"""Prophesee RAW (EVT2-style) DVS stream -> ADΔER events, on torch.

Port of `adder_tpu/transcoder/prophesee.py` (ref: adder-codec-rs
src/transcoder/source/prophesee.rs:25-365) along its resident engine, the
one the JAX package runs on an accelerator. Per pixel the source keeps the
last log intensity and the last timestamp; for each DVS event it integrates
the held intensity over the gap, steps the log intensity by +-camera_theta
and integrates one source tick of the new intensity.

A window of events (1 / view_fps of the stream) is planned on the host by
the native planner (`ops/dvs_batch.plan_dvs_compact`) into lanes:
lane k holds each pixel's k-th event. Lanes run in groups of at most 64 as
one chunk of T = 2 x lanes sub-steps. A group's rows reach the device as
one (5, E) int32 carrier and run from it
(`ops/fused_resident.dvs_rows_resident`: on a CUDA device the K3 row kernel,
which walks each pixel's own rows and updates the state in place; on the
CPU its plain version, which scatters the rows into dense (T, N) planes).
Windows of more than 1.5 segments
(ADDER_TPU_DVS_SEG_EVENTS events, default 262,144) are planned segment by
segment, as the JAX resident engine does.

Events reach the encoder in the JAX resident engine's order: by group, then
(sub-step, raster pixel, slot). Each pixel's stream is in time order and
independent of window, segment and group boundaries; the bytes equal the JAX
scan engine's wherever no window is segmented.

The bootstrap (two mid-grey ticks for every pixel) is one T = 2 chunk and
the end-of-stream flush one T = 1 chunk, both dense by nature and run from
planes (`ops/fused_resident.dvs_chunk_resident`, the dense K3 kernel).
Not ported: the scalar per-event oracle (`batched=False`) and the XLA scan
engine; on the CPU the plain version takes their place.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.types import EventArray, Mode, PlaneSize, TimeMode
from ..ops import dvs_batch
from ..ops import fused_resident as FR
from ..ops import integrate as ops
from .lanes import ingest_parts, lane_params, run_lane_chunk
from .video import SourceError, Video, resolve_device

PROPHESEE_SOURCE_TPS = 1_000_000
LANE_GROUP = 64  # lanes per chunk: T = 2 x lanes <= FR.MAX_T
SEG_EVENTS_DEFAULT = 262_144


def parse_header(f) -> tuple:
    """Parse the %-comment header; returns (bod, ev_type, ev_size, (h, w)).

    Copy of `adder_tpu/transcoder/prophesee.py:42-74` (ref:
    prophesee.rs:367-422)."""
    f.seek(0)
    height = width = None
    n_comment = 0
    bod = 0
    while True:
        bod = f.tell()
        line = f.readline()
        if not line or not line.startswith(b"%"):
            break
        words = line.replace(b"\t", b" ").split(b" ")
        if len(words) > 2:
            try:
                if words[1] == b"Height":
                    height = int(words[2].strip())
                elif words[1] == b"Width":
                    width = int(words[2].strip())
            except ValueError:
                pass
        n_comment += 1
    f.seek(bod)
    ev_type, ev_size = 0, 0
    if n_comment > 0:
        buf = f.read(2)
        ev_type, ev_size = buf[0], buf[1]
        if ev_size != 8 or ev_type not in (0, 12):
            raise SourceError("Invalid Prophesee event size")
    bod = f.tell()
    return bod, ev_type, ev_size, (height or 70, width or 100)


def decode_events_np(buf: bytes) -> tuple:
    """Vectorized decode of 8-byte LE records -> (t, x, y, p) arrays.

    Copy of `adder_tpu/transcoder/prophesee.py:77-90` (ref:
    prophesee.rs:437-452: x = data & 0x3FF, y = (data & 0xFFFC000) >> 14,
    p = (data >> 28) & 1)."""
    raw = np.frombuffer(buf, dtype="<u4")
    n = len(raw) // 2
    t = raw[0 : 2 * n : 2]
    data = raw[1 : 2 * n : 2].astype(np.int64)
    x = (data & 0x3FF).astype(np.uint16)
    y = ((data & 0xFFFC000) >> 14).astype(np.uint16)
    p = ((data & 0x10000000) >> 28).astype(np.uint8)
    return t.astype(np.uint32), x, y, p


class Prophesee:
    """Prophesee RAW -> ADΔER transcoder (ref: prophesee.rs:25-323) on the
    torch `device` (the card unless the caller asks for the CPU).

    view_fps sets how much of the stream one consume() call takes: events
    until t passes running_t + 1 s / view_fps (60 mirrors the reference's
    view interval; a bulk transcode may lower it). Per-pixel event streams
    do not depend on it. With `void_events` set (and the Empty sink) the
    events never leave the device: no fetch, no host sync."""

    def __init__(self, ref_time: int, input_path: str, view_fps: int = 60,
                 *, device="cuda"):
        self.device = resolve_device(device)
        with open(input_path, "rb") as f:
            bod, _, _, (h, w) = parse_header(f)
        self._path, self._bod = input_path, bod
        self.plane = PlaneSize(w, h, 1)
        n = self.plane.volume()
        if n > 1 << 20:
            raise ValueError(f"plane of {n} pixels: the DVS carrier holds "
                             f"pixel indices below 2^20")

        # tps scales the source's 1 MHz clock by ref_time; dtm = 2 * ref_time
        # (ref: prophesee.rs:65-76)
        self.video = Video(self.plane, Mode.Continuous, device=self.device)
        self.video.time_parameters(
            ref_time * PROPHESEE_SOURCE_TPS, ref_time, ref_time * 2,
            TimeMode.AbsoluteT,
        )
        self.running_t = 0
        self.t_subtract = 0
        self.camera_theta = 0.02
        self.view_fps = max(int(view_fps), 1)
        self.dvs_last_timestamps = np.full(n, 2, dtype=np.uint32)
        self.dvs_last_ln_val = np.full(n, np.log1p(128.0 / 255.0),
                                       dtype=np.float64)
        self._val_cache = np.full(n, np.nan, np.float64)  # exp(last_ln) memo
        # DVS gaps cascade deeper than framed intervals: depth 16 throughout
        # (the JAX package's choice), with no depth rerun
        self.state = ops.init_state(n, self.device, depth=FR.DVS_DEPTH)
        self._event_buf: Optional[tuple] = None
        self._event_pos = 0
        self._eof = False
        self._end_flushed = False
        self.void_events = False

    # -- setup API (ref: prophesee.rs) --

    def crf(self, crf: int) -> "Prophesee":
        self.video.update_crf(crf)
        base = self.video.encoder.options.crf.get_parameters().c_thresh_baseline
        self.state = self.state._replace(
            c_thresh=torch.full_like(self.state.c_thresh, base),
            c_increase_counter=torch.zeros_like(self.state.c_increase_counter),
        )
        return self

    def write_out(self, source_camera, time_mode, pixel_multi_mode,
                  adu_interval, encoder_type, encoder_options, write,
                  **kwargs) -> "Prophesee":
        self.video.write_out(
            source_camera, time_mode, pixel_multi_mode, adu_interval,
            encoder_type, encoder_options, write, **kwargs,
        )
        return self

    def get_video_ref(self):
        return self.video

    def get_video_mut(self):
        return self.video

    def end_write_stream(self):
        return self.video.end_write_stream()

    # -- internals --

    def _params(self) -> ops.TranscodeParams:
        return lane_params(self.video)

    def load_events(self) -> None:
        """Decode the whole stream into host arrays (once)."""
        if self._event_buf is None:
            with open(self._path, "rb") as f:
                f.seek(self._bod)
                t, x, y, p = decode_events_np(f.read())
            self._event_buf = (t - self.t_subtract, x, y, p)
            self._event_pos = 0

    def _next_dvs_batch(self):
        """DVS events until t passes running_t + 1 / view_fps s
        (ref: prophesee.rs:136-170)."""
        self.load_events()
        t, x, y, p = self._event_buf
        start = self._event_pos
        if start >= len(t):
            self._eof = True
            return None
        view_interval = PROPHESEE_SOURCE_TPS // self.view_fps
        limit = self.running_t + view_interval
        beyond = np.flatnonzero(t[start:] > limit)
        end = start + int(beyond[0]) + 1 if len(beyond) else len(t)
        if not len(beyond):
            self._eof = True
        self._event_pos = end
        sl = slice(start, end)
        if end > start:
            self.running_t = max(self.running_t, int(t[sl].max()))
        return t[sl], x[sl], y[sl], p[sl]

    def _run_chunk(self, inten, tspan, fvw, p):
        """One dense K3 chunk on the carried state; its events as (x, y, d,
        t) host arrays, or None on the void path."""
        self.state, events = run_lane_chunk(
            FR.dvs_chunk_resident, self.state, (inten, tspan, fvw), p,
            self.void_events, self.plane.width)
        return events

    def _run_group(self, g: dvs_batch.DvsCompact, n_lanes: int, p):
        """One lane group from its carrier, through the row route; the
        carried state is updated in place."""
        carrier = torch.from_numpy(FR.pack_dvs_plan(g)).to(self.device)
        self.state, events = run_lane_chunk(
            FR.dvs_rows_resident, self.state, (carrier, 2 * n_lanes), p,
            self.void_events, self.plane.width)
        return events

    def _const_chunk(self, T: int, intensity: float, fv: int, time: float):
        n = self.plane.volume()

        def full(v, dt):
            return torch.full((T, n), v, dtype=dt, device=self.device)

        return self._run_chunk(
            full(intensity, torch.float32), full(time, torch.float32),
            full(fv | 1 << 8, torch.int32), self._params(),
        )

    def _ingest(self, parts: list) -> EventArray:
        return ingest_parts(self.video.encoder, parts)

    def _bootstrap(self) -> EventArray:
        """Integrate two mid-grey (128) ticks in every pixel at t = 0
        (ref: prophesee.rs:117-133)."""
        ref = float(self.video.ref_time)
        part = self._const_chunk(2, 128.0, 128, ref)
        self.running_t = 2
        return self._ingest([part])

    def _end_events(self) -> None:
        """Flush the held intensities at the end of the stream, once
        (ref: prophesee.rs:325-365)."""
        if self._end_flushed:
            return
        self._end_flushed = True
        ref = self.video.ref_time
        gap = self.running_t - self.dvs_last_timestamps.astype(np.int64)
        mask = gap > 0
        last_val = (np.exp(self.dvs_last_ln_val) - 1.0) * 255.0
        time_spanned = (gap * ref).astype(np.float64)
        intensity = (last_val * time_spanned).astype(np.float32)
        fv = np.clip(last_val, 0.0, 255.0).astype(np.int64).astype(np.int32)
        planes = (
            np.where(mask, intensity, 0.0).astype(np.float32),
            np.where(mask, time_spanned, 0.0).astype(np.float32),
            (np.where(mask, fv, 0) | (mask.astype(np.int32) << 8)).astype(
                np.int32),
        )
        part = self._run_chunk(
            *(torch.from_numpy(a[None]).to(self.device) for a in planes),
            self._params(),
        )
        self._ingest([part])

    def consume(self) -> EventArray:
        """One view interval's worth of DVS events (ref: prophesee.rs:116-297).
        Raises EOFError once the stream is exhausted (after the flush)."""
        if self.running_t == 0:
            self._bootstrap()
        batch = self._next_dvs_batch()
        if batch is None:
            self._end_events()
            raise EOFError("prophesee source exhausted")
        ts, xs, ys, ps = batch
        p = self._params()
        seg = int(os.environ.get("ADDER_TPU_DVS_SEG_EVENTS",
                                 str(SEG_EVENTS_DEFAULT)))
        n_ev = len(ts)
        bounds = list(range(0, n_ev, seg)) if n_ev > seg + seg // 2 else [0]
        parts: list = []
        for i, lo in enumerate(bounds):
            hi = bounds[i + 1] if i + 1 < len(bounds) else n_ev
            plan = dvs_batch.plan_dvs_compact(
                ts[lo:hi], xs[lo:hi], ys[lo:hi], ps[lo:hi], self.plane.width,
                self.dvs_last_timestamps, self.dvs_last_ln_val,
                self.camera_theta, int(self.video.ref_time),
                val_cache=self._val_cache,
            )
            n_lanes = plan.n_lanes
            for g0 in range(0, n_lanes, LANE_GROUP):
                g = (plan.lane_slice(g0, g0 + LANE_GROUP)
                     if n_lanes > LANE_GROUP else plan)
                parts.append(
                    self._run_group(g, min(n_lanes - g0, LANE_GROUP), p))
        arr = self._ingest(parts)
        if self._eof:
            self._end_events()
        return arr
