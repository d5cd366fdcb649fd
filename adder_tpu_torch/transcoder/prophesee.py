"""Prophesee RAW (EVT2-style) DVS stream -> ADΔER events, on torch.

Port of `adder_tpu/transcoder/prophesee.py` (ref: adder-codec-rs
src/transcoder/source/prophesee.rs:25-365) along its resident engine, the
one the JAX package runs on an accelerator. Per pixel the source keeps the
last log intensity and the last timestamp; for each DVS event it integrates
the held intensity over the gap, steps the log intensity by +-camera_theta
and integrates one source tick of the new intensity.

A window of events (1 / view_fps of the stream) is planned on the host into
lanes: lane k holds each pixel's k-th event. Lanes run in groups of at most
64 as one chunk of T = 2 x lanes sub-steps. As in the JAX resident engine,
the native planner first plans and packs a segment in one pass into the
8-byte carrier (`ops/native_dvs_plan.plan_dvs_pack8_native`: two u32 words
a row and a 64-entry (value, fv) dictionary); where the segment does not
fit that layout, the classic plan (`ops/dvs_batch.plan_dvs_compact`) is
packed per group into the 8-byte carrier (`FR.pack_dvs_plan8`) or, failing
that, the (5, E) 20-byte one (`FR.pack_dvs_plan`). A group runs from its
carrier (`FR.dvs_rows8_resident` or `FR.dvs_rows_resident`: on a CUDA
device the grouping glue and the K3 row kernel, which walks each pixel's
own rows and updates the state in place; on the CPU the plain version,
which scatters the rows into dense (T, N) planes). The groups are
pipelined (`lanes.LanePipeline`): a group's upload runs while the next is
planned, at most one is staged and two are in flight, and their events are
fetched on one worker, in order; nothing is read back on the calling
thread inside a window's groups. Windows of more than 1.5 segments
(ADDER_TPU_DVS_SEG_EVENTS events, default 262,144) are planned segment by
segment, as the JAX resident engine does.

Events reach the encoder in the JAX resident engine's order: by group, then
(sub-step, raster pixel, slot). Each pixel's stream is in time order and
independent of window, segment and group boundaries; the bytes equal the JAX
scan engine's wherever no window is segmented.

The bootstrap (two mid-grey ticks for every pixel) and the end-of-stream
flush (the held intensity of every pixel with a gap) are carriers too: one
row per pixel in raster order, built on the device for the bootstrap and on
the host for the flush's pixels, run at T = 2 through the same row kernel
with the grouping such a carrier has (`lanes.run_raster_chunk`; the flush's
tick sub-step is empty); the staged groups are dispatched, and for the flush
collected, before either.

`batched=False` runs the scalar per-event oracle (`transcoder/pixel_oracle`,
the transcoder's semantic specification), as the JAX source does: the
bootstrap, each event's gap and tick, and the flush, pixel by pixel on the
host, with no tensor operation. Not ported: the XLA scan engine; on the CPU
the plain versions take its place.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.types import Coord, EventArray, Mode, PlaneSize, TimeMode
from ..ops import dvs_batch
from ..ops import fused_resident as FR
from ..ops import integrate as ops
from ..ops import native_dvs_plan
from ..utils import tracing
from ..utils.cv import mid_clamp_u8
from . import pixel_oracle as O
from .lanes import (LanePipeline, gap_rows, ingest_parts, lane_event_cap,
                    lane_params, run_raster_chunk)
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


def bootstrap_carrier(n: int, ref_time: int, device) -> torch.Tensor:
    """The (5, n) int32 carrier of the bootstrap (ref: prophesee.rs:117-133),
    built on `device`: one row per pixel in raster order, lane 0, whose gap
    is 128.0 over ref_time ticks and whose tick is 128.0 over one source
    tick (the row kernel's f32(ref_time)), both at fv 128."""
    bits = np.array([128.0, ref_time], np.float32).view(np.int32)
    carrier = torch.empty((5, n), dtype=torch.int32, device=device)
    carrier[0] = (torch.arange(n, dtype=torch.int32, device=device)
                  | 3 << 27)  # lane 0, gap and tick on
    carrier[1] = 128 | 128 << 8  # gap_fv, tick_fv
    carrier[2] = int(bits[0])  # gap_int
    carrier[3] = int(bits[1])  # gap_time
    carrier[4] = int(bits[0])  # tick_int
    return carrier


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
    events never leave the device: no fetch, no host sync. A window's last
    groups may still be in flight when consume() returns: their events
    reach the encoder (and a later consume()'s result) in order, and all
    of them before the end-of-stream flush or `end_write_stream`.
    `batched=False`: the scalar oracle, per event on the host."""

    def __init__(self, ref_time: int, input_path: str, batched: bool = True,
                 view_fps: int = 60, *, device="cuda"):
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
        self.batched = batched
        self.state = None
        self._pixels: list = []
        if batched:
            # DVS gaps cascade deeper than framed intervals: depth 16
            # throughout (the JAX package's choice), with no depth rerun
            self.state = ops.init_state(n, self.device, depth=FR.DVS_DEPTH)
            self._lanes = LanePipeline(self.device, w)
        else:  # the scalar oracle's arenas (Continuous mode)
            self._pixels = [O.PixelArena(1.0, Coord(i % w, i // w, None))
                            for i in range(n)]
            for px in self._pixels:
                px.set_time_mode(TimeMode.AbsoluteT)
        self._event_buf: Optional[tuple] = None
        self._event_pos = 0
        self._eof = False
        self._end_flushed = False
        self.void_events = False

    # -- setup API (ref: prophesee.rs) --

    def crf(self, crf: int) -> "Prophesee":
        self.video.update_crf(crf)
        base = self.video.encoder.options.crf.get_parameters().c_thresh_baseline
        if self.batched:
            self._lanes.flush(self.state)
            self.state = self.state._replace(
                c_thresh=torch.full_like(self.state.c_thresh, base),
                c_increase_counter=torch.zeros_like(
                    self.state.c_increase_counter),
            )
        for px in self._pixels:
            px.c_thresh = base
            px.c_increase_counter = 0
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

    def drain(self) -> EventArray:
        """Hand the lane groups still in flight to the encoder, in order,
        and return their events (none on the oracle's path, or once the
        stream is exhausted: its last window drains itself)."""
        return self._ingest(self._lanes.drain(self.state) if self.batched
                            else [])

    def end_write_stream(self):
        """`drain`, then end the encoder's stream."""
        self.drain()
        if self.batched:
            self._lanes.close()
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

    def _run_raster(self, carrier: torch.Tensor, p):
        """One raster chunk (the bootstrap, the flush) on the carried state,
        updated in place; its events as (x, y, d, t) host arrays, or None on
        the void path."""
        self.state, events = run_raster_chunk(self.state, carrier, p,
                                              self.void_events,
                                              self.plane.width)
        return events

    def _run_group(self, carrier: np.ndarray, n_lanes: int,
                   pb: Optional[int], cap: int, p) -> list:
        """Stage one lane group's carrier (the 8-byte one with `pb`, else
        the 20-byte one) of `cap` events at most; the parts of the groups
        this moves out of the pipeline, in order."""
        self._lanes.stage(carrier, n_lanes, pb, cap, p, self.void_events)
        return self._lanes.step(self.state)

    def _run_segment(self, pp, plan, p) -> list:
        """The lane groups of one planned segment, in lane order: the fused
        native plan `pp` sliced into 64-lane groups (its rows are lane-major
        and a group's lanes are 64-aligned), or the classic `plan`, each
        group packed into the 8-byte carrier where it fits and into the
        20-byte one where it does not."""
        parts: list = []
        if pp is not None:
            for g0 in range(0, pp.n_lanes, LANE_GROUP):
                g1 = min(pp.n_lanes, g0 + LANE_GROUP)
                r0, r1 = int(pp.lane_off[g0]), int(pp.lane_off[g1])
                E = r1 - r0
                with tracing.stage("dvs.pack", items=E):
                    carrier = np.zeros((2, E + FR.DICT_CAP), np.uint32)
                    carrier[0, :E] = pp.row0[r0:r1]
                    carrier[1, :E] = pp.row1[r0:r1]
                    carrier[0, E : E + len(pp.dict0)] = pp.dict0
                    carrier[1, E : E + len(pp.dict1)] = pp.dict1
                cap = lane_event_cap(pp.gap_cnt[g0:g1].sum()
                                     + pp.tick_cnt[g0:g1].sum())
                parts += self._run_group(carrier.view(np.int32), g1 - g0,
                                         pp.pb, cap, p)
            return parts
        n, ref = self.plane.volume(), int(self.video.ref_time)
        n_lanes = plan.n_lanes
        for g0 in range(0, n_lanes, LANE_GROUP):
            g = (plan.lane_slice(g0, g0 + LANE_GROUP)
                 if n_lanes > LANE_GROUP else plan)
            with tracing.stage("dvs.pack", items=len(g.pix)):
                p8 = FR.pack_dvs_plan8(g, n, ref)
                carrier, pb = p8 if p8 is not None else (
                    FR.pack_dvs_plan(g), None)
            cap = lane_event_cap(g.gap_on.sum() + g.tick_on.sum())
            parts += self._run_group(carrier, min(n_lanes - g0, LANE_GROUP),
                                     pb, cap, p)
        return parts

    def _ingest(self, parts: list) -> EventArray:
        return ingest_parts(self.video.encoder, parts)

    def _bootstrap(self) -> EventArray:
        """Integrate two mid-grey (128) ticks in every pixel at t = 0
        (ref: prophesee.rs:117-133), from `bootstrap_carrier`."""
        self._lanes.flush(self.state)
        carrier = bootstrap_carrier(self.plane.volume(), self.video.ref_time,
                                    self.device)
        part = self._run_raster(carrier, self._params())
        self.running_t = 2
        return self._ingest([part])

    def _end_events(self) -> None:
        """Flush the held intensities at the end of the stream, once
        (ref: prophesee.rs:325-365), after every group in flight."""
        if self._end_flushed:
            return
        self._end_flushed = True
        self._ingest(self._lanes.drain(self.state))
        ref = self.video.ref_time
        gap = self.running_t - self.dvs_last_timestamps.astype(np.int64)
        pix = np.flatnonzero(gap > 0)
        part = None
        if len(pix):  # gap-only rows of the pixels with a gap
            last_val = ((np.exp(self.dvs_last_ln_val) - 1.0) * 255.0)[pix]
            time_spanned = (gap[pix] * ref).astype(np.float64)
            fv = np.clip(last_val, 0.0, 255.0).astype(np.int64)
            carrier = gap_rows(pix, fv, last_val * time_spanned, time_spanned)
            part = self._run_raster(torch.from_numpy(carrier).to(self.device),
                                    self._params())
        self._ingest([part])

    def consume(self) -> EventArray:
        """One view interval's worth of DVS events (ref: prophesee.rs:116-297).
        Raises EOFError once the stream is exhausted (after the flush)."""
        if not self.batched:
            return self._consume_oracle()
        if self.running_t == 0:
            self._bootstrap()
        batch = self._next_dvs_batch()
        if batch is None:
            self._end_events()
            raise EOFError("prophesee source exhausted")
        ts, xs, ys, ps = batch
        p = self._params()
        n = self.plane.volume()
        seg = int(os.environ.get("ADDER_TPU_DVS_SEG_EVENTS",
                                 str(SEG_EVENTS_DEFAULT)))
        n_ev = len(ts)
        bounds = list(range(0, n_ev, seg)) if n_ev > seg + seg // 2 else [0]
        parts: list = []
        for i, lo in enumerate(bounds):
            sl = slice(lo, bounds[i + 1] if i + 1 < len(bounds) else n_ev)
            with tracing.stage("dvs.plan", items=sl.stop - lo):
                # the fused plan + 8-byte pack; the classic plan where the
                # segment does not fit (the chain is as it was then)
                pp = native_dvs_plan.plan_dvs_pack8_native(
                    ts[sl], xs[sl], ys[sl], ps[sl], self.plane.width, n,
                    self.dvs_last_timestamps, self.dvs_last_ln_val,
                    self.camera_theta, int(self.video.ref_time),
                    val_cache=self._val_cache,
                )
                plan = None
                if pp is None:
                    plan = dvs_batch.plan_dvs_compact(
                        ts[sl], xs[sl], ys[sl], ps[sl], self.plane.width,
                        self.dvs_last_timestamps, self.dvs_last_ln_val,
                        self.camera_theta, int(self.video.ref_time),
                        val_cache=self._val_cache,
                    )
            parts += self._run_segment(pp, plan, p)
        self._lanes.flush(self.state)
        if self._event_pos >= len(self._event_buf[0]):
            # the last window: every group's events, before the flush's
            parts += self._lanes.drain(self.state)
        arr = self._ingest(parts)
        if self._eof:
            self._end_events()
        return arr

    # -- the scalar oracle (batched=False; adder_tpu/transcoder/prophesee.py
    # :238-256, :821-895) --

    def _integrate_px(self, i, frame_val, intensity, time_spanned, buffer):
        v = self.video
        crf = v.encoder.options.crf.get_parameters()
        O.integrate_for_px(
            self._pixels[i], frame_val, intensity, time_spanned, buffer,
            Mode.Continuous, v.pixel_multi_mode, v.delta_t_max, v.ref_time,
            crf.c_thresh_max, max(crf.c_increase_velocity, 1),
        )

    def _bootstrap_oracle(self) -> None:
        """Integrate 2 gray (128) frames at t=0 (ref: prophesee.rs:117-133)."""
        events: list = []
        ref = self.video.ref_time
        for _ in range(2):
            for i in range(len(self._pixels)):
                self._integrate_px(i, 128, 128.0, float(ref), events)
        self.running_t = 2
        self.video.encoder.ingest_event_array(EventArray.from_events(events))

    def _consume_oracle(self) -> EventArray:
        if self.running_t == 0:
            self._bootstrap_oracle()
        batch = self._next_dvs_batch()
        if batch is None:
            self._end_events_oracle()
            raise EOFError("prophesee source exhausted")
        ts, xs, ys, ps = batch
        W = self.plane.width
        ref = self.video.ref_time
        events: list = []
        for k in range(len(ts)):
            t = int(ts[k])
            i = int(ys[k]) * W + int(xs[k])
            last_t = int(self.dvs_last_timestamps[i])
            if t < last_t:
                continue
            last_ln = self.dvs_last_ln_val[i]

            if t > last_t + 1:
                last_val = (np.exp(last_ln) - 1.0) * 255.0
                last_val, last_ln = mid_clamp_u8(last_val, last_ln)
                time_spanned = (t - last_t - 1) * ref
                # the f32 product by definition, as the planners and the
                # 8-byte carrier's decode compute it
                intensity = np.float32(
                    np.float32(last_val) * np.float32(t - last_t - 1)
                )
                self._integrate_px(i, int(last_val), float(intensity),
                                   float(time_spanned), events)

            new_ln = (last_ln - self.camera_theta if ps[k] == 0
                      else last_ln + self.camera_theta)
            self.dvs_last_ln_val[i] = new_ln
            self.dvs_last_timestamps[i] = t

            if t > last_t:
                new_val = (np.exp(new_ln) - 1.0) * 255.0
                new_val, new_ln = mid_clamp_u8(new_val, new_ln)
                self.dvs_last_ln_val[i] = new_ln
                self._integrate_px(i, int(new_val), float(new_val),
                                   float(ref), events)

        arr = EventArray.from_events(events)
        self.video.encoder.ingest_event_array(arr)
        if self._eof:
            self._end_events_oracle()
        return arr

    def _end_events_oracle(self) -> None:
        """Flush held intensities at EOF (ref: prophesee.rs:325-365), once."""
        if self._end_flushed:
            return
        self._end_flushed = True
        events: list = []
        ref = self.video.ref_time
        for i in range(len(self._pixels)):
            last_ln = self.dvs_last_ln_val[i]
            last_val = (np.exp(last_ln) - 1.0) * 255.0
            gap = self.running_t - int(self.dvs_last_timestamps[i])
            if gap <= 0:
                continue
            time_spanned = gap * ref
            intensity = last_val * time_spanned
            self._integrate_px(
                i, int(max(min(last_val, 255.0), 0.0)), float(intensity),
                float(time_spanned), events,
            )
        self.video.encoder.ingest_event_array(EventArray.from_events(events))
