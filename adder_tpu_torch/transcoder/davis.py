"""DAVIS (APS frames + DVS events) -> ADΔER, on torch.

Port of `adder_tpu/transcoder/davis.py` (ref: adder-codec-rs
src/transcoder/source/davis.rs) along its batched engines. A provider (the
EDI reconstructor over an aedat4 file, `transcoder/edi.py`, or an array of
packets) hands over `DavisPacket`s: a deblurred APS frame with its exposure
interval and the DVS events since the previous packet. The three transcode
modes of the reference are kept:

  Framed   - integrate only the (deblurred) APS frames
  RawDavis - integrate APS frames AND the DVS events between them
  RawDvs   - integrate only DVS events

Per pixel the source keeps the last DVS timestamp (microseconds) and the
last log intensity. DVS events are planned on the host by the native
planner (`ops/dvs_batch.plan_davis_events_compact`) into lanes, lane k
holding each pixel's k-th event, and run in groups of at most 128 lanes as
one chunk of T = lanes sub-steps (`ops/fused_resident.davis_chunk_resident`:
the K4 kernel on a CUDA device, its plain version on the CPU). A group's
rows reach the device as one (5, E) int32 carrier and are scattered there
into dense (T, N) planes. The gap to an APS frame's start and the frame
itself are one T = 1 chunk each through the DVS lane kernel (K3,
`dvs_chunk_resident`), with per-pixel planes, as the JAX package runs them
through its masked interval.

Events reach the encoder in the order of the JAX package's scan engine (the
one it runs on the CPU): lane by lane, and within a lane by raster pixel,
then slot. Not ported: the scalar per-event oracle (`batched=False`) and the
XLA scan engine; on the CPU the plain versions take their place.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..core.types import EventArray, Mode, PlaneSize, TimeMode
from ..ops import dvs_batch
from ..ops import fused_resident as FR
from ..ops import integrate as ops
from .lanes import ingest_parts, lane_params, run_lane_chunk
from .video import SourceError, Video, resolve_device

LANE_GROUP = 128  # lanes per K4 chunk: one sub-step per lane, T <= FR.MAX_T


class TranscoderMode(enum.IntEnum):
    """ref: davis.rs:39-53"""

    Framed = 0
    RawDavis = 1
    RawDvs = 2


@dataclass
class DvsEvent:
    t: int  # microseconds
    x: int
    y: int
    on: bool


@dataclass
class DvsEvents:
    """Struct-of-arrays DVS event batch, as the EDI reconstructor hands it
    over; the lane planner reads the arrays directly."""

    t: np.ndarray  # int64 microseconds
    x: np.ndarray
    y: np.ndarray
    on: np.ndarray  # bool

    def __len__(self) -> int:
        return len(self.t)

    def __iter__(self):
        for i in range(len(self.t)):
            yield DvsEvent(t=int(self.t[i]), x=int(self.x[i]),
                           y=int(self.y[i]), on=bool(self.on[i]))


@dataclass
class DavisPacket:
    """One reconstructed interval from the EDI stage."""

    frame: Optional[np.ndarray]  # (H, W) u8 deblurred APS frame
    frame_start_us: int
    frame_end_us: int
    # DVS events since the previous packet: a list of DvsEvent or a
    # DvsEvents struct-of-arrays batch
    events: object


class ArrayDavisProvider:
    """Array-backed provider for tests and offline data."""

    def __init__(self, packets: List[DavisPacket], plane: PlaneSize):
        self.packets = packets
        self.plane = plane

    def __iter__(self) -> Iterator[DavisPacket]:
        return iter(self.packets)


def _event_arrays(events):
    """(t int64, x u16, y u16, on bool) arrays of a DvsEvents batch or a
    list of DvsEvent."""
    if isinstance(events, DvsEvents):
        return (events.t.astype(np.int64), events.x.astype(np.uint16),
                events.y.astype(np.uint16), events.on.astype(bool))
    return (np.array([e.t for e in events], np.int64),
            np.array([e.x for e in events], np.uint16),
            np.array([e.y for e in events], np.uint16),
            np.array([e.on for e in events], bool))


class Davis:
    """DAVIS -> ADΔER transcoder (ref: davis.rs:55-900) on the torch
    `device` (the card unless the caller asks for the CPU).

    The arena is depth 16 over exactly N pixels, as the JAX package's
    batched engines use for DVS gap cascades. With `prefetch` the provider
    runs on its own worker thread (ref: davis.rs:626-632). With
    `void_events` set (and the Empty sink) events never leave the device:
    the chunks run their VOID pass, with no fetch and no host sync."""

    def __init__(self, provider, ref_time: int = 255,
                 tps: int = 255_000_000, delta_t_max: Optional[int] = None,
                 mode: TranscoderMode = TranscoderMode.RawDavis,
                 prefetch: bool = True, *, device="cuda"):
        self.device = resolve_device(device)
        n = provider.plane.volume()
        if n > 1 << 20:
            raise ValueError(f"plane of {n} pixels: the DAVIS carrier holds "
                             f"pixel indices below 2^20")
        if prefetch:
            from .edi import ThreadedProvider

            if not isinstance(provider, ThreadedProvider):
                provider = ThreadedProvider(provider)
        self.provider = provider
        self.mode = mode
        self.plane = provider.plane
        self.dvs_c = 0.15  # ref: davis.rs:150
        self.video = Video(self.plane, Mode.Continuous, device=self.device)
        self.video.time_parameters(
            tps, ref_time, delta_t_max or ref_time * 30, TimeMode.AbsoluteT
        )
        self.dvs_last_timestamps = np.zeros(n, dtype=np.int64)
        self.dvs_last_ln_val = np.full(n, np.log1p(0.5), dtype=np.float64)
        self._val_cache = np.full(n, np.nan, np.float64)  # exp(last_ln) memo
        self.state = ops.init_state(n, self.device, depth=FR.DVS_DEPTH)
        self.void_events = False
        self._iter = iter(provider)

    # -- setup API (ref: davis.rs) --

    def crf(self, crf: int) -> "Davis":
        """Set the CRF quality; resets c_thresh to its baseline. The CLI's
        `update_quality_manual` path on the Video does not touch this
        state, as in the JAX package."""
        self.video.update_crf(crf)
        base = self.video.encoder.options.crf.get_parameters().c_thresh_baseline
        self.state = self.state._replace(
            c_thresh=torch.full_like(self.state.c_thresh, base),
            c_increase_counter=torch.zeros_like(self.state.c_increase_counter),
        )
        return self

    def write_out(self, *args, **kwargs) -> "Davis":
        self.video.write_out(*args, **kwargs)
        return self

    def get_video_ref(self) -> Video:
        return self.video

    def end_write_stream(self):
        return self.video.end_write_stream()

    # -- internals --

    def _params(self) -> ops.TranscodeParams:
        return lane_params(self.video)

    def _run_chunk(self, fn, planes, p):
        """One chunk of `fn` (a lane-chunk wrapper) on the carried state;
        its events as (x, y, d, t) host arrays, or None on the void path."""
        self.state, events = run_lane_chunk(fn, self.state, planes, p,
                                            self.void_events,
                                            self.plane.width)
        return events

    def _run_group(self, g: dvs_batch.DavisCompact, n_lanes: int, p):
        carrier = torch.from_numpy(FR.pack_davis_plan(g)).to(self.device)
        planes = FR.build_davis_planes(n_lanes, self.plane.volume(),
                                       *FR.unpack_davis_carrier(carrier))
        return self._run_chunk(FR.davis_chunk_resident, planes, p)

    def _integrate_dvs_events(self, events, parts: list) -> None:
        """Log-space DVS integration (ref: davis.rs:235-465) of one packet's
        events: the lane plan, then groups of at most LANE_GROUP lanes."""
        if not len(events):
            return
        ts, xs, ys, ons = _event_arrays(events)
        plan = dvs_batch.plan_davis_events_compact(
            ts, xs, ys, ons, self.plane.width, self.dvs_last_timestamps,
            self.dvs_last_ln_val, self.dvs_c, self.video.ref_time,
            self.video.tps / 1e6, val_cache=self._val_cache,
        )
        n_lanes = plan.n_lanes
        p = self._params()
        for g0 in range(0, n_lanes, LANE_GROUP):
            g = (plan.lane_slice(g0, g0 + LANE_GROUP)
                 if n_lanes > LANE_GROUP else plan)
            parts.append(self._run_group(g, min(n_lanes - g0, LANE_GROUP), p))

    def _masked_chunk(self, intensity, fv, time, mask, parts: list) -> None:
        """One dense interval where only `mask` pixels integrate, with
        per-pixel intensity, frame value and ticks spanned: a T = 1 chunk
        of the DVS lane kernel."""
        fvw = (fv.astype(np.int32) | (mask.astype(np.int32) << 8))
        planes = tuple(torch.from_numpy(np.ascontiguousarray(a)[None])
                       .to(self.device)
                       for a in (intensity.astype(np.float32),
                                 time.astype(np.float32), fvw))
        parts.append(self._run_chunk(FR.dvs_chunk_resident, planes,
                                     self._params()))

    def _integrate_frame_gaps(self, start_of_frame_us: int,
                              parts: list) -> None:
        """Fill per-pixel time up to the APS frame start with the held
        intensity (ref: davis.rs:466+)."""
        tpm = self.video.tps / 1e6
        ref = self.video.ref_time
        gap_us = start_of_frame_us - self.dvs_last_timestamps
        mask = gap_us > 0
        last_val = (np.exp(self.dvs_last_ln_val) - 1.0) * 255.0
        dt_ticks = gap_us.astype(np.float64) * tpm
        intensity = np.maximum(last_val / ref * dt_ticks, 0.0)
        fv = np.clip(last_val, 0.0, 255.0).astype(np.int64)
        self._masked_chunk(
            np.where(mask, intensity, 0.0).astype(np.float32),
            np.where(mask, fv, 0).astype(np.int32),
            np.where(mask, dt_ticks, 0.0).astype(np.float32),
            mask, parts,
        )
        self.dvs_last_timestamps[mask] = start_of_frame_us

    def _integrate_frame(self, frame: np.ndarray, exposure_us: int,
                         parts: list) -> None:
        """Integrate a deblurred APS frame like a framed source over its
        exposure (ref: davis.rs consume, :601-900); the log intensity of
        every pixel is reset to the frame's."""
        n = self.plane.volume()
        fv = np.asarray(frame).reshape(-1).astype(np.int64)
        if len(fv) != n:
            raise SourceError(f"APS frame of {len(fv)} pixels on a plane of "
                              f"{n}")
        tpm = self.video.tps / 1e6
        ref = self.video.ref_time
        dt_ticks = max(exposure_us, 1) * tpm
        intensity = (fv.astype(np.float64) / ref * dt_ticks).astype(np.float32)
        self._masked_chunk(intensity, fv.astype(np.int32),
                           np.full(n, dt_ticks, np.float32),
                           np.ones(n, bool), parts)
        self.dvs_last_ln_val[:] = np.log1p(fv / 255.0)
        self._val_cache[:] = np.nan  # the ln state moved outside the planner

    def consume(self) -> EventArray:
        """One provider packet: its DVS events, the gap to its APS frame
        and the frame, as the mode asks. Raises EOFError once the provider
        is exhausted."""
        packet = next(self._iter, None)
        if packet is None:
            raise EOFError("davis source exhausted")
        parts: list = []
        if self.mode in (TranscoderMode.RawDavis, TranscoderMode.RawDvs):
            self._integrate_dvs_events(packet.events, parts)
        if (self.mode in (TranscoderMode.Framed, TranscoderMode.RawDavis)
                and packet.frame is not None):
            if self.mode == TranscoderMode.RawDavis:
                self._integrate_frame_gaps(packet.frame_start_us, parts)
            self._integrate_frame(
                packet.frame, packet.frame_end_us - packet.frame_start_us,
                parts,
            )
            np.copyto(self.dvs_last_timestamps,
                      np.maximum(self.dvs_last_timestamps,
                                 packet.frame_end_us))
        return ingest_parts(self.video.encoder, parts)
