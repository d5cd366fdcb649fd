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
one chunk of T = lanes sub-steps. A group's rows reach the device as one
(5, E) int32 carrier and run from it (`ops/fused_resident.davis_rows_resident`:
on a CUDA device the grouping glue and the K4 row kernel, which walks each
pixel's own rows; on the CPU its plain version, which scatters the rows into
dense (T, N) planes). The gap to an APS frame's start and the frame itself
are DVS carriers of one gap-only row per pixel in raster order (the gap's
pixels built on the host, the frame's on the device from its u8 values),
run at T = 2 through the K3 row kernel (`lanes.run_raster_chunk`; the tick
sub-step is empty): the JAX package's masked interval. Every chunk updates
the carried state in place.

Events reach the encoder in the order of the JAX package's scan engine (the
one it runs on the CPU): lane by lane, and within a lane by raster pixel,
then slot.

`batched=False` runs the scalar per-event oracle (`transcoder/pixel_oracle`)
as the JAX source does: each DVS event, the gap to a frame and the frame,
pixel by pixel on the host, with no tensor operation. Not ported: the XLA
scan engine; on the CPU the plain versions take its place.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..core.types import Coord, EventArray, Mode, PlaneSize, TimeMode
from ..ops import dvs_batch
from ..ops import fused_resident as FR
from ..ops import integrate as ops
from ..utils.cv import clamp_u8
from . import pixel_oracle as O
from .lanes import (gap_rows, ingest_parts, lane_params, run_lane_chunk,
                    run_raster_chunk)
from .video import SourceError, Video, resolve_device

LANE_GROUP = 128  # lanes per K4 chunk: one sub-step per lane, T <= FR.MAX_T


def frame_carrier(fv: torch.Tensor, ref_time: int,
                  dt_ticks: float) -> torch.Tensor:
    """The (5, N) int32 DVS carrier of an APS frame's integration, built on
    the device of `fv`, the (N,) u8 frame: one gap-only row per pixel in
    raster order, lane 0, with gap_int = f32(f64(fv) / ref_time * dt_ticks),
    gap_time = f32(dt_ticks) and gap_fv = fv (`lanes.gap_rows`'s layout),
    the bits the host computes in numpy f64. The division is by a tensor on
    the device: CUDA divides by a host scalar as a product with its
    reciprocal, which can differ in the last bit."""
    dev, n = fv.device, fv.shape[0]
    ref = torch.full((), float(ref_time), dtype=torch.float64, device=dev)
    gap_int = (fv.to(torch.float64) / ref * dt_ticks).to(torch.float32)
    carrier = torch.zeros((5, n), dtype=torch.int32, device=dev)
    carrier[0] = torch.arange(n, dtype=torch.int32, device=dev) | 1 << 27
    carrier[1] = fv
    carrier[2] = gap_int.view(torch.int32)
    carrier[3] = int(np.float32(dt_ticks).view(np.int32))
    return carrier


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
    the chunks run their void walk, with no fetch and no host sync.
    `batched=False`: the scalar oracle, per event on the host."""

    def __init__(self, provider, ref_time: int = 255,
                 tps: int = 255_000_000, delta_t_max: Optional[int] = None,
                 mode: TranscoderMode = TranscoderMode.RawDavis,
                 batched: bool = True, prefetch: bool = True, *,
                 device="cuda"):
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
        self.batched = batched
        self.state = None
        self._pixels: list = []
        if batched:
            self.state = ops.init_state(n, self.device, depth=FR.DVS_DEPTH)
        else:  # the scalar oracle's arenas (Continuous mode)
            w = self.plane.width
            self._pixels = [O.PixelArena(1.0, Coord(i % w, i // w, None))
                            for i in range(n)]
            for px in self._pixels:
                px.set_time_mode(TimeMode.AbsoluteT)
        self.void_events = False
        self._iter = iter(provider)

    # -- setup API (ref: davis.rs) --

    def crf(self, crf: int) -> "Davis":
        """Set the CRF quality; resets c_thresh to its baseline. The CLI's
        `update_quality_manual` path on the Video does not touch this
        state, as in the JAX package."""
        self.video.update_crf(crf)
        base = self.video.encoder.options.crf.get_parameters().c_thresh_baseline
        if self.batched:
            self.state = self.state._replace(
                c_thresh=torch.full_like(self.state.c_thresh, base),
                c_increase_counter=torch.zeros_like(
                    self.state.c_increase_counter),
            )
        for px in self._pixels:
            px.c_thresh = base
            px.c_increase_counter = 0
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

    def _run_group(self, g: dvs_batch.DavisCompact, n_lanes: int, p):
        """One lane group from its carrier, through the K4 row route; the
        carried state is updated in place. Its events as (x, y, d, t) host
        arrays, or None on the void path."""
        carrier = torch.from_numpy(FR.pack_davis_plan(g)).to(self.device)
        self.state, events = run_lane_chunk(
            FR.davis_rows_resident, self.state, (carrier, n_lanes), p,
            self.void_events, self.plane.width)
        return events

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

    def _raster_chunk(self, carrier: torch.Tensor, parts: list) -> None:
        """One interval of the pixels of a gap-only raster carrier (one row
        per pixel, raster order) with per-pixel intensity, frame value and
        ticks spanned: a T = 2 chunk of the K3 row kernel whose tick
        sub-step is empty."""
        self.state, events = run_raster_chunk(self.state, carrier,
                                              self._params(),
                                              self.void_events,
                                              self.plane.width)
        parts.append(events)

    def _integrate_frame_gaps(self, start_of_frame_us: int,
                              parts: list) -> None:
        """Fill per-pixel time up to the APS frame start with the held
        intensity (ref: davis.rs:466+)."""
        tpm = self.video.tps / 1e6
        ref = self.video.ref_time
        gap_us = start_of_frame_us - self.dvs_last_timestamps
        pix = np.flatnonzero(gap_us > 0)
        if not len(pix):  # no pixel has a gap: no chunk
            return
        last_val = ((np.exp(self.dvs_last_ln_val) - 1.0) * 255.0)[pix]
        dt_ticks = gap_us[pix].astype(np.float64) * tpm
        intensity = np.maximum(last_val / ref * dt_ticks, 0.0)
        fv = np.clip(last_val, 0.0, 255.0).astype(np.int64)
        carrier = gap_rows(pix, fv, intensity, dt_ticks)
        self._raster_chunk(torch.from_numpy(carrier).to(self.device), parts)
        self.dvs_last_timestamps[pix] = start_of_frame_us

    def _integrate_frame(self, frame: np.ndarray, exposure_us: int,
                         parts: list) -> None:
        """Integrate a deblurred APS frame like a framed source over its
        exposure (ref: davis.rs consume, :601-900); the log intensity of
        every pixel is reset to the frame's."""
        n = self.plane.volume()
        fv = np.asarray(frame).reshape(-1)
        if len(fv) != n:
            raise SourceError(f"APS frame of {len(fv)} pixels on a plane of "
                              f"{n}")
        if fv.dtype != np.uint8:
            if fv.size and (fv.min() < 0 or fv.max() > 255):
                raise SourceError("APS frame values must lie in 0..255")
            fv = fv.astype(np.uint8)
        dt_ticks = max(exposure_us, 1) * (self.video.tps / 1e6)
        # one host -> device copy of N bytes; the carrier is built there
        self._raster_chunk(
            frame_carrier(torch.from_numpy(np.ascontiguousarray(fv))
                          .to(self.device), self.video.ref_time, dt_ticks),
            parts)
        self.dvs_last_ln_val[:] = np.log1p(fv / 255.0)
        self._val_cache[:] = np.nan  # the ln state moved outside the planner

    def consume(self) -> EventArray:
        """One provider packet: its DVS events, the gap to its APS frame
        and the frame, as the mode asks. Raises EOFError once the provider
        is exhausted."""
        packet = next(self._iter, None)
        if packet is None:
            raise EOFError("davis source exhausted")
        if not self.batched:
            return self._consume_oracle(packet)
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

    # -- the scalar oracle (batched=False; adder_tpu/transcoder/davis.py
    # :175-259, :433-478) --

    def _oracle_params(self):
        v = self.video
        crf = v.encoder.options.crf.get_parameters()
        return (
            Mode.Continuous, v.pixel_multi_mode, v.delta_t_max, v.ref_time,
            crf.c_thresh_max, max(crf.c_increase_velocity, 1),
        )

    def integrate_dvs_events(self, events, buffer: list) -> None:
        """Log-space DVS integration (ref: davis.rs:235-465): integrate the
        held intensity over the gap, then step ln intensity by *exp(+-c)."""
        mode, multi, dtm, ref, cmax, cvel = self._oracle_params()
        ticks_per_micro = self.video.tps / 1e6
        W = self.plane.width
        for e in events:
            i = e.y * W + e.x
            px = self._pixels[i]
            last_ln = self.dvs_last_ln_val[i]
            last_val = (np.exp(last_ln) - 1.0) * 255.0
            delta_t_micro = e.t - self.dvs_last_timestamps[i]
            if delta_t_micro == e.t or delta_t_micro < 0:
                self.dvs_last_timestamps[i] = e.t
                continue
            delta_t_ticks = delta_t_micro * ticks_per_micro
            first_integration = max(last_val / ref * delta_t_ticks, 0.0)

            if px.need_to_pop_top:
                buffer.append(px.pop_top_event(first_integration, mode, ref))
            px.integrate(first_integration, delta_t_ticks, mode, dtm, ref,
                         cmax, cvel, multi)
            if px.need_to_pop_top:
                buffer.append(px.pop_top_event(first_integration, mode, ref))

            # the reference multiplies the ln value by exp(+-c) (davis.rs:365)
            last_ln *= np.exp(self.dvs_c if e.on else -self.dvs_c)
            frame_val = (np.exp(last_ln) - 1.0) * 255.0
            frame_val, last_ln = clamp_u8(frame_val, last_ln)
            self.dvs_last_ln_val[i] = last_ln
            fv8 = int(frame_val)
            if fv8 < max(px.base_val - px.c_thresh, 0) or fv8 > min(
                px.base_val + px.c_thresh, 255
            ):
                px.pop_best_events(buffer, mode, multi, ref, frame_val)
                px.base_val = fv8
                ev = px.set_d_for_continuous(frame_val, ref)
                if ev is not None:
                    buffer.append(ev)
            self.dvs_last_timestamps[i] = e.t

    def integrate_frame_gaps(self, start_of_frame_us: int,
                             buffer: list) -> None:
        """Fill per-pixel time up to the APS frame start (ref: davis.rs:466+)."""
        mode, multi, dtm, ref, cmax, cvel = self._oracle_params()
        ticks_per_micro = self.video.tps / 1e6
        for i, px in enumerate(self._pixels):
            gap_us = start_of_frame_us - self.dvs_last_timestamps[i]
            if gap_us <= 0:
                continue
            last_ln = self.dvs_last_ln_val[i]
            last_val = (np.exp(last_ln) - 1.0) * 255.0
            dt_ticks = gap_us * ticks_per_micro
            intensity = max(last_val / ref * dt_ticks, 0.0)
            O.integrate_for_px(
                px, int(max(min(last_val, 255.0), 0.0)), intensity, dt_ticks,
                buffer, mode, multi, dtm, ref, cmax, cvel,
            )
            self.dvs_last_timestamps[i] = start_of_frame_us

    def integrate_frame(self, frame: np.ndarray, exposure_us: int,
                        buffer: list) -> None:
        """Integrate a (deblurred) APS frame like a framed source
        (ref: davis.rs consume, :601-900)."""
        mode, multi, dtm, ref, cmax, cvel = self._oracle_params()
        ticks_per_micro = self.video.tps / 1e6
        dt_ticks = max(exposure_us, 1) * ticks_per_micro
        flat = frame.reshape(-1)
        for i, px in enumerate(self._pixels):
            fv = int(flat[i])
            intensity = fv / ref * dt_ticks
            O.integrate_for_px(
                px, fv, intensity, dt_ticks, buffer, mode, multi, dtm, ref,
                cmax, cvel,
            )
            self.dvs_last_ln_val[i] = np.log1p(fv / 255.0)

    def _consume_oracle(self, packet: DavisPacket) -> EventArray:
        buffer: list = []
        if self.mode in (TranscoderMode.RawDavis, TranscoderMode.RawDvs):
            self.integrate_dvs_events(packet.events, buffer)
        if (self.mode in (TranscoderMode.Framed, TranscoderMode.RawDavis)
                and packet.frame is not None):
            if self.mode == TranscoderMode.RawDavis:
                self.integrate_frame_gaps(packet.frame_start_us, buffer)
            self.integrate_frame(
                packet.frame, packet.frame_end_us - packet.frame_start_us,
                buffer,
            )
            np.copyto(self.dvs_last_timestamps,
                      np.maximum(self.dvs_last_timestamps,
                                 packet.frame_end_us))
        arr = EventArray.from_events(buffer)
        self.video.encoder.ingest_event_array(arr)
        return arr
