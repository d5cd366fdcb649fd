"""Video: the transcoder runtime tying the chunk kernel to the encoder.

Port of `adder_tpu/transcoder/video.py` (ref: adder-codec-rs
src/transcoder/source/video.rs). The encoder, the codec and the CRF tables
are the port's copies (adder_tpu_torch/codec); FAST and the markers are the
port's `utils/cv.py` and `utils/viz.py`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..codec.encoder import (
    Encoder,
    EncoderOptions,
    EncoderType,
    RawOutput,
)
from ..codec import raw as rawcodec
from ..codec.header import LATEST_CODEC_VERSION, CodecMetadata
from ..codec.rate_controller import Crf
from ..core.types import (
    NO_CHANNEL,
    EventArray,
    Mode,
    PixelMultiMode,
    PlaneSize,
    SourceCamera,
    TimeMode,
)

from .. import convert
from ..ops import fused_kernel, fused_resident
from ..ops import integrate as ops
from ..utils import cv, tracing
from ..utils.viz import ShowFeatureMode, draw_feature_coord, draw_rect

SHALLOW_DEPTH = 6  # the reference's SmallVec inline capacity

# The engines, named as the JAX package's `Video` selects them
# (adder_tpu/transcoder/video.py:120-136).
RESIDENT, FUSED, SLOTS = "resident", "fused", "slots"
# chunks of at most this many pixel-intervals get the full capacity
# (K_SLOTS events per pixel-interval) at once, so they never rerun for it
FULL_CAP_VOLUME = 1 << 20


def event_capacity(mult: int, n: int, T: int) -> int:
    """A chunk's event buffers: `mult` (at most K_SLOTS, the most events a
    pixel-interval emits) x n x T events, as a Python int: at 4K colour,
    K_SLOTS x 24,883,200 x 8 = 2,189,721,600 passes 2^31."""
    return min(mult, ops.K_SLOTS) * n * T


def engine_from_env() -> str:
    """`ADDER_TPU_FUSED=0` selects the interval-slot engine (K6 and the
    torch compaction), else `ADDER_TPU_RESIDENT=0` the fused one-interval
    engine (K5); the default is the resident chunk engine (K1/K2)."""
    if os.environ.get("ADDER_TPU_FUSED") == "0":
        return SLOTS
    if os.environ.get("ADDER_TPU_RESIDENT") == "0":
        return FUSED
    return RESIDENT


class SourceError(Exception):
    pass


@dataclass
class Roi:
    """Region of interest (ref: video.rs:219-223)."""

    start_x: int
    start_y: int
    end_x: int
    end_y: int


def resolve_device(device) -> torch.device:
    """The caller's device, checked: a CUDA device without a card raises;
    nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    return dev


class Video:
    """Shared transcoder engine (ref: video.rs:322-1301), on the torch
    `device` (the card unless the caller asks for the CPU).

    Three engines, chosen at construction from the environment as the JAX
    package chooses them (`engine_from_env`). Each runs a chunk of T frames
    through hand-written kernels on a CUDA device and through their plain
    PyTorch versions on the CPU; all three write the same events.
    - resident (default): `fused_resident.fused_chunk_resident` (or
      `group_chunk_resident` when `void_events` is set: the Empty sink,
      where events are never fetched). One kernel pass over the chunk,
      events in the reference's order, no host read inside the chunk.
    - fused (`ADDER_TPU_RESIDENT=0`): `fused_kernel.fused_chunk`, one K5
      launch per frame, events at a running offset kept on the device.
    - slots (`ADDER_TPU_FUSED=0`): `integrate.transcode_chunk`, one K6
      launch per frame and the slot compaction in torch; depth 8 from the
      start.
    Every engine writes its events into buffers of `_cap_mult` x N x T
    events (the full K_SLOTS x N x T at once where N x T <=
    FULL_CAP_VOLUME) and keeps the JAX runtime's rerun contract
    (`_collect_interval`): one host read of the control scalars when the
    chunk is collected, capacity doubling from the pre-chunk state on
    total > capacity, and capacity decay once a burst has passed; on the
    one-interval engines also the per-interval `take` limit (slots) and
    pack overflow (4 lanes, then 16 on fused, K_SLOTS on slots). The
    resident kernel writes every slot, so it has no pack.
    The arena starts at depth 6 on the resident and fused engines; a chunk
    that outgrows it is rerun at depth 8 from its pre-chunk state, as are
    the chunks submitted after it.

    The display frame: with `_keep_running_frame = True` or feature
    detection on (the JAX package's `emit_running`), every engine's kernels
    also write the (T, N) display frames of each chunk (on the resident
    engine the kernel's RUN variant), `running_intensities` holds the
    (H, W, C) u8 frame after the last collected chunk, and the next chunk
    starts from the previous in-flight chunk's last frame on the device.
    `_last_runnings` is the last collected chunk's (T, N) frames (None on
    the resident engine with the display off).

    Feature detection (`update_detect_features`): after each collected
    chunk, FAST (`cv.fast_mask_torch`) runs on the device over the chunk's
    display frames and only the bits of the candidate coordinates come back;
    the host replays the feature set in stream order, draws the markers on
    `display_frame_features`, lowers `c_thresh` around new features (the
    rate adjustment: a new tensor, never written in place) and clusters
    them (`cluster`). With features on, events are fetched even for the
    Empty sink, as in the JAX package.

    The events' way to the writer (`_collect_interval`): where the encoder
    writes each event's raw record as it comes (a Raw sink, no event drop,
    the Unchanged order) and feature detection is off, a chunk's events
    become `.adder` records on its device (`fused_resident.wire_pack`), the
    host copies the finished bytes into fresh pinned memory and hands them
    to the writer, and `collect_chunk` returns them as a
    `codec.raw.WireEvents` (its fields decoded on first access). Otherwise
    the host fetches the (pix << 8 | d, t) pairs, unpacks them into an
    EventArray and the encoder serialises that.

    The event layout (`_wide`, chosen once from the plane): below 2^24
    pixel-channels an event is the u32 pair (pix << 8 | d, t); at 2^24 and
    above (`fused_resident.wide_layout`: 4K colour is 24,883,200) its
    pixel-and-d word is int64, on the resident engine only, with every sink
    and route; each such chunk adds its events to the counter
    `video.wide_events`. The fused and slot engines, whose kernels keep the
    24-bit field, refuse such planes, and so does the display frame (and
    with it feature detection), which the wide layout does not write. Planes
    of 2^32 pixel-channels and more are refused.

    Two chunks may be in flight: `submit_chunk` launches a chunk on the state
    the previous one left, before that one's events are fetched.
    `save_checkpoint` / `load_checkpoint` write and read the JAX package's
    file layout.
    """

    _trace = "video"  # the tracing stages' prefix

    def __init__(self, plane: PlaneSize, pixel_tree_mode: Mode,
                 chunk_frames: int = 8, *, device="cuda"):
        self.device = resolve_device(device)
        self.plane = plane
        self.n = plane.volume()
        self.engine = engine_from_env()
        self._check_plane_size(self.n, self.engine)
        # the event layout, once from the plane (tests may force it True
        # before the first chunk)
        self._wide = fused_resident.wide_layout(self.n)
        self.pixel_tree_mode = pixel_tree_mode
        self.pixel_multi_mode = PixelMultiMode.Collapse
        self.delta_t_max = 7650
        self.ref_time = 255
        self.tps = 7650
        self.time_mode = TimeMode.AbsoluteT
        self.in_interval_count = 0
        self.chunk_frames = chunk_frames
        self.roi: Optional[Roi] = None
        self.state = self._new_state(
            ops.DEPTH if self.engine == SLOTS else SHALLOW_DEPTH)
        self._cap_mult = 1  # event capacity = _cap_mult * N * T per chunk
        self._pack = 4  # slot-packing lanes
        self._keep_running_frame = False  # set True to always sync display
        self.running_intensities = np.zeros(plane.shape, dtype=np.uint8)
        self._last_runnings = None
        self.feature_detection = False
        self.instantaneous_view_mode = 0  # FramedViewMode.Intensity
        self.show_features = ShowFeatureMode.Off
        self.feature_rate_adjustment = False
        self.feature_cluster = False
        self.features: set = set()  # persistent feature coords (x, y)
        self.display_frame_features = np.zeros(plane.shape, dtype=np.uint8)

        meta = self._make_meta()
        self.encoder = Encoder.new_empty(meta, EncoderOptions.default(plane))
        self.encoder_type = EncoderType.Empty
        self._inflight: list = []  # submitted, not-yet-collected chunks
        # With an Empty encoder, events can stay on the device ("the void",
        # matching the reference's EmptyOutput bench mode)
        self.void_events = False

    @staticmethod
    def _check_plane_size(n: int, engine: str) -> None:
        """Refuse, before anything is allocated, a plane the engine's event
        layout cannot index: 2^24 pixel-channels and more on the fused and
        slot engines (pix << 8 | d), 2^32 and more on the resident one."""
        if engine != RESIDENT and n >= fused_resident.MAX_PIXELS:
            raise ValueError(
                f"plane of {n} pixel-channels: the {engine} engine packs the "
                f"pixel index into 24 bits (at most "
                f"{fused_resident.MAX_PIXELS - 1}); the resident engine takes "
                f"such planes")
        if n >= fused_resident.MAX_WIDE_PIXELS:
            raise ValueError(
                f"plane of {n} pixel-channels: the wide event layout holds "
                f"at most {fused_resident.MAX_WIDE_PIXELS - 1}")

    def _new_state(self, depth: int):
        """The initial state of every pixel, at arena depth `depth`."""
        return ops.init_state(self.n, self.device, depth=depth)

    @property
    def _emit_running(self) -> bool:
        """Whether chunks write the display frames (video.py:342-344)."""
        return bool(self.feature_detection or self._keep_running_frame)

    # -- builder methods (ref: video.rs:271-317 VideoBuilder) --

    def _make_meta(self, source_camera=SourceCamera.FramedU8, adu_interval=0):
        return CodecMetadata(
            codec_version=LATEST_CODEC_VERSION,
            time_mode=self.time_mode,
            plane=self.plane,
            tps=self.tps,
            ref_interval=self.ref_time,
            delta_t_max=self.delta_t_max,
            source_camera=source_camera,
            adu_interval=adu_interval,
        )

    def time_parameters(self, tps: int, ref_time: int, delta_t_max: int,
                        time_mode=None) -> "Video":
        """ref: video.rs:493-537"""
        if delta_t_max < ref_time:
            raise SourceError(f"delta_t_max {delta_t_max} < ref_time {ref_time}")
        self.tps = tps
        self.ref_time = ref_time
        self.delta_t_max = delta_t_max
        if time_mode is not None:
            self.time_mode = TimeMode(time_mode)
        return self

    def write_out(self, source_camera: Optional[SourceCamera],
                  time_mode: Optional[TimeMode],
                  pixel_multi_mode: Optional[PixelMultiMode],
                  adu_interval: Optional[int], encoder_type: EncoderType,
                  encoder_options, write, entropy: str = "cabac") -> "Video":
        """Attach the output encoder (ref: video.rs:546-636)."""
        self.pixel_multi_mode = (
            PixelMultiMode.Collapse if pixel_multi_mode is None
            else pixel_multi_mode
        )
        if time_mode is not None:
            self.time_mode = TimeMode(time_mode)
        meta = self._make_meta(
            source_camera or SourceCamera.FramedU8, adu_interval or 0
        )
        meta.time_mode = self.time_mode
        if encoder_type == EncoderType.Raw:
            self.encoder = Encoder(RawOutput(meta, write), encoder_options)
        elif encoder_type == EncoderType.Compressed:
            self.encoder = Encoder.new_compressed(
                meta, write, encoder_options, entropy=entropy
            )
        else:
            self.encoder = Encoder.new_empty(meta, encoder_options)
        self.encoder_type = encoder_type
        return self

    def end_write_stream(self):
        """Flush pending chunks and close the writer (ref: video.rs:641-648)."""
        self.flush()
        writer = self.encoder.close_writer()
        self.encoder = Encoder.new_empty(self._make_meta(), self.encoder.options)
        return writer

    # -- quality control --

    def _reset_c_thresh(self, base: int) -> None:
        self.state = self.state._replace(
            c_thresh=torch.full((self.n,), base, dtype=torch.int32,
                                device=self.device),
            c_increase_counter=torch.zeros((self.n,), dtype=torch.int32,
                                           device=self.device),
        )

    def update_crf(self, crf: int) -> None:
        """ref: video.rs:1241-1251"""
        self.encoder.options.crf = Crf(crf, self.plane)
        self.encoder.sync_crf()
        self._reset_c_thresh(
            self.encoder.options.crf.get_parameters().c_thresh_baseline
        )

    def update_quality_manual(self, c_thresh_baseline: int, c_thresh_max: int,
                              delta_t_max_multiplier: int,
                              c_increase_velocity: int,
                              feature_c_radius: float) -> None:
        """ref: video.rs:1264-1287"""
        crf = self.encoder.options.crf
        crf.override_c_thresh_baseline(c_thresh_baseline)
        crf.override_c_thresh_max(c_thresh_max)
        crf.override_c_increase_velocity(c_increase_velocity)
        crf.override_feature_c_radius(int(feature_c_radius))
        self.delta_t_max = delta_t_max_multiplier * self.ref_time
        self.encoder.sync_crf()
        self._reset_c_thresh(c_thresh_baseline)

    def update_delta_t_max(self, dtm: int) -> None:
        self.delta_t_max = max(self.ref_time, dtm)

    def update_roi(self, roi: Optional[Roi]) -> None:
        self.roi = roi

    def _roi_mask(self) -> tuple:
        """The (N,) pixel-channels inside the ROI, and the c_thresh they
        take (ref: video.rs:865-881)."""
        base = min(self.encoder.options.crf.get_parameters().c_thresh_baseline, 2)
        mask = np.zeros(self.plane.shape, dtype=bool)
        mask[
            self.roi.start_y : self.roi.end_y + 1,
            self.roi.start_x : self.roi.end_x + 1,
            :,
        ] = True
        return mask.reshape(-1), base

    def _apply_roi(self) -> None:
        """Lower c_thresh inside the ROI (ref: video.rs:865-881)."""
        if self.roi is None:
            return
        mask, base = self._roi_mask()
        c = self.state.c_thresh.clone()
        c[torch.from_numpy(mask).to(self.device)] = base
        self.state = self.state._replace(c_thresh=c)

    # -- getters (API parity) --

    def get_ref_time(self):
        return self.ref_time

    def get_delta_t_max(self):
        return self.delta_t_max

    def get_tps(self):
        return self.tps

    def get_time_mode(self):
        return self.time_mode

    def get_encoder_options(self):
        return self.encoder.get_options()

    def get_event_size(self):
        return self.encoder.meta.event_size

    # -- transcoding --

    def _params(self) -> ops.TranscodeParams:
        p = self.encoder.options.crf.get_parameters()
        return ops.TranscodeParams(
            mode=int(self.pixel_tree_mode),
            multi_mode=int(self.pixel_multi_mode),
            time_mode=int(self.time_mode),
            ref_time=self.ref_time,
            delta_t_max=self.delta_t_max,
            c_thresh_max=p.c_thresh_max,
            c_increase_velocity=max(p.c_increase_velocity, 1),
        )

    def _run_chunk(self, state, pending: dict):
        """One chunk from `state` on the Video's engine, at the pending
        chunk's capacity (and, on the one-interval engines, its pack)."""
        p, frames, t = self._params(), pending["frames"], pending["t"]
        if self.engine == RESIDENT:
            if pending["group"]:
                return fused_resident.group_chunk_resident(
                    state, frames, t, p, pending["run0"])
            return fused_resident.fused_chunk_resident(
                state, frames, t, p, pending["run0"],
                event_cap=pending["cap"], wide=self._wide)
        if self.engine == FUSED:
            return fused_kernel.fused_chunk(
                state, frames, t, pending["run0"], p, pending["cap"],
                pending["pack"], emit_running=self._emit_running)
        return ops.transcode_chunk(state, frames, t, pending["run0"], p,
                                   pending["cap"], pending["pack"])

    def integrate_matrix(self, matrix: np.ndarray,
                         time_spanned: float) -> EventArray:
        """Transcode one input interval (ref: video.rs:651-778)."""
        matrix = np.asarray(matrix)
        if matrix.ndim == 2:
            matrix = matrix[..., None]
        return self.integrate_matrix_batch(matrix[None, ...], time_spanned)

    def integrate_matrix_batch(self, frames: np.ndarray,
                               time_spanned: Optional[float] = None
                               ) -> EventArray:
        """Transcode T frames (T, H, W, C) through one device chunk."""
        return self.collect_chunk(self.submit_chunk(frames, time_spanned))

    def submit_chunk(self, frames: np.ndarray, time_spanned=None) -> dict:
        """Launch a chunk on the current state; pair with collect_chunk.
        At most two chunks stay in flight; older ones are collected here, in
        order."""
        frames = np.asarray(frames)
        T = frames.shape[0]
        flat = frames.reshape(T, -1)
        if flat.shape[1] != self.n:
            raise SourceError(
                f"frame shape {frames.shape[1:]} != plane {self.plane.shape}"
            )
        if time_spanned is None:
            time_spanned = float(self.ref_time)
        if self._wide and self._emit_running:
            raise ValueError(
                f"plane of {self.n} pixel-channels: the wide event layout "
                f"writes no display frame, so neither the display nor "
                f"feature detection runs on it")
        with tracing.stage("video.upload", items=T * self.n):
            frames_t = torch.from_numpy(
                np.ascontiguousarray(flat, dtype=np.uint8)
            ).to(self.device)
        if self.in_interval_count == 0:
            self.state = ops.set_initial_d(self.state, frames_t[0].to(torch.int32))
        self._apply_roi()
        self.in_interval_count += T

        # the Empty sink on the resident engine runs the VOID pass, unless
        # features need the events (video.py:472-477)
        pending = {
            "frames": frames_t,
            "t": float(np.float32(time_spanned)),
            "group": (bool(self.void_events) and self.engine == RESIDENT
                      and not self.feature_detection),
            "state_before": self.state,
            "T": T,
            "run0": self._run0(),
        }
        if not pending["group"]:
            # capacity in power-of-two multiples of N * T; K_SLOTS * N * T
            # bounds every chunk, so small planes get it at once
            mult = min(self._cap_mult, ops.K_SLOTS)
            if self.n * T <= FULL_CAP_VOLUME:
                mult = ops.K_SLOTS
            pending.update(mult=mult, cap=event_capacity(mult, self.n, T),
                           pack=self._pack)
        with tracing.stage("video.submit_chunk", items=T * self.n):
            pending["outs"] = self._run_chunk(self.state, pending)
        self.state = pending["outs"].state
        self._inflight.append(pending)
        while len(self._inflight) > 2:
            self._collect_oldest()
        return pending

    def collect_chunk(self, pending: dict) -> EventArray:
        """Block on a submitted chunk (collecting older ones first, in
        order); feed its events to the encoder."""
        ev = None
        while any(p is pending for p in self._inflight):
            ev = self._collect_oldest()
        if ev is None:
            raise SourceError("collect_chunk: unknown pending handle")
        return ev

    def _run0(self) -> Optional[torch.Tensor]:
        """The display frame a new chunk starts from: the last in-flight
        chunk's last frame, on the device, when the display is kept; else
        the host frame. None on the resident engine with the display off
        (its kernel then writes none)."""
        if self._emit_running and self._inflight:
            return self._runnings(self._inflight[-1]["outs"])[-1]
        if self.engine == RESIDENT and not self._emit_running:
            return None
        return torch.from_numpy(
            self.running_intensities.reshape(-1).copy()).to(self.device)

    def _collect_oldest(self) -> EventArray:
        pending = self._inflight.pop(0)
        if pending["group"]:
            return self._collect_group(pending)
        return self._collect_interval(pending)

    def _collect_group(self, pending: dict) -> EventArray:
        """A resident Empty-sink chunk: one host read, the depth flag
        (video.py:533-559)."""
        outs = pending["outs"]
        shallow = pending["state_before"].node_d.shape[0] < ops.DEPTH
        with tracing.stage("video.collect.control_fetch"):
            flags = int(outs.pmax)
        if (flags >> 16) & 1 and shallow:
            # the arena outgrew the shallow depth: this chunk's state is
            # wrong, and so is every chunk submitted on top of it. Rerun
            # them all, in order, at full depth (which then sticks: the
            # depth is the state's).
            st = ops.pad_state_depth(pending["state_before"], ops.DEPTH)
            with tracing.stage("video.rerun"):
                outs = pending["outs"] = self._run_chunk(st, pending)
            self.state = self._rerun_inflight(outs)
        elif not self._inflight:
            # the newest chunk: its own state, without the rate adjustment
            # of the chunk collected before it (video.py:648-649)
            self.state = outs.state
        return self._finish_chunk(outs, None)

    def _collect_interval(self, pending: dict) -> EventArray:
        """The rerun contract of the JAX runtime (adder_tpu/transcoder/
        video.py:561-660), on every engine's chunk with events: one host
        read of the control scalars per pass; reruns go from the untouched
        pre-chunk state. The resident chunk takes the fused engine's rules
        (any interval may fill the buffer; the depth flag), without pack."""
        T, mult = pending["T"], pending["mult"]
        fused = self.engine in (FUSED, RESIDENT)
        depth_rerun = False
        while True:
            outs = pending["outs"]
            with tracing.stage("video.collect.control_fetch"):
                total, per_max, pmax = (int(x) for x in torch.stack(
                    [outs.total, outs.per_interval.max(), outs.pmax]).tolist())
            cap, pack = pending["cap"], pending["pack"]
            if fused:  # any interval may fill the rest of the buffer
                take = cap
                overflowed = total > cap
            else:
                take = ops.per_interval_take(cap, T)
                overflowed = total > cap or per_max > min(
                    take, ops.K_SLOTS * self.n)
            depth_overflow = fused and bool(pmax >> 16)
            pack_overflow = (self.engine != RESIDENT and pack < ops.K_SLOTS
                             and (pmax & 0xFFFF) > pack)
            if not overflowed and not pack_overflow:
                # decay the capacity once a burst has passed
                if per_max * 8 < take and self._cap_mult > 1:
                    self._cap_mult //= 2
            shallow = pending["state_before"].node_d.shape[0] < ops.DEPTH
            if depth_overflow and shallow:
                # the carried state is wrong: the chunks submitted on top of
                # it are recomputed below
                depth_rerun = True
                pending["state_before"] = ops.pad_state_depth(
                    pending["state_before"], ops.DEPTH)
            elif pack_overflow:
                self._pack = pending["pack"] = 16 if fused else ops.K_SLOTS
            elif not overflowed or mult >= ops.K_SLOTS:
                break
            else:  # capacity overflow: grow the buffer
                mult *= 2
                self._cap_mult = mult
                pending["cap"] = event_capacity(mult, self.n, T)
            with tracing.stage("video.rerun"):
                pending["outs"] = self._run_chunk(pending["state_before"],
                                                  pending)
        if depth_rerun and self._inflight:
            self.state = self._rerun_inflight(outs)
        elif not self._inflight:
            self.state = outs.state
        if self.void_events and not self.feature_detection:
            wire = None
        else:
            if self._wide:
                tracing.add_items(f"{self._trace}.wide_events", total)
            if self._packs_records():
                wire = self._fetch_records(outs.pixd[:total], outs.t[:total])
            else:
                wire = self._fetch(outs.pixd[:total], outs.t[:total])
        return self._finish_chunk(outs, wire)

    def _rerun_inflight(self, outs):
        """After a depth rerun: the chunks submitted on top of the rerun one
        ran on its wrong state, and their device-chained display frame is
        stale too. Rerun them, in order, from the corrected chain
        (video.py:631-647); return the newest state."""
        st, prev = outs.state, outs
        for p2 in self._inflight:
            p2["state_before"] = st
            p2["pack"] = self._pack
            if self._emit_running:
                p2["run0"] = self._runnings(prev)[-1]
            with tracing.stage("video.rerun"):
                p2["outs"] = self._run_chunk(st, p2)
            st, prev = p2["outs"].state, p2["outs"]
        return st

    def _finish_chunk(self, outs, wire) -> EventArray:
        """The collected chunk's display frame, then its events (`wire`:
        the host pair `_fetch` gives, the records `_fetch_records` gives, or
        None when they stay on the device) fed to the encoder, then the
        features (video.py:656-693)."""
        self._last_runnings = outs.runnings
        if self._emit_running:
            self._last_runnings = self._runnings(outs)
            self.running_intensities = self._last_runnings[-1].cpu().numpy(
            ).reshape(self.plane.shape)
        if wire is None:
            return EventArray.empty()
        if isinstance(wire, rawcodec.WireEvents):
            return self._write_records(wire)
        events = self._encode(*wire)
        if self.feature_detection:
            self._handle_features(events, outs.per_interval.cpu().numpy(),
                                  self._last_runnings)
        return events

    def _runnings(self, outs) -> torch.Tensor:
        """A chunk's (T, N) display frames. A resident chunk submitted with
        the display off wrote none; read after the display was turned on, it
        counts as the JAX resident chunk's all-zero frames
        (fused_resident.py:897-899)."""
        if outs.runnings is not None:
            return outs.runnings
        return torch.zeros((outs.per_interval.shape[0], self.n),
                           dtype=torch.uint8, device=self.device)

    def _fetch(self, pixd: torch.Tensor, t: torch.Tensor) -> tuple:
        """Wire events (`pix << 8 | d`, t as int32 u32 patterns) to the
        host, as uint32 arrays; in the wide layout pixd is int64 on both."""
        with tracing.stage("video.collect.event_fetch", items=pixd.numel()):
            pd = pixd.cpu().numpy()
            return (pd if pd.dtype == np.int64 else pd.view(np.uint32),
                    t.cpu().numpy().view(np.uint32))

    def _packs_records(self) -> bool:
        """Whether a chunk's events reach the writer as `.adder` records
        made on the chunk's device (`_fetch_records`): the encoder writes
        each event's record as it comes (a Raw sink, no event drop, the
        Unchanged order) and no feature detection reads the host events."""
        return (self.encoder.writes_records_unchanged()
                and not self.feature_detection)

    def _fetch_records(self, pixd: torch.Tensor,
                       t: torch.Tensor) -> rawcodec.WireEvents:
        """Wire events (`pix << 8 | d`, t) to their `.adder` records on
        their device (`fused_resident.wire_pack`), then into fresh host
        memory, pinned from a card: a writer may keep the buffer it is
        handed, so none is reused. A chunk without events launches
        nothing."""
        n = pixd.numel()
        with tracing.stage(f"{self._trace}.unpack", items=n):
            records = fused_resident.wire_pack(pixd, t, self.plane.width,
                                               self.plane.channels)
            if n:
                tracing.add_items(f"{self._trace}.wire_pack", 1)
        with tracing.stage("video.collect.event_fetch", items=n):
            if records.is_cuda:
                pinned = torch.empty(records.numel(), dtype=torch.uint8,
                                     pin_memory=True)
                records = pinned.copy_(records)  # waits for the copy
        return rawcodec.WireEvents(records.numpy(), self.plane.channels)

    def _write_records(self, events: rawcodec.WireEvents) -> EventArray:
        """A chunk's `.adder` records to the writer, as they are."""
        with tracing.stage(f"{self._trace}.encode", items=len(events)):
            self.encoder.ingest_records(events.records)
        return events

    def _encode(self, pixd: np.ndarray, t: np.ndarray) -> EventArray:
        """Host wire events (`pix << 8 | d`: uint32, or int64 in the wide
        layout; t uint32) to an EventArray, fed to the encoder."""
        with tracing.stage(f"{self._trace}.unpack", items=len(pixd)):
            events = self._events_from_flat(
                (pixd >> 8).astype(np.int64), (pixd & 0xFF).astype(np.uint8),
                t)
        with tracing.stage(f"{self._trace}.encode", items=len(events)):
            self.encoder.ingest_event_array(events)
        return events

    def _events_from_flat(self, pix, d, t) -> EventArray:
        C = self.plane.channels
        W = self.plane.width
        if C > 1:
            c = (pix % C).astype(np.uint8)
        else:
            c = np.full(len(pix), NO_CHANNEL, np.uint8)
        xy = pix // C
        x = (xy % W).astype(np.uint16)
        y = (xy // W).astype(np.uint16)
        return EventArray(x, y, c, d, t)

    def flush(self) -> None:
        """Collect any in-flight chunks (their events reach the encoder)."""
        while self._inflight:
            self._collect_oldest()

    # -- feature pipeline (ref: video.rs:883-1227) --

    def update_detect_features(self, detect_features: bool,
                               show_features=ShowFeatureMode.Off,
                               feature_rate_adjustment: bool = False,
                               feature_cluster: bool = False) -> None:
        self.feature_detection = detect_features
        self.show_features = show_features
        self.feature_rate_adjustment = feature_rate_adjustment
        self.feature_cluster = feature_cluster

    def detect_features(self, detect: bool, show_features=None) -> "Video":
        self.feature_detection = detect
        return self

    def _handle_features(self, events: EventArray, per_int: np.ndarray,
                         runnings: torch.Tensor) -> None:
        """Per-interval FAST feature maintenance over the event coordinates
        (ref: video.rs:883-1112; adder_tpu/transcoder/video.py:709-812).
        Candidate coords are gathered on the host (vector numpy over the
        chunk's events); the FAST masks are computed on the device over the
        chunk's display frames and only the candidates' corner bits come
        back."""
        H, W = self.plane.height, self.plane.width
        offsets = np.concatenate([[0], np.cumsum(per_int)])
        self.display_frame_features = self.running_intensities.copy()
        # ONE pass over the chunk's events (no per-interval Python loop):
        # candidate rule - channel 0/None, non-empty d, coord differs from
        # the circularly-next event's coord WITHIN its interval
        # (ref: video.rs:900-917). The circular next is arange+1 with each
        # interval's last event wrapping to that interval's first.
        n_ev = len(events)
        xs, ys, cs, ds = events.x, events.y, events.c, events.d
        nxt = np.arange(1, n_ev + 1, dtype=np.int64)
        ends = offsets[1:] - 1
        starts = offsets[:-1]
        nonempty = ends >= starts
        nxt[ends[nonempty]] = starts[nonempty]
        cand = (
            ((cs == NO_CHANNEL) | (cs == 0))
            & (ds != 255)
            & ((xs != xs[nxt]) | (ys != ys[nxt]))
        )
        ci = np.flatnonzero(cand)

        new_features: list = []
        if len(ci):
            ii = np.repeat(
                np.arange(len(per_int), dtype=np.int32), per_int
            )[ci]
            xx = xs[ci].astype(np.int32)
            yy = ys[ci].astype(np.int32)
            with tracing.stage("video.features.mask_lookup", items=len(ci)):
                is_f = self._feature_mask_lookup(runnings, ii, yy, xx)
            # Exact replay of the stream-order set updates, vectorized:
            # membership after the chunk = the key's LAST candidate's mask
            # bit, and a key was ADDED iff some candidate has f=True while
            # the previous state was False (previous candidate's bit, or
            # the pre-chunk set membership for the key's first candidate).
            key = yy.astype(np.int64) * W + xx
            sk = np.lexsort((np.arange(len(key)), key))
            k_s, f_s = key[sk], is_f[sk]
            first = np.ones(len(k_s), bool)
            first[1:] = k_s[1:] != k_s[:-1]
            last = np.empty(len(k_s), bool)
            last[:-1] = first[1:]
            last[-1] = True
            prev = np.empty(len(k_s), bool)
            prev[1:] = f_s[:-1]
            uk = k_s[first]
            ux, uy = (uk % W).astype(int), (uk // W).astype(int)
            prev[first] = [
                (int(x), int(y)) in self.features for x, y in zip(ux, uy)
            ]
            added = np.logical_and(f_s, ~prev)
            added_any = np.logical_or.reduceat(added, np.flatnonzero(first))
            final_f = f_s[last]
            for x, y, fin, add in zip(ux, uy, final_f, added_any):
                k = (int(x), int(y))
                if add:
                    new_features.append(k)
                if fin:
                    self.features.add(k)
                else:
                    self.features.discard(k)

        params = self.encoder.options.crf.get_parameters()
        if self.show_features == ShowFeatureMode.Hold:
            for (x, y) in self.features:
                draw_feature_coord(
                    x, y, self.display_frame_features, self.plane.channels != 1
                )
        if self.show_features == ShowFeatureMode.Instant:
            for (x, y) in set(new_features):
                draw_feature_coord(
                    x, y, self.display_frame_features, self.plane.channels != 1
                )
        if (
            self.feature_rate_adjustment
            and params.feature_c_radius > 0
            and new_features
        ):
            # one state fetch and one new tensor for ALL new features: the
            # old c_thresh may still be read by a pending rerun, so it is
            # never written in place
            r = params.feature_c_radius
            c = self._c_thresh_numpy()
            c3 = c.reshape(self.plane.shape[:2] + (-1,))
            for (x, y) in set(new_features):
                lo_y, hi_y = max(y - r, 0), min(y + r, H - 1)
                lo_x, hi_x = max(x - r, 0), min(x + r, W - 1)
                c3[lo_y : hi_y + 1, lo_x : hi_x + 1, :] = min(
                    params.c_thresh_baseline, 2
                )
            self._put_c_thresh(c)
        if self.feature_cluster and new_features:
            self.cluster(set(new_features))

    def _c_thresh_numpy(self) -> np.ndarray:
        """A host copy of every pixel's c_thresh (N,)."""
        return self.state.c_thresh.cpu().numpy().copy()

    def _put_c_thresh(self, c: np.ndarray) -> None:
        """Replace c_thresh by the host (N,) `c`: a new tensor, never
        written in place."""
        self.state = self.state._replace(
            c_thresh=torch.from_numpy(c).to(self.device))

    def _feature_mask_lookup(self, runnings: torch.Tensor, ii, yy,
                             xx) -> np.ndarray:
        """FAST-corner bits for candidate (interval, y, x) coords: the
        batched `cv.fast_mask_torch` over the chunk's (T, N) display frames
        (channel 0), gathered on their device (video.py:55-71, :814-831)."""
        H, W, C = self.plane.height, self.plane.width, self.plane.channels
        frames = runnings.reshape(runnings.shape[0], H, W, C)[..., 0]
        masks = cv.fast_mask_torch(frames)
        idx = torch.from_numpy(np.stack([ii, yy, xx]).astype(np.int64)).to(
            runnings.device)
        return masks[idx[0], idx[1], idx[2]].cpu().numpy()

    def cluster(self, points_set: set) -> list:
        """DBSCAN over feature coordinates; returns bounding boxes
        (ref: video.rs:1114-1227: eps = min_resolution/3, min_pts = 3)."""
        points = np.array(sorted(points_set), dtype=np.float32)
        if len(points) < 3:
            return []
        eps2 = (self.plane.min_resolution() / 3.0) ** 2
        min_pts = 3
        d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        neighbors = [np.flatnonzero(d2[i] <= eps2) for i in range(len(points))]
        visited = np.zeros(len(points), dtype=bool)
        clusters = []
        for i in range(len(points)):
            if visited[i]:
                continue
            visited[i] = True
            if len(neighbors[i]) < min_pts:
                continue
            cluster = {i}
            frontier = list(neighbors[i])
            k = 0
            while k < len(frontier):
                j = frontier[k]
                if not visited[j]:
                    visited[j] = True
                    if len(neighbors[j]) >= min_pts:
                        frontier.extend(
                            n for n in neighbors[j] if n not in cluster
                        )
                cluster.add(j)
                k += 1
            clusters.append(cluster)
        bboxes = []
        for cluster in clusters:
            pts = points[list(cluster)]
            min_x, min_y = pts.min(axis=0).astype(int)
            max_x, max_y = pts.max(axis=0).astype(int)
            if (max_x - min_x) * (max_y - min_y) < self.plane.area_wh() // 4:
                bboxes.append((int(min_x), int(min_y), int(max_x), int(max_y)))
                draw_rect(
                    int(min_x), int(min_y), int(max_x), int(max_y),
                    self.display_frame_features, self.plane.channels != 1,
                )
        return bboxes

    # -- checkpoint / resume (video.py:894-937; the reference has none) --

    def save_checkpoint(self, path) -> None:
        """Persist the transcoder state so a long job can resume mid-stream
        (pair with the encoder's byte position, which the caller owns), in
        the JAX package's layout: the interval counter, the plane volume
        (`n_state` is `n`: the port pads no plane), the arena depth, the
        display frame and each PixelState field as `state_<field>`."""
        self.flush()
        fields = self._state_numpy()
        state = {f"state_{k}": v for k, v in fields.items()}
        np.savez_compressed(
            path,
            in_interval_count=np.int64(self.in_interval_count),
            n=np.int64(self.n),
            n_state=np.int64(self.n),
            depth=np.int64(fields["node_d"].shape[0]),
            running_intensities=self.running_intensities,
            **state,
        )

    def _state_numpy(self) -> dict:
        """The whole plane's state, field name -> host numpy array."""
        return convert.state_to_numpy(self.state)

    def load_checkpoint(self, path) -> None:
        """Restore state saved by either package's save_checkpoint (same
        plane and configuration). The slot engine runs depth 8, so it pads a
        depth-6 arena (video.py:931-935)."""
        z = np.load(path)
        if int(z["n"]) != self.n:
            raise SourceError(
                f"checkpoint plane volume {int(z['n'])} != {self.n}"
            )
        if int(z["n_state"]) != self.n:
            raise SourceError(
                "checkpoint was taken with a different kernel padding"
            )
        self.state = convert.state_from_numpy(
            {k: z[f"state_{k}"] for k in ops.PixelState._fields}, self.device)
        if self.engine == SLOTS:
            self.state = ops.pad_state_depth(self.state, ops.DEPTH)
        self.in_interval_count = int(z["in_interval_count"])
        self.running_intensities = z["running_intensities"]

