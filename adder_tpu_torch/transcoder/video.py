"""Video: the transcoder runtime tying the chunk kernel to the encoder.

Port of `adder_tpu/transcoder/video.py` (ref: adder-codec-rs
src/transcoder/source/video.rs). The encoder, the codec and the CRF tables
are the port's copies (adder_tpu_torch/codec).
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

from ..ops import fused_kernel, fused_resident
from ..ops import integrate as ops

SHALLOW_DEPTH = 6  # the reference's SmallVec inline capacity

# The engines, named as the JAX package's `Video` selects them
# (adder_tpu/transcoder/video.py:120-136).
RESIDENT, FUSED, SLOTS = "resident", "fused", "slots"
# chunks of at most this many pixel-intervals get the full capacity
# (K_SLOTS events per pixel-interval) at once, so they never rerun for it
FULL_CAP_VOLUME = 1 << 20


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
      where events are never fetched). Events come back in the reference's
      order and sized to the chunk, so there is no capacity or pack rerun;
      the chunk call waits once for the device (the event total sizes the
      buffers).
    - fused (`ADDER_TPU_RESIDENT=0`): `fused_kernel.fused_chunk`, one K5
      launch per frame, events at a running offset kept on the device.
    - slots (`ADDER_TPU_FUSED=0`): `integrate.transcode_chunk`, one K6
      launch per frame and the slot compaction in torch; depth 8 from the
      start.
    The one-interval engines write into buffers of `_cap_mult` x N x T
    events and keep the JAX runtime's rerun contract (`_collect_interval`):
    capacity doubling, the per-interval `take` limit (slots), pack overflow
    (4 lanes, then 16 on fused, K_SLOTS on slots) and capacity decay.
    The arena starts at depth 6 on the resident and fused engines; a chunk
    that outgrows it is rerun at depth 8 from its pre-chunk state, as are
    the chunks submitted after it.

    The display frame: with `_keep_running_frame = True` (a one-interval
    engine only; the resident kernel's display output is not ported and
    raises NotImplementedError), `running_intensities` holds the (H, W, C)
    u8 frame after the last collected chunk, and the next chunk starts from
    the previous in-flight chunk's last frame on the device.
    `_last_runnings` is the last collected chunk's (T, N) frames.

    Two chunks may be in flight: `submit_chunk` launches a chunk on the state
    the previous one left, before that one's events are fetched.

    Not ported (raise NotImplementedError): feature detection,
    save_checkpoint / load_checkpoint.
    """

    def __init__(self, plane: PlaneSize, pixel_tree_mode: Mode,
                 chunk_frames: int = 8, *, device="cuda"):
        self.device = resolve_device(device)
        self.plane = plane
        self.n = plane.volume()
        if self.n >= fused_resident.MAX_PIXELS:
            raise ValueError(
                f"plane of {self.n} pixel-channels: events pack the pixel "
                f"index into 24 bits (at most {fused_resident.MAX_PIXELS - 1})"
            )
        self.pixel_tree_mode = pixel_tree_mode
        self.pixel_multi_mode = PixelMultiMode.Collapse
        self.delta_t_max = 7650
        self.ref_time = 255
        self.tps = 7650
        self.time_mode = TimeMode.AbsoluteT
        self.in_interval_count = 0
        self.chunk_frames = chunk_frames
        self.roi: Optional[Roi] = None
        self.engine = engine_from_env()
        depth = ops.DEPTH if self.engine == SLOTS else SHALLOW_DEPTH
        self.state = ops.init_state(self.n, self.device, depth=depth)
        self._cap_mult = 1  # event capacity = _cap_mult * N * T per chunk
        self._pack = 4  # slot-packing lanes
        self._keep_running = False
        self.running_intensities = np.zeros(plane.shape, dtype=np.uint8)
        self._last_runnings = None

        meta = self._make_meta()
        self.encoder = Encoder.new_empty(meta, EncoderOptions.default(plane))
        self.encoder_type = EncoderType.Empty
        self._inflight: list = []  # submitted, not-yet-collected chunks
        # With an Empty encoder, events can stay on the device ("the void",
        # matching the reference's EmptyOutput bench mode)
        self.void_events = False

    @property
    def _keep_running_frame(self) -> bool:
        return self._keep_running

    @_keep_running_frame.setter
    def _keep_running_frame(self, on: bool) -> None:
        if on and self.engine == RESIDENT:
            raise NotImplementedError(
                "the display frame runs on the one-interval engines "
                "(ADDER_TPU_RESIDENT=0 or ADDER_TPU_FUSED=0); the resident "
                "kernel's display output is not ported yet"
            )
        self._keep_running = bool(on)

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

    def _apply_roi(self) -> None:
        """Lower c_thresh inside the ROI (ref: video.rs:865-881)."""
        if self.roi is None:
            return
        base = min(self.encoder.options.crf.get_parameters().c_thresh_baseline, 2)
        mask = np.zeros(self.plane.shape, dtype=bool)
        mask[
            self.roi.start_y : self.roi.end_y + 1,
            self.roi.start_x : self.roi.end_x + 1,
            :,
        ] = True
        c = self.state.c_thresh.clone()
        c[torch.from_numpy(mask.reshape(-1)).to(self.device)] = base
        self.state = self.state._replace(c_thresh=c)

    def update_detect_features(self, detect_features: bool, *args, **kwargs):
        if detect_features:
            raise NotImplementedError(
                "feature detection is not ported to adder_tpu_torch yet"
            )

    def detect_features(self, detect: bool, show_features=None) -> "Video":
        self.update_detect_features(detect)
        return self

    def save_checkpoint(self, path) -> None:
        raise NotImplementedError("checkpoints are not ported to adder_tpu_torch yet")

    def load_checkpoint(self, path) -> None:
        raise NotImplementedError("checkpoints are not ported to adder_tpu_torch yet")

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
        chunk's capacity and pack (the one-interval engines)."""
        p, frames, t = self._params(), pending["frames"], pending["t"]
        if self.engine == RESIDENT:
            fn = (fused_resident.group_chunk_resident if pending["group"]
                  else fused_resident.fused_chunk_resident)
            return fn(state, frames, t, p)
        if self.engine == FUSED:
            return fused_kernel.fused_chunk(
                state, frames, t, pending["run0"], p, pending["cap"],
                pending["pack"], emit_running=self._keep_running)
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
        frames_t = torch.from_numpy(
            np.ascontiguousarray(flat, dtype=np.uint8)
        ).to(self.device)
        if self.in_interval_count == 0:
            self.state = ops.set_initial_d(self.state, frames_t[0].to(torch.int32))
        self._apply_roi()
        self.in_interval_count += T

        pending = {
            "frames": frames_t,
            "t": float(np.float32(time_spanned)),
            "group": bool(self.void_events) and self.engine == RESIDENT,
            "state_before": self.state,
            "T": T,
        }
        if self.engine != RESIDENT:
            # capacity in power-of-two multiples of N * T; K_SLOTS * N * T
            # bounds every chunk, so small planes get it at once
            mult = min(self._cap_mult, ops.K_SLOTS)
            if self.n * T <= FULL_CAP_VOLUME:
                mult = ops.K_SLOTS
            pending.update(mult=mult, cap=mult * self.n * T, pack=self._pack,
                           run0=self._run0())
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

    def _run0(self) -> torch.Tensor:
        """The display frame a new chunk starts from: the last in-flight
        chunk's last frame, on the device, when the display is kept; else
        the host frame."""
        if self._keep_running and self._inflight:
            return self._inflight[-1]["outs"].runnings[-1]
        return torch.from_numpy(
            self.running_intensities.reshape(-1).copy()).to(self.device)

    def _collect_oldest(self) -> EventArray:
        pending = self._inflight.pop(0)
        if self.engine == RESIDENT:
            return self._collect_resident(pending)
        return self._collect_interval(pending)

    def _collect_resident(self, pending: dict) -> EventArray:
        outs = pending["outs"]
        shallow = pending["state_before"].node_d.shape[0] < ops.DEPTH
        if (int(outs.pmax) >> 16) & 1 and shallow:
            # the arena outgrew the shallow depth: this chunk's state is
            # wrong, and so is every chunk submitted on top of it. Rerun
            # them all, in order, at full depth (which then sticks: the
            # depth is the state's).
            st = ops.pad_state_depth(pending["state_before"], ops.DEPTH)
            outs = pending["outs"] = self._run_chunk(st, pending)
            st = outs.state
            for p2 in self._inflight:
                p2["state_before"] = st
                p2["outs"] = self._run_chunk(st, p2)
                st = p2["outs"].state
            self.state = st
        if pending["group"]:
            return EventArray.empty()
        return self._ingest(outs.pixd, outs.t)

    def _collect_interval(self, pending: dict) -> EventArray:
        """The rerun contract of the JAX runtime's one-interval engines
        (adder_tpu/transcoder/video.py:561-660): one host read of the
        control scalars per pass; reruns go from the untouched pre-chunk
        state."""
        T, mult = pending["T"], pending["mult"]
        fused = self.engine == FUSED
        depth_rerun = False
        while True:
            outs = pending["outs"]
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
            pack_overflow = pack < ops.K_SLOTS and (pmax & 0xFFFF) > pack
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
                pending["cap"] = min(mult, ops.K_SLOTS) * self.n * T
            pending["outs"] = self._run_chunk(pending["state_before"], pending)
        if depth_rerun and self._inflight:
            st, run_prev = outs.state, outs.runnings
            for p2 in self._inflight:
                p2["state_before"] = st
                p2["pack"] = self._pack
                if self._keep_running:  # the device-chained frame is stale
                    p2["run0"] = run_prev[-1]
                p2["outs"] = self._run_chunk(st, p2)
                st, run_prev = p2["outs"].state, p2["outs"].runnings
            self.state = st
        elif not self._inflight:
            self.state = outs.state
        self._last_runnings = outs.runnings
        if self._keep_running:
            self.running_intensities = (
                outs.runnings[-1].cpu().numpy().reshape(self.plane.shape))
        if self.void_events:
            return EventArray.empty()
        return self._ingest(outs.pixd[:total], outs.t[:total])

    def _ingest(self, pixd: torch.Tensor, t: torch.Tensor) -> EventArray:
        """Fetch wire events (`pix << 8 | d`, t as int32 u32 patterns) and
        feed them to the encoder."""
        pixd = pixd.cpu().numpy().view(np.uint32)
        t = t.cpu().numpy().view(np.uint32)
        events = self._events_from_flat(
            (pixd >> 8).astype(np.int64), (pixd & 0xFF).astype(np.uint8), t
        )
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

