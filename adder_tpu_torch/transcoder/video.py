"""Video: the transcoder runtime tying the chunk kernel to the encoder.

Port of `adder_tpu/transcoder/video.py` (ref: adder-codec-rs
src/transcoder/source/video.rs). The encoder, the codec and the CRF tables
are the JAX package's host-only modules, shared by import.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from adder_tpu.codec.encoder import (
    Encoder,
    EncoderOptions,
    EncoderType,
    RawOutput,
)
from adder_tpu.codec.header import LATEST_CODEC_VERSION, CodecMetadata
from adder_tpu.codec.rate_controller import Crf
from adder_tpu.core.types import (
    NO_CHANNEL,
    EventArray,
    Mode,
    PixelMultiMode,
    PlaneSize,
    SourceCamera,
    TimeMode,
)

from ..ops import fused_resident
from ..ops import integrate as ops

SHALLOW_DEPTH = 6  # the reference's SmallVec inline capacity


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
    """The caller's device, checked: no automatic choice, no silent CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    return dev


class Video:
    """Shared transcoder engine (ref: video.rs:322-1301), on an explicit
    torch `device`.

    Each chunk of T frames goes through one call of
    `ops.fused_resident.fused_chunk_resident` (or `group_chunk_resident`
    when `void_events` is set: the Empty-sink path, where events are never
    fetched). On a CUDA device that is the hand-written kernel; on the CPU
    its plain PyTorch version. Events come back in the reference's order, so
    there is no capacity or pack rerun and no host assembler. The arena
    starts at depth 6 and a chunk that overflows it is rerun at depth 8 from
    its pre-chunk state, as are the chunks submitted after it.

    Two chunks may be in flight: `submit_chunk` launches a chunk on the state
    the previous one left, before that one's events are fetched. On the
    fetched path the chunk call itself waits once for the device: the
    event total, read between the kernel's COUNT and WRITE passes, sizes the
    event buffers. That one sync per chunk is accepted.

    Not ported (raise NotImplementedError): feature detection and the
    display intensity it needs, save_checkpoint / load_checkpoint.
    """

    def __init__(self, plane: PlaneSize, pixel_tree_mode: Mode,
                 chunk_frames: int = 8, *, device):
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
        self.state = ops.init_state(self.n, self.device, depth=SHALLOW_DEPTH)

        meta = self._make_meta()
        self.encoder = Encoder.new_empty(meta, EncoderOptions.default(plane))
        self.encoder_type = EncoderType.Empty
        self._inflight: list = []  # submitted, not-yet-collected chunks
        # With an Empty encoder, events can stay on the device ("the void",
        # matching the reference's EmptyOutput bench mode)
        self.void_events = False

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

    def _run_chunk(self, state, pending: dict) -> fused_resident.ChunkResult:
        fn = (fused_resident.group_chunk_resident if pending["group"]
              else fused_resident.fused_chunk_resident)
        return fn(state, pending["frames"], pending["t"], self._params())

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
            "group": bool(self.void_events),
            "state_before": self.state,
        }
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

    def _collect_oldest(self) -> EventArray:
        pending = self._inflight.pop(0)
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
        pixd = outs.pixd.cpu().numpy().view(np.uint32)
        t = outs.t.cpu().numpy().view(np.uint32)
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

