"""Framed (conventional video) -> ADΔER source, array-backed.

Port of `adder_tpu/transcoder/framed.py::FramedArray` (ref:
adder-codec-rs src/transcoder/source/framed.rs). Always Mode.FramePerfect,
as framed.rs:66 is that mode's sole producer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from adder_tpu.core.types import Mode, PlaneSize, TimeMode

from .video import SourceError, Video


class FramedArray:
    """Array-backed framed source: (T, H, W, C) uint8 frames, transcoded on
    the torch `device` the caller names."""

    def __init__(self, frames: np.ndarray, source_fps: float = 30.0,
                 chunk_frames: int = 8, *, device):
        frames = np.asarray(frames)
        if frames.ndim == 3:
            frames = frames[..., None]
        self.frames = frames.astype(np.uint8)
        self.source_fps = source_fps
        _, H, W, C = self.frames.shape
        self.video = Video(PlaneSize(W, H, C), Mode.FramePerfect,
                           chunk_frames=chunk_frames, device=device)
        self.frame_idx = 0
        self.frame_idx_start = 0

    # -- builder methods (ref: framed.rs:94-111, VideoBuilder impl) --

    def frame_start(self, frame_idx_start: int) -> "FramedArray":
        if frame_idx_start >= len(self.frames):
            raise SourceError(f"start frame {frame_idx_start} out of bounds")
        self.frame_idx = self.frame_idx_start = frame_idx_start
        return self

    def auto_time_parameters(self, ref_time: int, delta_t_max: int,
                             time_mode: Optional[TimeMode] = None
                             ) -> "FramedArray":
        """tps = ref_time * fps (ref: framed.rs:94-111)."""
        tps = int(ref_time * self.source_fps)
        return self.time_parameters(tps, ref_time, delta_t_max, time_mode)

    def time_parameters(self, tps, ref_time, delta_t_max, time_mode=None):
        if delta_t_max % ref_time != 0:
            raise SourceError("delta_t_max must be a multiple of ref_time")
        self.video.time_parameters(tps, ref_time, delta_t_max, time_mode)
        return self

    def crf(self, crf: int) -> "FramedArray":
        self.video.update_crf(crf)
        return self

    def quality_manual(self, *args) -> "FramedArray":
        self.video.update_quality_manual(*args)
        return self

    def write_out(self, source_camera, time_mode, pixel_multi_mode,
                  adu_interval, encoder_type, encoder_options, write,
                  **kwargs):
        self.video.write_out(
            source_camera, time_mode, pixel_multi_mode, adu_interval,
            encoder_type, encoder_options, write, **kwargs,
        )
        return self

    def detect_features(self, detect, show_features=None):
        self.video.detect_features(detect, show_features)
        return self

    def get_ref_time(self):
        return self.video.ref_time

    def get_video_ref(self):
        return self.video

    def get_video_mut(self):
        return self.video

    # -- Source trait (ref: video.rs:1419-1442) --

    def consume(self):
        """One input interval (ref: framed.rs:127-157)."""
        if self.frame_idx >= len(self.frames):
            raise EOFError("source exhausted")
        frame = self.frames[self.frame_idx]
        self.frame_idx += 1
        return self.video.integrate_matrix(frame, float(self.video.ref_time))

    def consume_batch(self, max_frames: Optional[int] = None):
        """Transcode up to chunk_frames frames as one device chunk."""
        t = self.video.chunk_frames if max_frames is None else max_frames
        if self.frame_idx >= len(self.frames):
            raise EOFError("source exhausted")
        chunk = self.frames[self.frame_idx : self.frame_idx + t]
        self.frame_idx += len(chunk)
        return self.video.integrate_matrix_batch(
            chunk, float(self.video.ref_time)
        )

    def get_running_input_bitrate(self) -> float:
        v = self.video
        return v.tps / v.ref_time * v.plane.volume() * 8.0
