"""Framed (conventional video) -> ADΔER sources.

Port of `adder_tpu/transcoder/framed.py` (ref: adder-codec-rs
src/transcoder/source/framed.rs): `FramedArray` (frames the caller holds),
`Framed` (a video file decoded whole, then fed as a FramedArray) and
`FramedStream` (a video file decoded on a producer thread into a bounded
prefetch queue, each chunk submitted while the previous one runs). Always
Mode.FramePerfect, as framed.rs:66 is that mode's sole producer.

The file sources decode with ffmpeg (`ffdec`, the reference's RGB24 bytes)
or with cv2 (BGR, its own YUV arithmetic): `decoder="auto"` takes ffmpeg
when its library builds, else cv2, and the source's `decoder` attribute
says which ran, as the two give different bytes.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from ..core.types import EventArray, Mode, PlaneSize, TimeMode
from ..utils import tracing
from ..utils.cv import handle_color_rgb_videors, handle_color_videors
from . import ffdec
from .video import SourceError, Video, resolve_device


class FramedArray:
    """Array-backed framed source: (T, H, W, C) uint8 frames, transcoded on
    the torch `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, frames: np.ndarray, source_fps: float = 30.0,
                 chunk_frames: int = 8, *, device="cuda"):
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


def _use_ffmpeg(decoder: str) -> bool:
    if decoder not in ("auto", "ffmpeg", "cv2"):
        raise ValueError(f"unknown decoder {decoder!r}")
    return decoder == "ffmpeg" or (decoder == "auto" and ffdec.available())


def _cv2_resize(cv2, frame: np.ndarray, scale: float) -> np.ndarray:
    if scale == 1.0:
        return frame
    h, w = frame.shape[:2]
    return cv2.resize(frame, (int(w * scale), int(h * scale)),
                      interpolation=cv2.INTER_AREA)


class Framed(FramedArray):
    """Video-file framed source (ref: framed.rs:42-122): the whole clip (or
    its first `max_frames`) decoded up front into the array-backed source.
    For long videos use `FramedStream`.

    `decoder`: "ffmpeg" binds the system libavcodec/libswscale
    (native/videodec.cpp), the libraries the reference's video-rs wraps, so
    the RGB24 bytes match the Rust implementation; "cv2" uses OpenCV (its
    YUV->BGR arithmetic differs by +-1 on a few percent of pixels); "auto"
    (default) takes ffmpeg when its library builds, else cv2."""

    def __init__(self, input_path: str, color_input: bool, scale: float = 1.0,
                 chunk_frames: int = 8, max_frames: Optional[int] = None,
                 decoder: str = "auto", *, device="cuda"):
        resolve_device(device)
        use_ffmpeg = _use_ffmpeg(decoder)
        if use_ffmpeg:
            rgb, fps = ffdec.decode_frames(
                str(input_path), scale=scale, max_frames=max_frames
            )
            frames = [handle_color_rgb_videors(f, color_input) for f in rgb]
            fps = fps or 30.0
        else:
            import cv2

            cap = cv2.VideoCapture(str(input_path))
            if not cap.isOpened():
                raise SourceError(f"could not open {input_path}")
            try:
                fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
                frames = []
                while max_frames is None or len(frames) < max_frames:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    frames.append(handle_color_videors(
                        _cv2_resize(cv2, frame, scale), color_input))
            finally:
                cap.release()
        if not frames:
            raise SourceError(f"no frames decoded from {input_path}")
        super().__init__(np.stack(frames), source_fps=fps,
                         chunk_frames=chunk_frames, device=device)
        self.color_input = color_input
        self.scale = scale
        self.decoder = "ffmpeg" if use_ffmpeg else "cv2"


class FramedStream:
    """Streaming framed source: frames decode on a producer thread into a
    bounded prefetch queue, overlapping decode with the card, and chunks
    ride Video's submit/collect pipelining (one chunk stays in flight
    across consume_batch calls).

    Same builder and Source API as FramedArray. Contract difference from
    the eager classes: consume_batch SUBMITS the next chunk and returns the
    events of the previously submitted one (EventArray.empty() on the first
    call); every event still reaches the encoder in reference order, so the
    written `.adder` bytes equal FramedArray's. EOFError comes after the
    pipeline is flushed. An error on the producer thread is raised by the
    consume_batch that reaches it, never turned into an early EOF."""

    def __init__(self, input_path: str, color_input: bool, scale: float = 1.0,
                 chunk_frames: int = 8, max_frames: Optional[int] = None,
                 decoder: str = "auto", prefetch_chunks: int = 3, *,
                 device="cuda"):
        resolve_device(device)
        use_ffmpeg = _use_ffmpeg(decoder)
        self.decoder = "ffmpeg" if use_ffmpeg else "cv2"
        self.color_input = color_input
        self.scale = scale
        self._q: queue.Queue = queue.Queue(
            maxsize=max(prefetch_chunks, 1) * chunk_frames
        )
        self._done = object()
        self._err: Optional[BaseException] = None

        if use_ffmpeg:
            sd = ffdec.StreamDecoder(str(input_path), scale=scale)
            self.source_fps = sd.fps
            W, H = sd.width, sd.height

            def produce():
                try:
                    n = 0
                    while max_frames is None or n < max_frames:
                        f = sd.read()
                        if f is None:
                            break
                        self._q.put(handle_color_rgb_videors(f, color_input))
                        n += 1
                finally:
                    sd.close()
        else:
            import cv2

            cap = cv2.VideoCapture(str(input_path))
            if not cap.isOpened():
                raise SourceError(f"could not open {input_path}")
            self.source_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
            W = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) * scale)
            H = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) * scale)

            def produce():
                try:
                    n = 0
                    while max_frames is None or n < max_frames:
                        ok, frame = cap.read()
                        if not ok:
                            break
                        self._q.put(handle_color_videors(
                            _cv2_resize(cv2, frame, scale), color_input))
                        n += 1
                finally:
                    cap.release()

        C = 3 if color_input else 1
        self.video = Video(PlaneSize(W, H, C), Mode.FramePerfect,
                           chunk_frames=chunk_frames, device=device)
        self.frame_idx = 0

        def run():
            try:
                produce()
            except BaseException as e:  # raised again on the consumer side
                self._err = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        self._exhausted = False

    # -- builder methods (shared contract with FramedArray) --

    auto_time_parameters = FramedArray.auto_time_parameters
    time_parameters = FramedArray.time_parameters
    crf = FramedArray.crf
    quality_manual = FramedArray.quality_manual
    write_out = FramedArray.write_out
    detect_features = FramedArray.detect_features
    get_ref_time = FramedArray.get_ref_time
    get_video_ref = FramedArray.get_video_ref
    get_video_mut = FramedArray.get_video_mut
    get_running_input_bitrate = FramedArray.get_running_input_bitrate

    def _next_chunk(self) -> list:
        frames = []
        with tracing.stage("framed.decode_wait"):
            while len(frames) < self.video.chunk_frames:
                item = self._q.get()
                if item is self._done:
                    self._exhausted = True
                    if self._err is not None:
                        raise self._err
                    break
                frames.append(item)
        return frames

    def consume_batch(self, max_frames=None):
        frames = [] if self._exhausted else self._next_chunk()
        if not frames:
            pending_any = bool(self.video._inflight)
            self.video.flush()
            if not pending_any:
                raise EOFError("source exhausted")
            return EventArray.empty()
        self.frame_idx += len(frames)
        self.video.submit_chunk(np.stack(frames), float(self.video.ref_time))
        if len(self.video._inflight) > 1:
            return self.video._collect_oldest()
        return EventArray.empty()

    def consume(self):
        return self.consume_batch()
