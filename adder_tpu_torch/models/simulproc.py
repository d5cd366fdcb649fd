"""Simultaneous transcode + reconstruction pipeline.

Port of `adder_tpu/models/simulproc.py` onto the port's `Framed` and host
`FramerBuilder` (ref: adder-codec-rs/src/utils/simulproc.rs,
SimulProcessor): the reference runs the framer on a rayon-spawned thread fed
by an mpsc channel while the transcoder drives the source on the main
thread (SURVEY P2). Here the framer runs on a Python thread draining a
queue of fetched event batches while the card transcodes the next chunk.
The source is a `Framed` or a `FramedArray` (anything with
`get_video_ref`, `consume_batch`, `video.chunk_frames`, `source_fps` and
`get_video_mut`).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import BinaryIO, Optional

from ..codec.encoder import EncoderOptions, EncoderType
from ..core.types import (
    SOURCE_CAMERA_TO_TYPE,
    PixelMultiMode,
    SourceCamera,
    TimeMode,
)
from ..framer.driver import FramerBuilder
from ..transcoder.framed import Framed


@dataclass
class SimulProcArgs:
    """ref: simulproc.rs:23-85 (clap/toml argument struct)."""

    input_filename: str = ""
    output_events_filename: str = ""
    output_raw_video_filename: str = ""
    color_input: bool = False
    scale: float = 1.0
    ref_time: int = 255
    delta_t_max: int = 7650
    tps: int = 0  # 0 = auto from source fps
    frame_count_max: int = 0
    frame_idx_start: int = 0
    crf: int = 3
    thread_count: int = 1
    time_mode: TimeMode = TimeMode.AbsoluteT
    integration_mode: str = ""  # "collapse" -> Collapse, else Normal


class SimulProcessor:
    """ref: simulproc.rs:96-277"""

    def __init__(
        self,
        source,
        ref_time: int,
        output_raw: Optional[BinaryIO],
        framer_fps: Optional[float] = None,
    ):
        self.source = source
        video = source.get_video_ref()
        meta = video.encoder.meta
        fps = framer_fps or (video.tps / video.ref_time)
        self.framer = (
            FramerBuilder(video.plane)
            .time_parameters(video.tps, video.ref_time, video.delta_t_max, fps)
            .codec_meta(meta.codec_version, video.time_mode)
            .source_info(
                SOURCE_CAMERA_TO_TYPE[meta.source_camera], meta.source_camera
            )
            .finish()
        )
        self.output_raw = output_raw
        self.frames_written = 0
        self._queue: queue.Queue = queue.Queue(maxsize=8)
        self._framer_thread: Optional[threading.Thread] = None
        self._framer_error: Optional[BaseException] = None

    def _framer_loop(self):
        try:
            while True:
                batch = self._queue.get()
                if batch is None:
                    break
                if self.framer.ingest_event_array(batch) and self.output_raw:
                    self.frames_written += self.framer.write_multi_frame_bytes(
                        self.output_raw
                    )
        except BaseException as e:  # surfaced in run()
            self._framer_error = e

    def run(self, max_frames: Optional[int] = None) -> int:
        """Transcode the whole source while reconstructing frames in
        parallel; returns the number of frames written."""
        self._framer_thread = threading.Thread(target=self._framer_loop)
        self._framer_thread.start()
        consumed = 0
        try:
            while max_frames is None or consumed < max_frames:
                try:
                    events = self.source.consume_batch()
                except EOFError:
                    break
                consumed += getattr(self.source.video, "chunk_frames", 1)
                self._queue.put(events)
        finally:
            self._queue.put(None)
            self._framer_thread.join()
        if self._framer_error is not None:
            raise self._framer_error
        # flush the tail: back-fill the final partial frame like the
        # reference's simulproc shutdown
        if self.output_raw:
            if self.framer.flush_frame_buffer():
                self.frames_written += self.framer.write_multi_frame_bytes(
                    self.output_raw
                )
        self.source.get_video_mut().end_write_stream()
        return self.frames_written


def simulproc_from_args(args: SimulProcArgs, events_writer: BinaryIO,
                        raw_writer: Optional[BinaryIO], *, device="cuda"):
    """Build the full simulproc pipeline from CLI-style args
    (ref: bin/adder_simulproc.rs:42-148), transcoding on `device`."""
    source = Framed(
        args.input_filename,
        args.color_input,
        args.scale,
        max_frames=args.frame_count_max or None,
        device=device,
    )
    if args.frame_idx_start:
        source.frame_start(args.frame_idx_start)
    source.auto_time_parameters(args.ref_time, args.delta_t_max, args.time_mode)
    source.crf(args.crf)
    multi_mode = (
        PixelMultiMode.Collapse
        if args.integration_mode.lower() == "collapse"
        else PixelMultiMode.Normal  # ref: bin/adder_simulproc.rs:57-60
    )
    # options carry the same CRF as the builder call, like the reference bin
    # (ref: bin/adder_simulproc.rs:74-90 passes Crf::new(Some(args.crf)))
    options = EncoderOptions.default(source.video.plane)
    options.crf.update_quality(args.crf)
    source.write_out(
        SourceCamera.FramedU8,
        args.time_mode,
        multi_mode,
        None,
        EncoderType.Raw,
        options,
        events_writer,
    )
    # the reference paces reconstruction at the *source* fps, not
    # tps/ref_time — the two differ by float truncation in tpf
    # (ref: simulproc.rs:141-160, driver.rs:356-357)
    return SimulProcessor(
        source, args.ref_time, raw_writer, framer_fps=source.source_fps
    )
