"""ADDER stream player: decode -> frames with pacing, looping, seeking.

Copy of `adder_tpu/models/player.py` over the port's decoder and host
framer; the port keeps its own copy and imports nothing of the JAX package.

Headless equivalent of adder-viz's player task
(ref: adder-viz/src/player/adder.rs:62-443): decodes a `.adder` file into a
FrameSequence, yields frames at the stream rate, supports looping via
`set_input_stream_position` (raw streams seek to any event boundary;
compressed streams restart at ADU boundaries) and live view-mode switching.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..codec.decoder import open_file_decoder
from ..core.types import SOURCE_CAMERA_TO_TYPE
from ..framer.driver import FramerBuilder, FrameSequence
from ..framer.scale_intensity import FramedViewMode


@dataclass
class PlayerStats:
    """Live playback statistics (ref: adder-viz TranscoderInfoMsg plots)."""

    events_total: int = 0
    events_per_sec: float = 0.0
    frames_emitted: int = 0
    bitrate_bps: float = 0.0


class AdderPlayer:
    def __init__(
        self,
        path: str,
        view_mode: FramedViewMode = FramedViewMode.Intensity,
        playback_speed: float = 1.0,
        buffer_limit: Optional[int] = 60,
    ):
        self.path = path
        self.view_mode = view_mode
        self.playback_speed = playback_speed
        self.buffer_limit = buffer_limit
        self.stats = PlayerStats()
        self._open()

    def _open(self) -> None:
        self.decoder = open_file_decoder(self.path)
        m = self.decoder.meta
        self.meta = m
        fps = m.tps / max(m.ref_interval, 1)
        b = FramerBuilder(m.plane)
        b.buffer_limit = self.buffer_limit
        self.framer: FrameSequence = (
            b.time_parameters(m.tps, m.ref_interval, m.delta_t_max, fps)
            .codec_meta(m.codec_version, m.time_mode)
            .source_info(SOURCE_CAMERA_TO_TYPE[m.source_camera], m.source_camera)
            .finish()
        )
        self.framer.view_mode = self.view_mode
        self.fps = fps

    def set_view_mode(self, view_mode: FramedViewMode) -> None:
        """Live-tunable, takes effect from the next decoded batch."""
        self.view_mode = view_mode
        self.framer.view_mode = view_mode

    def seek_to_beginning(self) -> None:
        """Loop restart (ref: player/adder.rs loop behavior): seek back to
        the first event/ADU boundary without reopening the file; the framer
        state is rebuilt for the fresh timeline."""
        self.decoder.set_input_stream_position(self.meta.header_size)
        fps = self.meta.tps / max(self.meta.ref_interval, 1)
        b = FramerBuilder(self.meta.plane)
        b.buffer_limit = self.buffer_limit
        self.framer = (
            b.time_parameters(
                self.meta.tps, self.meta.ref_interval, self.meta.delta_t_max, fps
            )
            .codec_meta(self.meta.codec_version, self.meta.time_mode)
            .source_info(
                SOURCE_CAMERA_TO_TYPE[self.meta.source_camera],
                self.meta.source_camera,
            )
            .finish()
        )
        self.framer.view_mode = self.view_mode

    def frames(
        self, batch_events: int = 1 << 18, realtime: bool = False, loop: bool = False
    ) -> Iterator[np.ndarray]:
        """Yield reconstructed frames; `realtime` paces to stream rate."""
        frame_period = 1.0 / (self.fps * self.playback_speed)
        t_start = time.monotonic()
        while True:
            batch = self.decoder.digest_batch(batch_events)
            if len(batch) == 0:
                # flush tail, maybe loop
                if self.framer.flush_frame_buffer():
                    while self.framer.is_frame_0_filled():
                        popped = self.framer.pop_next_frame()
                        if popped is None:
                            break
                        yield popped[0]
                        self.stats.frames_emitted += 1
                if not loop:
                    return
                self.seek_to_beginning()
                continue
            self.stats.events_total += len(batch)
            elapsed = max(time.monotonic() - t_start, 1e-9)
            self.stats.events_per_sec = self.stats.events_total / elapsed
            self.stats.bitrate_bps = (
                self.stats.events_per_sec * self.meta.event_size * 8
            )
            self.framer.ingest_event_array(batch)
            while self.framer.is_frame_0_filled():
                popped = self.framer.pop_next_frame()
                if popped is None:
                    break
                values, _ = popped
                if realtime:
                    target = t_start + self.stats.frames_emitted * frame_period
                    delay = target - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                yield values
                self.stats.frames_emitted += 1
