"""Live transcoder controller: the adder-viz transcode-tab engine, headless.

Port of `adder_tpu/models/live_transcoder.py` onto the port's `Framed` and
`Video`, transcoding on the torch `device` (the card unless the caller asks
for the CPU).

ref: adder-viz/src/transcoder/{mod.rs,adder.rs,ui.rs}. The reference splits
parameters into live-tunable `AdaptiveParameters` (CRF, view mode, features,
ROI, event drop/order) and relaunch-required `CoreParameters` (delta_t_ref,
dtm multiplier, scale, encoder type, paths); the UI thread messages a tokio
transcoder task. Here the controller applies adaptive updates between device
chunks and rebuilds the source when core parameters change, publishing the
same per-chunk statistics the GUI plots (events/s, events per pixel-channel
per second, bitrate, transcoded FPS, quality metrics).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from ..codec.encoder import EncoderOptions, EncoderType, EventOrder
from ..core.types import PixelMultiMode, SourceCamera, TimeMode
from ..framer.scale_intensity import FramedViewMode
from ..transcoder.framed import Framed
from ..transcoder.video import Roi
from ..utils.cv import QualityMetrics, calculate_quality_metrics
from ..utils.viz import ShowFeatureMode


@dataclass
class AdaptiveParams:
    """Live-tunable (ref: adder-viz/src/transcoder/mod.rs:17-38)."""

    crf: Optional[int] = 3
    view_mode: FramedViewMode = FramedViewMode.Intensity
    detect_features: bool = False
    show_features: ShowFeatureMode = ShowFeatureMode.Off
    feature_rate_adjustment: bool = False
    feature_cluster: bool = False
    roi: Optional[Roi] = None
    event_order: EventOrder = EventOrder.Unchanged
    quality_metrics: bool = False


@dataclass
class CoreParams:
    """Relaunch-required (ref: adder-viz/src/transcoder/mod.rs:40-53)."""

    input_path: str = ""
    color: bool = False
    scale: float = 1.0
    delta_t_ref: int = 255
    delta_t_max_mult: int = 30
    encoder_type: EncoderType = EncoderType.Empty
    output_path: Optional[str] = None
    time_mode: TimeMode = TimeMode.AbsoluteT
    integration_mode_continuous: bool = False


@dataclass
class ChunkStats:
    """Per-chunk live statistics (ref: transcoder/mod.rs:64-73)."""

    events_per_sec: float = 0.0
    events_ppc_per_sec: float = 0.0
    bitrate_bps: float = 0.0
    transcoded_fps: float = 0.0
    psnr: Optional[float] = None
    mse: Optional[float] = None


class LiveTranscoder:
    def __init__(self, core: CoreParams, adaptive: AdaptiveParams, *,
                 device="cuda"):
        self.device = device
        self.core = core
        self.adaptive = adaptive
        self.source = None
        self.stats = ChunkStats()
        self._launch()

    def _launch(self) -> None:
        """(Re)build the source from core params (ref: adder.rs:80-144)."""
        c = self.core
        self.source = Framed(c.input_path, c.color, c.scale,
                             device=self.device)
        self.source.auto_time_parameters(
            c.delta_t_ref, c.delta_t_ref * c.delta_t_max_mult, c.time_mode
        )
        writer = open(c.output_path, "wb") if c.output_path else None
        if writer is not None:
            self.source.write_out(
                SourceCamera.FramedU8,
                c.time_mode,
                PixelMultiMode.Collapse,
                None,
                c.encoder_type,
                EncoderOptions.default(self.source.video.plane),
                writer,
            )
        self._apply_adaptive()

    def update_core(self, core: CoreParams) -> None:
        self.core = core
        self._launch()

    def update_adaptive(self, adaptive: AdaptiveParams) -> None:
        self.adaptive = adaptive
        self._apply_adaptive()

    def _apply_adaptive(self) -> None:
        a = self.adaptive
        v = self.source.video
        if a.crf is not None:
            v.update_crf(a.crf)
        v.instantaneous_view_mode = int(a.view_mode)
        v.update_detect_features(
            a.detect_features, a.show_features,
            a.feature_rate_adjustment, a.feature_cluster,
        )
        v.update_roi(a.roi)
        # quality metrics need the reconstructed frame synced each chunk
        # even when feature detection is off (video.py keeps
        # running_intensities only when asked)
        if a.quality_metrics:
            v._keep_running_frame = True
        v.encoder.options.event_order = a.event_order
        v.encoder.sync_crf()

    def step(self):
        """Transcode one device chunk; returns (events, stats) or None at
        EOF (the GUI's PauseLoop/Loop recovery point, ref: adder.rs:144-186)."""
        v = self.source.video
        t0 = time.perf_counter()
        try:
            events = self.source.consume_batch()
        except EOFError:
            return None
        dt = max(time.perf_counter() - t0, 1e-9)
        T = v.chunk_frames
        s = self.stats
        s.transcoded_fps = T / dt
        interval_sec = T * v.ref_time / max(v.tps, 1)
        s.events_per_sec = len(events) / max(interval_sec, 1e-9)
        s.events_ppc_per_sec = s.events_per_sec / v.plane.volume()
        s.bitrate_bps = s.events_per_sec * v.get_event_size() * 8
        if self.adaptive.quality_metrics and getattr(
            self.source, "frames", None
        ) is not None:
            recon = v.running_intensities
            src = self.source.frames[self.source.frame_idx - 1]
            m = calculate_quality_metrics(src, recon, QualityMetrics())
            s.psnr, s.mse = m.psnr, m.mse
        return events, s
