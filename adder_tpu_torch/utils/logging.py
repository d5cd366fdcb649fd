"""Feature-detection evaluation logging.

Copy of `adder_tpu/utils/logging.py` (`LogFeature`, `FeatureLogger`,
`StageTimer`); the port keeps its own copy and imports nothing of the JAX
package.

ref: adder-codec-rs/src/utils/logging.rs (LogFeature serde records) and the
feature-logging instrumentation in video.rs:746-773/926-1048: per-interval
bitrate, ADDER-vs-OpenCV FAST timings, precision/recall. Records serialize
as JSON lines (the reference pickles; JSONL is the portable equivalent)."""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass
from typing import Optional, TextIO


@dataclass
class LogFeature:
    """One detected feature (ref: logging.rs LogFeature)."""

    x: int
    y: int
    source: str  # "ADDER" | "OpenCV"
    nonmax_suppression: bool = False


class FeatureLogger:
    """Per-interval feature/bitrate/quality log (JSONL)."""

    def __init__(self, handle: TextIO, plane=None):
        self.handle = handle
        if plane is not None:
            self.write({"plane": [plane.width, plane.height, plane.channels]})

    def write(self, record: dict) -> None:
        self.handle.write(json.dumps(record) + "\n")

    def log_bitrate(self, events_per_sec: float, bytes_per_event: int) -> None:
        self.write({"bps": events_per_sec * bytes_per_event * 8})

    def log_features(self, features, source: str, duration_ns: Optional[int] = None):
        self.write(
            {
                "source": source,
                "n_features": len(features),
                "duration_ns": duration_ns,
                "features": [
                    asdict(f) if isinstance(f, LogFeature) else list(f)
                    for f in features
                ],
            }
        )

    def log_quality(self, psnr=None, mse=None, ssim=None) -> None:
        self.write({"psnr": psnr, "mse": mse, "ssim": ssim})

    def log_precision_recall(self, precision, recall, accuracy) -> None:
        self.write(
            {"precision": precision, "recall": recall, "accuracy": accuracy}
        )


class StageTimer:
    """Ad-hoc stage timing (the reference sprinkles Instant::now)."""

    def __init__(self, logger: Optional[FeatureLogger] = None):
        self.logger = logger
        self._t0 = {}

    def start(self, name: str) -> None:
        self._t0[name] = time.perf_counter_ns()

    def stop(self, name: str) -> int:
        dt = time.perf_counter_ns() - self._t0.pop(name)
        if self.logger:
            self.logger.write({"stage": name, "duration_ns": dt})
        return dt
