"""CRF quality -> contrast-threshold parameter mapping.

Copy of `adder_tpu/codec/rate_controller.py`; the port keeps its own copy and imports nothing of
the JAX package.

ref: adder-codec-core/src/codec/rate_controller.rs
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..core.types import PlaneSize

# CRF lookup table: [c_thresh_baseline, c_thresh_max, c_increase_velocity,
# feature_c_radius fraction of min resolution] (ref: rate_controller.rs:5-18)
CRF_TABLE = [
    (0.0, 0.0, 10.0, 1e-9),
    (0.0, 1.0, 9.0, 1.0 / 12.0),
    (1.0, 3.0, 8.0, 1.0 / 14.0),
    (2.0, 7.0, 7.0, 1.0 / 15.0),
    (5.0, 9.0, 6.0, 1.0 / 18.0),
    (6.0, 10.0, 5.0, 1.0 / 20.0),
    (7.0, 13.0, 4.0, 1.0 / 25.0),
    (8.0, 16.0, 3.0, 1.0 / 30.0),
    (10.0, 20.0, 2.0, 1.0 / 30.0),
    (15.0, 25.0, 1.0, 1.0 / 30.0),
]

DEFAULT_CRF_QUALITY = 3


@dataclass
class CrfParameters:
    """ref: rate_controller.rs:39-53"""

    c_thresh_baseline: int
    c_thresh_max: int
    c_increase_velocity: int
    feature_c_radius: int


class Crf:
    """ref: rate_controller.rs:23-112"""

    def __init__(self, crf: Optional[int], plane: PlaneSize):
        self.plane = plane
        self.crf_quality: Optional[int] = crf
        q = DEFAULT_CRF_QUALITY if crf is None else crf
        self.parameters = self._params_for(q)

    def _params_for(self, q: int) -> CrfParameters:
        base, cmax, vel, radius_frac = CRF_TABLE[q]
        return CrfParameters(
            c_thresh_baseline=int(base),
            c_thresh_max=int(cmax),
            c_increase_velocity=int(vel),
            feature_c_radius=int(radius_frac * self.plane.min_resolution()),
        )

    def update_quality(self, crf: int) -> None:
        self.crf_quality = crf
        self.parameters = self._params_for(crf)

    def override_c_thresh_baseline(self, v: int) -> None:
        self.parameters.c_thresh_baseline = v
        self.crf_quality = None

    def override_c_thresh_max(self, v: int) -> None:
        self.parameters.c_thresh_max = v
        self.crf_quality = None

    def override_c_increase_velocity(self, v: int) -> None:
        self.parameters.c_increase_velocity = v
        self.crf_quality = None

    def override_feature_c_radius(self, v: int) -> None:
        self.parameters.feature_c_radius = v
        self.crf_quality = None

    def get_parameters(self) -> CrfParameters:
        return self.parameters

    def get_quality(self) -> Optional[int]:
        return self.crf_quality
