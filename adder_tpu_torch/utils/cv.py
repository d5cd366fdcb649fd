"""Colour conversion for the DAVIS path.

Copy of `handle_color` from `adder_tpu/utils/cv.py` (ref: cv.rs:215-232),
the one function of that module the port's EDI reconstructor needs.
"""

from __future__ import annotations

import numpy as np


def handle_color(frame_bgr: np.ndarray, color: bool) -> np.ndarray:
    """BGR -> gray (ITU-R 601 luma, truncating) or passthrough
    (ref: cv.rs:215-232). Used by general BGR inputs (aedat4 APS frames
    through the EDI path)."""
    if color:
        return frame_bgr
    gray = (
        frame_bgr[..., 0].astype(np.float64) * 0.114
        + frame_bgr[..., 1].astype(np.float64) * 0.587
        + frame_bgr[..., 2].astype(np.float64) * 0.299
    )
    return gray.astype(np.uint8)[..., None]
