"""FAST features and colour conversion.

Copies from `adder_tpu/utils/cv.py` (ref: adder-codec-rs src/utils/cv.rs):
`CIRCLE3`, `INTENSITY_THRESHOLD`, `STREAK_SIZE`, `is_feature`, `_streak`,
`fast_mask` and `_streak_mask` (the FAST-9/16 corner test, scalar and dense
numpy), and `handle_color` (the DAVIS path's EDI reconstructor). New here:
`fast_mask_torch`, the counterpart of `fast_mask_jax` in torch ops on the
caller's device, batched over a leading axis, which the feature pipeline of
`Video` runs over a chunk's display frames.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import Coord, PlaneSize

INTENSITY_THRESHOLD = 30
STREAK_SIZE = 9

# Bresenham circle of radius 3, [x, y] offsets (ref: cv.rs:26-31)
CIRCLE3 = [
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
]


def is_feature(coord: Coord, plane: PlaneSize, img: np.ndarray) -> bool:
    """Scalar FAST-9/16 corner check at one coordinate (ref: cv.rs:56-212).

    `img` is (H, W, C) uint8; only channel 0 is inspected, borders excluded.
    """
    if coord.is_border(plane.width, plane.height, 3) or coord.c_usize() != 0:
        return False
    x, y = coord.x, coord.y
    p = int(img[y, x, 0])
    t = INTENSITY_THRESHOLD
    samples = np.array(
        [int(img[y + dy, x + dx, 0]) for dx, dy in CIRCLE3], dtype=np.int32
    )
    bright = samples > p + t
    dark = samples < p - t
    return _streak(dark) or _streak(bright)


def _streak(mask: np.ndarray) -> bool:
    ext = np.concatenate([mask, mask[: STREAK_SIZE - 1]])
    run = 0
    for v in ext:
        run = run + 1 if v else 0
        if run >= STREAK_SIZE:
            return True
    return False


def fast_mask(img: np.ndarray, threshold: int = INTENSITY_THRESHOLD) -> np.ndarray:
    """Dense FAST-9/16: (H, W) bool mask of corners on channel 0.

    Vectorized equivalent of the reference's per-coordinate `is_feature`
    (identical decisions; the reference's staged d-checks and early exits are
    pure speed optimizations of the same predicate).
    """
    if img.ndim == 3:
        img = img[..., 0]
    H, W = img.shape
    p = img.astype(np.int16)
    bright = np.zeros((16, H, W), dtype=bool)
    dark = np.zeros((16, H, W), dtype=bool)
    for i, (dx, dy) in enumerate(CIRCLE3):
        shifted = np.roll(np.roll(img, -dy, axis=0), -dx, axis=1).astype(np.int16)
        bright[i] = shifted > p + threshold
        dark[i] = shifted < p - threshold
    corner = _streak_mask(bright) | _streak_mask(dark)
    corner[:3, :] = corner[-3:, :] = False
    corner[:, :3] = corner[:, -3:] = False
    return corner


def _streak_mask(m: np.ndarray) -> np.ndarray:
    """Circular run >= STREAK_SIZE along axis 0 of a (16, H, W) mask."""
    ext = np.concatenate([m, m[: STREAK_SIZE - 1]], axis=0)
    run = np.zeros(ext.shape[1:], dtype=np.int8)
    out = np.zeros(ext.shape[1:], dtype=bool)
    for i in range(ext.shape[0]):
        run = np.where(ext[i], run + 1, 0).astype(np.int8)
        out |= run >= STREAK_SIZE
    return out


def fast_mask_torch(frames: torch.Tensor,
                    threshold: int = INTENSITY_THRESHOLD) -> torch.Tensor:
    """Dense FAST-9/16 over (..., H, W) integer frames on their own device:
    a bool mask of the same shape (counterpart of `fast_mask_jax`,
    `adder_tpu/utils/cv.py:93-123`, batched over the leading axes). Each of
    the 16 circle samples is a view rolled by (-dy, -dx), brighter than the
    centre by more than `threshold` or darker by more; a corner has a
    circular run of STREAK_SIZE of either; the 3-pixel border is never one.
    The runs are counted as the circle is walked once and then its first
    STREAK_SIZE - 1 samples again, so the 16 marks are never all held."""
    p = frames.to(torch.int16)
    H, W = p.shape[-2:]
    run_b = torch.zeros(p.shape, dtype=torch.int16, device=p.device)
    run_d = torch.zeros_like(run_b)
    corner = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    hi, lo = p + threshold, p - threshold
    for i in range(len(CIRCLE3) + STREAK_SIZE - 1):
        dx, dy = CIRCLE3[i % len(CIRCLE3)]
        s = torch.roll(p, shifts=(-dy, -dx), dims=(-2, -1))
        run_b = torch.where(s > hi, run_b + 1, 0)
        run_d = torch.where(s < lo, run_d + 1, 0)
        corner |= (run_b >= STREAK_SIZE) | (run_d >= STREAK_SIZE)
    rows = torch.arange(H, device=p.device)
    cols = torch.arange(W, device=p.device)
    inner = (((rows >= 3) & (rows < H - 3))[:, None]
             & ((cols >= 3) & (cols < W - 3))[None, :])
    return corner & inner


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
