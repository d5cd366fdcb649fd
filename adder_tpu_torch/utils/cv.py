"""FAST features, colour conversion and quality metrics.

Copies from `adder_tpu/utils/cv.py` (ref: adder-codec-rs src/utils/cv.rs):
`CIRCLE3`, `INTENSITY_THRESHOLD`, `STREAK_SIZE`, `is_feature`, `_streak`,
`fast_mask` and `_streak_mask` (the FAST-9/16 corner test, scalar and dense
numpy), `handle_color` (the DAVIS path's EDI reconstructor),
`handle_color_rgb_videors` and `handle_color_videors` (the file sources'
conversions), and `QualityMetrics`, `calculate_quality_metrics`,
`calculate_mse`, `calculate_psnr` and `calculate_ssim`. New here:
`fast_mask_torch`, the counterpart of `fast_mask_jax` in torch ops on the
caller's device, batched over a leading axis, which the feature pipeline of
`Video` runs over a chunk's display frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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


def handle_color_rgb_videors(frame_rgb: np.ndarray, color: bool) -> np.ndarray:
    """The framed-source conversion applied to frames already in video-rs
    RGB order (the native ffmpeg decode path): coefficients
    (0.114, 0.587, 0.299) land on channels (0, 1, 2) exactly as the
    reference computes them (ref: cv.rs:215-232 via framed.rs:128), i.e.
    the 0.114 weight on RED — truncating, not rounding. Color passthrough
    keeps RGB (the reference's channel order for color transcodes)."""
    if color:
        return frame_rgb
    gray = (
        frame_rgb[..., 0].astype(np.float64) * 0.114
        + frame_rgb[..., 1].astype(np.float64) * 0.587
        + frame_rgb[..., 2].astype(np.float64) * 0.299
    )
    return gray.astype(np.uint8)[..., None]


def handle_color_videors(frame_bgr: np.ndarray, color: bool) -> np.ndarray:
    """The framed-source conversion, reference-faithful to a quirk that is
    golden-pinned against the committed `lake_scaled_out`: the reference
    applies coefficients (0.114, 0.587, 0.299) to channels (0, 1, 2) of
    frames that video-rs delivers in RGB order, so the 0.114 weight lands
    on RED (truncated, not rounded). cv2 delivers BGR, so the weights are
    mirrored here to reproduce the same bytes. Only the mp4 framed source
    uses this; other BGR inputs use the ITU-correct handle_color."""
    if color:
        return frame_bgr
    b = frame_bgr[..., 0].astype(np.float64)
    g = frame_bgr[..., 1].astype(np.float64)
    r = frame_bgr[..., 2].astype(np.float64)
    gray = 0.114 * r + 0.587 * g + 0.299 * b
    return gray.astype(np.uint8)[..., None]


# --- quality metrics (ref: cv.rs:282-429) -----------------------------------


@dataclass
class QualityMetrics:
    psnr: Optional[float] = 0.0
    mse: Optional[float] = 0.0
    ssim: Optional[float] = None


def calculate_quality_metrics(
    original: np.ndarray, reconstructed: np.ndarray, results: QualityMetrics
) -> QualityMetrics:
    if original.shape != reconstructed.shape:
        raise ValueError("shapes must match")
    mse = calculate_mse(original, reconstructed)
    if mse == 0.0:
        mse = 1e-7  # keep PSNR defined (ref: cv.rs:316-319)
    if results.mse is not None:
        results.mse = mse
    if results.psnr is not None:
        results.psnr = calculate_psnr(mse)
    if results.ssim is not None:
        results.ssim = calculate_ssim(original, reconstructed)
    return results


def calculate_mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))


def calculate_psnr(mse: float) -> float:
    return 20.0 * np.log10(255.0) - 10.0 * np.log10(mse)


_WINDOW = 8
_C1 = (0.01 * 255.0) ** 2
_C2 = (0.03 * 255.0) ** 2


def calculate_ssim(original: np.ndarray, reconstructed: np.ndarray) -> float:
    """Sliding 8x8-window SSIM averaged over channels, scaled to [0, 100].

    Matches the reference's formulation (ref: cv.rs:353-429), including its
    use of raw (un-normalized) sums for variance/covariance.
    """
    scores = []
    for c in range(original.shape[2]):
        a = original[..., c].astype(np.float64)
        b = reconstructed[..., c].astype(np.float64)
        mu_a = _win_mean(a)
        mu_b = _win_mean(b)
        n = _WINDOW * _WINDOW
        # reference covariance = sum((x-mx)(y-my)) without dividing by n
        var_a = (_win_mean(a * a) - mu_a**2) * n
        var_b = (_win_mean(b * b) - mu_b**2) * n
        cov = (_win_mean(a * b) - mu_a * mu_b) * n
        num = (2 * mu_a * mu_b + _C1) * (2 * cov + _C2)
        den = (mu_a**2 + mu_b**2 + _C1) * (var_a + var_b + _C2)
        scores.append(float(np.mean(num / den)))
    return float(np.mean(scores)) * 100.0


def _win_mean(x: np.ndarray) -> np.ndarray:
    """Mean over all sliding 8x8 windows via integral image."""
    ii = np.zeros((x.shape[0] + 1, x.shape[1] + 1))
    ii[1:, 1:] = np.cumsum(np.cumsum(x, axis=0), axis=1)
    w = _WINDOW
    s = ii[w:, w:] - ii[:-w, w:] - ii[w:, :-w] + ii[:-w, :-w]
    return s / (w * w)
