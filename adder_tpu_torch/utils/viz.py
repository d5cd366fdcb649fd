"""Feature markers and rectangles on a display frame, and frames to a video file.

Copy of `adder_tpu/utils/viz.py` (ref: adder-codec-rs src/utils/viz.rs):
`ShowFeatureMode`, `draw_feature_coord` and `draw_rect`, which the feature
pipeline of `Video` draws with, and `write_frames_to_video`.
"""

from __future__ import annotations

import enum
import pathlib

import numpy as np


class ShowFeatureMode(enum.IntEnum):
    """ref: viz.rs:76-86"""

    Off = 0
    Instant = 1
    Hold = 2


def draw_feature_coord(
    x: int, y: int, img: np.ndarray, color_img: bool, color=None
) -> None:
    """Draw a small cross marker at (x, y) (ref: viz.rs:89-126)."""
    h, w = img.shape[:2]
    val = color if color is not None else (255, 255, 255)
    for d in range(-2, 3):
        for (yy, xx) in ((y + d, x), (y, x + d)):
            if 0 <= yy < h and 0 <= xx < w:
                if color_img:
                    img[yy, xx, :3] = val[:3] if color is not None else 255
                else:
                    img[yy, xx, 0] = 255


def draw_rect(
    x0: int, y0: int, x1: int, y1: int, img: np.ndarray, color_img: bool, color=None
) -> None:
    """Draw a rectangle outline (ref: viz.rs:129-159)."""
    h, w = img.shape[:2]
    val = color if color is not None else (255, 255, 255)

    def put(yy, xx):
        if 0 <= yy < h and 0 <= xx < w:
            if color_img:
                img[yy, xx, :3] = val[:3] if color is not None else 255
            else:
                img[yy, xx, 0] = 255

    for xx in range(x0, x1 + 1):
        put(y0, xx)
        put(y1, xx)
    for yy in range(y0, y1 + 1):
        put(yy, x0)
        put(yy, x1)


def write_frames_to_video(
    frames: np.ndarray, path: str, fps: float = 30.0
) -> bool:
    """Write (T, H, W[, C]) uint8 frames to an mp4 via cv2
    (replaces the reference's ffmpeg shell-out, viz.rs:45-54)."""
    try:
        import cv2
    except ImportError:
        return False
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[..., None]
    T, H, W, C = frames.shape
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    vw = cv2.VideoWriter(str(path), fourcc, fps, (W, H), isColor=True)
    if not vw.isOpened():
        return False
    for t in range(T):
        f = frames[t]
        if C == 1:
            f = np.repeat(f, 3, axis=2)
        vw.write(f)
    vw.release()
    return pathlib.Path(path).exists()
