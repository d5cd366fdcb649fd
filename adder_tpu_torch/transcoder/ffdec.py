"""Native ffmpeg decode path: bit-exact parity with the reference's video-rs.

Copy of `adder_tpu/transcoder/ffdec.py` (`available`, `StreamDecoder`,
`decode_frames`), with one change: the shim `native/videodec.cpp` builds
through the port's `ops/native_build.py` into `adder_tpu_torch/build/native/`,
linked against libav, and the link arguments go into the library's digest.

The reference's Framed source decodes through video-rs, i.e. ffmpeg's
libavcodec + an RGB24 libswscale stage (framed.rs:44-79). cv2.VideoCapture
applies OpenCV's own YUV->BGR arithmetic instead, which differs by +-1 from
swscale on a few percent of pixels — enough to break byte-exact
cross-implementation goldens. This module binds a small C++ shim
(native/videodec.cpp) over the system ffmpeg libraries so decoded RGB24
frames match the Rust implementation exactly.

Frames are returned in RGB order (video-rs layout), NOT cv2's BGR.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Optional, Tuple

import numpy as np

from ..ops import native_build

_SOURCE = pathlib.Path(__file__).resolve().parent / "native" / "videodec.cpp"
LINK = ("-lavformat", "-lavcodec", "-lswscale", "-lavutil")
_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def _get_lib():
    """The bound library, or None when ffmpeg dev libraries are absent
    (`decoder="auto"` then takes cv2; an explicit ffmpeg decode raises)."""
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = native_build.load(_SOURCE, LINK)
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            return None
        lib.vdec_open.restype = ctypes.c_void_p
        lib.vdec_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.vdec_next.restype = ctypes.c_int
        lib.vdec_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
        ]
        lib.vdec_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _get_lib() is not None


def _require_lib():
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"ffmpeg decoder unavailable: {_build_error}")
    return lib


def _open(lib, path: str, scale: float):
    """vdec_open at `scale` times the native size (probed first); returns
    (handle, width, height, fps)."""
    out_w = ctypes.c_int(0)
    out_h = ctypes.c_int(0)
    fps = ctypes.c_double(0.0)
    if scale != 1.0:
        h0 = lib.vdec_open(
            str(path).encode(), 0, 0,
            ctypes.byref(out_w), ctypes.byref(out_h), ctypes.byref(fps),
        )
        if not h0:
            raise RuntimeError(f"could not open {path}")
        lib.vdec_close(h0)
        tw, th = int(out_w.value * scale), int(out_h.value * scale)
    else:
        tw = th = 0
    handle = lib.vdec_open(
        str(path).encode(), tw, th,
        ctypes.byref(out_w), ctypes.byref(out_h), ctypes.byref(fps),
    )
    if not handle:
        raise RuntimeError(f"could not open {path}")
    return handle, out_w.value, out_h.value, float(fps.value)


class StreamDecoder:
    """Incremental RGB24 frame reader over the native libavcodec shim —
    the streaming face of decode_frames (same swscale AREA stage video-rs
    configures, framed.rs:52-59). read() returns one (H, W, 3) uint8
    frame or None at EOF; frames decode on demand, so a prefetch thread
    can overlap decode with device integration (SURVEY P2/P4)."""

    def __init__(self, path: str, scale: float = 1.0):
        self._lib = _require_lib()
        self._handle, self.width, self.height, fps = _open(
            self._lib, path, scale)
        self.fps = fps or 30.0
        self._buf = np.empty((self.height, self.width, 3), np.uint8)
        self._ptr = self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def read(self) -> Optional[np.ndarray]:
        if self._handle is None:
            return None
        r = self._lib.vdec_next(self._handle, self._ptr)
        if r == 0:
            self.close()
            return None
        if r < 0:
            raise RuntimeError(f"decode error {r}")
        return self._buf.copy()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.vdec_close(self._handle)
            self._handle = None


def decode_frames(
    path: str,
    scale: float = 1.0,
    max_frames: Optional[int] = None,
) -> Tuple[np.ndarray, float]:
    """Decode a video file to (T, H, W, 3) uint8 RGB24 frames + fps.

    `scale` resizes through the same swscale AREA stage video-rs configures
    (Resize::Fit at width*scale x height*scale, framed.rs:52-59)."""
    lib = _require_lib()
    handle, W, H, fps = _open(lib, path, scale)
    try:
        frames = []
        buf = np.empty((H, W, 3), np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        while max_frames is None or len(frames) < max_frames:
            r = lib.vdec_next(handle, ptr)
            if r == 0:
                break
            if r < 0:
                raise RuntimeError(f"decode error {r} in {path}")
            frames.append(buf.copy())
    finally:
        lib.vdec_close(handle)
    if not frames:
        raise RuntimeError(f"no frames decoded from {path}")
    return np.stack(frames), fps
