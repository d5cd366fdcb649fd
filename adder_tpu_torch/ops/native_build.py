"""On-demand g++ build and ctypes load of the port's host C++ helpers.

Copy of adder_tpu/ops/native_build.py (and of the entropy library's build in
adder_tpu/codec/compressed.py), with two changes. The libraries land in
`adder_tpu_torch/build/native/`, named by a digest of the source and the
flags, so the port never shares a library file with the JAX package's
`.cache/native/` and an edited source never loads a stale build. A build
that fails raises: the port has no numpy fallback.

Sources: `ops/native/dvs_plan.cpp` (the DVS and DAVIS lane planners) and
`codec/native/adder_entropy.cpp` (the compressed codec's entropy stage and
the LZ4 block decoder of the aedat4 reader).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_libs: dict = {}
_lock = threading.Lock()


def library_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(src: pathlib.Path) -> pathlib.Path:
    """Compile `src` into BUILD_DIR unless this exact build exists."""
    so = library_path(src)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"building {src.name} needs g++: {e}") from e
    if proc.returncode:
        raise RuntimeError(f"g++ failed on {src.name}:\n{proc.stderr[-4000:]}")
    tmp.replace(so)
    return so


def load(src: pathlib.Path) -> ctypes.CDLL:
    """Build if needed and dlopen `src`'s library, once per process."""
    with _lock:
        if src not in _libs:
            _libs[src] = ctypes.CDLL(str(build(src)))
        return _libs[src]
