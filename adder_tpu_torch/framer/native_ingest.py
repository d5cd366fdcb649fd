"""ctypes loader + driver glue for the native framer ingest
(ops/native/framer_fill.cpp).

Copy of `adder_tpu/framer/native_ingest.py`, with two changes: the library
builds through the port's `ops/native_build.py` into
`adder_tpu_torch/build/native/`, and a failed build raises (the JAX
package's `ADDER_TPU_NATIVE_FRAMER` switch and its numpy fallback on a
missing toolchain are gone). `ingest_native(fs, events)` runs the full
reconstruction chain for one batch — counting sort, per-pixel chain replay,
value conversion, span fill — and returns True; it returns False for what
the walk refuses (feature detection, a pixel outside the plane), which the
numpy segmented-scan path of the driver then runs, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

from ..ops import native_build
from .scale_intensity import _SOURCE_MAX, _TYPE_MAX

_SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "ops" / "native"
           / "framer_fill.cpp")
_lib = None
_lib_lock = threading.Lock()


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = native_build.load(_SOURCE)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u16p = ctypes.POINTER(ctypes.c_uint16)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            i64p = ctypes.POINTER(ctypes.c_int64)
            vpp = ctypes.POINTER(ctypes.c_void_p)
            lib.adder_framer_plan.restype = ctypes.c_long
            lib.adder_framer_plan.argtypes = [
                u16p, u16p, u8p, u32p, ctypes.c_long,
                ctypes.c_long, ctypes.c_long, ctypes.c_long,
                u64p, i64p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_int, ctypes.c_int, i64p,
            ]
            lib.adder_framer_exec.restype = ctypes.c_long
            lib.adder_framer_exec.argtypes = [
                u16p, u16p, u8p, u8p, u32p, ctypes.c_long, i64p,
                ctypes.c_long, ctypes.c_long, ctypes.c_long,
                u64p, i64p, u8p, ctypes.c_long,
                ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_int, ctypes.c_int, ctypes.c_long,
                ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_double,
                vpp, vpp, ctypes.c_long, i64p,
            ]
            _lib = lib
        return _lib


def ingest_native(fs, events) -> bool:
    """Run one batch through the native ingest. Mutates `fs` state and frame
    buffers exactly like the numpy path. Returns False, with the state
    untouched, for what the walk refuses, which the numpy path runs."""
    if fs.detect_features:
        return False  # feature binning stays on the numpy path
    lib = _get_lib()

    n = len(events)
    x = np.ascontiguousarray(events.x, dtype=np.uint16)
    y = np.ascontiguousarray(events.y, dtype=np.uint16)
    c = np.ascontiguousarray(events.c, dtype=np.uint8)
    d = np.ascontiguousarray(events.d, dtype=np.uint8)
    t = np.ascontiguousarray(events.t, dtype=np.uint32)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)

    order = np.empty(n, dtype=np.int64)
    max_f = lib.adder_framer_plan(
        x.ctypes.data_as(u16p), y.ctypes.data_as(u16p), c.ctypes.data_as(u8p),
        t.ctypes.data_as(u32p), ctypes.c_long(n),
        ctypes.c_long(fs.plane.width), ctypes.c_long(fs.plane.channels),
        ctypes.c_long(fs.n),
        fs.running_ts.ctypes.data_as(u64p),
        fs.last_filled.ctypes.data_as(i64p),
        ctypes.c_uint64(fs.ref_interval), ctypes.c_uint64(fs.tpf),
        ctypes.c_int(1 if fs._absolute else 0),
        ctypes.c_int(1 if fs._framed_round else 0),
        order.ctypes.data_as(i64p),
    )
    if max_f < -1:
        return False

    # Pre-create the frame window the fills land in; frames created here
    # that receive no fill are dropped again below (the numpy path only
    # materializes frames it writes to, and flush_frame_buffer keys off
    # frame existence).
    existing = set(fs.frames.keys())
    nf = max(int(max_f) - fs.frames_written + 1, 0)
    if nf <= 0:
        # nothing fires: the dry walk says so, but chain state must still
        # advance — run exec with an empty frame window.
        nf = 0
    vals_ptrs = (ctypes.c_void_p * max(nf, 1))()
    fill_ptrs = (ctypes.c_void_p * max(nf, 1))()
    for i in range(nf):
        f = fs._ensure_frame(fs.frames_written + i)
        vals_ptrs[i] = f.values.ctypes.data
        fill_ptrs[i] = f.filled.ctypes.data
    fill_counts = np.zeros(max(nf, 1), dtype=np.int64)

    out_dtype = fs.out_dtype
    out_max = _TYPE_MAX[out_dtype.type]
    src_max = _SOURCE_MAX.get(fs.source, 255.0)

    fires = lib.adder_framer_exec(
        x.ctypes.data_as(u16p), y.ctypes.data_as(u16p), c.ctypes.data_as(u8p),
        d.ctypes.data_as(u8p), t.ctypes.data_as(u32p), ctypes.c_long(n),
        order.ctypes.data_as(i64p),
        ctypes.c_long(fs.plane.width), ctypes.c_long(fs.plane.channels),
        ctypes.c_long(fs.n),
        fs.running_ts.ctypes.data_as(u64p),
        fs.last_filled.ctypes.data_as(i64p),
        fs.last_intensity.ctypes.data_as(u8p),
        ctypes.c_long(out_dtype.itemsize),
        ctypes.c_uint64(fs.ref_interval), ctypes.c_uint64(fs.tpf),
        ctypes.c_int(1 if fs._absolute else 0),
        ctypes.c_int(1 if fs._framed_round else 0),
        ctypes.c_long(fs.frames_written),
        ctypes.c_int(int(fs.view_mode)), ctypes.c_int(1 if fs.coordless else 0),
        ctypes.c_double(float(fs.ref_interval)),
        ctypes.c_double(src_max), ctypes.c_double(out_max),
        ctypes.c_double(fs._practical_d_max), ctypes.c_double(fs.delta_t_max),
        ctypes.cast(vals_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(fill_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.c_long(nf),
        fill_counts.ctypes.data_as(i64p),
    )
    if fires < 0:
        raise RuntimeError(f"adder_framer_exec failed: rc={fires}")

    # drop frames we materialized that received no fill
    for i in range(nf):
        idx = fs.frames_written + i
        if fill_counts[i] == 0 and idx not in existing and idx != fs.frames_written:
            fs.frames.pop(idx, None)

    # buffer limit: force-complete frame 0 (driver.rs:1116-1122)
    if (
        fs.buffer_limit is not None
        and fires
        and int(fs.last_filled.max()) > fs.frames_written + fs.buffer_limit
    ):
        f0 = fs._ensure_frame(fs.frames_written)
        f0.filled[:] = True

    return True
