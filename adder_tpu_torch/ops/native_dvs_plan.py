"""ctypes binding of the native DVS and DAVIS lane planners (ops/native/dvs_plan.cpp).

Copy of the parts of `adder_tpu/ops/native_dvs_plan.py` that the port runs:
`plan_dvs_native` (Prophesee) and `plan_davis_native` (DAVIS). The library
builds through `ops/native_build.py`; a missing toolchain raises, as the
port has no numpy fallback. Both planners mutate the caller's last_t /
last_ln chain state in place (copied back when the input needed a dtype or
contiguity conversion), and the exp(last_ln) memo `val_cache` when given.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

from . import native_build

_SOURCE = pathlib.Path(__file__).resolve().parent / "native" / "dvs_plan.cpp"
_lib = None
_lib_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = native_build.load(_SOURCE)
            lib.adder_plan_dvs.restype = ctypes.c_long
            lib.adder_plan_dvs.argtypes = [
                _i64p, _i32p, _u8p, ctypes.c_long, ctypes.c_long,
                _u32p, _f64p, _f64p, ctypes.c_double, ctypes.c_double,
                _i32p, _i32p, _u8p, _i32p, _f32p, _f32p,
                _u8p, _i32p, _f32p, _f32p, _f32p, _i64p,
            ]
            lib.adder_plan_davis.restype = ctypes.c_long
            lib.adder_plan_davis.argtypes = [
                _i64p, _i32p, _u8p, ctypes.c_long, ctypes.c_long,
                _i64p, _f64p, _f64p, ctypes.c_double, ctypes.c_double,
                ctypes.c_double,
                _i32p, _i32p, _f32p, _f32p, _f32p, _i32p,
            ]
            _lib = lib
        return _lib


def _pixels(xs, ys, width: int) -> np.ndarray:
    return np.ascontiguousarray(
        np.asarray(ys, dtype=np.int64) * width + np.asarray(xs, dtype=np.int64),
        dtype=np.int32,
    )


def _memo(val_cache, n: int) -> np.ndarray:
    if val_cache is None:
        return np.full(n, np.nan, np.float64)
    if val_cache.dtype != np.float64 or len(val_cache) != n:
        raise ValueError("val_cache must be (N,) float64")
    if not val_cache.flags.c_contiguous:
        raise ValueError("val_cache must be contiguous")
    return val_cache


def _copy_back(lt, last_t, ln, last_ln) -> None:
    if lt is not last_t:
        last_t[...] = lt
    if ln is not last_ln:
        last_ln[...] = ln


def plan_dvs_native(ts, xs, ys, ps, width, last_t, last_ln, theta, ref,
                    val_cache=None):
    """The native `plan_dvs_batch_compact`: a `dvs_batch.DvsCompact`."""
    from .dvs_batch import DvsCompact

    lib = _get_lib()
    n_ev = len(ts)
    t64 = np.ascontiguousarray(ts, dtype=np.int64)
    pix = _pixels(xs, ys, width)
    pol = np.ascontiguousarray(np.asarray(ps) != 0, dtype=np.uint8)
    lt = np.ascontiguousarray(last_t, dtype=np.uint32)
    ln = np.ascontiguousarray(last_ln, dtype=np.float64)
    val_cache = _memo(val_cache, len(ln))

    out = DvsCompact(
        np.empty(n_ev, np.int32), np.empty(n_ev, np.int32),
        np.empty(n_ev, np.uint8), np.empty(n_ev, np.int32),
        np.empty(n_ev, np.float32), np.empty(n_ev, np.float32),
        np.empty(n_ev, np.uint8), np.empty(n_ev, np.int32),
        np.empty(n_ev, np.float32), np.empty(n_ev, np.float32),
        np.empty(n_ev, np.float32), np.empty(n_ev, np.int64),
    )
    ptype = {np.dtype(np.int32): _i32p, np.dtype(np.uint8): _u8p,
             np.dtype(np.float32): _f32p, np.dtype(np.int64): _i64p}
    rows = lib.adder_plan_dvs(
        t64.ctypes.data_as(_i64p), pix.ctypes.data_as(_i32p),
        pol.ctypes.data_as(_u8p), ctypes.c_long(n_ev), ctypes.c_long(len(lt)),
        lt.ctypes.data_as(_u32p), ln.ctypes.data_as(_f64p),
        val_cache.ctypes.data_as(_f64p),
        ctypes.c_double(theta), ctypes.c_double(ref),
        *(a.ctypes.data_as(ptype[a.dtype]) for a in out),
    )
    if rows < 0:
        raise ValueError("adder_plan_dvs: pixel index out of range")
    _copy_back(lt, last_t, ln, last_ln)
    out = DvsCompact(*(a[: int(rows)] for a in out))
    return out._replace(gap_on=out.gap_on.view(bool),
                        tick_on=out.tick_on.view(bool))


def plan_davis_native(ts, xs, ys, ons, width, last_t, last_ln, dvs_c, ref,
                      ticks_per_micro, val_cache=None):
    """The native `plan_davis_events_compact`: a `dvs_batch.DavisCompact`."""
    from .dvs_batch import DavisCompact

    lib = _get_lib()
    n_ev = len(ts)
    t64 = np.ascontiguousarray(ts, dtype=np.int64)
    pix = _pixels(xs, ys, width)
    onb = np.ascontiguousarray(np.asarray(ons) != 0, dtype=np.uint8)
    lt = np.ascontiguousarray(last_t, dtype=np.int64)
    ln = np.ascontiguousarray(last_ln, dtype=np.float64)
    val_cache = _memo(val_cache, len(ln))

    out_pix = np.empty(n_ev, np.int32)
    out_lane = np.empty(n_ev, np.int32)
    out_fi = np.empty(n_ev, np.float32)
    out_dt = np.empty(n_ev, np.float32)
    out_fv = np.empty(n_ev, np.float32)
    out_fv8 = np.empty(n_ev, np.int32)
    rows = lib.adder_plan_davis(
        t64.ctypes.data_as(_i64p), pix.ctypes.data_as(_i32p),
        onb.ctypes.data_as(_u8p), ctypes.c_long(n_ev), ctypes.c_long(len(lt)),
        lt.ctypes.data_as(_i64p), ln.ctypes.data_as(_f64p),
        val_cache.ctypes.data_as(_f64p),
        ctypes.c_double(dvs_c), ctypes.c_double(ref),
        ctypes.c_double(ticks_per_micro),
        out_pix.ctypes.data_as(_i32p), out_lane.ctypes.data_as(_i32p),
        out_fi.ctypes.data_as(_f32p), out_dt.ctypes.data_as(_f32p),
        out_fv.ctypes.data_as(_f32p), out_fv8.ctypes.data_as(_i32p),
    )
    if rows < 0:
        raise ValueError("adder_plan_davis: pixel index out of range")
    _copy_back(lt, last_t, ln, last_ln)
    r = int(rows)
    return DavisCompact(
        out_pix[:r], out_lane[:r], np.ones(r, bool), out_fi[:r],
        out_dt[:r], out_fv[:r], out_fv8[:r],
    )
