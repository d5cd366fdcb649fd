"""ctypes binding of the native DVS and DAVIS lane planners (ops/native/dvs_plan.cpp).

Copy of the parts of `adder_tpu/ops/native_dvs_plan.py` that the port runs:
`plan_dvs_native` (Prophesee, the classic plan), `PackedDvsPlan` and
`plan_dvs_pack8_native` (Prophesee, the plan and the 8-byte carrier in one
pass, `adder_tpu/ops/native_dvs_plan.py:136-232`) and `plan_davis_native`
(DAVIS). The library builds through `ops/native_build.py`; a missing
toolchain raises, as the port has no numpy fallback. The planners mutate
the caller's last_t / last_ln chain state in place (copied back when the
input needed a dtype or contiguity conversion), and the exp(last_ln) memo
`val_cache` when given.
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
            lib.adder_plan_dvs_pack8.restype = ctypes.c_long
            lib.adder_plan_dvs_pack8.argtypes = [
                _i64p, _i32p, _u8p, ctypes.c_long, ctypes.c_long,
                _u32p, _f64p, _f64p, ctypes.c_double, ctypes.c_double,
                ctypes.c_int32, ctypes.c_int64, ctypes.c_long,
                _u32p, _u32p, _u32p, _u32p, _i32p,
                _i64p, _i64p, _i64p, _i32p,
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


class PackedDvsPlan:
    """Fused native plan + 8-byte-carrier pack for one DVS window
    (adder_plan_dvs_pack8): carrier rows in lane-major order, shared
    (value, fv) dictionary, per-lane row boundaries for 64-aligned group
    slicing, and per-lane gap/tick active counts for capacity sizing."""

    __slots__ = (
        "row0", "row1", "dict0", "dict1", "lane_off", "gap_cnt",
        "tick_cnt", "n_lanes", "pb",
    )

    def __init__(self, row0, row1, dict0, dict1, lane_off, gap_cnt,
                 tick_cnt, n_lanes, pb):
        self.row0 = row0
        self.row1 = row1
        self.dict0 = dict0
        self.dict1 = dict1
        self.lane_off = lane_off
        self.gap_cnt = gap_cnt
        self.tick_cnt = tick_cnt
        self.n_lanes = n_lanes
        self.pb = pb


def plan_dvs_pack8_native(ts, xs, ys, ps, width, n, last_t, last_ln,
                          theta, ref, val_cache=None, lane_cap=4096):
    """Fused `plan_dvs_native` + `fused_resident.pack_dvs_plan8` in one
    native pass: a PackedDvsPlan, or None when the window does not fit the
    factored 8-byte layout (a pixel index past 24 bits, a gap_n past its
    field or the i32 gap_n * ref product, a dictionary past 64 entries, a
    lane past `lane_cap`). On None the chain state is left as it was
    (snapshot and restore around the call), so the caller can fall back to
    the classic plan and the 20-byte carrier. An empty window gives a plan
    of no rows and leaves the chain alone."""
    lib = _get_lib()
    pb = max(1, int(n - 1).bit_length())
    if 24 - pb < 0:
        return None
    gn_max = min((1 << (20 + (24 - pb))) - 1, (2**31 - 1) // max(ref, 1))
    n_ev = len(ts)
    if n_ev == 0:
        z = np.zeros(0, np.uint32)
        return PackedDvsPlan(z, z, z, z, np.zeros(1, np.int64),
                             np.zeros(0, np.int64), np.zeros(0, np.int64),
                             0, pb)
    t64 = np.ascontiguousarray(ts, dtype=np.int64)
    pix = _pixels(xs, ys, width)
    pol = np.ascontiguousarray(np.asarray(ps) != 0, dtype=np.uint8)
    lt = np.ascontiguousarray(last_t, dtype=np.uint32)
    ln = np.ascontiguousarray(last_ln, dtype=np.float64)
    val_cache = _memo(val_cache, len(ln))
    # the native call advances the chain mid-stream even on a window that
    # does not fit: a snapshot, so the fallback starts from the same chain
    snap = (lt.copy(), ln.copy(), val_cache.copy())

    row0 = np.empty(n_ev, np.uint32)
    row1 = np.empty(n_ev, np.uint32)
    dict0 = np.empty(64, np.uint32)
    dict1 = np.empty(64, np.uint32)
    ndict = np.zeros(1, np.int32)
    lane_off = np.zeros(lane_cap + 1, np.int64)
    gap_cnt = np.zeros(lane_cap, np.int64)
    tick_cnt = np.zeros(lane_cap, np.int64)
    nlanes = np.zeros(1, np.int32)
    rows = lib.adder_plan_dvs_pack8(
        t64.ctypes.data_as(_i64p), pix.ctypes.data_as(_i32p),
        pol.ctypes.data_as(_u8p), ctypes.c_long(n_ev),
        ctypes.c_long(len(lt)),
        lt.ctypes.data_as(_u32p), ln.ctypes.data_as(_f64p),
        val_cache.ctypes.data_as(_f64p),
        ctypes.c_double(theta), ctypes.c_double(ref),
        ctypes.c_int32(pb), ctypes.c_int64(int(gn_max)),
        ctypes.c_long(lane_cap),
        row0.ctypes.data_as(_u32p), row1.ctypes.data_as(_u32p),
        dict0.ctypes.data_as(_u32p), dict1.ctypes.data_as(_u32p),
        ndict.ctypes.data_as(_i32p),
        lane_off.ctypes.data_as(_i64p), gap_cnt.ctypes.data_as(_i64p),
        tick_cnt.ctypes.data_as(_i64p), nlanes.ctypes.data_as(_i32p),
    )
    if rows == -1:
        raise ValueError("adder_plan_dvs_pack8: pixel index out of range")
    if rows < 0:
        lt[...], ln[...], val_cache[...] = snap
        _copy_back(lt, last_t, ln, last_ln)
        return None
    _copy_back(lt, last_t, ln, last_ln)
    r, nd, nl = int(rows), int(ndict[0]), int(nlanes[0])
    return PackedDvsPlan(
        row0[:r], row1[:r], dict0[:nd], dict1[:nd], lane_off[: nl + 1],
        gap_cnt[:nl], tick_cnt[:nl], nl, pb,
    )


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
