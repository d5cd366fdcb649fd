"""DVS lanes on the dense state machine: masked sub-steps and the lane planner.

Port of `adder_tpu/ops/dvs_batch.py` (lines 42-85, 198-232, 505-514), the
parts the Prophesee path runs (ref: adder-codec-rs
src/transcoder/source/prophesee.rs:116-297):

- `masked_interval`: one dense interval where only masked pixels integrate,
  with per-pixel intensity, frame value and ticks spanned. Unmasked pixels
  are restored from a snapshot, which also undoes what their don't-care
  inputs did. This literal rollback is the plain version that the K3
  kernel (csrc/dvs_resident.cu), which skips those pixels instead, is held
  against.
- `DvsCompact` and `plan_dvs_compact`: the per-event lane plan. Lane k of a
  pixel is its k-th event in the window; each planned row drives up to two
  sub-steps, the held intensity over the gap (sub-step 2k) and one source
  tick of the new intensity (sub-step 2k + 1). The sequential f64 ln chain
  is walked on the host by the JAX package's native planner
  (`adder_tpu/ops/native/dvs_plan.cpp`, shared by import); there is no
  numpy fallback here, so a missing planner raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from adder_tpu.ops import native_dvs_plan as _native

from . import integrate as ops


def masked_step(s: ops._S, intensity, frame_val, time, mask,
                p: ops.TranscodeParams):
    """`ops._interval_core` on an unstacked state where only `mask` pixels
    integrate: every field of the other pixels is restored and their slots
    are masked off; the depth-overflow counter counts masked pixels only.
    Mutates `s`; returns the K slots as [(d, t, mask)]."""
    old = {f: getattr(s, f) for f in ops._S.__slots__ if f != "overflow"}
    old = {f: list(v) if isinstance(v, list) else v for f, v in old.items()}
    slots = ops._interval_core(s, intensity, frame_val, time, p,
                               ovf_mask=mask)
    for f, v in old.items():
        new = getattr(s, f)
        if isinstance(v, list):
            setattr(s, f, [torch.where(mask, a, b) for a, b in zip(new, v)])
        else:
            setattr(s, f, torch.where(mask, new, v))
    return [(d, t, m & mask) for d, t, m in slots]


def masked_interval(state: ops.PixelState, intensity: torch.Tensor,
                    frame_val: torch.Tensor, time: torch.Tensor,
                    mask: torch.Tensor, p: ops.TranscodeParams):
    """One dense interval where only `mask` pixels integrate.

    intensity (N,) f32, frame_val (N,) int32, time (N,) f32 ticks spanned
    per pixel, mask (N,) bool. Returns (state, slot_d (K, N) int32, slot_t
    (K, N) int64 holding u32 values, slot_m (K, N) bool); the display
    intensity the JAX function also returns is not ported."""
    s = ops._S.unstack(state)
    slots = masked_step(s, intensity, frame_val, time, mask, p)
    slot_d = torch.stack([x[0] for x in slots]).to(torch.int32)
    slot_t = torch.stack([x[1] for x in slots]).to(torch.int64)
    slot_m = torch.stack([x[2] for x in slots])
    return s.restack(), slot_d, slot_t, slot_m


class DvsCompact(NamedTuple):
    """Compact DVS lane plan: one row per source event that survives the
    out-of-order drop and does device work (a gap and/or a tick sub-step),
    in lane-major order. Fields, dtypes and meaning equal
    `adder_tpu.ops.dvs_batch.DvsCompact`: gap_int is the f32 product
    f32(gap_val) * f32(gap_n), gap_time is f32(gap_n * ref)."""

    pix: np.ndarray  # (E,) int32 flat pixel index
    lane: np.ndarray  # (E,) int32 per-pixel occurrence number
    gap_on: np.ndarray  # (E,) bool
    gap_fv: np.ndarray  # (E,) int32
    gap_int: np.ndarray  # (E,) float32
    gap_time: np.ndarray  # (E,) float32
    tick_on: np.ndarray  # (E,) bool
    tick_fv: np.ndarray  # (E,) int32
    tick_int: np.ndarray  # (E,) float32
    tick_time: np.ndarray  # (E,) float32
    gap_val: np.ndarray  # (E,) float32 held value (post mid-clamp)
    gap_n: np.ndarray  # (E,) int64 gap tick count (t - last_t - 1)

    @property
    def n_lanes(self) -> int:
        return int(self.lane.max()) + 1 if len(self.lane) else 0

    def lane_slice(self, lane_lo: int, lane_hi: int) -> "DvsCompact":
        """Rows whose lane falls in [lane_lo, lane_hi), rebased to 0."""
        sel = (self.lane >= lane_lo) & (self.lane < lane_hi)
        out = DvsCompact(*(f[sel] for f in self))
        return out._replace(lane=(out.lane - lane_lo).astype(np.int32))


def plan_dvs_compact(ts, xs, ys, ps, width: int, last_t: np.ndarray,
                     last_ln: np.ndarray, theta: float, ref: int,
                     val_cache: np.ndarray | None = None) -> DvsCompact:
    """Plan one batch of time-ordered DVS events (ref: prophesee.rs:175-249)
    through the shared native planner, with the argument list of
    `adder_tpu.ops.native_dvs_plan.plan_dvs_native`.

    Mutates the chain state in place: last_t (N,) uint32, last_ln (N,)
    float64 and, when given, val_cache (N,) float64 (the exp(last_ln) memo,
    NaN = not cached). Raises RuntimeError when the planner cannot be built
    or loaded (it needs g++)."""
    lib = _native._get_lib()
    if lib is None:
        raise RuntimeError(
            "the native DVS planner (adder_tpu/ops/native/dvs_plan.cpp) is "
            "unavailable: it is built with g++ at first use, and "
            "ADDER_TPU_NATIVE_DVS_PLAN=0 disables it"
        )
    if last_t.dtype != np.uint32 or last_ln.dtype != np.float64:
        raise ValueError("last_t must be uint32 and last_ln float64")
    if not (last_t.flags.c_contiguous and last_ln.flags.c_contiguous):
        raise ValueError("last_t and last_ln must be contiguous")
    n = len(last_t)
    if val_cache is None:
        val_cache = np.full(n, np.nan, np.float64)
    if val_cache.dtype != np.float64 or len(val_cache) != n or len(last_ln) != n:
        raise ValueError("last_ln and val_cache must be (N,) float64")
    n_ev = len(ts)
    t64 = np.ascontiguousarray(ts, dtype=np.int64)
    pix = np.ascontiguousarray(
        np.asarray(ys, np.int64) * width + np.asarray(xs, np.int64), np.int32
    )
    pol = np.ascontiguousarray(np.asarray(ps) != 0, dtype=np.uint8)
    out = DvsCompact(
        np.empty(n_ev, np.int32), np.empty(n_ev, np.int32),
        np.empty(n_ev, np.uint8), np.empty(n_ev, np.int32),
        np.empty(n_ev, np.float32), np.empty(n_ev, np.float32),
        np.empty(n_ev, np.uint8), np.empty(n_ev, np.int32),
        np.empty(n_ev, np.float32), np.empty(n_ev, np.float32),
        np.empty(n_ev, np.float32), np.empty(n_ev, np.int64),
    )

    def ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    ctype_of = {np.dtype(np.int32): ctypes.c_int32,
                np.dtype(np.uint8): ctypes.c_uint8,
                np.dtype(np.float32): ctypes.c_float,
                np.dtype(np.int64): ctypes.c_int64}
    rows = lib.adder_plan_dvs(
        ptr(t64, ctypes.c_int64), ptr(pix, ctypes.c_int32),
        ptr(pol, ctypes.c_uint8), ctypes.c_long(n_ev), ctypes.c_long(n),
        ptr(last_t, ctypes.c_uint32), ptr(last_ln, ctypes.c_double),
        ptr(val_cache, ctypes.c_double),
        ctypes.c_double(theta), ctypes.c_double(ref),
        *(ptr(a, ctype_of[a.dtype]) for a in out),
    )
    if rows < 0:
        raise ValueError("adder_plan_dvs: pixel index out of range")
    r = int(rows)
    out = DvsCompact(*(a[:r] for a in out))
    return out._replace(gap_on=out.gap_on.view(bool),
                        tick_on=out.tick_on.view(bool))


def wire_to_events(pixd: np.ndarray, t: np.ndarray, width: int):
    """Decode (pix << 8 | d, t) u32 wire pairs to (x, y, d, t) arrays."""
    pix = (pixd >> 8).astype(np.int64)
    return (
        (pix % width).astype(np.uint16),
        (pix // width).astype(np.uint16),
        (pixd & 0xFF).astype(np.uint8),
        t.astype(np.uint32),
    )
