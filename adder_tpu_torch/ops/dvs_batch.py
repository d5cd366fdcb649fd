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
  is walked on the host by the native planner (`ops/native/dvs_plan.cpp`,
  a copy of the JAX package's); there is no numpy fallback here, so a
  missing planner raises.
- `davis_event_interval`, `DavisCompact` and `plan_davis_events_compact`:
  the DAVIS counterparts (`adder_tpu/ops/dvs_batch.py:520-654`, ref:
  davis.rs:235-465). One lane is one sub-step per pixel, in the DAVIS op
  order: pop_top, integrate the held intensity over the gap, pop_top, then
  the contrast stage against the post-ln-step frame value.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import integrate as ops
from . import native_dvs_plan as _native


def _snapshot(s: ops._S) -> dict:
    """Every per-pixel field of `s` (the overflow counter aside), for
    `_rollback`."""
    old = {f: getattr(s, f) for f in ops._S.__slots__ if f != "overflow"}
    return {f: list(v) if isinstance(v, list) else v for f, v in old.items()}


def _rollback(s: ops._S, old: dict, mask: torch.Tensor) -> None:
    """Restore every field of the pixels outside `mask` from `old`."""
    for f, v in old.items():
        new = getattr(s, f)
        if isinstance(v, list):
            setattr(s, f, [torch.where(mask, a, b) for a, b in zip(new, v)])
        else:
            setattr(s, f, torch.where(mask, new, v))


def masked_step(s: ops._S, intensity, frame_val, time, mask,
                p: ops.TranscodeParams):
    """`ops._interval_core` on an unstacked state where only `mask` pixels
    integrate: every field of the other pixels is restored and their slots
    are masked off; the depth-overflow counter counts masked pixels only.
    Mutates `s`; returns the K slots as [(d, t, mask)]."""
    old = _snapshot(s)
    slots = ops._interval_core(s, intensity, frame_val, time, p,
                               ovf_mask=mask)
    _rollback(s, old, mask)
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
    through the native planner, with the argument list of
    `adder_tpu.ops.native_dvs_plan.plan_dvs_native`.

    Mutates the chain state in place: last_t (N,) uint32, last_ln (N,)
    float64 and, when given, val_cache (N,) float64 (the exp(last_ln) memo,
    NaN = not cached). Raises RuntimeError when the planner cannot be built
    (it needs g++)."""
    if last_t.dtype != np.uint32 or last_ln.dtype != np.float64:
        raise ValueError("last_t must be uint32 and last_ln float64")
    if not (last_t.flags.c_contiguous and last_ln.flags.c_contiguous):
        raise ValueError("last_t and last_ln must be contiguous")
    if len(last_ln) != len(last_t):
        raise ValueError("last_t and last_ln must have one length")
    return _native.plan_dvs_native(ts, xs, ys, ps, width, last_t, last_ln,
                                   theta, ref, val_cache)


# --- DAVIS (ref: adder-codec-rs/src/transcoder/source/davis.rs) -------------


def davis_masked_step(s: ops._S, first_int, dt_ticks, frame_val, fv8, mask,
                      p: ops.TranscodeParams):
    """One DAVIS DVS event per masked pixel on an unstacked state (port of
    `davis_event_interval`, `adder_tpu/ops/dvs_batch.py:520-572`): pop_top,
    integrate the held intensity `first_int` over `dt_ticks` (per-pixel
    time, so a per-pixel c_thresh increment), pop_top, then the contrast
    stage (pop_best, base_val, set_d) against the post-ln-step frame value
    (`frame_val` f32, `fv8` its int32 truncation). Unmasked pixels are
    restored from a snapshot; the overflow counter counts masked pixels
    only. Mutates `s`; returns the K = depth + 3 slots in the pixel's
    chronological order (d0, d8, pop_best..., d7) as [(d, t, mask)]."""
    old = _snapshot(s)
    inten = first_int.to(torch.float32)
    d0, t0, m0 = ops._pop_top_event(s, inten, s.need_pop, p)
    ops._integrate(s, inten, dt_ticks, p, ovf_mask=mask)
    d8, t8, m8 = ops._pop_top_event(s, inten, s.need_pop, p)
    fv_f = frame_val.to(torch.float32)
    bv, c = s.base_val, s.c_thresh
    changed = mask & ((fv8 < torch.clamp(bv - c, min=0))
                      | (fv8 > torch.clamp(bv + c, max=255)))
    pop_slots = ops._pop_best_events(s, fv_f, changed, p)
    s.base_val = torch.where(changed, fv8.to(torch.int32), s.base_val)
    d7, t7, m7 = ops._set_d_for_continuous(s, fv_f, changed, p)
    _rollback(s, old, mask)
    slots = [(d0, t0, m0), (d8, t8, m8)] + list(pop_slots) + [(d7, t7, m7)]
    return [(d, t, m & mask) for d, t, m in slots]


def davis_event_interval(state: ops.PixelState, first_int: torch.Tensor,
                         dt_ticks: torch.Tensor, frame_val: torch.Tensor,
                         fv8: torch.Tensor, mask: torch.Tensor,
                         p: ops.TranscodeParams):
    """`davis_masked_step` on a stacked state: first_int, dt_ticks and
    frame_val (N,) f32, fv8 (N,) int32, mask (N,) bool. Returns (state,
    slot_d (K, N) int32, slot_t (K, N) int64 holding u32 values, slot_m
    (K, N) bool), as `adder_tpu.ops.dvs_batch.davis_event_interval`."""
    s = ops._S.unstack(state)
    slots = davis_masked_step(s, first_int, dt_ticks, frame_val, fv8, mask, p)
    slot_d = torch.stack([x[0] for x in slots]).to(torch.int32)
    slot_t = torch.stack([x[1] for x in slots]).to(torch.int64)
    slot_m = torch.stack([x[2] for x in slots])
    return s.restack(), slot_d, slot_t, slot_m


class DavisCompact(NamedTuple):
    """Compact DAVIS lane plan: one row per event that does device work (one
    sub-step of lane `lane` at pixel `pix`), lane-major. Fields, dtypes and
    meaning equal `adder_tpu.ops.dvs_batch.DavisCompact`."""

    pix: np.ndarray  # (E,) int32
    lane: np.ndarray  # (E,) int32
    active: np.ndarray  # (E,) bool
    first_int: np.ndarray  # (E,) float32 held intensity over the gap
    dt_ticks: np.ndarray  # (E,) float32 ticks spanned by the gap
    fval: np.ndarray  # (E,) float32 post-ln-step frame value
    fv8: np.ndarray  # (E,) int32 its truncation

    @property
    def n_lanes(self) -> int:
        return int(self.lane.max()) + 1 if len(self.lane) else 0

    def lane_slice(self, lane_lo: int, lane_hi: int) -> "DavisCompact":
        """Rows whose lane falls in [lane_lo, lane_hi), rebased to 0."""
        sel = (self.lane >= lane_lo) & (self.lane < lane_hi)
        out = DavisCompact(*(f[sel] for f in self))
        return out._replace(lane=(out.lane - lane_lo).astype(np.int32))


def plan_davis_events_compact(ts, xs, ys, ons, width: int,
                              last_t: np.ndarray, last_ln: np.ndarray,
                              dvs_c: float, ref: int, ticks_per_micro: float,
                              val_cache: np.ndarray | None = None
                              ) -> DavisCompact:
    """Plan one batch of time-ordered DAVIS DVS events (ref:
    davis.rs:235-465) through the native planner: the argument list of
    `adder_tpu.ops.dvs_batch.plan_davis_events_compact` without its `n`.

    Mutates the chain state in place: last_t (N,) int64 microseconds,
    last_ln (N,) float64 and, when given, val_cache (N,) float64 (the
    exp(last_ln) memo, NaN = not cached). Raises RuntimeError when the
    planner cannot be built (it needs g++)."""
    if last_t.dtype != np.int64 or last_ln.dtype != np.float64:
        raise ValueError("last_t must be int64 and last_ln float64")
    if not (last_t.flags.c_contiguous and last_ln.flags.c_contiguous):
        raise ValueError("last_t and last_ln must be contiguous")
    if len(last_ln) != len(last_t):
        raise ValueError("last_t and last_ln must have one length")
    return _native.plan_davis_native(ts, xs, ys, ons, width, last_t, last_ln,
                                     dvs_c, ref, ticks_per_micro, val_cache)


def wire_to_events(pixd: np.ndarray, t: np.ndarray, width: int):
    """Decode (pix << 8 | d, t) u32 wire pairs to (x, y, d, t) arrays."""
    pix = (pixd >> 8).astype(np.int64)
    return (
        (pix % width).astype(np.uint16),
        (pix // width).astype(np.uint16),
        (pixd & 0xFF).astype(np.uint8),
        t.astype(np.uint32),
    )
