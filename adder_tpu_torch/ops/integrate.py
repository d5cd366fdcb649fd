"""Dense ADΔER integration: the whole pixel plane as one state machine, in torch.

The plain PyTorch counterpart of `adder_tpu/ops/integrate.py` (the state
layout, the per-interval logic `_interval_core` and its helpers). It is what
the port runs on the CPU, and what the CUDA kernel in
`adder_tpu_torch/csrc/fused_resident.cu` is held against on the card.

Same design as the JAX reference: struct-of-arrays state over the flattened
H*W*C plane; the per-pixel arena walk unrolled into DEPTH masked elementwise
steps; D-table lookups replaced by f32 exponent-bit manipulation.

Exactness. The JAX package needs `ops/numerics.py` (`exact_div`,
`exact_div_uint24`, `product_fence`) because XLA's f32 division is
approximate and LLVM contracts a product and a sum into one FMA. Neither
happens here: every eager torch op is its own kernel with its own f32
rounding, and torch's CPU and CUDA division is IEEE round-to-nearest. So a
plain `/` is the correctly rounded division and a plain `a * b` followed by
`+` rounds twice, as the reference does. This only holds for eager ops:
never run this module through `torch.compile`, and never replace a product
and a sum by `addcmul`, `lerp` or `torch.fma`.

u32 lanes (event timestamps, `_as_u32`) are carried as int64 and narrowed
by the caller; torch's uint32 support is thin. Every update builds a new
tensor (out-of-place `torch.where`); the input PixelState is never mutated.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Mode, PixelMultiMode, TimeMode

DEPTH = 8  # reference SmallVec inline capacity is 6 but can heap-grow
K_SLOTS = DEPTH + 3  # pop_top, DEPTH pop_best nodes, set_d filler, pop_top

F32_EPSILON = float(np.float32(1.1920929e-07))
D_MAX = 127
D_ZERO_INTEGRATION = 128
D_EMPTY = 255
U32_MAX = 0xFFFFFFFF

_i32 = torch.int32
_i64 = torch.int64
_f32 = torch.float32


class PixelState(NamedTuple):
    """Dense transcoder state over N pixels (SoA; node arrays are (DEPTH, N)).

    Field names, dtypes and shapes equal `adder_tpu.ops.integrate.PixelState`.
    """

    node_d: torch.Tensor  # int32 (DEPTH, N), 0..=128
    node_integ: torch.Tensor  # f32 (DEPTH, N)
    node_dt: torch.Tensor  # f32 (DEPTH, N)
    best_d: torch.Tensor  # int32 (DEPTH, N), -1 = no best event
    best_dt: torch.Tensor  # f32 (DEPTH, N)
    length: torch.Tensor  # int32 (N,), 1..=DEPTH
    base_val: torch.Tensor  # int32 (N,), u8 range
    c_thresh: torch.Tensor  # int32 (N,)
    c_increase_counter: torch.Tensor  # int32 (N,)
    last_fired_t: torch.Tensor  # f32 (N,)
    running_t: torch.Tensor  # f32 (N,)
    need_pop: torch.Tensor  # bool (N,)
    dtm_reached: torch.Tensor  # bool (N,)
    popped_dtm: torch.Tensor  # bool (N,)
    overflow: torch.Tensor  # int32 scalar: arena-depth overflow counter


STATE_DTYPES = {
    "node_d": torch.int32, "node_integ": torch.float32,
    "node_dt": torch.float32, "best_d": torch.int32,
    "best_dt": torch.float32, "length": torch.int32,
    "base_val": torch.int32, "c_thresh": torch.int32,
    "c_increase_counter": torch.int32, "last_fired_t": torch.float32,
    "running_t": torch.float32, "need_pop": torch.bool,
    "dtm_reached": torch.bool, "popped_dtm": torch.bool,
    "overflow": torch.int32,
}
ARENA_FIELDS = ("node_d", "node_integ", "node_dt", "best_d", "best_dt")


class TranscodeParams(NamedTuple):
    """Per-run integration parameters (Python scalars)."""

    mode: int = int(Mode.FramePerfect)
    multi_mode: int = int(PixelMultiMode.Collapse)
    time_mode: int = int(TimeMode.AbsoluteT)
    ref_time: int = 255
    delta_t_max: int = 7650
    c_thresh_max: int = 7
    c_increase_velocity: int = 7
    view_mode: int = 0  # FramedViewMode: 0 Intensity, 1 D, 2 DeltaT, 3 SAE


class _S:
    """Unstacked per-interval working state: DEPTH lists of (N,) vectors."""

    __slots__ = (
        "nd", "ni", "ndt", "bd", "bdt", "length", "base_val", "c_thresh",
        "cic", "lft", "running_t", "need_pop", "dtm_reached", "popped_dtm",
        "overflow",
    )

    @classmethod
    def unstack(cls, st: PixelState) -> "_S":
        s = cls()
        depth = st.node_d.shape[0]
        s.nd = [st.node_d[i] for i in range(depth)]
        s.ni = [st.node_integ[i] for i in range(depth)]
        s.ndt = [st.node_dt[i] for i in range(depth)]
        s.bd = [st.best_d[i] for i in range(depth)]
        s.bdt = [st.best_dt[i] for i in range(depth)]
        s.length = st.length
        s.base_val = st.base_val
        s.c_thresh = st.c_thresh
        s.cic = st.c_increase_counter
        s.lft = st.last_fired_t
        s.running_t = st.running_t
        s.need_pop = st.need_pop
        s.dtm_reached = st.dtm_reached
        s.popped_dtm = st.popped_dtm
        s.overflow = st.overflow
        return s

    def restack(self) -> PixelState:
        return PixelState(
            node_d=torch.stack(self.nd),
            node_integ=torch.stack(self.ni),
            node_dt=torch.stack(self.ndt),
            best_d=torch.stack(self.bd),
            best_dt=torch.stack(self.bdt),
            length=self.length,
            base_val=self.base_val,
            c_thresh=self.c_thresh,
            c_increase_counter=self.cic,
            last_fired_t=self.lft,
            running_t=self.running_t,
            need_pop=self.need_pop,
            dtm_reached=self.dtm_reached,
            popped_dtm=self.popped_dtm,
            overflow=self.overflow,
        )

    def tail_pick(self, arrs, zero):
        """arrs[length-1] per pixel via unrolled selects."""
        out = torch.full_like(arrs[0], zero)
        for s in range(len(arrs)):
            out = torch.where(self.length - 1 == s, arrs[s], out)
        return out


def init_state(
    n_pixels: int, device, c_thresh: int = 10, depth: int = DEPTH
) -> PixelState:
    """Fresh state as in PixelArena::new(1.0, coord): node d 0, c_thresh 10,
    c_increase_counter 1, no best events."""
    dev = torch.device(device)

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    return PixelState(
        node_d=z((depth, n_pixels), _i32),
        node_integ=z((depth, n_pixels), _f32),
        node_dt=z((depth, n_pixels), _f32),
        best_d=torch.full((depth, n_pixels), -1, dtype=_i32, device=dev),
        best_dt=z((depth, n_pixels), _f32),
        length=torch.ones((n_pixels,), dtype=_i32, device=dev),
        base_val=z((n_pixels,), _i32),
        c_thresh=torch.full((n_pixels,), c_thresh, dtype=_i32, device=dev),
        c_increase_counter=torch.ones((n_pixels,), dtype=_i32, device=dev),
        last_fired_t=z((n_pixels,), _f32),
        running_t=z((n_pixels,), _f32),
        need_pop=z((n_pixels,), torch.bool),
        dtm_reached=z((n_pixels,), torch.bool),
        popped_dtm=z((n_pixels,), torch.bool),
        overflow=z((), _i32),
    )


def pad_state_depth(state: PixelState, new_depth: int) -> PixelState:
    """Grow the arena depth of an existing state (zero nodes, best_d = -1):
    the depth-overflow rerun pads the pre-chunk state and runs it again."""
    old = state.node_d.shape[0]
    if new_depth <= old:
        return state
    n = state.node_d.shape[1]
    pad = new_depth - old
    dev = state.node_d.device

    def z(dt):
        return torch.zeros((pad, n), dtype=dt, device=dev)

    return state._replace(
        node_d=torch.cat([state.node_d, z(_i32)]),
        node_integ=torch.cat([state.node_integ, z(_f32)]),
        node_dt=torch.cat([state.node_dt, z(_f32)]),
        best_d=torch.cat(
            [state.best_d, torch.full((pad, n), -1, dtype=_i32, device=dev)]
        ),
        best_dt=torch.cat([state.best_dt, z(_f32)]),
    )


def set_initial_d(state: PixelState, frame_val: torch.Tensor) -> PixelState:
    """Seed D and base_val from the first frame (ref: video.rs:780-801)."""
    d0 = _d_from_intensity(frame_val.to(_f32))
    node_d = state.node_d.clone()
    node_d[0] = d0
    return state._replace(node_d=node_d, base_val=frame_val.to(_i32))


# --- f32 exponent-bit helpers (replace D_SHIFT table lookups) ---------------


def _d_from_intensity(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) via exponent bits, 128 below 1.0, clamped to D_MAX."""
    bits = x.to(_f32).view(_i32)
    e = ((bits >> 23) & 0xFF) - 127
    return torch.where(x < 1.0, D_ZERO_INTEGRATION, torch.clamp(e, max=D_MAX))


def _dshift_f32(d: torch.Tensor) -> torch.Tensor:
    """2^d as f32 for d in 0..=127; 0.0 for d >= 128 (table semantics)."""
    pow2 = ((torch.clamp(d, max=D_MAX) + 127) << 23).to(_i32).view(_f32)
    return torch.where(d >= 128, 0.0, pow2)


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """Rust `f32 as u32`: truncate toward zero, saturating, NaN -> 0.

    Follows the XLA branch of the reference (clamp at 4294967295.0, which
    rounds to 2^32 in f32, then saturate); returns int64 lanes."""
    x = torch.nan_to_num(x, nan=0.0, posinf=4294967295.0, neginf=0.0)
    x = torch.clamp(x, 0.0, 4294967295.0)
    return torch.clamp(x.to(_i64), max=U32_MAX)


def as_u32_scalar(x: float) -> int:
    """_as_u32 for one host scalar already rounded to f32."""
    if x != x or x <= 0.0:
        return 0
    if x >= 4294967296.0:  # +inf and the clamp at 4294967295.0 (2^32 in f32)
        return U32_MAX
    return int(x)


# --- event time conversion (ref: event_pixel_tree.rs:113-137) ---------------


def _emit_abs(lft, dt_f32, p: TranscodeParams):
    """delta_t -> event t (int64 u32 lanes) + updated last_fired_t."""
    if p.time_mode != int(TimeMode.AbsoluteT):
        return _as_u32(dt_f32), lft
    dtt = dt_f32 + lft
    new_lft = dtt
    if p.mode == int(Mode.FramePerfect):
        lf_u = _as_u32(dtt)
        ref = p.ref_time
        # u32 arithmetic: the product wraps as the reference's does
        rounded = torch.where(
            lf_u % ref == 0, lf_u, ((lf_u // ref + 1) * ref) & U32_MAX
        )
        new_lft = rounded.to(_f32)
    return _as_u32(dtt), new_lft


def _emit_abs_continuous(lft, dt_f32, p: TranscodeParams):
    """delta_t_to_absolute_t with mode forced Continuous (set_d filler path,
    ref: event_pixel_tree.rs:303)."""
    if p.time_mode != int(TimeMode.AbsoluteT):
        return _as_u32(dt_f32), lft
    dtt = dt_f32 + lft
    return _as_u32(dtt), dtt


# --- pop_top_event (ref: event_pixel_tree.rs:139-210) -----------------------


def _pop_top_event(s: _S, next_i, mask, p: TranscodeParams):
    """Vectorized root pop. Returns (ev_d, ev_t, mask)."""
    n0_integ, n0_dt, n0_best = s.ni[0], s.ndt[0], s.bd[0]
    has_best = n0_best >= 0

    zero_case = ~has_best & (n0_integ == 0.0) & (n0_dt > 0.0)
    synth_case = ~has_best & ~zero_case

    # synthesized best event (frame-perfect near-dtm path, ref: :161-196)
    synth_d = torch.where(
        n0_integ < 1.0, D_ZERO_INTEGRATION, _d_from_intensity(n0_integ)
    )
    ev_d = torch.where(
        zero_case, D_ZERO_INTEGRATION, torch.where(has_best, n0_best, synth_d)
    )
    ev_dt = torch.where(has_best, s.bdt[0], n0_dt)

    t, new_lft = _emit_abs(s.lft, ev_dt, p)
    if p.time_mode == int(TimeMode.AbsoluteT):
        s.lft = torch.where(mask, new_lft, s.lft)

    # arena shift-left for best & synth cases; zero case leaves arena in place
    shift = mask & ~zero_case
    for i in range(len(s.nd) - 1):
        s.nd[i] = torch.where(shift, s.nd[i + 1], s.nd[i])
        s.ni[i] = torch.where(shift, s.ni[i + 1], s.ni[i])
        s.ndt[i] = torch.where(shift, s.ndt[i + 1], s.ndt[i])
        s.bd[i] = torch.where(shift, s.bd[i + 1], s.bd[i])
        s.bdt[i] = torch.where(shift, s.bdt[i + 1], s.bdt[i])

    new_d0 = _d_from_intensity(next_i)
    ms = mask & synth_case
    s.nd[0] = torch.where(ms, new_d0, s.nd[0])
    s.ni[0] = torch.where(ms, 0.0, s.ni[0])
    s.ndt[0] = torch.where(ms, 0.0, s.ndt[0])
    s.bd[0] = torch.where(ms, -1, s.bd[0])
    mz = mask & zero_case
    s.ndt[0] = torch.where(mz, 0.0, s.ndt[0])
    s.nd[0] = torch.where(mz, new_d0, s.nd[0])

    s.length = torch.where(
        ms, 1, torch.where(mask & has_best, s.length - 1, s.length)
    )
    s.need_pop = s.need_pop & ~mask
    s.popped_dtm = s.popped_dtm | mask
    return ev_d, t, mask


# --- pop_best_events (ref: event_pixel_tree.rs:213-287) ---------------------


def _pop_best_events(s: _S, intensity, mask, p: TranscodeParams):
    """Drain all node best events where `mask`. Returns DEPTH slots in node
    order as [(d, t, emit_mask)]."""
    slots = []
    any_emit = torch.zeros_like(mask)
    tail_zeroed = torch.zeros_like(mask)
    for k in range(len(s.nd)):
        node_active = k < s.length
        has_best = s.bd[k] >= 0
        zero_ev = ~has_best & (s.ndt[k] > 0.0) & (s.ni[k] == 0.0)
        emit = mask & node_active & (has_best | zero_ev)
        d_raw = torch.where(has_best, s.bd[k], D_ZERO_INTEGRATION)
        dt_raw = torch.where(has_best, s.bdt[k], s.ndt[k])
        t, new_lft = _emit_abs(s.lft, dt_raw, p)
        if p.time_mode == int(TimeMode.AbsoluteT):
            s.lft = torch.where(emit, new_lft, s.lft)
        slots.append((d_raw, t, emit))
        any_emit = any_emit | emit
        # zero-event mutates node.dt = 0; only the tail's survives the reset
        tail_zeroed = tail_zeroed | (emit & zero_ev & (s.length - 1 == k))

    if p.multi_mode == int(PixelMultiMode.Collapse):
        collapse = mask & s.popped_dtm & any_emit
        first_d = torch.zeros_like(slots[0][0])
        first_t = torch.zeros_like(slots[0][1])
        found = torch.zeros_like(mask)
        for d_raw, t, emit in slots:
            take = emit & ~found
            first_d = torch.where(take, d_raw, first_d)
            first_t = torch.where(take, t, first_t)
            found = found | emit
        # rewrite: [first, (D_EMPTY, running_t)], rest off (ref: :249-265)
        new_slots = []
        for k, (d_raw, t, emit) in enumerate(slots):
            if k == 0:
                new_slots.append((
                    torch.where(collapse, first_d, d_raw),
                    torch.where(collapse, first_t, t),
                    emit | collapse,
                ))
            elif k == 1:
                new_slots.append((
                    torch.where(collapse, D_EMPTY, d_raw),
                    torch.where(collapse, _as_u32(s.running_t), t),
                    emit | collapse,
                ))
            else:
                new_slots.append((d_raw, t, emit & ~collapse))
        slots = new_slots
        s.lft = torch.where(collapse, s.running_t, s.lft)
    else:
        collapse = torch.zeros_like(mask)

    # arena reset: normal -> arena[0] = tail node; collapse -> fresh node
    tail_d = s.tail_pick(s.nd, 0)
    tail_integ = s.tail_pick(s.ni, 0.0)
    tail_dt = torch.where(tail_zeroed, 0.0, s.tail_pick(s.ndt, 0.0))

    fresh_d = _d_from_intensity(intensity)
    s.nd[0] = torch.where(mask, torch.where(collapse, fresh_d, tail_d), s.nd[0])
    s.ni[0] = torch.where(
        mask, torch.where(collapse, 0.0, tail_integ), s.ni[0]
    )
    s.ndt[0] = torch.where(mask, torch.where(collapse, 0.0, tail_dt), s.ndt[0])
    s.bd[0] = torch.where(mask, -1, s.bd[0])

    s.length = torch.where(mask, 1, s.length)
    s.need_pop = s.need_pop & ~mask
    s.dtm_reached = s.dtm_reached & ~mask
    s.popped_dtm = s.popped_dtm & ~mask
    return slots


# --- set_d_for_continuous (ref: event_pixel_tree.rs:289-312) ----------------


def _set_d_for_continuous(s: _S, intensity, mask, p: TranscodeParams):
    next_d = _d_from_intensity(intensity)
    fire = mask & (next_d < s.nd[0]) & (s.ndt[0] > 0.0)
    t, new_lft = _emit_abs_continuous(s.lft, s.ndt[0], p)
    if p.time_mode == int(TimeMode.AbsoluteT):
        s.lft = torch.where(fire, new_lft, s.lft)
    s.ndt[0] = torch.where(fire, 0.0, s.ndt[0])
    s.ni[0] = torch.where(fire, 0.0, s.ni[0])
    s.nd[0] = torch.where(mask, next_d, s.nd[0])
    return torch.full_like(next_d, D_EMPTY), t, fire


# --- integrate (ref: event_pixel_tree.rs:317-479) ---------------------------


def _integrate(s: _S, intensity, time, p: TranscodeParams, ovf_mask=None):
    """Vectorized PixelArena::integrate over all pixels. `time` is a host
    scalar already rounded to f32 (framed intervals) or an (N,) f32 tensor
    of per-pixel ticks spanned (DVS sub-steps). `ovf_mask`, when given,
    limits the depth-overflow counter to those pixels: DVS callers roll
    back the other pixels' state, but not the scalar counter."""
    per_pixel = isinstance(time, torch.Tensor)
    tail_virgin = (s.tail_pick(s.ndt, 0.0) == 0.0) & (
        s.tail_pick(s.ni, 0.0) == 0.0
    )
    d_aim = _d_from_intensity(intensity)
    for k in range(len(s.nd)):
        s.nd[k] = torch.where(
            (s.length - 1 == k) & tail_virgin, d_aim, s.nd[k]
        )

    i_cur = intensity.to(_f32)
    t_cur = time.to(_f32) if per_pixel else torch.full_like(i_cur, time)
    s.running_t = s.running_t + t_cur
    active = torch.ones_like(i_cur, dtype=torch.bool)
    collapse_brk = (
        s.popped_dtm
        if p.multi_mode == int(PixelMultiMode.Collapse)
        else torch.zeros_like(s.popped_dtm)
    )
    ref_f = float(np.float32(p.ref_time))

    depth = len(s.nd)
    frame_perfect = p.mode == int(Mode.FramePerfect)
    if frame_perfect:
        # FramePerfect breaks the walk at the FIRST fire, so the event
        # payload is evaluated once, after the walk, from the firing node's
        # pre-fire values (i_cur and t_cur never change before that fire)
        fire_ks = []
        snap_d = torch.zeros_like(s.nd[0])
        snap_integ = torch.zeros_like(s.ni[0])
        snap_dt = torch.zeros_like(s.ndt[0])
        child_d0 = _d_from_intensity(i_cur)

    for k in range(depth):
        d, integ, dt = s.nd[k], s.ni[k], s.ndt[k]

        total = integ + i_cur
        fire = active & (total >= _dshift_f32(d))

        new_d = _d_from_intensity(total)
        if frame_perfect:
            fire_ks.append(fire)
            snap_d = torch.where(fire, d, snap_d)
            snap_integ = torch.where(fire, integ, snap_integ)
            snap_dt = torch.where(fire, dt, snap_dt)
        else:
            prop = (_dshift_f32(new_d) - integ) / i_cur
            prop = torch.where(
                (new_d == D_ZERO_INTEGRATION)
                | (d == D_ZERO_INTEGRATION)
                | (i_cur < F32_EPSILON),
                1.0,
                prop,
            )
            # separate eager ops: each product rounds before the sum
            t_prop = t_cur * prop
            i_prop = i_cur * prop
            fired_best_dt = dt + t_prop

        # D bump for continued integration (ref: :449-461)
        bump = new_d < D_MAX
        d_bumped = torch.clamp(new_d + 1, max=128)

        accum = active & ~fire
        grow = (fire & bump) | accum
        s.nd[k] = torch.where(fire, torch.where(bump, d_bumped, new_d), d)
        s.ni[k] = torch.where(grow, total, integ)
        s.ndt[k] = torch.where(grow, dt + t_cur, dt)
        if not frame_perfect:
            s.bd[k] = torch.where(fire, new_d, s.bd[k])
            s.bdt[k] = torch.where(fire, fired_best_dt, s.bdt[k])

            # remainder (ref: :463-473)
            rem_i = i_cur - i_prop
            rem_t = t_cur - t_prop
            neg = rem_i < 0.0
            next_i = torch.where(neg, 0.0, rem_i)
            next_t = torch.where(neg, 0.0, rem_t)

        # child creation at k+1 (ref: :344-355)
        child_d = child_d0 if frame_perfect else _d_from_intensity(i_cur)
        if k + 1 < depth:
            s.nd[k + 1] = torch.where(fire, child_d, s.nd[k + 1])
            s.ni[k + 1] = torch.where(fire, 0.0, s.ni[k + 1])
            s.ndt[k + 1] = torch.where(fire, 0.0, s.ndt[k + 1])
            s.bd[k + 1] = torch.where(fire, -1, s.bd[k + 1])
        else:
            fire_c = fire if ovf_mask is None else fire & ovf_mask
            s.overflow = s.overflow + fire_c.sum(dtype=_i32)
        s.length = torch.where(fire, k + 2, s.length)

        # break conditions for the next iteration (idx = k+1)
        brk = collapse_brk
        if frame_perfect:
            brk = brk | fire
        else:
            i_cur = torch.where(fire, next_i, i_cur)
            t_cur = torch.where(fire, next_t, t_cur)
            if k + 1 < depth:
                override = fire & ~collapse_brk & (t_cur > ref_f)
                s.nd[k + 1] = torch.where(
                    override, _d_from_intensity(i_cur), s.nd[k + 1]
                )
            brk = brk | (fire & (i_cur == 0.0))
        brk = brk | (s.length <= k + 1)
        active = active & ~brk

    if frame_perfect:
        # deferred event payload for the (single) fired node
        total_f = snap_integ + i_cur
        new_d_f = _d_from_intensity(total_f)
        prop = (_dshift_f32(new_d_f) - snap_integ) / i_cur
        prop = torch.where(
            (new_d_f == D_ZERO_INTEGRATION)
            | (snap_d == D_ZERO_INTEGRATION)
            | (i_cur < F32_EPSILON),
            1.0,
            prop,
        )
        t_prop = t_cur * prop
        best_dt_f = snap_dt + t_prop
        for k in range(depth):
            s.bd[k] = torch.where(fire_ks[k], new_d_f, s.bd[k])
            s.bdt[k] = torch.where(fire_ks[k], best_dt_f, s.bdt[k])

    s.length = torch.clamp(s.length, max=depth)  # overflow containment
    s.dtm_reached = s.ndt[0] >= float(np.float32(p.delta_t_max))
    s.need_pop = (s.nd[0] == D_MAX) | (s.dtm_reached & ~s.popped_dtm)

    # adaptive c_thresh (ref: :402-412); for a scalar time the increment is
    # a host integer, for per-pixel time it is computed per pixel
    vel_m1, c_inc = c_thresh_scalars(0.0 if per_pixel else time, p)
    if per_pixel:
        c_inc = ((_as_u32(time.to(_f32)) // max(p.ref_time, 1)) % 256).to(_i32)
    adapting = s.c_thresh < p.c_thresh_max
    bump_c = adapting & (s.cic >= vel_m1)
    s.c_thresh = torch.where(
        bump_c, torch.clamp(s.c_thresh + 1, max=255), s.c_thresh
    )
    s.cic = torch.where(
        bump_c,
        0,
        torch.where(adapting, torch.clamp(s.cic + c_inc, max=255), s.cic),
    )


def c_thresh_scalars(time: float, p: TranscodeParams):
    """(velocity - 1) % 256 and the per-interval counter increment
    (u32(time) // ref_time) % 256, as the reference computes them."""
    vel_m1 = (p.c_increase_velocity - 1) % 256
    c_inc = (as_u32_scalar(time) // max(p.ref_time, 1)) % 256
    return vel_m1, c_inc


# --- full interval: integrate_for_px over the plane -------------------------


def integrate_interval(
    state: PixelState,
    intensity: torch.Tensor,  # (N,) f32
    frame_val: torch.Tensor,  # (N,) int32 (u8 range)
    time: float,  # ticks spanned
    p: TranscodeParams,
):
    """One input interval over all pixels (ref: video.rs:1317-1380).

    Returns (state, slot_d (K, N) int32, slot_t (K, N) int64 holding u32
    values, slot_mask (K, N) bool). The display intensity that the JAX
    function also returns is not ported."""
    s = _S.unstack(state)
    slots = _interval_core(s, intensity, frame_val, float(np.float32(time)), p)
    slot_d = torch.stack([x[0] for x in slots]).to(_i32)
    slot_t = torch.stack([x[1] for x in slots]).to(_i64)
    slot_m = torch.stack([x[2] for x in slots])
    return s.restack(), slot_d, slot_t, slot_m


def _interval_core(s: _S, intensity, frame_val, time, p: TranscodeParams,
                   ovf_mask=None):
    """The interval logic on an unstacked state (the reference's
    `emit_running=False` branch). `time` and `ovf_mask` as in `_integrate`.
    Mutates `s`; returns the K = depth + 3 slots as [(d, t, mask)]."""
    intensity = intensity.to(_f32)

    # 1. pre-integration pop_top
    d0, t0, m0 = _pop_top_event(s, intensity, s.need_pop, p)

    # 2. contrast threshold check (u8 saturating, ref: video.rs:1338-1340)
    bv = s.base_val
    c = s.c_thresh
    changed = (frame_val < torch.clamp(bv - c, min=0)) | (
        frame_val > torch.clamp(bv + c, max=255)
    )
    pop_slots = _pop_best_events(s, intensity, changed, p)
    s.base_val = torch.where(changed, frame_val.to(_i32), bv)

    if p.mode == int(Mode.Continuous):
        d7, t7, m7 = _set_d_for_continuous(s, intensity, changed, p)
    else:
        d7 = torch.zeros_like(d0)
        t7 = torch.zeros_like(t0)
        m7 = torch.zeros_like(m0)

    # 3. integrate
    _integrate(s, intensity, time, p, ovf_mask=ovf_mask)

    # 4. post-integration pop_top
    d8, t8, m8 = _pop_top_event(s, intensity, s.need_pop, p)

    return [(d0, t0, m0)] + list(pop_slots) + [(d7, t7, m7), (d8, t8, m8)]
