"""The plain reference of a framed ADΔER transcode, in eager PyTorch.

What `correct` is judged against. It follows the pixel state machine of
adder-codec-rs (`src/transcoder/event_pixel_tree.rs`: pop_top_event,
pop_best_events, integrate; `src/transcoder/source/video.rs:1317-1380`,
the per-pixel interval) over the whole plane as struct-of-arrays tensors,
one eager torch operation at a time, for the settings the benchmark's
configurations state: FramePerfect, Collapse, DeltaT. It imports nothing
but numpy and torch, and nothing of the program under test.

Exactness: every operation is its own eager kernel, so each f32 result is
rounded once, as the reference's scalar code rounds it; division is
tensor by tensor (IEEE on the CPU and on CUDA). Never run this through
`torch.compile`, and never fuse a product and a sum.

Layout of a state (the field names and dtypes the program's PixelState
uses, so the two can be compared field by field): the arena fields are
(depth, N), the rest (N,), `overflow` a 0-d counter a chunk passes on
unchanged. The arena starts at depth 6 (the reference's SmallVec inline
capacity); a chunk whose arena outgrows it is run again from its
pre-chunk state at depth 8.

`prec="bf16"` rounds every float result to bfloat16: the control, the
same arithmetic one precision below what the configuration states.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

import numpy as np
import torch

SHALLOW_DEPTH = 6
DEPTH = 8
D_MAX = 127
D_ZERO = 128
D_EMPTY = 255
U32_MAX = 0xFFFFFFFF
F32_EPSILON = float(np.float32(1.1920929e-07))

_i32, _i64, _f32 = torch.int32, torch.int64, torch.float32

ARENA = ("node_d", "node_integ", "node_dt", "best_d", "best_dt")


class State(NamedTuple):
    node_d: torch.Tensor
    node_integ: torch.Tensor
    node_dt: torch.Tensor
    best_d: torch.Tensor
    best_dt: torch.Tensor
    length: torch.Tensor
    base_val: torch.Tensor
    c_thresh: torch.Tensor
    c_increase_counter: torch.Tensor
    last_fired_t: torch.Tensor
    running_t: torch.Tensor
    need_pop: torch.Tensor
    dtm_reached: torch.Tensor
    popped_dtm: torch.Tensor
    overflow: torch.Tensor


class Params(NamedTuple):
    """The transcode settings of a configuration file."""

    ref_time: int
    delta_t_max: int
    c_thresh_baseline: int
    c_thresh_max: int
    c_increase_velocity: int


class Chunk(NamedTuple):
    """What one chunk gives: the state after it, its events in stream
    order (`pixd` = pixel << 8 | d, `t`, both int32 bit patterns; None
    when not asked for), the events of each interval, the largest count of
    one pixel in one interval with the depth flag at bit 16 (`pmax`), and
    the total."""

    state: State
    pixd: Optional[torch.Tensor]
    t: Optional[torch.Tensor]
    per_interval: torch.Tensor
    pmax: torch.Tensor
    total: torch.Tensor
    runnings: None = None


def params_of(config: dict) -> Params:
    """The settings of a configuration; refuses any the reference does not
    implement."""
    want = {"mode": "FramePerfect", "pixel_multi_mode": "Collapse",
            "time_mode": "DeltaT"}
    for key, value in want.items():
        if config[key] != value:
            raise ValueError(f"reference implements {key}={value}, "
                             f"not {config[key]}")
    return Params(config["ref_time"], config["delta_t_max"],
                  config["c_thresh_baseline"], config["c_thresh_max"],
                  config["c_increase_velocity"])


def initial_state(n: int, p: Params, device, depth: int = SHALLOW_DEPTH
                  ) -> State:
    """Every pixel before its first frame: one node of d 0, c_thresh at
    the baseline, no best event."""
    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    return State(
        node_d=z((depth, n), _i32), node_integ=z((depth, n), _f32),
        node_dt=z((depth, n), _f32),
        best_d=torch.full((depth, n), -1, dtype=_i32, device=device),
        best_dt=z((depth, n), _f32),
        length=torch.ones(n, dtype=_i32, device=device),
        base_val=z(n, _i32),
        c_thresh=torch.full((n,), p.c_thresh_baseline, dtype=_i32,
                            device=device),
        c_increase_counter=z(n, _i32), last_fired_t=z(n, _f32),
        running_t=z(n, _f32), need_pop=z(n, torch.bool),
        dtm_reached=z(n, torch.bool), popped_dtm=z(n, torch.bool),
        overflow=z((), _i32))


def first_frame(state: State, frame: torch.Tensor) -> State:
    """D and the base value from the stream's first frame (video.rs:780-801)."""
    node_d = state.node_d.clone()
    node_d[0] = _d_of(frame.to(_f32))
    return state._replace(node_d=node_d, base_val=frame.to(_i32))


def deepen(state: State, depth: int) -> State:
    """The same state with its arena grown to `depth` (empty nodes)."""
    old, n = state.node_d.shape
    if depth <= old:
        return state
    dev = state.node_d.device
    pad = {f: torch.zeros((depth - old, n), dtype=getattr(state, f).dtype,
                          device=dev) for f in ARENA}
    pad["best_d"] = pad["best_d"] - 1
    return state._replace(**{f: torch.cat([getattr(state, f), pad[f]])
                             for f in ARENA})


def as_state(obj) -> State:
    """A State holding the tensors of any object with the same fields."""
    return State(*(getattr(obj, f) for f in State._fields))


# --- f32 helpers -------------------------------------------------------------


def _d_of(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) from the exponent bits; 128 below 1; at most 127."""
    e = ((x.to(_f32).view(_i32) >> 23) & 0xFF) - 127
    return torch.where(x < 1.0, D_ZERO, torch.clamp(e, max=D_MAX))


def _pow2(d: torch.Tensor) -> torch.Tensor:
    """2^d as f32, 0 for d >= 128."""
    p = ((torch.clamp(d, max=D_MAX) + 127) << 23).to(_i32).view(_f32)
    return torch.where(d >= 128, 0.0, p)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """Rust's `f32 as u32` (saturating, NaN to 0), as int64."""
    x = torch.nan_to_num(x, nan=0.0, posinf=4294967295.0, neginf=0.0)
    x = torch.clamp(x, 0.0, 4294967295.0)
    return torch.clamp(x.to(_i64), max=U32_MAX)


def _u32_scalar(x: float) -> int:
    if x != x or x <= 0.0:
        return 0
    return U32_MAX if x >= 4294967296.0 else int(x)


# --- the state machine ---------------------------------------------------


class _Pixels:
    """A state unstacked into per-depth (N,) vectors while a chunk runs."""

    def __init__(self, st: State, rnd):
        self.nd = list(st.node_d.unbind(0))
        self.ni = list(st.node_integ.unbind(0))
        self.ndt = list(st.node_dt.unbind(0))
        self.bd = list(st.best_d.unbind(0))
        self.bdt = list(st.best_dt.unbind(0))
        self.length, self.base_val = st.length, st.base_val
        self.c_thresh, self.cic = st.c_thresh, st.c_increase_counter
        self.lft, self.running_t = st.last_fired_t, st.running_t
        self.need_pop, self.dtm_reached = st.need_pop, st.dtm_reached
        self.popped_dtm = st.popped_dtm
        self.fires_past_depth = torch.zeros((), dtype=_i32,
                                            device=st.length.device)
        self.rnd = rnd

    def state(self, overflow: torch.Tensor) -> State:
        return State(torch.stack(self.nd), torch.stack(self.ni),
                     torch.stack(self.ndt), torch.stack(self.bd),
                     torch.stack(self.bdt), self.length, self.base_val,
                     self.c_thresh, self.cic, self.lft, self.running_t,
                     self.need_pop, self.dtm_reached, self.popped_dtm,
                     overflow)

    def tail(self, arrs, zero):
        out = torch.full_like(arrs[0], zero)
        for k, a in enumerate(arrs):
            out = torch.where(self.length - 1 == k, a, out)
        return out

    def pop_top(self, next_i, mask):
        """event_pixel_tree.rs:139-210 (DeltaT: t is the node's dt)."""
        has_best = self.bd[0] >= 0
        zero = ~has_best & (self.ni[0] == 0.0) & (self.ndt[0] > 0.0)
        synth = ~has_best & ~zero
        synth_d = torch.where(self.ni[0] < 1.0, D_ZERO, _d_of(self.ni[0]))
        ev_d = torch.where(zero, D_ZERO, torch.where(has_best, self.bd[0],
                                                     synth_d))
        ev_t = _u32(torch.where(has_best, self.bdt[0], self.ndt[0]))
        shift = mask & ~zero
        for arrs in (self.nd, self.ni, self.ndt, self.bd, self.bdt):
            for i in range(len(arrs) - 1):
                arrs[i] = torch.where(shift, arrs[i + 1], arrs[i])
        d0 = _d_of(next_i)
        ms = mask & synth
        self.nd[0] = torch.where(ms, d0, self.nd[0])
        self.ni[0] = torch.where(ms, 0.0, self.ni[0])
        self.ndt[0] = torch.where(ms, 0.0, self.ndt[0])
        self.bd[0] = torch.where(ms, -1, self.bd[0])
        mz = mask & zero
        self.ndt[0] = torch.where(mz, 0.0, self.ndt[0])
        self.nd[0] = torch.where(mz, d0, self.nd[0])
        self.length = torch.where(
            ms, 1, torch.where(mask & has_best, self.length - 1, self.length))
        self.need_pop = self.need_pop & ~mask
        self.popped_dtm = self.popped_dtm | mask
        return [(ev_d, ev_t, mask)]

    def pop_best(self, intensity, mask):
        """event_pixel_tree.rs:213-287, Collapse."""
        slots = []
        any_emit = torch.zeros_like(mask)
        tail_zeroed = torch.zeros_like(mask)
        for k in range(len(self.nd)):
            has_best = self.bd[k] >= 0
            zero_ev = ~has_best & (self.ndt[k] > 0.0) & (self.ni[k] == 0.0)
            emit = mask & (k < self.length) & (has_best | zero_ev)
            d = torch.where(has_best, self.bd[k], D_ZERO)
            t = _u32(torch.where(has_best, self.bdt[k], self.ndt[k]))
            slots.append((d, t, emit))
            any_emit = any_emit | emit
            tail_zeroed = tail_zeroed | (emit & zero_ev
                                         & (self.length - 1 == k))
        # Collapse: the first event and then (D_EMPTY, running_t)
        collapse = mask & self.popped_dtm & any_emit
        first_d = torch.zeros_like(slots[0][0])
        first_t = torch.zeros_like(slots[0][1])
        found = torch.zeros_like(mask)
        for d, t, emit in slots:
            take = emit & ~found
            first_d = torch.where(take, d, first_d)
            first_t = torch.where(take, t, first_t)
            found = found | emit
        out = []
        for k, (d, t, emit) in enumerate(slots):
            if k == 0:
                out.append((torch.where(collapse, first_d, d),
                            torch.where(collapse, first_t, t),
                            emit | collapse))
            elif k == 1:
                out.append((torch.where(collapse, D_EMPTY, d),
                            torch.where(collapse, _u32(self.running_t), t),
                            emit | collapse))
            else:
                out.append((d, t, emit & ~collapse))
        self.lft = torch.where(collapse, self.running_t, self.lft)
        tail_d = self.tail(self.nd, 0)
        tail_i = self.tail(self.ni, 0.0)
        tail_dt = torch.where(tail_zeroed, 0.0, self.tail(self.ndt, 0.0))
        fresh = _d_of(intensity)
        self.nd[0] = torch.where(mask, torch.where(collapse, fresh, tail_d),
                                 self.nd[0])
        self.ni[0] = torch.where(mask, torch.where(collapse, 0.0, tail_i),
                                 self.ni[0])
        self.ndt[0] = torch.where(mask, torch.where(collapse, 0.0, tail_dt),
                                  self.ndt[0])
        self.bd[0] = torch.where(mask, -1, self.bd[0])
        self.length = torch.where(mask, 1, self.length)
        self.need_pop = self.need_pop & ~mask
        self.dtm_reached = self.dtm_reached & ~mask
        self.popped_dtm = self.popped_dtm & ~mask
        return out

    def integrate(self, intensity, time: float, p: Params):
        """event_pixel_tree.rs:317-479, FramePerfect: the walk stops at the
        first node that fires, whose event is worked out after the walk."""
        r = self.rnd
        depth = len(self.nd)
        virgin = (self.tail(self.ndt, 0.0) == 0.0) & (
            self.tail(self.ni, 0.0) == 0.0)
        d_aim = _d_of(intensity)
        for k in range(depth):
            self.nd[k] = torch.where((self.length - 1 == k) & virgin, d_aim,
                                     self.nd[k])
        i_cur = intensity
        t_cur = torch.full_like(i_cur, time)
        self.running_t = r(self.running_t + t_cur)
        active = torch.ones_like(i_cur, dtype=torch.bool)
        stop = self.popped_dtm  # Collapse
        fires = []
        snap_d = torch.zeros_like(self.nd[0])
        snap_i = torch.zeros_like(self.ni[0])
        snap_dt = torch.zeros_like(self.ndt[0])
        child_d = _d_of(i_cur)
        for k in range(depth):
            d, integ, dt = self.nd[k], self.ni[k], self.ndt[k]
            total = r(integ + i_cur)
            fire = active & (total >= _pow2(d))
            new_d = _d_of(total)
            fires.append(fire)
            snap_d = torch.where(fire, d, snap_d)
            snap_i = torch.where(fire, integ, snap_i)
            snap_dt = torch.where(fire, dt, snap_dt)
            bump = new_d < D_MAX
            grow = (fire & bump) | (active & ~fire)
            self.nd[k] = torch.where(
                fire, torch.where(bump, torch.clamp(new_d + 1, max=128),
                                  new_d), d)
            self.ni[k] = torch.where(grow, total, integ)
            self.ndt[k] = torch.where(grow, r(dt + t_cur), dt)
            if k + 1 < depth:
                self.nd[k + 1] = torch.where(fire, child_d, self.nd[k + 1])
                self.ni[k + 1] = torch.where(fire, 0.0, self.ni[k + 1])
                self.ndt[k + 1] = torch.where(fire, 0.0, self.ndt[k + 1])
                self.bd[k + 1] = torch.where(fire, -1, self.bd[k + 1])
            else:
                self.fires_past_depth = (self.fires_past_depth
                                         + fire.sum(dtype=_i32))
            self.length = torch.where(fire, k + 2, self.length)
            active = active & ~(stop | fire | (self.length <= k + 1))
        new_d = _d_of(r(snap_i + i_cur))
        prop = r(r(_pow2(new_d) - snap_i) / i_cur)
        prop = torch.where((new_d == D_ZERO) | (snap_d == D_ZERO)
                           | (i_cur < F32_EPSILON), 1.0, prop)
        best_dt = r(snap_dt + r(t_cur * prop))
        for k in range(depth):
            self.bd[k] = torch.where(fires[k], new_d, self.bd[k])
            self.bdt[k] = torch.where(fires[k], best_dt, self.bdt[k])
        self.length = torch.clamp(self.length, max=depth)
        self.dtm_reached = self.ndt[0] >= float(np.float32(p.delta_t_max))
        self.need_pop = (self.nd[0] == D_MAX) | (self.dtm_reached
                                                 & ~self.popped_dtm)
        # the adaptive contrast threshold (event_pixel_tree.rs:402-412)
        vel_m1 = (max(p.c_increase_velocity, 1) - 1) % 256
        c_inc = (_u32_scalar(time) // max(p.ref_time, 1)) % 256
        adapting = self.c_thresh < p.c_thresh_max
        bump_c = adapting & (self.cic >= vel_m1)
        self.c_thresh = torch.where(
            bump_c, torch.clamp(self.c_thresh + 1, max=255), self.c_thresh)
        self.cic = torch.where(bump_c, 0, torch.where(
            adapting, torch.clamp(self.cic + c_inc, max=255), self.cic))

    def interval(self, frame: torch.Tensor, time: float, p: Params):
        """One frame over every pixel (video.rs:1317-1380): the events in
        the reference's order within a pixel."""
        intensity = frame.to(_f32)
        fv = frame.to(_i32)
        slots = self.pop_top(intensity, self.need_pop)
        changed = ((fv < torch.clamp(self.base_val - self.c_thresh, min=0))
                   | (fv > torch.clamp(self.base_val + self.c_thresh,
                                       max=255)))
        slots += self.pop_best(intensity, changed)
        self.base_val = torch.where(changed, fv, self.base_val)
        self.integrate(intensity, time, p)
        return slots + self.pop_top(intensity, self.need_pop)


def _rounding(prec: str):
    if prec == "f32":
        return lambda x: x
    if prec == "bf16":
        return lambda x: x.to(torch.bfloat16).to(_f32)
    raise ValueError(f"unknown precision {prec!r}")


def run_chunk(state: State, frames: torch.Tensor, p: Params,
              events: bool = True, prec: str = "f32") -> Chunk:
    """T frames ((T, N) u8) from `state`, the arena deepened and the chunk
    run again from `state` when it outgrows a shallow depth."""
    out = _run_once(state, frames, p, events, prec)
    if int(out.pmax) >> 16 and state.node_d.shape[0] < DEPTH:
        out = _run_once(deepen(state, DEPTH), frames, p, events, prec)
    return out


def _run_once(state, frames, p, events, prec) -> Chunk:
    n = frames.shape[1]
    dev = frames.device
    px = _Pixels(state, _rounding(prec))
    time = float(np.float32(p.ref_time))
    pix = torch.arange(n, dtype=_i64, device=dev)[:, None]
    counts, most, pixd, ts = [], torch.zeros((), dtype=_i64, device=dev), [], []
    for i in range(frames.shape[0]):
        slots = px.interval(frames[i], time, p)
        m = torch.stack([s[2] for s in slots], dim=1)  # (n, slots)
        per_pixel = m.sum(dim=1)
        most = torch.maximum(most, per_pixel.max())
        counts.append(per_pixel.sum())
        if events:
            d = torch.stack([s[0] for s in slots], dim=1).to(_i64)
            t = torch.stack([s[1] for s in slots], dim=1)
            pixd.append(((pix << 8) | (d & 0xFF))[m].to(_i32))
            ts.append(t[m].to(_i32))
    per_interval = torch.stack(counts).to(_i64)
    pmax = most | ((px.fires_past_depth > 0).to(_i64) << 16)
    return Chunk(px.state(state.overflow),
                 torch.cat(pixd) if events else None,
                 torch.cat(ts) if events else None,
                 per_interval, pmax, per_interval.sum())


# --- the .adder raw bytes ------------------------------------------------


def header_bytes(config: dict) -> bytes:
    """The raw stream's header, codec version 3 (adder-codec-core
    codec/header.rs, encoder.rs:170-229): big-endian fixed ints."""
    c = config["plane"]["channels"]
    base = struct.pack(
        ">5sBBHHIIIBB", b"adder", 3, ord("b"), config["plane"]["width"],
        config["plane"]["height"], config["tps"], config["ref_time"],
        config["delta_t_max"], 9 if c == 1 else 11, c)
    camera = {"FramedU8": 0}[config["source_camera"]]
    time_mode = {"DeltaT": 0, "AbsoluteT": 1}[config["time_mode"]]
    return base + struct.pack(">III", camera, time_mode, 0)


_MONO = np.dtype([("x", ">u2"), ("y", ">u2"), ("d", "u1"), ("t", ">u4")])
_COLOR = np.dtype([("x", ">u2"), ("y", ">u2"), ("tag", "u1"), ("c", "u1"),
                   ("d", "u1"), ("t", ">u4")])


def event_bytes(pixd: np.ndarray, t: np.ndarray, width: int,
                channels: int) -> bytes:
    """Events (`pix << 8 | d` and t as u32) in the raw wire format
    (codec/raw/stream.rs): x, y, [Some(c)], d, t, big-endian."""
    pixd = pixd.view(np.uint32)
    pix = (pixd >> 8).astype(np.int64)
    xy = pix // channels
    out = np.empty(len(pixd), dtype=_MONO if channels == 1 else _COLOR)
    out["x"] = xy % width
    out["y"] = xy // width
    if channels > 1:
        out["tag"] = 1
        out["c"] = pix % channels
    out["d"] = pixd & 0xFF
    out["t"] = t.view(np.uint32)
    return out.tobytes()
