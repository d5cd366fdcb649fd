"""One transcode chunk: T intervals over the whole plane, events in reference order.

Counterpart of `adder_tpu/ops/fused_resident.py` in its two framed modes,
`make_fused_chunk_resident` (events fetched) and `make_group_chunk_resident`
(the Empty sink, where only counts and the depth flag are read), in its
DVS mode, `make_dvs_chunk_resident_packed` (lane sub-steps from the (5, E)
carrier of `pack_dvs_plan`, at depth 16) and
`make_dvs_chunk_resident_packed8` (the same from the (2, E + 64) carrier
of `pack_dvs_plan8`, 8 bytes a row and a dictionary), and in its DAVIS mode,
`make_davis_chunk_resident_packed` (one DAVIS event per pixel and sub-step,
from the carrier of `pack_davis_plan`, at depth 16).

Each entry point has two implementations:

- the plain PyTorch version (`fused_chunk_resident_plain`,
  `group_chunk_resident_plain`, `dvs_rows_resident_plain`,
  `dvs_rows8_resident_plain`, `davis_rows_resident_plain`): a Python loop
  over the T intervals of
  `integrate._interval_core` (for DVS, `dvs_batch.masked_step`; for DAVIS,
  `dvs_batch.davis_masked_step`, each over the carrier scattered into dense
  (T, N) planes), then the per-interval slots compacted into the
  reference's single-thread order (interval, raster pixel, slot);
- the hand-written Hopper kernels of `csrc/` (`adder_resident_chunk`,
  `adder_segment_copy` and `adder_exclusive_scan` in fused_resident.cu,
  `adder_dvs_rows`, `adder_dvs_rows8`, the grouping
  (`adder_rows_group_keys`, `_scan`, `_rank`) and `adder_rows_copy` in
  dvs_resident.cu, `adder_davis_rows` in
  davis_resident.cu), reached through the wrappers `fused_chunk_resident`,
  `group_chunk_resident`, `dvs_rows_resident`, `dvs_rows8_resident` and
  `davis_rows_resident` (and `segment_copy` and `rows_copy`, whose plain
  versions are `segment_copy_plain` and `rows_copy_plain`), and
  `wire_pack` (`adder_wire_pack` in fused_resident.cu; plain version
  `wire_pack_plain`), which turns a chunk's events into `.adder` records.

A wrapper runs the plain version for CPU tensors and launches the kernels
for CUDA tensors; a failed launch raises, there is no fallback.

Every DVS and DAVIS chunk takes one route: its carrier, the grouping of
its rows (on the card: `group_dvs_rows`; for a chunk of one row per pixel
in raster order, `raster_row_groups`), and the row walk, which builds no
plane and updates the state of the pixels that have rows in place. With
its events, the walk runs the state machine once: each cell (a pixel's
sub-step) stages its events in its own DVS_DEPTH + 3 slots, the scan of
the cell counts gives each cell its offset, and the rows copy moves them
there.

The events come back already in reference order, so the JAX package's
pack reruns and its host assembler have no counterpart here. A framed
chunk with its events runs the state machine once: the kernel stages each
warp's events of each interval in slabs of a pool, the scan of the
per-(interval, warp) counts gives each segment its offset, and the segment
copy moves them there. The buffers are sized by the caller's capacity, as
the JAX resident chunk's `event_cap`, and nothing is read back to the host
inside the chunk: `total` says on the device whether the events fit. The
lane chunks size their buffers from one host read of the scan's total,
unless the caller gives `event_cap`, a bound it knows (the Prophesee lane
groups: 19 events at most for each active cell of the host's plan); then
nothing is read back either.

Outputs (`ChunkResult`):
  state        the PixelState after the chunk (`overflow` passed through
               unchanged, as the resident kernel does);
  pixd, t      int32 holding u32 bit patterns: `pix << 8 | d` and the
               event time (None on the Empty-sink path); a framed chunk on
               the card gives its (event_cap,) buffers, the events first.
               In the framed chunk's wide layout (`wide_layout`: planes of
               2^24 pixel-channels and more, or forced by `wide=True`)
               `pixd` is int64 pix << 8 | d, 12 bytes an event with `t`;
  per_interval (T,) int64 event counts;
  pmax         0-d int64: bits 0-15 the largest per-(interval, pixel) event
               count, bit 16 arena-depth overflow (`fused_resident.py:409-413`);
  runnings     the framed chunks given a display frame `run0` (n,) u8 (the
               JAX chunk's `emit_running=True`): (T, n) u8, the display frame
               after each interval, carried forward from `run0` where a pixel
               shows nothing new (`fused_resident.py:890-899`); else None.
               The kernel carries it in the thread's register;
  total        0-d int64, the chunk's events.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.types import Mode, TimeMode

from . import cuda_build, dvs_batch
from . import integrate as ops

BLOCK = 256  # pixels per block of K5 and K6; kBlock in adder_interval.cuh
MAX_T = 128  # intervals per chunk; kMaxT in adder_interval.cuh
MAX_PIXELS = 1 << 24  # pix << 8 | d keeps 24 bits of pixel index
# The framed chunk's wide event layout (planes of MAX_PIXELS pixel-channels
# and more): `pixd` int64 pix << 8 | d; the pack's pixel index is a u32
MAX_WIDE_PIXELS = 1 << 32

DVS_DEPTH = 16  # the arena depth of the DVS and DAVIS paths (K3, K4)
# staging slots of one cell of the row walk: the most events one sub-step
# emits at depth 16
ROW_SLOTS = DVS_DEPTH + 3
# AdderRowsArgs.src: what a carrier row holds
SRC_DVS, SRC_DAVIS, SRC_DVS8 = 1, 2, 3
DICT_CAP = 64  # the 8-byte carrier's shared (value, fv) dictionary

# Launches of each kernel, counted where the wrapper launches it; the
# framed chunk's wide layout counts under its own keys (`_wide`).
LAUNCHES = {"adder_resident_chunk": 0, "adder_segment_copy": 0,
            "adder_exclusive_scan": 0, "adder_dvs_rows": 0,
            "adder_dvs_rows8": 0, "adder_rows_group": 0,
            "adder_davis_rows": 0, "adder_rows_copy": 0,
            "adder_wire_pack": 0, "adder_resident_chunk_wide": 0,
            "adder_segment_copy_wide": 0, "adder_wire_pack_wide": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ChunkResult(NamedTuple):
    state: ops.PixelState
    pixd: Optional[torch.Tensor]
    t: Optional[torch.Tensor]
    per_interval: torch.Tensor
    pmax: torch.Tensor
    runnings: Optional[torch.Tensor] = None
    total: Optional[torch.Tensor] = None


# --- plain PyTorch versions -------------------------------------------------


def wide_layout(n: int) -> bool:
    """Whether a framed chunk of n pixel-channels takes the wide event
    layout: its pixel index does not fit the 24 bits of pix << 8 | d."""
    return n >= MAX_PIXELS


def _chunk_plain(state: ops.PixelState, T: int, step,
                 events: bool, wide: bool = False) -> ChunkResult:
    """The loop every plain chunk shares: `step(s, i)` runs sub-step i on
    the unstacked state `s` and returns its K slots; the slots are
    compacted in (sub-step, raster pixel, slot) order. `wide`: `pixd` as
    int64 (the framed chunk's wide layout)."""
    n = state.length.shape[0]
    dev = state.length.device
    s = ops._S.unstack(state)
    s.overflow = torch.zeros((), dtype=torch.int32, device=dev)
    pix = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    max_cnt = torch.zeros((), dtype=torch.int64, device=dev)
    counts, pixd_parts, t_parts = [], [], []
    for i in range(T):
        slots = step(s, i)
        m = torch.stack([x[2] for x in slots], dim=1)  # (n, K) pixel-major
        cnt = m.sum(dim=1)
        max_cnt = torch.maximum(max_cnt, cnt.max())
        counts.append(cnt.sum())
        if events:
            d = torch.stack([x[0] for x in slots], dim=1).to(torch.int64)
            tt = torch.stack([x[1] for x in slots], dim=1).to(torch.int64)
            pixd = ((pix << 8) | (d & 0xFF))[m]
            pixd_parts.append(pixd if wide else pixd.to(torch.int32))
            t_parts.append(tt[m].to(torch.int32))
    new_state = s.restack()._replace(overflow=state.overflow)
    pmax = max_cnt | ((s.overflow > 0).to(torch.int64) << 16)
    per_interval = torch.stack(counts).to(torch.int64)
    total = per_interval.sum()
    if not events:
        return ChunkResult(new_state, None, None, per_interval, pmax,
                           total=total)
    return ChunkResult(
        new_state, torch.cat(pixd_parts), torch.cat(t_parts), per_interval,
        pmax, total=total,
    )


def _framed_plain(state, frames, time, p, events: bool,
                  run0=None, wide: bool = False) -> ChunkResult:
    time = float(np.float32(time))
    run, runnings = run0, []

    def step(s, i):
        nonlocal run
        fv = frames[i].to(torch.int32)
        slots = ops._interval_core(s, fv.to(torch.float32), fv, time, p)
        if run0 is not None:
            val, has = ops._running_intensity(s, p)
            run = torch.where(has, val, run)
            runnings.append(run)
        return slots

    res = _chunk_plain(state, frames.shape[0], step, events, wide)
    if run0 is None:
        return res
    return res._replace(runnings=torch.stack(runnings))


def fused_chunk_resident_plain(state, frames, time, p, run0=None,
                               wide: bool = False) -> ChunkResult:
    """Plain version of the fetched-events chunk: state after T intervals
    and the chunk's events in reference order (`wide`: in the wide layout);
    with `run0`, the display frames too."""
    return _framed_plain(state, frames, time, p, True, run0, wide)


def group_chunk_resident_plain(state, frames, time, p,
                               run0=None) -> ChunkResult:
    """Plain version of the Empty-sink chunk: state, counts and flags only
    (and, with `run0`, the display frames)."""
    return _framed_plain(state, frames, time, p, False, run0)


def exclusive_scan_plain(counts: torch.Tensor) -> torch.Tensor:
    """Plain version of `adder_exclusive_scan`: exclusive prefix sums of the
    flattened int32 counts as int64, with the total appended."""
    flat = counts.reshape(-1).to(torch.int64)
    out = torch.zeros(flat.numel() + 1, dtype=torch.int64, device=flat.device)
    out[1:] = torch.cumsum(flat, 0)
    return out


# --- DVS lane chunks (K3) ---------------------------------------------------


def dvs_chunk_resident_plain(state: ops.PixelState, inten: torch.Tensor,
                             tspan: torch.Tensor, fvw: torch.Tensor,
                             p: ops.TranscodeParams,
                             events: bool = True) -> ChunkResult:
    """Plain version of the DVS lane chunk (`make_dvs_chunk_resident`,
    `adder_tpu/ops/fused_resident.py:1017`): T sub-steps of
    `dvs_batch.masked_step`, the literal snapshot-and-restore rollback, on
    the (T, N) planes intensity f32, ticks spanned f32 and `fv | active << 8`
    int32. Events in (sub-step, raster pixel, slot) order, which is each
    pixel's chronological order."""

    def step(s, i):
        w = fvw[i]
        active = ((w >> 8) & 1) != 0
        return dvs_batch.masked_step(s, inten[i], w & 0xFF, tspan[i], active,
                                     p)

    return _chunk_plain(state, inten.shape[0], step, events)


def build_dvs_planes(T: int, n: int, pix, lane, gap_on, gap_fv, gap_int,
                     gap_time, tick_on, tick_fv, tick_int, *, ref_time: int):
    """Scatter compact DVS rows into the (T, N) lane planes [intensity,
    ticks spanned, fv | active << 8]: the gap sub-step of lane k goes to row
    2k, its tick to row 2k + 1 (port of `build_dvs_planes`,
    `adder_tpu/ops/fused_resident.py:1115`). A tick spans one source tick,
    the constant `ref_time`. Rows whose gap or tick is off go to a
    discarded slot past the planes, so nothing waits for the device."""
    dev = pix.device
    pix = pix.to(torch.int64)
    lane = lane.to(torch.int64)
    dump = T * n
    gdst = torch.where(gap_on, 2 * lane * n + pix, dump)
    tdst = torch.where(tick_on, (2 * lane + 1) * n + pix, dump)
    dst = torch.cat([gdst, tdst])
    tick_time = torch.full(tick_on.shape, float(np.float32(ref_time)),
                           dtype=torch.float32, device=dev)

    def plane(gv, tv, dtype):
        z = torch.zeros(T * n + 1, dtype=dtype, device=dev)
        z.index_put_((dst,), torch.cat([gv.to(dtype), tv.to(dtype)]))
        return z[: T * n].view(T, n)

    inten = plane(gap_int, tick_int, torch.float32)
    tspan = plane(gap_time, tick_time, torch.float32)
    fvw = plane(gap_fv.to(torch.int32) | (gap_on.to(torch.int32) << 8),
                tick_fv.to(torch.int32) | (tick_on.to(torch.int32) << 8),
                torch.int32)
    return inten, tspan, fvw


def pack_dvs_plan(plan) -> np.ndarray:
    """A DvsCompact (or a lane slice of one) -> the (5, E) int32 carrier of
    `pack_dvs_plan` (`adder_tpu/ops/fused_resident.py:1339`), 20 bytes per
    row, so a lane group reaches the card in one host -> device copy:
      row 0: pix | lane << 20 | gap_on << 27 | tick_on << 28
      row 1: gap_fv | tick_fv << 8
      rows 2-4: the bits of gap_int, gap_time, tick_int."""
    E = len(plan.pix)
    if E and (int(plan.pix.max()) >= 1 << 20 or int(plan.lane.max()) >= 128):
        raise ValueError("the carrier holds pixels < 2^20 and lanes < 128")
    packed = np.empty((5, E), np.int32)
    packed[0] = (plan.pix | (plan.lane << 20)
                 | (plan.gap_on.astype(np.int32) << 27)
                 | (plan.tick_on.astype(np.int32) << 28))
    packed[1] = plan.gap_fv | (plan.tick_fv << 8)
    packed[2] = plan.gap_int.view(np.int32)
    packed[3] = plan.gap_time.view(np.int32)
    packed[4] = plan.tick_int.view(np.int32)
    return packed


def unpack_dvs_carrier(packed: torch.Tensor):
    """The (5, E) carrier -> the nine row fields of `build_dvs_planes`
    (pix, lane, gap_on, gap_fv, gap_int, gap_time, tick_on, tick_fv,
    tick_int), with torch bit ops on the carrier's device."""
    meta = packed[0]
    return (
        meta & 0xFFFFF,
        (meta >> 20) & 0x7F,
        ((meta >> 27) & 1) != 0,
        packed[1] & 0xFF,
        packed[2].view(torch.float32),
        packed[3].view(torch.float32),
        ((meta >> 28) & 1) != 0,
        (packed[1] >> 8) & 0xFF,
        packed[4].view(torch.float32),
    )


def pix_bits(n: int) -> int:
    """The bits of the 8-byte carrier's pixel field for a plane of n
    pixels (`pb`)."""
    return max(1, int(n - 1).bit_length())


def pack_dvs_plan8(plan, n: int, ref_time: int):
    """A DvsCompact (or a lane slice of one) -> ((2, E + DICT_CAP) int32
    carrier, pb), 8 bytes per row, or None when the rows do not fit the
    factored layout and the caller falls back to `pack_dvs_plan`'s 20-byte
    carrier. Copy of `pack_dvs_plan8` (`adder_tpu/ops/fused_resident.py:
    1284-1336`) with E_pad = E: the port's carriers have no padding, so the
    dictionary follows the E rows.

    Bit layout (within u32 rows; pb = bits for a pixel index < n):
      row0: pix[0:pb] | lane[pb:pb+6] | gap_on[pb+6] | tick_on[pb+7]
            | gap_n_hi[pb+8:32]
      row1: gap_n_lo[0:20] | gap_idx[20:26] | tick_idx[26:32]
      dict appendix (columns E .. E+DICT_CAP):
            row0 = f32 bits of the value, row1 = its frame value
    One shared dictionary holds the unique (value, fv) pairs of both the
    gap side (gap_val/gap_fv) and the tick side (tick_int/tick_fv).
    Infeasible when: pixel indices need > 24 bits, a lane id >= 64, the
    dictionary exceeds DICT_CAP, or gap_n overflows its field / the exact
    i32 gap_n * ref_time product."""
    E = len(plan.pix)
    pb = pix_bits(n)
    hi_bits = 24 - pb
    if hi_bits < 0 or E == 0:
        return None
    gn = np.where(plan.gap_on, plan.gap_n, 0).astype(np.int64)
    if int(plan.lane.max()) >= 64:
        return None
    mx = int(gn.max())
    if mx >= (1 << (20 + hi_bits)) or mx > (2**31 - 1) // max(ref_time, 1):
        return None
    gv = plan.gap_val.view(np.int32).astype(np.int64)
    tv = plan.tick_int.view(np.int32).astype(np.int64)
    gkey = (gv << 32) | (plan.gap_fv.astype(np.int64) & 0xFFFFFFFF)
    tkey = (tv << 32) | (plan.tick_fv.astype(np.int64) & 0xFFFFFFFF)
    keys, inv = np.unique(np.concatenate([gkey, tkey]), return_inverse=True)
    if len(keys) > DICT_CAP:
        return None
    gidx = inv[:E].astype(np.uint32)
    tidx = inv[E:].astype(np.uint32)
    row0 = (
        plan.pix.astype(np.uint32)
        | (plan.lane.astype(np.uint32) << pb)
        | (plan.gap_on.astype(np.uint32) << (pb + 6))
        | (plan.tick_on.astype(np.uint32) << (pb + 7))
        | ((gn >> 20).astype(np.uint32) << (pb + 8))
    )
    row1 = (gn & 0xFFFFF).astype(np.uint32) | (gidx << 20) | (tidx << 26)
    packed = np.zeros((2, E + DICT_CAP), np.uint32)
    packed[0, :E] = row0
    packed[1, :E] = row1
    packed[0, E : E + len(keys)] = (keys >> 32).astype(np.uint32)
    packed[1, E : E + len(keys)] = (keys & 0xFFFFFFFF).astype(np.uint32)
    return packed.view(np.int32), pb


def unpack_dvs_carrier8(packed: torch.Tensor, pb: int, ref_time: int):
    """The (2, E + DICT_CAP) carrier of `pack_dvs_plan8` -> the nine row
    fields of `build_dvs_planes` (pix, lane, gap_on, gap_fv, gap_int,
    gap_time, tick_on, tick_fv, tick_int), with torch ops on the carrier's
    device: the plain version of the decode in `adder_dvs_rows8` (port of
    `unpack_dvs_carrier8`, `adder_tpu/ops/fused_resident.py:1254-1281`).
      gap_int  = f32(dict value[gap_idx]) * f32(gap_n)  (f32 multiply)
      gap_time = f32(gap_n * ref_time)                  (exact i32 product)
      tick_int, gap_fv, tick_fv from the dictionary.
    Gap-side values of tick-only rows are don't-cares (the plane scatter
    drops them through gap_on); the rest equals the planner's fields bit
    for bit."""
    E = packed.shape[1] - DICT_CAP
    u = packed.to(torch.int64) & 0xFFFFFFFF  # the u32 words
    r0, r1 = u[0, :E], u[1, :E]
    dval = packed[0, E:].contiguous().view(torch.float32)
    dfv = packed[1, E:]
    gn = (((r0 >> (pb + 8)) << 20) | (r1 & 0xFFFFF)).to(torch.int32)
    gidx, tidx = (r1 >> 20) & 63, (r1 >> 26) & 63
    return (
        (r0 & ((1 << pb) - 1)).to(torch.int32),
        ((r0 >> pb) & 63).to(torch.int32),
        ((r0 >> (pb + 6)) & 1) != 0,
        dfv[gidx],
        dval[gidx] * gn.to(torch.float32),
        (gn * ref_time).to(torch.float32),
        ((r0 >> (pb + 7)) & 1) != 0,
        dfv[tidx],
        dval[tidx],
    )


# --- lane chunks by rows: the grouping (K3 and K4) ---------------------------


class RowGroups(NamedTuple):
    """A carrier's rows grouped for the row walk; every array int64 on the
    carrier's device, made without a host read. A lane is `per_lane`
    sub-steps: 2 for DVS (the gap, then the tick), 1 for DAVIS.

    order      (E,) row indices sorted by (pixel, lane): the rows of one
               pixel are consecutive and in lane order;
    row_start  (E + 2,) for the j-th pixel that has rows (raster order,
               j < n_active) the start of its run in `order`; every later
               entry up to row_start[E] is E, so run j ends at
               row_start[j + 1] (the last slot is scratch);
    n_active   (1,) the number of pixels that have rows;
    cell_gap, cell_tick  (E,) the rank of each row's gap cell and tick cell
               among the 2 E cells in (sub-step, raster pixel) order, the
               order in which the chunk's events leave: the cells of
               sub-step 2 k are the gap halves of lane k's rows by pixel,
               those of sub-step 2 k + 1 their tick halves. DAVIS: cell_gap
               is each row's one cell, its rank among the E rows in (lane,
               raster pixel) order, and cell_tick is empty;
    sub_start  (T + 1,) the first cell of each sub-step, then per_lane x E."""

    order: torch.Tensor
    row_start: torch.Tensor
    n_active: torch.Tensor
    cell_gap: torch.Tensor
    cell_tick: torch.Tensor
    sub_start: torch.Tensor


def group_dvs_rows(carrier: torch.Tensor, T: int, per_lane: int = 2,
                   pb: Optional[int] = None, *,
                   n: Optional[int] = None) -> RowGroups:
    """Group the rows of a (5, E >= 1) carrier of T / per_lane lanes by
    pixel and rank their cells in output order: `pack_dvs_plan`'s with
    per_lane 2, `pack_davis_plan`'s with per_lane 1 (the low 27 bits of row
    0 are lane << 20 | pix in both); with `pb`, the (2, E + DICT_CAP)
    carrier of `pack_dvs_plan8` (per_lane 2), whose row 0 holds pix in its
    low pb bits and the lane in the 6 above. Each (lane, pixel) holds at
    most one row, as the planners guarantee; the rows may come in any
    order. For a CUDA carrier the three kernels of csrc/dvs_resident.cu
    (`adder_rows_group_keys`, `_scan`, `_rank`, each counted in
    LAUNCHES["adder_rows_group"]), which need the plane's pixel count `n`
    (pixels below n, lanes below T / per_lane; a row outside them is left
    out) and sort nothing; for a CPU carrier `group_dvs_rows_plain`."""
    if per_lane not in (1, 2) or (pb is not None and per_lane != 2):
        raise ValueError(f"{per_lane} sub-steps a lane; the grouping takes 1 "
                         f"or 2, and 2 for the 8-byte carrier")
    if not carrier.is_cuda:
        return group_dvs_rows_plain(carrier, T, per_lane, pb)
    if n is None or not 1 <= n <= 1 << 20:
        raise ValueError(f"the grouping on the card needs the plane's pixel "
                         f"count n in 1..2^20, got {n}")
    meta = _row0(carrier, pb)
    E, dev = meta.shape[0], meta.device
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # every output in one allocation: order, row_start, n_active, cell_gap,
    # cell_tick, sub_start
    sizes = (E, E + 2, 1, E, E if per_lane == 2 else 0, T + 1)
    out = torch.empty(sum(sizes), dtype=torch.int64, device=dev).split(sizes)
    a = _RowsGroupArgs()
    a.meta, a.rows, a.pb = meta.data_ptr(), E, pb or 0
    a.per_lane, a.T, a.n = per_lane, T, n
    a.order, a.row_start, a.n_active, a.cell_gap = (x.data_ptr()
                                                    for x in out[:4])
    a.cell_tick = out[4].data_ptr() if per_lane == 2 else None
    a.sub_start = out[5].data_ptr()
    words = ctypes.c_longlong()
    err = lib.adder_rows_group_scratch(n, T // per_lane,
                                       ctypes.addressof(words))
    if err:
        raise ValueError(f"the grouping's scratch for {n} pixels and "
                         f"{T // per_lane} lanes: "
                         f"{cuda_build.error_string(err)}")
    # the keys entry clears the part that must start at zero; freed on
    # return, it is reused only by work queued after these launches
    scratch = torch.empty(words.value, dtype=torch.int64, device=dev)
    a.scratch = scratch.data_ptr()
    for fn in (lib.adder_rows_group_keys, lib.adder_rows_group_scan,
               lib.adder_rows_group_rank):
        err = fn(ctypes.addressof(a), stream)
        if err:
            raise RuntimeError(f"the row grouping's launch failed: "
                               f"{cuda_build.error_string(err)}")
        LAUNCHES["adder_rows_group"] += 1
    return RowGroups(*out)


class _RowsGroupArgs(ctypes.Structure):
    """Mirror of `struct AdderRowsGroupArgs` in csrc/dvs_resident.cu."""

    _fields_ = [
        ("meta", ctypes.c_void_p),
        ("rows", ctypes.c_longlong),
        ("pb", ctypes.c_int),
        ("per_lane", ctypes.c_int),
        ("T", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("scratch", ctypes.c_void_p),
        ("order", ctypes.c_void_p),
        ("row_start", ctypes.c_void_p),
        ("n_active", ctypes.c_void_p),
        ("cell_gap", ctypes.c_void_p),
        ("cell_tick", ctypes.c_void_p),
        ("sub_start", ctypes.c_void_p),
    ]


def _row0(carrier: torch.Tensor, pb: Optional[int]) -> torch.Tensor:
    """Row 0 of a carrier's rows: the whole first row of a 20-byte carrier,
    the first E of an 8-byte one (its dictionary follows)."""
    return carrier[0] if pb is None else carrier[0, :carrier.shape[1]
                                                 - DICT_CAP]


def row_keys_plain(carrier: torch.Tensor,
                   pb: Optional[int] = None) -> torch.Tensor:
    """Each row's lane << 20 | pix (int32): the low 27 bits of a 20-byte
    carrier's row 0, or the fields of an 8-byte carrier's (`pb`)."""
    meta = _row0(carrier, pb)
    if pb is None:
        return meta & 0x7FFFFFF
    return (((meta >> pb) & 63) << 20) | (meta & ((1 << pb) - 1))


def group_dvs_rows_plain(carrier: torch.Tensor, T: int, per_lane: int = 2,
                         pb: Optional[int] = None) -> RowGroups:
    """Plain version of `group_dvs_rows`, with torch ops on the carrier's
    device (any E); it reads nothing back to the host either."""
    key = row_keys_plain(carrier, pb)  # lane << 20 | pix
    E = key.shape[0]
    dev = key.device
    lane = (key >> 20).to(torch.int64)
    ar = torch.arange(E, dtype=torch.int64, device=dev)
    # the rows of each pixel, in lane order
    skey, order = torch.sort(((key & 0xFFFFF) << 7) | (key >> 20))
    spix = skey >> 7
    head = torch.ones(E, dtype=torch.bool, device=dev)
    head[1:] = spix[1:] != spix[:-1]
    pos = torch.cumsum(head, 0) - 1
    row_start = torch.full((E + 2,), E, dtype=torch.int64, device=dev)
    # a row that heads no run writes to the discarded last slot
    row_start.scatter_(0, torch.where(head, pos, E + 1), ar)
    n_active = pos[-1:] + 1 if E else pos.new_zeros(1)
    # each row's rank in (lane, pixel) order, and each lane's first rank
    lkey, lorder = torch.sort(key)
    rank = torch.empty_like(ar)
    rank[lorder] = ar
    lanes = torch.arange(T // per_lane + 1, dtype=key.dtype, device=dev) << 20
    lane_start = torch.searchsorted(lkey, lanes)
    if per_lane == 1:  # a row's one cell is its rank
        return RowGroups(order, row_start, n_active, rank, rank[:0],
                         lane_start)
    lane_count = lane_start[1:] - lane_start[:-1]
    cell_gap = rank + lane_start[lane]
    cell_tick = cell_gap + lane_count[lane]
    sub_start = torch.cat([
        torch.stack([2 * lane_start[:-1], 2 * lane_start[:-1] + lane_count],
                    dim=1).reshape(-1),
        2 * lane_start[-1:],
    ])
    return RowGroups(order, row_start, n_active, cell_gap, cell_tick,
                     sub_start)


def raster_row_groups(E: int, device) -> RowGroups:
    """The grouping of a T = 2 DVS carrier of one row per pixel, in raster
    order, all in lane 0 (the Prophesee bootstrap and end-of-stream flush,
    DAVIS's frame and the gap to it), known without a sort: what
    `group_dvs_rows` makes of such a carrier, from four small torch ops and
    no grouping kernel."""
    ar = torch.arange(E, dtype=torch.int64, device=device)
    return RowGroups(ar, torch.cat([ar, ar.new_full((2,), E)]),
                     ar.new_full((1,), E), ar, ar + E,
                     ar.new_tensor([0, E, 2 * E]))


def dvs_rows_resident_plain(state: ops.PixelState, carrier: torch.Tensor,
                            T: int, p: ops.TranscodeParams,
                            events: bool = True) -> ChunkResult:
    """Plain version of `dvs_rows_resident`, the DVS lane group given as its
    carrier (`make_dvs_chunk_resident_packed`,
    `adder_tpu/ops/fused_resident.py:1159`): the carrier unpacked,
    scattered into dense planes and run through `dvs_chunk_resident_plain`.
    Returns a new state; the input state is left as it was."""
    n = state.length.shape[0]
    planes = build_dvs_planes(T, n, *unpack_dvs_carrier(carrier),
                              ref_time=p.ref_time)
    return dvs_chunk_resident_plain(state, *planes, p, events)


def dvs_rows8_resident_plain(state: ops.PixelState, carrier: torch.Tensor,
                             T: int, p: ops.TranscodeParams,
                             events: bool = True, *,
                             pb: int) -> ChunkResult:
    """Plain version of `dvs_rows8_resident`, the DVS lane group given as
    its 8-byte carrier (`make_dvs_chunk_resident_packed8`,
    `adder_tpu/ops/fused_resident.py:1214`): the carrier decoded
    (`unpack_dvs_carrier8`), scattered into dense planes and run through
    `dvs_chunk_resident_plain`. Returns a new state; the input state is left
    as it was."""
    n = state.length.shape[0]
    planes = build_dvs_planes(
        T, n, *unpack_dvs_carrier8(carrier, pb, p.ref_time),
        ref_time=p.ref_time)
    return dvs_chunk_resident_plain(state, *planes, p, events)


# --- DAVIS lane chunks (K4) -------------------------------------------------


def davis_chunk_resident_plain(state: ops.PixelState, first_int: torch.Tensor,
                               dt_ticks: torch.Tensor, fval: torch.Tensor,
                               fvw: torch.Tensor, p: ops.TranscodeParams,
                               events: bool = True) -> ChunkResult:
    """Plain version of the DAVIS lane chunk
    (`make_davis_chunk_resident_compact`,
    `adder_tpu/ops/fused_resident.py:1361`): T sub-steps of
    `dvs_batch.davis_masked_step`, the literal snapshot-and-restore
    rollback, on the (T, N) planes first_int f32, dt_ticks f32, fval f32
    and `fv8 | active << 8` int32. Events in (sub-step, raster pixel, slot)
    order, the slots of a sub-step in the pixel's chronological order."""

    def step(s, i):
        w = fvw[i]
        active = ((w >> 8) & 1) != 0
        return dvs_batch.davis_masked_step(s, first_int[i], dt_ticks[i],
                                           fval[i], w & 0xFF, active, p)

    return _chunk_plain(state, first_int.shape[0], step, events)


def pack_davis_plan(plan) -> np.ndarray:
    """A DavisCompact (or a lane slice of one) -> the (5, E) int32 carrier
    of `pack_davis_plan` (`adder_tpu/ops/fused_resident.py:1445`), 20 bytes
    per row, so a lane group reaches the card in one host -> device copy:
      row 0: pix | lane << 20 | active << 27
      row 1: fv8
      rows 2-4: the bits of first_int, dt_ticks, fval."""
    E = len(plan.pix)
    if E and (int(plan.pix.max()) >= 1 << 20 or int(plan.lane.max()) >= 128):
        raise ValueError("the carrier holds pixels < 2^20 and lanes < 128")
    packed = np.empty((5, E), np.int32)
    packed[0] = (plan.pix | (plan.lane << 20)
                 | (plan.active.astype(np.int32) << 27))
    packed[1] = plan.fv8
    packed[2] = plan.first_int.view(np.int32)
    packed[3] = plan.dt_ticks.view(np.int32)
    packed[4] = plan.fval.view(np.int32)
    return packed


def unpack_davis_carrier(packed: torch.Tensor):
    """The (5, E) carrier -> the seven row fields of `build_davis_planes`
    (pix, lane, active, first_int, dt_ticks, fval, fv8), with torch bit ops
    on the carrier's device (port of `fused_resident.py:1430-1440`)."""
    meta = packed[0]
    return (
        meta & 0xFFFFF,
        (meta >> 20) & 0x7F,
        ((meta >> 27) & 1) != 0,
        packed[2].view(torch.float32),
        packed[3].view(torch.float32),
        packed[4].view(torch.float32),
        packed[1],
    )


def build_davis_planes(T: int, n: int, pix, lane, active, first_int,
                       dt_ticks, fval, fv8):
    """Scatter compact DAVIS rows into the (T, N) lane planes [first_int,
    dt_ticks, fval, fv8 | active << 8]: lane k goes to row k (port of
    `build_davis_planes`, `adder_tpu/ops/fused_resident.py:1465`). Inactive
    rows go to a discarded slot past the planes."""
    dev = pix.device
    dst = torch.where(active, lane.to(torch.int64) * n + pix.to(torch.int64),
                      T * n)

    def plane(v, dtype):
        z = torch.zeros(T * n + 1, dtype=dtype, device=dev)
        z.index_put_((dst,), v.to(dtype))
        return z[: T * n].view(T, n)

    return (
        plane(first_int, torch.float32),
        plane(dt_ticks, torch.float32),
        plane(fval, torch.float32),
        plane(fv8.to(torch.int32) | (active.to(torch.int32) << 8),
              torch.int32),
    )


def davis_rows_resident_plain(state: ops.PixelState, carrier: torch.Tensor,
                              T: int, p: ops.TranscodeParams,
                              events: bool = True) -> ChunkResult:
    """Plain version of `davis_rows_resident`, the DAVIS lane group of T
    lanes given as its carrier (`make_davis_chunk_resident_packed`,
    `adder_tpu/ops/fused_resident.py:1411`): the carrier unpacked,
    scattered into dense planes and run through `davis_chunk_resident_plain`.
    Returns a new state; the input state is left as it was."""
    n = state.length.shape[0]
    planes = build_davis_planes(T, n, *unpack_davis_carrier(carrier))
    return davis_chunk_resident_plain(state, *planes, p, events)


# --- wrappers ---------------------------------------------------------------


def fused_chunk_resident(state, frames, time, p, run0=None, *,
                         event_cap: int, wide: bool = False) -> ChunkResult:
    """One chunk with its events (and, given the display frame `run0`, the
    display frames after each interval): the plain version for CPU
    tensors; for CUDA tensors the one-pass chunk kernel, the scan of its
    segment counts and the segment copy, with no host read.

    `event_cap` sizes the event buffers on the card (the JAX resident
    engine's `event_cap`): 16 bytes an entry, 8 of staging and 8 of output,
    plus a slab of staging per warp. The result's `total` (0-d int64, on the device) counts the chunk's events
    exactly, whatever the capacity; the first `total` entries of `pixd` and
    `t` are the events when `total <= event_cap`. Past the capacity the
    buffers are incomplete and the caller reruns the chunk with more. The
    plain version's buffers hold exactly the chunk's events.

    `wide`: the wide event layout, which the caller picks (`Video` from
    `wide_layout` of its plane) and which any plane may take: int64 `pixd`;
    on the card the staging stays 8 bytes an event and the copy writes 12.
    Planes of 2^24 pixel-channels and more need it. The wide layout has no
    display output: `run0` must be None there."""
    _check_run0(run0, frames)
    n = frames.shape[-1]
    if wide and run0 is not None:
        raise ValueError(f"the wide event layout ({n} pixel-channels) has no "
                         f"display output")
    if not wide and n >= MAX_PIXELS:
        raise ValueError(f"{n} pixel-channels do not fit the 24-bit pixel "
                         f"field of the narrow event layout")
    if not frames.is_cuda:
        return fused_chunk_resident_plain(state, frames, time, p, run0, wide)
    return _chunk_cuda(state, frames, time, p, True, run0, event_cap, wide)


def group_chunk_resident(state, frames, time, p, run0=None) -> ChunkResult:
    """One chunk without events (Empty sink), with the display frames when
    given `run0`: the plain version for CPU tensors, the chunk kernel
    without its staging for CUDA tensors."""
    _check_run0(run0, frames)
    if not frames.is_cuda:
        return group_chunk_resident_plain(state, frames, time, p, run0)
    return _chunk_cuda(state, frames, time, p, False, run0)


def dvs_rows_resident(state, carrier, T: int, p, events: bool = True,
                      groups: Optional[RowGroups] = None, *,
                      event_cap: Optional[int] = None) -> ChunkResult:
    """One DVS lane group of T = 2 x lanes sub-steps given as its (5, E)
    int32 carrier (`pack_dvs_plan`): the events in (sub-step, raster pixel,
    slot) order, the per-sub-step counts and the flags of
    `dvs_chunk_resident_plain` on the planes `build_dvs_planes` makes of
    that carrier. For a CUDA carrier the grouping (`groups` where the
    caller knows it, as `raster_row_groups` for one row per pixel in raster
    order; else `group_dvs_rows`), then the K3 row kernel
    `adder_dvs_rows` once: with `events` it stages each cell's events, and
    the scan of the cell counts and `rows_copy` put them in order; without,
    it counts them; for a CPU carrier `dvs_rows_resident_plain`, which needs
    no grouping.

    The state is updated in place, on the card and on the CPU alike: only
    the pixels that have rows change, so no copy of the other pixels is
    made, and the result's `state` is the caller's `state`. A caller that
    still needs the old state clones it first (`clone_state`).

    `event_cap`, where given, is a bound on the group's events that the
    caller knows without the card (at most DVS_DEPTH + 3 for each active
    cell): on the card the event buffers get that many entries, the copy
    follows the walk with no host read, and the result's `total` (0-d, on
    the card) says how many of them are the events (an event past the
    capacity is not written). Without it the wrapper reads the total back
    and the buffers hold the events exactly."""
    if not carrier.is_cuda:
        return _in_place(state, dvs_rows_resident_plain(state, carrier, T, p,
                                                        events))
    return _rows_cuda(SRC_DVS, state, carrier, T, p, events, groups,
                      event_cap=event_cap)


def dvs_rows8_resident(state, carrier, T: int, p, events: bool = True,
                       groups: Optional[RowGroups] = None, *, pb: int,
                       event_cap: Optional[int] = None) -> ChunkResult:
    """`dvs_rows_resident` for a lane group given as the (2, E + DICT_CAP)
    int32 carrier of `pack_dvs_plan8` (or of the fused native planner),
    whose pixel field has `pb` bits (`pix_bits` of the plane): for a CUDA
    carrier `group_dvs_rows` on the 8-byte keys, then the K3 row
    kernel `adder_dvs_rows8`, which decodes each row's two words and the
    dictionary as `unpack_dvs_carrier8` does; for a CPU carrier
    `dvs_rows8_resident_plain`. The same events, counts, flags and state
    as `dvs_rows_resident` on the 20-byte carrier of the same rows; the
    state updated in place, `event_cap` as there."""
    if not carrier.is_cuda:
        return _in_place(state, dvs_rows8_resident_plain(
            state, carrier, T, p, events, pb=pb))
    return _rows_cuda(SRC_DVS8, state, carrier, T, p, events, groups, pb=pb,
                      event_cap=event_cap)


def davis_rows_resident(state, carrier, T: int, p,
                        events: bool = True) -> ChunkResult:
    """One DAVIS lane group of T lanes (one sub-step each) given as its
    (5, E) int32 carrier (`pack_davis_plan`): the events in (sub-step,
    raster pixel, slot) order, the per-sub-step counts and the flags of
    `davis_chunk_resident_plain` on the planes `build_davis_planes` makes of
    that carrier. For a CUDA carrier `group_dvs_rows` with one
    sub-step per lane, then the K4 row kernel `adder_davis_rows` once, its
    events staged and copied as in `dvs_rows_resident` when `events`; for a
    CPU carrier `davis_rows_resident_plain`. The state is updated in place, as
    `dvs_rows_resident` does: only the pixels that have active rows change,
    and the result's `state` is the caller's `state`."""
    if not carrier.is_cuda:
        return _in_place(state, davis_rows_resident_plain(state, carrier, T,
                                                          p, events))
    return _rows_cuda(SRC_DAVIS, state, carrier, T, p, events)


def _in_place(state: ops.PixelState, res: ChunkResult) -> ChunkResult:
    """`res` with the caller's `state`, its fields overwritten by res's."""
    for f in _KERNEL_FIELDS:
        getattr(state, f).copy_(getattr(res.state, f))
    return res._replace(state=state)


def clone_state(state: ops.PixelState) -> ops.PixelState:
    """A copy of every per-pixel field, for a caller that keeps the old
    state across a chunk that updates it in place."""
    return ops.PixelState(*(getattr(state, f).clone()
                            for f in _KERNEL_FIELDS),
                          overflow=state.overflow)


class _ChunkArgs(ctypes.Structure):
    """Mirror of `struct AdderChunkArgs` in csrc/adder_interval.cuh."""

    _fields_ = [
        ("events", ctypes.c_int),
        ("mode", ctypes.c_int),
        ("multi_mode", ctypes.c_int),
        ("abs_time", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("T", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("time", ctypes.c_float),
        ("ref_time", ctypes.c_int),
        ("delta_t_max", ctypes.c_int),
        ("c_thresh_max", ctypes.c_int),
        ("vel_m1", ctypes.c_int),
        ("c_inc", ctypes.c_int),
        ("frames", ctypes.c_void_p),
        ("state_in", ctypes.c_void_p * 14),
        ("state_out", ctypes.c_void_p * 14),
        ("seg_counts", ctypes.c_void_p),
        ("seg_start", ctypes.c_void_p),
        ("link", ctypes.c_void_p),
        ("stage", ctypes.c_void_p),
        ("pool", ctypes.c_longlong),
        ("cursor", ctypes.c_void_p),
        ("flags", ctypes.c_void_p),
        ("view_mode", ctypes.c_int),
        ("pdm", ctypes.c_float),
        ("run0", ctypes.c_void_p),
        ("runnings", ctypes.c_void_p),
        ("wide", ctypes.c_int),
    ]


class _CopyArgs(ctypes.Structure):
    """Mirror of `struct AdderCopyArgs` in csrc/fused_resident.cu."""

    _fields_ = [
        ("segments", ctypes.c_longlong),
        ("cap", ctypes.c_longlong),
        ("slab", ctypes.c_int),
        ("counts", ctypes.c_void_p),
        ("offsets", ctypes.c_void_p),
        ("seg_start", ctypes.c_void_p),
        ("link", ctypes.c_void_p),
        ("stage", ctypes.c_void_p),
        ("flags", ctypes.c_void_p),
        ("out_pixd", ctypes.c_void_p),
        ("out_t", ctypes.c_void_p),
        ("wide", ctypes.c_int),
        ("n_warps", ctypes.c_longlong),
    ]


# the per-pixel state fields the kernel reads and writes, in the order of
# AdderChunkArgs.state_in / state_out (overflow is passed through)
_KERNEL_FIELDS = ops.PixelState._fields[:-1]


def _check_plane(x: torch.Tensor, dtype, what: str,
                 limit: int = MAX_PIXELS) -> None:
    """A (T, N) plane of `dtype`, contiguous, T in 1..MAX_T and N below
    `limit` (the 24-bit pixel field unless the caller takes wider)."""
    if x.dtype != dtype or x.dim() != 2:
        raise ValueError(f"{what} must be (T, N) {dtype}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    T, n = x.shape
    if not 1 <= T <= MAX_T:
        raise ValueError(f"chunk of {T} intervals; the kernel takes 1..{MAX_T}")
    if n >= limit:
        field = ("24-bit pixel field" if limit == MAX_PIXELS
                 else f"pixel field of the wide event layout (below {limit})")
        raise ValueError(f"{n} pixel-channels do not fit the {field}")


def _check_run0(run0: Optional[torch.Tensor], frames: torch.Tensor) -> None:
    """A display frame, where one is given, is (N,) u8, contiguous, on the
    frames' device."""
    if run0 is None:
        return
    n = frames.shape[-1]
    if run0.dtype != torch.uint8 or tuple(run0.shape) != (n,):
        raise ValueError(f"run0 must be ({n},) uint8, got {run0.dtype} "
                         f"{tuple(run0.shape)}")
    if run0.device != frames.device or not run0.is_contiguous():
        raise ValueError(f"run0 must be contiguous on {frames.device}")


def _check_state(state: ops.PixelState, like: torch.Tensor, depths,
                 n: Optional[int] = None) -> None:
    n = like.shape[1] if n is None else n
    depth = state.node_d.shape[0]
    if depth not in depths:
        raise ValueError(f"arena depth {depth}; the kernel is built for "
                         f"{depths}")
    for name in _KERNEL_FIELDS:
        x, dt = getattr(state, name), ops.STATE_DTYPES[name]
        shape = (depth, n) if name in ops.ARENA_FIELDS else (n,)
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"state.{name}: want {dt} {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != like.device or not x.is_contiguous():
            raise ValueError(f"state.{name} must be contiguous on {like.device}")


def slab_entries(depth: int) -> int:
    """The chunk kernel's staging slab: the most events one warp emits in
    one interval, 32 lanes x (depth + 3) slots (`chunk_slab` in
    csrc/adder_interval.cuh)."""
    return 32 * (depth + 3)


def _launch(entry: str, args: ctypes.Structure, dev,
            wide: bool = False) -> None:
    """One launch of a C entry point taking an argument block; adds one to
    its LAUNCHES entry (the `_wide` one for the wide layout's kernel)."""
    fn = getattr(cuda_build.load(), entry)
    err = fn(ctypes.addressof(args), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{cuda_build.error_string(err)}")
    LAUNCHES[entry + "_wide" if wide else entry] += 1


def staging_pool(event_cap: int, n: int, depth: int) -> int:
    """The chunk kernel's staging entries for a capacity of `event_cap`
    events over n pixel-channels: the capacity in whole slabs plus one slab
    per warp (a Python int; at 4K colour it passes 2^31)."""
    slab = slab_entries(depth)
    return (-(-event_cap // slab) + -(-n // 32)) * slab


def _chunk_cuda(state, frames, time, p, events: bool, run0=None,
                event_cap: int = 0, wide: bool = False) -> ChunkResult:
    """`adder_resident_chunk` once: the state machine over the chunk, the
    per-(interval, warp) counts and, with `events`, the staged events; then
    for the events the scan of the counts and `adder_segment_copy` (`wide`:
    both in the wide layout). Planes of 2^24 pixel-channels and more take
    the wide layout, or no events (the Empty sink's counts)."""
    _check_plane(frames, torch.uint8, "frames",
                 MAX_PIXELS if events and not wide else MAX_WIDE_PIXELS)
    _check_state(state, frames, (6, 8))
    T, n = frames.shape
    dev = frames.device
    depth = state.node_d.shape[0]
    if event_cap < 0:
        raise ValueError(f"event_cap {event_cap} is negative")
    time = float(np.float32(time))
    out_state = ops.PixelState(
        *(torch.empty_like(getattr(state, f)) for f in _KERNEL_FIELDS),
        overflow=state.overflow,
    )
    a = _ChunkArgs()
    a.events = int(events)
    a.mode, a.multi_mode = int(p.mode), int(p.multi_mode)
    a.abs_time = int(p.time_mode == int(TimeMode.AbsoluteT))
    a.depth, a.T, a.n = depth, T, n
    a.ref_time, a.delta_t_max = p.ref_time, p.delta_t_max
    a.c_thresh_max = p.c_thresh_max
    for i, f in enumerate(_KERNEL_FIELDS):
        a.state_in[i] = getattr(state, f).data_ptr()
        a.state_out[i] = getattr(out_state, f).data_ptr()
    a.time = time
    a.vel_m1, a.c_inc = ops.c_thresh_scalars(time, p)
    a.frames = frames.data_ptr()
    runnings = None
    if run0 is not None:
        runnings = torch.empty((T, n), dtype=torch.uint8, device=dev)
        a.view_mode, a.pdm = p.view_mode, ops.display_pdm(p)
        a.run0, a.runnings = run0.data_ptr(), runnings.data_ptr()
    n_warps = -(-n // 32)
    seg_counts = torch.empty((T, n_warps), dtype=torch.int32, device=dev)
    # [0]: flags (max count, depth overflow, staging overflow) as i32;
    # [2]: the staging cursor
    ctl = torch.zeros(3, dtype=torch.int64, device=dev)
    flags = ctl[:2].view(torch.int32)
    a.seg_counts, a.flags = seg_counts.data_ptr(), flags.data_ptr()
    a.wide = int(wide)
    if not events:
        _launch("adder_resident_chunk", a, dev)
        per_interval = seg_counts.sum(dim=1, dtype=torch.int64)
        return ChunkResult(out_state, None, None, per_interval, _pmax(flags),
                           runnings, per_interval.sum())
    slab = slab_entries(depth)
    pool = staging_pool(event_cap, n, depth)
    seg_start = torch.empty((T, n_warps), dtype=torch.int64, device=dev)
    link = torch.empty(pool // slab, dtype=torch.int32, device=dev)
    stage = torch.empty(pool, dtype=torch.int64, device=dev)
    a.seg_start, a.link = seg_start.data_ptr(), link.data_ptr()
    a.stage, a.pool, a.cursor = stage.data_ptr(), pool, ctl[2:].data_ptr()
    _launch("adder_resident_chunk", a, dev, wide)
    offsets = exclusive_scan(seg_counts)
    pixd, t = segment_copy(stage, seg_start, seg_counts, offsets, link, slab,
                           event_cap, flags, wide=wide)
    per_interval = offsets[::n_warps].diff()
    return ChunkResult(out_state, pixd, t, per_interval, _pmax(flags),
                       runnings, offsets[-1])


def _pmax(flags: torch.Tensor) -> torch.Tensor:
    return flags[0].to(torch.int64) | (flags[1].to(torch.int64) << 16)


def segment_copy(stage, seg_start, counts, offsets, link, slab: int,
                 cap: int, flags, *, wide: bool = False):
    """The staged events of a chunk to their offsets, in reference order:
    (cap,) int32 `pixd` and `t` whose first min(total, cap) entries are the
    events (nothing is written after a staging overflow, flags[2]). The
    plain version for CPU tensors, `adder_segment_copy` for CUDA tensors.
    `wide`: the wide layout, whose staged low word is lane << 8 | d (the
    event's lane in its warp; the segment (t, w) names warp w), and whose
    `pixd` comes out int64 pix << 8 | d, pix = 32 w + lane.

    stage      (pool,) int64: pix << 8 | d in the low 32 bits, t above;
    seg_start  (T, W) int64: the entry of each non-empty segment's first
               event; a segment that outgrows its slab goes on at the start
               of slab link[seg_start // slab];
    counts     (T, W) int32 events per (interval, warp) segment;
    offsets    (T W + 1,) int64 their exclusive scan, the total last."""
    if not stage.is_cuda:
        return segment_copy_plain(stage, seg_start, counts, offsets, link,
                                  slab, cap, flags, wide=wide)
    dev = stage.device
    segments = counts.numel()
    for name, x, dtype, numel in (
            ("stage", stage, torch.int64, stage.numel()),
            ("seg_start", seg_start, torch.int64, segments),
            ("counts", counts, torch.int32, segments),
            ("offsets", offsets, torch.int64, segments + 1),
            ("link", link, torch.int32, stage.numel() // max(slab, 1)),
            ("flags", flags, torch.int32, 3)):
        if (x.dtype != dtype or x.numel() < numel or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} of "
                             f"{numel} entries on {dev}")
    if slab < 1 or stage.numel() % slab or cap < 0 or segments < 1:
        raise ValueError(f"slab {slab}, pool {stage.numel()}, capacity {cap}"
                         f", {segments} segments")
    if wide and counts.dim() != 2:
        raise ValueError("the wide layout's counts must be (T, W)")
    pixd = torch.empty(max(cap, 1),
                       dtype=torch.int64 if wide else torch.int32, device=dev)
    t = torch.empty(max(cap, 1), dtype=torch.int32, device=dev)
    c = _CopyArgs()
    c.segments, c.cap, c.slab = counts.numel(), cap, slab
    c.wide, c.n_warps = int(wide), counts.shape[-1]
    c.counts, c.offsets = counts.data_ptr(), offsets.data_ptr()
    c.seg_start, c.link = seg_start.data_ptr(), link.data_ptr()
    c.stage, c.flags = stage.data_ptr(), flags.data_ptr()
    c.out_pixd, c.out_t = pixd.data_ptr(), t.data_ptr()
    _launch("adder_segment_copy", c, dev, wide)
    return pixd[:cap], t[:cap]


def segment_copy_plain(stage, seg_start, counts, offsets, link, slab: int,
                       cap: int, flags, *, wide: bool = False):
    """Plain version of `segment_copy`, with torch ops on the inputs'
    device: each output entry finds its segment by a search of the offsets
    and reads its staging entry."""
    dev = stage.device
    pixd = torch.zeros(cap, dtype=torch.int64 if wide else torch.int32,
                       device=dev)
    t = torch.zeros(cap, dtype=torch.int32, device=dev)
    n = min(int(offsets[-1]), cap)
    if n == 0 or int(flags[2]):
        return pixd, t
    o = torch.arange(n, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(offsets, o, right=True) - 1
    i = o - offsets[seg]
    start = seg_start.reshape(-1)[seg]
    c = counts.reshape(-1)[seg].to(torch.int64)
    first = torch.minimum(c, slab - start % slab)
    nxt = link[start // slab].to(torch.int64)
    at = torch.where(i < first, start + i, nxt * slab + (i - first))
    words = stage[at].view(torch.int32).view(-1, 2)
    pixd[:n], t[:n] = words[:, 0], words[:, 1]
    if wide:  # lane << 8 | d, and the segment's warp
        warp = seg % counts.shape[-1]
        pixd[:n] = (warp << 13) + (pixd[:n] & 0xFFFFFFFF)
    return pixd, t


class _RowsArgs(ctypes.Structure):
    """Mirror of `struct AdderRowsArgs` in csrc/adder_interval.cuh."""

    _fields_ = [
        ("events", ctypes.c_int),
        ("multi_mode", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("src", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("rows", ctypes.c_longlong),
        ("ref_time", ctypes.c_int),
        ("delta_t_max", ctypes.c_int),
        ("c_thresh_max", ctypes.c_int),
        ("vel_m1", ctypes.c_int),
        ("state", ctypes.c_void_p * 14),
        ("carrier", ctypes.c_void_p),
        ("order", ctypes.c_void_p),
        ("row_start", ctypes.c_void_p),
        ("n_active", ctypes.c_void_p),
        ("cell_gap", ctypes.c_void_p),
        ("cell_tick", ctypes.c_void_p),
        ("cell_counts", ctypes.c_void_p),
        ("stage", ctypes.c_void_p),
        ("flags", ctypes.c_void_p),
        ("pb", ctypes.c_int),
    ]


class _RowsCopyArgs(ctypes.Structure):
    """Mirror of `struct AdderRowsCopyArgs` in csrc/dvs_resident.cu."""

    _fields_ = [
        ("cells", ctypes.c_longlong),
        ("cap", ctypes.c_longlong),
        ("counts", ctypes.c_void_p),
        ("offsets", ctypes.c_void_p),
        ("stage", ctypes.c_void_p),
        ("out_pixd", ctypes.c_void_p),
        ("out_t", ctypes.c_void_p),
    ]


# each row source: its C entry point, its sub-steps per lane and the rows of
# its carrier
_ROW_ENTRIES = {SRC_DVS: ("adder_dvs_rows", 2, 5),
                SRC_DAVIS: ("adder_davis_rows", 1, 5),
                SRC_DVS8: ("adder_dvs_rows8", 2, 2)}


class RowWalk(NamedTuple):
    """What one launch of a row kernel leaves on the card: per cell (a
    pixel's sub-step, in (sub-step, raster pixel) order) its event count,
    and with the events its staged events, slot-major (cell c's k-th event
    at k C + c); the flags; the grouping."""

    cell_counts: torch.Tensor  # (C,) int32
    stage: Optional[torch.Tensor]  # (ROW_SLOTS x C,) int64, or None
    flags: torch.Tensor  # (2,) int32: max per-cell count, depth overflow
    groups: RowGroups


def _rows_cuda(src: int, state, carrier, T: int, p, events: bool,
               groups: Optional[RowGroups] = None, pb: Optional[int] = None,
               event_cap: Optional[int] = None) -> ChunkResult:
    """`dvs_rows_resident` (src SRC_DVS), `dvs_rows8_resident` (SRC_DVS8,
    with `pb`) or `davis_rows_resident` (SRC_DAVIS) for a CUDA carrier: the
    walk (`rows_walk`), the scan of its cell counts and, with the events,
    `rows_copy`. `groups`: the grouping made beforehand (for the raster
    chunks and the timings); `event_cap`: the caller's bound on the events,
    which spares the host read of the total."""
    if event_cap is not None and event_cap < 0:
        raise ValueError(f"event_cap {event_cap} is negative")
    walk = rows_walk(src, state, carrier, T, p, events, groups, pb)
    dev = carrier.device
    if walk is None:  # no row, nothing to launch: the state stays as it is
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        ev = torch.empty(0, dtype=torch.int32, device=dev) if events else None
        return ChunkResult(state, ev, ev, zero.expand(T).clone(), zero,
                           total=zero)
    offsets = exclusive_scan(walk.cell_counts)
    pixd = t = None
    if events:
        # the caller's bound, or a host read of the total
        cap = int(offsets[-1]) if event_cap is None else event_cap
        pixd, t = rows_copy(walk.stage, walk.cell_counts, offsets, cap)
    # the cells of one sub-step are contiguous: a segment sum of the counts
    at = offsets[walk.groups.sub_start]
    per_interval = at[1:] - at[:-1]
    return ChunkResult(state, pixd, t, per_interval, _pmax(walk.flags),
                       total=offsets[-1])


def rows_walk(src: int, state, carrier, T: int, p, events: bool,
              groups: Optional[RowGroups] = None,
              pb: Optional[int] = None) -> Optional[RowWalk]:
    """One launch of the row kernel of `src` on a CUDA carrier (the grouping
    made first unless `groups` is given): the state of the pixels that have
    rows updated in place, each cell's event count and, with `events`, its
    events staged in its ROW_SLOTS slots. None for a carrier of no rows
    (nothing is launched)."""
    entry, per_lane, height = _ROW_ENTRIES[src]
    width = "E + 64" if src == SRC_DVS8 else "E"
    if (carrier.dtype != torch.int32 or carrier.dim() != 2
            or carrier.shape[0] != height or not carrier.is_contiguous()):
        raise ValueError(f"carrier must be contiguous ({height}, {width}) "
                         f"int32, got {carrier.dtype} "
                         f"{tuple(carrier.shape)}")
    if T % per_lane or not per_lane <= T <= MAX_T:
        raise ValueError(f"group of {T} sub-steps; {entry} takes "
                         f"{per_lane} x lanes in {per_lane}..{MAX_T}")
    if p.mode != int(Mode.Continuous) or p.time_mode != int(TimeMode.AbsoluteT):
        raise ValueError("the lane kernels are built for Continuous, AbsoluteT")
    n, E, dev = state.length.shape[0], carrier.shape[1], carrier.device
    if n > 1 << 20:
        raise ValueError(f"{n} pixels: the carrier holds pixels below 2^20")
    if src == SRC_DVS8:
        E -= DICT_CAP
        if E < 0 or pb != pix_bits(n):
            raise ValueError(f"an 8-byte carrier of a {n}-pixel plane has "
                             f"a {pix_bits(n)}-bit pixel field and at least "
                             f"{DICT_CAP} columns; got pb {pb}, "
                             f"{carrier.shape[1]} columns")
    _check_state(state, carrier, (DVS_DEPTH,), n)
    if E == 0:
        return None
    if groups is None:
        g = group_dvs_rows(carrier, T, per_lane,
                           pb if src == SRC_DVS8 else None, n=n)
    else:
        g = groups
        shapes = ((E,), (E + 2,), (1,), (E,), (E if per_lane == 2 else 0,),
                  (T + 1,))
        for f, x, shape in zip(RowGroups._fields, g, shapes):
            if (x.dtype != torch.int64 or tuple(x.shape) != shape
                    or x.device != dev or not x.is_contiguous()):
                raise ValueError(f"groups.{f}: want contiguous int64 {shape} "
                                 f"on {dev}, got {x.dtype} {tuple(x.shape)}")
    cells = per_lane * E
    cell_counts = torch.empty(cells, dtype=torch.int32, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)  # atomic max / or
    stage = (torch.empty(cells * ROW_SLOTS, dtype=torch.int64, device=dev)
             if events else None)
    a = _RowsArgs()
    a.events = int(events)
    a.multi_mode, a.depth, a.src = int(p.multi_mode), DVS_DEPTH, src
    a.n, a.rows, a.pb = n, E, pb or 0
    a.ref_time, a.delta_t_max = p.ref_time, p.delta_t_max
    a.c_thresh_max = p.c_thresh_max
    a.vel_m1, _ = ops.c_thresh_scalars(0.0, p)
    for i, f in enumerate(_KERNEL_FIELDS):
        a.state[i] = getattr(state, f).data_ptr()
    a.carrier = carrier.data_ptr()
    a.order, a.row_start = g.order.data_ptr(), g.row_start.data_ptr()
    a.n_active = g.n_active.data_ptr()
    a.cell_gap = g.cell_gap.data_ptr()
    a.cell_tick = g.cell_tick.data_ptr() if per_lane == 2 else None
    a.cell_counts, a.flags = cell_counts.data_ptr(), flags.data_ptr()
    a.stage = stage.data_ptr() if events else None
    _launch(entry, a, dev)
    return RowWalk(cell_counts, stage, flags, g)


def rows_copy(stage, counts, offsets, cap: int):
    """The staged events of a row walk to their offsets, in (sub-step,
    raster pixel, slot) order: (cap,) int32 `pixd` and `t` whose first
    min(total, cap) entries are the events. The plain version for CPU
    tensors, `adder_rows_copy` for CUDA tensors.

    stage    (ROW_SLOTS x C,) int64, slot-major: cell c's k-th event
             (k < counts[c]) in entry k C + c, pix << 8 | d in the low 32
             bits, t above;
    counts   (C,) int32 events per cell;
    offsets  (C + 1,) int64 their exclusive scan, the total last."""
    if not stage.is_cuda:
        return rows_copy_plain(stage, counts, offsets, cap)
    dev = stage.device
    cells = counts.numel()
    for name, x, dtype, numel in (
            ("stage", stage, torch.int64, cells * ROW_SLOTS),
            ("counts", counts, torch.int32, cells),
            ("offsets", offsets, torch.int64, cells + 1)):
        if (x.dtype != dtype or x.numel() != numel or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} of "
                             f"{numel} entries on {dev}")
    if cap < 0 or cells < 1:
        raise ValueError(f"capacity {cap}, {cells} cells")
    pixd = torch.empty(max(cap, 1), dtype=torch.int32, device=dev)
    t = torch.empty(max(cap, 1), dtype=torch.int32, device=dev)
    c = _RowsCopyArgs()
    c.cells, c.cap = cells, cap
    c.counts, c.offsets = counts.data_ptr(), offsets.data_ptr()
    c.stage = stage.data_ptr()
    c.out_pixd, c.out_t = pixd.data_ptr(), t.data_ptr()
    _launch("adder_rows_copy", c, dev)
    return pixd[:cap], t[:cap]


def rows_copy_plain(stage, counts, offsets, cap: int):
    """Plain version of `rows_copy`, with torch ops on the inputs' device:
    each output entry finds its cell by a search of the offsets and reads
    that cell's slot."""
    dev = stage.device
    pixd = torch.zeros(cap, dtype=torch.int32, device=dev)
    t = torch.zeros(cap, dtype=torch.int32, device=dev)
    n = min(int(offsets[-1]), cap)
    if n == 0:
        return pixd, t
    o = torch.arange(n, dtype=torch.int64, device=dev)
    cell = torch.searchsorted(offsets, o, right=True) - 1
    words = stage[(o - offsets[cell]) * counts.numel() + cell]
    words = words.view(torch.int32).view(-1, 2)
    pixd[:n], t[:n] = words[:, 0], words[:, 1]
    return pixd, t


# Counts per block of `adder_exclusive_scan`, as the kernel is built.
SCAN_TILE = 2048


def exclusive_scan(counts: torch.Tensor) -> torch.Tensor:
    """`adder_exclusive_scan` on a CUDA int32 tensor (plain version on the
    CPU): exclusive int64 prefix sums of the flattened counts, total last.
    One launch of ceil(count / SCAN_TILE) blocks; the look-back words and the
    block ticket it needs are zeroed here, once per call."""
    if not counts.is_cuda:
        return exclusive_scan_plain(counts)
    if counts.dtype != torch.int32 or not counts.is_contiguous():
        raise ValueError("counts must be contiguous int32")
    lib = cuda_build.load()
    count, dev = counts.numel(), counts.device
    out = torch.empty(count + 1, dtype=torch.int64, device=dev)
    scratch = torch.zeros(max(-(-count // SCAN_TILE), 1) + 1, dtype=torch.int64,
                          device=dev)
    err = lib.adder_exclusive_scan(
        counts.data_ptr(), out.data_ptr(), count, scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"adder_exclusive_scan launch failed: "
                           f"{cuda_build.error_string(err)}")
    LAUNCHES["adder_exclusive_scan"] += 1
    return out


def wire_pack(pixd: torch.Tensor, t: torch.Tensor, width: int,
              channels: int) -> torch.Tensor:
    """A chunk's events (`pixd` = pix << 8 | d and `t`, int32 holding u32
    patterns, one entry an event; in the wide layout `pixd` int64) as the
    `.adder` raw records that `codec/raw.py::encode_events` writes for
    them, on their device: (n x 9,) uint8 for a mono plane, (n x 11,) for
    colour. The plain version for CPU tensors, `adder_wire_pack` for CUDA
    tensors (no launch for n = 0). The pixel index is held below 2^32."""
    if pixd.dtype not in (torch.int32, torch.int64) or (
            t.dtype != torch.int32 or pixd.dim() != 1
            or pixd.shape != t.shape):
        raise ValueError(f"pixd (n,) int32 or int64 and t (n,) int32, got "
                         f"{pixd.dtype} {tuple(pixd.shape)}, {t.dtype} "
                         f"{tuple(t.shape)}")
    if width < 1 or channels < 1:
        raise ValueError(f"plane width {width}, {channels} channels")
    if not pixd.is_cuda:
        return wire_pack_plain(pixd, t, width, channels)
    dev = pixd.device
    if t.device != dev or not (pixd.is_contiguous() and t.is_contiguous()):
        raise ValueError(f"pixd and t must be contiguous on {dev}")
    n = pixd.numel()
    # 9 or 11 bytes a record (codec/header.py::event_size_for_plane)
    out = torch.empty(n * (9 if channels == 1 else 11), dtype=torch.uint8,
                      device=dev)
    if n == 0:
        return out
    err = cuda_build.load().adder_wire_pack(
        pixd.data_ptr(), t.data_ptr(), out.data_ptr(), n, width, channels,
        int(pixd.dtype == torch.int64),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"adder_wire_pack launch failed: "
                           f"{cuda_build.error_string(err)}")
    LAUNCHES["adder_wire_pack_wide" if pixd.dtype == torch.int64
             else "adder_wire_pack"] += 1
    return out


def wire_pack_plain(pixd: torch.Tensor, t: torch.Tensor, width: int,
                    channels: int) -> torch.Tensor:
    """Plain version of `wire_pack`, with torch ops on the inputs' device:
    each field's big-endian bytes as a column of an (n, record) table."""
    pd = pixd.to(torch.int64)
    if pixd.dtype == torch.int32:  # the u32 pattern
        pd = pd & 0xFFFFFFFF
    tt = t.to(torch.int64) & 0xFFFFFFFF
    pix, d = pd >> 8, pd & 0xFF
    xy = pix // channels
    x, y = xy % width, xy // width
    cols = [x >> 8, x, y >> 8, y]
    if channels > 1:
        cols += [torch.ones_like(pix), pix % channels]
    cols += [d, tt >> 24, tt >> 16, tt >> 8, tt]
    return (torch.stack(cols, dim=1) & 0xFF).to(torch.uint8).reshape(-1)
