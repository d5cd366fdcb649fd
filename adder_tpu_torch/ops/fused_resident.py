"""One transcode chunk: T intervals over the whole plane, events in reference order.

Counterpart of `adder_tpu/ops/fused_resident.py` in its two framed modes,
`make_fused_chunk_resident` (events fetched) and `make_group_chunk_resident`
(the Empty sink, where only counts and the depth flag are read), in its
DVS mode, `make_dvs_chunk_resident` (lane sub-steps with per-pixel
intensity, ticks spanned and an active flag, at depth 16), and in its DAVIS
mode, `make_davis_chunk_resident_compact` (one DAVIS event per pixel and
sub-step, from four planes, at depth 16).

Each entry point has two implementations:

- the plain PyTorch version (`fused_chunk_resident_plain`,
  `group_chunk_resident_plain`, `dvs_chunk_resident_plain`,
  `davis_chunk_resident_plain`): a Python loop over the T intervals of
  `integrate._interval_core` (for DVS, `dvs_batch.masked_step`; for DAVIS,
  `dvs_batch.davis_masked_step`), then the per-interval slots compacted
  into the reference's single-thread order (interval, raster pixel, slot);
- the hand-written Hopper kernels of `csrc/` (`adder_resident_chunk` and
  `adder_exclusive_scan` in fused_resident.cu, `adder_dvs_chunk` and
  `adder_dvs_rows` in dvs_resident.cu, `adder_davis_chunk` in
  davis_resident.cu), reached through the wrappers `fused_chunk_resident`,
  `group_chunk_resident`, `dvs_chunk_resident`, `dvs_rows_resident` and
  `davis_chunk_resident`.

A wrapper runs the plain version for CPU tensors and launches the kernels
for CUDA tensors; a failed launch raises, there is no fallback.

The DVS mode has two routes to the same function. `dvs_chunk_resident`
takes dense (T, N) planes and walks every pixel through every sub-step: it
serves the chunks that are dense by nature (the bootstrap, the end-of-stream
flush, DAVIS's frame and gap chunks). `dvs_rows_resident` takes the (5, E)
carrier itself, the input of `make_dvs_chunk_resident_packed`, and walks
each pixel's own rows: it serves the sparse lane groups, builds no plane,
and updates the state of the pixels that have rows in place.

The events come back already in reference order, so the JAX package's
capacity and pack reruns and its host assembler have no counterpart here.
The fetched path costs one host read per chunk: the scan's total, between
the COUNT and WRITE passes, sizes the event buffers.

Outputs (`ChunkResult`):
  state        the PixelState after the chunk (`overflow` passed through
               unchanged, as the resident kernel does);
  pixd, t      (E,) int32 holding u32 bit patterns: `pix << 8 | d` and the
               event time (None on the Empty-sink path);
  per_interval (T,) int64 event counts;
  pmax         0-d int64: bits 0-15 the largest per-(interval, pixel) event
               count, bit 16 arena-depth overflow (`fused_resident.py:409-413`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.types import Mode, TimeMode

from . import cuda_build, dvs_batch
from . import integrate as ops

BLOCK = 256  # threads (pixels) per CUDA block; must match kBlock in the .cu
MAX_T = 128  # intervals per chunk (the kernel's shared count array)
MAX_PIXELS = 1 << 24  # pix << 8 | d keeps 24 bits of pixel index

PASS_COUNT, PASS_WRITE, PASS_VOID = 0, 1, 2
DVS_DEPTH = 16  # the arena depth of the DVS and DAVIS paths (K3, K4)
SRC_FRAMED, SRC_DVS, SRC_DAVIS = 0, 1, 2  # AdderChunkArgs.dvs

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"adder_resident_chunk": 0, "adder_exclusive_scan": 0,
            "adder_dvs_chunk": 0, "adder_dvs_rows": 0, "adder_rows_group": 0,
            "adder_davis_chunk": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ChunkResult(NamedTuple):
    state: ops.PixelState
    pixd: Optional[torch.Tensor]
    t: Optional[torch.Tensor]
    per_interval: torch.Tensor
    pmax: torch.Tensor


# --- plain PyTorch versions -------------------------------------------------


def _chunk_plain(state: ops.PixelState, T: int, step,
                 events: bool) -> ChunkResult:
    """The loop every plain chunk shares: `step(s, i)` runs sub-step i on
    the unstacked state `s` and returns its K slots; the slots are
    compacted in (sub-step, raster pixel, slot) order."""
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
            pixd_parts.append(((pix << 8) | (d & 0xFF))[m].to(torch.int32))
            t_parts.append(tt[m].to(torch.int32))
    new_state = s.restack()._replace(overflow=state.overflow)
    pmax = max_cnt | ((s.overflow > 0).to(torch.int64) << 16)
    per_interval = torch.stack(counts).to(torch.int64)
    if not events:
        return ChunkResult(new_state, None, None, per_interval, pmax)
    return ChunkResult(
        new_state, torch.cat(pixd_parts), torch.cat(t_parts), per_interval,
        pmax,
    )


def _framed_plain(state, frames, time, p, events: bool) -> ChunkResult:
    time = float(np.float32(time))

    def step(s, i):
        fv = frames[i].to(torch.int32)
        return ops._interval_core(s, fv.to(torch.float32), fv, time, p)

    return _chunk_plain(state, frames.shape[0], step, events)


def fused_chunk_resident_plain(state, frames, time, p) -> ChunkResult:
    """Plain version of the fetched-events chunk: state after T intervals
    and the chunk's events in reference order."""
    return _framed_plain(state, frames, time, p, events=True)


def group_chunk_resident_plain(state, frames, time, p) -> ChunkResult:
    """Plain version of the Empty-sink chunk: state, counts and flags only."""
    return _framed_plain(state, frames, time, p, events=False)


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


# --- DVS lane groups by rows (K3, the sparse route) --------------------------


class RowGroups(NamedTuple):
    """A carrier's rows grouped for the row walk; every array int64 on the
    carrier's device, made without a host read.

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
               those of sub-step 2 k + 1 their tick halves;
    sub_start  (T + 1,) the first cell of each sub-step, then 2 E."""

    order: torch.Tensor
    row_start: torch.Tensor
    n_active: torch.Tensor
    cell_gap: torch.Tensor
    cell_tick: torch.Tensor
    sub_start: torch.Tensor


def group_dvs_rows(carrier: torch.Tensor, T: int) -> RowGroups:
    """Group the rows of a (5, E >= 1) carrier (`pack_dvs_plan`) of T / 2
    lanes by pixel and rank their cells in output order. Each (lane, pixel)
    holds at most one row, as the planner guarantees; the rows may come in
    any order. For a CUDA carrier two `torch.sort`s, the glue kernels of
    csrc/dvs_resident.cu (`adder_rows_keys`, `adder_rows_rank`,
    `adder_rows_starts`, counted as LAUNCHES["adder_rows_group"]) and one
    `exclusive_scan`; for a CPU carrier `group_dvs_rows_plain`."""
    if not carrier.is_cuda:
        return group_dvs_rows_plain(carrier, T)
    meta = carrier[0]
    E, dev = meta.shape[0], meta.device
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(fn, *args) -> None:
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"the row grouping's launch failed: "
                               f"{cuda_build.error_string(err)}")
        LAUNCHES["adder_rows_group"] += 1

    keys = torch.empty((2, E), dtype=torch.int32, device=dev)
    launch(lib.adder_rows_keys, meta.data_ptr(), E, keys[0].data_ptr(),
           keys[1].data_ptr())
    skey, order = torch.sort(keys[0])
    lkey, lorder = torch.sort(keys[1])
    head = torch.empty(E, dtype=torch.int32, device=dev)
    cells = torch.empty((2, E), dtype=torch.int64, device=dev)
    sub_start = torch.empty(T + 1, dtype=torch.int64, device=dev)
    launch(lib.adder_rows_rank, skey.data_ptr(), lkey.data_ptr(),
           lorder.data_ptr(), E, T, head.data_ptr(), cells[0].data_ptr(),
           cells[1].data_ptr(), sub_start.data_ptr())
    pos = exclusive_scan(head)
    row_start = torch.empty(E + 2, dtype=torch.int64, device=dev)
    launch(lib.adder_rows_starts, head.data_ptr(), pos.data_ptr(), E,
           row_start.data_ptr())
    return RowGroups(order, row_start, pos[E:], cells[0], cells[1], sub_start)


def group_dvs_rows_plain(carrier: torch.Tensor, T: int) -> RowGroups:
    """Plain version of `group_dvs_rows`, with torch ops on the carrier's
    device (any E); it reads nothing back to the host either."""
    meta = carrier[0]
    E = meta.shape[0]
    dev = meta.device
    key = meta & 0x7FFFFFF  # lane << 20 | pix
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
    lanes = torch.arange(T // 2 + 1, dtype=key.dtype, device=dev) << 20
    lane_start = torch.searchsorted(lkey, lanes)
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


def dvs_rows_resident_plain(state: ops.PixelState, carrier: torch.Tensor,
                            T: int, p: ops.TranscodeParams,
                            events: bool = True) -> ChunkResult:
    """Plain version of the DVS lane group given as its carrier
    (`make_dvs_chunk_resident_packed`,
    `adder_tpu/ops/fused_resident.py:1159`): the carrier unpacked,
    scattered into dense planes and run through `dvs_chunk_resident_plain`.
    Returns a new state; the input state is left as it was."""
    n = state.length.shape[0]
    planes = build_dvs_planes(T, n, *unpack_dvs_carrier(carrier),
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


# --- wrappers ---------------------------------------------------------------


def fused_chunk_resident(state, frames, time, p) -> ChunkResult:
    """One chunk with its events: the plain version for CPU tensors, the
    COUNT -> scan -> WRITE kernels for CUDA tensors."""
    if not frames.is_cuda:
        return fused_chunk_resident_plain(state, frames, time, p)
    return _chunk_cuda(state, frames, time, p, events=True)


def group_chunk_resident(state, frames, time, p) -> ChunkResult:
    """One chunk without events (Empty sink): the plain version for CPU
    tensors, the VOID kernel pass for CUDA tensors."""
    if not frames.is_cuda:
        return group_chunk_resident_plain(state, frames, time, p)
    return _chunk_cuda(state, frames, time, p, events=False)


def dvs_chunk_resident(state, inten, tspan, fvw, p,
                       events: bool = True) -> ChunkResult:
    """One DVS lane chunk: the plain version for CPU tensors; for CUDA
    tensors the K3 kernel `adder_dvs_chunk`, COUNT -> scan -> WRITE when
    `events`, the VOID pass (state, counts and flags only) otherwise."""
    if not inten.is_cuda:
        return dvs_chunk_resident_plain(state, inten, tspan, fvw, p, events)
    return _dvs_chunk_cuda(state, inten, tspan, fvw, p, events)


def dvs_rows_resident(state, carrier, T: int, p,
                      events: bool = True) -> ChunkResult:
    """One DVS lane group of T = 2 x lanes sub-steps given as its (5, E)
    int32 carrier (`pack_dvs_plan`): the same events in the same order, the
    same counts and flags as `dvs_chunk_resident` on the planes
    `build_dvs_planes` makes of that carrier. For a CUDA carrier the
    grouping glue `group_dvs_rows`, then the K3 row kernel `adder_dvs_rows`,
    COUNT -> scan -> WRITE when `events`, the VOID pass otherwise; for a CPU
    carrier `dvs_rows_resident_plain`.

    The state is updated in place, on the card and on the CPU alike: only
    the pixels that have rows change, so no copy of the other pixels is
    made, and the result's `state` is the caller's `state`. A caller that
    still needs the old state clones it first (`clone_state`)."""
    if not carrier.is_cuda:
        res = dvs_rows_resident_plain(state, carrier, T, p, events)
        for f in _KERNEL_FIELDS:
            getattr(state, f).copy_(getattr(res.state, f))
        return res._replace(state=state)
    return _dvs_rows_cuda(state, carrier, T, p, events)


def clone_state(state: ops.PixelState) -> ops.PixelState:
    """A copy of every per-pixel field, for a caller that keeps the old
    state across a chunk that updates it in place."""
    return ops.PixelState(*(getattr(state, f).clone()
                            for f in _KERNEL_FIELDS),
                          overflow=state.overflow)


def davis_chunk_resident(state, first_int, dt_ticks, fval, fvw, p,
                         events: bool = True) -> ChunkResult:
    """One DAVIS lane chunk: the plain version for CPU tensors; for CUDA
    tensors the K4 kernel `adder_davis_chunk`, COUNT -> scan -> WRITE when
    `events`, the VOID pass (state, counts and flags only) otherwise."""
    if not first_int.is_cuda:
        return davis_chunk_resident_plain(state, first_int, dt_ticks, fval,
                                          fvw, p, events)
    return _davis_chunk_cuda(state, first_int, dt_ticks, fval, fvw, p, events)


class _ChunkArgs(ctypes.Structure):
    """Mirror of `struct AdderChunkArgs` in csrc/adder_interval.cuh."""

    _fields_ = [
        ("pass_", ctypes.c_int),
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
        ("block_counts", ctypes.c_void_p),
        ("offsets", ctypes.c_void_p),
        ("out_pixd", ctypes.c_void_p),
        ("out_t", ctypes.c_void_p),
        ("flags", ctypes.c_void_p),
        ("dvs", ctypes.c_int),
        ("inten", ctypes.c_void_p),
        ("tspan", ctypes.c_void_p),
        ("fvw", ctypes.c_void_p),
        ("fval", ctypes.c_void_p),
    ]


# the per-pixel state fields the kernel reads and writes, in the order of
# AdderChunkArgs.state_in / state_out (overflow is passed through)
_KERNEL_FIELDS = ops.PixelState._fields[:-1]


def _check_plane(x: torch.Tensor, dtype, what: str) -> None:
    if x.dtype != dtype or x.dim() != 2:
        raise ValueError(f"{what} must be (T, N) {dtype}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    T, n = x.shape
    if not 1 <= T <= MAX_T:
        raise ValueError(f"chunk of {T} intervals; the kernel takes 1..{MAX_T}")
    if n >= MAX_PIXELS:
        raise ValueError(f"{n} pixel-channels do not fit the 24-bit pixel field")


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


def _chunk_args(state, p, T: int, n: int):
    """The argument block shared by both entry points, and the new state's
    tensors it points at."""
    out_state = ops.PixelState(
        *(torch.empty_like(getattr(state, f)) for f in _KERNEL_FIELDS),
        overflow=state.overflow,
    )
    a = _ChunkArgs()
    a.mode, a.multi_mode = int(p.mode), int(p.multi_mode)
    a.abs_time = int(p.time_mode == int(TimeMode.AbsoluteT))
    a.depth, a.T, a.n = state.node_d.shape[0], T, n
    a.ref_time, a.delta_t_max = p.ref_time, p.delta_t_max
    a.c_thresh_max = p.c_thresh_max
    for i, f in enumerate(_KERNEL_FIELDS):
        a.state_in[i] = getattr(state, f).data_ptr()
        a.state_out[i] = getattr(out_state, f).data_ptr()
    return a, out_state


def _run_passes(entry: str, a: _ChunkArgs, out_state, T: int, n: int, dev,
                events: bool) -> ChunkResult:
    """COUNT -> scan -> WRITE (events fetched) or VOID through the C entry
    point `entry`; each launch adds one to LAUNCHES[entry]."""
    lib = cuda_build.load()
    fn = getattr(lib, entry)
    stream = torch.cuda.current_stream(dev).cuda_stream
    nblk = -(-n // BLOCK)
    block_counts = torch.empty((T, nblk), dtype=torch.int32, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)  # atomic max / or
    a.block_counts = block_counts.data_ptr()
    a.flags = flags.data_ptr()

    def launch(pass_: int) -> None:
        a.pass_ = pass_
        err = fn(ctypes.addressof(a), stream)
        if err:
            raise RuntimeError(f"{entry} launch failed: "
                               f"{cuda_build.error_string(err)}")
        LAUNCHES[entry] += 1

    pixd = t = None
    if events:
        launch(PASS_COUNT)
        offsets = exclusive_scan(block_counts)
        total = int(offsets[-1])  # host read: sizes the event buffers
        pixd = torch.empty(max(total, 1), dtype=torch.int32, device=dev)
        t = torch.empty(max(total, 1), dtype=torch.int32, device=dev)
        a.offsets = offsets.data_ptr()
        a.out_pixd, a.out_t = pixd.data_ptr(), t.data_ptr()
        launch(PASS_WRITE)
        pixd, t = pixd[:total], t[:total]
    else:
        launch(PASS_VOID)
    per_interval = block_counts.sum(dim=1, dtype=torch.int64)
    pmax = flags[0].to(torch.int64) | (flags[1].to(torch.int64) << 16)
    return ChunkResult(out_state, pixd, t, per_interval, pmax)


def _chunk_cuda(state, frames, time, p, events: bool) -> ChunkResult:
    _check_plane(frames, torch.uint8, "frames")
    _check_state(state, frames, (6, 8))
    T, n = frames.shape
    time = float(np.float32(time))
    a, out_state = _chunk_args(state, p, T, n)
    a.dvs = SRC_FRAMED
    a.time = time
    a.vel_m1, a.c_inc = ops.c_thresh_scalars(time, p)
    a.frames = frames.data_ptr()
    return _run_passes("adder_resident_chunk", a, out_state, T, n,
                       frames.device, events)


def _lane_chunk_args(state, planes: dict, p):
    """Checks and the argument block shared by the DVS and DAVIS chunks:
    `planes` maps each plane's name to (tensor, dtype)."""
    for name, (x, dtype) in planes.items():
        _check_plane(x, dtype, name)
    first = next(iter(planes.values()))[0]
    if any(x.shape != first.shape for x, _ in planes.values()):
        raise ValueError(f"{', '.join(planes)} must have one shape")
    if any(x.device != first.device for x, _ in planes.values()):
        raise ValueError(f"{', '.join(planes)} must be on one device")
    if p.mode != int(Mode.Continuous) or p.time_mode != int(TimeMode.AbsoluteT):
        raise ValueError("the lane kernels are built for Continuous, AbsoluteT")
    _check_state(state, first, (DVS_DEPTH,))
    T, n = first.shape
    a, out_state = _chunk_args(state, p, T, n)
    a.vel_m1, _ = ops.c_thresh_scalars(0.0, p)
    return a, out_state, T, n


def _dvs_chunk_cuda(state, inten, tspan, fvw, p, events: bool) -> ChunkResult:
    a, out_state, T, n = _lane_chunk_args(
        state, {"inten": (inten, torch.float32),
                "tspan": (tspan, torch.float32),
                "fvw": (fvw, torch.int32)}, p)
    a.dvs = SRC_DVS
    a.inten, a.tspan, a.fvw = inten.data_ptr(), tspan.data_ptr(), fvw.data_ptr()
    return _run_passes("adder_dvs_chunk", a, out_state, T, n, inten.device,
                       events)


def _davis_chunk_cuda(state, first_int, dt_ticks, fval, fvw, p,
                      events: bool) -> ChunkResult:
    a, out_state, T, n = _lane_chunk_args(
        state, {"first_int": (first_int, torch.float32),
                "dt_ticks": (dt_ticks, torch.float32),
                "fval": (fval, torch.float32),
                "fvw": (fvw, torch.int32)}, p)
    a.dvs = SRC_DAVIS
    a.inten, a.tspan = first_int.data_ptr(), dt_ticks.data_ptr()
    a.fval, a.fvw = fval.data_ptr(), fvw.data_ptr()
    return _run_passes("adder_davis_chunk", a, out_state, T, n,
                       first_int.device, events)


class _RowsArgs(ctypes.Structure):
    """Mirror of `struct AdderRowsArgs` in csrc/adder_interval.cuh."""

    _fields_ = [
        ("pass_", ctypes.c_int),
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
        ("offsets", ctypes.c_void_p),
        ("out_pixd", ctypes.c_void_p),
        ("out_t", ctypes.c_void_p),
        ("flags", ctypes.c_void_p),
    ]


def _dvs_rows_cuda(state, carrier, T: int, p, events: bool,
                   groups: Optional[RowGroups] = None) -> ChunkResult:
    """`dvs_rows_resident` for a CUDA carrier. For the timings: `groups`,
    the grouping made beforehand."""
    if (carrier.dtype != torch.int32 or carrier.dim() != 2
            or carrier.shape[0] != 5 or not carrier.is_contiguous()):
        raise ValueError(f"carrier must be contiguous (5, E) int32, got "
                         f"{carrier.dtype} {tuple(carrier.shape)}")
    if T % 2 or not 2 <= T <= MAX_T:
        raise ValueError(f"group of {T} sub-steps; the kernel takes an even "
                         f"2..{MAX_T}")
    if p.mode != int(Mode.Continuous) or p.time_mode != int(TimeMode.AbsoluteT):
        raise ValueError("the lane kernels are built for Continuous, AbsoluteT")
    n, E, dev = state.length.shape[0], carrier.shape[1], carrier.device
    if n > 1 << 20:
        raise ValueError(f"{n} pixels: the carrier holds pixels below 2^20")
    _check_state(state, carrier, (DVS_DEPTH,), n)
    if E == 0:  # no row, nothing to launch: the state stays as it is
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        ev = torch.empty(0, dtype=torch.int32, device=dev) if events else None
        return ChunkResult(state, ev, ev, zero.expand(T).clone(), zero)
    g = groups if groups is not None else group_dvs_rows(carrier, T)
    cell_counts = torch.empty(2 * E, dtype=torch.int32, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)  # atomic max / or
    a = _RowsArgs()
    a.multi_mode, a.depth, a.src = int(p.multi_mode), DVS_DEPTH, SRC_DVS
    a.n, a.rows = n, E
    a.ref_time, a.delta_t_max = p.ref_time, p.delta_t_max
    a.c_thresh_max = p.c_thresh_max
    a.vel_m1, _ = ops.c_thresh_scalars(0.0, p)
    for i, f in enumerate(_KERNEL_FIELDS):
        a.state[i] = getattr(state, f).data_ptr()
    a.carrier = carrier.data_ptr()
    a.order, a.row_start = g.order.data_ptr(), g.row_start.data_ptr()
    a.n_active = g.n_active.data_ptr()
    a.cell_gap, a.cell_tick = g.cell_gap.data_ptr(), g.cell_tick.data_ptr()
    a.cell_counts, a.flags = cell_counts.data_ptr(), flags.data_ptr()
    lib = cuda_build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(pass_: int) -> None:
        a.pass_ = pass_
        err = lib.adder_dvs_rows(ctypes.addressof(a), stream)
        if err:
            raise RuntimeError(f"adder_dvs_rows launch failed: "
                               f"{cuda_build.error_string(err)}")
        LAUNCHES["adder_dvs_rows"] += 1

    pixd = t = None
    launch(PASS_COUNT if events else PASS_VOID)
    offsets = exclusive_scan(cell_counts)
    if events:
        total = int(offsets[-1])  # host read: sizes the event buffers
        pixd = torch.empty(max(total, 1), dtype=torch.int32, device=dev)
        t = torch.empty(max(total, 1), dtype=torch.int32, device=dev)
        a.offsets = offsets.data_ptr()
        a.out_pixd, a.out_t = pixd.data_ptr(), t.data_ptr()
        launch(PASS_WRITE)
        pixd, t = pixd[:total], t[:total]
    # the cells of one sub-step are contiguous: a segment sum of the counts
    at = offsets[g.sub_start]
    per_interval = at[1:] - at[:-1]
    pmax = flags[0].to(torch.int64) | (flags[1].to(torch.int64) << 16)
    return ChunkResult(state, pixd, t, per_interval, pmax)


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
