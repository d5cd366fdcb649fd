"""One transcode chunk: T intervals over the whole plane, events in reference order.

Counterpart of `adder_tpu/ops/fused_resident.py` in its two framed modes,
`make_fused_chunk_resident` (events fetched) and `make_group_chunk_resident`
(the Empty sink, where only counts and the depth flag are read), and in its
DVS mode, `make_dvs_chunk_resident` (lane sub-steps with per-pixel
intensity, ticks spanned and an active flag, at depth 16).

Each entry point has two implementations:

- the plain PyTorch version (`fused_chunk_resident_plain`,
  `group_chunk_resident_plain`, `dvs_chunk_resident_plain`): a Python loop
  over the T intervals of `integrate._interval_core` (for DVS,
  `dvs_batch.masked_step`), then the per-interval slots compacted into the
  reference's single-thread order (interval, raster pixel, slot);
- the hand-written Hopper kernels of `csrc/` (`adder_resident_chunk` and
  `adder_exclusive_scan` in fused_resident.cu, `adder_dvs_chunk` in
  dvs_resident.cu), reached through the wrappers `fused_chunk_resident`,
  `group_chunk_resident` and `dvs_chunk_resident`.

A wrapper runs the plain version for CPU tensors and launches the kernels
for CUDA tensors; a failed launch raises, there is no fallback.

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

from adder_tpu.core.types import Mode, TimeMode

from . import cuda_build, dvs_batch
from . import integrate as ops

BLOCK = 256  # threads (pixels) per CUDA block; must match kBlock in the .cu
MAX_T = 128  # intervals per chunk (the kernel's shared count array)
MAX_PIXELS = 1 << 24  # pix << 8 | d keeps 24 bits of pixel index

PASS_COUNT, PASS_WRITE, PASS_VOID = 0, 1, 2
DVS_DEPTH = 16  # the arena depth of the DVS path, the one the K3 kernel takes

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"adder_resident_chunk": 0, "adder_exclusive_scan": 0,
            "adder_dvs_chunk": 0}


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


def _check_state(state: ops.PixelState, like: torch.Tensor, depths) -> None:
    n = like.shape[1]
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
    a.time = time
    a.vel_m1, a.c_inc = ops.c_thresh_scalars(time, p)
    a.frames = frames.data_ptr()
    return _run_passes("adder_resident_chunk", a, out_state, T, n,
                       frames.device, events)


def _dvs_chunk_cuda(state, inten, tspan, fvw, p, events: bool) -> ChunkResult:
    _check_plane(inten, torch.float32, "inten")
    _check_plane(tspan, torch.float32, "tspan")
    _check_plane(fvw, torch.int32, "fvw")
    if not inten.shape == tspan.shape == fvw.shape:
        raise ValueError("inten, tspan and fvw must have one shape")
    if not inten.device == tspan.device == fvw.device:
        raise ValueError("inten, tspan and fvw must be on one device")
    if p.mode != int(Mode.Continuous) or p.time_mode != int(TimeMode.AbsoluteT):
        raise ValueError("the DVS kernel is built for Continuous, AbsoluteT")
    _check_state(state, inten, (DVS_DEPTH,))
    T, n = inten.shape
    a, out_state = _chunk_args(state, p, T, n)
    a.vel_m1, _ = ops.c_thresh_scalars(0.0, p)
    a.dvs = 1
    a.inten, a.tspan, a.fvw = inten.data_ptr(), tspan.data_ptr(), fvw.data_ptr()
    return _run_passes("adder_dvs_chunk", a, out_state, T, n, inten.device,
                       events)


def exclusive_scan(counts: torch.Tensor) -> torch.Tensor:
    """`adder_exclusive_scan` on a CUDA int32 tensor (plain version on the
    CPU): exclusive int64 prefix sums of the flattened counts, total last."""
    if not counts.is_cuda:
        return exclusive_scan_plain(counts)
    if counts.dtype != torch.int32 or not counts.is_contiguous():
        raise ValueError("counts must be contiguous int32")
    lib = cuda_build.load()
    out = torch.empty(counts.numel() + 1, dtype=torch.int64,
                      device=counts.device)
    err = lib.adder_exclusive_scan(
        counts.data_ptr(), out.data_ptr(), counts.numel(),
        torch.cuda.current_stream(counts.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"adder_exclusive_scan launch failed: "
                           f"{cuda_build.error_string(err)}")
    LAUNCHES["adder_exclusive_scan"] += 1
    return out
