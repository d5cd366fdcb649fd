"""One transcode chunk: T intervals over the whole plane, events in reference order.

Counterpart of `adder_tpu/ops/fused_resident.py` in its two framed modes:
`make_fused_chunk_resident` (events fetched) and `make_group_chunk_resident`
(the Empty sink, where only counts and the depth flag are read).

Each entry point has two implementations:

- the plain PyTorch version (`fused_chunk_resident_plain`,
  `group_chunk_resident_plain`): a Python loop over the T intervals of
  `integrate._interval_core`, then the per-interval slots compacted into the
  reference's single-thread order (interval, raster pixel, slot);
- the hand-written Hopper kernels of `csrc/fused_resident.cu`
  (`adder_resident_chunk` and `adder_exclusive_scan`), reached through the
  wrappers `fused_chunk_resident` / `group_chunk_resident`.

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

from adder_tpu.core.types import TimeMode

from . import cuda_build
from . import integrate as ops

BLOCK = 256  # threads (pixels) per CUDA block; must match kBlock in the .cu
MAX_T = 128  # intervals per chunk (the kernel's shared count array)
MAX_PIXELS = 1 << 24  # pix << 8 | d keeps 24 bits of pixel index

PASS_COUNT, PASS_WRITE, PASS_VOID = 0, 1, 2

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"adder_resident_chunk": 0, "adder_exclusive_scan": 0}


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


def _chunk_plain(state: ops.PixelState, frames: torch.Tensor, time: float,
                 p: ops.TranscodeParams, events: bool) -> ChunkResult:
    T, n = frames.shape
    dev = frames.device
    time = float(np.float32(time))
    s = ops._S.unstack(state)
    s.overflow = torch.zeros((), dtype=torch.int32, device=dev)
    pix = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    max_cnt = torch.zeros((), dtype=torch.int64, device=dev)
    counts, pixd_parts, t_parts = [], [], []
    for i in range(T):
        fv = frames[i].to(torch.int32)
        slots = ops._interval_core(s, fv.to(torch.float32), fv, time, p)
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


def fused_chunk_resident_plain(state, frames, time, p) -> ChunkResult:
    """Plain version of the fetched-events chunk: state after T intervals
    and the chunk's events in reference order."""
    return _chunk_plain(state, frames, time, p, events=True)


def group_chunk_resident_plain(state, frames, time, p) -> ChunkResult:
    """Plain version of the Empty-sink chunk: state, counts and flags only."""
    return _chunk_plain(state, frames, time, p, events=False)


def exclusive_scan_plain(counts: torch.Tensor) -> torch.Tensor:
    """Plain version of `adder_exclusive_scan`: exclusive prefix sums of the
    flattened int32 counts as int64, with the total appended."""
    flat = counts.reshape(-1).to(torch.int64)
    out = torch.zeros(flat.numel() + 1, dtype=torch.int64, device=flat.device)
    out[1:] = torch.cumsum(flat, 0)
    return out


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


class _ChunkArgs(ctypes.Structure):
    """Mirror of `struct AdderChunkArgs` in csrc/fused_resident.cu."""

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
    ]


# the per-pixel state fields the kernel reads and writes, in the order of
# AdderChunkArgs.state_in / state_out (overflow is passed through)
_KERNEL_FIELDS = ops.PixelState._fields[:-1]


def _check_inputs(state: ops.PixelState, frames: torch.Tensor) -> None:
    if frames.dtype != torch.uint8 or frames.dim() != 2:
        raise ValueError(f"frames must be (T, N) uint8, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    T, n = frames.shape
    if not 1 <= T <= MAX_T:
        raise ValueError(f"chunk of {T} intervals; the kernel takes 1..{MAX_T}")
    if n >= MAX_PIXELS:
        raise ValueError(f"{n} pixel-channels do not fit the 24-bit pixel field")
    depth = state.node_d.shape[0]
    if depth not in (6, 8):
        raise ValueError(f"arena depth {depth}; the kernel is built for 6 and 8")
    for name in _KERNEL_FIELDS:
        x, dt = getattr(state, name), ops.STATE_DTYPES[name]
        shape = (depth, n) if name in ops.ARENA_FIELDS else (n,)
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"state.{name}: want {dt} {shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        if x.device != frames.device or not x.is_contiguous():
            raise ValueError(f"state.{name} must be contiguous on {frames.device}")


def _chunk_cuda(state, frames, time, p, events: bool) -> ChunkResult:
    _check_inputs(state, frames)
    lib = cuda_build.load()
    T, n = frames.shape
    dev = frames.device
    nblk = -(-n // BLOCK)
    stream = torch.cuda.current_stream(dev).cuda_stream
    time = float(np.float32(time))
    vel_m1, c_inc = ops.c_thresh_scalars(time, p)

    out_state = ops.PixelState(
        *(torch.empty_like(getattr(state, f)) for f in _KERNEL_FIELDS),
        overflow=state.overflow,
    )
    block_counts = torch.empty((T, nblk), dtype=torch.int32, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)  # atomic max / or

    a = _ChunkArgs()
    a.mode, a.multi_mode = int(p.mode), int(p.multi_mode)
    a.abs_time = int(p.time_mode == int(TimeMode.AbsoluteT))
    a.depth, a.T, a.n = state.node_d.shape[0], T, n
    a.time, a.ref_time, a.delta_t_max = time, p.ref_time, p.delta_t_max
    a.c_thresh_max, a.vel_m1, a.c_inc = p.c_thresh_max, vel_m1, c_inc
    a.frames = frames.data_ptr()
    for i, f in enumerate(_KERNEL_FIELDS):
        a.state_in[i] = getattr(state, f).data_ptr()
        a.state_out[i] = getattr(out_state, f).data_ptr()
    a.block_counts = block_counts.data_ptr()
    a.flags = flags.data_ptr()

    def launch(pass_: int) -> None:
        a.pass_ = pass_
        err = lib.adder_resident_chunk(ctypes.addressof(a), stream)
        if err:
            raise RuntimeError(f"adder_resident_chunk launch failed: "
                               f"{cuda_build.error_string(err)}")
        LAUNCHES["adder_resident_chunk"] += 1

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
