"""One interval with its events written in reference order (the fused one-interval engine).

Counterpart of `adder_tpu/ops/fused_kernel.py::make_fused_interval` (K5)
and of the chunk scan over it, `adder_tpu/ops/integrate.py::make_fused_chunk`
(the JAX `Video` engine chosen by `ADDER_TPU_RESIDENT=0`). Per interval:
`_interval_core` for every pixel; each pixel's K slots left-packed into
`pack` lanes (its first `pack` events; 16 >= K keeps them all); the events
`(pix << 8 | d, t)` written in (pixel, slot) order into flat chunk buffers,
starting at a running offset that stays on the device; the display
intensity when `emit_running`. Events of pixels at or past `n_real` (plane
padding) are masked.

`flags` (2,) int32 accumulates over a chunk's intervals, as the JAX chunk
combines its `pmax` channels (`integrate.py:839-842`): flags[0] is the
largest per-pixel event count of a real pixel (above `pack`: events were
dropped), flags[1] is 1 when a fire found no free arena node, on any pixel.
`state.overflow` is passed through unchanged, as the TPU kernel does. Events
past the end of the buffers are dropped and the offset goes on counting, so
capacity overflow shows as total > event_cap without a host read.

Two implementations:
- `fused_interval_plain`: the eager torch version;
- the hand-written Hopper kernel `adder_fused_interval` in
  `csrc/fused_interval.cu`, reached through `fused_interval`.
The wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors; a failed launch raises, there is no fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import fused_resident as FR
from . import integrate as ops
from . import pallas_kernel

DEPTHS = (6, 8)  # the kernel's arena depths (6 first, 8 after a rerun)

# Launches of the kernel, counted where the wrapper launches it.
LAUNCHES = {"adder_fused_interval": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class FusedStep(NamedTuple):
    state: ops.PixelState
    offset: torch.Tensor  # 0-d int64: the running offset after the interval
    flags: torch.Tensor  # (2,) int32: max per-pixel count, depth overflow
    run_val: torch.Tensor  # (N,) u8
    run_has: torch.Tensor  # (N,) bool


def new_flags(device) -> torch.Tensor:
    return torch.zeros(2, dtype=torch.int32, device=device)


def fused_interval_plain(state: ops.PixelState, frame: torch.Tensor,
                         time: float, offset: torch.Tensor, bufs,
                         p: ops.TranscodeParams, pack: int = 4,
                         emit_running: bool = True, n_real: int = 0,
                         flags: torch.Tensor = None) -> FusedStep:
    """Plain version of one fused interval. Writes the interval's events
    into `bufs` = (pixd, t), each (cap,) int32 holding u32 values, in place
    at [offset, offset + events), dropping those at or past cap."""
    n, dev = frame.numel(), frame.device
    if flags is None:
        flags = new_flags(dev)
    s = ops._S.unstack(state)
    s.overflow = torch.zeros((), dtype=torch.int32, device=dev)
    fv = frame.to(torch.int32)
    slots = ops._interval_core(s, fv.to(torch.float32), fv,
                               float(np.float32(time)), p)
    if emit_running:
        run_val, run_has = ops._running_intensity(s, p)
    else:
        run_val = torch.zeros(n, dtype=torch.uint8, device=dev)
        run_has = torch.zeros(n, dtype=torch.bool, device=dev)
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    m = torch.stack([x[2] for x in slots], dim=1)  # (n, K) pixel-major
    m = m & (pix < (n_real or n))[:, None]
    rank = torch.cumsum(m, 1) - m.to(torch.int64)
    keep = m & (rank < pack)
    kept = keep.sum(1)
    pos = offset + (torch.cumsum(kept, 0) - kept)[:, None] + rank
    d = torch.stack([x[0] for x in slots], dim=1).to(torch.int64)
    t = torch.stack([x[1] for x in slots], dim=1).to(torch.int64)
    buf_pixd, buf_t = bufs
    w = keep & (pos < buf_pixd.numel())
    buf_pixd[pos[w]] = ((pix[:, None] << 8) | (d & 0xFF))[w].to(torch.int32)
    buf_t[pos[w]] = t[w].to(torch.int32)
    cnt_max = m.sum(1).max().to(torch.int32)
    ovf = (s.overflow > 0).to(torch.int32)
    flags = torch.stack([torch.maximum(flags[0], cnt_max), flags[1] | ovf])
    return FusedStep(s.restack()._replace(overflow=state.overflow),
                     offset + kept.sum(), flags, run_val, run_has)


def fused_interval(state: ops.PixelState, frame: torch.Tensor, time: float,
                   offset: torch.Tensor, bufs, p: ops.TranscodeParams,
                   pack: int = 4, emit_running: bool = True, n_real: int = 0,
                   flags: torch.Tensor = None,
                   scratch: torch.Tensor = None) -> FusedStep:
    """One fused interval: the plain version for CPU tensors, the
    `adder_fused_interval` kernel for CUDA tensors (same outputs; `bufs`
    written in place, `flags` updated in place on the card). `scratch`, on
    the card: the kernel's look-back words and block ticket, (nblk + 1,)
    int64 zeroed (`new_scratch`), used by one launch; made here if None."""
    if not frame.is_cuda:
        return fused_interval_plain(state, frame, time, offset, bufs, p, pack,
                                    emit_running, n_real, flags)
    return _fused_interval_cuda(state, frame, time, offset, bufs, p, pack,
                                emit_running, n_real, flags, scratch)


def new_scratch(n: int, device, launches: int = 1) -> torch.Tensor:
    """(launches, nblk + 1) zeroed int64: one row of look-back words and a
    block ticket for each of `launches` K5 launches over n pixels, zeroed
    by one memset."""
    return torch.zeros((launches, -(-n // FR.BLOCK) + 1), dtype=torch.int64,
                       device=device)


def fused_chunk(state: ops.PixelState, frames: torch.Tensor, time: float,
                run0: torch.Tensor, p: ops.TranscodeParams, event_cap: int,
                pack: int = 4, emit_running: bool = True,
                n_real: int = 0) -> ops.IntervalChunk:
    """T frames through `fused_interval` (counterpart of `make_fused_chunk`,
    `adder_tpu/ops/integrate.py:800-868`): (event_cap,) buffers, the
    running offset and the flags stay on the device for the whole chunk,
    with no host read. The arena depth is the state's (6 or 8 on the card).

    Overflow (events lost; the caller reruns from the pre-chunk state):
    total > event_cap; pmax & 0xFFFF above `pack`; pmax bit 16, the arena
    outgrew its depth."""
    T, n = frames.shape
    dev = frames.device
    bufs = (torch.zeros(event_cap, dtype=torch.int32, device=dev),
            torch.zeros(event_cap, dtype=torch.int32, device=dev))
    offsets = [torch.zeros((), dtype=torch.int64, device=dev)]
    flags = new_flags(dev)
    scratch = new_scratch(n, dev, T) if frames.is_cuda else None
    run, runnings = run0, []
    for i in range(T):
        r = fused_interval(state, frames[i], time, offsets[-1], bufs, p, pack,
                           emit_running, n_real, flags,
                           None if scratch is None else scratch[i])
        state, flags = r.state, r.flags
        offsets.append(r.offset)
        run = torch.where(r.run_has, r.run_val, run)
        runnings.append(run)
    offsets = torch.stack(offsets)
    pmax = flags[0].to(torch.int64) | (flags[1].to(torch.int64) << 16)
    return ops.IntervalChunk(state, bufs[0], bufs[1], offsets[-1],
                             offsets[1:] - offsets[:-1],
                             torch.stack(runnings), pmax)


def _fused_interval_cuda(state, frame, time, offset, bufs, p, pack,
                         emit_running, n_real, flags, scratch=None):
    if not 1 <= pack <= 16:
        raise ValueError(f"pack {pack}: the kernel takes 1..16 lanes")
    buf_pixd, buf_t = bufs
    for name, x in (("offset", offset), ("flags", flags)):
        if x is not None and (x.device != frame.device
                              or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {frame.device}")
    if offset.dtype != torch.int64 or offset.numel() != 1:
        raise ValueError("offset must be one int64")
    if (buf_pixd.dtype != torch.int32 or buf_t.dtype != torch.int32
            or buf_pixd.shape != buf_t.shape or buf_pixd.dim() != 1
            or buf_pixd.device != frame.device
            or not (buf_pixd.is_contiguous() and buf_t.is_contiguous())):
        raise ValueError("bufs must be two contiguous (cap,) int32 tensors "
                         f"on {frame.device}")
    ia, out_state, run_val, run_has = pallas_kernel.interval_args(
        state, frame, time, p, DEPTHS)
    n, dev = frame.numel(), frame.device
    if flags is None:
        flags = new_flags(dev)
    elif flags.dtype != torch.int32 or flags.numel() != 2:
        raise ValueError("flags must be (2,) int32")
    if scratch is None:
        scratch = new_scratch(n, dev)[0]
    elif (scratch.dtype != torch.int64 or scratch.device != dev
          or not scratch.is_contiguous()
          or scratch.shape != (-(-n // FR.BLOCK) + 1,)):
        raise ValueError(f"scratch must be a contiguous zeroed "
                         f"({-(-n // FR.BLOCK) + 1},) int64 on {dev}")
    new_offset = torch.empty((), dtype=torch.int64, device=dev)
    ia.n_real = n_real or n
    ia.emit_running, ia.pack, ia.cap = int(emit_running), pack, buf_pixd.numel()
    ia.offset_in, ia.offset_out = offset.data_ptr(), new_offset.data_ptr()
    ia.out_pixd, ia.out_t = buf_pixd.data_ptr(), buf_t.data_ptr()
    ia.flags, ia.scratch = flags.data_ptr(), scratch.data_ptr()
    pallas_kernel.launch("adder_fused_interval", ia, dev, LAUNCHES)
    return FusedStep(out_state, new_offset, flags, run_val, run_has)
