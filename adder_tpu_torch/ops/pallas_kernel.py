"""One interval over the whole plane, as K slot planes (the interval-slot engine).

Counterpart of `adder_tpu/ops/pallas_kernel.py::make_interval_pallas` (K6),
the per-interval kernel of `make_transcode_chunk` with `pallas_block > 0`
(the JAX `Video` engine chosen by `ADDER_TPU_FUSED=0`). It runs
`_interval_core` for every pixel and writes the state, the (K, N) slot
planes (d, t, mask), the display intensity (run_val, run_has) and the
arena-overflow count added to `state.overflow`. The compaction of the slots
into reference order stays in the chunk glue (`integrate.transcode_chunk`).

Two implementations:
- `interval_slots_plain`: `integrate.integrate_interval`, its slot planes
  narrowed to the kernel's types and its masked-off slots set to 0 (the
  glue reads a slot's d and t only where its mask is set);
- the hand-written Hopper kernel `adder_interval_slots` in
  `csrc/interval_slots.cu`, reached through `interval_slots`.

The wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors; a failed launch raises, there is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.types import TimeMode

from . import cuda_build
from . import fused_resident as FR
from . import integrate as ops

KERNEL_DEPTH = ops.DEPTH  # the kernel runs the depth-8 arena only
K = ops.K_SLOTS

# Launches of the kernel, counted where the wrapper launches it.
LAUNCHES = {"adder_interval_slots": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def interval_slots_plain(state: ops.PixelState, frame: torch.Tensor,
                         time: float, p: ops.TranscodeParams):
    """Plain version: (state, slot_d (K, N) int32, slot_t (K, N) int32
    holding u32, slot_m (K, N) bool, (run_val (N,) u8, run_has (N,) bool)).
    The state's `overflow` gains the interval's arena-overflow count."""
    fv = frame.to(torch.int32)
    st, sd, stt, sm, run = ops.integrate_interval(
        state, fv.to(torch.float32), fv, time, p)
    sd = torch.where(sm, sd, 0)
    stt = torch.where(sm, stt, 0).to(torch.int32)
    return st, sd, stt, sm, run


def interval_slots(state: ops.PixelState, frame: torch.Tensor, time: float,
                   p: ops.TranscodeParams):
    """One interval as slot planes: the plain version for CPU tensors, the
    `adder_interval_slots` kernel for CUDA tensors (same outputs)."""
    if not frame.is_cuda:
        return interval_slots_plain(state, frame, time, p)
    return _interval_slots_cuda(state, frame, time, p)


class IntervalArgs(ctypes.Structure):
    """Mirror of `struct AdderIntervalArgs` in csrc/adder_interval.cuh (the
    one-interval kernels K5 and K6)."""

    _fields_ = [
        ("mode", ctypes.c_int),
        ("multi_mode", ctypes.c_int),
        ("abs_time", ctypes.c_int),
        ("depth", ctypes.c_int),
        ("n", ctypes.c_longlong),
        ("n_real", ctypes.c_longlong),
        ("time", ctypes.c_float),
        ("ref_time", ctypes.c_int),
        ("delta_t_max", ctypes.c_int),
        ("c_thresh_max", ctypes.c_int),
        ("vel_m1", ctypes.c_int),
        ("c_inc", ctypes.c_int),
        ("view_mode", ctypes.c_int),
        ("pdm", ctypes.c_float),
        ("emit_running", ctypes.c_int),
        ("pack", ctypes.c_int),
        ("cap", ctypes.c_longlong),
        ("frame", ctypes.c_void_p),
        ("state_in", ctypes.c_void_p * 14),
        ("state_out", ctypes.c_void_p * 14),
        ("run_val", ctypes.c_void_p),
        ("run_has", ctypes.c_void_p),
        ("slot_d", ctypes.c_void_p),
        ("slot_t", ctypes.c_void_p),
        ("slot_m", ctypes.c_void_p),
        ("overflow", ctypes.c_void_p),
        ("offset_in", ctypes.c_void_p),
        ("offset_out", ctypes.c_void_p),
        ("out_pixd", ctypes.c_void_p),
        ("out_t", ctypes.c_void_p),
        ("flags", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
    ]


def check_frame(frame: torch.Tensor) -> None:
    if frame.dtype != torch.uint8 or frame.dim() != 1:
        raise ValueError(f"frame must be (N,) uint8, got {frame.dtype} "
                         f"{tuple(frame.shape)}")
    if not frame.is_contiguous():
        raise ValueError("frame must be contiguous")
    if frame.numel() >= FR.MAX_PIXELS:
        raise ValueError(f"{frame.numel()} pixel-channels do not fit the "
                         f"24-bit pixel field")


def interval_args(state: ops.PixelState, frame: torch.Tensor, time: float,
                  p: ops.TranscodeParams, depths):
    """Checks and the argument block the two one-interval kernels share,
    with the new state's tensors and the display outputs it points at."""
    check_frame(frame)
    FR._check_state(state, frame[None], depths)
    n = frame.numel()
    time = float(np.float32(time))
    out_state = ops.PixelState(
        *(torch.empty_like(getattr(state, f)) for f in FR._KERNEL_FIELDS),
        overflow=state.overflow,
    )
    ia = IntervalArgs()
    ia.mode, ia.multi_mode = int(p.mode), int(p.multi_mode)
    ia.abs_time = int(p.time_mode == int(TimeMode.AbsoluteT))
    ia.depth, ia.n, ia.n_real = state.node_d.shape[0], n, n
    ia.time = time
    ia.ref_time, ia.delta_t_max = p.ref_time, p.delta_t_max
    ia.c_thresh_max = p.c_thresh_max
    ia.vel_m1, ia.c_inc = ops.c_thresh_scalars(time, p)
    for i, f in enumerate(FR._KERNEL_FIELDS):
        ia.state_in[i] = getattr(state, f).data_ptr()
        ia.state_out[i] = getattr(out_state, f).data_ptr()
    ia.view_mode = p.view_mode
    ia.pdm = ops.display_pdm(p)
    ia.frame = frame.data_ptr()
    run_val = torch.empty(n, dtype=torch.uint8, device=frame.device)
    run_has = torch.empty(n, dtype=torch.bool, device=frame.device)
    ia.run_val, ia.run_has = run_val.data_ptr(), run_has.data_ptr()
    return ia, out_state, run_val, run_has


def launch(entry: str, ia: IntervalArgs, dev, counts: dict) -> None:
    """Launch the C entry point `entry` on the current stream; raise on a
    refused launch; count it."""
    fn = getattr(cuda_build.load(), entry)
    err = fn(ctypes.addressof(ia), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{cuda_build.error_string(err)}")
    counts[entry] += 1


def _interval_slots_cuda(state, frame, time, p):
    ia, out_state, run_val, run_has = interval_args(
        state, frame, time, p, (KERNEL_DEPTH,))
    n, dev = frame.numel(), frame.device
    slot_d = torch.empty((K, n), dtype=torch.int32, device=dev)
    slot_t = torch.empty((K, n), dtype=torch.int32, device=dev)
    slot_m = torch.empty((K, n), dtype=torch.bool, device=dev)
    overflow = state.overflow.clone()
    ia.slot_d, ia.slot_t = slot_d.data_ptr(), slot_t.data_ptr()
    ia.slot_m, ia.overflow = slot_m.data_ptr(), overflow.data_ptr()
    launch("adder_interval_slots", ia, dev, LAUNCHES)
    return (out_state._replace(overflow=overflow), slot_d, slot_t, slot_m,
            (run_val, run_has))
