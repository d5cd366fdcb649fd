"""Inputs and comparisons shared by the tests and by chip_smoke.py.

Scenes are made from a seed (numpy for small ones, torch on the target
device for 1080p), so the CPU tests and the card see the same data.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops import fused_resident as FR
from .ops import integrate as ops


def walk_frames(seed, T: int, n: int) -> np.ndarray:
    """(T, n) u8 random walk with jumps, plus constant, dark and saturated
    pixels."""
    rng = np.random.default_rng(seed)
    frames = np.zeros((T, n), dtype=np.uint8)
    cur = rng.integers(0, 256, n)
    for t in range(T):
        step = rng.integers(-6, 7, n)
        jump = rng.random(n) < 0.05
        cur = np.where(jump, rng.integers(0, 256, n), np.clip(cur + step, 0, 255))
        frames[t] = cur
    frames[:, 0] = 128
    frames[:, 1] = 0
    frames[:, 2] = 255
    return frames


def moving_blobs(H: int, W: int, T: int, seed: int, device) -> torch.Tensor:
    """(T, H, W) u8 scene: a smooth background with six bright Gaussian
    blobs moving across it (the bench scene of the JAX package), made on
    `device` from numpy-seeded blob paths."""
    rng = np.random.default_rng(seed)
    n_blobs = 6
    cx0, cy0 = rng.uniform(0, W, n_blobs), rng.uniform(0, H, n_blobs)
    vx, vy = rng.uniform(-25, 25, n_blobs), rng.uniform(-15, 15, n_blobs)
    dev = torch.device(device)
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    background = 128 + 60 * torch.sin(x / 97.0) + 30 * torch.cos(y / 53.0)
    out = torch.empty((T, H, W), dtype=torch.uint8, device=dev)
    for t in range(T):
        img = background.clone()
        for b in range(n_blobs):
            cx = math.fmod(cx0[b] + vx[b] * t, W) % W
            cy = math.fmod(cy0[b] + vy[b] * t, H) % H
            r2 = (x - cx) ** 2 + (y - cy) ** 2
            img += 90.0 * torch.exp(-r2 / (2 * 60.0 ** 2))
        out[t] = img.clamp(0, 255).to(torch.uint8)
    return out


def forced_overflow_state(frames0: torch.Tensor, n_forced: int,
                          depth: int = 6) -> ops.PixelState:
    """A depth-`depth` state whose first `n_forced` pixels fire at the last
    node on the next interval (unless the contrast threshold resets them):
    nodes 0..depth-2 sit at d = 100, which no u8 sum reaches, and the
    virgin tail re-aims at the frame's D and fires."""
    st = ops.set_initial_d(
        ops.init_state(frames0.numel(), frames0.device, depth=depth),
        frames0.to(torch.int32),
    )
    nd = st.node_d.clone()
    nd[: depth - 1, :n_forced] = 100
    length = st.length.clone()
    length[:n_forced] = depth
    return st._replace(node_d=nd, length=length)


def bitwise_max_err(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Raise unless a and b are equal bit for bit; return max |a - b|."""
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {a.dtype} {tuple(a.shape)} vs "
                             f"{b.dtype} {tuple(b.shape)}")
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        same = torch.equal(a.view(torch.int32), b.view(torch.int32))
    else:
        same = torch.equal(a, b)
    err = 0.0
    if a.numel():
        err = float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
    if not same:
        raise AssertionError(f"{what}: kernel and plain differ (max abs {err})")
    return err


def compare_chunks(got: FR.ChunkResult, want: FR.ChunkResult,
                   what: str) -> float:
    """Bit-for-bit comparison of two chunk results (events, counts, flags,
    every state field); returns the largest absolute difference."""
    errs = [
        bitwise_max_err(got.per_interval, want.per_interval, f"{what} counts"),
        bitwise_max_err(got.pmax, want.pmax, f"{what} pmax"),
    ]
    for f in ops.PixelState._fields:
        errs.append(bitwise_max_err(getattr(got.state, f),
                                    getattr(want.state, f), f"{what} {f}"))
    if (got.pixd is None) != (want.pixd is None):
        raise AssertionError(f"{what}: one result has events, one has not")
    if got.pixd is not None:
        errs.append(bitwise_max_err(got.pixd, want.pixd, f"{what} pixd"))
        errs.append(bitwise_max_err(got.t, want.t, f"{what} t"))
    return max(errs)


MODE_CASES = [
    ops.TranscodeParams(mode=m, multi_mode=u, time_mode=t, ref_time=255,
                        delta_t_max=255 * 4, c_thresh_max=7,
                        c_increase_velocity=2)
    for m in (0, 1) for u in (0, 1) for t in (0, 1)
]


def check_kernels_against_plain(device, H: int = 150, W: int = 200,
                                T: int = 8, chunks: int = 2,
                                seed: int = 0) -> float:
    """Every mode case at depth 6 and 8, plus a forced depth-6 overflow:
    the CUDA kernels (fetched and Empty-sink paths, chained over `chunks`
    chunks) against the plain version on the same inputs. Raises on any
    difference; returns the largest absolute difference (0.0)."""
    dev = torch.device(device)
    n = H * W
    frames = torch.from_numpy(walk_frames(seed, T * chunks, n)).to(dev)
    err = 0.0
    for p in MODE_CASES:
        for depth in (6, 8):
            st_k = st_p = ops.set_initial_d(
                ops.init_state(n, dev, c_thresh=3, depth=depth),
                frames[0].to(torch.int32),
            )
            for c in range(chunks):
                f = frames[c * T : (c + 1) * T].contiguous()
                what = f"mode {tuple(p[:3])} depth {depth} chunk {c}"
                k = FR.fused_chunk_resident(st_k, f, 255.0, p)
                v = FR.group_chunk_resident(st_k, f, 255.0, p)
                want = FR.fused_chunk_resident_plain(st_p, f, 255.0, p)
                err = max(err, compare_chunks(k, want, what),
                          compare_chunks(v, want._replace(pixd=None, t=None),
                                         what + " void"))
                st_k, st_p = k.state, want.state
    p = ops.TranscodeParams(mode=0, multi_mode=1, time_mode=0, ref_time=255,
                            delta_t_max=255 * 24, c_thresh_max=0,
                            c_increase_velocity=1)
    st = forced_overflow_state(frames[0], n // 10)
    f = frames[:T].contiguous()
    k = FR.fused_chunk_resident(st, f, 255.0, p)
    v = FR.group_chunk_resident(st, f, 255.0, p)
    want = FR.fused_chunk_resident_plain(st, f, 255.0, p)
    if not (int(want.pmax) >> 16) & 1:
        raise AssertionError("the forced overflow did not overflow")
    err = max(err, compare_chunks(k, want, "forced overflow"),
              compare_chunks(v, want._replace(pixd=None, t=None),
                             "forced overflow void"))
    return err
