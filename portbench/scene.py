"""The moving-blob scene, rendered into a pool of frames; the seed mirrors it
and picks where the playback starts.

The framed bench scene of the repository's `bench.py` (`_scene`): six
Gaussian blobs moving over a sinusoidal background, clipped to u8, with
the blob paths that `bench.py` draws from its own seed (7) written into
the traffic file. In colour each channel's background has a phase of its
own.

The seed picks a mirror image of the scene (left-right, up-down, both or
neither) and the chunk of the playback cycle the stream starts at. Every
pixel's series of values is then some pixel's series of the unmirrored
scene, played from another point of the same cycle, so every seed asks
the same work of the transcoder over whole cycles, in another order over
the plane and in time.

The pool is rendered on `device` (the card in a benchmark run) and held in
host memory, unrolled forward then back ("ping-pong"), so that every chunk
of frames is one contiguous slice of it and the motion has no cut where
the playback wraps.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def mirrors(seed: int) -> tuple:
    """(left-right, up-down) mirroring for `seed`."""
    flip = np.random.default_rng(seed).integers(0, 2, 2)
    return bool(flip[0]), bool(flip[1])


def start_frame(seed: int, cycle_frames: int, chunk_frames: int) -> int:
    """The frame of the playback cycle the stream starts at for `seed`: a
    whole number of chunks into it."""
    rng = np.random.default_rng(seed)
    rng.integers(0, 2, 2)  # the mirrors' draw
    return chunk_frames * int(rng.integers(0, cycle_frames // chunk_frames))


def render(scene: dict, width: int, height: int, channels: int, frames: int,
           device) -> torch.Tensor:
    """(frames, H, W, C) u8 on `device`, unmirrored."""
    dev = torch.device(device)
    bg = scene["background"]
    blobs = scene["blobs"]
    x = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    planes = []
    for c in range(channels):
        phase = 2 * math.pi * c / channels
        planes.append(bg["level"]
                      + bg["sin_amp"] * torch.sin(x / bg["sin_period_px"] + phase)
                      + bg["cos_amp"] * torch.cos(y / bg["cos_period_px"] + phase))
    background = torch.stack(planes, dim=-1)  # (H, W, C)
    two_s2 = 2.0 * blobs["sigma_px"] ** 2
    out = torch.empty((frames, height, width, channels), dtype=torch.uint8,
                      device=dev)
    for t in range(frames):
        glow = torch.zeros((height, width), dtype=torch.float32, device=dev)
        for b in blobs["paths"]:
            cx = math.fmod(b["x0_frac"] * width + b["vx_px"] * t, width) % width
            cy = math.fmod(b["y0_frac"] * height + b["vy_px"] * t, height) % height
            glow += blobs["amplitude"] * torch.exp(
                -((x - cx) ** 2 + (y - cy) ** 2) / two_s2)
        out[t] = (background + glow[..., None]).clamp(0, 255).to(torch.uint8)
    return out


def pool(traffic: dict, width: int, height: int, channels: int, seed: int,
         device) -> np.ndarray:
    """The playback sequence on the host: (F, H * W * C) u8, C-contiguous,
    the seed's mirror image of the pool, forward then backward (F = 2 x
    pool_frames)."""
    frames = render(traffic["scene"], width, height, channels,
                    traffic["pool_frames"], device)
    lr, ud = mirrors(seed)
    dims = [d for d, on in ((2, lr), (1, ud)) if on]
    if dims:
        frames = frames.flip(dims)
    fwd = frames.reshape(frames.shape[0], -1).cpu().numpy()
    if traffic["playback"] != "pingpong":
        raise ValueError(f"unknown playback {traffic['playback']!r}")
    seq = np.empty((2 * len(fwd), fwd.shape[1]), dtype=np.uint8)
    seq[:len(fwd)] = fwd
    seq[len(fwd):] = fwd[::-1]
    return seq
