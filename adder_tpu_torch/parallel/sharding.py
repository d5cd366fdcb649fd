"""The pixel plane in bands, one per device, through the ported kernels.

Port of `adder_tpu/parallel/sharding.py`. Pixels never communicate while
they integrate (the reference's rayon row chunks, video.rs:677-734), so the
flattened plane splits into contiguous bands and each band runs the chunk
kernels of the single-device engines on its own device, with its own event
buffers; the only step across bands is the merge of their events on the
host. Where the JAX package runs one `shard_map` over a `jax.sharding.Mesh`,
the port calls the existing wrappers once per band:

- `transcode_chunk_sharded`: `ops.transcode_chunk` (K6 and the slot glue),
  the counterpart of `make_transcode_chunk_sharded` (`sharding.py:70`);
- `fused_chunk_sharded`: `fused_kernel.fused_chunk` (K5),
  `make_fused_chunk_sharded` (`:103`);
- `resident_chunk_sharded`: `fused_resident.fused_chunk_resident` (K1, and
  K1's display output given run0) or `group_chunk_resident` (K2, the Empty
  sink), `make_resident_chunk_sharded` (`:173`).

A mesh is a list of torch devices in band order (`make_mesh`); one card
may appear k times, and then its k bands run in order on its stream. Each
band's launches run under its device (`device_context`): the wrappers take
`torch.cuda.current_stream(dev)`, but a launch goes to the thread's current
device, so a band on `cuda:1` launched from `cuda:0` would hand the kernel
another device's stream. No wrapper reads the device inside a chunk, so the
bands of distinct cards are all launched before any is collected.

The plane splits into bands of ceil(N / k) pixels, the last one shorter
(`band_bounds`); the port's kernels need no block padding, so there are no
pad pixels. The JAX package pads the plane to `pallas_block * k` instead
(`transcoder/sharded.py:76-78`), so its bands can differ from the port's;
`convert.py` carries a state between the two layouts.

Order: every engine's chunk leaves a band's events in the reference order
within the band (interval-major, raster order within an interval), with one
count per interval. `merge_bands` restores the global single-thread order:
interval-major across the bands, the bands in order within an interval
(`sharding.py:283-292`), each band's pixel ids offset by its first pixel.
Where JAX's `assemble_resident_sharded` takes the (D, blocks, T) block
counts of its kernel's layout, the port's takes the (D, T) interval
counts, because the port's K1 already writes the reference order inside a
band.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import fused_kernel
from ..ops import fused_resident as FR
from ..ops import integrate as ops


def make_mesh(devices=None) -> list:
    """The devices the bands run on, in band order: `devices` (names or
    torch devices; one may repeat, e.g. ["cuda:0"] * 4), or by default every
    visible card; inside an NCCL job (`multihost.init_multihost`), this
    process's own card, its current device. A CUDA device without a card
    raises; nothing falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass the devices, "
                "e.g. ['cpu'] * k")
        import torch.distributed as dist

        if (dist.is_available() and dist.is_initialized()
                and dist.get_backend() == "nccl"):
            devices = [f"cuda:{torch.cuda.current_device()}"]
        else:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("make_mesh: no devices given")
    if any(d.type == "cuda" for d in mesh) and not torch.cuda.is_available():
        raise RuntimeError(
            f"mesh {devices!r} names a CUDA device but "
            "torch.cuda.is_available() is False")
    return mesh


def band_bounds(n: int, k: int) -> list:
    """[lo, hi) of each of k contiguous bands of an n-pixel plane: ceil(n /
    k) pixels each, the last one shorter. Every band holds a pixel."""
    if k < 1:
        raise ValueError(f"{k} bands")
    per = -(-n // k)
    if n < 1 or (k - 1) * per >= n:
        raise ValueError(f"{n} pixels do not fill {k} bands of {per}")
    return [(d * per, min((d + 1) * per, n)) for d in range(k)]


def device_context(dev):
    """The context a band's launches run under: its CUDA device made the
    thread's current device; nothing for a CPU band."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def shard_state(state: ops.PixelState, mesh: Sequence) -> list:
    """A whole-plane PixelState split into `len(mesh)` bands, each band's
    fields contiguous copies on its device: node arrays (DEPTH, N) along
    N, per-pixel arrays (N,) along N, the overflow scalar copied."""
    bounds = band_bounds(state.length.shape[0], len(mesh))
    bands = []
    for (lo, hi), dev in zip(bounds, mesh):
        bands.append(ops.PixelState(*(
            (x[..., lo:hi] if x.dim() else x).to(dev).clone(
                memory_format=torch.contiguous_format)
            for x in state)))
    return bands


def gather_state(states: Sequence, device) -> ops.PixelState:
    """The bands joined into one whole-plane PixelState on `device`; the
    overflow flag is the largest of the bands'."""
    dev = torch.device(device)
    fields = []
    for name in ops.PixelState._fields:
        xs = [getattr(s, name).to(dev) for s in states]
        if name == "overflow":
            fields.append(torch.stack(xs).max())
        else:
            fields.append(torch.cat(xs, dim=-1))
    return ops.PixelState(*fields)


def transcode_chunk_sharded(states, frames, time: float, run0,
                            p: ops.TranscodeParams, event_cap_per_dev: int,
                            pack: int = 4) -> list:
    """Each band's (T, n_d) u8 frames through `ops.transcode_chunk` (K6 per
    frame, then the slot glue) on its device, from its state and its
    (n_d,) display frame `run0[d]`, into its own (event_cap_per_dev,)
    buffers. Returns the bands' `ops.IntervalChunk`s."""
    out = []
    for st, fr, r0 in zip(states, frames, run0):
        with device_context(fr.device):
            out.append(ops.transcode_chunk(st, fr, time, r0, p,
                                           event_cap_per_dev, pack))
    return out


def fused_chunk_sharded(states, frames, time: float, run0,
                        p: ops.TranscodeParams, event_cap_per_dev: int,
                        pack: int = 4, emit_running: bool = True) -> list:
    """Each band through `fused_kernel.fused_chunk` (one K5 launch per
    frame, its running offset on the band's device) into its own buffers.
    Returns the bands' `ops.IntervalChunk`s."""
    out = []
    for st, fr, r0 in zip(states, frames, run0):
        with device_context(fr.device):
            out.append(fused_kernel.fused_chunk(
                st, fr, time, r0, p, event_cap_per_dev, pack,
                emit_running=emit_running))
    return out


def resident_chunk_sharded(states, frames, time: float,
                           p: ops.TranscodeParams, run0=None, *,
                           event_cap_per_dev: Optional[int]) -> list:
    """Each band through the resident chunk on its device: with
    `event_cap_per_dev` the fetched chunk (K1, the scan and the segment
    copy, into the band's own buffers), with None the Empty-sink chunk (K2,
    no events); given `run0` (one (n_d,) u8 display frame per band) K1's
    display output too. Returns the bands' `fused_resident.ChunkResult`s."""
    out = []
    for d, (st, fr) in enumerate(zip(states, frames)):
        r0 = None if run0 is None else run0[d]
        with device_context(fr.device):
            if event_cap_per_dev is None:
                out.append(FR.group_chunk_resident(st, fr, time, p, r0))
            else:
                out.append(FR.fused_chunk_resident(
                    st, fr, time, p, r0, event_cap=event_cap_per_dev))
    return out


def band_controls(results: Sequence, device) -> tuple:
    """The control scalars of every band's chunk in ONE host read: the
    bands' totals and flags and (D, T) interval counts are stacked on
    `device` first. Returns (totals (D,), pmax (D,), per_interval (D, T))
    as int64 numpy arrays."""
    dev = torch.device(device)
    rows = [torch.cat([torch.stack([r.total, r.pmax]).to(torch.int64),
                       r.per_interval.to(torch.int64)]).to(dev)
            for r in results]
    ctl = torch.stack(rows).cpu().numpy()
    return ctl[:, 0], ctl[:, 1], ctl[:, 2:]


def _u32(a) -> np.ndarray:
    """Wire words as uint32 (the kernels' int32 buffers hold u32 bits)."""
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def _check_pack(pack_max, pack: int) -> None:
    if pack_max is not None and pack < 16:
        pm = int(np.max(np.asarray(pack_max))) & 0xFFFF
        if pm > pack:
            raise OverflowError(
                f"a pixel emitted {pm} events (> pack={pack}): rerun the "
                "chunk with pack=16 to avoid event loss")


def merge_bands(bufs_pixd, bufs_t, totals, per_interval,
                offsets: Sequence[int]) -> tuple:
    """The bands' streams (band d: the first totals[d] entries of its
    buffers, in the reference order within the band, per_interval[d] events
    in each interval) as one stream in the global order: interval-major
    across the bands, the bands in order within an interval; band d's pixel
    ids raised by offsets[d]. A band whose total exceeds its buffer raises
    OverflowError (the caller reruns with a larger capacity). Returns
    (pixd uint32, t uint32, the merged (T,) interval counts)."""
    per_interval = np.asarray(per_interval, dtype=np.int64)
    D, T = per_interval.shape
    band_p, band_t, band_off = [], [], []
    for d in range(D):
        k = int(totals[d])
        if k > len(bufs_pixd[d]):
            raise OverflowError(
                f"band {d} event buffer overflow ({k} > {len(bufs_pixd[d])})")
        pd = _u32(bufs_pixd[d][:k])
        if offsets[d]:
            pd = pd + np.uint32(int(offsets[d]) << 8)
        band_p.append(pd)
        band_t.append(_u32(bufs_t[d][:k]))
        band_off.append(np.concatenate([[0], np.cumsum(per_interval[d])]))
    parts_p, parts_t = [], []
    for t in range(T):
        for d in range(D):
            a, b = int(band_off[d][t]), int(band_off[d][t + 1])
            if a != b:
                parts_p.append(band_p[d][a:b])
                parts_t.append(band_t[d][a:b])
    merged = per_interval.sum(axis=0)
    if not parts_p:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32), merged
    return np.concatenate(parts_p), np.concatenate(parts_t), merged


def assemble_resident_sharded(bufs_pixd, bufs_t, totals, per_interval,
                              pack_max=None, pack: int = 4,
                              n_local_px: int = 0) -> tuple:
    """The global single-thread order from the bands' buffers (a sequence
    of per-band arrays, each at least totals[d] long) and their (D, T)
    interval counts, band d's pixel ids raised by d * n_local_px (0: the
    ids stay local). With `pack_max`, a packed-lane overflow above `pack`
    raises OverflowError, as a capacity overflow does. Returns (pixd, t),
    uint32."""
    _check_pack(pack_max, pack)
    offsets = [d * n_local_px for d in range(len(bufs_pixd))]
    pixd, t, _ = merge_bands(bufs_pixd, bufs_t, totals, per_interval,
                             offsets)
    return pixd, t


def assemble_sharded_events(bufs_pixd, bufs_t, totals, pack_max=None,
                            pack: int = 4) -> tuple:
    """Each band's event prefix, band-major, as host arrays (pixel ids
    local): (pixd parts, t parts). A band past its buffer, or a packed-lane
    overflow given `pack_max`, raises OverflowError."""
    _check_pack(pack_max, pack)
    pixd_parts, t_parts = [], []
    for d in range(len(bufs_pixd)):
        k = int(totals[d])
        if k > len(bufs_pixd[d]):
            raise OverflowError(
                f"band {d} event buffer overflow ({k} > {len(bufs_pixd[d])})")
        pixd_parts.append(_u32(bufs_pixd[d][:k]))
        t_parts.append(_u32(bufs_t[d][:k]))
    return pixd_parts, t_parts
