"""Several processes: each transcodes its own band of rows, and the event
parts merge into the reference order.

Port of `adder_tpu/parallel/multihost.py` on torch.distributed. The pixel
plane splits in equal contiguous slices over the job's processes
(`host_pixel_slice`); each process decodes only the rows that cover its
slice (`host_rows`, `local_band_frames`), splits its slice across its own
devices (`local_shard_frames`; a `transcoder.sharded.ShardedVideo` built
with `pixels=host_pixel_slice(...)` does the same), transcodes it, and
writes its events as a part (`write_event_part`). No frame byte crosses
processes, and nothing is exchanged while the chunks run. `merge_event_parts`
(rank 0, or offline) restores the global order: interval-major across the
processes, raster order within an interval.

Where the JAX package builds one global mesh over every process's devices
and reads back the shards each process can address, a process of the port
holds only its own bands' results: `make_global_frames` becomes
`local_shard_frames`, and `addressable_host_view` takes this process's
band results. Part files keep the JAX layout (npz, magic `adpt`, version
1), so parts pass between the two packages.

`init_multihost` starts torch.distributed from torchrun's environment
(`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`; where JAX reads
`JAX_COORDINATOR_ADDRESS`) or from explicit arguments. A single-process job
is a no-op. Under NCCL each process takes the card of its `LOCAL_RANK`
(`torch.cuda.set_device`), and `sharding.make_mesh()` then gives that card
alone.
"""

from __future__ import annotations

import os
import pathlib
from typing import Optional, Sequence

import numpy as np
import torch

from . import sharding as sh

_PART_MAGIC = "adpt"
_PART_VERSION = 1


def init_multihost(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None,
                   backend: Optional[str] = None) -> bool:
    """Start torch.distributed for a multi-process job. Returns True when a
    process group of several processes is up (started now or before),
    False for the single-process no-op (no world size above 1 given and
    none in the environment). Safe to call twice.

    `init_method` defaults to "env://" (torchrun's MASTER_ADDR and
    MASTER_PORT); `world_size` and `rank` to WORLD_SIZE and RANK. The
    backend defaults to NCCL only when every process of this host has a
    card of its own (LOCAL_WORLD_SIZE, else the world size, at most the
    visible cards), and to gloo otherwise: for CPU tensors, and for
    processes that share a card. Under NCCL the process takes the card of
    its LOCAL_RANK (else of its rank modulo the visible cards) as its
    current device, before the group starts."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size)))
        own_card = (torch.cuda.is_available()
                    and local <= torch.cuda.device_count())
        backend = "nccl" if own_card else "gloo"
    if backend == "nccl":
        local_rank = int(os.environ.get(
            "LOCAL_RANK", str(rank % max(torch.cuda.device_count(), 1))))
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def host_pixel_slice(n: int, process_id: Optional[int] = None,
                     num_processes: Optional[int] = None) -> tuple:
    """This process's contiguous slice [p0, p1) of the flattened pixel
    axis under equal row-block sharding of n pixels over all processes. n
    must divide evenly by the process count."""
    pid = process_index() if process_id is None else process_id
    nproc = process_count() if num_processes is None else num_processes
    if n % nproc:
        raise ValueError(
            f"pixel count {n} not divisible by {nproc} processes; pad the "
            "plane to a multiple (same contract as the device sharding)"
        )
    per = n // nproc
    return pid * per, (pid + 1) * per


def host_rows(height: int, width: int, channels: int = 1,
              process_id: Optional[int] = None,
              num_processes: Optional[int] = None) -> tuple:
    """The [row0, row1) band of input-frame rows this process must DECODE
    to cover its pixel slice. Bands of different processes overlap by at
    most one row (when the pixel split is not row-aligned)."""
    rowpx = width * channels
    p0, p1 = host_pixel_slice(height * rowpx, process_id, num_processes)
    return p0 // rowpx, -(-p1 // rowpx)  # floor, ceil


def local_band_frames(frames_band: np.ndarray, height: int, width: int,
                      channels: int = 1, process_id: Optional[int] = None,
                      num_processes: Optional[int] = None) -> np.ndarray:
    """Slice a process's decoded row band (T, rows, W[, C]) down to its
    exact pixel slice (T, n_local) in flattened order. The band must be
    the one host_rows() prescribed."""
    rowpx = width * channels
    r0, _ = host_rows(height, width, channels, process_id, num_processes)
    p0, p1 = host_pixel_slice(
        height * rowpx, process_id, num_processes
    )
    T = frames_band.shape[0]
    flat = np.ascontiguousarray(frames_band).reshape(T, -1)
    a = p0 - r0 * rowpx
    return flat[:, a : a + (p1 - p0)]


def local_shard_frames(local_frames: np.ndarray, mesh: Sequence) -> list:
    """This process's (T, n_local) slice split into its devices' bands
    (`sharding.band_bounds`), each band a (T, n_d) u8 tensor on its
    device."""
    local_frames = np.asarray(local_frames)
    bounds = sh.band_bounds(local_frames.shape[1], len(mesh))
    return [torch.from_numpy(np.ascontiguousarray(local_frames[:, lo:hi],
                                                  dtype=np.uint8)).to(dev)
            for (lo, hi), dev in zip(bounds, mesh)]


def addressable_host_view(results: Sequence, device=None) -> tuple:
    """This process's own band results (the chunk results of
    `sharding.*_chunk_sharded`) on the host: (pixd per band, t per band,
    totals (D,), per_interval (D, T)); one read of the control scalars,
    then each band's event prefix."""
    if device is None:
        device = results[0].per_interval.device
    totals, _, per_int = sh.band_controls(results, device)
    pixd = [r.pixd[:k].cpu().numpy() for r, k in zip(results, totals.tolist())]
    t = [r.t[:k].cpu().numpy() for r, k in zip(results, totals.tolist())]
    return pixd, t, totals, per_int


def assemble_host_events(bufs_pixd, bufs_t, totals, per_interval,
                         pixel_offsets: Sequence[int], pack_max=None,
                         pack: int = 4) -> tuple:
    """One process's interval-major event stream from its bands' buffers
    (per-band arrays, band d's first totals[d] entries, per_interval[d]
    events in each interval), each band's pixel ids raised to global ids
    by pixel_offsets[d] (its first global pixel). Returns (pixd uint32, t
    uint32, per_interval (T,) int64), the per-interval counts segmenting
    the stream for the merge across processes."""
    sh._check_pack(pack_max, pack)
    return sh.merge_bands(bufs_pixd, bufs_t, totals, per_interval,
                          pixel_offsets)


def write_event_part(path, pixd, t, per_interval, pixel_offset: int,
                     process_id: Optional[int] = None) -> None:
    """Persist one process's interval-major event stream as a part file
    (compressed npz, the JAX package's layout). pixel_offset = the
    process's first global pixel id, which orders parts within an interval
    at merge time."""
    pid = process_index() if process_id is None else process_id
    np.savez_compressed(
        path,
        magic=np.frombuffer(_PART_MAGIC.encode(), dtype=np.uint8),
        version=np.int64(_PART_VERSION),
        process_id=np.int64(pid),
        pixel_offset=np.int64(pixel_offset),
        pixd=np.asarray(pixd, dtype=np.uint32),
        t=np.asarray(t, dtype=np.int64),
        per_interval=np.asarray(per_interval, dtype=np.int64),
    )


def read_event_part(path) -> dict:
    """Load a part file -> dict with pixd/t/per_interval/pixel_offset."""
    with np.load(path) as z:
        if bytes(z["magic"].tobytes()) != _PART_MAGIC.encode():
            raise ValueError(f"{path}: not an adder event part file")
        if int(z["version"]) != _PART_VERSION:
            raise ValueError(
                f"{path}: unsupported part version {int(z['version'])}"
            )
        return {
            "pixel_offset": int(z["pixel_offset"]),
            "process_id": int(z["process_id"]),
            "pixd": z["pixd"],
            "t": z["t"],
            "per_interval": z["per_interval"],
        }


def merge_event_parts(parts) -> tuple:
    """Merge part dicts (as from read_event_part) into the global
    reference single-thread stream: interval-major across processes,
    processes ordered by pixel_offset within each interval (row-block
    sharding keeps raster order). Returns (pixd uint32, t int64)."""
    parts = sorted(parts, key=lambda p: p["pixel_offset"])
    if not parts:
        return np.empty(0, np.uint32), np.empty(0, np.int64)
    T = len(parts[0]["per_interval"])
    offs = []
    for p in parts:
        if len(p["per_interval"]) != T:
            raise ValueError("event parts disagree on interval count")
        per = np.asarray(p["per_interval"], dtype=np.int64)
        offs.append(np.concatenate([[0], np.cumsum(per)]))
    out_p, out_t = [], []
    for t in range(T):
        for p, off in zip(parts, offs):
            a, b = int(off[t]), int(off[t + 1])
            if a != b:
                out_p.append(p["pixd"][a:b])
                out_t.append(p["t"][a:b])
    if not out_p:
        return np.empty(0, np.uint32), np.empty(0, np.int64)
    return np.concatenate(out_p), np.concatenate(out_t)


def encode_merged(video, parts) -> int:
    """Merge `parts` and feed the stream to `video`'s encoder (the whole
    plane's Video of rank 0, its sink attached with write_out). Returns the
    event count."""
    pixd, t = merge_event_parts(parts)
    pixd = np.asarray(pixd, dtype=np.uint32)
    video._encode(pixd, np.asarray(t).astype(np.uint32))
    return len(pixd)


def gather_parts(video, part_dir) -> Optional[int]:
    """Finish one process's part of a job: write its `ShardedVideo`'s part
    (built with `pixels=host_pixel_slice(...)`) into `part_dir` as
    part<rank>.npz, wait for every process (a torch.distributed barrier,
    when a group is up), and on rank 0 merge every part into `video`'s
    encoder (its sink attached with write_out). Returns the merged event
    count on rank 0, None on the others."""
    import torch.distributed as dist

    rank, world = process_index(), process_count()
    part_dir = pathlib.Path(part_dir)
    video.write_part(part_dir / f"part{rank}.npz", rank)
    if dist.is_initialized():
        dist.barrier()
    if rank:
        return None
    return encode_merged(video, [read_event_part(part_dir / f"part{r}.npz")
                                 for r in range(world)])
