"""Inputs and comparisons shared by the tests and by chip_smoke.py.

Scenes are made from a seed (numpy for small ones, torch on the target
device for 1080p), so the CPU tests and the card see the same data.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .ops import dvs_batch
from .ops import fused_kernel as FK
from .ops import fused_resident as FR
from .ops import integrate as ops
from .ops import pallas_kernel as PK


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


def moving_blobs(H: int, W: int, T: int, seed: int, device,
                 rows: Optional[tuple] = None) -> torch.Tensor:
    """(T, H, W) u8 scene: a smooth background with six bright Gaussian
    blobs moving across it (the bench scene of the JAX package), made on
    `device` from numpy-seeded blob paths. With `rows=(r0, r1)`, only those
    rows, (T, r1 - r0, W): each pixel is computed on its own, so they equal
    the whole scene's rows bit for bit."""
    rng = np.random.default_rng(seed)
    n_blobs = 6
    cx0, cy0 = rng.uniform(0, W, n_blobs), rng.uniform(0, H, n_blobs)
    vx, vy = rng.uniform(-25, 25, n_blobs), rng.uniform(-15, 15, n_blobs)
    dev = torch.device(device)
    r0, r1 = (0, H) if rows is None else rows
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(r0, r1, dtype=torch.float32, device=dev)[:, None]
    background = 128 + 60 * torch.sin(x / 97.0) + 30 * torch.cos(y / 53.0)
    out = torch.empty((T, r1 - r0, W), dtype=torch.uint8, device=dev)
    for t in range(T):
        img = background.clone()
        for b in range(n_blobs):
            cx = math.fmod(cx0[b] + vx[b] * t, W) % W
            cy = math.fmod(cy0[b] + vy[b] * t, H) % H
            r2 = (x - cx) ** 2 + (y - cy) ** 2
            img += 90.0 * torch.exp(-r2 / (2 * 60.0 ** 2))
        out[t] = img.clamp(0, 255).to(torch.uint8)
    return out


def moving_shapes(seed, T: int, H: int, W: int, C: int = 1,
                  n_shapes: int = 4) -> np.ndarray:
    """(T, H, W, C) u8 scene with corners for FAST: seeded squares and
    discs, bright or dark, moving at seeded whole-pixel speeds (wrapping
    round the plane) over a dim gradient, in channel 0. A channel c > 0
    holds the first frame, offset by 17 c, still: FAST reads channel 0, and
    an event of channel 0 is a candidate only where its own pixel's next
    channel has none (video.rs:900-917)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = 40 + (xx * 50) // max(W - 1, 1) + (yy * 20) // max(H - 1, 1)
    shapes = [(int(rng.integers(0, W)), int(rng.integers(0, H)),
               int(rng.integers(4, 12)), int(rng.integers(-3, 4)),
               int(rng.integers(-2, 3)),
               int(rng.integers(150, 256) if k % 2 == 0
                   else rng.integers(0, 10)))
              for k in range(n_shapes)]
    frames = np.empty((T, H, W, C), np.uint8)
    for t in range(T):
        img = base.copy()
        for k, (x0, y0, r, vx, vy, val) in enumerate(shapes):
            cx, cy = (x0 + vx * t) % W, (y0 + vy * t) % H
            if k % 2:
                inside = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            else:
                inside = (abs(xx - cx) <= r) & (abs(yy - cy) <= r)
            img = np.where(inside, val, img)
        frames[t, ..., 0] = img
        for c in range(1, C):
            frames[t, ..., c] = np.clip(
                frames[0, ..., 0].astype(np.int32) + 17 * c, 0, 255)
    return frames


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
    every state field, the total where both give one); the events are
    compared up to the total, since a framed chunk on the card gives its
    capacity-sized buffers. Returns the largest absolute difference."""
    errs = [
        bitwise_max_err(got.per_interval, want.per_interval, f"{what} counts"),
        bitwise_max_err(got.pmax, want.pmax, f"{what} pmax"),
    ]
    if got.total is not None and want.total is not None:
        errs.append(bitwise_max_err(got.total, want.total, f"{what} total"))
    for f in ops.PixelState._fields:
        errs.append(bitwise_max_err(getattr(got.state, f),
                                    getattr(want.state, f), f"{what} {f}"))
    if (got.pixd is None) != (want.pixd is None):
        raise AssertionError(f"{what}: one result has events, one has not")
    if got.pixd is not None:
        n = int(want.per_interval.sum())
        for f in ("pixd", "t"):
            a, b = getattr(got, f), getattr(want, f)
            if a.numel() < n or b.numel() < n:
                raise AssertionError(f"{what} {f}: {a.numel()} and "
                                     f"{b.numel()} entries for {n} events")
            errs.append(bitwise_max_err(a[:n], b[:n], f"{what} {f}"))
    if (got.runnings is None) != (want.runnings is None):
        raise AssertionError(f"{what}: one result has a display, one has not")
    if got.runnings is not None:
        errs.append(bitwise_max_err(got.runnings, want.runnings,
                                    f"{what} runnings"))
    return max(errs)


MODE_CASES = [
    ops.TranscodeParams(mode=m, multi_mode=u, time_mode=t, ref_time=255,
                        delta_t_max=255 * 4, c_thresh_max=7,
                        c_increase_velocity=2)
    for m in (0, 1) for u in (0, 1) for t in (0, 1)
]


# the (H, W, T) chunks the kernel checks add to their main plane: one
# interval, and the longest chunk the kernel takes, on a second ragged plane
EXTRA_CHUNKS = ((150, 200, 1), (47, 61, 1), (47, 61, 128))


def firing_frames(T: int, n: int) -> np.ndarray:
    """(T, n) u8 frames that swing between 0 and 255 every interval, so that
    every pixel crosses its contrast threshold in every interval."""
    frames = np.zeros((T, n), dtype=np.uint8)
    frames[1::2] = 255
    return frames


def _chained_chunks(dev, p, depth: int, frames: torch.Tensor, T: int,
                    run0, what: str) -> float:
    """The chunks of `frames` (T intervals each) chained from a fresh state
    (and, given `run0`, a display frame): the kernels' fetched and
    Empty-sink chunks against the plain version. Returns the largest
    absolute difference."""
    err = 0.0
    st_k = st_p = ops.set_initial_d(
        ops.init_state(frames.shape[1], dev, c_thresh=3, depth=depth),
        frames[0].to(torch.int32),
    )
    run_k = run_p = run0
    for c in range(frames.shape[0] // T):
        f = frames[c * T : (c + 1) * T].contiguous()
        w = f"{what} chunk {c}"
        want = FR.fused_chunk_resident_plain(st_p, f, 255.0, p, run_p)
        k = FR.fused_chunk_resident(st_k, f, 255.0, p, run_k,
                                    event_cap=int(want.total))
        v = FR.group_chunk_resident(st_k, f, 255.0, p, run_k)
        err = max(err, compare_chunks(k, want, w),
                  compare_chunks(v, want._replace(pixd=None, t=None),
                                 w + " void"))
        st_k, st_p = k.state, want.state
        if run0 is not None:
            run_k, run_p = k.runnings[-1], want.runnings[-1]
    return err


def _chunk_cases(H: int, W: int, T: int, chunks: int, extra):
    """(n, T, chunks) of the main plane, then of each extra chunk."""
    return [(H * W, T, chunks)] + [(h * w, t, 1) for h, w, t in extra]


def check_kernels_against_plain(device, H: int = 150, W: int = 200,
                                T: int = 8, chunks: int = 2,
                                seed: int = 0,
                                extra=EXTRA_CHUNKS) -> float:
    """Every mode case at depth 6 and 8: the CUDA kernels (the fetched
    chunk: the one-pass kernel, the scan and the segment copy; the
    Empty-sink chunk), chained over `chunks` chunks of T on the H x W plane
    and for each (h, w, t) of `extra`, against the plain version on the
    same inputs; then a forced depth-6 overflow and a forced capacity
    overflow (`check_capacity_overflow`). Raises on any difference;
    returns the largest absolute difference (0.0)."""
    dev = torch.device(device)
    err = 0.0
    for i, (n, t, c) in enumerate(_chunk_cases(H, W, T, chunks, extra)):
        frames = torch.from_numpy(walk_frames(seed + i, t * c, n)).to(dev)
        for p in MODE_CASES:
            for depth in (6, 8):
                err = max(err, _chained_chunks(
                    dev, p, depth, frames, t, None,
                    f"{n} pixels T {t} mode {tuple(p[:3])} depth {depth}"))
    n = H * W
    frames = torch.from_numpy(walk_frames(seed, T, n)).to(dev)
    p = ops.TranscodeParams(mode=0, multi_mode=1, time_mode=0, ref_time=255,
                            delta_t_max=255 * 24, c_thresh_max=0,
                            c_increase_velocity=1)
    st = forced_overflow_state(frames[0], n // 10)
    want = FR.fused_chunk_resident_plain(st, frames, 255.0, p)
    k = FR.fused_chunk_resident(st, frames, 255.0, p,
                                event_cap=int(want.total))
    v = FR.group_chunk_resident(st, frames, 255.0, p)
    if not (int(want.pmax) >> 16) & 1:
        raise AssertionError("the forced overflow did not overflow")
    err = max(err, compare_chunks(k, want, "forced overflow"),
              compare_chunks(v, want._replace(pixd=None, t=None),
                             "forced overflow void"))
    return max(err, check_capacity_overflow(dev, H, W))


def check_capacity_overflow(device, H: int = 150, W: int = 200,
                            T: int = 32) -> float:
    """A chunk whose every pixel fires in every interval, given a quarter of
    its events as capacity, then none: `total` still counts every event
    (the plain version's), so the caller sees the overflow; the rerun at
    capacity `total` equals the plain version. At capacity 0 the staging
    pool (one slab per warp) runs dry too. Raises on any difference;
    returns the largest absolute difference (0.0)."""
    dev = torch.device(device)
    n = H * W
    frames = torch.from_numpy(firing_frames(T, n)).to(dev)
    p = ops.TranscodeParams(mode=1, multi_mode=0, time_mode=1, ref_time=255,
                            delta_t_max=255, c_thresh_max=0,
                            c_increase_velocity=1)
    st = ops.set_initial_d(ops.init_state(n, dev, c_thresh=0, depth=6),
                           frames[0].to(torch.int32))
    want = FR.fused_chunk_resident_plain(st, frames, 255.0, p)
    total = int(want.total)
    if total <= n * (6 + 3):
        raise AssertionError(f"{total} events do not outgrow the staging "
                             f"slack of {n * (6 + 3)}")
    err = 0.0
    for cap in (total // 4, 0):
        k = FR.fused_chunk_resident(st, frames, 255.0, p, event_cap=cap)
        err = max(err, bitwise_max_err(k.total, want.total,
                                       f"capacity {cap} total"))
        if int(k.total) <= cap:
            raise AssertionError(f"capacity {cap}: no overflow seen")
    rerun = FR.fused_chunk_resident(st, frames, 255.0, p, event_cap=total)
    return max(err, compare_chunks(rerun, want, "capacity rerun"))


def segment_counts(res: FR.ChunkResult, n: int) -> np.ndarray:
    """(T, ceil(n / 32)) int64: a plain chunk's events per (interval,
    warp), the chunk kernel's segments."""
    T = res.per_interval.numel()
    pix = res.pixd.numpy().view(np.uint32) >> 8
    interval = np.repeat(np.arange(T), res.per_interval.numpy())
    counts = np.zeros((T, -(-n // 32)), dtype=np.int64)
    np.add.at(counts, (interval, pix.astype(np.int64) // 32), 1)
    return counts


def stage_segments(res: FR.ChunkResult, n: int, slab: int, seed: int = 0):
    """A plain chunk's events staged as the chunk kernel stages them, the
    warps taking their slabs in a seeded random order: each warp's
    intervals in order, the warps interleaved at random. Returns (stage,
    seg_start, counts, link) as CPU tensors for `segment_copy` (the pool
    holds the events plus one slab per warp)."""
    rng = np.random.default_rng(seed)
    counts = segment_counts(res, n)
    T, W = counts.shape
    pixd = res.pixd.numpy().view(np.uint32).astype(np.uint64)
    tt = res.t.numpy().view(np.uint32).astype(np.uint64)
    words = (pixd | (tt << np.uint64(32))).view(np.int64)
    if counts.max(initial=0) > slab:
        raise ValueError(f"a segment of {counts.max()} events; slab {slab}")
    first = (np.cumsum(counts.reshape(-1)) - counts.reshape(-1)).reshape(T, W)
    pool = (-(-len(words) // slab) + W) * slab
    stage = np.full(pool, -1, dtype=np.int64)
    seg_start = np.zeros((T, W), dtype=np.int64)
    link = np.full(pool // slab, -1, dtype=np.int32)
    cur = np.zeros(W, dtype=np.int64)
    room = np.zeros(W, dtype=np.int64)
    nxt_t = np.zeros(W, dtype=np.int64)
    cursor = 0
    for w in rng.permutation(np.repeat(np.arange(W), T)):
        t = nxt_t[w]
        nxt_t[w] += 1
        c = counts[t, w]
        if c == 0:
            continue
        if room[w] >= c:
            start = cur[w]
            at = start + np.arange(c)
            cur[w] += c
            room[w] -= c
        else:
            base, cursor = cursor, cursor + slab
            if room[w] == 0:
                start = base
                at = base + np.arange(c)
                cur[w], room[w] = base + c, slab - c
            else:
                start, k = cur[w], room[w]
                at = np.concatenate([start + np.arange(k),
                                     base + np.arange(c - k)])
                link[start // slab] = base // slab
                cur[w], room[w] = base + c - k, slab - (c - k)
        seg_start[t, w] = start
        stage[at] = words[first[t, w] + np.arange(c)]
    return (torch.from_numpy(stage), torch.from_numpy(seg_start),
            torch.from_numpy(counts.astype(np.int32)), torch.from_numpy(link))


def segment_copy_cases(seed: int = 0):
    """(name, plain chunk, n) for the segment copy checks: a ragged 47 x 61
    plane (its last warp holds 19 pixels) of seeded walks, T = 8; the same
    plane with no event; every pixel firing in every interval."""
    n = 47 * 61
    p = MODE_CASES[5]
    walk = torch.from_numpy(walk_frames(seed, 8, n))
    fire = torch.from_numpy(firing_frames(8, n))
    still = torch.full((2, n), 77, dtype=torch.uint8)
    cases = []
    for name, frames in (("walk", walk), ("no events", still),
                         ("every pixel fires", fire)):
        st = ops.set_initial_d(ops.init_state(n, "cpu", c_thresh=0, depth=6),
                               frames[0].to(torch.int32))
        cases.append((name, FR.fused_chunk_resident_plain(st, frames, 255.0,
                                                          p), n))
    return cases


def check_segment_copy_against_plain(device, seed: int = 0) -> float:
    """`segment_copy` on `device` against `segment_copy_plain` and against
    the plain chunk's events, bit for bit, for each of
    `segment_copy_cases`: staging from `stage_segments` with slabs as small
    as the largest segment (so that many segments run over into a second
    slab) and with the kernel's slab, at the full capacity and at half the
    events. Raises on any difference; returns the largest absolute
    difference (0.0)."""
    dev = torch.device(device)
    err = 0.0
    for name, res, n in segment_copy_cases(seed):
        total = int(res.total)
        biggest = int(segment_counts(res, n).max(initial=0))
        for slab in sorted({max(biggest, 1), FR.slab_entries(6)}):
            stage, seg_start, counts, link = stage_segments(res, n, slab,
                                                            seed)
            offsets = FR.exclusive_scan_plain(counts)
            flags = torch.zeros(3, dtype=torch.int32)
            for cap in (total, total // 2):
                what = f"segment copy, {name}, slab {slab}, capacity {cap}"
                want = FR.segment_copy_plain(stage, seg_start, counts,
                                             offsets, link, slab, cap, flags)
                got = FR.segment_copy(
                    stage.to(dev), seg_start.to(dev), counts.to(dev),
                    offsets.to(dev), link.to(dev), slab, cap, flags.to(dev))
                for g, w_, ref in zip(got, want, (res.pixd, res.t)):
                    err = max(err, bitwise_max_err(g.cpu(), w_, what),
                              bitwise_max_err(w_, ref[:cap], what + " order"))
    return err


def check_display_against_plain(device, H: int = 150, W: int = 200,
                                T: int = 8, chunks: int = 2,
                                seed: int = 0,
                                extra=EXTRA_CHUNKS) -> float:
    """The resident kernel's display output (K1 with `run0`) against the
    plain version on the same inputs, bit for bit, on ragged planes: every
    mode case at depth 6 and 8, the view mode cycling so that each of the
    four meets four mode cases at each depth, `chunks` chained chunks of T
    on the H x W plane and one of each (h, w, t) of `extra`, from a
    non-zero seeded display frame, the events fetched and the Empty sink;
    then a forced depth-6 overflow. Raises on any difference; returns the
    largest absolute difference (0.0)."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed + 1)
    err = 0.0
    for j, (n, t, c) in enumerate(_chunk_cases(H, W, T, chunks, extra)):
        frames = torch.from_numpy(walk_frames(seed + j, t * c, n)).to(dev)
        run0 = torch.from_numpy(rng.integers(0, 256, n,
                                             dtype=np.uint8)).to(dev)
        for i, p in enumerate(MODE_CASES):
            for depth in (6, 8):
                p = p._replace(view_mode=(i + depth // 2) % 4)
                err = max(err, _chained_chunks(
                    dev, p, depth, frames, t, run0,
                    f"display {n} pixels T {t} mode {tuple(p[:3])} view "
                    f"{p.view_mode} depth {depth}"))
    n = H * W
    frames = torch.from_numpy(walk_frames(seed, T, n)).to(dev)
    run0 = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)).to(dev)
    p = ops.TranscodeParams(mode=0, multi_mode=1, time_mode=0, ref_time=255,
                            delta_t_max=255 * 24, c_thresh_max=0,
                            c_increase_velocity=1, view_mode=1)
    st = forced_overflow_state(frames[0], n // 10)
    want = FR.fused_chunk_resident_plain(st, frames, 255.0, p, run0)
    if not (int(want.pmax) >> 16) & 1:
        raise AssertionError("the forced overflow did not overflow")
    got = FR.fused_chunk_resident(st, frames, 255.0, p, run0,
                                  event_cap=int(want.total))
    err = max(err, compare_chunks(got, want, "display forced overflow"),
              compare_chunks(FR.group_chunk_resident(st, frames, 255.0, p,
                                                     run0),
                             want._replace(pixd=None, t=None),
                             "display forced overflow void"))
    return err


# --- DVS (Prophesee) inputs and checks -----------------------------------------


def dvs_stream(seed, W: int, H: int, duration_us: int, n_hot: int = 0,
               hot_events: int = 0, band_events: int = 0,
               background_events: int = 0, band_width: int = 24):
    """A seeded synthetic DVS stream as (t u32 us, x u16, y u16, p u8),
    sorted by time: `n_hot` hot pixels with `hot_events` events each, a
    `band_width`-pixel vertical band that sweeps the width once over the
    duration with `band_events` events, and `background_events` uniform
    events; random polarity. Times start at 3 us (every pixel's chain
    starts at t = 2)."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(W * H, n_hot, replace=False)
    hot_pix = np.repeat(hot, hot_events)
    t_hot = rng.integers(0, duration_us, len(hot_pix))
    t_band = rng.integers(0, duration_us, band_events)
    edge = (t_band * (W - band_width) // max(duration_us, 1)).astype(np.int64)
    band_pix = ((rng.integers(0, H, band_events)) * W
                + edge + rng.integers(0, band_width, band_events))
    bg_pix = rng.integers(0, W * H, background_events)
    t_bg = rng.integers(0, duration_us, background_events)
    pix = np.concatenate([hot_pix, band_pix, bg_pix]).astype(np.int64)
    t = np.concatenate([t_hot, t_band, t_bg]).astype(np.int64) + 3
    order = np.argsort(t, kind="stable")
    t, pix = t[order], pix[order]
    p = rng.integers(0, 2, len(t)).astype(np.uint8)
    return (t.astype(np.uint32), (pix % W).astype(np.uint16),
            (pix // W).astype(np.uint16), p)


def write_prophesee_raw(path, W: int, H: int, t, x, y, p) -> None:
    """Write a Prophesee RAW file: the %-header, the (type 0, size 8) bytes,
    then (t, p << 28 | y << 14 | x) little-endian u32 records."""
    rec = np.empty((len(t), 2), dtype="<u4")
    rec[:, 0] = t
    rec[:, 1] = ((np.asarray(p, np.uint32) << 28)
                 | (np.asarray(y, np.uint32) << 14) | np.asarray(x, np.uint32))
    with open(path, "wb") as f:
        f.write(b"%% Height %d\n%% Width %d\n" % (H, W))
        f.write(bytes([0, 8]))
        f.write(rec.tobytes())


def _dvs_params(multi_mode: int) -> ops.TranscodeParams:
    """The Prophesee path's parameters (ref_time 20, delta_t_max 40) with an
    adapting c_thresh, so the per-pixel c_thresh increment is exercised."""
    return ops.TranscodeParams(mode=1, multi_mode=multi_mode, time_mode=1,
                               ref_time=20, delta_t_max=40, c_thresh_max=6,
                               c_increase_velocity=2)


def dvs_group_planes(plan, lane_lo: int, lane_hi: int, n: int, device,
                     ref_time: int = 20):
    """Lanes [lane_lo, lane_hi) of a plan as (T, n) planes on `device`,
    through the carrier the Prophesee path ships."""
    g = plan.lane_slice(lane_lo, lane_hi)
    carrier = torch.from_numpy(FR.pack_dvs_plan(g)).to(device)
    return FR.build_dvs_planes(2 * (lane_hi - lane_lo), n,
                               *FR.unpack_dvs_carrier(carrier),
                               ref_time=ref_time)


def _check_plan(seed, W: int, H: int, need: int) -> dvs_batch.DvsCompact:
    """A seeded stream on fresh chains, planned by the port's planner into
    at least `need` lanes: three hot pixels and a quarter of the plane in
    background events."""
    n = H * W
    ts, xs, ys, ps = dvs_stream(seed, W, H, 200_000, n_hot=3,
                                hot_events=need + 8,
                                background_events=max(n // 4, 64))
    last_t = np.full(n, 2, np.uint32)
    last_ln = np.full(n, np.log1p(128.0 / 255.0), np.float64)
    plan = dvs_batch.plan_dvs_compact(ts, xs, ys, ps, W, last_t, last_ln,
                                      0.02, 20)
    if plan.n_lanes < need:
        raise AssertionError(f"stream planned {plan.n_lanes} lanes < {need}")
    return plan


def check_raster_chunks_against_plain(device, H: int = 260, W: int = 346,
                                      seed: int = 0) -> float:
    """The chunks of one row per pixel in raster order, as the sources build
    them and run them (`lanes.run_raster_chunk`: T = 2, the grouping
    `FR.raster_row_groups`, the K3 row kernel), against the plain version,
    bit for bit (`check_rows_group`: events and void, each grouping equal to
    the glue's), for Normal and Collapse and chained: the Prophesee
    bootstrap from a fresh state; a flush of a seeded partial mask
    (`lanes.gap_rows`); a DAVIS APS frame's carrier, built on `device` by
    `davis.frame_carrier` from a seeded u8 frame and held to the numpy f64
    build of the same rows; the gap to a frame of a seeded partial mask;
    then the bootstrap on a forced depth-16 overflow. Raises on any
    difference; returns the largest absolute difference (0.0)."""
    from .transcoder.davis import frame_carrier
    from .transcoder.lanes import gap_rows
    from .transcoder.prophesee import bootstrap_carrier

    dev = torch.device(device)
    n = H * W
    rng = np.random.default_rng(seed)

    def on_dev(rows):
        return torch.from_numpy(rows).to(dev)

    def gap_chunk(ref: int, frame_gap: bool):
        """Gap rows of a partial mask with the sources' own arithmetic: the
        flush's (Prophesee) or the gap to a frame's (DAVIS)."""
        pix = np.flatnonzero(rng.random(n) < 0.6)
        last_val = rng.uniform(0.0, 300.0, len(pix))
        if frame_gap:
            dt = rng.integers(1, 40_000, len(pix)).astype(np.float64) * 255.0
            inten = np.maximum(last_val / ref * dt, 0.0)
        else:
            dt = (rng.integers(1, 5_000, len(pix)) * ref).astype(np.float64)
            inten = last_val * dt
        fv = np.clip(last_val, 0.0, 255.0).astype(np.int64)
        return on_dev(gap_rows(pix, fv, inten, dt))

    frame = rng.integers(0, 256, n, dtype=np.uint8)
    dt_frame = 10_000 * 255.0  # a 10 ms exposure at 255 ticks per us
    frame_rows = frame_carrier(on_dev(frame), 255, dt_frame)
    err = bitwise_max_err(frame_rows, on_dev(gap_rows(
        np.arange(n), frame, frame.astype(np.float64) / 255 * dt_frame,
        np.full(n, dt_frame))), "frame carrier on the device")
    groups = FR.raster_row_groups
    n_events = 0
    for multi in (0, 1):
        st = ops.init_state(n, dev, c_thresh=3, depth=FR.DVS_DEPTH)
        p_dvs, p_davis = _dvs_params(multi), _davis_params(multi)
        for what, carrier, p in (
                ("bootstrap", bootstrap_carrier(n, 20, dev), p_dvs),
                ("flush", gap_chunk(20, False), p_dvs),
                ("frame", frame_rows, p_davis),
                ("gap to a frame", gap_chunk(255, True), p_davis)):
            e, want = check_rows_group(
                st, carrier, 2, p, f"multi {multi} {what}",
                groups=groups(carrier.shape[1], dev))
            st, err = want.state, max(err, e)
            n_events += int(want.per_interval.sum())
    if not n_events:
        raise AssertionError("the raster chunks emitted no event")
    st = forced_overflow_state(torch.full((n,), 128, dtype=torch.uint8,
                                          device=dev), n // 10,
                               depth=FR.DVS_DEPTH)
    e, want = check_rows_group(st, bootstrap_carrier(n, 20, dev), 2,
                               _dvs_params(1), "forced depth-16 overflow",
                               groups=groups(n, dev))
    if not (int(want.pmax) >> 16) & 1:
        raise AssertionError("the forced overflow did not overflow")
    return max(err, e)


# --- DVS lane groups by rows, and the scan ------------------------------------


def dvs_group_carrier(plan, lane_lo: int, lane_hi: int, device) -> torch.Tensor:
    """Lanes [lane_lo, lane_hi) of a plan as the (5, E) carrier on `device`."""
    return torch.from_numpy(
        FR.pack_dvs_plan(plan.lane_slice(lane_lo, lane_hi))).to(device)


def rows_carrier(pix, lane, gap_on, tick_on, gap_fv, gap_val, gap_n, tick_fv,
                 tick_int, ref_time: int = 20) -> np.ndarray:
    """Hand-made rows as the (5, E) carrier (`rows_plan`)."""
    return FR.pack_dvs_plan(rows_plan(pix, lane, gap_on, tick_on, gap_fv,
                                      gap_val, gap_n, tick_fv, tick_int,
                                      ref_time))


def rows_plan(pix, lane, gap_on, tick_on, gap_fv, gap_val, gap_n, tick_fv,
              tick_int, ref_time: int = 20) -> dvs_batch.DvsCompact:
    """Hand-made rows as a plan, with the planner's field definitions:
    gap_int = f32(gap_val) * f32(gap_n), gap_time = f32(gap_n * ref_time)."""
    gap_val = np.asarray(gap_val, np.float32)
    gap_n = np.asarray(gap_n, np.int64)
    E = len(gap_n)
    return dvs_batch.DvsCompact(
        np.asarray(pix, np.int32), np.asarray(lane, np.int32),
        np.asarray(gap_on, bool), np.asarray(gap_fv, np.int32),
        gap_val * gap_n.astype(np.float32),
        (gap_n * ref_time).astype(np.float32), np.asarray(tick_on, bool),
        np.asarray(tick_fv, np.int32), np.asarray(tick_int, np.float32),
        np.full(E, ref_time, np.float32), gap_val, gap_n)


def synthetic_rows(seed, n: int, lanes: int, density: float = 0.3,
                   flags=((1, 1), (0, 1), (1, 0), (0, 0)),
                   pixels=None) -> np.ndarray:
    """A seeded (5, E) carrier of `lanes` lanes: in each lane a random subset
    of the plane (or of `pixels`) in random order, so the pixels of a lane
    come unsorted; each row's (gap_on, tick_on) drawn from `flags`, so rows
    with one half off, or both, occur; random values and spans."""
    rng = np.random.default_rng(seed)
    pool = np.arange(n) if pixels is None else np.asarray(pixels)
    pix, lane = [], []
    for k in range(lanes):
        m = max(1, int(len(pool) * density))
        pix.append(rng.permutation(pool)[:m])
        lane.append(np.full(m, k))
    pix, lane = np.concatenate(pix), np.concatenate(lane)
    E = len(pix)
    on = np.asarray(flags)[rng.integers(0, len(flags), E)]
    return rows_carrier(
        pix, lane, on[:, 0] != 0, on[:, 1] != 0, rng.integers(0, 256, E),
        rng.uniform(0, 255, E), rng.integers(1, 3000, E),
        rng.integers(0, 256, E), rng.uniform(0, 255, E))


def check_rows_group(state: ops.PixelState, carrier: torch.Tensor, T: int,
                     p: ops.TranscodeParams, what: str, src: int = FR.SRC_DVS,
                     groups=None):
    """One lane group through its row wrapper (`dvs_rows_resident` for src
    FR.SRC_DVS, `davis_rows_resident` for FR.SRC_DAVIS; events and void)
    against its plain version on the same carrier and state, bit for bit,
    each returning the caller's state updated in place, and the grouping
    (the glue `group_dvs_rows`, or `groups` where given) against the glue's
    plain version. `state` is left as it was. Returns (the largest absolute
    difference, the plain result)."""
    E = carrier.shape[1]
    if src == FR.SRC_DVS:
        wrapper, plain, per_lane = (FR.dvs_rows_resident,
                                    FR.dvs_rows_resident_plain, 2)
    else:
        wrapper, plain, per_lane = (FR.davis_rows_resident,
                                    FR.davis_rows_resident_plain, 1)
    want = plain(state, carrier, T, p)
    want_void = want._replace(pixd=None, t=None)
    kw = {} if groups is None else {"groups": groups}
    err = 0.0
    if E:  # the grouping against the glue's plain version
        glue_plain = FR.group_dvs_rows_plain(carrier, T, per_lane)
        made = [("glue", FR.group_dvs_rows(carrier, T, per_lane,
                                           n=state.length.shape[0]))]
        if groups is not None:
            made.append(("given grouping", groups))
        for name, g in made:
            for field, a, b in zip(g._fields, g, glue_plain):
                if field == "row_start":  # the last slot is scratch
                    a, b = a[: E + 1], b[: E + 1]
                err = max(err, bitwise_max_err(a, b,
                                               f"{what} {name} {field}"))
    for events, ref in ((True, want), (False, want_void)):
        st = FR.clone_state(state)
        got = wrapper(st, carrier, T, p, events=events, **kw)
        if any(a is not b for a, b in zip(got.state, st)):
            raise AssertionError(f"{what}: the rows chunk did not return "
                                 f"the caller's state")
        err = max(err, compare_chunks(got, ref,
                                      f"{what} rows events {events}"))
    return err, want


def check_dvs_rows_against_plain(device, H: int = 150, W: int = 200,
                                 lanes=(1, 19, 64), seed: int = 0) -> float:
    """The K3 row kernel against its plain version, bit for bit
    (`check_rows_group`): for Normal and Collapse, from
    the state after the bootstrap chunk, two chained groups of T = 2 L
    sub-steps for each lane count L, planned by the port's planner from a
    seeded stream; then a forced depth-16 overflow in a group of one row per
    pixel, a group with no rows, a group whose rows sit in one pixel, and a
    hand-made group of unsorted rows with one half or both off. Raises on
    any difference; returns the largest absolute difference (0.0)."""
    from .transcoder.prophesee import bootstrap_carrier

    dev = torch.device(device)
    n = H * W
    need = 2 * sum(lanes)
    plan = _check_plan(seed, W, H, need)
    boot = bootstrap_carrier(n, 20, dev)
    err = 0.0
    for multi in (0, 1):
        p = _dvs_params(multi)
        st = FR.dvs_rows_resident_plain(
            ops.init_state(n, dev, c_thresh=3, depth=FR.DVS_DEPTH), boot, 2,
            p).state
        lo = 0
        for L in lanes:
            for rep in range(2):
                e, want = check_rows_group(
                    st, dvs_group_carrier(plan, lo, lo + L, dev), 2 * L, p,
                    f"multi {multi} T {2 * L} group {rep}")
                st, err = want.state, max(err, e)
                lo += L
        top = max(lanes)
        hot = int(np.bincount(plan.pix).argmax())
        cases = (
            ("no rows", np.zeros((5, 0), np.int32), 2),
            ("one pixel", synthetic_rows(seed + 1, n, top, flags=((1, 1),),
                                         pixels=[hot]), 2 * top),
            ("halves off", synthetic_rows(seed + 2, n, min(top, 6)),
             2 * min(top, 6)),
        )
        for what, rows, T in cases:
            e, _ = check_rows_group(st, torch.from_numpy(rows).to(dev), T, p,
                                    f"multi {multi} {what}")
            err = max(err, e)
    st = forced_overflow_state(torch.full((n,), 128, dtype=torch.uint8,
                                          device=dev), n // 10,
                               depth=FR.DVS_DEPTH)
    ones = np.ones(n, bool)
    every = rows_carrier(np.arange(n), np.zeros(n), ones, ones,
                         np.full(n, 128), np.full(n, 128.0), np.ones(n),
                         np.full(n, 128), np.full(n, 128.0))
    e, want = check_rows_group(st, torch.from_numpy(every).to(dev), 2,
                               _dvs_params(1), "forced depth-16 overflow")
    if not (int(want.pmax) >> 16) & 1:
        raise AssertionError("the forced overflow did not overflow")
    return max(err, e)


# --- DVS lane groups on the 8-byte carrier ------------------------------------


def lattice_plan(seed, n: int, lanes: int, density: float = 0.3,
                 flags=((1, 1), (0, 1), (1, 0), (0, 0)), pixels=None,
                 n_values: int = 8, gap_n=(1, 3000),
                 ref_time: int = 20) -> dvs_batch.DvsCompact:
    """A seeded plan of `lanes` lanes with the planner's field definitions,
    whose held and new values come from a lattice of `n_values` (value,
    fv) pairs, so it fits the 8-byte carrier's dictionary when n_values <=
    64 and not beyond: in each lane a random subset of the plane (or of
    `pixels`) in random order; each row's (gap_on, tick_on) drawn from
    `flags`; gap_n uniform in the closed range `gap_n`. The dictionary of
    `FR.pack_dvs_plan8` holds every pair that the rows draw."""
    rng = np.random.default_rng(seed)
    pool = np.arange(n) if pixels is None else np.asarray(pixels)
    pix, lane = [], []
    for k in range(lanes):
        m = max(1, int(len(pool) * density))
        pix.append(rng.permutation(pool)[:m])
        lane.append(np.full(m, k))
    pix, lane = np.concatenate(pix), np.concatenate(lane)
    E = len(pix)
    on = np.asarray(flags)[rng.integers(0, len(flags), E)]
    vals = np.float32(np.sort(rng.choice(25_500, n_values, replace=False))
                      / 100.0)
    fvs = vals.astype(np.int32)
    gi, ti = rng.integers(0, n_values, E), rng.integers(0, n_values, E)
    gi[: min(E, n_values)] = np.arange(min(E, n_values))  # every pair drawn
    gn = rng.integers(gap_n[0], gap_n[1] + 1, E).astype(np.int64)
    gv = vals[gi]
    return dvs_batch.DvsCompact(
        pix.astype(np.int32), lane.astype(np.int32), on[:, 0] != 0,
        fvs[gi], gv * gn.astype(np.float32),
        (gn * ref_time).astype(np.float32), on[:, 1] != 0, fvs[ti],
        vals[ti], np.full(E, ref_time, np.float32), gv, gn)


def carriers(plan, n: int, device, ref_time: int = 20):
    """The rows of a plan as both carriers on `device`: ((2, E + 64) 8-byte
    carrier, pb, (5, E) 20-byte carrier). Raises when the rows do not fit
    the 8-byte layout; a plan of no rows gives an 8-byte carrier of the
    dictionary alone."""
    if len(plan.pix) == 0:
        c8, pb = np.zeros((2, FR.DICT_CAP), np.int32), FR.pix_bits(n)
    else:
        packed = FR.pack_dvs_plan8(plan, n, ref_time)
        if packed is None:
            raise AssertionError("the rows do not fit the 8-byte carrier")
        c8, pb = packed
    return (torch.from_numpy(c8).to(device), pb,
            torch.from_numpy(FR.pack_dvs_plan(plan)).to(device))


def check_rows8_group(state: ops.PixelState, plan, n: int, T: int,
                      p: ops.TranscodeParams, what: str, want=None):
    """One lane group on the 8-byte carrier (`dvs_rows8_resident`: events,
    void, and events with the capacity the Prophesee path gives it, the
    caller's state updated in place) against its plain version on the same
    carrier (`want`, where the caller has run it), bit for bit; the 20-byte
    route on the same rows (`dvs_rows_resident`, the kernel on the card)
    against the same; the 8-byte glue against its plain version and
    against the 20-byte carrier's grouping. `state` is left as it was.
    Returns (the largest absolute difference, the plain result)."""
    dev = state.length.device
    c8, pb, c20 = carriers(plan, n, dev, p.ref_time)
    if want is None:
        want = FR.dvs_rows8_resident_plain(state, c8, T, p, pb=pb)
    err = 0.0
    E = len(plan.pix)
    if E:  # the 8-byte grouping: its plain version, the 20-byte one's
        g20 = FR.group_dvs_rows_plain(c20, T)
        for name, g in (("glue", FR.group_dvs_rows(c8, T, 2, pb, n=n)),
                        ("plain glue", FR.group_dvs_rows_plain(c8, T, 2,
                                                               pb))):
            for field, a, b in zip(g._fields, g, g20):
                if field == "row_start":  # the last slot is scratch
                    a, b = a[: E + 1], b[: E + 1]
                err = max(err, bitwise_max_err(
                    a, b, f"{what} 8-byte {name} {field}"))
    cap = (FR.DVS_DEPTH + 3) * int(plan.gap_on.sum() + plan.tick_on.sum())
    runs = ((FR.dvs_rows8_resident, c8, {"pb": pb}, True, None),
            (FR.dvs_rows8_resident, c8, {"pb": pb}, False, None),
            (FR.dvs_rows8_resident, c8, {"pb": pb}, True, cap),
            (FR.dvs_rows_resident, c20, {}, True, cap))
    for fn, carrier, kw, events, ev_cap in runs:
        st = FR.clone_state(state)
        got = fn(st, carrier, T, p, events=events, event_cap=ev_cap, **kw)
        if any(a is not b for a, b in zip(got.state, st)):
            raise AssertionError(f"{what}: the rows chunk did not return "
                                 f"the caller's state")
        ref = want if events else want._replace(pixd=None, t=None)
        err = max(err, compare_chunks(
            got, ref, f"{what} {fn.__name__} events {events} cap {ev_cap}"))
    return err, want


def check_dvs_rows8_against_plain(device, H: int = 150, W: int = 200,
                                  lanes=(1, 19, 64), seed: int = 0,
                                  big=(480, 640)) -> float:
    """The K3 row kernel on the 8-byte carrier (`adder_dvs_rows8`) against
    its plain version and against the 20-byte route, bit for bit
    (`check_rows8_group`): for Normal and Collapse, from the state after
    the bootstrap, two chained groups of T = 2 L sub-steps for each lane
    count L, planned by the port's planner from a seeded stream (packed by
    `FR.pack_dvs_plan8`); a group with no rows; one whose rows sit in one
    pixel; rows with one half or both off; a dictionary of exactly 64
    entries; gap_n past 2^20 (its hi/lo split); a forced depth-16 overflow;
    the planned groups on a small ragged plane and, unless `big` is None,
    on a plane of `big` (H, W) (pb 19 at 480 x 640). Raises on any difference; returns the largest
    absolute difference (0.0)."""
    from .transcoder.prophesee import bootstrap_carrier

    dev = torch.device(device)
    err = 0.0
    planes = [(H, W, lanes), (47, 61, (3,))] + ([(*big, (2,))] if big else [])
    for h, w, ls in planes:
        n = h * w
        plan = _check_plan(seed, w, h, 2 * sum(ls))
        boot = bootstrap_carrier(n, 20, dev)
        for multi in (0, 1):
            p = _dvs_params(multi)
            st = FR.dvs_rows_resident_plain(
                ops.init_state(n, dev, c_thresh=3, depth=FR.DVS_DEPTH), boot,
                2, p).state
            lo = 0
            for L in ls:
                for rep in range(2):
                    e, want = check_rows8_group(
                        st, plan.lane_slice(lo, lo + L), n, 2 * L, p,
                        f"{w}x{h} multi {multi} T {2 * L} group {rep}")
                    st, err = want.state, max(err, e)
                    lo += L
            if (h, w) != (H, W):
                continue
            top = max(ls)
            hot = int(np.bincount(plan.pix).argmax())
            cases = (
                ("no rows", lattice_plan(seed, n, 1, density=0.0), 2),
                ("one pixel", lattice_plan(seed + 1, n, top, flags=((1, 1),),
                                           pixels=[hot]), 2 * top),
                ("halves off", lattice_plan(seed + 2, n, 6), 12),
                ("dictionary of 64", lattice_plan(seed + 3, n, 4,
                                                  n_values=64), 8),
                ("gap_n past 2^20", lattice_plan(
                    seed + 4, n, 2, gap_n=(1 << 20, (1 << 20) + 50_000)), 4),
            )
            for what, g, T in cases:
                if what == "no rows":
                    g = g.lane_slice(1, 1)
                e, _ = check_rows8_group(st, g, n, T, p,
                                         f"{w}x{h} multi {multi} {what}")
                err = max(err, e)
            if FR.pack_dvs_plan8(lattice_plan(seed + 3, n, 4, n_values=65),
                                 n, 20) is not None:
                raise AssertionError("a dictionary of 65 entries fitted")
    n = H * W
    st = forced_overflow_state(torch.full((n,), 128, dtype=torch.uint8,
                                          device=dev), n // 10,
                               depth=FR.DVS_DEPTH)
    ones = np.ones(n, bool)
    every = rows_plan(np.arange(n), np.zeros(n), ones, ones, np.full(n, 128),
                      np.full(n, 128.0), np.ones(n), np.full(n, 128),
                      np.full(n, 128.0))
    e, want = check_rows8_group(st, every, n, 2, _dvs_params(1),
                                "forced depth-16 overflow")
    if not (int(want.pmax) >> 16) & 1:
        raise AssertionError("the forced overflow did not overflow")
    return max(err, e)


SCAN_SIZES = (0, 1, 37, 4096, 4097, 129_600, 524_288)


def check_scan_against_plain(device, sizes=SCAN_SIZES, seed: int = 0) -> float:
    """`exclusive_scan` against `exclusive_scan_plain` at every size, on
    counts below 16,384 (the total of the largest size passes 2^31), and at
    each size once more on a view that starts 4 bytes past a 16-byte
    boundary. Raises on any difference; returns the
    largest absolute difference (0.0)."""
    dev = torch.device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    err = 0.0
    for size in sizes:
        counts = torch.randint(0, 16384, (size + 1,), generator=gen,
                               dtype=torch.int32)
        want = FR.exclusive_scan_plain(counts[:size])
        if size == max(sizes) and size >= 524_288 and int(want[-1]) <= 2 ** 31:
            raise AssertionError("the largest scan stays below 2^31")
        on_dev = counts.to(dev)
        err = max(err, bitwise_max_err(
            FR.exclusive_scan(on_dev[:size]).cpu(), want, f"scan of {size}"))
        err = max(err, bitwise_max_err(
            FR.exclusive_scan(on_dev[1:]).cpu(),
            FR.exclusive_scan_plain(counts[1:]), f"scan of {size}, unaligned"))
    return err


# --- DAVIS (aedat4 -> EDI -> Davis) inputs and checks --------------------------


DAVIS_BAR_WIDTH = 24  # pixels
DAVIS_BACKGROUND, DAVIS_BAR = 60.0, 200.0  # grey levels


def davis_stream(seed, W: int, H: int, duration_us: int, n_frames: int,
                 exposure_us: int, n_hot: int = 0, hot_events: int = 0,
                 edge_events: int = 0, background_events: int = 0):
    """A seeded DAVIS scene: a DAVIS_BAR_WIDTH-pixel vertical bar of
    DAVIS_BAR on a DAVIS_BACKGROUND grey sweeping the width once over
    `duration_us`.

    Returns (events, frames). events = (t int64 us sorted, x int16, y int16,
    on int8): `n_hot` hot pixels with `hot_events` events each, random
    polarity; `edge_events` on the bar's edges, ON at the leading edge and
    OFF at the trailing one; `background_events` uniform events of random
    polarity. frames = [(t, exposure_begin, exposure_end, (H, W) u8)]: one
    every duration / n_frames, the last exposure ending at `duration_us`,
    each the scene averaged over its exposure."""
    rng = np.random.default_rng(seed)
    bar_width = DAVIS_BAR_WIDTH
    span = W - bar_width

    def bar_x(t):
        return np.asarray(t, np.float64) * span / max(duration_us, 1)

    hot = rng.choice(W * H, n_hot, replace=False)
    hot_pix = np.repeat(hot, hot_events)
    t_hot = rng.integers(0, duration_us, len(hot_pix))
    on_hot = rng.integers(0, 2, len(hot_pix))
    t_edge = rng.integers(0, duration_us, edge_events)
    lead = rng.random(edge_events) < 0.5
    col = np.where(lead, bar_x(t_edge) + bar_width, bar_x(t_edge))
    col = np.clip(col.astype(np.int64) + rng.integers(0, 2, edge_events),
                  0, W - 1)
    edge_pix = rng.integers(0, H, edge_events) * W + col
    bg_pix = rng.integers(0, W * H, background_events)
    t_bg = rng.integers(0, duration_us, background_events)
    on_bg = rng.integers(0, 2, background_events)
    pix = np.concatenate([hot_pix, edge_pix, bg_pix]).astype(np.int64)
    t = np.concatenate([t_hot, t_edge, t_bg]).astype(np.int64)
    on = np.concatenate([on_hot, lead, on_bg]).astype(np.int8)
    order = np.argsort(t, kind="stable")
    t, pix, on = t[order], pix[order], on[order]
    events = (t, (pix % W).astype(np.int16), (pix // W).astype(np.int16), on)

    period = duration_us // n_frames
    cols = np.arange(W, dtype=np.float64)
    frames = []
    for i in range(n_frames):
        end = (i + 1) * period if i + 1 < n_frames else duration_us
        begin = end - exposure_us
        samples = np.linspace(begin, end, 16, endpoint=False)
        x0 = bar_x(samples)[:, None]
        cover = ((cols >= x0) & (cols < x0 + bar_width)).mean(axis=0)
        row = DAVIS_BACKGROUND + (DAVIS_BAR - DAVIS_BACKGROUND) * cover
        img = np.repeat(row[None, :], H, axis=0).astype(np.uint8)
        frames.append(((begin + end) // 2, begin, end, img))
    return events, frames


def write_davis_aedat4(path, W: int, H: int, events, frames,
                       compression: int = 0) -> None:
    """Write `davis_stream`'s output as an aedat4 file: before each frame,
    one event packet with the events up to the frame's exposure end."""
    from .utils.aedat4 import Aedat4Writer

    t, x, y, on = events
    w = Aedat4Writer(path, W, H, compression=compression)
    try:
        lo = 0
        for ft, begin, end, img in frames:
            hi = int(np.searchsorted(t, end))
            if hi > lo:
                w.write_events(t[lo:hi], x[lo:hi], y[lo:hi], on[lo:hi])
            w.write_frame(ft, begin, end, img)
            lo = hi
    finally:
        w.close()


def _davis_params(multi_mode: int) -> ops.TranscodeParams:
    """The DAVIS CLI's time base (ref_time 255, delta_t_max 3921 x 255)
    with an adapting c_thresh, so the per-pixel increment is exercised."""
    return ops.TranscodeParams(mode=1, multi_mode=multi_mode, time_mode=1,
                               ref_time=255, delta_t_max=3921 * 255,
                               c_thresh_max=6, c_increase_velocity=2)


def davis_plan(seed, W: int, H: int, lanes: int) -> dvs_batch.DavisCompact:
    """A seeded burst planned by the port's DAVIS planner into at least
    `lanes` lanes: a hot pixel with `lanes` + 8 events and a quarter of the
    plane in background events, on chains that start active."""
    n = W * H
    ts, xs, ys, ps = dvs_stream(seed, W, H, 200_000, n_hot=3,
                                hot_events=lanes + 8,
                                background_events=max(n // 4, 64))
    last_t = np.ones(n, np.int64)
    last_ln = np.full(n, np.log1p(0.5), np.float64)
    plan = dvs_batch.plan_davis_events_compact(
        ts.astype(np.int64), xs, ys, ps != 0, W, last_t, last_ln, 0.15, 255,
        255.0)
    if plan.n_lanes < lanes:
        raise AssertionError(f"burst planned {plan.n_lanes} lanes < {lanes}")
    return plan


def davis_group_planes(plan, lane_lo: int, lane_hi: int, n: int, device):
    """Lanes [lane_lo, lane_hi) of a DAVIS plan as (T, n) planes on
    `device`, through the carrier the Davis path ships."""
    carrier = davis_group_carrier(plan, lane_lo, lane_hi, device)
    return FR.build_davis_planes(lane_hi - lane_lo, n,
                                 *FR.unpack_davis_carrier(carrier))


def davis_group_carrier(plan, lane_lo: int, lane_hi: int,
                        device) -> torch.Tensor:
    """Lanes [lane_lo, lane_hi) of a DAVIS plan as the (5, E) carrier on
    `device`."""
    return torch.from_numpy(
        FR.pack_davis_plan(plan.lane_slice(lane_lo, lane_hi))).to(device)


def davis_rows(seed, pix, lane, active=None) -> np.ndarray:
    """Hand-made DAVIS rows at (pix, lane) as the (5, E) carrier, with
    seeded values in the planner's ranges: first_int over a gap of 1 to
    40,000 us at 255 ticks per us, fval in [0, 255] and fv8 its
    truncation; every row active unless `active` says otherwise."""
    rng = np.random.default_rng(seed)
    E = len(pix)
    dt = rng.integers(1, 40_000, E).astype(np.float64) * 255.0
    fval = rng.uniform(0.0, 255.0, E)
    plan = dvs_batch.DavisCompact(
        np.asarray(pix, np.int32), np.asarray(lane, np.int32),
        np.ones(E, bool) if active is None else np.asarray(active, bool),
        (rng.uniform(0.0, 255.0, E) / 255 * dt).astype(np.float32),
        dt.astype(np.float32), fval.astype(np.float32),
        fval.astype(np.int64).astype(np.int32))
    return FR.pack_davis_plan(plan)


def check_davis_rows_against_plain(device, H: int = 47, W: int = 61,
                                   lanes=(1, 37, 128),
                                   seed: int = 0) -> float:
    """The K4 row kernel (`davis_rows_resident`, events and void) against its
    plain version on the same carrier and state, bit for bit, and the
    grouping glue with one sub-step per lane against its plain version
    (`check_rows_group`): for Normal and Collapse and each lane count T, two
    chained groups of T lanes planned by the port's DAVIS planner from a
    seeded burst on a ragged plane; a group with no rows, a planned group
    with a seeded half of its rows inactive, and a group of 64 lanes whose
    rows sit in one pixel; then a forced depth-16 overflow in a group of one
    row per pixel. Raises on any difference; returns the largest absolute
    difference (0.0)."""
    dev = torch.device(device)
    n = H * W
    plan = davis_plan(seed, W, H, 2 * sum(lanes))
    rng = np.random.default_rng(seed + 1)
    err = 0.0

    def check(st, carrier, T, p, what):
        e, want = check_rows_group(st, carrier, T, p, what, FR.SRC_DAVIS)
        return want.state, e

    for multi in (0, 1):
        p = _davis_params(multi)
        st = ops.init_state(n, dev, c_thresh=3, depth=FR.DVS_DEPTH)
        lo = 0
        for L in lanes:
            for rep in range(2):
                st, e = check(st, davis_group_carrier(plan, lo, lo + L, dev),
                              L, p, f"multi {multi} T {L} group {rep}")
                err, lo = max(err, e), lo + L
        g = plan.lane_slice(0, 8)
        half = g._replace(active=rng.random(len(g.pix)) < 0.5)
        hot = int(np.bincount(plan.pix).argmax())
        cases = (
            ("no rows", np.zeros((5, 0), np.int32), 2),
            ("inactive rows", FR.pack_davis_plan(half), 8),
            ("one pixel", davis_rows(seed + 2, np.full(64, hot),
                                     rng.permutation(64)), 64),
        )
        for what, rows, T in cases:
            st, e = check(st, torch.from_numpy(rows).to(dev), T, p,
                          f"multi {multi} {what}")
            err = max(err, e)
    st = forced_overflow_state(torch.full((n,), 128, dtype=torch.uint8,
                                          device=dev), n // 10,
                               depth=FR.DVS_DEPTH)
    every = FR.pack_davis_plan(dvs_batch.DavisCompact(
        np.arange(n, dtype=np.int32), np.zeros(n, np.int32), np.ones(n, bool),
        np.full(n, 1000.0, np.float32), np.full(n, 255.0, np.float32),
        np.full(n, 128.0, np.float32), np.full(n, 128, np.int32)))
    e, want = check_rows_group(st, torch.from_numpy(every).to(dev), 1,
                               _davis_params(1), "forced depth-16 overflow",
                               FR.SRC_DAVIS)
    if not (int(want.pmax) >> 16) & 1:
        raise AssertionError("the forced overflow did not overflow")
    return max(err, e)


# --- the grouping of the row route -------------------------------------------


def group_keys_carrier(lane, pix, form: str, n: int, seed: int = 0):
    """Rows at (lane, pix) as a carrier whose row 0 holds their keys and
    whose other words are seeded garbage: form "20" the (5, E) DVS carrier
    (lane << 20 | pix, random on bits above), "davis" the (5, E) DAVIS
    carrier (one sub-step a lane), "8" the (2, E + DICT_CAP) 8-byte carrier
    of a plane of n pixels (pix in its pb bits, the lane in the 6 above,
    random bits past them). Returns (CPU carrier, per_lane, pb or None)."""
    rng = np.random.default_rng(seed)
    lane = np.asarray(lane, np.int64)
    pix = np.asarray(pix, np.int64)
    E = len(lane)
    if form == "8":
        pb = FR.pix_bits(n)
        hi = pb + 6
        w0 = pix | lane << pb | rng.integers(0, 1 << (32 - hi), E) << hi
        width, per_lane = E + FR.DICT_CAP, 2
    else:
        pb = None
        w0 = pix | lane << 20 | rng.integers(0, 32, E) << 27
        width, per_lane = E, 1 if form == "davis" else 2
    c = rng.integers(-2 ** 31, 2 ** 31, (5 if pb is None else 2, width))
    c[0, :E] = w0
    c = (c & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return torch.from_numpy(c), per_lane, pb


def group_reference(lane, pix, T: int, per_lane: int, n: int) -> tuple:
    """The fields of `FR.RowGroups` for rows at (lane, pix), as numpy
    int64, from their definitions alone: `order` by np.lexsort on (pixel,
    lane), the runs of each pixel, and every cell (a row's sub-step
    per_lane x lane + h, h < per_lane) ranked by (sub-step, pixel) with
    `sub_start` the first rank of each sub-step. row_start's last slot
    (scratch) is E here."""
    lane = np.asarray(lane, np.int64)
    pix = np.asarray(pix, np.int64)
    E = len(lane)
    order = np.lexsort((lane, pix))
    sp = pix[order]
    starts = np.flatnonzero(np.r_[True, sp[1:] != sp[:-1]])
    row_start = np.full(E + 2, E, np.int64)
    row_start[:len(starts)] = starts
    sub = np.concatenate([per_lane * lane + h for h in range(per_lane)])
    keys = sub * n + np.tile(pix, per_lane)
    rank = np.empty(per_lane * E, np.int64)
    rank[np.argsort(keys)] = np.arange(per_lane * E)
    tick = rank[E:] if per_lane == 2 else np.zeros(0, np.int64)
    sub_start = np.searchsorted(np.sort(sub), np.arange(T + 1))
    return (order, row_start, np.array([len(starts)], np.int64), rank[:E],
            tick, sub_start.astype(np.int64))


# The grouping's cases: (form, n, T, how the rows are drawn)
ROW_GROUP_CASES = {
    "20-byte": ("20", 300, 128, "random"),
    "8-byte pb 8": ("8", 256, 20, "random"),
    "8-byte pb 19": ("8", 640 * 480, 128, "random"),
    "8-byte pb 20": ("8", 1 << 20, 128, "last pixel"),
    "DAVIS lanes to 127": ("davis", 97, 128, "random"),
    "E = 1 20-byte": ("20", 50, 6, "one row"),
    "E = 1 8-byte": ("8", 50, 6, "one row"),
    "E = 1 DAVIS": ("davis", 50, 128, "one row"),
    "one pixel": ("20", 40, 128, "one pixel"),
    "one pixel DAVIS": ("davis", 40, 128, "one pixel"),
    "one lane": ("8", 200, 64, "one lane"),
    "every lane and pixel": ("20", 13, 16, "full"),
    "every lane and pixel DAVIS": ("davis", 13, 128, "full"),
    "pixel n - 1": ("8", 777, 128, "last pixel"),
    "shuffled DAVIS": ("davis", 500, 100, "random"),
    "T = 128 group": ("8", 640 * 480, 128, "group"),
    "T = 128 group, 20 bytes": ("20", 640 * 480, 128, "group"),
}


def row_group_rows(case: str, seed: int = 0):
    """(lane, pix, T, form, n) of a grouping case: each (lane, pixel) at
    most once, the rows in a seeded random order."""
    form, n, T, how = ROW_GROUP_CASES[case]
    lanes = T // (1 if form == "davis" else 2)
    rng = np.random.default_rng(seed)
    if how == "one row":
        lane, pix = [lanes - 1], [n - 1]
    elif how == "one pixel":
        lane, pix = np.arange(lanes), np.full(lanes, n // 2)
    elif how == "one lane":
        lane, pix = np.full(n, 3), np.arange(n)
    elif how == "full":
        lane, pix = np.divmod(np.arange(lanes * n), n)
    else:
        # random unique (lane, pixel); "group": about 250,000 rows, as the
        # main path's T = 128 group at 640 x 480; "last pixel": pixel n - 1
        # in every lane as well
        E = {"group": 250_000, "random": min(lanes * n // 3, 20_000),
             "last pixel": 20_000}[how]
        flat = rng.choice(lanes * n, E, replace=False)
        if how == "last pixel":
            flat = np.union1d(flat, np.arange(lanes) * n + n - 1)
        else:  # the last lane too
            flat = np.union1d(flat, (lanes - 1) * n + np.arange(min(n, 5)))
        lane, pix = np.divmod(flat, n)
    lane, pix = np.asarray(lane, np.int64), np.asarray(pix, np.int64)
    perm = rng.permutation(len(lane))
    return lane[perm], pix[perm], T, form, n


def check_group_against_reference(device, case: str, seed: int = 0) -> float:
    """`FR.group_dvs_rows` on `device` (the grouping kernels on the card,
    the plain version on the CPU) and `FR.group_dvs_rows_plain` against
    `group_reference`, every field bit for bit (row_start's last slot is
    scratch); on the card with the plane's n. Raises on a difference;
    returns the largest absolute difference (0.0)."""
    lane, pix, T, form, n = row_group_rows(case, seed)
    carrier, per_lane, pb = group_keys_carrier(lane, pix, form, n, seed)
    carrier = carrier.to(device)
    want = group_reference(lane, pix, T, per_lane, n)
    E = len(lane)
    err = 0.0
    for name, g in (("kernel", FR.group_dvs_rows(carrier, T, per_lane, pb,
                                                  n=n)),
                    ("plain", FR.group_dvs_rows_plain(carrier, T, per_lane,
                                                      pb))):
        for field, a, b in zip(FR.RowGroups._fields, g, want):
            if a.dtype != torch.int64 or a.device != carrier.device:
                raise AssertionError(f"{case} {name} {field}: {a.dtype} on "
                                     f"{a.device}")
            if field == "row_start":
                a, b = a[: E + 1], b[: E + 1]
            err = max(err, bitwise_max_err(a, torch.from_numpy(b).to(device),
                                           f"{case} {name} {field}"))
    return err


# --- the row walk's compaction (one pass: stage, scan, copy) -----------------


def row_cell_keys(carrier: torch.Tensor, n: int, per_lane: int,
                  pb: Optional[int] = None) -> torch.Tensor:
    """Sorted (C,) int64 `sub-step * n + pix` of a carrier's cells, a cell
    being one row's gap or tick half (DVS, per_lane 2) or one row (DAVIS):
    the rank of a cell in this order is its index in the row walk's
    `cell_counts` and staging."""
    key = FR.row_keys_plain(carrier, pb).to(torch.int64)
    lane, pix = key >> 20, key & 0xFFFFF
    subs = [per_lane * lane + h for h in range(per_lane)]
    return torch.sort(torch.cat([s * n + pix for s in subs]))[0]


def stage_rows(want: FR.ChunkResult, carrier: torch.Tensor, n: int,
               per_lane: int, pb: Optional[int] = None, seed: int = 0):
    """What the one-pass row walk leaves for a lane group whose plain result
    is `want`: (stage, counts) as CPU tensors, the staging slot-major, cell
    c's k-th event (k < counts[c]) in entry k C + c (pix << 8 | d in the
    low 32 bits, t above), every other entry seeded garbage."""
    keys = row_cell_keys(carrier.cpu(), n, per_lane, pb)
    C = keys.numel()
    T = want.per_interval.numel()
    pixd = want.pixd.cpu().to(torch.int64) & 0xFFFFFFFF
    t = want.t.cpu().to(torch.int64) & 0xFFFFFFFF
    sub = torch.repeat_interleave(torch.arange(T),
                                  want.per_interval.cpu().to(torch.int64))
    ekey = sub * n + (pixd >> 8)
    cell = torch.searchsorted(keys, ekey)
    if C and not torch.equal(keys[cell.clamp(max=C - 1)], ekey):
        raise AssertionError("an event outside the carrier's cells")
    counts = torch.bincount(cell, minlength=C).to(torch.int32)
    first = torch.cumsum(counts.to(torch.int64), 0) - counts
    at = (torch.arange(len(cell)) - first[cell]) * C + cell
    rng = np.random.default_rng(seed)
    stage = torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62,
                                          C * FR.ROW_SLOTS))
    stage[at] = pixd | (t << 32)
    return stage, counts


ROW_COPY_LANES = (1, 19, 64)  # DVS lanes of the copy checks: T 2, 38, 128


def check_rows_copy_against_plain(device, H: int = 13, W: int = 19,
                                  lanes=ROW_COPY_LANES,
                                  seed: int = 0) -> float:
    """The row walk's compaction (`FR.rows_copy`: `adder_rows_copy` on the
    card, `rows_copy_plain` on the CPU) against the events of the plain
    route, bit for bit, on the staging `stage_rows` makes of them: for
    Normal and Collapse, chained DVS lane groups of T = 2 L for each lane
    count L (8-byte carrier, planned from a seeded stream), a DAVIS group
    of T = max(lanes) lanes, at the exact capacity, at half of it (the
    first events, the total exact) and at none; a group with no rows. On
    the card also the walk itself (`FR.rows_walk`): its cell counts, its
    staged events and its state equal the harness's and the plain
    version's. Raises on any difference; returns the largest absolute
    difference (0.0)."""
    from .transcoder.prophesee import bootstrap_carrier

    dev = torch.device(device)
    n = H * W
    plan = _check_plan(seed, W, H, 2 * sum(lanes))
    dplan = davis_plan(seed, W, H, max(lanes))
    err = 0.0

    def check(state, carrier, T, p, what, src, pb=None):
        per_lane = 1 if src == FR.SRC_DAVIS else 2
        plain = {FR.SRC_DVS8: lambda: FR.dvs_rows8_resident_plain(
                     state, carrier, T, p, pb=pb),
                 FR.SRC_DAVIS: lambda: FR.davis_rows_resident_plain(
                     state, carrier, T, p)}[src]
        want = plain()
        stage, counts = stage_rows(want, carrier, n, per_lane, pb, seed)
        total = int(want.per_interval.sum())
        e = 0.0
        offsets = FR.exclusive_scan(counts.to(dev))
        # the kernel takes at least one cell: a group of no rows launches
        # neither the walk nor the copy
        copies = ((FR.rows_copy, FR.rows_copy_plain) if counts.numel()
                  else (FR.rows_copy_plain,))
        for cap in (total, total // 2, 0):
            for copy in copies:
                got = copy(stage.to(dev), counts.to(dev), offsets, cap)
                for f, a in zip(("pixd", "t"), got):
                    if a.numel() != cap:
                        raise AssertionError(f"{what} {copy.__name__} cap "
                                             f"{cap}: {a.numel()} entries")
                    e = max(e, bitwise_max_err(
                        a, getattr(want, f)[:cap].to(dev),
                        f"{what} {copy.__name__} cap {cap} {f}"))
        if dev.type == "cuda":
            st = FR.clone_state(state)
            walk = FR.rows_walk(src, st, carrier, T, p, True, pb=pb)
            if walk is None:
                if counts.numel():
                    raise AssertionError(f"{what}: no walk for "
                                         f"{counts.numel()} cells")
            else:
                slot = torch.arange(FR.ROW_SLOTS, device=dev)
                filled = (slot[:, None]
                          < walk.cell_counts[None, :]).reshape(-1)
                e = max(e, bitwise_max_err(walk.cell_counts, counts.to(dev),
                                           f"{what} walk cell counts"),
                        bitwise_max_err(walk.stage[filled],
                                        stage.to(dev)[filled],
                                        f"{what} walk staging"),
                        state_max_err(st, want.state, f"{what} walk state"))
        return want.state, e

    for multi in (0, 1):
        p = _dvs_params(multi)
        st = FR.dvs_rows_resident_plain(
            ops.init_state(n, dev, c_thresh=3, depth=FR.DVS_DEPTH),
            bootstrap_carrier(n, 20, dev), 2, p).state
        lo = 0
        for L in lanes:
            c8, pb, _ = carriers(plan.lane_slice(lo, lo + L), n, dev)
            st, e = check(st, c8, 2 * L, p, f"multi {multi} T {2 * L}",
                          FR.SRC_DVS8, pb)
            err, lo = max(err, e), lo + L
        c8, pb, _ = carriers(lattice_plan(seed, n, 1, density=0.0)
                             .lane_slice(1, 1), n, dev)
        _, e = check(st, c8, 2, p, f"multi {multi} no rows", FR.SRC_DVS8, pb)
        err = max(err, e)
        pd = _davis_params(multi)
        sd = ops.init_state(n, dev, c_thresh=3, depth=FR.DVS_DEPTH)
        L = max(lanes)
        _, e = check(sd, davis_group_carrier(dplan, 0, L, dev), L, pd,
                     f"multi {multi} DAVIS T {L}", FR.SRC_DAVIS)
        err = max(err, e)
    return err


def check_rows_copy_counts(device, cells: int = 4099, seed: int = 0) -> float:
    """`FR.rows_copy` (the kernel on the card, the plain version on the CPU)
    and `FR.rows_copy_plain` against a numpy copy of a seeded slot-major
    staging whose cells hold 0 to ROW_SLOTS events (every count, in a
    shuffled order, warps of empty cells among them), at the exact
    capacity, at capacities that fall inside a cell and between two, at
    none, and past the total. Raises on a difference; returns the largest
    absolute difference (0.0)."""
    rng = np.random.default_rng(seed)
    counts = rng.permutation(np.arange(cells) % (FR.ROW_SLOTS + 1))
    counts[64:160] = 0  # three whole warps of empty cells
    stage = rng.integers(-2 ** 63, 2 ** 63 - 1, cells * FR.ROW_SLOTS)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    total = int(offsets[-1])
    cell = np.repeat(np.arange(cells), counts)
    slot = np.arange(total) - offsets[cell]
    words = stage[slot * cells + cell].view(np.int32).reshape(-1, 2)
    mid = int(np.flatnonzero(counts > 4)[len(counts) // 3])
    dev = torch.device(device)
    args = (torch.from_numpy(stage).to(dev),
            torch.from_numpy(counts.astype(np.int32)).to(dev),
            torch.from_numpy(offsets.astype(np.int64)).to(dev))
    err = 0.0
    for cap in (total, int(offsets[mid]) + 3, int(offsets[mid]), 0,
                total + 7, 1):
        n = min(cap, total)
        for copy in (FR.rows_copy, FR.rows_copy_plain):
            got = copy(*args, cap)
            for f, a, want in zip(("pixd", "t"), got, words.T):
                if a.numel() != cap:
                    raise AssertionError(f"{copy.__name__} cap {cap}: "
                                         f"{a.numel()} entries")
                err = max(err, bitwise_max_err(
                    a[:n], torch.from_numpy(np.ascontiguousarray(want[:n]))
                    .to(dev), f"{copy.__name__} cap {cap} {f}"))
    return err


# --- the one-interval kernels (K5 fused interval, K6 interval slots) -----------


def state_max_err(got: ops.PixelState, want: ops.PixelState,
                  what: str) -> float:
    """`bitwise_max_err` over every field of two states."""
    return max(bitwise_max_err(getattr(got, f), getattr(want, f),
                               f"{what} {f}") for f in ops.PixelState._fields)


def _fused_lockstep(st, frames, p, pack, emit, offset0, cap, n_real,
                    what) -> tuple:
    """K5 and its plain version interval by interval from one state, both
    writing chained intervals into their own buffers from `offset0`;
    compares every output of every interval, then the buffers. Returns
    (max abs err, the plain side's last step)."""
    dev = frames.device
    sides = []
    for _ in range(2):
        bufs = (torch.full((cap,), -1, dtype=torch.int32, device=dev),
                torch.full((cap,), -1, dtype=torch.int32, device=dev))
        sides.append([st, torch.tensor(offset0, device=dev), FK.new_flags(dev),
                      bufs])
    err = 0.0
    for i in range(frames.shape[0]):
        steps = []
        for fn, side in zip((FK.fused_interval, FK.fused_interval_plain),
                            sides):
            r = fn(side[0], frames[i], 255.0, side[1], side[3], p, pack, emit,
                   n_real, side[2])
            side[:3] = [r.state, r.offset, r.flags]
            steps.append(r)
        k, w = steps
        w_i = f"{what} interval {i}"
        err = max(err, state_max_err(k.state, w.state, w_i),
                  bitwise_max_err(k.offset, w.offset, f"{w_i} offset"),
                  bitwise_max_err(k.flags, w.flags, f"{w_i} flags"),
                  bitwise_max_err(k.run_val, w.run_val, f"{w_i} run_val"),
                  bitwise_max_err(k.run_has, w.run_has, f"{w_i} run_has"))
    for j, name in enumerate(("pixd", "t")):
        err = max(err, bitwise_max_err(sides[0][3][j], sides[1][3][j],
                                       f"{what} {name}"))
    return err, steps[1]


def check_fused_interval_against_plain(device, H: int = 150, W: int = 200,
                                       T: int = 8, chunks: int = 2,
                                       seed: int = 0) -> float:
    """K5 against its plain version on the same inputs, bit for bit, on a
    ragged plane: every mode case at depth 6 and 8 with pack 4 and 16,
    `chunks` chained chunks of T intervals written from a non-zero offset
    (the odd cases with plane padding, n_real = N - 37; view modes cycling;
    the display off in two cases); then pack 2 overflowing, a forced depth-6
    overflow and a buffer too small for the events. Raises on any
    difference; returns the largest absolute difference (0.0)."""
    dev = torch.device(device)
    n = H * W
    frames = torch.from_numpy(walk_frames(seed, T * chunks, n)).to(dev)
    cap = ops.K_SLOTS * n * T * chunks + 1000
    err = 0.0
    for i, p in enumerate(MODE_CASES):
        p = p._replace(view_mode=i % 4)
        for depth in (6, 8):
            for pack in (4, 16):
                st = ops.set_initial_d(
                    ops.init_state(n, dev, c_thresh=3, depth=depth),
                    frames[0].to(torch.int32))
                e, _ = _fused_lockstep(
                    st, frames, p, pack, i < 6, 1000 + i, cap,
                    n - 37 if i % 2 else 0,
                    f"mode {tuple(p[:3])} depth {depth} pack {pack}")
                err = max(err, e)
    st = ops.set_initial_d(ops.init_state(n, dev, c_thresh=0, depth=8),
                           frames[0].to(torch.int32))
    p2 = ops.TranscodeParams(mode=1, multi_mode=0, time_mode=1, ref_time=255,
                             delta_t_max=255, c_thresh_max=0,
                             c_increase_velocity=1)
    e, last = _fused_lockstep(st, frames[:T], p2, 2, True, 5, cap, 0, "pack 2")
    if int(last.flags[0]) <= 2:
        raise AssertionError("the pack-2 case did not overflow its lanes")
    e_small, last_small = _fused_lockstep(st, frames[:T], p2, 16, True, 5, 999,
                                          0, "cap 999")
    if int(last_small.offset) <= 999:
        raise AssertionError("the small buffer did not overflow")
    p = ops.TranscodeParams(mode=0, multi_mode=1, time_mode=0, ref_time=255,
                            delta_t_max=255 * 24, c_thresh_max=0,
                            c_increase_velocity=1)
    st = forced_overflow_state(frames[0], n // 10)
    e_ovf, last = _fused_lockstep(st, frames[:T], p, 4, True, 0, cap, 0,
                                  "forced overflow")
    if int(last.flags[1]) != 1:
        raise AssertionError("the forced overflow did not overflow")
    return max(err, e, e_small, e_ovf)


def check_interval_slots_against_plain(device, H: int = 150, W: int = 200,
                                       T: int = 8, chunks: int = 2,
                                       seed: int = 0) -> float:
    """K6 against its plain version on the same inputs, bit for bit, on a
    ragged plane: every mode case at depth 8, chunks x T chained intervals,
    view modes cycling; a forced depth-8 overflow (the overflow count); then
    the slot engine's chunk (`transcode_chunk`, pack 4, plane padding) on
    the card against the same chunk on the CPU. Raises on any difference;
    returns the largest absolute difference (0.0)."""
    dev = torch.device(device)
    n = H * W
    frames = torch.from_numpy(walk_frames(seed, T * chunks, n)).to(dev)

    def lockstep(st, frames, p, what):
        st_k = st_p = st
        err = 0.0
        for i in range(frames.shape[0]):
            k = PK.interval_slots(st_k, frames[i], 255.0, p)
            w = PK.interval_slots_plain(st_p, frames[i], 255.0, p)
            w_i = f"{what} interval {i}"
            err = max(err, state_max_err(k[0], w[0], w_i), *(
                bitwise_max_err(a, b, f"{w_i} {name}") for a, b, name in zip(
                    (*k[1:4], *k[4]), (*w[1:4], *w[4]),
                    ("slot_d", "slot_t", "slot_m", "run_val", "run_has"))))
            st_k, st_p = k[0], w[0]
        return err, st_p

    err = 0.0
    for i, p in enumerate(MODE_CASES):
        p = p._replace(view_mode=i % 4)
        st = ops.set_initial_d(ops.init_state(n, dev, c_thresh=3),
                               frames[0].to(torch.int32))
        err = max(err, lockstep(st, frames, p, f"mode {tuple(p[:3])}")[0])
    p = ops.TranscodeParams(mode=0, multi_mode=1, time_mode=0, ref_time=255,
                            delta_t_max=255 * 24, c_thresh_max=0,
                            c_increase_velocity=1)
    e, st = lockstep(forced_overflow_state(frames[0], n // 10, depth=8),
                     frames[:1], p, "forced overflow")
    if int(st.overflow) == 0:
        raise AssertionError("the forced overflow did not overflow")
    p = MODE_CASES[5]
    st = ops.set_initial_d(ops.init_state(n, dev, c_thresh=3),
                           frames[0].to(torch.int32))
    run0 = torch.zeros(n, dtype=torch.uint8, device=dev)
    cap = ops.K_SLOTS * n * T
    got = ops.transcode_chunk(st, frames[:T], 255.0, run0, p, cap, 4, n - 37)
    want = ops.transcode_chunk(
        ops.PixelState(*(x.cpu() for x in st)), frames[:T].cpu(), 255.0,
        run0.cpu(), p, cap, 4, n - 37)
    for f in ops.IntervalChunk._fields:
        a, b = getattr(got, f), getattr(want, f)
        if f == "state":
            e = max(e, state_max_err(a, b, "slot chunk"))
        else:
            e = max(e, bitwise_max_err(a, b, f"slot chunk {f}"))
    return max(err, e)


def framer_chains(plane, k_per_px: int, dtm: int, seed, absolute: bool):
    """Seeded per-pixel event chains for the framers, honouring delta_t_max:
    every gap (and the first event) is within `dtm` ticks, each chain cut
    where the shortest one ends (so no pixel falls silent), in time order
    across pixels. `plane` is (W, H, C). Returns the (x, y, c, d, t) numpy
    arrays of an EventArray (t absolute or per-pixel deltas), about 5% of
    the events D_EMPTY."""
    rng = np.random.default_rng(seed)
    W, H, C = plane
    npx = W * H * C
    gaps = rng.integers(1, dtm, (npx, k_per_px)).astype(np.uint64)
    t_abs = np.cumsum(gaps, axis=1)
    end = t_abs[:, -1].min()
    pix = np.repeat(np.arange(npx), k_per_px)
    t_abs, gaps = t_abs.reshape(-1), gaps.reshape(-1)
    live = t_abs <= end
    pix, t_abs, gaps = pix[live], t_abs[live], gaps[live]
    order = np.argsort(t_abs, kind="stable")
    pix = pix[order]
    x = ((pix // C) % W).astype(np.uint16)
    y = ((pix // C) // W).astype(np.uint16)
    c = ((pix % C).astype(np.uint8) if C > 1
         else np.full(len(pix), 255, np.uint8))
    d = rng.integers(0, 32, len(pix)).astype(np.uint8)
    d[rng.random(len(pix)) < 0.05] = 255  # D_EMPTY fillers
    t = (t_abs if absolute else gaps)[order].astype(np.uint32)
    return x, y, c, d, t
