"""Inputs and comparisons shared by the tests and by chip_smoke.py.

Scenes are made from a seed (numpy for small ones, torch on the target
device for 1080p), so the CPU tests and the card see the same data.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops import dvs_batch
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


def check_dvs_kernel_against_plain(device, H: int = 150, W: int = 200,
                                   lanes=(1, 19, 64), seed: int = 0) -> float:
    """The K3 kernel (WRITE and VOID) against its plain version on the same
    inputs, bit for bit: for Normal and Collapse, the bootstrap chunk (T = 2
    of constant planes), then for each lane count L two chained groups of
    T = 2 L sub-steps planned by the port's planner from a seeded stream;
    then a forced depth-16 overflow. Raises on any difference; returns the
    largest absolute difference (0.0)."""
    dev = torch.device(device)
    n = H * W
    need = 2 * sum(lanes)
    ts, xs, ys, ps = dvs_stream(seed, W, H, 200_000, n_hot=3,
                                hot_events=need + 8,
                                background_events=max(n // 4, 64))
    last_t = np.full(n, 2, np.uint32)
    last_ln = np.full(n, np.log1p(128.0 / 255.0), np.float64)
    plan = dvs_batch.plan_dvs_compact(ts, xs, ys, ps, W, last_t, last_ln,
                                      0.02, 20)
    if plan.n_lanes < need:
        raise AssertionError(f"stream planned {plan.n_lanes} lanes < {need}")
    err = 0.0

    def both(st_k, st_p, planes, p, what):
        k = FR.dvs_chunk_resident(st_k, *planes, p)
        v = FR.dvs_chunk_resident(st_k, *planes, p, events=False)
        want = FR.dvs_chunk_resident_plain(st_p, *planes, p)
        e = max(compare_chunks(k, want, what),
                compare_chunks(v, want._replace(pixd=None, t=None),
                               what + " void"))
        return k.state, want, e

    def const_planes(T):
        return tuple(torch.full((T, n), v, dtype=dt, device=dev) for v, dt in
                     ((128.0, torch.float32), (20.0, torch.float32),
                      (128 | 1 << 8, torch.int32)))

    for multi in (0, 1):
        p = _dvs_params(multi)
        st_k = st_p = ops.init_state(n, dev, c_thresh=3, depth=FR.DVS_DEPTH)
        st_k, want, e = both(st_k, st_p, const_planes(2), p,
                             f"bootstrap multi {multi}")
        st_p, err = want.state, max(err, e)
        lo = 0
        for L in lanes:
            for rep in range(2):
                planes = dvs_group_planes(plan, lo, lo + L, n, dev)
                st_k, want, e = both(st_k, st_p, planes, p,
                                     f"multi {multi} T {2 * L} group {rep}")
                st_p, err = want.state, max(err, e)
                lo += L
    st = forced_overflow_state(torch.full((n,), 128, dtype=torch.uint8,
                                          device=dev), n // 10,
                               depth=FR.DVS_DEPTH)
    _, want, e = both(st, st, const_planes(2), _dvs_params(1),
                      "forced depth-16 overflow")
    if not (int(want.pmax) >> 16) & 1:
        raise AssertionError("the forced overflow did not overflow")
    return max(err, e)


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
    g = plan.lane_slice(lane_lo, lane_hi)
    carrier = torch.from_numpy(FR.pack_davis_plan(g)).to(device)
    return FR.build_davis_planes(lane_hi - lane_lo, n,
                                 *FR.unpack_davis_carrier(carrier))


def check_davis_kernel_against_plain(device, H: int = 47, W: int = 61,
                                     lanes=(1, 37, 128),
                                     seed: int = 0) -> float:
    """The K4 kernel (WRITE and VOID) against its plain version on the same
    inputs, bit for bit: for Normal and Collapse and each lane count T, two
    chained groups of T sub-steps planned by the port's DAVIS planner from a
    seeded burst on a ragged plane; then a forced depth-16 overflow. Raises
    on any difference; returns the largest absolute difference (0.0)."""
    dev = torch.device(device)
    n = H * W
    plan = davis_plan(seed, W, H, 2 * sum(lanes))
    err = 0.0

    def both(st_k, st_p, planes, p, what):
        k = FR.davis_chunk_resident(st_k, *planes, p)
        v = FR.davis_chunk_resident(st_k, *planes, p, events=False)
        want = FR.davis_chunk_resident_plain(st_p, *planes, p)
        e = max(compare_chunks(k, want, what),
                compare_chunks(v, want._replace(pixd=None, t=None),
                               what + " void"))
        return k.state, want, e

    for multi in (0, 1):
        p = _davis_params(multi)
        st_k = st_p = ops.init_state(n, dev, c_thresh=3, depth=FR.DVS_DEPTH)
        lo = 0
        for L in lanes:
            for rep in range(2):
                planes = davis_group_planes(plan, lo, lo + L, n, dev)
                st_k, want, e = both(st_k, st_p, planes, p,
                                     f"multi {multi} T {L} group {rep}")
                st_p, err = want.state, max(err, e)
                lo += L
    st = forced_overflow_state(torch.full((n,), 128, dtype=torch.uint8,
                                          device=dev), n // 10,
                               depth=FR.DVS_DEPTH)
    planes = tuple(torch.full((1, n), v, dtype=dt, device=dev) for v, dt in
                   ((1000.0, torch.float32), (255.0, torch.float32),
                    (128.0, torch.float32), (128 | 1 << 8, torch.int32)))
    _, want, e = both(st, st, planes, _davis_params(1),
                      "forced depth-16 overflow")
    if not (int(want.pmax) >> 16) & 1:
        raise AssertionError("the forced overflow did not overflow")
    return max(err, e)
