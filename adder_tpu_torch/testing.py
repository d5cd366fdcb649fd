"""Inputs and comparisons shared by the tests and by chip_smoke.py.

Scenes are made from a seed (numpy for small ones, torch on the target
device for 1080p), so the CPU tests and the card see the same data.
"""

from __future__ import annotations

import math

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


def _const_planes(T: int, n: int, dev):
    """T sub-steps of one mid-grey tick in every pixel (the bootstrap)."""
    return tuple(torch.full((T, n), v, dtype=dt, device=dev) for v, dt in
                 ((128.0, torch.float32), (20.0, torch.float32),
                  (128 | 1 << 8, torch.int32)))


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
    plan = _check_plan(seed, W, H, need)
    err = 0.0

    def both(st_k, st_p, planes, p, what):
        k = FR.dvs_chunk_resident(st_k, *planes, p)
        v = FR.dvs_chunk_resident(st_k, *planes, p, events=False)
        want = FR.dvs_chunk_resident_plain(st_p, *planes, p)
        e = max(compare_chunks(k, want, what),
                compare_chunks(v, want._replace(pixd=None, t=None),
                               what + " void"))
        return k.state, want, e

    for multi in (0, 1):
        p = _dvs_params(multi)
        st_k = st_p = ops.init_state(n, dev, c_thresh=3, depth=FR.DVS_DEPTH)
        st_k, want, e = both(st_k, st_p, _const_planes(2, n, dev), p,
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
    _, want, e = both(st, st, _const_planes(2, n, dev), _dvs_params(1),
                      "forced depth-16 overflow")
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
    """Hand-made rows as the (5, E) carrier, with the planner's field
    definitions: gap_int = f32(gap_val) * f32(gap_n), gap_time =
    f32(gap_n * ref_time)."""
    gap_val = np.asarray(gap_val, np.float32)
    gap_n = np.asarray(gap_n, np.int64)
    E = len(gap_n)
    plan = dvs_batch.DvsCompact(
        np.asarray(pix, np.int32), np.asarray(lane, np.int32),
        np.asarray(gap_on, bool), np.asarray(gap_fv, np.int32),
        gap_val * gap_n.astype(np.float32),
        (gap_n * ref_time).astype(np.float32), np.asarray(tick_on, bool),
        np.asarray(tick_fv, np.int32), np.asarray(tick_int, np.float32),
        np.full(E, ref_time, np.float32), gap_val, gap_n)
    return FR.pack_dvs_plan(plan)


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
                     p: ops.TranscodeParams, what: str):
    """One lane group through `dvs_rows_resident` (WRITE and VOID) against
    `dvs_rows_resident_plain` on the same carrier and state, bit for bit,
    the dense `dvs_chunk_resident` on planes built from that carrier
    against the same, and the grouping glue `group_dvs_rows` against its
    plain version. `state` is left as it was. Returns (the largest
    absolute difference, the plain result)."""
    n, E = state.length.shape[0], carrier.shape[1]
    want = FR.dvs_rows_resident_plain(state, carrier, T, p)
    want_void = want._replace(pixd=None, t=None)
    if E:  # the grouping glue against its plain version
        glue = FR.group_dvs_rows(carrier, T)
        glue_plain = FR.group_dvs_rows_plain(carrier, T)
        for name, a, b in zip(glue._fields, glue, glue_plain):
            if name == "row_start":  # the last slot is scratch
                a, b = a[: E + 1], b[: E + 1]
            bitwise_max_err(a, b, f"{what} glue {name}")
    planes = FR.build_dvs_planes(T, n, *FR.unpack_dvs_carrier(carrier),
                                 ref_time=p.ref_time)
    err = compare_chunks(FR.dvs_chunk_resident(state, *planes, p), want,
                         what + " dense")
    for events, ref in ((True, want), (False, want_void)):
        st = FR.clone_state(state)
        got = FR.dvs_rows_resident(st, carrier, T, p, events=events)
        if any(a is not b for a, b in zip(got.state, st)):
            raise AssertionError(f"{what}: the rows chunk did not return "
                                 f"the caller's state")
        err = max(err, compare_chunks(got, ref,
                                      f"{what} rows events {events}"))
    return err, want


def check_dvs_rows_against_plain(device, H: int = 150, W: int = 200,
                                 lanes=(1, 19, 64), seed: int = 0) -> float:
    """The K3 row kernel against its plain version and against the dense K3
    kernel, bit for bit (`check_rows_group`): for Normal and Collapse, from
    the state after the bootstrap chunk, two chained groups of T = 2 L
    sub-steps for each lane count L, planned by the port's planner from a
    seeded stream; then a forced depth-16 overflow in a group of one row per
    pixel, a group with no rows, a group whose rows sit in one pixel, and a
    hand-made group of unsorted rows with one half or both off. Raises on
    any difference; returns the largest absolute difference (0.0)."""
    dev = torch.device(device)
    n = H * W
    need = 2 * sum(lanes)
    plan = _check_plan(seed, W, H, need)
    boot = _const_planes(2, n, dev)
    err = 0.0
    for multi in (0, 1):
        p = _dvs_params(multi)
        st = FR.dvs_chunk_resident_plain(
            ops.init_state(n, dev, c_thresh=3, depth=FR.DVS_DEPTH), *boot,
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
