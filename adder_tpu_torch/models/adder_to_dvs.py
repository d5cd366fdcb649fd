"""ADDER -> DVS polarity-event transcoder.

Copy of `adder_tpu/models/adder_to_dvs.py` (host numpy); the port keeps its
own copy and imports nothing of the JAX package.

ref: adder-to-dvs/src/main.rs. Per-pixel log-intensity state fires +-events
when the reconstructed frame intensity crosses the theta threshold; output is
Prophesee-style text or binary (.dat layout) plus an optional event-count
visualization frame.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import BinaryIO, Optional

import numpy as np

from ..codec.decoder import open_file_decoder
from ..core.types import D_ZERO_INTEGRATION, D_EMPTY, NO_CHANNEL, TimeMode, is_framed


@dataclass
class DvsEvent:
    t: int
    x: int
    y: int
    p: int


def event_to_frame_intensity(d: int, t: int, frame_length: int) -> float:
    """ref: adder-to-dvs/src/main.rs:450-460. d >= 128 (including the legacy
    254 zero-integration sentinel found in old fixtures) maps to 0."""
    if d >= D_ZERO_INTEGRATION:
        return 0.0
    base = float(2.0 ** d)
    if t == 0:
        return float(np.log1p(base * frame_length / 255.0))
    return float(np.log1p((base / t) * frame_length / 255.0))


def write_dvs_header(writer: BinaryIO, width: int, height: int, binary: bool) -> None:
    """Prophesee-style %-comment header (ref: main.rs:151-163)."""
    writer.write(f"% Height {height}\n".encode())
    writer.write(f"% Width {width}\n".encode())
    writer.write(b"% Version 2\n")
    now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    writer.write(f"% Date {now}\n".encode())
    writer.write(b"% end\n")
    if binary:
        writer.write(bytes([0, 8]))  # event type, size


def encode_dvs_binary(events: list) -> bytes:
    """Prophesee .dat record layout (ref: main.rs:533-556)."""
    out = np.zeros((len(events), 2), dtype="<u4")
    for i, e in enumerate(events):
        out[i, 0] = e.t & 0xFFFFFFFF
        out[i, 1] = (e.p << 28) | (e.y << 14) | e.x
    return out.tobytes()


def _e2fi_vec(d: np.ndarray, t: np.ndarray, ref: int) -> np.ndarray:
    """Vectorized event_to_frame_intensity (ref: main.rs:450-460)."""
    base = np.power(2.0, np.minimum(d, 200).astype(np.float64))
    v = np.where(
        t == 0,
        np.log1p(base * ref / 255.0),
        np.log1p((base / np.maximum(t, 1)) * ref / 255.0),
    )
    return np.where(d >= D_ZERO_INTEGRATION, 0.0, v)


def _transcode_core(events, meta, theta: float):
    """Vectorized DVS transcode core: per-pixel occurrence lanes (the
    plan_dvs_batch idiom) replace the per-event Python loop; fire
    decisions are recorded per input index so the emitted stream keeps
    the exact input order. Bit-identical to _transcode_core_scalar (the
    labeled transliteration of adder-to-dvs/src/main.rs:240-360), pinned
    by tests. Returns (t, x, y, p, event_counts)."""
    H, W, C = meta.plane.height, meta.plane.width, meta.plane.channels
    n = len(events)
    delta_t_mode = meta.time_mode == TimeMode.DeltaT
    framed = is_framed(meta.source_camera)
    ref = max(meta.ref_interval, 1)
    ln_floor = float(np.log1p(0.0))
    ln_ceil = float(np.log1p(1.0))

    cs = np.where(events.c == NO_CHANNEL, 0, events.c).astype(np.int64)
    pix = (events.y.astype(np.int64) * W + events.x.astype(np.int64)) * C + cs
    event_counts = (
        np.bincount(pix, minlength=H * W * C)
        .astype(np.uint32)
        .reshape(H, W, C)
    )
    order = np.argsort(pix, kind="stable")
    sp = pix[order]
    seg_start = np.ones(n, bool)
    seg_start[1:] = sp[1:] != sp[:-1]
    idx = np.arange(n)
    seg_base = np.where(seg_start, idx, 0)
    np.maximum.accumulate(seg_base, out=seg_base)
    lane_sorted = idx - seg_base

    px_ln = np.zeros(H * W * C, np.float64)
    px_t = np.zeros(H * W * C, np.int64)
    fire_mask = np.zeros(n, bool)
    fire_pol = np.zeros(n, np.uint8)
    fire_t = np.zeros(n, np.int64)

    d_all = events.d[order].astype(np.int64)
    t_all = events.t[order].astype(np.int64)
    k_max = int(lane_sorted.max()) + 1 if n else 0
    for k in range(k_max):
        sidx = np.flatnonzero(lane_sorted == k)
        i = sp[sidx]
        d = d_all[sidx]
        t = t_all[sidx]
        if k == 0:
            # first event per pixel seeds the state (main.rs:263-275); the
            # reference panics for d > D_ZERO_INTEGRATION — legacy
            # sentinels (253/254/255) are accepted as zero-intensity here
            px_ln[i] = _e2fi_vec(d, t, ref)
            px_t[i] = t
            continue
        old_t = px_t[i]
        if delta_t_mode:
            pt = old_t + t
            t_eff = t
        else:
            pt = t.copy()
            t_eff = np.maximum(t - old_t, 0)
        if framed:
            pt = np.where(pt % ref != 0, (pt // ref + 1) * ref, pt)
        px_t[i] = pt

        alive = d != D_EMPTY
        new_ln = _e2fi_vec(d, t_eff, ref)
        cur = px_ln[i]
        same_t = pt == old_t
        # mid-gray special cases + threshold crossings (main.rs:292-360);
        # the scalar elif chain falls through to the threshold checks when
        # a mid-gray value matches neither special case
        mid = (new_ln > 0.406) & (new_ln < 0.407)
        c1 = mid & ((cur > ln_ceil - theta) | (same_t & (cur > 0.6)))
        c0 = mid & ~c1 & ((cur < ln_floor + theta) | (same_t & (cur < 0.3)))
        rest = ~c1 & ~c0
        up = rest & (new_ln > cur + theta / 2.0)
        dn = rest & ~up & (new_ln < cur - theta / 2.0)
        f = alive & (c1 | c0 | up | dn)
        px_ln[i] = np.where(f, new_ln, cur)
        orig = order[sidx]
        fire_mask[orig] = f
        fire_pol[orig] = np.where(c1 | up, 1, 0)
        fire_t[orig] = old_t + 1

    keep = np.flatnonzero(fire_mask)  # ascending == input stream order
    return (
        fire_t[keep].astype(np.uint64),
        events.x[keep].astype(np.uint16),
        events.y[keep].astype(np.uint16),
        fire_pol[keep],
        event_counts,
    )


def _transcode_core_scalar(events, meta, theta: float):
    """Reference-shaped per-event loop (labeled transliteration of
    adder-to-dvs/src/main.rs:240-360); the oracle the vectorized core is
    pinned against. Same return contract as _transcode_core."""
    H, W, C = meta.plane.height, meta.plane.width, meta.plane.channels
    have = np.zeros((H, W, C), dtype=bool)
    px_ln = np.zeros((H, W, C), dtype=np.float64)
    px_t = np.zeros((H, W, C), dtype=np.uint64)
    event_counts = np.zeros((H, W, C), dtype=np.uint32)

    delta_t_mode = meta.time_mode == TimeMode.DeltaT
    framed = is_framed(meta.source_camera)
    ref = max(meta.ref_interval, 1)

    out: list = []
    ln_floor = float(np.log1p(0.0))
    ln_ceil = float(np.log1p(1.0))

    cs = np.where(events.c == NO_CHANNEL, 0, events.c)
    for i in range(len(events)):
        x, y, c = int(events.x[i]), int(events.y[i]), int(cs[i])
        d, t = int(events.d[i]), int(events.t[i])
        event_counts[y, x, c] += 1
        if not have[y, x, c]:
            have[y, x, c] = True
            px_ln[y, x, c] = event_to_frame_intensity(d, t, ref)
            px_t[y, x, c] = t
            continue

        old_t = int(px_t[y, x, c])
        if delta_t_mode:
            px_t[y, x, c] = old_t + t
        else:
            px_t[y, x, c] = t
            t = max(t - old_t, 0)
        if framed:
            pt = int(px_t[y, x, c])
            if pt % ref != 0:
                px_t[y, x, c] = (pt // ref + 1) * ref

        if d == D_EMPTY:
            continue
        new_ln = event_to_frame_intensity(d, t, ref)
        cur = px_ln[y, x, c]
        fire_p = None
        if 0.406 < new_ln < 0.407 and (
            cur > ln_ceil - theta or (px_t[y, x, c] == old_t and cur > 0.6)
        ):
            fire_p = 1
        elif 0.406 < new_ln < 0.407 and (
            cur < ln_floor + theta or (px_t[y, x, c] == old_t and cur < 0.3)
        ):
            fire_p = 0
        elif new_ln > cur + theta / 2.0:
            fire_p = 1
        elif new_ln < cur - theta / 2.0:
            fire_p = 0
        if fire_p is not None:
            out.append(DvsEvent(old_t + 1, x, y, fire_p))
            px_ln[y, x, c] = new_ln

    return (
        np.array([e.t for e in out], np.uint64),
        np.array([e.x for e in out], np.uint16),
        np.array([e.y for e in out], np.uint16),
        np.array([e.p for e in out], np.uint8),
        event_counts,
    )


def adder_to_dvs(
    input_path: str,
    output_events: BinaryIO,
    output_mode: str = "binary",
    theta: float = 0.01,
    reorder: bool = False,
    max_events: Optional[int] = None,
) -> dict:
    """Transcode an .adder file to DVS events. Returns stats
    {n_adder_events, n_dvs_events, event_count_frame}."""
    dec = open_file_decoder(input_path)
    meta = dec.meta
    W, H, C = meta.plane.width, meta.plane.height, meta.plane.channels
    binary = output_mode == "binary"
    write_dvs_header(output_events, W, H, binary)

    events = dec.digest_all()
    if max_events is not None:
        events = events[:max_events]

    ts, xs, ys, ps, event_counts = _transcode_core(events, meta, theta)
    if reorder:
        o = np.argsort(ts, kind="stable")
        ts, xs, ys, ps = ts[o], xs[o], ys[o], ps[o]
    if binary:
        rec = np.zeros((len(ts), 2), dtype="<u4")
        rec[:, 0] = ts & 0xFFFFFFFF
        rec[:, 1] = (
            (ps.astype(np.uint32) << 28)
            | (ys.astype(np.uint32) << 14)
            | xs.astype(np.uint32)
        )
        output_events.write(rec.tobytes())
    else:
        lines = [
            f"{int(t)} {int(x)} {int(y)} {int(p)}\n".encode()
            for t, x, y, p in zip(ts, xs, ys, ps)
        ]
        output_events.write(b"".join(lines))

    mx = max(int(event_counts.max()), 1)
    count_frame = (event_counts.astype(np.float32) / mx * 255.0).astype(np.uint8)
    return {
        "n_adder_events": len(events),
        "n_dvs_events": int(len(ts)),
        "event_count_frame": count_frame,
    }
