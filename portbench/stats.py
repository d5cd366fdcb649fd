"""The benchmark's arithmetic: rates, tails, spreads, bytes, busy time.

No device and no program here: numbers in, numbers out, so each rule can
be tested on its own.
"""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # one NVIDIA H100 SXM, published peak


def rate(amount: float, seconds: float) -> float:
    """All the work of a window over all its time."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return amount / seconds


def p95(values: Sequence[float]) -> float:
    """The 95th percentile over every sample (numpy's linear rule)."""
    if len(values) == 0:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def quartile_spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, Python's `statistics.quantiles(n=4)`."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def state_bytes(n: int, live: int) -> int:
    """Bytes of a framed state's live part over `n` pixels: five 4-byte
    arena fields for each of the `live` nodes in use (the sum of `length`;
    n x depth counts the whole arena), six 4-byte fields and three flags a
    pixel."""
    return 5 * 4 * live + n * (6 * 4 + 3)


def chunk_bytes(frames: int, n: int, live_before: int, live_after: int,
                events: int) -> int:
    """What one framed chunk must move: its u8 frames read once, the live
    state read before and written after, 8 bytes written for each event."""
    return (frames * n + state_bytes(n, live_before)
            + state_bytes(n, live_after) + 8 * events)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def busy(intervals, lo: float, hi: float) -> float:
    """Time inside [lo, hi] covered by at least one interval."""
    return sum(b - a for a, b in union(clip(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def label_gap(gap: Tuple[float, float], spans, default: str) -> str:
    """The name of the span that overlaps `gap` most (`spans`: (name,
    start, end), innermost candidates first); `default` where none does."""
    best, best_overlap = default, 0.0
    for name, a, b in spans:
        overlap = min(b, gap[1]) - max(a, gap[0])
        if overlap > best_overlap:
            best, best_overlap = name, overlap
    return best


def top(pairs: Iterable[Tuple[str, float]], k: int = 10) -> list:
    return sorted(pairs, key=lambda kv: -kv[1])[:k]
