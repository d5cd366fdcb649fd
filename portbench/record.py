"""What a driver hands the readers of a cell's metrics."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .tracecap import Trace


@dataclass
class TracedChunk:
    """A chunk submitted while the trace ran: its shape and its events."""

    frames: int
    n: int  # pixel-channels
    live_before: int  # live arena nodes over all pixels (sum of `length`)
    live_after: int  # the same after the chunk
    events: int  # events it wrote out (0 on the Empty sink)


@dataclass
class Run:
    platform: str
    device_kind: str
    memory_peak_bytes: int
    correct: bool
    attempted: int  # chunks collected in the window
    failed: int  # chunks checked that the reference does not confirm
    setup_s: float  # process start to the first timed submit
    window_s: float
    pixels_per_frame: int  # H x W, channels not counted
    frames: int  # frames of the chunks collected in the window
    latencies_ms: List[float]  # submit to collect, of each chunk the window
    # collected that was neither submitted nor collected while profiled
    trace: Optional[Trace] = None
    traced_chunks: List[TracedChunk] = field(default_factory=list)
    checks: List[Tuple[str, int, int]] = field(default_factory=list)
    info: dict = field(default_factory=dict)
