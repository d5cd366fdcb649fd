"""Per-stage tracing: wall time and call counts by stage name, each stage
also a torch.profiler range of its own name.

Copy of `adder_tpu/utils/tracing.py` with two changes, both where the
device is touched: an enabled `stage` opens
`torch.profiler.record_function(name)` around its body, so a profiler
trace of the port (torch's CPU and CUDA activities) labels the host's
time by stage; and `device_trace` records such a trace into a directory
as a Chrome trace, the operator's labelled timeline. The registry,
`add_items`, `report`, `reset`, `summary_table` and the `ADDER_TPU_TRACE`
gate are the original's; the original's `hard_sync` has no counterpart.

Enable with ADDER_TPU_TRACE=1 (read at import; `set_enabled` switches it
later). Disabled, a stage does nothing but test one flag; enabled, it opens
the profiler range (which records nothing unless a profiler runs), reads
the host clock twice
and never the device, so a stage around a chunk's launches adds no host
read inside the chunk. The registry times the body inside the range.

Where the port records the JAX package's stage names:
- transcoder/video.py: `video.submit_chunk` (the chunk's launches),
  `video.collect.control_fetch` (the one read of a chunk's control
  scalars), `video.collect.event_fetch`, `video.encode`,
  `video.features.mask_lookup`. The JAX `video.collect.assemble` has no
  counterpart: the port's kernels write the reference order, and there is
  no host assembler to time. New here, siblings of those (none nests in
  another): `video.upload` (the frames' host-to-device copy; items: the
  bytes), `video.unpack` (the wire events to an EventArray before
  `video.encode`; items: the events) and `video.rerun` (one span per
  relaunch of a chunk: a capacity, pack or depth rerun, or a chunk in
  flight recomputed after a depth rerun). Where the encoder writes each
  event's raw record as it comes (a Raw sink, no event drop, the
  Unchanged order) and feature detection is off, a chunk's events are
  packed into `.adder` records on its device (`Video._packs_records`), and
  the same names time that route: `video.unpack` the host side of the
  pack's launch (items: the events), `video.collect.event_fetch` the copy
  of the records into pinned memory and its wait, `video.encode` the
  writer's call (items: the events); the counter `video.wire_pack` (items
  only, no calls) adds 1 for each chunk so packed;
- transcoder/sharded.py: `sharded.submit_chunk`,
  `sharded.collect.control_fetch`, `sharded.collect.event_fetch`,
  `sharded.collect.assemble` (the bands' streams merged into the global
  order), `sharded.unpack` (Video's), `sharded.encode`;
- transcoder/prophesee.py and transcoder/lanes.py: `dvs.plan` (the fused
  plan + 8-byte pack, or the classic plan), `dvs.pack`, `dvs.upload` (the
  pinned copy and the h2d enqueue), `dvs.dispatch`, `dvs.event_fetch` (on
  the pipeline's fetch worker for the Prophesee lane groups), `dvs.encode`
  (the Davis source's lane chunks go through the same lanes.py calls and
  record under the same names); new here, `dvs.fetch_wait` (the calling
  thread waiting for the fetch worker) and `dvs.upload_pending` (items:
  the groups whose upload had not finished when dispatched). The JAX
  `dvs.sync` and `dvs.assemble` have no counterpart: the totals are read
  by the fetch worker or the row wrappers, and the events come back in the
  reference order;
- transcoder/framed.py: `framed.decode_wait` (FramedStream waiting on its
  decoder thread);
- framer/device.py: `device_framer.pack`, `.dispatch`, `.sync_fetch`,
  `.pop_d2h`, `.recycle`, `.convert`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

_ENABLED = os.environ.get("ADDER_TPU_TRACE", "0") not in ("", "0")
_LOCK = threading.Lock()


@dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    items: int = 0  # optional unit count (pixels, events, bytes)

    @property
    def mean_ms(self) -> float:
        return self.total_s / self.calls * 1e3 if self.calls else 0.0


_REGISTRY: Dict[str, StageStats] = {}


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = on


@contextlib.contextmanager
def stage(name: str, items: int = 0):
    """Accumulate wall time under `name`; `items` adds to a unit counter
    so report() can derive rates (px/s, events/s). Enabled, the body also
    runs inside a torch.profiler range named `name`."""
    if not _ENABLED:
        yield
        return
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with _LOCK:
                s = _REGISTRY.setdefault(name, StageStats())
                s.calls += 1
                s.total_s += dt
                s.max_s = max(s.max_s, dt)
                s.items += items


def add_items(name: str, items: int) -> None:
    if not _ENABLED:
        return
    with _LOCK:
        _REGISTRY.setdefault(name, StageStats()).items += items


def report() -> Dict[str, StageStats]:
    with _LOCK:
        return {k: StageStats(**vars(v)) for k, v in _REGISTRY.items()}


def reset() -> None:
    with _LOCK:
        _REGISTRY.clear()


def summary_table() -> str:
    rows = ["stage                          calls   total_ms   mean_ms     rate"]
    for name, s in sorted(report().items(), key=lambda kv: -kv[1].total_s):
        rate = (
            f"{s.items / s.total_s / 1e6:8.2f}M/s" if s.items and s.total_s
            else "        -"
        )
        rows.append(
            f"{name:<30} {s.calls:>5} {s.total_s*1e3:>10.1f}"
            f" {s.mean_ms:>9.2f} {rate}"
        )
    return "\n".join(rows)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """torch.profiler trace (CPU and, where there is a card, CUDA
    activities) around a region, written to `log_dir` as a Chrome trace;
    no-op when log_dir is None. With tracing enabled, each stage run in
    the region is a range of its name on the trace's timeline."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
