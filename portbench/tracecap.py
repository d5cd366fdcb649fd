"""One traced stretch of a window: torch.profiler and the program's stages.

`Capture` waits for the card, turns on the program's stage tracer
(`adder_tpu_torch.utils.tracing`) and torch.profiler (CPU and CUDA
activities), and gives each stage a `record_function` range of its own
name, so the profiler's timeline shows what the host was doing while the
card sat idle. `stop` waits for the card again, so that every kernel of a
chunk submitted in the stretch falls inside it, and turns all of it off.

What it hands on (`Trace`): the stretch's length, every operation that ran
on the card (name, start, end; in seconds from the stretch's start), the
host spans by name, and the stage tracer's totals.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple, Tuple

import torch

WINDOW = "portbench.window"


class Trace(NamedTuple):
    window_s: float
    device_ops: List[Tuple[str, float, float]]
    host_spans: List[Tuple[str, float, float]]
    stages: Dict[str, float]


def span(name: str, on: bool):
    """A profiler range of the harness's own, when tracing."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class Capture:
    def __init__(self, tracing, span_prefixes=("portbench.",)):
        """`span_prefixes`: the host ranges the trace keeps (the program's
        stage names and the harness's own)."""
        self.tracing = tracing
        self.span_prefixes = tuple(span_prefixes)
        self._orig_stage = tracing.stage

    def _stage(self, name: str, items: int = 0):
        @contextlib.contextmanager
        def both():
            with torch.profiler.record_function(name):
                with self._orig_stage(name, items):
                    yield
        return both()

    def warm(self, fn) -> None:
        """One short profiled call of `fn`, thrown away: the profiler's
        first start (CUPTI's set-up) takes seconds, and belongs to set-up."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            fn()
            torch.cuda.synchronize()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.tracing.reset()
        self.tracing.set_enabled(True)
        self.tracing.stage = self._stage
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.range = torch.profiler.record_function(WINDOW)
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> Trace:
        torch.cuda.synchronize()
        host_s = time.perf_counter() - self.t0
        self.range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.tracing.stage = self._orig_stage
        self.tracing.set_enabled(False)
        stages = {k: v.total_s for k, v in self.tracing.report().items()}
        self.tracing.reset()
        cuda = torch.autograd.DeviceType.CUDA
        dev, host, lo, hi = [], [], None, None
        for e in self.prof.events():
            a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.device_type == cuda:
                # the card's copy of a host range is no operation
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(self.span_prefixes)):
                    dev.append((e.name, a, b))
            elif e.name == WINDOW:
                lo, hi = a, b
            elif e.name.startswith(self.span_prefixes):
                host.append((e.name, a, b))
        if lo is None:  # the window's range was not recorded: the host clock
            lo = min((a for _, a, _ in dev), default=0.0)
            hi = lo + host_s
        return Trace(hi - lo, [(n, a - lo, b - lo) for n, a, b in dev],
                     [(n, a - lo, b - lo) for n, a, b in host], stages)
