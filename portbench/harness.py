"""One cell of BENCHMARK.json: find its pieces by name, run it, read it.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name `BENCHMARK.json` gives it:

- a configuration: the file its entry names (`configs/<name>.json`), whose
  `driver` key names the code that runs it (`drivers/<driver>.py`);
- a traffic mix: `traffic/<name>.json`, parameters only;
- an end-to-end metric: `end_to_end/<name>.py`; a per-layer metric:
  `metrics/<name>.py`. Each defines `read(run)`, which takes the driver's
  `Run` and returns a number, or None where it finds nothing to read (the
  metric is then left out of the line).

A driver defines `run(config, traffic, *, seed, seconds, trace, device,
plane, hook, t_start) -> Run`.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import List, Optional

from . import stats

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the process may not hold once the window closed
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "adder_tpu"})


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def entry(entries: list, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def load_module(path: Path):
    """A file of the benchmark as a module of its own (names may hold
    dots and dashes, so they are loaded by path)."""
    name = re.sub(r"\W", "_", str(path.relative_to(HERE).with_suffix("")))
    spec = importlib.util.spec_from_file_location(f"portbench_{name}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names=None) -> List[str]:
    """Top-level module names of `names` (default: sys.modules) that are
    JAX or the JAX package, compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (those without `workloads` and those
    that list it), or with `trace` its per-layer ones (those that list it,
    and those without `workloads` whose `moves` the cell reports)."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def breakdown(trace) -> dict:
    """The device operations that took most time, and the longest idle
    gaps labelled by what the host was doing: the program's stage that
    overlaps a gap most, else the harness's own span, else "untraced"."""
    per_op: dict = {}
    for name, a, b in trace.device_ops:
        per_op[name] = per_op.get(name, 0.0) + (b - a)
    ivs = [(a, b) for _, a, b in trace.device_ops]
    stages = [s for s in trace.host_spans if not s[0].startswith("portbench.")]
    own = [s for s in trace.host_spans if s[0].startswith("portbench.")]
    gaps = []
    for g in stats.gaps(ivs, 0.0, trace.window_s):
        label = stats.label_gap(g, stages, "")
        gaps.append((label or stats.label_gap(g, own, "untraced"), g[1] - g[0]))
    return {"device_ops": [list(x) for x in stats.top(per_op.items())],
            "idle_gaps": [list(x) for x in stats.top(gaps)]}


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", plane: Optional[tuple] = None,
        hook=None, spec: Optional[dict] = None,
        traffic: Optional[dict] = None) -> dict:
    """Run one cell and return its result line (a dict). For tests only:
    `plane` (W, H, C) replaces the configuration's plane, `traffic` the
    traffic file's parameters, and `hook(program)` is called on the
    program before its first chunk."""
    spec = load_spec() if spec is None else spec
    cell = entry(spec["workloads"], workload)
    config = json.loads((ROOT / entry(spec["configs"], cell["config"])["file"])
                        .read_text())
    if traffic is None:
        traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                             .read_text())
    driver = load_module(HERE / "drivers" / f"{config['driver']}.py")
    r = driver.run(config, traffic, seed=seed, seconds=seconds, trace=trace,
                   device=device, plane=plane, hook=hook, t_start=t_start)
    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        kind = "metrics" if trace else "end_to_end"
        value = load_module(HERE / kind / f"{m['name']}.py").read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": r.platform, "kind": r.device_kind, "count": 1,
           "memory_peak_bytes": r.memory_peak_bytes}
    line = {"correct": r.correct, "attempted": r.attempted,
            "failed": r.failed, "metrics": metrics, "device": dev}
    if trace and r.trace is not None:
        dev["busy_s"] = stats.busy([(a, b) for _, a, b in r.trace.device_ops],
                                   0.0, r.trace.window_s)
        dev["window_s"] = r.trace.window_s
        line["breakdown"] = breakdown(r.trace)
    line.update(r.info)
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in r.checks}
    return line
