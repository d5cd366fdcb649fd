"""The correctness check, driven through the harness on the CPU at a tiny
plane: the reference agrees with the program's plain path, and the
control and every planted fault come out not correct."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import control, harness

ROOT = harness.ROOT
SPEC = harness.load_spec()
SPEC["workloads"].append({"name": "color-raw-test", "config": "framed-1080p-color",
                          "traffic": "raw-moving", "chips": 1, "why": "tests"})
PLANE = (48, 32, 1)


def _traffic(name):
    t = json.loads((harness.HERE / "traffic" / f"{name}.json").read_text())
    t = dict(t, pool_frames=16, warmup_frames=16, window_pairs=1)
    paths = [dict(p, vx_px=p["vx_px"] / 8, vy_px=p["vy_px"] / 8)
             for p in t["scene"]["blobs"]["paths"]]
    t["scene"] = dict(t["scene"], blobs=dict(
        t["scene"]["blobs"], sigma_px=4.0, paths=paths))
    return t


def _run(workload, traffic, plane=PLANE, hook=None, seed=2 ** 31 + 17,
         seconds=0.4):
    import time

    return harness.run(workload, seed, seconds, False, t_start=time.perf_counter(),
                       device="cpu", plane=plane, hook=hook, spec=SPEC,
                       traffic=_traffic(traffic))


@pytest.mark.parametrize("workload,traffic,plane", [
    ("framed-1080p-raw-moving", "raw-moving", PLANE),
    ("framed-1080p-void-moving", "void-moving", PLANE),
    ("color-raw-test", "raw-moving", (24, 16, 3)),
])
def test_reference_agrees_with_the_program(workload, traffic, plane):
    line = _run(workload, traffic, plane)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert line["chunks_checked"] >= 4
    assert set(line["checks"]) == (
        {"state_mismatch", "count_mismatch"}
        | ({"bytes_mismatch"} if "raw" in traffic else set()))
    if "raw" in traffic:
        assert line["stream_bytes"] > 1000  # the scene makes events


def test_a_window_cut_short_still_checks_a_pair_in_it():
    line = _run("framed-1080p-raw-moving", "raw-moving", seconds=0.001)
    assert line["correct"] and line["attempted"] == 1
    assert line["chunks_checked"] == 4


def test_the_tail_leaves_out_the_chunks_the_profiler_ran_over(monkeypatch):
    """A traced run's chunk_p95_ms reads the chunks outside the profiled
    stretch: here every collect in it stalls, and the tail stays short."""
    import time

    from portbench import tracecap

    on = []

    class Capture:  # the profiler's place, with a stall of its own
        def __init__(self, *args):
            pass

        def warm(self, fn):
            fn()

        def start(self):
            on.append(1)

        def stop(self):
            on.clear()
            return tracecap.Trace(1.0, [], [], {})

    def stall_while_traced(video):
        inner = video.collect_chunk

        def collect_chunk(pending):
            if on:
                time.sleep(0.3)
            return inner(pending)
        video.collect_chunk = collect_chunk

    monkeypatch.setattr(tracecap, "Capture", Capture)
    line = harness.run("framed-1080p-void-moving", 2 ** 31 + 5, 2.0, True,
                       t_start=time.perf_counter(), device="cpu", plane=PLANE,
                       hook=stall_while_traced, spec=SPEC,
                       traffic=_traffic("void-moving"))
    assert line["correct"], line["checks"]
    assert 0 < line["chunks_timed"] <= line["attempted"] - 3
    assert line["metrics"]["chunk_p95_ms"]["value"] < 300


@pytest.mark.parametrize("what", ["control"] + sorted(control.FAULTS))
@pytest.mark.parametrize("traffic", ["raw-moving", "void-moving"])
def test_control_and_faults_are_not_correct(what, traffic):
    workload = {"raw-moving": "framed-1080p-raw-moving",
                "void-moving": "framed-1080p-void-moving"}[traffic]
    config = json.loads((ROOT / "portbench/configs/framed-1080p-mono.json").read_text())
    hook = control.control(config) if what == "control" else control.FAULTS[what]
    line = _run(workload, traffic, hook=hook)
    assert not line["correct"]
    assert line["failed"] > 0
    if what == "altered_answer" and traffic == "raw-moving":
        assert line["checks"]["bytes_mismatch"]["value"] > 0


def test_reference_is_deterministic_and_the_control_differs():
    import torch

    from portbench import reference

    cfg = json.loads((ROOT / "portbench/configs/framed-1080p-mono.json").read_text())
    p = reference.params_of(cfg)
    g = torch.Generator().manual_seed(4)
    frames = torch.randint(0, 256, (8, 500), generator=g, dtype=torch.uint8)
    st = reference.first_frame(reference.initial_state(500, p, "cpu"), frames[0])
    a = reference.run_chunk(st, frames, p)
    b = reference.run_chunk(st, frames, p)
    c = reference.run_chunk(st, frames, p, prec="bf16")
    assert torch.equal(a.pixd, b.pixd) and torch.equal(a.t, b.t)
    assert int(a.total) == len(a.pixd) > 0
    assert not (torch.equal(a.t, c.t) and torch.equal(
        a.state.node_integ, c.state.node_integ))


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "framed-1080p-void-moving", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=120)
    assert p.returncode == 2
    assert p.stdout.strip() == ""


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["adder_tpu_torch", "adder_tpu_torch.ops",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["jax.numpy", "adder_tpu.ops", "flax"]) == [
        "adder_tpu", "flax", "jax"]


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from portbench.tests import test_portbench_check as t\n"
            "t._run('framed-1080p-void-moving', 'void-moving')\n"
            "from portbench import harness\n"
            "print(harness.forbidden_modules())\n") % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse((harness.HERE / "reference.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "struct", "typing", "numpy", "torch"}
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'adder_tpu_torch', 'adder_tpu', 'jax'}))\n") % str(ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.stdout.strip() == "[]", p.stderr[-2000:]
