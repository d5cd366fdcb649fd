"""BENCHMARK.json against the contract's shape, and every piece it names
found by name."""

import json
import re

from portbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["portbench"]
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_name_and_file_is_found():
    for c in SPEC["configs"]:
        assert NAME.match(c["name"]) and c["reduced"] == []
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (harness.HERE / "drivers" / f"{cfg['driver']}.py").exists()
    used = set()
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        harness.entry(SPEC["configs"], w["config"])
        used.add(w["config"])
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (harness.HERE / "end_to_end" / f"{m['name']}.py").exists()
    for m in SPEC["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(SPEC, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(SPEC, w["name"], True)
