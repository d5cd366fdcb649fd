"""The readers of the program's own spans (upload_pct, unpack_pct,
rerun_pct, host_untraced_pct) on a synthetic trace: nested spans of one
name count once, the host spans' union, nothing read without a trace."""

import pytest

from portbench import harness
from portbench.record import Run, TracedChunk
from portbench.tracecap import Trace

READERS = ["upload_pct", "unpack_pct", "rerun_pct", "host_untraced_pct"]


def _run(trace, chunks=4):
    return Run(platform="gpu", device_kind="x", memory_peak_bytes=0,
               correct=True, attempted=8, failed=0, setup_s=1.0,
               window_s=20.0, pixels_per_frame=1920 * 1080, frames=64,
               latencies_ms=[10.0] * 20, trace=trace,
               traced_chunks=[TracedChunk(8, 100, 10, 10, 0)] * chunks)


def _read(name, run):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(run)


def _trace(host_spans, stages=None, window_s=10.0):
    stages = {"video.upload": 2.5, "video.unpack": 1.5} if stages is None \
        else stages
    return Trace(window_s, [("adder_resident_chunk", 0.0, 1.0)], host_spans,
                 stages)


def test_stage_shares_read_the_registry_over_the_stretch():
    run = _run(_trace([]))
    assert _read("upload_pct", run) == pytest.approx(25.0)
    assert _read("unpack_pct", run) == pytest.approx(15.0)


def test_nested_rerun_spans_of_one_name_count_once():
    spans = [
        ("portbench.collect", 0.9, 2.5),
        ("video.rerun", 1.0, 1.2),  # the harness's range ...
        ("video.rerun", 1.0, 1.2),  # ... and the program's, equal here
        ("video.rerun", 2.0, 2.1),  # the harness's range ...
        ("video.rerun", 2.01, 2.09),  # ... and the program's inside it
        ("video.rerun", 2.1, 2.2),  # the next chunk's, just after
        ("video.upload", 3.0, 3.5),
    ]
    assert _read("rerun_pct", _run(_trace(spans))) == pytest.approx(75.0)
    assert _read("rerun_pct", _run(_trace(spans), chunks=3)) == pytest.approx(
        100.0)


def test_no_rerun_reads_zero_and_a_program_without_the_spans_nothing():
    spans = [("video.upload", 3.0, 3.5), ("video.encode", 4.0, 5.0)]
    assert _read("rerun_pct", _run(_trace(spans))) == 0.0
    # the parent's program: stages, but no upload and no rerun span
    old = _trace(spans[1:], stages={"video.encode": 1.0})
    assert _read("rerun_pct", _run(old)) is None
    assert _read("upload_pct", _run(old)) is None
    assert _read("unpack_pct", _run(old)) is None
    assert _read("rerun_pct", _run(_trace(spans), chunks=0)) is None


def test_host_untraced_is_the_stretch_outside_the_union_of_program_spans():
    spans = [
        ("portbench.window", 0.0, 10.0),  # the harness's own: left out
        ("portbench.submit", 4.0, 6.0),
        ("video.submit_chunk", 1.0, 3.0),
        ("video.submit_chunk", 1.0, 3.0),  # the same range twice
        ("video.upload", 2.0, 4.0),  # overlaps the one before
        ("video.encode", 2.5, 2.7),  # inside both
        ("video.unpack", 6.0, 7.0),
        ("video.encode", 9.5, 11.0),  # past the stretch's end: clipped
    ]
    # covered: [1, 4] + [6, 7] + [9.5, 10] = 4.5 of 10
    got = _read("host_untraced_pct", _run(_trace(spans)))
    assert got == pytest.approx(55.0)
    assert _read("host_untraced_pct", _run(_trace([]))) == pytest.approx(100.0)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_without_a_trace(name):
    assert _read(name, _run(None)) is None


def test_the_readers_are_in_the_spec_for_the_cells_that_have_their_spans():
    spec = harness.load_spec()
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    cells = [w["name"] for w in spec["workloads"]]
    for name in READERS:
        m = per_layer[name]
        assert (m["source"], m["moves"], m["unit"], m["better"]) == (
            "program_span", "framed_mpx_s", "%", "lower")
    assert per_layer["unpack_pct"]["workloads"] == ["framed-1080p-raw-moving"]
    for name in ("upload_pct", "rerun_pct", "host_untraced_pct"):
        assert per_layer[name]["workloads"] == cells
