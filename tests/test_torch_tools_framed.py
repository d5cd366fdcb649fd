"""The framed tools of the port against the JAX package's, in-process on
the CPU, at tolerance 0, on the seeded 48 x 32 FFV1 clip of
tests/test_torch_pipelines.py (cv2.VideoWriter, lossless):

- `adder_simulproc`: the same `.adder` and raw frame bytes and printed
  line, with flags and with a TOML `--args-filename` preset (Collapse,
  DeltaT), `--trace` printing the port tracer's table;
- `evaluate_crf_sweep`: the same JSON rows, printed and written, floats
  equal to their printed digits;
- `evaluate_feature_detection`: the same JSON-lines log and line;
- the example `frames_to_adder`: the same `.adder` bytes and line.
"""

import json

import pytest

from test_torch_file_sources import write_clip
from torch_tools_common import both, run_port_tool, same_files


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(tmp_path_factory.mktemp("clip") / "clip.avi", "FFV1",
                      n_frames=20, seed=3)


def test_adder_simulproc_writes_jax_bytes(clip, tmp_path, monkeypatch,
                                          capsys):
    argv = ["-i", clip, "--output-events-filename", "ev.adder",
            "--output-raw-video-filename", "raw.gray",
            "--frame-count-max", "16", "--delta-t-max", "1020"]
    (jrc, jout, jdir), (rc, out, pdir) = both(
        "adder_simulproc", argv, tmp_path, monkeypatch, capsys)
    assert rc == jrc == 0 and out == jout
    assert out.startswith("wrote ")
    same_files(jdir, pdir, ["ev.adder", "raw.gray"])


def test_adder_simulproc_toml_preset_and_trace(clip, tmp_path, monkeypatch,
                                               capsys):
    """A TOML preset sets the input, outputs and settings (Collapse,
    DeltaT, crf 5); `--trace` adds the tracer's table after the line."""
    preset = tmp_path / "preset.toml"
    preset.write_text(
        f'input-filename = "{clip}"\n'
        'output-events-filename = "ev.adder"\n'
        'output-raw-video-filename = "raw.gray"\n'
        'frame-count-max = 12\n'
        'delta-t-max = 1020\n'
        'crf = 5\n'
        'time-mode = "delta_t"\n'
        'integration-mode = "collapse"\n')
    (jrc, jout, jdir), (rc, out, pdir) = both(
        "adder_simulproc", ["--args-filename", preset, "--trace"], tmp_path,
        monkeypatch, capsys)
    assert rc == jrc == 0
    assert out.splitlines()[0] == jout.splitlines()[0]
    assert "stage" in out and len(out.splitlines()) > 3
    same_files(jdir, pdir, ["ev.adder", "raw.gray"])
    from adder_tpu_torch.utils import tracing

    tracing.set_enabled(False)


def test_evaluate_crf_sweep_rows_equal_jax(clip, tmp_path, monkeypatch,
                                          capsys):
    argv = ["-i", clip, "--crfs", "0,3", "--frames", "12",
            "--output", "rows.jsonl"]
    (jrc, jout, jdir), (rc, out, pdir) = both(
        "evaluate_crf_sweep", argv, tmp_path, monkeypatch, capsys)
    assert rc == jrc == 0 and out == jout
    rows = [json.loads(line) for line in out.splitlines()]
    assert [r["crf"] for r in rows] == [0, 3]
    assert all(r["frames"] > 5 and r["events"] > 0 for r in rows)
    same_files(jdir, pdir, ["rows.jsonl"])


def test_evaluate_feature_detection_log_equals_jax(clip, tmp_path,
                                                   monkeypatch, capsys):
    argv = ["-i", clip, "--max-frames", "16", "--log", "features.jsonl"]
    (jrc, jout, jdir), (rc, out, pdir) = both(
        "evaluate_feature_detection", argv, tmp_path, monkeypatch, capsys)
    assert rc == jrc == 0 and out == jout
    assert out.startswith("evaluated 2 chunks")
    same_files(jdir, pdir, ["features.jsonl"])
    records = (pdir / "features.jsonl").read_text().splitlines()
    assert len(records) == 1 + 2 * 2


def test_frames_to_adder_example_writes_jax_bytes(tmp_path, monkeypatch,
                                                  capsys):
    (jrc, jout, jdir), (rc, out, pdir) = both(
        "frames_to_adder", ["out.adder"], tmp_path, monkeypatch, capsys,
        script_dir="examples", package="examples")
    assert rc == jrc == 0 and out == jout
    same_files(jdir, pdir, ["out.adder"])


def test_framed_tools_default_to_the_card(clip, tmp_path, monkeypatch,
                                          capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_port_tool("adder_simulproc",
                      ["-i", clip, "--output-events-filename", "ev.adder"],
                      tmp_path, monkeypatch, capsys, device=None)
