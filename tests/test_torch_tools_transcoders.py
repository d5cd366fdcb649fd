"""The transcoder tools, `python -m adder_tpu_torch.tools.prophesee_to_adder`
and `davis_to_adder --crf`, against `tools/prophesee_to_adder.py` and
`tools/davis_to_adder.py`, in-process on the CPU, at tolerance 0: the same
`.adder` bytes and the same printed line from the same seeded input. The
Prophesee stream is the 14 x 10 stream of tests/test_torch_dvs.py, with no
window segmented, so the JAX tool's default engine on the CPU, the scan
engine, is the yardstick. The flags the port keeps: `--no-batched` runs
the scalar oracle and writes the JAX tool's `--no-batched` bytes,
`--batched` is accepted, and the default `--torch-device cuda` raises
without CUDA, for both transcoders.
The DAVIS tool's other settings are held in tests/test_torch_tools_davis.py."""

import numpy as np
import pytest
import torch

from adder_tpu_torch import testing
from torch_tools_common import (  # noqa: F401
    aedat4_path, both, pinned_jax_davis, run_port_tool)


@pytest.fixture(scope="module")
def stream_path(tmp_path_factory):
    """The 14 x 10 stream of tests/test_torch_dvs.py (seed 3, 300 events)."""
    w, h = 14, 10
    rng = np.random.default_rng(3)
    t = 10 + np.cumsum(rng.integers(1, 1500, 300))
    x, y, p = (rng.integers(0, w, 300), rng.integers(0, h, 300),
               rng.integers(0, 2, 300))
    path = tmp_path_factory.mktemp("dvs") / "s.raw"
    testing.write_prophesee_raw(path, w, h, t, x, y, p)
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--max-intervals", "3"],
                                   ["--batched"]],
                         ids=["defaults", "max-intervals", "batched"])
def test_prophesee_to_adder_writes_jax_bytes(stream_path, tmp_path,
                                             monkeypatch, capsys, extra):
    """The defaults, a cut after 3 view intervals, and `--batched` (the
    port's only route, accepted): the same bytes and line as the JAX
    tool's defaults with the same cut."""
    argv = ["-i", stream_path, "-o", "out.adder", *extra]
    jax_argv = [a for a in argv if a != "--batched"]
    (jrc, jout, jdir), _ = both("prophesee_to_adder", jax_argv, tmp_path,
                                monkeypatch, capsys)
    rc, out = run_port_tool("prophesee_to_adder", argv, tmp_path / "port",
                            monkeypatch, capsys)
    assert rc == jrc == 0
    assert out == jout and out.startswith("transcoded ")
    want = (jdir / "out.adder").read_bytes()
    assert len(want) > 1000
    assert (tmp_path / "port" / "out.adder").read_bytes() == want


@pytest.mark.parametrize("tool,argv", [
    ("prophesee_to_adder", ["-i", "in.raw", "-o", "out.adder"]),
    ("davis_to_adder", ["-i", "in.aedat4", "--output-events-filename",
                        "out.adder", "-t", "raw-davis"]),
])
def test_transcoders_refuse_no_batched(tool, argv, stream_path,
                                       aedat4_path,  # noqa: F811
                                       tmp_path, monkeypatch, capsys):
    """`--no-batched` runs the scalar per-event oracle in both tools, as in
    the JAX tools: the same `.adder` bytes and printed line as the JAX
    tool's `--no-batched` (the DAVIS tool with frames and events)."""
    inputs = {"in.raw": stream_path, "in.aedat4": aedat4_path}
    argv = [inputs.get(a, a) for a in argv] + ["--no-batched"]
    (jrc, jout, jdir), (rc, out, pdir) = both(tool, argv, tmp_path,
                                              monkeypatch, capsys)
    assert rc == jrc == 0
    assert out == jout and out.startswith("transcoded ")
    want = (jdir / "out.adder").read_bytes()
    assert len(want) > 1000
    assert (pdir / "out.adder").read_bytes() == want


@pytest.mark.parametrize("tool", ["prophesee_to_adder", "davis_to_adder"])
def test_transcoders_default_to_the_card(tool, stream_path, tmp_path,
                                         monkeypatch, capsys):
    """Without CUDA, the default `--torch-device cuda` raises as the port's
    entry points do; the tool does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = stream_path
    if tool == "davis_to_adder":
        ev, frames = testing.davis_stream(4, 20, 16, 20_000, n_frames=2,
                                          exposure_us=4000,
                                          background_events=200)
        src = str(tmp_path / "in.aedat4")
        testing.write_davis_aedat4(src, 20, 16, ev, frames)
    out = ["-o", "out.adder"] if tool == "prophesee_to_adder" else [
        "--output-events-filename", "out.adder"]
    with pytest.raises(RuntimeError, match="cuda"):
        run_port_tool(tool, ["-i", src, *out], tmp_path, monkeypatch,
                      capsys, device=None)


def test_davis_to_adder_crf_writes_jax_bytes(aedat4_path, tmp_path,  # noqa: F811
                                             monkeypatch, capsys,
                                             pinned_jax_davis):  # noqa: F811
    """`--crf 3`, set after write_out as the JAX tool sets it (the chunks
    take their CRF parameters from the encoder's options, which write_out
    replaces): the same bytes and line."""
    argv = ["-i", aedat4_path, "--output-events-filename", "out.adder",
            "-t", "raw-dvs", "--crf", "3"]
    (jrc, jout, jdir), (rc, out, pdir) = both(
        "davis_to_adder", argv, tmp_path, monkeypatch, capsys)
    assert rc == jrc == 0 and out == jout
    want = (jdir / "out.adder").read_bytes()
    assert len(want) > 500 and (pdir / "out.adder").read_bytes() == want
