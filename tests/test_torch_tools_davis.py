"""`python -m adder_tpu_torch.tools.davis_to_adder` against
`tools/davis_to_adder.py`, in-process on the CPU, at tolerance 0: the same
`.adder` bytes and printed line from the same seeded aedat4 file
(`testing.davis_stream` + `write_davis_aedat4`), for each source mode at
the manual quality (the CLI without `--crf`), and the compressed sink with
both entropy coders; `--crf` is held in tests/test_torch_tools_transcoders.py. The JAX tool builds its Davis itself; its scan engine's sticky
capacities are pinned after construction, as tests/test_torch_davis.py
pins them (capacity only: the events do not depend on it), so that it
compiles once per parameter set."""

import pytest

from torch_tools_common import aedat4_path, both, pinned_jax_davis  # noqa: F401


@pytest.mark.parametrize("extra", [
    ["-t", "raw-davis"],
    ["-t", "raw-dvs"],
    ["-t", "framed", "--no-prefetch"],
    ["-t", "raw-davis", "--compressed"],
    ["-t", "raw-davis", "--compressed", "--entropy", "rans", "--batched"],
], ids=["raw-davis", "raw-dvs", "framed", "cabac", "rans"])
def test_davis_to_adder_writes_jax_bytes(aedat4_path, tmp_path,  # noqa: F811
                                         monkeypatch, capsys,
                                         pinned_jax_davis, extra):  # noqa: F811
    argv = ["-i", aedat4_path, "--output-events-filename", "out.adder",
            *extra]
    (jrc, jout, jdir), (rc, out, pdir) = both(
        "davis_to_adder", argv, tmp_path, monkeypatch, capsys)
    assert rc == jrc == 0
    assert out == jout and out.startswith("transcoded 3 packets")
    want = (jdir / "out.adder").read_bytes()
    assert len(want) > 500
    assert (pdir / "out.adder").read_bytes() == want
