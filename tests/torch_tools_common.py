"""Helpers of the tests/test_torch_tools_*.py files: run a JAX tool under
`tools/` and its port twin (`adder_tpu_torch.tools.<name>`) in-process,
each from a directory of its own, so that relative output paths, and the
lines that print them, are the same for both."""

import pathlib
import re
import runpy
import sys

import pytest

from adder_tpu_torch import testing

REPO = pathlib.Path(__file__).resolve().parents[1]

# the measured parts of a printed line: "<number> ms", "(<rate>/s ...)"
_TIMES = re.compile(r"\d+(\.\d+)?(e[-+]?\d+)? ?(ms|s|Mev/s|Mpx/s)\b")


def without_times(text: str) -> list:
    """The printed lines with every measured time and rate blanked."""
    return [_TIMES.sub("<t>", line) for line in text.splitlines()]


def run_jax_tool(name, argv, cwd, monkeypatch, capsys, script_dir="tools"):
    """`python tools/<name>.py *argv` in-process from `cwd`: (exit code,
    stdout). The JAX tools parse sys.argv."""
    path = REPO / script_dir / f"{name}.py"
    capsys.readouterr()
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [str(path), *map(str, argv)])
    try:
        runpy.run_path(str(path), run_name="__main__")
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                     else 1)
    finally:
        monkeypatch.chdir(REPO)
    return rc, capsys.readouterr().out


def run_port_tool(name, argv, cwd, monkeypatch, capsys, package="tools",
                  device="cpu"):
    """`python -m adder_tpu_torch.<package>.<name> *argv` in-process from
    `cwd`, with `--torch-device device` unless `device` is None: (exit
    code, stdout)."""
    import importlib

    mod = importlib.import_module(f"adder_tpu_torch.{package}.{name}")
    capsys.readouterr()
    monkeypatch.chdir(cwd)
    extra = [] if device is None else ["--torch-device", device]
    try:
        rc = mod.main([*map(str, argv), *extra])
    finally:
        monkeypatch.chdir(REPO)
    return rc, capsys.readouterr().out


def both(name, argv, tmp_path, monkeypatch, capsys, device="cpu",
         script_dir="tools", package="tools"):
    """Run the JAX tool and the port's from tmp_path/jax and tmp_path/port
    with the same arguments: ((rc, stdout, dir) of JAX, of the port)."""
    out = []
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        if side == "jax":
            rc, text = run_jax_tool(name, argv, d, monkeypatch, capsys,
                                    script_dir)
        else:
            rc, text = run_port_tool(name, argv, d, monkeypatch, capsys,
                                     package, device)
        out.append((rc, text, d))
    return out


def same_files(a: pathlib.Path, b: pathlib.Path, names) -> None:
    for n in names:
        got, want = (b / n).read_bytes(), (a / n).read_bytes()
        assert len(want) > 0 and got == want, n


@pytest.fixture(scope="module")
def aedat4_path(tmp_path_factory):
    """A DAVIS scene on the 14 x 12 plane of tests/test_torch_davis.py (so
    that the JAX scan engine, pinned alike, compiles the same programs): 3
    APS frames, about 1,000 DVS events."""
    events, frames = testing.davis_stream(
        2, 14, 12, 60_000, n_frames=3, exposure_us=8_000, n_hot=4,
        hot_events=30, edge_events=500, background_events=400)
    path = tmp_path_factory.mktemp("davis") / "in.aedat4"
    testing.write_davis_aedat4(str(path), 14, 12, events, frames)
    return str(path)


@pytest.fixture
def pinned_jax_davis(monkeypatch):
    """The JAX Davis with its scan engine's sticky capacities pinned after
    construction, as tests/test_torch_davis.py pins them (capacity only:
    the events do not depend on it), so that it compiles once per
    parameter set."""
    from adder_tpu.transcoder import davis as JD

    init = JD.Davis.__init__

    def pinned(self, *a, **kw):
        init(self, *a, **kw)
        self._scan_take, self._scan_lpad, self._mask_take = 4096, 8, 4096

    monkeypatch.setattr(JD.Davis, "__init__", pinned)
