"""The port's boundary: it runs without jax, and its CUDA build keeps the
flags that hold the kernels to IEEE f32."""

import pathlib
import re
import subprocess
import sys

import pytest

from adder_tpu_torch.ops import cuda_build

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "adder_tpu_torch"

_TINY_RUN = r"""
import io, sys
import numpy as np
if sys.argv[1] == "block":
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
import adder_tpu_torch as at
frames = np.random.default_rng(0).integers(0, 256, (6, 4, 5, 1)).astype(np.uint8)
src = at.FramedArray(frames, chunk_frames=3, device="cpu")
buf = io.BytesIO()
src.write_out(at.SourceCamera.FramedU8, at.TimeMode.AbsoluteT,
              at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
              at.EncoderOptions.default(src.video.plane), buf)
n = 0
while True:
    try:
        n += len(src.consume_batch())
    except EOFError:
        break
src.video.end_write_stream()
assert n > 0 and len(buf.getvalue()) > 9 * n
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print("OK", n)
"""


@pytest.mark.parametrize("jax_state", ["block", "installed"])
def test_port_runs_without_importing_jax(jax_state):
    """With jax blocked, and with jax installed: a tiny CPU transcode runs
    and no jax module gets imported."""
    proc = subprocess.run(
        [sys.executable, "-c", _TINY_RUN, jax_state], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    offenders = [
        str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
        if pat.search(p.read_text())
    ]
    assert offenders == []


def test_nvcc_command_is_exact_ieee_for_sm90a():
    cmd = cuda_build.nvcc_command(pathlib.Path("out.so"))
    line = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in line
    assert "--fmad=false" in cmd
    assert "--prec-div=true" in cmd
    for bad in ("--use_fast_math", "-use_fast_math", "-ftz=true",
                "--ftz=true"):
        assert bad not in cmd
    sources = [pathlib.Path(c) for c in cmd if c.endswith(".cu")]
    assert sources and all(s.exists() for s in sources)
    assert cuda_build.library_path().parent == cuda_build.BUILD_DIR
