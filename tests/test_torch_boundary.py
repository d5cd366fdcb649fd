"""The port's boundary: it runs without jax and without the JAX package
`adder_tpu`, and its CUDA build keeps the flags that hold the kernels to
IEEE f32."""

import pathlib
import re
import subprocess
import sys

import pytest

from adder_tpu_torch.ops import cuda_build

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "adder_tpu_torch"

_TINY_RUN = r"""
import io, os, sys
import numpy as np
if sys.argv[1] == "block":
    # any `import jax` or `import adder_tpu` now raises ImportError
    sys.modules["jax"] = sys.modules["adder_tpu"] = None
import adder_tpu_torch as at
from adder_tpu_torch.ops import fused_kernel, pallas_kernel
frames = np.random.default_rng(0).integers(0, 256, (6, 4, 5, 1)).astype(np.uint8)
for env in (None, "ADDER_TPU_RESIDENT", "ADDER_TPU_FUSED"):
    # the resident engine, then the fused and the interval-slot engines
    if env:
        os.environ[env] = "0"
    src = at.FramedArray(frames, chunk_frames=3, device="cpu")
    buf = io.BytesIO()
    src.write_out(at.SourceCamera.FramedU8, at.TimeMode.AbsoluteT,
                  at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                  at.EncoderOptions.default(src.video.plane), buf)
    if env:
        src.video._keep_running_frame = True
    n = 0
    while True:
        try:
            n += len(src.consume_batch())
        except EOFError:
            break
    src.video.end_write_stream()
    assert n > 0 and len(buf.getvalue()) > 9 * n
    if env:
        assert src.video.running_intensities.any()
        del os.environ[env]
assert not any(m.split(".")[0] in ("jax", "adder_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("OK", n)
"""


@pytest.mark.parametrize("jax_state", ["block", "installed"])
def test_port_runs_without_importing_jax(jax_state):
    """With jax and adder_tpu blocked, and with both importable: a tiny CPU
    transcode through each of the three Video engines runs and no jax or
    adder_tpu module gets imported."""
    proc = subprocess.run(
        [sys.executable, "-c", _TINY_RUN, jax_state], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_port_sources_never_import_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package (`adder_tpu`, as opposed to `adder_tpu_torch`)."""
    pat = re.compile(r"^\s*(import\s+(jax|adder_tpu)\b|"
                     r"from\s+(jax|adder_tpu)[\s.])", re.M)
    assert pat.search("from adder_tpu.codec import raw")
    assert pat.search("    import adder_tpu  # noqa")
    assert not pat.search("from adder_tpu_torch.ops import integrate")
    sources = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [
        str(p.relative_to(REPO)) for p in sources if pat.search(p.read_text())
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


_SHARDED_RUN = r"""
import io, sys
import numpy as np
sys.modules["jax"] = sys.modules["adder_tpu"] = None
import adder_tpu_torch as at
from adder_tpu_torch.parallel import multihost, sharding
from adder_tpu_torch.utils import tracing
tracing.set_enabled(True)
frames = np.random.default_rng(1).integers(0, 256, (4, 5, 7, 1)).astype(np.uint8)
v = at.ShardedVideo(at.PlaneSize(7, 5, 1), at.Mode.FramePerfect,
                    mesh=sharding.make_mesh(["cpu"] * 2))
buf = io.BytesIO()
v.write_out(at.SourceCamera.FramedU8, at.TimeMode.AbsoluteT,
            at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
            at.EncoderOptions.default(v.plane), buf)
v.submit_chunk(frames)
v.end_write_stream()
assert len(buf.getvalue()) > 100 and "sharded.encode" in tracing.report()
assert multihost.init_multihost() is False
assert not any(m.split(".")[0] in ("jax", "adder_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("OK")
"""


def test_sharded_modules_run_without_jax():
    """parallel/sharding.py, parallel/multihost.py, transcoder/sharded.py
    and utils/tracing.py run with jax and adder_tpu blocked: a tiny
    two-band ShardedVideo on the CPU, traced."""
    proc = subprocess.run([sys.executable, "-c", _SHARDED_RUN], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
