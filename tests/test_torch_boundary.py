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
    # the command-line tools and the examples are among them
    for sub in ("tools", "examples"):
        assert len([p for p in sources if p.parent == PORT / sub]) > 2, sub
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


_DVS_RUN = r"""
import io, os, sys
import numpy as np
sys.modules["jax"] = sys.modules["adder_tpu"] = None
import adder_tpu_torch as at
from adder_tpu_torch import testing
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.transcoder import davis as TD
path = os.path.join(sys.argv[1], "s.raw")
testing.write_prophesee_raw(path, 9, 7, *testing.dvs_stream(
    3, 9, 7, 60_000, n_hot=2, hot_events=40, background_events=200))
calls = []
orig = FR.dvs_rows8_resident
FR.dvs_rows8_resident = lambda *a, **k: calls.append(1) or orig(*a, **k)
out = []
for batched in (True, False):
    src = at.Prophesee(20, path, batched=batched, device="cpu")
    src.crf(3)
    buf = io.BytesIO()
    src.write_out(at.SourceCamera.Dvs, at.TimeMode.AbsoluteT,
                  at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                  at.EncoderOptions.default(src.plane), buf)
    while True:
        try:
            src.consume()
        except EOFError:
            break
    src.end_write_stream()
    out.append(len(buf.getvalue()))
assert calls and min(out) > 1000, (calls, out)
rng = np.random.default_rng(2)
ev = TD.DvsEvents(t=np.sort(rng.integers(10, 900, 60)).astype(np.int64),
                  x=rng.integers(0, 6, 60), y=rng.integers(0, 5, 60),
                  on=rng.integers(0, 2, 60).astype(bool))
pk = [TD.DavisPacket(rng.integers(40, 200, (5, 6)).astype(np.uint8), 1000,
                     2000, ev)]
src = at.Davis(TD.ArrayDavisProvider(pk, at.PlaneSize(6, 5, 1)),
               batched=False, prefetch=False, device="cpu")
buf = io.BytesIO()
src.write_out(at.SourceCamera.DavisU8, at.TimeMode.AbsoluteT,
              at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
              at.EncoderOptions.default(src.plane), buf)
src.crf(3)
assert len(src.consume()) > 0
src.end_write_stream()
assert not any(m.split(".")[0] in ("jax", "adder_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("OK")
"""


def test_dvs_routes_and_oracle_run_without_jax(tmp_path):
    """With jax and adder_tpu blocked: a tiny Prophesee transcode on the
    CPU through the 8-byte carrier route (ops/native_dvs_plan.py's fused
    planner, the pipeline of transcoder/lanes.py) and through the scalar
    oracle (transcoder/pixel_oracle.py, batched=False), and a DAVIS packet
    through the oracle."""
    proc = subprocess.run([sys.executable, "-c", _DVS_RUN, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_every_c_entry_has_its_signature_declared():
    """Every `int adder_*(` entry the CUDA sources define is in
    cuda_build.SIGNATURES (an entry without one gets its pointers cut to
    32-bit ints by ctypes), with one c_void_p or integer type per
    parameter, and nothing else is declared."""
    import ctypes

    defined = {}
    for src in (PORT / "csrc").glob("*.cu"):
        for name, params in re.findall(r"^int (adder_\w+)\(([^)]*)\)",
                                       src.read_text(), re.M):
            defined[name] = [p for p in params.split(",") if p.strip()]
    assert set(defined) == set(cuda_build.SIGNATURES)
    for name, params in defined.items():
        argtypes = cuda_build.SIGNATURES[name]
        assert len(argtypes) == len(params), name
        for t, p in zip(argtypes, params):
            want = (ctypes.c_void_p if "*" in p else ctypes.c_longlong
                    if "long long" in p else ctypes.c_int)
            assert t is want, (name, p)
