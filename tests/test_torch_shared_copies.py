"""The port's own copies of the JAX package's host modules behave like the
originals: the core constants, the raw and compressed encoders (the same
bytes), the decoder (reads what JAX wrote), the native DVS and DAVIS
planners (the same rows and chain state), and the aedat4 container. The
classes differ across the two packages, so values cross as numpy arrays
and IntEnum values. A subprocess checks that the port imports no jax and
no `adder_tpu` module. Tolerance: none.
"""

import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from adder_tpu.codec import decoder as JDEC
from adder_tpu.codec import encoder as JENC
from adder_tpu.codec import header as JHDR
from adder_tpu.core import types as JT
from adder_tpu.ops import native_dvs_plan as JPLAN
from adder_tpu.utils import aedat4 as JAEDAT
from adder_tpu_torch.codec import decoder as DEC
from adder_tpu_torch.codec import encoder as ENC
from adder_tpu_torch.codec import header as HDR
from adder_tpu_torch.core import types as T
from adder_tpu_torch.ops import native_build
from adder_tpu_torch.ops import native_dvs_plan as PLAN
from adder_tpu_torch.utils import aedat4 as AEDAT

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "adder_tpu_torch"


def test_core_constants_and_enums_equal_jax():
    for name in ("D_MAX", "D_ZERO_INTEGRATION", "D_NO_EVENT", "D_EMPTY",
                 "D_START", "MAX_INTENSITY", "EOF_PX_ADDRESS", "NO_CHANNEL"):
        assert getattr(T, name) == getattr(JT, name), name
    assert list(T.D_SHIFT) == list(JT.D_SHIFT)
    assert T.EVENT_DTYPE == JT.EVENT_DTYPE
    for enum_name in ("SourceCamera", "SourceType", "TimeMode", "Mode",
                      "PixelMultiMode"):
        port, jax = getattr(T, enum_name), getattr(JT, enum_name)
        assert [(m.name, int(m)) for m in port] == [(m.name, int(m))
                                                    for m in jax]
        assert port is not jax and port(0) == jax(0)  # by value, not class
    assert not isinstance(T.PlaneSize(4, 3, 1), JT.PlaneSize)
    assert T.PlaneSize(4, 3, 2).volume() == JT.PlaneSize(4, 3, 2).volume()
    for v in (0.0, 0.5, 1.0, 3.0, 255.0, 1e9):
        assert T.get_d_from_intensity(v) == JT.get_d_from_intensity(v)


def _events(mod, n=4000, w=37, h=23, c=1, seed=5):
    """One seeded EventArray of `mod`'s class, field by field."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, 255 * 40, n)).astype(np.uint32)
    chan = (rng.integers(0, c, n).astype(np.uint8) if c > 1
            else np.full(n, mod.NO_CHANNEL, np.uint8))
    return mod.EventArray(rng.integers(0, w, n).astype(np.uint16),
                          rng.integers(0, h, n).astype(np.uint16), chan,
                          rng.integers(0, 20, n).astype(np.uint8), t)


def _encode(types, enc, hdr, kind, channels, entropy="cabac"):
    plane = types.PlaneSize(37, 23, channels)
    meta = hdr.CodecMetadata(
        codec_version=hdr.LATEST_CODEC_VERSION,
        time_mode=types.TimeMode.AbsoluteT, plane=plane, tps=255 * 30,
        ref_interval=255, delta_t_max=255 * 30,
        source_camera=types.SourceCamera.FramedU8, adu_interval=1)
    buf = io.BytesIO()
    opts = enc.EncoderOptions.default(plane)
    if kind == "raw":
        e = enc.Encoder(enc.RawOutput(meta, buf), opts)
    else:
        e = enc.Encoder.new_compressed(meta, buf, opts, entropy=entropy)
    ev = _events(types, c=channels)
    for lo in range(0, len(ev), 1000):  # several ingests, several ADUs
        e.ingest_event_array(ev[lo : lo + 1000])
    e.close_writer()
    return buf.getvalue()


@pytest.mark.parametrize("kind,channels,entropy", [
    ("raw", 1, None), ("raw", 3, None), ("compressed", 1, "cabac"),
    ("compressed", 3, "rans"),
])
def test_encoders_write_jax_bytes(kind, channels, entropy):
    want = _encode(JT, JENC, JHDR, kind, channels, entropy)
    got = _encode(T, ENC, HDR, kind, channels, entropy)
    assert len(want) > 1000 and got == want


@pytest.mark.parametrize("kind", ["raw", "compressed"])
def test_decoder_reads_jax_written_file(tmp_path, kind):
    path = tmp_path / f"jax.{kind}.adder"
    path.write_bytes(_encode(JT, JENC, JHDR, kind, 1))
    got = DEC.open_file_decoder(str(path))
    want = JDEC.open_file_decoder(str(path))
    assert got.meta.plane.volume() == want.meta.plane.volume()
    assert int(got.meta.time_mode) == int(want.meta.time_mode)
    a, b = got.digest_all(), want.digest_all()
    assert isinstance(a, T.EventArray) and len(a) == len(b) > 1000
    for f in ("x", "y", "c", "d", "t"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _burst(seed, w=23, h=17, n_ev=3000):
    rng = np.random.default_rng(seed)
    n = w * h
    ts = np.sort(rng.integers(0, 2500, n_ev))
    xs = rng.integers(0, w, n_ev).astype(np.uint16)
    ys = rng.integers(0, h, n_ev).astype(np.uint16)
    ps = rng.integers(0, 2, n_ev).astype(np.uint8)
    ln = rng.uniform(-1.0, 1.2, n)
    ln[rng.random(n) < 0.05] = 5.0
    return w, n, rng, ts, xs, ys, ps, ln


def _same_plan(got, want, chains):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, g, e in zip(got._fields, got, want):
        assert g.dtype == e.dtype, name
        np.testing.assert_array_equal(g, e, err_msg=name)
    for a, b in zip(*chains):
        np.testing.assert_array_equal(a, b)
    assert len(got.pix) > 100


def test_native_dvs_planner_equals_jax():
    w, n, rng, ts, xs, ys, ps, ln = _burst(41)
    lt = rng.integers(0, 900, n).astype(np.uint32)
    chains = [[lt.copy(), ln.copy(), np.full(n, np.nan)] for _ in range(2)]
    got = PLAN.plan_dvs_native(ts.astype(np.uint32), xs, ys, ps, w,
                               chains[0][0], chains[0][1], 0.3, 20,
                               val_cache=chains[0][2])
    want = JPLAN.plan_dvs_native(ts.astype(np.uint32), xs, ys, ps, w,
                                 chains[1][0], chains[1][1], 0.3, 20,
                                 val_cache=chains[1][2])
    _same_plan(got, want, chains)


def test_native_davis_planner_equals_jax():
    w, n, rng, ts, xs, ys, ps, ln = _burst(42)
    lt = rng.integers(0, 900, n).astype(np.int64)
    lt[rng.random(n) < 0.1] = 0  # chains that never started drop an event
    chains = [[lt.copy(), ln.copy(), np.full(n, np.nan)] for _ in range(2)]
    got = PLAN.plan_davis_native(ts.astype(np.int64), xs, ys, ps != 0, w,
                                 chains[0][0], chains[0][1], 0.15, 255, 255.0,
                                 val_cache=chains[0][2])
    want = JPLAN.plan_davis_native(ts.astype(np.int64), xs, ys, ps != 0, w,
                                   chains[1][0], chains[1][1], 0.15, 255,
                                   255.0, val_cache=chains[1][2])
    _same_plan(got, want, chains)
    assert 0 < len(got.pix) < len(ts)


def test_native_libraries_build_in_the_port_tree():
    src = PORT / "ops" / "native" / "dvs_plan.cpp"
    PLAN._get_lib()
    so = native_build.library_path(src)
    assert so.exists() and so.parent == PORT / "build" / "native"
    assert native_build.library_path(
        PORT / "codec" / "native" / "adder_entropy.cpp").parent == so.parent


def test_aedat4_copy_reads_and_writes_like_jax(tmp_path):
    rng = np.random.default_rng(3)
    n = 500
    t = np.sort(rng.integers(0, 50_000, n)).astype(np.int64)
    x, y = rng.integers(0, 40, n), rng.integers(0, 30, n)
    on = rng.integers(0, 2, n).astype(np.int8)
    img = rng.integers(0, 256, (30, 40)).astype(np.uint8)
    paths = []
    for mod in (AEDAT, JAEDAT):
        path = tmp_path / f"{mod.__name__}.aedat4"
        w = mod.Aedat4Writer(str(path), 40, 30)
        w.write_events(t, x, y, on)
        w.write_frame(25_000, 20_000, 30_000, img)
        w.close()
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    got = list(AEDAT.Aedat4Reader(str(paths[1])).packets())
    want = list(JAEDAT.Aedat4Reader(str(paths[1])).packets())
    assert [type(p).__name__ for p in got] == [type(p).__name__
                                               for p in want]
    np.testing.assert_array_equal(got[0].events, want[0].events)
    np.testing.assert_array_equal(got[1].image, want[1].image)
    assert got[1].exposure_end_t == want[1].exposure_end_t == 30_000


def test_port_modules_import_no_jax_and_no_adder_tpu():
    """Every module of the port, imported in a fresh process: no jax and no
    adder_tpu module gets loaded."""
    names = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {names!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'adder_tpu'))\n"
        "assert not bad, bad\n"
        "print('OK', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
    assert len(names) > 20
