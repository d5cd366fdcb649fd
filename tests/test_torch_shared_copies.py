"""The port's own copies of the JAX package's host modules behave like the
originals: the core constants, the raw and compressed encoders (the same
bytes), the decoder (reads what JAX wrote), the native DVS and DAVIS
planners (the same rows and chain state), the aedat4 container, the cv and
viz helpers, the frame-value conversion, the ffmpeg decoder, the tools'
info, logging and stream-migration modules and the C++ sources of the
decoder and the framer's walk (the host framer, the player
and adder_to_dvs are held to theirs in test_torch_framer.py and
test_torch_pipelines.py). The
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
from adder_tpu.utils import cv as JCV
from adder_tpu.utils import viz as JVIZ
from adder_tpu_torch.codec import decoder as DEC
from adder_tpu_torch.codec import encoder as ENC
from adder_tpu_torch.codec import header as HDR
from adder_tpu_torch.core import types as T
from adder_tpu_torch.ops import native_build
from adder_tpu_torch.ops import native_dvs_plan as PLAN
from adder_tpu_torch.utils import aedat4 as AEDAT
from adder_tpu_torch.utils import cv as CV
from adder_tpu_torch.utils import viz as VIZ

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


def test_cv_copy_equals_jax():
    """The FAST constants, the scalar `is_feature` with its `_streak`, and
    the dense numpy `fast_mask` with its `_streak_mask`, on seeded images
    with corners and at every pixel (borders and channels included)."""
    assert CV.CIRCLE3 == JCV.CIRCLE3
    assert (CV.INTENSITY_THRESHOLD, CV.STREAK_SIZE) == (
        JCV.INTENSITY_THRESHOLD, JCV.STREAK_SIZE)
    rng = np.random.default_rng(12)
    imgs = [rng.integers(0, 256, (14, 17, 2), dtype=np.uint8),
            np.full((12, 12, 1), 128, dtype=np.uint8)]
    imgs[1][:6, :6] = 220
    for img in imgs:
        H, W, C = img.shape
        np.testing.assert_array_equal(CV.fast_mask(img), JCV.fast_mask(img))
        for thr in (10, 60):
            np.testing.assert_array_equal(CV.fast_mask(img, thr),
                                          JCV.fast_mask(img, thr))
        jp, tp = JT.PlaneSize(W, H, C), T.PlaneSize(W, H, C)
        for y in range(H):
            for x in range(W):
                for c in (None, 0, 1):
                    assert CV.is_feature(T.Coord(x, y, c), tp, img) == (
                        JCV.is_feature(JT.Coord(x, y, c), jp, img)), (x, y, c)
    m = rng.random((16, 9, 7)) < 0.6
    np.testing.assert_array_equal(CV._streak_mask(m), JCV._streak_mask(m))
    for row in m.reshape(16, -1).T:
        assert CV._streak(row) == JCV._streak(row)


def test_viz_copy_equals_jax():
    """ShowFeatureMode's values, and the markers and rectangles drawn on
    mono and colour frames (edges clipped), the default and a given
    colour."""
    assert [(m.name, int(m)) for m in VIZ.ShowFeatureMode] == [
        (m.name, int(m)) for m in JVIZ.ShowFeatureMode]
    for C in (1, 3):
        for color in (None, (10, 20, 30)):
            imgs = [np.zeros((9, 11, C), np.uint8) for _ in range(2)]
            for mod, img in zip((VIZ, JVIZ), imgs):
                mod.draw_feature_coord(1, 7, img, C != 1, color)
                mod.draw_feature_coord(6, 4, img, C != 1, color)
                mod.draw_rect(2, 1, 12, 6, img, C != 1, color)
            np.testing.assert_array_equal(imgs[0], imgs[1])
            assert imgs[0].any()


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


# --- the file sources' and the framer's copies ------------------------------


@pytest.mark.parametrize("rel", ["transcoder/native/videodec.cpp",
                                 "ops/native/framer_fill.cpp"])
def test_native_sources_are_copies(rel):
    """The C++ copies equal their originals but for the header line that
    names the source."""
    jax_src = {"transcoder/native/videodec.cpp":
               "adder_tpu/transcoder/native/videodec.cpp",
               "ops/native/framer_fill.cpp":
               "adder_tpu/ops/native/framer_fill.cpp"}[rel]
    head, body = (PORT / rel).read_text().split("\n", 1)
    assert jax_src in head
    assert body == (REPO / jax_src).read_text()


def test_scale_intensity_copy_equals_jax():
    """FramedViewMode, event_to_intensity, practical_d_max_for and
    get_frame_values in every view mode and output type, on seeded events
    (d past 128 and D_EMPTY included, dt 0 included)."""
    from adder_tpu.framer import scale_intensity as JSI
    from adder_tpu_torch.framer import scale_intensity as SI

    assert [(m.name, int(m)) for m in SI.FramedViewMode] == [
        (m.name, int(m)) for m in JSI.FramedViewMode]
    rng = np.random.default_rng(8)
    d = rng.integers(0, 256, 3000).astype(np.int64)
    dt = rng.integers(0, 9000, 3000).astype(np.uint64)
    dt[::17] = 0
    np.testing.assert_array_equal(SI.event_to_intensity(d, dt),
                                  JSI.event_to_intensity(d, dt))
    run_t = dt + rng.integers(0, 500, 3000).astype(np.uint64)
    for dtype in (np.uint8, np.uint16, np.uint32, np.uint64):
        pdm = SI.practical_d_max_for(float(np.iinfo(dtype).max), 7650, 255)
        assert pdm == JSI.practical_d_max_for(float(np.iinfo(dtype).max),
                                              7650, 255)
        for m in SI.FramedViewMode:
            sae = dict(sae_running_t=run_t, sae_last_fired_t=dt)
            for src_t in (T.SourceType.U8, T.SourceType.U16):
                got = SI.get_frame_values(d, dt, dtype, src_t, 255.0, pdm,
                                          7650, m, **sae)
                want = JSI.get_frame_values(d, dt, dtype,
                                            JT.SourceType(int(src_t)), 255.0,
                                            pdm, 7650,
                                            JSI.FramedViewMode(int(m)), **sae)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want, err_msg=f"{m}")


def test_file_source_colour_helpers_and_quality_metrics_equal_jax():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (21, 30, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0,
                255).astype(np.uint8)
    for name in ("handle_color_rgb_videors", "handle_color_videors"):
        for color in (False, True):
            np.testing.assert_array_equal(getattr(CV, name)(a, color),
                                          getattr(JCV, name)(a, color))
    assert CV.calculate_mse(a, b) == JCV.calculate_mse(a, b)
    assert CV.calculate_psnr(3.5) == JCV.calculate_psnr(3.5)
    assert CV.calculate_ssim(a, b) == JCV.calculate_ssim(a, b)
    for q in ((0.0, 0.0, None), (None, 0.0, 0.0)):
        got = CV.calculate_quality_metrics(a, b, CV.QualityMetrics(*q))
        want = JCV.calculate_quality_metrics(a, b, JCV.QualityMetrics(*q))
        assert (got.psnr, got.mse, got.ssim) == (want.psnr, want.mse,
                                                 want.ssim)
    z = CV.calculate_quality_metrics(a, a, CV.QualityMetrics())
    assert z.mse == 1e-7 == JCV.calculate_quality_metrics(
        a, a, JCV.QualityMetrics()).mse
    with pytest.raises(ValueError):
        CV.calculate_quality_metrics(a, b[:-1], CV.QualityMetrics())


def test_write_frames_to_video_equals_jax(tmp_path):
    import cv2

    rng = np.random.default_rng(10)
    for shape in ((5, 16, 24), (5, 16, 24, 3)):
        frames = rng.integers(0, 256, shape, dtype=np.uint8)
        decoded = []
        for mod in (VIZ, JVIZ):
            path = tmp_path / f"{mod.__name__}.{len(shape)}.mp4"
            assert mod.write_frames_to_video(frames, str(path), 24.0)
            cap = cv2.VideoCapture(str(path))
            got = []
            while True:
                ok, f = cap.read()
                if not ok:
                    break
                got.append(f)
            cap.release()
            decoded.append(np.stack(got))
        assert len(decoded[0]) == 5
        np.testing.assert_array_equal(decoded[0], decoded[1])


def test_ffdec_copy_decodes_like_jax(tmp_path):
    """decode_frames and StreamDecoder at scale 1 and 0.5 give the JAX
    copy's RGB24 frames; the library builds in the port's tree, named by
    a digest that covers the libav link arguments."""
    from adder_tpu.transcoder import ffdec as JFF
    from adder_tpu_torch.transcoder import ffdec as FF
    from test_torch_file_sources import write_clip

    clip = str(write_clip(tmp_path / "c.avi", "FFV1", n_frames=6, seed=2))
    for scale in (1.0, 0.5):
        got, fps = FF.decode_frames(clip, scale, max_frames=5)
        want, jfps = JFF.decode_frames(clip, scale, max_frames=5)
        assert fps == jfps and got.shape == want.shape == (
            5, int(32 * scale), int(48 * scale), 3)
        np.testing.assert_array_equal(got, want)
        sd, jsd = FF.StreamDecoder(clip, scale), JFF.StreamDecoder(clip, scale)
        assert (sd.width, sd.height, sd.fps) == (jsd.width, jsd.height,
                                                 jsd.fps)
        n = 0
        while (f := sd.read()) is not None:
            np.testing.assert_array_equal(f, jsd.read())
            n += 1
        assert n == 6 and jsd.read() is None
    so = native_build.library_path(FF._SOURCE, FF.LINK)
    assert so.exists() and so.parent == PORT / "build" / "native"
    assert so != native_build.library_path(FF._SOURCE)


def test_native_ingest_builds_in_the_port_tree_and_raises_on_failure(
        monkeypatch):
    from adder_tpu_torch.framer import native_ingest as NI

    NI._get_lib()
    so = native_build.library_path(NI._SOURCE)
    assert so.exists() and so.parent == PORT / "build" / "native"

    def broken(src, link=()):
        raise RuntimeError("g++ failed on framer_fill.cpp")

    monkeypatch.setattr(NI, "_lib", None)
    monkeypatch.setattr(native_build, "load", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        NI._get_lib()


# --- the multi-process helpers' and the tracer's copies ----------------------


def _code_of(fn_or_cls):
    """The AST of a function or class without its docstrings and type
    annotations, the JAX process queries named as the port's helpers."""
    import ast
    import inspect
    import textwrap

    src = textwrap.dedent(inspect.getsource(fn_or_cls))
    src = (src.replace("jax.process_index()", "process_index()")
           .replace("jax.process_count()", "process_count()"))
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(getattr(body[0], "value", None), ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            node.returns = None
            for a in node.args.args + node.args.kwonlyargs:
                a.annotation = None
        if isinstance(node, ast.AnnAssign):
            node.annotation = ast.Constant(None)
    return ast.dump(tree)


@pytest.mark.parametrize("name", ["host_pixel_slice", "host_rows",
                                  "local_band_frames", "write_event_part",
                                  "read_event_part", "merge_event_parts"])
def test_multihost_numpy_helpers_are_copies(name):
    """The plain numpy helpers of parallel/multihost.py are the JAX
    package's, but for the docstrings, the annotations and the process
    queries (torch.distributed's rank and world size for jax.process_index
    and jax.process_count)."""
    from adder_tpu.parallel import multihost as JMH
    from adder_tpu_torch.parallel import multihost as MH

    assert _code_of(getattr(MH, name)) == _code_of(getattr(JMH, name))
    assert (MH._PART_MAGIC, MH._PART_VERSION) == (JMH._PART_MAGIC,
                                                 JMH._PART_VERSION)


@pytest.mark.parametrize("name", ["StageStats", "enabled", "set_enabled",
                                  "stage", "add_items", "report", "reset",
                                  "summary_table"])
def test_tracing_copy_is_the_original(name):
    """utils/tracing.py keeps the original's registry, stages and report;
    only hard_sync and device_trace, which touch the device, differ."""
    from adder_tpu.utils import tracing as JTR
    from adder_tpu_torch.utils import tracing as TR

    assert _code_of(getattr(TR, name)) == _code_of(getattr(JTR, name))


# --- the tools' copies: info, logging, stream migration, cv ------------------


def _v1_deltat_file(types, enc, hdr, path):
    """A v1 DeltaT Raw stream of 2000 seeded framed events (`types`' and
    `enc`'s classes)."""
    plane = types.PlaneSize(13, 11, 1)
    meta = hdr.CodecMetadata(codec_version=1, plane=plane, tps=255 * 30,
                             ref_interval=255, delta_t_max=255 * 10,
                             time_mode=types.TimeMode.DeltaT,
                             source_camera=types.SourceCamera.FramedU8)
    rng = np.random.default_rng(8)
    n = 2000
    e = enc.Encoder.new_raw(meta, open(path, "wb"),
                            enc.EncoderOptions.default(plane))
    d = rng.integers(0, 20, n).astype(np.uint8)
    d[rng.random(n) < 0.05] = types.D_EMPTY
    e.ingest_event_array(types.EventArray(
        rng.integers(0, 13, n).astype(np.uint16),
        rng.integers(0, 11, n).astype(np.uint16),
        np.full(n, types.NO_CHANNEL, np.uint8), d,
        rng.integers(1, 255 * 10, n).astype(np.uint32)))
    e.close_writer().close()


def test_info_copy_prints_jax_report(tmp_path):
    """`adder_info` with and without the dynamic range, on an AbsoluteT
    colour stream and a v1 DeltaT one."""
    from adder_tpu.utils import info as JINFO
    from adder_tpu_torch.utils import info as INFO

    a = tmp_path / "abs.adder"
    a.write_bytes(_encode(JT, JENC, JHDR, "raw", 3))
    v1 = tmp_path / "v1.adder"
    _v1_deltat_file(T, ENC, HDR, v1)
    for path in (a, v1):
        for dr in (False, True):
            got = INFO.adder_info(str(path), dr)
            assert got == JINFO.adder_info(str(path), dr)
            assert ("Dynamic range" in got) == dr


def test_stream_migration_copy_writes_jax_bytes(tmp_path):
    """`migrate_v2` of a v1 DeltaT stream into a v3 AbsoluteT one: the same
    bytes; into a DeltaT one, the events passed through."""
    from adder_tpu.utils import stream_migration as JMIG
    from adder_tpu_torch.utils import stream_migration as MIG

    src = tmp_path / "v1.adder"
    _v1_deltat_file(T, ENC, HDR, src)
    outs = []
    for types, enc, hdr, dec, mig in ((T, ENC, HDR, DEC, MIG),
                                      (JT, JENC, JHDR, JDEC, JMIG)):
        for mode in (types.TimeMode.AbsoluteT, types.TimeMode.DeltaT):
            d = dec.open_file_decoder(str(src))
            m = d.meta
            meta = hdr.CodecMetadata(
                codec_version=hdr.LATEST_CODEC_VERSION, time_mode=mode,
                plane=types.PlaneSize(m.plane.width, m.plane.height, 1),
                tps=m.tps, ref_interval=m.ref_interval,
                delta_t_max=m.delta_t_max, source_camera=types.SourceCamera(
                    int(m.source_camera)))
            buf = io.BytesIO()
            e = enc.Encoder(enc.RawOutput(meta, buf),
                            enc.EncoderOptions.default(meta.plane))
            mig.migrate_v2(d, e).close_writer()
            outs.append(buf.getvalue())
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert len(outs[0]) > 2000 * 9 and outs[0] != outs[1]


def test_logging_copy_writes_jax_records():
    """FeatureLogger's JSON lines for every record kind, and LogFeature."""
    from adder_tpu.utils import logging as JLOG
    from adder_tpu_torch.utils import logging as LOG

    texts = []
    for mod, types in ((LOG, T), (JLOG, JT)):
        fh = io.StringIO()
        lg = mod.FeatureLogger(fh, types.PlaneSize(7, 5, 3))
        lg.log_bitrate(1234.5, 9)
        lg.log_features([mod.LogFeature(1, 2, "ADDER"), (3, 4)], "OpenCV",
                        77)
        lg.log_quality(30.5, 2.25, 91.0)
        lg.log_precision_recall(0.5, 0.25, 0.99)
        timer = mod.StageTimer(None)
        timer.start("s")
        assert timer.stop("s") >= 0
        texts.append(fh.getvalue())
    assert texts[0] == texts[1] and len(texts[0].splitlines()) == 5


def test_cv_tool_helpers_equal_jax():
    """`feature_precision_recall_accuracy` on seeded coordinate sets (and
    empty ones), and the log-intensity clamps at and past their edges."""
    rng = np.random.default_rng(13)
    for k in (0, 5, 40):
        gt = {tuple(v) for v in rng.integers(0, 20, (k, 2)).tolist()}
        pred = {tuple(v) for v in rng.integers(0, 20, (k + 3, 2)).tolist()}
        for a, b in ((gt, pred), (set(), pred), (gt, set())):
            assert CV.feature_precision_recall_accuracy(
                a, b, T.PlaneSize(20, 20, 1)) == \
                JCV.feature_precision_recall_accuracy(
                    a, b, JT.PlaneSize(20, 20, 1))
    for v in (-1.0, 0.0, 0.5, 128.0, 255.0, 255.5, 1e9):
        for ln in (0.1, 2.0):
            assert CV.clamp_u8(v, ln) == JCV.clamp_u8(v, ln)
            assert CV.mid_clamp_u8(v, ln) == JCV.mid_clamp_u8(v, ln)
