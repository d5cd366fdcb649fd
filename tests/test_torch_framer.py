"""The port's framers against the JAX package's, on the CPU, at tolerance 0.

- `FrameSequence` (the host framer: the native walk, and the numpy
  segmented scans when features are detected) pops the JAX framer's values
  and ends in its running state, in every view mode, both time modes, u8,
  u16 and u64 output, coordless, over several batches; with features on,
  the feature intervals are the JAX package's.
- `DeviceFramer` on CPU tensors pops the frames of the JAX `DeviceFramer`
  (CPU jit) and of the host framer, on per-pixel chains that honour
  delta_t_max (the inputs of tests/test_device_framer.py), with a small
  `batch_cap` so carries cross batches, and a window that wraps; a DeltaT
  chain past 2^31 raises as the JAX one does, while a span past
  delta_t_max and an ingest deeper than the window, where the JAX framer
  raises, give the host framer's frames (the passes and the window grow),
  as does a Collapse DeltaT stream of the transcoder whose D_EMPTY fillers
  span more than delta_t_max; no real window cell is written twice in one
  span-fill pass.
Inputs are made from numpy seeds; the two packages' EventArray classes
differ, so the events cross as numpy arrays.
"""

import numpy as np
import pytest
import torch

from adder_tpu.core import types as JT
from adder_tpu.framer import device as JDEV
from adder_tpu.framer import driver as JDRV
from adder_tpu.framer import scale_intensity as JSI
from adder_tpu_torch.core import types as T
from adder_tpu_torch.testing import framer_chains
from adder_tpu_torch.framer import device as DEV
from adder_tpu_torch.framer import driver as DRV
from adder_tpu_torch.framer import scale_intensity as SI

PKGS = {"jax": (JT, JDRV, JSI), "port": (T, DRV, SI)}


def events_of(types, ev):
    """`ev` (x, y, c, d, t numpy arrays) as `types`' EventArray."""
    return types.EventArray(*ev)


def builder(pkg, plane, tps, ref, dtm, fps, version, t_mode, *,
            view="Intensity", dtype=np.uint8, coordless=False,
            features=False):
    types, drv, si = PKGS[pkg]
    b = drv.FramerBuilder(types.PlaneSize(*plane))
    b.view_mode = si.FramedViewMode[view]
    b.out_dtype = dtype
    b.coordless = coordless
    b.detect_features = features
    return (b.time_parameters(tps, ref, dtm, fps)
            .codec_meta(version, types.TimeMode(t_mode))
            .source_info(types.SourceType.U8, types.SourceCamera.FramedU8))


def random_stream(rng, plane, n, t_mode, t0=0):
    """Random events honouring per-pixel order (driver.rs:1068-1074):
    DeltaT t are per-event deltas; AbsoluteT streams are sorted by t and
    start at `t0`."""
    W, H, C = plane
    x = rng.integers(0, W, n).astype(np.uint16)
    y = rng.integers(0, H, n).astype(np.uint16)
    c = (np.full(n, 255, np.uint8) if C == 1
         else rng.integers(0, C, n).astype(np.uint8))
    d = rng.integers(0, 130, n).astype(np.uint8)
    d[rng.random(n) < 0.05] = 255  # D_EMPTY
    if t_mode == 1:  # AbsoluteT
        t = np.sort(rng.integers(1, 60_000, n) + t0).astype(np.uint32)
    else:
        t = rng.integers(0, 3_000, n).astype(np.uint32)
    return x, y, c, d, t


def run_host(fs, types, batches):
    frames = []
    for ev in batches:
        fs.ingest_event_array(events_of(types, ev))
        while fs.is_frame_0_filled():
            frames.append(fs.pop_next_frame())
    fs.flush_frame_buffer()
    while fs.is_frame_0_filled():
        frames.append(fs.pop_next_frame())
    return frames


def same_host_framers(b_jax, b_port, batches):
    """Both framers through `batches`, their popped frames held equal;
    returns (port framer, JAX framer)."""
    ref = b_jax.finish()
    want = run_host(ref, JT, batches)
    fs = b_port.finish()
    got = run_host(fs, T, batches)
    assert len(got) == len(want) > 2
    for i, ((gv, gf), (wv, wf)) in enumerate(zip(got, want)):
        assert gv.dtype == wv.dtype
        np.testing.assert_array_equal(gv, wv, err_msg=f"frame {i}")
        np.testing.assert_array_equal(gf, wf, err_msg=f"filled {i}")
    return fs, ref


@pytest.mark.parametrize("view", [m.name for m in SI.FramedViewMode])
@pytest.mark.parametrize("t_mode", [0, 1], ids=["deltaT", "absT"])
def test_frame_sequence_equals_jax(view, t_mode):
    rng = np.random.default_rng(1234 + 7 * int(SI.FramedViewMode[view])
                                + t_mode)
    plane = (17, 11, 3)
    # about 8 events a pixel, the AbsoluteT batches one after another
    batches = [random_stream(rng, plane, 6 * n, t_mode, t0)
               for n, t0 in ((800, 0), (1, 60_000), (500, 60_000))]
    args = (plane, 24_000, 1000, 4000, 24.0, 2, t_mode)
    fs, ref = same_host_framers(builder("jax", *args, view=view),
                                builder("port", *args, view=view), batches)
    for f in ("running_ts", "last_filled", "last_intensity"):
        np.testing.assert_array_equal(getattr(fs, f), getattr(ref, f), f)
    assert sorted(fs.frames) == sorted(ref.frames)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint64])
@pytest.mark.parametrize("coordless", [False, True], ids=["values",
                                                          "coordless"])
def test_frame_sequence_dtypes_coordless(dtype, coordless):
    rng = np.random.default_rng(77)
    plane = (9, 7, 1)
    batches = [random_stream(rng, plane, 600, 0),
               random_stream(rng, plane, 300, 0)]
    args = (plane, 24_000, 1000, 4000, 24.0, 1, 0)
    same_host_framers(
        builder("jax", *args, dtype=dtype, coordless=coordless),
        builder("port", *args, dtype=dtype, coordless=coordless), batches)


def test_frame_sequence_features_equal_jax():
    """Feature detection takes the numpy segmented scans in both packages;
    the feature intervals and the display frame are the JAX framer's."""
    rng = np.random.default_rng(5)
    plane = (24, 20, 1)
    batches = [random_stream(rng, plane, 8 * n, 1, t0)
               for n, t0 in ((1500, 0), (900, 60_000))]
    args = (plane, 24_000, 1000, 4000, 24.0, 2, 1)
    fs, ref = same_host_framers(builder("jax", *args, features=True),
                                builder("port", *args, features=True),
                                batches)
    got = [(fi.end_ts, fi.features) for fi in fs.features]
    assert got == [(fi.end_ts, fi.features) for fi in ref.features]
    assert sum(len(f) for _, f in got) > 0
    np.testing.assert_array_equal(fs.running_intensities,
                                  ref.running_intensities)
    a, b = fs.pop_features(), ref.pop_features()
    assert (a.end_ts, a.features) == (b.end_ts, b.features)


# --- the device framer -------------------------------------------------


def drive_device(df, types, ev, splits):
    """Ingest `ev` in slices at `splits`, popping every complete frame
    after each (pop_ready_frames) and draining at the end."""
    out = []
    lo = 0
    for hi in [*splits, len(ev[0])]:
        df.ingest_event_array(events_of(types, [a[lo:hi] for a in ev]))
        out.extend(df.pop_ready_frames())
        lo = hi
    out.extend(df.drain())
    return out


def drive_host_whole(b, types, ev):
    fs = b.finish()
    return [v for v, _ in run_host(fs, types, [ev])]


DEVICE_CASES = [
    # (view, coordless, version, t_mode, plane, batch_cap, window,
    #  events per ingest, or 0 for one ingest)
    ("Intensity", False, 2, 1, (32, 24, 1), 1024, None, 0),
    ("Intensity", False, 0, 0, (32, 24, 1), 1024, None, 0),
    ("D", False, 2, 1, (16, 12, 1), 512, None, 0),
    ("DeltaT", False, 0, 0, (16, 12, 1), 512, None, 0),
    ("SAE", False, 2, 1, (16, 12, 1), 512, None, 0),
    ("SAE", False, 0, 0, (16, 12, 1), 512, None, 0),
    ("Intensity", True, 0, 0, (16, 12, 1), 512, None, 0),
    ("Intensity", True, 2, 1, (12, 10, 3), 333, None, 0),
    # a window of 24 rows that wraps: 20 events a pixel span about 50
    # frames, ingested 150 events (about 3 frames) at a time
    ("Intensity", False, 2, 1, (16, 12, 1), 256, 24, 150),
    ("D", False, 0, 0, (16, 12, 1), 256, 24, 150),
]


@pytest.mark.parametrize("case", DEVICE_CASES,
                         ids=[f"{c[0]}-{'coordless' if c[1] else 'v'}-"
                              f"{'abs' if c[3] else 'delta'}-w{c[6]}"
                              for c in DEVICE_CASES])
def test_device_framer_equals_jax_and_host(case):
    view, coordless, version, t_mode, plane, cap, window, step = case
    ev = framer_chains(plane, 20 if window else 12, 8000, 3 + t_mode,
                       t_mode == 1)
    splits = range(step, len(ev[0]), step) if step else ()
    args = (plane, 60_000, 1000, 8000, 60.0, version, t_mode)
    kw = dict(view=view, coordless=coordless)
    bj, bp = builder("jax", *args, **kw), builder("port", *args, **kw)
    want = drive_device(JDEV.DeviceFramer(bj, batch_cap=cap, window=window),
                        JT, ev, splits)
    df = DEV.DeviceFramer(bp, batch_cap=cap, window=window, device="cpu")
    got = drive_device(df, T, ev, splits)
    host = drive_host_whole(builder("port", *args, **kw), T, ev)
    assert len(got) == len(want) == len(host) > (30 if window else 5)
    for i, (g, w, h) in enumerate(zip(got, want, host)):
        assert g.dtype == w.dtype == h.dtype
        np.testing.assert_array_equal(g, w, err_msg=f"frame {i} vs jax")
        np.testing.assert_array_equal(g, h, err_msg=f"frame {i} vs host")
    if window:
        assert df.frames_written > window + 12  # the window wrapped


def test_device_framer_pop_next_frame_and_flush():
    """The frame-at-a-time pops (pop_next_frame, then a flush that
    back-fills from the carries) give the host framer's frames."""
    plane = (16, 12, 1)
    ev = framer_chains(plane, 12, 8000, 9, True)
    args = (plane, 60_000, 1000, 8000, 60.0, 2, 1)
    df = DEV.DeviceFramer(builder("port", *args), batch_cap=512,
                          device="cpu")
    df.ingest_event_array(events_of(T, ev))
    got = []
    while df.is_frame_0_filled():
        got.append(df.pop_next_frame())
    assert df.pop_next_frame() is None
    if df.flush_frame_buffer():
        while (f := df.pop_next_frame()) is not None:
            got.append(f)
    host = drive_host_whole(builder("port", *args), T, ev)
    assert len(got) == len(host) > 5
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g, h)


def overflow_inputs(kind):
    """(builder args, events, window) where only one overflow condition of
    the device framer holds."""
    one = lambda t: (np.array([0], np.uint16), np.array([0], np.uint16),
                     np.array([255], np.uint8), np.array([5], np.uint8),
                     np.array(t, np.uint32))
    if kind == "window":
        # every gap within dtm (spans <= 10 frames), 90 frames deep on a
        # window of 64 rows and nothing popped
        t = np.arange(1, 91) * 1000
        ev = tuple(np.repeat(a, 90) for a in one([0])[:4]) + (
            t.astype(np.uint32),)
        return ((1, 1, 1), 60_000, 1000, 8000, 60.0, 2, 1), ev, None
    if kind == "span":
        # one silence of 20 frames, past max_span = 8000 // 1000 + 2
        return ((1, 1, 1), 60_000, 1000, 8000, 60.0, 2, 1), tuple(
            np.concatenate([a, b]) for a, b in zip(one([500]), one([20_500]))
        ), None
    # a DeltaT chain past 2^31 at tpf 2^28: frame 8, inside the span and
    # the window
    tpf = 1 << 28
    return (((1, 1, 1), tpf * 30, tpf, 1 << 31, 30.0, 0, 0),
            one([(1 << 31) + 5]), None)


@pytest.mark.parametrize("kind", ["window", "span", "chain"])
def test_device_framer_overflows_raise(kind):
    """Only the DeltaT chain past 2^31 raises in the port; the JAX device
    framer raises on all three. Past its window or its header span bound
    the port grows and pops the host framer's frames."""
    args, ev, window = overflow_inputs(kind)
    df = DEV.DeviceFramer(builder("port", *args), window=window,
                          device="cpu")
    rows, span = df.window, df.max_span
    with pytest.raises(OverflowError):
        JDEV.DeviceFramer(builder("jax", *args), window=window
                          ).ingest_event_array(events_of(JT, ev))
    if kind == "chain":
        assert df.max_span > 8 and df.window > 8
        with pytest.raises(OverflowError):
            df.ingest_event_array(events_of(T, ev))
        return
    got = drive_device(df, T, ev, ())
    host = drive_host_whole(builder("port", *args), T, ev)
    assert len(got) == len(host) > 15
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g, h)
    assert (df.window > rows) if kind == "window" else (df.max_span > span)


@pytest.mark.parametrize("t_mode", [1, 0], ids=["absT", "deltaT"])
def test_device_framer_window_past_free_memory_raises(monkeypatch, t_mode):
    """A window that would outgrow the device's free memory raises a named
    OverflowError before it is allocated (AbsoluteT: grown from the latest
    time before the upload; DeltaT: grown for the rerun), and one that
    fits grows as before."""
    args = ((1, 1, 1), 60_000, 1000, 8000, 60.0, 2, t_mode)
    t = np.arange(1, 91) * 1000 if t_mode else np.full(90, 1000)
    ev = (np.zeros(90, np.uint16), np.zeros(90, np.uint16),
          np.full(90, 255, np.uint8), np.full(90, 5, np.uint8),
          t.astype(np.uint32))
    df = DEV.DeviceFramer(builder("port", *args), device="cpu")
    # 64 rows held, 96 wanted: 9 bytes a cell, one cell a row
    monkeypatch.setattr(DEV, "_free_bytes",
                        lambda device: 96 * 9 - 64 * 9 - 1)
    with pytest.raises(OverflowError, match="free"):
        df.ingest_event_array(events_of(T, ev))
    assert df.window == 64
    monkeypatch.setattr(DEV, "_free_bytes", lambda device: 96 * 9 - 64 * 9)
    df = DEV.DeviceFramer(builder("port", *args), device="cpu")
    got = drive_device(df, T, ev, ())
    host = drive_host_whole(builder("port", *args), T, ev)
    assert df.window == 96 and len(got) == len(host) >= 89
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g, h)


def test_device_framer_inside_limits_does_not_raise():
    """The same shapes one step inside each limit ingest cleanly."""
    args = ((1, 1, 1), 60_000, 1000, 8000, 60.0, 2, 1)
    t = np.arange(1, 60) * 1000  # 59 frames deep, window 64
    ev = (np.zeros(59, np.uint16), np.zeros(59, np.uint16),
          np.full(59, 255, np.uint8), np.full(59, 5, np.uint8),
          t.astype(np.uint32))
    df = DEV.DeviceFramer(builder("port", *args), device="cpu")
    df.ingest_event_array(events_of(T, ev))
    assert len(df.pop_ready_frames()) == 59


def test_span_fill_writes_each_real_cell_once_per_pass(monkeypatch):
    """Count the writes per flat window index in every span-fill pass: the
    real cells (all but the dummy slot) are written at most once, so the
    scatter's unordered duplicate writes only ever hit the dummy."""
    plane = (16, 12, 1)
    ev = framer_chains(plane, 20, 8000, 21, True)
    args = (plane, 60_000, 1000, 8000, 60.0, 2, 1)
    df = DEV.DeviceFramer(builder("port", *args), batch_cap=700, window=24,
                          device="cpu")
    dummy = df.window * df.n
    counts = []
    orig = DEV._write_pass

    def counting(planes, flat, values):
        real = flat[flat != dummy]
        counts.append((len(real), int(torch.bincount(real).max())
                       if len(real) else 0))
        orig(planes, flat, values)

    monkeypatch.setattr(DEV, "_write_pass", counting)
    frames = drive_device(df, T, ev, range(150, len(ev[0]), 150))
    assert len(frames) > 30
    assert len(counts) > 3 * df.max_span
    assert sum(n for n, _ in counts) >= df.n * len(frames) // 2
    assert max(m for _, m in counts) == 1


def test_device_framer_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = builder("port", (4, 3, 1), 60_000, 1000, 8000, 60.0, 2, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        DEV.DeviceFramer(b)


def test_device_framer_holds_to_host_where_u32_rounding_wraps():
    """AbsoluteT times within ref_interval of 2^32: the JAX step rounds
    them up in u32 and wraps to 0, so its chain stops guarding and it keeps
    events the host framer (u64) drops (255 frames against the host's 253
    on this stream). The port computes in int64 and pops the host framer's
    frames."""
    ref = 1 << 26
    rng = np.random.default_rng(1)
    pix, t = [], []
    for p in range(12):
        tp = np.cumsum(rng.integers(1, ref // 3, 800))
        tp = tp[tp < (1 << 32)]
        pix.append(np.full(len(tp), p))
        t.append(tp)
    pix, t = np.concatenate(pix), np.concatenate(t)
    order = np.argsort(t, kind="stable")
    pix, t = pix[order], t[order]
    assert (t > (1 << 32) - ref).sum() > 50
    ev = ((pix % 4).astype(np.uint16), (pix // 4).astype(np.uint16),
          np.full(len(pix), 255, np.uint8),
          rng.integers(0, 32, len(pix)).astype(np.uint8), t.astype(np.uint32))
    args = ((4, 3, 1), ref * 60, ref, 4 * ref, 240.0, 2, 1)
    host = drive_host_whole(builder("port", *args), T, ev)
    df = DEV.DeviceFramer(builder("port", *args), device="cpu")
    got = drive_device(df, T, ev, range(10, len(t), 10))
    assert len(got) == len(host) == 253
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g, h)


def collapse_deltat_adder(path):
    """A 100 x 8 crop of the bench scene (rows 100-107, columns 600-699 of
    `moving_blobs(1080, 1920, 64, seed=7)`) transcoded by the port at the
    reference's criterion-bench config (FramePerfect, Collapse, DeltaT,
    ref_time 255, delta_t_max 24 x 255, c_thresh 0) into `path`."""
    import adder_tpu_torch as at
    from adder_tpu_torch import testing

    frames = testing.moving_blobs(1080, 1920, 64, seed=7, device="cpu",
                                  rows=(100, 108)).numpy()
    src = at.FramedArray(np.ascontiguousarray(frames[:, :, 600:700, None]),
                         30.0, chunk_frames=16, device="cpu")
    src.auto_time_parameters(255, 255 * 24, at.TimeMode.DeltaT)
    src.quality_manual(0, 0, 24, 1, 0)
    with open(path, "wb") as f:
        src.write_out(at.SourceCamera.FramedU8, at.TimeMode.DeltaT,
                      at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                      at.EncoderOptions.default(src.video.plane), f)
        while True:
            try:
                src.consume_batch()
            except EOFError:
                break
        src.video.end_write_stream()


@pytest.mark.parametrize("step,window", [(0, 16), (2000, None)],
                         ids=["one-ingest", "ingests"])
def test_device_framer_frames_collapse_fillers_past_delta_t_max(tmp_path,
                                                                step, window):
    """Collapse mode's D_EMPTY fillers carry the summed time of the events
    they replace: on this crop of the bench scene they span 8160 ticks,
    more than the header's delta_t_max of 6120. DeviceFramer, built from
    the header as it stands, pops the frames of the port's host
    FrameSequence bit for bit, and the JAX FrameSequence gives the same
    frames. The JAX DeviceFramer bounds a span by delta_t_max and raises
    OverflowError on this stream, so it is not the yardstick here. One
    ingest of the whole file into a window of 16 rows runs again, grown;
    ingests of 2000 events pop between them."""
    from adder_tpu.codec.decoder import open_file_decoder as jax_open
    from adder_tpu_torch.codec.decoder import open_file_decoder

    path = tmp_path / "collapse.adder"
    collapse_deltat_adder(path)
    dec = open_file_decoder(str(path))
    m = dec.meta
    events = dec.digest_all()
    assert m.delta_t_max == 6120 and m.time_mode == T.TimeMode.DeltaT
    fillers = events.d == T.D_EMPTY
    assert fillers.any() and events.t[fillers].max() > m.delta_t_max
    ev = tuple(getattr(events, f) for f in ("x", "y", "c", "d", "t"))
    fps = m.tps / m.ref_interval

    def b(pkg):
        types, drv, _ = PKGS[pkg]
        d = jax_open(str(path)) if pkg == "jax" else dec
        return (drv.FramerBuilder(types.PlaneSize(
                    m.plane.width, m.plane.height, m.plane.channels))
                .time_parameters(m.tps, m.ref_interval, m.delta_t_max, fps)
                .codec_meta(m.codec_version, types.TimeMode(int(m.time_mode)))
                .source_info(types.SourceType(int(d.get_source_type())),
                             types.SourceCamera(int(m.source_camera))))

    host = drive_host_whole(b("port"), T, ev)
    jax_host = drive_host_whole(b("jax"), JT, ev)
    with pytest.raises(OverflowError):
        JDEV.DeviceFramer(b("jax")).ingest_event_array(events_of(JT, ev))
    df = DEV.DeviceFramer(b("port"), batch_cap=4096, window=window,
                          device="cpu")
    splits = range(step, len(ev[0]), step) if step else ()
    got = drive_device(df, T, ev, splits)
    assert len(got) == len(host) == len(jax_host) > 50
    for i, (g, h, j) in enumerate(zip(got, host, jax_host)):
        assert g.dtype == h.dtype
        np.testing.assert_array_equal(g, h, err_msg=f"frame {i} vs host")
        np.testing.assert_array_equal(h, j, err_msg=f"frame {i} vs jax")
    assert df.max_span > m.delta_t_max // m.ref_interval + 2
    assert df.window >= (len(got) if window else 64)
