"""The port's 8-byte DVS carrier route against the JAX package, on the CPU.

The fused native planner (`plan_dvs_pack8_native`), the numpy pack
(`pack_dvs_plan8`) and the decode (`unpack_dvs_carrier8`) of the port
against the JAX package's; one lane group through the port's plain 8-byte
route against the JAX packed8 entry (Pallas interpret mode); and whole
Prophesee transcodes through the 8-byte route and its pipeline, against the
JAX scan engine (where no window is segmented) and the port's own 20-byte
route. Inputs are made from numpy seeds; every comparison is bit for bit
(tolerance 0). The CUDA kernel `adder_dvs_rows8` is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adder_tpu.core.types import PixelMultiMode
from adder_tpu.ops import fused_resident as JFR
from adder_tpu.ops import native_dvs_plan as JNP
from adder_tpu.transcoder import prophesee as JP
from adder_tpu_torch import convert, testing
from adder_tpu_torch.codec.encoder import EncoderOptions, EncoderType
from adder_tpu_torch.core.types import SourceCamera, TimeMode
from adder_tpu_torch.ops import dvs_batch as B
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.ops import native_dvs_plan as NP
from adder_tpu_torch.transcoder import lanes
from adder_tpu_torch.transcoder import prophesee as TP

from test_torch_dvs import (MIDGREY_LN, _assert_state_equal, _jax_state,
                            _params, _transcode, open_file_decoder_bytes)

FIELDS8 = ("row0", "row1", "dict0", "dict1", "lane_off", "gap_cnt",
           "tick_cnt")


def _stream_23x11(seed=7, n_ev=4000):
    """tests/test_dvs_batch.py's fused-planner stream: 23 x 11, times
    spread over 9 s so gap_n passes 2^20."""
    w, h = 23, 11
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(5, 9_000_000, n_ev)).astype(np.uint32)
    xs = rng.integers(0, w, n_ev).astype(np.uint16)
    ys = rng.integers(0, h, n_ev).astype(np.uint16)
    ps = rng.integers(0, 2, n_ev).astype(np.uint8)
    return w, h, ts, xs, ys, ps


def _chains(n, k=2):
    return [[np.full(n, 2, np.uint32), np.full(n, MIDGREY_LN),
             np.full(n, np.nan)] for _ in range(k)]


def _stream_vga(n_ev=30_000):
    """A 640 x 480 stream (pb 19): a band and a background, 0.2 s."""
    ts, xs, ys, ps = testing.dvs_stream(13, 640, 480, 200_000, n_hot=5,
                                        hot_events=70, band_events=20_000,
                                        background_events=n_ev - 20_350)
    return 640, 480, ts, xs, ys, ps


@pytest.mark.parametrize("stream", [_stream_23x11, _stream_vga],
                         ids=["23x11", "640x480-pb19"])
def test_native_pack8_equals_jax(stream):
    """The fused native plan + pack on the same window and chain: the same
    rows, dictionary, lane boundaries, per-lane counts, pb and chain state
    (last_t, last_ln, the exp memo) as the JAX package's."""
    w, h, ts, xs, ys, ps = stream()
    n = w * h
    chains = _chains(n)
    got = NP.plan_dvs_pack8_native(ts, xs, ys, ps, w, n, *chains[0][:2],
                                   0.02, 20, val_cache=chains[0][2])
    want = JNP.plan_dvs_pack8_native(ts, xs, ys, ps, w, n, *chains[1][:2],
                                     0.02, 20, val_cache=chains[1][2])
    assert got is not None and want is not None
    assert (got.n_lanes, got.pb) == (want.n_lanes, want.pb)
    assert got.pb == FR.pix_bits(n) == (19 if n == 640 * 480 else 8)
    for f in FIELDS8:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(*chains):
        np.testing.assert_array_equal(a, b)
    assert len(got.row0) > 1000 and got.n_lanes > 1


def _infeasible(kind):
    """A window the 8-byte layout cannot hold, and the planner's extra
    arguments: a pixel past lane_cap lanes; a gap past the i32
    gap_n x ref product; more than 64 (value, fv) pairs."""
    w, h = 5, 4
    n = w * h
    if kind == "lane past lane_cap":
        n_ev = 300
        ts = np.arange(10, 10 + 2 * n_ev, 2, dtype=np.uint32)
        xs, ys = np.full(n_ev, 2, np.uint16), np.full(n_ev, 1, np.uint16)
        return w, n, ts, xs, ys, (np.arange(n_ev) % 2).astype(np.uint8), \
            dict(ref=20, lane_cap=8)
    rng = np.random.default_rng(4)
    if kind == "gap_n past its field":
        ts = np.array([10, 5_000_000, 5_000_010], np.uint32)
        xs, ys = np.array([1, 1, 2], np.uint16), np.array([0, 0, 3], np.uint16)
        return w, n, ts, xs, ys, np.array([1, 0, 1], np.uint8), \
            dict(ref=1000)
    # a small theta, and each pixel's polarity fixed by its column: the
    # chains walk the whole ln range, over a hundred distinct values
    n_ev = 4000
    ts = np.sort(rng.integers(3, 200_000, n_ev)).astype(np.uint32)
    xs = rng.integers(0, w, n_ev).astype(np.uint16)
    return (w, n, ts, xs, rng.integers(0, h, n_ev).astype(np.uint16),
            (xs % 2).astype(np.uint8), dict(ref=20, theta=0.005))


@pytest.mark.parametrize("kind", ["lane past lane_cap",
                                  "gap_n past its field",
                                  "dictionary over 64"])
def test_native_pack8_infeasible_restores_the_chain(kind):
    """A window that does not fit gives None in both packages, with the
    chain state (last_t, last_ln, the exp memo) exactly as it was; the
    classic plan from that chain equals JAX's."""
    w, n, ts, xs, ys, ps, kw = _infeasible(kind)
    theta = kw.pop("theta", 0.02)
    ref = kw.pop("ref")
    chains = _chains(n)
    chains[0][0][3] = chains[1][0][3] = 7  # a chain that has started
    before = [a.copy() for a in chains[0]]
    got = NP.plan_dvs_pack8_native(ts, xs, ys, ps, w, n, *chains[0][:2],
                                   theta, ref, val_cache=chains[0][2], **kw)
    want = JNP.plan_dvs_pack8_native(ts, xs, ys, ps, w, n, *chains[1][:2],
                                     theta, ref, val_cache=chains[1][2],
                                     **kw)
    assert got is None and want is None
    for a, b, c in zip(chains[0], chains[1], before):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    plan = B.plan_dvs_compact(ts, xs, ys, ps, w, *chains[0][:2], theta, ref,
                              val_cache=chains[0][2])
    assert len(plan.pix) > 0
    if kind == "dictionary over 64":  # the numpy pack refuses it too
        g = plan.lane_slice(0, min(plan.n_lanes, 64))
        assert FR.pack_dvs_plan8(g, n, ref) is None
        assert JFR.pack_dvs_plan8(g, len(g.pix), n, ref) is None


def test_native_pack8_needs_its_library(monkeypatch):
    """A library that does not build raises; nothing gives way to a numpy
    plan or to the 20-byte carrier."""
    from adder_tpu_torch.ops import native_build

    def broken(src):
        raise RuntimeError("g++: no compiler")

    monkeypatch.setattr(NP, "_lib", None)
    monkeypatch.setattr(native_build, "load", broken)
    w, h, ts, xs, ys, ps = _stream_23x11(n_ev=50)
    lt, ln, vc = _chains(w * h, 1)[0]
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        NP.plan_dvs_pack8_native(ts, xs, ys, ps, w, w * h, lt, ln, 0.02, 20,
                                 val_cache=vc)


def _classic_groups(seed=7, n_ev=4000):
    w, h, ts, xs, ys, ps = _stream_23x11(seed, n_ev)
    n = w * h
    lt, ln, vc = _chains(n, 1)[0]
    plan = B.plan_dvs_compact(ts, xs, ys, ps, w, lt, ln, 0.02, 20,
                              val_cache=vc)
    # groups of 8 lanes, so that the window gives several
    return n, [plan.lane_slice(g0, g0 + 8)
               for g0 in range(0, plan.n_lanes, 8)]


def test_pack8_and_unpack8_equal_jax():
    """Each lane group of the classic plan: `pack_dvs_plan8` gives the
    JAX package's bytes (JAX called with E_pad = E) and pb; the plain
    `unpack_dvs_carrier8` gives JAX's nine fields bit for bit, and the
    planner's own fields where a half is on."""
    n, groups = _classic_groups()
    assert len(groups) > 1
    names = ("pix", "lane", "gap_on", "gap_fv", "gap_int", "gap_time",
             "tick_on", "tick_fv", "tick_int")
    for g in groups:
        got, pb = FR.pack_dvs_plan8(g, n, 20)
        want, jpb = JFR.pack_dvs_plan8(g, len(g.pix), n, 20)
        assert pb == jpb and got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        mine = FR.unpack_dvs_carrier8(torch.from_numpy(got), pb, 20)
        theirs = JFR.unpack_dvs_carrier8(jnp.asarray(want), jpb, 20)
        for name, a, b in zip(names, mine, theirs):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype, name
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            np.testing.assert_array_equal(a, b, err_msg=name)
        for name, a in zip(names, mine):
            on = (g.gap_on if name.startswith("gap") and name != "gap_on"
                  else slice(None))
            want_f = getattr(g, name)
            a = a.numpy()
            if a.dtype == np.float32:
                a, want_f = a.view(np.int32), want_f.view(np.int32)
            np.testing.assert_array_equal(a[on], want_f[on], err_msg=name)
    assert max(int(g.gap_n.max()) for g in groups) > 1 << 20


def test_rows8_plain_matches_pallas_packed8_kernel():
    """Two chained lane groups, each as its 8-byte carrier, through
    `dvs_rows8_resident_plain` and through the TPU kernel's packed8 entry
    (make_dvs_chunk_resident_packed8, Pallas interpret mode, 2 blocks of
    128 pixels, the carrier decoded in-graph) plus its host assembler:
    events in order, counts, flags and state, field by field."""
    kp, pp = _params(PixelMultiMode.Collapse)
    w, h, lanes_ = 16, 16, 2
    n, T = w * h, 2 * lanes_
    ts, xs, ys, ps = testing.dvs_stream(5, w, h, 50_000, n_hot=2,
                                        hot_events=2 * lanes_ + 4,
                                        background_events=3 * n)
    plan = B.plan_dvs_compact(ts, xs, ys, ps, w, np.full(n, 2, np.uint32),
                              np.full(n, MIDGREY_LN), 0.02, 20)
    pb = FR.pix_bits(n)
    fn = JFR.make_dvs_chunk_resident_packed8(kp, 19 * n * T, T, n, pb,
                                             pallas_block=128,
                                             interpret=True, depth=16)
    js = _jax_state(n)
    ts_ = convert.state_from_numpy(js, "cpu")
    for g in range(2):
        sl = plan.lane_slice(g * lanes_, (g + 1) * lanes_)
        rows, got_pb = FR.pack_dvs_plan8(sl, n, 20)
        assert got_pb == pb
        js, bp, bt, total, per_interval, pmax, counts = fn(
            js, jnp.asarray(rows))
        total = int(total)
        rp, rt = JFR.assemble_resident_events(
            np.asarray(bp[:total]), np.asarray(bt[:total]),
            np.asarray(counts))
        got = FR.dvs_rows8_resident_plain(ts_, torch.from_numpy(rows), T, pp,
                                          pb=pb)
        assert total == len(got.pixd) > 0
        np.testing.assert_array_equal(got.per_interval.numpy(),
                                      np.asarray(per_interval))
        np.testing.assert_array_equal(got.pixd.numpy().view(np.uint32), rp)
        np.testing.assert_array_equal(got.t.numpy().view(np.uint32), rt)
        assert int(got.pmax) == int(pmax)
        _assert_state_equal(js, got.state)
        ts_ = got.state


def test_rows8_route_equals_the_20_byte_route_on_cpu():
    """`testing.check_dvs_rows8_against_plain` at a small size: the 8-byte
    wrapper (events, void, with the pipeline's capacity) and its plain
    version equal the 20-byte route on the same rows, and the 8-byte glue
    its plain version and the 20-byte grouping, for planned groups, no
    rows, one pixel's rows, halves off, a dictionary of 64, gap_n past
    2^20, a forced depth-16 overflow (the 640 x 480 plane, pb 19, runs on
    the card; its pack is held to JAX's above)."""
    assert testing.check_dvs_rows8_against_plain(
        "cpu", H=11, W=23, lanes=(1, 3), big=None) == 0.0


def test_rows8_wrapper_refuses_a_wrong_carrier():
    """On the CPU the wrapper runs the plain version; the glue refuses an
    8-byte carrier of one sub-step a lane, and a group's plan whose lane
    passes 63 does not pack."""
    n, groups = _classic_groups(n_ev=300)
    with pytest.raises(ValueError):
        FR.group_dvs_rows(torch.zeros((2, 70), dtype=torch.int32), 2, 1, 8)
    g = groups[0]
    assert FR.pack_dvs_plan8(g._replace(lane=g.lane + 64), n, 20) is None


def _raw(tmp_path, name, seed, w, h, dur, **kw):
    path = str(tmp_path / f"{name}.raw")
    testing.write_prophesee_raw(path, w, h,
                                *testing.dvs_stream(seed, w, h, dur, **kw))
    return path


def _twenty_byte_only(monkeypatch):
    """The port's 20-byte route alone: no fused plan, no 8-byte pack."""
    monkeypatch.setattr(NP, "plan_dvs_pack8_native", lambda *a, **k: None)
    monkeypatch.setattr(FR, "pack_dvs_plan8", lambda *a, **k: None)


def _count_routes(monkeypatch):
    calls = {"8": 0, "20": 0, "raster": 0}

    def spy(orig, key):
        def f(*a, **kw):
            calls["raster" if kw.get("groups") is not None else key] += 1
            return orig(*a, **kw)
        return f

    monkeypatch.setattr(FR, "dvs_rows8_resident",
                        spy(FR.dvs_rows8_resident, "8"))
    monkeypatch.setattr(FR, "dvs_rows_resident",
                        spy(FR.dvs_rows_resident, "20"))
    return calls


def test_windowed_transcode_takes_8_bytes_and_writes_jax_bytes(
        tmp_path, monkeypatch):
    """A windowed transcode (60 windows a second) of the 14 x 10 stream of
    tests/test_torch_dvs.py: every lane group on the 8-byte carrier (the
    bootstrap and the flush as 20-byte raster chunks), the same bytes as
    the JAX scan engine, and the same as the port's 20-byte route."""
    w, h = 14, 10
    rng = np.random.default_rng(3)
    t = 10 + np.cumsum(rng.integers(1, 1500, 300))
    x, y, p = (rng.integers(0, w, 300), rng.integers(0, h, 300),
               rng.integers(0, 2, 300))
    path = str(tmp_path / "s.raw")
    testing.write_prophesee_raw(path, w, h, t, x, y, p)
    with monkeypatch.context() as m:
        calls = _count_routes(m)
        got = _transcode(TP.Prophesee(20, path, device="cpu"))
    assert calls["8"] > 3 and calls["20"] == 0 and calls["raster"] == 2
    want = _transcode(JP.Prophesee(20, path, batched=True, engine="scan"))
    assert got == want and len(got) > 1000
    _twenty_byte_only(monkeypatch)
    assert _transcode(TP.Prophesee(20, path, device="cpu")) == got


def test_segmented_and_bulk_transcodes_equal_the_20_byte_route(
        tmp_path, monkeypatch):
    """One window cut into segments of 100 events (a pixel of more than 64
    lanes in a segment: two lane groups) and a bulk void run: the 8-byte
    route's bytes, per-pixel streams and state equal the port's 20-byte
    route's, and the void run ends in the fetched run's state; the native
    pack forced off, the per-group 8-byte pack (the fallback) writes the
    same bytes."""
    w, h = 14, 10
    path = _raw(tmp_path, "seg", 9, w, h, 200_000, n_hot=1, hot_events=140,
                background_events=35)
    monkeypatch.setenv("ADDER_TPU_DVS_SEG_EVENTS", "100")

    def run(void=False):
        src = TP.Prophesee(20, path, view_fps=1, device="cpu")
        if not void:
            return _transcode(src), src
        src.void_events = True
        src.crf(3)
        src.write_out(SourceCamera.Dvs, TimeMode.AbsoluteT,
                      PixelMultiMode.Collapse, None, EncoderType.Empty,
                      EncoderOptions.default(src.plane), None)
        while True:
            try:
                src.consume()
            except EOFError:
                break
        return None, src

    with monkeypatch.context() as m:
        calls = _count_routes(m)
        got, src8 = run()
        assert calls["8"] >= 3 and calls["20"] == 0
        _, void8 = run(void=True)
    with monkeypatch.context() as m:
        m.setattr(NP, "plan_dvs_pack8_native", lambda *a, **k: None)
        calls = _count_routes(m)
        fallback, _ = run()
        assert calls["8"] >= 3 and calls["20"] == 0
    _twenty_byte_only(monkeypatch)
    want, src20 = run()
    assert got == want == fallback and len(got) > 1000
    for a, b in zip(src8.state, src20.state):
        assert torch.equal(a, b)
    for a, b in zip(void8.state, src8.state):
        assert torch.equal(a, b)


def test_staged_pipeline_delivers_the_synchronous_order(tmp_path,
                                                        monkeypatch):
    """A windowed transcode of a dozen groups with groups in flight
    across windows: the encoder receives the same events in the same order
    as with nothing staged and nothing in flight (the synchronous route);
    a run stopped after 5 windows hands its groups in flight to the
    encoder at end_write_stream."""
    w, h = 14, 10
    path = _raw(tmp_path, "pipe", 21, w, h, 150_000, n_hot=3,
                hot_events=100, background_events=500)
    depth = []

    def record(orig):
        def f(self, state):
            depth.append(len(self))
            return orig(self, state)
        return f

    def run(windows=0):
        ingested = []
        src = TP.Prophesee(20, path, device="cpu")
        orig = src.video.write_out

        def write_out(*a, **kw):
            orig(*a, **kw)
            enc = src.video.encoder
            ing = enc.ingest_event_array
            enc.ingest_event_array = lambda arr: (
                ingested.append(np.stack([arr.x, arr.y, arr.d, arr.t])),
                ing(arr))

        src.video.write_out = write_out
        data = _transcode(src, windows=windows)
        return data, np.concatenate(ingested, axis=1)

    with monkeypatch.context() as m:
        m.setattr(lanes.LanePipeline, "step",
                  record(lanes.LanePipeline.step))
        staged = run()
        staged5 = run(windows=5)
    assert max(depth) >= 3  # one staged and two in flight
    monkeypatch.setattr(lanes.LanePipeline, "max_staged", 0)
    monkeypatch.setattr(lanes.LanePipeline, "max_in_flight", 0)
    sync = run()
    sync5 = run(windows=5)
    assert staged[0] == sync[0] and len(sync[0]) > 1000
    np.testing.assert_array_equal(staged[1], sync[1])
    assert staged5[0] == sync5[0] and len(staged5[0]) < len(sync[0])
    assert open_file_decoder_bytes(staged5[0]) == open_file_decoder_bytes(
        sync5[0])


def test_lane_event_cap_bounds_every_group(tmp_path, monkeypatch):
    """The capacity the pipeline gives a group, 19 events a cell of the
    host plan, holds every group's events on a busy stream (the plain
    route: buffers exact, total on the host)."""
    w, h = 14, 10
    path = _raw(tmp_path, "cap", 9, w, h, 200_000, n_hot=1, hot_events=140,
                background_events=35)
    seen = []
    orig = FR.dvs_rows8_resident

    def spy(state, carrier, T, p, events=True, groups=None, **kw):
        res = orig(state, carrier, T, p, events=events, groups=groups, **kw)
        seen.append((int(res.total), kw["event_cap"]))
        return res

    monkeypatch.setattr(FR, "dvs_rows8_resident", spy)
    _transcode(TP.Prophesee(20, path, view_fps=1, device="cpu"))
    assert seen and all(0 <= t <= cap for t, cap in seen)
    assert sum(t for t, _ in seen) > 0
