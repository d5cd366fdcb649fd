"""The port's Prophesee DVS path against the JAX package, on the CPU.

Inputs are made from numpy seeds and go through both packages; every
comparison is bit for bit (tolerance 0). The JAX side runs as its own tests
run it here: eager `masked_interval`, the numpy and native planners, the
Pallas kernel in interpret mode, and `Prophesee(..., engine="scan")`, the
engine JAX picks on the CPU. The port's CUDA kernel is checked on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import io
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adder_tpu.codec.decoder import open_file_decoder
from adder_tpu.codec.encoder import EncoderOptions, EncoderType
from adder_tpu.core.types import PixelMultiMode, SourceCamera, TimeMode
from adder_tpu.ops import dvs_batch as JB
from adder_tpu.ops import fused_resident as JFR
from adder_tpu.ops import integrate as K
from adder_tpu.transcoder import prophesee as JP
from adder_tpu_torch import convert, testing
from adder_tpu_torch.ops import dvs_batch as B
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.ops import integrate as P
from adder_tpu_torch.transcoder import prophesee as TP

MULTI = [PixelMultiMode.Collapse, PixelMultiMode.Normal]
MIDGREY_LN = float(np.log1p(128.0 / 255.0))


def _params(multi):
    cfg = dict(mode=1, multi_mode=int(multi), time_mode=1, ref_time=20,
               delta_t_max=40, c_thresh_max=6, c_increase_velocity=2)
    return K.TranscodeParams(**cfg), P.TranscodeParams(**cfg)


def _jax_state(n, depth=16):
    st = K.init_state(n, depth=depth)
    return st._replace(c_thresh=jnp.full((n,), 3, jnp.int32),
                       c_increase_counter=jnp.zeros((n,), jnp.int32))


def _assert_state_equal(jax_state, port_state, skip=()):
    port = convert.state_to_numpy(port_state)
    for f in K.PixelState._fields:
        if f not in skip:
            np.testing.assert_array_equal(np.asarray(getattr(jax_state, f)),
                                          port[f], err_msg=f)


def _substep_inputs(rng, n):
    """Gap-like (long spans, large intensity) or tick-like inputs."""
    gn = rng.integers(0, 3000, n)
    inten = (rng.uniform(0, 255, n).astype(np.float32)
             * gn.astype(np.float32)).astype(np.float32)
    tspan = (gn * 20).astype(np.float32)
    tick = rng.random(n) < 0.5
    inten = np.where(tick, rng.uniform(0, 255, n), inten).astype(np.float32)
    tspan = np.where(tick, 20.0, tspan).astype(np.float32)
    fv = rng.integers(0, 256, n).astype(np.int32)
    return inten, tspan, fv


@pytest.mark.parametrize("multi", MULTI, ids=lambda m: m.name)
def test_interval_core_per_pixel_time_and_ovf_mask_match_jax(multi):
    """`_interval_core` with per-pixel time and an overflow mask: slots,
    state and the masked overflow count equal JAX's at depth 16."""
    kp, pp = _params(multi)
    n = 96
    rng = np.random.default_rng(1)
    base = testing.forced_overflow_state(torch.full((n,), 128, dtype=torch.uint8),
                                         n // 3, depth=16)
    js = K.PixelState(*(jnp.asarray(v) for v in
                        convert.state_to_numpy(base).values()))
    inten, tspan, fv = _substep_inputs(rng, n)
    inten[: n // 3], tspan[: n // 3], fv[: n // 3] = 128.0, 20.0, 128
    mask = rng.random(n) < 0.5
    s_j, s_p = K._S.unstack(js), P._S.unstack(base)
    slots_j, _ = K._interval_core(s_j, jnp.asarray(inten), jnp.asarray(fv),
                                  jnp.asarray(tspan), kp,
                                  emit_running=False,
                                  ovf_mask=jnp.asarray(mask))
    slots_p = P._interval_core(s_p, torch.from_numpy(inten),
                               torch.from_numpy(fv), torch.from_numpy(tspan),
                               pp, ovf_mask=torch.from_numpy(mask))
    assert len(slots_j) == len(slots_p) == 19
    for (dj, tj, mj), (dp, tp, mp) in zip(slots_j, slots_p):
        mj = np.asarray(mj)
        np.testing.assert_array_equal(mj, mp.numpy())
        np.testing.assert_array_equal(np.asarray(dj)[mj], dp.numpy()[mj])
        np.testing.assert_array_equal(np.asarray(tj)[mj].astype(np.int64),
                                      tp.numpy()[mj])
    _assert_state_equal(s_j.restack(), s_p.restack())
    assert 0 < int(s_p.overflow) < n // 3  # counted for masked pixels only


@pytest.mark.parametrize("multi", MULTI, ids=lambda m: m.name)
def test_masked_interval_matches_jax(multi):
    """Twelve chained masked sub-steps with gap-sized and tick-sized
    spans and an adapting c_thresh: state and slots equal JAX's."""
    kp, pp = _params(multi)
    n = 160
    rng = np.random.default_rng(2)
    js = _jax_state(n)
    ts = convert.state_from_numpy(js, "cpu")
    for _ in range(12):
        inten, tspan, fv = _substep_inputs(rng, n)
        mask = rng.random(n) < 0.6
        js, sd, stt, sm, _ = JB.masked_interval(
            js, jnp.asarray(inten), jnp.asarray(fv), jnp.asarray(tspan),
            jnp.asarray(mask), kp)
        ts, sd2, stt2, sm2 = B.masked_interval(
            ts, torch.from_numpy(inten), torch.from_numpy(fv),
            torch.from_numpy(tspan), torch.from_numpy(mask), pp)
        m = np.asarray(sm)
        np.testing.assert_array_equal(m, sm2.numpy())
        np.testing.assert_array_equal(np.asarray(sd)[m], sd2.numpy()[m])
        np.testing.assert_array_equal(np.asarray(stt)[m].astype(np.int64),
                                      stt2.numpy()[m])
        _assert_state_equal(js, ts)


def _planner_inputs():
    """The inputs of tests/test_dvs_batch.py's native-planner test: drops,
    tick-only and gap + tick events, both mid-clamp branches."""
    w, h = 23, 17
    n = w * h
    rng = np.random.default_rng(41)
    n_ev = 3000
    ts = np.sort(rng.integers(0, 2500, n_ev)).astype(np.uint32)
    xs = rng.integers(0, w, n_ev).astype(np.uint16)
    ys = rng.integers(0, h, n_ev).astype(np.uint16)
    ps = rng.integers(0, 2, n_ev).astype(np.uint8)
    lt = rng.integers(0, 900, n).astype(np.uint32)
    ln = rng.uniform(-1.0, 1.2, n)
    ln[rng.random(n) < 0.05] = 5.0
    return w, n, ts, xs, ys, ps, lt, ln


def test_planner_matches_jax_planners():
    w, n, ts, xs, ys, ps, lt, ln = _planner_inputs()
    chains = [(lt.copy(), ln.copy()) for _ in range(3)]
    cache = np.full(n, np.nan)
    got = B.plan_dvs_compact(ts, xs, ys, ps, w, *chains[0], 0.3, 20,
                             val_cache=cache)
    want_np = JB.plan_dvs_batch_compact_np(ts, xs, ys, ps, w, n, *chains[1],
                                           0.3, 20)
    want = JB.plan_dvs_batch_compact(ts, xs, ys, ps, w, n, *chains[2], 0.3,
                                     20)
    assert got._fields == want._fields and len(got._fields) == 12
    for ref in (want_np, want):
        for name, g, e in zip(got._fields, got, ref):
            np.testing.assert_array_equal(g, e, err_msg=name)
            assert g.dtype == e.dtype, name
    for lt_j, ln_j in chains[1:]:
        np.testing.assert_array_equal(chains[0][0], lt_j)
        np.testing.assert_array_equal(chains[0][1], ln_j)
    assert got.n_lanes == want.n_lanes > 2
    sub, sub_j = got.lane_slice(1, 3), want.lane_slice(1, 3)
    for g, e in zip(sub, sub_j):
        np.testing.assert_array_equal(g, e)


def test_build_dvs_planes_through_carrier_matches_jax():
    """Rows packed into the (5, E) carrier, unpacked and scattered, give
    JAX's planes (tick time derived from ref_time)."""
    w, n, ts, xs, ys, ps, lt, ln = _planner_inputs()
    plan = B.plan_dvs_compact(ts, xs, ys, ps, w, lt, ln, 0.3, 20)
    L = plan.n_lanes
    T = 2 * L
    fields = FR.unpack_dvs_carrier(torch.from_numpy(FR.pack_dvs_plan(plan)))
    got = FR.build_dvs_planes(T, n, *fields, ref_time=20)
    want = JFR.build_dvs_planes(
        T, n, *(jnp.asarray(getattr(plan, f)) for f in (
            "pix", "lane", "gap_on", "gap_fv", "gap_int", "gap_time",
            "tick_on", "tick_fv", "tick_int")), None, ref_time=20)
    for g, e in zip(got, want):
        assert g.dtype == getattr(torch, str(np.asarray(e).dtype))
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def _plan(seed, w, h, lanes):
    n = w * h
    ts, xs, ys, ps = testing.dvs_stream(seed, w, h, 50_000, n_hot=2,
                                        hot_events=2 * lanes + 4,
                                        background_events=3 * n)
    lt = np.full(n, 2, np.uint32)
    ln = np.full(n, MIDGREY_LN)
    return B.plan_dvs_compact(ts, xs, ys, ps, w, lt, ln, 0.02, 20)


def _two_groups(seed, w, h, lanes):
    plan = _plan(seed, w, h, lanes)
    return [testing.dvs_group_planes(plan, g * lanes, (g + 1) * lanes, w * h,
                                     "cpu") for g in range(2)]


@pytest.mark.parametrize("multi", MULTI, ids=lambda m: m.name)
def test_dvs_chunk_plain_matches_jax_masked_loop(multi):
    """Two chained lane groups: the plain chunk against JAX's
    masked_interval looped over the sub-steps and compacted per sub-step
    with `_compact_interval` (events, counts, state, the overflow flag)."""
    kp, pp = _params(multi)
    w, h = 9, 7
    n = w * h
    js = _jax_state(n)
    ts = convert.state_from_numpy(js, "cpu")
    for inten, tspan, fvw in _two_groups(3, w, h, 4):
        got = FR.dvs_chunk_resident_plain(ts, inten, tspan, fvw, pp)
        ov0 = int(js.overflow)
        pd, tt, counts = [], [], []
        for i in range(inten.shape[0]):
            w_i = fvw[i].numpy()
            js, sd, stt, sm, _ = JB.masked_interval(
                js, jnp.asarray(inten[i].numpy()), jnp.asarray(w_i & 0xFF),
                jnp.asarray(tspan[i].numpy()),
                jnp.asarray(((w_i >> 8) & 1) != 0), kp)
            p_i, t_i, n_i = K._compact_interval(sd, stt, sm, 19 * n)
            n_i = int(n_i)
            pd.append(np.asarray(p_i[:n_i]))
            tt.append(np.asarray(t_i[:n_i]))
            counts.append(n_i)
        np.testing.assert_array_equal(got.per_interval.numpy(), counts)
        np.testing.assert_array_equal(got.pixd.numpy().view(np.uint32),
                                      np.concatenate(pd))
        np.testing.assert_array_equal(got.t.numpy().view(np.uint32),
                                      np.concatenate(tt))
        assert (int(got.pmax) >> 16) & 1 == int(int(js.overflow) > ov0)
        _assert_state_equal(js, got.state, skip=("overflow",))
        ts = got.state
        assert sum(counts) > 0


def test_dvs_chunk_plain_matches_pallas_kernel():
    """The plain chunk against the TPU kernel itself
    (make_dvs_chunk_resident, Pallas interpret mode, 2 blocks of 128
    pixels) plus its host assembler: events, counts, flags and state."""
    kp, pp = _params(PixelMultiMode.Collapse)
    w, h = 16, 16
    n = w * h
    (inten, tspan, fvw), _ = _two_groups(5, w, h, 2)
    js = _jax_state(n)
    fn = JFR.make_dvs_chunk_resident(kp, 19 * n * 4, pallas_block=128,
                                     interpret=True, depth=16)
    st, bp, bt, total, per_interval, pmax, counts = fn(
        js, jnp.asarray(inten.numpy()), jnp.asarray(tspan.numpy()),
        jnp.asarray(fvw.numpy()))
    total = int(total)
    rp, rt = JFR.assemble_resident_events(
        np.asarray(bp[:total]), np.asarray(bt[:total]), np.asarray(counts))
    got = FR.dvs_chunk_resident_plain(convert.state_from_numpy(js, "cpu"),
                                      inten, tspan, fvw, pp)
    assert total == len(got.pixd) > 0
    np.testing.assert_array_equal(got.per_interval.numpy(),
                                  np.asarray(per_interval))
    np.testing.assert_array_equal(got.pixd.numpy().view(np.uint32), rp)
    np.testing.assert_array_equal(got.t.numpy().view(np.uint32), rt)
    assert int(got.pmax) == int(pmax)
    _assert_state_equal(st, got.state)


def test_header_and_decode_match_jax(tmp_path):
    t, x, y, p = testing.dvs_stream(4, 37, 29, 10_000, n_hot=3,
                                    hot_events=20, background_events=500)
    path = tmp_path / "s.raw"
    testing.write_prophesee_raw(path, 37, 29, t, x, y, p)
    with open(path, "rb") as f:
        got = TP.parse_header(f)
        body = f.read()
    with open(path, "rb") as f:
        assert got == JP.parse_header(f) == (got[0], 0, 8, (29, 37))
    for a, b, c in zip(TP.decode_events_np(body), JP.decode_events_np(body),
                       (t, x, y, p)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _transcode(src, multi=PixelMultiMode.Collapse, crf=3, windows=0):
    """The CLI's drive (tools/prophesee_to_adder.py): crf, Raw sink,
    consume until EOFError (or `windows` windows), end the stream."""
    if crf is not None:
        src.crf(crf)
    buf = io.BytesIO()
    src.write_out(SourceCamera.Dvs, TimeMode.AbsoluteT, multi, None,
                  EncoderType.Raw, EncoderOptions.default(src.plane), buf)
    n = 0
    while True:
        try:
            src.consume()
        except EOFError:
            break
        n += 1
        if windows and n >= windows:
            break
    src.end_write_stream()
    return buf.getvalue()


@pytest.fixture(scope="module")
def stream_path(tmp_path_factory):
    """The 14 x 10 stream of tests/test_dvs_batch.py's oracle test."""
    w, h = 14, 10
    rng = np.random.default_rng(3)
    t = 10 + np.cumsum(rng.integers(1, 1500, 300))
    x, y, p = (rng.integers(0, w, 300), rng.integers(0, h, 300),
               rng.integers(0, 2, 300))
    path = tmp_path_factory.mktemp("dvs") / "s.raw"
    testing.write_prophesee_raw(path, w, h, t, x, y, p)
    return str(path)


@pytest.mark.parametrize("crf", [3, None], ids=["crf3", "no-crf"])
def test_prophesee_bytes_and_state_match_jax_scan(stream_path, crf):
    jax_src = JP.Prophesee(20, stream_path, batched=True, engine="scan")
    want = _transcode(jax_src, crf=crf)
    port = TP.Prophesee(20, stream_path, device="cpu")
    got = _transcode(port, crf=crf)
    assert len(got) > 1000 and got == want
    np.testing.assert_array_equal(port.dvs_last_timestamps,
                                  jax_src.dvs_last_timestamps)
    np.testing.assert_array_equal(port.dvs_last_ln_val,
                                  jax_src.dvs_last_ln_val)
    _assert_state_equal(jax_src._dev_state, port.state)
    assert port.state.node_d.shape == (16, 140)


def test_void_events_state_equals_fetched(stream_path):
    fetched = TP.Prophesee(20, stream_path, device="cpu")
    _transcode(fetched)
    void = TP.Prophesee(20, stream_path, device="cpu")
    void.void_events = True
    void.crf(3)
    void.write_out(SourceCamera.Dvs, TimeMode.AbsoluteT,
                   PixelMultiMode.Collapse, None, EncoderType.Empty,
                   EncoderOptions.default(void.plane), None)
    while True:
        try:
            assert len(void.consume()) == 0
        except EOFError:
            break
    for a, b in zip(void.state, fetched.state):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(void.dvs_last_ln_val,
                                  fetched.dvs_last_ln_val)


def test_resume_from_jax_state(stream_path):
    """A stream started by JAX (3 windows) and finished by the port gives
    JAX's events for the rest; the JAX state is padded past N here, as the
    JAX resident engine pads it, and the carry cuts it back."""
    full = open_file_decoder_bytes(_transcode(
        JP.Prophesee(20, stream_path, batched=True, engine="scan")))
    head_src = JP.Prophesee(20, stream_path, batched=True, engine="scan")
    head = open_file_decoder_bytes(_transcode(head_src, windows=3))
    st = head_src._dev_state
    head_src._dev_state = K.PixelState(*(
        jnp.concatenate([v, v[..., :5]], axis=-1) if v.ndim else v
        for v in st))
    port = TP.Prophesee(20, stream_path, device="cpu")
    port.crf(3)
    convert.carry_prophesee_state(head_src, port)
    _assert_state_equal(st, port.state)
    rest = open_file_decoder_bytes(_transcode(port, crf=None))
    assert 0 < len(head) < len(full)
    assert head + rest == full


def open_file_decoder_bytes(data: bytes) -> list:
    """Decoded (x, y, d, t) tuples of a Raw .adder byte string."""
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".adder") as f:
        f.write(data)
        f.flush()
        ev = open_file_decoder(f.name).digest_all()
    return list(zip(ev.x.tolist(), ev.y.tolist(), ev.d.tolist(),
                    ev.t.tolist()))


def test_segmented_window_per_pixel_streams_match_jax_scan(
        tmp_path, monkeypatch):
    """One window (view_fps 1) cut into segments of 100 events, with a
    pixel of more than 64 lanes in a segment (two lane groups): each
    pixel's event stream equals the JAX scan engine's."""
    w, h = 14, 10
    t, x, y, p = testing.dvs_stream(9, w, h, 200_000, n_hot=1,
                                    hot_events=240, background_events=60)
    path = str(tmp_path / "seg.raw")
    testing.write_prophesee_raw(path, w, h, t, x, y, p)
    monkeypatch.setenv("ADDER_TPU_DVS_SEG_EVENTS", "100")
    port = TP.Prophesee(20, path, view_fps=1, device="cpu")
    groups = []
    orig = port._run_group
    port._run_group = lambda c, L, *a: groups.append(L) or orig(c, L, *a)
    got = open_file_decoder_bytes(_transcode(port))
    want = open_file_decoder_bytes(_transcode(
        JP.Prophesee(20, path, batched=True, view_fps=1, engine="scan")))
    assert max(groups) == 64 and len(groups) > 3

    def streams(events):
        out = {}
        for xx, yy, d, tt in events:
            out.setdefault((xx, yy), []).append((d, tt))
        return out

    assert sorted(got) == sorted(want)
    assert streams(got) == streams(want)


def test_window_of_one_to_one_and_a_half_segments_keeps_every_event(
        tmp_path, monkeypatch):
    """A window of 120 events with segments of 100 is planned whole: the
    bytes equal an unsegmented run's (the JAX resident engine plans only
    its first 100 events there)."""
    w, h = 14, 10
    t, x, y, p = testing.dvs_stream(9, w, h, 200_000, n_hot=1,
                                    hot_events=40, background_events=80)
    path = str(tmp_path / "w.raw")
    testing.write_prophesee_raw(path, w, h, t, x, y, p)
    whole = _transcode(TP.Prophesee(20, path, view_fps=1, device="cpu"))
    monkeypatch.setenv("ADDER_TPU_DVS_SEG_EVENTS", "100")
    port = TP.Prophesee(20, path, view_fps=1, device="cpu")
    got = _transcode(port)
    assert port._event_pos == len(t) == 120
    assert got == whole and len(got) > 1000


def test_dvs_wrappers_run_plain_on_cpu_tensors():
    """The DVS row wrapper on CPU tensors runs its plain version (no launch),
    also with a grouping given; the dense entry point is gone."""
    _, pp = _params(PixelMultiMode.Collapse)
    carrier = testing.dvs_group_carrier(_plan(6, 7, 5, 2), 0, 2, "cpu")
    st = P.init_state(35, "cpu", depth=16)
    FR.reset_launch_counts()
    got = FR.dvs_rows_resident(FR.clone_state(st), carrier, 4, pp)
    void = FR.dvs_rows_resident(FR.clone_state(st), carrier, 4, pp,
                                events=False,
                                groups=FR.group_dvs_rows(carrier, 4))
    want = FR.dvs_rows_resident_plain(st, carrier, 4, pp)
    assert set(FR.LAUNCHES.values()) == {0}
    assert not hasattr(FR, "dvs_chunk_resident")
    assert "adder_dvs_chunk" not in FR.LAUNCHES
    assert testing.compare_chunks(got, want, "cpu") == 0.0
    assert testing.compare_chunks(void, want._replace(pixd=None, t=None),
                                  "cpu void") == 0.0


def test_dvs_kernel_check_harness_runs_on_cpu():
    """chip_smoke.py's check of the raster chunks (the bootstrap, a flush,
    a DAVIS frame and gap) against plain, on CPU tensors."""
    assert testing.check_raster_chunks_against_plain("cpu", H=5, W=7) == 0.0


def test_prophesee_module_imports_no_jax():
    code = ("import sys; import adder_tpu_torch.transcoder.prophesee; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.')]; assert not bad, bad; print('OK')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=str(__import__("pathlib").Path(
                              __file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "OK"
