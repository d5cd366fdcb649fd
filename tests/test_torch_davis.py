"""The port's DAVIS path against the JAX package, on the CPU.

Inputs are made from numpy seeds and go through both packages; every
comparison is bit for bit (tolerance 0). The JAX side runs as its own tests
run it here: `make_davis_event_interval` (one jit per parameter set), the
native planner, the Pallas kernel in interpret mode, and
`Davis(..., batched=True, engine="scan")`, the engine JAX picks on the CPU.
The JAX runs are shared through module-scoped fixtures. The port's CUDA
kernel is checked on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adder_tpu.codec.decoder import open_file_decoder as jax_decoder
from adder_tpu.codec.encoder import EncoderOptions as JEncoderOptions
from adder_tpu.codec.encoder import EncoderType as JEncoderType
from adder_tpu.core.types import PixelMultiMode
from adder_tpu.core.types import PlaneSize as JPlaneSize
from adder_tpu.core.types import SourceCamera as JSourceCamera
from adder_tpu.core.types import TimeMode as JTimeMode
from adder_tpu.ops import dvs_batch as JB
from adder_tpu.ops import fused_resident as JFR
from adder_tpu.ops import integrate as K
from adder_tpu.transcoder import davis as JD
from adder_tpu.transcoder import edi as JEDI
import adder_tpu_torch as at
from adder_tpu_torch import convert, testing
from adder_tpu_torch.ops import dvs_batch as B
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.ops import integrate as P
from adder_tpu_torch.transcoder import davis as TD
from adder_tpu_torch.transcoder import edi as TEDI

MULTI = [PixelMultiMode.Collapse, PixelMultiMode.Normal]
H, W = 12, 14


def _params(multi):
    cfg = dict(mode=1, multi_mode=int(multi), time_mode=1, ref_time=255,
               delta_t_max=3921 * 255, c_thresh_max=6, c_increase_velocity=2)
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


def _event_inputs(rng, n):
    """Random DAVIS event inputs: gaps of up to 3000 us at 255 ticks/us
    (past delta_t_max), the held intensity over them, a post-step frame
    value and its truncation."""
    dt_us = rng.integers(1, 3000, n)
    dt = (dt_us * 255.0).astype(np.float32)
    last_val = rng.uniform(0, 255, n)
    fi = np.maximum(last_val / 255 * dt_us * 255.0, 0.0).astype(np.float32)
    fval = rng.uniform(0, 255, n).astype(np.float32)
    return fi, dt, fval, fval.astype(np.int32)


@pytest.mark.parametrize("multi", MULTI, ids=lambda m: m.name)
def test_davis_event_interval_matches_jax(multi):
    """Ten chained DAVIS events on 96 pixels, a third of them forced to
    overflow the depth-16 arena: state, slots and the masked overflow
    count equal JAX's `make_davis_event_interval`."""
    kp, pp = _params(multi)
    n = 96
    rng = np.random.default_rng(1)
    ts = testing.forced_overflow_state(
        torch.full((n,), 128, dtype=torch.uint8), n // 3, depth=16)
    ts = ts._replace(c_thresh=torch.full((n,), 3, dtype=torch.int32))
    js = K.PixelState(*(jnp.asarray(v) for v in
                        convert.state_to_numpy(ts).values()))
    fn = JB.make_davis_event_interval(kp)
    for _ in range(10):
        fi, dt, fval, fv8 = _event_inputs(rng, n)
        mask = rng.random(n) < 0.7
        js, sd, stt, sm = fn(js, jnp.asarray(fi), jnp.asarray(dt),
                             jnp.asarray(fval), jnp.asarray(fv8),
                             jnp.asarray(mask))
        ts, sd2, stt2, sm2 = B.davis_event_interval(
            ts, torch.from_numpy(fi), torch.from_numpy(dt),
            torch.from_numpy(fval), torch.from_numpy(fv8),
            torch.from_numpy(mask), pp)
        m = np.asarray(sm)
        assert m.shape == (19, n)
        np.testing.assert_array_equal(m, sm2.numpy())
        np.testing.assert_array_equal(np.asarray(sd)[m], sd2.numpy()[m])
        np.testing.assert_array_equal(np.asarray(stt)[m].astype(np.int64),
                                      stt2.numpy()[m])
        _assert_state_equal(js, ts)
    assert int(ts.overflow) > 0


def _burst():
    """A seeded burst on a 23 x 17 plane with drops (chains that never
    started, out-of-order times) and both clamp branches."""
    w, h = 23, 17
    n = w * h
    rng = np.random.default_rng(41)
    n_ev = 3000
    ts = np.sort(rng.integers(0, 2500, n_ev)).astype(np.int64)
    xs = rng.integers(0, w, n_ev).astype(np.uint16)
    ys = rng.integers(0, h, n_ev).astype(np.uint16)
    ons = rng.integers(0, 2, n_ev).astype(bool)
    lt = rng.integers(0, 900, n).astype(np.int64)
    lt[rng.random(n) < 0.1] = 0
    ln = rng.uniform(-1.0, 0.69, n)
    ln[rng.random(n) < 0.05] = 3.0
    return w, n, ts, xs, ys, ons, lt, ln


def test_davis_planner_carrier_and_planes_match_jax():
    """The port's planner gives JAX's rows and chain state; the rows packed
    into the (5, E) carrier, unpacked and scattered give JAX's carrier and
    JAX's `build_davis_planes`."""
    w, n, ts, xs, ys, ons, lt, ln = _burst()
    chains = [(lt.copy(), ln.copy()) for _ in range(2)]
    cache = np.full(n, np.nan)
    got = B.plan_davis_events_compact(ts, xs, ys, ons, w, *chains[0], 0.15,
                                      255, 255.0, val_cache=cache)
    want = JB.plan_davis_events_compact(ts, xs, ys, ons, w, n, *chains[1],
                                        0.15, 255, 255.0)
    assert got._fields == want._fields and len(got._fields) == 7
    for name, g, e in zip(got._fields, got, want):
        np.testing.assert_array_equal(g, e, err_msg=name)
        assert g.dtype == e.dtype, name
    np.testing.assert_array_equal(chains[0][0], chains[1][0])
    np.testing.assert_array_equal(chains[0][1], chains[1][1])
    assert got.n_lanes == want.n_lanes > 2 and 0 < len(got.pix) < len(ts)
    for g, e in zip(got.lane_slice(1, 3), want.lane_slice(1, 3)):
        np.testing.assert_array_equal(g, e)

    packed = FR.pack_davis_plan(got)
    np.testing.assert_array_equal(packed,
                                  JFR.pack_davis_plan(want, len(want.pix)))
    T = got.n_lanes
    planes = FR.build_davis_planes(
        T, n, *FR.unpack_davis_carrier(torch.from_numpy(packed)))
    want_planes = JFR.build_davis_planes(
        T, n, *(jnp.asarray(getattr(want, f)) for f in want._fields))
    for g, e in zip(planes, want_planes):
        assert g.dtype == getattr(torch, str(np.asarray(e).dtype))
        np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def _two_groups(w, h, lanes, seed=3):
    plan = testing.davis_plan(seed, w, h, 2 * lanes)
    return [testing.davis_group_planes(plan, g * lanes, (g + 1) * lanes,
                                       w * h, "cpu") for g in range(2)]


@pytest.mark.parametrize("multi", MULTI, ids=lambda m: m.name)
def test_davis_chunk_plain_matches_jax_event_loop(multi):
    """Two chained lane groups: the plain chunk against JAX's
    `davis_event_interval` looped over the sub-steps and compacted per
    sub-step with `_compact_interval` (events, counts, state, the overflow
    flag)."""
    kp, pp = _params(multi)
    w, h = 12, 8  # the plane of test_davis_event_interval_matches_jax: one jit
    n = w * h
    js = _jax_state(n)
    ts = convert.state_from_numpy(js, "cpu")
    fn = JB.make_davis_event_interval(kp)
    for fi, dt, fval, fvw in _two_groups(w, h, 4):
        got = FR.davis_chunk_resident_plain(ts, fi, dt, fval, fvw, pp)
        ov0 = int(js.overflow)
        pd, tt, counts = [], [], []
        for i in range(fi.shape[0]):
            w_i = fvw[i].numpy()
            js, sd, stt, sm = fn(js, jnp.asarray(fi[i].numpy()),
                                 jnp.asarray(dt[i].numpy()),
                                 jnp.asarray(fval[i].numpy()),
                                 jnp.asarray(w_i & 0xFF),
                                 jnp.asarray(((w_i >> 8) & 1) != 0))
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


@pytest.mark.slow
def test_davis_chunk_plain_matches_pallas_kernel():
    """The plain chunk against the TPU kernel itself
    (make_davis_chunk_resident_compact, Pallas interpret mode, 2 blocks of
    128 pixels) plus its host assembler: events, counts, flags and state.
    Slow tier: about 50 s of interpret-mode compilation on one core."""
    kp, pp = _params(PixelMultiMode.Collapse)
    w, h = 16, 16
    n = w * h
    plan = testing.davis_plan(5, w, h, 2)
    g = plan.lane_slice(0, 2)
    js = _jax_state(n)
    fn = JFR.make_davis_chunk_resident_compact(kp, 19 * n * 2, 2, n,
                                               pallas_block=128,
                                               interpret=True, depth=16)
    st, bp, bt, total, per_interval, pmax, counts = fn(
        js, *(jnp.asarray(f) for f in g))
    total = int(total)
    rp, rt = JFR.assemble_resident_events(
        np.asarray(bp[:total]), np.asarray(bt[:total]), np.asarray(counts))
    planes = testing.davis_group_planes(plan, 0, 2, n, "cpu")
    got = FR.davis_chunk_resident_plain(convert.state_from_numpy(js, "cpu"),
                                        *planes, pp)
    assert total == len(got.pixd) > 0
    np.testing.assert_array_equal(got.per_interval.numpy(),
                                  np.asarray(per_interval))
    np.testing.assert_array_equal(got.pixd.numpy().view(np.uint32), rp)
    np.testing.assert_array_equal(got.t.numpy().view(np.uint32), rt)
    assert int(got.pmax) == int(pmax)
    _assert_state_equal(st, got.state)


# --- the whole slice -----------------------------------------------------------


def _packets(mod):
    """Four packets on a 14 x 12 plane: frames with events between them and
    one event-only packet. The first packet holds the most lanes (a hot
    pixel) and the busiest lane, so the JAX scan engine's capacities are
    set by it."""
    rng = np.random.default_rng(9)

    def frame():
        return rng.integers(40, 200, (H, W)).astype(np.uint8)

    def burst(t0, t1, n, hot=0):
        pix = np.concatenate([rng.integers(0, W * H, n), np.full(hot, 17)])
        t = np.sort(rng.integers(t0, t1, len(pix))).astype(np.int64)
        rng.shuffle(pix)
        return mod.DvsEvents(t=t, x=(pix % W).astype(np.int32),
                             y=(pix // W).astype(np.int32),
                             on=rng.integers(0, 2, len(pix)).astype(bool))

    return [
        mod.DavisPacket(frame(), 1000, 3000, burst(10, 900, 420, hot=7)),
        mod.DavisPacket(frame(), 6000, 8000, burst(3100, 5900, 160)),
        mod.DavisPacket(None, 0, 0, burst(8100, 12000, 140)),
        mod.DavisPacket(frame(), 15000, 17000, burst(12100, 14900, 120)),
    ]


def _drive(src, quality, enc, packets=None):
    """tools/davis_to_adder.py's drive: Raw sink, then crf or the manual
    quality path the CLI takes without --crf; consume `packets` packets
    (all when None), end the stream. `enc` holds the package's codec
    names."""
    buf = io.BytesIO()
    src.write_out(enc["camera"].DavisU8, enc["time"].AbsoluteT,
                  PixelMultiMode.Collapse, None, enc["type"].Raw,
                  enc["options"].default(src.plane), buf)
    if quality == "crf3":
        src.crf(3)
    elif quality == "manual":
        src.get_video_ref().update_quality_manual(5, 5, 3921, 1, 2.0)
    n = 0
    while packets is None or n < packets:
        try:
            src.consume()
        except EOFError:
            break
        n += 1
    src.end_write_stream()
    return buf.getvalue()


JAX_ENC = dict(camera=JSourceCamera, time=JTimeMode, type=JEncoderType,
               options=JEncoderOptions)
PORT_ENC = dict(camera=at.SourceCamera, time=at.TimeMode, type=at.EncoderType,
                options=at.EncoderOptions)
CLI = dict(ref_time=255, tps=255_000_000, delta_t_max=255_000_000)


def _jax_davis(mode, provider_packets=None):
    src = JD.Davis(JD.ArrayDavisProvider(provider_packets or _packets(JD),
                                         JPlaneSize(W, H, 1)),
                   mode=JD.TranscoderMode[mode], batched=True, engine="scan",
                   **CLI)
    # pin the scan engine's sticky capacities at their largest values on
    # this plane, so that it compiles once per parameter set (capacity
    # only: the events do not depend on it)
    src._scan_take, src._scan_lpad, src._mask_take = 4096, 8, 4096
    return src


def _port_davis(mode, packets=None, **kw):
    return TD.Davis(TD.ArrayDavisProvider(packets or _packets(TD),
                                          at.PlaneSize(W, H, 1)),
                    mode=TD.TranscoderMode[mode], device="cpu", **CLI, **kw)


@pytest.fixture(scope="module")
def jax_runs():
    """(mode, quality) -> (Raw bytes, the finished JAX Davis), run once."""
    cache = {}

    def get(mode, quality):
        if (mode, quality) not in cache:
            src = _jax_davis(mode)
            cache[mode, quality] = (_drive(src, quality, JAX_ENC), src)
        return cache[mode, quality]

    return get


@pytest.mark.parametrize("quality", ["crf3", "manual"])
@pytest.mark.parametrize("mode", ["RawDavis", "RawDvs", "Framed"])
def test_davis_bytes_and_state_match_jax_scan(jax_runs, mode, quality):
    want, jax_src = jax_runs(mode, quality)
    port = _port_davis(mode)
    got = _drive(port, quality, PORT_ENC)
    assert len(got) > 1000 and got == want
    np.testing.assert_array_equal(port.dvs_last_timestamps,
                                  jax_src.dvs_last_timestamps)
    np.testing.assert_array_equal(port.dvs_last_ln_val,
                                  jax_src.dvs_last_ln_val)
    _assert_state_equal(jax_src._dev_state, port.state)
    assert port.state.node_d.shape == (16, W * H)


def test_manual_quality_keeps_the_davis_c_thresh():
    """The CLI's manual quality path sets the encoder's CRF parameters and
    delta_t_max, and leaves the Davis state's c_thresh at init_state's
    value (only `crf` resets it), as in the JAX package."""
    port = _port_davis("RawDavis")
    _drive(port, "manual", PORT_ENC, packets=0)
    assert port.get_video_ref().delta_t_max == 3921 * 255
    assert port._params().c_thresh_max == 5
    assert set(port.state.c_thresh.tolist()) == {10}
    crf = _port_davis("RawDavis")
    _drive(crf, "crf3", PORT_ENC, packets=0)
    base = crf.video.encoder.options.crf.get_parameters().c_thresh_baseline
    assert set(crf.state.c_thresh.tolist()) == {base} != {10}


def test_void_events_state_equals_fetched():
    fetched = _port_davis("RawDavis")
    _drive(fetched, "manual", PORT_ENC)
    void = _port_davis("RawDavis")
    void.void_events = True
    void.write_out(at.SourceCamera.DavisU8, at.TimeMode.AbsoluteT,
                   at.PixelMultiMode.Collapse, None, at.EncoderType.Empty,
                   at.EncoderOptions.default(void.plane), None)
    void.get_video_ref().update_quality_manual(5, 5, 3921, 1, 2.0)
    while True:
        try:
            assert len(void.consume()) == 0
        except EOFError:
            break
    for a, b in zip(void.state, fetched.state):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(void.dvs_last_ln_val,
                                  fetched.dvs_last_ln_val)


def _decoded(data: bytes, decoder) -> list:
    """Decoded (x, y, d, t) tuples of a Raw .adder byte string."""
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".adder") as f:
        f.write(data)
        f.flush()
        ev = decoder(f.name).digest_all()
    return list(zip(ev.x.tolist(), ev.y.tolist(), ev.d.tolist(),
                    ev.t.tolist()))


def test_resume_from_jax_state(jax_runs):
    """A stream started by JAX (2 packets) and finished by the port gives
    JAX's events for the rest; the JAX state is padded past N here, as the
    JAX resident engine pads it, and the carry cuts it back."""
    full = _decoded(jax_runs("RawDavis", "manual")[0], jax_decoder)
    head_src = _jax_davis("RawDavis")
    head = _decoded(_drive(head_src, "manual", JAX_ENC, packets=2),
                    jax_decoder)
    st = head_src._dev_state
    head_src._dev_state = K.PixelState(*(
        jnp.concatenate([v, v[..., :5]], axis=-1) if v.ndim else v
        for v in st))
    port = _port_davis("RawDavis", packets=_packets(TD)[2:])
    convert.carry_davis_state(head_src, port)
    _assert_state_equal(st, port.state)
    rest = _decoded(_drive(port, "manual", PORT_ENC), at.open_file_decoder)
    assert 0 < len(head) < len(full)
    assert head + rest == full


# --- aedat4 -> EDI -> Davis ---------------------------------------------------


def _write_aedat4(path, compression):
    events, frames = testing.davis_stream(
        2, 40, 30, 60_000, n_frames=3, exposure_us=8_000, n_hot=4,
        hot_events=30, edge_events=1500, background_events=600)
    testing.write_davis_aedat4(str(path), 40, 30, events, frames,
                               compression=compression)
    return events, frames


@pytest.mark.parametrize("compression", ["none", "zstd"])
def test_aedat4_edi_davis_end_to_end(tmp_path, compression):
    """An aedat4 file through the port's EdiReconstructor and Davis (the
    CLI's raw-davis drive): the reconstructor's packets equal JAX's, the
    .adder file decodes to the events the source returned, and reading the
    file back gives what was written."""
    from adder_tpu_torch.utils import aedat4

    code = aedat4.COMPRESSION_NONE
    if compression == "zstd":
        pytest.importorskip("zstandard")
        code = aedat4.COMPRESSION_ZSTD
    path = tmp_path / f"davis_{compression}.aedat4"
    events, frames = _write_aedat4(path, code)
    got = list(TEDI.EdiReconstructor(str(path)))
    want = list(JEDI.EdiReconstructor(str(path)))
    assert len(got) == len(want) == len(frames) == 3
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g.frame, e.frame)
        assert (g.frame_start_us, g.frame_end_us) == (e.frame_start_us,
                                                      e.frame_end_us)
        for f in ("t", "x", "y", "on"):
            np.testing.assert_array_equal(getattr(g.events, f),
                                          getattr(e.events, f))
    assert sum(len(g.events) for g in got) == len(events[0])

    src = at.Davis(at.EdiReconstructor(str(path)), mode=at.TranscoderMode.RawDavis,
                   device="cpu", **CLI)
    buf = io.BytesIO()
    src.write_out(at.SourceCamera.DavisU8, at.TimeMode.AbsoluteT,
                  at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                  at.EncoderOptions.default(src.plane), buf)
    src.get_video_ref().update_quality_manual(5, 5, 3921, 1, 2.0)
    n_events = 0
    while True:
        try:
            n_events += len(src.consume())
        except EOFError:
            break
    src.end_write_stream()
    assert src.plane == at.PlaneSize(40, 30, 1)
    assert n_events > 1000
    assert len(_decoded(buf.getvalue(), at.open_file_decoder)) == n_events


def test_davis_wrappers_run_plain_on_cpu_tensors():
    _, pp = _params(PixelMultiMode.Collapse)
    planes, _ = _two_groups(7, 5, 2, seed=6)
    st = P.init_state(35, "cpu", depth=16)
    FR.reset_launch_counts()
    got = FR.davis_chunk_resident(st, *planes, pp)
    void = FR.davis_chunk_resident(st, *planes, pp, events=False)
    want = FR.davis_chunk_resident_plain(st, *planes, pp)
    assert set(FR.LAUNCHES.values()) == {0}
    assert len(want.pixd) > 0
    assert testing.compare_chunks(got, want, "cpu") == 0.0
    assert testing.compare_chunks(void, want._replace(pixd=None, t=None),
                                  "cpu void") == 0.0


def test_davis_kernel_check_harness_runs_on_cpu():
    """chip_smoke.py's K4-against-plain check, on CPU tensors."""
    assert testing.check_davis_kernel_against_plain(
        "cpu", H=5, W=7, lanes=(1, 3)) == 0.0


def test_davis_device_contract():
    packets = _packets(TD)
    provider = TD.ArrayDavisProvider(packets, at.PlaneSize(W, H, 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TD.Davis(provider, prefetch=False)  # the card is the default
    with pytest.raises(ValueError):
        TD.Davis(TD.ArrayDavisProvider(packets, at.PlaneSize(2048, 1024, 1)),
                 prefetch=False, device="cpu")
