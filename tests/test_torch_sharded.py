"""The port's pixel bands (`adder_tpu_torch/parallel/sharding.py`) and
`ShardedVideo` against adder_tpu's, on the CPU.

- The three sharded chunk functions (K6 and the slot glue, K5, K1) at k =
  2 and 8 bands against adder_tpu's `make_*_chunk_sharded` on the 8-device
  CPU mesh that tests/conftest.py forces (its Pallas kernels in interpret
  mode), compared as assembled streams, display frames and state, and
  against the single-device chunk's stream.
- The port's `ShardedVideo` over k CPU bands against adder_tpu's
  `ShardedVideo` (interpret mode) and the port's `Video`: the events of
  every chunk and the `.adder` bytes; k = 2 and 4; a plane the JAX side
  pads; colour and Continuous mode; deep pipelining
  (tests/test_sharded_video.py:152-180); features on; ROI; a forced
  capacity rerun; the Empty sink; a checkpoint resume; a JAX sharded state
  carried in through convert.py mid-stream, and back.
- The whole-plane 24-bit guard, the mesh and band helpers, and each band
  launching under its own device.
Tolerance: none; every comparison is exact.
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adder_tpu.codec.encoder import EncoderOptions as JaxEncoderOptions
from adder_tpu.codec.encoder import EncoderType as JaxEncoderType
from adder_tpu.core import types as JT
from adder_tpu.ops import integrate as jops
from adder_tpu.parallel import sharding as jsh
from adder_tpu.transcoder.sharded import ShardedVideo as JaxShardedVideo
from adder_tpu.transcoder.video import Roi as JaxRoi
from adder_tpu.transcoder.video import Video as JaxVideo
from adder_tpu_torch import ShardedVideo, Video, convert, testing
from adder_tpu_torch.codec.encoder import EncoderOptions, EncoderType
from adder_tpu_torch.core import types as T
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.ops import integrate as ops
from adder_tpu_torch.parallel import sharding as sh
from adder_tpu_torch.transcoder import sharded as TS
from adder_tpu_torch.transcoder.video import Roi

BLOCK = 128  # the JAX kernels' pallas_block on the CPU


def jax_mesh(k):
    return jsh.make_mesh(jax.devices("cpu")[:k])


# --- the chunk functions ------------------------------------------------------


def _chunk_inputs(k, T, seed):
    n = BLOCK * 2 * k
    frames = np.random.default_rng(seed).integers(0, 256, (T, n)).astype(
        np.uint8)
    jstate = jops.set_initial_d(jops.init_state(n),
                                jnp.asarray(frames[0].astype(np.int32)))
    return n, frames, jstate


def _port_bands(jstate, frames, k):
    mesh = ["cpu"] * k
    states = sh.shard_state(convert.state_from_numpy(jstate, "cpu"), mesh)
    bounds = sh.band_bounds(frames.shape[1], k)
    fr = [torch.from_numpy(np.ascontiguousarray(frames[:, lo:hi]))
          for lo, hi in bounds]
    run0 = [torch.zeros(hi - lo, dtype=torch.uint8) for lo, hi in bounds]
    return states, fr, run0, bounds


def _assert_state(got_states, want, n):
    got = convert.state_to_numpy(sh.gather_state(got_states, "cpu"))
    for name in ops.PixelState._fields[:-1]:
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(want, name))[..., :n],
                                      err_msg=name)


def _runnings(results):
    return torch.cat([r.runnings for r in results], dim=1).numpy()


def _host(results):
    totals, pmax, per_int = sh.band_controls(results, "cpu")
    pixd = [r.pixd.numpy() for r in results]
    t = [r.t.numpy() for r in results]
    return pixd, t, totals, pmax, per_int


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("engine", ["slots", "fused", "resident"])
def test_chunk_sharded_matches_jax(engine, k):
    T = 3
    n, frames, jstate = _chunk_inputs(k, T, seed=6 + k)
    n_local = n // k
    p, jp = ops.TranscodeParams(), jops.TranscodeParams()
    states, fr, run0, bounds = _port_bands(jstate, frames, k)
    assert [hi - lo for lo, hi in bounds] == [n_local] * k

    # the single-device stream in the reference order
    ref = jops.make_transcode_chunk(jp, jops.K_SLOTS * n * T * 4,
                                    jops.K_SLOTS)(
        jstate, jnp.asarray(frames), jnp.float32(255.0),
        jnp.zeros((n,), jnp.uint8))
    ref_total = int(ref[6])
    assert np.count_nonzero(np.asarray(ref[7])) >= 2  # several intervals
    ref_p, ref_t = (np.asarray(ref[1][:ref_total]).astype(np.uint32),
                    np.asarray(ref[2][:ref_total]).astype(np.uint32))

    jrun0 = jnp.zeros((n,), jnp.uint8)
    jst = jsh.shard_state(jstate, jax_mesh(k))
    if engine == "slots":
        res = sh.transcode_chunk_sharded(
            states, fr, 255.0, run0, p, ops.K_SLOTS * n_local * T * 4,
            ops.K_SLOTS)
        cap = 4 * n * T * jops.K_SLOTS
        outs = jsh.make_transcode_chunk_sharded(jp, cap, jax_mesh(k))(
            jst, jnp.asarray(frames), jnp.float32(255.0), jrun0)
        jtotal = int(outs[6])
        want_p = np.asarray(outs[1][:jtotal]).astype(np.uint32)
        want_t = np.asarray(outs[2][:jtotal]).astype(np.uint32)
        want_state, want_run = outs[0], outs[8]
    elif engine == "fused":
        res = sh.fused_chunk_sharded(states, fr, 255.0, run0, p,
                                     4 * n_local * T, 4)
        outs = jsh.make_fused_chunk_sharded(
            jp, 4 * n_local * T, jax_mesh(k), pallas_block=BLOCK,
            interpret=True)(jst, jnp.asarray(frames), jnp.float32(255.0),
                            jrun0)
        (want_state, jbp, jbt, jtot, jper, jpmax, want_run) = outs
        # JAX's band-major parts, pixel ids local, against the port's
        pixd, t, totals, pmax, _ = _host(res)
        gp, gt = sh.assemble_sharded_events(pixd, t, totals, pmax, 4)
        wp, wt = jsh.assemble_sharded_events(
            np.asarray(jbp), np.asarray(jbt), np.asarray(jtot), k,
            pack_max=np.asarray(jpmax))
        for a, b in zip(gp + gt, wp + wt):
            np.testing.assert_array_equal(a, np.asarray(b).astype(np.uint32))
        np.testing.assert_array_equal(
            sh.band_controls(res, "cpu")[2], np.asarray(jper))
        want_p, want_t = ref_p, ref_t
    else:
        res = sh.resident_chunk_sharded(states, fr, 255.0, p, run0,
                                        event_cap_per_dev=4 * n_local * T)
        outs = jsh.make_resident_chunk_sharded(
            jp, 4 * n_local * T, jax_mesh(k), pallas_block=BLOCK,
            interpret=True)(jst, jnp.asarray(frames), jnp.float32(255.0),
                            jrun0)
        (want_state, jbp, jbt, jtot, _, jpmax, want_run, jcounts) = outs
        want_p, want_t = jsh.assemble_resident_sharded(
            np.asarray(jbp), np.asarray(jbt), np.asarray(jtot),
            np.asarray(jcounts), k, pack_max=np.asarray(jpmax),
            n_local_px=n_local)
    pixd, t, totals, pmax, per_int = _host(res)
    got_p, got_t = sh.assemble_resident_sharded(
        pixd, t, totals, per_int, pmax, 4 if engine == "fused" else 16,
        n_local_px=n_local)
    assert len(got_p) == ref_total > 0
    np.testing.assert_array_equal(got_p, np.asarray(want_p).astype(np.uint32))
    np.testing.assert_array_equal(got_t, np.asarray(want_t).astype(np.uint32))
    np.testing.assert_array_equal(got_p, ref_p)
    np.testing.assert_array_equal(got_t, ref_t)
    np.testing.assert_array_equal(_runnings(res), np.asarray(want_run))
    _assert_state([r.state for r in res], want_state, n)


def test_merge_raises_on_overflow_and_pack():
    p = [np.arange(4, dtype=np.uint32), np.arange(2, dtype=np.uint32)]
    with pytest.raises(OverflowError):
        sh.merge_bands(p, p, [4, 3], np.array([[4], [3]]), [0, 4])
    with pytest.raises(OverflowError):
        sh.assemble_resident_sharded(p, p, [4, 2], np.array([[4], [2]]),
                                     pack_max=np.array([5, 1]), pack=4)
    with pytest.raises(OverflowError):
        sh.assemble_sharded_events(p, p, [4, 3])


# --- mesh, bands, devices -----------------------------------------------------


def test_band_bounds_and_mesh():
    assert sh.band_bounds(429, 4) == [(0, 108), (108, 216), (216, 324),
                                      (324, 429)]
    assert sh.band_bounds(10, 1) == [(0, 10)]
    with pytest.raises(ValueError):
        sh.band_bounds(5, 4)  # the fourth band would be empty
    mesh = sh.make_mesh(["cpu"] * 3)
    assert mesh == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sh.make_mesh()
        with pytest.raises(RuntimeError):
            ShardedVideo(T.PlaneSize(8, 4, 1), T.Mode.FramePerfect)


def test_each_band_launches_under_its_device(monkeypatch):
    """A band on cuda:d launches inside torch.cuda.device(cuda:d): the
    wrappers hand the kernel torch.cuda.current_stream(dev), and a launch
    goes to the thread's current device. The context is checked here on
    the CPU: its device, and that every wrapper call of a band runs inside
    its band's context."""
    ctx = sh.device_context("cuda:1")
    assert isinstance(ctx, torch.cuda.device) and ctx.idx == 1
    assert not isinstance(sh.device_context("cpu"), torch.cuda.device)

    entered = []

    class Recorder:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            entered.append(self.dev)

        def __exit__(self, *exc):
            entered.append(None)

    calls = []

    def fake(state, frames, *a, **kw):
        calls.append((entered[-1], frames.device))
        return FR.ChunkResult(state, None, None, None, None)

    monkeypatch.setattr(sh, "device_context", Recorder)
    monkeypatch.setattr(sh.FR, "fused_chunk_resident", fake)
    monkeypatch.setattr(sh.FR, "group_chunk_resident", fake)
    monkeypatch.setattr(sh.fused_kernel, "fused_chunk", fake)
    monkeypatch.setattr(sh.ops, "transcode_chunk", fake)
    frames = [torch.zeros((1, 4), dtype=torch.uint8) for _ in range(3)]
    p = ops.TranscodeParams()
    for run in (
        lambda: sh.resident_chunk_sharded([None] * 3, frames, 1.0, p,
                                          event_cap_per_dev=8),
        lambda: sh.resident_chunk_sharded([None] * 3, frames, 1.0, p,
                                          event_cap_per_dev=None),
        lambda: sh.fused_chunk_sharded([None] * 3, frames, 1.0,
                                       [None] * 3, p, 8),
        lambda: sh.transcode_chunk_sharded([None] * 3, frames, 1.0,
                                           [None] * 3, p, 8),
    ):
        calls.clear()
        entered.clear()
        run()
        assert calls == [(torch.device("cpu"), torch.device("cpu"))] * 3
        assert entered[1::2] == [None] * 3  # each left after its band


def test_whole_plane_24_bit_guard():
    """2^24 pixel-channels: each of 4 bands would fit the pixel field, but
    the merged stream carries global ids, so the Video refuses the plane."""
    with pytest.raises(ValueError, match="24 bits"):
        ShardedVideo(T.PlaneSize(4096, 4096, 1), T.Mode.FramePerfect,
                     mesh=["cpu"] * 4)
    assert -(-(4096 * 4096) // 4) < FR.MAX_PIXELS


# --- ShardedVideo -------------------------------------------------------------


def _frames(plane, T_, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (T_, plane[1], plane[0], plane[2])).astype(
        np.uint8)


def _configure(v, mods, buf, plane):
    v.time_parameters(255 * 10, 255, 255 * 10, mods.TimeMode.DeltaT)
    v.update_quality_manual(0, 0, 1, 0, 0)
    enc_type, enc_opts = ((JaxEncoderType, JaxEncoderOptions) if mods is JT
                          else (EncoderType, EncoderOptions))
    v.write_out(mods.SourceCamera.FramedU8, mods.TimeMode.DeltaT,
                mods.PixelMultiMode.Collapse, None, enc_type.Raw,
                enc_opts.default(mods.PlaneSize(*plane)), buf)
    return v


def _make(kind, plane, mode, k=2):
    mods = JT if kind.startswith("jax") else T
    pl = mods.PlaneSize(*plane)
    md = getattr(mods.Mode, mode)
    if kind == "jax-sharded":
        return JaxShardedVideo(pl, md, mesh=jax_mesh(k), interpret=True), mods
    if kind == "jax":
        return JaxVideo(pl, md), mods
    if kind == "port":
        return Video(pl, md, device="cpu"), mods
    return ShardedVideo(pl, md, mesh=["cpu"] * k), mods


def _events(ev):
    return tuple(np.asarray(a) for a in (ev.x, ev.y, ev.c, ev.d, ev.t))


def _stream(kind, plane, mode, chunks, k=2, pipelined=False, before=None):
    """The events of every collected chunk (sequential) and the bytes."""
    v, mods = _make(kind, plane, mode, k)
    buf = io.BytesIO()
    _configure(v, mods, buf, plane)
    if before:
        before(v)
    evs = []
    for c in chunks:
        if pipelined:
            v.submit_chunk(c)
        else:
            evs.append(_events(v.integrate_matrix_batch(c)))
    v.flush()
    v.end_write_stream()
    return evs, buf.getvalue(), v


_JAX: dict = {}


def _jax_stream(kind, plane, mode, seeds, k=2):
    key = (kind, plane, mode, seeds, k)
    if key not in _JAX:
        chunks = [_frames(plane, 3, s) for s in seeds]
        _JAX[key] = _stream(kind, plane, mode, chunks, k)[:2]
    return _JAX[key]


@pytest.mark.parametrize("plane,mode,k", [
    ((20, 24, 1), "FramePerfect", 2),  # 480 px: the JAX side pads to 512
    ((20, 24, 1), "FramePerfect", 4),
    ((11, 13, 3), "FramePerfect", 2),  # 429: JAX pads, the port's bands
    ((11, 13, 3), "FramePerfect", 4),  # are 108 + 108 + 108 + 105
    ((8, 16, 3), "Continuous", 2),  # colour, Continuous
])
def test_sharded_video_matches_jax_and_video(plane, mode, k):
    seeds = (0, 1, 2)
    chunks = [_frames(plane, 3, s) for s in seeds]
    want_ev, want = _jax_stream("jax-sharded", plane, mode, seeds, k)
    got_ev, got, sv = _stream("sharded", plane, mode, chunks, k)
    _, single, _ = _stream("port", plane, mode, chunks)
    assert len(want) > 100 and got == want == single
    for g, w in zip(got_ev, want_ev):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert sv.n_devices == k and sv.in_interval_count == 9
    assert len(sv.state) == k


def test_deep_pipelining_matches_sequential():
    """Five chunks submitted up front (submit collects once two are in
    flight): the bytes of the sequential run and of the JAX ShardedVideo's
    (tests/test_sharded_video.py:152-180)."""
    plane = (16, 16, 1)
    chunks = [_frames(plane, 2, 10 + s) for s in range(5)]
    seq = _stream("sharded", plane, "FramePerfect", chunks)[1]
    pipe = _stream("sharded", plane, "FramePerfect", chunks,
                   pipelined=True)[1]
    want = _stream("jax-sharded", plane, "FramePerfect", chunks,
                   pipelined=True)[1]
    assert len(seq) > 33 and pipe == seq == want


def test_empty_sink_ends_in_the_fetched_runs_state():
    """The Empty sink runs K2's plain version per band (no events); its
    state equals the Raw run's, and the display frame kept on the way."""
    plane = (11, 13, 3)
    chunks = [_frames(plane, 3, s) for s in range(3)]
    _, _, raw = _stream("sharded", plane, "FramePerfect", chunks, k=3)

    def void(v):
        v.void_events = True
        v._keep_running_frame = True

    _, _, vd = _stream("sharded", plane, "FramePerfect", chunks, k=3,
                       before=void)
    _, _, single = _stream("port", plane, "FramePerfect", chunks,
                           before=void)
    got = convert.state_to_numpy(sh.gather_state(vd.state, "cpu"))
    for name, want in convert.state_to_numpy(
            sh.gather_state(raw.state, "cpu")).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    np.testing.assert_array_equal(vd.running_intensities,
                                  single.running_intensities)


def test_roi_matches_jax_video():
    plane = (20, 12, 1)
    chunks = [_frames(plane, 3, 20 + s) for s in range(2)]

    def roi(v):
        v.update_crf(6)  # baseline 7: the ROI lowers it to 2
        v.update_roi((Roi if isinstance(v, Video) else JaxRoi)(3, 2, 9, 7))

    got = _stream("sharded", plane, "FramePerfect", chunks, k=3,
                  before=roi)[1]
    want = _stream("jax", plane, "FramePerfect", chunks, before=roi)[1]
    plain = _stream("sharded", plane, "FramePerfect", chunks, k=3,
                    before=lambda v: v.update_crf(6))[1]
    assert got == want and got != plain


def test_capacity_rerun(monkeypatch):
    """With the full-capacity shortcut off a band's chunk starts at n_local
    x T events; content that swings every pixel past its threshold
    overflows it, every band reruns from the pre-chunk state at a doubled
    capacity, `_cap_mult` grows, and the bytes stay adder_tpu's."""
    monkeypatch.setattr(TS, "FULL_CAP_VOLUME", 0)
    caps = []
    orig = sh.FR.fused_chunk_resident

    def chunk(state, frames, time, p, run0=None, *, event_cap):
        res = orig(state, frames, time, p, run0, event_cap=event_cap)
        caps.append((event_cap, int(res.total)))
        return res

    monkeypatch.setattr(sh.FR, "fused_chunk_resident", chunk)
    plane = (12, 10, 1)
    frames = np.random.default_rng(5).integers(0, 256, (16, 10, 12, 1)
                                               ).astype(np.uint8)
    frames[1::2] = 255 - frames[1::2]
    chunks = [frames[i:i + 4] for i in range(0, 16, 4)]
    _, got, sv = _stream("sharded", plane, "Continuous", chunks, k=2,
                         pipelined=True)
    _, want, _ = _stream("jax", plane, "Continuous", chunks, pipelined=True)
    n_t = 60 * 4
    assert caps[0][0] == n_t and caps[0][1] > n_t
    assert any(c > n_t for c, _ in caps) and sv._cap_mult > 1
    assert len(want) > 1000 and got == want


def test_checkpoint_resume_across_band_counts(tmp_path):
    """A checkpoint of a 2-band Video taken after two chunks resumes in a
    3-band one and in the port's Video with the uninterrupted run's bytes;
    a JAX ShardedVideo's checkpoint (padded plane) is refused."""
    plane = (11, 13, 3)
    chunks = [_frames(plane, 3, 30 + s) for s in range(4)]
    want_ev = _stream("sharded", plane, "FramePerfect", chunks)[0]
    a, mods = _make("sharded", plane, "FramePerfect", 2)
    _configure(a, mods, io.BytesIO(), plane)
    for c in chunks[:2]:
        a.integrate_matrix_batch(c)
    path = tmp_path / "ck.npz"
    a.save_checkpoint(path)
    for kind, k in (("sharded", 3), ("port", 1)):
        b, mods = _make(kind, plane, "FramePerfect", k)
        _configure(b, mods, io.BytesIO(), plane)
        b.load_checkpoint(path)
        for c, w in zip(chunks[2:], want_ev[2:]):
            for x, y in zip(_events(b.integrate_matrix_batch(c)), w):
                np.testing.assert_array_equal(x, y)
    j, jm = _make("jax-sharded", plane, "FramePerfect", 2)
    _configure(j, jm, io.BytesIO(), plane)
    j.save_checkpoint(tmp_path / "jax.npz")
    c, mods = _make("sharded", plane, "FramePerfect", 2)
    with pytest.raises(Exception, match="padding"):
        c.load_checkpoint(tmp_path / "jax.npz")


def test_jax_sharded_state_carried_mid_stream():
    """adder_tpu's ShardedVideo transcodes the first chunk; its padded
    state, cut to the plane by convert.shard_jax_state, starts the port's
    ShardedVideo, whose second chunk equals the JAX one's. Then the port's
    bands, padded by convert.bands_to_numpy, go back into a JAX
    ShardedVideo, whose third chunk equals the port's."""
    plane = (11, 13, 3)
    chunks = [_frames(plane, 3, 40 + s) for s in range(3)]
    j, jm = _make("jax-sharded", plane, "FramePerfect", 2)
    _configure(j, jm, io.BytesIO(), plane)
    j.integrate_matrix_batch(chunks[0])
    assert j.n_state != j.n  # the JAX plane is padded
    s, mods = _make("sharded", plane, "FramePerfect", 4)
    _configure(s, mods, io.BytesIO(), plane)
    s.state = convert.shard_jax_state(j.state, s.n, s.mesh)
    s.in_interval_count = j.in_interval_count
    for x, y in zip(_events(s.integrate_matrix_batch(chunks[1])),
                    _events(j.integrate_matrix_batch(chunks[1]))):
        np.testing.assert_array_equal(x, y)
    back, bm = _make("jax-sharded", plane, "FramePerfect", 2)
    _configure(back, bm, io.BytesIO(), plane)
    fields = convert.bands_to_numpy(s.state, back.n_state)
    back.state = back._shard(jops.PixelState(
        **{f: jnp.asarray(v) for f, v in fields.items()}))
    back.in_interval_count = s.in_interval_count
    for x, y in zip(_events(back.integrate_matrix_batch(chunks[2])),
                    _events(s.integrate_matrix_batch(chunks[2]))):
        np.testing.assert_array_equal(x, y)


def _features_snap(v):
    c = (v._c_thresh_numpy() if isinstance(v, ShardedVideo)
         else np.asarray(v.state.c_thresh))
    return (set(v.features), v.display_frame_features.copy(),
            np.array(v.running_intensities), c)


@pytest.mark.parametrize("k", [2, 3])
def test_features_match_jax_video(k):
    """Features on (Instant markers, crf 5, the rate adjustment and
    clustering) over bands: the bytes, the feature set, the display frame
    with its markers and c_thresh after every chunk equal adder_tpu's
    Video."""
    frames = testing.moving_shapes(8, 12, 48, 64, 3)
    plane = (64, 48, 3)
    seen = {}
    for kind in ("jax", "sharded"):
        v, mods = _make(kind, plane, "FramePerfect", k)
        buf = io.BytesIO()
        v.time_parameters(255 * 24, 255, 255 * 30, mods.TimeMode.AbsoluteT)
        enc_type, enc_opts = ((JaxEncoderType, JaxEncoderOptions)
                              if mods is JT else (EncoderType, EncoderOptions))
        v.write_out(mods.SourceCamera.FramedU8, mods.TimeMode.AbsoluteT,
                    mods.PixelMultiMode.Collapse, None, enc_type.Raw,
                    enc_opts.default(mods.PlaneSize(*plane)), buf)
        v.update_crf(5)
        v.update_detect_features(True, 1, True, True)
        snaps = []
        for i in range(0, len(frames), 4):
            v.integrate_matrix_batch(frames[i:i + 4])
            snaps.append(_features_snap(v))
        v.end_write_stream()
        seen[kind] = (buf.getvalue(), snaps)
    assert seen["sharded"][0] == seen["jax"][0]
    for g, w in zip(seen["sharded"][1], seen["jax"][1]):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
    assert seen["jax"][1][-1][0]  # the scene has features
    assert seen["jax"][1][-1][3].min() <= 2  # the rate adjustment ran
