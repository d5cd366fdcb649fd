"""The port's one-interval engines of `Video` on the CPU, chosen by the JAX
package's environment names (`ADDER_TPU_RESIDENT=0`: fused, K5;
`ADDER_TPU_FUSED=0`: interval slots, K6), against adder_tpu's `Video` on the
CPU (its XLA chunk engine, whatever the environment): the same `.adder`
bytes and the same display frames, byte for byte (no tolerance)."""

import io

import numpy as np
import pytest

from adder_tpu.codec.encoder import EncoderOptions, EncoderType
from adder_tpu.core.types import (
    Mode,
    PixelMultiMode,
    PlaneSize,
    SourceCamera,
    TimeMode,
)
from adder_tpu.transcoder.framed import FramedArray as JaxFramedArray
from adder_tpu.transcoder.video import Video as JaxVideo
from adder_tpu_torch import FramedArray, Video, convert
from adder_tpu_torch.transcoder import video as TV

ENGINES = {"fused": "ADDER_TPU_RESIDENT", "slots": "ADDER_TPU_FUSED"}


@pytest.fixture(params=sorted(ENGINES))
def engine(request, monkeypatch):
    monkeypatch.setenv(ENGINES[request.param], "0")
    return request.param


def synth_frames(T, H, W, C=1, seed=0):
    rng = np.random.default_rng(seed)
    frames = np.zeros((T, H, W, C), dtype=np.uint8)
    cur = rng.integers(0, 256, (H, W, C))
    for t in range(T):
        step = rng.integers(-4, 5, (H, W, C))
        jump = rng.random((H, W, C)) < 0.03
        cur = np.where(jump, rng.integers(0, 256, (H, W, C)),
                       np.clip(cur + step, 0, 255))
        frames[t] = cur
    return frames


def _framed_run(src, cfg):
    """Transcode every chunk; return the bytes and the display frame after
    each chunk."""
    if cfg == "bench":
        src.auto_time_parameters(255, 255 * 24, TimeMode.DeltaT)
        src.quality_manual(0, 0, 24, 1, 0)
    else:
        src.auto_time_parameters(255, 255 * 4, TimeMode.AbsoluteT)
        src.crf(3)
    buf = io.BytesIO()
    src.write_out(
        SourceCamera.FramedU8, src.video.time_mode, PixelMultiMode.Collapse,
        None, EncoderType.Raw, EncoderOptions.default(src.video.plane), buf,
    )
    src.video._keep_running_frame = True
    shown = []
    while True:
        try:
            src.consume_batch()
        except EOFError:
            break
        shown.append(np.array(src.video.running_intensities))
    src.video.end_write_stream()
    return buf.getvalue(), shown


@pytest.mark.parametrize("channels", [1, 3], ids=["mono", "color"])
@pytest.mark.parametrize("cfg", ["bench", "crf3"])
def test_engine_bytes_and_display_match_jax(engine, channels, cfg):
    frames = synth_frames(12, 16, 24, channels)
    want, want_shown = _framed_run(
        JaxFramedArray(frames, 24.0, chunk_frames=4), cfg)
    src = FramedArray(frames, 24.0, chunk_frames=4, device="cpu")
    assert src.video.engine == engine
    got, got_shown = _framed_run(src, cfg)
    assert len(want) > 1000
    assert got == want
    assert len(got_shown) == 3
    for a, b in zip(got_shown, want_shown):
        np.testing.assert_array_equal(a, b)
    assert got_shown[-1].any()
    assert src.video._last_runnings.shape == (4, 16 * 24 * channels)


def _video(cls, plane, writer, T, mode=Mode.FramePerfect,
           multi=PixelMultiMode.Collapse, dtm_mult=1000, c0=10, **kw):
    v = cls(plane, mode, chunk_frames=T, **kw)
    v.time_parameters(255 * 30, 255, 255 * dtm_mult, TimeMode.AbsoluteT)
    v.write_out(SourceCamera.FramedU8, TimeMode.AbsoluteT, multi, None,
                EncoderType.Raw, EncoderOptions.default(plane), writer)
    v.update_quality_manual(c0, 0, dtm_mult, 1, 0)
    return v


def _submit_all(v, frames, T):
    """Every chunk submitted before the last is collected (two stay in
    flight); the display frame after the stream."""
    v._keep_running_frame = True
    for i in range(0, len(frames), T):
        v.submit_chunk(frames[i : i + T])
    v.end_write_stream()
    return np.array(v.running_intensities)


def test_depth_rerun_with_chunks_in_flight(engine):
    """Dim, near-constant input outgrows the depth-6 arena after ~30
    intervals: the fused engine reruns that chunk and the one in flight on
    top of it at depth 8, display chain included; the slot engine runs
    depth 8 throughout. Both write adder_tpu's bytes and display."""
    rng = np.random.default_rng(1)
    H, W, T = 6, 8, 8
    frames = rng.integers(1, 4, (48, H, W, 1)).astype(np.uint8)
    plane = PlaneSize(W, H, 1)
    outs = []
    for cls, kw in ((JaxVideo, {}), (Video, {"device": "cpu"})):
        buf = io.BytesIO()
        v = _video(cls, plane, buf, T, **kw)
        shown = _submit_all(v, frames, T)
        outs.append((buf.getvalue(), shown))
    assert v.state.node_d.shape[0] == 8
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def test_capacity_and_pack_reruns(engine, monkeypatch):
    """With the full-capacity shortcut off, a chunk starts at N x T events:
    Continuous / Normal content with delta_t_max == ref_time overflows the
    capacity and the slot engine's per-interval take, and with 2 packed
    lanes to start from (up to 3 events per pixel-interval) the pack; the
    reruns still write adder_tpu's bytes and display."""
    monkeypatch.setattr(TV, "FULL_CAP_VOLUME", 0)
    frames = synth_frames(16, 10, 12, 1, seed=5)
    frames[1::2] = 255 - frames[1::2]  # every pixel crosses its threshold
    plane = PlaneSize(12, 10, 1)
    outs = []
    for cls, kw in ((JaxVideo, {}), (Video, {"device": "cpu"})):
        buf = io.BytesIO()
        v = _video(cls, plane, buf, 4, Mode.Continuous, PixelMultiMode.Normal,
                   dtm_mult=1, c0=0, **kw)
        v._pack = 2
        shown = _submit_all(v, frames, 4)
        outs.append((buf.getvalue(), shown))
    assert v._cap_mult > 1 and v._pack > 2  # both reruns happened
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def test_resident_capacity_rerun(monkeypatch):
    """The resident engine's capacity contract: with the full-capacity
    shortcut off a chunk starts at N x T events, content that swings every
    pixel past its threshold overflows it, and with two chunks in flight
    the overflowing chunk reruns from its pre-chunk state at a doubled
    capacity. `_cap_mult` grows; the bytes and the display after every
    chunk equal adder_tpu's."""
    monkeypatch.delenv("ADDER_TPU_RESIDENT", raising=False)
    monkeypatch.delenv("ADDER_TPU_FUSED", raising=False)
    monkeypatch.setattr(TV, "FULL_CAP_VOLUME", 0)
    caps = []
    orig = TV.fused_resident.fused_chunk_resident

    def chunk(state, frames, time, p, run0=None, *, event_cap, wide):
        res = orig(state, frames, time, p, run0, event_cap=event_cap,
                   wide=wide)
        caps.append((event_cap, int(res.total)))
        return res

    monkeypatch.setattr(TV.fused_resident, "fused_chunk_resident", chunk)
    frames = synth_frames(16, 10, 12, 1, seed=5)
    frames[1::2] = 255 - frames[1::2]  # every pixel crosses its threshold
    plane = PlaneSize(12, 10, 1)
    outs = []
    for cls, kw in ((JaxVideo, {}), (Video, {"device": "cpu"})):
        buf = io.BytesIO()
        v = _video(cls, plane, buf, 4, Mode.Continuous, PixelMultiMode.Normal,
                   dtm_mult=1, c0=0, **kw)
        shown = _submit_all(v, frames, 4)
        outs.append((buf.getvalue(), shown))
    assert v.engine == "resident" and v._cap_mult > 1
    n_t = 12 * 10 * 4
    assert caps[0][0] == n_t and caps[0][1] > n_t  # the first chunk overflows
    reruns = [c for c, _ in caps if c > n_t]
    assert reruns and all(c % n_t == 0 for c in reruns)
    assert all(total <= cap for cap, total in caps if cap > n_t)
    assert len(outs[0][0]) > 1000 and outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def test_resume_from_jax_depth8_state(engine):
    """adder_tpu transcodes the first chunk; the port's engine takes its
    depth-8 state (through numpy) and its display frame and transcodes the
    second: adder_tpu's events, state and display."""
    frames = synth_frames(8, 12, 10, 1, seed=4)
    plane = PlaneSize(10, 12, 1)
    jv = _video(JaxVideo, plane, io.BytesIO(), 4)
    jv._keep_running_frame = True
    jv.integrate_matrix_batch(frames[:4])
    tv = _video(Video, plane, io.BytesIO(), 4, device="cpu")
    tv._keep_running_frame = True
    tv.state = convert.state_from_numpy(jv.state, "cpu")
    assert tv.state.node_d.shape[0] == 8
    tv.in_interval_count = jv.in_interval_count
    tv.running_intensities = np.array(jv.running_intensities)
    want = jv.integrate_matrix_batch(frames[4:])
    got = tv.integrate_matrix_batch(frames[4:])
    assert len(want) > 0 and len(got) == len(want)
    for f in ("x", "y", "c", "d", "t"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(tv.running_intensities,
                                  jv.running_intensities)
    port = convert.state_to_numpy(tv.state)
    for f, a in zip(jv.state._fields[:-1], jv.state[:-1]):
        np.testing.assert_array_equal(np.asarray(a), port[f], err_msg=f)
    np.testing.assert_array_equal(np.asarray(jv._last_runnings),
                                  tv._last_runnings.numpy())


def test_resident_engine_refuses_the_display_frame(monkeypatch):
    """The name is historical: the resident engine now keeps the display
    frame through its kernel's display output, and its `_last_runnings`
    and `running_intensities` equal adder_tpu's after every chunk; with
    the display off it writes none."""
    monkeypatch.delenv("ADDER_TPU_RESIDENT", raising=False)
    monkeypatch.delenv("ADDER_TPU_FUSED", raising=False)
    frames = synth_frames(12, 9, 11, 1, seed=6)
    plane = PlaneSize(11, 9, 1)
    jv = _video(JaxVideo, plane, io.BytesIO(), 4)
    tv = _video(Video, plane, io.BytesIO(), 4, device="cpu")
    assert tv.engine == "resident"
    tv.integrate_matrix_batch(frames[:4])
    assert tv._last_runnings is None  # the display off: no display output
    jv.integrate_matrix_batch(frames[:4])
    for v in (jv, tv):
        v._keep_running_frame = True
    for i in range(4, 12, 4):
        want = jv.integrate_matrix_batch(frames[i : i + 4])
        got = tv.integrate_matrix_batch(frames[i : i + 4])
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(tv._last_runnings.numpy(),
                                      np.asarray(jv._last_runnings))
        np.testing.assert_array_equal(tv.running_intensities,
                                      jv.running_intensities)
    assert tv.running_intensities.any()
    monkeypatch.setenv("ADDER_TPU_RESIDENT", "0")
    monkeypatch.setenv("ADDER_TPU_FUSED", "0")  # the slot engine wins
    assert Video(PlaneSize(4, 3, 1), Mode.FramePerfect,
                 device="cpu").engine == "slots"


@pytest.mark.parametrize("channels", [1, 3], ids=["mono", "color"])
@pytest.mark.parametrize("cfg", ["bench", "crf3"])
def test_resident_bytes_and_display_match_jax(channels, cfg, monkeypatch):
    """The resident engine with the display kept: adder_tpu's bytes and
    display frame after every chunk."""
    monkeypatch.delenv("ADDER_TPU_RESIDENT", raising=False)
    monkeypatch.delenv("ADDER_TPU_FUSED", raising=False)
    frames = synth_frames(12, 16, 24, channels)
    want, want_shown = _framed_run(
        JaxFramedArray(frames, 24.0, chunk_frames=4), cfg)
    src = FramedArray(frames, 24.0, chunk_frames=4, device="cpu")
    assert src.video.engine == "resident"
    got, got_shown = _framed_run(src, cfg)
    assert len(want) > 1000 and got == want
    assert len(got_shown) == 3
    for a, b in zip(got_shown, want_shown):
        np.testing.assert_array_equal(a, b)
    assert got_shown[-1].any()


def test_resident_depth_rerun_rechains_the_display(monkeypatch):
    """The resident engine outgrows depth 6 with chunks in flight and the
    display kept: the rerun chunks start from the rerun chunk's display
    frame (video.py:636-646); adder_tpu's bytes and display."""
    monkeypatch.delenv("ADDER_TPU_RESIDENT", raising=False)
    monkeypatch.delenv("ADDER_TPU_FUSED", raising=False)
    rng = np.random.default_rng(1)
    H, W, T = 6, 8, 8
    frames = rng.integers(1, 4, (48, H, W, 1)).astype(np.uint8)
    plane = PlaneSize(W, H, 1)
    outs, reruns = [], []
    orig = TV.ops.pad_state_depth

    def pad(state, depth):
        reruns.append(depth)
        return orig(state, depth)

    monkeypatch.setattr(TV.ops, "pad_state_depth", pad)
    for cls, kw in ((JaxVideo, {}), (Video, {"device": "cpu"})):
        buf = io.BytesIO()
        v = _video(cls, plane, buf, T, **kw)
        shown = _submit_all(v, frames, T)
        outs.append((buf.getvalue(), shown))
    assert v.engine == "resident" and v.state.node_d.shape[0] == 8
    assert reruns  # the port reran
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def test_void_events_on_one_interval_engines(engine):
    """The Empty sink on a one-interval engine: no events come back, the
    state and display equal the fetched run's."""
    frames = synth_frames(8, 6, 7, 1, seed=2)
    runs = []
    for void in (False, True):
        src = FramedArray(frames, chunk_frames=4, device="cpu")
        src.video._keep_running_frame = True
        src.video.void_events = void
        n = sum(len(src.consume_batch()) for _ in range(2))
        runs.append((n, src.video))
    assert runs[0][0] > 0 and runs[1][0] == 0
    for a, b in zip(runs[0][1].state, runs[1][1].state):
        assert np.array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(runs[0][1].running_intensities,
                                  runs[1][1].running_intensities)
