"""Feature detection and checkpoints of the port's `Video` against
adder_tpu's, on the CPU.

- `fast_mask_torch` against the JAX package's `fast_mask_jax` and its numpy
  `fast_mask`: random images, a quadrant corner, a uniform image, a batch.
- The port's `Video(device="cpu")` on each of its three engines (resident,
  `ADDER_TPU_RESIDENT=0` fused, `ADDER_TPU_FUSED=0` slots) against
  adder_tpu's `Video` on the CPU (its XLA chunk engine) with feature
  detection on: the `.adder` bytes, the feature set, the display frame with
  its markers (Off, Instant, Hold), `c_thresh` after the rate adjustment at
  crf 5, the clustered boxes; chunks collected one by one (sequential) and
  submitted two in flight (pipelined); mono and colour; the moving square of
  tests/test_features_player.py and a seeded scene of moving shapes.
- Checkpoints written by either package resume in the other with the same
  bytes.
Tolerance: none; every comparison is exact.
"""

import io

import numpy as np
import pytest

from adder_tpu.codec.encoder import EncoderOptions as JaxEncoderOptions
from adder_tpu.codec.encoder import EncoderType as JaxEncoderType
from adder_tpu.core import types as JT
from adder_tpu.transcoder.video import Video as JaxVideo
from adder_tpu.utils import cv as JCV
from adder_tpu_torch import Video, convert, testing
from adder_tpu_torch.codec.encoder import EncoderOptions, EncoderType
from adder_tpu_torch.core import types as T
from adder_tpu_torch.transcoder import video as TV
from adder_tpu_torch.utils import cv as CV

import torch

ENGINES = {"resident": None, "fused": "ADDER_TPU_RESIDENT",
           "slots": "ADDER_TPU_FUSED"}


@pytest.fixture(params=sorted(ENGINES))
def engine(request, monkeypatch):
    monkeypatch.delenv("ADDER_TPU_RESIDENT", raising=False)
    monkeypatch.delenv("ADDER_TPU_FUSED", raising=False)
    if ENGINES[request.param]:
        monkeypatch.setenv(ENGINES[request.param], "0")
    return request.param


# --- FAST -------------------------------------------------------------------


def _fast_images(case):
    if case == "quadrant":  # tests/test_utils_tools.py:32-41
        img = np.full((20, 20), 50, dtype=np.uint8)
        img[:10, :10] = 200
        return img[None]
    if case == "uniform":
        return np.full((1, 16, 16), 128, dtype=np.uint8)
    if case == "batch":
        return testing.moving_shapes(5, 6, 24, 40)[..., 0]
    rng = np.random.default_rng(int(case[-1]))
    return rng.integers(0, 256, (1, 32, 32), dtype=np.uint8)


@pytest.mark.parametrize("case", ["random0", "random1", "random2",
                                  "quadrant", "uniform", "batch"])
def test_fast_mask_torch_equals_jax_and_numpy(case):
    imgs = _fast_images(case)
    got = CV.fast_mask_torch(torch.from_numpy(imgs)).numpy()
    for img, g in zip(imgs, got):
        np.testing.assert_array_equal(g, np.asarray(JCV.fast_mask_jax(img)))
        np.testing.assert_array_equal(g, JCV.fast_mask(img))
    if case == "uniform":
        assert not got.any()
    else:
        assert got.any()


# --- the feature pipeline of Video ------------------------------------------


def moving_square_frames(T=10, H=24, W=32):
    """tests/test_features_player.py:32-38"""
    frames = np.full((T, H, W, 1), 30, dtype=np.uint8)
    for t in range(T):
        x0 = 4 + t
        frames[t, 6:16, x0 : x0 + 10, 0] = 220
    return frames


SCENES = {
    "square": lambda: moving_square_frames(),
    "shapes-mono": lambda: testing.moving_shapes(7, 12, 64, 96, 1),
    "shapes-color": lambda: testing.moving_shapes(8, 12, 64, 96, 3),
}
# (show_features, rate adjustment and clustering at crf 5)
CONFIGS = {"off": (0, False), "instant": (1, False), "hold": (2, False),
           "rate": (1, True)}
CHUNK = 4


def _features_video(cls, mods, plane, writer, show, rate, **kw):
    v = cls(plane, mods.Mode.FramePerfect, chunk_frames=CHUNK, **kw)
    v.time_parameters(255 * 24, 255, 255 * 30, mods.TimeMode.AbsoluteT)
    enc_type, enc_opts = ((JaxEncoderType, JaxEncoderOptions) if mods is JT
                          else (EncoderType, EncoderOptions))
    v.write_out(mods.SourceCamera.FramedU8, mods.TimeMode.AbsoluteT,
                mods.PixelMultiMode.Collapse, None, enc_type.Raw,
                enc_opts.default(plane), writer)
    if rate:
        v.update_crf(5)
    v.update_detect_features(True, show, rate, rate)
    return v


def _c_thresh(v):
    c = v.state.c_thresh
    return c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def _features_run(pkg, frames, show, rate, pipelined):
    """The bytes, and what the feature pipeline left after each collected
    chunk (sequential) or after the stream (pipelined): feature set,
    display frame with markers, display frame, c_thresh."""
    H, W, C = frames.shape[1:]
    cls, mods, kw = ((JaxVideo, JT, {}) if pkg == "jax"
                     else (Video, T, {"device": "cpu"}))
    buf = io.BytesIO()
    v = _features_video(cls, mods, mods.PlaneSize(W, H, C), buf, show, rate,
                        **kw)

    def snap():
        return (set(v.features), v.display_frame_features.copy(),
                np.array(v.running_intensities), _c_thresh(v).copy())

    seen = []
    for i in range(0, len(frames), CHUNK):
        if pipelined:
            v.submit_chunk(frames[i : i + CHUNK])
        else:
            v.integrate_matrix_batch(frames[i : i + CHUNK])
            seen.append(snap())
    v.end_write_stream()
    seen.append(snap())
    return buf.getvalue(), seen, v


_JAX_RUNS: dict = {}


def _jax_run(scene, cfg, pipelined):
    key = (scene, cfg, pipelined)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _features_run("jax", SCENES[scene](), *CONFIGS[cfg],
                                       pipelined)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sequential", "pipelined"])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_features_equal_jax(engine, scene, cfg, pipelined):
    want, want_seen, jv = _jax_run(scene, cfg, pipelined)
    got, got_seen, tv = _features_run("port", SCENES[scene](), *CONFIGS[cfg],
                                      pipelined)
    assert tv.engine == engine
    assert len(want) > 1000 and got == want
    assert len(got_seen) == len(want_seen)
    for i, (g, w) in enumerate(zip(got_seen, want_seen)):
        assert g[0] == w[0], f"features after chunk {i}"
        for j, name in ((1, "display_frame_features"),
                        (2, "running_intensities"), (3, "c_thresh")):
            np.testing.assert_array_equal(g[j], w[j],
                                          err_msg=f"{name} after chunk {i}")
    assert want_seen[-1][0]  # the scene has features
    if cfg == "rate":
        assert want_seen[-1][3].min() <= 2  # the rate adjustment lowered some
    if cfg != "off":  # markers drawn over the display frame
        assert (want_seen[-1][1] != want_seen[-1][2]).any()
    np.testing.assert_array_equal(tv._last_runnings.numpy(),
                                  np.asarray(jv._last_runnings))


@pytest.mark.parametrize("scene", ["square", "shapes-color"])
def test_cluster_boxes_equal_jax(scene):
    """`cluster` on the feature set the rate run ends with: the same boxes,
    drawn the same way."""
    _, seen, jv = _jax_run(scene, "rate", False)
    frames = SCENES[scene]()
    H, W, C = frames.shape[1:]
    tv = _features_video(Video, T, T.PlaneSize(W, H, C), io.BytesIO(), 1,
                         True, device="cpu")
    points = seen[-1][0] | {(5, 5), (6, 5), (5, 6), (6, 6)}
    for v in (jv, tv):
        v.display_frame_features = np.zeros((H, W, C), np.uint8)
    want = jv.cluster(points)
    got = tv.cluster(points)
    assert want and got == want
    np.testing.assert_array_equal(tv.display_frame_features,
                                  jv.display_frame_features)


# --- checkpoints --------------------------------------------------------------


def _checkpoint_round(tmp_path, writer_pkg, reader_pkg, reader_engine):
    """`writer_pkg` transcodes two chunks and saves a checkpoint; a fresh
    Video of `reader_pkg` loads it and transcodes the rest. The resumed
    run's events must continue the uninterrupted run's file, and its state
    and display frame must equal the uninterrupted run's."""
    frames = testing.moving_shapes(9, 16, 40, 56, 1)
    H, W, C = frames.shape[1:]

    def make(pkg, buf):
        cls, mods, kw = ((JaxVideo, JT, {}) if pkg == "jax"
                         else (Video, T, {"device": "cpu"}))
        v = _features_video(cls, mods, mods.PlaneSize(W, H, C), buf, 1,
                            False, **kw)
        return v

    full_buf = io.BytesIO()
    full = make("jax", full_buf)
    for i in range(0, len(frames), CHUNK):
        full.integrate_matrix_batch(frames[i : i + CHUNK])
    full.end_write_stream()

    head_buf = io.BytesIO()
    head = make(writer_pkg, head_buf)
    for i in range(0, 2 * CHUNK, CHUNK):
        head.submit_chunk(frames[i : i + CHUNK])
    path = tmp_path / f"{writer_pkg}.npz"
    head.save_checkpoint(path)
    header = head.encoder.meta.header_size

    tail_buf = io.BytesIO()
    tail = make(reader_pkg, tail_buf)
    tail.load_checkpoint(path)
    if reader_pkg == "port":
        assert tail.engine == reader_engine
    for i in range(2 * CHUNK, len(frames), CHUNK):
        tail.submit_chunk(frames[i : i + CHUNK])
    tail.end_write_stream()
    resumed = head_buf.getvalue() + tail_buf.getvalue()[header:]
    assert len(resumed) > 10_000 and resumed == full_buf.getvalue()
    np.testing.assert_array_equal(np.array(tail.running_intensities),
                                  np.array(full.running_intensities))
    got = (convert.state_to_numpy(tail.state) if reader_pkg == "port"
           else {f: np.asarray(x) for f, x in zip(tail.state._fields,
                                                  tail.state)})
    for f, a in zip(full.state._fields[:-1], full.state[:-1]):
        if a.ndim == 2:  # the arena: compare at the shallower depth's rows
            d = min(a.shape[0], got[f].shape[0])
            np.testing.assert_array_equal(got[f][:d], np.asarray(a)[:d],
                                          err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], np.asarray(a), err_msg=f)
    return tail


def test_checkpoint_from_jax_resumes_in_port(engine, tmp_path):
    tail = _checkpoint_round(tmp_path, "jax", "port", engine)
    assert tail.state.node_d.shape[0] == 8  # adder_tpu on the CPU: depth 8


def test_checkpoint_from_port_resumes_in_jax(engine, tmp_path):
    _checkpoint_round(tmp_path, "port", "jax", engine)


def test_checkpoint_depth6_pads_on_the_slot_engine(tmp_path, monkeypatch):
    """A depth-6 checkpoint of the resident engine loads at depth 8 into
    the slot engine and at depth 6 into the fused engine, with the same
    arena rows; a checkpoint of another plane or padding raises."""
    monkeypatch.delenv("ADDER_TPU_RESIDENT", raising=False)
    monkeypatch.delenv("ADDER_TPU_FUSED", raising=False)
    plane = T.PlaneSize(12, 10, 1)
    src = Video(plane, T.Mode.FramePerfect, chunk_frames=4, device="cpu")
    src.integrate_matrix_batch(testing.moving_shapes(2, 4, 10, 12, 1))
    assert src.state.node_d.shape[0] == 6
    path = tmp_path / "ck.npz"
    src.save_checkpoint(path)
    depths = {}
    for env in ("ADDER_TPU_FUSED", "ADDER_TPU_RESIDENT"):
        monkeypatch.setenv(env, "0")
        v = Video(plane, T.Mode.FramePerfect, chunk_frames=4, device="cpu")
        v.load_checkpoint(path)
        depths[v.engine] = v.state.node_d.shape[0]
        assert torch.equal(v.state.node_d[:6], src.state.node_d)
        assert v.in_interval_count == 4
        monkeypatch.delenv(env)
    assert depths == {"slots": 8, "fused": 6}
    z = dict(np.load(path))
    z["n_state"] = np.int64(plane.volume() + 1)
    bad = tmp_path / "bad.npz"
    np.savez(bad, **z)
    with pytest.raises(TV.SourceError):
        src.load_checkpoint(bad)
    with pytest.raises(TV.SourceError):
        Video(T.PlaneSize(12, 11, 1), T.Mode.FramePerfect,
              device="cpu").load_checkpoint(path)


def test_features_turned_on_mid_stream(engine):
    """Features turned on while a chunk submitted without them is still in
    flight (as a live view toggles them): the stream goes on with the same
    bytes, and the display and features follow from then on."""
    frames = testing.moving_shapes(4, 12, 48, 64, 1)
    H, W, C = frames.shape[1:]
    outs = []
    for cls, mods, kw in ((JaxVideo, JT, {}), (Video, T, {"device": "cpu"})):
        buf = io.BytesIO()
        v = _features_video(cls, mods, mods.PlaneSize(W, H, C), buf, 1,
                            False, **kw)
        v.update_detect_features(False)
        v.submit_chunk(frames[:CHUNK])
        v.update_detect_features(True, 1)
        for i in range(CHUNK, len(frames), CHUNK):
            v.submit_chunk(frames[i : i + CHUNK])
        v.end_write_stream()
        outs.append((buf.getvalue(), v))
    assert outs[1][0] == outs[0][0]
    assert outs[1][1].features and outs[1][1].running_intensities.any()
