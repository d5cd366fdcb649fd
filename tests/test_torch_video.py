"""The whole slice on the CPU: the port's FramedArray / Video writes the same
`.adder` bytes as adder_tpu's, byte for byte (no tolerance)."""

import io

import numpy as np
import pytest
import torch

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


def _configure(src, cfg):
    if cfg == "bench":
        # the reference's criterion bench: lossless, DeltaT, dtm 24 * 255
        src.auto_time_parameters(255, 255 * 24, TimeMode.DeltaT)
        src.quality_manual(0, 0, 24, 1, 0)
    else:
        src.auto_time_parameters(255, 255 * 4, TimeMode.AbsoluteT)
        src.crf(3)


def _transcode(src, cfg):
    _configure(src, cfg)
    buf = io.BytesIO()
    src.write_out(
        SourceCamera.FramedU8, src.video.time_mode, PixelMultiMode.Collapse,
        None, EncoderType.Raw, EncoderOptions.default(src.video.plane), buf,
    )
    while True:
        try:
            src.consume_batch()
        except EOFError:
            break
    src.video.end_write_stream()
    return buf.getvalue()


@pytest.mark.parametrize("channels", [1, 3], ids=["mono", "color"])
@pytest.mark.parametrize("cfg", ["bench", "crf3"])
def test_adder_bytes_match_jax(channels, cfg):
    frames = synth_frames(12, 16, 24, channels)
    want = _transcode(JaxFramedArray(frames, 24.0, chunk_frames=4), cfg)
    got = _transcode(FramedArray(frames, 24.0, chunk_frames=4, device="cpu"),
                     cfg)
    assert len(want) > 1000
    assert got == want


def _video(cls, plane, writer, T, **kw):
    v = cls(plane, Mode.FramePerfect, chunk_frames=T, **kw)
    v.time_parameters(255 * 30, 255, 255 * 1000, TimeMode.AbsoluteT)
    v.write_out(
        SourceCamera.FramedU8, TimeMode.AbsoluteT, PixelMultiMode.Collapse,
        None, EncoderType.Raw, EncoderOptions.default(plane), writer,
    )
    # c_thresh 10 keeps the dim test scene from resetting the arenas
    v.update_quality_manual(10, 0, 1000, 1, 0)
    return v


def test_depth_rerun_matches_jax():
    """Dim, near-constant input outgrows the depth-6 arena after ~30
    intervals: the port reruns that chunk and the one in flight behind it
    at depth 8, and still writes adder_tpu's bytes (which runs depth 8)."""
    rng = np.random.default_rng(1)
    H, W, T = 6, 8, 8
    frames = rng.integers(1, 4, (48, H, W, 1)).astype(np.uint8)
    plane = PlaneSize(W, H, 1)
    outs = []
    for cls, kw in ((JaxVideo, {}), (Video, {"device": "cpu"})):
        buf = io.BytesIO()
        v = _video(cls, plane, buf, T, **kw)
        for i in range(0, len(frames), T):
            v.submit_chunk(frames[i : i + T])
        v.end_write_stream()
        outs.append(buf.getvalue())
        if cls is Video:
            assert v.state.node_d.shape[0] == 8  # the rerun happened
    assert outs[0] == outs[1]


def test_resume_from_jax_state():
    """adder_tpu transcodes the first chunk; the port takes its state
    (through numpy) and transcodes the second: the same events as
    adder_tpu's own second chunk."""
    frames = synth_frames(8, 12, 10, 1, seed=4)
    plane = PlaneSize(10, 12, 1)
    jv = _video(JaxVideo, plane, io.BytesIO(), 4)
    jv.integrate_matrix_batch(frames[:4])
    tv = _video(Video, plane, io.BytesIO(), 4, device="cpu")
    tv.state = convert.state_from_numpy(jv.state, "cpu")
    tv.in_interval_count = jv.in_interval_count
    want = jv.integrate_matrix_batch(frames[4:])
    got = tv.integrate_matrix_batch(frames[4:])
    assert len(want) > 0
    # the two packages' EventArray classes differ: compare field by field
    assert len(got) == len(want)
    for f in ("x", "y", "c", "d", "t"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    port = convert.state_to_numpy(tv.state)
    for f, a in zip(jv.state._fields[:-1], jv.state[:-1]):
        np.testing.assert_array_equal(np.asarray(a), port[f], err_msg=f)


def test_void_path_and_device_contract():
    frames = synth_frames(8, 6, 7, 1, seed=2)
    src = FramedArray(frames, chunk_frames=4, device="cpu")
    src.video.void_events = True
    assert len(src.consume_batch()) == 0
    assert src.video.state.running_t.device.type == "cpu"
    with pytest.raises(ValueError):
        Video(PlaneSize(4096, 2160, 2), Mode.FramePerfect, device="cpu")
    with pytest.raises(NotImplementedError):
        src.detect_features(True)
    if not torch.cuda.is_available():
        # the card is the default device, and nothing falls back to the CPU
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError):
                Video(PlaneSize(4, 4, 1), Mode.FramePerfect, **kw)
            with pytest.raises(RuntimeError):
                FramedArray(frames, chunk_frames=4, **kw)


def test_compressed_sink_and_roi_match_jax():
    """The shared compressed encoder behind the port's Video, and an ROI
    that lowers c_thresh inside a window: adder_tpu's bytes."""
    from adder_tpu.transcoder.video import Roi as JaxRoi
    from adder_tpu_torch.transcoder.video import Roi

    frames = synth_frames(12, 16, 24, 1)
    outs = []
    for cls, roi, kw in ((JaxFramedArray, JaxRoi, {}),
                         (FramedArray, Roi, {"device": "cpu"}),
                         (FramedArray, None, {"device": "cpu"})):
        src = cls(frames, 24.0, chunk_frames=4, **kw)
        _configure(src, "crf3")
        src.crf(6)  # c_thresh baseline 7; the ROI lowers it to 2
        if roi is not None:
            src.video.update_roi(roi(3, 2, 14, 9))
        buf = io.BytesIO()
        src.write_out(
            SourceCamera.FramedU8, src.video.time_mode,
            PixelMultiMode.Collapse, None, EncoderType.Compressed,
            EncoderOptions.default(src.video.plane), buf,
        )
        while True:
            try:
                src.consume_batch()
            except EOFError:
                break
        src.video.end_write_stream()
        outs.append(buf.getvalue())
    assert len(outs[0]) > 100
    assert outs[1] == outs[0]
    assert outs[2] != outs[0]  # the ROI changed the stream
