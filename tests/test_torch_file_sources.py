"""The port's video-file sources write the JAX package's `.adder` bytes.

Each test decodes the same small clip, written here with cv2.VideoWriter
(FFV1 in .avi, lossless; mp4v in .mp4), through `adder_tpu`'s `Framed` /
`FramedStream` and the port's (on the CPU), and compares the Raw `.adder`
bytes: mono and colour, the ffmpeg and the cv2 decoder, scale 1.0 and 0.5,
a start frame and a frame cap. Tolerance: none.
"""

import io

import cv2
import numpy as np
import pytest

from adder_tpu.codec.encoder import EncoderOptions as JEncoderOptions
from adder_tpu.codec.encoder import EncoderType as JEncoderType
from adder_tpu.core import types as JT
from adder_tpu.transcoder import framed as JFRAMED
from adder_tpu_torch.codec.encoder import EncoderOptions, EncoderType
from adder_tpu_torch.core import types as T
from adder_tpu_torch.transcoder import ffdec
from adder_tpu_torch.transcoder import framed as FRAMED

H, W, N_FRAMES = 32, 48, 12


def write_clip(path, fourcc: str, n_frames: int = N_FRAMES, seed: int = 0):
    """A seeded colour clip of moving gradients with noise (BGR, 30 fps)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30.0,
                         (W, H), isColor=True)
    assert vw.isOpened()
    for t in range(n_frames):
        f = np.stack([(xx * 5 + yy * 3 + t * 11) % 256,
                      128 + 100 * np.cos(yy / 5 - t / 4),
                      128 + 100 * np.sin(xx / 7 + t / 3)], -1)
        f = f + rng.integers(-20, 21, f.shape)
        vw.write(np.clip(f, 0, 255).astype(np.uint8))
    vw.release()
    return path


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("clips")
    return {"avi": write_clip(d / "clip.avi", "FFV1"),
            "mp4": write_clip(d / "clip.mp4", "mp4v")}


def transcode(src, types, enc_opts, enc_type, cfg="crf3"):
    """Drive a framed source to EOF into a Raw .adder; returns its bytes."""
    if cfg == "bench":
        src.auto_time_parameters(255, 255 * 24, types.TimeMode.DeltaT)
        src.quality_manual(0, 0, 24, 1, 0)
    else:
        src.auto_time_parameters(255, 255 * 4, types.TimeMode.AbsoluteT)
        src.crf(3)
    buf = io.BytesIO()
    video = src.get_video_ref()
    src.write_out(types.SourceCamera.FramedU8, video.time_mode,
                  types.PixelMultiMode.Collapse, None, enc_type.Raw,
                  enc_opts.default(video.plane), buf)
    while True:
        try:
            src.consume_batch()
        except EOFError:
            break
    video.end_write_stream()
    return buf.getvalue()


def both(cls_name, path, color, start=0, cfg="crf3", **kw):
    """(JAX bytes, port bytes, the port source) of one clip."""
    jsrc = getattr(JFRAMED, cls_name)(str(path), color, chunk_frames=4, **kw)
    src = getattr(FRAMED, cls_name)(str(path), color, chunk_frames=4,
                                    device="cpu", **kw)
    assert src.decoder == jsrc.decoder
    if start:
        jsrc.frame_start(start)
        src.frame_start(start)
    want = transcode(jsrc, JT, JEncoderOptions, JEncoderType, cfg)
    got = transcode(src, T, EncoderOptions, EncoderType, cfg)
    assert len(want) > 1000
    return want, got, src


@pytest.mark.parametrize("cls_name", ["Framed", "FramedStream"])
@pytest.mark.parametrize("decoder", ["ffmpeg", "cv2"])
@pytest.mark.parametrize("color", [False, True], ids=["mono", "color"])
def test_file_source_writes_jax_bytes(clips, cls_name, decoder, color):
    want, got, src = both(cls_name, clips["avi"], color, decoder=decoder)
    assert got == want
    assert src.decoder == decoder
    assert src.get_video_ref().plane.channels == (3 if color else 1)


@pytest.mark.parametrize("cls_name", ["Framed", "FramedStream"])
@pytest.mark.parametrize("decoder", ["ffmpeg", "cv2"])
def test_file_source_scaled_mp4(clips, cls_name, decoder):
    """scale 0.5 (swscale's AREA stage, or cv2.resize INTER_AREA) on the
    lossy mp4v clip, the bench configuration (DeltaT)."""
    want, got, src = both(cls_name, clips["mp4"], False, cfg="bench",
                          decoder=decoder, scale=0.5)
    assert got == want
    assert (src.video.plane.width, src.video.plane.height) == (W // 2, H // 2)


@pytest.mark.parametrize("decoder", ["ffmpeg", "cv2"])
def test_framed_start_and_max_frames(clips, decoder):
    want, got, src = both("Framed", clips["avi"], True, start=3,
                          decoder=decoder, max_frames=10)
    assert got == want
    assert len(src.frames) == 10 and src.frame_idx == 10
    want, got, src = both("FramedStream", clips["avi"], False,
                          decoder=decoder, max_frames=7)
    assert got == want and src.frame_idx == 7


def test_auto_decoder_is_ffmpeg_when_it_builds(clips):
    assert ffdec.available()
    src = FRAMED.Framed(str(clips["avi"]), False, device="cpu")
    assert src.decoder == "ffmpeg"
    np.testing.assert_array_equal(
        src.frames, JFRAMED.Framed(str(clips["avi"]), False).frames)


def test_decoder_without_ffmpeg(clips, monkeypatch):
    """An ffmpeg library that cannot build: "auto" takes cv2 (and says
    so), an explicit "ffmpeg" raises."""
    monkeypatch.setattr(ffdec, "_lib", None)
    monkeypatch.setattr(ffdec, "_build_error", "g++: no libav")
    src = FRAMED.Framed(str(clips["avi"]), False, device="cpu")
    assert src.decoder == "cv2"
    with pytest.raises(RuntimeError, match="no libav"):
        FRAMED.Framed(str(clips["avi"]), False, decoder="ffmpeg",
                      device="cpu")
    with pytest.raises(RuntimeError, match="no libav"):
        FRAMED.FramedStream(str(clips["avi"]), False, decoder="ffmpeg",
                            device="cpu")
    with pytest.raises(ValueError):
        FRAMED.Framed(str(clips["avi"]), False, decoder="gst", device="cpu")


@pytest.mark.parametrize("decoder", ["ffmpeg", "cv2"])
def test_stream_producer_error_reaches_caller(clips, monkeypatch, decoder):
    """A decode error on FramedStream's producer thread is raised by
    consume_batch, after the chunks decoded before it, and not turned into
    an early EOF."""
    name = ("handle_color_rgb_videors" if decoder == "ffmpeg"
            else "handle_color_videors")
    orig = getattr(FRAMED, name)
    calls = []

    def failing(frame, color):
        calls.append(1)
        if len(calls) == 6:
            raise IOError("corrupt frame 6")
        return orig(frame, color)

    monkeypatch.setattr(FRAMED, name, failing)
    src = FRAMED.FramedStream(str(clips["avi"]), False, chunk_frames=4,
                              decoder=decoder, device="cpu")
    src.auto_time_parameters(255, 255 * 4, T.TimeMode.AbsoluteT)
    src.consume_batch()  # frames 0-3
    with pytest.raises(IOError, match="corrupt frame 6"):
        src.consume_batch()


def test_file_sources_default_to_the_card(clips, monkeypatch):
    """Without CUDA, the default device raises before a frame decodes."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (FRAMED.Framed, FRAMED.FramedStream):
        with pytest.raises(RuntimeError, match="cuda"):
            cls(str(clips["avi"]), False)
