"""The port's stage tracer (`adder_tpu_torch/utils/tracing.py`) against
adder_tpu's, on the CPU.

- The copy keeps the original's registry and report: the same calls,
  items and summary table under a shared fake clock.
- Disabled, a stage records nothing.
- A traced run of each port source records the JAX package's stage names
  at the matching points (the gate `_ENABLED` is read at import, so the
  tests switch it on the module).
- `hard_sync` and `device_trace` on the CPU.
"""

import io
import time

import cv2
import numpy as np
import pytest
import torch

from adder_tpu.utils import tracing as JTR
import adder_tpu_torch as at
from adder_tpu_torch import testing
from adder_tpu_torch.utils import tracing as TR
from adder_tpu_torch.utils.viz import ShowFeatureMode


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setattr(TR, "_ENABLED", True)
    TR.reset()
    yield TR
    TR.reset()


def _drive(mod):
    with mod.stage("video.submit_chunk", items=100):
        pass
    for _ in range(3):
        with mod.stage("video.encode", items=7):
            pass
    mod.add_items("video.encode", 5)
    mod.add_items("only.items", 9)
    with pytest.raises(KeyError):
        with mod.stage("raises"):
            raise KeyError("x")


def test_report_and_table_equal_the_original(monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    tables = []
    for mod in (JTR, TR):
        monkeypatch.setattr(mod, "_ENABLED", True)
        mod.reset()
        _drive(mod)
        tables.append((mod.summary_table(),
                       {k: vars(v) for k, v in mod.report().items()}))
        mod.reset()
    assert tables[0] == tables[1]
    report = tables[1][1]
    assert report["video.encode"]["calls"] == 3
    assert report["video.encode"]["items"] == 26
    assert report["raises"]["calls"] == 1
    assert tables[1][0].splitlines()[0] == (
        "stage                          calls   total_ms   mean_ms     rate")


def test_disabled_stages_do_nothing(monkeypatch):
    monkeypatch.setattr(TR, "_ENABLED", False)
    TR.reset()
    assert not TR.enabled()
    _drive(TR)
    assert TR.report() == {}
    TR.set_enabled(True)
    assert TR.enabled()
    TR.set_enabled(False)


def _names():
    return set(TR.report())


def _raw_sink(src_or_video, plane, buf, source=None, time_mode=None):
    src_or_video.write_out(
        source or at.SourceCamera.FramedU8,
        time_mode or at.TimeMode.DeltaT, at.PixelMultiMode.Collapse, None,
        at.EncoderType.Raw, at.EncoderOptions.default(plane), buf)


def test_video_records_the_jax_stage_names(traced):
    frames = testing.moving_shapes(2, 8, 24, 32, 1)
    v = at.Video(at.PlaneSize(32, 24, 1), at.Mode.FramePerfect,
                 device="cpu")
    v.time_parameters(255 * 24, 255, 255 * 30, at.TimeMode.AbsoluteT)
    _raw_sink(v, v.plane, io.BytesIO(), time_mode=at.TimeMode.AbsoluteT)
    v.update_detect_features(True, ShowFeatureMode.Instant)
    for i in range(0, 8, 4):
        v.integrate_matrix_batch(frames[i:i + 4])
    v.end_write_stream()
    want = {"video.submit_chunk", "video.collect.control_fetch",
            "video.collect.event_fetch", "video.encode",
            "video.features.mask_lookup"}
    assert want <= _names()
    assert "video.collect.assemble" not in _names()  # no host assembler
    assert TR.report()["video.submit_chunk"].items == 8 * 24 * 32


def test_sharded_video_records_the_jax_stage_names(traced):
    frames = testing.moving_shapes(2, 8, 24, 32, 1)
    v = at.ShardedVideo(at.PlaneSize(32, 24, 1), at.Mode.FramePerfect,
                        mesh=["cpu"] * 2)
    v.time_parameters(255 * 30, 255, 255 * 24, at.TimeMode.DeltaT)
    _raw_sink(v, v.plane, io.BytesIO())
    for i in range(0, 8, 4):
        v.submit_chunk(frames[i:i + 4])
    v.end_write_stream()
    assert {"sharded.submit_chunk", "sharded.collect.control_fetch",
            "sharded.collect.event_fetch", "sharded.collect.assemble",
            "sharded.encode"} <= _names()
    assert TR.report()["sharded.collect.control_fetch"].calls == 2


def test_prophesee_records_the_jax_stage_names(traced, tmp_path):
    W, H = 32, 24
    path = tmp_path / "s.raw"
    testing.write_prophesee_raw(path, W, H, *testing.dvs_stream(
        4, W, H, 100_000, n_hot=3, hot_events=40, background_events=400))
    src = at.Prophesee(20, str(path), view_fps=30, device="cpu")
    src.crf(3)
    _raw_sink(src, at.PlaneSize(W, H, 1), io.BytesIO(),
              source=at.SourceCamera.Dvs, time_mode=at.TimeMode.AbsoluteT)
    while True:
        try:
            src.consume()
        except EOFError:
            break
    src.end_write_stream()
    assert {"dvs.plan", "dvs.pack", "dvs.upload", "dvs.dispatch",
            "dvs.event_fetch", "dvs.encode"} <= _names()


def test_framed_stream_and_device_framer_record_the_jax_stage_names(
        traced, tmp_path):
    path = str(tmp_path / "clip.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 30.0,
                         (32, 24), isColor=True)
    for f in testing.moving_shapes(5, 16, 24, 32, 3):
        vw.write(f)
    vw.release()
    src = at.FramedStream(path, False, decoder="cv2", chunk_frames=4,
                          device="cpu")
    # delta_t_max 4 intervals: every pixel fires often enough to fill frames
    src.auto_time_parameters(255, 255 * 4, at.TimeMode.AbsoluteT)
    src.crf(3)
    out = tmp_path / "clip.adder"
    with open(out, "wb") as f:
        src.write_out(at.SourceCamera.FramedU8, at.TimeMode.AbsoluteT,
                      at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                      at.EncoderOptions.default(src.video.plane), f)
        while True:
            try:
                src.consume_batch()
            except EOFError:
                break
        src.video.end_write_stream()
    assert "framed.decode_wait" in _names()

    dec = at.open_file_decoder(str(out))
    b = (at.FramerBuilder(dec.meta.plane)
         # the span bound past the stream's longest gap: its D_EMPTY
         # fillers run past delta_t_max
         .time_parameters(dec.meta.tps, dec.meta.ref_interval, 255 * 16,
                          30.0)
         .codec_meta(dec.meta.codec_version, dec.meta.time_mode)
         .source_info(dec.get_source_type(), dec.meta.source_camera))
    df = at.DeviceFramer(b, device="cpu")
    df.ingest_event_array(dec.digest_all())
    assert df.drain()
    assert {"device_framer.pack", "device_framer.dispatch",
            "device_framer.sync_fetch", "device_framer.pop_d2h",
            "device_framer.recycle", "device_framer.convert"} <= _names()


def test_hard_sync_and_device_trace_on_the_cpu(tmp_path):
    x = torch.ones(3)
    TR.hard_sync(x)
    TR.hard_sync({"a": [x, (x,)]})
    TR.hard_sync([])
    with TR.device_trace(None):
        pass
    with TR.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert list((tmp_path / "trace").glob("trace_*.json"))
