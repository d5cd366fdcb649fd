"""The port's stage tracer (`adder_tpu_torch/utils/tracing.py`) against
adder_tpu's, on the CPU.

- The copy keeps the original's registry and report: the same calls,
  items and summary table under a shared fake clock.
- Disabled, a stage records nothing.
- Enabled, a stage is also a torch.profiler range of its name, and its
  registry entry is the original's; disabled, it opens none.
- A traced run of each port source records the JAX package's stage names
  at the matching points (the gate `_ENABLED` is read at import, so the
  tests switch it on the module).
- `Video`'s own stages: the frame upload and the event unpack, beside the
  submit and the encode on the profiler's timeline; one rerun span for
  each relaunch of a chunk, with the same bytes as an untraced run.
- `device_trace` on the CPU: a Chrome trace with the stages' names.
"""

import io
import json
import time

import cv2
import numpy as np
import pytest
import torch

from adder_tpu.utils import tracing as JTR
import adder_tpu_torch as at
from adder_tpu_torch import testing
from adder_tpu_torch.transcoder import video as TV
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


def _ranges(prof):
    """The profiler's host ranges: name -> [(start, end)] in microseconds."""
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return _ranges(prof)


@pytest.mark.parametrize("on", [True, False], ids=["enabled", "disabled"])
def test_a_stage_is_a_profiler_range_of_its_name_only_while_enabled(
        monkeypatch, on):
    """Under torch.profiler an enabled stage leaves one range of its name
    a call (closed on an exception too), and the registry reads as the
    original's under a shared fake clock; a disabled one leaves none."""
    reports = []
    for mod in (JTR, TR):
        monkeypatch.setattr(mod, "_ENABLED", on)
        mod.reset()

        def drive(mod=mod):
            clock = iter(np.arange(0.0, 100.0, 0.25))
            with monkeypatch.context() as m:
                m.setattr(time, "perf_counter", lambda: float(next(clock)))
                _drive(mod)

        ranges = _profiled(drive)  # the port's, after the loop
        reports.append({k: vars(v) for k, v in mod.report().items()})
        mod.reset()
    assert reports[0] == reports[1]
    counts = {k: len(ranges.get(k, [])) for k in
              ("video.submit_chunk", "video.encode", "raises", "only.items")}
    if on:
        assert counts == {"video.submit_chunk": 1, "video.encode": 3,
                          "raises": 1, "only.items": 0}
        assert reports[1]["video.encode"]["calls"] == 3
    else:
        assert counts == dict.fromkeys(counts, 0)
        assert reports[1] == {}


def _overlaps(xs, ys):
    return [(x, y) for x in xs for y in ys if x[0] < y[1] and y[0] < x[1]]


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


def test_video_traces_its_upload_and_unpack_beside_the_other_stages(traced):
    """A Raw-sink run: `video.upload` counts T x n bytes a chunk,
    `video.unpack` every event, and on the profiler's timeline neither
    overlaps `video.submit_chunk` or `video.encode`."""
    frames = testing.moving_shapes(2, 8, 24, 32, 1)
    v = at.Video(at.PlaneSize(32, 24, 1), at.Mode.FramePerfect,
                 device="cpu")
    v.time_parameters(255 * 24, 255, 255 * 30, at.TimeMode.AbsoluteT)
    _raw_sink(v, v.plane, io.BytesIO(), time_mode=at.TimeMode.AbsoluteT)
    events = []

    def run():
        for i in range(0, 8, 4):
            events.append(len(v.integrate_matrix_batch(frames[i:i + 4])))
        v.end_write_stream()

    ranges = _profiled(run)
    r = TR.report()
    assert (r["video.upload"].calls, r["video.upload"].items) == (
        2, 2 * 4 * 24 * 32)
    assert sum(events) > 0
    assert r["video.unpack"].calls == 2
    assert r["video.unpack"].items == r["video.encode"].items == sum(events)
    assert "video.rerun" not in r
    assert len(ranges["video.upload"]) == len(ranges["video.unpack"]) == 2
    for own in ("video.upload", "video.unpack"):
        for other in ("video.submit_chunk", "video.encode"):
            assert ranges[other]
            assert not _overlaps(ranges[own], ranges[other]), (own, other)


def _rerun_video(plane, T, content, writer):
    v = at.Video(plane, at.Mode.Continuous if content == "capacity"
                 else at.Mode.FramePerfect, chunk_frames=T, device="cpu")
    dtm = 1 if content == "capacity" else 1000
    v.time_parameters(255 * 30, 255, 255 * dtm, at.TimeMode.AbsoluteT)
    v.write_out(at.SourceCamera.FramedU8, at.TimeMode.AbsoluteT,
                at.PixelMultiMode.Normal if content == "capacity"
                else at.PixelMultiMode.Collapse, None,
                at.EncoderType.Empty if content == "void-depth"
                else at.EncoderType.Raw, at.EncoderOptions.default(plane),
                writer)
    v.update_quality_manual(0 if content == "capacity" else 10, 0, dtm, 1, 0)
    v.void_events = content == "void-depth"
    return v


ENGINE_ENV = {"resident": {}, "fused": {"ADDER_TPU_RESIDENT": "0"},
              "slots": {"ADDER_TPU_FUSED": "0"}}


@pytest.mark.parametrize("engine,content", [
    ("resident", "capacity"), ("fused", "capacity"), ("slots", "capacity"),
    ("resident", "depth"), ("fused", "depth"), ("resident", "void-depth")])
def test_each_relaunch_of_a_chunk_is_one_rerun_span(monkeypatch, engine,
                                                    content):
    """With the full-capacity shortcut off, content that swings every pixel
    past its threshold overflows a chunk's capacity (and, on the
    one-interval engines from 2 packed lanes, the pack); dim near-constant
    content (beside two swinging columns) outgrows the depth-6 arena, so
    the two chunks in flight are
    rerun too (on the Empty sink, the resident engine's void pass).
    `video.rerun`'s calls equal the chunks launched again, and the bytes
    (the state, on the Empty sink) equal an untraced run's."""
    for var in ("ADDER_TPU_RESIDENT", "ADDER_TPU_FUSED"):
        monkeypatch.delenv(var, raising=False)
    for var, val in ENGINE_ENV[engine].items():
        monkeypatch.setenv(var, val)
    monkeypatch.setattr(TV, "FULL_CAP_VOLUME", 0)
    if content == "capacity":
        rng = np.random.default_rng(5)
        frames = rng.integers(0, 256, (16, 10, 12, 1)).astype(np.uint8)
        frames[1::2] = 255 - frames[1::2]
        T = 4
    else:
        frames = np.random.default_rng(1).integers(
            1, 4, (72, 6, 8, 1)).astype(np.uint8)
        # two columns that swing every frame, so the Raw sink has events
        frames[:, :, :2] = np.where(np.arange(72)[:, None, None, None] % 2,
                                    250, 5)
        T = 8
    plane = at.PlaneSize(frames.shape[2], frames.shape[1], 1)
    outs = []
    for on in (True, False):
        monkeypatch.setattr(TR, "_ENABLED", on)
        TR.reset()
        buf = io.BytesIO()
        v = _rerun_video(plane, T, content, buf)
        assert v.engine == engine
        if content == "capacity" and engine != "resident":
            v._pack = 2
        launches = []
        run_chunk = v._run_chunk

        def counted(state, pending, run_chunk=run_chunk, launches=launches):
            launches.append(pending["T"])
            return run_chunk(state, pending)

        v._run_chunk = counted
        for i in range(0, len(frames), T):
            v.submit_chunk(frames[i:i + T])
        v.end_write_stream()
        relaunches = len(launches) - len(frames) // T
        result = (buf.getvalue() if content != "void-depth" else
                  b"".join(f.numpy().tobytes() for f in v.state))
        outs.append((result, relaunches, TR.report()))
        TR.reset()
    (got, reruns, report), (want, reruns_off, report_off) = outs
    assert reruns == 3 if "depth" in content else reruns > 0
    assert report["video.rerun"].calls == reruns == reruns_off
    assert report_off == {}
    assert len(got) > 100 and got == want


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
            "sharded.unpack", "sharded.encode"} <= _names()
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


def test_device_trace_on_the_cpu_labels_the_stages(traced, tmp_path):
    with TR.device_trace(None):
        pass
    with TR.device_trace(str(tmp_path / "trace")):
        with TR.stage("video.upload", items=8):
            torch.ones(8).sum()
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "video.upload" in names
