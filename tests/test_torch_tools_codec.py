"""The codec-only and reconstruction tools of the port against the JAX
package's, in-process on the CPU, at tolerance 0, on `.adder` files this
file writes (a seeded colour scene through the port's FramedArray,
AbsoluteT; a v1 DeltaT stream through the encoder) and a seeded aedat4
file:

- `adder_info`, `adder_to_dvs`, `adder_recompress` (addrn and back to raw,
  the events the input's but for the end flush's D_EMPTY fillers, which
  the ADU framing of both packages drops; addec; a DeltaT input refused), `migrate_raw_v0_v1_to_v2`,
  `aedat4_dvs_visualize`, `adder_to_framed`: the same output bytes (the
  DVS header's date line aside) and printed lines;
- `adder_video_player`, `decode_benchmark` (host framer and, on CPU
  tensors, the device framer) and the example
  `events_to_instantaneous_frames`: the same frames, and the same lines
  but for their measured times.
"""

import numpy as np
import pytest

from adder_tpu_torch import testing
from adder_tpu_torch.codec.decoder import open_file_decoder
from adder_tpu_torch.codec.encoder import Encoder, EncoderOptions, EncoderType
from adder_tpu_torch.codec.header import CodecMetadata
from adder_tpu_torch.core import types as T
from adder_tpu_torch.transcoder.framed import FramedArray
from test_torch_video import synth_frames
from torch_tools_common import both, same_files, without_times


@pytest.fixture(scope="module")
def adder_file(tmp_path_factory):
    """A Raw .adder (AbsoluteT, Collapse, crf 2) of a seeded 19 x 14
    colour scene of 20 frames, written by the port on the CPU."""
    path = tmp_path_factory.mktemp("adder") / "scene.adder"
    src = FramedArray(synth_frames(20, 14, 19, 3, seed=4), 30.0,
                      chunk_frames=5, device="cpu")
    src.auto_time_parameters(255, 255 * 6, T.TimeMode.AbsoluteT)
    src.crf(2)
    with open(path, "wb") as f:
        src.write_out(T.SourceCamera.FramedU8, T.TimeMode.AbsoluteT,
                      T.PixelMultiMode.Collapse, None, EncoderType.Raw,
                      EncoderOptions.default(src.video.plane), f)
        while True:
            try:
                src.consume_batch()
            except EOFError:
                break
        src.video.end_write_stream()
    return str(path)


@pytest.fixture(scope="module")
def v1_file(tmp_path_factory):
    """A v1 DeltaT Raw stream of 3000 seeded events on a 23 x 17 plane."""
    path = tmp_path_factory.mktemp("v1") / "v1.adder"
    plane = T.PlaneSize(23, 17, 1)
    meta = CodecMetadata(codec_version=1, plane=plane, tps=255 * 30,
                         ref_interval=255, delta_t_max=255 * 10,
                         time_mode=T.TimeMode.DeltaT,
                         source_camera=T.SourceCamera.FramedU8)
    rng = np.random.default_rng(7)
    n = 3000
    enc = Encoder.new_raw(meta, open(path, "wb"),
                          EncoderOptions.default(plane))
    enc.ingest_event_array(T.EventArray(
        rng.integers(0, 23, n).astype(np.uint16),
        rng.integers(0, 17, n).astype(np.uint16),
        np.full(n, T.NO_CHANNEL, np.uint8),
        rng.integers(0, 20, n).astype(np.uint8),
        rng.integers(1, 255 * 10, n).astype(np.uint32)))
    enc.close_writer().close()
    return str(path)


@pytest.mark.parametrize("which,flags", [("adder", ["-d"]), ("v1", []),
                                         ("v1", ["-d"])])
def test_adder_info_prints_jax_report(adder_file, v1_file, tmp_path,
                                      monkeypatch, capsys, which, flags):
    src = adder_file if which == "adder" else v1_file
    (jrc, jout, _), (rc, out, _) = both(
        "adder_info", ["-i", src, *flags], tmp_path, monkeypatch, capsys,
        device=None)
    assert rc == jrc == 0 and out == jout
    assert "ADDER event count:" in out


@pytest.mark.parametrize("flags", [["--output-mode", "binary"],
                                   ["--output-mode", "text", "--reorder",
                                    "--theta", "0.05"]])
def test_adder_to_dvs_writes_jax_events(adder_file, tmp_path, monkeypatch,
                                        capsys, flags):
    (jrc, jout, jdir), (rc, out, pdir) = both(
        "adder_to_dvs", ["-i", adder_file, "--output-events", "out.dvs",
                         *flags], tmp_path, monkeypatch, capsys, device=None)
    assert rc == jrc == 0 and out == jout

    def body(d):
        return [line for line in (d / "out.dvs").read_bytes()
                .split(b"\n") if not line.startswith(b"% Date")]

    assert body(pdir) == body(jdir) and len(body(pdir)) > 5


def test_adder_recompress_round_trip_writes_jax_bytes(adder_file, v1_file,
                                                      tmp_path, monkeypatch,
                                                      capsys):
    """raw -> addrn -> raw and raw -> addec: each step the JAX tool's
    bytes and line; the events come back equal to the input's. A DeltaT
    input is refused (exit 1) for a compressed output."""
    for argv, name in ((["-i", adder_file, "-o", "mid.addrn"], "mid.addrn"),
                       (["-i", "mid.addrn", "-o", "back.adder", "--codec",
                         "raw"], "back.adder"),
                       (["-i", adder_file, "-o", "c.addec", "--codec",
                         "cabac"], "c.addec")):
        if argv[1] == "mid.addrn":
            argv = ["-i", str(tmp_path / "port" / "mid.addrn"), *argv[2:]]
        (jrc, jout, jdir), (rc, out, pdir) = both(
            "adder_recompress", argv, tmp_path, monkeypatch, capsys,
            device=None)
        assert rc == jrc == 0 and out == jout
        same_files(jdir, pdir, [name])
    a = _event_multiset(open_file_decoder(adder_file).digest_all())
    b = _event_multiset(open_file_decoder(
        str(tmp_path / "port" / "back.adder")).digest_all())
    # what the ADU framing does not carry back (in both packages): the
    # D_EMPTY fillers of the stream's end flush, past its last ADU
    lost = a - b
    assert sum(a.values()) > 1000 and not (b - a)
    assert all(k[3] == T.D_EMPTY for k in lost) and sum(lost.values()) < 5
    (jrc, _, _), (rc, _, pdir) = both(
        "adder_recompress", ["-i", v1_file, "-o", "x.addec", "--codec",
                             "cabac"], tmp_path, monkeypatch, capsys,
        device=None)
    assert rc == jrc == 1 and not (pdir / "x.addec").exists()


def _event_multiset(ev):
    import collections

    return collections.Counter(zip(*(getattr(ev, f).tolist()
                                     for f in ("x", "y", "c", "d", "t"))))


def test_migrate_v1_to_v2_writes_jax_bytes(v1_file, tmp_path, monkeypatch,
                                           capsys):
    (jrc, jout, jdir), (rc, out, pdir) = both(
        "migrate_raw_v0_v1_to_v2", ["-i", v1_file, "-o", "v3.adder"],
        tmp_path, monkeypatch, capsys, device=None)
    assert rc == jrc == 0 and out == jout
    same_files(jdir, pdir, ["v3.adder"])
    m = open_file_decoder(str(pdir / "v3.adder")).meta
    assert m.codec_version == 3 and m.time_mode == T.TimeMode.AbsoluteT


def test_aedat4_dvs_visualize_writes_jax_frames(tmp_path, monkeypatch,
                                               capsys):
    events, frames = testing.davis_stream(
        6, 30, 20, 50_000, n_frames=2, exposure_us=5_000, n_hot=3,
        hot_events=40, edge_events=600, background_events=300)
    src = tmp_path / "in.aedat4"
    testing.write_davis_aedat4(str(src), 30, 20, events, frames)
    (jrc, jout, jdir), (rc, out, pdir) = both(
        "aedat4_dvs_visualize", ["-i", src, "--output-video", "dvs.raw",
                                 "--fps", "400"],
        tmp_path, monkeypatch, capsys, device=None)
    assert rc == jrc == 0 and out == jout
    assert out.startswith(f"DVS event count: {len(events[0])}")
    same_files(jdir, pdir, ["dvs.gray8"])


def test_adder_to_framed_writes_jax_frames(adder_file, tmp_path,
                                           monkeypatch, capsys):
    (jrc, jout, jdir), (rc, out, pdir) = both(
        "adder_to_framed", ["-i", adder_file, "-o", "frames.bgr"],
        tmp_path, monkeypatch, capsys, device=None)
    assert rc == jrc == 0 and out == jout
    assert out.startswith("wrote ") and "19x14x3" in out
    same_files(jdir, pdir, ["frames.bgr"])


def test_stream_tools_report_a_bad_stream(tmp_path, monkeypatch, capsys):
    bad = tmp_path / "bad.adder"
    bad.write_bytes(b"not an adder stream at all")
    import importlib

    monkeypatch.chdir(tmp_path)
    for name, argv in (("adder_info", ["-i", bad]),
                       ("adder_to_framed", ["-i", bad, "-o", "x"]),
                       ("decode_benchmark", ["-i", tmp_path / "none"])):
        mod = importlib.import_module(f"adder_tpu_torch.tools.{name}")
        capsys.readouterr()
        assert mod.main([str(a) for a in argv]) == 1
        assert capsys.readouterr().err.startswith("error: ")


@pytest.mark.parametrize("view", ["intensity", "d"])
def test_adder_video_player_plays_jax_frames(adder_file, tmp_path,
                                             monkeypatch, capsys, view):
    """The player's frames, taken where the tool hands them to the mp4
    writer, and its line but for the measured rate."""
    import adder_tpu.utils.viz as JVIZ
    from adder_tpu_torch.tools import adder_video_player as PLAYER

    written = {}

    def capture(key):
        def write(stack, path, fps):
            written[key] = (stack, fps)
            return True
        return write

    monkeypatch.setattr(JVIZ, "write_frames_to_video", capture("jax"))
    monkeypatch.setattr(PLAYER, "write_frames_to_video", capture("port"))
    (jrc, jout, _), (rc, out, _) = both(
        "adder_video_player", ["-i", adder_file, "-o", "out.mp4",
                               "--view-mode", view, "--max-frames", "6"],
        tmp_path, monkeypatch, capsys, device=None)
    assert rc == jrc == 0 and without_times(out) == without_times(jout)
    assert out.startswith("played ")
    got, want = written["port"], written["jax"]
    assert got[0].shape == want[0].shape and len(got[0]) == 6
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def _jax_host_frames(path, fps):
    """The JAX host framer's frames of `path` at `fps`, popped as the JAX
    decode_benchmark pops them."""
    from adder_tpu.codec.decoder import open_file_decoder as jopen
    from adder_tpu.framer.driver import FramerBuilder

    dec = jopen(path)
    m = dec.meta
    fr = (FramerBuilder(m.plane)
          .time_parameters(m.tps, m.ref_interval, m.delta_t_max, fps)
          .codec_meta(m.codec_version, m.time_mode)
          .source_info(dec.get_source_type(), m.source_camera).finish())
    fr.ingest_event_array(dec.digest_all())
    out = []
    while fr.is_frame_0_filled():
        out.append(fr.pop_next_frame()[0])
    if fr.flush_frame_buffer():
        while fr.is_frame_0_filled():
            out.append(fr.pop_next_frame()[0])
    return out


@pytest.mark.parametrize("flags", [[], ["--frame"], ["--frame", "--device"]],
                         ids=["digest", "host", "device"])
def test_decode_benchmark_frames_equal_jax(adder_file, tmp_path,
                                           monkeypatch, capsys, flags):
    """The lines but for their times, and the frames (the host framer's,
    or the device framer's on CPU tensors) equal to the JAX host framer's.
    With --device the JAX tool raises OverflowError on this stream: some
    pixels stay silent longer than delta_t_max (1530 ticks, 6 frames), and
    its device framer bounds a span by that. The port's pops the host
    framer's frames, and prints the JAX tool's --frame lines under its
    own label."""
    from adder_tpu_torch.tools import decode_benchmark as DB

    argv = ["-i", adder_file, "--fps", "30", *flags]
    if "--device" in flags:
        with pytest.raises(OverflowError):
            both("decode_benchmark", argv, tmp_path, monkeypatch, capsys)
        argv_jax = argv[:-1]
    else:
        argv_jax = argv
    (jrc, jout, _), _ = both("decode_benchmark", argv_jax, tmp_path,
                             monkeypatch, capsys)
    frames = DB.benchmark(DB.parse_args([*argv, "--torch-device", "cpu"]))
    out = capsys.readouterr().out
    assert jrc == 0
    assert without_times(out) == without_times(
        jout.replace("host-framed", "device-framed") if "--device" in flags
        else jout)
    if not flags:
        assert frames == []
        return
    want = _jax_host_frames(adder_file, 30.0)
    assert len(frames) == len(want) > 5
    for g, w in zip(frames, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_events_to_instantaneous_frames_example(adder_file, tmp_path,
                                                monkeypatch, capsys):
    """The example's line, and its frames against the JAX framer's, batch
    by batch as the JAX example drives it."""
    from adder_tpu.codec.decoder import open_file_decoder as jopen
    from adder_tpu.framer.driver import FramerBuilder
    from adder_tpu_torch.examples import events_to_instantaneous_frames as EX

    (jrc, jout, _), (rc, out, _) = both(
        "events_to_instantaneous_frames", [adder_file], tmp_path,
        monkeypatch, capsys, device=None, script_dir="examples",
        package="examples")
    assert rc == jrc == 0 and out == jout
    got = list(EX.reconstruct(adder_file))
    dec = jopen(adder_file)
    m = dec.meta
    fs = (FramerBuilder(m.plane)
          .time_parameters(m.tps, m.ref_interval, m.delta_t_max,
                           m.tps / m.ref_interval)
          .codec_meta(m.codec_version, m.time_mode)
          .source_info(dec.get_source_type(), m.source_camera).finish())
    want = []
    while len(batch := dec.digest_batch(1 << 16)):
        if fs.ingest_event_array(batch):
            while fs.is_frame_0_filled():
                want.append(fs.pop_next_frame()[0])
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
