"""The port's pipelines against the JAX package's, on the CPU, at tolerance 0.

- `simulproc_from_args` on a small clip (written here with cv2, FFV1,
  lossless) writes the JAX pipeline's `.adder` bytes and raw frame bytes;
  `SimulProcessor` runs over a `FramedArray` source as well.
- `AdderPlayer` yields the JAX player's frames, in two view modes.
- `adder_to_dvs` writes the JAX transcoder's DVS events (binary and text).
- `LiveTranscoder` gives the JAX controller's per-chunk statistics.
"""

import io

import numpy as np
import pytest

from adder_tpu.codec.encoder import EncoderOptions as JEncoderOptions
from adder_tpu.codec.encoder import EncoderType as JEncoderType
from adder_tpu.core import types as JT
from adder_tpu.framer.scale_intensity import FramedViewMode as JView
from adder_tpu.models import adder_to_dvs as JA2D
from adder_tpu.models import live_transcoder as JLIVE
from adder_tpu.models import player as JPLAYER
from adder_tpu.models import simulproc as JSIM
from adder_tpu.transcoder.framed import FramedArray as JFramedArray
from adder_tpu_torch.codec.encoder import EncoderOptions, EncoderType
from adder_tpu_torch.core import types as T
from adder_tpu_torch.framer.scale_intensity import FramedViewMode
from adder_tpu_torch.models import adder_to_dvs as A2D
from adder_tpu_torch.models import live_transcoder as LIVE
from adder_tpu_torch.models import player as PLAYER
from adder_tpu_torch.models import simulproc as SIM
from adder_tpu_torch.transcoder.framed import FramedArray
from test_torch_file_sources import write_clip
from test_torch_video import synth_frames


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(tmp_path_factory.mktemp("clip") / "clip.avi", "FFV1",
                      n_frames=20, seed=3)


def simulproc_bytes(mod, clip, **kw):
    args = mod.SimulProcArgs(input_filename=str(clip), frame_count_max=16,
                             delta_t_max=255 * 4)
    events, raw = io.BytesIO(), io.BytesIO()
    proc = mod.simulproc_from_args(args, events, raw, **kw)
    n = proc.run()
    return events.getvalue(), raw.getvalue(), n


def test_simulproc_from_args_writes_jax_bytes(clip):
    """The adder_simulproc CLI's defaults (crf 3, AbsoluteT, Normal) on the
    clip: the same events and the same reconstructed frames."""
    want = simulproc_bytes(JSIM, clip)
    got = simulproc_bytes(SIM, clip, device="cpu")
    assert len(want[0]) > 1000 and want[2] >= 10
    assert len(want[1]) == want[2] * 48 * 32
    assert got == want


def framed_array_simulproc(types, enc_opts, enc_type, sim, source):
    source.auto_time_parameters(255, 255 * 4, types.TimeMode.AbsoluteT)
    source.crf(3)
    events, raw = io.BytesIO(), io.BytesIO()
    source.write_out(types.SourceCamera.FramedU8, types.TimeMode.AbsoluteT,
                     types.PixelMultiMode.Normal, None, enc_type.Raw,
                     enc_opts.default(source.video.plane), events)
    n = sim.SimulProcessor(source, 255, raw,
                           framer_fps=source.source_fps).run()
    return events.getvalue(), raw.getvalue(), n


def test_simulprocessor_over_framed_array():
    frames = synth_frames(24, 18, 26, 1, seed=11)
    want = framed_array_simulproc(JT, JEncoderOptions, JEncoderType, JSIM,
                                  JFramedArray(frames, 30.0, chunk_frames=8))
    got = framed_array_simulproc(
        T, EncoderOptions, EncoderType, SIM,
        FramedArray(frames, 30.0, chunk_frames=8, device="cpu"))
    assert want[2] >= 3 and len(want[1]) == want[2] * 18 * 26
    assert got == want


@pytest.fixture(scope="module")
def adder_file(tmp_path_factory):
    """A Raw .adder of a seeded colour scene, written by the port."""
    path = tmp_path_factory.mktemp("adder") / "scene.adder"
    frames = synth_frames(20, 14, 19, 3, seed=4)
    src = FramedArray(frames, 30.0, chunk_frames=5, device="cpu")
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
    return path


@pytest.mark.parametrize("view", ["Intensity", "D"])
def test_player_yields_jax_frames(adder_file, view):
    got_p = PLAYER.AdderPlayer(str(adder_file), FramedViewMode[view])
    want_p = JPLAYER.AdderPlayer(str(adder_file), JView[view])
    got = list(got_p.frames(batch_events=700))
    want = list(want_p.frames(batch_events=700))
    assert len(got) == len(want) >= 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got_p.stats.events_total == want_p.stats.events_total > 1000
    assert got_p.stats.frames_emitted == len(got)


def test_player_seek_to_beginning_replays(adder_file):
    p = PLAYER.AdderPlayer(str(adder_file))
    first = list(p.frames())
    p.seek_to_beginning()
    again = list(p.frames())
    assert len(first) == len(again) > 0
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def _strip_date(data: bytes) -> bytes:
    return b"".join(line for line in io.BytesIO(data)
                    if not line.startswith(b"% Date"))


@pytest.mark.parametrize("mode,reorder", [("binary", False),
                                          ("text", True)])
def test_adder_to_dvs_writes_jax_output(adder_file, mode, reorder):
    outs, stats = [], []
    for mod in (A2D, JA2D):
        buf = io.BytesIO()
        stats.append(mod.adder_to_dvs(str(adder_file), buf, mode, 0.05,
                                      reorder))
        outs.append(_strip_date(buf.getvalue()))
    assert outs[0] == outs[1]
    assert stats[0]["n_dvs_events"] == stats[1]["n_dvs_events"] > 100
    assert stats[0]["n_adder_events"] == stats[1]["n_adder_events"]
    np.testing.assert_array_equal(stats[0]["event_count_frame"],
                                  stats[1]["event_count_frame"])


def live_stats(mod, clip, **kw):
    core = mod.CoreParams(input_path=str(clip), delta_t_max_mult=4)
    adaptive = mod.AdaptiveParams(crf=3, quality_metrics=True)
    lt = mod.LiveTranscoder(core, adaptive, **kw)
    out = []
    while (r := lt.step()) is not None:
        events, s = r
        out.append((len(events), s.events_per_sec, s.events_ppc_per_sec,
                    s.bitrate_bps, s.psnr, s.mse))
    return out


def test_live_transcoder_stats_equal_jax(clip):
    want = live_stats(JLIVE, clip)
    got = live_stats(LIVE, clip, device="cpu")
    assert len(want) == 3 and want[0][0] > 0 and want[-1][4] is not None
    assert got == want
