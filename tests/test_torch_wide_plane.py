"""The wide event layout of the framed chunk, on the CPU.

Planes of 2^24 pixel-channels and more (3840 x 2160 x 3 is 24,883,200)
cannot index a pixel in the 24 bits of `pix << 8 | d`; the resident engine
takes them in its wide layout (an int64 pixel-and-d word). No such plane is
built here: the layout is forced on small planes, and the fields past 24
bits are held on synthetic events.
- The forced wide layout gives the narrow layout's state, events and bytes
  with the Raw (packed), Empty and Compressed sinks, and each of its chunks
  adds its events to the counter `video.wide_events`.
- The benchmark's 4K cell, run by its own driver and `reference_wide` on a
  tiny plane with the layout forced, comes out correct.
- The plain record pack, the host route's unpack and `reference_wide`'s
  bytes hold events at indices past 2^24 to a numpy ground truth.
- The plain segment copy restores the pixel from the segment.
- `reference_wide` equals `reference` below 2^24.
- The engines and sources that keep the 24-bit field refuse such planes.
- The capacity arithmetic at 2,189,721,600 slots.
"""

import ast
import io
import json
import time
import types

import numpy as np
import pytest
import torch

import adder_tpu_torch as at
from adder_tpu_torch import testing
from adder_tpu_torch.codec import raw as rawcodec
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.ops import integrate as ops
from adder_tpu_torch.transcoder import video as V
from adder_tpu_torch.utils import tracing as TR
from portbench import harness, reference, reference_wide

W, H, T = 33, 17, 4
# the last pixel-channel of 3840 x 2160 x 3
LAST_4K = 3840 * 2160 * 3 - 1


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setattr(TR, "_ENABLED", True)
    TR.reset()
    yield TR
    TR.reset()


def _video(C, writer, encoder, wide):
    plane = at.PlaneSize(W, H, C)
    v = at.Video(plane, at.Mode.FramePerfect, chunk_frames=T, device="cpu")
    assert v._wide is False  # a small plane picks the narrow layout
    v._wide = wide
    v.time_parameters(255 * 24, 255, 255 * 30, at.TimeMode.AbsoluteT)
    v.write_out(at.SourceCamera.FramedU8, at.TimeMode.AbsoluteT,
                at.PixelMultiMode.Collapse, None, encoder,
                at.EncoderOptions.default(plane), writer)
    return v


def _transcode(C, encoder, wide):
    buf = io.BytesIO()
    v = _video(C, buf, encoder, wide)
    frames = testing.moving_shapes(5, 3 * T, H, W, C)
    states, events = [], []
    for i in range(0, len(frames), T):
        p = v.submit_chunk(frames[i:i + T])
        ev = v.collect_chunk(p)
        assert p["outs"].pixd.dtype == (torch.int64 if wide else torch.int32)
        states.append(v._state_numpy())
        events.append(ev)
    v.end_write_stream()
    return buf.getvalue(), states, events


SINKS = {"raw": at.EncoderType.Raw, "empty": at.EncoderType.Empty,
         "compressed": at.EncoderType.Compressed}


@pytest.mark.parametrize("sink", sorted(SINKS))
@pytest.mark.parametrize("C", [1, 3], ids=["mono", "color"])
def test_forced_wide_layout_gives_the_narrow_state_and_bytes(traced, C, sink):
    want = _transcode(C, SINKS[sink], False)
    assert "video.wide_events" not in traced.report()
    got = _transcode(C, SINKS[sink], True)
    assert got[0] == want[0]
    if sink != "empty":
        assert len(got[0]) > 1000
    for a, b in zip(got[1], want[1]):
        for f in a:
            assert np.array_equal(a[f], b[f]), f
    counts = [len(e) for e in got[2]]
    assert counts == [len(e) for e in want[2]] and min(counts) > 0
    for a, b in zip(got[2], want[2]):
        for f in ("x", "y", "c", "d", "t"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    r = traced.report()
    assert r["video.wide_events"].items == sum(counts)
    assert ("video.wire_pack" in r) == (sink == "raw")


def _tiny_traffic():
    t = json.loads((harness.HERE / "traffic" / "raw-moving-2160p.json")
                   .read_text())
    paths = [dict(p, vx_px=p["vx_px"] / 16, vy_px=p["vy_px"] / 16)
             for p in t["scene"]["blobs"]["paths"]]
    return dict(t, pool_frames=16, warmup_frames=16, window_pairs=1,
                scene=dict(t["scene"], blobs=dict(t["scene"]["blobs"],
                                                  sigma_px=4.0, paths=paths)))


def test_the_4k_cell_is_correct_on_a_tiny_plane_in_the_wide_layout(traced):
    """The cell `framed-2160p-color-raw-moving` through its driver
    (`framed_wide`: the framed driver with `reference_wide`) at 24 x 16 x 3,
    the program's layout forced wide: every check 0, the events counted."""
    seen = []

    def force_wide(video):
        video._wide = True
        seen.append(video)

    line = harness.run("framed-2160p-color-raw-moving", 2 ** 31 + 99, 0.3,
                       False, t_start=time.perf_counter(), device="cpu",
                       plane=(24, 16, 3), hook=force_wide,
                       traffic=_tiny_traffic())
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["chunks_checked"] >= 4
    assert set(line["checks"]) == {"state_mismatch", "count_mismatch",
                                   "bytes_mismatch"}
    assert seen and seen[0]._wide
    assert traced.report()["video.wide_events"].items > 0
    driver = harness.load_module(harness.HERE / "drivers" / "framed_wide.py")
    assert driver._framed.reference is reference_wide
    framed = harness.load_module(harness.HERE / "drivers" / "framed.py")
    assert framed.reference is reference


def _truth(pix, d, t, width, C):
    """The raw records of events, by numpy (codec/raw/stream.rs)."""
    xy = pix // C
    if C == 1:
        rec = np.empty(len(pix), dtype=[("x", ">u2"), ("y", ">u2"),
                                         ("d", "u1"), ("t", ">u4")])
    else:
        rec = np.empty(len(pix), dtype=[("x", ">u2"), ("y", ">u2"),
                                         ("tag", "u1"), ("c", "u1"),
                                         ("d", "u1"), ("t", ">u4")])
        rec["tag"], rec["c"] = 1, pix % C
    rec["x"], rec["y"], rec["d"], rec["t"] = xy % width, xy // width, d, t
    return rec.tobytes()


@pytest.mark.parametrize("plane", [(3840, 2160, 3), (8192, 4096, 1)],
                         ids=["4k-color", "mono-past-2^24"])
def test_pack_and_host_unpack_past_24_bits(plane):
    """Events at pixel indices past 2^24 (up to the plane's last, 24,883,199
    at 4K colour), d 0, 128 and 255, t past 2^31: the plain pack, the host
    route's fetch and unpack, and reference_wide's bytes all give numpy's
    records."""
    Wp, Hp, C = plane
    last = Wp * Hp * C - 1
    rng = np.random.default_rng(7)
    pix = np.concatenate([[2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1, last, last,
                           0], rng.integers(2 ** 24, last + 1, 200)])
    d = np.concatenate([[0, 128, 255, 0, 255, 128],
                        rng.choice([0, 128, 255], 200)])
    t = np.concatenate([[2 ** 31, 2 ** 32 - 1, 0, 2 ** 31 - 1, 2 ** 31 + 5,
                         1], rng.integers(2 ** 31, 2 ** 32, 200)])
    want = _truth(pix, d, t, Wp, C)
    pixd = torch.from_numpy((pix << 8) | d)
    tt = torch.from_numpy(t.astype(np.uint32).view(np.int32))
    assert FR.wire_pack_plain(pixd, tt, Wp, C).numpy().tobytes() == want
    assert FR.wire_pack(pixd, tt, Wp, C).numpy().tobytes() == want
    # the host route: Video._fetch, then Video._encode's unpack
    host = types.SimpleNamespace(
        plane=at.PlaneSize(Wp, Hp, C),
        encoder=types.SimpleNamespace(ingest_event_array=lambda ev: None),
        _trace="video")
    host._events_from_flat = lambda *a: V.Video._events_from_flat(host, *a)
    wire = V.Video._fetch(host, pixd, tt)
    assert wire[0].dtype == np.int64
    events = V.Video._encode(host, *wire)
    assert rawcodec.encode_events(events, C) == want
    assert reference_wide.event_bytes(pixd.numpy(), tt.numpy(), Wp, C) == want


def test_plain_segment_copy_restores_the_pixel_from_the_segment():
    """Staging in the wide layout (lane << 8 | d in the low word) through
    the plain copy gives the chunk's events as int64 pix << 8 | d, as the
    narrow staging gives them as u32; and the plain chunk forced wide
    gives the same events."""
    for name, res, n in testing.segment_copy_cases(3):
        if not int(res.total):
            continue
        narrow = res.pixd.to(torch.int64) & 0xFFFFFFFF
        slab = FR.slab_entries(6)
        stage, seg_start, counts, link = testing.stage_segments(res, n, slab)
        low = stage & 0xFFFFFFFF
        lane_word = (((low >> 8) & 31) << 8) | (low & 0xFF)
        wide_stage = torch.where(stage >= 0, (stage & ~0xFFFFFFFF) | lane_word,
                                 stage)
        offsets = FR.exclusive_scan_plain(counts)
        flags = torch.zeros(3, dtype=torch.int32)
        for cap in (int(res.total), int(res.total) // 2):
            pixd, t = FR.segment_copy(wide_stage, seg_start, counts, offsets,
                                      link, slab, cap, flags, wide=True)
            assert pixd.dtype == torch.int64, name
            assert torch.equal(pixd, narrow[:cap]), name
            assert torch.equal(t, res.t[:cap]), name


def test_plain_chunk_forced_wide_equals_narrow():
    n = 47 * 61
    frames = torch.from_numpy(testing.walk_frames(4, 6, n))
    p = testing.MODE_CASES[5]
    st = ops.set_initial_d(ops.init_state(n, "cpu", depth=6),
                           frames[0].to(torch.int32))
    a = FR.fused_chunk_resident(st, frames, 255.0, p, event_cap=0)
    b = FR.fused_chunk_resident(st, frames, 255.0, p, event_cap=0, wide=True)
    assert a.pixd.dtype == torch.int32 and b.pixd.dtype == torch.int64
    assert int(a.total) > 0
    assert torch.equal(b.pixd, a.pixd.to(torch.int64) & 0xFFFFFFFF)
    assert torch.equal(b.t, a.t) and torch.equal(b.pmax, a.pmax)
    for f in FR._KERNEL_FIELDS:
        assert torch.equal(getattr(b.state, f), getattr(a.state, f)), f
    with pytest.raises(ValueError, match="display"):
        FR.fused_chunk_resident(st, frames, 255.0, p, frames[0].clone(),
                                event_cap=0, wide=True)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_reference_wide_equals_reference_below_2_24(prec):
    config = json.loads((harness.ROOT / "portbench" / "configs"
                                 / "framed-2160p-color.json").read_text())
    p = reference_wide.params_of(config)
    Wp, Hp, C = 24, 16, 3
    frames = torch.from_numpy(testing.moving_shapes(2, 8, Hp, Wp, C)
                              .reshape(8, -1))
    st = reference_wide.first_frame(
        reference_wide.initial_state(Wp * Hp * C, p, "cpu"), frames[0])
    sw = sn = st
    for k in (0, 4):
        a = reference.run_chunk(sn, frames[k:k + 4], p, prec=prec)
        b = reference_wide.run_chunk(sw, frames[k:k + 4], p, prec=prec)
        assert int(a.total) > 0 and b.pixd.dtype == torch.int64
        assert torch.equal(b.pixd, a.pixd.to(torch.int64) & 0xFFFFFFFF)
        for f in ("t", "per_interval", "pmax", "total"):
            assert torch.equal(getattr(b, f), getattr(a, f)), f
        for f in reference.State._fields:
            assert torch.equal(getattr(b.state, f), getattr(a.state, f)), f
        want = reference.event_bytes(a.pixd.numpy(), a.t.numpy(), Wp, C)
        assert reference_wide.event_bytes(b.pixd.numpy(), b.t.numpy(), Wp,
                                          C) == want
        assert reference_wide.event_bytes(a.pixd.numpy(), a.t.numpy(), Wp,
                                          C) == want
        sn, sw = a.state, b.state
    assert reference_wide.header_bytes is reference.header_bytes


def test_reference_wide_imports_nothing_of_the_program():
    tree = ast.parse((harness.HERE / "reference_wide.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    assert names <= {"__future__", "numpy", "torch", "portbench",
                     "portbench.reference"}


def _prophesee_header(tmp_path, w, h):
    path = tmp_path / "wide.raw"
    path.write_bytes(f"% Height {h}\n% Width {w}\n".encode() + bytes([0, 8]))
    return str(path)


REFUSALS = ["fused", "slots", "sharded", "multihost", "prophesee", "davis",
            "past-2^32"]


@pytest.mark.parametrize("what", REFUSALS)
def test_the_24_bit_engines_and_sources_refuse_wide_planes(what, monkeypatch,
                                                           tmp_path):
    """A plane of 2^24 pixel-channels or more is refused, with a
    ValueError and before anything is allocated, by the fused (K5) and slot
    (K6) engines, ShardedVideo and a multihost band, and the lane sources
    (K3, K4); the resident engine refuses 2^32."""
    plane = at.PlaneSize(3840, 2160, 3)
    mode = at.Mode.FramePerfect
    if what == "fused":
        monkeypatch.setenv("ADDER_TPU_RESIDENT", "0")
        build = lambda: at.Video(plane, mode, device="cpu")  # noqa: E731
    elif what == "slots":
        monkeypatch.setenv("ADDER_TPU_FUSED", "0")
        build = lambda: at.Video(plane, mode, device="cpu")  # noqa: E731
    elif what == "sharded":
        build = lambda: at.ShardedVideo(plane, mode,  # noqa: E731
                                        mesh=["cpu"] * 2)
    elif what == "multihost":
        build = lambda: at.ShardedVideo(plane, mode, mesh=["cpu"],  # noqa
                                        pixels=(0, 1000))
    elif what == "prophesee":
        path = _prophesee_header(tmp_path, 4096, 4096)
        build = lambda: at.Prophesee(20, path, device="cpu")  # noqa: E731
    elif what == "davis":
        provider = types.SimpleNamespace(plane=at.PlaneSize(3840, 2160, 1))
        build = lambda: at.Davis(provider, prefetch=False,  # noqa: E731
                                 device="cpu")
    else:
        build = lambda: at.Video(at.PlaneSize(65535, 65535, 3),  # noqa
                                 mode, device="cpu")
    with pytest.raises(ValueError, match="24 bits|2\\^20|wide event layout"):
        build()


@pytest.mark.parametrize("what", ["display", "features"])
def test_a_wide_video_refuses_the_display_and_features(what):
    v = _video(1, io.BytesIO(), at.EncoderType.Raw, True)
    if what == "display":
        v._keep_running_frame = True
    else:
        v.update_detect_features(True)
    with pytest.raises(ValueError, match="display"):
        v.submit_chunk(testing.moving_shapes(1, T, H, W, 1))


def test_capacity_arithmetic_at_4k_colour():
    """K_SLOTS x N x T at 3840 x 2160 x 3 and 8 frames: 2,189,721,600
    slots, past 2^31, whole through the staging pool and the C argument
    blocks; each slab index of the pool still fits the i32 link."""
    n, T8 = 3840 * 2160 * 3, 8
    assert FR.wide_layout(n) and not FR.wide_layout(FR.MAX_PIXELS - 1)
    cap = V.event_capacity(ops.K_SLOTS, n, T8)
    assert cap == 2_189_721_600 > 2 ** 31
    assert V.event_capacity(64, n, T8) == cap  # at most K_SLOTS a slot
    assert V.event_capacity(1, n, T8) == n * T8
    for depth in (6, 8):
        slab = FR.slab_entries(depth)
        pool = FR.staging_pool(cap, n, depth)
        assert pool % slab == 0 and pool >= cap + -(-n // 32) * slab
        assert pool // slab < 2 ** 31
        a = FR._ChunkArgs()
        a.pool, a.n = pool, n
        assert (a.pool, a.n) == (pool, n)
    c = FR._CopyArgs()
    c.cap, c.segments, c.n_warps = cap, T8 * -(-n // 32), -(-n // 32)
    assert (c.cap, c.segments, c.n_warps) == (cap, T8 * -(-n // 32),
                                              -(-n // 32))
    # the records of so many events, in bytes: a Python int past 2^34
    assert cap * 11 == 24_086_937_600
    assert LAST_4K < FR.MAX_WIDE_PIXELS
