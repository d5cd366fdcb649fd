"""The `.adder` records made on the chunk's device, on the CPU.

- `wire_pack_plain` writes `codec/raw.py::encode_events`'s bytes for the
  events `Video._events_from_flat` gives, mono and colour, at the edges of
  each field and for no events at all.
- The rule of the route: a Raw sink with no event drop, the Unchanged order
  and feature detection off packs every chunk (the `video.wire_pack`
  counter); features, a manual drop, the Interleaved order and the
  Compressed sink take the host route and count nothing.
- The events `collect_chunk` returns on the packed route equal, field by
  field, those the host route unpacks from the same chunk.
- A writer that keeps every buffer it is handed still holds each chunk's
  bytes after the later chunks.
"""

import io

import numpy as np
import pytest
import torch

import adder_tpu_torch as at
from adder_tpu_torch import testing
from adder_tpu_torch.codec import raw as rawcodec
from adder_tpu_torch.codec.encoder import EventDrop, EventOrder
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.utils import tracing as TR
from adder_tpu_torch.utils.viz import ShowFeatureMode

W, H = 33, 17
T = 4


def _host_events(video, pixd: torch.Tensor, t: torch.Tensor):
    """The host route's unpack (`Video._encode`) of wire pairs."""
    pd = pixd.numpy().view(np.uint32)
    return video._events_from_flat((pd >> 8).astype(np.int64),
                                   (pd & 0xFF).astype(np.uint8),
                                   t.numpy().view(np.uint32))


def _edge_pairs(C: int, n: int, seed: int):
    """n wire pairs over a W x H x C plane with the edges of every field:
    the first and the last pixel-channel, d 0 and 255, t 0, 2^31 - 1,
    2^31 and 2^32 - 1; the rest drawn from the seed."""
    rng = np.random.default_rng(seed)
    last = W * H * C - 1
    pix = np.concatenate([[0, last, last, 0], rng.integers(0, last + 1, n)])
    d = np.concatenate([[0, 255, 0, 255], rng.integers(0, 256, n)])
    t = np.concatenate([[0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                        rng.integers(0, 2 ** 32, n)])
    pixd = ((pix << 8) | d).astype(np.uint32).view(np.int32)
    return (torch.from_numpy(pixd),
            torch.from_numpy(t.astype(np.uint32).view(np.int32)))


def _video(C, writer, encoder=at.EncoderType.Raw, options=None):
    plane = at.PlaneSize(W, H, C)
    v = at.Video(plane, at.Mode.FramePerfect, chunk_frames=T, device="cpu")
    v.time_parameters(255 * 24, 255, 255 * 30, at.TimeMode.AbsoluteT)
    v.write_out(at.SourceCamera.FramedU8, at.TimeMode.AbsoluteT,
                at.PixelMultiMode.Collapse, None, encoder,
                options or at.EncoderOptions.default(plane), writer)
    return v


def _frames(C, chunks=3):
    return testing.moving_shapes(3, chunks * T, H, W, C)


@pytest.mark.parametrize("n", [0, 1, 300], ids=["none", "one", "many"])
@pytest.mark.parametrize("C", [1, 3], ids=["mono", "color"])
def test_wire_pack_plain_writes_the_encoders_bytes(C, n):
    v = _video(C, io.BytesIO())
    pixd, t = _edge_pairs(C, 296, seed=n)
    pixd, t = pixd[:n], t[:n]
    got = FR.wire_pack_plain(pixd, t, W, C)
    want = rawcodec.encode_events(_host_events(v, pixd, t), C)
    assert got.dtype == torch.uint8
    assert got.numpy().tobytes() == want
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(FR.wire_pack(pixd, t, W, C), got)


def test_wire_pack_rejects_bad_input():
    pixd, t = _edge_pairs(1, 4, seed=0)
    # int64 pixd is the wide layout's (tests/test_torch_wide_plane.py)
    for args in ((pixd.to(torch.int16), t, W, 1), (pixd, t.to(torch.int64),
                                                   W, 1),
                 (pixd, t[:3], W, 1), (pixd, t, 0, 1), (pixd, t, W, 0)):
        with pytest.raises(ValueError):
            FR.wire_pack(*args)


@pytest.fixture
def traced(monkeypatch):
    monkeypatch.setattr(TR, "_ENABLED", True)
    TR.reset()
    yield TR
    TR.reset()


ROUTES = ["raw", "features", "manual-drop", "interleaved", "compressed"]


@pytest.mark.parametrize("route", ROUTES)
def test_packed_route_engages_by_the_rule(traced, route):
    """Only the plain Raw sink packs on the device; every other setting of
    the rule takes the host route, which unpacks on the host."""
    plane = at.PlaneSize(W, H, 1)
    options = at.EncoderOptions.default(plane)
    if route == "manual-drop":
        options.event_drop = EventDrop("manual", 1e9, 0.5)
    if route == "interleaved":
        options.event_order = EventOrder.Interleaved
    v = _video(1, io.BytesIO(), at.EncoderType.Compressed
               if route == "compressed" else at.EncoderType.Raw, options)
    if route == "features":
        v.update_detect_features(True, ShowFeatureMode.Off)
    assert v._packs_records() == (route == "raw")
    frames = _frames(1)
    counts = [len(v.integrate_matrix_batch(frames[i:i + T]))
              for i in range(0, len(frames), T)]
    v.end_write_stream()
    r = traced.report()
    assert min(counts) > 0
    if route == "raw":
        assert r["video.wire_pack"].items == len(counts)
        assert r["video.unpack"].items == sum(counts)
    else:
        assert "video.wire_pack" not in r
        assert r["video.unpack"].calls == len(counts)


@pytest.mark.parametrize("C", [1, 3], ids=["mono", "color"])
def test_packed_events_equal_the_host_routes(C):
    """Each collected chunk's events, read field by field, equal the host
    route's unpack of the same chunk's `outs.pixd[:total]`, `outs.t[:total]`;
    their length needs no decode."""
    v = _video(C, io.BytesIO())
    frames = _frames(C)
    for i in range(0, len(frames), T):
        p = v.submit_chunk(frames[i:i + T])
        ev = v.collect_chunk(p)
        assert isinstance(ev, rawcodec.WireEvents)
        total = int(p["outs"].total)
        assert len(ev) == total > 0
        assert ev._fields is None  # nothing decoded yet
        want = _host_events(v, p["outs"].pixd[:total], p["outs"].t[:total])
        for f in ("x", "y", "c", "d", "t"):
            np.testing.assert_array_equal(getattr(ev, f), getattr(want, f),
                                          err_msg=f)
        assert ev == want
    v.end_write_stream()


class KeepingWriter:
    """Keeps every buffer it is handed, and a copy of its bytes then."""

    def __init__(self):
        self.kept, self.copies = [], []

    def write(self, data):
        self.kept.append(data)
        self.copies.append(bytes(memoryview(data).cast("B")))
        return memoryview(data).nbytes

    def flush(self):
        pass


@pytest.mark.parametrize("C", [1, 3], ids=["mono", "color"])
def test_kept_buffers_hold_their_bytes(C):
    frames = _frames(C, chunks=4)
    keep = KeepingWriter()
    buf = io.BytesIO()
    for writer in (keep, buf):
        v = _video(C, writer)
        for i in range(0, len(frames), T):
            v.submit_chunk(frames[i:i + T])
        v.end_write_stream()
    assert len(keep.kept) >= 6  # the header, 4 chunks, the end marker
    for data, copy in zip(keep.kept, keep.copies):
        assert bytes(memoryview(data).cast("B")) == copy
    assert b"".join(keep.copies) == buf.getvalue()
