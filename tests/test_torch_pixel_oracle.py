"""The port's scalar per-event oracle (`batched=False`) against the JAX
package's, on the CPU.

`adder_tpu_torch/transcoder/pixel_oracle.py` is a copy of the JAX package's
(tests/test_torch_shared_copies.py holds it to the original); here the two
DVS sources drive it: the port's `Prophesee(batched=False)` and
`Davis(batched=False)` write the JAX sources' `batched=False` bytes on the
same inputs, and the oracle's per-pixel event streams equal the port's
batched plain route's (the batched route orders events across pixels by
sub-step, the oracle by input event, so only each pixel's own stream is
held). Tolerance 0.
"""

import io

import numpy as np
import pytest

import adder_tpu_torch as at
from adder_tpu.core.types import PlaneSize as JPlaneSize
from adder_tpu.transcoder import davis as JD
from adder_tpu.transcoder import prophesee as JP
from adder_tpu_torch.transcoder import davis as TD
from adder_tpu_torch.transcoder import prophesee as TP

from test_torch_davis import (CLI, JAX_ENC, PORT_ENC, H, W, _drive,
                              _packets)
from test_torch_dvs import _transcode, open_file_decoder_bytes


@pytest.fixture(scope="module")
def stream_path(tmp_path_factory):
    """The 14 x 10 stream of tests/test_torch_dvs.py (seed 3, 300 events)."""
    from adder_tpu_torch import testing

    w, h = 14, 10
    rng = np.random.default_rng(3)
    t = 10 + np.cumsum(rng.integers(1, 1500, 300))
    x, y, p = (rng.integers(0, w, 300), rng.integers(0, h, 300),
               rng.integers(0, 2, 300))
    path = tmp_path_factory.mktemp("dvs") / "s.raw"
    testing.write_prophesee_raw(path, w, h, t, x, y, p)
    return str(path)


def _streams(events):
    out = {}
    for x, y, d, t in events:
        out.setdefault((x, y), []).append((d, t))
    return out


@pytest.mark.parametrize("crf", [3, None], ids=["crf3", "no-crf"])
def test_prophesee_oracle_writes_jax_oracle_bytes(stream_path, crf):
    """`Prophesee(batched=False)`: the bootstrap, every event's gap and
    tick and the end-of-stream flush on the scalar oracle give the JAX
    oracle's bytes and chain state, and the same per-pixel streams as the
    port's batched route on the CPU."""
    jax_src = JP.Prophesee(20, stream_path, batched=False)
    want = _transcode(jax_src, crf=crf)
    port = TP.Prophesee(20, stream_path, batched=False, device="cpu")
    got = _transcode(port, crf=crf)
    assert got == want and len(got) > 1000
    np.testing.assert_array_equal(port.dvs_last_timestamps,
                                  jax_src.dvs_last_timestamps)
    np.testing.assert_array_equal(port.dvs_last_ln_val,
                                  jax_src.dvs_last_ln_val)
    assert port.state is None and len(port._pixels) == 140
    batched = _transcode(TP.Prophesee(20, stream_path, device="cpu"),
                         crf=crf)
    assert batched != got  # the cross-pixel order differs
    assert _streams(open_file_decoder_bytes(batched)) == _streams(
        open_file_decoder_bytes(got))


def _davis(mod, batched, mode="RawDavis"):
    plane = (JPlaneSize if mod is JD else at.PlaneSize)(W, H, 1)
    kw = {} if mod is JD else {"device": "cpu"}
    return mod.Davis(mod.ArrayDavisProvider(_packets(mod), plane),
                     mode=mod.TranscoderMode[mode], batched=batched,
                     prefetch=False, **CLI, **kw)


@pytest.mark.parametrize("mode,quality", [("RawDavis", "manual"),
                                          ("RawDavis", "crf3"),
                                          ("RawDvs", "crf3")])
def test_davis_oracle_writes_jax_oracle_bytes(mode, quality):
    """`Davis(batched=False)` on the four packets of
    tests/test_torch_davis.py (frames with events between them and an
    event-only packet): the JAX oracle's bytes and chain state, and the
    same per-pixel streams as the port's batched route on the CPU."""
    jax_src = _davis(JD, False, mode)
    want = _drive(jax_src, quality, JAX_ENC)
    port = _davis(TD, False, mode)
    got = _drive(port, quality, PORT_ENC)
    assert got == want and len(got) > 1000
    np.testing.assert_array_equal(port.dvs_last_timestamps,
                                  jax_src.dvs_last_timestamps)
    np.testing.assert_array_equal(port.dvs_last_ln_val,
                                  jax_src.dvs_last_ln_val)
    assert port.state is None
    batched = _drive(_davis(TD, True, mode), quality, PORT_ENC)
    assert _streams(open_file_decoder_bytes(batched)) == _streams(
        open_file_decoder_bytes(got))


def test_oracle_sources_still_need_the_card_by_default(stream_path,
                                                       monkeypatch):
    """The oracle runs no tensor operation, but its device is resolved as
    at every entry point: without CUDA the default raises."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TP.Prophesee(20, stream_path, batched=False)
    with pytest.raises(RuntimeError, match="cuda"):
        TD.Davis(TD.ArrayDavisProvider([], at.PlaneSize(W, H, 1)),
                 batched=False, prefetch=False)


def test_oracle_void_of_tensors(stream_path):
    """A whole oracle transcode with every torch tensor factory made to
    raise: the scalar branches run no tensor operation."""
    import torch

    src = TP.Prophesee(20, stream_path, batched=False, device="cpu")
    src.crf(3)
    buf = io.BytesIO()
    src.write_out(at.SourceCamera.Dvs, at.TimeMode.AbsoluteT,
                  at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                  at.EncoderOptions.default(src.plane), buf)

    def no_tensor(*a, **k):
        raise AssertionError("a tensor operation ran")

    saved = {k: getattr(torch, k) for k in ("empty", "zeros", "full",
                                            "from_numpy", "tensor")}
    try:
        for k in saved:
            setattr(torch, k, no_tensor)
        while True:
            try:
                src.consume()
            except EOFError:
                break
    finally:
        for k, v in saved.items():
            setattr(torch, k, v)
    src.end_write_stream()
    assert len(buf.getvalue()) > 1000
