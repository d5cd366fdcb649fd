"""The port's fused one-interval engine (adder_tpu_torch/ops/fused_kernel.py,
plain version) against the JAX package's `make_fused_chunk` (the Pallas
kernel K5 in interpret mode) and its XLA chunk scan `make_transcode_chunk`.

Shapes and parameters are those of tests/test_fused_kernel.py (BLOCK 256,
N 512, T 3). Tolerances:
- against the XLA chunk (jitted): exact (events, counts, display frames,
  every state field but `overflow`, which the fused kernels pass through);
- against the interpret-mode kernel: events, counts and `pmax` exact; event
  t, state and display frames exact except the FMA-tie class of
  tests/test_fused_kernel.py:55-74 (at most 1% of elements differing by one
  ulp, tick or display unit): the interpret graph and XLA may contract a
  product and a sum differently on rounding near-ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adder_tpu.core.types import Mode, PixelMultiMode, TimeMode
from adder_tpu.ops import integrate as K
from adder_tpu_torch import convert, testing
from adder_tpu_torch.ops import fused_kernel as FK
from adder_tpu_torch.ops import integrate as P

BLOCK = 256
N = BLOCK * 2
T = 3
CAP = K.K_SLOTS * N * T * 4

# the fast cases of tests/test_fused_kernel.py:95-106
MODE_CASES = [
    (Mode.FramePerfect, PixelMultiMode.Collapse, TimeMode.AbsoluteT),
    (Mode.Continuous, PixelMultiMode.Collapse, TimeMode.AbsoluteT),
]
IDS = [f"{m.name}-{u.name}-{t.name}" for m, u, t in MODE_CASES]


def _params(mode=Mode.FramePerfect, multi=PixelMultiMode.Collapse,
            tm=TimeMode.AbsoluteT, dtm=255 * 4):
    cfg = dict(mode=int(mode), multi_mode=int(multi), time_mode=int(tm),
               ref_time=255, delta_t_max=dtm)
    return K.TranscodeParams(**cfg), P.TranscodeParams(**cfg)


def _frames(rng, t=T, n=N):
    frames = rng.integers(0, 256, (t, n)).astype(np.uint8)
    frames[:, : n // 4] = 128  # static region
    return frames


def _jax_state(frames, depth=K.DEPTH):
    return K.set_initial_d(K.init_state(frames.shape[1], depth=depth),
                           jnp.asarray(frames[0].astype(np.int32)))


def _jax_chunk(fn, st, frames, run0=None):
    run0 = jnp.zeros((frames.shape[1],), jnp.uint8) if run0 is None else run0
    return fn(st, jnp.asarray(frames), jnp.float32(255.0), run0)


def _port(st, frames, pp, pack=4, run0=None, **kw):
    n = frames.shape[1]
    run0 = torch.zeros(n, dtype=torch.uint8) if run0 is None else run0
    return FK.fused_chunk(st, torch.from_numpy(frames), 255.0, run0, pp, CAP,
                          pack, **kw)


def _assert_fma_tie_only(a, b):
    """Exact, except <= 1% of elements differing by one ulp / one unit."""
    a, b = np.asarray(a), np.asarray(b)
    if np.array_equal(a, b):
        return
    if a.dtype == np.float32:
        tie = np.abs(a - b) <= np.spacing(np.maximum(np.abs(a), np.abs(b)))
    else:
        tie = np.abs(a.astype(np.int64) - b.astype(np.int64)) <= 1
    frac = float((a != b).mean())
    assert tie.all() and frac <= 0.01, f"non-tie mismatch: frac={frac}"


def _compare(ref, got, exact, pmax=True):
    """`ref` a JAX chunk tuple, `got` the port's IntervalChunk."""
    close = np.testing.assert_array_equal if exact else _assert_fma_tie_only
    total = int(ref[6])
    assert int(got.total) == total > 0
    np.testing.assert_array_equal(got.per_interval.numpy(), np.asarray(ref[7]))
    np.testing.assert_array_equal(got.pixd[:total].numpy().view(np.uint32),
                                  np.asarray(ref[1][:total]))
    close(np.asarray(ref[2][:total]), got.t[:total].numpy().view(np.uint32))
    close(np.asarray(ref[8]), got.runnings.numpy())
    if pmax:
        assert int(got.pmax) == int(ref[9])
    port = convert.state_to_numpy(got.state)
    for f in K.PixelState._fields[:-1]:
        close(np.asarray(getattr(ref[0], f)), port[f])


@pytest.mark.parametrize("mode,multi,tm", MODE_CASES, ids=IDS)
def test_plain_matches_pallas_interpret(mode, multi, tm):
    kp, pp = _params(mode, multi, tm)
    frames = _frames(np.random.default_rng(7))
    js = _jax_state(frames)
    ref = _jax_chunk(K.make_fused_chunk(kp, CAP, 4, pallas_block=BLOCK,
                                        interpret=True), js, frames)
    got = _port(convert.state_from_numpy(js, "cpu"), frames, pp)
    _compare(ref, got, exact=False)
    assert int(got.state.overflow) == int(js.overflow)  # passed through


@pytest.mark.parametrize("mode,multi,tm", MODE_CASES, ids=IDS)
@pytest.mark.parametrize("pack", [4, 16])
def test_plain_matches_xla_chunk_chained(mode, multi, tm, pack):
    """Two chained chunks, the display frame chained through run0, against
    the jitted XLA chunk: exact."""
    kp, pp = _params(mode, multi, tm)
    rng = np.random.default_rng(13)
    f1, f2 = _frames(rng), _frames(rng)
    fn = K.make_transcode_chunk(kp, CAP, K.K_SLOTS)
    js = _jax_state(f1)
    ts = convert.state_from_numpy(js, "cpu")
    run_j, run_t = None, None
    for frames in (f1, f2):
        ref = _jax_chunk(fn, js, frames, run_j)
        got = _port(ts, frames, pp, pack, run0=run_t)
        assert int(got.pmax) & 0xFFFF <= 4  # nothing lost to the pack
        _compare(ref, got, exact=True, pmax=False)
        js, ts = ref[0], got.state
        run_j, run_t = ref[8][-1], got.runnings[-1]


def test_pack16_and_pad_masking_match_pallas_interpret():
    """pack 16 (>= K: every slot a lane) on a padded plane: pixels at or
    past n_real emit nothing, and the rest equal the unpadded stream."""
    kp, pp = _params()
    rng = np.random.default_rng(11)
    n_real = N - 100
    frames = _frames(rng)
    frames[:, n_real:] = 0
    js = _jax_state(frames)
    fn = K.make_fused_chunk(kp, CAP, 16, pallas_block=BLOCK, n_real=n_real,
                            interpret=True)
    ref = _jax_chunk(fn, js, frames)
    got = _port(convert.state_from_numpy(js, "cpu"), frames, pp, 16,
                n_real=n_real)
    _compare(ref, got, exact=False)
    pix = got.pixd[: int(got.total)].numpy().view(np.uint32) >> 8
    assert pix.max() < n_real
    real = _port(P.set_initial_d(P.init_state(n_real, "cpu"),
                                 torch.from_numpy(frames[0, :n_real]
                                                  .astype(np.int32))),
                 np.ascontiguousarray(frames[:, :n_real]), pp, 16)
    assert torch.equal(real.pixd[: int(real.total)],
                       got.pixd[: int(got.total)])


def test_pack2_overflow_matches_xla():
    """Continuous / Normal with dtm == ref_time emits up to 3 slots per
    pixel-interval: pack 2 drops events and raises pmax to the XLA chunk's
    max_cnt; pack 16 recovers the whole stream."""
    kp, pp = _params(Mode.Continuous, PixelMultiMode.Normal, dtm=255)
    frames = np.random.default_rng(5).integers(0, 256, (T, N)).astype(np.uint8)
    js = _jax_state(frames)
    ts = convert.state_from_numpy(js, "cpu")
    ref2 = _jax_chunk(K.make_transcode_chunk(kp, CAP, 2), js, frames)
    got2 = _port(ts, frames, pp, 2)
    assert int(got2.pmax) == int(ref2[9]) > 2
    ref = _jax_chunk(K.make_transcode_chunk(kp, CAP, K.K_SLOTS), js, frames)
    assert int(got2.total) < int(ref[6])  # events were dropped
    _compare(ref, _port(ts, frames, pp, 16), exact=True, pmax=False)


def test_depth_overflow_and_rerun():
    """depth 6 holds this content; depth 2 overflows (pmax bit 16, state
    overflow passed through); the pre-chunk state padded to depth 8 and run
    again equals the XLA chunk."""
    kp, pp = _params(Mode.Continuous, PixelMultiMode.Collapse, dtm=255 * 24)
    frames = np.random.default_rng(21).integers(0, 256, (T, N)).astype(np.uint8)
    ref = _jax_chunk(K.make_transcode_chunk(kp, CAP, K.K_SLOTS),
                     _jax_state(frames), frames)

    def port_at(depth):
        st = P.set_initial_d(P.init_state(N, "cpu", depth=depth),
                             torch.from_numpy(frames[0].astype(np.int32)))
        return st, _port(st, frames, pp)

    _, six = port_at(6)
    assert int(six.pmax) >> 16 == 0
    assert torch.equal(six.pixd, _port(convert.state_from_numpy(
        _jax_state(frames), "cpu"), frames, pp).pixd)
    st2, two = port_at(2)
    assert int(two.pmax) >> 16 == 1
    assert int(two.state.overflow) == 0
    deep = _port(P.pad_state_depth(st2, 8), frames, pp)
    _compare(ref, deep, exact=True, pmax=False)


def test_emit_running_off_same_events():
    """emit_running=False skips only the display conversion: run0 carries
    through unchanged, events and state are those of the on case."""
    _, pp = _params()
    frames = _frames(np.random.default_rng(23))
    st = P.set_initial_d(P.init_state(N, "cpu"),
                         torch.from_numpy(frames[0].astype(np.int32)))
    run0 = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, N).astype(np.uint8))
    on = _port(st, frames, pp, run0=run0)
    off = _port(st, frames, pp, run0=run0, emit_running=False)
    assert torch.equal(off.runnings, run0.expand(T, N))
    assert not torch.equal(on.runnings, off.runnings)
    assert torch.equal(on.pixd, off.pixd) and torch.equal(on.t, off.t)
    for a, b in zip(on.state, off.state):
        assert torch.equal(a, b)


def test_interval_offsets_and_capacity_truncation():
    """One interval at a non-zero offset writes exactly there; a chunk whose
    buffer is too small keeps its prefix and reports total > cap."""
    _, pp = _params(Mode.Continuous)
    frames = _frames(np.random.default_rng(3))
    st = P.set_initial_d(P.init_state(N, "cpu", depth=6),
                         torch.from_numpy(frames[0].astype(np.int32)))
    full = _port(st, frames, pp)
    n0 = int(full.per_interval[0])
    bufs = (torch.full((n0 + 20,), -1, dtype=torch.int32),
            torch.full((n0 + 20,), -1, dtype=torch.int32))
    r = FK.fused_interval(st, torch.from_numpy(frames[0]), 255.0,
                          torch.tensor(7), bufs, pp)
    assert int(r.offset) == 7 + n0
    assert torch.equal(bufs[0][7 : 7 + n0], full.pixd[:n0])
    assert (bufs[0][:7] == -1).all() and (bufs[0][7 + n0 :] == -1).all()
    small = FK.fused_chunk(st, torch.from_numpy(frames), 255.0,
                           torch.zeros(N, dtype=torch.uint8), pp, n0 + 5)
    assert int(small.total) == int(full.total) > n0 + 5
    assert torch.equal(small.pixd, full.pixd[: n0 + 5])


def test_wrapper_runs_plain_on_cpu_and_check_harness():
    """The wrapper takes the plain version for CPU tensors (no launch), and
    chip_smoke.py's K5-against-plain check runs clean where both sides are
    the plain version."""
    FK.reset_launch_counts()
    assert testing.check_fused_interval_against_plain("cpu", H=20, W=30,
                                                      T=3) == 0.0
    assert FK.LAUNCHES == {"adder_fused_interval": 0}
