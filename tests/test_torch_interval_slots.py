"""The port's interval-slot engine (adder_tpu_torch/ops/pallas_kernel.py,
plain version, and `integrate.transcode_chunk`) against the JAX package's
`make_interval_pallas` (the Pallas kernel K6 in interpret mode), its jitted
`integrate_interval` and its XLA chunk scan `make_transcode_chunk`.

Tolerances:
- against the jitted XLA functions: exact (slots where the mask is set,
  every state field, the display intensity, chunk buffers bit for bit);
- against the interpret-mode kernel: masks exact; slot t, state and the
  display intensity exact except the FMA-tie class of
  tests/test_fused_kernel.py:55-74 (at most 1% of elements differing by one
  ulp, tick or display unit).
The JAX reference is jitted, as tests/test_fused_kernel.py:215-216 does:
eager JAX rounds the display division differently from any fused graph.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adder_tpu.core.types import Mode, PixelMultiMode, TimeMode
from adder_tpu.ops import integrate as K
from adder_tpu.ops import pallas_kernel as JPK
from adder_tpu_torch import convert, testing
from adder_tpu_torch.ops import integrate as P
from adder_tpu_torch.ops import pallas_kernel as PK

N = 512
T = 3


def _params(mode=Mode.FramePerfect, multi=PixelMultiMode.Collapse,
            tm=TimeMode.AbsoluteT, dtm=255 * 4, view=0):
    cfg = dict(mode=int(mode), multi_mode=int(multi), time_mode=int(tm),
               ref_time=255, delta_t_max=dtm, view_mode=view)
    return K.TranscodeParams(**cfg), P.TranscodeParams(**cfg)


def _jax_state(frame, depth=K.DEPTH):
    return K.set_initial_d(K.init_state(frame.shape[0], depth=depth),
                           jnp.asarray(frame.astype(np.int32)))


def _jit_interval(kp):
    return jax.jit(lambda st, f: K.integrate_interval(
        st, f.astype(jnp.float32), f.astype(jnp.int32), jnp.float32(255.0),
        kp))


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


def _compare_interval(ref, got, exact):
    """`ref` a JAX interval tuple, `got` the port's `interval_slots`."""
    close = np.testing.assert_array_equal if exact else _assert_fma_tie_only
    j_st, j_d, j_t, j_m, (j_rv, j_rh) = ref
    st, sd, stt, sm, (rv, rh) = got
    m = np.asarray(j_m)
    np.testing.assert_array_equal(sm.numpy(), m)
    np.testing.assert_array_equal(sd.numpy()[m], np.asarray(j_d)[m])
    close(np.asarray(j_t)[m], stt.numpy().view(np.uint32)[m])
    assert (sd.numpy()[~m] == 0).all() and (stt.numpy()[~m] == 0).all()
    np.testing.assert_array_equal(rh.numpy(), np.asarray(j_rh))
    close(np.asarray(j_rv), rv.numpy())
    port = convert.state_to_numpy(st)
    for f in K.PixelState._fields:
        close(np.asarray(getattr(j_st, f)), port[f])
    return int(m.sum())


@pytest.mark.parametrize("exact", [False, True], ids=["pallas", "xla"])
def test_interval_slots_plain_matches_jax(exact):
    """Three intervals, Continuous / Normal (the mode that fills the most
    slots), against the interpret-mode kernel and the jitted XLA interval."""
    kp, pp = _params(Mode.Continuous, PixelMultiMode.Normal)
    frames = np.random.default_rng(17).integers(0, 256, (T, N)).astype(
        np.uint8)
    js = _jax_state(frames[0])
    ts = convert.state_from_numpy(js, "cpu")
    step = (_jit_interval(kp) if exact else
            JPK.make_interval_pallas(kp, N, block=256, interpret=True))
    n_ev = 0
    for i in range(T):
        f = frames[i]
        ref = (step(js, jnp.asarray(f)) if exact
               else step(js, jnp.asarray(f), jnp.float32(255.0)))
        got = PK.interval_slots(ts, torch.from_numpy(f), 255.0, pp)
        n_ev += _compare_interval(ref, got, exact)
        js, ts = ref[0], got[0]
    assert n_ev > N


@pytest.mark.parametrize("view", [0, 1, 2, 3],
                         ids=["Intensity", "D", "DeltaT", "SAE"])
def test_running_intensity_matches_jitted_jax(view):
    """The display intensity in each view mode, on states whose roots hold
    best events: exact against the jitted JAX interval."""
    kp, pp = _params(Mode.Continuous, PixelMultiMode.Normal, dtm=255 * 24,
                     view=view)
    frames = testing.walk_frames(view, 4, N)
    js = _jax_state(frames[0])
    ts = convert.state_from_numpy(js, "cpu")
    step = _jit_interval(kp)
    for f in frames:
        js, _, _, _, (j_rv, j_rh) = step(js, jnp.asarray(f))
        fv = torch.from_numpy(f.astype(np.int32))
        ts, *_, (rv, rh) = P.integrate_interval(ts, fv.to(torch.float32), fv,
                                                255.0, pp)
        np.testing.assert_array_equal(rh.numpy(), np.asarray(j_rh))
        np.testing.assert_array_equal(rv.numpy(), np.asarray(j_rv))
    vals = rv.numpy()[rh.numpy()]
    assert rh.numpy().mean() > 0.3 and len(np.unique(vals)) > 3


def _jax_chunk(kp, cap, pack, st, frames, run0, n_real=0):
    fn = K.make_transcode_chunk(kp, cap, pack, n_real=n_real)
    return fn(st, jnp.asarray(frames), jnp.float32(255.0), run0)


def _compare_chunk(ref, got, buffers=False):
    total = int(ref[6])
    assert int(got.total) == total
    np.testing.assert_array_equal(got.per_interval.numpy(), np.asarray(ref[7]))
    n = total if not buffers else None
    np.testing.assert_array_equal(got.pixd[:n].numpy().view(np.uint32),
                                  np.asarray(ref[1][:n]))
    np.testing.assert_array_equal(got.t[:n].numpy().view(np.uint32),
                                  np.asarray(ref[2][:n]))
    np.testing.assert_array_equal(got.runnings.numpy(), np.asarray(ref[8]))
    assert int(got.pmax) == int(ref[9])
    port = convert.state_to_numpy(got.state)
    for f in K.PixelState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref[0], f)), port[f],
                                      err_msg=f)


@pytest.mark.parametrize("pack", [4, K.K_SLOTS])
def test_transcode_chunk_matches_xla_chained(pack):
    """Two chained chunks (display frame chained through run0) on a padded
    plane (n_real), against the jitted XLA chunk: exact."""
    kp, pp = _params(Mode.Continuous, PixelMultiMode.Collapse)
    rng = np.random.default_rng(29)
    frames = rng.integers(0, 256, (2 * T, N)).astype(np.uint8)
    frames[:, : N // 4] = 128
    cap = K.K_SLOTS * N * T
    js = _jax_state(frames[0])
    ts = convert.state_from_numpy(js, "cpu")
    run_j, run_t = jnp.zeros((N,), jnp.uint8), torch.zeros(N, dtype=torch.uint8)
    for c in range(2):
        f = frames[c * T : (c + 1) * T]
        ref = _jax_chunk(kp, cap, pack, js, f, run_j, n_real=N - 37)
        got = P.transcode_chunk(ts, torch.from_numpy(f), 255.0, run_t, pp,
                                cap, pack, n_real=N - 37)
        _compare_chunk(ref, got)
        js, ts = ref[0], got.state
        run_j, run_t = ref[8][-1], got.runnings[-1]


def test_truncating_take_matches_xla():
    """A cap so small that intervals overflow their `take` prefix and the
    pack overflows: the port signals it as JAX does (n_ev > take, total >
    cap, max_cnt > pack) and its buffers equal JAX's bit for bit, garbage
    and clamped windows included."""
    kp, pp = _params(Mode.Continuous, PixelMultiMode.Normal, dtm=255)
    frames = np.random.default_rng(5).integers(0, 256, (T, N)).astype(np.uint8)
    cap = 2 * N  # take = cap // T // 4 = 85 per interval
    take = P.per_interval_take(cap, T)
    js = _jax_state(frames[0])
    ts = convert.state_from_numpy(js, "cpu")
    run0 = torch.zeros(N, dtype=torch.uint8)
    for pack in (2, K.K_SLOTS):
        ref = _jax_chunk(kp, cap, pack, js, frames, jnp.zeros((N,), jnp.uint8))
        got = P.transcode_chunk(ts, torch.from_numpy(frames), 255.0, run0, pp,
                                cap, pack)
        assert int(got.per_interval.max()) > take
        _compare_chunk(ref, got, buffers=True)
        assert int(got.pmax) > 2 if pack == 2 else int(got.pmax) == 0
    assert int(got.total) > cap


def test_wrapper_runs_plain_on_cpu_and_counts_overflow():
    """The wrapper takes the plain version for CPU tensors (no launch), and
    a forced depth-8 overflow adds to state.overflow as JAX's kernel does."""
    kp, pp = _params(dtm=255 * 24)
    frame = np.random.default_rng(2).integers(1, 256, N).astype(np.uint8)
    st = testing.forced_overflow_state(torch.from_numpy(frame), 40, depth=8)
    PK.reset_launch_counts()
    got = PK.interval_slots(st, torch.from_numpy(frame), 255.0, pp)
    assert PK.LAUNCHES == {"adder_interval_slots": 0}
    jst = K.PixelState(**{k: jnp.asarray(v) for k, v in
                          convert.state_to_numpy(st).items()})
    ref = _jit_interval(kp)(jst, jnp.asarray(frame))
    assert int(got[0].overflow) == int(ref[0].overflow) > 0
    _compare_interval(ref, got, exact=True)


def test_kernel_check_harness_runs_on_cpu():
    """chip_smoke.py's K6-against-plain check, on CPU tensors (where both
    sides are the plain version): the harness itself runs clean."""
    assert testing.check_interval_slots_against_plain("cpu", H=20, W=30,
                                                      T=3) == 0.0
