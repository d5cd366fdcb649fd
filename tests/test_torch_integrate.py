"""The port's interval logic (adder_tpu_torch/ops/integrate.py) against the
scalar oracle and against the JAX package's `integrate_interval`.

Tolerance: none. Every comparison is exact (events bit for bit, float state
bit for bit): the port rounds each f32 op once, as the reference does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adder_tpu.core.types import Coord, Mode, PixelMultiMode, TimeMode
from adder_tpu.ops import integrate as K
from adder_tpu.transcoder import pixel_oracle as O
from adder_tpu_torch import convert, testing
from adder_tpu_torch.ops import integrate as P

CASES = [
    (mode, multi, tm)
    for mode in (Mode.FramePerfect, Mode.Continuous)
    for multi in (PixelMultiMode.Normal, PixelMultiMode.Collapse)
    for tm in (TimeMode.DeltaT, TimeMode.AbsoluteT)
]


def _run_oracle(frames, p, c0):
    T, N = frames.shape
    pixels = []
    for i in range(N):
        px = O.PixelArena(1.0, Coord(i, 0, None))
        px.set_time_mode(TimeMode(p.time_mode))
        px.c_thresh = c0
        fv = int(frames[0, i])
        px.arena[0].d = O.get_d_from_intensity(float(fv)) if fv > 0 else 128
        px.base_val = fv
        pixels.append(px)
    out = []
    for t in range(T):
        for i in range(N):
            buf = []
            O.integrate_for_px(
                pixels[i], int(frames[t, i]), float(frames[t, i]),
                float(p.ref_time), buf, Mode(p.mode),
                PixelMultiMode(p.multi_mode), p.delta_t_max, p.ref_time,
                p.c_thresh_max, p.c_increase_velocity,
            )
            out.extend((t, i, e.d, e.t) for e in buf)
    return out


def _port_events(t, slot_d, slot_t, slot_m):
    """(interval, pixel, d, t) in reference order: pixel-major, then slot."""
    m = slot_m.T.numpy()
    pix = np.broadcast_to(np.arange(m.shape[0])[:, None], m.shape)[m]
    d = slot_d.T.numpy()[m] & 0xFF
    tt = slot_t.T.numpy()[m]
    return [(t, int(a), int(b), int(c)) for a, b, c in zip(pix, d, tt)]


def _run_port(frames, p, c0):
    T, N = frames.shape
    st = P.init_state(N, "cpu", c_thresh=c0)
    st = P.set_initial_d(st, torch.from_numpy(frames[0].astype(np.int32)))
    out = []
    for t in range(T):
        fv = torch.from_numpy(frames[t].astype(np.int32))
        st, sd, stt, sm, _ = P.integrate_interval(
            st, fv.to(torch.float32), fv, float(p.ref_time), p
        )
        out.extend(_port_events(t, sd, stt, sm))
    assert int(st.overflow) == 0
    return out


@pytest.mark.parametrize(
    "mode,multi,tm", CASES,
    ids=[f"{m.name}-{u.name}-{t.name}" for m, u, t in CASES],
)
@pytest.mark.parametrize(
    "c_max,c_vel,c0", [(0, 10, 0), (7, 2, 10)], ids=["lossless", "lossy"]
)
def test_port_matches_oracle(mode, multi, tm, c_max, c_vel, c0):
    p = P.TranscodeParams(
        mode=int(mode), multi_mode=int(multi), time_mode=int(tm),
        ref_time=255, delta_t_max=255 * 8, c_thresh_max=c_max,
        c_increase_velocity=max(c_vel, 1),
    )
    frames = testing.walk_frames([int(mode), int(multi), int(tm), c_max], 40, 64)
    got = _run_port(frames, p, c0)
    want = _run_oracle(frames, p, c0)
    assert len(got) == len(want)
    assert got == want


BENCH = dict(
    mode=int(Mode.FramePerfect), multi_mode=int(PixelMultiMode.Collapse),
    time_mode=int(TimeMode.DeltaT), ref_time=255, delta_t_max=255 * 24,
    c_thresh_max=0, c_increase_velocity=1,
)
CONT_LOSSY = dict(
    mode=int(Mode.Continuous), multi_mode=int(PixelMultiMode.Normal),
    time_mode=int(TimeMode.AbsoluteT), ref_time=255, delta_t_max=255 * 2,
    c_thresh_max=7, c_increase_velocity=2,
)


@pytest.mark.parametrize("cfg", [BENCH, CONT_LOSSY], ids=["bench", "cont-lossy"])
def test_port_matches_jax_integrate_interval(cfg):
    """Interval by interval against adder_tpu's integrate_interval (run
    eagerly on the CPU): slots exact, every state field exact."""
    kp, pp = K.TranscodeParams(**cfg), P.TranscodeParams(**cfg)
    N, T = 96, 6
    frames = testing.walk_frames(3, T, N)
    c0 = 0 if cfg is BENCH else 4
    js = K.set_initial_d(
        K.init_state(N, c_thresh=c0), jnp.asarray(frames[0].astype(np.int32))
    )
    ts = convert.state_from_numpy(js, "cpu")
    n_events = 0
    for t in range(T):
        fv = frames[t]
        js, jd, jt, jm, _ = K.integrate_interval(
            js, jnp.asarray(fv.astype(np.float32)),
            jnp.asarray(fv.astype(np.int32)), jnp.float32(255.0), kp,
        )
        fvt = torch.from_numpy(fv.astype(np.int32))
        ts, td, tt, tm, _ = P.integrate_interval(
            ts, fvt.to(torch.float32), fvt, 255.0, pp
        )
        jm = np.asarray(jm)
        np.testing.assert_array_equal(jm, tm.numpy())
        np.testing.assert_array_equal(np.asarray(jd)[jm], td.numpy()[jm])
        np.testing.assert_array_equal(
            np.asarray(jt)[jm].astype(np.int64), tt.numpy()[jm]
        )
        n_events += int(jm.sum())
        got = convert.state_to_numpy(ts)
        for f in K.PixelState._fields:
            np.testing.assert_array_equal(np.asarray(getattr(js, f)), got[f],
                                          err_msg=f)
    assert n_events > N  # the scene made events beyond the first interval


def test_as_u32_saturates_like_rust():
    x = torch.tensor(
        [float("nan"), -1.0, -0.0, 0.9, 1.5, 2.0 ** 31, 2.0 ** 32,
         float("inf"), 3e38], dtype=torch.float32,
    )
    want = [0, 0, 0, 0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32 - 1, 2 ** 32 - 1]
    assert P._as_u32(x).tolist() == want
    assert [P.as_u32_scalar(float(v)) for v in x] == want


def test_pad_state_depth_and_roundtrip():
    st = P.init_state(10, "cpu", depth=6)
    st8 = P.pad_state_depth(st, 8)
    assert st8.node_d.shape == (8, 10)
    assert (st8.best_d[6:] == -1).all() and (st8.node_integ[6:] == 0).all()
    back = convert.state_from_numpy(convert.state_to_numpy(st8), "cpu")
    for a, b in zip(st8, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
