"""The port's lane chunks by rows, DAVIS and raster, against the JAX package.

`davis_rows_resident` takes the (5, E) carrier that the JAX package's
`make_davis_chunk_resident_packed` takes; the chunks of one row per pixel in
raster order (the Prophesee bootstrap and flush, DAVIS's frame and the gap
to it) run at T = 2 through `dvs_rows_resident` with a grouping known
without a sort. Inputs are made from numpy seeds; every comparison is bit
for bit (tolerance 0). The JAX side runs as its own tests run it here:
`make_davis_event_interval` (one jit per parameter set) and
`masked_interval`. The CUDA kernels are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py; here their grouping and their
plain versions run on CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adder_tpu.core.types import PixelMultiMode
from adder_tpu.ops import dvs_batch as JB
from adder_tpu.ops import integrate as K
from adder_tpu_torch import convert, testing
from adder_tpu_torch.ops import dvs_batch as B
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.ops import integrate as P
from adder_tpu_torch.transcoder import lanes
from adder_tpu_torch.transcoder.davis import frame_carrier
from adder_tpu_torch.transcoder.prophesee import bootstrap_carrier

from test_torch_davis import MULTI, _assert_state_equal, _jax_state, _params


def _jax_loop(fn, js, planes, n):
    """JAX's `davis_event_interval` over the sub-steps of dense planes,
    each compacted with `_compact_interval`: (state, pixd, t, counts)."""
    fi, dt, fval, fvw = (x.numpy() for x in planes)
    pd, tt, counts = [], [], []
    for i in range(fi.shape[0]):
        js, sd, stt, sm = fn(js, jnp.asarray(fi[i]), jnp.asarray(dt[i]),
                             jnp.asarray(fval[i]), jnp.asarray(fvw[i] & 0xFF),
                             jnp.asarray(((fvw[i] >> 8) & 1) != 0))
        p_i, t_i, n_i = K._compact_interval(sd, stt, sm, 19 * n)
        n_i = int(n_i)
        pd.append(np.asarray(p_i[:n_i]))
        tt.append(np.asarray(t_i[:n_i]))
        counts.append(n_i)
    return js, np.concatenate(pd), np.concatenate(tt), counts


@pytest.mark.parametrize("multi", MULTI, ids=lambda m: m.name)
def test_davis_rows_match_jax_event_loop(multi):
    """Two chained lane groups, each as its carrier from the port's planner,
    through the row wrapper on CPU tensors (its plain version, the state
    updated in place) against JAX's `davis_event_interval` looped over the
    sub-steps of `build_davis_planes` of the same rows: events, counts,
    state, the overflow flag."""
    kp, pp = _params(multi)
    w, h, lanes_per_group = 12, 8, 4  # test_torch_davis's plane: one jit
    n = w * h
    plan = testing.davis_plan(3, w, h, 2 * lanes_per_group)
    js = _jax_state(n)
    ts = convert.state_from_numpy(js, "cpu")
    fn = JB.make_davis_event_interval(kp)
    for g in range(2):
        carrier = testing.davis_group_carrier(
            plan, g * lanes_per_group, (g + 1) * lanes_per_group, "cpu")
        planes = FR.build_davis_planes(lanes_per_group, n,
                                       *FR.unpack_davis_carrier(carrier))
        ov0 = int(js.overflow)
        got = FR.davis_rows_resident(ts, carrier, lanes_per_group, pp)
        assert all(a is b for a, b in zip(got.state, ts))
        js, pd, tt, counts = _jax_loop(fn, js, planes, n)
        np.testing.assert_array_equal(got.per_interval.numpy(), counts)
        np.testing.assert_array_equal(got.pixd.numpy().view(np.uint32), pd)
        np.testing.assert_array_equal(got.t.numpy().view(np.uint32), tt)
        assert (int(got.pmax) >> 16) & 1 == int(int(js.overflow) > ov0)
        _assert_state_equal(js, got.state, skip=("overflow",))
        assert sum(counts) > 0


def _davis_planned(n):
    return FR.pack_davis_plan(testing.davis_plan(7, 9, 7, 6).lane_slice(0, 6))


def _davis_one_pixel(n):
    return testing.davis_rows(1, np.full(40, n // 2),
                              np.random.default_rng(1).permutation(40))


def _davis_unsorted_inactive(n):
    rng = np.random.default_rng(2)
    pix = np.concatenate([rng.permutation(n)[:20] for _ in range(5)])
    return testing.davis_rows(2, pix, np.repeat(np.arange(5), 20),
                              active=rng.random(100) < 0.7)


DAVIS_GLUE_CASES = {
    "empty": (lambda n: np.zeros((5, 0), np.int32), 3),
    "planned": (_davis_planned, 6),
    "one-pixel-40-lanes": (_davis_one_pixel, 40),
    "unsorted-inactive": (_davis_unsorted_inactive, 5),
}


@pytest.mark.parametrize("case", DAVIS_GLUE_CASES)
def test_davis_glue_ranks_rows_in_lane_pixel_order(case):
    """The glue with one sub-step per lane (plain version, CPU tensors)
    against an independent numpy ranking: each row's cell is its rank in
    (lane, pixel) order, each lane's first cell its number of rows in the
    lanes before it, and each pixel's run its rows in lane order."""
    make, T = DAVIS_GLUE_CASES[case]
    n = 63
    rows = make(n)
    E = rows.shape[1]
    pix, lane = rows[0] & 0xFFFFF, (rows[0] >> 20) & 0x7F
    g = FR.group_dvs_rows(torch.from_numpy(rows), T, per_lane=1)
    assert all(x.dtype == torch.int64 for x in g)
    rank = np.empty(E, np.int64)
    rank[np.lexsort((pix, lane))] = np.arange(E)
    np.testing.assert_array_equal(g.cell_gap.numpy(), rank)
    assert g.cell_tick.numel() == 0
    np.testing.assert_array_equal(
        g.sub_start.numpy(),
        np.concatenate([[0], np.cumsum(np.bincount(lane, minlength=T))]))
    by_pixel = np.lexsort((lane, pix))
    np.testing.assert_array_equal(g.order.numpy(), by_pixel)
    heads = np.flatnonzero(np.diff(pix[by_pixel], prepend=-1) != 0)
    assert int(g.n_active) == len(heads)
    np.testing.assert_array_equal(g.row_start.numpy()[:len(heads)], heads)
    assert (g.row_start.numpy()[len(heads):E + 1] == E).all()  # then scratch


def _gap_rows_of_mask(n, seed, frac):
    rng = np.random.default_rng(seed)
    pix = np.flatnonzero(rng.random(n) < frac)
    last_val = rng.uniform(0.0, 255.0, len(pix))
    dt = rng.integers(1, 5000, len(pix)).astype(np.float64) * 20
    return lanes.gap_rows(pix, last_val.astype(np.int64), last_val * dt, dt)


RASTER_CASES = {
    "bootstrap": lambda n: bootstrap_carrier(n, 20, "cpu").numpy(),
    "partial-mask": lambda n: _gap_rows_of_mask(n, 4, 0.4),
    "one-pixel": lambda n: lanes.gap_rows([n - 1], [7], [3.0], [20.0]),
    "frame": lambda n: frame_carrier(
        torch.arange(n, dtype=torch.uint8), 255, 2550.0).numpy(),
}


@pytest.mark.parametrize("case", RASTER_CASES)
def test_raster_row_groups_equal_the_glue(case):
    """`raster_row_groups` of a raster carrier (one row per pixel of a
    mask, ascending, lane 0) equals what the glue's plain version makes of
    it, field by field (the scratch slot of row_start aside)."""
    n = 63
    rows = torch.from_numpy(np.ascontiguousarray(RASTER_CASES[case](n)))
    E = rows.shape[1]
    assert E > 0 and ((rows[0] >> 20) & 0x7F == 0).all()
    want = FR.group_dvs_rows_plain(rows, 2)
    got = FR.raster_row_groups(E, "cpu")
    for field, a, b in zip(want._fields, got, want):
        if field == "row_start":
            a, b = a[: E + 1], b[: E + 1]
        assert torch.equal(a, b), field


def test_frame_carrier_equals_the_host_build():
    """`frame_carrier`'s torch code on CPU tensors against the rows the
    host builds from the same frame in numpy f64, as the frame chunk was
    built before it moved to the device: bit for bit; and its plain chunk
    equals JAX's `masked_interval` over the old dense planes."""
    rng = np.random.default_rng(8)
    n, ref = 77, 255
    frame = rng.integers(0, 256, n, dtype=np.uint8)
    for exposure_us in (1, 9_973, 10_000):
        dt_ticks = max(exposure_us, 1) * (255_000_000 / 1e6)
        got = frame_carrier(torch.from_numpy(frame), ref, dt_ticks)
        fv = frame.astype(np.int64)
        inten = (fv.astype(np.float64) / ref * dt_ticks).astype(np.float32)
        want = np.zeros((5, n), np.int32)
        want[0] = np.arange(n) | 1 << 27
        want[1] = fv
        want[2] = inten.view(np.int32)
        want[3] = np.full(n, dt_ticks, np.float32).view(np.int32)
        np.testing.assert_array_equal(got.numpy(), want)
    kp, pp = _params(PixelMultiMode.Collapse)
    js = _jax_state(n)
    res = FR.dvs_rows_resident_plain(convert.state_from_numpy(js, "cpu"),
                                     got, 2, pp)
    js, sd, st, sm, _ = JB.masked_interval(
        js, jnp.asarray(inten), jnp.asarray(fv.astype(np.int32)),
        jnp.asarray(np.full(n, dt_ticks, np.float32)),
        jnp.asarray(np.ones(n, bool)), kp)
    p_i, t_i, n_i = K._compact_interval(sd, st, sm, 19 * n)
    n_i = int(n_i)
    np.testing.assert_array_equal(res.per_interval.numpy(), [n_i, 0])
    np.testing.assert_array_equal(res.pixd.numpy().view(np.uint32),
                                  np.asarray(p_i[:n_i]))
    np.testing.assert_array_equal(res.t.numpy().view(np.uint32),
                                  np.asarray(t_i[:n_i]))
    _assert_state_equal(js, res.state, skip=("overflow",))


def _dvs_plan_keys():
    w, h = 16, 12
    n = w * h
    ts, xs, ys, ps = testing.dvs_stream(4, w, h, 50_000, n_hot=3,
                                        hot_events=90, background_events=4 * n)
    plan = B.plan_dvs_compact(ts, xs, ys, ps, w, np.full(n, 2, np.uint32),
                              np.full(n, np.log1p(128.0 / 255.0)), 0.02, 20)
    return FR.pack_dvs_plan(plan)


def _davis_plan_keys():
    return FR.pack_davis_plan(testing.davis_plan(4, 16, 12, 90))


@pytest.mark.parametrize("planner", [_dvs_plan_keys, _davis_plan_keys],
                         ids=["dvs", "davis"])
def test_planner_keys_are_unique_per_lane_and_pixel(planner):
    """The glue's sort keys (lane << 20 | pix, the low 27 bits of row 0) are
    unique across a whole plan of many lanes: the CUDA `torch.sort` is not
    stable, so the grouping relies on it."""
    rows = planner()
    keys = rows[0] & 0x7FFFFFF
    assert len(keys) > 300 and ((keys >> 20) > 64).any()
    assert len(np.unique(keys)) == len(keys)


def test_davis_rows_update_the_callers_state_in_place():
    """As the docstring says: the result's state is the caller's, updated in
    place; only the pixels with active rows change (a pixel whose rows are
    all inactive keeps its values); a clone made first keeps the old state;
    the plain version leaves its input alone."""
    _, pp = _params(PixelMultiMode.Collapse)
    n = 35
    pix = np.array([0, 2, 4, 6, 8, 2, 4, 10])
    lane = np.array([0, 0, 0, 0, 0, 1, 1, 0])
    active = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)  # pixel 10: inactive
    carrier = torch.from_numpy(testing.davis_rows(5, pix, lane, active))
    st = P.init_state(n, "cpu", c_thresh=3, depth=16)
    old = FR.clone_state(st)
    want = FR.davis_rows_resident_plain(st, carrier, 2, pp)
    assert testing.state_max_err(st, old, "plain leaves its input") == 0.0
    got = FR.davis_rows_resident(st, carrier, 2, pp)
    assert all(a is b for a, b in zip(got.state, st))
    assert testing.compare_chunks(got, want, "in place") == 0.0
    changed = torch.tensor(sorted(set(pix[active].tolist())))
    assert not torch.equal(st.running_t[changed], old.running_t[changed])
    untouched = torch.tensor([q for q in range(n) if q not in changed])
    for f in FR._KERNEL_FIELDS:
        assert torch.equal(getattr(st, f)[..., untouched],
                           getattr(old, f)[..., untouched]), f
    void = FR.davis_rows_resident(FR.clone_state(old), carrier, 2, pp,
                                  events=False)
    assert void.pixd is None
    assert testing.state_max_err(void.state, want.state, "void") == 0.0
