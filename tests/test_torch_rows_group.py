"""The grouping of the row route: `group_dvs_rows` and its plain version.

A lane chunk's rows are grouped before the walk: the rows of each pixel in
lane order (`order`, `row_start`, `n_active`) and each row's cells ranked in
(sub-step, raster pixel) order (`cell_gap`, `cell_tick`, `sub_start`). On
the card three kernels do it by counting (bitmaps and one look-back scan,
no sort); here, on the CPU, the plain version `group_dvs_rows_plain` is held
to an independent numpy definition (`testing.group_reference`: np.lexsort
on (pixel, lane), every cell ranked by (sub-step, pixel)) on the three key
forms (the 20-byte DVS key, the 8-byte key at pb 8, 19 and 20, the DAVIS
key with lanes up to 127) and the edge cases; the same cases run on the
card through the kernels in tests/test_torch_cuda.py. The edge carriers
(DAVIS lane 127, pixel 2^pb - 1 of an 8-byte carrier) go through the port's
plain row route against the JAX package, run as its own tests run it here:
`make_davis_event_interval` looped over the sub-steps, and the packed8
resident chunk in Pallas interpret mode. Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from adder_tpu.core.types import PixelMultiMode
from adder_tpu.ops import dvs_batch as JB
from adder_tpu.ops import fused_resident as JFR
from adder_tpu_torch import convert, testing
from adder_tpu_torch.ops import fused_resident as FR

import test_torch_davis as TD
import test_torch_dvs as TV
from test_torch_davis_rows import _jax_loop


@pytest.mark.parametrize("case", testing.ROW_GROUP_CASES)
def test_plain_grouping_equals_its_definition(case):
    """Every RowGroups field of the plain version (and of `group_dvs_rows`
    on CPU tensors, which runs it) equals the numpy definition."""
    assert testing.check_group_against_reference("cpu", case) == 0.0


@pytest.mark.parametrize("form", ["20", "8", "davis"])
def test_grouping_reads_only_the_key(form):
    """Two carriers of the same keys whose other bits differ (the on bits,
    gap_n's high bits, every other word) group alike."""
    lane, pix, T, _, n = testing.row_group_rows("shuffled DAVIS")
    if form != "davis":
        T, keep = 64, lane < 32
        lane, pix = lane[keep], pix[keep]
    got = []
    for seed in (1, 2):
        c, per_lane, pb = testing.group_keys_carrier(lane, pix, form, n, seed)
        got.append(FR.group_dvs_rows(c, T, per_lane, pb))
    for a, b in zip(*got):
        assert torch.equal(a[: len(lane) + 1], b[: len(lane) + 1])


@st.composite
def _unique_keys(draw):
    form = draw(st.sampled_from(["20", "8", "davis"]))
    n = draw(st.integers(1, 300))
    T = draw(st.integers(1, 128)) if form == "davis" else 2 * draw(
        st.integers(1, 64))
    lanes = T if form == "davis" else T // 2
    flat = draw(st.lists(st.integers(0, lanes * n - 1), min_size=1,
                         max_size=400, unique=True))
    lane, pix = np.divmod(np.asarray(flat, np.int64), n)
    return form, n, T, lane, pix


@settings(max_examples=80, deadline=None)
@given(_unique_keys())
def test_plain_grouping_on_random_unique_keys(keys):
    """Random unique (lane, pixel) keys in random order, any plane, group
    and form: the plain version equals the numpy definition."""
    form, n, T, lane, pix = keys
    c, per_lane, pb = testing.group_keys_carrier(lane, pix, form, n)
    want = testing.group_reference(lane, pix, T, per_lane, n)
    g = FR.group_dvs_rows_plain(c, T, per_lane, pb)
    E = len(lane)
    for field, a, b in zip(FR.RowGroups._fields, g, want):
        if field == "row_start":
            a, b = a[: E + 1], b[: E + 1]
        np.testing.assert_array_equal(a.numpy(), b, err_msg=field)


def test_davis_lane_127_matches_jax_event_loop():
    """A DAVIS group of 128 lanes whose rows reach lane 127 and the last
    pixel, through the port's plain row route (`davis_rows_resident` on CPU
    tensors) against JAX's `davis_event_interval` looped over the sub-steps
    of the same rows: events, counts, state, the overflow flag."""
    kp, pp = TD._params(PixelMultiMode.Collapse)
    n, T = 12 * 8, 128  # test_torch_davis's plane: one jit
    rng = np.random.default_rng(4)
    lane = np.concatenate([[127, 127, 126, 64, 63, 0],
                           rng.choice(np.arange(1, 126), 30)])
    pix = np.concatenate([[n - 1, 0, n - 1, n - 1, 5, n - 1],
                          rng.integers(0, n, 30)])
    keep = np.unique(lane * n + pix, return_index=True)[1]
    lane, pix = lane[np.sort(keep)], pix[np.sort(keep)]
    carrier = torch.from_numpy(testing.davis_rows(4, pix, lane))
    js = TD._jax_state(n)
    ts = convert.state_from_numpy(js, "cpu")
    planes = FR.build_davis_planes(T, n, *FR.unpack_davis_carrier(carrier))
    got = FR.davis_rows_resident(ts, carrier, T, pp)
    js, pd, tt, counts = _jax_loop(JB.make_davis_event_interval(kp), js,
                                   planes, n)
    assert counts[127] > 0 and sum(counts) > 0
    np.testing.assert_array_equal(got.per_interval.numpy(), counts)
    np.testing.assert_array_equal(got.pixd.numpy().view(np.uint32), pd)
    np.testing.assert_array_equal(got.t.numpy().view(np.uint32), tt)
    TD._assert_state_equal(js, got.state, skip=("overflow",))


def test_rows8_last_pixel_matches_pallas_packed8_kernel():
    """An 8-byte carrier of a 16 x 16 plane (pb 8) whose rows hold pixel
    2^pb - 1 in both lanes, through `dvs_rows8_resident_plain` against the
    TPU kernel's packed8 entry (Pallas interpret mode, blocks of 128
    pixels, the carrier decoded in-graph) and its host assembler: events,
    counts, flags and state."""
    kp, pp = TV._params(PixelMultiMode.Collapse)
    n, T = 16 * 16, 4
    pb = FR.pix_bits(n)
    assert n - 1 == (1 << pb) - 1
    plan = testing.lattice_plan(2, n, T // 2, density=1.0,
                                pixels=[n - 1, 0, 17, 128, 200],
                                flags=((1, 1), (1, 0), (0, 1)))
    rows, got_pb = FR.pack_dvs_plan8(plan, n, 20)
    assert got_pb == pb and (rows[0, :len(plan.pix)] & 0xFF == n - 1).any()
    fn = JFR.make_dvs_chunk_resident_packed8(kp, 19 * n * T, T, n, pb,
                                             pallas_block=128,
                                             interpret=True, depth=16)
    js = TV._jax_state(n)
    ts = convert.state_from_numpy(js, "cpu")
    js, bp, bt, total, per_interval, pmax, counts = fn(js, jnp.asarray(rows))
    total = int(total)
    rp, rt = JFR.assemble_resident_events(
        np.asarray(bp[:total]), np.asarray(bt[:total]), np.asarray(counts))
    got = FR.dvs_rows8_resident_plain(ts, torch.from_numpy(rows), T, pp,
                                      pb=pb)
    assert total == len(got.pixd) > 0
    assert (got.pixd.numpy().view(np.uint32) >> 8 == n - 1).any()
    np.testing.assert_array_equal(got.per_interval.numpy(),
                                  np.asarray(per_interval))
    np.testing.assert_array_equal(got.pixd.numpy().view(np.uint32), rp)
    np.testing.assert_array_equal(got.t.numpy().view(np.uint32), rt)
    assert int(got.pmax) == int(pmax)
    TV._assert_state_equal(js, got.state)


def test_rows_copy_plain_on_every_count_and_capacity():
    """The copy's plain version (and `rows_copy` on CPU tensors) against a
    numpy copy of a slot-major staging with 0 to ROW_SLOTS events a cell,
    at capacities that fall inside a cell, between cells, at none and past
    the total."""
    assert testing.check_rows_copy_counts("cpu") == 0.0
