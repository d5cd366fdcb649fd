"""The port's DVS lane groups by rows against the JAX package, on the CPU.

`dvs_rows_resident` takes the (5, E) carrier that the JAX package's
`make_dvs_chunk_resident_packed` takes. Inputs are made from numpy seeds and
go through both packages; every comparison is bit for bit (tolerance 0). The
JAX side runs as its own tests run it here: the Pallas kernel in interpret
mode, and `Prophesee(..., engine="scan")`. The grouping glue the CUDA row
kernel depends on runs here on CPU tensors; the kernel itself is checked on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adder_tpu.core.types import PixelMultiMode
from adder_tpu.ops import dvs_batch as JB
from adder_tpu.ops import fused_resident as JFR
from adder_tpu.ops import integrate as K
from adder_tpu.transcoder import prophesee as JP
from adder_tpu_torch import convert, testing
from adder_tpu_torch.ops import dvs_batch as B
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.ops import integrate as P
from adder_tpu_torch.transcoder import prophesee as TP

from test_torch_dvs import (MIDGREY_LN, MULTI, _assert_state_equal,
                            _jax_state, _params, _transcode,
                            open_file_decoder_bytes)


def _plan(seed, w, h, lanes, background=3):
    n = w * h
    ts, xs, ys, ps = testing.dvs_stream(seed, w, h, 50_000, n_hot=2,
                                        hot_events=2 * lanes + 4,
                                        background_events=background * n)
    return B.plan_dvs_compact(ts, xs, ys, ps, w, np.full(n, 2, np.uint32),
                              np.full(n, MIDGREY_LN), 0.02, 20)


@pytest.mark.parametrize("multi", MULTI, ids=lambda m: m.name)
def test_rows_plain_matches_jax_masked_loop(multi):
    """Two chained lane groups, each as its carrier: the plain rows chunk
    against JAX's `build_dvs_planes` of the same rows, `masked_interval`
    looped over the sub-steps and `_compact_interval` per sub-step (events,
    counts, state, the overflow flag)."""
    kp, pp = _params(multi)
    w, h, lanes = 9, 7, 4
    n, T = w * h, 2 * lanes
    plan = _plan(3, w, h, lanes)
    js = _jax_state(n)
    ts = convert.state_from_numpy(js, "cpu")
    for g in range(2):
        sl = plan.lane_slice(g * lanes, (g + 1) * lanes)
        got = FR.dvs_rows_resident_plain(
            ts, torch.from_numpy(FR.pack_dvs_plan(sl)), T, pp)
        inten, tspan, fvw = (np.asarray(x) for x in JFR.build_dvs_planes(
            T, n, *(jnp.asarray(getattr(sl, f)) for f in (
                "pix", "lane", "gap_on", "gap_fv", "gap_int", "gap_time",
                "tick_on", "tick_fv", "tick_int")), None, ref_time=20))
        ov0 = int(js.overflow)
        pd, tt, counts = [], [], []
        for i in range(T):
            js, sd, stt, sm, _ = JB.masked_interval(
                js, jnp.asarray(inten[i]), jnp.asarray(fvw[i] & 0xFF),
                jnp.asarray(tspan[i]), jnp.asarray(((fvw[i] >> 8) & 1) != 0),
                kp)
            p_i, t_i, n_i = K._compact_interval(sd, stt, sm, 19 * n)
            n_i = int(n_i)
            pd.append(np.asarray(p_i[:n_i]))
            tt.append(np.asarray(t_i[:n_i]))
            counts.append(n_i)
        np.testing.assert_array_equal(got.per_interval.numpy(), counts)
        np.testing.assert_array_equal(got.pixd.numpy().view(np.uint32),
                                      np.concatenate(pd))
        np.testing.assert_array_equal(got.t.numpy().view(np.uint32),
                                      np.concatenate(tt))
        assert (int(got.pmax) >> 16) & 1 == int(int(js.overflow) > ov0)
        _assert_state_equal(js, got.state, skip=("overflow",))
        ts = got.state
        assert sum(counts) > 0


@pytest.mark.parametrize("multi", [
    PixelMultiMode.Collapse,
    pytest.param(PixelMultiMode.Normal, marks=pytest.mark.slow),
], ids=lambda m: m.name)
def test_rows_plain_matches_pallas_packed_kernel(multi):
    """Two chained lane groups, each as its (5, E) carrier, through
    `dvs_rows_resident_plain` and through the TPU kernel's packed entry
    (make_dvs_chunk_resident_packed, Pallas interpret mode, 2 blocks of 128
    pixels) plus its host assembler: events, counts, flags and state."""
    kp, pp = _params(multi)
    w, h, lanes = 16, 16, 2
    n, T = w * h, 2 * lanes
    plan = _plan(5, w, h, lanes)
    fn = JFR.make_dvs_chunk_resident_packed(kp, 19 * n * T, T, n,
                                            pallas_block=128, interpret=True,
                                            depth=16)
    js = _jax_state(n)
    ts = convert.state_from_numpy(js, "cpu")
    for g in range(2):
        rows = FR.pack_dvs_plan(plan.lane_slice(g * lanes, (g + 1) * lanes))
        js, bp, bt, total, per_interval, pmax, counts = fn(js,
                                                           jnp.asarray(rows))
        total = int(total)
        rp, rt = JFR.assemble_resident_events(
            np.asarray(bp[:total]), np.asarray(bt[:total]),
            np.asarray(counts))
        got = FR.dvs_rows_resident_plain(ts, torch.from_numpy(rows), T, pp)
        assert total == len(got.pixd) > 0
        np.testing.assert_array_equal(got.per_interval.numpy(),
                                      np.asarray(per_interval))
        np.testing.assert_array_equal(got.pixd.numpy().view(np.uint32), rp)
        np.testing.assert_array_equal(got.t.numpy().view(np.uint32), rt)
        assert int(got.pmax) == int(pmax)
        _assert_state_equal(js, got.state)
        ts = got.state


def _one_pixel_64_lanes(n):
    return testing.synthetic_rows(1, n, 64, flags=((1, 1),), pixels=[n // 2])


def _every_pixel_one_row(n):
    return testing.synthetic_rows(2, n, 1, density=1.0, flags=((1, 1),))


def _halves_off_unsorted(n):
    return testing.synthetic_rows(3, n, 5)


GLUE_CASES = {
    "empty": (lambda n: np.zeros((5, 0), np.int32), 4),
    "one-pixel-64-lanes": (_one_pixel_64_lanes, 128),
    "every-pixel-one-row": (_every_pixel_one_row, 2),
    "halves-off-unsorted": (_halves_off_unsorted, 10),
    "planned": (lambda n: FR.pack_dvs_plan(_plan(7, 9, 7, 4).lane_slice(0, 4)),
                8),
}


@pytest.mark.parametrize("case", GLUE_CASES)
def test_row_groups_list_each_pixels_rows_in_lane_order(case):
    make, T = GLUE_CASES[case]
    n = 63
    rows = make(n)
    E = rows.shape[1]
    pix, lane = rows[0] & 0xFFFFF, (rows[0] >> 20) & 0x7F
    g = FR.group_dvs_rows(torch.from_numpy(rows), T)
    assert all(x.dtype == torch.int64 for x in g)
    order, start = g.order.numpy(), g.row_start.numpy()
    n_active = int(g.n_active)
    assert n_active == len(np.unique(pix))
    assert sorted(order.tolist()) == list(range(E))
    # run j ends at start[j + 1]; the last slot is the discarded one
    assert (start[n_active:-1] == E).all() and len(start) == E + 2
    seen = []
    for j in range(n_active):
        run = order[start[j]:start[j + 1]]
        assert len(run) > 0 and len(set(pix[run])) == 1
        assert (np.diff(lane[run]) > 0).all()  # lane order
        seen.append(int(pix[run[0]]))
    assert seen == sorted(set(pix.tolist()))  # raster order, each pixel once
    if case == "halves-off-unsorted":
        assert any((np.diff(pix[lane == k]) < 0).any() for k in range(5))


@pytest.mark.parametrize("case", GLUE_CASES)
def test_cell_ranks_place_every_event_of_the_plain_chunk(case):
    """The cell ranks, with the plain version's per-cell event counts and
    `exclusive_scan_plain`, give the position of every event in the plain
    version's output: what the rows copy relies on."""
    make, T = GLUE_CASES[case]
    n = 63
    rows = make(n)
    E = rows.shape[1]
    _, pp = _params(PixelMultiMode.Collapse)
    st = FR.dvs_chunk_resident_plain(
        P.init_state(n, "cpu", c_thresh=3, depth=16),
        *(torch.full((2, n), v, dtype=dt) for v, dt in
          ((128.0, torch.float32), (20.0, torch.float32),
           (128 | 1 << 8, torch.int32))), pp).state
    got = FR.dvs_rows_resident_plain(st, torch.from_numpy(rows), T, pp)
    g = FR.group_dvs_rows(torch.from_numpy(rows), T)
    pix, lane = rows[0] & 0xFFFFF, (rows[0] >> 20) & 0x7F
    # every cell once, ranked by (sub-step, pixel)
    cells = np.concatenate([g.cell_gap.numpy(), g.cell_tick.numpy()])
    sub = np.concatenate([2 * lane, 2 * lane + 1])
    assert sorted(cells.tolist()) == list(range(2 * E))
    by_rank = np.argsort(cells)
    keys = (sub[by_rank].astype(np.int64) << 20) | np.tile(pix, 2)[by_rank]
    assert (np.diff(keys) > 0).all()
    np.testing.assert_array_equal(
        g.sub_start.numpy(), np.searchsorted(sub[by_rank], np.arange(T + 1)))
    # the plain chunk's events, each with its sub-step and pixel
    ev_sub = np.repeat(np.arange(T), got.per_interval.numpy())
    ev_pix = got.pixd.numpy().view(np.uint32) >> 8
    cell_of = {(int(s), int(q)): int(c)
               for s, q, c in zip(sub, np.tile(pix, 2), cells)}
    counts = np.zeros(2 * E, np.int32)
    ev_cell = np.array([cell_of[(int(s), int(q))]
                        for s, q in zip(ev_sub, ev_pix)], np.int64)
    np.add.at(counts, ev_cell, 1)
    offsets = FR.exclusive_scan_plain(torch.from_numpy(counts)).numpy()
    assert offsets[-1] == len(ev_pix)
    at = np.arange(len(ev_pix))
    assert ((offsets[ev_cell] <= at) & (at < offsets[ev_cell + 1])).all()
    np.testing.assert_array_equal(
        np.diff(offsets[g.sub_start.numpy()]), got.per_interval.numpy())
    if case != "empty":
        assert len(ev_pix) > 0


def _walk_rows(state, rows, T, p):
    """The row kernel's walk, spelled out with the plain sub-step on one
    pixel at a time: for each pixel that has rows, its rows in `order`; per
    row the gap then the tick sub-step; each cell's events at its offset."""
    g = FR.group_dvs_rows(torch.from_numpy(rows), T)
    fields = [x.numpy() for x in
              FR.unpack_dvs_carrier(torch.from_numpy(rows))]
    pix, _, gap_on, gap_fv, gap_int, gap_time, tick_on, tick_fv, tick_int = \
        fields
    E = rows.shape[1]
    cell_events = [[] for _ in range(2 * E)]
    new = FR.clone_state(state)
    one = torch.ones(1, dtype=torch.bool)
    for j in range(int(g.n_active)):
        run = g.order[g.row_start[j]:g.row_start[j + 1]].tolist()
        q = int(pix[run[0]])
        s = P._S.unstack(P.PixelState(
            *(getattr(state, f)[..., q:q + 1].clone()
              for f in FR._KERNEL_FIELDS), overflow=state.overflow))
        for r in run:
            halves = ((gap_on[r], gap_int[r], gap_fv[r], gap_time[r],
                       g.cell_gap[r]),
                      (tick_on[r], tick_int[r], tick_fv[r],
                       np.float32(p.ref_time), g.cell_tick[r]))
            for on, inten, fv, span, cell in halves:
                if not on:
                    continue
                slots = B.masked_step(
                    s, torch.tensor([inten]), torch.tensor([int(fv)]),
                    torch.tensor([span]), one, p)
                cell_events[int(cell)] = [
                    ((q << 8) | (int(d) & 0xFF), int(t) & 0xFFFFFFFF)
                    for d, t, m in slots if bool(m)]
        after = s.restack()
        for f in FR._KERNEL_FIELDS:
            getattr(new, f)[..., q] = getattr(after, f)[..., 0]
    events = [e for c in cell_events for e in c]
    return new, events, g


@pytest.mark.parametrize("case", ["halves-off-unsorted", "planned"])
def test_row_walk_over_the_groups_equals_the_plain_chunk(case):
    make, T = GLUE_CASES[case]
    n = 63
    rows = make(n)
    _, pp = _params(PixelMultiMode.Normal)
    st = P.init_state(n, "cpu", c_thresh=3, depth=16)
    want = FR.dvs_rows_resident_plain(st, torch.from_numpy(rows), T, pp)
    new, events, g = _walk_rows(st, rows, T, pp)
    assert len(events) == len(want.pixd) > 0
    np.testing.assert_array_equal(
        np.array([e[0] for e in events], np.uint32),
        want.pixd.numpy().view(np.uint32))
    np.testing.assert_array_equal(
        np.array([e[1] for e in events], np.uint32),
        want.t.numpy().view(np.uint32))
    assert testing.state_max_err(new, want.state, "row walk") == 0.0


def _spy_rows(monkeypatch):
    """Record (T, E, whether a grouping was given) of each call of either
    DVS row wrapper (the 20-byte carrier's and the 8-byte one's, whose E
    leaves out the dictionary's columns)."""
    calls = []

    def spy(orig, rows):
        def f(state, carrier, T, p, events=True, groups=None, **kw):
            calls.append((T, rows(carrier), groups is not None))
            return orig(state, carrier, T, p, events=events, groups=groups,
                        **kw)
        return f

    monkeypatch.setattr(FR, "dvs_rows_resident",
                        spy(FR.dvs_rows_resident, lambda c: c.shape[1]))
    monkeypatch.setattr(FR, "dvs_rows8_resident",
                        spy(FR.dvs_rows8_resident,
                            lambda c: c.shape[1] - FR.DICT_CAP))
    return calls


def test_windowed_prophesee_through_rows_matches_jax_scan(tmp_path,
                                                          monkeypatch):
    """A windowed transcode (60 windows a second): every lane group, the
    bootstrap and the flush go through `dvs_rows_resident` (the bootstrap
    and the flush as T = 2 raster chunks with their grouping given, the
    groups through the glue), and the Raw bytes, chain state and depth-16
    state equal the JAX scan engine's."""
    w, h = 14, 10
    t, x, y, p = testing.dvs_stream(12, w, h, 50_000, n_hot=2,
                                    hot_events=30, background_events=200)
    path = str(tmp_path / "win.raw")
    testing.write_prophesee_raw(path, w, h, t, x, y, p)
    rows_calls = _spy_rows(monkeypatch)
    port = TP.Prophesee(20, path, device="cpu")
    got = _transcode(port)
    jax_src = JP.Prophesee(20, path, batched=True, engine="scan")
    want = _transcode(jax_src)
    assert got == want and len(got) > 1000
    raster = [c for c in rows_calls if c[2]]
    assert rows_calls[0] == (2, w * h, True)  # the bootstrap: every pixel
    assert rows_calls[-1][0] == 2 and rows_calls[-1][2]  # the flush
    assert len(raster) == 2 and 0 < rows_calls[-1][1] <= w * h
    assert len(rows_calls) >= 5
    np.testing.assert_array_equal(port.dvs_last_timestamps,
                                  jax_src.dvs_last_timestamps)
    np.testing.assert_array_equal(port.dvs_last_ln_val,
                                  jax_src.dvs_last_ln_val)
    _assert_state_equal(jax_src._dev_state, port.state)


def test_segmented_prophesee_through_rows_matches_jax_scan(tmp_path,
                                                           monkeypatch):
    """One window cut into segments of 100 events, a pixel of more than 64
    lanes in a segment: every group through `dvs_rows_resident` (T = 128
    among them), each pixel's stream, the chain state and the depth-16
    state equal the JAX scan engine's."""
    w, h = 14, 10
    t, x, y, p = testing.dvs_stream(9, w, h, 200_000, n_hot=1,
                                    hot_events=240, background_events=60)
    path = str(tmp_path / "seg.raw")
    testing.write_prophesee_raw(path, w, h, t, x, y, p)
    monkeypatch.setenv("ADDER_TPU_DVS_SEG_EVENTS", "100")
    rows_calls = _spy_rows(monkeypatch)
    port = TP.Prophesee(20, path, view_fps=1, device="cpu")
    got = open_file_decoder_bytes(_transcode(port))
    jax_src = JP.Prophesee(20, path, batched=True, view_fps=1, engine="scan")
    want = open_file_decoder_bytes(_transcode(jax_src))
    groups = [(T, E) for T, E, raster in rows_calls if not raster]
    assert max(T for T, _ in groups) == 128 and len(groups) > 3
    assert all(E > 0 for _, E in groups)
    assert [(T, raster) for T, _, raster in rows_calls if raster] == [
        (2, True), (2, True)]  # the bootstrap and the flush

    def streams(events):
        out = {}
        for xx, yy, d, tt in events:
            out.setdefault((xx, yy), []).append((d, tt))
        return out

    assert sorted(got) == sorted(want)
    assert streams(got) == streams(want)
    np.testing.assert_array_equal(port.dvs_last_timestamps,
                                  jax_src.dvs_last_timestamps)
    _assert_state_equal(jax_src._dev_state, port.state)


def test_rows_chunk_updates_the_callers_state_in_place():
    """As the docstring says: the result's state is the caller's, updated
    in place; pixels without rows keep their values; a clone made first
    keeps the old state; the plain version leaves its input alone."""
    _, pp = _params(PixelMultiMode.Collapse)
    n = 35
    rows = testing.synthetic_rows(4, n, 3, pixels=np.arange(0, n, 2))
    carrier = torch.from_numpy(rows)
    st = P.init_state(n, "cpu", c_thresh=3, depth=16)
    old = FR.clone_state(st)
    want = FR.dvs_rows_resident_plain(st, carrier, 6, pp)
    assert testing.state_max_err(st, old, "plain leaves its input") == 0.0
    got = FR.dvs_rows_resident(st, carrier, 6, pp)
    assert all(a is b for a, b in zip(got.state, st))
    assert testing.compare_chunks(got, want, "in place") == 0.0
    assert not torch.equal(st.running_t, old.running_t)
    untouched = torch.arange(1, n, 2)
    for f in FR._KERNEL_FIELDS:
        assert torch.equal(getattr(st, f)[..., untouched],
                           getattr(old, f)[..., untouched]), f
    void = FR.dvs_rows_resident(FR.clone_state(old), carrier, 6, pp,
                                events=False)
    assert void.pixd is None
    assert testing.state_max_err(void.state, want.state, "void") == 0.0


def test_rows_wrapper_runs_plain_on_cpu_tensors():
    _, pp = _params(PixelMultiMode.Normal)
    n = 35
    carrier = torch.from_numpy(testing.synthetic_rows(6, n, 2))
    st = P.init_state(n, "cpu", depth=16)
    FR.reset_launch_counts()
    want = FR.dvs_rows_resident_plain(st, carrier, 4, pp)
    got = FR.dvs_rows_resident(FR.clone_state(st), carrier, 4, pp)
    empty = FR.dvs_rows_resident(FR.clone_state(st),
                                 torch.zeros((5, 0), dtype=torch.int32), 4,
                                 pp)
    assert set(FR.LAUNCHES.values()) == {0} and "adder_dvs_rows" in FR.LAUNCHES
    assert testing.compare_chunks(got, want, "cpu") == 0.0
    assert len(empty.pixd) == 0 and int(empty.per_interval.sum()) == 0
    assert testing.state_max_err(empty.state, st, "no rows") == 0.0


def test_rows_and_scan_check_harnesses_run_on_cpu():
    """chip_smoke.py's rows-against-plain and scan-against-plain checks, on
    CPU tensors."""
    assert testing.check_dvs_rows_against_plain(
        "cpu", H=5, W=7, lanes=(1, 3)) == 0.0
    assert testing.check_scan_against_plain("cpu", sizes=(0, 1, 37, 4097)) == 0.0
