"""The port's chunk function (adder_tpu_torch/ops/fused_resident.py) against
the JAX package's resident kernel (Pallas, interpret mode, plus its host
assembler) and its XLA chunk scan.

Shapes and parameters are those of tests/test_fused_resident.py (BLOCK 256,
N 512, T 3). Tolerances:
- against the XLA scan: exact (events, counts, every state field but
  `overflow`, which the resident kernels pass through unchanged);
- against the interpret-mode resident kernel: events and counts exact;
  event t and state exact except the FMA-tie class documented in
  tests/test_fused_resident.py:59-75 (at most 1% of elements may differ,
  by at most one tick or one ulp), because the interpret graph and XLA may
  contract a product and a sum differently on rounding near-ties.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adder_tpu.core.types import Mode, PixelMultiMode, TimeMode
from adder_tpu.ops import fused_resident as JFR
from adder_tpu.ops import integrate as K
from adder_tpu_torch import convert, testing
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.ops import integrate as P

BLOCK = 256
N = BLOCK * 2
T = 3

MODE_CASES = [
    (Mode.FramePerfect, PixelMultiMode.Collapse, TimeMode.AbsoluteT),
    (Mode.Continuous, PixelMultiMode.Collapse, TimeMode.AbsoluteT),
]
IDS = [f"{m.name}-{u.name}-{t.name}" for m, u, t in MODE_CASES]


def _params(mode, multi, tm):
    cfg = dict(mode=int(mode), multi_mode=int(multi), time_mode=int(tm),
               ref_time=255, delta_t_max=255 * 4)
    return K.TranscodeParams(**cfg), P.TranscodeParams(**cfg)


def _frames(rng, t=T, n=N):
    frames = rng.integers(0, 256, (t, n)).astype(np.uint8)
    frames[:, : n // 4] = 128  # static region: empty block-intervals
    return frames


def _jax_state(frames, depth=K.DEPTH):
    return K.set_initial_d(
        K.init_state(frames.shape[1], depth=depth),
        jnp.asarray(frames[0].astype(np.int32)),
    )


def _port_chunk(st, frames, pp, fn=FR.fused_chunk_resident_plain):
    return fn(st, torch.from_numpy(frames), 255.0, pp)


# The fetched chunk's wrapper at a capacity no chunk of N x T exceeds
_fetched = functools.partial(FR.fused_chunk_resident,
                             event_cap=P.K_SLOTS * N * T)


def _u32(x):
    return x.numpy().view(np.uint32)


def _assert_fma_tie_only(a, b):
    """Exact, except <= 1% of elements differing by one ulp / one tick."""
    a, b = np.asarray(a), np.asarray(b)
    if np.array_equal(a, b):
        return
    if a.dtype == np.float32:
        tie = np.abs(a - b) <= np.spacing(np.maximum(np.abs(a), np.abs(b)))
    else:
        tie = np.abs(a.astype(np.int64) - b.astype(np.int64)) <= 1
    frac = float((a != b).mean())
    assert tie.all() and frac <= 0.01, f"non-tie mismatch: frac={frac}"


@pytest.mark.parametrize("mode,multi,tm", MODE_CASES, ids=IDS)
def test_plain_matches_resident_kernel(mode, multi, tm):
    kp, pp = _params(mode, multi, tm)
    frames = _frames(np.random.default_rng(7))
    cap = K.K_SLOTS * N * T * 4
    js = _jax_state(frames)
    fn = JFR.make_fused_chunk_resident(kp, cap, 4, pallas_block=BLOCK,
                                       interpret=True)
    ref = fn(js, jnp.asarray(frames), jnp.float32(255.0),
             jnp.zeros((N,), jnp.uint8))
    total = int(ref[6])
    rp, rt = JFR.assemble_resident_events(
        np.asarray(ref[1][:total]), np.asarray(ref[2][:total]),
        np.asarray(ref[10]),
    )
    got = _port_chunk(convert.state_from_numpy(js, "cpu"), frames, pp)

    assert int(ref[9]) & 0xFFFF <= 4  # no pixel outgrew the 4 packed lanes
    assert len(got.pixd) == total > 0
    np.testing.assert_array_equal(got.per_interval.numpy(), np.asarray(ref[7]))
    np.testing.assert_array_equal(_u32(got.pixd), rp)
    _assert_fma_tie_only(rt, _u32(got.t))
    assert int(got.pmax) & 0xFFFF == int(ref[9]) & 0xFFFF
    port = convert.state_to_numpy(got.state)
    for f in K.PixelState._fields[:-1]:
        _assert_fma_tie_only(np.asarray(getattr(ref[0], f)), port[f])


@pytest.mark.parametrize("mode,multi,tm", MODE_CASES, ids=IDS)
def test_plain_matches_xla_chunk_two_chunks(mode, multi, tm):
    """Two chained chunks against make_transcode_chunk: exact."""
    kp, pp = _params(mode, multi, tm)
    rng = np.random.default_rng(13)
    f1, f2 = _frames(rng), _frames(rng)
    cap = K.K_SLOTS * N * T
    fn = K.make_transcode_chunk(kp, cap, K.K_SLOTS)
    run0 = jnp.zeros((N,), jnp.uint8)
    js = _jax_state(f1)
    ts = convert.state_from_numpy(js, "cpu")
    for frames in (f1, f2):
        ref = fn(js, jnp.asarray(frames), jnp.float32(255.0), run0)
        js = ref[0]
        got = _port_chunk(ts, frames, pp)
        ts = got.state
        total = int(ref[6])
        assert len(got.pixd) == total
        np.testing.assert_array_equal(_u32(got.pixd),
                                      np.asarray(ref[1][:total]))
        np.testing.assert_array_equal(_u32(got.t), np.asarray(ref[2][:total]))
        np.testing.assert_array_equal(got.per_interval.numpy(),
                                      np.asarray(ref[7]))
        port = convert.state_to_numpy(ts)
        for f in K.PixelState._fields[:-1]:
            np.testing.assert_array_equal(np.asarray(getattr(js, f)), port[f],
                                          err_msg=f)


def test_forced_depth6_overflow_sets_flag():
    pp = P.TranscodeParams(ref_time=255, delta_t_max=255 * 24,
                           c_thresh_max=0, c_increase_velocity=1)
    rng = np.random.default_rng(5)
    frames = rng.integers(1, 256, (T, N)).astype(np.uint8)
    st = testing.forced_overflow_state(torch.from_numpy(frames[0]), 40)
    for fn in (FR.fused_chunk_resident_plain, FR.group_chunk_resident_plain):
        res = _port_chunk(st, frames, pp, fn)
        assert (int(res.pmax) >> 16) & 1
        assert int(res.state.overflow) == 0  # passed through, not counted
        deep = _port_chunk(P.pad_state_depth(st, 8), frames, pp, fn)
        assert not (int(deep.pmax) >> 16) & 1
    # no forced pixels, no flag
    clean = _port_chunk(
        testing.forced_overflow_state(torch.from_numpy(frames[0]), 0),
        frames, pp,
    )
    assert not (int(clean.pmax) >> 16) & 1


@pytest.mark.parametrize("depth", [6, 8])
def test_void_pass_equals_write_pass(depth):
    """The Empty-sink chunk (the kernel without its staging) gives the
    fetched chunk's state, counts, total and flags, through the wrappers;
    the total counts the fetched chunk's events."""
    rng = np.random.default_rng(11)
    frames = _frames(rng)
    for mode, multi, tm in MODE_CASES:
        _, pp = _params(mode, multi, tm)
        st = P.set_initial_d(P.init_state(N, "cpu", depth=depth),
                             torch.from_numpy(frames[0].astype(np.int32)))
        w = _port_chunk(st, frames, pp, _fetched)
        v = _port_chunk(st, frames, pp, FR.group_chunk_resident)
        assert v.pixd is None and v.t is None
        assert torch.equal(w.per_interval, v.per_interval)
        assert int(w.per_interval.sum()) == len(w.pixd) == len(w.t)
        assert int(v.total) == int(w.total) == len(w.pixd)
        assert int(w.pmax) == int(v.pmax)
        for a, b in zip(w.state, v.state):
            assert torch.equal(a, b)


def test_wrappers_run_plain_on_cpu_tensors():
    _, pp = _params(*MODE_CASES[0])
    frames = _frames(np.random.default_rng(2))
    st = P.set_initial_d(P.init_state(N, "cpu", depth=6),
                         torch.from_numpy(frames[0].astype(np.int32)))
    FR.reset_launch_counts()
    w = _port_chunk(st, frames, pp, _fetched)
    v = _port_chunk(st, frames, pp, FR.group_chunk_resident)
    ref = _port_chunk(st, frames, pp)
    assert set(FR.LAUNCHES.values()) == {0}
    assert torch.equal(w.pixd, ref.pixd) and torch.equal(w.t, ref.t)
    assert torch.equal(v.per_interval, ref.per_interval)
    counts = torch.from_numpy(
        np.random.default_rng(0).integers(0, 50, (5, 7)).astype(np.int32)
    )
    scan = FR.exclusive_scan(counts).numpy()
    flat = counts.numpy().reshape(-1).astype(np.int64)
    np.testing.assert_array_equal(scan[:-1], np.cumsum(flat) - flat)
    assert scan[-1] == flat.sum()


def test_kernel_check_harness_runs_on_cpu():
    """chip_smoke.py's kernel-against-plain check, on CPU tensors (where
    both sides are the plain version): the harness itself runs clean, its
    extra chunks (one interval; a ragged plane) and the capacity overflow
    included."""
    assert testing.check_kernels_against_plain(
        "cpu", H=5, W=7, T=3, extra=((3, 5, 1), (4, 9, 4))) == 0.0


# --- the segment copy: staged events back into reference order ------------


@pytest.fixture(scope="module")
def copy_cases():
    return {name: (res, n) for name, res, n in testing.segment_copy_cases()}


@pytest.mark.parametrize("slab", ["largest segment", "kernel"])
@pytest.mark.parametrize("case", ["walk", "no events", "every pixel fires"])
def test_segment_copy_plain_restores_reference_order(copy_cases, case, slab):
    """The plain chunk's events, staged in slabs taken by the warps in a
    shuffled order (as the one-pass kernel's atomics hand them out), come
    back from `segment_copy_plain` in exactly the plain chunk's order, on a
    47 x 61 plane whose last warp holds 19 pixels. With slabs as small as
    the largest segment most segments run over into a second slab."""
    res, n = copy_cases[case]
    counts = testing.segment_counts(res, n)
    assert counts.shape == (2 if case == "no events" else 8, 90)
    size = max(int(counts.max()), 1) if slab != "kernel" else (
        FR.slab_entries(6))
    stage, seg_start, counts_t, link = testing.stage_segments(res, n, size,
                                                              seed=3)
    total = int(res.total)
    assert (total == 0) == (case == "no events")
    if case == "every pixel fires":
        assert (counts[1:] > 0).all()  # every warp, every interval
    if case == "walk" and slab != "kernel":
        assert (link >= 0).sum() > 10  # segments that run over
    offsets = FR.exclusive_scan_plain(counts_t)
    flags = torch.zeros(3, dtype=torch.int32)
    pixd, t = FR.segment_copy(stage, seg_start, counts_t, offsets, link,
                              size, total, flags)
    assert torch.equal(pixd, res.pixd) and torch.equal(t, res.t)
    # a smaller capacity keeps the prefix; a staging overflow writes nothing
    half = total // 2
    pixd, t = FR.segment_copy_plain(stage, seg_start, counts_t, offsets,
                                    link, size, half, flags)
    assert torch.equal(pixd, res.pixd[:half]) and torch.equal(t, res.t[:half])
    flags[2] = 1
    pixd, _ = FR.segment_copy_plain(stage, seg_start, counts_t, offsets, link,
                                    size, total, flags)
    assert not pixd.any()


def test_staging_order_is_shuffled(copy_cases):
    """The staging the copy tests start from is not the reference order:
    the seeded interleaving of the warps moves segments apart."""
    res, n = copy_cases["walk"]
    stage, _, _, _ = testing.stage_segments(res, n, 64, seed=3)
    staged = stage[stage >= 0].view(torch.int32).view(-1, 2)[:, 0]
    assert len(staged) == len(res.pixd)
    assert not torch.equal(staged, res.pixd)
    assert torch.equal(staged.sort().values, res.pixd.sort().values)


def test_segment_copy_check_harness_runs_on_cpu():
    """chip_smoke.py's segment-copy check, on CPU tensors."""
    assert testing.check_segment_copy_against_plain("cpu") == 0.0


def test_capacity_overflow_keeps_the_total():
    """A chunk whose every pixel fires, given too small a capacity: the
    total stays exact (the harness of the card's check, on the CPU), and
    the plain version's total is its events."""
    assert testing.check_capacity_overflow("cpu", H=15, W=20) == 0.0
    n, T = 15 * 20, 32
    frames = torch.from_numpy(testing.firing_frames(T, n))
    st = P.set_initial_d(P.init_state(n, "cpu", c_thresh=0, depth=6),
                         frames[0].to(torch.int32))
    pp = P.TranscodeParams(mode=1, multi_mode=0, time_mode=1, ref_time=255,
                           delta_t_max=255, c_thresh_max=0,
                           c_increase_velocity=1)
    res = FR.fused_chunk_resident(st, frames, 255.0, pp, event_cap=n)
    assert int(res.total) == len(res.pixd) > n  # past the capacity


# --- the display output (emit_running) ---------------------------------------

VIEW_MODES = [0, 1, 2, 3]  # Intensity, D, DeltaT, SAE


def _display_params(view_mode):
    """Continuous / Collapse / AbsoluteT with the view mode under test."""
    cfg = dict(mode=int(Mode.Continuous),
               multi_mode=int(PixelMultiMode.Collapse),
               time_mode=int(TimeMode.AbsoluteT), ref_time=255,
               delta_t_max=255 * 4, view_mode=view_mode)
    return K.TranscodeParams(**cfg), P.TranscodeParams(**cfg)


def _run0(seed=3):
    return np.random.default_rng(seed).integers(0, 256, N, dtype=np.uint8)


@pytest.mark.parametrize("view_mode", VIEW_MODES)
def test_plain_runnings_match_xla_chunk(view_mode):
    """Two chained chunks from a non-zero display frame: the plain
    version's display frames (fetched and Empty-sink) equal
    make_transcode_chunk's exactly."""
    kp, pp = _display_params(view_mode)
    rng = np.random.default_rng(17)
    f1, f2 = _frames(rng), _frames(rng)
    fn = K.make_transcode_chunk(kp, K.K_SLOTS * N * T, K.K_SLOTS)
    js = _jax_state(f1)
    ts = convert.state_from_numpy(js, "cpu")
    run_j = jnp.asarray(_run0())
    run_t = torch.from_numpy(_run0())
    for frames in (f1, f2):
        ref = fn(js, jnp.asarray(frames), jnp.float32(255.0), run_j)
        got = FR.fused_chunk_resident_plain(ts, torch.from_numpy(frames),
                                            255.0, pp, run_t)
        void = FR.group_chunk_resident_plain(ts, torch.from_numpy(frames),
                                             255.0, pp, run_t)
        want = np.asarray(ref[8])
        assert got.runnings.shape == (T, N)
        np.testing.assert_array_equal(got.runnings.numpy(), want)
        np.testing.assert_array_equal(void.runnings.numpy(), want)
        assert (want != np.asarray(run_j)[None]).any()  # the frame moved
        js, ts = ref[0], got.state
        run_j, run_t = ref[8][-1], got.runnings[-1]


@pytest.mark.parametrize("view_mode", VIEW_MODES)
def test_plain_runnings_match_resident_kernel(view_mode):
    """Two chained chunks from a non-zero display frame against the JAX
    resident kernel with emit_running (Pallas, interpret mode): the display
    frames equal within the FMA-tie class of the module docstring, the
    events exactly."""
    kp, pp = _display_params(view_mode)
    rng = np.random.default_rng(19)
    f1, f2 = _frames(rng), _frames(rng)
    fn = JFR.make_fused_chunk_resident(kp, K.K_SLOTS * N * T * 4, 4,
                                       pallas_block=BLOCK, interpret=True,
                                       emit_running=True)
    js = _jax_state(f1)
    ts = convert.state_from_numpy(js, "cpu")
    run_j = jnp.asarray(_run0(5))
    run_t = torch.from_numpy(_run0(5))
    for frames in (f1, f2):
        ref = fn(js, jnp.asarray(frames), jnp.float32(255.0), run_j)
        got = FR.fused_chunk_resident_plain(ts, torch.from_numpy(frames),
                                            255.0, pp, run_t)
        total = int(ref[6])
        assert int(ref[9]) & 0xFFFF <= 4  # no pixel outgrew the 4 lanes
        rp, _ = JFR.assemble_resident_events(
            np.asarray(ref[1][:total]), np.asarray(ref[2][:total]),
            np.asarray(ref[10]))
        np.testing.assert_array_equal(_u32(got.pixd), rp)
        _assert_fma_tie_only(np.asarray(ref[8]), got.runnings.numpy())
        js, ts = ref[0], got.state
        run_j, run_t = ref[8][-1], got.runnings[-1]


def test_run0_guard_and_no_display_without_it():
    _, pp = _params(*MODE_CASES[0])
    frames = torch.from_numpy(_frames(np.random.default_rng(4)))
    st = P.set_initial_d(P.init_state(N, "cpu", depth=6),
                         frames[0].to(torch.int32))
    assert _fetched(st, frames, 255.0, pp).runnings is None
    assert FR.group_chunk_resident(st, frames, 255.0, pp).runnings is None
    for bad in (torch.zeros(N, dtype=torch.int32),
                torch.zeros(N - 1, dtype=torch.uint8),
                torch.zeros((1, N), dtype=torch.uint8)):
        for fn in (_fetched, FR.group_chunk_resident):
            with pytest.raises(ValueError):
                fn(st, frames, 255.0, pp, bad)
    run0 = torch.zeros(N, dtype=torch.uint8)
    got = _fetched(st, frames, 255.0, pp, run0)
    want = FR.fused_chunk_resident_plain(st, frames, 255.0, pp)
    assert torch.equal(got.pixd, want.pixd)  # the display changes no event


def test_display_check_harness_runs_on_cpu():
    """chip_smoke.py's display-against-plain check, on CPU tensors, with
    small extra chunks."""
    assert testing.check_display_against_plain(
        "cpu", H=5, W=7, T=3, extra=((3, 5, 1), (4, 9, 4))) == 0.0
