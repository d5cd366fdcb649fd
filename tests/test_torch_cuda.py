"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped without a GPU. This file imports no jax, so on a
machine without jax it runs with `python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py` (tests/conftest.py imports jax).
Tolerance: none; every comparison is bit for bit.
"""

import io

import numpy as np
import pytest
import torch

import adder_tpu_torch as at
from adder_tpu_torch import testing
from adder_tpu_torch.ops import fused_resident as FR
from adder_tpu_torch.utils.viz import ShowFeatureMode

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_kernels_match_plain_every_mode(cuda):
    assert testing.check_kernels_against_plain(cuda) == 0.0


def test_scan_matches_plain_past_int32(cuda):
    gen = torch.Generator(device="cpu").manual_seed(0)
    counts = torch.randint(0, 2816, (64, 24300), generator=gen,
                           dtype=torch.int32)
    got = FR.exclusive_scan(counts.to(cuda))
    want = FR.exclusive_scan_plain(counts)
    assert int(want[-1]) > 2 ** 31
    assert torch.equal(got.cpu(), want)


def test_scan_matches_plain_every_size(cuda):
    """The multi-block scan at 0, 1, 37, 4096, 4097, 129,600 and 524,288
    counts (the last with a total past 2^31), and on inputs that are not
    16-byte aligned."""
    FR.reset_launch_counts()
    assert testing.check_scan_against_plain(cuda) == 0.0
    assert FR.LAUNCHES["adder_exclusive_scan"] == 2 * len(testing.SCAN_SIZES)


def _raw_bytes(frames, device):
    src = at.FramedArray(frames, 30.0, chunk_frames=4, device=device)
    src.auto_time_parameters(255, 255 * 24, at.TimeMode.DeltaT)
    src.quality_manual(0, 0, 24, 1, 0)
    buf = io.BytesIO()
    src.write_out(at.SourceCamera.FramedU8, at.TimeMode.DeltaT,
                  at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                  at.EncoderOptions.default(src.video.plane), buf)
    while True:
        try:
            src.consume_batch()
        except EOFError:
            break
    src.video.end_write_stream()
    return buf.getvalue()


@pytest.mark.parametrize("channels", [1, 3])
def test_video_cuda_bytes_equal_cpu(cuda, channels):
    frames = testing.walk_frames(channels, 12, 33 * 17 * channels)
    frames = frames.reshape(12, 17, 33, channels)
    FR.reset_launch_counts()
    on_card = _raw_bytes(frames, cuda)
    # one pass, one segment copy and one record pack per chunk, x 3
    assert FR.LAUNCHES["adder_resident_chunk"] == 3
    assert FR.LAUNCHES["adder_segment_copy"] == 3
    assert FR.LAUNCHES["adder_wire_pack"] == 3
    assert on_card == _raw_bytes(frames, "cpu")
    assert len(on_card) > 1000


@pytest.mark.parametrize("C", [1, 3], ids=["mono", "color"])
def test_wire_pack_matches_plain_at_1080p(cuda, C):
    """`adder_wire_pack` against `wire_pack_plain` (run on the card), bit
    for bit, at 1080p: the Raw cell's 4.3 M events a chunk (no multiple of
    the kernel's block) drawn over the plane with the edges of every field
    first, and a chunk with no events, which launches nothing."""
    rng = np.random.default_rng(C)
    W, n, last = 1920, 4_300_001, 1920 * 1080 * C - 1
    pix = rng.integers(0, last + 1, n)
    d = rng.integers(0, 256, n)
    t = rng.integers(0, 2 ** 32, n)
    pix[:4], d[:4] = [0, last, last, 0], [0, 255, 0, 255]
    t[:4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    pixd = torch.from_numpy(((pix << 8) | d).astype(np.uint32).view(np.int32))
    tt = torch.from_numpy(t.astype(np.uint32).view(np.int32))
    pixd, tt = pixd.to(cuda), tt.to(cuda)
    FR.reset_launch_counts()
    for k in (n, 1025, 0):
        got = FR.wire_pack(pixd[:k], tt[:k], W, C)
        want = FR.wire_pack_plain(pixd[:k], tt[:k], W, C)
        assert got.is_cuda and got.numel() == k * (9 if C == 1 else 11)
        assert torch.equal(got, want), k
    assert FR.LAUNCHES["adder_wire_pack"] == 2


def test_video_cuda_writer_keeps_each_chunks_records(cuda):
    """On the card the records reach the writer in fresh pinned buffers: a
    writer that keeps every buffer still holds each chunk's bytes after the
    later chunks, and the events returned equal the CPU route's."""
    frames = testing.walk_frames(5, 16, 33 * 17 * 3).reshape(16, 17, 33, 3)
    plane = at.PlaneSize(33, 17, 3)
    runs = {}
    for dev in (cuda, "cpu"):
        kept, copies, events = [], [], []

        class Keep:
            def write(self, data):
                kept.append(data)
                copies.append(bytes(memoryview(data).cast("B")))

            def flush(self):
                pass

        v = at.Video(plane, at.Mode.FramePerfect, chunk_frames=4, device=dev)
        v.write_out(at.SourceCamera.FramedU8, at.TimeMode.AbsoluteT,
                    at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                    at.EncoderOptions.default(plane), Keep())
        for i in range(0, 16, 4):
            events.append(v.integrate_matrix_batch(frames[i:i + 4]))
        v.end_write_stream()
        assert all(bytes(memoryview(a).cast("B")) == b
                   for a, b in zip(kept, copies))
        runs[str(dev)] = (b"".join(copies), events)
    (on_card, ev_card), (on_cpu, ev_cpu) = runs.values()
    assert on_card == on_cpu and len(on_card) > 1000
    assert all(a == b for a, b in zip(ev_card, ev_cpu))


def test_segment_copy_matches_plain(cuda):
    """The segment copy kernel against its plain version on staging in
    shuffled slab order: a ragged plane, a chunk with no events, every
    pixel firing; small and kernel slabs; full and half capacity."""
    FR.reset_launch_counts()
    assert testing.check_segment_copy_against_plain(cuda) == 0.0
    assert FR.LAUNCHES["adder_segment_copy"] == 3 * 2 * 2


def test_capacity_overflow_keeps_total_and_reruns(cuda):
    """Every pixel fires: at a quarter of the events and at none (the
    staging pool dry) the total stays exact; the rerun equals plain."""
    assert testing.check_capacity_overflow(cuda) == 0.0


def test_resident_chunks_never_wait_for_the_card(cuda):
    """The resident engine's chunk calls (with the display and without)
    launch their kernels and read nothing back: under
    torch.cuda.set_sync_debug_mode("error") they run to the end."""
    frames = testing.walk_frames(3, 8, 33 * 17).reshape(8, 17, 33, 1)
    for keep in (False, True):
        v = at.Video(at.PlaneSize(33, 17, 1), at.Mode.FramePerfect,
                     device=cuda)
        v._keep_running_frame = keep
        run = v._run_chunk

        def chunk(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return run(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        v._run_chunk = chunk
        v.submit_chunk(frames[:4])
        v.submit_chunk(frames[4:])
        v.flush()
        assert v.in_interval_count == 8


def test_cuda_wrapper_rejects_bad_input(cuda):
    st = at.Video(at.PlaneSize(8, 4, 1), at.Mode.FramePerfect,
                  device=cuda).state
    frames = torch.zeros((3, 32), dtype=torch.uint8, device=cuda)
    p = FR.ops.TranscodeParams()
    with pytest.raises(ValueError):
        FR.fused_chunk_resident(st, frames.to(torch.int32), 255.0, p,
                                event_cap=96)
    with pytest.raises(ValueError):
        FR.fused_chunk_resident(st, frames[:, :16], 255.0, p, event_cap=48)
    cpu_state = st._replace(length=st.length.cpu())
    with pytest.raises(ValueError):
        FR.group_chunk_resident(cpu_state, frames, 255.0, p)


def test_display_matches_plain(cuda):
    """K1's display output against its plain version: 8 modes x depth 6/8,
    the four view modes, two chained chunks of T = 8 from a seeded display
    frame on a ragged 200 x 150 plane, WRITE and VOID, a forced depth-6
    overflow."""
    assert testing.check_display_against_plain(cuda) == 0.0


def test_display_wrapper_rejects_bad_run0(cuda):
    st = at.Video(at.PlaneSize(8, 4, 1), at.Mode.FramePerfect,
                  device=cuda).state
    frames = torch.zeros((3, 32), dtype=torch.uint8, device=cuda)
    p = FR.ops.TranscodeParams()
    for run0 in (torch.zeros(32, dtype=torch.int32, device=cuda),
                 torch.zeros(31, dtype=torch.uint8, device=cuda),
                 torch.zeros(32, dtype=torch.uint8)):
        with pytest.raises(ValueError):
            FR.fused_chunk_resident(st, frames, 255.0, p, run0,
                                    event_cap=96)


def _features_run(frames, device, rate: bool):
    """A features-on FramedArray run (Instant markers; with `rate`, crf 5,
    the rate adjustment and clustering): the bytes, the feature set and the
    display frame with its markers after each chunk."""
    src = at.FramedArray(frames, 30.0, chunk_frames=4, device=device)
    src.auto_time_parameters(255, 255 * 30, at.TimeMode.AbsoluteT)
    if rate:
        src.crf(5)
    buf = io.BytesIO()
    src.write_out(at.SourceCamera.FramedU8, at.TimeMode.AbsoluteT,
                  at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                  at.EncoderOptions.default(src.video.plane), buf)
    src.video.update_detect_features(True, ShowFeatureMode.Instant, rate,
                                     rate)
    shown = []
    while True:
        try:
            src.consume_batch()
        except EOFError:
            break
        shown.append((set(src.video.features),
                      src.video.display_frame_features.copy()))
    src.video.end_write_stream()
    return buf.getvalue(), shown, src.video.state.c_thresh.cpu()


@pytest.mark.parametrize("rate", [False, True], ids=["plain", "rate"])
@pytest.mark.parametrize("env", [None, "ADDER_TPU_RESIDENT",
                                 "ADDER_TPU_FUSED"])
def test_features_video_cuda_equals_cpu(cuda, env, rate, monkeypatch):
    """A features-on Video on each engine: the same bytes, feature sets,
    display frames and c_thresh on the card and on the CPU; on the resident
    engine through the display kernel."""
    monkeypatch.delenv("ADDER_TPU_RESIDENT", raising=False)
    monkeypatch.delenv("ADDER_TPU_FUSED", raising=False)
    if env:
        monkeypatch.setenv(env, "0")
    frames = testing.moving_shapes(3, 12, 48, 64, 1)
    FR.reset_launch_counts()
    card = _features_run(frames, cuda, rate)
    if env is None:
        # one pass and one segment copy per chunk, x 3
        assert FR.LAUNCHES["adder_resident_chunk"] == 3
        assert FR.LAUNCHES["adder_segment_copy"] == 3
    cpu = _features_run(frames, "cpu", rate)
    assert card[0] == cpu[0] and len(card[0]) > 1000
    assert len(card[1]) == len(cpu[1]) == 3
    for (fa, da), (fb, db) in zip(card[1], cpu[1]):
        assert fa == fb and (da == db).all()
    assert card[1][-1][0]  # some features
    assert torch.equal(card[2], cpu[2])


def test_dvs_kernel_matches_plain(cuda):
    """K3 on the raster chunks against its plain version at 346 x 260: the
    bootstrap, a flush of a partial mask, a DAVIS frame (its carrier built
    on the card) and gap, Normal and Collapse, the events staged and
    copied, and void, forced overflow; the raster grouping equal to the
    glue's, and no glue run."""
    FR.reset_launch_counts()
    assert testing.check_raster_chunks_against_plain(cuda) == 0.0
    assert FR.LAUNCHES["adder_dvs_rows"] > 0


def test_dvs_rows_kernel_matches_plain_and_dense(cuda):
    """The K3 row kernel against its plain version: T = 2, 38 and 128 in
    two chained groups, Normal and Collapse, the events staged and copied,
    and void, a group with no rows, one whose rows sit in one pixel, rows
    with one half or both off, a forced depth-16 overflow; the state
    updated in place."""
    FR.reset_launch_counts()
    assert testing.check_dvs_rows_against_plain(cuda) == 0.0
    assert FR.LAUNCHES["adder_dvs_rows"] > 0


def test_dvs_rows8_kernel_matches_plain_and_20_byte_route(cuda):
    """K3 on the 8-byte carrier (`adder_dvs_rows8`) against its plain
    version and the 20-byte route on the same rows: T = 2, 38 and 128 in
    two chained groups, Normal and Collapse, the events staged and copied,
    void, and staged with the pipeline's capacity, no rows, one pixel's
    rows, halves off, a
    dictionary of 64, gap_n past 2^20, a forced depth-16 overflow, a 61 x
    47 plane and a 640 x 480 one (pb 19); the 8-byte glue against its plain
    version and the 20-byte grouping."""
    FR.reset_launch_counts()
    assert testing.check_dvs_rows8_against_plain(cuda) == 0.0
    assert FR.LAUNCHES["adder_dvs_rows8"] > 0


def test_dvs_rows8_wrapper_rejects_bad_input(cuda):
    p = testing._dvs_params(1)
    n = 35
    st = FR.ops.init_state(n, cuda, depth=FR.DVS_DEPTH)
    c8, pb, _ = testing.carriers(testing.lattice_plan(6, n, 2), n, cuda)
    with pytest.raises(ValueError):
        FR.dvs_rows8_resident(st, c8.to(torch.int64), 4, p, pb=pb)
    with pytest.raises(ValueError):
        FR.dvs_rows8_resident(st, c8[:1].contiguous(), 4, p, pb=pb)
    with pytest.raises(ValueError):  # a pixel field that is not the plane's
        FR.dvs_rows8_resident(st, c8, 4, p, pb=pb + 1)
    with pytest.raises(ValueError):
        FR.dvs_rows8_resident(st, c8[:, :FR.DICT_CAP - 1].contiguous(), 4,
                              p, pb=pb)
    with pytest.raises(ValueError):
        FR.dvs_rows8_resident(st, c8, 4, p, pb=pb, event_cap=-1)
    with pytest.raises(ValueError):
        FR.dvs_rows8_resident(st, c8, 4, p._replace(mode=0), pb=pb)


def test_dvs_rows_wrapper_rejects_bad_input(cuda):
    p = testing._dvs_params(1)
    st = FR.ops.init_state(35, cuda, depth=FR.DVS_DEPTH)
    carrier = torch.from_numpy(testing.synthetic_rows(6, 35, 2)).to(cuda)
    with pytest.raises(ValueError):
        FR.dvs_rows_resident(st, carrier.to(torch.int64), 4, p)
    with pytest.raises(ValueError):
        FR.dvs_rows_resident(st, carrier[:4], 4, p)
    with pytest.raises(ValueError):
        FR.dvs_rows_resident(st, carrier, 3, p)
    with pytest.raises(ValueError):
        FR.dvs_rows_resident(FR.ops.init_state(35, cuda, depth=8), carrier, 4,
                             p)
    with pytest.raises(ValueError):
        FR.dvs_rows_resident(st, carrier, 4, p._replace(mode=0))


def test_prophesee_cuda_bytes_equal_cpu(cuda, tmp_path):
    t, x, y, p = testing.dvs_stream(2, 64, 48, 40_000, n_hot=4,
                                    hot_events=90, band_events=3000,
                                    background_events=1500)
    path = str(tmp_path / "s.raw")
    testing.write_prophesee_raw(path, 64, 48, t, x, y, p)

    def run(device):
        src = at.Prophesee(20, path, device=device)
        src.crf(3)
        buf = io.BytesIO()
        src.write_out(at.SourceCamera.Dvs, at.TimeMode.AbsoluteT,
                      at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                      at.EncoderOptions.default(src.plane), buf)
        while True:
            try:
                src.consume()
            except EOFError:
                break
        src.end_write_stream()
        return buf.getvalue()

    FR.reset_launch_counts()
    on_card = run(cuda)
    # every chunk by rows: the lane groups on the 8-byte carrier through
    # the glue, the bootstrap and the flush as 20-byte raster chunks (one
    # walk and one rows copy each)
    assert FR.LAUNCHES["adder_dvs_rows8"] >= 1
    assert FR.LAUNCHES["adder_dvs_rows"] == 2
    assert (FR.LAUNCHES["adder_rows_copy"]
            == FR.LAUNCHES["adder_dvs_rows8"] + 2)
    assert FR.LAUNCHES["adder_rows_group"] > 0
    assert "adder_dvs_chunk" not in FR.LAUNCHES
    assert on_card == run("cpu")
    assert len(on_card) > 1000


def test_prophesee_lane_groups_never_wait_for_the_card(cuda, tmp_path):
    """Inside a window's lane groups (the pipeline's stage, step and flush)
    nothing waits for the card on the calling thread
    (torch.cuda.set_sync_debug_mode "error"); the fetch worker's waits are
    on events. The bytes equal the synchronous 20-byte route's."""
    from adder_tpu_torch.ops import native_dvs_plan as NP
    from adder_tpu_torch.transcoder import lanes

    t, x, y, p = testing.dvs_stream(3, 64, 48, 60_000, n_hot=4,
                                    hot_events=150, band_events=4000,
                                    background_events=2000)
    path = str(tmp_path / "s.raw")
    testing.write_prophesee_raw(path, 64, 48, t, x, y, p)

    def strict(orig):
        def f(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return f

    def run():
        src = at.Prophesee(20, path, view_fps=10, device=cuda)
        src.crf(3)
        buf = io.BytesIO()
        src.write_out(at.SourceCamera.Dvs, at.TimeMode.AbsoluteT,
                      at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                      at.EncoderOptions.default(src.plane), buf)
        while True:
            try:
                src.consume()
            except EOFError:
                break
        src.end_write_stream()
        return buf.getvalue()

    P = lanes.LanePipeline
    saved = {k: getattr(P, k) for k in ("stage", "step", "flush")}
    try:
        for k, f in saved.items():
            setattr(P, k, strict(f))
        pipelined = run()
    finally:
        for k, f in saved.items():
            setattr(P, k, f)
    saved = (NP.plan_dvs_pack8_native, FR.pack_dvs_plan8, P.max_staged,
             P.max_in_flight)
    try:
        NP.plan_dvs_pack8_native = FR.pack_dvs_plan8 = lambda *a, **k: None
        P.max_staged = P.max_in_flight = 0
        synchronous = run()
    finally:
        (NP.plan_dvs_pack8_native, FR.pack_dvs_plan8, P.max_staged,
         P.max_in_flight) = saved
    assert pipelined == synchronous and len(pipelined) > 1000


def test_davis_kernel_matches_plain(cuda):
    """K4 by rows against its plain version: T = 1, 37 and 128 in two
    chained groups on a ragged 61 x 47 plane, Normal and Collapse, the
    events staged and copied, and void, a group with no rows, one with
    inactive rows, one whose rows sit in one pixel, forced depth-16
    overflow; the glue with one sub-step per lane against its plain
    version; the state updated in place."""
    FR.reset_launch_counts()
    assert testing.check_davis_rows_against_plain(cuda) == 0.0
    assert FR.LAUNCHES["adder_davis_rows"] > 0


def test_rows_copy_kernel_matches_plain(cuda):
    """The one-pass walk's compaction, `adder_rows_copy`, against its plain
    version and the plain route's events on the staging made of them
    (8-byte DVS T = 2, 38 and 128 chained, DAVIS T = 64, Normal and
    Collapse, the exact capacity, half of it, none; no rows), and the walk
    itself: its cell counts, its staged events and its state."""
    FR.reset_launch_counts()
    assert testing.check_rows_copy_against_plain(cuda) == 0.0
    assert FR.LAUNCHES["adder_rows_copy"] > 0


@pytest.mark.parametrize("case", testing.ROW_GROUP_CASES)
def test_rows_group_kernels_match_definition(cuda, case):
    """The grouping's kernels (`adder_rows_group_keys`, `_scan`, `_rank`)
    and the plain version on the card against the numpy definition, every
    RowGroups field: the 20-byte key, the 8-byte key at pb 8, 19 and 20,
    the DAVIS key with lanes up to 127, E = 1, one pixel, one lane, every
    (lane, pixel) of a small plane, pixel n - 1, shuffled rows, and a T =
    128 group of about 250,000 rows at 640 x 480 on both DVS keys."""
    FR.reset_launch_counts()
    assert testing.check_group_against_reference(cuda, case) == 0.0
    assert FR.LAUNCHES["adder_rows_group"] == 3


def test_rows_group_runs_no_sort(cuda, monkeypatch):
    """With every torch sort and search patched to raise, the grouping on
    the card still equals its plain version (made before the patch), in
    three launches, on each key form; a whole lane chunk runs too."""
    cases = [testing.row_group_rows(c) for c in (
        "20-byte", "8-byte pb 19", "DAVIS lanes to 127")]
    inputs = []
    for lane, pix, T, form, n in cases:
        c, per_lane, pb = testing.group_keys_carrier(lane, pix, form, n)
        c = c.to(cuda)
        inputs.append((c, T, per_lane, pb, n,
                       FR.group_dvs_rows_plain(c, T, per_lane, pb)))
    p = testing._dvs_params(1)
    m = 35
    c8, pb8, _ = testing.carriers(testing.lattice_plan(6, m, 3), m, cuda)
    st = FR.ops.init_state(m, cuda, depth=FR.DVS_DEPTH)
    want = FR.dvs_rows8_resident_plain(st, c8, 6, p, pb=pb8)

    def refuse(*a, **k):
        raise AssertionError("a sort or search ran")

    for owner in (torch, torch.Tensor):
        for name in ("sort", "argsort", "searchsorted", "msort"):
            if hasattr(owner, name):
                monkeypatch.setattr(owner, name, refuse)
    for c, T, per_lane, pb, n, plain in inputs:
        FR.reset_launch_counts()
        got = FR.group_dvs_rows(c, T, per_lane, pb, n=n)
        assert FR.LAUNCHES["adder_rows_group"] == 3
        E = c.shape[1] - (FR.DICT_CAP if pb else 0)
        for field, a, b in zip(FR.RowGroups._fields, got, plain):
            if field == "row_start":
                a, b = a[: E + 1], b[: E + 1]
            assert torch.equal(a, b), field
    got = FR.dvs_rows8_resident(FR.clone_state(st), c8, 6, p, pb=pb8,
                                event_cap=19 * 6 * m)
    monkeypatch.undo()
    n_ev = int(got.total)
    assert torch.equal(got.pixd[:n_ev], want.pixd)
    assert torch.equal(got.t[:n_ev], want.t)


def test_rows_group_needs_the_planes_pixel_count(cuda):
    c, per_lane, pb = testing.group_keys_carrier([0, 1], [3, 4], "20", 10)
    with pytest.raises(ValueError):
        FR.group_dvs_rows(c.to(cuda), 4, per_lane, pb)
    with pytest.raises(ValueError):
        FR.group_dvs_rows(c.to(cuda), 4, per_lane, pb, n=(1 << 20) + 1)


def test_rows_copy_kernel_every_count_and_capacity(cuda):
    """`adder_rows_copy` against its plain version and a numpy copy of a
    slot-major staging holding 0 to ROW_SLOTS events a cell, with the
    capacity falling mid-cell, between cells, at none and past the
    total."""
    FR.reset_launch_counts()
    assert testing.check_rows_copy_counts(cuda) == 0.0
    assert FR.LAUNCHES["adder_rows_copy"] > 0


@pytest.mark.parametrize("events", [True, False])
def test_row_walk_launches_once_per_chunk(cuda, events):
    """A lane chunk walks its rows once: one row kernel launch, and with
    the events one rows copy; the grouping's three kernels and the cell
    counts' scan; with the pipeline's capacity nothing is read back in
    between."""
    p = testing._dvs_params(1)
    n = 35
    plan = testing.lattice_plan(6, n, 3)
    c8, pb, c20 = testing.carriers(plan, n, cuda)
    st = FR.ops.init_state(n, cuda, depth=FR.DVS_DEPTH)
    for fn, carrier, kw, entry in (
            (FR.dvs_rows8_resident, c8, {"pb": pb}, "adder_dvs_rows8"),
            (FR.dvs_rows_resident, c20, {}, "adder_dvs_rows")):
        FR.reset_launch_counts()
        fn(FR.clone_state(st), carrier, 6, p, events=events, event_cap=19 * 6
           * n, **kw)
        assert FR.LAUNCHES[entry] == 1
        assert FR.LAUNCHES["adder_rows_copy"] == int(events)
        assert FR.LAUNCHES["adder_rows_group"] == 3
        assert FR.LAUNCHES["adder_exclusive_scan"] == 1


def test_davis_rows_wrapper_rejects_bad_input(cuda):
    p = testing._davis_params(1)
    st = FR.ops.init_state(35, cuda, depth=FR.DVS_DEPTH)
    carrier = testing.davis_group_carrier(testing.davis_plan(6, 7, 5, 4), 0,
                                          4, cuda)
    with pytest.raises(ValueError):
        FR.davis_rows_resident(st, carrier.to(torch.int64), 4, p)
    with pytest.raises(ValueError):
        FR.davis_rows_resident(st, carrier[:4], 4, p)
    with pytest.raises(ValueError):
        FR.davis_rows_resident(st, carrier, FR.MAX_T + 1, p)
    with pytest.raises(ValueError):
        FR.davis_rows_resident(FR.ops.init_state(35, cuda, depth=8), carrier,
                               4, p)
    with pytest.raises(ValueError):
        FR.davis_rows_resident(st, carrier, 4, p._replace(mode=0))


def test_davis_cuda_bytes_equal_cpu(cuda, tmp_path):
    """aedat4 -> EdiReconstructor -> Davis (raw-davis, the CLI's manual
    quality) on the card and on the CPU: the same bytes."""
    events, frames = testing.davis_stream(
        4, 64, 48, 100_000, n_frames=4, exposure_us=10_000, n_hot=4,
        hot_events=60, edge_events=6000, background_events=2000)
    path = str(tmp_path / "s.aedat4")
    testing.write_davis_aedat4(path, 64, 48, events, frames)

    def run(device):
        src = at.Davis(at.EdiReconstructor(path), ref_time=255,
                       tps=255_000_000, delta_t_max=255_000_000,
                       mode=at.TranscoderMode.RawDavis, device=device)
        buf = io.BytesIO()
        src.write_out(at.SourceCamera.DavisU8, at.TimeMode.AbsoluteT,
                      at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                      at.EncoderOptions.default(src.plane), buf)
        src.get_video_ref().update_quality_manual(5, 5, 3921, 1, 2.0)
        while True:
            try:
                src.consume()
            except EOFError:
                break
        src.end_write_stream()
        return buf.getvalue()

    FR.reset_launch_counts()
    on_card = run(cuda)
    # the lane groups through K4 by rows, the frames and gaps through K3
    assert FR.LAUNCHES["adder_davis_rows"] > 0
    assert FR.LAUNCHES["adder_dvs_rows"] > 0
    assert not {"adder_dvs_chunk", "adder_davis_chunk"} & set(FR.LAUNCHES)
    assert on_card == run("cpu")
    assert len(on_card) > 1000


def test_fused_interval_matches_plain(cuda):
    """K5 against its plain version: 8 modes x depth 6/8 x pack 4/16, two
    chained chunks from a non-zero offset on a ragged 200 x 150 plane (plane
    padding, view modes, the display off), pack-2 overflow, a forced depth-6
    overflow and a buffer too small."""
    assert testing.check_fused_interval_against_plain(cuda) == 0.0


def test_interval_slots_matches_plain(cuda):
    """K6 against its plain version: 8 modes at depth 8, 16 chained
    intervals on a ragged 200 x 150 plane, a forced depth-8 overflow, and
    the slot chunk on the card against the CPU."""
    assert testing.check_interval_slots_against_plain(cuda) == 0.0


@pytest.mark.parametrize("env", ["ADDER_TPU_RESIDENT", "ADDER_TPU_FUSED"])
def test_one_interval_engines_cuda_bytes_equal_cpu(cuda, env, monkeypatch):
    """Each one-interval engine of Video: the same bytes and display frames
    on the card and on the CPU, through its kernel."""
    from adder_tpu_torch.ops import fused_kernel, pallas_kernel

    monkeypatch.setenv(env, "0")
    frames = testing.walk_frames(5, 12, 33 * 17).reshape(12, 17, 33, 1)

    def run(device):
        src = at.FramedArray(frames, 30.0, chunk_frames=4, device=device)
        src.auto_time_parameters(255, 255 * 24, at.TimeMode.DeltaT)
        src.quality_manual(0, 0, 24, 1, 0)
        buf = io.BytesIO()
        src.write_out(at.SourceCamera.FramedU8, at.TimeMode.DeltaT,
                      at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                      at.EncoderOptions.default(src.video.plane), buf)
        src.video._keep_running_frame = True
        shown = []
        while True:
            try:
                src.consume_batch()
            except EOFError:
                break
            shown.append(src.video.running_intensities.copy())
        src.video.end_write_stream()
        return buf.getvalue(), shown

    fused_kernel.reset_launch_counts()
    pallas_kernel.reset_launch_counts()
    on_card, shown_card = run(cuda)
    launches = (fused_kernel.LAUNCHES["adder_fused_interval"]
                if env == "ADDER_TPU_RESIDENT"
                else pallas_kernel.LAUNCHES["adder_interval_slots"])
    assert launches == 12
    on_cpu, shown_cpu = run("cpu")
    assert on_card == on_cpu and len(on_card) > 1000
    for a, b in zip(shown_card, shown_cpu):
        assert (a == b).all()


@pytest.mark.parametrize("t_mode", [0, 1], ids=["deltaT", "absT"])
@pytest.mark.parametrize("view", ["Intensity", "SAE", "coordless"])
def test_device_framer_cuda_equals_cpu(cuda, t_mode, view):
    """DeviceFramer on the card pops the frames it pops on the CPU, on
    seeded per-pixel chains, with carries across batches and a window that
    wraps, and on one ingest of the whole stream."""
    from adder_tpu_torch.framer.device import DeviceFramer
    from adder_tpu_torch.framer.driver import FramerBuilder
    from adder_tpu_torch.framer.scale_intensity import FramedViewMode

    plane = (40, 30, 1)
    ev = testing.framer_chains(plane, 20, 8000, 5, t_mode == 1)
    b = FramerBuilder(at.PlaneSize(*plane))
    if view == "coordless":
        b.coordless = True
    else:
        b.view_mode = FramedViewMode[view]
    b = (b.time_parameters(60_000, 1000, 8000, 60.0)
         .codec_meta(2 if t_mode else 0, at.TimeMode(t_mode))
         .source_info(at.core.types.SourceType.U8, at.SourceCamera.FramedU8))
    outs = []
    for device in ("cpu", cuda):
        for window, step in ((24, 700), (None, 0)):
            df = DeviceFramer(b, batch_cap=1000, window=window, device=device)
            frames = []
            cuts = [*range(step, len(ev[0]), step), len(ev[0])] if step \
                else [len(ev[0])]
            lo = 0
            for hi in cuts:
                df.ingest_event_array(at.EventArray(*[a[lo:hi] for a in ev]))
                frames.extend(df.pop_ready_frames())
                lo = hi
            frames.extend(df.drain())
            outs.append(frames)
    assert len(outs[0]) > 40
    for cpu_frames, card_frames in zip(outs[:2], outs[2:]):
        assert len(cpu_frames) == len(card_frames)
        for a, b_ in zip(cpu_frames, card_frames):
            assert (a == b_).all()


def _sharded_raw_bytes(frames, k, device, void=False):
    """_raw_bytes' drive through a ShardedVideo of k bands on `device`."""
    T_, H_, W_, C_ = frames.shape
    v = at.ShardedVideo(at.PlaneSize(W_, H_, C_), at.Mode.FramePerfect,
                        chunk_frames=4, mesh=[device] * k)
    v.time_parameters(255 * 30, 255, 255 * 24, at.TimeMode.DeltaT)
    v.update_quality_manual(0, 0, 24, 1, 0)
    buf = io.BytesIO()
    v.write_out(at.SourceCamera.FramedU8, at.TimeMode.DeltaT,
                at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                at.EncoderOptions.default(v.plane), buf)
    v.void_events = void
    for i in range(0, T_, 4):
        v.submit_chunk(frames[i:i + 4])
    v.end_write_stream()
    return buf.getvalue(), v


@pytest.mark.parametrize("k", [2, 3])
def test_sharded_video_on_one_card_equals_video(cuda, k):
    """k bands on cuda:0: the one-card Video's bytes, one K1 pass and one
    segment copy per band and chunk; the Empty sink launches K2 per band
    and ends in the same state."""
    from adder_tpu_torch.parallel import sharding

    frames = testing.walk_frames(3, 12, 33 * 17).reshape(12, 17, 33, 1)
    want = _raw_bytes(frames, cuda)
    FR.reset_launch_counts()
    got, v = _sharded_raw_bytes(frames, k, "cuda:0")
    assert FR.LAUNCHES["adder_resident_chunk"] == 3 * k
    assert FR.LAUNCHES["adder_segment_copy"] == 3 * k
    assert got == want and len(got) > 1000
    FR.reset_launch_counts()
    _, vd = _sharded_raw_bytes(frames, k, "cuda:0", void=True)
    assert FR.LAUNCHES["adder_resident_chunk"] == 3 * k
    assert FR.LAUNCHES["adder_segment_copy"] == 0
    a = sharding.gather_state(v.state, "cpu")
    b = sharding.gather_state(vd.state, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _tool_bytes(name, argv, out, device):
    import importlib

    mod = importlib.import_module(f"adder_tpu_torch.tools.{name}")
    assert mod.main([*argv, "--torch-device", device]) == 0
    with open(out, "rb") as f:
        return f.read()


def test_prophesee_to_adder_tool_cuda_bytes_equal_cpu(cuda, tmp_path):
    """The Prophesee CLI with its defaults on the card (K3 on the 8-byte
    carrier for the lane groups, on 20 bytes for the bootstrap and the
    flush, and its row glue) and on the CPU: the same bytes."""
    path = str(tmp_path / "s.raw")
    testing.write_prophesee_raw(path, 64, 48, *testing.dvs_stream(
        3, 64, 48, 40_000, n_hot=4, hot_events=90, band_events=3000,
        background_events=1500))
    out = str(tmp_path / "out.adder")
    FR.reset_launch_counts()
    on_card = _tool_bytes("prophesee_to_adder", ["-i", path, "-o", out],
                          out, "cuda")
    # one walk and one rows copy a chunk: the lane groups on 8 bytes, the
    # bootstrap and the flush on 20
    assert FR.LAUNCHES["adder_dvs_rows8"] >= 1
    assert FR.LAUNCHES["adder_dvs_rows"] == 2
    assert (FR.LAUNCHES["adder_rows_copy"]
            == FR.LAUNCHES["adder_dvs_rows8"] + 2)
    assert FR.LAUNCHES["adder_rows_group"] > 0
    assert on_card == _tool_bytes("prophesee_to_adder",
                                  ["-i", path, "-o", out], out, "cpu")
    assert len(on_card) > 1000


@pytest.mark.parametrize("mode", ["raw-davis", "raw-dvs"])
def test_davis_to_adder_tool_cuda_bytes_equal_cpu(cuda, tmp_path, mode):
    """The DAVIS CLI without --crf on the card (K4 for the lanes, K3 for
    the frames and gaps) and on the CPU: the same bytes."""
    events, frames = testing.davis_stream(
        5, 64, 48, 100_000, n_frames=4, exposure_us=10_000, n_hot=4,
        hot_events=60, edge_events=6000, background_events=2000)
    path = str(tmp_path / "s.aedat4")
    testing.write_davis_aedat4(path, 64, 48, events, frames)
    out = str(tmp_path / "out.adder")
    argv = ["-i", path, "--output-events-filename", out, "-t", mode]
    FR.reset_launch_counts()
    on_card = _tool_bytes("davis_to_adder", argv, out, "cuda")
    assert FR.LAUNCHES["adder_davis_rows"] > 0
    if mode == "raw-davis":
        assert FR.LAUNCHES["adder_dvs_rows"] > 0
    assert on_card == _tool_bytes("davis_to_adder", argv, out, "cpu")
    assert len(on_card) > 1000


def test_decode_benchmark_device_frames_fillers_past_delta_t_max(cuda,
                                                                 tmp_path):
    """`decode_benchmark --frame --device` on the card, on a Collapse
    DeltaT stream of the transcoder (the bench config on a crop of the
    bench scene, transcoded on the card) whose D_EMPTY fillers span more
    than the header's delta_t_max: the device framer's frames equal the
    host framer's."""
    from adder_tpu_torch.core.types import D_EMPTY
    from adder_tpu_torch.tools import decode_benchmark as DB

    scene = testing.moving_blobs(1080, 1920, 64, seed=7, device="cpu",
                                 rows=(100, 108))
    frames = scene[:, :, 600:700].contiguous().numpy()[..., None]
    path = str(tmp_path / "collapse.adder")
    with open(path, "wb") as f:
        f.write(_raw_bytes(frames, cuda))
    ev = at.open_file_decoder(path).digest_all()
    assert (ev.t[ev.d == D_EMPTY] > 6120).any()
    argv = ["-i", path, "--fps", "30", "--frame", "--torch-device", "cuda"]
    host = DB.benchmark(DB.parse_args(argv))
    device = DB.benchmark(DB.parse_args([*argv, "--device"]))
    assert len(device) == len(host) > 50
    for a, b_ in zip(host, device):
        assert (a == b_).all()


# --- the wide event layout (planes of 2^24 pixel-channels and more) --------


@pytest.mark.parametrize("depth", [6, 8])
def test_wide_chunk_kernels_match_narrow_every_mode(cuda, depth):
    """K1's wide pass and the wide segment copy give, in every mode case,
    the narrow kernels' events as int64 pix << 8 | d, and the same state,
    counts and flags, on a ragged plane (its last warp part full)."""
    n, T8 = 47 * 61, 8
    frames = torch.from_numpy(testing.walk_frames(depth, 2 * T8, n)).to(cuda)
    for p in testing.MODE_CASES:
        st = FR.ops.set_initial_d(
            FR.ops.init_state(n, cuda, c_thresh=3, depth=depth),
            frames[0].to(torch.int32))
        for c in range(2):
            f = frames[c * T8:(c + 1) * T8].contiguous()
            FR.reset_launch_counts()
            a = FR.fused_chunk_resident(st, f, 255.0, p, event_cap=11 * n * T8)
            b = FR.fused_chunk_resident(st, f, 255.0, p, event_cap=11 * n * T8,
                                        wide=True)
            for key in ("adder_resident_chunk", "adder_segment_copy"):
                assert FR.LAUNCHES[key] == FR.LAUNCHES[key + "_wide"] == 1
            k = int(a.total)
            assert k > 0 and int(b.total) == k and b.pixd.dtype == torch.int64
            assert torch.equal(b.pixd[:k], a.pixd[:k].to(torch.int64)
                               & 0xFFFFFFFF), (tuple(p[:3]), c)
            assert torch.equal(b.t[:k], a.t[:k])
            for name in ("per_interval", "pmax"):
                assert torch.equal(getattr(b, name), getattr(a, name)), name
            for fld in FR._KERNEL_FIELDS:
                assert torch.equal(getattr(b.state, fld),
                                   getattr(a.state, fld)), fld
            st = a.state


def test_wide_segment_copy_matches_plain(cuda):
    """The wide copy kernel against its plain version on staging that
    `testing.stage_segments` lays out, its low words in lane form, at the
    full capacity and at half the events."""
    for name, res, n in testing.segment_copy_cases(1):
        if not int(res.total):
            continue
        slab = FR.slab_entries(6)
        stage, seg_start, counts, link = testing.stage_segments(res, n, slab)
        low = stage & 0xFFFFFFFF
        lane_word = (((low >> 8) & 31) << 8) | (low & 0xFF)
        stage = torch.where(stage >= 0, (stage & ~0xFFFFFFFF) | lane_word,
                            stage)
        offsets = FR.exclusive_scan_plain(counts)
        flags = torch.zeros(3, dtype=torch.int32)
        for cap in (int(res.total), int(res.total) // 2):
            want = FR.segment_copy_plain(stage, seg_start, counts, offsets,
                                         link, slab, cap, flags, wide=True)
            got = FR.segment_copy(stage.to(cuda), seg_start.to(cuda),
                                  counts.to(cuda), offsets.to(cuda),
                                  link.to(cuda), slab, cap, flags.to(cuda),
                                  wide=True)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), (name, cap)


def test_wide_wire_pack_matches_plain_at_52m_events(cuda):
    """`adder_wire_pack`'s wide kernel against its plain version on 52 M
    events of a 3840 x 2160 x 3 plane in pixel order (a 4K colour Raw
    chunk's count), the indices past 2^24 and the last pixel-channel among
    them."""
    n, last = 52_000_000, 3840 * 2160 * 3 - 1
    gen = torch.Generator(device=cuda).manual_seed(22)
    pix = torch.randint(0, last + 1, (n,), generator=gen, device=cuda,
                        dtype=torch.int64).sort().values
    pix[-1] = last
    d = torch.randint(0, 256, (n,), generator=gen, device=cuda,
                      dtype=torch.int64)
    t = torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen, device=cuda,
                      dtype=torch.int64).to(torch.int32)
    pixd = (pix << 8) | d
    FR.reset_launch_counts()
    got = FR.wire_pack(pixd, t, 3840, 3)
    assert FR.LAUNCHES["adder_wire_pack_wide"] == 1
    assert FR.LAUNCHES["adder_wire_pack"] == 0
    assert got.numel() == 11 * n
    want = FR.wire_pack_plain(pixd, t, 3840, 3)
    assert torch.equal(got, want)


def _reference_chunks(frames, config, device, events=True):
    """reference_wide over the chunks of `frames` ((k, 8, n) u8 on the
    card) from its own initial state: the chunks' results."""
    from portbench import reference_wide as R

    p = R.params_of(config)
    st = R.first_frame(R.initial_state(frames.shape[-1], p, device),
                       frames[0, 0])
    out = []
    for f in frames:
        res = R.run_chunk(st, f, p, events)
        out.append(res)
        st = res.state
    return out


def _events_of(pixd: np.ndarray, t: np.ndarray, width: int, channels: int):
    """The reference's events (int64 pix << 8 | d, u32 t) as the
    EventArray an encoder takes, unpacked with numpy."""
    from adder_tpu_torch.core.types import EventArray

    pix = pixd >> 8
    xy = pix // channels
    return EventArray((xy % width).astype(np.uint16),
                      (xy // width).astype(np.uint16),
                      (pix % channels).astype(np.uint8),
                      (pixd & 0xFF).astype(np.uint8), t.view(np.uint32))


@pytest.mark.parametrize("sink", ["raw", "empty", "compressed"])
def test_video_4k_color_equals_reference_wide(cuda, sink):
    """Two chunks of 8 frames at 3840 x 2160 x 3 through `Video` (the
    resident engine, the wide layout) against `reference_wide` on the card:
    the state after each chunk, its per-frame counts and pmax, and the
    `.adder` bytes. Raw: the packed route (the wide K1 pass, copy and
    pack), the bytes against `reference_wide.event_bytes`, header
    included. Empty, as the benchmark drives it (`void_events`): the
    events-free pass (K2) on the 4K plane, no bytes. Compressed: the host
    route (the wide copy, the int64 fetch and unpack), the bytes against
    the same encoder fed the reference's events; there the scene moves only
    in the plane's last 120 rows (indices past 2^24; constant pixels emit
    nothing over 16 frames), which keeps the host coder's work small."""
    import json
    import pathlib

    from adder_tpu_torch.codec import raw as rawcodec
    from adder_tpu_torch.codec.encoder import Encoder
    from portbench import reference_wide as R
    from portbench import scene

    root = pathlib.Path(__file__).resolve().parents[1] / "portbench"
    config = json.loads((root / "configs" / "framed-2160p-color.json")
                        .read_text())
    traffic = json.loads((root / "traffic" / "raw-moving-2160p.json")
                         .read_text())
    Wp, Hp, C = 3840, 2160, 3
    n = Wp * Hp * C
    frames = scene.render(traffic["scene"], Wp, Hp, C, 16, cuda)
    if sink == "compressed":
        band = torch.zeros_like(frames)
        band[:, Hp - 120:] = frames[:, Hp // 2 - 60:Hp // 2 + 60]
        frames = band
    frames = frames.reshape(2, 8, n)
    plane = at.PlaneSize(Wp, Hp, C)
    v = at.Video(plane, at.Mode.FramePerfect, chunk_frames=8, device=cuda)
    assert v._wide
    v.time_parameters(config["tps"], config["ref_time"],
                      config["delta_t_max"], at.TimeMode.DeltaT)
    kind = {"raw": at.EncoderType.Raw, "empty": at.EncoderType.Empty,
            "compressed": at.EncoderType.Compressed}[sink]
    buf = io.BytesIO()
    options = at.EncoderOptions.default(plane)
    v.write_out(at.SourceCamera.FramedU8, at.TimeMode.DeltaT,
                at.PixelMultiMode.Collapse, None, kind, options, buf)
    v.void_events = sink == "empty"
    v.update_quality_manual(0, 0, config["delta_t_max"] // config["ref_time"],
                            1, 0)
    header = len(buf.getvalue())
    FR.reset_launch_counts()
    got = []
    for f in frames:
        p = v.submit_chunk(f.cpu().numpy().reshape(8, Hp, Wp, C),
                           float(config["ref_time"]))
        ev = v.collect_chunk(p)
        got.append((p["outs"], len(ev)))
    v.end_write_stream()
    wide_keys = ("adder_resident_chunk_wide", "adder_segment_copy_wide",
                 "adder_wire_pack_wide")
    want_launches = {
        "raw": dict.fromkeys(wide_keys, 2),
        "empty": {"adder_resident_chunk": 2},
        "compressed": {"adder_resident_chunk_wide": 2,
                       "adder_segment_copy_wide": 2}}[sink]
    assert {k: c for k, c in FR.LAUNCHES.items()
            if c and k != "adder_exclusive_scan"} == want_launches
    data = buf.getvalue()
    want = _reference_chunks(frames, config, cuda, sink != "empty")
    for (outs, k), ref in zip(got, want):
        assert int(ref.total) > (1_000_000 if sink != "compressed"
                                 else 10_000)
        assert torch.equal(outs.per_interval, ref.per_interval)
        assert int(outs.pmax) == int(ref.pmax)
        for fld in R.State._fields:
            a, b = getattr(outs.state, fld), getattr(ref.state, fld)
            assert a.shape == b.shape and a.dtype == b.dtype, fld
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), fld
        if sink == "empty":
            continue
        assert k == int(ref.total)
        assert int(ref.pixd.min()) >> 8 >= 1 << 24 or sink == "raw"
        assert int(ref.pixd.max()) >> 8 >= 1 << 24  # indices past 24 bits
    if sink == "raw":
        assert data[:header] == R.header_bytes(
            dict(config, plane=dict(width=Wp, height=Hp, channels=C)))
        body = b"".join(R.event_bytes(ref.pixd.cpu().numpy(),
                                      ref.t.cpu().numpy(), Wp, C)
                        for ref in want)
        assert data[header:] == body + rawcodec.eof_event_bytes(C)
    elif sink == "compressed":
        meta = v._make_meta(at.SourceCamera.FramedU8, 0)
        meta.time_mode = at.TimeMode.DeltaT
        ref_buf = io.BytesIO()
        enc = Encoder.new_compressed(meta, ref_buf, options)
        for ref in want:
            enc.ingest_event_array(_events_of(
                ref.pixd.cpu().numpy(), ref.t.cpu().numpy(), Wp, C))
        enc.close_writer()
        assert len(data) > header and data == ref_buf.getvalue()


def _ptxas_by_kernel(log: str) -> dict:
    """-Xptxas=-v output -> {kernel<template args>: [registers, stack frame,
    spill stores, spill loads]} for the framed chunk's kernels, the
    anonymous namespace's hash left out of the name."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(adder_[a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?",
                          line)
            args = re.findall(r"L[ib](\d+)E", (m.group(2) or "") if m else "")
            cur = None
            if m:
                cur = m.group(1) + (f"<{','.join(args)}>" if args else "")
                out[cur] = [0, 0, 0, 0]
        elif cur and "spill stores" in line:
            w = line.replace(",", "").split()
            out[cur][1:] = [int(w[0]), int(w[w.index("spill") - 2]),
                            int(w[-4])]
        elif cur and "Used" in line and "registers" in line:
            w = line.split()
            out[cur][0] = int(w[w.index("Used") + 1])
    return out


def test_narrow_chunk_kernels_ptxas_unchanged(cuda):
    """The narrow instantiations of K1's pass (WIDE false, its last
    template argument), the segment copy and the wire pack compile to the
    registers, stack frame and spills the kernels had before the wide
    layout (tests/narrow_ptxas_sm90a.json: the build before it, on the H100
    toolchain); the wide kernels spill nothing."""
    import json
    import pathlib

    from adder_tpu_torch.ops import cuda_build

    cuda_build.load()
    got = _ptxas_by_kernel(cuda_build.build_log())
    want = json.loads((pathlib.Path(__file__).with_name(
        "narrow_ptxas_sm90a.json")).read_text())
    narrow, wide = {}, {}
    for k, v in got.items():
        if k.startswith("adder_resident_chunk_kernel<"):
            *args, flag = k[:-1].split("<")[1].split(",")
            name = f"adder_resident_chunk_kernel<{','.join(args)}>"
            (wide if flag == "1" else narrow)[name] = v
        elif "_wide_kernel" in k:
            wide[k] = v
        elif k.split("<")[0] in ("adder_segment_copy_kernel",
                                 "adder_wire_pack_kernel"):
            narrow[k] = v
    assert narrow == want
    assert len(wide) == 8 * 2 + 1 + 2
    assert all(v[2] == v[3] == 0 for v in wide.values()), wide
