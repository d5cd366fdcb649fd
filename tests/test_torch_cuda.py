"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped without a GPU. This file imports no jax, so on a
machine without jax it runs with `python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py` (tests/conftest.py imports jax).
Tolerance: none; every comparison is bit for bit.
"""

import io

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
    # one pass and one segment copy per chunk, x 3
    assert FR.LAUNCHES["adder_resident_chunk"] == 3
    assert FR.LAUNCHES["adder_segment_copy"] == 3
    assert on_card == _raw_bytes(frames, "cpu")
    assert len(on_card) > 1000


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
    on the card) and gap, Normal and Collapse, WRITE and VOID, forced
    overflow; the raster grouping equal to the glue's, and no glue run."""
    FR.reset_launch_counts()
    assert testing.check_raster_chunks_against_plain(cuda) == 0.0
    assert FR.LAUNCHES["adder_dvs_rows"] > 0


def test_dvs_rows_kernel_matches_plain_and_dense(cuda):
    """The K3 row kernel against its plain version: T = 2, 38 and 128 in
    two chained groups, Normal and Collapse, WRITE and VOID, a group with no
    rows, one whose rows sit in one pixel, rows with one half or both off,
    a forced depth-16 overflow; the state updated in place."""
    FR.reset_launch_counts()
    assert testing.check_dvs_rows_against_plain(cuda) == 0.0
    assert FR.LAUNCHES["adder_dvs_rows"] > 0


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
    # every chunk by rows: the lane groups through the glue, the bootstrap
    # and the flush as raster chunks (COUNT + WRITE each)
    assert FR.LAUNCHES["adder_dvs_rows"] >= 6
    assert FR.LAUNCHES["adder_rows_group"] > 0
    assert "adder_dvs_chunk" not in FR.LAUNCHES
    assert on_card == run("cpu")
    assert len(on_card) > 1000


def test_davis_kernel_matches_plain(cuda):
    """K4 by rows against its plain version: T = 1, 37 and 128 in two
    chained groups on a ragged 61 x 47 plane, Normal and Collapse, WRITE and
    VOID, a group with no rows, one with inactive rows, one whose rows sit
    in one pixel, forced depth-16 overflow; the glue with one sub-step per
    lane against its plain version; the state updated in place."""
    FR.reset_launch_counts()
    assert testing.check_davis_rows_against_plain(cuda) == 0.0
    assert FR.LAUNCHES["adder_davis_rows"] > 0


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
    """The Prophesee CLI with its defaults on the card (K3 and its row glue)
    and on the CPU: the same bytes."""
    path = str(tmp_path / "s.raw")
    testing.write_prophesee_raw(path, 64, 48, *testing.dvs_stream(
        3, 64, 48, 40_000, n_hot=4, hot_events=90, band_events=3000,
        background_events=1500))
    out = str(tmp_path / "out.adder")
    FR.reset_launch_counts()
    on_card = _tool_bytes("prophesee_to_adder", ["-i", path, "-o", out],
                          out, "cuda")
    assert FR.LAUNCHES["adder_dvs_rows"] >= 6
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
