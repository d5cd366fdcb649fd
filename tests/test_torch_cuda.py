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
    assert FR.LAUNCHES["adder_resident_chunk"] == 6  # COUNT + WRITE x 3
    assert on_card == _raw_bytes(frames, "cpu")
    assert len(on_card) > 1000


def test_cuda_wrapper_rejects_bad_input(cuda):
    st = at.Video(at.PlaneSize(8, 4, 1), at.Mode.FramePerfect,
                  device=cuda).state
    frames = torch.zeros((3, 32), dtype=torch.uint8, device=cuda)
    p = FR.ops.TranscodeParams()
    with pytest.raises(ValueError):
        FR.fused_chunk_resident(st, frames.to(torch.int32), 255.0, p)
    with pytest.raises(ValueError):
        FR.fused_chunk_resident(st, frames[:, :16], 255.0, p)
    cpu_state = st._replace(length=st.length.cpu())
    with pytest.raises(ValueError):
        FR.group_chunk_resident(cpu_state, frames, 255.0, p)


def test_dvs_kernel_matches_plain(cuda):
    """K3 against its plain version: bootstrap, T = 2, 38 and 128 in two
    chained groups, Normal and Collapse, WRITE and VOID, forced overflow."""
    assert testing.check_dvs_kernel_against_plain(cuda) == 0.0


def test_dvs_rows_kernel_matches_plain_and_dense(cuda):
    """The K3 row kernel against its plain version and the dense K3 kernel:
    T = 2, 38 and 128 in two chained groups, Normal and Collapse, WRITE and
    VOID, a group with no rows,
    one whose rows sit in one pixel, rows with one half or both off, a
    forced depth-16 overflow; the state updated in place."""
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
    # every lane group by rows; the bootstrap and the flush dense
    assert FR.LAUNCHES["adder_dvs_rows"] > 0
    assert FR.LAUNCHES["adder_dvs_chunk"] == 4  # COUNT + WRITE x 2
    assert on_card == run("cpu")
    assert len(on_card) > 1000


def test_davis_kernel_matches_plain(cuda):
    """K4 against its plain version: T = 1, 37 and 128 in two chained
    groups on a ragged 61 x 47 plane, Normal and Collapse, WRITE and VOID,
    forced depth-16 overflow."""
    assert testing.check_davis_kernel_against_plain(cuda) == 0.0


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
    assert FR.LAUNCHES["adder_davis_chunk"] > 0
    assert FR.LAUNCHES["adder_dvs_chunk"] > 0
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
