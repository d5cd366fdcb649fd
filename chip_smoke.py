#!/usr/bin/env python3
"""Smoke run of adder_tpu_torch on one NVIDIA GPU: build, check, transcode, time.

Usage, from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit; build the CUDA kernels from
     adder_tpu_torch/csrc (nvcc, at first use) and time the build;
  2. every kernel against its plain PyTorch version on the card, bit for
     bit: a ragged 200x150 plane, 2 chunks of T = 8, all 8 mode cases,
     depth 6 and 8, a forced depth-6 overflow; the scan past 2^31;
  3. the main path: 1080p mono, the reference's bench config, 64 frames of
     a seeded moving-blob scene, FramedArray(device="cuda") -> Video
     submit/collect -> Raw .adder in a temporary directory. The launch
     counters must rise, the decoded event count must equal the kernel's,
     and the first 8 frames must give the same bytes on the card and on
     the CPU;
  4. timings: kernel against plain version at 1080p mono, T = 16; the
     Empty-sink (void) path at 1080p mono and colour.
The last line is {"ok": true, "device": {...}}; the line before it holds
the card's name and power limit, and the one before that the kernels'
record. Without CUDA the script exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

H, W = 1080, 1920
T_CHUNK = 16
N_FRAMES = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_source(at, frames, device, chunk):
    """FramedArray at the reference's criterion-bench config: FramePerfect,
    Collapse, DeltaT, ref_time 255, delta_t_max 24 * 255, c_thresh 0."""
    src = at.FramedArray(frames, 30.0, chunk_frames=chunk, device=device)
    src.auto_time_parameters(255, 255 * 24, at.TimeMode.DeltaT)
    src.quality_manual(0, 0, 24, 1, 0)
    return src


def transcode_raw(at, frames, device, path, chunk):
    """Frames -> .adder file through FramedArray / Video submit-collect
    (two chunks in flight). Returns (seconds, kernel event count)."""
    src = bench_source(at, frames, device, chunk)
    with open(path, "wb") as f:
        src.write_out(at.SourceCamera.FramedU8, at.TimeMode.DeltaT,
                      at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                      at.EncoderOptions.default(src.video.plane), f)
        video = src.get_video_mut()
        t0 = time.perf_counter()
        pendings = [video.submit_chunk(frames[i : i + chunk])
                    for i in range(0, len(frames), chunk)]
        video.end_write_stream()
        sync(device)
        dt = time.perf_counter() - t0
    n_kernel = sum(int(p["outs"].per_interval.sum()) for p in pendings)
    return dt, n_kernel


def void_mpx(at, frames, chunk, device) -> float:
    """H x W pixels per second through the Empty-sink path (events never
    leave the device), host frames included."""
    src = bench_source(at, frames, device, chunk)
    video = src.get_video_mut()
    video.void_events = True
    video.submit_chunk(frames[:chunk])  # warm-up chunk
    video.flush()
    sync(device)
    t0 = time.perf_counter()
    for i in range(0, len(frames), chunk):
        video.submit_chunk(frames[i : i + chunk])
    video.flush()
    sync(device)
    dt = time.perf_counter() - t0
    return frames.shape[1] * frames.shape[2] * len(frames) / dt / 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "one NVIDIA GPU", file=sys.stderr)
        return 2
    import adder_tpu_torch as at
    from adder_tpu_torch import testing
    from adder_tpu_torch.ops import cuda_build
    from adder_tpu_torch.ops import fused_resident as FR
    from adder_tpu_torch.ops import integrate as ops

    dev = torch.device("cuda")
    card = card_line()
    log(f"# card: {card}")
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- phase 1: build --------------------------------------------------
    fresh = not cuda_build.library_path().exists()
    t0 = time.perf_counter()
    cuda_build.load()
    build_s = time.perf_counter() - t0
    log(f"# phase 1: kernels {'built' if fresh else 'loaded (cached)'} in "
        f"{build_s:.2f} s: {cuda_build.library_path().name}")
    regs, spills = [], []
    for line in cuda_build.build_log().splitlines():
        if "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split("registers")[0]))
        if "spill stores" in line:
            spills.append(int(line.split("bytes spill stores")[0].split()[-1]))
    if regs:
        log(f"# ptxas: {len(regs)} kernels, registers {min(regs)}..{max(regs)}"
            f", spill stores max {max(spills or [0])} bytes")

    # -- phase 2: kernels against plain, bit for bit ----------------------
    t0 = time.perf_counter()
    max_err = testing.check_kernels_against_plain(dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    big = torch.randint(0, 2816, (64, 24300), generator=gen, dtype=torch.int32)
    scan_err = testing.bitwise_max_err(
        FR.exclusive_scan(big.to(dev)), FR.exclusive_scan_plain(big).to(dev),
        "exclusive scan",
    )
    torch.cuda.synchronize()
    log(f"# phase 2: kernels == plain on 8 modes x depth 6/8 x 2 chunks + "
        f"forced overflow (max abs err {max_err}); scan == plain past 2^31 "
        f"(max abs err {scan_err}); {time.perf_counter() - t0:.1f} s")

    # -- phase 3: the main path at 1080p mono -----------------------------
    t0 = time.perf_counter()
    scene = testing.moving_blobs(H, W, N_FRAMES, seed=7, device=dev)
    frames = scene.cpu().numpy()[..., None]  # (T, H, W, 1) u8 host frames
    log(f"# phase 3: scene {frames.shape} made in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "main.adder")
        FR.reset_launch_counts()
        raw_s, n_kernel = transcode_raw(at, frames, dev, path, T_CHUNK)
        launches = dict(FR.LAUNCHES)
        if min(launches.values()) < 1:
            raise AssertionError(f"main path missed a kernel: {launches}")
        dec = at.open_file_decoder(path)
        events = dec.digest_all()
        n_decoded = len(events)
        if n_decoded != n_kernel or n_kernel == 0:
            raise AssertionError(
                f"decoded {n_decoded} events, the kernel counted {n_kernel}"
            )
        size = os.path.getsize(path)
        log(f"# phase 3: 1080p mono Raw: {N_FRAMES} frames, {n_kernel} events"
            f", {size} bytes, {raw_s:.3f} s (first run), launches {launches}")
        raw_s2, _ = transcode_raw(at, frames, dev, path, T_CHUNK)
        raw_mpx = H * W * N_FRAMES / raw_s2 / 1e6
        log(f"# phase 3: Raw-sink path {raw_mpx} Mpx/s ({raw_s2} s for "
            f"{N_FRAMES} frames, second run) [{card}]")

        a, b = os.path.join(tmp, "cuda8.adder"), os.path.join(tmp, "cpu8.adder")
        transcode_raw(at, frames[:8], dev, a, 8)
        t0 = time.perf_counter()
        transcode_raw(at, frames[:8], "cpu", b, 8)
        cpu_s = time.perf_counter() - t0
        with open(a, "rb") as fa, open(b, "rb") as fb:
            same = fa.read() == fb.read()
        if not same:
            raise AssertionError("first 8 frames: card and CPU .adder differ")
        log(f"# phase 3: first 8 frames byte-identical on card and CPU "
            f"({os.path.getsize(a)} bytes; CPU plain run {cpu_s:.1f} s)")

    # -- phase 4: timings --------------------------------------------------
    p = ops.TranscodeParams(mode=0, multi_mode=1, time_mode=0, ref_time=255,
                            delta_t_max=255 * 24, c_thresh_max=0,
                            c_increase_velocity=1)
    f16 = scene[:T_CHUNK].reshape(T_CHUNK, -1).contiguous()
    st = ops.set_initial_d(
        ops.init_state(H * W, dev, c_thresh=0, depth=6), f16[0].to(torch.int32)
    )
    st = FR.group_chunk_resident(st, f16, 255.0, p).state  # mid-stream
    f16 = scene[T_CHUNK : 2 * T_CHUNK].reshape(T_CHUNK, -1).contiguous()
    counts = torch.randint(0, 12, (T_CHUNK, -(-H * W // FR.BLOCK)),
                           generator=gen, dtype=torch.int32).to(dev)
    # the kernels against plain once more, at the main path's shapes
    want = FR.fused_chunk_resident_plain(st, f16, 255.0, p)
    max_err = max(
        max_err,
        testing.compare_chunks(FR.fused_chunk_resident(st, f16, 255.0, p),
                               want, "1080p chunk"),
        testing.compare_chunks(FR.group_chunk_resident(st, f16, 255.0, p),
                               want._replace(pixd=None, t=None),
                               "1080p void chunk"),
    )
    scan_err = max(scan_err, testing.bitwise_max_err(
        FR.exclusive_scan(counts), FR.exclusive_scan_plain(counts),
        "1080p scan",
    ))
    log(f"# phase 4: kernels == plain at 1080p mono T={T_CHUNK} "
        f"({len(want.pixd)} events)")
    k_ms = cuda_ms(lambda: FR.fused_chunk_resident(st, f16, 255.0, p), 10)
    p_ms = cuda_ms(lambda: FR.fused_chunk_resident_plain(st, f16, 255.0, p), 2)
    v_ms = cuda_ms(lambda: FR.group_chunk_resident(st, f16, 255.0, p), 10)
    vp_ms = cuda_ms(lambda: FR.group_chunk_resident_plain(st, f16, 255.0, p), 2)
    s_ms = cuda_ms(lambda: FR.exclusive_scan(counts), 50)
    sp_ms = cuda_ms(lambda: FR.exclusive_scan_plain(counts), 50)
    log(f"# phase 4: 1080p mono T={T_CHUNK} chunk [{card}]:")
    log(f"#   fetched chunk (COUNT+scan+WRITE) {k_ms} ms, plain {p_ms} ms; "
        f"void chunk {v_ms} ms, plain {vp_ms} ms; scan {s_ms} ms, plain "
        f"{sp_ms} ms")
    log(f"#   device-only: void {H * W * T_CHUNK / v_ms / 1e3} Mpx/s, "
        f"fetched {H * W * T_CHUNK / k_ms / 1e3} Mpx/s")
    mono = void_mpx(at, frames, T_CHUNK, dev)
    scene_c = torch.stack(
        [testing.moving_blobs(H, W, N_FRAMES, seed=s, device=dev)
         for s in (7, 8, 9)], dim=-1,
    ).cpu().numpy()
    color = void_mpx(at, scene_c, T_CHUNK, dev)
    log(f"# phase 4: void path (host frames in, Empty sink) 1080p mono "
        f"{mono} Mpx/s, colour {color} Mpx/s (H x W pixels) [{card}]")

    record = {"kernels": [
        {"name": "adder_resident_chunk", "route": "cuda",
         "source": "adder_tpu_torch/csrc/fused_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:676",
         "launches": launches["adder_resident_chunk"],
         "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms},
        {"name": "adder_exclusive_scan", "route": "cuda",
         "source": "adder_tpu_torch/csrc/fused_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:676",
         "launches": launches["adder_exclusive_scan"],
         "max_abs_err": scan_err, "ms": s_ms, "plain_ms": sp_ms},
    ]}
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
