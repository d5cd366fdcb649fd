#!/usr/bin/env python3
"""Smoke run of adder_tpu_torch on one NVIDIA GPU: build, check, transcode, time.

Usage, from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit; build the CUDA kernels from
     adder_tpu_torch/csrc (one nvcc per source, in parallel, at first use),
     time the build and report ptxas registers and spills;
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
     Empty-sink (void) path at 1080p mono and colour;
  5. the DVS lane kernel (K3) against its plain version, bit for bit: a
     ragged 200x150 plane, the bootstrap chunk, T = 2, 38 and 128 in two
     chained groups planned from a seeded stream, Normal and Collapse, WRITE
     and VOID, a forced depth-16 overflow;
  6. the Prophesee path at 640x480 (the DSEC Gen3.1 VGA sensor) with the
     CLI defaults (ref_time 20, crf 3, Collapse, AbsoluteT, Raw sink,
     view_fps 60) on a seeded 1.0 s, 2,000,000-event stream, through
     Prophesee(20, path, device="cuda"): the launch counters must rise and
     the decoded event count must equal the kernel's; the first 0.05 s must
     give the same bytes on the card and on the CPU; a bulk run (view_fps 1,
     Empty sink, void) must run segmented windows and T = 128 groups;
  7. timings: K3 against plain on one 64-lane group at 640x480 (T = 128);
     end-to-end Mev/s (windowed Raw, bulk void); a stage breakdown of the
     windowed Raw run.
The last line is {"ok": true, "device": {...}}; the line before it holds
the card's name and power limit, and the one before that the kernels'
record. Without CUDA the script exits non-zero and prints no result.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

H, W = 1080, 1920
T_CHUNK = 16
N_FRAMES = 64
DVS_W, DVS_H = 640, 480
DVS_PREFIX_US = 50_000


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


def ptxas_report(text: str) -> dict:
    """Kernel (mangled name) -> registers and spill bytes, from -Xptxas=-v."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
            out[cur] = {"regs": 0, "spill_st": 0, "spill_ld": 0}
        elif cur and "spill stores" in line:
            words = line.replace(",", "").split()
            out[cur]["spill_st"] = int(words[words.index("spill") - 2])
            out[cur]["spill_ld"] = int(words[-4])
        elif cur and "Used" in line and "registers" in line:
            out[cur]["regs"] = int(line.split("Used")[1].split("registers")[0])
    return out


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


def device_busy_seconds(fn) -> float:
    """Sum of the device time torch.profiler records over fn() (kernels
    and copies), in seconds; 0.0 when it records none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e6


class Patches:
    """Temporary wrappers around module or object functions; undone by
    restore()."""

    def __init__(self):
        self._undo = []

    def wrap(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def restore(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []


def prophesee_run(at, path, device, raw_path=None, view_fps=60,
                  before=None):
    """tools/prophesee_to_adder.py's drive with its defaults (ref_time 20,
    crf 3, Collapse, AbsoluteT): a Raw sink into `raw_path`, or with None
    the Empty sink and void events. `before(src)` runs after write_out.
    Returns (seconds from the first consume to the closed stream, src)."""
    src = at.Prophesee(20, path, view_fps=view_fps, device=device)
    src.crf(3)
    f = open(raw_path, "wb") if raw_path else None
    try:
        src.write_out(at.SourceCamera.Dvs, at.TimeMode.AbsoluteT,
                      at.PixelMultiMode.Collapse, None,
                      at.EncoderType.Raw if f else at.EncoderType.Empty,
                      at.EncoderOptions.default(src.plane), f)
        src.void_events = f is None
        if before:
            before(src)
        t0 = time.perf_counter()
        while True:
            try:
                src.consume()
            except EOFError:
                break
        src.end_write_stream()
        sync(device)
        return time.perf_counter() - t0, src
    finally:
        if f:
            f.close()


def staged_prophesee_run(at, path, dev, raw_path, dvs_batch, FR, TP):
    """The windowed Raw run with every stage timed on the host clock and a
    synchronise after it: decode, the window search, plan, pack, host ->
    device carrier copy, unpack + scatter into planes, kernels (COUNT + scan
    + WRITE, with the host read of the total), event fetch, unpacking the
    wire pairs to x, y, d, t, encode; "other" is the rest of the wall (the
    loop, event arrays, the bootstrap and end-of-stream planes)."""
    st = {k: 0.0 for k in ("decode", "window", "plan", "pack", "h2d",
                           "scatter", "kernels", "fetch", "unpack",
                           "encode")}
    mark = {"packed": 0.0}
    bytes_h2d = [0]
    P = Patches()

    def timed(stage):
        def make(orig):
            def f(*a, **k):
                t0 = time.perf_counter()
                r = orig(*a, **k)
                torch.cuda.synchronize()
                st[stage] += time.perf_counter() - t0
                return r
            return f
        return make

    def pack(orig):
        def f(g):
            t0 = time.perf_counter()
            r = orig(g)
            mark["packed"] = time.perf_counter()
            st["pack"] += mark["packed"] - t0
            bytes_h2d[0] += r.nbytes
            return r
        return f

    def unpack(orig):
        def f(carrier):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st["h2d"] += t0 - mark["packed"]
            r = orig(carrier)
            torch.cuda.synchronize()
            st["scatter"] += time.perf_counter() - t0
            return r
        return f

    def kernels(orig):
        def f(*a, **k):
            t0 = time.perf_counter()
            r = orig(*a, **k)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st["kernels"] += t1 - t0
            if r.pixd is not None:
                r = r._replace(pixd=r.pixd.cpu(), t=r.t.cpu())
            st["fetch"] += time.perf_counter() - t1
            return r
        return f

    P.wrap(TP, "decode_events_np", timed("decode"))
    P.wrap(dvs_batch, "plan_dvs_compact", timed("plan"))
    P.wrap(FR, "pack_dvs_plan", pack)
    P.wrap(FR, "unpack_dvs_carrier", unpack)
    P.wrap(FR, "build_dvs_planes", timed("scatter"))
    P.wrap(FR, "dvs_chunk_resident", kernels)
    P.wrap(dvs_batch, "wire_to_events", timed("unpack"))

    def window(orig):
        def f():  # the decode runs inside the first call: not counted twice
            d0, t0 = st["decode"], time.perf_counter()
            r = orig()
            st["window"] += time.perf_counter() - t0 - (st["decode"] - d0)
            return r
        return f

    def before(src):
        P.wrap(src.video.encoder, "ingest_event_array", timed("encode"))
        P.wrap(src, "_next_dvs_batch", window)

    try:
        wall, src = prophesee_run(at, path, dev, raw_path, before=before)
    finally:
        P.restore()
    st["other"] = wall - sum(st.values())
    return wall, st, bytes_h2d[0]


def dvs_phases(dev, card):
    """Phases 5-7 (the Prophesee path). Returns (K3's max abs err against
    plain, the windowed run's launch counts, K3 ms, plain ms at T = 128)."""
    import numpy as np

    import adder_tpu_torch as at
    from adder_tpu_torch import testing
    from adder_tpu_torch.ops import dvs_batch
    from adder_tpu_torch.ops import fused_resident as FR
    from adder_tpu_torch.transcoder import prophesee as TP

    # -- phase 5: the DVS lane kernel (K3) against plain, bit for bit ------
    t0 = time.perf_counter()
    dvs_err = testing.check_dvs_kernel_against_plain(dev)
    torch.cuda.synchronize()
    log(f"# phase 5: K3 == plain on 200x150: bootstrap, T = 2/38/128 x 2 "
        f"chained groups, Normal and Collapse, WRITE and VOID, forced "
        f"depth-16 overflow (max abs err {dvs_err}); "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 6: the Prophesee path at 640x480 ------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dvs_")
    try:
        t0 = time.perf_counter()
        stream = testing.dvs_stream(
            11, DVS_W, DVS_H, 1_000_000, n_hot=200, hot_events=1000,
            band_events=1_260_000, background_events=540_000)
        n_in = len(stream[0])
        raw_in = os.path.join(tmp, "stream.raw")
        testing.write_prophesee_raw(raw_in, DVS_W, DVS_H, *stream)
        k = int(np.searchsorted(stream[0], DVS_PREFIX_US))
        prefix_in = os.path.join(tmp, "prefix.raw")
        testing.write_prophesee_raw(prefix_in, DVS_W, DVS_H,
                                    *(a[:k] for a in stream))
        log(f"# phase 6: stream {DVS_W}x{DVS_H}, {n_in} events over 1.0 s "
            f"({k} in the first {DVS_PREFIX_US} us) written in "
            f"{time.perf_counter() - t0:.1f} s")

        out = os.path.join(tmp, "dvs.adder")
        kernel_events = []
        P = Patches()

        def count_events(orig):
            def f(*a, **kw):
                r = orig(*a, **kw)
                kernel_events.append(r.per_interval.sum())
                return r
            return f

        P.wrap(FR, "dvs_chunk_resident", count_events)
        FR.reset_launch_counts()
        try:
            first_s, _ = prophesee_run(at, raw_in, dev, out)
        finally:
            P.restore()
        dvs_launches = dict(FR.LAUNCHES)
        if min(dvs_launches["adder_dvs_chunk"],
               dvs_launches["adder_exclusive_scan"]) < 1:
            raise AssertionError(f"Prophesee path missed a kernel: "
                                 f"{dvs_launches}")
        n_kernel = int(sum(int(x) for x in kernel_events))
        n_decoded = len(at.open_file_decoder(out).digest_all())
        if n_decoded != n_kernel or n_kernel == 0:
            raise AssertionError(f"decoded {n_decoded} ADΔER events, the "
                                 f"kernel counted {n_kernel}")
        log(f"# phase 6: windowed Raw (60 fps): {n_kernel} ADΔER events, "
            f"{os.path.getsize(out)} bytes, {first_s:.3f} s (first run), "
            f"launches {dvs_launches}")
        win_s, _ = prophesee_run(at, raw_in, dev, out)
        win_mev = n_in / win_s / 1e6
        log(f"# phase 6: windowed Raw path {win_mev} Mev/s ({win_s} s for "
            f"{n_in} input events, second run) [{card}]")
        busy = device_busy_seconds(lambda: prophesee_run(at, raw_in, dev,
                                                         out))
        log(f"# phase 6: windowed Raw under torch.profiler: device busy "
            f"{busy} s (kernels and copies), {busy / win_s:.2%} of the "
            f"second run's wall [{card}]" if busy else
            "# phase 6: device busy share not measured (the profiler saw "
            "no device time)")

        a, b = os.path.join(tmp, "cuda.adder"), os.path.join(tmp, "cpu.adder")
        prophesee_run(at, prefix_in, dev, a)
        cpu_s, _ = prophesee_run(at, prefix_in, "cpu", b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"first {DVS_PREFIX_US} us: card and CPU "
                                     f".adder differ")
        log(f"# phase 6: first {DVS_PREFIX_US} us byte-identical on card and "
            f"CPU ({os.path.getsize(a)} bytes; CPU plain run {cpu_s:.1f} s)")

        plans, depths = [0], []

        def count_plans(orig):
            def f(*a, **kw):
                plans[0] += 1
                return orig(*a, **kw)
            return f

        def record_t(orig):
            def f(st, inten, *a, **kw):
                depths.append(inten.shape[0])
                return orig(st, inten, *a, **kw)
            return f

        P.wrap(dvs_batch, "plan_dvs_compact", count_plans)
        P.wrap(FR, "dvs_chunk_resident", record_t)
        try:
            prophesee_run(at, raw_in, dev, None, view_fps=1)
        finally:
            P.restore()
        if plans[0] < 2 or max(depths) != FR.MAX_T:
            raise AssertionError(f"bulk run: {plans[0]} segments, largest "
                                 f"T {max(depths)}")
        bulk_s, _ = prophesee_run(at, raw_in, dev, None, view_fps=1)
        bulk_mev = n_in / bulk_s / 1e6
        log(f"# phase 6: bulk void (view_fps 1, Empty sink): {plans[0]} "
            f"segments, {len(depths)} chunks, T up to {max(depths)}; "
            f"{bulk_mev} Mev/s ({bulk_s} s, second run) [{card}]")

        # -- phase 7: timings ------------------------------------------------
        n = DVS_W * DVS_H
        src = at.Prophesee(20, raw_in, device=dev)
        src.crf(3)
        src.write_out(at.SourceCamera.Dvs, at.TimeMode.AbsoluteT,
                      at.PixelMultiMode.Collapse, None, at.EncoderType.Empty,
                      at.EncoderOptions.default(src.plane), None)
        src.void_events = True
        src._bootstrap()
        p_dvs, st_dvs = src._params(), src.state
        seg = TP.SEG_EVENTS_DEFAULT
        plan = dvs_batch.plan_dvs_compact(
            *(a[:seg] for a in stream), DVS_W, src.dvs_last_timestamps,
            src.dvs_last_ln_val, src.camera_theta, 20)
        g = plan.lane_slice(0, TP.LANE_GROUP)
        packed = FR.pack_dvs_plan(g)
        fields = FR.unpack_dvs_carrier(torch.from_numpy(packed).to(dev))
        planes = FR.build_dvs_planes(FR.MAX_T, n, *fields, ref_time=20)
        active = float(((planes[2] >> 8) & 1).float().mean())
        want = FR.dvs_chunk_resident_plain(st_dvs, *planes, p_dvs)
        dvs_err = max(
            dvs_err,
            testing.compare_chunks(FR.dvs_chunk_resident(st_dvs, *planes,
                                                         p_dvs),
                                   want, "T=128 group"),
            testing.compare_chunks(
                FR.dvs_chunk_resident(st_dvs, *planes, p_dvs, events=False),
                want._replace(pixd=None, t=None), "T=128 void"),
        )
        log(f"# phase 7: K3 == plain on the {DVS_W}x{DVS_H} T=128 group "
            f"({len(g.pix)} planned rows, {active:.4%} of (sub-step, pixel) "
            f"active, "
            f"{len(want.pixd)} events)")
        k3_ms = cuda_ms(lambda: FR.dvs_chunk_resident(st_dvs, *planes, p_dvs),
                        10)
        k3v_ms = cuda_ms(lambda: FR.dvs_chunk_resident(
            st_dvs, *planes, p_dvs, events=False), 10)
        k3p_ms = cuda_ms(lambda: FR.dvs_chunk_resident_plain(
            st_dvs, *planes, p_dvs), 1)
        sc_ms = cuda_ms(lambda: FR.build_dvs_planes(FR.MAX_T, n, *fields,
                                                    ref_time=20), 10)
        h2d_ms = cuda_ms(lambda: torch.from_numpy(packed).to(dev), 10)
        log(f"# phase 7: {DVS_W}x{DVS_H} T=128 group [{card}]:")
        log(f"#   K3 fetched (COUNT+scan+WRITE) {k3_ms} ms, void {k3v_ms} "
            f"ms, plain {k3p_ms} ms")
        log(f"#   carrier h2d {packed.nbytes} bytes in {h2d_ms} ms "
            f"({packed.nbytes / h2d_ms / 1e3} MB/s, pageable); unpack + "
            f"scatter into 3 x (128, {n}) planes {sc_ms} ms")
        wall, stages, nbytes = staged_prophesee_run(
            at, raw_in, dev, out, dvs_batch, FR, TP)
        log(f"# phase 7: windowed Raw stage breakdown, {wall} s wall "
            f"({n_in / wall / 1e6} Mev/s with a synchronise after each "
            f"stage; {nbytes} carrier bytes) [{card}]:")
        for name, sec in stages.items():
            log(f"#   {name:8s} {sec:.6f} s  {sec / wall:.1%}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    return dvs_err, dvs_launches, k3_ms, k3p_ms


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
    ptx = ptxas_report(cuda_build.build_log())
    for what, sel in (("framed", lambda k: "Li16E" not in k),
                      ("DVS depth 16", lambda k: "Li16E" in k)):
        ks = {k: v for k, v in ptx.items()
              if "chunk_kernel" in k and sel(k)}
        if ks:
            regs = [v["regs"] for v in ks.values()]
            log(f"# ptxas {what}: {len(ks)} kernels, registers "
                f"{min(regs)}..{max(regs)}, spill stores max "
                f"{max(v['spill_st'] for v in ks.values())} bytes, spill "
                f"loads max {max(v['spill_ld'] for v in ks.values())} bytes")
    for k, v in ptx.items():
        if "Li16E" in k:
            log(f"#   {k}: {v}")

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
        if min(launches["adder_resident_chunk"],
               launches["adder_exclusive_scan"]) < 1:
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

    dvs_err, dvs_launches, k3_ms, k3p_ms = dvs_phases(dev, card)

    record = {"kernels": [
        {"name": "adder_resident_chunk", "route": "cuda",
         "source": "adder_tpu_torch/csrc/fused_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:676",
         "launches": launches["adder_resident_chunk"],
         "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms},
        {"name": "adder_exclusive_scan", "route": "cuda",
         "source": "adder_tpu_torch/csrc/fused_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:676",
         "launches": (launches["adder_exclusive_scan"]
                      + dvs_launches["adder_exclusive_scan"]),
         "max_abs_err": scan_err, "ms": s_ms, "plain_ms": sp_ms},
        {"name": "adder_dvs_chunk", "route": "cuda",
         "source": "adder_tpu_torch/csrc/dvs_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:1017",
         "launches": dvs_launches["adder_dvs_chunk"],
         "max_abs_err": dvs_err, "ms": k3_ms, "plain_ms": k3p_ms},
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
