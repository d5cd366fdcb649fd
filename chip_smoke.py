#!/usr/bin/env python3
"""Smoke run of adder_tpu_torch on one NVIDIA GPU: build, check, transcode, time.

Usage, from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit; build the CUDA kernels from
     adder_tpu_torch/csrc (one nvcc per source, in parallel, at first use),
     time the build and report ptxas registers and spills;
  2. every kernel against its plain PyTorch version on the card, bit for
     bit: a ragged 200x150 plane, 2 chunks of T = 8, all 8 mode cases,
     depth 6 and 8, a forced depth-6 overflow; the multi-block scan at 0, 1,
     37, 4096, 4097, 129,600 and 524,288 counts (a total past 2^31), each
     also from an input off the 16-byte boundary;
  3. the main path: 1080p mono, the reference's bench config, 64 frames of
     a seeded moving-blob scene, FramedArray(device="cuda") -> Video
     submit/collect -> Raw .adder in a temporary directory. The launch
     counters must rise, the decoded event count must equal the kernel's,
     and the first 8 frames must give the same bytes on the card and on
     the CPU;
  4. timings: kernel against plain version at 1080p mono, T = 16; the scan
     at (16, 8100) counts beside torch.cumsum, and at 524,288, each timed
     from the host and on the card alone; the Empty-sink (void) path at 1080p mono and colour;
  5. the DVS lane kernel (K3) against its plain version, bit for bit, by
     both routes. Dense (adder_dvs_chunk, planes): a ragged 200x150 plane,
     the bootstrap chunk, T = 2, 38 and 128 in two chained groups planned
     from a seeded stream, Normal and Collapse, WRITE and VOID, a forced
     depth-16 overflow. Rows (adder_dvs_rows, the carrier): the same groups,
     modes and passes, a group with no rows, one whose rows sit in one pixel, rows with one half or
     both off, the forced overflow; each also equal to the dense kernel on
     planes built from the same carrier, and the grouping glue's kernels
     (adder_rows_group) equal to their plain version in torch ops;
  6. the Prophesee path at 640x480 (the DSEC Gen3.1 VGA sensor) with the
     CLI defaults (ref_time 20, crf 3, Collapse, AbsoluteT, Raw sink,
     view_fps 60) on a seeded 1.0 s, 2,000,000-event stream, through
     Prophesee(20, path, device="cuda"): every lane group must go through
     adder_dvs_rows, the dense kernel may run only the bootstrap and the
     flush, and the decoded event count must equal the kernels'; the first
     0.05 s must
     give the same bytes on the card and on the CPU; a bulk run (view_fps 1,
     Empty sink, void) must run segmented windows and T = 128 groups;
  7. timings on one 64-lane group at 640x480 (T = 128): the row route
     fetched and void, with and without its grouping glue, the glue alone beside its plain version;
     the dense kernel and its plane scatter beside them; both against
     plain; end-to-end Mev/s
     (windowed Raw, bulk void); a stage breakdown of the windowed Raw run;
  8. the DAVIS lane kernel (K4) against its plain version, bit for bit: a
     ragged 61x47 plane, lanes planned from a seeded burst by the port's
     planner, T = 1, 37 and 128 in two chained groups, Normal and Collapse,
     WRITE and VOID, a forced depth-16 overflow;
  9. the DAVIS path at 346x260 (the DAVIS346 of MVSEC) with the CLI
     settings of tools/davis_to_adder.py -t raw-davis (ref_time 255, tps
     255e6, delta_t_max 255e6, the manual quality 5, 5, 3921, 1, 2.0, Raw
     sink) on a seeded, uncompressed aedat4 stream (1.0 s, 1,000,000 DVS
     events, 40 APS frames of 10 ms), through Davis(EdiReconstructor(path),
     device="cuda"): the K4 and K3 launch counters must rise and the
     decoded event count must equal the kernels'; the first 4 packets must
     give the same bytes on the card and on the CPU; a void run must end in
     the fetched run's state;
  10. timings: K4 against plain on the largest packet's chunk; the dense
     K3 kernel at the T = 1 shape of the frame and gap chunks; end-to-end
     Mev/s and APS frames/s; a stage breakdown; the device's busy share;
  11. the fused one-interval kernel (K5) against its plain version, bit for
     bit: a ragged 200x150 plane, 2 chained chunks of T = 8 written from a
     non-zero offset, all 8 mode cases, depth 6 and 8, pack 4 and 16, plane
     padding, the four view modes, the display on and off; pack 2
     overflowing, a forced depth-6 overflow, a buffer too small;
  12. the interval-slot kernel (K6) against its plain version, bit for bit:
     the same plane, 16 chained intervals, all 8 mode cases at depth 8, the
     four view modes, a forced overflow (the count); the slot chunk on the
     card against the CPU;
  13. the main path of phase 3 once per one-interval engine
     (ADDER_TPU_RESIDENT=0: fused, K5; ADDER_TPU_FUSED=0: interval slots,
     K6) with the display frame kept (`_keep_running_frame = True`): the
     engine's launch counter must rise by at least 64, the decoded event
     count must equal the engine's, the .adder bytes must equal the
     resident engine's from phase 3, and the first 8 frames (two chunks of
     4, the display frame chained on the card) must give the same bytes and
     display frames on the card and on the CPU;
  14. timings: K5 and K6 against plain at 1080p mono, mid-stream, with
     their bounds; the slot engine's compaction glue per interval; each
     engine's Raw Mpx/s, stage breakdown and device busy share, and the
     resident engine's stage breakdown beside them.
Every kernel of the record carries its bound: the bytes it must move over
3.35 TB/s, counted for the lane kernels (K3, K4) from the active cells
and pixels of the chunk (the dense-plane figure is logged beside it), for
K5 from the interval's state and its event count, for K6 from its state
and its dense slot planes.
The last line is {"ok": true, "device": {...}}; the line before it holds
the card's name and power limit, and the one before that the kernels'
record. Without CUDA the script exits non-zero and prints no result.
"""

import contextlib
import hashlib
import json
import os
import re
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
DAVIS_W, DAVIS_H = 346, 260
DAVIS_FRAMES = 40
DAVIS_PREFIX_PACKETS = 4
# H100 SXM HBM3 peak (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12


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


def file_digest(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@contextlib.contextmanager
def engine_env(name):
    """The JAX package's engine switch `name` set to 0 inside the block
    (Video reads it when it is built)."""
    old = os.environ.get(name)
    os.environ[name] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


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


def cuda_ms_queued(fn, reps: int) -> float:
    """As `cuda_ms`, for a call that never waits for the card: the card is
    kept busy while the host enqueues every call, so the events time the
    launches back to back on the card, without the host's dispatch time
    between them."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # about 25 ms of spinning on the card
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rows_ms(fn, state, reps: int, clone) -> float:
    """`cuda_ms` of fn(state) for a function that updates the state it is
    given in place: every call gets its own copy of `state`, made before
    the clock starts."""
    copies = iter([clone(state) for _ in range(reps + 1)])
    return cuda_ms(lambda: fn(next(copies)), reps)


def state_bytes(state) -> int:
    """Bytes of a PixelState's per-pixel fields (the overflow scalar aside)."""
    return sum(x.numel() * x.element_size() for x in state[:-1])


def bound(nbytes: int) -> float:
    """Milliseconds to move `nbytes` at the HBM rate. No kernel of the port
    multiplies matrices, so the bytes bound them."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def chunk_bound(state, planes, n_events: int) -> float:
    """The bound of one chunk over dense inputs (a framed chunk, where every
    pixel runs every interval): each input plane read once, the state read
    and written once, each event's (pix << 8 | d, t) pair written once."""
    return bound(sum(x.numel() * x.element_size() for x in planes)
                 + 2 * state_bytes(state) + 8 * n_events)


def lane_chunk_bound(state, planes, n_events: int) -> float:
    """The bound of one lane chunk (K3, K4; the last plane is fv | active <<
    8) from what this chunk's data needs. An inactive (sub-step, pixel) cell
    carries nothing the function reads, so the inputs are each active cell's
    pixel index and plane values (4 B each: 16 B for K3, the 20-byte carrier
    row for K4); the state of each pixel active in the chunk is read once
    and written once; each event's (pix << 8 | d, t) pair is written once."""
    active = ((planes[-1] >> 8) & 1).bool()
    n_pix = active.shape[1]
    cells, pixels = int(active.sum()), int(active.any(0).sum())
    return bound(cells * 4 * (1 + len(planes))
                 + 2 * pixels * state_bytes(state) // n_pix + 8 * n_events)


def kernel_source(name: str) -> str:
    """Which kernel a mangled name instantiates: a one-interval kernel by its
    name, a chunk kernel by its last template argument, the source
    (adder_interval.cuh SRC_FRAMED / DVS / DAVIS)."""
    if "adder_fused_interval_kernel" in name:
        return "fused interval (K5)"
    if "adder_interval_slots_kernel" in name:
        return "interval slots (K6)"
    if "adder_lane_rows_kernel" in name:
        return "DVS rows (K3)"
    if "adder_exclusive_scan_kernel" in name:
        return "scan"
    m = re.search(r"ELi(\d)E+v", name)
    return {"0": "framed (K1/K2)", "1": "DVS (K3)", "2": "DAVIS (K4)"}.get(
        m.group(1) if m else "", "other")


def ptxas_report(text: str) -> dict:
    """Kernel (mangled name) -> registers and spill bytes, from -Xptxas=-v."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
            out[cur] = {"regs": 0, "stack": 0, "spill_st": 0, "spill_ld": 0}
        elif cur and "spill stores" in line:
            words = line.replace(",", "").split()
            out[cur]["stack"] = int(words[0])
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


def transcode_raw(at, frames, device, path, chunk, keep_running=False,
                  before=None):
    """Frames -> .adder file through FramedArray / Video submit-collect
    (two chunks in flight), the display frame kept if `keep_running`;
    `before(video)` runs after write_out. Returns (seconds, kernel event
    count, the Video)."""
    src = bench_source(at, frames, device, chunk)
    with open(path, "wb") as f:
        src.write_out(at.SourceCamera.FramedU8, at.TimeMode.DeltaT,
                      at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                      at.EncoderOptions.default(src.video.plane), f)
        video = src.get_video_mut()
        video._keep_running_frame = keep_running
        if before:
            before(video)
        t0 = time.perf_counter()
        pendings = [video.submit_chunk(frames[i : i + chunk])
                    for i in range(0, len(frames), chunk)]
        video.end_write_stream()
        sync(device)
        dt = time.perf_counter() - t0
    n_kernel = sum(int(p["outs"].per_interval.sum()) for p in pendings)
    return dt, n_kernel, video


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


class Stages:
    """Host-clock stage timers for a staged run: each wrapper synchronises
    after the call it times. `seconds` maps stage name -> seconds."""

    def __init__(self, names):
        self.seconds = {k: 0.0 for k in names}
        self.packed_at = 0.0
        self.carrier_bytes = 0

    def timed(self, stage):
        def make(orig):
            def f(*a, **k):
                t0 = time.perf_counter()
                r = orig(*a, **k)
                torch.cuda.synchronize()
                self.seconds[stage] += time.perf_counter() - t0
                return r
            return f
        return make

    def pack(self, orig):
        """The carrier pack; the h2d copy runs from its end to unpack."""
        def f(g):
            t0 = time.perf_counter()
            r = orig(g)
            self.packed_at = time.perf_counter()
            self.seconds["pack"] += self.packed_at - t0
            self.carrier_bytes += r.nbytes
            return r
        return f

    def unpack(self, orig):
        """The carrier unpack, timed as scatter; the copy before it as h2d."""
        def f(carrier):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.seconds["h2d"] += t0 - self.packed_at
            r = orig(carrier)
            torch.cuda.synchronize()
            self.seconds["scatter"] += time.perf_counter() - t0
            return r
        return f

    def rows(self, orig):
        """The row wrapper: the copy before it as h2d, its grouping glue
        (timed inside it by `timed("group")`) apart from its kernels, its
        event fetch as fetch."""
        def f(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.seconds["h2d"] += t0 - self.packed_at
            g0 = self.seconds["group"]
            r = orig(*a, **k)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.seconds["kernels"] += t1 - t0 - (self.seconds["group"] - g0)
            if r.pixd is not None:
                r = r._replace(pixd=r.pixd.cpu(), t=r.t.cpu())
            self.seconds["fetch"] += time.perf_counter() - t1
            return r
        return f

    def kernels(self, stage):
        """A chunk wrapper timed as `stage`, its event fetch as fetch."""
        def make(orig):
            def f(*a, **k):
                t0 = time.perf_counter()
                r = orig(*a, **k)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                self.seconds[stage] += t1 - t0
                if r.pixd is not None:
                    r = r._replace(pixd=r.pixd.cpu(), t=r.t.cpu())
                self.seconds["fetch"] += time.perf_counter() - t1
                return r
            return f
        return make


def staged_prophesee_run(at, path, dev, raw_path, dvs_batch, FR, TP):
    """The windowed Raw run with every stage timed on the host clock and a
    synchronise after it: decode, the window search, plan, pack, host ->
    device carrier copy, group (the row route's grouping glue: two sorts and
    the cell ranks), kernels (COUNT + scan + WRITE, with the host read of
    the total; the row kernel for the lane groups, the dense one for the
    bootstrap and the flush), event fetch, unpacking the wire pairs to x,
    y, d, t, encode; "other" is the rest of the wall (the loop, event
    arrays, the bootstrap and end-of-stream planes)."""
    S = Stages(("decode", "window", "plan", "pack", "h2d", "group",
                "kernels", "fetch", "unpack", "encode"))
    st = S.seconds
    P = Patches()
    P.wrap(TP, "decode_events_np", S.timed("decode"))
    P.wrap(dvs_batch, "plan_dvs_compact", S.timed("plan"))
    P.wrap(FR, "pack_dvs_plan", S.pack)
    P.wrap(FR, "group_dvs_rows", S.timed("group"))
    P.wrap(FR, "dvs_rows_resident", S.rows)
    P.wrap(FR, "dvs_chunk_resident", S.kernels("kernels"))
    P.wrap(dvs_batch, "wire_to_events", S.timed("unpack"))

    def window(orig):
        def f():  # the decode runs inside the first call: not counted twice
            d0, t0 = st["decode"], time.perf_counter()
            r = orig()
            st["window"] += time.perf_counter() - t0 - (st["decode"] - d0)
            return r
        return f

    def before(src):
        P.wrap(src.video.encoder, "ingest_event_array", S.timed("encode"))
        P.wrap(src, "_next_dvs_batch", window)

    try:
        wall, src = prophesee_run(at, path, dev, raw_path, before=before)
    finally:
        P.restore()
    st["other"] = wall - sum(st.values())
    return wall, st, S.carrier_bytes


def dvs_phases(dev, card):
    """Phases 5-7 (the Prophesee path). Returns (the dense K3 kernel's and
    the row route's max abs err against plain, the windowed run's launch
    counts, the timings and bound at T = 128 of the dense kernel, of the
    row route and of its grouping glue)."""
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
    t0 = time.perf_counter()
    rows_err = testing.check_dvs_rows_against_plain(dev)
    torch.cuda.synchronize()
    log(f"# phase 5: K3 rows == plain == dense K3 on 200x150: T = 2/38/128 x "
        f"2 chained groups, Normal and Collapse, WRITE and VOID, "
        f"no rows, one pixel's rows, halves off, forced "
        f"depth-16 overflow; state in place (max abs err {rows_err}); "
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
        P.wrap(FR, "dvs_rows_resident", count_events)
        FR.reset_launch_counts()
        try:
            first_s, _ = prophesee_run(at, raw_in, dev, out)
        finally:
            P.restore()
        dvs_launches = dict(FR.LAUNCHES)
        if min(dvs_launches["adder_dvs_rows"], dvs_launches["adder_dvs_chunk"],
               dvs_launches["adder_rows_group"],
               dvs_launches["adder_exclusive_scan"]) < 1:
            raise AssertionError(f"Prophesee path missed a kernel: "
                                 f"{dvs_launches}")
        # dense: COUNT + WRITE of the bootstrap and of the flush, no more
        if dvs_launches["adder_dvs_chunk"] != 4:
            raise AssertionError(f"a lane group ran the dense kernel: "
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
            def f(st, carrier, T, *a, **kw):
                depths.append(T)
                return orig(st, carrier, T, *a, **kw)
            return f

        P.wrap(dvs_batch, "plan_dvs_compact", count_plans)
        P.wrap(FR, "dvs_rows_resident", record_t)
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
            f"segments, {len(depths)} row groups, T up to {max(depths)}; "
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
        carrier = torch.from_numpy(packed).to(dev)
        fields = FR.unpack_dvs_carrier(carrier)
        planes = FR.build_dvs_planes(FR.MAX_T, n, *fields, ref_time=20)
        active = float(((planes[2] >> 8) & 1).float().mean())
        # rows (WRITE and VOID) and the dense kernel's fetched
        # chunk against the plain version; then the dense VOID pass
        e, want = testing.check_rows_group(st_dvs, carrier, FR.MAX_T, p_dvs,
                                           "T=128 group")
        rows_err = max(rows_err, e)
        dvs_err = max(dvs_err, e, testing.compare_chunks(
            FR.dvs_chunk_resident(st_dvs, *planes, p_dvs, events=False),
            want._replace(pixd=None, t=None), "T=128 void"))
        groups = FR.group_dvs_rows(carrier, FR.MAX_T)
        log(f"# phase 7: K3 == plain and K3 rows == plain == K3 on the "
            f"{DVS_W}x{DVS_H} T=128 group ({len(g.pix)} planned rows, "
            f"{int(groups.n_active)} pixels with rows, longest "
            f"{int((groups.row_start[1:] - groups.row_start[:-1]).max())} "
            f"rows, {active:.4%} of (sub-step, pixel) active, "
            f"{len(want.pixd)} events)")
        k3_ms = cuda_ms(lambda: FR.dvs_chunk_resident(st_dvs, *planes, p_dvs),
                        10)
        k3v_ms = cuda_ms(lambda: FR.dvs_chunk_resident(
            st_dvs, *planes, p_dvs, events=False), 10)
        k3p_ms = cuda_ms(lambda: FR.dvs_chunk_resident_plain(
            st_dvs, *planes, p_dvs), 1)
        k3_bound = lane_chunk_bound(st_dvs, planes, len(want.pixd))
        k3v_bound = lane_chunk_bound(st_dvs, planes, 0)
        k3_dense = chunk_bound(st_dvs, planes, len(want.pixd))
        sc_ms = cuda_ms(lambda: FR.build_dvs_planes(
            FR.MAX_T, n, *FR.unpack_dvs_carrier(carrier), ref_time=20), 10)
        h2d_ms = cuda_ms(lambda: torch.from_numpy(packed).to(dev), 10)
        # the row route: the whole wrapper (glue + passes), the passes alone
        # on groups made before the clock starts, the glue alone
        glue_ms = cuda_ms(lambda: FR.group_dvs_rows(carrier, FR.MAX_T), 20)
        glue_p_ms = cuda_ms(lambda: FR.group_dvs_rows_plain(carrier,
                                                            FR.MAX_T), 20)
        glue_q_ms = cuda_ms_queued(
            lambda: FR.group_dvs_rows(carrier, FR.MAX_T), 20)
        sort_ms = cuda_ms(lambda: torch.sort(carrier[0]), 20)
        E = carrier.shape[1]
        # carrier row 0 read; order, row_start, the two cell arrays written
        glue_bound = bound(4 * E + 8 * (4 * E + 2) + 8 * (FR.MAX_T + 2))
        rows_t = {}
        for events in (True, False):
            rows_t["fetched" if events else "void"] = (
                rows_ms(lambda st: FR.dvs_rows_resident(
                    st, carrier, FR.MAX_T, p_dvs, events=events), st_dvs, 10,
                    FR.clone_state),
                rows_ms(lambda st: FR._dvs_rows_cuda(
                    st, carrier, FR.MAX_T, p_dvs, events, groups), st_dvs, 10,
                    FR.clone_state))
        r_ms = rows_t["fetched"][0]  # the wrapper's own time, glue included
        rp_ms = cuda_ms(lambda: FR.dvs_rows_resident_plain(
            st_dvs, carrier, FR.MAX_T, p_dvs), 1)
        log(f"# phase 7: {DVS_W}x{DVS_H} T=128 group [{card}]:")
        log(f"#   dense K3 fetched (COUNT+scan+WRITE) {k3_ms} ms, void "
            f"{k3v_ms} ms, plain {k3p_ms} ms; unpack + scatter into 3 x "
            f"(128, {n}) planes {sc_ms} ms; bound {k3_bound} ms, void bound "
            f"{k3v_bound} ms (active cells and pixels; dense-plane format "
            f"{k3_dense} ms)")
        for what, (with_glue, alone) in rows_t.items():
            log(f"#   K3 rows, {what}: {with_glue} ms with glue, {alone} ms "
                f"the passes alone")
        log(f"#   row grouping glue: {glue_ms} ms ({glue_q_ms} ms on the "
            f"card alone), its plain version in torch ops {glue_p_ms} ms, "
            f"one torch.sort of {E} int32 keys {sort_ms} ms, bound "
            f"{glue_bound} ms")
        log(f"#   K3 rows: plain {rp_ms} ms; the wrapper {r_ms} ms fetched "
            f"(the bound is {k3_bound / r_ms:.2%} of it)")
        log(f"#   carrier h2d {packed.nbytes} bytes in {h2d_ms} ms "
            f"({packed.nbytes / h2d_ms / 1e3} MB/s, pageable)")
        wall, stages, nbytes = staged_prophesee_run(
            at, raw_in, dev, out, dvs_batch, FR, TP)
        log(f"# phase 7: windowed Raw stage breakdown, {wall} s wall "
            f"({n_in / wall / 1e6} Mev/s with a synchronise after each "
            f"stage; {nbytes} carrier bytes) [{card}]:")
        for name, sec in stages.items():
            log(f"#   {name:8s} {sec:.6f} s  {sec / wall:.1%}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    return (dvs_err, rows_err, dvs_launches,
            dict(ms=k3_ms, plain_ms=k3p_ms, bound_ms=k3_bound),
            dict(ms=r_ms, plain_ms=rp_ms, bound_ms=k3_bound),
            dict(ms=glue_ms, plain_ms=glue_p_ms, bound_ms=glue_bound))


def davis_run(at, path, device, raw_path=None, before=None):
    """tools/davis_to_adder.py -t raw-davis with its defaults: Davis over
    EdiReconstructor(path) on its worker thread, Collapse, AbsoluteT, the
    manual quality the CLI sets without --crf; a Raw sink into `raw_path`,
    or with None the Empty sink and void events. `before(src)` runs after
    write_out. Returns (seconds from the source's construction, which
    starts the reader thread, to the closed stream; the source)."""
    t0 = time.perf_counter()
    src = at.Davis(at.EdiReconstructor(path), ref_time=255, tps=255_000_000,
                   delta_t_max=255_000_000, mode=at.TranscoderMode.RawDavis,
                   device=device)
    f = open(raw_path, "wb") if raw_path else None
    try:
        src.write_out(at.SourceCamera.DavisU8, at.TimeMode.AbsoluteT,
                      at.PixelMultiMode.Collapse, None,
                      at.EncoderType.Raw if f else at.EncoderType.Empty,
                      at.EncoderOptions.default(src.plane), f)
        src.get_video_ref().update_quality_manual(5, 5, 3921, 1, 2.0)
        src.void_events = f is None
        if before:
            before(src)
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


def staged_davis_run(at, path, dev, raw_path, dvs_batch, FR):
    """The Raw run with every stage timed on the host clock and a
    synchronise after it: set-up (the source's construction, write_out and
    the quality call, up to the first consume), the wait on the aedat4 +
    EDI worker thread, plan, pack, host -> device carrier copy, unpack +
    scatter into planes, K4 chunks (COUNT + scan + WRITE, with the host
    read of the total), the K3 frame and gap chunks, event fetch, the frame
    and gap planes on the host and their copy to the card ("frame host":
    the gap and frame steps less their chunks and fetches), unpacking the
    wire pairs, encode; "other" is the rest of the wall (the consume loop,
    event arrays, the end of the stream)."""
    S = Stages(("set-up", "provider", "plan", "pack", "h2d", "scatter",
                "K4", "K3 frames", "fetch", "frame host", "unpack", "encode"))
    st = S.seconds
    P = Patches()
    P.wrap(dvs_batch, "plan_davis_events_compact", S.timed("plan"))
    P.wrap(FR, "pack_davis_plan", S.pack)
    P.wrap(FR, "unpack_davis_carrier", S.unpack)
    P.wrap(FR, "build_davis_planes", S.timed("scatter"))
    P.wrap(FR, "davis_chunk_resident", S.kernels("K4"))
    P.wrap(FR, "dvs_chunk_resident", S.kernels("K3 frames"))
    P.wrap(dvs_batch, "wire_to_events", S.timed("unpack"))

    def provider(orig_iter):
        class Timed:
            def __next__(self):
                t0 = time.perf_counter()
                try:
                    return next(orig_iter)
                finally:
                    st["provider"] += time.perf_counter() - t0
        return Timed()

    def frame_host(orig):
        def f(*a, **k):
            inner = st["K3 frames"] + st["fetch"]
            t0 = time.perf_counter()
            r = orig(*a, **k)
            torch.cuda.synchronize()
            st["frame host"] += (time.perf_counter() - t0
                                 - (st["K3 frames"] + st["fetch"] - inner))
            return r
        return f

    def before(src):
        P.wrap(src.video.encoder, "ingest_event_array", S.timed("encode"))
        P.wrap(src, "_integrate_frame_gaps", frame_host)
        P.wrap(src, "_integrate_frame", frame_host)
        src._iter = provider(src._iter)
        st["set-up"] = time.perf_counter() - t_start

    t_start = time.perf_counter()
    try:
        wall, src = davis_run(at, path, dev, raw_path, before=before)
    finally:
        P.restore()
    st["other"] = wall - sum(st.values())
    return wall, st


def davis_phases(dev, card):
    """Phases 8-10 (the DAVIS path). Returns the K4 record entry's numbers
    and the DAVIS run's launch counts."""
    import numpy as np

    import adder_tpu_torch as at
    from adder_tpu_torch import testing
    from adder_tpu_torch.ops import dvs_batch
    from adder_tpu_torch.ops import fused_resident as FR

    # -- phase 8: the DAVIS lane kernel (K4) against plain, bit for bit ----
    t0 = time.perf_counter()
    k4_err = testing.check_davis_kernel_against_plain(dev)
    torch.cuda.synchronize()
    log(f"# phase 8: K4 == plain on 61x47: T = 1/37/128 x 2 chained groups, "
        f"Normal and Collapse, WRITE and VOID, forced depth-16 overflow "
        f"(max abs err {k4_err}); {time.perf_counter() - t0:.1f} s")

    # -- phase 9: the DAVIS path at 346x260 ----------------------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_davis_")
    try:
        t0 = time.perf_counter()
        events, frames = testing.davis_stream(
            21, DAVIS_W, DAVIS_H, 1_000_000, n_frames=DAVIS_FRAMES,
            exposure_us=10_000, n_hot=100, hot_events=1000,
            edge_events=600_000, background_events=300_000)
        n_in = len(events[0])
        path = os.path.join(tmp, "davis.aedat4")
        testing.write_davis_aedat4(path, DAVIS_W, DAVIS_H, events, frames)
        k = int(np.searchsorted(events[0],
                                frames[DAVIS_PREFIX_PACKETS - 1][2]))
        prefix = os.path.join(tmp, "prefix.aedat4")
        testing.write_davis_aedat4(prefix, DAVIS_W, DAVIS_H,
                                   tuple(a[:k] for a in events),
                                   frames[:DAVIS_PREFIX_PACKETS])
        log(f"# phase 9: aedat4 {DAVIS_W}x{DAVIS_H}, {n_in} DVS events and "
            f"{len(frames)} APS frames over 1.0 s ({os.path.getsize(path)} "
            f"bytes, uncompressed) written in "
            f"{time.perf_counter() - t0:.1f} s")

        out = os.path.join(tmp, "davis.adder")
        kernel_events, biggest, frame_chunk = [], {}, {}
        P = Patches()

        def count_events(orig):
            def f(*a, **kw):
                r = orig(*a, **kw)
                kernel_events.append(r.per_interval.sum())
                return r
            return f

        def keep_frame_chunk(orig):
            def f(state, *planes_p, **kw):
                frame_chunk.update(state=state, args=planes_p[:3])
                return orig(state, *planes_p, **kw)
            return f

        def keep_biggest(orig):
            def f(state, *planes_p, **kw):
                T = planes_p[0].shape[0]
                if T > biggest.get("T", 0):
                    biggest.update(T=T, state=state, args=planes_p[:4])
                return orig(state, *planes_p, **kw)
            return f

        P.wrap(FR, "dvs_chunk_resident", count_events)
        P.wrap(FR, "dvs_chunk_resident", keep_frame_chunk)
        P.wrap(FR, "davis_chunk_resident", count_events)
        P.wrap(FR, "davis_chunk_resident", keep_biggest)
        FR.reset_launch_counts()
        try:
            first_s, fetched = davis_run(at, path, dev, out)
        finally:
            P.restore()
        launches = dict(FR.LAUNCHES)
        if min(launches["adder_davis_chunk"], launches["adder_dvs_chunk"],
               launches["adder_exclusive_scan"]) < 1:
            raise AssertionError(f"DAVIS path missed a kernel: {launches}")
        n_kernel = int(sum(int(x) for x in kernel_events))
        n_decoded = len(at.open_file_decoder(out).digest_all())
        if n_decoded != n_kernel or n_kernel == 0:
            raise AssertionError(f"decoded {n_decoded} ADΔER events, the "
                                 f"kernels counted {n_kernel}")
        log(f"# phase 9: Raw: {n_kernel} ADΔER events, "
            f"{os.path.getsize(out)} bytes, {first_s:.3f} s (first run), "
            f"launches {launches}")

        _, void = davis_run(at, path, dev, None)
        for name, a, b in zip(fetched.state._fields, fetched.state,
                              void.state):
            if not torch.equal(a, b):
                raise AssertionError(f"void run state.{name} differs from "
                                     f"the fetched run's")
        log("# phase 9: the void run (Empty sink) ends in the fetched run's "
            "state")

        a, b = os.path.join(tmp, "cuda.adder"), os.path.join(tmp, "cpu.adder")
        davis_run(at, prefix, dev, a)
        cpu_s, _ = davis_run(at, prefix, "cpu", b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"first {DAVIS_PREFIX_PACKETS} packets: "
                                     f"card and CPU .adder differ")
        log(f"# phase 9: first {DAVIS_PREFIX_PACKETS} packets byte-identical "
            f"on card and CPU ({os.path.getsize(a)} bytes; CPU plain run "
            f"{cpu_s:.1f} s)")

        # -- phase 10: timings -------------------------------------------------
        p = fetched._params()
        st, planes = biggest["state"], biggest["args"]
        want = FR.davis_chunk_resident_plain(st, *planes, p)
        k4_err = max(
            k4_err,
            testing.compare_chunks(FR.davis_chunk_resident(st, *planes, p),
                                   want, "largest DAVIS chunk"),
            testing.compare_chunks(
                FR.davis_chunk_resident(st, *planes, p, events=False),
                want._replace(pixd=None, t=None), "largest DAVIS void chunk"),
        )
        active = int(((planes[3] >> 8) & 1).sum())
        k4_ms = cuda_ms(lambda: FR.davis_chunk_resident(st, *planes, p), 10)
        k4v_ms = cuda_ms(lambda: FR.davis_chunk_resident(
            st, *planes, p, events=False), 10)
        k4p_ms = cuda_ms(lambda: FR.davis_chunk_resident_plain(
            st, *planes, p), 1)
        k4_bound = lane_chunk_bound(st, planes, len(want.pixd))
        k4v_bound = lane_chunk_bound(st, planes, 0)
        k4_dense = chunk_bound(st, planes, len(want.pixd))
        pixels = int(((planes[3] >> 8) & 1).any(0).sum())
        log(f"# phase 10: largest DAVIS chunk T={biggest['T']} at "
            f"{DAVIS_W}x{DAVIS_H} ({active} active (sub-step, pixel) of "
            f"{planes[0].numel()}, {pixels} active pixels, "
            f"{len(want.pixd)} events) [{card}]:")
        log(f"#   K4 fetched (COUNT+scan+WRITE) {k4_ms} ms, void {k4v_ms} ms, "
            f"plain {k4p_ms} ms; bound {k4_bound} ms, void bound {k4v_bound} "
            f"ms (active cells and pixels; dense-plane format {k4_dense} ms)")

        st1, planes1 = frame_chunk["state"], frame_chunk["args"]
        want1 = FR.dvs_chunk_resident(st1, *planes1, p)
        k3f_ms = cuda_ms(lambda: FR.dvs_chunk_resident(st1, *planes1, p), 20)
        log(f"#   dense K3 at the frame chunk's shape, T="
            f"{planes1[0].shape[0]} ({len(want1.pixd)} events): fetched "
            f"{k3f_ms} ms, bound "
            f"{lane_chunk_bound(st1, planes1, len(want1.pixd))} ms")

        wall, _ = davis_run(at, path, dev, out)
        log(f"# phase 10: end to end (Raw, second run): {n_in / wall / 1e6} "
            f"Mev/s, {len(frames) / wall} APS frames/s ({wall} s for {n_in} "
            f"DVS events and {len(frames)} frames) [{card}]")
        t0 = time.perf_counter()
        n_pk = sum(1 for _ in at.EdiReconstructor(path))
        edi_s = time.perf_counter() - t0
        log(f"# phase 10: aedat4 read + EDI alone (one thread): {edi_s} s "
            f"for {n_pk} packets [{card}]")
        busy = device_busy_seconds(lambda: davis_run(at, path, dev, out))
        log(f"# phase 10: Raw run under torch.profiler: device busy {busy} s "
            f"(kernels and copies), {busy / wall:.2%} of the second run's "
            f"wall [{card}]" if busy else
            "# phase 10: device busy share not measured (the profiler saw "
            "no device time)")
        wall, stages = staged_davis_run(at, path, dev, out, dvs_batch, FR)
        log(f"# phase 10: Raw stage breakdown, {wall} s wall "
            f"({n_in / wall / 1e6} Mev/s with a synchronise after each "
            f"stage) [{card}]:")
        for name, sec in stages.items():
            log(f"#   {name:9s} {sec:.6f} s  {sec / wall:.1%}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    return dict(err=k4_err, ms=k4_ms, plain_ms=k4p_ms,
                bound_ms=k4_bound), launches


def staged_framed_run(at, frames, dev, path, keep_running=True):
    """The 1080p Raw run (the display kept if `keep_running`; the resident
    engine cannot keep it) with each stage timed on the host
    clock and a synchronise after it: chunks (every chunk call, reruns
    included: the kernels and, on the slot engine, the compaction), fetch
    (the events' device -> host copy), unpack (wire pairs to x, y, c, d, t),
    encode, and submit (submit_chunk less the stages inside it: the frames'
    host -> device copy, the initial state, and the control reads and
    display fetch of the chunks it collects); "other" is the rest of the
    wall (the end of the stream's control reads and display fetches, the
    loop). Returns (wall seconds, stage -> seconds)."""
    S = Stages(("submit", "chunks", "fetch", "unpack", "encode"))
    st = S.seconds
    P = Patches()

    def less_inner(stage, inner):
        def make(orig):
            def f(*a, **k):
                i0, t0 = sum(st[s] for s in inner), time.perf_counter()
                r = orig(*a, **k)
                torch.cuda.synchronize()
                st[stage] += (time.perf_counter() - t0
                              - (sum(st[s] for s in inner) - i0))
                return r
            return f
        return make

    def before(video):
        P.wrap(video, "_run_chunk", S.timed("chunks"))
        P.wrap(video, "_events_from_flat", S.timed("unpack"))
        P.wrap(video.encoder, "ingest_event_array", S.timed("encode"))
        P.wrap(video, "_ingest", less_inner("fetch", ("unpack", "encode")))
        P.wrap(video, "submit_chunk", less_inner(
            "submit", ("chunks", "fetch", "unpack", "encode")))

    try:
        wall, _, _ = transcode_raw(at, frames, dev, path, T_CHUNK,
                                   keep_running=keep_running, before=before)
    finally:
        P.restore()
    st["other"] = wall - sum(st.values())
    return wall, st


def interval_phases(dev, card, scene, main_digest, st6, p):
    """Phases 11-14 (the one-interval engines). `scene` is phase 3's (T, H,
    W) u8 scene on the card, `main_digest` the resident engine's .adder
    digest, `st6` phase 4's mid-stream depth-6 state (after the scene's
    first chunk), `p` the bench parameters. Returns the K5 and K6 record
    entries."""
    import numpy as np

    import adder_tpu_torch as at
    from adder_tpu_torch import testing
    from adder_tpu_torch.ops import fused_kernel as FK
    from adder_tpu_torch.ops import fused_resident as FR
    from adder_tpu_torch.ops import integrate as ops
    from adder_tpu_torch.ops import pallas_kernel as PK

    # -- phases 11-12: K5 and K6 against plain, bit for bit ---------------
    t0 = time.perf_counter()
    k5_err = testing.check_fused_interval_against_plain(dev)
    torch.cuda.synchronize()
    log(f"# phase 11: K5 == plain on 200x150: 8 modes x depth 6/8 x pack "
        f"4/16, 2 chained chunks of T = 8 from a non-zero offset, plane "
        f"padding, 4 view modes, display on and off; pack-2 overflow, forced "
        f"depth-6 overflow, a buffer too small (max abs err {k5_err}); "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    k6_err = testing.check_interval_slots_against_plain(dev)
    torch.cuda.synchronize()
    log(f"# phase 12: K6 == plain on 200x150: 8 modes at depth 8, 16 chained "
        f"intervals, 4 view modes, forced overflow count; the slot chunk on "
        f"the card == on the CPU (max abs err {k6_err}); "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 13: the 1080p path once per one-interval engine -------------
    frames = scene.cpu().numpy()[..., None]
    engines = (("fused", "ADDER_TPU_RESIDENT", FK, "adder_fused_interval"),
               ("slots", "ADDER_TPU_FUSED", PK, "adder_interval_slots"))
    launches, mpx = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "engine.adder")
        for engine, env, mod, name in engines:
            with engine_env(env):
                mod.reset_launch_counts()
                FR.reset_launch_counts()
                raw_s, n_kernel, video = transcode_raw(
                    at, frames, dev, path, T_CHUNK, keep_running=True)
                launches[name] = mod.LAUNCHES[name]
                if video.engine != engine or launches[name] < N_FRAMES:
                    raise AssertionError(
                        f"{engine} engine: {video.engine}, {launches[name]} "
                        f"{name} launches for {N_FRAMES} frames")
                if FR.LAUNCHES["adder_resident_chunk"]:
                    raise AssertionError(f"{engine} engine ran the resident "
                                         f"kernel")
                n_decoded = len(at.open_file_decoder(path).digest_all())
                if n_decoded != n_kernel or n_kernel == 0:
                    raise AssertionError(
                        f"{engine}: decoded {n_decoded} events, the engine "
                        f"counted {n_kernel}")
                if file_digest(path) != main_digest:
                    raise AssertionError(f"{engine}: the .adder bytes differ "
                                         f"from the resident engine's")
                shown = video.running_intensities
                if shown.shape != (H, W, 1) or not shown.any():
                    raise AssertionError(f"{engine}: display frame "
                                         f"{shown.shape}, all zero")
                log(f"# phase 13: {engine} engine ({env}=0), 1080p mono Raw, "
                    f"display kept: {n_kernel} events, the resident engine's "
                    f"{os.path.getsize(path)} bytes exactly, {raw_s:.3f} s "
                    f"(first run), {launches[name]} {name} launches, capacity "
                    f"x{video._cap_mult}, pack {video._pack}, depth "
                    f"{video.state.node_d.shape[0]}")

                a = os.path.join(tmp, "cuda8.adder")
                b = os.path.join(tmp, "cpu8.adder")
                _, _, va = transcode_raw(at, frames[:8], dev, a, 4,
                                         keep_running=True)
                t0 = time.perf_counter()
                _, _, vb = transcode_raw(at, frames[:8], "cpu", b, 4,
                                         keep_running=True)
                cpu_s = time.perf_counter() - t0
                if file_digest(a) != file_digest(b):
                    raise AssertionError(f"{engine}: first 8 frames, card and "
                                         f"CPU .adder differ")
                if not (np.array_equal(va.running_intensities,
                                       vb.running_intensities)
                        and torch.equal(va._last_runnings.cpu(),
                                        vb._last_runnings)):
                    raise AssertionError(f"{engine}: first 8 frames, card and "
                                         f"CPU display frames differ")
                log(f"# phase 13: {engine}: first 8 frames (2 chunks of 4) "
                    f"byte-identical on card and CPU, display frames equal "
                    f"({os.path.getsize(a)} bytes; CPU plain run "
                    f"{cpu_s:.1f} s)")

                raw_s2, _, _ = transcode_raw(at, frames, dev, path, T_CHUNK,
                                             keep_running=True)
                mpx[engine] = H * W * N_FRAMES / raw_s2 / 1e6
                log(f"# phase 14: {engine} engine Raw-sink path, display "
                    f"kept: {mpx[engine]} Mpx/s ({raw_s2} s for {N_FRAMES} "
                    f"frames, second run) [{card}]")
                busy = device_busy_seconds(lambda: transcode_raw(
                    at, frames, dev, path, T_CHUNK, keep_running=True))
                log(f"# phase 14: {engine} Raw run under torch.profiler: "
                    f"device busy {busy} s (kernels and copies), "
                    f"{busy / raw_s2:.2%} of the second run's wall [{card}]"
                    if busy else
                    f"# phase 14: {engine} device busy share not measured "
                    f"(the profiler saw no device time)")
                wall, stages = staged_framed_run(at, frames, dev, path)
                log(f"# phase 14: {engine} Raw stage breakdown, {wall} s wall "
                    f"({H * W * N_FRAMES / wall / 1e6} Mpx/s with a "
                    f"synchronise after each stage) [{card}]:")
                for s, sec in stages.items():
                    log(f"#   {s:7s} {sec:.6f} s  {sec / wall:.1%}")
        # the same breakdown on the default engine, for comparison
        wall, stages = staged_framed_run(at, frames, dev, path,
                                         keep_running=False)
        log(f"# phase 14: resident engine Raw stage breakdown (display off), "
            f"{wall} s wall ({H * W * N_FRAMES / wall / 1e6} Mpx/s with a "
            f"synchronise after each stage) [{card}]:")
        for s, sec in stages.items():
            log(f"#   {s:7s} {sec:.6f} s  {sec / wall:.1%}")

    # -- phase 14: K5 and K6 at 1080p mono, mid-stream ---------------------
    n = H * W
    frame = scene[T_CHUNK].reshape(-1).contiguous()
    st8 = ops.pad_state_depth(st6, ops.DEPTH)
    cap = ops.K_SLOTS * n

    def k5(fn, bufs, emit=True):
        return fn(st6, frame, 255.0, torch.tensor(7, device=dev), bufs, p, 4,
                  emit)

    def new_bufs():
        return (torch.full((cap,), -1, dtype=torch.int32, device=dev),
                torch.full((cap,), -1, dtype=torch.int32, device=dev))

    got_b, want_b = new_bufs(), new_bufs()
    got, want = k5(FK.fused_interval, got_b), k5(FK.fused_interval_plain,
                                                  want_b)
    k5_err = max(k5_err, testing.state_max_err(got.state, want.state, "1080p K5"),
                 *(testing.bitwise_max_err(getattr(got, f), getattr(want, f),
                                           f"1080p K5 {f}")
                   for f in ("offset", "flags", "run_val", "run_has")),
                 testing.bitwise_max_err(got_b[0], want_b[0], "1080p K5 pixd"),
                 testing.bitwise_max_err(got_b[1], want_b[1], "1080p K5 t"))
    n_ev5 = int(want.offset) - 7
    k5_ms = cuda_ms(lambda: k5(FK.fused_interval, got_b), 20)
    k5p_ms = cuda_ms(lambda: k5(FK.fused_interval_plain, want_b), 2)
    # frame read; state read and written; run_val, run_has written; events
    k5_bound = bound(n + 2 * state_bytes(st6) + 2 * n + 8 * n_ev5)

    got = PK.interval_slots(st8, frame, 255.0, p)
    want = PK.interval_slots_plain(st8, frame, 255.0, p)
    k6_err = max(k6_err, testing.state_max_err(got[0], want[0], "1080p K6"), *(
        testing.bitwise_max_err(a, b, f"1080p K6 {f}") for a, b, f in zip(
            (*got[1:4], *got[4]), (*want[1:4], *want[4]),
            ("slot_d", "slot_t", "slot_m", "run_val", "run_has"))))
    n_ev6 = int(want[3].sum())
    k6_ms = cuda_ms(lambda: PK.interval_slots(st8, frame, 255.0, p), 20)
    k6p_ms = cuda_ms(lambda: PK.interval_slots_plain(st8, frame, 255.0, p), 2)
    # frame read; state read and written; K slot planes (i32, u32, u8) and
    # run_val, run_has written
    k6_bound = bound(n + 2 * state_bytes(st8) + 9 * ops.K_SLOTS * n + 2 * n)

    _, sd, stt, sm, _ = got
    take = ops.per_interval_take(n * T_CHUNK, T_CHUNK)
    glue_bufs = new_bufs()
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def glue():
        packed = ops._pack_slots(sd, stt, sm, 4)
        pixd_i, t_i, n_ev = ops._compact_interval(*packed[:3], take)
        ops._merge_prefix(glue_bufs, zero, pixd_i, t_i, n_ev, take)

    glue_ms = cuda_ms(glue, 10)
    f16 = scene[T_CHUNK : 2 * T_CHUNK].reshape(T_CHUNK, -1).contiguous()
    run0 = torch.zeros(n, dtype=torch.uint8, device=dev)
    fused_ms = cuda_ms(lambda: FK.fused_chunk(st6, f16, 255.0, run0, p,
                                              n * T_CHUNK), 5)
    slots_ms = cuda_ms(lambda: ops.transcode_chunk(st8, f16, 255.0, run0, p,
                                                   n * T_CHUNK), 5)
    log(f"# phase 14: K5 == plain, K6 == plain at 1080p mono mid-stream "
        f"({n_ev5} and {n_ev6} events in the interval)")
    log(f"# phase 14: 1080p mono, one interval [{card}]:")
    log(f"#   K5 (depth 6, pack 4, display) {k5_ms} ms, plain {k5p_ms} ms, "
        f"bound {k5_bound} ms")
    log(f"#   K6 (depth 8) {k6_ms} ms, plain {k6p_ms} ms, bound {k6_bound} ms")
    log(f"#   slot glue (pack 4, compact, merge; take {take}) {glue_ms} ms")
    log(f"# phase 14: 1080p mono T={T_CHUNK} chunk, device-only [{card}]: "
        f"fused {fused_ms} ms ({n * T_CHUNK / fused_ms / 1e3} Mpx/s), slots "
        f"{slots_ms} ms ({n * T_CHUNK / slots_ms / 1e3} Mpx/s)")

    return [
        {"name": "adder_fused_interval", "route": "cuda",
         "source": "adder_tpu_torch/csrc/fused_interval.cu",
         "replaces": "adder_tpu/ops/fused_kernel.py:526",
         "launches": launches["adder_fused_interval"], "max_abs_err": k5_err,
         "ms": k5_ms, "plain_ms": k5p_ms, "bound_ms": k5_bound,
         "bound_by": "bytes", "library_ms": None},
        {"name": "adder_interval_slots", "route": "cuda",
         "source": "adder_tpu_torch/csrc/interval_slots.cu",
         "replaces": "adder_tpu/ops/pallas_kernel.py:114",
         "launches": launches["adder_interval_slots"], "max_abs_err": k6_err,
         "ms": k6_ms, "plain_ms": k6p_ms, "bound_ms": k6_bound,
         "bound_by": "bytes", "library_ms": None},
    ]


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
    for what in ("framed (K1/K2)", "scan", "DVS (K3)", "DVS rows (K3)",
                 "DAVIS (K4)", "fused interval (K5)", "interval slots (K6)"):
        ks = {k: v for k, v in ptx.items()
              if "_kernel" in k and kernel_source(k) == what}
        if ks:
            regs = [v["regs"] for v in ks.values()]
            log(f"# ptxas {what}: {len(ks)} kernels, registers "
                f"{min(regs)}..{max(regs)}, stack frame max "
                f"{max(v['stack'] for v in ks.values())} bytes, spill stores max "
                f"{max(v['spill_st'] for v in ks.values())} bytes, spill "
                f"loads max {max(v['spill_ld'] for v in ks.values())} bytes")
    for k, v in ptx.items():
        if kernel_source(k) in ("DVS (K3)", "DVS rows (K3)", "DAVIS (K4)",
                                "scan", "other"):
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
    scan_err = max(scan_err, testing.check_scan_against_plain(dev))
    torch.cuda.synchronize()
    log(f"# phase 2: kernels == plain on 8 modes x depth 6/8 x 2 chunks + "
        f"forced overflow (max abs err {max_err}); scan == plain at "
        f"{testing.SCAN_SIZES} counts, aligned and unaligned, "
        f"and at (64, 24300) past 2^31 (max abs err {scan_err}); "
        f"{time.perf_counter() - t0:.1f} s")

    # -- phase 3: the main path at 1080p mono -----------------------------
    t0 = time.perf_counter()
    scene = testing.moving_blobs(H, W, N_FRAMES, seed=7, device=dev)
    frames = scene.cpu().numpy()[..., None]  # (T, H, W, 1) u8 host frames
    log(f"# phase 3: scene {frames.shape} made in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "main.adder")
        FR.reset_launch_counts()
        raw_s, n_kernel, _ = transcode_raw(at, frames, dev, path, T_CHUNK)
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
        main_digest = file_digest(path)
        log(f"# phase 3: 1080p mono Raw: {N_FRAMES} frames, {n_kernel} events"
            f", {size} bytes, {raw_s:.3f} s (first run), launches {launches}")
        raw_s2, _, _ = transcode_raw(at, frames, dev, path, T_CHUNK)
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
    # the scan beside the library yardstick, one torch.cumsum of the same
    # counts (int64): each the best of two loops, the scan's around cumsum's
    s_lib_ms = cuda_ms(lambda: torch.cumsum(counts.reshape(-1), 0), 50)
    s_ms = cuda_ms(lambda: FR.exclusive_scan(counts), 50)
    s_ms = min(s_ms, cuda_ms(lambda: FR.exclusive_scan(counts), 50))
    sp_ms = cuda_ms(lambda: FR.exclusive_scan_plain(counts), 50)
    s_lib_ms = min(s_lib_ms,
                   cuda_ms(lambda: torch.cumsum(counts.reshape(-1), 0), 50))
    zero_ms = cuda_ms(lambda: torch.zeros(65, dtype=torch.int64, device=dev),
                      50)
    # the same three with the host's dispatch time taken out
    q_ms = cuda_ms_queued(lambda: FR.exclusive_scan(counts), 50)
    q_lib_ms = cuda_ms_queued(lambda: torch.cumsum(counts.reshape(-1), 0), 50)
    q_zero_ms = cuda_ms_queued(
        lambda: torch.zeros(65, dtype=torch.int64, device=dev), 50)
    cells = torch.randint(0, 4, (2 * 262_144,), generator=gen,
                          dtype=torch.int32).to(dev)
    big_ms = cuda_ms(lambda: FR.exclusive_scan(cells), 50)
    big_lib_ms = cuda_ms(lambda: torch.cumsum(cells, 0), 50)
    q_big_ms = cuda_ms_queued(lambda: FR.exclusive_scan(cells), 50)
    q_big_lib_ms = cuda_ms_queued(lambda: torch.cumsum(cells, 0), 50)
    k_bound = chunk_bound(st, [f16], len(want.pixd))
    v_bound = chunk_bound(st, [f16], 0)
    s_bound = bound(counts.numel() * 4 + (counts.numel() + 1) * 8)
    log(f"# phase 4: 1080p mono T={T_CHUNK} chunk [{card}]:")
    log(f"#   fetched chunk (COUNT+scan+WRITE) {k_ms} ms, plain {p_ms} ms, "
        f"bound {k_bound} ms; void chunk {v_ms} ms, plain {vp_ms} ms, bound "
        f"{v_bound} ms")
    log(f"#   scan of (16, 8100) counts, {FR.SCAN_TILE} a block: {s_ms} ms "
        f"(best of two loops of 50; its scratch memset included, alone "
        f"{zero_ms} ms), plain {sp_ms} ms, torch.cumsum {s_lib_ms} ms, bound "
        f"{s_bound} ms")
    log(f"#   the same on the card alone (every call enqueued while the card "
        f"is kept busy): scan {q_ms} ms, its scratch memset alone "
        f"{q_zero_ms} ms, torch.cumsum {q_lib_ms} ms")
    log(f"#   scan of 524,288 counts: {big_ms} ms, torch.cumsum "
        f"{big_lib_ms} ms; on the card alone {q_big_ms} ms, "
        f"torch.cumsum {q_big_lib_ms} ms; bound "
        f"{bound(cells.numel() * 4 + (cells.numel() + 1) * 8)} ms")
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

    dvs_err, rows_err, dvs_launches, k3, k3r, glue = dvs_phases(dev, card)
    k4, davis_launches = davis_phases(dev, card)
    k5_k6 = interval_phases(dev, card, scene, main_digest, st, p)

    record = {"kernels": [
        {"name": "adder_resident_chunk", "route": "cuda",
         "source": "adder_tpu_torch/csrc/fused_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:676",
         "launches": launches["adder_resident_chunk"],
         "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": k_bound, "bound_by": "bytes", "library_ms": None},
        {"name": "adder_exclusive_scan", "route": "cuda",
         "source": "adder_tpu_torch/csrc/fused_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:676",
         "launches": (launches["adder_exclusive_scan"]
                      + dvs_launches["adder_exclusive_scan"]
                      + davis_launches["adder_exclusive_scan"]),
         "max_abs_err": scan_err, "ms": s_ms, "plain_ms": sp_ms,
         "bound_ms": s_bound, "bound_by": "bytes", "library_ms": s_lib_ms,
         "queued_ms": q_ms, "queued_library_ms": q_lib_ms},
        {"name": "adder_dvs_chunk", "route": "cuda",
         "source": "adder_tpu_torch/csrc/dvs_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:1017",
         "launches": (dvs_launches["adder_dvs_chunk"]
                      + davis_launches["adder_dvs_chunk"]),
         "max_abs_err": dvs_err, "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "adder_dvs_rows", "route": "cuda",
         "source": "adder_tpu_torch/csrc/dvs_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:1159",
         "launches": dvs_launches["adder_dvs_rows"],
         "max_abs_err": rows_err, "ms": k3r["ms"],
         "plain_ms": k3r["plain_ms"], "bound_ms": k3r["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "adder_rows_group", "route": "cuda",
         "source": "adder_tpu_torch/csrc/dvs_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:1115",
         "launches": dvs_launches["adder_rows_group"],
         "max_abs_err": rows_err, "ms": glue["ms"],
         "plain_ms": glue["plain_ms"], "bound_ms": glue["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "adder_davis_chunk", "route": "cuda",
         "source": "adder_tpu_torch/csrc/davis_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:1361",
         "launches": davis_launches["adder_davis_chunk"],
         "max_abs_err": k4["err"], "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
        *k5_k6,
    ]}
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "adder_tpu"))
    if imported:
        raise AssertionError(f"imported {imported[:5]}")
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
