#!/usr/bin/env python3
"""Smoke run of adder_tpu_torch on one NVIDIA GPU: build, check, transcode, time.

Usage, from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit; build the CUDA kernels from
     adder_tpu_torch/csrc (one nvcc per source, in parallel, at first use),
     time the build and report ptxas registers and spills of every
     instantiation, and the SASS of K1's interval loop (cuobjdump);
  2. every kernel against its plain PyTorch version on the card, bit for
     bit: K1 (the one-pass chunk kernel, the scan of its segment counts,
     the segment copy) and K2 on a ragged 200x150 plane, 2 chunks of T = 8,
     all 8 mode cases, depth 6 and 8, and single chunks of T = 1 at 200x150
     and of T = 1 and 128 at 61x47; a forced depth-6 overflow; a forced
     capacity overflow (the total stays exact at a quarter of the events
     and at none, the staging pool dry, and the rerun equals plain); the
     same with K1's display output (the four view modes, from a seeded
     display frame, fetched and void); the segment copy on staging in
     shuffled slab order (a ragged plane, no events, every pixel firing);
     the multi-block scan at 0, 1,
     37, 4096, 4097, 129,600 and 524,288 counts (a total past 2^31), each
     also from an input off the 16-byte boundary;
  3. the main path: 1080p mono, the reference's bench config, 64 frames of
     a seeded moving-blob scene, FramedArray(device="cuda") -> Video
     submit/collect -> Raw .adder in a temporary directory. The launch
     counters must rise (the one-pass kernel and the copy once per chunk),
     no chunk call may wait for the card, the decoded event count must
     equal the kernel's, and the first 8 frames must give the same bytes on
     the card and on the CPU;
  4. timings: K1 fetched and K2 against plain at 1080p mono, T = 16, from
     the host and on the card alone, the kernels of a fetched chunk under
     torch.profiler, the byte bound and an issue-rate estimate; the
     segment copy alone; the scan at (16, 64800) counts (one per interval
     and warp) beside torch.cumsum, and at 524,288, each timed from the
     host and on the card alone; the Empty-sink (void) path at 1080p mono
     and colour;
  5. the DVS lane kernel by rows (K3, adder_dvs_rows, on the carrier)
     against its plain version, bit for bit, each chunk WRITE and VOID with
     the caller's state updated in place: the raster chunks at 346x260
     (T = 2, one row per pixel, with the grouping raster_row_groups, held
     equal to the glue's): the bootstrap, a flush of a partial mask, a
     DAVIS frame (its carrier built on the card and held to the host's f64
     build) and a gap, Normal and Collapse, a forced depth-16 overflow; the
     lane groups on a ragged 200x150 plane: T = 2, 38 and 128 in two
     chained groups planned from a seeded stream, Normal and Collapse, a
     group with no rows, one whose rows sit in one pixel, rows with one
     half or both off, the forced overflow; the grouping glue's kernels
     (adder_rows_group) equal to their plain version in torch ops;
  6. the Prophesee path at 640x480 (the DSEC Gen3.1 VGA sensor) with the
     CLI defaults (ref_time 20, crf 3, Collapse, AbsoluteT, Raw sink,
     view_fps 60) on a seeded 1.0 s, 2,000,000-event stream, through
     Prophesee(20, path, device="cuda"): every chunk must go through
     adder_dvs_rows (the lane groups through the glue, the bootstrap and the
     flush as raster chunks), no dense entry point may remain, and the
     decoded event count must equal the kernels'; the first 0.025 s must
     give the same bytes on the card and on the CPU; a bulk run (view_fps
     1, Empty sink, void) must run segmented windows and T = 128 groups;
  7. timings on one 64-lane group at 640x480 (T = 128): the row route
     fetched and void, with and without its grouping glue, the glue alone
     beside its plain version, against plain; end-to-end Mev/s (windowed
     Raw, bulk void); a stage breakdown of the windowed Raw run;
  8. the DAVIS lane kernel by rows (K4, adder_davis_rows, on the carrier)
     against its plain version, bit for bit, WRITE and VOID, the state
     updated in place: a ragged 61x47 plane, lanes planned from a seeded
     burst by the port's planner, T = 1, 37 and 128 in two chained groups,
     Normal and Collapse, a group with no rows, one with inactive rows, one
     whose rows sit in one pixel, a forced depth-16 overflow; the glue with
     one sub-step per lane equal to its plain version;
  9. the DAVIS path at 346x260 (the DAVIS346 of MVSEC) with the CLI
     settings of tools/davis_to_adder.py -t raw-davis (ref_time 255, tps
     255e6, delta_t_max 255e6, the manual quality 5, 5, 3921, 1, 2.0, Raw
     sink) on a seeded, uncompressed aedat4 stream (1.0 s, 1,000,000 DVS
     events, 40 APS frames of 10 ms), through Davis(EdiReconstructor(path),
     device="cuda"): the K4 and K3 row counters must rise, no dense entry
     point may remain, and the decoded event count must equal the kernels';
     the first 2 packets must give the same bytes on the card and on the
     CPU; a void run must end in the fetched run's state;
  10. timings: K4 by rows on the largest packet's chunk, fetched and void,
     with and without its glue, against plain; the raster T = 2 K3 chunk at
     the frame chunk's shape; end-to-end Mev/s and APS frames/s; a stage
     breakdown; the device's busy share;
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
  14. timings: K5 (from the host, on the card alone and under
     torch.profiler) and K6 against plain at 1080p mono, mid-stream, with
     their bounds; the slot engine's compaction glue per interval; each
     engine's Raw Mpx/s, stage breakdown and device busy share, and the
     resident engine's stage breakdown beside them;
  15. feature detection: the main path of phase 3 with
     update_detect_features(True, Instant, False, False) on each engine
     (resident: K1 with its display output; fused: K5; slots: K6): the
     engine's launch counter must rise, the .adder bytes must equal phase
     3's by sha256, and the feature set and the display frame with its
     markers must be one across the engines; the first 8 frames (two
     chunks of 4) must give the same bytes, feature set and display frame
     on the card and on the CPU, on the bench scene and, with crf 5, the
     rate adjustment and clustering on, on a 1080p scene of moving shapes
     (the bench scene's smooth display frame has few corners); a checkpoint
     taken after chunk 2 and resumed in a fresh Video must continue the
     uninterrupted run's bytes and end on its display frame;
  16. timings: K1 and K2 with and without the display at 1080p mono, T =
     16, in turns, from the host and on the card alone, with their bounds; fast_mask_torch per chunk; the features-on Raw wall
     beside the features-off one; a stage breakdown of the features-on run;
  17. simulproc at 1080p: phase 3's 64 frames as a FramedArray source at 30
     fps with the defaults of tools/adder_simulproc.py (ref_time 255,
     delta_t_max 7650, crf 3, AbsoluteT, Normal), Raw sink, through
     SimulProcessor (the card transcodes, a host thread frames the fetched
     events with FrameSequence): K1's counters must rise; the first 8
     frames' .adder and reconstructed frames must equal the CPU plain
     path's; the wall, frames/s, the framer thread's busy share, the main
     thread's waits on its queue, and the card's busy share under
     torch.profiler;
  18. the device framer at 1080p on both chain modes: phase 3's .adder
     (DeltaT, made again) and phase 17's (AbsoluteT), decoded whole, framed
     by DeviceFramer on the card (a warm pass, then a timed ingest and
     drain; its window holding every frame an event fills, its builder the
     header's, though phase 3's D_EMPTY fillers span more than its
     delta_t_max) and by the host FrameSequence (the native walk):
     every frame equal bit for bit, and phase 17's equal to the frames its
     framer thread wrote; Mev/s of both, the batches, the peak memory; the
     card's operations per batch, the top device operations of the framer
     step and its busy share under torch.profiler over its first batches;
  19. the file sources: a seeded 640x360 colour clip of 24 frames written
     with cv2.VideoWriter (FFV1, lossless), read by Framed (colour) and
     FramedStream (mono) with cv2 decode on the card (the card's host has
     cv2 but no libav to link the ffmpeg decoder against): K1's counter
     must rise and each .adder must equal Framed's on the CPU;
  20. sharded on the one card: phase 3's 64 frames through ShardedVideo
     with k = 2 and 4 pixel bands on cuda:0 (Raw sink, k = 2 traced with
     the stage tracer on and no chunk call waiting for the card): each
     .adder must hash to phase 3's constant and K1's pass and copy counters
     rise by k a chunk; a k = 4 Empty-sink run (K2 per band) must end in
     the single-device void run's state; a k = 2 features-on run (K1's
     display per band) must give phase 15's feature and display digest and
     phase 3's bytes; one 1080p chunk through fused_chunk_sharded (K5) and
     transcode_chunk_sharded (K6) at k = 2 and 4 must give, merged, the
     single-device chunk's events, display frames and state bit for bit;
     the Raw wall and the void Mpx/s at k = 2 and 4 in turns with the
     single-device run (recorded, no claim: every band runs on one card);
  21. multi-process on the one card: two processes under gloo, both on
     cuda:0, started as torchrun starts them (this script with
     --band-job), each decoding only its host_rows band of phase 3's
     scene, transcoding its pixel slice and writing a part file; rank 0
     merges the parts into a Raw .adder that must hash to phase 3's
     constant. A process that fails or outlives its timeout fails the
     phase;
  22. the command-line tools on the card, each main(argv) in-process with
     the default --torch-device cuda, the launch counts set to 0 before
     each and read after, on the inputs of phases 3, 6, 9 and 19 made
     again from their seeds: prophesee_to_adder (phase 6's digest, K3),
     davis_to_adder -t raw-davis (phase 9's, K4 and K3), adder_simulproc on
     phase 3's scene written as lossless FFV1 (decoded by cv2 to the scene
     bit for bit first; phase 17's two digests, K1), adder_to_framed and
     decode_benchmark --frame --device on phase 3's .adder (phase 18's
     digest; the device framer under the header's delta_t_max, equal to
     the host framer), evaluate_crf_sweep --crfs 0,3 --frames 24 (K1) and
     evaluate_feature_detection (K1's display) on phase 19's clip,
     adder_info, adder_to_dvs, adder_recompress (addrn and back) and
     migrate_raw_v0_v1_to_v2 on phase 19's .adder, and one start and stop
     of adder_viz's play tab over HTTP on 127.0.0.1:0 until a PNG frame
     comes back. A transcode tool that launched none of its kernels fails
     the phase.
The sha256 of each whole output of a full-size run (the .adder files of
phases 3, 6, 9, 17, 20, 21 and 22; the feature set and display frame of
phase 15; the reconstructed frames of phases 17, 18 and 22) is logged and held to a
constant (DIGESTS), so that a kernel which reorders events past the
prefixes the CPU checks cannot pass.
Every kernel of the record carries its bound: the bytes it must move over
3.35 TB/s, counted for the lane kernels (K3, K4) from the chunk's carrier
(20 bytes per row with an active sub-step, the state of the pixels with
active rows read and written once, 8 bytes per event), for K5 from the
interval's state and its event count, for K6 from its state and its
dense slot planes, for K1's display from K1's bytes and the display's
(run0 read, T x N written).
The last line is {"ok": true, "device": {...}}; the line before it holds
the card's name and power limit, and the one before that the kernels'
record. Without CUDA the script exits non-zero and prints no result.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W = 1080, 1920
T_CHUNK = 16
N_FRAMES = 64
DVS_W, DVS_H = 640, 480
DVS_PREFIX_US = 25_000
DAVIS_W, DAVIS_H = 346, 260
DAVIS_FRAMES = 40
DAVIS_PREFIX_PACKETS = 2
# phase 18 traces the device framer's first batches; phase 19's clip
PROFILED_BATCHES = 16
CLIP_W, CLIP_H, CLIP_FRAMES = 640, 360, 24
# H100 SXM HBM3 peak (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
# sha256 of each whole output of the seeded full-size runs (hold_digest),
# as the first card run that logged them gave them
DIGESTS = {
    "phase 3 framed 1080p mono Raw .adder":
        "b9052465fb80e8703764f8dd680ecfced79941ef9de24761c968c03910f4932c",
    "phase 6 Prophesee 640x480 windowed Raw .adder":
        "5aeed204d6735e75b7097d61c37d17cebbf8eed1f5ea53b3204046a642f50273",
    "phase 9 DAVIS 346x260 raw-davis Raw .adder":
        "36451913da1c442a1fc429e5d495bd0e0688483939a64172e4b465518ef83e86",
    "phase 15 features and display, 1080p bench scene":
        "58fcb4754be8d3554b5aa2ce72ff3f30c3ea27a8df08dd0c8ad605cbf811def5",
    "phase 17 simulproc 1080p Raw .adder":
        "6cc7a487613e867b5c0caf21b8f7da929f110217d7f4a2323d50c1922166d813",
    "phase 17 simulproc 1080p reconstructed frames":
        "ee3a370e1678176b49640897a8e62b1f9b290d87900ef190e76a97933439d6fc",
    "phase 18 framer 1080p frames of phase 3's .adder (DeltaT)":
        "dc4b77711b9e8542fe6658e4ab080d183b1780ef29ab200c1c93c5e9cdd96d58",
    "phase 18 framer 1080p frames of phase 17's .adder (AbsoluteT)":
        "ee3a370e1678176b49640897a8e62b1f9b290d87900ef190e76a97933439d6fc",
}


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


def hold_digest(name: str, digest: str) -> None:
    """Log a whole output's sha256 and hold it to DIGESTS[name]."""
    log(f"# digest {name}: {digest}")
    if digest != DIGESTS[name]:
        raise AssertionError(f"{name}: sha256 {digest}, held {DIGESTS[name]}")


def features_digest(video) -> str:
    """sha256 of a Video's feature set (sorted) and its display frame with
    the markers."""
    h = hashlib.sha256(repr(sorted(video.features)).encode())
    h.update(video.display_frame_features.tobytes())
    return h.hexdigest()


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


def rows_bound(state, carrier, n_events: int) -> float:
    """The bound of one lane chunk by rows (K3, K4) from what its carrier
    needs: each row with an active sub-step read once (its 20 carrier
    bytes; bits 27 and 28 of row 0 are a DVS row's gap and tick, bit 27 a
    DAVIS row's active bit), the state of each pixel that has an active
    row read once and written once, each event's (pix << 8 | d, t) pair
    written once. Rows and sub-steps that are off carry nothing the
    function needs."""
    meta = carrier[0]
    on = ((meta >> 27) & 3) != 0
    pixels = int(torch.unique(meta[on] & 0xFFFFF).numel())
    return bound(20 * int(on.sum()) + 2 * pixels * state_bytes(state)
                 // state.length.shape[0] + 8 * n_events)


def kernel_source(name: str) -> str:
    """Which kernel a mangled name instantiates: a one-interval kernel or
    the scan by its name, a row kernel by its last template argument (the
    carrier, adder_interval.cuh SRC_DVS / SRC_DAVIS), a framed chunk kernel
    by its last (RUN, the display)."""
    if "adder_fused_interval_kernel" in name:
        return "fused interval (K5)"
    if "adder_interval_slots_kernel" in name:
        return "interval slots (K6)"
    if "adder_exclusive_scan_kernel" in name:
        return "scan"
    if "adder_lane_rows_kernel" in name:
        m = re.search(r"ELi(\d)E+v", name)
        return {"1": "DVS rows (K3)", "2": "DAVIS rows (K4)"}.get(
            m.group(1) if m else "", "other")
    if "adder_resident_chunk_kernel" in name:
        return ("framed display (K1)" if re.search(r"ELb1E+v", name)
                else "framed (K1/K2)")
    if "adder_segment_copy_kernel" in name:
        return "segment copy"
    return "other"


# Every kernel entry the port counts (fused_resident.LAUNCHES), and every
# chunk wrapper it has: the lane chunks go by rows only.
CHUNK_KERNELS = {"adder_resident_chunk", "adder_segment_copy",
                 "adder_exclusive_scan", "adder_dvs_rows", "adder_rows_group",
                 "adder_davis_rows"}
CHUNK_WRAPPERS = ["davis_rows_resident", "dvs_rows_resident",
                  "fused_chunk_resident", "group_chunk_resident"]


def hold_one_route(FR) -> None:
    """Raise unless the port's chunk kernels and wrappers are the row route's
    and the framed ones, and nothing else."""
    wrappers = sorted(k for k in dir(FR)
                      if k.endswith("_resident") and not k.startswith("_"))
    if set(FR.LAUNCHES) != CHUNK_KERNELS or wrappers != CHUNK_WRAPPERS:
        raise AssertionError(f"chunk kernels {sorted(FR.LAUNCHES)}, "
                             f"wrappers {wrappers}")


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


def sass_lines(so_path, kernel: str) -> list:
    """(address, predicated, opcode, branch target or None) of each SASS
    instruction of one kernel of the library, from cuobjdump -sass."""
    cuobjdump = os.path.join(os.path.dirname(shutil.which("nvcc") or
                                             "/usr/local/cuda/bin/nvcc"),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", "-fun", kernel, str(so_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    labels, out, pending = {}, [], []
    for line in text.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                     r"(.*)", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        target = None
        if m.group(3).split(".")[0] in ("BRA", "BRX", "JMP"):
            t = re.search(r"\(\s*(\.L_x_\d+)\s*\)|(0x[0-9a-f]+)",
                          m.group(4))
            if t:
                target = t.group(1) or int(t.group(2), 16)
        out.append((addr, bool(m.group(2)), m.group(3), target))
    return [(a, pr, op, labels.get(t, t) if isinstance(t, str) else t)
            for a, pr, op, t in out]


def loop_issue_estimate(so_path, kernel: str) -> dict:
    """SASS instructions per iteration of a kernel's outermost loop (the
    widest backward branch): `body`, every instruction between its head and
    its back edge (all paths); `path`, the fewest instructions from the
    head to the back edge that take no conditional forward branch spanning
    more than half of the body (so the path runs the body's main work, such
    as a pixel's interval, and skips only what a quiet interval skips)."""
    ins = sass_lines(so_path, kernel)
    back = [(a, t) for a, _, op, t in ins
            if op.startswith("BRA") and isinstance(t, int) and t <= a]
    if not back:
        return {"body": 0, "path": 0}
    end, head = max(back, key=lambda x: x[0] - x[1])
    body = [x for x in ins if head <= x[0] <= end]
    index = {a: i for i, (a, _, _, _) in enumerate(body)}
    span = len(body)
    inf = float("inf")
    dist = [inf] * span
    dist[0] = 1
    for i, (a, pred, op, t) in enumerate(body):
        if dist[i] == inf or i == span - 1:
            continue
        base = op.split(".")[0]
        jumps = base in ("BRA", "BRX", "JMP") and isinstance(t, int)
        # BRA.DIV jumps only where the warp has diverged
        always = jumps and not pred and op != "BRA.DIV"
        if (jumps and t > a and t in index
                and (always or index[t] - i <= span // 2)):
            j = index[t]
            dist[j] = min(dist[j], dist[i] + 1)
        if (base == "EXIT" and not pred) or always:
            continue
        dist[i + 1] = min(dist[i + 1], dist[i] + 1)
    return {"body": span, "path": dist[-1] if dist[-1] < inf else 0}


def sm_clock_hz() -> float:
    """The card's top SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.split()[0]) * 1e6


def issue_bound_ms(instructions: int, lane_steps: int) -> float:
    """An estimate, not a bound the hardware guarantees: `instructions`
    per lane step (one pixel-interval) issued at one warp instruction per
    clock by each of the 132 SMs' 4 schedulers, 32 lanes each."""
    return instructions * lane_steps / (132 * 4 * 32 * sm_clock_hz()) * 1e3


def kernel_device_ms(fn, reps: int, names) -> dict:
    """Device milliseconds per call of each kernel whose name contains one
    of `names`, under torch.profiler over `reps` calls of fn (empty when
    the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        for name in names:
            if name in e.key and us:
                out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


def k1_timings(FR, st, frames, p, run0=None, reps: int = 10, *,
               event_cap: int) -> dict:
    """K1 with its events fetched (the chunk: the one pass, the scan and the
    segment copy, at capacity `event_cap`) and K2 (the Empty sink), each
    from the host (`cuda_ms`) and on the card alone (`cuda_ms_queued`)."""

    def fetched():
        return FR.fused_chunk_resident(st, frames, 255.0, p, run0,
                                       event_cap=event_cap)

    def void():
        return FR.group_chunk_resident(st, frames, 255.0, p, run0)

    return {"fetched": cuda_ms(fetched, reps),
            "fetched_queued": cuda_ms_queued(fetched, reps),
            "void": cuda_ms(void, reps),
            "void_queued": cuda_ms_queued(void, reps)}


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


def no_sync_in_chunks(video) -> None:
    """Make every chunk call of `video` raise on an operation that waits
    for the card (torch.cuda.set_sync_debug_mode "error"): the chunk
    launches its kernels and reads nothing back."""
    run = video._run_chunk

    def chunk(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    video._run_chunk = chunk


def copy_inputs(FR, st, frames, p, cap: int):
    """The arguments of `segment_copy` for one chunk: what the chunk kernel
    staged, its counts and their scan (one launch each, as the wrapper
    makes them)."""
    staged = {}
    orig = FR.segment_copy

    def keep(*a):
        staged["args"] = a
        return orig(*a)

    FR.segment_copy = keep
    try:
        FR.fused_chunk_resident(st, frames, 255.0, p, event_cap=cap)
    finally:
        FR.segment_copy = orig
    return staged["args"]


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


def device_events(prof) -> dict:
    """{name: (count, microseconds)} of the operations a torch.profiler
    trace recorded on the device (kernels, copies, memsets). Only the
    device-side events: an aten operator's own device time repeats its
    kernels'."""
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return out


def device_busy_seconds(fn) -> float:
    """Sum of the device time torch.profiler records over fn() (kernels
    and copies), in seconds; 0.0 when it records none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    return sum(us for _, us in device_events(prof).values()) / 1e6


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
        self.packed_at = None  # the end of the last pack not yet copied
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
        """The carrier pack; the h2d copy runs from its end to the row
        wrapper."""
        def f(g):
            t0 = time.perf_counter()
            r = orig(g)
            self.packed_at = time.perf_counter()
            self.seconds["pack"] += self.packed_at - t0
            self.carrier_bytes += r.nbytes
            return r
        return f

    def rows(self, stage):
        """A row wrapper timed as `stage`: the copy of a packed carrier
        before it as h2d (a carrier built elsewhere, as the raster chunks',
        counts no copy here), its grouping glue (timed inside it by
        `timed("group")`) apart from its kernels, its event fetch as
        fetch."""
        def make(orig):
            def f(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if self.packed_at is not None:
                    self.seconds["h2d"] += t0 - self.packed_at
                    self.packed_at = None
                g0 = self.seconds["group"]
                r = orig(*a, **k)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                self.seconds[stage] += t1 - t0 - (self.seconds["group"] - g0)
                if r.pixd is not None:
                    r = r._replace(pixd=r.pixd.cpu(), t=r.t.cpu())
                self.seconds["fetch"] += time.perf_counter() - t1
                return r
            return f
        return make

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
    the total; the row kernel for the lane groups, the bootstrap and the
    flush), event fetch, unpacking the wire pairs to x, y, d, t, encode;
    "other" is the rest of the wall (the loop, event arrays, the bootstrap
    and end-of-stream carriers and their raster groupings)."""
    S = Stages(("decode", "window", "plan", "pack", "h2d", "group",
                "kernels", "fetch", "unpack", "encode"))
    st = S.seconds
    P = Patches()
    P.wrap(TP, "decode_events_np", S.timed("decode"))
    P.wrap(dvs_batch, "plan_dvs_compact", S.timed("plan"))
    P.wrap(FR, "pack_dvs_plan", S.pack)
    P.wrap(FR, "group_dvs_rows", S.timed("group"))
    P.wrap(FR, "dvs_rows_resident", S.rows("kernels"))
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
    """Phases 5-7 (the Prophesee path). Returns (the row route's max abs err
    against plain, the windowed run's launch counts, the timings and bound
    at T = 128 of the row route and of its grouping glue)."""
    import numpy as np

    import adder_tpu_torch as at
    from adder_tpu_torch import testing
    from adder_tpu_torch.ops import dvs_batch
    from adder_tpu_torch.ops import fused_resident as FR
    from adder_tpu_torch.transcoder import prophesee as TP

    # -- phase 5: the DVS lane kernel by rows (K3) against plain -----------
    t0 = time.perf_counter()
    FR.reset_launch_counts()
    raster_err = testing.check_raster_chunks_against_plain(
        dev, H=DAVIS_H, W=DAVIS_W)
    torch.cuda.synchronize()
    if FR.LAUNCHES["adder_dvs_rows"] < 1:
        raise AssertionError(f"the raster check ran no row kernel: "
                             f"{FR.LAUNCHES}")
    log(f"# phase 5: K3 rows == plain on the raster chunks at {DAVIS_W}x"
        f"{DAVIS_H} (T = 2, raster grouping == glue): bootstrap, flush of a "
        f"partial mask, DAVIS frame (carrier built on the card == host f64) "
        f"and gap, Normal and Collapse, WRITE and VOID, forced depth-16 "
        f"overflow; state in place (max abs err {raster_err}); "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows_err = max(raster_err, testing.check_dvs_rows_against_plain(dev))
    torch.cuda.synchronize()
    log(f"# phase 5: K3 rows == plain on 200x150: T = 2/38/128 x "
        f"2 chained groups, Normal and Collapse, WRITE and VOID, "
        f"no rows, one pixel's rows, halves off, forced "
        f"depth-16 overflow; glue == plain; state in place (max abs err "
        f"{rows_err}); {time.perf_counter() - t0:.1f} s")

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
        kernel_events, raster_calls = [], []
        P = Patches()

        def count_events(orig):
            def f(*a, **kw):
                r = orig(*a, **kw)
                kernel_events.append(r.per_interval.sum())
                if kw.get("groups") is not None:
                    raster_calls.append(a[1].shape[1])
                return r
            return f

        P.wrap(FR, "dvs_rows_resident", count_events)
        FR.reset_launch_counts()
        try:
            first_s, _ = prophesee_run(at, raw_in, dev, out)
        finally:
            P.restore()
        dvs_launches = dict(FR.LAUNCHES)
        hold_one_route(FR)
        if min(dvs_launches["adder_dvs_rows"],
               dvs_launches["adder_rows_group"],
               dvs_launches["adder_exclusive_scan"]) < 1:
            raise AssertionError(f"Prophesee path missed a kernel: "
                                 f"{dvs_launches}")
        # the bootstrap (every pixel) and the flush went as raster chunks
        if len(raster_calls) != 2 or raster_calls[0] != DVS_W * DVS_H:
            raise AssertionError(f"raster chunks of {raster_calls} rows")
        n_kernel = int(sum(int(x) for x in kernel_events))
        n_decoded = len(at.open_file_decoder(out).digest_all())
        if n_decoded != n_kernel or n_kernel == 0:
            raise AssertionError(f"decoded {n_decoded} ADΔER events, the "
                                 f"kernel counted {n_kernel}")
        log(f"# phase 6: windowed Raw (60 fps): {n_kernel} ADΔER events, "
            f"{os.path.getsize(out)} bytes, {first_s:.3f} s (first run), "
            f"launches {dvs_launches}; raster chunks (bootstrap, flush) of "
            f"{raster_calls} rows")
        hold_digest("phase 6 Prophesee 640x480 windowed Raw .adder",
                    file_digest(out))
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
        meta = carrier[0]
        active = float((((meta >> 27) & 1).sum() + ((meta >> 28) & 1).sum())
                       / (FR.MAX_T * n))
        # rows (WRITE and VOID) against the plain version, the glue too
        e, want = testing.check_rows_group(st_dvs, carrier, FR.MAX_T, p_dvs,
                                           "T=128 group")
        rows_err = max(rows_err, e)
        groups = FR.group_dvs_rows(carrier, FR.MAX_T)
        log(f"# phase 7: K3 rows == plain on the "
            f"{DVS_W}x{DVS_H} T=128 group ({len(g.pix)} planned rows, "
            f"{int(groups.n_active)} pixels with rows, longest "
            f"{int((groups.row_start[1:] - groups.row_start[:-1]).max())} "
            f"rows, {active:.4%} of (sub-step, pixel) active, "
            f"{len(want.pixd)} events)")
        k3_bound = rows_bound(st_dvs, carrier, len(want.pixd))
        k3v_bound = rows_bound(st_dvs, carrier, 0)
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
                rows_ms(lambda st: FR._rows_cuda(
                    FR.SRC_DVS, st, carrier, FR.MAX_T, p_dvs, events, groups),
                    st_dvs, 10, FR.clone_state))
        r_ms = rows_t["fetched"][0]  # the wrapper's own time, glue included
        rp_ms = cuda_ms(lambda: FR.dvs_rows_resident_plain(
            st_dvs, carrier, FR.MAX_T, p_dvs), 1)
        log(f"# phase 7: {DVS_W}x{DVS_H} T=128 group [{card}]:")
        for what, (with_glue, alone) in rows_t.items():
            log(f"#   K3 rows, {what}: {with_glue} ms with glue, {alone} ms "
                f"the passes alone")
        log(f"#   row grouping glue: {glue_ms} ms ({glue_q_ms} ms on the "
            f"card alone), its plain version in torch ops {glue_p_ms} ms, "
            f"one torch.sort of {E} int32 keys {sort_ms} ms, bound "
            f"{glue_bound} ms")
        log(f"#   K3 rows: plain {rp_ms} ms; bound {k3_bound} ms, void bound "
            f"{k3v_bound} ms (the carrier's active rows, the state of their "
            f"pixels, the events); the wrapper {r_ms} ms fetched (the bound "
            f"is {k3_bound / r_ms:.2%} of it)")
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

    return (rows_err, dvs_launches,
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
    EDI worker thread, plan, pack, host -> device carrier copy, group (the
    K4 route's grouping glue), K4 rows (COUNT + scan + WRITE, with the host
    read of the total), the K3 raster chunks of the frames and the gaps to
    them, event fetch, the frame and gap carriers ("frame host": the gap
    rows on the host and the frame's u8 values to the card, the frame
    carrier built there, the raster groupings; the gap and frame steps less
    their chunks and fetches), unpacking the wire pairs, encode; "other" is
    the rest of the wall (the consume loop, event arrays, the end of the
    stream)."""
    S = Stages(("set-up", "provider", "plan", "pack", "h2d", "group",
                "K4 rows", "K3 frames", "fetch", "frame host", "unpack",
                "encode"))
    st = S.seconds
    P = Patches()
    P.wrap(dvs_batch, "plan_davis_events_compact", S.timed("plan"))
    P.wrap(FR, "pack_davis_plan", S.pack)
    P.wrap(FR, "group_dvs_rows", S.timed("group"))
    P.wrap(FR, "davis_rows_resident", S.rows("K4 rows"))
    P.wrap(FR, "dvs_rows_resident", S.kernels("K3 frames"))
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
    """Phases 8-10 (the DAVIS path). Returns the K4 record entry's numbers,
    the raster K3 chunk's at the frame chunk's shape, and the DAVIS run's
    launch counts."""
    import numpy as np

    import adder_tpu_torch as at
    from adder_tpu_torch import testing
    from adder_tpu_torch.ops import dvs_batch
    from adder_tpu_torch.ops import fused_resident as FR
    from adder_tpu_torch.transcoder.davis import frame_carrier

    # -- phase 8: the DAVIS lane kernel by rows (K4) against plain ---------
    t0 = time.perf_counter()
    FR.reset_launch_counts()
    k4_err = testing.check_davis_rows_against_plain(dev)
    torch.cuda.synchronize()
    if FR.LAUNCHES["adder_davis_rows"] < 1:
        raise AssertionError(f"the K4 check ran no row kernel: "
                             f"{FR.LAUNCHES}")
    log(f"# phase 8: K4 rows == plain on 61x47: T = 1/37/128 x 2 chained "
        f"groups, Normal and Collapse, WRITE and VOID, no rows, inactive "
        f"rows, one pixel's rows, forced depth-16 overflow; glue (one "
        f"sub-step a lane) == plain; state in place (max abs err {k4_err}); "
        f"{time.perf_counter() - t0:.1f} s")

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

        # the chunks update the state in place: keep a clone of the state
        # before the chunk, with the chunk's inputs
        def keep_frame_chunk(orig):
            def f(state, carrier, T, p, **kw):
                if not frame_chunk and carrier.shape[1] == DAVIS_W * DAVIS_H:
                    frame_chunk.update(state=FR.clone_state(state),
                                       carrier=carrier, groups=kw["groups"])
                return orig(state, carrier, T, p, **kw)
            return f

        def keep_biggest(orig):
            def f(state, carrier, T, p, **kw):
                if T > biggest.get("T", 0):
                    biggest.update(T=T, state=FR.clone_state(state),
                                   carrier=carrier)
                return orig(state, carrier, T, p, **kw)
            return f

        P.wrap(FR, "dvs_rows_resident", count_events)
        P.wrap(FR, "dvs_rows_resident", keep_frame_chunk)
        P.wrap(FR, "davis_rows_resident", count_events)
        P.wrap(FR, "davis_rows_resident", keep_biggest)
        FR.reset_launch_counts()
        try:
            first_s, fetched = davis_run(at, path, dev, out)
        finally:
            P.restore()
        launches = dict(FR.LAUNCHES)
        hold_one_route(FR)
        if min(launches["adder_davis_rows"], launches["adder_dvs_rows"],
               launches["adder_rows_group"],
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
        hold_digest("phase 9 DAVIS 346x260 raw-davis Raw .adder",
                    file_digest(out))

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
        st, carrier, T = biggest["state"], biggest["carrier"], biggest["T"]
        e, want = testing.check_rows_group(st, carrier, T, p,
                                           "largest DAVIS chunk", FR.SRC_DAVIS)
        k4_err = max(k4_err, e)
        groups = FR.group_dvs_rows(carrier, T, 1)
        k4_t = {}
        for events in (True, False):
            k4_t["fetched" if events else "void"] = (
                rows_ms(lambda s: FR.davis_rows_resident(
                    s, carrier, T, p, events=events), st, 10, FR.clone_state),
                rows_ms(lambda s: FR._rows_cuda(
                    FR.SRC_DAVIS, s, carrier, T, p, events, groups), st, 10,
                    FR.clone_state))
        k4_ms = k4_t["fetched"][0]  # the wrapper's own time, glue included
        k4p_ms = cuda_ms(lambda: FR.davis_rows_resident_plain(
            st, carrier, T, p), 1)
        k4_glue_ms = cuda_ms(lambda: FR.group_dvs_rows(carrier, T, 1), 20)
        k4_bound = rows_bound(st, carrier, len(want.pixd))
        k4v_bound = rows_bound(st, carrier, 0)
        run = groups.row_start[1:] - groups.row_start[:-1]
        log(f"# phase 10: largest DAVIS chunk T={T} at {DAVIS_W}x{DAVIS_H} "
            f"({carrier.shape[1]} rows, {int(groups.n_active)} pixels with "
            f"rows, longest {int(run.max())} rows, {len(want.pixd)} events; "
            f"K4 rows == plain) [{card}]:")
        for what, (with_glue, alone) in k4_t.items():
            log(f"#   K4 rows, {what}: {with_glue} ms with glue, {alone} ms "
                f"the passes alone")
        log(f"#   K4 rows: glue alone {k4_glue_ms} ms; plain {k4p_ms} ms; "
            f"bound {k4_bound} ms, void bound {k4v_bound} ms (the carrier's "
            f"active rows, the state of their pixels, the events)")

        st1, c1, g1 = (frame_chunk[k] for k in ("state", "carrier", "groups"))
        e, want1 = testing.check_rows_group(st1, c1, 2, p, "frame chunk",
                                            groups=g1)
        k4_err = max(k4_err, e)
        raster_ms = rows_ms(lambda s: FR.dvs_rows_resident(
            s, c1, 2, p, groups=g1), st1, 20, FR.clone_state)
        raster_v_ms = rows_ms(lambda s: FR.dvs_rows_resident(
            s, c1, 2, p, events=False, groups=g1), st1, 20, FR.clone_state)
        raster_p_ms = cuda_ms(lambda: FR.dvs_rows_resident_plain(
            st1, c1, 2, p), 2)
        n1 = c1.shape[1]
        groups_ms = cuda_ms(lambda: FR.raster_row_groups(n1, dev), 20)
        fv1 = c1[1].to(torch.uint8)
        carrier_ms = cuda_ms(lambda: frame_carrier(fv1, 255, 2_550_000.0), 20)
        raster_bound = rows_bound(st1, c1, len(want1.pixd))
        log(f"#   K3 rows at the frame chunk's shape (T = 2 raster, {n1} "
            f"rows, {len(want1.pixd)} events; == plain): fetched "
            f"{raster_ms} ms, void {raster_v_ms} ms, plain {raster_p_ms} ms, "
            f"bound {raster_bound} ms; its raster grouping {groups_ms} ms, "
            f"the frame carrier built on the card {carrier_ms} ms")
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

    return (dict(err=k4_err, ms=k4_ms, plain_ms=k4p_ms, bound_ms=k4_bound,
                 void_ms=k4_t["void"][0], passes_ms=k4_t["fetched"][1],
                 void_passes_ms=k4_t["void"][1], glue_ms=k4_glue_ms),
            dict(ms=raster_ms, void_ms=raster_v_ms, plain_ms=raster_p_ms,
                 bound_ms=raster_bound),
            launches)


def staged_framed_run(at, frames, dev, path, keep_running=True,
                      features=False):
    """The 1080p Raw run (the display kept if `keep_running`; with
    `features`, feature detection on, Instant markers) with each stage timed
    on the host clock and a synchronise after it: chunks (every chunk call,
    reruns included: the kernels and, on the slot engine, the compaction),
    fetch (the events' device -> host copy), unpack (wire pairs to x, y, c,
    d, t), encode, with features FAST (fast_mask_torch over the chunk's
    display frames), gather (the candidates' bits to the host) and replay
    (the host feature set update and the markers), and submit (submit_chunk
    less the stages inside it: the frames' host -> device copy, the initial
    state, and the control reads and display fetch of the chunks it
    collects); "other" is the rest of the wall (the end of the stream's
    control reads and display fetches, the loop). Returns (wall seconds,
    stage -> seconds)."""
    from adder_tpu_torch.utils import cv as CV

    feature_stages = ("FAST", "gather", "replay") if features else ()
    S = Stages(("submit", "chunks", "fetch", "unpack", "encode")
               + feature_stages)
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
        P.wrap(video, "_fetch", S.timed("fetch"))
        P.wrap(video, "submit_chunk", less_inner(
            "submit", ("chunks", "fetch", "unpack", "encode")
            + feature_stages))
        if features:
            features_on(video)
            P.wrap(CV, "fast_mask_torch", S.timed("FAST"))
            P.wrap(video, "_feature_mask_lookup",
                   less_inner("gather", ("FAST",)))
            P.wrap(video, "_handle_features",
                   less_inner("replay", ("FAST", "gather")))

    try:
        wall, _, _ = transcode_raw(at, frames, dev, path, T_CHUNK,
                                   keep_running=keep_running, before=before)
    finally:
        P.restore()
    st["other"] = wall - sum(st.values())
    return wall, st


def features_on(video, rate=False):
    """Feature detection as phase 15 runs it: Instant markers; with `rate`,
    crf 5, the rate adjustment and clustering."""
    from adder_tpu_torch.utils.viz import ShowFeatureMode

    if rate:
        video.update_crf(5)
    video.update_detect_features(True, ShowFeatureMode.Instant, rate, rate)


class DisplayLaunches:
    """Counts the launches of adder_resident_chunk that write the display
    (given `runnings`), at the C entry point the chunk wrapper calls;
    LAUNCHES["adder_resident_chunk"] counts them with the display-off ones.
    Undone by close()."""

    def __init__(self, lib, FR):
        self.n = 0
        self._lib, self._orig = lib, lib.adder_resident_chunk

        def entry(addr, stream):
            if FR._ChunkArgs.from_address(addr).runnings:
                self.n += 1
            return self._orig(addr, stream)

        lib.adder_resident_chunk = entry

    def close(self):
        self._lib.adder_resident_chunk = self._orig


def features_phases(dev, card, scene, main_digest, st6, p):
    """Phases 15-16 (feature detection on each engine, checkpoints, the
    display kernel's timing). `scene` is phase 3's (T, H, W) u8 scene on the
    card, `main_digest` the resident engine's .adder digest, `st6` phase
    4's mid-stream depth-6 state, `p` the bench parameters. Returns the K1
    display record entry."""
    import numpy as np

    import adder_tpu_torch as at
    from adder_tpu_torch import testing
    from adder_tpu_torch.ops import cuda_build
    from adder_tpu_torch.ops import fused_kernel as FK
    from adder_tpu_torch.ops import fused_resident as FR
    from adder_tpu_torch.ops import pallas_kernel as PK
    from adder_tpu_torch.utils import cv as CV

    frames = scene.cpu().numpy()[..., None]
    engines = (("resident", None, FR, "adder_resident_chunk"),
               ("fused", "ADDER_TPU_RESIDENT", FK, "adder_fused_interval"),
               ("slots", "ADDER_TPU_FUSED", PK, "adder_interval_slots"))
    t0 = time.perf_counter()
    corners = testing.moving_shapes(5, 8, H, W, 1, n_shapes=24)
    log(f"# phase 15: a 1080p scene of 24 moving shapes, 8 frames, made in "
        f"{time.perf_counter() - t0:.1f} s")
    launches, videos, walls = {}, {}, {}
    display = DisplayLaunches(cuda_build.load(), FR)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "features.adder")
            for engine, env, mod, name in engines:
                with (engine_env(env) if env else contextlib.nullcontext()):
                    mod.reset_launch_counts()
                    display.n = 0
                    raw_s, n_kernel, video = transcode_raw(
                        at, frames, dev, path, T_CHUNK, before=features_on)
                    launches[name] = mod.LAUNCHES[name]
                    if engine == "resident":
                        launches["display"] = display.n
                    if video.engine != engine or launches[name] < 1:
                        raise AssertionError(
                            f"{engine} engine: {video.engine}, "
                            f"{launches[name]} {name} launches")
                    if engine == "resident" and display.n < 1:
                        raise AssertionError("the resident engine ran no "
                                             "display launch")
                    if file_digest(path) != main_digest:
                        raise AssertionError(f"{engine}: features on, the "
                                             f".adder bytes differ from "
                                             f"phase 3's")
                    videos[engine] = video
                    walls[engine] = raw_s
                    ref = videos["resident"]
                    if (video.features != ref.features or not np.array_equal(
                            video.display_frame_features,
                            ref.display_frame_features)):
                        raise AssertionError(f"{engine}: feature set or "
                                             f"display differs from the "
                                             f"resident engine's")
                    extra = (f", {launches['display']} of them with the "
                             f"display" if engine == "resident" else "")
                    log(f"# phase 15: {engine} engine, features on (Instant)"
                        f", 1080p mono Raw: {n_kernel} events, phase 3's "
                        f"bytes exactly (sha256), {len(video.features)} "
                        f"features, {raw_s:.3f} s (first run), "
                        f"{launches[name]} {name} launches{extra}")

                    for what, src, rate in (("bench scene", frames, False),
                                            ("shapes, crf 5, rate + cluster",
                                             corners, True)):
                        a = os.path.join(tmp, "cuda8.adder")
                        b = os.path.join(tmp, "cpu8.adder")
                        _, _, va = transcode_raw(
                            at, src[:8], dev, a, 4,
                            before=lambda v: features_on(v, rate))
                        t1 = time.perf_counter()
                        _, _, vb = transcode_raw(
                            at, src[:8], "cpu", b, 4,
                            before=lambda v: features_on(v, rate))
                        cpu_s = time.perf_counter() - t1
                        if file_digest(a) != file_digest(b):
                            raise AssertionError(f"{engine}, {what}: first 8 "
                                                 f"frames, card and CPU .adder"
                                                 f" differ")
                        if rate and not (va.features
                                         and int(va.state.c_thresh.min()) <= 2):
                            raise AssertionError(f"{engine}, {what}: no "
                                                 f"feature lowered c_thresh")
                        if not (va.features == vb.features and np.array_equal(
                                va.display_frame_features,
                                vb.display_frame_features) and torch.equal(
                                va.state.c_thresh.cpu(), vb.state.c_thresh)):
                            raise AssertionError(f"{engine}, {what}: first 8 "
                                                 f"frames, card and CPU "
                                                 f"features differ")
                        log(f"# phase 15: {engine}, {what}: first 8 frames (2 "
                            f"chunks of 4) byte-identical on card and CPU, "
                            f"the same {len(va.features)} features, display "
                            f"frame and c_thresh (min "
                            f"{int(va.state.c_thresh.min())}; "
                            f"{os.path.getsize(a)} bytes; CPU plain run "
                            f"{cpu_s:.1f} s)")
            ref = videos["resident"]
            hold_digest("phase 15 features and display, 1080p bench scene",
                        features_digest(ref))

            # a checkpoint after chunk 2, resumed in a fresh Video
            head_p, tail_p = (os.path.join(tmp, f"{x}.adder")
                              for x in ("head", "tail"))
            ck = os.path.join(tmp, "ck.npz")

            def start(out):
                src = bench_source(at, frames, dev, T_CHUNK)
                src.write_out(at.SourceCamera.FramedU8, at.TimeMode.DeltaT,
                              at.PixelMultiMode.Collapse, None,
                              at.EncoderType.Raw,
                              at.EncoderOptions.default(src.video.plane), out)
                src.video._keep_running_frame = True
                return src.video

            with open(head_p, "wb") as f:
                v = start(f)
                for i in (0, T_CHUNK):
                    v.submit_chunk(frames[i : i + T_CHUNK])
                v.save_checkpoint(ck)
                header = v.encoder.meta.header_size
            with open(tail_p, "wb") as f:
                v = start(f)
                v.load_checkpoint(ck)
                for i in range(2 * T_CHUNK, N_FRAMES, T_CHUNK):
                    v.submit_chunk(frames[i : i + T_CHUNK])
                v.end_write_stream()
            with open(head_p, "rb") as fh, open(tail_p, "rb") as ft:
                resumed = fh.read() + ft.read()[header:]
            if (hashlib.sha256(resumed).hexdigest() != main_digest
                    or not np.array_equal(v.running_intensities,
                                          ref.running_intensities)):
                raise AssertionError("the resumed run differs from the "
                                     "uninterrupted one")
            log(f"# phase 15: checkpoint after chunk 2 ({os.path.getsize(ck)}"
                f" bytes), resumed in a fresh Video: phase 3's bytes and the "
                f"uninterrupted run's display frame")

            # -- phase 16: timings ------------------------------------------
            n = H * W
            f16 = scene[T_CHUNK : 2 * T_CHUNK].reshape(T_CHUNK, -1)
            f16 = f16.contiguous()
            run0 = scene[T_CHUNK - 1].reshape(-1).contiguous()
            want = FR.fused_chunk_resident_plain(st6, f16, 255.0, p, run0)
            cap = n * T_CHUNK
            err = max(
                testing.compare_chunks(FR.fused_chunk_resident(
                    st6, f16, 255.0, p, run0, event_cap=cap), want,
                    "1080p display chunk"),
                testing.compare_chunks(FR.group_chunk_resident(
                    st6, f16, 255.0, p, run0),
                    want._replace(pixd=None, t=None),
                    "1080p display void chunk"))
            n_ev = int(want.total)
            # in turns: display off, on, off, on
            off = k1_timings(FR, st6, f16, p, event_cap=cap)
            on = k1_timings(FR, st6, f16, p, run0, event_cap=cap)
            off2 = k1_timings(FR, st6, f16, p, event_cap=cap)
            on2 = k1_timings(FR, st6, f16, p, run0, event_cap=cap)
            kdp_ms = cuda_ms(lambda: FR.fused_chunk_resident_plain(
                st6, f16, 255.0, p, run0), 2)
            k_bound = chunk_bound(st6, [f16], n_ev)
            kd_bound = k_bound + bound(T_CHUNK * n + n)
            frames16 = f16.view(T_CHUNK, H, W)
            fast_ms = cuda_ms(lambda: CV.fast_mask_torch(frames16), 10)
            # the frames read once (u8), the mask written once (bool)
            fast_bound = bound(2 * T_CHUNK * n)
            log(f"# phase 16: K1 display == plain at 1080p mono T={T_CHUNK} "
                f"mid-stream ({n_ev} events), fetched and void")
            log(f"# phase 16: 1080p mono T={T_CHUNK} chunk, in turns (display"
                f" off, on, off, on) [{card}]:")
            for what, key in (("K1 fetched (one pass + scan + copy)",
                               "fetched"), ("K2 void", "void")):
                log(f"#   {what}: from the host, display off "
                    f"{off[key]}, {off2[key]} ms, on {on[key]}, {on2[key]} "
                    f"ms; on the card alone, off {off[key + '_queued']}, "
                    f"{off2[key + '_queued']} ms, on {on[key + '_queued']}, "
                    f"{on2[key + '_queued']} ms")
            log(f"#   bounds: fetched {k_bound} ms, with the display "
                f"{kd_bound} ms; plain with the display {kdp_ms} ms")
            kd_ms, k_ms = on["fetched"], off["fetched"]
            log(f"#   fast_mask_torch over ({T_CHUNK}, {H}, {W}): {fast_ms} "
                f"ms (bytes bound {fast_bound} ms)")

            FR.reset_launch_counts()
            off_s, _, _ = transcode_raw(at, frames, dev, path, T_CHUNK)
            on_s, _, _ = transcode_raw(at, frames, dev, path, T_CHUNK,
                                       before=features_on)
            off_s2, _, _ = transcode_raw(at, frames, dev, path, T_CHUNK)
            on_s2, _, _ = transcode_raw(at, frames, dev, path, T_CHUNK,
                                        before=features_on)
            log(f"# phase 16: resident engine 1080p mono Raw walls, in turns "
                f"[{card}]: features off {off_s}, {off_s2} s "
                f"({H * W * N_FRAMES / off_s / 1e6}, "
                f"{H * W * N_FRAMES / off_s2 / 1e6} Mpx/s); features on "
                f"{on_s}, {on_s2} s ({H * W * N_FRAMES / on_s / 1e6}, "
                f"{H * W * N_FRAMES / on_s2 / 1e6} Mpx/s)")
            for engine, env, _, _ in engines[1:]:
                with engine_env(env):
                    s_on, _, _ = transcode_raw(at, frames, dev, path, T_CHUNK,
                                               before=features_on)
                log(f"# phase 16: {engine} engine, features on: {s_on} s "
                    f"(second run; first {walls[engine]} s) [{card}]")
            wall, stages = staged_framed_run(at, frames, dev, path,
                                             keep_running=False,
                                             features=True)
            log(f"# phase 16: resident engine features-on Raw stage "
                f"breakdown, {wall} s wall ({H * W * N_FRAMES / wall / 1e6} "
                f"Mpx/s with a synchronise after each stage) [{card}]:")
            for name, sec in stages.items():
                log(f"#   {name:7s} {sec:.6f} s  {sec / wall:.1%}")
    finally:
        display.close()
    return {"name": "adder_resident_chunk (display)", "route": "cuda",
            "source": "adder_tpu_torch/csrc/fused_resident.cu",
            "replaces": "adder_tpu/ops/fused_resident.py:676",
            "launches": launches["display"], "max_abs_err": err, "ms": kd_ms,
            "plain_ms": kdp_ms, "bound_ms": kd_bound, "bound_by": "bytes",
            "library_ms": None, "display_off_ms": k_ms,
            "queued_ms": on["fetched_queued"], "void_ms": on["void"],
            "void_queued_ms": on["void_queued"]}


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

    offset7 = torch.tensor(7, device=dev)  # made once, outside every clock

    def k5(fn, bufs, emit=True, scratch=None):
        if scratch is None:
            return fn(st6, frame, 255.0, offset7, bufs, p, 4, emit)
        return fn(st6, frame, 255.0, offset7, bufs, p, 4, emit,
                  scratch=scratch)

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
    # from the host (each call zeroes its own look-back scratch), on the
    # card alone with a scratch row zeroed beforehand for each call, and the
    # kernel's own device time under torch.profiler
    k5_ms = cuda_ms(lambda: k5(FK.fused_interval, got_b), 20)
    rows = iter(FK.new_scratch(n, dev, 21))
    k5_q_ms = cuda_ms_queued(
        lambda: k5(FK.fused_interval, got_b, scratch=next(rows)), 20)
    k5_dev_ms = kernel_device_ms(lambda: k5(FK.fused_interval, got_b), 20,
                                 ("adder_fused_interval_kernel",)).get(
                                     "adder_fused_interval_kernel")
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
    k5_alone = k5_dev_ms or k5_q_ms
    log(f"#   K5 (depth 6, pack 4, display): from the host {k5_ms} ms, on "
        f"the card alone {k5_q_ms} ms, the kernel under torch.profiler "
        f"{k5_dev_ms} ms; plain {k5p_ms} ms, bound {k5_bound} ms: "
        f"{k5_bound / k5_alone:.1%} of it on the card alone, "
        f"{'over' if k5_alone > 2 * k5_bound else 'at most'} twice the bound")
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
         "bound_by": "bytes", "library_ms": None, "queued_ms": k5_q_ms,
         "kernel_ms": k5_dev_ms},
        {"name": "adder_interval_slots", "route": "cuda",
         "source": "adder_tpu_torch/csrc/interval_slots.cu",
         "replaces": "adder_tpu/ops/pallas_kernel.py:114",
         "launches": launches["adder_interval_slots"], "max_abs_err": k6_err,
         "ms": k6_ms, "plain_ms": k6p_ms, "bound_ms": k6_bound,
         "bound_by": "bytes", "library_ms": None},
    ]


def simulproc_run(at, frames, device, adder_path, raw_path, chunk,
                  before=None):
    """tools/adder_simulproc.py's drive with its defaults (ref_time 255,
    delta_t_max 7650, crf 3, AbsoluteT, Normal; the builder's and the
    encoder options' CRF alike, as simulproc_from_args sets them) over a
    FramedArray of `frames` at 30 fps, Raw sink into `adder_path`, frames
    reconstructed by SimulProcessor's framer thread into `raw_path`;
    `before(proc)` runs before the run. Returns (seconds, frames written,
    the SimulProcessor)."""
    from adder_tpu_torch.models.simulproc import SimulProcessor

    src = at.FramedArray(frames, 30.0, chunk_frames=chunk, device=device)
    src.auto_time_parameters(255, 7650, at.TimeMode.AbsoluteT)
    src.crf(3)
    opts = at.EncoderOptions.default(src.video.plane)
    opts.crf.update_quality(3)
    with open(adder_path, "wb") as ev, open(raw_path, "wb") as raw:
        src.write_out(at.SourceCamera.FramedU8, at.TimeMode.AbsoluteT,
                      at.PixelMultiMode.Normal, None, at.EncoderType.Raw,
                      opts, ev)
        proc = SimulProcessor(src, 255, raw, framer_fps=src.source_fps)
        if before:
            before(proc)
        t0 = time.perf_counter()
        n = proc.run()
        sync(device)
        dt = time.perf_counter() - t0
    return dt, n, proc


def simulproc_clocks(proc, clocks: dict) -> None:
    """Time, into `clocks`, the framer thread's ingest and frame writes
    ("framer") and the main thread's blocking puts on its queue ("wait")."""
    def timed(key, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                clocks[key] = clocks.get(key, 0.0) + time.perf_counter() - t0
        return run

    fr = proc.framer
    fr.ingest_event_array = timed("framer", fr.ingest_event_array)
    fr.write_multi_frame_bytes = timed("framer", fr.write_multi_frame_bytes)
    proc._queue.put = timed("wait", proc._queue.put)


def simulproc_phase(at, FR, dev, card, frames, tmp) -> dict:
    """Phase 17; returns K1's launches on the run and the .adder's path."""
    t0 = time.perf_counter()
    adder, raw = os.path.join(tmp, "sim.adder"), os.path.join(tmp, "sim.raw")
    clocks = {}
    FR.reset_launch_counts()
    wall, n_frames, _ = simulproc_run(
        at, frames, dev, adder, raw, T_CHUNK,
        before=lambda proc: simulproc_clocks(proc, clocks))
    launches = dict(FR.LAUNCHES)
    if min(launches["adder_resident_chunk"], launches["adder_segment_copy"],
           launches["adder_exclusive_scan"]) < 1:
        raise AssertionError(f"simulproc missed a kernel: {launches}")
    frame_bytes = H * W
    if n_frames < 1 or os.path.getsize(raw) != n_frames * frame_bytes:
        raise AssertionError(f"simulproc wrote {n_frames} frames, "
                             f"{os.path.getsize(raw)} bytes")
    n_events = len(at.open_file_decoder(adder).digest_all())
    log(f"# phase 17: simulproc 1080p mono: {N_FRAMES} frames in, "
        f"{n_events} events, {n_frames} frames out, {wall} s: "
        f"{N_FRAMES / wall} frames/s, {H * W * N_FRAMES / wall / 1e6} Mpx/s; "
        f"the framer thread busy {clocks.get('framer', 0.0)} s "
        f"({clocks.get('framer', 0.0) / wall:.1%} of the wall), the main "
        f"thread waiting on the queue {clocks.get('wait', 0.0)} s; "
        f"launches {launches} [{card}]")
    hold_digest("phase 17 simulproc 1080p Raw .adder", file_digest(adder))
    hold_digest("phase 17 simulproc 1080p reconstructed frames",
                file_digest(raw))
    wall2, _, _ = simulproc_run(at, frames, dev, os.path.join(tmp, "s2.adder"),
                                os.path.join(tmp, "s2.raw"), T_CHUNK)
    walls = []
    busy = device_busy_seconds(lambda: walls.append(simulproc_run(
        at, frames, dev, os.path.join(tmp, "s3.adder"),
        os.path.join(tmp, "s3.raw"), T_CHUNK)[0]))
    log(f"# phase 17: second run {wall2} s ({N_FRAMES / wall2} frames/s); "
        f"under torch.profiler {walls[0]} s, the card busy {busy} s "
        f"({busy / walls[0]:.1%})")
    outs = []
    for device in (dev, "cpu"):
        a = os.path.join(tmp, f"p8_{torch.device(device).type}.adder")
        r = a[:-6] + ".raw"
        simulproc_run(at, frames[:8], device, a, r, 8)
        with open(a, "rb") as fa, open(r, "rb") as fr:
            outs.append((fa.read(), fr.read()))
    if outs[0] != outs[1]:
        raise AssertionError("simulproc, first 8 frames: card and CPU differ")
    log(f"# phase 17: first 8 frames: .adder ({len(outs[0][0])} bytes) and "
        f"{len(outs[0][1]) // frame_bytes} reconstructed frames identical on "
        f"the card and the CPU; {time.perf_counter() - t0:.1f} s")
    return {"launches": launches["adder_resident_chunk"], "adder": adder,
            "raw_digest": file_digest(raw)}


def framer_builder(at, dec):
    """The framer of a decoded file at its own rate (tps / ref_interval),
    as bench.py's reconstruction drive builds it."""
    from adder_tpu_torch.framer.driver import FramerBuilder

    m = dec.meta
    return (FramerBuilder(m.plane)
            .time_parameters(m.tps, m.ref_interval, m.delta_t_max,
                             m.tps / max(m.ref_interval, 1))
            .codec_meta(m.codec_version, m.time_mode)
            .source_info(dec.get_source_type(), m.source_camera))


def longest_gap(dec, events, device) -> int:
    """The longest time between a pixel's consecutive events (and before
    its first), in ticks: DeltaT times are the gaps; AbsoluteT times are
    sorted by pixel on the card and differenced."""
    from adder_tpu_torch.core.types import TimeMode

    if dec.meta.time_mode == TimeMode.DeltaT:
        return int(events.t.max())
    m = dec.meta.plane
    pix = torch.from_numpy((events.y.astype(np.int64) * m.width
                            + events.x) * m.channels).to(device)
    pix += torch.from_numpy(np.where(events.c == 255, 0, events.c)
                            .astype(np.int64)).to(device)
    t = torch.from_numpy(events.t.astype(np.int64)).to(device)
    pix, order = torch.sort(pix, stable=True)
    t = t[order]
    first = torch.ones_like(pix, dtype=torch.bool)
    first[1:] = pix[1:] != pix[:-1]
    gap = torch.where(first, t, t - torch.roll(t, 1))
    return int(gap.max())


def host_frames(b, events):
    """FrameSequence over all events: pop the complete frames, then one
    back-filling flush (the drive DeviceFramer.drain mirrors). Returns the
    frames and the last frame index any event filled."""
    fs = b.finish()
    fs.ingest_event_array(events)
    last = max(fs.frames)
    out = []
    while fs.is_frame_0_filled():
        out.append(fs.pop_next_frame()[0])
    if fs.flush_frame_buffer():
        while fs.is_frame_0_filled():
            out.append(fs.pop_next_frame()[0])
    return out, last


def framer_phase(at, dev, card, path, name) -> dict:
    """Phase 18 on one file: DeviceFramer on the card against the host
    FrameSequence, bit for bit, timed and traced."""
    from torch.profiler import ProfilerActivity, profile

    from adder_tpu_torch.framer.device import DeviceFramer

    t0 = time.perf_counter()
    dec = at.open_file_decoder(path)
    events = dec.digest_all()
    b = framer_builder(at, dec)
    n_ev = len(events)
    th = time.perf_counter()
    want, last = host_frames(b, events)
    host_s = time.perf_counter() - th
    # one ingest of the whole file: the window holds every frame an event
    # fills (a DeltaT chain, rounded up to ref_interval at every event,
    # runs ahead of the source's 64 frames). The builder is the header's:
    # the stream's D_EMPTY fillers span more than its delta_t_max (the
    # longest gap is logged), and the framer sizes its span passes from
    # the spans the ingest holds
    window = max(64, last + 2)
    gap = longest_gap(dec, events, dev)
    bd = framer_builder(at, dec)
    warm = DeviceFramer(bd, window=window, device=dev)
    warm.ingest_event_array(events)
    warm.drain()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    df = DeviceFramer(bd, window=window, device=dev)
    td = time.perf_counter()
    df.ingest_event_array(events)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - td
    got = df.drain()
    dev_s = time.perf_counter() - td
    peak = torch.cuda.max_memory_allocated()
    if len(got) != len(want) or not want:
        raise AssertionError(f"{name}: device {len(got)} frames, host "
                             f"{len(want)}")
    h = hashlib.sha256()
    for i, (g, w_) in enumerate(zip(got, want)):
        if g.dtype != w_.dtype or not np.array_equal(g, w_):
            raise AssertionError(f"{name}: frame {i} differs from the host "
                                 f"framer's")
        h.update(g.tobytes())
    batches = -(-n_ev // df.batch_cap)
    # the trace: the first PROFILED_BATCHES batches (a whole ingest's trace
    # takes minutes to read back)
    df2 = DeviceFramer(bd, window=window, device=dev)
    prefix = events[: PROFILED_BATCHES * df2.batch_cap]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tp = time.perf_counter()
        df2.ingest_event_array(prefix)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - tp
    del df2
    ops = device_events(prof)
    busy = sum(us for _, us in ops.values()) / 1e6
    n_device_ops = sum(c for c, _ in ops.values())
    top = [f"{k[:60]} x{c} {us / 1e3:.2f} ms" for k, (c, us) in
           sorted(ops.items(), key=lambda kv: -kv[1][1])[:8]]
    log(f"# phase 18: {name}: {n_ev} events, {len(got)} frames equal bit for "
        f"bit; host FrameSequence {host_s} s ({n_ev / host_s / 1e6} Mev/s); "
        f"DeviceFramer ingest + drain {dev_s} s ({n_ev / dev_s / 1e6} Mev/s; "
        f"the ingest {ingest_s} s), window {df.window}, the longest gap "
        f"{gap} ticks (delta_t_max {dec.meta.delta_t_max}), max_span "
        f"{df.max_span}, {batches} batches of {df.batch_cap}, "
        f"peak memory {peak / 2**30:.2f} GiB ({base_mem / 2**30:.2f} GiB "
        f"held before it) [{card}]")
    log(f"#   the ingest of the first {PROFILED_BATCHES} batches under "
        f"torch.profiler: {n_device_ops / PROFILED_BATCHES:.0f} device "
        f"operations a batch, {prof_s} s, the card busy "
        f"{busy} s ({busy / prof_s:.1%}); top device operations: {top}; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"digest": h.hexdigest(), "host_mev": n_ev / host_s / 1e6,
            "device_mev": n_ev / dev_s / 1e6}


def pipeline_phases(at, FR, dev, card, frames) -> dict:
    """Phases 17 and 18; returns K1's launches on the simulproc run."""
    with tempfile.TemporaryDirectory() as tmp:
        sim = simulproc_phase(at, FR, dev, card, frames, tmp)
        t0 = time.perf_counter()
        main = os.path.join(tmp, "main.adder")
        transcode_raw(at, frames, dev, main, T_CHUNK)
        hold_digest("phase 3 framed 1080p mono Raw .adder", file_digest(main))
        log(f"# phase 18: phase 3's .adder made again in "
            f"{time.perf_counter() - t0:.1f} s")
        for path, name in ((main, "phase 3's .adder (DeltaT)"),
                           (sim["adder"], "phase 17's .adder (AbsoluteT)")):
            r = framer_phase(at, dev, card, path, name)
            hold_digest(f"phase 18 framer 1080p frames of {name}",
                        r["digest"])
        # simulproc's framer thread wrote what the framers pop from its file
        if r["digest"] != sim["raw_digest"]:
            raise AssertionError("phase 17's reconstructed frames differ "
                                 "from the framers' on its .adder")
    return sim


def write_clip(cv2, path, seed: int = 5) -> str:
    """A seeded colour clip (moving gradients with noise, 30 fps) in FFV1,
    lossless, through cv2.VideoWriter."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:CLIP_H, 0:CLIP_W]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"FFV1"), 30.0,
                         (CLIP_W, CLIP_H), isColor=True)
    if not vw.isOpened():
        raise AssertionError("cv2.VideoWriter cannot write FFV1 here")
    for t in range(CLIP_FRAMES):
        f = np.stack([(xx * 3 + yy * 2 + t * 9) % 256,
                      128 + 100 * np.cos(yy / 23 - t / 5),
                      128 + 100 * np.sin(xx / 31 + t / 4)], -1)
        f = f + rng.integers(-12, 13, f.shape)
        vw.write(np.clip(f, 0, 255).astype(np.uint8))
    vw.release()


def file_source_run(at, cls, path, color, device) -> tuple:
    """A file source with cv2 decode, chunks of 8, crf 3, AbsoluteT, Raw
    sink: (.adder bytes, the source)."""
    src = cls(path, color, chunk_frames=8, decoder="cv2", device=device)
    src.auto_time_parameters(255, 255 * 30, at.TimeMode.AbsoluteT)
    src.crf(3)
    buf = io.BytesIO()
    video = src.get_video_ref()
    src.write_out(at.SourceCamera.FramedU8, at.TimeMode.AbsoluteT,
                  at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                  at.EncoderOptions.default(video.plane), buf)
    while True:
        try:
            src.consume_batch()
        except EOFError:
            break
    video.end_write_stream()
    return buf.getvalue(), src


def file_source_phase(at, FR, dev, card) -> tuple:
    """Phase 19: Framed and FramedStream on the card, cv2 decode (this host
    has cv2 and no libav to link the ffmpeg decoder), against the CPU plain
    path; returns K1's launches on the card's runs and the .adder bytes of
    the colour Framed run on the card (phase 22's codec tools read them)."""
    import cv2

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.avi")
        write_clip(cv2, path)
        FR.reset_launch_counts()
        runs = {}
        for cls, color in ((at.Framed, True), (at.FramedStream, False)):
            tc = time.perf_counter()
            got, src = file_source_run(at, cls, path, color, dev)
            sync(dev)
            card_s = time.perf_counter() - tc
            if src.decoder != "cv2" or src.frame_idx != CLIP_FRAMES:
                raise AssertionError(f"{cls.__name__}: decoder {src.decoder}"
                                     f", {src.frame_idx} frames")
            runs[(cls.__name__, color)] = (got, card_s)
        launches = FR.LAUNCHES["adder_resident_chunk"]
        if launches < 2 * CLIP_FRAMES // 8:
            raise AssertionError(f"file sources missed K1: {dict(FR.LAUNCHES)}")
        for (name, color), (got, card_s) in runs.items():
            want, _ = file_source_run(at, at.Framed, path, color, "cpu")
            if got != want or len(want) < 1000:
                raise AssertionError(f"{name} {color}: card and CPU differ")
            log(f"# phase 19: {name}, cv2 decode, {CLIP_W}x{CLIP_H} "
                f"{'colour' if color else 'mono'} FFV1, {CLIP_FRAMES} "
                f"frames: .adder identical on the card and the CPU "
                f"({len(got)} bytes; {card_s} s on the card) [{card}]")
    log(f"# phase 19: K1 launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, runs[("Framed", True)][0]


def sharded_video(at, k, chunk, mesh_device="cuda:0", pixels=None):
    """A ShardedVideo of k bands on one card at bench_source's config
    (FramePerfect, DeltaT, ref_time 255, tps 255 x 30, delta_t_max 24 x
    255, c_thresh 0)."""
    v = at.ShardedVideo(at.PlaneSize(W, H, 1), at.Mode.FramePerfect, chunk,
                        mesh=[mesh_device] * k, pixels=pixels)
    v.time_parameters(int(255 * 30.0), 255, 255 * 24, at.TimeMode.DeltaT)
    v.update_quality_manual(0, 0, 24, 1, 0)
    return v


def sharded_raw(at, frames, k, path, before=None):
    """transcode_raw's drive through a ShardedVideo of k bands on the card:
    (seconds, kernel event count, the Video)."""
    video = sharded_video(at, k, T_CHUNK)
    with open(path, "wb") as f:
        video.write_out(at.SourceCamera.FramedU8, at.TimeMode.DeltaT,
                        at.PixelMultiMode.Collapse, None, at.EncoderType.Raw,
                        at.EncoderOptions.default(video.plane), f)
        if before:
            before(video)
        t0 = time.perf_counter()
        pendings = [video.submit_chunk(frames[i : i + T_CHUNK])
                    for i in range(0, len(frames), T_CHUNK)]
        video.end_write_stream()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    n_kernel = sum(int(o.per_interval.sum()) for p in pendings
                   for o in p["outs"])
    return dt, n_kernel, video


def sharded_void_mpx(at, frames, k) -> float:
    """void_mpx through a ShardedVideo of k bands on the card."""
    video = sharded_video(at, k, T_CHUNK)
    video.void_events = True
    video.submit_chunk(frames[:T_CHUNK])  # warm-up chunk
    video.flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, len(frames), T_CHUNK):
        video.submit_chunk(frames[i : i + T_CHUNK])
    video.flush()
    torch.cuda.synchronize()
    return H * W * len(frames) / (time.perf_counter() - t0) / 1e6


def same_chunk_outputs(sh, single, bands, n, what: str) -> int:
    """Hold the merged outputs of a sharded chunk (per-band results) to the
    single-device chunk's, bit for bit: events, interval counts, display
    frames, state. Returns the event count."""
    import numpy as np

    dev = single.pixd.device
    totals, _, per_int = sh.band_controls(bands, dev)
    total = int(single.total)
    pixd, t, per = sh.merge_bands(
        [b.pixd[:k].cpu().numpy() for b, k in zip(bands, totals.tolist())],
        [b.t[:k].cpu().numpy() for b, k in zip(bands, totals.tolist())],
        totals, per_int, [lo for lo, _ in sh.band_bounds(n, len(bands))])
    want_p = single.pixd[:total].cpu().numpy().view(np.uint32)
    want_t = single.t[:total].cpu().numpy().view(np.uint32)
    if not (np.array_equal(pixd, want_p) and np.array_equal(t, want_t)
            and np.array_equal(per, single.per_interval.cpu().numpy())):
        raise AssertionError(f"{what}: the merged events differ from the "
                             f"single-device chunk's")
    run = torch.cat([b.runnings for b in bands], dim=1)
    if not torch.equal(run, single.runnings):
        raise AssertionError(f"{what}: the display frames differ")
    whole = sh.gather_state([b.state for b in bands], dev)
    for name, a, b in zip(whole._fields, whole, single.state):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: state field {name} differs")
    return total


def sharded_phase(at, FR, dev, card, scene, frames, st6, p) -> dict:
    """Phase 20: phase 3's 1080p scene through ShardedVideo with k bands on
    the one card. Returns the launch counts of each run and the sharded K5
    and K6 chunks."""
    from adder_tpu_torch.ops import cuda_build
    from adder_tpu_torch.ops import fused_kernel as FK
    from adder_tpu_torch.ops import integrate as ops
    from adder_tpu_torch.ops import pallas_kernel as PK
    from adder_tpu_torch.parallel import sharding as sh
    from adder_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    chunks = N_FRAMES // T_CHUNK
    main_name = "phase 3 framed 1080p mono Raw .adder"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sharded.adder")
        for k in (2, 4):
            FR.reset_launch_counts()
            # k = 2 traced (ADDER_TPU_TRACE's switch): the stages must not
            # add a host read inside a chunk either
            tracing.set_enabled(k == 2)
            tracing.reset()
            try:
                raw_s, n_kernel, video = sharded_raw(
                    at, frames, k, path, before=no_sync_in_chunks)
            finally:
                tracing.set_enabled(False)
            launches = dict(FR.LAUNCHES)
            out[f"raw_k{k}"] = launches["adder_resident_chunk"]
            if (launches["adder_resident_chunk"] != k * chunks
                    or launches["adder_segment_copy"] != k * chunks):
                raise AssertionError(f"k = {k}: not one pass and one copy "
                                     f"per band and chunk: {launches}")
            log(f"# phase 20: ShardedVideo, {k} bands on {dev} "
                f"({video.bounds[0][1]} px each), 1080p mono Raw: {n_kernel} "
                f"events, {os.path.getsize(path)} bytes, {raw_s:.3f} s (first "
                f"run), launches {launches}")
            hold_digest(main_name, file_digest(path))
            if k == 2:
                log(f"# phase 20: k = 2 traced (tracing enabled, no chunk "
                    f"call waited for the card):")
                for line in tracing.summary_table().splitlines():
                    log(f"#   {line}")

        # the Empty sink: K2 per band, the single-device void run's state
        FR.reset_launch_counts()
        vd = sharded_video(at, 4, T_CHUNK)
        vd.void_events = True
        for i in range(0, N_FRAMES, T_CHUNK):
            vd.submit_chunk(frames[i : i + T_CHUNK])
        vd.flush()
        void_launches = dict(FR.LAUNCHES)
        out["void_k4"] = void_launches["adder_resident_chunk"]
        if (void_launches["adder_resident_chunk"] != 4 * chunks
                or void_launches["adder_segment_copy"]):
            raise AssertionError(f"void, k = 4: {void_launches}")
        src = bench_source(at, frames, dev, T_CHUNK)
        single = src.get_video_mut()
        single.void_events = True
        for i in range(0, N_FRAMES, T_CHUNK):
            single.submit_chunk(frames[i : i + T_CHUNK])
        single.flush()
        whole = sh.gather_state(vd.state, dev)
        want = ops.pad_state_depth(single.state, ops.DEPTH)
        for name, a, b in zip(whole._fields, whole, want):
            if not torch.equal(a, b):
                raise AssertionError(f"void, k = 4: state field {name} "
                                     f"differs from the single-device run's")
        log(f"# phase 20: Empty sink, 4 bands: K2 launches {void_launches}; "
            f"the state equals the single-device void run's (depth "
            f"{single.state.node_d.shape[0]} padded to {ops.DEPTH})")

        # features on, 2 bands: K1's display output per band
        FR.reset_launch_counts()
        display = DisplayLaunches(cuda_build.load(), FR)
        try:
            feat_s, _, fv = sharded_raw(at, frames, 2, path,
                                        before=features_on)
        finally:
            display.close()
        out["features_k2"] = FR.LAUNCHES["adder_resident_chunk"]
        if display.n != 2 * chunks or out["features_k2"] != 2 * chunks:
            raise AssertionError(f"features, k = 2: {display.n} display "
                                 f"launches of {FR.LAUNCHES}")
        hold_digest(main_name, file_digest(path))
        hold_digest("phase 15 features and display, 1080p bench scene",
                    features_digest(fv))
        log(f"# phase 20: features on, 2 bands: {display.n} K1 display "
            f"launches, {len(fv.features)} features, {feat_s:.3f} s")

    # one 1080p chunk through the sharded K5 and K6 chunk functions
    n = H * W
    f16 = scene[T_CHUNK : 2 * T_CHUNK].reshape(T_CHUNK, -1).contiguous()
    run0 = torch.zeros(n, dtype=torch.uint8, device=dev)
    st8 = ops.pad_state_depth(st6, ops.DEPTH)
    single5 = FK.fused_chunk(st6, f16, 255.0, run0, p, 2 * n * T_CHUNK, 16)
    single6 = ops.transcode_chunk(st8, f16, 255.0, run0, p, 4 * n * T_CHUNK,
                                  ops.K_SLOTS)
    for k in (2, 4):
        bounds = sh.band_bounds(n, k)
        mesh = [dev] * k
        fr = [f16[:, lo:hi].contiguous() for lo, hi in bounds]
        r0 = [run0[lo:hi].contiguous() for lo, hi in bounds]
        n_local = bounds[0][1]
        FK.reset_launch_counts()
        b5 = sh.fused_chunk_sharded(sh.shard_state(st6, mesh), fr, 255.0, r0,
                                    p, 2 * n_local * T_CHUNK, 16)
        out[f"k5_k{k}"] = FK.LAUNCHES["adder_fused_interval"]
        PK.reset_launch_counts()
        b6 = sh.transcode_chunk_sharded(sh.shard_state(st8, mesh), fr, 255.0,
                                        r0, p, 4 * n_local * T_CHUNK,
                                        ops.K_SLOTS)
        out[f"k6_k{k}"] = PK.LAUNCHES["adder_interval_slots"]
        if out[f"k5_k{k}"] != k * T_CHUNK or out[f"k6_k{k}"] != k * T_CHUNK:
            raise AssertionError(f"k = {k}: K5 {out[f'k5_k{k}']}, K6 "
                                 f"{out[f'k6_k{k}']} launches, want "
                                 f"{k * T_CHUNK} each")
        e5 = same_chunk_outputs(sh, single5, b5, n, f"K5 sharded, k = {k}")
        e6 = same_chunk_outputs(sh, single6, b6, n, f"K6 sharded, k = {k}")
        log(f"# phase 20: one 1080p chunk (T = {T_CHUNK}, mid-stream) through "
            f"fused_chunk_sharded (K5, pack 16, {out[f'k5_k{k}']} launches) "
            f"and transcode_chunk_sharded (K6 and its glue, "
            f"{out[f'k6_k{k}']} launches), {k} bands: {e5} and {e6} events, "
            f"display frames and state equal the single-device chunk's")

    # walls in turns: single, 2, 4, 4, 2, single (no claim: every band
    # runs on the one card)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "turns.adder")
        walls = {"single": [], 2: [], 4: []}
        voids = {"single": [], 2: [], 4: []}
        for who in ("single", 2, 4, 4, 2, "single"):
            if who == "single":
                walls[who].append(transcode_raw(at, frames, dev, path,
                                                T_CHUNK)[0])
                voids[who].append(void_mpx(at, frames, T_CHUNK, dev))
            else:
                walls[who].append(sharded_raw(at, frames, who, path)[0])
                voids[who].append(sharded_void_mpx(at, frames, who))
    out["raw_s"] = {str(k): v for k, v in walls.items()}
    out["void_mpx"] = {str(k): v for k, v in voids.items()}
    log(f"# phase 20: in turns (single, 2, 4, 4, 2, single bands), 1080p "
        f"mono [{card}]: Raw walls {out['raw_s']} s; void {out['void_mpx']} "
        f"Mpx/s (all bands on one card: no scaling is claimed)")
    log(f"# phase 20: {time.perf_counter() - t_phase:.1f} s")
    return out


MULTIHOST_TIMEOUT_S = 240


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def multihost_phase(card) -> list:
    """Phase 21: two processes under gloo, both on cuda:0, as torchrun
    would start them (RANK, WORLD_SIZE, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT): each runs `band_job`. Returns each rank's record."""
    t_phase = time.perf_counter()
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        try:
            for rank in range(2):
                env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                           WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                           MASTER_ADDR="localhost", MASTER_PORT=str(port))
                logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--band-job",
                     tmp], env=env, stdout=logs[-1],
                    stderr=subprocess.STDOUT, text=True))
            deadline = time.monotonic() + MULTIHOST_TIMEOUT_S
            for rank, proc in enumerate(procs):
                try:
                    proc.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise AssertionError(
                        f"phase 21: rank {rank} did not finish within "
                        f"{MULTIHOST_TIMEOUT_S} s")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        records = []
        for rank, (proc, f) in enumerate(zip(procs, logs)):
            f.seek(0)
            text = f.read()
            f.close()
            if proc.returncode != 0:
                raise AssertionError(f"phase 21: rank {rank} exited "
                                     f"{proc.returncode}:\n{text[-3000:]}")
            records.append(json.loads(text.strip().splitlines()[-1]))
        path = os.path.join(tmp, "multihost.adder")
        size = os.path.getsize(path)
        log(f"# phase 21: 2 processes, {records[0]['backend']}, both on "
            f"cuda:0; rank 0 merged {records[0]['merged']} events into "
            f"{size} bytes; ranks {records}")
        hold_digest("phase 3 framed 1080p mono Raw .adder", file_digest(path))
    log(f"# phase 21: {time.perf_counter() - t_phase:.1f} s, the processes' "
        f"start included [{card}]")
    return records


def band_job(out_dir: str) -> int:
    """One process of phase 21's job (or of `torchrun --nproc-per-node 2
    chip_smoke.py --band-job DIR`): decode only this process's rows of
    phase 3's scene, transcode its pixel slice on cuda:0 through a
    ShardedVideo of one band, write its part into `out_dir`; rank 0 merges
    the parts into out_dir/multihost.adder. Prints its record as JSON."""
    if not torch.cuda.is_available():
        print("band job: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import torch.distributed as dist

    import adder_tpu_torch as at
    from adder_tpu_torch import testing
    from adder_tpu_torch.ops import fused_resident as FR
    from adder_tpu_torch.parallel import multihost as mh

    t0 = time.perf_counter()
    if not mh.init_multihost():
        raise RuntimeError("band job: WORLD_SIZE must be above 1")
    rank = mh.process_index()
    rows = mh.host_rows(H, W, 1)
    band = testing.moving_blobs(H, W, N_FRAMES, seed=7, device="cuda",
                                rows=rows).cpu().numpy()[..., None]
    local = mh.local_band_frames(band, H, W, 1)
    video = sharded_video(at, 1, T_CHUNK,
                          pixels=mh.host_pixel_slice(H * W))
    # every rank attaches a sink with the same options (they carry the CRF
    # parameters of the chunks); rank 0's is the file, the others' Empty
    f = open(os.path.join(out_dir, "multihost.adder"), "wb") if rank == 0 \
        else None
    video.write_out(at.SourceCamera.FramedU8, at.TimeMode.DeltaT,
                    at.PixelMultiMode.Collapse, None,
                    at.EncoderType.Raw if f else at.EncoderType.Empty,
                    at.EncoderOptions.default(video.plane), f)
    FR.reset_launch_counts()
    t1 = time.perf_counter()
    for i in range(0, N_FRAMES, T_CHUNK):
        video.submit_chunk(local[i : i + T_CHUNK])
    video.flush()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    merged = mh.gather_parts(video, out_dir)
    if f:
        video.end_write_stream()
        f.close()
    t3 = time.perf_counter()
    record = {"rank": rank, "backend": dist.get_backend(), "rows": rows,
              "pixels": video.pixels, "launches": dict(FR.LAUNCHES),
              "transcode_s": t2 - t1, "parts_s": t3 - t2,
              "wall_s": t3 - t0, "merged": merged}
    dist.destroy_process_group()
    if record["launches"]["adder_resident_chunk"] != N_FRAMES // T_CHUNK:
        raise AssertionError(f"rank {rank}: {record['launches']}")
    print(json.dumps(record), flush=True)
    return 0


# -- phase 22: the command-line tools on the card -------------------------


def grey_as_bgr(frame):
    """A (H, W) grey u8 frame as the BGR frame that the mono cv2 path of
    the file sources (`handle_color_videors`: 0.114 r + 0.587 g + 0.299 b,
    truncated) turns back into it: r = g = v and b = v + 1 (v at 255), so
    that the weights' rounding cannot truncate v to v - 1."""
    b = np.minimum(frame.astype(np.int16) + 1, 255).astype(np.uint8)
    return np.dstack([b, frame, frame])


def write_scene_ffv1(cv2, path, frames) -> None:
    """Phase 3's scene as a lossless FFV1 file at 30 fps (cv2.VideoWriter)."""
    T_, H_, W_ = frames.shape[:3]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"FFV1"), 30.0,
                         (W_, H_), isColor=True)
    if not vw.isOpened():
        raise AssertionError("cv2.VideoWriter cannot write FFV1 here")
    for f in frames[..., 0]:
        vw.write(grey_as_bgr(f))
    vw.release()


def decoded_mono(cv2, path, CV) -> np.ndarray:
    """The frames the file sources' cv2 path gives for `path`, mono."""
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(CV.handle_color_videors(f, False))
    cap.release()
    return np.stack(out)


class ToolRuns:
    """Phase 22's drive of one tool's main(argv) in-process: its stdout
    kept and logged, the launch counts set to 0 just before the call and
    read just after (K1's display launches apart), its wall."""

    def __init__(self, FR, display, card, dev):
        self.FR, self.display, self.card, self.dev = FR, display, card, dev
        self.launches = {}
        self.walls = {}

    def run(self, name, fn):
        self.FR.reset_launch_counts()
        self.display.n = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn()
        sync(self.dev)
        wall = time.perf_counter() - t0
        got = {k: v for k, v in self.FR.LAUNCHES.items() if v}
        if self.display.n:
            got["adder_resident_chunk (display)"] = self.display.n
        self.launches[name] = got
        self.walls[name] = wall
        text = buf.getvalue().strip().splitlines()
        log(f"# phase 22: {name}: {wall:.3f} s, launches {got} [{self.card}]")
        for line in text[:4]:
            log(f"#   | {line}")
        if out not in (0, None) and not isinstance(out, list):
            raise AssertionError(f"{name} exited {out}")
        return out


def tools_phase(at, FR, dev, card, frames, clip_adder) -> dict:
    """Phase 22: each tool's main(argv) in-process with the default
    --torch-device cuda, on the inputs of earlier phases made again from
    their seeds (phase 19's .adder kept). Returns the launches per tool."""
    import cv2

    from adder_tpu_torch import testing
    from adder_tpu_torch.ops import cuda_build
    from adder_tpu_torch.tools import (adder_info, adder_recompress,
                                       adder_simulproc, adder_to_dvs,
                                       adder_to_framed, adder_viz,
                                       davis_to_adder, decode_benchmark,
                                       evaluate_crf_sweep,
                                       evaluate_feature_detection,
                                       migrate_raw_v0_v1_to_v2,
                                       prophesee_to_adder)
    from adder_tpu_torch.utils import cv as CV

    t_phase = time.perf_counter()
    display = DisplayLaunches(cuda_build.load(), FR)
    runs = ToolRuns(FR, display, card, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        t0 = time.perf_counter()
        j = lambda name: os.path.join(tmp, name)  # noqa: E731
        testing.write_prophesee_raw(j("dvs.raw"), DVS_W, DVS_H,
                                    *testing.dvs_stream(
                                        11, DVS_W, DVS_H, 1_000_000,
                                        n_hot=200, hot_events=1000,
                                        band_events=1_260_000,
                                        background_events=540_000))
        events, aps = testing.davis_stream(
            21, DAVIS_W, DAVIS_H, 1_000_000, n_frames=DAVIS_FRAMES,
            exposure_us=10_000, n_hot=100, hot_events=1000,
            edge_events=600_000, background_events=300_000)
        testing.write_davis_aedat4(j("davis.aedat4"), DAVIS_W, DAVIS_H,
                                   events, aps)
        write_scene_ffv1(cv2, j("scene.avi"), frames)
        decoded = decoded_mono(cv2, j("scene.avi"), CV)
        if decoded.shape != frames.shape or not np.array_equal(decoded,
                                                               frames):
            raise AssertionError("the FFV1 scene does not decode to phase "
                                 "3's frames")
        transcode_raw(at, frames, dev, j("main.adder"), T_CHUNK)
        with open(j("clip.adder"), "wb") as f:
            f.write(clip_adder)
        write_clip(cv2, j("clip.avi"))
        log(f"# phase 22: inputs made again from their seeds in "
            f"{time.perf_counter() - t0:.1f} s: phase 6's stream, phase 9's "
            f"aedat4, phase 3's scene as FFV1 (decoded by cv2 to phase 3's "
            f"frames, bit for bit) and .adder, phase 19's clip and .adder")

        # the transcoders
        runs.run("prophesee_to_adder", lambda: prophesee_to_adder.main(
            ["-i", j("dvs.raw"), "-o", j("dvs.adder")]))
        hold_digest("phase 6 Prophesee 640x480 windowed Raw .adder",
                    file_digest(j("dvs.adder")))
        runs.run("davis_to_adder", lambda: davis_to_adder.main(
            ["-i", j("davis.aedat4"), "--output-events-filename",
             j("davis.adder"), "-t", "raw-davis"]))
        hold_digest("phase 9 DAVIS 346x260 raw-davis Raw .adder",
                    file_digest(j("davis.adder")))
        # the framed pipeline: the scene's file at the CLI's defaults
        runs.run("adder_simulproc", lambda: adder_simulproc.main(
            ["-i", j("scene.avi"), "--output-events-filename",
             j("sim.adder"), "--output-raw-video-filename", j("sim.raw")]))
        hold_digest("phase 17 simulproc 1080p Raw .adder",
                    file_digest(j("sim.adder")))
        hold_digest("phase 17 simulproc 1080p reconstructed frames",
                    file_digest(j("sim.raw")))
        # reconstruction: phase 3's file framed by the host framer, and by
        # the device framer under the header's delta_t_max
        runs.run("adder_to_framed", lambda: adder_to_framed.main(
            ["-i", j("main.adder"), "-o", j("main.gray")]))
        hold_digest("phase 18 framer 1080p frames of phase 3's .adder "
                    "(DeltaT)", file_digest(j("main.gray")))
        fps = ["--fps", "30"]
        host = runs.run("decode_benchmark --frame", lambda:
                        decode_benchmark.benchmark(decode_benchmark.parse_args(
                            ["-i", j("main.adder"), "--frame", *fps])))
        device = runs.run("decode_benchmark --frame --device", lambda:
                          decode_benchmark.benchmark(
                              decode_benchmark.parse_args(
                                  ["-i", j("main.adder"), "--frame",
                                   "--device", *fps])))
        h = hashlib.sha256()
        if len(device) != len(host) or not host:
            raise AssertionError(f"decode_benchmark: {len(device)} device "
                                 f"frames, {len(host)} host frames")
        for i, (a, b) in enumerate(zip(host, device)):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"decode_benchmark: device frame {i} "
                                     f"differs from the host's")
            h.update(b.tobytes())
        hold_digest("phase 18 framer 1080p frames of phase 3's .adder "
                    "(DeltaT)", h.hexdigest())
        log(f"# phase 22: decode_benchmark --device: {len(device)} frames "
            f"of phase 3's .adder under its header (delta_t_max 6120) equal "
            f"the host framer's")
        del host, device
        # the evaluations on phase 19's clip
        runs.run("evaluate_crf_sweep", lambda: evaluate_crf_sweep.main(
            ["-i", j("clip.avi"), "--crfs", "0,3", "--frames", "24",
             "--output", j("sweep.jsonl")]))
        with open(j("sweep.jsonl")) as f:
            for line in f:
                log(f"#   row {line.strip()}")
        runs.run("evaluate_feature_detection",
                 lambda: evaluate_feature_detection.main(
                     ["-i", j("clip.avi"), "--log", j("features.jsonl")]))
        with open(j("features.jsonl")) as f:
            for line in f.read().splitlines()[:5]:
                log(f"#   log {line}")
        # the codec-only tools on phase 19's .adder
        runs.run("adder_info", lambda: adder_info.main(
            ["-i", j("clip.adder"), "-d"]))
        runs.run("adder_to_dvs", lambda: adder_to_dvs.main(
            ["-i", j("clip.adder"), "--output-events", j("clip.dvs")]))
        runs.run("adder_recompress addrn", lambda: adder_recompress.main(
            ["-i", j("clip.adder"), "-o", j("clip.addrn")]))
        runs.run("adder_recompress raw", lambda: adder_recompress.main(
            ["-i", j("clip.addrn"), "-o", j("back.adder"), "--codec",
             "raw"]))
        a = at.open_file_decoder(j("clip.adder")).digest_all()
        b = at.open_file_decoder(j("back.adder")).digest_all()
        from adder_tpu_torch.core.types import D_EMPTY

        def keys(ev, keep):
            k = ((ev.y.astype(np.int64) * 4096 + ev.x) * 4 + (ev.c % 4)) \
                * 2**40 + ev.t.astype(np.int64) * 256 + ev.d
            return np.sort(k[keep(ev)])

        if not np.array_equal(keys(a, lambda e: e.d != D_EMPTY),
                              keys(b, lambda e: e.d != D_EMPTY)):
            raise AssertionError("adder_recompress: the round trip changed "
                                 "the events")
        log(f"# phase 22: adder_recompress round trip: {len(a)} events in, "
            f"{len(b)} back, every event but D_EMPTY fillers equal "
            f"({int((a.d == D_EMPTY).sum()) - int((b.d == D_EMPTY).sum())} "
            f"fillers not carried)")
        runs.run("migrate_raw_v0_v1_to_v2",
                 lambda: migrate_raw_v0_v1_to_v2.main(
                     ["-i", j("clip.adder"), "-o", j("migrated.adder")]))
        # the GUI: one headless start and stop of the play tab
        t0 = time.perf_counter()
        png = viz_play_once(adder_viz, j("clip.adder"))
        runs.walls["adder_viz"] = time.perf_counter() - t0
        log(f"# phase 22: adder_viz: the play tab on phase 19's .adder over "
            f"HTTP on 127.0.0.1:0, started, one PNG frame ({len(png)} "
            f"bytes), stopped, in {runs.walls['adder_viz']:.3f} s")
    finally:
        display.close()
        shutil.rmtree(tmp, ignore_errors=True)

    need = {"prophesee_to_adder": ("adder_dvs_rows", "adder_rows_group"),
            "davis_to_adder": ("adder_davis_rows", "adder_dvs_rows"),
            "adder_simulproc": ("adder_resident_chunk",
                                "adder_segment_copy"),
            "evaluate_crf_sweep": ("adder_resident_chunk",),
            "evaluate_feature_detection": (
                "adder_resident_chunk (display)",)}
    for name, keys_ in need.items():
        missing = [k for k in keys_ if not runs.launches[name].get(k)]
        if missing:
            raise AssertionError(f"{name} launched no {missing}: "
                                 f"{runs.launches[name]}")
    wall = time.perf_counter() - t_phase
    log(f"# phase 22: every tool ran; walls {runs.walls}; the phase "
        f"{wall:.1f} s, its inputs included [{card}]")
    return {"launches": runs.launches, "walls": runs.walls, "wall": wall}


def viz_play_once(adder_viz, path) -> bytes:
    """Start adder_viz's play tab on `path` through its HTTP API on
    127.0.0.1:0, wait for one PNG frame, stop it and the server."""
    import threading
    import urllib.error
    import urllib.request

    srv = adder_viz.make_server("127.0.0.1", 0)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def post(route, cfg):
        urllib.request.urlopen(urllib.request.Request(
            base + route, json.dumps(cfg).encode(), method="POST"),
            timeout=30)

    try:
        post("/api/start", {"tab": "play", "path": path, "crf": 3,
                            "view_mode": 0, "features": "off", "roi": "",
                            "dtref": 255, "dtmult": 30, "outpath": ""})
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                png = urllib.request.urlopen(base + "/api/frame",
                                             timeout=30).read()
                if png[:8] == b"\x89PNG\r\n\x1a\n":
                    break
            except urllib.error.HTTPError:
                pass
            time.sleep(0.05)
        else:
            raise AssertionError("adder_viz: no PNG frame in 30 s")
        post("/api/stop", {})
        if adder_viz.SESSION.thread is not None:
            raise AssertionError("adder_viz: the worker outlived stop")
        return png
    finally:
        adder_viz.SESSION.stop()
        srv.shutdown()
        srv.server_close()
        thread.join()


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

    t_start = time.perf_counter()
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
    for what in ("framed (K1/K2)", "framed display (K1)", "segment copy",
                 "scan", "DVS rows (K3)", "DAVIS rows (K4)",
                 "fused interval (K5)", "interval slots (K6)"):
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
        if kernel_source(k) in ("framed (K1/K2)", "framed display (K1)",
                                "segment copy", "DVS rows (K3)",
                                "DAVIS rows (K4)", "scan", "other"):
            log(f"#   {k}: {v}")
    # the bench mode's chunk kernel (depth 6, FramePerfect, Collapse,
    # DeltaT, display off), events staged and not: its SASS per interval
    k1_sass = {}
    for k in ptx:
        m = re.search(r"adder_resident_chunk_kernelILi6ELb1ELb1ELb0ELb([01])"
                      r"ELb0E", k)
        if m:
            k1_sass["fetched" if m.group(1) == "1" else "void"] = \
                loop_issue_estimate(cuda_build.library_path(), k)
    log(f"# phase 1: K1 SASS per pixel-interval (cuobjdump -sass; the "
        f"interval loop's body, all paths, and the fewest instructions "
        f"through it that run the interval): {k1_sass}; SM clock "
        f"{sm_clock_hz() / 1e6:.0f} MHz")

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
    copy_err = testing.check_segment_copy_against_plain(dev)
    torch.cuda.synchronize()
    log(f"# phase 2: K1 (one pass, scan, segment copy) and K2 == plain on 8 "
        f"modes x depth 6/8: 2 chained chunks of T = 8 at 200x150, and "
        f"(H, W, T) {testing.EXTRA_CHUNKS}; forced depth-6 overflow; forced "
        f"capacity overflow (total exact at a quarter of the events and at "
        f"0, the staging pool dry; the rerun == plain) (max abs err "
        f"{max_err}); scan == plain at {testing.SCAN_SIZES} counts, aligned "
        f"and unaligned, and at (64, 24300) past 2^31 (max abs err "
        f"{scan_err}); segment copy == plain on staging in shuffled slab "
        f"order (61x47 ragged, no events, every pixel firing; small and "
        f"kernel slabs; full and half capacity) (max abs err {copy_err}); "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    display_err = testing.check_display_against_plain(dev)
    torch.cuda.synchronize()
    log(f"# phase 2: K1 display == plain on 8 modes x depth 6/8 x 2 chained "
        f"chunks of T = 8 and the extra chunks, the 4 view modes, from a "
        f"seeded display frame, events fetched and not, forced depth-6 "
        f"overflow (max abs err {display_err}); "
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
        raw_s, n_kernel, _ = transcode_raw(at, frames, dev, path, T_CHUNK,
                                           before=no_sync_in_chunks)
        launches = dict(FR.LAUNCHES)
        if min(launches["adder_resident_chunk"],
               launches["adder_segment_copy"],
               launches["adder_exclusive_scan"]) < 1:
            raise AssertionError(f"main path missed a kernel: {launches}")
        # one pass over the state machine per chunk (no COUNT and WRITE
        # passes: the argument block has no pass to choose) and one copy
        if (launches["adder_resident_chunk"] != N_FRAMES // T_CHUNK
                or launches["adder_segment_copy"] != N_FRAMES // T_CHUNK
                or "pass_" in dict(FR._ChunkArgs._fields_)):
            raise AssertionError(f"not one pass and one copy per chunk: "
                                 f"{launches}")
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
        hold_digest("phase 3 framed 1080p mono Raw .adder", main_digest)
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
    n = H * W
    f16 = scene[:T_CHUNK].reshape(T_CHUNK, -1).contiguous()
    st = ops.set_initial_d(
        ops.init_state(n, dev, c_thresh=0, depth=6), f16[0].to(torch.int32)
    )
    st = FR.group_chunk_resident(st, f16, 255.0, p).state  # mid-stream
    f16 = scene[T_CHUNK : 2 * T_CHUNK].reshape(T_CHUNK, -1).contiguous()
    # the scan's input on the main path: one count per (interval, warp)
    counts = torch.randint(0, 12, (T_CHUNK, -(-n // 32)),
                           generator=gen, dtype=torch.int32).to(dev)
    # the capacity Video gives a 1080p chunk: N x T events
    cap = n * T_CHUNK
    # the kernels against plain once more, at the main path's shapes
    want = FR.fused_chunk_resident_plain(st, f16, 255.0, p)
    got = FR.fused_chunk_resident(st, f16, 255.0, p, event_cap=cap)
    n_ev = int(want.total)
    max_err = max(
        max_err,
        testing.compare_chunks(got, want, "1080p chunk"),
        testing.compare_chunks(FR.group_chunk_resident(st, f16, 255.0, p),
                               want._replace(pixd=None, t=None),
                               "1080p void chunk"),
    )
    scan_err = max(scan_err, testing.bitwise_max_err(
        FR.exclusive_scan(counts), FR.exclusive_scan_plain(counts),
        "1080p scan",
    ))
    log(f"# phase 4: kernels == plain at 1080p mono T={T_CHUNK} "
        f"({n_ev} events, capacity {cap})")
    k1 = k1_timings(FR, st, f16, p, event_cap=cap)
    k1_2 = k1_timings(FR, st, f16, p, event_cap=cap)
    p_ms = cuda_ms(lambda: FR.fused_chunk_resident_plain(st, f16, 255.0, p), 2)
    vp_ms = cuda_ms(lambda: FR.group_chunk_resident_plain(st, f16, 255.0, p), 2)
    # each kernel of the fetched chunk on the card (torch.profiler)
    parts = kernel_device_ms(
        lambda: FR.fused_chunk_resident(st, f16, 255.0, p, event_cap=cap), 10,
        ("adder_resident_chunk_kernel", "adder_exclusive_scan_kernel",
         "adder_segment_copy_kernel"))
    # the segment copy alone, on the staging of the chunk above
    seg = copy_inputs(FR, st, f16, p, cap)
    copy_err = max(copy_err, *(testing.bitwise_max_err(
        g[:n_ev], w_[:n_ev], f"1080p segment copy {f}") for g, w_, f in zip(
            FR.segment_copy(*seg), FR.segment_copy_plain(*seg), ("pixd", "t"))))
    c_ms = cuda_ms(lambda: FR.segment_copy(*seg), 20)
    c_q_ms = cuda_ms_queued(lambda: FR.segment_copy(*seg), 20)
    cp_ms = cuda_ms(lambda: FR.segment_copy_plain(*seg), 2)
    nonempty = int((seg[2] > 0).sum())
    # counts and offsets read, the starts of non-empty segments read, each
    # event's 8 staged bytes read and its 8 output bytes written
    c_bound = bound(seg[2].numel() * 12 + nonempty * 8 + 16 * n_ev)
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
    k_bound = chunk_bound(st, [f16], n_ev)
    v_bound = chunk_bound(st, [f16], 0)
    k_issue = {k: issue_bound_ms(v["path"], n * T_CHUNK)
               for k, v in k1_sass.items()}
    s_bound = bound(counts.numel() * 4 + (counts.numel() + 1) * 8)
    log(f"# phase 4: 1080p mono T={T_CHUNK} chunk [{card}]:")
    log(f"#   K1 fetched chunk (one pass + scan + segment copy): from the "
        f"host {k1['fetched']}, {k1_2['fetched']} ms; on the card alone "
        f"{k1['fetched_queued']}, {k1_2['fetched_queued']} ms; plain {p_ms} "
        f"ms; bytes bound {k_bound} ms; issue estimate "
        f"{k_issue.get('fetched')} ms ({k1_sass.get('fetched')} SASS)")
    log(f"#   its kernels on the card (torch.profiler, per chunk): {parts}")
    log(f"#   K2 void chunk: from the host {k1['void']}, {k1_2['void']} ms; "
        f"on the card alone {k1['void_queued']}, {k1_2['void_queued']} ms; "
        f"plain {vp_ms} ms; bytes bound {v_bound} ms; issue estimate "
        f"{k_issue.get('void')} ms ({k1_sass.get('void')} SASS)")
    log(f"#   segment copy ({seg[2].numel()} segments, {nonempty} non-empty, "
        f"{n_ev} events): {c_ms} ms from the host, {c_q_ms} ms on the card "
        f"alone, plain {cp_ms} ms, bound {c_bound} ms")
    log(f"#   scan of {tuple(counts.shape)} counts, {FR.SCAN_TILE} a block: "
        f"{s_ms} ms "
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
    log(f"#   device-only: void {n * T_CHUNK / k1['void_queued'] / 1e3} "
        f"Mpx/s, fetched {n * T_CHUNK / k1['fetched_queued'] / 1e3} Mpx/s")
    mono = void_mpx(at, frames, T_CHUNK, dev)
    scene_c = torch.stack(
        [testing.moving_blobs(H, W, N_FRAMES, seed=s, device=dev)
         for s in (7, 8, 9)], dim=-1,
    ).cpu().numpy()
    color = void_mpx(at, scene_c, T_CHUNK, dev)
    log(f"# phase 4: void path (host frames in, Empty sink) 1080p mono "
        f"{mono} Mpx/s, colour {color} Mpx/s (H x W pixels) [{card}]")
    k_ms, k_q_ms = k1["fetched"], k1["fetched_queued"]

    rows_err, dvs_launches, k3r, glue = dvs_phases(dev, card)
    k4, raster, davis_launches = davis_phases(dev, card)
    k5_k6 = interval_phases(dev, card, scene, main_digest, st, p)
    k1_display = features_phases(dev, card, scene, main_digest, st, p)
    k1_display["max_abs_err"] = max(k1_display["max_abs_err"], display_err)
    sim = pipeline_phases(at, FR, dev, card, frames)
    file_launches, clip_adder = file_source_phase(at, FR, dev, card)
    sharded = sharded_phase(at, FR, dev, card, scene, frames, st, p)
    band_records = multihost_phase(card)
    tools = tools_phase(at, FR, dev, card, frames, clip_adder)
    k5_k6[0]["sharded_launches"] = {k: sharded[f"k5_{k}"]
                                    for k in ("k2", "k4")}
    k5_k6[1]["sharded_launches"] = {k: sharded[f"k6_{k}"]
                                    for k in ("k2", "k4")}

    record = {"kernels": [
        {"name": "adder_resident_chunk", "route": "cuda",
         "source": "adder_tpu_torch/csrc/fused_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:676",
         "launches": launches["adder_resident_chunk"],
         "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": k_bound, "bound_by": "bytes", "library_ms": None,
         "queued_ms": k_q_ms, "kernel_ms": parts.get(
             "adder_resident_chunk_kernel"),
         "issue_estimate_ms": k_issue.get("fetched"),
         "void_ms": k1["void"], "void_queued_ms": k1["void_queued"],
         "void_plain_ms": vp_ms, "void_bound_ms": v_bound,
         "simulproc_launches": sim["launches"],
         "file_source_launches": file_launches,
         "sharded_launches": {k: sharded[k] for k in (
             "raw_k2", "raw_k4", "void_k4", "features_k2")},
         "multihost_launches": [r["launches"]["adder_resident_chunk"]
                                for r in band_records],
         "sharded_raw_s": sharded["raw_s"],
         "sharded_void_mpx": sharded["void_mpx"]},
        k1_display,
        {"name": "adder_segment_copy", "route": "cuda",
         "source": "adder_tpu_torch/csrc/fused_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:676",
         "launches": launches["adder_segment_copy"],
         "sharded_launches": {k: sharded[k] for k in ("raw_k2", "raw_k4")},
         "multihost_launches": [r["launches"]["adder_segment_copy"]
                                for r in band_records],
         "max_abs_err": copy_err, "ms": c_ms, "plain_ms": cp_ms,
         "bound_ms": c_bound, "bound_by": "bytes", "library_ms": None,
         "queued_ms": c_q_ms},
        {"name": "adder_exclusive_scan", "route": "cuda",
         "source": "adder_tpu_torch/csrc/fused_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:676",
         "launches": (launches["adder_exclusive_scan"]
                      + dvs_launches["adder_exclusive_scan"]
                      + davis_launches["adder_exclusive_scan"]),
         "max_abs_err": scan_err, "ms": s_ms, "plain_ms": sp_ms,
         "bound_ms": s_bound, "bound_by": "bytes", "library_ms": s_lib_ms,
         "queued_ms": q_ms, "queued_library_ms": q_lib_ms},
        {"name": "adder_dvs_rows", "route": "cuda",
         "source": "adder_tpu_torch/csrc/dvs_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:1159",
         "launches": (dvs_launches["adder_dvs_rows"]
                      + davis_launches["adder_dvs_rows"]),
         "max_abs_err": rows_err, "ms": k3r["ms"],
         "plain_ms": k3r["plain_ms"], "bound_ms": k3r["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "raster_ms": raster["ms"], "raster_plain_ms": raster["plain_ms"],
         "raster_bound_ms": raster["bound_ms"]},
        {"name": "adder_rows_group", "route": "cuda",
         "source": "adder_tpu_torch/csrc/dvs_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:1115",
         "launches": (dvs_launches["adder_rows_group"]
                      + davis_launches["adder_rows_group"]),
         "max_abs_err": max(rows_err, k4["err"]), "ms": glue["ms"],
         "plain_ms": glue["plain_ms"], "bound_ms": glue["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "adder_davis_rows", "route": "cuda",
         "source": "adder_tpu_torch/csrc/davis_resident.cu",
         "replaces": "adder_tpu/ops/fused_resident.py:1411",
         "launches": davis_launches["adder_davis_rows"],
         "max_abs_err": k4["err"], "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "void_ms": k4["void_ms"],
         "passes_ms": k4["passes_ms"]},
        *k5_k6,
    ]}
    # phase 22: what each tool launched of each kernel
    for k in record["kernels"]:
        k["tools_launches"] = {tool: got[k["name"]] for tool, got in
                               tools["launches"].items() if got.get(k["name"])}
    log(f"# all phases passed in {time.perf_counter() - t_start:.1f} s, the "
        f"build included")
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
    if sys.argv[1:2] == ["--band-job"]:
        sys.exit(band_job(sys.argv[2]))
    sys.exit(main())
