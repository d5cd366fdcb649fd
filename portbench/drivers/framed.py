"""The framed driver: frames from host memory through `Video` of adder_tpu_torch.

Set-up renders the traffic's scene from the seed into a pool in host
memory (`scene.pool`), builds the program's `Video` as the configuration
states, and plays `warmup_frames` through it, so the kernels are loaded,
the capacity and the arena depth have settled, and the caching allocator
holds its blocks before the window opens. The window then drives
`Video.submit_chunk` and `Video.collect_chunk` in `FramedStream`'s order
(submit chunk k + 1, then collect chunk k) until `seconds` have passed.

Correctness, once the window has closed and the peak memory was read: the
plain reference (`reference.py`) works out pairs of chunks again and each
number compared must be 0.
- The start: chunks 0 and 1 from the reference's own initial state and
  the stream's first frame.
- In the window: `window_pairs` pairs of chunks at times drawn from the
  seed. The reference starts each pair from the program's state before
  its first chunk (the reference cannot replay the whole window), and
  carries its own state into the second, so the carry between chunks is
  checked too.
Each checked chunk is compared on its state after (every field, bit for
bit: `state_mismatch`), its events per frame and its `pmax`
(`count_mismatch`); on the Raw sink also on the `.adder` bytes the
encoder wrote for it, with the stream's header (`bytes_mismatch`).
"""

from __future__ import annotations

import resource
import time

import numpy as np
import torch

from portbench import reference, scene, stats, tracecap
from portbench.record import Run, TracedChunk
from portbench.sink import MemoryWriter

# the traced stretch of a `--trace 1` window: from this share of it, for
# at most TRACE_MAX_S or to the TRACE_END share
TRACE_START, TRACE_END, TRACE_MAX_S = 0.25, 0.75, 5.0


def program(config: dict, plane: tuple, raw: bool, writer, device):
    """The program's Video, set up as the configuration states."""
    from adder_tpu_torch.codec.encoder import EncoderOptions, EncoderType
    from adder_tpu_torch.core.types import (
        Mode, PixelMultiMode, PlaneSize, SourceCamera, TimeMode)
    from adder_tpu_torch.transcoder.video import Video

    size = PlaneSize(*plane)
    video = Video(size, Mode[config["mode"]],
                  chunk_frames=config["chunk_frames"], device=device)
    if video.engine != config["engine"]:
        raise RuntimeError(f"the environment selects the {video.engine} "
                           f"engine; the configuration states "
                           f"{config['engine']}")
    video.time_parameters(config["tps"], config["ref_time"],
                          config["delta_t_max"], TimeMode[config["time_mode"]])
    video.write_out(SourceCamera[config["source_camera"]],
                    TimeMode[config["time_mode"]],
                    PixelMultiMode[config["pixel_multi_mode"]], None,
                    EncoderType.Raw if raw else EncoderType.Empty,
                    EncoderOptions.default(size), writer)
    # after write_out, whose encoder options would replace them
    video.update_quality_manual(
        config["c_thresh_baseline"], config["c_thresh_max"],
        config["delta_t_max"] // config["ref_time"],
        config["c_increase_velocity"], 0)
    video.void_events = not raw
    return video


def run(config: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device, plane, hook, t_start: float) -> Run:
    W, H, C = plane or (config["plane"]["width"], config["plane"]["height"],
                        config["plane"]["channels"])
    n, T = W * H * C, config["chunk_frames"]
    raw = traffic["sink"] == "raw"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    seq = scene.pool(traffic, W, H, C, seed, dev)
    if len(seq) % T:
        raise ValueError("the playback must hold whole chunks")
    head = scene.start_frame(seed, len(seq), T)

    def frames_of(j):
        k = (head + j * T) % len(seq)
        return seq[k:k + T]

    writer = MemoryWriter() if raw else None
    video = program(config, (W, H, C), raw, writer, dev)
    if hook is not None:
        hook(video)
    from adder_tpu_torch.utils import tracing
    capture = tracecap.Capture(tracing, ("video.", "portbench."))

    pend, kept, check = {}, {}, {0, 1}
    events, live, sub_t, sub_on = {}, {}, {}, {}
    on = [False]  # whether the trace is running

    def submit(j):
        with tracecap.span("portbench.submit", on[0]):
            sub_t[j], sub_on[j] = time.perf_counter(), on[0]
            pend[j] = video.submit_chunk(frames_of(j),
                                         float(config["ref_time"]))

    def collect(j):
        if writer is not None:
            writer.keep = j in check
        with tracecap.span("portbench.collect", on[0]):
            ev = video.collect_chunk(pend[j])
        done = time.perf_counter()
        p = pend.pop(j)
        outs = p["outs"]
        events[j] = len(ev)
        if on[0] or sub_on.get(j):
            # its live arena nodes after, the next chunk's before; read
            # after the window, so the host does not wait on the card here
            live[j] = outs.state.length.sum()
        if j in check:
            kept[j] = dict(state_before=p["state_before"], state=outs.state,
                           per_interval=outs.per_interval, pmax=outs.pmax,
                           bytes=writer.take() if writer is not None else None)
        if writer is not None:
            writer.keep = False
        return done

    # set-up: the warm-up, in the window's order
    warm = traffic["warmup_frames"] // T
    submit(0)
    for j in range(1, warm - 1):
        submit(j)
        collect(j - 1)
    if trace:
        capture.warm(lambda: (submit(warm - 1), collect(warm - 2)))
    else:
        submit(warm - 1)
        collect(warm - 2)
    collect(warm - 1)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    # the window
    rng = np.random.default_rng([seed, 1])
    due = sorted(rng.uniform(0.1, 0.9, traffic["window_pairs"]) * seconds)
    pairs, lat, ends, traced, tr, info = [], [], [], [], None, {}
    attempted = 0
    tr_start = TRACE_START * seconds
    tr_end = min(TRACE_END * seconds, tr_start + TRACE_MAX_S)
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    prev = warm
    submit(prev)
    while True:
        m = prev + 1
        now = time.perf_counter() - t0
        if due and now >= due[0]:
            due = [d for d in due if d > now]
            pairs.append(m)
            check |= {m, m + 1}
        if trace and tr is None and not on[0] and now >= tr_start:
            capture.start()
            on[0] = True
        submit(m)
        if on[0]:
            traced.append(m)
        done = collect(prev)
        attempted += 1
        if not (sub_on.pop(prev) or on[0]):  # the profiler's chunks left out
            lat.append((done - sub_t[prev]) * 1e3)
        now = done - t0
        ends.append(now)
        if on[0] and (now >= tr_end or now >= seconds):
            tr = capture.stop()
            on[0] = False
        if now >= seconds:
            break
        prev = m
    window_s = now
    info["chunks_timed"] = len(lat)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    info["window_cpu_s"] = {"user": ru1.ru_utime - ru0.ru_utime,
                            "sys": ru1.ru_stime - ru0.ru_stime}
    per_s, _ = np.histogram(ends, bins=max(int(window_s), 1), range=(0, window_s))
    if raw:
        info["events_per_px_frame"] = (
            sum(events[j] for j in range(warm, warm + attempted))
            / (attempted * T * n))
    info["mpx_s_by_second"] = [round(float(k) * T * W * H / 1e6 * len(per_s)
                                     / window_s, 1) for k in per_s]
    if due and m not in pairs:  # a window cut short: its last chunk's pair
        pairs.append(m)
        check |= {m, m + 1}
    collect(m)  # the chunk still in flight, after the window
    if pairs and pairs[-1] == m:  # a pair drawn at the window's last chunk
        submit(m + 1)
        collect(m + 1)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del pend, video

    # the check
    t_ref = time.perf_counter()
    p = reference.params_of(config)
    counts = dict(state=0, counts=0, bytes=0)
    if raw:
        counts["bytes"] = bytes_mismatch(
            writer.header, reference.header_bytes(_with_plane(config, W, H, C)))
    failed = 0
    start = reference.first_frame(
        reference.initial_state(n, p, dev),
        torch.from_numpy(np.ascontiguousarray(frames_of(0)[0])).to(dev))
    for first, st in [(0, start)] + [
            (j, reference.as_state(kept[j]["state_before"])) for j in pairs]:
        for j in (first, first + 1):
            frames = torch.from_numpy(np.ascontiguousarray(frames_of(j))).to(dev)
            out = reference.run_chunk(st, frames, p, events=raw)
            got = kept[j]
            bad = dict(state=state_mismatch(got["state"], out.state),
                       counts=counts_mismatch(got["per_interval"],
                                              out.per_interval)
                       + int(int(got["pmax"]) != int(out.pmax)))
            if raw:
                want = reference.event_bytes(out.pixd.cpu().numpy(),
                                             out.t.cpu().numpy(), W, C)
                bad["bytes"] = bytes_mismatch(got["bytes"], want)
            for k, v in bad.items():
                counts[k] += v
            failed += any(bad.values())
            st = out.state
    checks = [("state_mismatch", counts["state"], 0),
              ("count_mismatch", counts["counts"], 0)]
    if raw:
        checks.append(("bytes_mismatch", counts["bytes"], 0))
        info["stream_bytes"] = writer.nbytes
    info["chunks_checked"] = 2 * (1 + len(pairs))
    info["reference_s"] = time.perf_counter() - t_ref
    correct = all(v <= lim for _, v, lim in checks)
    return Run(
        platform="gpu" if cuda else dev.type,
        device_kind=torch.cuda.get_device_name(dev) if cuda else dev.type,
        memory_peak_bytes=int(peak), correct=correct, attempted=attempted,
        failed=failed, setup_s=setup_s, window_s=window_s,
        pixels_per_frame=W * H, frames=attempted * T, latencies_ms=lat,
        trace=tr,
        traced_chunks=[TracedChunk(T, n, int(live[j - 1]), int(live[j]),
                                   events[j]) for j in traced],
        checks=checks, info=info)


def _with_plane(config: dict, W: int, H: int, C: int) -> dict:
    return dict(config, plane=dict(width=W, height=H, channels=C))


def state_mismatch(got, want) -> int:
    """Elements of any field that differ bit for bit (a field of another
    shape counts whole)."""
    bad = 0
    for f in reference.State._fields:
        a, b = getattr(got, f), getattr(want, f)
        if a.shape != b.shape or a.dtype != b.dtype:
            bad += max(a.numel(), b.numel())
            continue
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad += int((a != b).sum())
    return bad


def counts_mismatch(got, want) -> int:
    """The sum of each frame's event-count difference (a frame one side
    lacks counts as 0 there)."""
    a, b = got.cpu().tolist(), want.cpu().tolist()
    k = max(len(a), len(b))
    a, b = a + [0] * (k - len(a)), b + [0] * (k - len(b))
    return sum(abs(x - y) for x, y in zip(a, b))


def bytes_mismatch(got: bytes, want: bytes) -> int:
    """Bytes that differ, and every byte one side has past the other's end."""
    k = min(len(got), len(want))
    a = np.frombuffer(got, dtype=np.uint8, count=k)
    b = np.frombuffer(want, dtype=np.uint8, count=k)
    return int((a != b).sum()) + abs(len(got) - len(want))
