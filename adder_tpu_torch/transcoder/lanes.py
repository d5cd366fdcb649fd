"""The lane-chunk plumbing the event-camera sources share (Prophesee, DAVIS):
the chunk parameters, one chunk through a row wrapper of
`ops/fused_resident`, the Prophesee lane groups' pipeline (`LanePipeline`),
and the hand-off of their events to the encoder."""

from __future__ import annotations

import collections
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..core.types import NO_CHANNEL, EventArray, Mode, TimeMode
from ..ops import dvs_batch
from ..ops import fused_resident as FR
from ..ops import integrate as ops
from ..utils import tracing
from .video import Video


def lane_params(v: Video) -> ops.TranscodeParams:
    """The lane chunks' parameters from the Video's time base and CRF:
    Continuous mode, AbsoluteT."""
    crf = v.encoder.options.crf.get_parameters()
    return ops.TranscodeParams(
        mode=int(Mode.Continuous),
        multi_mode=int(v.pixel_multi_mode),
        time_mode=int(TimeMode.AbsoluteT),
        ref_time=int(v.ref_time),
        delta_t_max=int(v.delta_t_max),
        c_thresh_max=int(crf.c_thresh_max),
        c_increase_velocity=max(int(crf.c_increase_velocity), 1),
    )


def run_lane_chunk(fn, state, args, p, void: bool, width: int, **kw):
    """One lane chunk of the row wrapper `fn` (`dvs_rows_resident` or
    `davis_rows_resident`) on `state`, `args` being its inputs between the
    state and the parameters (the carrier and T) and `kw` its keywords:
    (the state, updated in place and returned by the wrapper; its events as
    (x, y, d, t) host arrays, or None when `void`: the void walk, no
    fetch)."""
    with tracing.stage("dvs.dispatch"):
        res = fn(state, *args, p, events=not void, **kw)
    if void:
        return res.state, None
    with tracing.stage("dvs.event_fetch", items=res.pixd.numel()):
        pixd = res.pixd.cpu().numpy().view(np.uint32)
        t = res.t.cpu().numpy().view(np.uint32)
    return res.state, dvs_batch.wire_to_events(pixd, t, width)


def gap_rows(pix, fv, inten, tspan) -> np.ndarray:
    """Gap-only DVS rows in lane 0, one for each pixel of `pix` (ascending:
    raster order), as the (5, E) int32 carrier of `FR.pack_dvs_plan`: the
    held intensity `inten` (cast to f32) over `tspan` ticks (cast to f32)
    with frame value `fv` (0..255), the tick half off. Run at T = 2 through
    `run_raster_chunk`, this is the JAX sources' masked interval over the
    pixels of `pix`, with an empty tick sub-step after it."""
    packed = np.zeros((5, len(pix)), np.int32)
    packed[0] = np.asarray(pix, np.int32) | (1 << 27)
    packed[1] = fv
    packed[2] = np.asarray(inten, np.float32).view(np.int32)
    packed[3] = np.asarray(tspan, np.float32).view(np.int32)
    return packed


def run_raster_chunk(state, carrier, p, void: bool, width: int):
    """`run_lane_chunk` of a T = 2 DVS carrier of one row per pixel in
    raster order, all in lane 0 (the bootstrap, an end-of-stream flush,
    DAVIS's frame and the gap to it): through `FR.dvs_rows_resident` with
    the grouping such a carrier has, `FR.raster_row_groups`, so no glue
    runs."""
    groups = FR.raster_row_groups(carrier.shape[1], carrier.device)
    return run_lane_chunk(FR.dvs_rows_resident, state, (carrier, 2), p, void,
                          width, groups=groups)


def ingest_parts(encoder, parts: list) -> EventArray:
    """Concatenate (x, y, d, t) parts (None for a void chunk; a Future of
    one for a group whose fetch runs on `LanePipeline`'s worker, waited for
    here, in order) into one EventArray and feed it to `encoder`."""
    if any(isinstance(q, Future) for q in parts):
        with tracing.stage("dvs.fetch_wait"):
            parts = [q.result() if isinstance(q, Future) else q
                     for q in parts]
    parts = [q for q in parts if q is not None]
    if parts:
        x, y, d, t = (np.concatenate([q[i] for q in parts]) for i in range(4))
    else:
        x = y = np.zeros(0, np.uint16)
        d = np.zeros(0, np.uint8)
        t = np.zeros(0, np.uint32)
    arr = EventArray(x, y, np.full(len(x), NO_CHANNEL, np.uint8), d, t)
    with tracing.stage("dvs.encode", items=len(arr)):
        encoder.ingest_event_array(arr)
    return arr


def lane_event_cap(active_cells: int) -> int:
    """The most events a lane group of `active_cells` active (sub-step,
    pixel) cells can emit: DVS_DEPTH + 3 slots a cell."""
    return (FR.DVS_DEPTH + 3) * int(active_cells)


class LanePipeline:
    """The Prophesee lane groups in flight, in the JAX resident engine's
    order (`adder_tpu/transcoder/prophesee.py:534-744`: `_stage_dvs_group8`,
    `_flush_staged`, `_dispatch_staged_oldest`, `_collect_dvs_oldest`).

    `stage` copies a group's host carrier into pinned memory and enqueues
    its host -> device copy on a side stream, so the upload runs while the
    host plans and packs the next group; the compute stream waits for it
    when the group is dispatched. At most `max_staged` groups wait staged
    and `max_in_flight` have run with their events not yet collected
    (`step`); a group is dispatched through its row wrapper with an event
    capacity from the host plan (`lane_event_cap`), so nothing is read back
    on the calling thread. A collected group's fetch runs on one worker
    thread, in order: it waits for the group's event (its total was copied
    to pinned memory behind the launches), copies the events out and
    unpacks them, and the caller gets a Future (`ingest_parts` waits for
    it). The state chains through the row wrappers in place, in dispatch
    order; anything else that reads or writes the state first dispatches
    what is staged (`flush`). On the CPU the same queue runs with the plain
    versions, the copies being no-ops. With `max_staged` and
    `max_in_flight` 0 every group runs and is fetched before `step`
    returns: the synchronous route."""

    max_staged = 1
    max_in_flight = 2

    def __init__(self, device: torch.device, width: int):
        self.device = device
        self.width = width
        self._staged: collections.deque = collections.deque()
        self._in_flight: collections.deque = collections.deque()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._cuda = device.type == "cuda"
        self._copy_stream = self._fetch_stream = None
        if self._cuda:
            self._copy_stream = torch.cuda.Stream(device)
            self._fetch_stream = torch.cuda.Stream(device)

    def __len__(self) -> int:
        return len(self._staged) + len(self._in_flight)

    def stage(self, carrier: np.ndarray, n_lanes: int, pb: Optional[int],
              cap: int, p, void: bool) -> None:
        """Queue one lane group of `n_lanes` lanes: its int32 carrier (the
        20-byte one with `pb` None, else the 8-byte one with pixel field
        `pb`), its event capacity, its parameters."""
        with tracing.stage("dvs.upload", items=carrier.nbytes):
            if self._cuda:
                host = torch.empty(carrier.shape, dtype=torch.int32,
                                   pin_memory=True)
                host.numpy()[...] = carrier
                with torch.cuda.stream(self._copy_stream):
                    dev = torch.empty(carrier.shape, dtype=torch.int32,
                                      device=self.device)
                    dev.copy_(host, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
                # made on the copy stream, read on the compute stream
                dev.record_stream(torch.cuda.current_stream(self.device))
            else:
                dev, ready = torch.from_numpy(carrier), None
        self._staged.append((dev, ready, 2 * n_lanes, pb, cap, p, void))

    def step(self, state) -> list:
        """Dispatch the oldest staged groups past `max_staged` and collect
        the oldest in flight past `max_in_flight`; their parts, in order."""
        parts = []
        while len(self._staged) > self.max_staged:
            self._dispatch_oldest(state)
        while len(self._in_flight) > self.max_in_flight:
            parts.append(self._collect_oldest())
        return parts

    def flush(self, state) -> None:
        """Dispatch every staged group, oldest first."""
        while self._staged:
            self._dispatch_oldest(state)

    def drain(self, state) -> list:
        """Dispatch every staged group and collect every group in flight;
        their parts, in order."""
        self.flush(state)
        return [self._collect_oldest() for _ in range(len(self._in_flight))]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def _dispatch_oldest(self, state) -> None:
        carrier, ready, T, pb, cap, p, void = self._staged.popleft()
        with tracing.stage("dvs.dispatch"):
            if ready is not None:
                if not ready.query():  # the upload was still running
                    tracing.add_items("dvs.upload_pending", 1)
                torch.cuda.current_stream(self.device).wait_event(ready)
            if pb is None:
                res = FR.dvs_rows_resident(state, carrier, T, p,
                                           events=not void, event_cap=cap)
            else:
                res = FR.dvs_rows8_resident(state, carrier, T, p,
                                            events=not void, pb=pb,
                                            event_cap=cap)
            job = None
            if not void:
                total, done = res.total, None
                if self._cuda:  # the total to the host behind the launches
                    total = torch.empty(1, dtype=torch.int64,
                                        pin_memory=True)
                    total.copy_(res.total.view(1), non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                job = (res.pixd, res.t, total, done, cap)
        self._in_flight.append(job)

    def _collect_oldest(self):
        job = self._in_flight.popleft()
        if job is None:  # the void walk: nothing to fetch
            return None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1)
        fut = self._pool.submit(self._fetch, *job)
        return fut.result() if self.max_in_flight == 0 else fut

    def _fetch(self, pixd, t, total, done, cap: int):
        """On the worker: one group's events as (x, y, d, t) host arrays."""
        with tracing.stage("dvs.event_fetch"):
            if done is None:
                n = int(total)
                hp, ht = pixd[:n], t[:n]
            else:
                done.synchronize()
                n = int(total[0])
                if n > cap:
                    raise RuntimeError(f"a lane group emitted {n} events "
                                       f"past its capacity {cap}")
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self._fetch_stream):
                    hp = torch.empty(n, dtype=torch.int32, pin_memory=True)
                    ht = torch.empty(n, dtype=torch.int32, pin_memory=True)
                    hp.copy_(pixd[:n], non_blocking=True)
                    ht.copy_(t[:n], non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(self._fetch_stream)
                copied.synchronize()
            tracing.add_items("dvs.event_fetch", n)
        return dvs_batch.wire_to_events(hp.numpy().view(np.uint32),
                                        ht.numpy().view(np.uint32),
                                        self.width)
