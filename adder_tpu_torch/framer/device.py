"""Device-side framer: the segmented-scan event->frame pipeline in torch ops.

Port of `adder_tpu/framer/device.py` (`_make_batch_step`, `DeviceFramer`).
The host framer (framer/driver.py) reformulates the reference's per-event
ingest (ref: adder-codec-rs/src/framer/driver.rs:984-1133) as segmented
scans over a pixel-sorted batch; this module runs the same formulation on
the torch device (the card unless the caller asks for the CPU):

  stable sort by pixel (keeps per-pixel order, the reference's own
  invariant) -> segmented chains (AbsoluteT monotonicity guard, framed
  ref_interval rounding, last-filled-frame cummax, the D_EMPTY payload
  carry) -> span fill into a modular (F, N) frame window by one scatter
  pass per frame of the longest span, first write wins -> the carries at
  each segment's last event.

The window holds each cell's (d, delta_t) pair, never a display value; the
host converts popped frames through the same f64 `get_frame_values` as the
host framer, so popped frames equal the host framer's byte for byte.

Differences from the JAX step, none of which changes a popped frame:
- the chains are computed in int64 (torch on CUDA has no uint32 division,
  maximum or cummax); the (F, N) window planes are stored as int32 (d, and
  the bits of the u32 delta_t), which halves the memory of int64 planes.
  A DeltaT chain at or past 2^31 raises OverflowError, as in the JAX
  package. Where the JAX step rounds `t` to ref_interval in u32 and wraps
  (t within ref_interval of 2^32), int64 does not wrap and agrees with the
  host framer's u64;
- the span passes and the window follow the spans the ingest holds, where
  the JAX step bounds a span by delta_t_max / tpf and the window by its
  argument, and raises past either. Collapse mode's D_EMPTY fillers carry
  the summed time of the events they replace, which can pass delta_t_max,
  and the host framer fills every frame an event spans, growing its
  buffer. Here the passes start at the header's bound, widened before the
  upload where the host can bound the spans from the times alone (DeltaT:
  the largest time; AbsoluteT: the window from the latest time); the step
  measures the longest span and the furthest frame on the device, and an
  ingest that needed more passes or rows than it had runs again from a
  clone of the carries, with both grown (its writes so far are the rerun's
  own, so the window needs no clone). A window that would outgrow the
  card's free memory raises OverflowError before it is allocated;
- the segmented scans are a global cumsum minus each segment's base, and a
  cummax of keys offset by segment (`_seg_cumsum`, `_seg_cummax`), in
  place of `jax.lax.associative_scan` with a segment flag;
- masked scatter writes land in one extra dummy slot at the end of each
  flat plane (JAX drops them out of bounds); the real writes of one pass
  are unique, so duplicate indices exist only at that slot, which is never
  read;
- a batch is the events themselves, no padding to `batch_cap`: the whole
  ingest is uploaded once and sliced on the device, and nothing is read
  back per batch. The measured needs and the chain flag stay on the device
  and are read with the window's fill counts once per `ingest_event_array`
  (twice on a rerun);
- popped rows narrow delta_t to u16 when every payload stored so far fits
  (the largest is read with the control outputs), not by delta_t_max.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.types import D_EMPTY, NO_CHANNEL, EventArray, TimeMode, is_framed
from ..transcoder.video import resolve_device
from ..utils import tracing
from .driver import FramerBuilder
from .scale_intensity import (
    FramedViewMode,
    get_frame_values,
    practical_d_max_for,
)

_SENTINEL_NEG = -(1 << 30)
# key spans of the segmented cummax: values are offset to >= 0 and stay
# below the span (rounded u32 times < 2^33; frame indices < 2^33; the
# sentinel -2^30), and segment ids stay below 2^24 (`batch_cap`)
_CHAIN_SPAN = 1 << 34
_MAX_BATCH = 1 << 24


def _seg_ids(seg_start: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(seg_start.to(torch.int64), 0) - 1


def _seg_cumsum(x: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of int64 `x`, restarting at every segment start: a
    global cumsum minus the exclusive sum at the segment's first element."""
    total = torch.cumsum(x, 0)
    idx = torch.arange(len(x), device=x.device)
    first = torch.cummax(torch.where(seg_start, idx, 0), 0).values
    return total - (total - x)[first]


def _seg_cummax(x: torch.Tensor, seg: torch.Tensor, lo: int,
                span: int) -> torch.Tensor:
    """Inclusive cummax of int64 `x` (lo <= x < lo + span) within each
    segment (`seg` the non-decreasing segment ids): the keys of segment k
    lie in [k * span, (k + 1) * span), above every earlier segment's."""
    base = seg * span
    return torch.cummax(base + (x - lo), 0).values - base + lo


def _seg_exclusive(inclusive: torch.Tensor, seg_start: torch.Tensor,
                   carry: torch.Tensor) -> torch.Tensor:
    prev = torch.cat([inclusive[:1], inclusive[:-1]])
    return torch.where(seg_start, carry, prev)


def _free_bytes(device: torch.device) -> Optional[int]:
    """The device memory free for the window (None on the CPU, where the
    host's memory is not checked)."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[0]


def _write_pass(planes, flat: torch.Tensor, values) -> None:
    """One span-fill pass: planes[k][flat] = values[k] for each flat plane.
    Masked events carry the dummy index (the planes' last slot)."""
    for plane, v in zip(planes, values):
        plane.index_put_((flat,), v)


class DeviceFramer:
    """FrameSequence on the torch device (AbsoluteT and bounded DeltaT
    streams), the card unless the caller asks for the CPU.

    API: ingest_event_array / is_frame_0_filled / pop_next_frame /
    pop_ready_frames / flush_frame_buffer / drain / frames_written. Values
    are converted on pop through the host `get_frame_values` f64 path, so
    popped frames equal the host framer's byte for byte."""

    def __init__(self, b: FramerBuilder, batch_cap: int = 1 << 17,
                 window: Optional[int] = None, *, device="cuda"):
        self.device = resolve_device(device)
        if not 0 < batch_cap <= _MAX_BATCH:
            raise ValueError(f"batch_cap must be in 1..{_MAX_BATCH}")
        self._absolute = (
            b.codec_version >= 2 and b.time_mode == TimeMode.AbsoluteT
        )
        self.b = b
        self.plane = b.plane
        self.n = b.plane.volume()
        self.coordless = b.coordless
        self.out_dtype = (
            np.dtype(np.uint64) if b.coordless else np.dtype(b.out_dtype)
        )
        self.tpf = int(b.tps / b.output_fps) if b.output_fps else b.ref_interval
        self.ref_interval = b.ref_interval
        self.delta_t_max = b.delta_t_max
        self.view_mode = b.view_mode
        self.source = b.source
        self._framed_round = b.codec_version >= 1 and is_framed(
            b.source_camera
        )
        # SAE on DeltaT streams needs the chain value as payload; on
        # AbsoluteT the standard (t - prev_chain) payload IS the SAE diff
        self._sae_chain = (
            self.view_mode == FramedViewMode.SAE
            and not self._absolute
            and not self.coordless
        )
        # the span passes and the window rows to start from; both grow to
        # what an ingest holds
        self.max_span = max(self.delta_t_max // max(self.tpf, 1) + 2, 4)
        self.window = window or max(2 * self.max_span, 64)
        self._dt_hi = 0  # the largest delta_t payload stored so far
        self.batch_cap = batch_cap
        self.frames_written = 0

        n, F, dev = self.n, self.window, self.device
        # per-pixel carries; slot n takes the masked carry writes
        self.running_ts = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        self.last_filled = torch.full((n + 1,), -1, dtype=torch.int64,
                                      device=dev)
        # never-filled pixels must convert to the host framer's
        # zero-initialized last_intensity: d=255 maps to intensity 0 in the
        # Intensity view, while the D view and coordless packing read d
        # directly and need a literal 0 payload (DeltaT/SAE read only dt)
        init_d = (
            255
            if (
                self.view_mode == FramedViewMode.Intensity
                and not self.coordless
            )
            else 0
        )
        self.li_d = torch.full((n + 1,), init_d, dtype=torch.int64,
                               device=dev)
        self.li_dt = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        # the (F, N) window, flat with one dummy slot at the end
        self._wd = torch.zeros(F * n + 1, dtype=torch.int32, device=dev)
        self._wdt = torch.zeros(F * n + 1, dtype=torch.int32, device=dev)
        self._wf = torch.zeros(F * n + 1, dtype=torch.bool, device=dev)
        self._counts = np.zeros(F, np.int64)
        self._force_pop = False
        self._practical_d_max = practical_d_max_for(
            float(np.iinfo(self.out_dtype).max), self.delta_t_max,
            self.ref_interval,
        )

    @property
    def win_d(self) -> torch.Tensor:
        return self._wd[: -1].view(self.window, self.n)

    @property
    def win_dt(self) -> torch.Tensor:
        return self._wdt[: -1].view(self.window, self.n)

    @property
    def win_filled(self) -> torch.Tensor:
        return self._wf[: -1].view(self.window, self.n)

    def _pix_index(self, events: EventArray) -> np.ndarray:
        c = np.where(events.c == NO_CHANNEL, 0, events.c).astype(np.int64)
        return (
            events.y.astype(np.int64) * self.plane.width
            + events.x.astype(np.int64)
        ) * self.plane.channels + c

    def _step(self, pix, t, d, base: int, passes: int, need: torch.Tensor,
              overflow: torch.Tensor) -> None:
        """One batch: pix, t, d are int64 (E,) on the device, in arrival
        order. Updates the carries and the window in place, fills `passes`
        frames of each span at most and none past the window, raises `need`
        to (frames past `base`, longest span, largest delta_t payload) and
        ORs the DeltaT chain's overflow into `overflow` (no host read)."""
        n, F = self.n, self.window
        pix, order = torch.sort(pix, stable=True)
        t = t[order]
        d = d[order]
        cap = len(pix)
        seg_start = torch.ones(cap, dtype=torch.bool, device=pix.device)
        seg_start[1:] = pix[1:] != pix[:-1]
        seg = _seg_ids(seg_start)

        rts0 = self.running_ts[pix]
        lf0 = self.last_filled[pix]
        ref = self.ref_interval
        rt = t
        if self._framed_round:
            rt = torch.div(t + (ref - 1), ref, rounding_mode="floor") * ref
        if self._absolute:
            incl_rt = _seg_cummax(torch.maximum(rt, rts0), seg, 0,
                                  _CHAIN_SPAN)
            prev_chain = _seg_exclusive(incl_rt, seg_start, rts0)
            keep = t > prev_chain
            v = t  # pre-rounding running value for the frame index
            dt_for_value = torch.clamp(t - prev_chain, min=0)
        else:
            # DeltaT: running_ts accumulates (rounded) deltas; chains held
            # below 2^31 as in the JAX package (overflow checked below)
            incl_rt = rts0 + _seg_cumsum(rt, seg_start)
            base_chain = incl_rt - rt
            keep = torch.ones(cap, dtype=torch.bool, device=pix.device)
            v = base_chain + t
            # SAE on DeltaT streams displays the chain value itself
            # (host: sae_running_t=v, sae_last_fired_t=0)
            dt_for_value = v if self._sae_chain else t

        # frame index: (running_ts.saturating_sub(1)) / tpf
        f_idx = torch.div(torch.clamp(v, min=1) - 1, self.tpf,
                          rounding_mode="floor")
        f_for_chain = torch.where(keep, f_idx, _SENTINEL_NEG)
        incl_lf = _seg_cummax(torch.maximum(f_for_chain, lf0), seg,
                              _SENTINEL_NEG, _CHAIN_SPAN)
        prev_lf = _seg_exclusive(incl_lf, seg_start, lf0)
        fires = keep & (f_idx > prev_lf)

        # fill payload: (d, dt); D_EMPTY repeats the previous payload
        compute = fires & (d != D_EMPTY)
        idx = torch.arange(cap, device=pix.device)
        incl_src = _seg_cummax(torch.where(compute, idx, -1), seg, -1,
                               cap + 1)
        has_src = incl_src >= 0
        gsrc = torch.clamp(incl_src, min=0)
        fill_d = torch.where(has_src, d[gsrc], self.li_d[pix])
        fill_dt = torch.where(has_src, dt_for_value[gsrc], self.li_dt[pix])

        # span fill: a fired event fills frames (prev_lf, f_idx] with its
        # payload, first write wins; a pixel's spans are disjoint and start
        # past its filled frames, so each cell has one writer in an ingest
        lo = torch.clamp(prev_lf + 1, min=base)
        hi = f_idx
        zero = torch.zeros((), dtype=torch.int64, device=pix.device)
        need.copy_(torch.maximum(need, torch.stack([
            torch.where(fires, hi - base + 1, zero).max(),
            torch.where(fires, hi - lo + 1, zero).max(),
            fill_dt.max(),
        ])))
        planes = (self._wd, self._wdt, self._wf)
        values = (fill_d.to(torch.int32), fill_dt.to(torch.int32),
                  torch.ones((), dtype=torch.bool, device=pix.device))
        dummy = F * n
        # frames past the window wait for the rerun
        hi_w = torch.clamp(hi, max=base + F - 1)
        for s in range(passes):
            fr = lo + s
            m = fires & (fr <= hi_w)
            flat = torch.where(m, torch.remainder(fr, F) * n + pix, dummy)
            write = m & ~self._wf[flat]
            _write_pass(planes, torch.where(write, flat, dummy), values)

        if not self._absolute:
            overflow |= incl_rt.max() >= (1 << 31)

        # carries: the value at each segment's last event
        last_el = torch.ones(cap, dtype=torch.bool, device=pix.device)
        last_el[:-1] = seg_start[1:]
        seg_pix = torch.where(last_el, pix, n)
        self.running_ts[seg_pix] = torch.maximum(incl_rt, rts0)
        self.last_filled[seg_pix] = torch.maximum(incl_lf, lf0)
        self.li_d[seg_pix] = fill_d
        self.li_dt[seg_pix] = fill_dt

    def _grow(self, rows: int) -> None:
        """Widen the window to at least `rows` rows (a multiple of 8),
        moving the rows of frames [frames_written, frames_written + F) to
        their places modulo the new width."""
        F, n = self.window, self.n
        F2 = -(-rows // 8) * 8
        if F2 <= F:
            return
        # d and delta_t as int32 and the fill flag, per cell
        grown_bytes = F2 * n * 9
        free = _free_bytes(self.device)
        if free is not None and grown_bytes > free + F * n * 9:
            raise OverflowError(
                f"device framer: one ingest spans {F2} frames, a window of "
                f"{grown_bytes / 2**30:.2f} GiB against "
                f"{free / 2**30:.2f} GiB free on {self.device}; ingest the "
                f"events in smaller arrays, popping frames between them")
        frames = self.frames_written + np.arange(F)
        old_h, new_h = frames % F, frames % F2
        old = torch.from_numpy(old_h).to(self.device)
        new = torch.from_numpy(new_h).to(self.device)
        for name in ("_wd", "_wdt", "_wf"):
            plane = getattr(self, name)
            grown = torch.zeros(F2 * n + 1, dtype=plane.dtype,
                                device=self.device)
            grown[:-1].view(F2, n)[new] = plane[:-1].view(F, n)[old]
            setattr(self, name, grown)
        counts = np.zeros(F2, np.int64)
        counts[new_h] = self._counts[old_h]
        self._counts = counts
        self.window = F2

    def _carries(self) -> tuple:
        return (self.running_ts, self.last_filled, self.li_d, self.li_dt)

    def ingest_event_array(self, events: EventArray) -> bool:
        m = len(events)
        if m == 0:
            return self.is_frame_0_filled()
        # ONE upload per ingest: [pix, bits(t), d] as an int32 carrier
        with tracing.stage("device_framer.pack"):
            packed = np.empty((3, m), np.int32)
            packed[0] = self._pix_index(events)
            packed[1] = events.t.astype(np.uint32).view(np.int32)
            packed[2] = events.d
            # what the times alone bound: a DeltaT span lasts at most the
            # largest time (rounded up) plus a frame; an AbsoluteT event
            # fills no frame past the latest time's
            t_hi = int(events.t.max())
            base = self.frames_written
            if not self._absolute:
                self.max_span = max(self.max_span,
                                    (t_hi + self.ref_interval) // self.tpf + 2)
            else:
                self._grow((max(t_hi, 1) - 1) // self.tpf - base + 1)
        with tracing.stage("device_framer.dispatch"):
            packed = torch.from_numpy(packed).to(self.device)
            pix_all = packed[0].to(torch.int64)
            t_all = packed[1].to(torch.int64) & 0xFFFFFFFF
            d_all = packed[2].to(torch.int64)
            saved = tuple(c.clone() for c in self._carries())
        while True:
            with tracing.stage("device_framer.dispatch"):
                need = torch.zeros(3, dtype=torch.int64, device=self.device)
                overflow = torch.zeros((), dtype=torch.bool,
                                       device=self.device)
                for i in range(0, m, self.batch_cap):
                    j = min(i + self.batch_cap, m)
                    self._step(pix_all[i:j], t_all[i:j], d_all[i:j], base,
                               self.max_span, need, overflow)
            # ONE read back for the control outputs: the window's fill
            # counts after the last batch, the needs and the chain flag
            with tracing.stage("device_framer.sync_fetch"):
                ctl = torch.cat([torch.count_nonzero(self.win_filled, dim=1),
                                 need, overflow.view(1).to(torch.int64)]
                                ).cpu().numpy().astype(np.int64)
            if ctl[-1]:
                raise OverflowError(
                    "device framer: a DeltaT chain reached 2^31 ticks")
            rows, span, dt_hi = (int(v) for v in ctl[-4:-1])
            self._dt_hi = max(self._dt_hi, dt_hi)
            if rows <= self.window and span <= self.max_span:
                break
            # more frames or a longer span than this pass had room for:
            # grow, put the carries back and run the ingest again
            with tracing.stage("device_framer.rerun"):
                self.max_span = max(self.max_span, span)
                self._grow(rows)
                for c, s in zip(self._carries(), saved):
                    c.copy_(s)
        self._counts = ctl[:-4]
        return self.is_frame_0_filled()

    def is_frame_0_filled(self) -> bool:
        return int(self._counts[self.frames_written % self.window]) >= self.n

    def _values_for(self, dd: np.ndarray, dtt: np.ndarray) -> np.ndarray:
        if self.coordless:
            # EventCoordless passthrough: (d, delta-t) packed into u64
            # (the device window already holds exactly that pair)
            return (dd.astype(np.uint64) << 32) | dtt.astype(np.uint64)
        if self.view_mode == FramedViewMode.SAE:
            # the stored payload is the SAE diff (see _sae_chain note)
            return get_frame_values(
                dd.astype(np.int64), dtt.astype(np.uint64), self.out_dtype,
                self.source, float(self.ref_interval),
                self._practical_d_max, self.delta_t_max, self.view_mode,
                sae_running_t=dtt.astype(np.uint64),
                sae_last_fired_t=np.zeros(len(dtt), np.uint64),
            )
        return get_frame_values(
            dd.astype(np.int64), dtt.astype(np.uint64), self.out_dtype,
            self.source, float(self.ref_interval), self._practical_d_max,
            self.delta_t_max, self.view_mode,
        )

    def _recycle(self, rows: torch.Tensor) -> None:
        for plane in (self.win_d, self.win_dt, self.win_filled):
            plane.index_fill_(0, rows, 0)

    def pop_next_frame(self) -> Optional[np.ndarray]:
        """Pop frame 0 if every pixel is filled (None otherwise; a
        preceding flush_frame_buffer() force-pops with back-fill)."""
        if not self._force_pop and not self.is_frame_0_filled():
            return None
        self._force_pop = False
        return self._pop_row()

    def _pop_row(self) -> np.ndarray:
        row = self.frames_written % self.window
        dd, dtt, filled = (p[row].cpu().numpy() for p in (
            self.win_d, self.win_dt, self.win_filled))
        vals = self._values_for(dd, dtt.view(np.uint32))
        # unfilled pixels inherit the carry payload (flush semantics use
        # this too; during normal pops every pixel is filled)
        if not filled.all():
            carry_d = self.li_d[: self.n].cpu().numpy()
            carry_dt = self.li_dt[: self.n].cpu().numpy()
            vals = np.where(filled, vals, self._values_for(carry_d, carry_dt))
        self._recycle(torch.tensor([row], device=self.device))
        self._counts[row] = 0
        self.frames_written += 1
        return vals.reshape(self.plane.shape).astype(self.out_dtype)

    def pop_ready_frames(self) -> list:
        """Pop every consecutive complete frame in ONE fetch from the
        device, d narrowed to u8 and delta_t to u16 where delta_t_max fits
        (5 or 3 bytes a pixel instead of 8)."""
        F = self.window
        k = 0
        while k < F - 1 and (
            self._counts[(self.frames_written + k) % F] >= self.n
        ):
            k += 1
        if k == 0:
            return []
        rows_h = np.array([(self.frames_written + i) % F for i in range(k)],
                          np.int64)
        rows = torch.from_numpy(rows_h).to(self.device)
        narrow = self._dt_hi < (1 << 16)
        with tracing.stage("device_framer.pop_d2h"):
            dd = self.win_d.index_select(0, rows).to(torch.uint8)
            dtt = self.win_dt.index_select(0, rows)
            if narrow:
                dtt = dtt.to(torch.int16)
            dd, dtt = dd.cpu().numpy(), dtt.cpu().numpy()
        dtt = dtt.view(np.uint16 if narrow else np.uint32)
        with tracing.stage("device_framer.recycle"):
            self._recycle(rows)
            self._counts[rows_h] = 0
        out = []
        with tracing.stage("device_framer.convert"):
            for i in range(k):
                vals = self._values_for(dd[i], dtt[i])
                out.append(
                    vals.reshape(self.plane.shape).astype(self.out_dtype))
        self.frames_written += k
        return out

    def flush_frame_buffer(self) -> bool:
        """Back-fill the current frame from the per-pixel carry and mark it
        poppable (host framer / ref driver.rs:632-677 semantics)."""
        hi = int(self.last_filled[: self.n].max())
        if hi > self.frames_written:
            self._force_pop = True
            return True
        return self.is_frame_0_filled()

    def drain(self) -> list:
        """Batch-pop all complete frames, then a single back-filling flush
        (the simulproc shutdown drive, like the host framer)."""
        out = self.pop_ready_frames()
        if self.flush_frame_buffer() and self._force_pop:
            out.append(self.pop_next_frame())
            out.extend(self.pop_ready_frames())
        return out
