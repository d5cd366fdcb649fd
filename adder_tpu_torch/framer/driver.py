"""Framer: ADDER events -> instantaneous frames, fully vectorized.

Copy of `adder_tpu/framer/driver.py` (`FramerBuilder`, `FrameSequence`, the
feature intervals and the numpy segmented scans); the port keeps its own
copy and imports nothing of the JAX package. The ingest takes the native
walk of `native_ingest.py`, whose library build raises when it fails; the
numpy scans below run what the walk refuses (feature detection).

ref: adder-codec-rs/src/framer/driver.rs. The reference ingests one event at
a time per row-chunk thread (`ingest_event_for_chunk`, driver.rs:984-1133).
Here the per-pixel recurrences are reformulated as *segmented scans* over an
event batch sorted by pixel:

- the AbsoluteT monotonicity guard (driver.rs:1002-1012) becomes
  `t > cummax(rounded running-ts)` per pixel segment (dropped events can
  never raise the chain, so an inclusive cummax over all events is exact);
- the framed-source ref_interval rounding (driver.rs:1094-1114) folds into
  the chain as `ceil(t/ref)*ref` (AbsoluteT) or `ref*ceil(t/ref)` summands
  (DeltaT, since rounding after each add telescopes);
- frame spans are disjoint per pixel, so span filling is one scatter with no
  write conflicts.

This replaces the reference's rayon chunk parallelism (P1) — one numpy pass
handles what the reference splits across threads, and the same formulation
maps directly onto a JAX scatter kernel for on-device framing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.types import (
    D_EMPTY,
    NO_CHANNEL,
    EventArray,
    PlaneSize,
    SourceCamera,
    SourceType,
    TimeMode,
    is_framed,
)
from .scale_intensity import (
    FramedViewMode,
    get_frame_values,
    practical_d_max_for,
)


@dataclass
class FramerBuilder:
    """Framer configuration (ref: driver.rs:36-145)."""

    plane: PlaneSize
    tps: int = 150_000
    output_fps: Optional[float] = None
    view_mode: FramedViewMode = FramedViewMode.Intensity
    source: SourceType = SourceType.U8
    codec_version: int = 3
    source_camera: SourceCamera = SourceCamera.FramedU8
    time_mode: TimeMode = TimeMode.AbsoluteT
    ref_interval: int = 5000
    delta_t_max: int = 5000
    detect_features: bool = False
    buffer_limit: Optional[int] = None
    out_dtype: type = np.uint8
    # EventCoordless output (ref: FrameValue for EventCoordless,
    # scale_intensity.rs:32-52): frames carry (d, t) packed into u64
    coordless: bool = False

    def time_parameters(self, tps, ref_interval, delta_t_max, output_fps=None):
        self.tps = tps
        self.ref_interval = ref_interval
        self.delta_t_max = delta_t_max
        self.output_fps = output_fps
        return self

    def codec_meta(self, codec_version, time_mode):
        self.codec_version = codec_version
        self.time_mode = time_mode
        return self

    def source_info(self, source: SourceType, source_camera: SourceCamera):
        self.source = source
        self.source_camera = source_camera
        return self

    def finish(self) -> "FrameSequence":
        return FrameSequence(self)


class _Frame:
    __slots__ = ("values", "filled")

    def __init__(self, n: int, dtype):
        self.values = np.zeros(n, dtype=dtype)
        self.filled = np.zeros(n, dtype=bool)

    @property
    def filled_count(self) -> int:
        return int(self.filled.sum())


class FeatureInterval:
    """Features binned to the output frame they were detected in
    (ref: driver.rs:253-257)."""

    __slots__ = ("end_ts", "features")

    def __init__(self, end_ts: int):
        self.end_ts = end_ts
        self.features: list = []


class FrameSequence:
    """Reconstructs instantaneous frames from an ADDER event stream.

    ref: driver.rs:259-981 (FrameSequence / Framer trait). INSTANTANEOUS
    mode only, like the reference (INTEGRATION is declared but unimplemented
    there, driver.rs:24-31).
    """

    def __init__(self, b: FramerBuilder):
        self.plane = b.plane
        n = b.plane.volume()
        self.n = n
        self.view_mode = b.view_mode
        self.source = b.source
        self.codec_version = b.codec_version
        self.source_camera = b.source_camera
        self.time_mode = b.time_mode
        self.ref_interval = b.ref_interval
        self.delta_t_max = b.delta_t_max
        self.buffer_limit = b.buffer_limit
        self.coordless = b.coordless
        self.out_dtype = np.dtype(np.uint64 if b.coordless else b.out_dtype)
        self.tps = b.tps
        # ticks per output frame (ref: driver.rs:356-360)
        self.tpf = (
            int(b.tps / b.output_fps) if b.output_fps else b.ref_interval
        )

        # per-pixel trackers (flattened y-major, then x, then c)
        self.running_ts = np.zeros(n, dtype=np.uint64)
        self.last_filled = np.full(n, -1, dtype=np.int64)
        self.last_intensity = np.zeros(n, dtype=self.out_dtype)

        self.frames: dict[int, _Frame] = {}
        self.frames_written = 0
        self._ensure_frame(0)

        self._absolute = (
            self.codec_version >= 2 and self.time_mode == TimeMode.AbsoluteT
        )
        self._framed_round = self.codec_version >= 1 and is_framed(
            self.source_camera
        )
        self._practical_d_max = practical_d_max_for(
            float(np.iinfo(self.out_dtype).max),
            self.delta_t_max,
            self.ref_interval,
        )
        self.detect_features = b.detect_features
        self.features: list = []  # FeatureInterval deque (ref: driver.rs:272)
        self.running_intensities = np.zeros(self.plane.shape, dtype=np.uint8)

    # -- helpers --

    def _ensure_frame(self, idx: int) -> _Frame:
        f = self.frames.get(idx)
        if f is None:
            f = _Frame(self.n, self.out_dtype)
            self.frames[idx] = f
        return f

    def _pix_index(self, events: EventArray) -> np.ndarray:
        c = np.where(events.c == NO_CHANNEL, 0, events.c).astype(np.int64)
        return (
            events.y.astype(np.int64) * self.plane.width
            + events.x.astype(np.int64)
        ) * self.plane.channels + c

    # -- ingestion --

    def ingest_event_array(self, events: EventArray) -> bool:
        """Vectorized ingest of an event batch. Only per-pixel event order is
        required (the reference's own invariant, driver.rs:1068-1074).
        Returns True if frame 0 is now ready to pop."""
        if len(events) == 0:
            return self.is_frame_0_filled()

        # native fast path: counting sort + serial chain replay in C++
        # (ops/native/framer_fill.cpp) — same recurrence, ~100x the numpy
        # segmented scans on 1-core hosts. Feature detection takes the
        # numpy path below.
        from .native_ingest import ingest_native

        if ingest_native(self, events):
            return self.is_frame_0_filled()

        pix = self._pix_index(events)
        order = np.argsort(pix, kind="stable")
        pix = pix[order]
        t = events.t[order].astype(np.uint64)
        d = events.d[order].astype(np.int64)

        seg_start = np.ones(len(pix), dtype=bool)
        seg_start[1:] = pix[1:] != pix[:-1]

        ref = np.uint64(self.ref_interval)

        if self._absolute:
            # rounded chain contribution of each event
            rt = t
            if self._framed_round:
                rt = ((t + ref - np.uint64(1)) // ref) * ref
            # prev-chain: carry at segment starts, else cummax of rt
            prev_chain = _segmented_exclusive_cummax(
                rt, seg_start, self.running_ts[pix]
            )
            keep = t > prev_chain
            v = t  # pre-rounding running_ts used for frame index
            prev_running = prev_chain
            dt_for_value = np.where(
                t >= prev_running, t - prev_running, np.uint64(0)
            )
            # new chain value after batch, per pixel
            chain_after = np.maximum.accumulate
        else:
            # DeltaT: running_ts += t, then rounding; telescopes to
            # summing ref*ceil(t/ref) per event
            step = t
            if self._framed_round:
                step = ((t + ref - np.uint64(1)) // ref) * ref
            base = _segmented_exclusive_cumsum(
                step, seg_start, self.running_ts[pix]
            )
            keep = np.ones(len(pix), dtype=bool)
            v = base + t  # pre-rounding value for frame index
            dt_for_value = t

        # frame index: (running_ts.saturating_sub(1)) / tpf (driver.rs:1014)
        f_idx = (
            np.maximum(v, np.uint64(1)) - np.uint64(1)
        ).astype(np.int64) // self.tpf

        # last_filled chain (monotone among kept events)
        f_for_chain = np.where(keep, f_idx, np.int64(-(2**62)))
        prev_lf = _segmented_exclusive_cummax_i64(
            f_for_chain, seg_start, self.last_filled[pix]
        )
        fires = keep & (f_idx > prev_lf)

        # intensity values: fired, non-D_EMPTY events compute a new value;
        # D_EMPTY repeats the previous one (driver.rs:1017-1043)
        compute = fires & (d != D_EMPTY)
        vals = np.zeros(len(pix), dtype=self.out_dtype)
        if compute.any() and self.coordless:
            # EventCoordless passthrough: pack (d, delta-t) into u64
            vals[compute] = (
                d[compute].astype(np.uint64) << 32
            ) | dt_for_value[compute].astype(np.uint64)
        elif compute.any():
            if self.view_mode == FramedViewMode.SAE:
                dt_v = t if self._absolute else dt_for_value
                vals[compute] = get_frame_values(
                    d[compute],
                    dt_v[compute],
                    self.out_dtype,
                    self.source,
                    float(self.ref_interval),
                    self._practical_d_max,
                    self.delta_t_max,
                    self.view_mode,
                    sae_running_t=v[compute],
                    sae_last_fired_t=(
                        prev_running[compute] if self._absolute else np.zeros(compute.sum(), np.uint64)
                    ),
                )
            else:
                vals[compute] = get_frame_values(
                    d[compute],
                    dt_for_value[compute],
                    self.out_dtype,
                    self.source,
                    float(self.ref_interval),
                    self._practical_d_max,
                    self.delta_t_max,
                    self.view_mode,
                )
        # forward-fill values within segments (carry = last_intensity)
        fill_vals = _segmented_forward_fill(
            vals, compute, seg_start, self.last_intensity[pix]
        )

        # span fill: fired event k fills frames (prev_lf, f_idx] with
        # fill_vals[k]; spans are disjoint per pixel (driver.rs:1079-1091)
        lo = np.maximum(prev_lf[fires] + 1, self.frames_written)
        hi = f_idx[fires]
        span_len = np.maximum(hi - lo + 1, 0)
        total = int(span_len.sum())
        if total:
            reps = span_len
            fill_pix = np.repeat(pix[fires], reps)
            fill_val = np.repeat(fill_vals[fires], reps)
            # frame index within each span
            span_off = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(reps) - reps, reps
            )
            fill_frame = np.repeat(lo, reps) + span_off
            # scatter per target frame
            for fi in np.unique(fill_frame):
                frame = self._ensure_frame(int(fi))
                sel = fill_frame == fi
                p = fill_pix[sel]
                vfill = fill_val[sel]
                new = ~frame.filled[p]
                frame.values[p[new]] = vfill[new]
                frame.filled[p[new]] = True

        # update carries
        last_idx = np.zeros(len(pix), dtype=bool)
        last_idx[:-1] = seg_start[1:]
        last_idx[-1] = True
        seg_pix = pix[last_idx]
        if self._absolute:
            rt_max = _segmented_inclusive_cummax(rt, seg_start, self.running_ts[pix])
            self.running_ts[seg_pix] = rt_max[last_idx]
        else:
            self.running_ts[seg_pix] = (base + step)[last_idx]
        lf_new = np.maximum(
            _segmented_inclusive_cummax_i64(
                f_for_chain, seg_start, self.last_filled[pix]
            ),
            self.last_filled[pix],
        )
        self.last_filled[seg_pix] = lf_new[last_idx]
        self.last_intensity[seg_pix] = fill_vals[last_idx]

        # buffer limit: force-complete frame 0 (driver.rs:1116-1122)
        if self.buffer_limit is not None and len(hi) and int(
            self.last_filled.max()
        ) > self.frames_written + self.buffer_limit:
            f0 = self._ensure_frame(self.frames_written)
            f0.filled[:] = True

        # in-framer feature detection binned by output frame
        # (ref: driver.rs:482-553)
        if self.detect_features and fires.any():
            from ..utils.cv import fast_mask

            self.running_intensities.reshape(-1)[pix[fires]] = fill_vals[fires]
            mask = fast_mask(self.running_intensities)
            fx = (pix[fires] // self.plane.channels) % self.plane.width
            fy = (pix[fires] // self.plane.channels) // self.plane.width
            is_f = mask[fy, fx]
            for xx, yy, tt in zip(fx[is_f], fy[is_f], t[fires][is_f]):
                idx = max(
                    int(tt) // self.tpf - self.frames_written, 0
                )
                if int(tt) % self.tpf == 0 and idx > 0:
                    idx -= 1
                while idx >= len(self.features):
                    end = (
                        self.features[-1].end_ts + self.tpf
                        if self.features
                        else self.tpf * (len(self.features) + 1)
                    )
                    self.features.append(FeatureInterval(end))
                self.features[idx].features.append((int(xx), int(yy)))

        return self.is_frame_0_filled()

    def pop_features(self):
        """Pop the oldest feature interval (ref: driver.rs:851-873)."""
        if not self.features:
            self.features.append(FeatureInterval(self.tpf))
            self.features.append(FeatureInterval(self.tpf * 2))
        else:
            self.features.append(
                FeatureInterval(self.features[-1].end_ts + self.tpf)
            )
        return self.features.pop(0)

    def get_running_intensities(self) -> np.ndarray:
        return self.running_intensities

    def ingest_event(self, event) -> bool:
        return self.ingest_event_array(EventArray.from_events([event]))

    def ingest_events_events(self, events_list) -> bool:
        for ev in events_list:
            if isinstance(ev, EventArray):
                self.ingest_event_array(ev)
            else:
                self.ingest_event_array(EventArray.from_events(ev))
        return self.is_frame_0_filled()

    # -- frame extraction --

    def is_frame_0_filled(self) -> bool:
        f = self.frames.get(self.frames_written)
        if f is None:
            return False
        if self.buffer_limit is not None:
            live = [i for i in self.frames if i >= self.frames_written]
            if live and max(live) - self.frames_written + 1 > self.buffer_limit:
                return True
        return f.filled_count == self.n

    def pop_next_frame(self):
        """Pop frame `frames_written`; returns (values (H,W,C), filled mask)
        or None if nothing to pop."""
        f = self.frames.pop(self.frames_written, None)
        self.frames_written += 1
        self._ensure_frame(self.frames_written)
        if f is None:
            return None
        shape = self.plane.shape
        return f.values.reshape(shape), f.filled.reshape(shape)

    def flush_frame_buffer(self) -> bool:
        """Back-fill None pixels of the current frame with the last recorded
        intensity (ref: driver.rs:632-677)."""
        any_nonempty = any(i > self.frames_written for i in self.frames)
        f0 = self._ensure_frame(self.frames_written)
        if any_nonempty:
            empty = ~f0.filled
            f0.values[empty] = self.last_intensity[empty]
            self.last_filled[empty] += 1
            f0.filled[:] = True
            return True
        return f0.filled_count == self.n

    def write_frame_bytes(self, writer) -> None:
        """Serialize the next frame big-endian (ref: driver.rs:935-961)."""
        popped = self.pop_next_frame()
        if popped is None:
            raise ValueError("uninitialized frame")
        values, _ = popped
        writer.write(values.astype(self.out_dtype.newbyteorder(">")).tobytes())

    def write_multi_frame_bytes(self, writer) -> int:
        count = 0
        while self.is_frame_0_filled():
            self.write_frame_bytes(writer)
            count += 1
        return count


def unpack_coordless(arr: np.ndarray):
    """Split packed u64 EventCoordless frames into (d, delta_t) arrays."""
    return (arr >> 32).astype(np.uint8), (arr & 0xFFFFFFFF).astype(np.uint32)


# --- segmented scan helpers --------------------------------------------------


def _segment_ids(seg_start: np.ndarray) -> np.ndarray:
    return np.cumsum(seg_start) - 1


def _segmented_exclusive_cumsum(x, seg_start, carry):
    """carry + sum of previous in-segment values."""
    total = np.cumsum(x)
    seg_base = np.maximum.accumulate(
        np.where(seg_start, total - x, np.uint64(0))
    )
    return carry + (total - x) - seg_base


def _segmented_inclusive_cummax(x, seg_start, carry):
    """Segment-reset cummax via key packing: chain values stay < 2^33
    (u32 timestamps rounded up), so pack the segment id in the high bits."""
    x2 = np.maximum(x, carry)
    seg = _segment_ids(seg_start).astype(np.uint64)
    packed = (seg << np.uint64(33)) | x2
    pm = np.maximum.accumulate(packed)
    return pm & ((np.uint64(1) << np.uint64(33)) - np.uint64(1))


def _segmented_exclusive_cummax(x, seg_start, carry):
    inc = _segmented_inclusive_cummax(x, seg_start, carry)
    out = np.empty_like(inc)
    out[0] = carry[0]
    out[1:] = np.where(seg_start[1:], carry[1:], inc[:-1])
    return out


def _segmented_inclusive_cummax_i64(x, seg_start, carry):
    x2 = np.maximum(x, carry)
    seg = _segment_ids(seg_start)
    # frame indices fit comfortably in 40 bits; pack segment id above
    offset = np.int64(1) << np.int64(41)
    packed = seg * offset + np.maximum(x2, -(offset // 2) + 1)
    pm = np.maximum.accumulate(packed)
    return pm - seg * offset

def _segmented_exclusive_cummax_i64(x, seg_start, carry):
    inc = _segmented_inclusive_cummax_i64(x, seg_start, carry)
    out = np.empty_like(inc)
    out[0] = carry[0]
    out[1:] = np.where(seg_start[1:], carry[1:], inc[:-1])
    return out


def _segmented_forward_fill(vals, valid, seg_start, carry):
    """Forward-fill `vals` where ~valid within segments, seeded by carry."""
    n = len(vals)
    idx = np.arange(n)
    src = np.where(valid, idx, -1)
    seg = _segment_ids(seg_start)
    offset = np.int64(1) << np.int64(41)
    packed = seg * offset + src
    pm = np.maximum.accumulate(packed)
    last_valid = pm - seg * offset
    out = np.where(
        last_valid >= 0, vals[np.maximum(last_valid, 0)], carry
    ).astype(vals.dtype)
    return out
