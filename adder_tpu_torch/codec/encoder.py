"""Encoder container: header emission, event pre-processing, backend dispatch.

Copy of `adder_tpu/codec/encoder.py`; the port keeps its own copy and imports nothing of
the JAX package. New here: `Encoder.writes_records_unchanged` and
`Encoder.ingest_records`, for events already serialised as raw records.

ref: adder-codec-core/src/codec/encoder.rs (container),
     codec/mod.rs:262-314 (EncoderOptions / EventDrop / EventOrder),
     codec/empty/stream.rs (null sink).

TPU-native redesign notes:
- The hot path is `ingest_event_array`, which takes a struct-of-arrays batch
  (typically one transcoded interval's compacted events straight off the
  device) and performs drop / reorder / serialization as vectorized numpy
  ops, instead of the reference's per-event virtual dispatch.
- Scalar `ingest_event` is kept for API parity and tooling.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import BinaryIO, Optional

import numpy as np

from ..core.types import Event, EventArray, PlaneSize
from .header import (
    MAGIC_COMPRESSED,
    MAGIC_RAW,
    CodecMetadata,
    encode_header,
    event_size_for_plane,
)
from .rate_controller import Crf
from . import raw as rawcodec


class EncoderType(enum.IntEnum):
    """ref: codec/mod.rs:24-43"""

    Compressed = 0
    Raw = 1
    Empty = 2


@dataclass
class EventDrop:
    """Rate-based random event dropping (ref: codec/mod.rs:285-303).

    mode 'none' | 'manual' | 'auto' ('auto' unimplemented in the reference too)
    """

    mode: str = "none"
    target_event_rate: float = 0.0
    alpha: float = 0.0


class EventOrder(enum.IntEnum):
    """ref: codec/mod.rs:305-314"""

    Unchanged = 0
    Interleaved = 1


@dataclass
class EncoderOptions:
    """ref: codec/mod.rs:262-283"""

    event_drop: EventDrop = field(default_factory=EventDrop)
    event_order: EventOrder = EventOrder.Unchanged
    crf: Crf = None  # type: ignore[assignment]

    @classmethod
    def default(cls, plane: PlaneSize) -> "EncoderOptions":
        return cls(crf=Crf(None, plane))


class _WriteBackend:
    magic: bytes = MAGIC_RAW

    def __init__(self, meta: CodecMetadata, writer: Optional[BinaryIO]):
        self.meta = meta
        self.meta.event_size = event_size_for_plane(meta.plane)
        self.writer = writer

    def write_bytes(self, data: bytes) -> None:
        if self.writer is not None:
            self.writer.write(data)

    def ingest_event_array(self, events: EventArray) -> None:
        raise NotImplementedError

    def close(self) -> Optional[BinaryIO]:
        """Write the EOF marker and return the underlying writer."""
        self.write_bytes(rawcodec.eof_event_bytes(self.meta.plane.channels))
        if self.writer is not None:
            self.writer.flush()
        w, self.writer = self.writer, None
        return w

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()


class RawOutput(_WriteBackend):
    """Raw event serialization backend (ref: codec/raw/stream.rs:11-126)."""

    magic = MAGIC_RAW

    def ingest_event_array(self, events: EventArray) -> None:
        self.write_bytes(rawcodec.encode_events(events, self.meta.plane.channels))


class EmptyOutput(_WriteBackend):
    """Null sink (ref: codec/empty/stream.rs:9-63)."""

    magic = MAGIC_RAW

    def __init__(self, meta: CodecMetadata, writer=None):
        super().__init__(meta, None)

    def ingest_event_array(self, events: EventArray) -> None:
        pass

    def close(self):
        return None


class Encoder:
    """ADDER stream encoder (ref: codec/encoder.rs:29-313).

    Construction writes the header immediately. Events then flow through:
      1. EventDrop EMA rate limiter        (ref: encoder.rs:234-253)
      2. optional Interleaved t-reordering (ref: encoder.rs:255-272)
      3. the serialization backend
    `close_writer` flushes any reorder queue, writes the in-band EOF event,
    and returns the underlying writer.
    """

    def __init__(self, backend: _WriteBackend, options: EncoderOptions):
        self.output = backend
        self.options = options
        self._pending: Optional[EventArray] = None  # t-sorted reorder buffer
        self._queue_max_t = 0
        self._current_event_rate = 0.0
        self._last_event_ts = time.monotonic()
        header = encode_header(backend.meta, backend.magic)
        backend.write_bytes(header)
        backend.meta.header_size = len(header)

    # -- constructors matching the reference API shape --
    @classmethod
    def new_raw(cls, meta: CodecMetadata, writer: BinaryIO, options: EncoderOptions) -> "Encoder":
        return cls(RawOutput(meta, writer), options)

    @classmethod
    def new_empty(cls, meta: CodecMetadata, options: EncoderOptions) -> "Encoder":
        return cls(EmptyOutput(meta), options)

    @classmethod
    def new_compressed(
        cls, meta: CodecMetadata, writer: BinaryIO,
        options: EncoderOptions, entropy: str = "cabac",
    ) -> "Encoder":
        """entropy: "cabac" -> reference-compatible `addec`; "rans" ->
        interleaved-rANS `addrn` (own format, parallel-friendly decode)."""
        from .compressed import CompressedOutput  # local import: optional heavy dep

        out = CompressedOutput(meta, writer, entropy=entropy)
        out.options = options
        return cls(out, options)

    @property
    def meta(self) -> CodecMetadata:
        return self.output.meta

    def get_options(self) -> EncoderOptions:
        return self.options

    def sync_crf(self) -> None:
        """Push CRF state into the backend (ref: encoder.rs:304-313)."""
        if hasattr(self.output, "options"):
            self.output.options = self.options

    # -- ingest --

    def ingest_event(self, event: Event) -> None:
        self.ingest_event_array(EventArray.from_events([event]))

    def ingest_events(self, events) -> None:
        self.ingest_event_array(EventArray.from_events(events))

    def ingest_event_array(self, events: EventArray) -> None:
        if len(events) == 0:
            return
        events = self._apply_event_drop(events)
        if self.options.event_order == EventOrder.Interleaved:
            events = self._interleave(events)
        if len(events):
            self.output.ingest_event_array(events)

    def writes_records_unchanged(self) -> bool:
        """Whether this encoder writes each event as its raw record, as it
        comes: a Raw backend, no event drop, the Unchanged order."""
        return (isinstance(self.output, RawOutput)
                and self.options.event_drop.mode == "none"
                and self.options.event_order == EventOrder.Unchanged)

    def ingest_records(self, records: np.ndarray) -> None:
        """Events already serialised as this stream's raw records (uint8,
        `raw.encode_events`'s bytes), handed to the writer as they are (the
        writer may keep the buffer). Only an encoder that
        `writes_records_unchanged` takes them."""
        if not self.writes_records_unchanged():
            raise ValueError("raw records go only to a Raw backend with no "
                             "event drop and the Unchanged order")
        if len(records):
            self.output.write_bytes(records)

    def _apply_event_drop(self, events: EventArray) -> EventArray:
        """EMA rate limiter (ref: encoder.rs:234-253). Wall-clock based, like
        the reference; applied per-batch with the same recurrence, run
        natively (the recurrence is serially data-dependent — each event's
        keep decision feeds the next rate — so it lives in C++ next to the
        entropy coder rather than as a per-event Python loop)."""
        drop = self.options.event_drop
        if drop.mode != "manual":
            return events
        from .compressed import event_drop_ema

        now = time.monotonic()
        # Events inside one batch arrive "simultaneously"; spread the batch
        # over the elapsed interval to keep the recurrence meaningful.
        t_diff = max((now - self._last_event_ts) / max(len(events), 1), 1e-9)
        keep, self._current_event_rate = event_drop_ema(
            len(events), self._current_event_rate, drop.alpha, t_diff,
            drop.target_event_rate,
        )
        self._last_event_ts = now
        return events[keep] if not keep.all() else events

    def _interleave(self, events: EventArray) -> EventArray:
        """Global t-ordering with bounded delay (ref: encoder.rs:255-272).

        Events are buffered and released in t-sorted order once
        `max_t_seen - delta_t_max` has passed them. The pending buffer is
        kept sorted, so each batch costs one O(b log b) batch sort plus an
        O(Q + b) merge memcpy — the amortized equivalent of the reference's
        per-event BinaryHeap, instead of re-sorting the whole queue per
        batch (quadratic-log over a stream).
        """
        order = np.argsort(events.t, kind="stable")
        batch = events[order]
        held = self._pending
        if held is None or len(held) == 0:
            pending = batch
        else:
            # equal timestamps: held events arrived earlier and stay first
            # (side="right"), preserving the stable arrival order
            pos = np.searchsorted(held.t, batch.t, side="right")
            m = len(held) + len(batch)
            dest_new = pos + np.arange(len(batch))
            mask = np.ones(m, dtype=bool)
            mask[dest_new] = False

            def merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
                out = np.empty(m, a.dtype)
                out[mask] = a
                out[dest_new] = b
                return out

            pending = EventArray(
                merge(held.x, batch.x), merge(held.y, batch.y),
                merge(held.c, batch.c), merge(held.d, batch.d),
                merge(held.t, batch.t),
            )
        self._queue_max_t = max(self._queue_max_t, int(batch.t[-1]))
        threshold = self._queue_max_t - self.meta.delta_t_max
        k = int(np.searchsorted(pending.t, threshold, side="left"))
        self._pending = pending[k:]
        return pending[:k]

    # -- teardown --

    def flush_writer(self) -> None:
        self.output.flush()

    def close_writer(self) -> Optional[BinaryIO]:
        if (
            self.options.event_order == EventOrder.Interleaved
            and self._pending is not None
            and len(self._pending)
        ):
            self.output.ingest_event_array(self._pending)  # already sorted
            self._pending = None
        return self.output.close()
