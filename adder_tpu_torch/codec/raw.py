"""Raw (uncompressed) ADDER event wire codec — vectorized.

Copy of `adder_tpu/codec/raw.py`; the port keeps its own copy and imports nothing of
the JAX package. New here: `WireEvents`, a batch held as its records.

Wire format per event, big-endian (matches the reference's bincode
fixint/big-endian serialization, ref: adder-codec-core/src/codec/raw/stream.rs):

  mono  (9 B):  x:u16  y:u16  d:u8  t:u32
  color (11 B): x:u16  y:u16  tag:u8 (1=Some) c:u8  d:u8  t:u32

Unlike the reference's per-event serialize loop, encode/decode here are
single numpy operations over struct-of-arrays batches, so a multi-million
event stream round-trips in milliseconds on the host.
"""

from __future__ import annotations

import numpy as np

from ..core.types import EOF_PX_ADDRESS, NO_CHANNEL, EventArray

# numpy structured dtypes are packed (no padding) by default
MONO_DTYPE = np.dtype([("x", ">u2"), ("y", ">u2"), ("d", "u1"), ("t", ">u4")])
COLOR_DTYPE = np.dtype(
    [("x", ">u2"), ("y", ">u2"), ("tag", "u1"), ("c", "u1"), ("d", "u1"), ("t", ">u4")]
)
assert MONO_DTYPE.itemsize == 9 and COLOR_DTYPE.itemsize == 11


def encode_events(events: EventArray, channels: int) -> bytes:
    """Pack a batch of events into raw wire bytes (one vectorized copy)."""
    n = len(events)
    if channels == 1:
        out = np.empty(n, dtype=MONO_DTYPE)
        out["x"] = events.x
        out["y"] = events.y
        out["d"] = events.d
        out["t"] = events.t
    else:
        out = np.empty(n, dtype=COLOR_DTYPE)
        out["x"] = events.x
        out["y"] = events.y
        # c == NO_CHANNEL encodes Option::None (tag 0, no payload in the
        # reference; here the payload byte is still present — the reference
        # always writes Some(c) for color planes, see raw/stream.rs:109-117)
        out["tag"] = (events.c != NO_CHANNEL).astype(np.uint8)
        out["c"] = np.where(events.c == NO_CHANNEL, 0, events.c).astype(np.uint8)
        out["d"] = events.d
        out["t"] = events.t
    return out.tobytes()


def decode_events(buf: bytes | np.ndarray, channels: int) -> EventArray:
    """Unpack raw wire bytes into a batch. Truncates any trailing partial event."""
    raw = np.frombuffer(buf, dtype=np.uint8)
    if channels == 1:
        n = len(raw) // MONO_DTYPE.itemsize
        rec = raw[: n * MONO_DTYPE.itemsize].view(MONO_DTYPE)
        c = np.full(n, NO_CHANNEL, dtype=np.uint8)
    else:
        n = len(raw) // COLOR_DTYPE.itemsize
        rec = raw[: n * COLOR_DTYPE.itemsize].view(COLOR_DTYPE)
        c = np.where(rec["tag"] == 0, NO_CHANNEL, rec["c"]).astype(np.uint8)
    return EventArray(
        rec["x"].astype(np.uint16),
        rec["y"].astype(np.uint16),
        c,
        rec["d"].astype(np.uint8),
        rec["t"].astype(np.uint32),
    )


class WireEvents(EventArray):
    """A batch of events held as their raw records (`records`: uint8, as
    `encode_events` writes them), decoded into the EventArray fields by
    `decode_events` on the first access to one. Its length needs no
    decode."""

    __slots__ = ("records", "channels", "_n", "_fields")

    def __init__(self, records: np.ndarray, channels: int):
        size = (MONO_DTYPE if channels == 1 else COLOR_DTYPE).itemsize
        if records.dtype != np.uint8 or records.ndim != 1 or len(records) % size:
            raise ValueError(f"records must be whole {size}-byte records "
                             f"(uint8), got {records.dtype} {records.shape}")
        self.records, self.channels = records, channels
        self._n = len(records) // size
        self._fields = None

    def __len__(self) -> int:
        return self._n

    def _decoded(self) -> EventArray:
        if self._fields is None:
            self._fields = decode_events(self.records, self.channels)
        return self._fields

    x = property(lambda self: self._decoded().x)
    y = property(lambda self: self._decoded().y)
    c = property(lambda self: self._decoded().c)
    d = property(lambda self: self._decoded().d)
    t = property(lambda self: self._decoded().t)

    def __repr__(self):
        return f"WireEvents(n={self._n})"


def eof_event_bytes(channels: int) -> bytes:
    """The in-band EOF marker event (ref: raw/stream.rs:79-92, lib.rs:450-458)."""
    eof = EventArray(
        np.array([EOF_PX_ADDRESS], np.uint16),
        np.array([EOF_PX_ADDRESS], np.uint16),
        np.array([0], np.uint8),
        np.array([0], np.uint8),
        np.array([0], np.uint32),
    )
    return encode_events(eof, channels)


def find_eof(events: EventArray) -> int:
    """Index of the first EOF event, or len(events) if none present."""
    eof = np.flatnonzero(
        (events.x == EOF_PX_ADDRESS) & (events.y == EOF_PX_ADDRESS)
    )
    return int(eof[0]) if len(eof) else len(events)
