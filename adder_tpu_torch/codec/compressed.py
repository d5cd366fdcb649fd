"""Compressed ADDER codec: ADU-chunked source-modeled entropy coding.

Copy of adder_tpu/codec/compressed.py; the native library builds through
the port's ops/native_build.py, into adder_tpu_torch/build/native/.

ref: adder-codec-core/src/codec/compressed/stream.rs (CompressedOutput /
CompressedInput). The per-symbol adaptive entropy stage is native C++
(codec/native/adder_entropy.cpp, built on demand via g++ and bound with
ctypes) because an adaptive arithmetic coder is inherently serial; Python
orchestrates the ADU framing (length-prefixed u32 blobs) and the lifecycle.

Pipeline mapping (ref SURVEY section 2.5 P3): the reference compresses each
full ADU on a spawned worker thread and resequences blobs by message id.
Here ADU compression runs on a ThreadPoolExecutor (the C call releases the
GIL); futures are drained in submission order, which preserves the on-disk
ADU order without a priority queue.
"""

from __future__ import annotations

import ctypes
import io
import os
import pathlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Optional

import numpy as np

from ..core.types import NO_CHANNEL, EventArray
from ..ops import native_build
from .header import (
    MAGIC_COMPRESSED,
    MAGIC_RANS,
    CodecError,
    CodecMetadata,
    Eof,
    SeekError,
    encode_header,
    event_size_for_plane,
)

_SOURCE = pathlib.Path(__file__).resolve().parent / "native" / "adder_entropy.cpp"
_lib = None
_lib_lock = threading.Lock()


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = native_build.load(_SOURCE)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.adder_compress_adu.restype = ctypes.c_int
        lib.adder_compress_adu.argtypes = [
            u16p, u16p, u8p, u8p, u32p, ctypes.c_size_t,
            ctypes.c_uint16, ctypes.c_uint16, ctypes.c_uint8,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint8,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.adder_decompress_adu.restype = ctypes.c_long
        lib.adder_decompress_adu.argtypes = [
            u8p, ctypes.c_size_t,
            ctypes.c_uint16, ctypes.c_uint16, ctypes.c_uint8,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
            u16p, u16p, u8p, u8p, u32p, ctypes.c_size_t,
        ]
        lib.adder_compress_adu_rans.restype = ctypes.c_int
        lib.adder_compress_adu_rans.argtypes = lib.adder_compress_adu.argtypes
        lib.adder_decompress_adu_rans.restype = ctypes.c_long
        lib.adder_decompress_adu_rans.argtypes = (
            lib.adder_decompress_adu.argtypes
        )
        lib.adder_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.adder_lz4_block_decompress.restype = ctypes.c_long
        lib.adder_lz4_block_decompress.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
        ]
        lib.adder_lz4_block_decompress_prefixed.restype = ctypes.c_long
        lib.adder_lz4_block_decompress_prefixed.argtypes = [
            u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, ctypes.c_size_t,
        ]
        lib.adder_event_drop_ema.restype = ctypes.c_double
        lib.adder_event_drop_ema.argtypes = [
            ctypes.c_size_t, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, u8p,
        ]
        _lib = lib
        return lib


def event_drop_ema(
    n: int, rate: float, alpha: float, t_diff: float, target: float
) -> tuple[np.ndarray, float]:
    """Run the EventDrop EMA recurrence over n events natively
    (ref: encoder.rs:234-253). Returns (keep mask, final rate); bit-identical
    to the scalar double recurrence."""
    lib = _get_lib()
    keep = np.empty(n, dtype=np.uint8)
    new_rate = lib.adder_event_drop_ema(
        n, rate, alpha, (1.0 - alpha) / t_diff, target,
        _ptr(keep, ctypes.c_uint8),
    )
    return keep.view(bool), float(new_rate)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def lz4_block_decompress(src: bytes, dst_size: int) -> bytes:
    """Decompress one LZ4 block (native; used by the aedat4 reader)."""
    lib = _get_lib()
    s = np.frombuffer(src, dtype=np.uint8)
    d = np.empty(dst_size, dtype=np.uint8)
    n = lib.adder_lz4_block_decompress(
        _ptr(s, ctypes.c_uint8), len(s), _ptr(d, ctypes.c_uint8), dst_size
    )
    if n < 0:
        raise ValueError("malformed LZ4 block")
    return d[:n].tobytes()


def compress_adu(
    events: EventArray,
    width: int,
    height: int,
    channels: int,
    start_t: int,
    dt_ref: int,
    num_intervals: int,
    c_thresh_max: int,
    rans: bool = False,
) -> bytes:
    """Compress one ADU's events to an entropy-coded blob.

    rans=True selects the interleaved-rANS entropy stage (`addrn` format,
    own design); default is the reference-compatible adaptive range coder."""
    lib = _get_lib()
    xs = np.ascontiguousarray(events.x)
    ys = np.ascontiguousarray(events.y)
    cs = np.ascontiguousarray(events.c)
    ds = np.ascontiguousarray(events.d)
    ts = np.ascontiguousarray(events.t)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    fn = lib.adder_compress_adu_rans if rans else lib.adder_compress_adu
    rc = fn(
        _ptr(xs, ctypes.c_uint16), _ptr(ys, ctypes.c_uint16),
        _ptr(cs, ctypes.c_uint8), _ptr(ds, ctypes.c_uint8),
        _ptr(ts, ctypes.c_uint32), len(events),
        width, height, channels, start_t, dt_ref, num_intervals, c_thresh_max,
        ctypes.byref(out), ctypes.byref(out_len),
    )
    if rc != 0:
        raise RuntimeError(f"adder_compress_adu failed: {rc}")
    blob = ctypes.string_at(out, out_len.value)
    lib.adder_free(out)
    return blob


def decompress_adu(
    blob: bytes,
    width: int,
    height: int,
    channels: int,
    start_t: int,
    dt_ref: int,
    num_intervals: int,
    rans: bool = False,
) -> EventArray:
    """Decompress one ADU blob to events in cube-raster drain order."""
    lib = _get_lib()
    fn = lib.adder_decompress_adu_rans if rans else lib.adder_decompress_adu
    cap = max(4096, min(width * height * channels * (num_intervals + 2), 1 << 22))
    while True:
        xs = np.empty(cap, np.uint16)
        ys = np.empty(cap, np.uint16)
        cs = np.empty(cap, np.uint8)
        ds = np.empty(cap, np.uint8)
        ts = np.empty(cap, np.uint32)
        buf = np.frombuffer(blob, dtype=np.uint8)
        n = fn(
            _ptr(buf, ctypes.c_uint8), len(blob),
            width, height, channels, start_t, dt_ref, num_intervals,
            _ptr(xs, ctypes.c_uint16), _ptr(ys, ctypes.c_uint16),
            _ptr(cs, ctypes.c_uint8), _ptr(ds, ctypes.c_uint8),
            _ptr(ts, ctypes.c_uint32), cap,
        )
        if n == -2:
            raise CodecError("corrupt compressed ADU: event cap exceeded")
        if n >= 0:
            return EventArray(xs[:n], ys[:n], cs[:n], ds[:n], ts[:n])
        cap *= 4


class CompressedOutput:
    """Write backend for the compressed codec (ref: stream.rs:103-328).

    Events accumulate into the current ADU; when an event's t passes the ADU
    span, the ADU is shipped to a worker thread for entropy coding and the
    length-prefixed blob is written in order.
    """

    magic = MAGIC_COMPRESSED

    def __init__(
        self, meta: CodecMetadata, writer: BinaryIO, entropy: str = "cabac"
    ):
        """entropy: "cabac" (reference-compatible `addec`) or "rans"
        (interleaved-rANS `addrn`, own format — same ADU framing and cube
        transforms, ~parallel-decodable entropy stage)."""
        if entropy not in ("cabac", "rans"):
            raise CodecError(f"unknown entropy stage {entropy!r}")
        self.entropy = entropy
        if entropy == "rans":
            self.magic = MAGIC_RANS
        if meta.codec_version < 3 and meta.adu_interval > 1:
            raise CodecError(
                "compressed streams with adu_interval > 1 need a v3 header "
                "(the field is a v3 extension; decoders would assume span 1)"
            )
        self.meta = meta
        self.meta.event_size = event_size_for_plane(meta.plane)
        self.writer = writer
        self.options = None  # synced by Encoder.sync_crf
        self.start_t = 0
        self.dt_ref = meta.ref_interval
        self.num_intervals = max(meta.adu_interval, 1)
        self._pending: list = []  # event chunks for current ADU
        self._futures: list = []
        # The ADU worker pool (ref P3, stream.rs:264-319) only pays for
        # itself when a second core can run the GIL-released C call; on a
        # 1-core host the thread handoff costs ~30% of the encode, so
        # compress inline there (ADDER_TPU_ADU_WORKERS overrides).
        env = os.environ.get("ADDER_TPU_ADU_WORKERS")
        if env is not None:
            workers = int(env)
        else:
            workers = 2 if (os.cpu_count() or 1) > 1 else 0
        self._pool = (
            ThreadPoolExecutor(max_workers=workers) if workers > 0 else None
        )

    # -- WriteBackend interface --

    def write_bytes(self, data: bytes) -> None:
        self.writer.write(data)

    def _c_thresh_max(self) -> int:
        if self.options is not None and getattr(self.options, "crf", None):
            return self.options.crf.get_parameters().c_thresh_max
        return 7

    def _adu_span(self) -> int:
        return self.dt_ref * self.num_intervals

    def _flush_adu(self) -> None:
        if not self._pending:
            return
        events = EventArray.concatenate(self._pending)
        self._pending = []
        plane = self.meta.plane
        args = (
            events, plane.width, plane.height, plane.channels,
            self.start_t, self.dt_ref, self.num_intervals,
            self._c_thresh_max(), self.entropy == "rans",
        )
        if self._pool is None:
            blob = compress_adu(*args)
            self.writer.write(len(blob).to_bytes(4, "big"))
            self.writer.write(blob)
        else:
            self._futures.append(self._pool.submit(compress_adu, *args))

    def _drain_futures(self, wait: bool) -> None:
        while self._futures and (wait or self._futures[0].done()):
            blob = self._futures.pop(0).result()
            self.writer.write(len(blob).to_bytes(4, "big"))
            self.writer.write(blob)

    def ingest_event_array(self, events: EventArray) -> None:
        if len(events) == 0:
            return
        # Split the batch at ADU boundaries. The reference checks per event
        # and rotates the ADU at most once per event (stream.rs:264-318): the
        # triggering event lands in the NEW adu even if beyond its span too.
        t = events.t.astype(np.int64)
        span = self._adu_span()
        i = 0
        n = len(events)
        while i < n:
            span_end = self.start_t + span
            rel = np.flatnonzero(t[i:] > span_end)
            if len(rel) == 0:
                self._pending.append(events[i:])
                break
            cut = i + int(rel[0])
            if cut > i:
                self._pending.append(events[i:cut])
            self._flush_adu()
            self.start_t += span
            self._pending.append(events[cut : cut + 1])
            i = cut + 1
        self._drain_futures(wait=False)

    def close(self) -> Optional[BinaryIO]:
        self._flush_adu()
        self._drain_futures(wait=True)
        if self._pool is not None:
            self._pool.shutdown()
        self.writer.flush()
        w, self.writer = self.writer, None
        return w

    def flush(self) -> None:
        self._drain_futures(wait=False)
        if self.writer is not None:
            self.writer.flush()


class CompressedInput:
    """Read backend for the compressed codec (ref: stream.rs:330-443)."""

    def __init__(
        self, meta: CodecMetadata, reader: BinaryIO, entropy: str = "cabac"
    ):
        if entropy not in ("cabac", "rans"):
            raise CodecError(f"unknown entropy stage {entropy!r}")
        self.entropy = entropy
        self.meta = meta
        self.reader = reader
        self.dt_ref = meta.ref_interval
        self.num_intervals = max(meta.adu_interval, 1)
        self._queue = EventArray.empty()
        self._queue_pos = 0
        self._adu_idx = 0  # index of the NEXT ADU to read from the stream
        # byte offset -> ADU index; seeds the seek table with the first
        # boundary (right after the header); later boundaries are recorded
        # as ADUs stream past (or discovered by scan_adu_boundaries)
        self._boundaries = {meta.header_size: 0}

    @property
    def start_t(self) -> int:
        """start_t of the most recently decoded ADU (external tracking, like
        the reference: the blob's own coded start_t bytes are ignored)."""
        return max(self._adu_idx - 1, 0) * self.dt_ref * self.num_intervals

    def _read_adu(self) -> bool:
        pos = self.reader.tell()
        lenb = self.reader.read(4)
        if len(lenb) < 4:
            return False
        n = int.from_bytes(lenb, "big")
        blob = self.reader.read(n)
        if len(blob) < n:
            return False
        self._boundaries[pos] = self._adu_idx
        start_t = self._adu_idx * self.dt_ref * self.num_intervals
        self._adu_idx += 1
        self._boundaries[self.reader.tell()] = self._adu_idx
        plane = self.meta.plane
        self._queue = decompress_adu(
            blob, plane.width, plane.height, plane.channels,
            start_t, self.dt_ref, self.num_intervals,
            rans=self.entropy == "rans",
        )
        self._queue_pos = 0
        return True

    def scan_adu_boundaries(self) -> list[int]:
        """Walk the length-prefixed ADU frames from the current position
        without decompressing, filling the seek table. Returns all known
        boundary offsets in order (ref: stream.rs:394-400 — `addec` streams
        are seekable only at ADU boundaries)."""
        pos0 = self.reader.tell()
        file_end = self.reader.seek(0, io.SEEK_END)
        pos = min(self._boundaries)
        idx = self._boundaries[pos]
        self.reader.seek(pos)
        while True:
            lenb = self.reader.read(4)
            if len(lenb) < 4:
                break
            n = int.from_bytes(lenb, "big")
            # seeking past EOF does not clamp, so check against the real
            # file end: a truncated final ADU must not register a boundary
            # (seeking there would silently decode nothing)
            if file_end - (pos + 4) < n:
                break
            end = self.reader.seek(pos + 4 + n)
            self._boundaries[pos] = idx
            pos, idx = end, idx + 1
            self._boundaries[pos] = idx
        self.reader.seek(pos0)
        return sorted(self._boundaries)

    def seek(self, pos: int) -> None:
        """Seek to an ADU boundary (the only valid targets in an `addec`
        stream). Resets the in-flight ADU so the next digest decodes the
        ADU starting at `pos` with the correct start_t."""
        if pos not in self._boundaries:
            self.scan_adu_boundaries()
        if pos not in self._boundaries:
            raise SeekError(
                f"position {pos} is not an ADU boundary of this stream"
            )
        self.reader.seek(pos)
        self._adu_idx = self._boundaries[pos]
        self._queue = EventArray.empty()
        self._queue_pos = 0

    def digest_event(self):
        while self._queue_pos >= len(self._queue):
            if not self._read_adu():
                raise Eof()
        ev = self._queue[self._queue_pos]
        self._queue_pos += 1
        return ev

    def digest_batch(self, max_events: int) -> EventArray:
        if self._queue_pos >= len(self._queue):
            if not self._read_adu():
                return EventArray.empty()
        end = min(self._queue_pos + max_events, len(self._queue))
        out = self._queue[self._queue_pos : end]
        self._queue_pos = end
        return out

    def digest_all(self) -> EventArray:
        chunks = []
        if self._queue_pos < len(self._queue):
            chunks.append(self._queue[self._queue_pos :])
            self._queue_pos = len(self._queue)
        while self._read_adu():
            chunks.append(self._queue)
            self._queue_pos = len(self._queue)
        return EventArray.concatenate(chunks)
