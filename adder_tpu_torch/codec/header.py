"""ADDER stream header read/write, bit-compatible with the reference.

Copy of `adder_tpu/codec/header.py`; the port keeps its own copy and imports nothing of
the JAX package.

Wire layout (big-endian, fixed-int; ref: adder-codec-core/src/codec/header.rs:4-85
and bincode fixint encoding used at codec/encoder.rs:170-229):

  offset size field
  0      5    magic: b"adder" (raw) | b"addec" (compressed)
  5      1    version (0..=3)
  6      1    endianness: b'b' (big endian)
  7      2    width  (u16)
  9      2    height (u16)
  11     4    tps (u32)
  15     4    ref_interval (u32)
  19     4    delta_t_max (u32)
  23     1    event_size (9 mono / 11 color)
  24     1    channels

Chained extensions (each only present for version >= N):
  V1: source_camera (u32 enum index)   — header size 29
  V2: time_mode     (u32 enum index)   — header size 33
  V3: adu_interval  (u32)              — header size 37
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..core.types import PlaneSize, SourceCamera, TimeMode

MAGIC_RAW = b"adder"
MAGIC_COMPRESSED = b"addec"
# Own TPU-friendly compressed variant (interleaved rANS entropy stage, same
# container framing and cube transforms; NOT in the reference)
MAGIC_RANS = b"addrn"

LATEST_CODEC_VERSION = 3

_BASE = struct.Struct(">5sBBHHIIIBB")  # 25 bytes
_EXT = struct.Struct(">I")  # each extension field is a 4-byte BE u32


class CodecError(Exception):
    pass


class WrongMagic(CodecError):
    pass


class Eof(CodecError):
    """In-band EOF event reached (ref: codec/mod.rs CodecError::Eof)."""


class UnsupportedVersion(CodecError):
    pass


class SeekError(CodecError):
    pass


@dataclass
class CodecMetadata:
    """Stream-constant metadata (ref: adder-codec-core/src/codec/mod.rs:79-107)."""

    codec_version: int = LATEST_CODEC_VERSION
    header_size: int = 24
    time_mode: TimeMode = TimeMode.AbsoluteT
    plane: PlaneSize = field(default_factory=PlaneSize)
    tps: int = 2550
    ref_interval: int = 255
    delta_t_max: int = 255
    event_size: int = 9
    source_camera: SourceCamera = SourceCamera.FramedU8
    adu_interval: int = 1


def event_size_for_plane(plane: PlaneSize) -> int:
    """9 B mono / 11 B color (ref: codec/header.rs:77-82)."""
    return 9 if plane.channels == 1 else 11


def encode_header(meta: CodecMetadata, magic: bytes) -> bytes:
    """Serialize header + version-gated extensions.

    ref: codec/encoder.rs:170-229 (encode_header / encode_header_extension)
    """
    if magic not in (MAGIC_RAW, MAGIC_COMPRESSED, MAGIC_RANS):
        raise CodecError(f"bad magic {magic!r}")
    plane = meta.plane
    out = bytearray(
        _BASE.pack(
            magic,
            meta.codec_version,
            ord("b"),
            plane.width,
            plane.height,
            meta.tps,
            meta.ref_interval,
            meta.delta_t_max,
            event_size_for_plane(plane),
            plane.channels,
        )
    )
    if meta.codec_version >= 1:
        out += _EXT.pack(int(meta.source_camera))
    if meta.codec_version >= 2:
        out += _EXT.pack(int(meta.time_mode))
    if meta.codec_version >= 3:
        out += _EXT.pack(meta.adu_interval)
    if meta.codec_version > LATEST_CODEC_VERSION:
        raise UnsupportedVersion(meta.codec_version)
    return bytes(out)


def decode_header(reader, expected_magic: bytes | None = None) -> tuple[CodecMetadata, bytes]:
    """Read header from a binary stream. Returns (metadata, magic).

    ref: codec/decoder.rs:102-203 (decode_header / decode_header_extension)
    """
    buf = reader.read(_BASE.size)
    if len(buf) < _BASE.size:
        raise CodecError("truncated header")
    (
        magic,
        version,
        _endianness,
        width,
        height,
        tps,
        ref_interval,
        delta_t_max,
        event_size,
        channels,
    ) = _BASE.unpack(buf)
    if magic not in (MAGIC_RAW, MAGIC_COMPRESSED, MAGIC_RANS):
        raise WrongMagic(magic)
    if expected_magic is not None and magic != expected_magic:
        raise WrongMagic(magic)

    # Manual fix for malformed files from old software (ref: decoder.rs:133-137)
    if event_size == 10:
        event_size = 11

    meta = CodecMetadata(
        codec_version=version,
        header_size=_BASE.size,
        time_mode=TimeMode.DeltaT,
        plane=PlaneSize(width, height, channels),
        tps=tps,
        ref_interval=ref_interval,
        delta_t_max=delta_t_max,
        event_size=event_size,
        source_camera=SourceCamera.FramedU8,
        adu_interval=0,
    )

    if version >= 1:
        meta.source_camera = SourceCamera(_read_ext(reader))
        meta.header_size += 4
    if version >= 2:
        meta.time_mode = TimeMode(_read_ext(reader))
        meta.header_size += 4
    if version >= 3:
        meta.adu_interval = _read_ext(reader)
        meta.header_size += 4
    if version > LATEST_CODEC_VERSION:
        raise UnsupportedVersion(version)
    return meta, magic


def _read_ext(reader) -> int:
    buf = reader.read(4)
    if len(buf) < 4:
        raise CodecError("truncated header extension")
    return _EXT.unpack(buf)[0]
