"""Event -> pixel-value conversion (vectorized).

Copy of `adder_tpu/framer/scale_intensity.py`; the port keeps its own copy
and imports nothing of the JAX package.

ref: adder-codec-rs/src/framer/scale_intensity.rs. The reference converts one
event at a time through the FrameValue trait; here the conversion is a single
vectorized f64 pass over an event batch.
"""

from __future__ import annotations

import enum

import numpy as np

from ..core.types import D_SHIFT_F64, SourceType


class FramedViewMode(enum.IntEnum):
    """ref: transcoder/source/video.rs:143-158"""

    Intensity = 0
    D = 1
    DeltaT = 2
    SAE = 3


_TYPE_MAX = {
    np.uint8: 255.0,
    np.uint16: 65535.0,
    np.uint32: 4294967295.0,
    np.uint64: 18446744073709551615.0,
}

_SOURCE_MAX = {
    SourceType.U8: 255.0,
    SourceType.U16: 65535.0,
    SourceType.U32: 4294967295.0,
    SourceType.U64: 18446744073709551615.0,
}


def event_to_intensity(d: np.ndarray, dt: np.ndarray) -> np.ndarray:
    """2^d / dt in f64; dt==0 treated as 1; d >= 129 -> 0.

    ref: scale_intensity.rs:262-270
    """
    d = d.astype(np.int64)
    safe_d = np.minimum(d, 128)
    num = D_SHIFT_F64[safe_d]
    num = np.where(d > 128, 0.0, num)
    den = np.where(dt == 0, 1.0, dt.astype(np.float64))
    return num / den


def get_frame_values(
    d: np.ndarray,
    dt: np.ndarray,
    out_dtype,
    source_type: SourceType,
    tpf: float,
    practical_d_max: float,
    delta_t_max: int,
    view_mode: FramedViewMode,
    sae_running_t: np.ndarray | None = None,
    sae_last_fired_t: np.ndarray | None = None,
) -> np.ndarray:
    """Vectorized FrameValue::get_frame_value for integer output types.

    ref: scale_intensity.rs:54-258 (u8/u16/u32/u64 impls share this formula:
    intensity renormalized from source bit depth to output bit depth,
    saturating cast).
    """
    out_max = _TYPE_MAX[np.dtype(out_dtype).type]
    if view_mode == FramedViewMode.Intensity:
        intensity = event_to_intensity(d, dt)
        src_max = _SOURCE_MAX[source_type]
        if src_max == out_max:
            val = intensity * tpf
        else:
            val = intensity / src_max * tpf * out_max
    elif view_mode == FramedViewMode.D:
        val = d.astype(np.float32) / np.float32(practical_d_max) * out_max
    elif view_mode == FramedViewMode.DeltaT:
        val = dt.astype(np.float32) / np.float32(delta_t_max) * out_max
    elif view_mode == FramedViewMode.SAE:
        if sae_running_t is None:
            return np.zeros(len(d), dtype=out_dtype)
        val = (
            (sae_running_t - sae_last_fired_t).astype(np.float32)
            / np.float32(delta_t_max)
            * 255.0
        )
    else:
        raise ValueError(view_mode)
    if np.dtype(out_dtype).type is np.uint64:
        # float64 cannot represent 2^64-1; a plain astype wraps to 0 at the
        # clip boundary. The reference's `as u64` saturates
        # (scale_intensity.rs u64 impl), so saturate explicitly.
        hi = val >= 18446744073709549568.0  # largest f64 < 2^64
        res = np.where(hi, 0.0, np.clip(val, 0, None)).astype(np.uint64)
        res[np.asarray(hi)] = np.uint64(2**64 - 1)
        return res
    return np.clip(val, 0, out_max).astype(out_dtype)


def practical_d_max_for(out_max_f32: float, delta_t_max: int, ref_interval: int) -> float:
    """fast_math::log2_raw(T::max * dtm/ref) (ref: driver.rs:1020-1021).

    Uses exact log2; the reference's approximate log2 only affects the D
    view-mode scaling, not event data.
    """
    return float(np.log2(out_max_f32 * (delta_t_max // ref_interval)))
