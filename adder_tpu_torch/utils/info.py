"""Stream metadata / statistics report (the adder-info tool).

Copy of `adder_tpu/utils/info.py` over the port's decoder and core types;
the port keeps its own copy and imports nothing of the JAX package.

ref: adder-info/src/main.rs:30-153. The dynamic-range computation is a
single vectorized pass (segmented per-pixel delta-t reconstruction) instead
of the reference's per-event loop.
"""

from __future__ import annotations

import io
import pathlib

import numpy as np

from ..codec.decoder import open_file_decoder
from ..core.types import D_EMPTY, D_ZERO_INTEGRATION, NO_CHANNEL, TimeMode


def adder_info(input_path: str, dynamic_range: bool = False) -> str:
    dec = open_file_decoder(input_path)
    meta = dec.meta
    file_size = pathlib.Path(input_path).stat().st_size
    events = dec.digest_all()
    num_events = len(events)
    events_per_px = num_events // meta.plane.volume()

    out = io.StringIO()
    w = out.write
    w("Dimensions\n")
    w(f"\tWidth: {meta.plane.width}\n")
    w(f"\tHeight: {meta.plane.height}\n")
    w(f"\tColor channels: {meta.plane.channels}\n")
    w(f"Source camera: {meta.source_camera.name}\n")
    w("ADDER transcoder parameters\n")
    w(f"\tCodec version: {meta.codec_version}\n")
    w(f"\tTime mode: {meta.time_mode.name}\n")
    w(f"\tTicks per second: {meta.tps}\n")
    w(f"\tReference ticks per source interval: {meta.ref_interval}\n")
    w(f"\tDelta_t_max: {meta.delta_t_max}\n")
    w("File metadata\n")
    w(f"\tFile size: {file_size}\n")
    w(f"\tHeader size: {meta.header_size}\n")
    w(f"\tADDER event count: {num_events}\n")
    w(f"\tEvents per pixel channel: {events_per_px}\n")

    if dynamic_range and num_events:
        # reconstruct per-pixel delta-t for AbsoluteT streams (ref: :90-100)
        dts = events.t.astype(np.int64)
        if meta.codec_version >= 2 and meta.time_mode == TimeMode.AbsoluteT:
            c = np.where(events.c == NO_CHANNEL, 0, events.c).astype(np.int64)
            pix = (
                events.y.astype(np.int64) * meta.plane.width
                + events.x.astype(np.int64)
            ) * meta.plane.channels + c
            order = np.argsort(pix, kind="stable")
            spix = pix[order]
            st = events.t[order].astype(np.int64)
            prev = np.zeros_like(st)
            prev[1:] = np.where(spix[1:] == spix[:-1], st[:-1], 0)
            dts = np.empty_like(st)
            dts[order] = st - prev

        d = events.d.astype(np.int64)
        safe_dt = np.where(dts == 0, 1, dts).astype(np.float64)
        with np.errstate(over="ignore"):
            intensity = np.where(
                d <= 127, np.exp2(np.minimum(d, 127).astype(np.float64)), 0.0
            ) / safe_dt
        valid = d != D_EMPTY
        mins = np.where(
            valid & (d == D_ZERO_INTEGRATION), 1.0 / safe_dt, np.inf
        )
        mins = np.where(valid & (d != D_ZERO_INTEGRATION), intensity, mins)
        min_intensity = float(np.min(np.where(valid, mins, np.inf)))
        max_intensity = float(np.max(np.where(valid, intensity, 0.0)))

        theory_ratio = float(2.0**127) / (1.0 / meta.delta_t_max)
        w("Dynamic range\n")
        w("\tTheoretical range:\n")
        w(f"\t\t{10.0 * np.log10(theory_ratio):.4f} dB (power)\n")
        w(f"\t\t{np.log2(theory_ratio):.4f} bits\n")
        real_ratio = max_intensity / max(min_intensity, 1e-300)
        w("\tRealized range:\n")
        w(f"\t\t{10.0 * np.log10(real_ratio):.4f} dB (power)\n")
        w(f"\t\t{np.log2(real_ratio):.4f} bits\n")
    return out.getvalue()
