"""Codec version migration: v0/v1 DeltaT streams -> v2+ AbsoluteT.

Copy of `adder_tpu/utils/stream_migration.py` over the port's codec and
core types; the port keeps its own copy and imports nothing of the JAX
package.

ref: adder-codec-rs/src/utils/stream_migration.rs. The reference migrates
one event at a time with a per-pixel running-t array; here the whole stream
converts in one vectorized pass: the per-pixel tracker chain
`t_k = roundup(t_{k-1} + dt_k)` telescopes to a segmented cumsum of
`ref * ceil(dt/ref)` for framed sources (same identity as the framer's
DeltaT chain).
"""

from __future__ import annotations

import numpy as np

from ..codec.decoder import Decoder
from ..codec.encoder import Encoder
from ..core.types import Event, EventArray, NO_CHANNEL, TimeMode, is_framed


def absolute_event_to_dt_event(event: Event, last_t: int) -> Event:
    """ref: stream_migration.rs:18-21"""
    return event._replace(t=event.t - last_t)


def migrate_v2(input_dec: Decoder, output_enc: Encoder) -> Encoder:
    """Re-encode a DeltaT stream with AbsoluteT timestamps
    (ref: stream_migration.rs:32-88)."""
    meta = input_dec.meta
    events = input_dec.digest_all()
    if len(events) == 0:
        return output_enc

    if output_enc.meta.time_mode != TimeMode.AbsoluteT:
        output_enc.ingest_event_array(events)
        return output_enc

    c = np.where(events.c == NO_CHANNEL, 0, events.c).astype(np.int64)
    pix = (
        events.y.astype(np.int64) * meta.plane.width + events.x.astype(np.int64)
    ) * meta.plane.channels + c
    order = np.argsort(pix, kind="stable")
    spix = pix[order]
    dt = events.t[order].astype(np.uint64)

    seg_start = np.ones(len(spix), dtype=bool)
    seg_start[1:] = spix[1:] != spix[:-1]

    framed = meta.codec_version > 0 and is_framed(meta.source_camera)
    ref = np.uint64(max(meta.ref_interval, 1))
    # tracker step: rounded-up dt for framed sources, raw dt otherwise
    step = ((dt + ref - np.uint64(1)) // ref) * ref if framed else dt
    # emitted t_k = tracker_{k-1} + dt_k  (rounding applies after emission,
    # ref: stream_migration.rs:59-82)
    total = np.cumsum(step)
    seg_base = np.maximum.accumulate(np.where(seg_start, total - step, np.uint64(0)))
    tracker_prev = (total - step) - seg_base
    t_abs = tracker_prev + dt

    out_t = np.empty(len(events), dtype=np.uint32)
    out_t[order] = t_abs.astype(np.uint32)
    output_enc.ingest_event_array(
        EventArray(events.x, events.y, events.c, events.d, out_t)
    )
    return output_enc
