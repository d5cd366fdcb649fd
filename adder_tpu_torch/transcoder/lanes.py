"""The lane-chunk plumbing the event-camera sources share (Prophesee, DAVIS):
the chunk parameters, one chunk through a wrapper of `ops/fused_resident`,
and the hand-off of its events to the encoder."""

from __future__ import annotations

import numpy as np

from ..core.types import NO_CHANNEL, EventArray, Mode, TimeMode
from ..ops import dvs_batch
from ..ops import integrate as ops
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


def run_lane_chunk(fn, state, planes, p, void: bool, width: int):
    """One lane chunk of the wrapper `fn` (`dvs_chunk_resident`,
    `dvs_rows_resident` or `davis_chunk_resident`) on `state`, `planes`
    being its inputs between the state and the parameters: (the new state,
    its events as (x, y, d, t) host arrays, or None when `void`: the VOID
    pass, no fetch). `dvs_rows_resident` updates `state` in place and
    returns it; the others return a new one."""
    res = fn(state, *planes, p, events=not void)
    if void:
        return res.state, None
    pixd = res.pixd.cpu().numpy().view(np.uint32)
    t = res.t.cpu().numpy().view(np.uint32)
    return res.state, dvs_batch.wire_to_events(pixd, t, width)


def ingest_parts(encoder, parts: list) -> EventArray:
    """Concatenate (x, y, d, t) parts (None for a void chunk) in order into
    one EventArray and feed it to `encoder`."""
    parts = [q for q in parts if q is not None]
    if parts:
        x, y, d, t = (np.concatenate([q[i] for q in parts]) for i in range(4))
    else:
        x = y = np.zeros(0, np.uint16)
        d = np.zeros(0, np.uint8)
        t = np.zeros(0, np.uint32)
    arr = EventArray(x, y, np.full(len(x), NO_CHANNEL, np.uint8), d, t)
    encoder.ingest_event_array(arr)
    return arr
