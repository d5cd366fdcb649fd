"""The lane-chunk plumbing the event-camera sources share (Prophesee, DAVIS):
the chunk parameters, one chunk through a row wrapper of
`ops/fused_resident`, and the hand-off of its events to the encoder."""

from __future__ import annotations

import numpy as np

from ..core.types import NO_CHANNEL, EventArray, Mode, TimeMode
from ..ops import dvs_batch
from ..ops import fused_resident as FR
from ..ops import integrate as ops
from ..utils import tracing
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


def run_lane_chunk(fn, state, args, p, void: bool, width: int, **kw):
    """One lane chunk of the row wrapper `fn` (`dvs_rows_resident` or
    `davis_rows_resident`) on `state`, `args` being its inputs between the
    state and the parameters (the carrier and T) and `kw` its keywords:
    (the state, updated in place and returned by the wrapper; its events as
    (x, y, d, t) host arrays, or None when `void`: the VOID pass, no
    fetch)."""
    with tracing.stage("dvs.dispatch"):
        res = fn(state, *args, p, events=not void, **kw)
    if void:
        return res.state, None
    with tracing.stage("dvs.event_fetch", items=res.pixd.numel()):
        pixd = res.pixd.cpu().numpy().view(np.uint32)
        t = res.t.cpu().numpy().view(np.uint32)
    return res.state, dvs_batch.wire_to_events(pixd, t, width)


def gap_rows(pix, fv, inten, tspan) -> np.ndarray:
    """Gap-only DVS rows in lane 0, one for each pixel of `pix` (ascending:
    raster order), as the (5, E) int32 carrier of `FR.pack_dvs_plan`: the
    held intensity `inten` (cast to f32) over `tspan` ticks (cast to f32)
    with frame value `fv` (0..255), the tick half off. Run at T = 2 through
    `run_raster_chunk`, this is the JAX sources' masked interval over the
    pixels of `pix`, with an empty tick sub-step after it."""
    packed = np.zeros((5, len(pix)), np.int32)
    packed[0] = np.asarray(pix, np.int32) | (1 << 27)
    packed[1] = fv
    packed[2] = np.asarray(inten, np.float32).view(np.int32)
    packed[3] = np.asarray(tspan, np.float32).view(np.int32)
    return packed


def run_raster_chunk(state, carrier, p, void: bool, width: int):
    """`run_lane_chunk` of a T = 2 DVS carrier of one row per pixel in
    raster order, all in lane 0 (the bootstrap, an end-of-stream flush,
    DAVIS's frame and the gap to it): through `FR.dvs_rows_resident` with
    the grouping such a carrier has, `FR.raster_row_groups`, so no glue
    runs."""
    groups = FR.raster_row_groups(carrier.shape[1], carrier.device)
    return run_lane_chunk(FR.dvs_rows_resident, state, (carrier, 2), p, void,
                          width, groups=groups)


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
    with tracing.stage("dvs.encode", items=len(arr)):
        encoder.ingest_event_array(arr)
    return arr
