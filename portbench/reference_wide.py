"""The plain reference of a framed ADΔER transcode on a wide plane.

`reference.py` with a wider event list, for planes of 2^24 pixel-channels
and more (3840 x 2160 x 3 is 24,883,200), where its `pix << 8 | d` in 32
bits would alias one pixel with another. The state machine, the settings,
the initial state, the header and the bfloat16 control are
`reference.py`'s, taken by import and unchanged; only the chunk's event
list (`run_chunk`, which builds it) and `event_bytes` are replaced: an
event's `pixd` is int64 pix << 8 | d, so the pixel index keeps every bit.
The module's API is the same, so a driver that imports `reference` can take
this one in its place. On planes below 2^24 it gives `reference.py`'s
events (the same values, int64) and the same bytes.

Like `reference.py` it imports nothing but numpy, torch and that module,
nothing of the program under test and no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference
from portbench.reference import (  # noqa: F401  (the module's API)
    DEPTH, SHALLOW_DEPTH, Chunk, Params, State, as_state, deepen,
    first_frame, header_bytes, initial_state, params_of)

_i64 = torch.int64


def run_chunk(state: State, frames: torch.Tensor, p: Params,
              events: bool = True, prec: str = "f32") -> Chunk:
    """`reference.run_chunk`, its events' `pixd` int64 pix << 8 | d."""
    out = _run_once(state, frames, p, events, prec)
    if int(out.pmax) >> 16 and state.node_d.shape[0] < DEPTH:
        out = _run_once(deepen(state, DEPTH), frames, p, events, prec)
    return out


def _run_once(state, frames, p, events, prec) -> Chunk:
    n = frames.shape[1]
    dev = frames.device
    px = reference._Pixels(state, reference._rounding(prec))
    time = float(np.float32(p.ref_time))
    pix = torch.arange(n, dtype=_i64, device=dev)[:, None]
    counts, most, pixd, ts = [], torch.zeros((), dtype=_i64, device=dev), [], []
    for i in range(frames.shape[0]):
        slots = px.interval(frames[i], time, p)
        m = torch.stack([s[2] for s in slots], dim=1)  # (n, slots)
        per_pixel = m.sum(dim=1)
        most = torch.maximum(most, per_pixel.max())
        counts.append(per_pixel.sum())
        if events:
            d = torch.stack([s[0] for s in slots], dim=1).to(_i64)
            t = torch.stack([s[1] for s in slots], dim=1)
            pixd.append(((pix << 8) | (d & 0xFF))[m])
            ts.append(t[m].to(torch.int32))
    per_interval = torch.stack(counts).to(_i64)
    pmax = most | ((px.fires_past_depth > 0).to(_i64) << 16)
    return Chunk(px.state(state.overflow),
                 torch.cat(pixd) if events else None,
                 torch.cat(ts) if events else None,
                 per_interval, pmax, per_interval.sum())


def event_bytes(pixd: np.ndarray, t: np.ndarray, width: int,
                channels: int) -> bytes:
    """Events (`pix << 8 | d` as int64, or as u32 from `reference.py`, and
    t as u32) in the raw wire format (codec/raw/stream.rs): x, y, [Some(c)],
    d, t, big-endian."""
    if pixd.dtype.itemsize == 4:
        pixd = pixd.view(np.uint32)
    pixd = pixd.astype(np.int64)
    pix = pixd >> 8
    xy = pix // channels
    out = np.empty(len(pixd), dtype=reference._MONO if channels == 1
                   else reference._COLOR)
    out["x"] = xy % width
    out["y"] = xy // width
    if channels > 1:
        out["tag"] = 1
        out["c"] = pix % channels
    out["d"] = pixd & 0xFF
    out["t"] = t.view(np.uint32)
    return out.tobytes()
