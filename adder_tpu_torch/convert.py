"""Move transcoder state between the JAX package and the port through numpy.

`state_from_numpy` takes anything that names the PixelState fields: a mapping
of field name to array, or an object with those attributes (such as
`adder_tpu.ops.integrate.PixelState`, whose fields go through np.asarray).
Both packages then start from one mid-stream state.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .ops.integrate import STATE_DTYPES, PixelState


def state_from_numpy(fields, device) -> PixelState:
    """A PixelState on `device` from numpy-convertible fields."""
    if isinstance(fields, Mapping):
        get = fields.__getitem__
    else:
        def get(name):
            return getattr(fields, name)
    dev = torch.device(device)
    return PixelState(**{
        name: torch.from_numpy(np.array(get(name), copy=True)).to(dev, dt)
        for name, dt in STATE_DTYPES.items()
    })


def state_to_numpy(state: PixelState) -> dict:
    """Field name -> host numpy array."""
    return {
        name: getattr(state, name).detach().cpu().numpy()
        for name in PixelState._fields
    }


def _cut_state(jax_state, n: int, device) -> PixelState:
    """A JAX PixelState cut to the first `n` pixels (the JAX resident
    engines pad the plane to whole blocks) on `device`."""
    fields = {name: np.asarray(getattr(jax_state, name))
              for name in STATE_DTYPES}
    return state_from_numpy(
        {k: v[..., :n] if v.ndim else v for k, v in fields.items()}, device)


def carry_prophesee_state(src, dst) -> None:
    """Carry a JAX `adder_tpu.transcoder.prophesee.Prophesee`'s mid-stream
    state into the port's `dst` (same file, same parameters): the depth-16
    PixelState, cut to the real N pixels where the JAX resident engine pads
    the plane to whole blocks, the per-pixel chain (`dvs_last_timestamps`,
    `dvs_last_ln_val`), `running_t` and the read position in the stream.
    `dst` then goes on where `src` stopped."""
    dst.state = _cut_state(src._dev_state, dst.plane.volume(), dst.device)
    dst.dvs_last_timestamps[...] = src.dvs_last_timestamps
    dst.dvs_last_ln_val[...] = src.dvs_last_ln_val
    dst._val_cache[...] = np.nan
    dst.running_t = int(src.running_t)
    dst.load_events()
    dst._event_pos = int(src._event_pos)
    dst._eof = bool(src._eof)


def carry_davis_state(src, dst) -> None:
    """Carry a batched JAX `adder_tpu.transcoder.davis.Davis`'s mid-stream
    state into the port's `dst` (same parameters): the depth-16
    PixelState, cut to the real N pixels where the JAX resident engine pads
    the plane (`davis.py:151-160`), and the per-pixel chain
    (`dvs_last_timestamps`, `dvs_last_ln_val`). The provider is not carried:
    `dst` reads the packets that follow the ones `src` consumed from its
    own provider."""
    dst.state = _cut_state(src._dev_state, dst.plane.volume(), dst.device)
    dst.dvs_last_timestamps[...] = src.dvs_last_timestamps
    dst.dvs_last_ln_val[...] = src.dvs_last_ln_val
    dst._val_cache[...] = np.nan
