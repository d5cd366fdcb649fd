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
