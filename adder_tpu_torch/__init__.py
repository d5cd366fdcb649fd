"""adder_tpu_torch — the ADΔER transcoder on PyTorch, with CUDA kernels for Hopper.

The port of `adder_tpu` (JAX on a TPU) to PyTorch and an NVIDIA H100. This
package imports torch and never jax. Host-only numpy modules of `adder_tpu`
(core types, the codec and its encoder/decoder, the CRF tables) are shared
by import rather than rewritten; they import no jax.

Layers, entry point first:
  transcoder/framed.py  FramedArray: (T, H, W, C) u8 frames -> Video
  transcoder/prophesee.py Prophesee: DVS RAW stream -> lane chunks -> Video's
                        encoder
  transcoder/video.py   Video: chunked submit/collect, depth rerun, encoder
  ops/fused_resident.py one chunk (framed or DVS lanes): plain torch version
                        and the CUDA wrappers
  ops/dvs_batch.py      masked DVS sub-steps, the lane plan (shared native
                        planner)
  ops/integrate.py      PixelState, TranscodeParams, the interval logic
  ops/cuda_build.py     nvcc build of csrc/ at first use, ctypes binding
  csrc/                 the Hopper kernels (CUDA C++, sm_90a)
  convert.py            state to and from the JAX package through numpy

Every constructor that allocates takes an explicit `device`.
"""

import os as _os


def _import_shared_package() -> None:
    """Import `adder_tpu` without jax. Its package init imports jax, where
    jax is installed, to set the platform (ADDER_TPU_PLATFORM) and the
    compilation cache (skipped when ADDER_TPU_XLA_CACHE is "0"). The port
    needs neither, so both are switched off for this one import; a process
    that imported `adder_tpu` first keeps its configuration."""
    keys = ("ADDER_TPU_PLATFORM", "ADDER_TPU_XLA_CACHE")
    saved = {k: _os.environ.pop(k, None) for k in keys}
    _os.environ["ADDER_TPU_XLA_CACHE"] = "0"
    try:
        import adder_tpu  # noqa: F401
    finally:
        for k, v in saved.items():
            _os.environ.pop(k, None)
            if v is not None:
                _os.environ[k] = v


_import_shared_package()

from adder_tpu.codec.decoder import open_file_decoder  # noqa: E402,F401
from adder_tpu.codec.encoder import EncoderOptions, EncoderType  # noqa: E402,F401
from adder_tpu.core.types import (  # noqa: E402,F401
    EventArray,
    Mode,
    PixelMultiMode,
    PlaneSize,
    SourceCamera,
    TimeMode,
)

from .transcoder.framed import FramedArray  # noqa: E402,F401
from .transcoder.prophesee import Prophesee  # noqa: E402,F401
from .transcoder.video import Video  # noqa: E402,F401
