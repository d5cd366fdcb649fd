"""adder_tpu_torch — the ADΔER transcoder on PyTorch, with CUDA kernels for Hopper.

The port of `adder_tpu` (JAX on a TPU) to PyTorch and an NVIDIA H100. This
package imports torch and never jax, and nothing of `adder_tpu`: the host
modules it needs (core types, the codec, the native planners, the aedat4
container, EDI) are copies of the JAX package's, each naming its source.

Layers, entry point first:
  transcoder/framed.py    FramedArray: (T, H, W, C) u8 frames -> Video
  transcoder/prophesee.py Prophesee: DVS RAW stream -> lane chunks (K3)
  transcoder/davis.py     Davis: DAVIS packets (APS frames + DVS events)
                          -> lane chunks (K4) and frame chunks (K3)
  transcoder/edi.py       EdiReconstructor: aedat4 -> deblurred packets
  transcoder/video.py     Video: chunked submit/collect, depth rerun, encoder
  ops/fused_resident.py   one chunk (framed, DVS or DAVIS lanes): plain
                          torch version and the CUDA wrappers
  ops/dvs_batch.py        masked DVS / DAVIS sub-steps, the lane plans
  ops/integrate.py        PixelState, TranscodeParams, the interval logic
  ops/cuda_build.py       nvcc build of csrc/ at first use, ctypes binding
  ops/native_build.py     g++ build of the host C++ helpers at first use
  csrc/                   the Hopper kernels (CUDA C++, sm_90a)
  codec/, core/, utils/   the codec, the core types, aedat4 (copies)
  convert.py              state to and from the JAX package through numpy

Every entry point runs on the card (`device="cuda"`) unless the caller asks
for the CPU; without CUDA a CUDA device raises.
"""

from .codec.decoder import open_file_decoder  # noqa: F401
from .codec.encoder import EncoderOptions, EncoderType  # noqa: F401
from .core.types import (  # noqa: F401
    EventArray,
    Mode,
    PixelMultiMode,
    PlaneSize,
    SourceCamera,
    TimeMode,
)
from .transcoder.davis import Davis, TranscoderMode  # noqa: F401
from .transcoder.edi import EdiReconstructor  # noqa: F401
from .transcoder.framed import FramedArray  # noqa: F401
from .transcoder.prophesee import Prophesee  # noqa: F401
from .transcoder.video import Video  # noqa: F401
