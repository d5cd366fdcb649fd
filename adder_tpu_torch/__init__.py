"""adder_tpu_torch — the ADΔER transcoder on PyTorch, with CUDA kernels for Hopper.

The port of `adder_tpu` (JAX on a TPU) to PyTorch and an NVIDIA H100. This
package imports torch and never jax, and nothing of `adder_tpu`: the host
modules it needs (core types, the codec, the native planners, the aedat4
container, EDI, the ffmpeg decoder, the host framer, the player) are copies
of the JAX package's, each naming its source.

Layers, entry point first:
  models/simulproc.py     SimulProcessor: a framed source transcoded on the
                          card while a host thread frames its events
  models/player.py        AdderPlayer: .adder -> paced frames (host framer)
  models/live_transcoder.py  LiveTranscoder: chunked transcode, live params
  models/adder_to_dvs.py  .adder -> DVS polarity events (host numpy)
  framer/device.py        DeviceFramer: events -> frames in torch ops on the
                          card, values converted on the host at pop
  framer/driver.py        FramerBuilder, FrameSequence: the host framer,
                          its ingest the native walk (framer/native_ingest.py,
                          ops/native/framer_fill.cpp)
  framer/scale_intensity.py  (d, delta_t) -> frame values, f64
  transcoder/framed.py    FramedArray: (T, H, W, C) u8 frames -> Video;
                          Framed, FramedStream: a video file (ffmpeg through
                          transcoder/ffdec.py, or cv2) -> Video
  transcoder/prophesee.py Prophesee: DVS RAW stream -> lane chunks (K3, on
                          the 8-byte carrier), pipelined (transcoder/lanes.py);
                          batched=False: the scalar oracle
                          (transcoder/pixel_oracle.py), as Davis
  transcoder/davis.py     Davis: DAVIS packets (APS frames + DVS events)
                          -> lane chunks (K4) and frame chunks (K3)
  transcoder/edi.py       EdiReconstructor: aedat4 -> deblurred packets
  transcoder/sharded.py   ShardedVideo: Video over pixel bands on several
                          devices (or k bands on one card), one process's
                          pixels of a multi-process job
  transcoder/video.py     Video: chunked submit/collect, depth rerun, encoder
  parallel/sharding.py    the plane in bands: the chunk wrappers per band,
                          the bands' events merged into the reference order
  parallel/multihost.py   torch.distributed jobs: rows per process, event
                          part files, their merge
  ops/fused_resident.py   one chunk (framed, DVS or DAVIS lanes): plain
                          torch version and the CUDA wrappers
  ops/dvs_batch.py        masked DVS / DAVIS sub-steps, the lane plans
  ops/integrate.py        PixelState, TranscodeParams, the interval logic
  ops/cuda_build.py       nvcc build of csrc/ at first use, ctypes binding
  ops/native_build.py     g++ build of the host C++ helpers at first use
  csrc/                   the Hopper kernels (CUDA C++, sm_90a)
  codec/, core/, utils/   the codec, the core types, aedat4 (copies);
                          utils/tracing.py the stage timer (ADDER_TPU_TRACE)
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
from .framer.device import DeviceFramer  # noqa: F401
from .framer.driver import FramerBuilder, FrameSequence  # noqa: F401
from .models.simulproc import SimulProcessor  # noqa: F401
from .transcoder.davis import Davis, TranscoderMode  # noqa: F401
from .transcoder.edi import EdiReconstructor  # noqa: F401
from .transcoder.framed import Framed, FramedArray, FramedStream  # noqa: F401
from .transcoder.prophesee import Prophesee  # noqa: F401
from .transcoder.sharded import ShardedVideo  # noqa: F401
from .transcoder.video import Video  # noqa: F401
