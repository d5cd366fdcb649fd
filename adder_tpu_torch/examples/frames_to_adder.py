"""Transcode synthetic frames to an .adder file on the card.

The port's twin of `examples/frames_to_adder.py`: the same seeded frames,
settings and `.adder` bytes, transcoded on `--torch-device` (K1).

    python -m adder_tpu_torch.examples.frames_to_adder out.adder
"""

import argparse
import sys

import numpy as np

from ..codec.encoder import EncoderOptions, EncoderType
from ..core.types import PixelMultiMode, SourceCamera, TimeMode
from ..transcoder.framed import FramedArray


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="synthetic frames -> .adder")
    p.add_argument("output", nargs="?", default="example.adder")
    p.add_argument("--torch-device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    rng = np.random.default_rng(0)
    frames = np.clip(
        rng.integers(80, 176, (32, 64, 96, 1))
        + np.linspace(0, 40, 32)[:, None, None, None],
        0, 255,
    ).astype(np.uint8)

    src = FramedArray(frames, source_fps=24.0, chunk_frames=8,
                      device=args.torch_device)
    src.auto_time_parameters(255, 255 * 30, TimeMode.AbsoluteT)
    src.crf(3)
    out = args.output
    src.write_out(
        SourceCamera.FramedU8, TimeMode.AbsoluteT, PixelMultiMode.Collapse,
        None, EncoderType.Raw, EncoderOptions.default(src.video.plane),
        open(out, "wb"),
    )
    n = 0
    while True:
        try:
            n += len(src.consume_batch())
        except EOFError:
            break
    src.video.end_write_stream().close()
    print(f"wrote {n} events to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
