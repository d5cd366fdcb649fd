"""Prophesee RAW -> ADDER transcode (ref: bin/prophesee_to_adder.rs).

The port's twin of `tools/prophesee_to_adder.py`: the same flags, defaults,
printed line and `.adder` bytes, transcoding on `--torch-device` (K3 and
its row glue on the card).

    python -m adder_tpu_torch.tools.prophesee_to_adder -i in.raw -o out.adder
"""

import argparse
import sys

from ..codec.encoder import EncoderOptions, EncoderType
from ..core.types import PixelMultiMode, SourceCamera, TimeMode
from ..transcoder.prophesee import Prophesee
from . import add_torch_device, refuse_scalar_oracle


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Prophesee RAW -> ADDER")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--ref-time", type=int, default=20)
    p.add_argument("--crf", type=int, default=3)
    p.add_argument("--max-intervals", type=int, default=0)
    p.add_argument(
        "--batched", action=argparse.BooleanOptionalAction, default=True,
        help="integrate on the device kernels (the only route of the "
             "port); --no-batched, the scalar oracle, is refused",
    )
    add_torch_device(p)
    args = p.parse_args(argv)
    refuse_scalar_oracle(p, args)

    src = Prophesee(args.ref_time, args.input, device=args.torch_device)
    src.crf(args.crf)
    src.write_out(
        SourceCamera.Dvs,
        TimeMode.AbsoluteT,
        PixelMultiMode.Collapse,
        None,
        EncoderType.Raw,
        EncoderOptions.default(src.plane),
        open(args.output, "wb"),
    )
    n_events = 0
    intervals = 0
    while True:
        try:
            n_events += len(src.consume())
        except EOFError:
            break
        intervals += 1
        if args.max_intervals and intervals >= args.max_intervals:
            break
    src.end_write_stream().close()
    print(f"transcoded {n_events} ADDER events over {intervals} view intervals")
    return 0


if __name__ == "__main__":
    sys.exit(main())
