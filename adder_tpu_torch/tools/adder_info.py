"""Print ADDER stream metadata + statistics (ref: adder-info CLI).

The port's twin of `tools/adder_info.py`, over the port's copy of
`utils/info.py`: the same flags and report.

    python -m adder_tpu_torch.tools.adder_info -i in.adder -d
"""

import argparse
import sys

from ..utils.info import adder_info
from . import stream_errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ADDER stream info")
    p.add_argument("-i", "--input", required=True, help="Input .adder path")
    p.add_argument(
        "-d", "--dynamic-range", action="store_true",
        help="Calculate dynamic range of the event stream",
    )
    args = p.parse_args(argv)

    def run() -> int:
        print(adder_info(args.input, args.dynamic_range), end="")
        return 0

    return stream_errors(run)


if __name__ == "__main__":
    sys.exit(main())
