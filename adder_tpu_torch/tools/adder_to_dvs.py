"""Transcode an ADDER file to DVS polarity events (ref: adder-to-dvs CLI).

The port's twin of `tools/adder_to_dvs.py`: the same flags, printed line
and output bytes.

    python -m adder_tpu_torch.tools.adder_to_dvs -i in.adder --output-events out.dvs
"""

import argparse
import sys

from ..models.adder_to_dvs import adder_to_dvs
from . import stream_errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="ADDER -> DVS events")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--output-events", required=True)
    p.add_argument("--output-mode", choices=["binary", "text"], default="binary")
    p.add_argument("--theta", type=float, default=0.01)
    p.add_argument("--reorder", action="store_true")
    args = p.parse_args(argv)

    def run() -> int:
        with open(args.output_events, "wb") as f:
            stats = adder_to_dvs(
                args.input, f, args.output_mode, args.theta, args.reorder
            )
        print(
            f"{stats['n_adder_events']} ADDER events -> "
            f"{stats['n_dvs_events']} DVS events"
        )
        return 0

    return stream_errors(run)


if __name__ == "__main__":
    sys.exit(main())
