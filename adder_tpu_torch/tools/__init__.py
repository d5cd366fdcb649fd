"""The command-line tools of adder_tpu_torch.

One module per script of the JAX package's `tools/`, under the same name,
each run as `python -m adder_tpu_torch.tools.<name>` and callable in-process
as `main(argv) -> int`. A tool keeps its JAX twin's flags, defaults,
printed lines and output bytes (`--no-batched` of the DVS and DAVIS
transcoders runs the scalar per-event oracle, as there), with one
difference of the port's: a tool that touches a tensor takes
`--torch-device {cuda,cpu}` (default `cuda`) and passes it to the entry
points as `device=`; without CUDA the default raises as the entry points
do, and nothing falls back to the CPU. (`decode_benchmark`'s own
`--device` keeps its meaning: also frame on the accelerator.)
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable

from ..codec.header import CodecError


def add_torch_device(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--torch-device", choices=["cuda", "cpu"], default="cuda",
        help="torch device of the transcode (default cuda; without CUDA "
             "the default raises)",
    )


def stream_errors(run: Callable[[], int]) -> int:
    """Run a tool that reads an .adder stream, reporting an invalid stream
    or a missing file on stderr with exit code 1, as the JAX tools' script
    guards do."""
    try:
        return run()
    except CodecError as e:
        print(f"error: not a valid ADDER stream: {e}", file=sys.stderr)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
    return 1
