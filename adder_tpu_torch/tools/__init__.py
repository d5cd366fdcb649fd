"""The command-line tools of adder_tpu_torch.

One module per script of the JAX package's `tools/`, under the same name,
each run as `python -m adder_tpu_torch.tools.<name>` and callable in-process
as `main(argv) -> int`. A tool keeps its JAX twin's flags, defaults,
printed lines and output bytes, with two differences of the port's:

- a tool that touches a tensor takes `--torch-device {cuda,cpu}` (default
  `cuda`) and passes it to the entry points as `device=`; without CUDA the
  default raises as the entry points do, and nothing falls back to the CPU.
  (`decode_benchmark`'s own `--device` keeps its meaning: also frame on the
  accelerator.)
- `--no-batched`, which picks the JAX package's scalar per-event oracle, is
  refused with exit code 2: the port does not carry that oracle, and its
  batched device route, which `--batched` names, is its only one.
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


def refuse_scalar_oracle(p: argparse.ArgumentParser,
                         args: argparse.Namespace) -> None:
    """Exit 2 through argparse when the scalar oracle is asked for."""
    if not args.batched:
        p.error("--no-batched selects the scalar per-event oracle, which "
                "adder_tpu_torch does not port; its batched device route "
                "(--batched, the default) is the only one")


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
