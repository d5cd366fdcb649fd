"""Run one cell of the benchmark of adder_tpu_torch on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (one JSON object); the numbers the correctness check compared,
each beside its limit, are the last lines of standard error. Without a
CUDA card, or with fewer cards than the cell asks for, it prints no
result and exits 2; if JAX or the JAX package was imported, it exits 3.
The kernel library builds once into the checkout (adder_tpu_torch/build/),
and every other cache goes to fixed directories under .cache/portbench/.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".cache" / "portbench" / sub)
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path[0] = str(ROOT)
    else:
        sys.path.insert(0, str(ROOT))

    from portbench import harness

    spec = harness.load_spec()
    chips = harness.entry(spec["workloads"], args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = harness.run(args.workload, args.seed % (1 << 63), args.seconds,
                       bool(args.trace), t_start=T_START, spec=spec)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the process holds {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
