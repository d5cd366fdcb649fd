"""The control and the planted faults of the correctness check.

Neither runs in a benchmark run. Each is a hook that `harness.run` calls
on the program (`Video`) before its first chunk, and that replaces what
runs a chunk (`Video._run_chunk`):

- `control`: the plain reference itself in the program's place, its float
  arithmetic rounded to bfloat16, one precision below the f32 that the
  configuration's state machine states. The check must find it wrong.
- `FAULTS`: the program's own chunk, broken underneath: a chunk that
  returns its state unchanged; a chunk that leaves out half of its frames;
  an answer altered where it is produced (the first frame's event count,
  and on the Raw sink the first event's time). The exchange between cards
  does not exist in a one-card cell.

On the card, at the cell's own size:

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds 3 [--fault <name>]

prints one line per seed with the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def control(config: dict, prec: str = "bf16"):
    from portbench import reference

    p = reference.params_of(config)

    def hook(video):
        def run_chunk(state, pending):
            return reference.run_chunk(reference.as_state(state),
                                       pending["frames"], p,
                                       events=not pending["group"], prec=prec)
        video._run_chunk = run_chunk
    return hook


def _broken(change):
    def hook(video):
        orig = video._run_chunk

        def run_chunk(state, pending):
            return change(orig, state, pending)
        video._run_chunk = run_chunk
    return hook


def _state_unchanged(orig, state, pending):
    return orig(state, pending)._replace(state=state)


def _half_frames(orig, state, pending):
    half = pending["frames"].shape[0] // 2
    return orig(state, dict(pending, frames=pending["frames"][:half]))


def _altered(orig, state, pending):
    outs = orig(state, pending)
    per = outs.per_interval.clone()
    per[0] += 1
    outs = outs._replace(per_interval=per)
    if outs.t is not None and outs.t.numel():
        t = outs.t.clone()
        t[0] ^= 1
        outs = outs._replace(t=t)
    return outs


FAULTS = {"state_unchanged": _broken(_state_unchanged),
          "half_frames": _broken(_half_frames),
          "altered_answer": _broken(_altered)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control, or a fault, on the card")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from portbench import harness

    spec = harness.load_spec()
    cell = harness.entry(spec["workloads"], args.workload)
    config = json.loads((root / harness.entry(spec["configs"], cell["config"])
                         ["file"]).read_text())
    hook = FAULTS[args.fault] if args.fault else control(config)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = harness.run(args.workload, seed, args.seconds, False,
                           t_start=time.perf_counter(), hook=hook, spec=spec)
        print(json.dumps({"seed": seed, "what": args.fault or "control bf16",
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
