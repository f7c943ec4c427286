"""The control of each cell's correctness check, and the readings its
limits are set from.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --seconds 2 [--dtype bfloat16]

For each seed, in one process: a run of the cell as the benchmark makes it
(set-up, a window of ``--seconds``, the check against the reference), whose
compared numbers are the program's readings; then the control on the same
rows and frames: the plain reference computed in the precision below the
configuration's (float32 -> bfloat16), put in the program's place. One
JSON line per seed: ``{"seed", "program", "control"}``. A limit lies above
the program's readings and below the control's. Card only; the benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def readings(name: str, seed: int, seconds: float, dtype, device, mix_overrides=None) -> dict:
    run = harness.find(name, seed=seed, seconds=seconds, trace=False, device=device,
                       t_start=time.perf_counter(), mix_overrides=mix_overrides)
    harness.execute(run)
    return {"seed": seed, "frames": len(run.frames),
            "program": {c.name: c.value for c in run.checks},
            "control": run.driver.control(run, dtype)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the control runs on the card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        line = readings(args.workload, seed, args.seconds, DTYPES[args.dtype],
                        torch.device("cuda", 0))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
