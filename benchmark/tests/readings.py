"""The readings behind a cell's limits: the numbers the judgement compares,
on the card at the cell's own size, for the program over many seeds and
for the control and each planted fault (``faults.py``) over a few, all
in one process (each run builds, warms up and runs its own short window,
as ``run.py`` does, then is judged).

    python3 benchmark/tests/readings.py --workload drum.bed --seconds 8 \\
        --seeds 11,12,13 --faults bf16,no_second_kick --fault-seeds 21,22,23 \\
        --out build/readings.jsonl

Prints, and appends to ``--out``, one JSON line a run: the fault (null
for the program), the seed, each number's reading (the largest over the
judged steps) and each judged step's own.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def one_run(spec, seed, seconds, fault, device):
    from benchmark.harness import cell
    from benchmark.tests import faults

    undo = []

    def put(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if fault:
        faults.apply(fault, put)
    try:
        res = cell.run_single(spec, seed, seconds, False, device, time.time())
        checks, details = cell.judge(spec, res, device)
    finally:
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
    return dict(fault=fault, seed=seed, steps=res["steps"],
                evidence=res["evidence"],
                readings={k: v for k, (v, _) in checks.items()},
                by_step=[d["numbers"] for d in details["steps"]],
                reference_s=details["reference_s"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from benchmark.harness import cell

    spec = cell.spec_of(args.workload)
    ints = lambda s: [int(v) for v in s.split(",") if v]
    runs = [(None, s) for s in ints(args.seeds)]
    runs += [(f, s) for f in args.faults.split(",") if f
             for s in ints(args.fault_seeds)]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for fault, seed in runs:
        try:
            rec = one_run(spec, seed, args.seconds, fault, args.device)
        except Exception:  # a fault that crashes the run has failed
            rec = dict(fault=fault, seed=seed,
                       error=traceback.format_exc()[-2000:])
        rec["workload"] = args.workload
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
