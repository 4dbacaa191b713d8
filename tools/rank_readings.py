"""The readings behind a sharded cell's limits, and each run's hosts: the
numbers the judgement compares, on the cards at the cell's own size, for
the program over many seeds and for the control and each planted fault
over a few (``benchmark/tests/faults.py``).

Each (fault, seed) is one run of the cell as ``benchmark/run.py`` makes
it: ``harness/ranks.run_ranks`` spawns the ranks (set-up, warm-up, the
window of ``--seconds`` stopped together, the judged steps; the fault
planted in every rank by ``faults.fault_worker``), and ``cell.judge``
holds the merged judged steps to the plain reference. It prints, and
appends to ``--out``, one JSON line a run: the fault (null for the
program), the seed, the window's seconds, ``run.py``'s result line
(``metrics``, ``checks``, ``correct``), each number's reading (the
largest over the judged steps, the guards among them), and each rank's
host (``hosts``): the CPUs its threads may use and its CPU seconds over
the run. The faults' runs take ``--fault-seconds``
(default ``--seconds``).

``--limits-from`` reads such lines instead and prints the limits they
give (``limits``), and each fault's numbers above them; ``--write``
writes the limits as the cell's limits file.

    python3 tools/rank_readings.py --workload triaxial.shear.4rank \\
        --seconds 30 --seeds 11,12 --faults bf16,unchanged \\
        --fault-seeds 21,22 --out build/readings.jsonl
    python3 tools/rank_readings.py --limits-from build/readings.jsonl \\
        [--write benchmark/limits/triaxial.shear.4rank.json]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The guards (limit 0 in every cell, not in a limits file).
GUARDS = ("overflow", "skin_violations", "nonfinite_etot",
          "kernels_unlaunched")
# A limit's place between the program's largest reading and the upper
# reading, on a log scale; the numbers whose upper reading is an
# unchanged state's (the control barely moves a position).
PLACE = 0.6
UNCHANGED = ("x_err", "q_err")


def limits(recs, control="bf16") -> dict:
    """The limits of the readings ``recs`` (this tool's lines): for each
    number, 60 % of the way on a log scale from the program's largest
    reading (fault null) to the control's smallest (``x_err``, ``q_err``:
    the fault ``unchanged``'s), to two significant digits;
    ``missing_pairs`` 0."""
    prog = [r["readings"] for r in recs if r["fault"] is None]
    out = {}
    for name in prog[0]:
        if name in GUARDS:
            continue
        if name == "missing_pairs":
            out[name] = 0
            continue
        fault = "unchanged" if name in UNCHANGED else control
        lo = max(p[name] for p in prog)
        hi = min(r["readings"][name] for r in recs if r["fault"] == fault)
        if not 0 < lo < hi:
            raise ValueError(f"{name}: no room between the program's {lo!r} "
                             f"and the {fault} run's {hi!r}")
        out[name] = float(f"{lo * (hi / lo) ** PLACE:.2g}")
    return out


def host_worker(axis, spec, seed, seconds, trace):
    """``harness/ranks.rank_worker`` (``faults.fault_worker`` where the
    run plants a fault) that also appends this rank's host over the run
    to the file ``spec["hosts_out"]``."""
    from benchmark.harness import ranks
    from benchmark.tests import faults

    worker = faults.fault_worker if spec["fault"] else ranks.rank_worker
    t0, u0 = time.time(), resource.getrusage(resource.RUSAGE_SELF)
    res = worker(axis, spec, seed, seconds, trace)
    u1 = resource.getrusage(resource.RUSAGE_SELF)
    line = dict(rank=axis.rank, cpus=sorted(os.sched_getaffinity(0)),
                cpu_s=u1.ru_utime + u1.ru_stime - u0.ru_utime - u0.ru_stime,
                wall_s=time.time() - t0, steps=res["steps"])
    with open(spec["hosts_out"], "a") as f:
        f.write(json.dumps(line) + "\n")
    return res


def one_run(spec, fault, seed, seconds, t_process, device) -> dict:
    from benchmark.harness import cell, ranks

    with tempfile.TemporaryDirectory() as tmp:
        spec = dict(spec, fault=fault, hosts_out=os.path.join(tmp, "hosts"))
        res = ranks.run_ranks(spec, seed, seconds, False, t_process,
                              device=device, worker=host_worker)
        with open(spec["hosts_out"]) as f:
            hosts = sorted((json.loads(line) for line in f),
                           key=lambda h: h["rank"])
    checks, details = cell.judge(spec, res, device)
    return dict(workload=spec["cell"]["name"], fault=fault, seed=seed,
                seconds=seconds,
                result=cell.result_line(spec, res, checks, False, device),
                readings={k: v for k, (v, _) in checks.items()},
                by_step=[d["numbers"] for d in details["steps"]],
                reference_s=details["reference_s"], hosts=hosts)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload")
    p.add_argument("--seconds", type=float)
    p.add_argument("--seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--fault-seconds", type=float)
    p.add_argument("--out")
    p.add_argument("--device", default="cuda")
    p.add_argument("--limits-from")
    p.add_argument("--write")
    args = p.parse_args(argv)
    if args.limits_from:
        with open(args.limits_from) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        lim = limits(recs)
        print(json.dumps(lim))
        for r in recs:
            if r["fault"]:
                over = sorted(k for k, v in r["readings"].items()
                              if v > lim.get(k, 0))
                print(f"{r['fault']} seed {r['seed']}: above a limit: {over}")
        if args.write:
            Path(args.write).write_text(json.dumps(lim, indent=2) + "\n")
        return 0

    from benchmark.harness import cell
    from benchmark.run import process_start

    t_process = process_start()
    spec = cell.spec_of(args.workload)
    ints = lambda s: [int(v) for v in s.split(",") if v]
    fault_s = args.fault_seconds or args.seconds
    runs = [(None, s, args.seconds) for s in ints(args.seeds)]
    runs += [(f, s, fault_s) for f in args.faults.split(",") if f
             for s in ints(args.fault_seeds)]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for i, (fault, seed, seconds) in enumerate(runs):
        rec = one_run(spec, fault, seed, seconds,
                      t_process if i == 0 else time.time(), args.device)
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
