"""The benchmark of spherharm_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload drum.bed --seed 7 --seconds 10 --trace 0

builds the cell's configuration on the card from the seed, warms up its
CUDA graphs, runs the window for ``--seconds`` through the program's own
``run``, then the steps its traffic file judges, holds them to the plain
reference (``benchmark/reference``), and prints the result as one JSON
line, last on standard output. ``--trace 1`` runs the window with a slice
of it under the profiler and reports the cell's per-layer metrics instead
of its end-to-end ones. Exits non-zero, printing no result, without enough CUDA
cards for the cell, or when a module of the JAX package has been loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """The wall-clock time this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def main(argv=None) -> int:
    t_process = process_start()
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import cell

    spec = cell.spec_of(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    trace = bool(args.trace)
    if spec["cfg"].get("shards"):
        from benchmark.harness import ranks

        res = ranks.run_ranks(spec, args.seed, args.seconds, trace, t_process)
    else:
        res = cell.run_single(spec, args.seed, args.seconds, trace, "cuda",
                              t_process)
    checks, details = cell.judge(spec, res, "cuda")
    cell.report(spec, res, checks, details, trace, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
