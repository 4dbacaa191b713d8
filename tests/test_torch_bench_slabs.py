"""The four-rank cell ``triaxial.shear.4rank`` held to its plain reference
on the CPU.

The cell's own files (its entry in BENCHMARK.json, ``configs/``, the
``shear`` traffic, the ``compressed_lattice`` start, the
``triaxial_slabs`` builder and ``harness/ranks.py``) run the sheared cell
at n = 1,000 as 4 slabs on 4 gloo ranks, each rank a spawned process,
from seeded random starts. The ranks' judged step (0, 1) is merged
(``harness/snapshot.merge``) and the plain float64 reference
(``benchmark/reference/step.run``) redoes it: every number is within the
cell's committed limits (``benchmark/limits/triaxial.shear.4rank.json``),
``seam_err`` (the forces on particles with a partner owned by another
rank) and ``missing_pairs`` = 0 among them, with the system's guards at
0. With the planted fault ``no_exchange`` (ghosts never refreshed from
their owners) the same run fails a limit.

    python -m pytest tests/test_torch_bench_slabs.py --noconftest -q
"""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell, ranks  # noqa: E402
from benchmark.tests import faults  # noqa: E402

CELL = "triaxial.shear.4rank"
SEEDS = (2 ** 33 + 101, 2 ** 31 + 4099)


def _judged(seed, fault=None):
    """The cell at n = 1,000 on 4 gloo ranks: (checks, details) of
    ``cell.judge`` (each check (reading, limit))."""
    spec = cell.spec_of(CELL, {"n": 1000}, {"block_steps": 10})
    assert spec["cell"]["chips"] == 4 and spec["cfg"]["shards"] == 4
    spec["fault"] = fault
    res = ranks.run_ranks(spec, seed, 0.1, False, time.time(), device="cpu",
                          worker=faults.fault_worker if fault
                          else ranks.rank_worker)
    return cell.judge(spec, res, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_four_rank_step_is_within_the_cells_limits(seed):
    checks, details = _judged(seed)
    limits = cell.load_json(ROOT / "benchmark" / "limits" / f"{CELL}.json")
    assert set(limits) <= set(checks)
    assert {"seam_err", "missing_pairs", "overflow", "skin_violations",
            "kernels_unlaunched"} <= set(checks)
    over = {k: v for k, v in checks.items() if not v[0] <= v[1]}
    assert not over, over
    assert checks["missing_pairs"][0] == 0
    (step,) = details["steps"]
    assert step["judged"] == [0, 1] and step["contacts"] > 0
    assert step["numbers"]["seam_err"] > 0  # the seam holds contacts


def test_no_exchange_fails_a_limit():
    checks, _ = _judged(SEEDS[0], fault="no_exchange")
    failing = [k for k, (v, lim) in checks.items() if v > lim]
    assert failing, checks
