"""The benchmark's own tests: its cells at a tiny size on the CPU (the
kernels' plain twins) through the same files as on the card, the
planted faults and the control, the import rules, the names in
BENCHMARK.json and the roofline's counts.

    python -m pytest benchmark/tests -q        # here (~3 min)
    python -m pytest benchmark/tests -q -m cuda   # on the card
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell, window  # noqa: E402
from benchmark.roofline import pair_law  # noqa: E402
from benchmark.tests import faults  # noqa: E402

SEED = 2 ** 33 + 12345
# Small systems the CPU twins step in seconds: the drum's bed at n = 300,
# the sheared cell at n = 512 (3 grid cells an axis), its slabs at
# n = 1,000 (a slab wider than the halo).
TINY = {"drum.bed": ({"n": 300}, {"warmup_steps": 20, "block_steps": 20}),
        "triaxial.shear": ({"n": 512}, {"block_steps": 10}),
        "triaxial.shear.4rank": ({"n": 1000}, {"block_steps": 10})}


def four_ranks():
    """BENCHMARK.json with the sheared cell as 4 slabs, one a rank (its
    configuration file is the benchmark's; the cell is not measured yet),
    and its limits: the sheared cell's, with the seam's."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "triaxial_n100k_l4_4rank",
                             "file": "benchmark/configs/triaxial_n100k_l4_4rank.json"})
    bench["workloads"].append({"name": "triaxial.shear.4rank",
                               "config": "triaxial_n100k_l4_4rank",
                               "traffic": "shear", "chips": 4})
    limits = json.loads((BENCH / "limits" / "triaxial.shear.json").read_text())
    limits["seam_err"] = limits["force_err"]
    return dict(bench=bench, limits=limits)


def run_tiny(workload, trace=False, fault=None, monkeypatch=None):
    overrides, traffic = TINY[workload]
    sharded = workload.endswith("4rank")
    spec = cell.spec_of(workload, overrides, traffic,
                        **(four_ranks() if sharded else {}))
    t0 = time.time()
    if sharded:
        from benchmark.harness import ranks

        spec["fault"] = fault
        res = ranks.run_ranks(spec, SEED, 0.1, trace, t0, device="cpu",
                              worker=faults.fault_worker if fault
                              else ranks.rank_worker)
    else:
        if fault:
            faults.apply(fault, monkeypatch.setattr)
        res = cell.run_single(spec, SEED, 0.1, trace, "cpu", t0)
    checks, details = cell.judge(spec, res, "cpu")
    return spec, res, checks, details


@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_at_tiny_size_is_correct(workload, capsys):
    spec, res, checks, details = run_tiny(workload)
    line = cell.report(spec, res, checks, details, False, "cpu")
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out) == json.loads(json.dumps(line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    # The reference was reached, once a judged step, and found the
    # contacts it judged.
    judged = spec["traffic"]["judged"]
    assert [d["judged"] for d in details["steps"]] == judged
    assert all(d["contacts"] > 0 for d in details["steps"])
    assert details["reference_s"] > 0
    assert {"force_err", "missing_pairs", "spring_err", "x_err", "q_err",
            "v_err", "L_err"} <= set(line["checks"])
    ev0, ev1 = res["evidence"]
    assert ev0["live_rows"] > 0 and ev0["pe_pair"] > 0 and ev1["pe_pair"] > 0


def test_traced_run_reports_per_layer_metrics(capsys):
    spec, res, checks, details = run_tiny("triaxial.shear", trace=True)
    line = cell.report(spec, res, checks, details, True, "cpu")
    assert line["correct"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
    # The CPU has no device trace: only the counter reads.
    assert set(line["metrics"]) <= {"steps_per_rebuild"}


@pytest.mark.parametrize("workload,fault", [
    ("drum.bed", "unchanged"), ("drum.bed", "half_batch"),
    ("drum.bed", "altered"), ("drum.bed", "bf16"),
    ("drum.bed", "no_second_kick"), ("drum.bed", "plain_step_forgets_springs"),
    ("triaxial.shear", "unchanged"), ("triaxial.shear", "half_batch"),
    ("triaxial.shear", "altered"), ("triaxial.shear", "bf16"),
    ("triaxial.shear", "no_second_kick"),
    ("triaxial.shear.4rank", "no_exchange"),
    ("triaxial.shear.4rank", "half_batch")])
def test_fault_makes_the_run_incorrect(workload, fault, monkeypatch):
    spec, res, checks, details = run_tiny(workload, fault=fault,
                                          monkeypatch=monkeypatch)
    failing = [k for k, (v, lim) in checks.items() if v > lim]
    assert failing, checks


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "spherharm_tpu"}
    for path in BENCH.rglob("*.py"):
        found = set(_imports(path)) & banned
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert "spherharm_tpu_torch" not in names, path
        assert names <= {"__future__", "dataclasses", "math", "numpy",
                         "scipy", "torch", "benchmark"}, (path, names)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units_use_the_allowed_characters():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [c["name"] for c in bench["configs"]]
    names += [w[k] for w in bench["workloads"] for k in ("name", "config",
                                                          "traffic")]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:
        assert (BENCH / "limits" / f"{w['name']}.json").exists()
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (BENCH / "starts" / f"{traffic['start']}.py").exists()
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (BENCH / "builders" / f"{cfg['builder']}.py").exists()


def test_roofline_counts_match_a_count_by_hand():
    # Degree 2: 9 coefficients; r and its two derivatives 3 x 9 multiply-
    # adds, 54 operations a surface; a node side two surfaces + 90.
    assert pair_law.surface_ops(2) == 54
    assert pair_law.ops_per_node(2, conservative=False) == 2 * 54 + 90
    assert pair_law.ops_per_node(2, conservative=True) == 2 * 54 + 90 + 60
    ops, nbytes = pair_law.work(10, 2, 4, False, 1, 1)
    assert ops == 10 * 4 * 2 * 198
    assert nbytes == 10 * 216 + 4 * (9 + 16)
    ops8, _ = pair_law.work(1000, 8, 128, True, 4, 20)
    assert ops8 == 1000 * 128 * 2 * (2 * 6 * 81 + 90 + 60)


def test_law_rows_counts_pairs_whose_spheres_overlap():
    # Four particles on a line, bounding radii 0.6, 0.6, 0.5, 0.5: rows
    # (0,1) at 1.0 < 1.2 and (2,3) at 0.9 < 1.0 need the law; (1,2) at
    # 1.2 > 1.1 and (0,2) do not; a dead row never counts, nor a row with
    # an inactive particle.
    x = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [2.2, 0, 0], [3.1, 0, 0]])
    kept = dict(x=x, shtype=torch.tensor([0, 0, 1, 1]), scale=torch.ones(4),
                active=torch.tensor([True, True, True, True]),
                pair_i=torch.tensor([0, 1, 2, 0, 3]),
                pair_j=torch.tensor([1, 2, 3, 2, 3]),
                pair_valid=torch.tensor([True, True, True, True, False]),
                box=(torch.zeros(3), torch.full((3,), 10.0), torch.zeros(3)),
                shard=False)
    rb = torch.tensor([0.6, 0.5], dtype=torch.float64)
    assert window.law_rows(kept, rb, (False,) * 3) == 2
    kept["active"] = torch.tensor([True, True, True, False])
    assert window.law_rows(kept, rb, (False,) * 3) == 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")


@pytest.mark.cuda
def test_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "triaxial.shear",
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
