"""One run of one cell: set-up, the window, the traced slice, the judged
steps, the judgement against the reference and the result line.

A cell is an entry of ``workloads`` in BENCHMARK.json. Its configuration
is ``configs/<config>.json`` (which names its builder,
``builders/<builder>.py``), its traffic ``traffic/<traffic>.json``
(which names its start, ``starts/<start>.py``, and the steps judged),
its limits ``limits/<cell>.json``, and each per-layer metric a reader
``metrics/<metric>.py``: everything is found by name.
"""

from __future__ import annotations

import importlib
import json
import math
import sys
import time
from pathlib import Path

import torch

from benchmark.harness import inputs, program, snapshot, window
from benchmark.reference import step as ref_step
from benchmark.starts import make_start

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "spherharm_tpu")
GIB = float(1 << 30)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def spec_of(workload: str, overrides: dict | None = None,
            traffic_overrides: dict | None = None, bench: dict | None = None,
            limits: dict | None = None) -> dict:
    """The cell's entry, configuration, traffic and limits, from
    BENCHMARK.json or ``bench`` (``overrides`` and ``traffic_overrides``
    replace keys, ``limits`` the limits file: the CPU tests' small
    sizes)."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / cfg_entry["file"])
    cfg.update(overrides or {})
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    traffic.update(traffic_overrides or {})
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return dict(cell=cell, cfg=cfg, traffic=traffic,
                limits=limits or load_json(BENCH / "limits" / f"{workload}.json"),
                per_layer=per_layer,
                end_to_end=[m for m in bench["end_to_end"]
                            if workload in m.get("workloads", [workload])])


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def evidence(sim, carry) -> dict:
    """Live rows of the pair list and pe_pair (the bed is in contact); on
    ranks summed over the shards."""
    th = program.thermo(sim, carry)
    neigh = carry[1]
    live = neigh.pair_valid.sum(-1)
    axis = getattr(sim, "axis", None)
    live = axis.psum(live) if axis is not None else live
    return dict(live_rows=int(live), pe_pair=float(th["pe_pair"]),
                etot=float(th["etot"]),
                overflow=int(th["neigh_overflow"].max()),
                k_used=int(neigh.mask.sum(-1).max()))


def guards(cfg, carry, counts, ev_end) -> dict:
    """The system's own guarantees as checks of limit 0. The kernels'
    launches are counted on the card only (the CPU runs their twins)."""
    neigh = carry[1]
    on_card = neigh.overflow.is_cuda
    missing = [k for k in cfg["kernels"] if on_card and counts.get(k, 0) <= 0]
    if missing:
        print(f"kernels not launched in the window: {missing}", file=sys.stderr)
    return {"overflow": (int(neigh.overflow.max()), 0),
            "skin_violations": (int(neigh.skin_violations.max()), 0),
            "nonfinite_etot": (int(not math.isfinite(ev_end["etot"])), 0),
            "kernels_unlaunched": (len(missing), 0)}


def measure(spec, seed, seconds, trace, device, t_process, axis=None,
            stop=None, barrier=None) -> dict:
    """Set-up, the window (between ``barrier()`` calls where given; the
    blocks stop when ``stop(done)`` says so), the traced slice and the
    judged steps, in this process: one card's run, or one rank's part."""
    cfg, traffic = spec["cfg"], spec["traffic"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    parts = {"interpreter_imports_cuda_s": time.time() - t_process}
    t = time.time()
    geo = inputs.deployment(cfg)
    start = make_start(cfg, geo, traffic, seed, device)
    parts["inputs_s"] = time.time() - t
    t = time.time()
    sim = program.build(cfg, geo, device, axis=axis)
    win = window.Window(sim, program.initialise(
        sim, program.start_state(start, device)), cuda)
    parts["build_init_s"] = time.time() - t
    t = time.time()
    win.step(traffic["warmup_steps"])
    win.sync()
    parts["warmup_s"] = time.time() - t
    parts["capture_s"] = sim.graph_stats()["capture_s"] if cuda else 0.0
    t = time.time()
    ev0 = evidence(sim, win.carry)
    counts0, rebuilds0 = program.launch_counts(), window.rebuild_replays(sim)
    parts["evidence_s"] = time.time() - t
    if barrier:
        barrier()
    t_window = time.time()
    budget = max(seconds - traffic["trace_reserve_s"], 0.0) if trace else seconds
    steps, elapsed = win.run(budget, traffic["block_steps"], stop)
    slices, pair_steps, slice_steps = [], 0, 0
    if trace:
        sl, pair_steps = win.traced_slice(
            traffic["trace_steps"], geo["ref_shapes"].rmax, geo["periodic"])
        slices, slice_steps = [sl], traffic["trace_steps"]
        steps += slice_steps
    if barrier:
        win.sync()
        barrier()
        elapsed = time.time() - t_window
    counts = {k: v - counts0.get(k, 0)
              for k, v in program.launch_counts().items()}
    rebuilds = window.rebuild_replays(sim) - rebuilds0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ev1 = evidence(sim, win.carry)
    checks = guards(cfg, win.carry, counts, ev1)
    snaps = win.judged(traffic["judged"], snapshot.shard if axis is not None
                       else snapshot.single)
    del sim, win
    if cuda:
        torch.cuda.empty_cache()
    return dict(setup_s=t_window - t_process, t_window=t_window,
                setup_parts=parts, steps=steps, elapsed=elapsed, n=cfg["n"],
                peak=peak, counts=counts, rebuilds=rebuilds, slices=slices,
                slice_steps=slice_steps, pair_steps=pair_steps,
                evidence=[ev0, ev1], snaps=snaps, checks=checks, geo=geo)


def run_single(spec, seed: int, seconds: float, trace: bool, device,
               t_process: float) -> dict:
    res = measure(spec, seed, seconds, trace, device, t_process)
    res["chips"] = 1
    return res


def judge(spec, res, device) -> tuple[dict, dict]:
    """The reference's steps against the program's judged steps: (checks,
    details). A number's reading is its largest over the judged steps."""
    cfg, geo = spec["cfg"], res["geo"]
    shapes = geo["ref_shapes"]
    shapes = type(shapes)(**{k: (v.to(device) if torch.is_tensor(v) else v)
                             for k, v in vars(shapes).items()})
    t = time.time()
    readings, details = {}, {"steps": []}
    for (a, b), (before, after) in zip(spec["traffic"]["judged"], res["snaps"]):
        numbers, det = ref_step.run(
            shapes, inputs.reference_config(cfg, geo),
            snapshot.to(before, device), snapshot.to(after, device))
        det["judged"] = [a, b]
        det["numbers"] = numbers
        details["steps"].append(det)
        for name, value in numbers.items():
            readings[name] = max(value, readings.get(name, value))
    details["reference_s"] = time.time() - t
    checks = dict(res["checks"])
    for name, value in readings.items():
        checks[name] = (value, spec["limits"][name])
    return checks, details


def per_layer_metrics(spec, res) -> dict:
    cfg = spec["cfg"]
    ctx = dict(slices=res["slices"], steps=res["steps"],
               slice_steps=res["slice_steps"], rebuilds=res["rebuilds"],
               peaks=load_json(BENCH / "roofline" / "peaks.json"),
               law=dict(conservative=cfg["conservative"], lmax=cfg["lmax"],
                        nodes=int(res["geo"]["ref_shapes"].cap.shape[1]),
                        n_types=cfg["n_shape_types"],
                        pair_steps=res["pair_steps"]))
    out = {}
    for m in spec["per_layer"]:
        value = importlib.import_module(f"benchmark.metrics.{m['name']}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(slices) -> dict:
    ops = {}
    for s in slices:
        for name, sec in s["device_ops"].items():
            ops[name] = ops.get(name, 0.0) + sec / len(slices)
    gaps = sorted((g for s in slices for g in s["idle_gaps"]),
                  key=lambda g: -g[1])
    return {"device_ops": sorted(([n, v] for n, v in ops.items()),
                                 key=lambda p: -p[1])[:10],
            "idle_gaps": [[n, v] for n, v in gaps[:10]]}


def result_line(spec, res, checks, trace: bool, device) -> dict:
    correct = all(v <= lim for v, lim in checks.values())
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": res["chips"], "memory_peak_bytes": int(res["peak"])}
    if trace:
        metrics = per_layer_metrics(spec, res)
        dev["busy_s"] = sum(s["busy_s"] for s in res["slices"]) / len(res["slices"])
        dev["window_s"] = sum(s["window_s"] for s in res["slices"]) / len(res["slices"])
    else:
        metrics = {
            "particle_steps_per_s": {"value": res["n"] * res["steps"]
                                     / res["elapsed"], "unit": "particle-steps/s"},
            "peak_mem_gib": {"value": res["peak"] / GIB, "unit": "GiB"},
            "setup_s": {"value": res["setup_s"], "unit": "s"}}
    line = {"correct": correct, "attempted": res["steps"],
            "failed": 0 if correct else res["steps"], "metrics": metrics,
            "device": dev}
    if trace:
        line["breakdown"] = breakdown(res["slices"])
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in checks.items()}
    return line


def report(spec, res, checks, details, trace, device):
    """Prints the run's notes and checks on standard error, then the
    result line last on standard output."""
    ev0, ev1 = res["evidence"]
    print(json.dumps({"setup_parts": res["setup_parts"], "evidence_start": ev0,
                      "evidence_end": ev1, "steps": res["steps"],
                      "window_s": res["elapsed"], "rebuilds": res["rebuilds"],
                      "launches": res["counts"], "reference": details}),
          file=sys.stderr)
    line = result_line(spec, res, checks, trace, device)
    for name, (value, lim) in checks.items():
        print(f"check {name}: {value!r} (limit {lim!r})", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"modules of the JAX package loaded: {bad}", file=sys.stderr)
        raise SystemExit(3)
    sys.stdout.flush()
    print(json.dumps(line))
    return line
