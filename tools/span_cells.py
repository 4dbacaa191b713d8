"""The spans of the benchmark's cells, read the way
``spherharm_tpu_torch/validation/profile_step.py`` reads the drum's.

Each cell of ``BENCHMARK.json`` is built and warmed up as
``benchmark/harness/cell.measure`` does it (its configuration, traffic
and start, from ``--seed``), its window runs for ``--seconds``, and then,
``--reps`` times in turn from the carry the window left, two slices of
the traffic's ``trace_steps`` steps: the benchmark's own profiled slice
(spans off, ``benchmark/harness/trace.profiled``) and a span slice
(``utils/timing.span_profile``: spans on, after one unprofiled run that
captures the spans-on graphs). A run leaves its input as it was, so each
slice starts from the same state. Spans are off in the window.

One JSON line a cell: ``plain_ms_per_step`` and ``span_ms_per_step`` (each
slice's length over its steps) and ``spans_cost_pct`` (their medians'
difference), ``metrics`` (``timing.span_metrics`` of each span slice),
``evidence_live_pct`` (live rows of the pair list over its slots at the
slice's two ends, the mean of the two), ``coverage``, and from the last
span slice, in ms a step: ``span_ms`` and ``self_ms`` by span,
``rebuild_stage_ms`` (ms a rebuild), ``top_ops_ms`` (each span's largest
operations by self time), ``idle_ms`` and ``idle_inner_ms`` (idle time by
what the device waited for, ``timing.reduce_spans``), with ``spans_n``,
``marks``, ``unmatched`` and ``clipped``.

    python3 tools/span_cells.py [drum.bed triaxial.shear] [--seed N] \\
        [--seconds 20] [--reps 3] [--device cuda]

Needs the card for device times; on the CPU the spans are host ranges.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import cell, inputs, program, trace, window  # noqa: E402
from benchmark.starts import make_start  # noqa: E402
from spherharm_tpu_torch.utils import timing  # noqa: E402

TOP_OPS = 4


def live_pct(carry) -> float:
    """Live rows of the pair list (valid, both ends active) over its
    slots, in %."""
    state, neigh = carry[0], carry[1]
    ok = neigh.pair_valid & state.active[neigh.pair_i] & state.active[neigh.pair_j]
    return 100.0 * int(ok.sum()) / neigh.pair_valid.shape[-1]


def per_step(d: dict, steps: int, scale: float = 1e3) -> dict:
    return {k: round(scale * v / steps, 4) for k, v in d.items()}


def cell_spans(workload, seed, seconds, reps, device, overrides=None,
               traffic_overrides=None) -> dict:
    """The spans of one cell (see the module docstring)."""
    spec = cell.spec_of(workload, overrides, traffic_overrides)
    cfg, traffic = spec["cfg"], spec["traffic"]
    cuda = torch.device(device).type == "cuda"
    geo = inputs.deployment(cfg)
    start = make_start(cfg, geo, traffic, seed, device)
    sim = program.build(cfg, geo, device)
    win = window.Window(sim, program.initialise(
        sim, program.start_state(start, device)), cuda)
    win.step(traffic["warmup_steps"])
    win.sync()
    t0 = time.perf_counter()
    window_steps, _ = win.run(seconds, traffic["block_steps"])
    window_s = time.perf_counter() - t0
    carry, steps = win.carry, traffic["trace_steps"]
    plain, spanned, metrics, end = [], [], [], None
    for _ in range(reps):
        _, sl = trace.profiled(lambda: sim.run(*carry, steps))
        plain.append(1e3 * sl["window_s"] / steps)
        end, summary = timing.span_profile(lambda: sim.run(*carry, steps))
        spanned.append(1e3 * summary["window_s"] / steps)
        metrics.append(timing.span_metrics(summary, steps))
    t, self_t, n, clock = timing.span_times(summary)
    rebuilds = n.get("rebuild", 0)
    return dict(
        workload=workload, seed=seed, clock=clock,
        card=torch.cuda.get_device_name(0) if cuda else "cpu",
        window_steps=window_steps, window_s=window_s,
        rate=cfg["n"] * window_steps / window_s, steps=steps,
        plain_ms_per_step=plain, span_ms_per_step=spanned,
        spans_cost_pct=100.0 * (statistics.median(spanned)
                                / statistics.median(plain) - 1.0),
        plain_busy_pct=100.0 * sl["busy_s"] / sl["window_s"],
        metrics=metrics,
        evidence_live_pct=0.5 * (live_pct(carry) + live_pct(end)),
        coverage=summary["coverage"], spans_n=n,
        marks=summary["marks"], unmatched=summary["unmatched"],
        clipped=summary["clipped"],
        span_ms=per_step(t, steps),
        self_ms=per_step(self_t, steps) if self_t is not None else None,
        rebuild_stage_ms=(per_step({k: v for k, v in t.items()
                                    if k.startswith("rebuild")}, rebuilds)
                          if rebuilds else {}),
        top_ops_ms={name or "none": per_step(dict(sorted(
            ops.items(), key=lambda p: -p[1])[:TOP_OPS]), steps)
            for name, ops in summary["self_ops"].items()},
        idle_ms=per_step(summary["idle_s"], steps),
        idle_inner_ms=per_step(summary["idle_inner_s"], steps),
        busy_ms=1e3 * summary["busy_s"] / steps,
        counters=summary["counters"])


def main(argv=None):
    bench = cell.load_json(ROOT / "BENCHMARK.json")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workloads", nargs="*",
                    default=[w["name"] for w in bench["workloads"]
                             if w["chips"] == 1])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 19)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for k, name in enumerate(args.workloads):
        res = cell_spans(name, args.seed + k, args.seconds, args.reps,
                         args.device)
        print(json.dumps(res), flush=True)
        if args.device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
