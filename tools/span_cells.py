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
slice's two ends, the mean of the two), ``indexed_pct`` (the slots whose
row the pair kernel gathered itself, ``pair.indexed``, over the slots,
``pair.slots``, in %), ``reduce_read_pct`` (the slots the pair reduction
read, ``pair.reduce_rows``: the lists' live prefixes, over ``pair.slots``,
in %; 0 where the plain twin sums every slot), ``coverage``, and from the last
span slice, in ms a step: ``span_ms`` and ``self_ms`` by span,
``group_ms`` (time in any span of a group: ``halo``, ``comm``, ...),
``rebuild_stage_ms`` (ms a rebuild), ``top_ops_ms`` (each span's largest
operations by self time), ``idle_ms`` and ``idle_inner_ms`` (idle time by
what the device waited for, ``timing.reduce_spans``), with ``spans_n``,
``marks``, ``unmatched`` and ``clipped``.

A sharded cell (its configuration has ``shards``) runs one rank a card
through the program's ``parallel/ranks.spawn_ranks`` (NCCL; gloo on the
CPU), each rank as ``benchmark/harness/ranks.py`` runs it: the window's
blocks stop together, and every slice runs on every rank at once. Its
line holds each rank's numbers above under ``ranks`` and, at the top
level, those of the slowest rank (the most device time a step in its
last span slice; ``slowest`` its rank) with ``halo_ms_per_step``,
``comm_ms_per_step`` and ``ghost_pct`` of that slice
(``timing.span_metrics``).

    python3 tools/span_cells.py [drum.bed triaxial.shear ...] [--seed N] \\
        [--seconds 20] [--reps 3] [--device cuda]

The cells default to those of ``BENCHMARK.json`` this machine has the
cards for. Needs the card for device times; on the CPU the spans are host
ranges.
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
    slots, in %; a shard's rows index its owned rows, then its ghosts."""
    state, neigh = carry[0], carry[1]
    active = state.active
    if len(carry) == 3:
        active = torch.cat([active, carry[2].active], dim=-1)[0]
        neigh = neigh.replace(**{k: getattr(neigh, k)[0] for k in (
            "pair_i", "pair_j", "pair_valid")})
    ok = neigh.pair_valid & active[neigh.pair_i] & active[neigh.pair_j]
    return 100.0 * int(ok.sum()) / neigh.pair_valid.shape[-1]


def per_step(d: dict, steps: int, scale: float = 1e3) -> dict:
    return {k: round(scale * v / steps, 4) for k, v in d.items()}


def cell_spans(workload, seed, seconds, reps, device, overrides=None,
               traffic_overrides=None) -> dict:
    """The spans of one cell (see the module docstring)."""
    spec = cell.spec_of(workload, overrides, traffic_overrides)
    if spec["cfg"].get("shards"):
        return rank_cell_spans(spec, workload, seed, seconds, reps, device)
    return _spans(spec, workload, seed, seconds, reps, device)


def rank_cell_spans(spec, workload, seed, seconds, reps, device) -> dict:
    """A sharded cell's spans: ``_spans`` on each rank, one a card."""
    from spherharm_tpu_torch.parallel.ranks import spawn_ranks

    S = spec["cfg"]["shards"]
    cuda = torch.device(device).type == "cuda"
    out = spawn_ranks(rank_spans, S, "nccl" if cuda else "gloo",
                      [f"cuda:{r}" for r in range(S)] if cuda else ["cpu"] * S,
                      spec, workload, seed, seconds, reps,
                      timeout=spec["traffic"]["rank_timeout_s"] + 60 * reps)
    slowest = max(range(S), key=lambda r: out[r]["busy_ms"])
    top = dict(out[slowest], slowest=slowest, ranks=out)
    top.update({k: top["metrics"][-1][k] for k in (
        "halo_ms_per_step", "comm_ms_per_step", "ghost_pct")})
    return top


def rank_spans(axis, spec, workload, seed, seconds, reps) -> dict:
    """One rank's part of ``rank_cell_spans``: the window's blocks stop
    together (an all-reduce of the ranks' clocks, as the benchmark's
    ranks stop)."""
    import torch.distributed as dist

    dev = axis.device

    def stop(done):
        flag = torch.tensor([float(done)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    res = _spans(spec, workload, seed, seconds, reps, dev, axis, stop)
    res["rank"] = axis.rank
    return res


def _spans(spec, workload, seed, seconds, reps, device, axis=None,
           stop=None) -> dict:
    cfg, traffic = spec["cfg"], spec["traffic"]
    cuda = torch.device(device).type == "cuda"
    geo = inputs.deployment(cfg)
    start = make_start(cfg, geo, traffic, seed, device)
    sim = program.build(cfg, geo, device, axis=axis)
    win = window.Window(sim, program.initialise(
        sim, program.start_state(start, device)), cuda)
    win.step(traffic["warmup_steps"])
    win.sync()
    t0 = time.perf_counter()
    window_steps, _ = win.run(seconds, traffic["block_steps"], stop)
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
    share = lambda name: (100.0 * summary["counters"].get(name, 0)
                          / summary["counters"]["pair.slots"]
                          if summary["counters"].get("pair.slots") else None)
    return dict(
        workload=workload, seed=seed, clock=clock,
        card=torch.cuda.get_device_name(device) if cuda else "cpu",
        window_steps=window_steps, window_s=window_s,
        rate=cfg["n"] * window_steps / window_s, steps=steps,
        plain_ms_per_step=plain, span_ms_per_step=spanned,
        spans_cost_pct=100.0 * (statistics.median(spanned)
                                / statistics.median(plain) - 1.0),
        plain_busy_pct=100.0 * sl["busy_s"] / sl["window_s"],
        metrics=metrics,
        evidence_live_pct=0.5 * (live_pct(carry) + live_pct(end)),
        indexed_pct=share("pair.indexed"),
        reduce_read_pct=share("pair.reduce_rows"),
        coverage=summary["coverage"], spans_n=n,
        marks=summary["marks"], unmatched=summary["unmatched"],
        clipped=summary["clipped"],
        span_ms=per_step(t, steps),
        self_ms=per_step(self_t, steps) if self_t is not None else None,
        group_ms=per_step(summary["group_s" if clock == "device"
                                  else "host_group_s"], steps),
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
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    ap.add_argument("workloads", nargs="*",
                    default=[w["name"] for w in bench["workloads"]
                             if w["chips"] <= max(cards, 1)])
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
