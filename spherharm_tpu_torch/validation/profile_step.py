"""Per-span time of the drum's step (the port's copy of the reference
harness ``scripts/profile_step.py``), read from the step's own spans.

After ``--settle`` steps of ``Simulation.run``, runs ``--reps`` cadence
blocks (``rebuild_every`` steps each) of ``Simulation.run`` with spans on
under ``torch.profiler`` (``utils/timing.span_profile``: one unprofiled
run first captures the spans-on graphs) and prints:

* each span of ``utils/spans.SPANS`` (the stages of ``rebuild`` and
  ``pair`` indented under them) in ms a step: its device time, and its
  self time (in no span inside it);
* the rebuild and its stages in ms a rebuild;
* the device time in no span, the marks' time, each span's largest
  operation, and the idle time by what the device waited for: the
  innermost ``spherharm.*`` host range over the launch of the operation
  after the gap (``spherharm.replay.<unit>``: a graph launch), or a gap
  inside one launch (``timing.reduce_spans``);
* the counters and ``timing.span_metrics`` (the live share of the pair
  list, ``pack_ms_per_step``, ``rebuild_ms``, ``trigger_idle_ms_per_step``).

The replays are the step as the benchmark runs it, so no time here is
the host's launch time. On the CPU the spans are host ranges and the times
are the host's.

    python -m spherharm_tpu_torch.validation.profile_step [n] [lmax] \\
        [--stage2 3n] [--pair-cap 5n] [--cons 1] [--settle 100] [--reps 5] \\
        [--device cuda]

``--stage2``, ``--pair-cap`` and ``--cons`` are the reference's PROF_STAGE2,
PROF_PAIR_CAP and PROF_CONS, with its defaults.
"""

from __future__ import annotations

import argparse
import sys

from spherharm_tpu_torch.models import scenarios
from spherharm_tpu_torch.utils import spans, timing
from spherharm_tpu_torch.validation.drift import device_name

STAGES = spans.SPANS


def build(n=100_000, lmax=8, stage2=None, pair_cap=None, cons=True,
          device="cuda"):
    """The drum at the bench's capacities (stage-2 cap 3n, candidate cap
    5n by default), cadence 20. Returns (sim, state, neigh)."""
    return scenarios.rotating_drum(
        n=n, lmax=lmax, k_max=24, rebuild_every=20,
        stage2_capacity=3 * n if stage2 is None else stage2,
        conservative=cons,
        pair_capacity=5 * n if pair_cap is None else pair_cap,
        device=device)


def label(name: str) -> str:
    """A span's name, indented under its parent span."""
    parent = name.rsplit(".", 1)[0]
    return f"  {name}" if parent != name and parent in STAGES else name


def print_profile(summary, steps: int, out=print) -> dict:
    """Prints a ``span_profile`` of ``steps`` steps (see the module
    docstring). Returns {span: ms a step}."""
    t, self_t, n, clock = timing.span_times(summary)
    out(f"# {clock} ms a step over {steps} steps (self: in no span inside)")
    ms = {name: 1e3 * t.get(name, 0.0) / steps for name in STAGES}
    for name in STAGES:
        own = ("" if self_t is None
               else f"   self {1e3 * self_t.get(name, 0.0) / steps:8.3f}")
        out(f"{label(name):<22}{ms[name]:8.3f} ms{own}   x{n.get(name, 0)}")
    if n.get("rebuild"):
        out(f"# a rebuild ({n['rebuild']} in the profile): " + ", ".join(
            f"{name} {1e3 * t.get(name, 0.0) / n['rebuild']:.3f} ms"
            for name in STAGES if name.startswith("rebuild")))
    if summary["ops_s"] > 0:
        out(f"# in no span {1e3 * summary['outside_s'] / steps:.4f} ms a "
            f"step (coverage {100 * summary['coverage']:.2f} %); marks "
            f"{summary['marks']} ({1e3 * summary['marks_s'] / steps:.4f} ms "
            f"a step), unmatched {summary['unmatched']}, outside the window "
            f"{summary['clipped']}")
        out("# largest operation a span (ms a step): " + ", ".join(
            f"{name or 'none'}: {op[:40]} {1e3 * sec / steps:.3f}"
            for name, ops in summary["self_ops"].items()
            for op, sec in [max(ops.items(), key=lambda p: p[1])]))
        out(f"# busy {summary['busy_s']:.4f} s of {summary['window_s']:.4f}"
            " s; idle by what the device waited for (ms a step): " + ", ".join(
                f"{k or 'none'} {1e3 * v / steps:.4f}" for k, v in sorted(
                    summary["idle_inner_s"].items(), key=lambda p: -p[1])))
    out(f"# counters: {summary['counters']}")
    out("# " + ", ".join(
        f"{k} {'-' if v is None else f'{v:.4f}'}"
        for k, v in timing.span_metrics(summary, steps).items()))
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("lmax", type=int, nargs="?", default=8)
    ap.add_argument("--stage2", type=int, default=None,
                    help="stage-2 (pair-list) capacity, default 3n")
    ap.add_argument("--pair-cap", type=int, default=None,
                    help="candidate capacity, default 5n")
    ap.add_argument("--cons", type=int, choices=(0, 1), default=1)
    ap.add_argument("--settle", type=int, default=100,
                    help="steps run before the profile")
    ap.add_argument("--reps", type=int, default=5,
                    help="cadence blocks profiled")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    pr = lambda s: print(s, flush=True)
    sim, state, neigh = build(args.n, args.lmax, args.stage2, args.pair_cap,
                              bool(args.cons), args.device)
    pr(f"# n={args.n} lmax={args.lmax} cand_cap={sim.pair_capacity} "
       f"pair_list_cap={sim.pair_list_cap} conservative={sim.conservative}")
    state, neigh = sim.run(state, neigh, args.settle)
    pr(f"# overflow={int(neigh.overflow)} "
       f"live_pairs={int(neigh.pair_valid.sum())}/{sim.pair_list_cap}")
    steps = args.reps * max(sim.rebuild_every, 1)
    _, summary = timing.span_profile(lambda: sim.run(state, neigh, steps))
    ms = print_profile(summary, steps, out=pr)
    pr(f"# RESULT ({device_name(sim.device)}): " + ", ".join(
        f"{k} {ms[k]:.3f} ms" for k in STAGES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
