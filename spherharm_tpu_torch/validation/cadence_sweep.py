"""One-setup rebuild-cadence sweep of the main-path drum (the port's copy
of the reference harness ``scripts/cadence_sweep.py``).

Builds the n = 100k drum once (conservative law, prefilter: pair cap 5n,
stage-2 cap 3n, cadence R = 20), warms it up for 60 steps, then measures,
sharing shapes, params, grid and walls across Simulation configurations:

1. the rebuild step against the plain step: one replay each of the graph
   units ``always`` and ``never`` (``Simulation.run_units``) from the
   warm state, timed between CUDA events, and a block of R replays (one
   rebuild, R - 1 plain) the same way: the reference's
   ``_run_cadence_jit(r=1)`` against ``r=20``;
2. particle-steps/s at each cadence R (0: the skin trigger), host clock
   ending in a synchronisation; skin violations and overflow recorded,
   and a row with either is void.

    python -m spherharm_tpu_torch.validation.cadence_sweep [--n 100000] \\
        [--lmax 8] [--r 20,40,80,0] [--steps 180] [--warm 60] [--reps 3] \\
        [--device cuda]

``--n``, ``--lmax`` and ``--r`` are the reference's SWEEP_N, SWEEP_LMAX and
SWEEP_R, with its defaults. Timings on the CPU are host times.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.models import scenarios
from spherharm_tpu_torch.validation.drift import device_name

WARM_STEPS = 60


def build(n=100_000, lmax=8, device="cuda"):
    """The drum as the reference's bench builds it. Returns (sim, state,
    neigh)."""
    return scenarios.rotating_drum(
        n=n, lmax=lmax, k_max=24, pair_capacity=5 * n,
        stage2_capacity=3 * n, rebuild_every=20, conservative=True,
        device=device)


def clone(sim0, rebuild_every):
    """``sim0``'s configuration at another cadence (shapes, params, grid
    and walls shared)."""
    return Simulation(
        sim0.shapes, sim0.params, neighbor_mode="cell", grid=sim0.grid,
        k_max=sim0.k_max, cell_cap=sim0.cell_cap, walls=sim0.walls,
        pair_capacity=sim0.pair_capacity, rebuild_every=rebuild_every,
        wall_capacity=sim0.wall_capacity,
        stage2_capacity=sim0.stage2_capacity, conservative=True,
        device=sim0.device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def unit_ms(sim, state, neigh, kinds, reps=3):
    """Mean ms of ``sim.run_units(state, neigh, kinds)`` (the graph units
    ``kinds`` replayed in order from (state, neigh)), after one call that
    captures them: timed between CUDA events around the replays alone.
    On the CPU (no graphs) the same units run eagerly, timed by the host
    clock."""
    dev = state.x.device
    sim.run_units(state, neigh, kinds)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            sim.run_units(state, neigh, kinds)
        return 1e3 * (time.perf_counter() - t0) / reps
    total = 0.0
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sim.run_units(state, neigh, kinds, events=(start, stop))
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def block_decomposition(sim, state, neigh, reps=3, out=print):
    """Part 1: the rebuild step, the plain step and a block of R steps
    (one rebuild, R - 1 plain) from the warm state, ms each (the mean of
    ``reps``)."""
    R = sim.rebuild_every
    kinds = {"rebuild step": ("always",), "plain step": ("never",),
             f"block of {R}": ("always",) + ("never",) * (R - 1)}
    rows = {name: unit_ms(sim, state, neigh, k, reps)
            for name, k in kinds.items()}
    for name, ms in rows.items():
        out(f"# {name:>13s}: {ms:8.3f} ms")
    out(f"# amortised rebuild: {(rows['rebuild step'] - rows['plain step']) / R:.3f}"
        f" ms a step at R={R}")
    return rows


def sweep_row(sim0, state, r, n_steps, out=print):
    """Part 2, one cadence: a Simulation at rebuild_every = r from the warm
    state, one block (3r steps; 60 for the trigger) to capture its graphs,
    then blocks until ``n_steps``, timed by the host clock. Returns the
    row: ms a step, particle-steps/s, overflow, skin violations, void."""
    sim = clone(sim0, r)
    st, ng = sim.init_neighbors(state)
    ng = ng.replace(skin_violations=torch.zeros_like(ng.skin_violations))
    block = 3 * r if r > 0 else 60
    t0 = time.perf_counter()
    st, ng = sim.run(st, ng, block)
    _sync(sim.device)
    out(f"#   R={r}: capture+{block} {time.perf_counter() - t0:.1f}s")
    done = 0
    t0 = time.perf_counter()
    while done < n_steps:
        st, ng = sim.run(st, ng, block)
        done += block
    _sync(sim.device)
    wall = time.perf_counter() - t0
    n = int(st.n_active)
    row = dict(r=r, steps=done, ms=1e3 * wall / done, rate=n * done / wall,
               overflow=int(ng.overflow),
               skin_violations=int(ng.skin_violations))
    row["void"] = bool(row["overflow"] or row["skin_violations"])
    out(f"R={r:>2d}  {row['ms']:7.1f} ms/step  {row['rate']:,.0f} ps/s  "
        f"overflow={row['overflow']} skin_viol={row['skin_violations']}"
        + ("  VOID" if row["void"] else ""))
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--lmax", type=int, default=8)
    ap.add_argument("--r", default="20,40,80,0",
                    help="cadences, comma-separated (0: the skin trigger)")
    ap.add_argument("--steps", type=int, default=180,
                    help="timed steps a cadence (whole blocks)")
    ap.add_argument("--warm", type=int, default=WARM_STEPS,
                    help="warm-up steps before the measurements")
    ap.add_argument("--reps", type=int, default=3,
                    help="repetitions of each part-1 measurement")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rs = [int(r) for r in args.r.split(",")]
    pr = lambda s: print(s, flush=True)

    t0 = time.perf_counter()
    sim0, state0, neigh0 = build(args.n, args.lmax, args.device)
    pr(f"# setup {time.perf_counter() - t0:.1f}s n={args.n}")
    t0 = time.perf_counter()
    state, neigh = sim0.run(state0, neigh0, args.warm)
    _sync(sim0.device)
    pr(f"# warm start (capture+{args.warm}) {time.perf_counter() - t0:.1f}s")
    block_decomposition(sim0, state, neigh, args.reps, out=pr)
    rows = [sweep_row(sim0, state, r, args.steps, out=pr) for r in rs]
    pr(f"# RESULT ({device_name(sim0.device)}): " + ", ".join(
        f"R={w['r']} {w['rate']:,.0f} ps/s" + (" (void)" if w["void"] else "")
        for w in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
