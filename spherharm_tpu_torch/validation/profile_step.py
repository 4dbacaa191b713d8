"""Per-stage timing of the drum step (the port's copy of the reference
harness ``scripts/profile_step.py``).

After ``--settle`` steps of ``Simulation.run``, times on the live state,
each stage between CUDA events around ``--reps`` calls after a warm-up
call (``utils/timing.timeit``; never in a profiler window, which loses and
gains kernel records):

  step     - one plain step (a replay of the captured ``never`` unit)
  rows     - ``particle_rows`` pack
  forces   - ``contact_force_pairs`` as the step runs it
  pack     - the per-pair kernel input: row gathers, minimum image,
             ``pack_pairs``
  kernel   - the pair kernel over the (prefiltered) list
  rebuild  - the whole rebuild with the prefilter (every rebuild_every
             steps), then its pieces: cell_list, remap, pair_build,
             prefilter
  walls    - every wall's contact stage
  integ    - initial + final integrate

Every stage but ``step`` runs its ops eagerly, so a stage shorter than its
host issue time reads the issue time. The reference's ``step`` timed
``sim.run(state, neigh, 1)``, a rebuild step at cadence 20; here the
rebuild step's share is ``rebuild / rebuild_every`` in the budget line.

    python -m spherharm_tpu_torch.validation.profile_step [n] [lmax] \\
        [--stage2 3n] [--pair-cap 5n] [--cons 1] [--device cuda]

``--stage2``, ``--pair-cap`` and ``--cons`` are the reference's PROF_STAGE2,
PROF_PAIR_CAP and PROF_CONS, with its defaults.
"""

from __future__ import annotations

import argparse
import sys

import torch

from spherharm_tpu_torch.models import scenarios
from spherharm_tpu_torch.ops import contact, integrate, neighbor
from spherharm_tpu_torch.ops import contact_kernels as ck
from spherharm_tpu_torch.ops import walls as walls_mod
from spherharm_tpu_torch.utils.timing import timeit
from spherharm_tpu_torch.validation.cadence_sweep import unit_ms
from spherharm_tpu_torch.validation.drift import device_name

STAGES = ("step", "rows", "forces", "pack", "kernel", "rebuild", "walls",
          "integ")


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


def stage_times(sim, state, neigh, reps=5, out=print):
    """Each stage's ms a call on (state, neigh), printed as it is timed.
    Returns {stage: ms}, the rebuild's pieces included."""
    shapes, params = sim.shapes, sim.params
    dev = state.x.device
    cons = sim.conservative
    t = {}

    def put(name, ms, note=""):
        t[name] = ms
        out(f"{name:<12}{ms:8.3f} ms{note}")

    def ms(fn, r=reps):
        return 1e3 * timeit(fn, dev, r)

    put("step", unit_ms(sim, state, neigh, ("never",), reps))
    put("rows", ms(lambda: contact.particle_rows(state, shapes)))
    put("forces", ms(lambda: contact.contact_force_pairs(
        state, shapes, params, neigh, periodic=sim.periodic,
        conservative=cons)))

    pi, pj = neigh.pair_i, neigh.pair_j

    def pack():
        rws = contact.particle_rows(state, shapes)
        ri, rj = rws[pi], rws[pj]
        msk = (neigh.pair_valid & (ri[:, contact._RACT] > 0.5)
               & (rj[:, contact._RACT] > 0.5))
        dp = contact.minimum_image(rj[:, contact._RX] - ri[:, contact._RX],
                                   state.box_lo, state.box_hi, sim.periodic)
        return ck.pack_pairs(state, shapes, params, pi, pj, msk,
                             neigh.pair_hist, dp, rows=rws)

    put("pack", ms(pack))
    packed, tbl, cap, par = pack()
    put("kernel", ms(lambda: ck.pair_contact(
        packed, tbl, cap, par, lmax=shapes.lmax, conservative=cons)),
        f"  ({sim.pair_list_cap} pairs)")
    put("rebuild", ms(lambda: sim._rebuild(state, neigh), min(reps, 3)),
        f"  (every {sim.rebuild_every})")

    cutoff = params.cutoff + params.skin
    cell = lambda: neighbor.cell_list_neighbors(
        state.x, state.active, state.box_lo, state.box_hi, cutoff,
        sim.grid.dims, sim.cell_cap, sim.k_max, sim.periodic,
        row_chunk=sim.rebuild_chunk)
    put("  cell_list", ms(cell, min(reps, 3)))
    idx, mask, _, _ = cell()
    neigh_tag = torch.where(mask, state.tag[idx], 0)
    put("  remap", ms(lambda: neighbor.remap_history(
        neigh_tag, mask, neigh.neigh_tag, neigh.mask, neigh.hist,
        torch.ones_like(state.active)), min(reps, 3)))
    build_list = lambda: contact.build_pair_list(
        state, shapes, params, idx, mask, neigh.hist, state.active,
        sim.pair_capacity, sim.periodic)
    put("  pair_build", ms(build_list, min(reps, 3)))
    if sim.prefilter:
        fields, _ = build_list()
        put("  prefilter", ms(lambda: contact.prefilter_pair_list(
            state, shapes, params, fields, sim.stage2_capacity, sim.k_max,
            window_steps=sim.rebuild_every or 16, periodic=sim.periodic,
            probe_chunk=sim.rebuild_chunk), min(reps, 3)),
            f"  (probe+compact over {sim.pair_capacity} cand)")

    def walls():
        for w_i, wall in enumerate(sim.walls):
            walls_mod.wall_contact(state, shapes, params, wall,
                                   neigh.wall_hist[:, w_i],
                                   wall_cap=sim.wall_capacity)

    if sim.walls:
        put("walls", ms(walls), f"  ({len(sim.walls)} walls)")
    put("integ", ms(lambda: integrate.final_integrate(
        integrate.initial_integrate(state, shapes, params), shapes, params)))
    return t


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
                    help="steps run before the timings")
    ap.add_argument("--reps", type=int, default=5)
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
    t = stage_times(sim, state, neigh, args.reps, out=pr)
    step = t["step"] + t["rebuild"] / max(sim.rebuild_every, 1)
    pr(f"# step budget: plain step {t['step']:.3f} + rebuild/R "
       f"{t['rebuild'] / max(sim.rebuild_every, 1):.3f} -> {step:.3f} ms "
       f"-> {args.n / step * 1e3:,.0f} particle-steps/s")
    pr(f"# RESULT ({device_name(sim.device)}): " + ", ".join(
        f"{k} {t[k]:.3f} ms" for k in STAGES if k in t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
