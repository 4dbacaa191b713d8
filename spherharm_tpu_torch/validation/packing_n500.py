"""Config 2's quantitative acceptance: the packing fraction of n = 500
settled particles (the port's copy of the reference harness
``scripts/packing_n500.py``).

Loose random pourings of frictional ellipsoids (aspect ~1.4:1.1:1) land
between random-loose and random-close packing: phi ~ 0.52-0.64 depending
on friction (mu 0.4 here biases low-mid). The settling box runs in blocks
of ``--block`` steps until the mean kinetic energy falls under 5e-4 of its
peak, or ``max_blocks`` blocks.

    python -m spherharm_tpu_torch.validation.packing_n500 [n] [max_blocks] \\
        [--block 1000] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

from spherharm_tpu_torch.core import computes
from spherharm_tpu_torch.models import scenarios


def build(n=500, device="cuda"):
    """``settling_box`` with the harness's settings (Lmax 2, dt 2e-4,
    gamma_n 400, mu 0.4, k_max 24). Returns (sim, state, neigh)."""
    return scenarios.settling_box(n=n, lmax=2, dt=2e-4, gamma_n=400.0,
                                  mu=0.4, k_max=24, device=device)


def settle(sim, state, neigh, max_blocks, block=1000, out=print):
    """Blocks of ``block`` steps until ke < 5e-4 of its peak (or
    ``max_blocks``), printing ke a particle and phi after each. Returns
    (state, neigh, phi, blocks run)."""
    e_peak = 0.0
    for blk in range(max_blocks):
        state, neigh = sim.run(state, neigh, block)
        ke = float(computes.mean_kinetic_energy(state, sim.shapes))
        e_peak = max(e_peak, ke)
        phi = float(computes.packing_fraction_box(state, sim.shapes))
        out(f"block {blk:3d}  ke/atom {ke:.3e}  phi {phi:.4f}")
        if e_peak > 0 and ke < 5e-4 * e_peak:
            break
    return state, neigh, phi, blk + 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=500)
    ap.add_argument("max_blocks", type=int, nargs="?", default=120)
    ap.add_argument("--block", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, state, neigh = build(args.n, device=args.device)
    state, neigh, phi, blocks = settle(sim, state, neigh, args.max_blocks,
                                       args.block,
                                       out=lambda s: print(s, flush=True))
    n_act = int(state.n_active)
    ovf = int(neigh.overflow)
    print(f"# {blocks * args.block} steps; active {n_act}/{args.n}; "
          f"overflow {ovf}")
    if n_act != args.n:
        print(f"# FAIL: lost particles: {n_act}/{args.n}")
        return 1
    print(f"# RESULT: packing fraction phi = {phi:.4f} at n={args.n} "
          f"(expected window 0.50-0.66 for mu=0.4 ellipsoids)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
