"""Restitution against damping (config 1; the port's copy of the
reference harness ``scripts/restitution_curve.py``).

Runs the two-body head-on collision over a gamma_n sweep as one replica
ensemble (``parallel/ensemble.run_replicas``: one launch of each kernel a
step for every replica) and prints the restitution table, the classic DEM
validation (restitution check against a reference CPU run).

    python -m spherharm_tpu_torch.validation.restitution_curve [n_gammas] \\
        [--steps 3000] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from spherharm_tpu_torch.models import scenarios
from spherharm_tpu_torch.parallel import ensemble


def build(n_g=8, device="cuda"):
    """``two_body_collision(gamma_n=0, dt=2e-4)`` replicated n_g times,
    gamma_n swept over linspace(0, 700, n_g). Returns (sim, states,
    neighs, params, gammas)."""
    sim, state, neigh = scenarios.two_body_collision(gamma_n=0.0, dt=2e-4,
                                                     device=device)
    gammas = np.linspace(0.0, 700.0, n_g).astype(np.float32)
    return (sim, ensemble.replicate(state, n_g),
            ensemble.replicate(neigh, n_g),
            ensemble.with_param_sweep(sim.params, gamma_n=gammas), gammas)


def curve(sim, states, neighs, params, n_steps=3000):
    """The restitution of each replica after ``n_steps``: outgoing over
    incoming speed (v0 = 1). Returns (e [n_g] numpy, states, neighs)."""
    states, neighs = ensemble.run_replicas(sim, states, neighs, params,
                                           n_steps)
    return -states.v[:, 0, 0].cpu().numpy(), states, neighs


def check(e):
    """The reference's two asserts, raised as AssertionError whatever the
    interpreter's -O."""
    if not e[0] > 0.995:
        raise AssertionError("elastic limit must give e ~ 1")
    if not np.all(np.diff(e) < 1e-3):
        raise AssertionError("e must decrease with damping")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_g", type=int, nargs="?", default=8)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, states, neighs, params, gammas = build(args.n_g, args.device)
    e, states, neighs = curve(sim, states, neighs, params, args.steps)
    print(f"{'gamma_n':>10} {'restitution':>12}")
    for g, ei in zip(gammas, e):
        print(f"{g:>10.1f} {ei:>12.5f}")
    check(e)
    print("# monotone restitution curve OK")
    print("# RESULT: e(gamma_n) = " + " ".join(f"{ei:.5f}" for ei in e))
    return 0


if __name__ == "__main__":
    sys.exit(main())
