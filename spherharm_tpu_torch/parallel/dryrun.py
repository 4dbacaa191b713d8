"""One sharded step of a tiny system: the slab half of the reference's
multi-device dry run (``__graft_entry__.dryrun_multichip``), with the
slabs on the shard axis of one device.

    python -m spherharm_tpu_torch.parallel.dryrun 4            # the card
    python -m spherharm_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from spherharm_tpu_torch.core.state import SimParams
from spherharm_tpu_torch.models import scenarios, shapes_library
from spherharm_tpu_torch.parallel.halo import ShardedSimulation


def dryrun_sharded(n_shards: int, device="cuda") -> dict:
    """Init, one step and thermo of 16 S Lmax-4 ellipsoids in a periodic
    4S x 4 x 4 box over S = ``n_shards`` slabs (the reference's tiny
    system and capacities). Raises unless every particle is counted and
    the energy is finite; returns the thermo dict."""
    lmax = 4
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, lmax)],
        lmax, contact_quad=(6, 12), device=device)
    box = 4.0 * n_shards
    rng = np.random.default_rng(0)
    n = 16 * n_shards
    x = rng.uniform(0.6, box - 0.6, (n, 3))
    x[:, 1] %= 4.0
    x[:, 2] %= 4.0
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3, device=device)
    state = scenarios.make_state(x, [0, 0, 0], [box, 4.0, 4.0],
                                 v=rng.normal(size=(n, 3)) * 0.3,
                                 device=device)
    sim = ShardedSimulation(
        shapes, params, n_shards=n_shards, box_lo=(0, 0, 0),
        box_hi=(box, 4.0, 4.0), cap_local=64, halo_cap=32, migrate_cap=16,
        periodic=(True, True, True), k_max=16, cell_cap=8,
        pair_capacity=256, device=device)
    st, ng, gh = sim.init(state)
    st, ng, gh = sim.run(st, ng, gh, 1)
    th = sim.thermo(st, ng, gh)
    if int(th["n"]) != n:
        raise RuntimeError(f"dry run counts {int(th['n'])} particles, not {n}")
    if not bool(torch.isfinite(th["etot"])):
        raise RuntimeError("non-finite energy in the dry run")
    return th


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_shards", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    th = dryrun_sharded(args.n_shards, device=args.device)
    print(f"dryrun_sharded({args.n_shards}) on {args.device}: n={int(th['n'])} "
          f"etot={float(th['etot']):.7g} overflow={int(th['neigh_overflow'])}")


if __name__ == "__main__":
    main()
