"""One sharded step of a tiny system: the reference's multi-device dry run
(``__graft_entry__.dryrun_multichip``), with the slabs or the bricks on
the shard axis of one device.

    python -m spherharm_tpu_torch.parallel.dryrun 4            # 4 slabs, the card
    python -m spherharm_tpu_torch.parallel.dryrun 4 --device cpu
    python -m spherharm_tpu_torch.parallel.dryrun 2 2 2        # a 2x2x2 brick
    python -m spherharm_tpu_torch.parallel.dryrun 2 2 --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from spherharm_tpu_torch.core.state import SimParams
from spherharm_tpu_torch.models import scenarios, shapes_library
from spherharm_tpu_torch.parallel.brick import BrickSimulation
from spherharm_tpu_torch.parallel.halo import ShardedSimulation


def _tiny(device):
    """The dry runs' shapes (one Lmax-4 ellipsoid) and parameters."""
    lmax = 4
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, lmax)],
        lmax, contact_quad=(6, 12), device=device)
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3, device=device)
    return shapes, params


def _checked(sim, state, n):
    """Init, one step and thermo; raises unless every particle is counted
    and the energy is finite. Returns the thermo dict."""
    st, ng, gh = sim.init(state)
    st, ng, gh = sim.run(st, ng, gh, 1)
    th = sim.thermo(st, ng, gh)
    if int(th["n"]) != n:
        raise RuntimeError(f"dry run counts {int(th['n'])} particles, not {n}")
    if not bool(torch.isfinite(th["etot"])):
        raise RuntimeError("non-finite energy in the dry run")
    return th


def dryrun_sharded(n_shards: int, device="cuda") -> dict:
    """Init, one step and thermo of 16 S Lmax-4 ellipsoids in a periodic
    4S x 4 x 4 box over S = ``n_shards`` slabs (the reference's tiny
    system and capacities). Raises unless every particle is counted and
    the energy is finite; returns the thermo dict."""
    shapes, params = _tiny(device)
    box = 4.0 * n_shards
    rng = np.random.default_rng(0)
    n = 16 * n_shards
    x = rng.uniform(0.6, box - 0.6, (n, 3))
    x[:, 1] %= 4.0
    x[:, 2] %= 4.0
    state = scenarios.make_state(x, [0, 0, 0], [box, 4.0, 4.0],
                                 v=rng.normal(size=(n, 3)) * 0.3,
                                 device=device)
    sim = ShardedSimulation(
        shapes, params, n_shards=n_shards, box_lo=(0, 0, 0),
        box_hi=(box, 4.0, 4.0), cap_local=64, halo_cap=32, migrate_cap=16,
        periodic=(True, True, True), k_max=16, cell_cap=8,
        pair_capacity=256, device=device)
    return _checked(sim, state, n)


def dryrun_brick(mesh_shape, device="cuda") -> dict:
    """The brick half of the reference's dry run on a brick of
    ``mesh_shape`` ((S/4, 2, 2) at S = 8 there, (S/2, 2) otherwise): 16 S
    Lmax-4 ellipsoids, each inside a random 4-wide cube of a periodic box
    of 4 (Sx, Sy, Sz) (Sz = 1 on a 2D brick), the x bounds moved up by
    0.04 (weighted), the reference's capacities; init, one step and
    thermo. Raises unless every particle is counted and the energy is
    finite; returns the thermo dict."""
    shapes, params = _tiny(device)
    shape = tuple(int(s) for s in mesh_shape)
    grid = shape + (1,) * (3 - len(shape))
    n = 16 * int(np.prod(shape))
    box = tuple(4.0 * p for p in grid)
    rng = np.random.default_rng(0)
    # The reference draws the slab half's positions and velocities from
    # the same generator first.
    rng.uniform(size=(n, 3))
    rng.normal(size=(n, 3))
    x = rng.uniform(0.6, 3.4, (n, 3))
    for d in range(3):
        x[:, d] += 4.0 * rng.integers(0, grid[d], n)
    state = scenarios.make_state(x, [0, 0, 0], box,
                                 v=rng.normal(size=(n, 3)) * 0.3,
                                 device=device)
    fx = np.linspace(0.0, 1.0, shape[0] + 1)
    fx[1:-1] += 0.04
    sim = BrickSimulation(
        shapes, params, mesh_shape=shape, box_lo=(0, 0, 0), box_hi=box,
        cap_local=64, halo_cap=32, migrate_cap=16,
        periodic=(True, True, True), k_max=16, cell_cap=12,
        pair_capacity=256, bounds_frac={"x": fx}, device=device)
    return _checked(sim, state, n)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shape", type=int, nargs="+",
                    help="S (slabs), or Sx Sy [Sz] (a brick)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if len(args.shape) == 1:
        label = f"dryrun_sharded({args.shape[0]})"
        th = dryrun_sharded(args.shape[0], device=args.device)
    else:
        label = f"dryrun_brick({tuple(args.shape)})"
        th = dryrun_brick(args.shape, device=args.device)
    print(f"{label} on {args.device}: n={int(th['n'])} "
          f"etot={float(th['etot']):.7g} overflow={int(th['neigh_overflow'])}")


if __name__ == "__main__":
    main()
