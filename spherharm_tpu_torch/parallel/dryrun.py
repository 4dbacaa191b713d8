"""One sharded step of a tiny system: the reference's multi-device dry run
(``__graft_entry__.dryrun_multichip``), with the slabs or the bricks on
the shard axis of one device, or one shard a process (``--ranks``).

    python -m spherharm_tpu_torch.parallel.dryrun 4            # 4 slabs, the card
    python -m spherharm_tpu_torch.parallel.dryrun 4 --device cpu
    python -m spherharm_tpu_torch.parallel.dryrun 2 2 2        # a 2x2x2 brick
    python -m spherharm_tpu_torch.parallel.dryrun 2 2 --device cpu
    python -m spherharm_tpu_torch.parallel.dryrun 4 --ranks --device cpu
        # 4 gloo ranks on the CPU (spawned processes)
    torchrun --nproc_per_node 4 -m spherharm_tpu_torch.parallel.dryrun 4 --ranks
        # 4 slabs, one a card, over NCCL (2 2 --ranks: the (2, 2) brick)

``--ranks`` without ``torchrun`` spawns the ranks itself: NCCL when the
host has a card for each, else gloo (CUDA tensors through host memory:
``--eager`` then, since no CUDA graph holds a host sync).
"""

from __future__ import annotations

import argparse
import os

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


def dryrun_sharded(n_shards: int, device="cuda", axis=None,
                   cuda_graphs: bool = True) -> dict:
    """Init, one step and thermo of 16 S Lmax-4 ellipsoids in a periodic
    4S x 4 x 4 box over S = ``n_shards`` slabs (the reference's tiny
    system and capacities); ``axis`` a rank's ``RankAxis`` (one slab a
    process). Raises unless every particle is counted and the energy is
    finite; returns the thermo dict."""
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
        pair_capacity=256, device=device, axis=axis, cuda_graphs=cuda_graphs)
    return _checked(sim, state, n)


def dryrun_brick(mesh_shape, device="cuda", axis=None,
                 cuda_graphs: bool = True) -> dict:
    """The brick half of the reference's dry run on a brick of
    ``mesh_shape`` ((S/4, 2, 2) at S = 8 there, (S/2, 2) otherwise): 16 S
    Lmax-4 ellipsoids, each inside a random 4-wide cube of a periodic box
    of 4 (Sx, Sy, Sz) (Sz = 1 on a 2D brick), the x bounds moved up by
    0.04 (weighted), the reference's capacities; init, one step and
    thermo; ``axis`` a rank's ``RankBrickAxes`` (one brick a process).
    Raises unless every particle is counted and the energy is finite;
    returns the thermo dict."""
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
        pair_capacity=256, bounds_frac={"x": fx}, device=device, axis=axis,
        cuda_graphs=cuda_graphs)
    return _checked(sim, state, n)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shape", type=int, nargs="+",
                    help="S (slabs), or Sx Sy [Sz] (a brick)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", action="store_true",
                    help="one shard a process (torch.distributed)")
    ap.add_argument("--eager", action="store_true",
                    help="no CUDA graphs (cuda_graphs=False)")
    args = ap.parse_args(argv)
    shape = tuple(args.shape)
    label = (f"dryrun_sharded({shape[0]})" if len(shape) == 1
             else f"dryrun_brick({shape})")
    graphs = not args.eager
    if not args.ranks:
        th = (dryrun_sharded(shape[0], device=args.device, cuda_graphs=graphs)
              if len(shape) == 1 else
              dryrun_brick(shape, device=args.device, cuda_graphs=graphs))
        where = args.device
    else:
        from spherharm_tpu_torch.parallel import ranks

        n = int(np.prod(shape))
        if "RANK" in os.environ:  # started by torchrun
            axis = ranks.init_ranks(None if args.device == "cuda"
                                    else args.device)
            th = ranks.dryrun(axis, shape, graphs)
            if axis.rank != 0:
                return
            th = {k: v.cpu() for k, v in th.items()}
            where = f"{n} {axis.backend} ranks on {axis.device.type}"
        else:
            cards = (torch.cuda.device_count() if args.device != "cpu"
                     else 0)
            if args.device != "cpu" and cards == 0:
                raise SystemExit("--ranks on the card needs a CUDA device")
            backend = "nccl" if cards >= n else "gloo"
            devices = ([f"cuda:{r % cards}" for r in range(n)] if cards
                       else ["cpu"] * n)
            th = ranks.spawn_ranks(ranks.dryrun, n, backend, devices, shape,
                                   graphs, timeout=600.0)[0]
            where = f"{n} {backend} ranks on {devices[0].split(':')[0]}"
    print(f"{label} on {where}: n={int(th['n'])} "
          f"etot={float(th['etot']):.7g} overflow={int(th['neigh_overflow'])}")


if __name__ == "__main__":
    main()
