"""The periodic triaxial cell (``models/scenarios.triaxial_cell``'s
geometry): a cube holding ``n`` particles at ``fill_fraction``, strained
and sheared (triclinic where the shear is not zero), the skin trigger,
one card."""

from __future__ import annotations

import math


def geometry(cfg, geo):
    n = cfg["n"]
    shapes = geo["ref_shapes"]
    rmax = float(shapes.rmax.max())
    box = (n * float(shapes.vol.mean()) / cfg["fill_fraction"]) ** (1 / 3)
    geo.update(
        rmax=rmax, box=box, side=int(math.ceil(n ** (1 / 3))),
        box_lo=[0.0] * 3, box_hi=[box] * 3, periodic=[True] * 3,
        skin=0.4 * rmax, cutoff=2.0 * rmax, walls=[],
        triclinic=any(abs(r) > 0 for r in geo["shear_rate"]))


def simulation(cfg, geo, shapes, params, device, axis=None, cuda_graphs=True):
    from spherharm_tpu_torch.core.simulation import Simulation
    from spherharm_tpu_torch.ops.neighbor import CellGrid

    box, tri = geo["box"], geo["triclinic"]
    grid = CellGrid([0, 0, 0], [box * cfg["deform_min"]] * 3,
                    2.4 * geo["rmax"] * (1.4 if tri else 1.0), (True,) * 3)
    return Simulation(
        shapes, params, periodic=(True,) * 3, neighbor_mode="cell", grid=grid,
        k_max=cfg["k_max"], cell_cap=cfg["cell_cap"],
        pair_capacity=cfg["pair_capacity_per_particle"] * cfg["n"],
        triclinic=tri, conservative=cfg["conservative"], device=device,
        cuda_graphs=cuda_graphs)
