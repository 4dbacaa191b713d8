"""The rotating drum (``models/scenarios.rotating_drum``'s geometry): a
cylinder along y turning at ``drum_omega``, closed by two plane walls,
the box 1.1 drum radii about it; the R-step static cadence with the
stage-2 prefilter."""

from __future__ import annotations

import numpy as np


def geometry(cfg, geo):
    n = cfg["n"]
    rmax = float(geo["ref_shapes"].rmax.max()) * (1 + cfg["poly_spread"])
    pitch = 2.05 * rmax
    R = pitch * (2.5 * n / np.pi) ** (1 / 3)
    L = R
    box = 1.1 * R
    geo.update(
        rmax=rmax, R=R, L=L, box_lo=[-box, -L / 2 - rmax, -box],
        box_hi=[box, L / 2 + rmax, box], periodic=[False] * 3,
        skin=0.4 * rmax, cutoff=2.0 * rmax, cell=2.4 * rmax,
        walls=[dict(kind="cylinder", axis_point=[0.0, 0.0, 0.0],
                    axis_dir=[0.0, 1.0, 0.0], radius=R,
                    omega=cfg["drum_omega"]),
               dict(kind="plane", point=[0.0, -L / 2, 0.0],
                    normal=[0.0, 1.0, 0.0], velocity=[0.0, 0.0, 0.0]),
               dict(kind="plane", point=[0.0, L / 2, 0.0],
                    normal=[0.0, -1.0, 0.0], velocity=[0.0, 0.0, 0.0])],
        wall_cap=max(1024, min(n, int(8.0 * n * rmax / R))))


def simulation(cfg, geo, shapes, params, device, axis=None, cuda_graphs=True):
    from spherharm_tpu_torch.core.simulation import Simulation
    from spherharm_tpu_torch.ops.neighbor import CellGrid
    from spherharm_tpu_torch.ops.walls import CylinderWall, PlaneWall

    n = cfg["n"]
    cyl, lo_plane, hi_plane = geo["walls"]
    walls = (CylinderWall.create(cyl["axis_point"], cyl["axis_dir"],
                                 cyl["radius"], omega=cyl["omega"],
                                 device=device),
             PlaneWall.create(lo_plane["point"], lo_plane["normal"],
                              device=device),
             PlaneWall.create(hi_plane["point"], hi_plane["normal"],
                              device=device))
    return Simulation(
        shapes, params, grid=CellGrid(geo["box_lo"], geo["box_hi"],
                                      geo["cell"]),
        k_max=cfg["k_max"], cell_cap=cfg["cell_cap"], walls=walls,
        pair_capacity=cfg["pair_capacity_per_particle"] * n,
        rebuild_every=cfg["rebuild_every"], wall_capacity=geo["wall_cap"],
        stage2_capacity=cfg["stage2_capacity_per_particle"] * n,
        conservative=cfg["conservative"], device=device,
        cuda_graphs=cuda_graphs)
