"""The triaxial cell (``triaxial_cell``'s geometry) as ``shards`` slabs
along x, one a rank (``parallel/halo.ShardedSimulation``), with the
reference's per-slab capacities and the tilt pad."""

from __future__ import annotations

from benchmark.builders import triaxial_cell

geometry = triaxial_cell.geometry


def simulation(cfg, geo, shapes, params, device, axis=None, cuda_graphs=True):
    from spherharm_tpu_torch.parallel.halo import ShardedSimulation

    n, S = cfg["n"], cfg["shards"]
    box, tri = geo["box"], geo["triclinic"]
    return ShardedSimulation(
        shapes, params, n_shards=S, box_lo=(0, 0, 0), box_hi=(box,) * 3,
        cap_local=cfg["cap_local_per_particle"] * n // S,
        halo_cap=cfg["halo_cap_per_particle"] * n // S,
        periodic=(True,) * 3, k_max=cfg["k_max"], cell_cap=cfg["cell_cap"],
        pair_capacity=cfg["pair_capacity_per_particle"] * n // S,
        deform_min=cfg["deform_min"], triclinic=tri,
        conservative=cfg["conservative"],
        tilt_pad=cfg["tilt_pad_box"] * box if tri else 0.0,
        device=device, axis=axis, cuda_graphs=cuda_graphs)
