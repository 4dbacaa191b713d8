"""The triaxial cell's jittered cubic lattice, compressed with its box
about the centre until lattice neighbours overlap by ``overlap`` of a
diameter (never below the configuration's ``deform_min``, where the fixed
cell grid's cells would shrink under the cutoff): the benchmark's copy of
the port's test helper ``triaxial_start``.
"""

from __future__ import annotations

import torch

from benchmark.starts import orientations


def make(cfg, geo, traffic, gen, device):
    n, side, box = geo["n"], geo["side"], geo["box"]
    pitch = box / side
    i = torch.arange(n, device=device, dtype=torch.float64)
    x = torch.stack([torch.remainder(i, side), torch.remainder(
        torch.div(i, side, rounding_mode="floor"), side),
        torch.div(i, side * side, rounding_mode="floor")], -1)
    x = (x + 0.5) * pitch
    x = x + traffic["jitter"] * geo["rmax"] * (2.0 * torch.rand(
        (n, 3), generator=gen, device=device, dtype=torch.float64) - 1.0)
    q = orientations(n, gen, device)
    v = traffic["v_sigma"] * torch.randn((n, 3), generator=gen, device=device,
                                         dtype=torch.float64)
    shtype = torch.randint(0, cfg["n_shape_types"], (n,), generator=gen,
                           device=device)
    c = max(cfg["deform_min"], (1.0 - traffic["overlap"]) * 2.0
            * cfg["mean_radius"] / pitch)
    ctr = 0.5 * box
    x = ctr + c * (x - ctr)
    lo, hi = ctr - c * ctr, ctr + c * (box - ctr)
    return dict(x=x, v=v, q=q, scale=torch.ones(n, dtype=torch.float64,
                                                device=device),
                shtype=shtype, box_lo=[lo] * 3, box_hi=[hi] * 3,
                tilt=[0.0] * 3, compression=c)
