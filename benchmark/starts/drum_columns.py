"""The drum's bed in contact. Columns on a square grid across the drum's
lower half, a largest diameter apart, each standing on the cylinder and
stacked to a common height with neighbours overlapping by ``overlap`` of
their diameters: every particle starts in contact with the ones above and
below, none overlapping more than that, and the bed compacts under
gravity through the window.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.starts import orientations


def make(cfg, geo, traffic, gen, device):
    n, rc = geo["n"], cfg["mean_radius"]
    spread, ov = cfg["poly_spread"], traffic["overlap"]
    scale = (1.0 - spread) + 2.0 * spread * torch.rand(
        n, generator=gen, device=device, dtype=torch.float64)
    shtype = torch.randint(0, cfg["n_shape_types"], (n,), generator=gen,
                           device=device)
    q = orientations(n, gen, device)
    # The grid of columns (host, float64: a few thousand sites).
    pitch = 2.0 * rc * (1.0 + spread) * (1.0 - ov)
    R, L = geo["R"], geo["L"]
    r_in = R - 0.5 * pitch
    nx = int(2 * r_in / pitch)
    xs = (np.arange(nx) - 0.5 * (nx - 1)) * pitch
    ny = int((L - pitch) / pitch) + 1
    ys = (np.arange(ny) - 0.5 * (ny - 1)) * pitch
    cx, cy = np.meshgrid(xs, ys, indexing="ij")
    cx, cy = cx.ravel(), cy.ravel()
    z0 = -np.sqrt(np.maximum(r_in ** 2 - cx ** 2, 0.0))
    step = 2.0 * rc * (1.0 - ov)  # the mean spacing along a column
    lo, hi = float(z0.min()), float(r_in)
    for _ in range(60):  # the common height that holds n particles
        H = 0.5 * (lo + hi)
        count = np.where(H >= z0, np.floor((H - z0) / step) + 1, 0)
        lo, hi = (H, hi) if count.sum() < n else (lo, H)
    count = np.where(hi >= z0, np.floor((hi - z0) / step) + 1, 0).astype(np.int64)
    extra = int(count.sum()) - n
    if extra < 0:
        raise ValueError("the drum cannot hold the bed")
    tops = np.where(count > 0, z0 + (count - 1) * step, -np.inf)
    for c in np.argsort(-tops, kind="stable")[:extra]:
        count[c] -= 1
    col = np.repeat(np.arange(count.size), count)
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=device)
    col_t, start_t = t(col, torch.long), t(start, torch.long)
    gap = rc * (scale[:-1] + scale[1:]) * (1.0 - ov)
    cum = torch.cat([torch.zeros(1, dtype=torch.float64, device=device),
                     torch.cumsum(gap, 0)])
    z = t(z0)[col_t] + cum - cum[start_t[col_t]]
    jit = traffic["jitter"] * rc * (2.0 * torch.rand(
        (n, 2), generator=gen, device=device, dtype=torch.float64) - 1.0)
    x = torch.stack([t(cx)[col_t] + jit[:, 0], t(cy)[col_t] + jit[:, 1], z],
                    dim=-1)
    zero = torch.zeros((n, 3), dtype=torch.float64, device=device)
    return dict(x=x, v=zero, q=q, scale=scale, shtype=shtype,
                box_lo=geo["box_lo"], box_hi=geo["box_hi"], tilt=[0.0] * 3)
