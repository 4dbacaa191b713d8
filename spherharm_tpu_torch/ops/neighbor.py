"""Cell-list / Verlet neighbour build over fixed-capacity tensors (torch
twin of ``spherharm_tpu/ops/neighbor.py``). Every geometric function
takes the triclinic ``tilt`` (xy, xz, yz) or None (orthogonal box).

Dense ``[N, K]`` index tensor + mask built with sort / scatter / stable
compaction, so every shape is static. Full-list semantics: pair (i, j)
appears in row i and row j.

Where the reference relies on a stable ``argsort`` or on ``lax.top_k``
putting the lowest index first among ties, this module uses
``torch.sort(..., stable=True)``: ``torch.topk`` promises no order.
"""

from __future__ import annotations

import numpy as np
import torch

from spherharm_tpu_torch.ops.contact import minimum_image, unshear_coords


class CellGrid:
    """Static binning geometry: grid dims chosen once at setup (cell size
    >= cutoff + skin keeps the 27-stencil complete)."""

    def __init__(self, box_lo, box_hi, cutoff: float,
                 periodic=(False, False, False)):
        lo = np.asarray(box_lo, dtype=np.float64)
        hi = np.asarray(box_hi, dtype=np.float64)
        dims = np.maximum(np.floor((hi - lo) / cutoff).astype(int), 1)
        self.dims = tuple(int(v) for v in dims)
        self.n_cells = int(np.prod(dims))
        self.periodic = tuple(bool(p) for p in periodic)

    def __repr__(self):
        return f"CellGrid(dims={self.dims}, periodic={self.periodic})"


def stable_topk_true(valid, k: int):
    """Indices of the first k True entries per row (then the False ones),
    lowest index first: the order ``lax.top_k`` gives on a 0/1 score."""
    return torch.sort((~valid).to(torch.uint8), dim=-1,
                      stable=True).indices[..., :k]


def allpairs_neighbors(x, active, box_lo, box_hi, cutoff, k_max: int,
                       periodic=(False, False, False), tilt=None):
    """O(N^2) neighbour build, the small-system path. Returns (idx, mask,
    count) with K = min(k_max, N) slots a row, lowest index first."""
    N = x.shape[0]
    d = minimum_image(x[None, :, :] - x[:, None, :], box_lo, box_hi,
                      periodic, tilt)
    dist2 = (d * d).sum(-1)
    eye = torch.eye(N, dtype=torch.bool, device=x.device)
    valid = ((dist2 < cutoff**2) & ~eye & active[None, :]
             & active[:, None])
    idx = stable_topk_true(valid, min(k_max, N))
    return idx, torch.gather(valid, 1, idx), valid.sum(1)


def cell_list_neighbors(x, active, box_lo, box_hi, cutoff,
                        grid_dims: tuple, cell_cap: int, k_max: int,
                        periodic=(False, False, False), tilt=None,
                        row_chunk: int = 0):
    """Cell-binned neighbour build. Returns (idx, mask, count,
    cell_overflow).

    bin -> rank in cell (stable sort) -> scatter into the [cells, cap]
    table -> 27-stencil gather -> distance filter -> stable compaction to
    k_max. ``row_chunk`` > 0 runs the stencil stage over row blocks to
    bound the [N, 27 * cell_cap] transients. A tilted box bins in the
    unsheared frame (``unshear_coords``: periodic images are orthogonal
    translations there; the caller inflates the cell size to cover the
    skew) and filters by the exact tilted minimum image.
    """
    N = x.shape[0]
    dev = x.device
    D = torch.as_tensor(grid_dims, dtype=torch.long, device=dev)
    n_cells = int(grid_dims[0] * grid_dims[1] * grid_dims[2])
    cell_sz = (box_hi - box_lo) / torch.as_tensor(grid_dims, dtype=x.dtype,
                                                 device=dev)
    x_bin = x if tilt is None else unshear_coords(x, box_lo, box_hi, tilt)
    cc = torch.floor((x_bin - box_lo) / cell_sz).long()
    cc = torch.minimum(torch.clamp(cc, min=0), D - 1)
    cid = (cc[:, 0] * D[1] + cc[:, 1]) * D[2] + cc[:, 2]
    cid = torch.where(active, cid, n_cells)  # inactive -> overflow bin

    # Rank within cell via a stable sort.
    cid_sorted, order = torch.sort(cid, stable=True)
    starts = torch.searchsorted(cid_sorted, cid_sorted, side="left")
    rank_sorted = torch.arange(N, device=dev) - starts
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)

    flat = torch.where((rank < cell_cap) & (cid < n_cells),
                       cid * cell_cap + rank, n_cells * cell_cap)
    table = torch.full((n_cells * cell_cap + 1,), -1, dtype=torch.long,
                       device=dev)
    table.scatter_(0, flat, torch.arange(N, device=dev))
    table = table[:-1].reshape(n_cells, cell_cap)

    per_cell = torch.zeros(n_cells + 1, dtype=torch.long, device=dev)
    per_cell.index_add_(0, cid, torch.ones_like(cid))  # exact: integers
    cell_overflow = per_cell[:n_cells].max()
    under = (cell_sz < cutoff * (1.0 - 1e-6)) & (D > 1)
    cell_overflow = torch.where(under.any(),
                                torch.full_like(cell_overflow, 1 << 20),
                                cell_overflow)

    off = torch.as_tensor(
        [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
        dtype=torch.long, device=dev,
    )
    pmask = torch.as_tensor(periodic, device=dev)

    def stencil_rows(cc_b, x_b, self_b):
        ncc = cc_b[:, None, :] + off[None, :, :]  # [C,27,3]
        oob = (ncc < 0) | (ncc >= D)
        ncc_ok = torch.where(pmask, torch.remainder(ncc, D),
                             torch.minimum(torch.clamp(ncc, min=0), D - 1))
        invalid_cell = (oob & ~pmask).any(-1)
        ncid = (ncc_ok[..., 0] * D[1] + ncc_ok[..., 1]) * D[2] + ncc_ok[..., 2]
        ncid = torch.where(invalid_cell, n_cells - 1, ncid)
        cand = table[ncid]  # [C, 27, cell_cap]
        cand = torch.where(invalid_cell[..., None], -1, cand)
        cand = cand.reshape(cand.shape[0], 27 * cell_cap)
        safe = torch.clamp(cand, min=0)
        d = minimum_image(x[safe] - x_b[:, None, :], box_lo, box_hi,
                          periodic, tilt)
        dist2 = (d * d).sum(-1)
        valid = ((cand >= 0) & (cand != self_b[:, None])
                 & (dist2 < cutoff**2) & active[safe]
                 & active[self_b][:, None])
        count = valid.sum(1)
        sel = stable_topk_true(valid, k_max)
        return (torch.gather(safe, 1, sel), torch.gather(valid, 1, sel),
                count)

    self_idx = torch.arange(N, device=dev)
    if row_chunk and N > row_chunk:
        outs = [stencil_rows(cc[s:s + row_chunk], x[s:s + row_chunk],
                             self_idx[s:s + row_chunk])
                for s in range(0, N, row_chunk)]
        idx, mask, count = (torch.cat(t) for t in zip(*outs))
    else:
        idx, mask, count = stencil_rows(cc, x, self_idx)
    return idx, mask, count, cell_overflow


def remap_history(new_key, new_mask, old_key, old_mask, old_hist,
                  row_ok=None, chunk: int = 4096):
    """Carry spring state across a rebuild: per row, match new neighbour
    tags against old ones (masked equality join) and take the old spring;
    unmatched contacts start at zero. The [N, K, K] match tensor is built
    per ``chunk`` rows to bound memory."""
    N = new_key.shape[0]
    if row_ok is None:
        row_ok = torch.ones(N, dtype=torch.bool, device=new_key.device)
    out = []
    for s in range(0, N, chunk):
        sl = slice(s, s + chunk)
        m = ((new_key[sl, :, None] == old_key[sl, None, :])
             & old_mask[sl, None, :] & new_mask[sl, :, None]
             & row_ok[sl, None, None])
        out.append(torch.einsum("nkl,nlc->nkc", m.to(old_hist.dtype),
                                old_hist[sl]))
    return torch.cat(out)


def wrap_positions(x, image, box_lo, box_hi, periodic, tilt=None):
    """Wrap x into the box for periodic dims, tracking image counters.

    With ``tilt`` the wrap runs in fractional lattice coordinates:
    n = floor(H^-1 (x - lo)) per periodic dim, x -= H n, whole lattice
    vectors only, so x + image @ H^T recovers the unwrapped position and
    the wrapped fractional coordinate lies in [0, 1)."""
    L = box_hi - box_lo
    pmask = torch.as_tensor(periodic, dtype=x.dtype, device=x.device)
    if tilt is None:
        shifts = torch.floor((x - box_lo) / L) * pmask
        return x - shifts * L, image + shifts.long()
    xy, xz, yz = tilt[0], tilt[1], tilt[2]
    px, py, pz = x[..., 0], x[..., 1], x[..., 2]
    # Fractional coordinates by back-substitution through the
    # upper-triangular H = [a|b|c], from the original coordinates.
    f3 = (pz - box_lo[2]) / L[2]
    f2 = (py - box_lo[1] - yz * f3) / L[1]
    f1 = (px - box_lo[0] - xy * f2 - xz * f3) / L[0]
    n3 = torch.floor(f3) * pmask[2]
    n2 = torch.floor(f2) * pmask[1]
    n1 = torch.floor(f1) * pmask[0]
    px = px - n1 * L[0] - n2 * xy - n3 * xz
    py = py - n2 * L[1] - n3 * yz
    pz = pz - n3 * L[2]
    shifts = torch.stack([n1, n2, n3], dim=-1)
    return torch.stack([px, py, pz], dim=-1), image + shifts.long()


def max_displacement2(x, x_build, active, box_lo, box_hi, periodic,
                      tilt=None):
    """Max squared displacement since the last build (skin trigger)."""
    d = minimum_image(x - x_build, box_lo, box_hi, periodic, tilt)
    d2 = (d * d).sum(-1)
    return torch.where(active, d2, torch.zeros_like(d2)).max()


def surface_motion(x, x_build, q, q_build, gmax_s, active,
                   box_lo, box_hi, periodic, tilt=None):
    """Per-particle surface-motion bound since the last build:
    |dx| + gmax * (rotation angle). Inactive rows report 0."""
    d = minimum_image(x - x_build, box_lo, box_hi, periodic, tilt)
    disp = torch.sqrt((d * d).sum(-1))
    qdot = (q * q_build).sum(-1).abs()
    alpha = 2.0 * torch.arccos(torch.clamp(qdot, 0.0, 1.0))
    appr = disp + gmax_s * alpha
    return torch.where(active, appr, torch.zeros_like(appr))


def approach_ratio(x, x_build, q, q_build, gmax_s, budget, active,
                   box_lo, box_hi, periodic, tilt=None):
    """Rebuild trigger for the prefiltered pair list: max over particles
    of (surface motion since build) / (its recorded motion budget)."""
    appr = surface_motion(x, x_build, q, q_build, gmax_s, active,
                          box_lo, box_hi, periodic, tilt)
    ratio = appr / budget.clamp(min=1e-30)
    return torch.where(active, ratio, torch.zeros_like(ratio)).max()
