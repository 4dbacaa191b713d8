"""Cell-list / Verlet neighbour build over fixed-capacity tensors (torch
twin of ``spherharm_tpu/ops/neighbor.py``). Every geometric function
takes the triclinic ``tilt`` (xy, xz, yz) or None (orthogonal box).

Dense ``[N, K]`` index tensor + mask built with sort / scatter / stable
compaction, so every shape is static. Full-list semantics: pair (i, j)
appears in row i and row j.

Where the reference relies on a stable ``argsort`` or on ``lax.top_k``
putting the lowest index first among ties, this module uses
``torch.sort(..., stable=True)``: ``torch.topk`` promises no order.

Every function takes a single system or replicas stacked along a leading
axis (x [R, N, 3], boxes and tilts [R, 3], cutoff [R]); no candidate ever
pairs particles of two replicas, and indices stay each replica's own.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spherharm_tpu_torch.core.state import per_replica
from spherharm_tpu_torch.ops.contact import (minimum_image, periodic_mask,
                                             unshear_coords)


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


@functools.cache
def grid_constants(grid_dims: tuple, periodic: tuple, device):
    """The cell list's constant tensors on ``device``: the grid dims D [3]
    (long), the 27 stencil offsets [27, 3] and the periodic mask [3]
    (bool). Built once for each grid and kept: a tensor made from host
    values on each call is a copy from host memory, which synchronises
    and which a CUDA graph cannot capture."""
    D = torch.as_tensor(grid_dims, dtype=torch.long, device=device)
    off = torch.as_tensor(
        [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
        dtype=torch.long, device=device,
    )
    return D, off, torch.as_tensor(periodic, device=device)


def stable_topk_true(valid, k: int):
    """Indices of the first k True entries per row (then the False ones),
    lowest index first: the order ``lax.top_k`` gives on a 0/1 score."""
    return torch.sort((~valid).to(torch.uint8), dim=-1,
                      stable=True).indices[..., :k]


def allpairs_neighbors(x, active, box_lo, box_hi, cutoff, k_max: int,
                       periodic=(False, False, False), tilt=None):
    """O(N^2) neighbour build, the small-system path. Returns (idx, mask,
    count) with K = min(k_max, N) slots a row, lowest index first. With a
    replica axis the distances are [R, N, N]: O(N^2) per replica."""
    N = x.shape[-2]
    d = minimum_image(x[..., None, :, :] - x[..., :, None, :], box_lo,
                      box_hi, periodic, tilt)
    dist2 = (d * d).sum(-1)
    eye = torch.eye(N, dtype=torch.bool, device=x.device)
    valid = ((dist2 < per_replica(cutoff, 0, dist2.dim()) ** 2) & ~eye
             & active[..., None, :] & active[..., :, None])
    idx = stable_topk_true(valid, min(k_max, N))
    return idx, torch.gather(valid, -1, idx), valid.sum(-1)


def cell_list_neighbors(x, active, box_lo, box_hi, cutoff,
                        grid_dims: tuple, cell_cap: int, k_max: int,
                        periodic=(False, False, False), tilt=None,
                        row_chunk: int = 0, bin_lo=None, bin_hi=None,
                        owned=None):
    """Cell-binned neighbour build. Returns (idx, mask, count,
    cell_overflow).

    bin -> rank in cell (stable sort) -> scatter into the [cells, cap]
    table -> 27-stencil gather -> distance filter -> stable compaction to
    k_max. ``row_chunk`` > 0 runs the stencil stage over row blocks to
    bound the [N, 27 * cell_cap] transients. A tilted box bins in the
    unsheared frame (``unshear_coords``: periodic images are orthogonal
    translations there; the caller inflates the cell size to cover the
    skew) and filters by the exact tilted minimum image.

    Replicas bin into their own copy of the grid: replica r's cell c is
    table row r * n_cells + c (its overflow bin r * (n_cells + 1) +
    n_cells in the rank sort), so a stable sort of the offset keys keeps
    each replica's order within its cells identical to its own sort, and
    its rows and stencils [R * N, ...] reach only its own particles.
    A single system runs as one replica.

    Slabs of a decomposition (``parallel/halo.py``, slabs on the leading
    axis) pass their owned + ghost rows with ``bin_lo`` / ``bin_hi`` [R, 3]
    covering each slab and its halo (the periodic box stays ``box_lo`` /
    ``box_hi``), ``owned`` [R, N] marking the rows that get a list (ghosts
    appear only as partners), and the slab axis not periodic (its images
    are explicit ghosts). Left as None they are the box and ``active``.
    """
    if x.dim() == 2:
        one = lambda t: t[None] if torch.is_tensor(t) else t
        out = cell_list_neighbors(
            x[None], active[None], box_lo[None], box_hi[None], one(cutoff),
            grid_dims, cell_cap, k_max, periodic, one(tilt), row_chunk,
            one(bin_lo), one(bin_hi), one(owned))
        return tuple(t[0] for t in out)
    if bin_lo is None:
        bin_lo = box_lo
    if bin_hi is None:
        bin_hi = box_hi
    if owned is None:
        owned = active
    R, N = x.shape[:2]
    dev = x.device
    D, off, pmask = grid_constants(tuple(grid_dims),
                                   tuple(bool(p) for p in periodic), dev)
    n_cells = int(grid_dims[0] * grid_dims[1] * grid_dims[2])
    cell_sz = (bin_hi - bin_lo) / D.to(x.dtype)  # [R, 3]
    x_bin = x if tilt is None else unshear_coords(x, box_lo, box_hi, tilt)
    cc = torch.floor((x_bin - bin_lo[:, None, :]) / cell_sz[:, None, :]).long()
    cc = torch.minimum(torch.clamp(cc, min=0), D - 1)
    cid = (cc[..., 0] * D[1] + cc[..., 1]) * D[2] + cc[..., 2]
    cid = torch.where(active, cid, n_cells)  # inactive -> overflow bin
    rep = torch.arange(R, device=dev)[:, None]  # [R, 1]

    # Rank within cell via a stable sort of the replica-offset keys.
    key = (cid + rep * (n_cells + 1)).reshape(-1)
    key_sorted, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(key_sorted, key_sorted, side="left")
    rank_sorted = torch.arange(R * N, device=dev) - starts
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    rank = rank.reshape(R, N)

    flat = torch.where((rank < cell_cap) & (cid < n_cells),
                       (cid + rep * n_cells) * cell_cap + rank,
                       R * n_cells * cell_cap)
    table = torch.full((R * n_cells * cell_cap + 1,), -1, dtype=torch.long,
                       device=dev)
    table.scatter_(0, flat.reshape(-1), torch.arange(R * N, device=dev))
    table = table[:-1].reshape(R * n_cells, cell_cap)

    per_cell = torch.zeros(R * (n_cells + 1), dtype=torch.long, device=dev)
    per_cell.index_add_(0, key, torch.ones_like(key))  # exact: integers
    cell_overflow = per_cell.reshape(R, n_cells + 1)[:, :n_cells].amax(-1)
    under = ((cell_sz < per_replica(cutoff, 0, 2) * (1.0 - 1e-6))
             & (D > 1)).any(-1)
    cell_overflow = torch.where(under,
                                torch.full_like(cell_overflow, 1 << 20),
                                cell_overflow)

    # Rows of all replicas, flattened replica-major: global slot r*N + i.
    cc_f, x_f, act_f = cc.reshape(-1, 3), x.reshape(-1, 3), active.reshape(-1)
    own_f = owned.reshape(-1)
    rep_f = torch.arange(R * N, device=dev) // N
    cut2 = per_replica(cutoff, 0, 2) ** 2  # [R, 1] (or a float)

    def stencil_rows(sl):
        cc_b, x_b, r_b = cc_f[sl], x_f[sl], rep_f[sl]
        self_b = torch.arange(R * N, device=dev)[sl]
        ncc = cc_b[:, None, :] + off[None, :, :]  # [C,27,3]
        oob = (ncc < 0) | (ncc >= D)
        ncc_ok = torch.where(pmask, torch.remainder(ncc, D),
                             torch.minimum(torch.clamp(ncc, min=0), D - 1))
        invalid_cell = (oob & ~pmask).any(-1)
        ncid = (ncc_ok[..., 0] * D[1] + ncc_ok[..., 1]) * D[2] + ncc_ok[..., 2]
        ncid = torch.where(invalid_cell, n_cells - 1, ncid)
        cand = table[r_b[:, None] * n_cells + ncid]  # [C, 27, cell_cap]
        cand = torch.where(invalid_cell[..., None], -1, cand)
        cand = cand.reshape(cand.shape[0], 27 * cell_cap)
        safe = torch.clamp(cand, min=0)
        # The row's replica's box (per row of the chunk).
        d = minimum_image(x_f[safe] - x_b[:, None, :], box_lo[r_b],
                          box_hi[r_b], periodic,
                          None if tilt is None else tilt[r_b])
        dist2 = (d * d).sum(-1)
        valid = ((cand >= 0) & (cand != self_b[:, None])
                 & (dist2 < (cut2[r_b] if torch.is_tensor(cut2) else cut2))
                 & act_f[safe]
                 & own_f[self_b][:, None])
        count = valid.sum(1)
        sel = stable_topk_true(valid, k_max)
        # Each replica's own slot numbers.
        local = torch.where(cand >= 0, cand - (r_b * N)[:, None], 0)
        return (torch.gather(local, 1, sel), torch.gather(valid, 1, sel),
                count)

    if row_chunk and R * N > row_chunk:
        outs = [stencil_rows(slice(s, s + row_chunk))
                for s in range(0, R * N, row_chunk)]
        idx, mask, count = (torch.cat(t) for t in zip(*outs))
    else:
        idx, mask, count = stencil_rows(slice(None))
    return (idx.reshape(R, N, -1), mask.reshape(R, N, -1),
            count.reshape(R, N), cell_overflow)


def remap_history(new_key, new_mask, old_key, old_mask, old_hist,
                  row_ok=None, chunk: int = 4096):
    """Carry spring state across a rebuild: per row, match new neighbour
    tags against old ones (masked equality join) and take the old spring;
    unmatched contacts start at zero. The [N, K, K] match tensor is built
    per ``chunk`` rows to bound memory. Rows are independent: replicas
    [R, N, K] run as R * N rows."""
    if new_key.dim() == 3:
        lead = new_key.shape[:2]
        rows = lambda t: None if t is None else t.reshape(
            (-1,) + t.shape[2:])
        return remap_history(
            rows(new_key), rows(new_mask), rows(old_key), rows(old_mask),
            rows(old_hist), rows(row_ok), chunk).reshape(
                lead + old_hist.shape[2:])
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
    L = per_replica(box_hi - box_lo, 1, x.dim())
    box_lo = per_replica(box_lo, 1, x.dim())
    if tilt is None:
        shifts = periodic_mask(torch.floor((x - box_lo) / L), periodic)
        return x - shifts * L, image + shifts.long()
    pm = [float(p) for p in periodic]
    L = L[..., 0], L[..., 1], L[..., 2]
    box_lo = box_lo[..., 0], box_lo[..., 1], box_lo[..., 2]
    tilt = per_replica(tilt, 1, x.dim())
    xy, xz, yz = tilt[..., 0], tilt[..., 1], tilt[..., 2]
    px, py, pz = x[..., 0], x[..., 1], x[..., 2]
    # Fractional coordinates by back-substitution through the
    # upper-triangular H = [a|b|c], from the original coordinates.
    f3 = (pz - box_lo[2]) / L[2]
    f2 = (py - box_lo[1] - yz * f3) / L[1]
    f1 = (px - box_lo[0] - xy * f2 - xz * f3) / L[0]
    n3 = torch.floor(f3) * pm[2]
    n2 = torch.floor(f2) * pm[1]
    n1 = torch.floor(f1) * pm[0]
    px = px - n1 * L[0] - n2 * xy - n3 * xz
    py = py - n2 * L[1] - n3 * yz
    pz = pz - n3 * L[2]
    shifts = torch.stack([n1, n2, n3], dim=-1)
    return torch.stack([px, py, pz], dim=-1), image + shifts.long()


def max_displacement2(x, x_build, active, box_lo, box_hi, periodic,
                      tilt=None):
    """Max squared displacement since the last build (skin trigger); one
    a replica ([R]) with a replica axis."""
    d = minimum_image(x - x_build, box_lo, box_hi, periodic, tilt)
    d2 = (d * d).sum(-1)
    return torch.where(active, d2, torch.zeros_like(d2)).amax(-1)


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


def max_approach(x, x_build, q, q_build, gmax_s, active,
                 box_lo, box_hi, periodic, tilt=None):
    """Max per-particle surface motion since the last build (the
    rotation-aware analogue of the max displacement; ``surface_motion``);
    one a replica ([R]) with a replica axis."""
    return surface_motion(x, x_build, q, q_build, gmax_s, active,
                          box_lo, box_hi, periodic, tilt).amax(-1)


def approach_ratio(x, x_build, q, q_build, gmax_s, budget, active,
                   box_lo, box_hi, periodic, tilt=None):
    """Rebuild trigger for the prefiltered pair list: max over particles
    of (surface motion since build) / (its recorded motion budget); one
    a replica ([R]) with a replica axis."""
    appr = surface_motion(x, x_build, q, q_build, gmax_s, active,
                          box_lo, box_hi, periodic, tilt)
    ratio = appr / budget.clamp(min=1e-30)
    return torch.where(active, ratio, torch.zeros_like(ratio)).amax(-1)
