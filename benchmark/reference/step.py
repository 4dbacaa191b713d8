"""One step of the system, worked out again, and the numbers that judge the
program's step against it.

Input: the program's state before the step (``before``) and after it
(``after``), each a dict of plain tensors over the active particles in
tag order: tag, x, v, q, angmom, f, tau, scale, shtype, box_lo, box_hi,
tilt; the pair list's rows as tag_i, tag_j and their springs (in the
row's own orientation); wall springs [N, W, 6] where there are walls;
``seam`` (sharded runs): the tags of owned particles with a partner
owned elsewhere. Springs are the system's state, so the reference starts
from the program's springs before the step; everything else it derives
itself from the blob coefficients.

What it checks:

* the integration: the reference takes the first half-kick, drift,
  rotation and deformation from ``before`` itself, and the law below
  runs at its poses; the program's positions (and box) and orientations
  after the step are held to these (``x_err``, ``q_err``), and its
  velocities and angular momenta to the reference's second half-kick
  with the reference's forces and torques (``v_err``, ``L_err``);
* the neighbour list: every pair the law finds in contact after the step
  is a row of the program's list (a brute-force search over all pairs
  whose bounding spheres overlap);
* the law: forces, torques and springs;
* the walls: the same on the particles touching a wall;
* on sharded runs, the forces on particles with a partner owned by
  another shard.
"""

from __future__ import annotations

import torch

from benchmark.reference import law, motion

PAIR_BLOCK = 2048
SEARCH_ROWS = 512


def _q99(t):
    if t.numel() == 0:
        return 0.0
    return float(torch.quantile(t.double(), 0.99))


def candidate_pairs(x, rb, box_lo, box_hi, tilt, periodic):
    """All pairs a < b (indices into x) whose bounding spheres overlap,
    by brute force in blocks of rows."""
    n = x.shape[0]
    out_a, out_b = [], []
    xf = x.float()
    for s in range(0, n, SEARCH_ROWS):
        a = torch.arange(s, min(s + SEARCH_ROWS, n), device=x.device)
        d = motion.minimum_image(xf[None, :, :] - xf[a, None, :],
                                 box_lo.float(), box_hi.float(), periodic,
                                 tilt.float())
        reach = (rb[a, None] + rb[None, :]).float() * 1.0001 + 1e-6
        hit = ((d * d).sum(-1) < reach * reach) & (
            torch.arange(n, device=x.device)[None, :] > a[:, None])
        ia, ib = torch.nonzero(hit, as_tuple=True)
        out_a.append(a[ia])
        out_b.append(ib)
    return torch.cat(out_a), torch.cat(out_b)


def _key(ta, tb, width):
    return ta * width + tb


def oriented_springs(tag_i, tag_j, spring, width):
    """Program rows as (key of (low tag, high tag), spring in that
    orientation): a reversed row's tangential part changes sign, its
    rolling part does not."""
    flip = tag_i > tag_j
    lo = torch.where(flip, tag_j, tag_i)
    hi = torch.where(flip, tag_i, tag_j)
    sgn = torch.ones_like(spring)
    sgn[:, :3] = torch.where(flip[:, None], -1.0, 1.0)
    return _key(lo, hi, width), spring * sgn


def lookup(keys, table_keys, table_vals, default=0.0):
    """Values of ``keys`` in a (keys, values) table (first match), and
    which keys were found."""
    if table_keys.numel() == 0:
        return (torch.full(keys.shape + table_vals.shape[1:], default,
                           dtype=table_vals.dtype, device=keys.device),
                torch.zeros_like(keys, dtype=torch.bool))
    order = torch.sort(table_keys, stable=True)
    pos = torch.searchsorted(order.values, keys).clamp(max=order.values.numel() - 1)
    found = order.values[pos] == keys
    vals = table_vals[order.indices[pos]]
    return torch.where(found.reshape(found.shape + (1,) * (vals.dim() - 1)),
                       vals, default), found


def run(shapes, cfg, before, after):
    """The reference step and the numbers. ``cfg``: lmax, conservative,
    mat [8], dt, gravity [3], periodic, deform_rate [3], shear_rate [3],
    walls (list of dicts, see ``law.wall_law``). Returns (numbers,
    details)."""
    dev = before["x"].device
    f64 = lambda t: t.to(torch.float64)
    if not torch.equal(before["tag"], after["tag"]):
        raise ValueError("the step changed the set of particles")
    tag = before["tag"]
    width = int(tag.max()) + 1
    ty, sc = before["shtype"], f64(before["scale"])
    m = shapes.mass(ty, sc)
    inertia = shapes.inertia_of(ty, sc)
    rb = shapes.rmax[ty] * sc
    dt = torch.tensor(cfg["dt"], dtype=torch.float64, device=dev)
    periodic = tuple(cfg["periodic"])

    # -- integration: first half-kick, drift, rotation, the box --------
    x1, v_half, q1, L_half = motion.first_half(
        f64(before["x"]), f64(before["v"]), f64(before["q"]),
        f64(before["angmom"]), f64(before["f"]), f64(before["tau"]), m,
        inertia, dt)
    box_lo, box_hi, tilt = (f64(before["box_lo"]), f64(before["box_hi"]),
                            f64(before["tilt"]))
    rate = torch.tensor(cfg["deform_rate"], dtype=torch.float64, device=dev)
    shear = torch.tensor(cfg["shear_rate"], dtype=torch.float64, device=dev)
    if bool((rate != 0).any() or (shear != 0).any()):
        x1, box_lo, box_hi, tilt = motion.deform(x1, box_lo, box_hi, tilt,
                                                 rate, shear, dt, periodic)
    # The program's positions (over the bounding radius) and box, and its
    # orientations, after the step against these.
    blo, bhi, btl = f64(after["box_lo"]), f64(after["box_hi"]), f64(after["tilt"])
    dx = motion.minimum_image(f64(after["x"]) - x1, blo, bhi, periodic, btl)
    box_gap = torch.cat([blo - box_lo, bhi - box_hi, btl - tilt]).abs().max()
    x_err = max(float((torch.linalg.norm(dx, dim=-1) / rb).max()),
                float(box_gap / rb.min()))
    qa = f64(after["q"])
    q_err = float(torch.minimum(torch.linalg.norm(qa - q1, dim=-1),
                                torch.linalg.norm(qa + q1, dim=-1)).max())

    # -- the law at the reference's poses after the step -----------------
    xa, blo, bhi, btl = x1, box_lo, box_hi, tilt
    om = motion.omega(q1, L_half, inertia)
    coef = shapes.coeffs[ty] * sc[:, None]
    side = dict(v=v_half, om=om, q=q1, m=m, rb=rb, rm=shapes.rmin[ty] * sc,
                rc=shapes.rchar[ty] * sc, coef=coef)
    ia, ib = candidate_pairs(xa, rb, blo, bhi, btl, periodic)
    k_in, s_in = oriented_springs(before["tag_i"], before["tag_j"],
                                  f64(before["spring"]), width)
    keys = _key(tag[ia], tag[ib], width)
    hist, _ = lookup(keys, k_in, s_in)
    mat = [torch.tensor(v, dtype=torch.float64, device=dev)
           for v in cfg["mat"]]
    n = xa.shape[0]
    F = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    T = torch.zeros_like(F)
    spring_out = torch.zeros((ia.numel(), 6), dtype=torch.float64, device=dev)
    on = torch.zeros(ia.numel(), dtype=torch.bool, device=dev)
    pe = torch.zeros((), dtype=torch.float64, device=dev)
    for s in range(0, ia.numel(), PAIR_BLOCK):
        a, b = ia[s:s + PAIR_BLOCK], ib[s:s + PAIR_BLOCK]
        d = motion.minimum_image(xa[b] - xa[a], blo, bhi, periodic, btl)
        pick = lambda idx: {k: v[idx] for k, v in side.items()}
        fo, ti, tj, so, pe_b, on_b = law.pair_law(
            pick(a), pick(b), d, hist[s:s + PAIR_BLOCK], mat, dt, shapes.cap,
            shapes.lmax, cfg["conservative"])
        F.index_add_(0, a, fo)
        F.index_add_(0, b, -fo)
        T.index_add_(0, a, ti)
        T.index_add_(0, b, tj)
        spring_out[s:s + PAIR_BLOCK] = so
        on[s:s + PAIR_BLOCK] = on_b
        pe = pe + pe_b.sum()

    # -- walls -----------------------------------------------------------
    wall_on = torch.zeros(n, dtype=torch.bool, device=dev)
    wall_pairs = []
    for w, wall in enumerate(cfg["walls"]):
        wall = {k: (torch.tensor(v, dtype=torch.float64, device=dev)
                    if k != "kind" else v) for k, v in wall.items()}
        p = dict(x=xa, **{k: side[k] for k in ("v", "q", "om", "m", "rb",
                                               "rc", "coef")})
        fw, tw, sw, onw, nw = [], [], [], [], []
        for s in range(0, n, PAIR_BLOCK):
            blk = {k: v[s:s + PAIR_BLOCK] for k, v in p.items()}
            out = law.wall_law(blk, wall, f64(before["wall_hist"][s:s + PAIR_BLOCK, w]),
                               mat, dt, shapes.cap, shapes.lmax)
            for acc, o in zip((fw, tw, sw, onw, nw), out):
                acc.append(o)
        F = F + torch.cat(fw)
        T = T + torch.cat(tw)
        wall_on |= torch.cat(onw)
        wall_pairs.append((torch.cat(sw), f64(after["wall_hist"][:, w]),
                           torch.cat(nw)))
    F = F + m[:, None] * torch.tensor(cfg["gravity"], dtype=torch.float64,
                                      device=dev)

    # -- the numbers ---------------------------------------------------------
    f_rms = float(torch.sqrt((F * F).sum(-1).mean()))
    t_rms = float(torch.sqrt((T * T).sum(-1).mean()))
    f_gap = torch.linalg.norm(f64(after["f"]) - F, dim=-1) / f_rms
    t_gap = torch.linalg.norm(f64(after["tau"]) - T, dim=-1) / t_rms
    # The second half-kick: the gaps over the rms of the kick itself.
    kick_v = 0.5 * dt * F / m[:, None]
    kick_L = 0.5 * dt * T
    v_gap = torch.linalg.norm(f64(after["v"]) - (v_half + kick_v), dim=-1)
    L_gap = torch.linalg.norm(f64(after["angmom"]) - (L_half + kick_L), dim=-1)
    v_err = _q99(v_gap / torch.sqrt((kick_v * kick_v).sum(-1).mean()))
    L_err = _q99(L_gap / torch.sqrt((kick_L * kick_L).sum(-1).mean()))

    k_out, s_prog = oriented_springs(after["tag_i"], after["tag_j"],
                                     f64(after["spring"]), width)
    in_list = lookup(keys, k_out, torch.zeros((k_out.numel(), 1),
                                              dtype=torch.float64,
                                              device=dev))[1]
    missing = int((on & ~in_list).sum())
    # Springs of the program's rows whose bounding spheres overlap (the
    # law also leaves a rolling residue on rows out of contact).
    s_ref, compared = lookup(k_out, keys, spring_out)
    s_rms = float(torch.sqrt((spring_out[on] ** 2).sum(-1).mean())) if bool(on.any()) else 1.0
    s_gap = [torch.linalg.norm(s_prog - s_ref, dim=-1)[compared] / s_rms]
    for ref_w, prog_w, near in wall_pairs:
        s_gap.append(torch.linalg.norm(prog_w - ref_w, dim=-1)[near] / s_rms)
    numbers = {
        "missing_pairs": missing,
        "force_err": _q99(f_gap),
        "force_err_max": float(f_gap.max()) if n else 0.0,
        "torque_err": _q99(t_gap),
        "torque_err_max": float(t_gap.max()) if n else 0.0,
        "spring_err": _q99(torch.cat(s_gap)),
        "x_err": x_err,
        "q_err": q_err,
        "v_err": v_err,
        "L_err": L_err,
    }
    if cfg["walls"]:
        numbers["wall_err"] = _q99(f_gap[wall_on])
    if "seam" in after:
        seam = torch.isin(tag, after["seam"])
        numbers["seam_err"] = _q99(f_gap[seam])
    details = {
        "contacts": int(on.sum()), "candidates": int(ia.numel()),
        "wall_contacts": int(wall_on.sum()), "pe_pair": float(pe),
        "f_rms": f_rms, "t_rms": t_rms,
        "spring_err_by_kind": [_q99(g) for g in s_gap],
    }
    return numbers, details
