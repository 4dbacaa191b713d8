"""Pair-contact kernels: packing, CUDA wrappers and their plain twins.

Three kernels, all hand-written CUDA C++ for sm_90a (``csrc/``):

* ``pair_contact_indexed`` — the stage-2 pair law
  (``csrc/pair_contact.cu``): both-sided cap quadrature, Hertz + damping
  + friction + rolling, in either elastic law: conservative (hand-derived
  gradient of the depth moments) or geometric (inclination-weighted
  measure, force along the integral normal); each with f32 or bfloat16
  Horner chains (K3, ``SPHERHARM_STAGE2_BF16=1`` for every call, as in
  the reference).
* ``stage1_depth`` — the r-only probe (``csrc/stage1_probe.cu``): upper
  bound on each pair's max depth, at a truncation degree l1 and in f32
  or bfloat16 (K4 is l1 = lmax in f32, what the prefilter runs; K5 the
  rest, with the reference's defaults l1 = 4, bf16).
* ``pair_reduce`` — the step's sums over the law's rows
  (``csrc/pair_reduce.cu``): each particle's force and torque over its
  rows of the pair list, the list's pe and virial, reading the list's
  live prefix alone.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs
its plain PyTorch twin on a CPU tensor; nothing else picks the route. A
wrapper counts its kernel launches in ``<wrapper>.launches``, a dict
keyed by variant.

The pair law has one CUDA entry, ``pair_contact_indexed``: every caller
(the step's ``contact.contact_force_pairs`` and ``contact_force_dense``,
``core/computes.py``, ``validation/conservative_probe.py``) hands it
the pair list by index. Each warp of the kernel gathers its pair's
packed row into shared memory from the particle rows, the pair indices,
the springs, the material table and the box, and forms the mask and the
minimum image itself, so no [P, 64] tensor is built; its output row also
carries d and the mask. On the CPU it packs the rows (``pack_indexed``)
and runs ``pair_contact``, the plain twin's entry on the reference's
packed layout, which takes CPU tensors only. Launches are counted in
``pair_contact.launches`` by variant. The benchmark keys on both names:
its configurations' ``kernels`` guard reads the launch counters by
variant (``pair_contact_geometric``, ``pair_contact_conservative``), and
its roofline readers find the law's device time by the kernel names
``pair_geometric_kernel`` and ``pair_conservative_kernel``.

Replicas (``parallel/ensemble.py``): the rows of R replicas come
replica-major, [R * P, 64], with ``par`` [R, 16], one row a replica; a
row's parameters are ``par[row // P]``. One launch serves all R. The
stage-1 probe reads no ``par`` and runs unchanged on such rows.

Inputs keep the reference's packed layout (``_SLOTS`` of
``spherharm_tpu/ops/contact_pallas.py``), so tests compare like with like.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from spherharm_tpu_torch.core import state as state_mod
from spherharm_tpu_torch.ops import contact, cuda_build, sh_power
from spherharm_tpu_torch.ops.rotation import quat_rotate, quat_rotate_inv
from spherharm_tpu_torch.utils import spans

# Packed per-pair input layout [P, F].
F_PACK = 64
SLOTS = {
    "xi": (0, 3), "vi": (3, 6), "qi": (6, 10), "omi": (10, 13),
    "mi": (13, 14), "rbi": (14, 15), "rmi": (15, 16), "rci": (16, 17),
    "xj": (17, 20), "vj": (20, 23), "qj": (23, 27), "omj": (27, 30),
    "mj": (30, 31), "rbj": (31, 32), "rmj": (32, 33), "rcj": (33, 34),
    "hist": (34, 40), "mask": (40, 41), "d": (41, 44),
    "tail": (44, 45),  # stage-1 truncation bound (zeroed: full basis)
    # Per-type-pair material row: kn, kt, gamma_n, gamma_t, mu, k_roll,
    # gamma_roll, mu_roll.
    "mat": (45, 53),
    "typ": (53, 55), "scl": (55, 57),  # shape-type ids (float), scales
}
# Output row: force 0:3, tau_i 3:6, tau_j 6:9, springs 9:15, pe 15,
# contact 16, zero padding to 24; ``pair_contact_indexed`` also writes
# the minimum-image d to 17:20 and the mask to 20 (a dead slot's row
# stays zero), ``pair_contact`` zeros there.
N_OUT = 24
N_PAR = 16


def pad_type_table(tbl):
    """Pad the per-type power table [T, W] to a multiple of 8 rows (all-
    zero, unreachable: type ids < T)."""
    T = tbl.shape[0]
    T8 = -(-T // 8) * 8
    return torch.nn.functional.pad(tbl, (0, 0, 0, T8 - T))


def pair_tables(shapes, params, dtype):
    """The law's inputs beside its rows: (tbl [T8, W] per-type power
    table, cap [4, G] contact cap grid, par [R, 16] with each replica's dt
    and materials, dt first), par in ``dtype``."""
    tbl = pad_type_table(shapes.power_tbl).contiguous()
    cap = torch.stack([shapes.cap_x, shapes.cap_glw, shapes.cap_cpsi,
                       shapes.cap_spsi])
    z = torch.zeros_like(params.dt)
    par = torch.stack([
        params.dt, params.kn, params.kt, params.gamma_n, params.gamma_t,
        params.mu, params.k_roll, params.gamma_roll, params.mu_roll,
        z, z, z, z, z, z, z,
    ], dim=-1).reshape(-1, N_PAR).to(dtype)
    return tbl, cap, par


def box_rows(box_lo, box_hi, tilt, lists: int):
    """The boxes ``pair_contact_indexed`` images by, one row a list
    (replica or shard): the edge lengths box_hi - box_lo [lists, 3], and
    for a triclinic box the tilt (xy, xz, yz) after them [lists, 6].
    Boxes and tilts [3] or [lists, 3]."""
    cols = [box_hi - box_lo] + ([] if tilt is None else [tilt])
    return torch.cat([c.reshape(-1, 3).expand(lists, 3) for c in cols],
                     dim=-1).contiguous()


def _pack(ri, rj, hist, mask, d, tail, mat, typ, scl):
    """Packed rows [P, 64] (``SLOTS``) from each slot's columns: the two
    particle rows (their first 17 columns), springs, mask, d, tail,
    material row, type ids and scales, in the particle rows' dtype."""
    f32 = ri.dtype
    packed = torch.cat(
        [ri[..., :17], rj[..., :17], hist.to(f32), mask.to(f32)[..., None],
         d.to(f32), tail.to(f32)[..., None], mat.to(f32), typ.to(f32),
         scl.to(f32)], dim=-1)
    return torch.nn.functional.pad(
        packed, (0, F_PACK - packed.shape[-1])).reshape(-1, F_PACK)


def pack_pairs(state, shapes, params, pi, pj, mask, hist, d, rows=None,
               probe_only: bool = False):
    """Kernel inputs from the particle-row table.

    Returns (packed [P, 64], tbl [T8, W] per-type power table,
    cap [4, G] contact cap grid, par [1, 16] with dt first). The first
    17 columns of ``contact.particle_rows`` match each side's slots.
    With a replica axis (pi, pj, mask, hist, d [R, P, ...]; state and
    params stacked) the rows come replica-major, [R * P, 64], and ``par``
    is [R, 16] with each replica's dt and materials."""
    if rows is None:
        rows = contact.particle_rows(state, shapes)
    rep = pi.dim() == 2
    at = lambda t, i: state_mod.take(t, i, rep)
    ti_t, tj_t = at(state.shtype, pi), at(state.shtype, pj)
    si, sj = at(state.scale, pi), at(state.scale, pj)
    # float32, as the kernels read it; a float64 state packs in float64
    # for the CPU twins (a CUDA wrapper refuses it).
    ri, rj = at(rows, pi), at(rows, pj)
    tail = shapes.tail1[ti_t] * si + shapes.tail1[tj_t] * sj
    if probe_only:
        # The r-only probe reads neither materials nor springs.
        mat = ri.new_zeros(pi.shape + (8,))
    else:
        mat = state_mod.pair_material(params, ti_t, tj_t)
    packed = _pack(ri, rj, hist, mask, d, tail, mat,
                   torch.stack([ti_t, tj_t], dim=-1),
                   torch.stack([si, sj], dim=-1))
    return (packed, *pair_tables(shapes, params, rows.dtype))


def pack_indexed(rows, typ, pi, pj, valid, hist, pair_tab, box, periodic):
    """What ``pair_contact_indexed``'s kernel gathers, as packed rows:
    (packed [P, 64], mask, d), mask and d shaped as pi. The mask is
    ``valid`` with both ends active, d the minimum image of x_j - x_i in
    ``box`` (``box_rows``); the tail column stays zero (the law does not
    read it)."""
    rep = pi.dim() == 2
    at = lambda t, i: state_mod.take(t, i, rep)
    ri, rj = at(rows, pi), at(rows, pj)
    mask = (valid & (ri[..., contact._RACT] > 0.5)
            & (rj[..., contact._RACT] > 0.5))
    d = contact.minimum_image_of(
        rj[..., contact._RX] - ri[..., contact._RX], box[..., :3], periodic,
        box[..., 3:] if box.shape[-1] == 6 else None)
    ti, tj = at(typ, pi), at(typ, pj)
    packed = _pack(ri, rj, hist, mask, d, torch.zeros_like(d[..., 0]),
                   state_mod.table_material(pair_tab, ti, tj),
                   torch.stack([ti, tj], dim=-1),
                   torch.stack([ri[..., contact._RS], rj[..., contact._RS]],
                               dim=-1))
    return packed, mask, d


def _col(packed, name):
    lo, hi = SLOTS[name]
    return packed[:, lo] if hi - lo == 1 else packed[:, lo:hi]


def _check_cuda(name, **tensors):
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, expected cuda")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, "
                            "expected float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# -- stage-2 pair contact ------------------------------------------------

# Stage-2 Horner chains in bfloat16 for every stage-2 call that does not
# choose (bf16=None): SPHERHARM_STAGE2_BF16=1, read at import, as the
# reference reads it (contact_pallas.py _STAGE2_BF16). In the conservative
# law the force is then the exact gradient of a ~1e-3-perturbed potential.
STAGE2_BF16 = os.environ.get("SPHERHARM_STAGE2_BF16", "0") == "1"

LAWS = ("conservative", "geometric")
VARIANTS = LAWS + tuple(f"{law}_bf16" for law in LAWS)


def rows_per_replica(P: int, par, name: str) -> int:
    """Rows a replica of a replica-major list [R * rows, ...] with ``par``
    [R, n] holds; raises unless P splits evenly."""
    R = par.shape[0] if par.dim() == 2 else 1
    if R < 1 or P % R:
        raise ValueError(f"{name}: {P} rows do not split into {R} replicas")
    return P // R


def pair_contact(packed, tbl, cap, par, lmax: int, conservative: bool = True,
                 bf16: bool | None = None):
    """The plain twin over packed rows, in the conservative or the
    geometric law: packed [P, 64] (``pack_pairs``, ``pack_indexed``), tbl
    [T, W] per-type power table, cap [4, G], par [R, 16]: R replicas'
    lists, replica-major, P / R rows each (R = 1 a single list). Returns
    [P, 24]. ``bf16`` runs the Horner chains in bfloat16 (K3's twin);
    None takes ``STAGE2_BF16``. CPU tensors only: on the card the law
    reads the pair list by index (``pair_contact_indexed``)."""
    if packed.device.type != "cpu":
        raise ValueError(f"pair_contact: packed rows on {packed.device}; the "
                         "CUDA entry of the law is pair_contact_indexed")
    if bf16 is None:
        bf16 = STAGE2_BF16
    par = par.reshape(-1, N_PAR)
    rpr = rows_per_replica(packed.shape[0], par, "pair_contact")
    # Rows are independent and masked rows are zeros: the twin runs on the
    # live rows only (a fixed-capacity list is mostly dead slots). Replicas
    # of the conservative law run a replica at a time, so that each
    # replica's rows form the very tensor its own run forms: its ``** 2.5``
    # (torch's CPU pow) rounds apart in a vector loop's body and its tail.
    # The geometric law takes every live row at once, each with its
    # replica's par row.
    blocks = ([(r, slice(r * rpr, (r + 1) * rpr))
               for r in range(par.shape[0])] if conservative
              else [(None, slice(None))])
    out = packed.new_zeros((packed.shape[0], N_OUT))
    for r, blk in blocks:
        sub = packed[blk]
        live = torch.nonzero(_col(sub, "mask") > 0.5).squeeze(1)
        if not live.numel():
            continue
        par_r = par if r is None else par[r:r + 1]
        if par_r.shape[0] > 1:
            par_r = par_r[live // rpr]
        if live.numel() == sub.shape[0]:
            out[blk] = pair_contact_plain(sub, tbl, cap, par_r, lmax,
                                          conservative, bf16)
        else:
            out[blk][live] = pair_contact_plain(
                sub[live], tbl, cap, par_r, lmax, conservative, bf16)
    return out


pair_contact.launches = {v: 0 for v in VARIANTS}


def _variant(conservative: bool, bf16: bool) -> str:
    return (LAWS[0] if conservative else LAWS[1]) + ("_bf16" if bf16 else "")


def pair_contact_indexed(rows, typ, pi, pj, valid, hist, pair_tab, tbl, cap,
                         par, box, periodic, lmax: int,
                         conservative: bool = True, bf16: bool | None = None):
    """The stage-2 pair law over a pair list read by index, in the
    conservative or the geometric law. rows [..., N, 20] (``contact.particle_rows``), typ [..., N]
    shape-type ids; pi, pj, valid [P] or, for R lists (replicas or
    shards), [R, P] with rows [R, N, 20]; hist [..., P, 6] springs (any
    row stride); pair_tab [T, T, 8], [1, 1, 8] or [R, T, T, 8]; tbl, cap,
    par as ``pair_tables`` gives them (par [1, 16] or one row a replica);
    box [R or 1, 3 | 6] (``box_rows``); periodic the three flags. A slot
    is live where ``valid`` holds and both ends are active.

    Returns [R * P, 24]: each slot's row (``N_OUT``; zeros where dead),
    with d in columns 17-19 and the mask in column 20. ``bf16`` runs the
    Horner chains in bfloat16 (K3); None takes ``STAGE2_BF16``. CUDA
    tensors launch ``sh_pair_contact_indexed`` (``csrc/pair_contact.cu``)
    once for all R: the kernel gathers each live slot's row; launches
    counted in ``pair_contact.launches`` by variant (law, ``_bf16``
    appended for K3), and ``pair.indexed`` (the slots gathered in the
    kernel) counted while spans are on. CPU tensors pack the rows
    (``pack_indexed``) and run the plain twin (``pair_contact``)."""
    if bf16 is None:
        bf16 = STAGE2_BF16
    par = par.reshape(-1, N_PAR)
    if rows.device.type == "cpu":
        packed, mask, d = pack_indexed(rows, typ, pi, pj, valid, hist,
                                       pair_tab, box, periodic)
        out = pair_contact(packed, tbl, cap, par, lmax, conservative, bf16)
        mask, d = mask.reshape(-1), d.reshape(-1, 3)
        out[:, 17:20] = torch.where(mask[:, None], d.to(out.dtype), 0.0)
        out[:, 20] = mask.to(out.dtype)
        return out
    h = hist.reshape(-1, hist.shape[-1])
    if h.stride(-1) != 1:
        h = h.contiguous()
    tab = pair_tab
    _check_cuda("pair_contact_indexed", rows=rows, tab=tab, tbl=tbl, cap=cap,
                par=par, box=box)
    if h.device.type != "cuda" or h.dtype != torch.float32:
        raise TypeError("pair_contact_indexed: hist must be float32 on "
                        f"cuda, not {h.dtype} on {h.device}")
    lists = pi.shape[0] if pi.dim() == 2 else 1
    ppl, P, N = pi.shape[-1], pi.numel(), rows.shape[-2]
    T, W, G = tbl.shape[0], tbl.shape[1], cap.shape[1]
    if (rows.shape[-1] != contact.ROW_W or typ.shape != rows.shape[:-1]
            or rows.numel() != lists * N * contact.ROW_W
            or pj.shape != pi.shape or valid.shape != pi.shape
            or valid.dtype != torch.bool or h.shape != (P, 6)
            or tab.shape[-1] != 8 or tab.shape[-2] != tab.shape[-3]
            or tab.dim() not in (3, 4)
            or (tab.dim() == 4 and tab.shape[0] != lists)
            or box.shape not in ((lists, 3), (lists, 6)) or cap.shape[0] != 4
            or W != sh_power.power_layout(lmax)["W"]):
        raise ValueError("pair_contact_indexed: bad input shapes "
                         f"rows {tuple(rows.shape)} typ {tuple(typ.shape)} "
                         f"pi {tuple(pi.shape)} pj {tuple(pj.shape)} "
                         f"valid {tuple(valid.shape)} {valid.dtype} "
                         f"hist {tuple(hist.shape)} tab {tuple(tab.shape)} "
                         f"box {tuple(box.shape)} tbl {tuple(tbl.shape)} "
                         f"cap {tuple(cap.shape)}")
    rpr = rows_per_replica(P, par, "pair_contact_indexed")
    idx = lambda t: t.reshape(-1).long().contiguous()
    typ, pi, pj = idx(typ), idx(pi), idx(pj)
    valid = valid.reshape(-1).contiguous()
    out = torch.empty((P, N_OUT), dtype=torch.float32, device=rows.device)
    if P:
        variant = _variant(conservative, bf16)
        err = cuda_build.library().sh_pair_contact_indexed(
            _ptr(rows), _ptr(typ), N, _ptr(pi), _ptr(pj), _ptr(valid), _ptr(h),
            h.stride(0), _ptr(tab), tab.shape[-2], int(tab.dim() == 4),
            _ptr(box), box.shape[-1], *(int(bool(p)) for p in periodic), ppl,
            _ptr(tbl), T, W, _ptr(cap), G, _ptr(par), lmax, P, rpr,
            int(conservative), int(bf16), _ptr(out), _stream(rows.device))
        cuda_build.check(err, f"pair_contact_indexed[{variant}]")
        pair_contact.launches[variant] += 1
        spans.count("pair.indexed", P)
    return out


def pair_contact_plain(packed, tbl, cap, par, lmax: int,
                       conservative: bool = True, bf16: bool = False):
    """Plain twin of the pair kernel. Conservative law: the inclination-
    free sampled elastic PE in the power basis, its gradient from
    ``torch.autograd.grad`` (``contact.pair_elastic_grad``), then damping,
    friction and rolling. Geometric law: the inclination-weighted probe
    (sin(gamma)^2 floored at 0, as the reference's Pallas kernel), Hertz +
    damping along the integral normal at the centroid, no autograd.
    ``bf16``: K3's surfaces (``contact.eval_radius``).
    Masked rows (mask column <= 0.5) output zeros, as the kernel's do.
    ``par`` [R, 16]: row p reads dt from ``par[p // (P / R)]``, as the
    kernel does."""
    c = lambda name: _col(packed, name)
    mask = c("mask") > 0.5
    d = c("d")
    q_i, q_j = c("qi"), c("qj")
    typ = c("typ").long()
    scl = c("scl")
    rb_i, rb_j = c("rbi"), c("rbj")
    geo = (scl[:, 0], scl[:, 1], tbl[typ[:, 0]], tbl[typ[:, 1]],
           rb_i, rb_j, c("rmi"), c("rmj"))
    cap = cap.unbind(0)

    dist = torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-24))
    inv_dist = 1.0 / dist
    cull = mask & (dist < rb_i + rb_j) & (dist > 1e-12)
    s1, s2, s1b, c1, c2, n1, n2 = contact._both_sides(
        d, q_i, q_j, geo, cap, lmax, incl=not conservative, bf16=bf16)
    denom = torch.clamp(s1, min=1e-30)
    cen = torch.where((s1 > 0)[:, None],
                      (c1 + c2 + s1b[:, None] * d) / denom[:, None], 0.5 * d)
    n_raw = n1 - n2
    nn = torch.sqrt(torch.clamp((n_raw * n_raw).sum(-1), min=1e-40))
    d_hat = d * inv_dist[:, None]
    n_hat = torch.where((nn > 1e-20)[:, None], n_raw / nn[:, None], -d_hat)
    in_contact = cull & (s1 > 0)
    zero = torch.zeros_like(s1)
    delta = torch.where(in_contact, 1.5 * s2 / denom, zero)

    rci, rcj = c("rci"), c("rcj")
    r_eff = rci * rcj / torch.clamp(rci + rcj, min=1e-12)
    mi, mj = c("mi"), c("mj")
    m_eff = mi * mj / torch.clamp(mi + mj, min=1e-30)
    poly = torch.sqrt(torch.clamp(delta * r_eff, min=0.0))
    R = par.shape[0] if par.dim() == 2 else 1
    if R == 1:
        dt = par.reshape(-1)[0]
    else:  # each row its replica's dt, a column against [P, 3]
        rpr = rows_per_replica(packed.shape[0], par, "pair_contact_plain")
        dt = par[:, 0].repeat_interleave(rpr)[:, None]
    kn, kt, gn, gt, mu, k_roll, g_roll, mu_roll = c("mat").unbind(-1)

    vi, vj, omi, omj = c("vi"), c("vj"), c("omi"), c("omj")
    arm_i = cen
    arm_j = cen - d
    v_rel = vi + contact._cross(omi, arm_i) - vj - contact._cross(omj, arm_j)
    vn_mag = (v_rel * n_hat).sum(-1)
    vt = v_rel - vn_mag[:, None] * n_hat
    fn_mag = torch.clamp(poly * (kn * delta - m_eff * gn * vn_mag), min=0.0)

    hist = c("hist")
    xi, f_t, xi_r, tau_roll = friction_rolling(
        hist[:, 0:3], hist[:, 3:6], n_hat, vt, in_contact, poly, fn_mag,
        m_eff, r_eff, omi - omj, dt, kt, gt, mu, k_roll, g_roll, mu_roll)

    if conservative:
        f_el, tau_ei, tau_ej = contact.pair_elastic_grad(
            d, q_i, q_j, geo, mask, kn, r_eff, cap, lmax, bf16)
        fn_damp = -(poly * m_eff * gn * vn_mag)
        f_vis = torch.where(in_contact[:, None],
                            fn_damp[:, None] * n_hat + f_t, 0.0)
        force = f_el + f_vis
        torque = tau_ei + contact._cross(arm_i, f_vis) + tau_roll
        torque_j = tau_ej + contact._cross(arm_j, -f_vis) - tau_roll
    else:
        force = torch.where(in_contact[:, None],
                            fn_mag[:, None] * n_hat + f_t, 0.0)
        torque = contact._cross(arm_i, force) + tau_roll
        torque_j = contact._cross(arm_j, -force) - tau_roll
    pe = torch.where(in_contact,
                     0.4 * kn * torch.sqrt(r_eff) * delta * delta
                     * torch.sqrt(delta), zero)
    out = torch.cat([force, torque, torque_j, xi, xi_r, pe[:, None],
                     in_contact.to(pe.dtype)[:, None]], dim=1)
    out = torch.nn.functional.pad(out, (0, N_OUT - out.shape[1]))
    return torch.where(mask[:, None], out, 0.0)


def friction_rolling(hist_t, hist_r, n_hat, vt, in_contact, poly, fn_mag,
                      m_eff, r_eff, dom, dt, kt, gt, mu, k_roll, g_roll,
                      mu_roll):
    """Tangential history spring with Coulomb cap + rolling spring-dashpot-
    slider (shared by the pair and wall twins). ``dom`` is the relative
    spin. Returns (xi, f_t, xi_r, tau_roll)."""
    cross = contact._cross
    col = lambda a: a[:, None]
    xi = hist_t - (hist_t * n_hat).sum(-1, keepdim=True) * n_hat
    xi = torch.where(col(in_contact), xi + vt * dt, 0.0)
    f_t = -col(poly) * (col(kt) * xi + col(m_eff * gt) * vt)
    ft_mag = torch.sqrt(torch.clamp((f_t * f_t).sum(-1), min=1e-30))
    capf = mu * fn_mag
    over = ft_mag > torch.clamp(capf, min=1e-30)
    f_t = f_t * col(torch.where(over, capf / ft_mag, 1.0))
    inv_poly = 1.0 / torch.clamp(poly, min=1e-30)
    xi = torch.where(
        col(over & (poly > 0)),
        -(f_t * col(inv_poly) + col(m_eff * gt) * vt)
        / col(torch.clamp(kt, min=1e-30)),
        xi)

    roll_on = (k_roll > 0) | (g_roll > 0)
    v_roll = -col(r_eff) * cross(n_hat, dom)
    xi_r = hist_r - (hist_r * n_hat).sum(-1, keepdim=True) * n_hat
    xi_r = torch.where(col(in_contact & roll_on), xi_r + v_roll * dt, 0.0)
    f_r = -(col(k_roll) * xi_r + col(g_roll) * v_roll)
    fr_mag = torch.sqrt(torch.clamp((f_r * f_r).sum(-1), min=1e-30))
    cap_r = mu_roll * fn_mag
    over_r = fr_mag > torch.clamp(cap_r, min=1e-30)
    f_r = f_r * col(torch.where(over_r, cap_r / fr_mag, 1.0))
    xi_r = torch.where(
        col(over_r & (k_roll > 0)),
        -(f_r + col(g_roll) * v_roll) / col(torch.clamp(k_roll, min=1e-30)),
        xi_r)
    tau_roll = torch.where(col(in_contact), col(r_eff) * cross(n_hat, f_r),
                           0.0)
    return xi, f_t, xi_r, tau_roll


# -- pair reduction --------------------------------------------------------

def pair_reduce(out, pi, pj, perm, both, valid, N: int):
    """The sums of ``contact.contact_force_pairs`` over the law's rows.
    out [..., P, 24] or [R * P, 24]: ``pair_contact_indexed``'s rows of
    the list pi, pj, valid, both [P] or, for R lists (replicas or shards),
    [R, P]; perm (``pair_jsort``) sorts pj stably, per list; N particles
    a list. pair_i is sorted, a list's live slots (``valid``) are a prefix
    of it, and its dead slots have zero rows and pair_i = pair_j = N - 1,
    as ``build_pair_list`` and ``prefilter_pair_list`` leave them.

    Returns (f [..., N, 3], tau [..., N, 3], pe_total [...], virial
    [..., 3, 3]): f and tau sum force and torque over a particle's pair_i
    rows, and -force and torque_j over its pair_j rows where the mask
    (column 20) and ``both`` hold; pe_total sums pe w and the virial is
    -sum w d (x) force, w = 1 where the mask and ``both`` hold, else 0.5.
    CUDA tensors launch ``sh_pair_reduce`` (``csrc/pair_reduce.cu``: the
    sums over the live prefix, then the totals; launches counted in
    ``pair_reduce.launches``); with spans on it counts ``pair.reduce_rows``
    (the slots the kernel read) and ``pair.live`` (the masked rows) from
    the kernel's stats row. CPU tensors run ``pair_reduce_plain`` (spans
    on: ``pair.live`` from the mask column)."""
    out = out.reshape(pi.shape + (N_OUT,))
    if out.device.type == "cpu":
        if spans.is_on():
            spans.count("pair.live", out[..., 20] > 0.5)
        return pair_reduce_plain(out, pi, pj, perm, both, N)
    _check_cuda("pair_reduce", out=out)
    lead, P = pi.shape[:-1], pi.shape[-1]
    lists = pi.shape[0] if pi.dim() == 2 else 1
    if (pi.dim() not in (1, 2) or N < 1 or P >= 2 ** 31
            or any(t.shape != pi.shape for t in (pj, perm, both, valid))
            or both.dtype != torch.bool or valid.dtype != torch.bool):
        raise ValueError("pair_reduce: bad inputs "
                         f"out {tuple(out.shape)} pi {tuple(pi.shape)} "
                         f"pj {tuple(pj.shape)} perm {tuple(perm.shape)} "
                         f"both {tuple(both.shape)} {both.dtype} "
                         f"valid {tuple(valid.shape)} {valid.dtype} N {N}")
    idx = lambda t: t.long().contiguous()
    pi, pj, perm = idx(pi), idx(pj), idx(perm)
    both, valid = both.contiguous(), valid.contiguous()
    dev = out.device
    lib = cuda_build.library()
    blocks = lib.sh_pair_reduce_blocks(N)
    f = torch.empty(lead + (N, 3), dtype=torch.float32, device=dev)
    tau = torch.empty_like(f)
    pe_total = torch.empty(lead, dtype=torch.float32, device=dev)
    virial = torch.empty(lead + (3, 3), dtype=torch.float32, device=dev)
    part = torch.empty((lists, blocks, 10), dtype=torch.float64, device=dev)
    part_n = torch.empty((lists, blocks), dtype=torch.int32, device=dev)
    stats = torch.empty((lists, 2), dtype=torch.int32, device=dev)
    err = lib.sh_pair_reduce(
        _ptr(out), _ptr(pi), _ptr(pj), _ptr(perm), _ptr(both), _ptr(valid), N,
        P, lists, _ptr(f), _ptr(tau), _ptr(pe_total), _ptr(virial), _ptr(part),
        _ptr(part_n), _ptr(stats), _stream(dev))
    cuda_build.check(err, "pair_reduce")
    pair_reduce.launches["pair_reduce"] += 1
    if spans.is_on():
        spans.count("pair.reduce_rows", stats[:, 0])
        spans.count("pair.live", stats[:, 1])
    return f, tau, pe_total, virial


pair_reduce.launches = {"pair_reduce": 0}


def pair_reduce_plain(out, pi, pj, perm, both, N: int):
    """Plain twin of ``pair_reduce`` (out [..., P, 24]): float64 prefix
    sums over every slot differenced at the segment bounds
    (``contact.sorted_segment_sum``), the j side permuted into pair_j
    order, pe and virial over every slot."""
    rep = pi.dim() == 2
    at = lambda t, i: state_mod.take(t, i, rep)
    force = out[..., 0:3]
    torque = out[..., 3:6]
    torque_j = out[..., 6:9]
    pe = out[..., 15]
    dp = out[..., 17:20]
    msk = out[..., 20] > 0.5
    # i side: pair_i is sorted by construction. j side (reaction,
    # half-list pairs only): permuted into pair_j order, so also a
    # sorted sum.
    acc_i = contact.sorted_segment_sum(torch.cat([force, torque], dim=-1), pi, N)
    w_j = (msk & both).to(force.dtype)[..., None]
    acc_j = contact.sorted_segment_sum(
        at(torch.cat([-force * w_j, torque_j * w_j], dim=-1), perm),
        at(pj, perm), N)
    f = acc_i[..., 0:3] + acc_j[..., 0:3]
    tau = acc_i[..., 3:6] + acc_j[..., 3:6]
    w_pe = torch.where(msk & both, 1.0, 0.5).to(pe.dtype)
    pe_total = (pe * w_pe).sum(-1)
    virial = -torch.einsum("rp,rpa,rpb->rab" if rep else "p,pa,pb->ab",
                           w_pe, dp, force)
    return f, tau, pe_total, virial


# -- stage-1 r-only probe ------------------------------------------------

def stage1_table(shapes, l1: int):
    """The stage-1 probe's per-type table at truncation degree l1:
    ``sh_power.build_power_tables_np(coeffs[:, :(l1+1)^2], l1)`` cut to its
    [T, (l1+1)^2] A/B prefix and padded as ``pad_type_table`` pads, on
    the shapes' device. A table built at degree l1 is a different table
    from the first (l1+1)^2 columns of the lmax table (whose runs hold
    degree lmax - m polynomials): only the former gives r truncated at
    l1, which the packed ``tail`` column (``shapes.tail1``, at
    ``shapes.l1``) bounds. At l1 = lmax it is the A/B prefix of
    ``shapes.power_tbl``."""
    nc = (l1 + 1) ** 2
    coeffs = shapes.coeffs.double().cpu().numpy()[:, :nc]
    tbl = sh_power.build_power_tables_np(coeffs, l1)[:, :nc]
    t = torch.tensor(np.asarray(tbl), dtype=shapes.coeffs.dtype,
                     device=shapes.coeffs.device)
    return pad_type_table(t).contiguous()


def _stage1_variant(truncated: bool, bf16: bool):
    """Launch-counter key: K4 is ``stage1_depth``; K5 adds ``_l1`` when
    l1 < lmax and ``_bf16`` with bf16."""
    return "stage1_depth" + ("_l1" if truncated else "") + (
        "_bf16" if bf16 else "")


def stage1_depth(packed, tbl1, cap1, lmax: int, l1: int = 4,
                 bf16: bool = True):
    """Upper bound on each pair's max signed depth [P] (r_target - rho over
    both probe directions, plus the tail column, plus 0.02 rsum with
    bf16). Pairs apart by their bounding spheres give rsum - dist; dead
    rows give -1e9. The defaults are the reference's
    (``stage1_depth_pallas``: l1 = 4, bf16, K5), kept so that a call
    without them means what it means there; the prefilter, the port's
    only caller, passes l1 = lmax, bf16 = False (K4) by name, with the
    tail column zeroed.
    tbl1: [T, (l1+1)^2] degree-l1 table (``stage1_table``; at l1 = lmax
    the A/B prefix of the power table); cap1: [4, G1]. l1 is capped at
    lmax. CUDA tensors launch ``csrc/stage1_probe.cu`` (launches counted
    per (l1 < lmax, bf16) in ``stage1_depth.launches``, ``_stage1_variant``
    keys); CPU tensors run ``stage1_depth_plain``."""
    l1 = min(l1, lmax)
    if packed.device.type == "cpu":
        return stage1_depth_plain(packed, tbl1, cap1, lmax, l1, bf16)
    _check_cuda("stage1_depth", packed=packed, tbl1=tbl1, cap1=cap1)
    P, T, W, G = (packed.shape[0], tbl1.shape[0], tbl1.shape[1],
                  cap1.shape[1])
    if (packed.shape[1] != F_PACK or cap1.shape[0] != 4
            or W != (l1 + 1) ** 2):
        raise ValueError("stage1_depth: bad input shapes "
                         f"{tuple(packed.shape)} {tuple(tbl1.shape)} "
                         f"{tuple(cap1.shape)} for l1={l1}")
    out = torch.empty((P,), dtype=torch.float32, device=packed.device)
    if P:
        variant = _stage1_variant(l1 < lmax, bf16)
        err = cuda_build.library().sh_stage1_depth(
            _ptr(packed), _ptr(tbl1), T, W, _ptr(cap1), G, l1, int(bf16), P,
            _ptr(out), _stream(packed.device))
        cuda_build.check(err, f"stage1_depth[{variant}]")
        stage1_depth.launches[variant] += 1
    return out


stage1_depth.launches = {_stage1_variant(tr, bf): 0
                         for tr in (False, True) for bf in (False, True)}


def stage1_depth_plain(packed, tbl1, cap1, lmax: int, l1: int = 4,
                       bf16: bool = True):
    """Plain twin of the stage-1 probe (direct tensor version), with the
    same arguments as ``stage1_depth``. With bf16 the rows are scaled
    first and the radius evaluates in bfloat16 (``sh_power.eval_power_r``).
    """
    l1 = min(l1, lmax)
    c = lambda name: _col(packed, name)
    cap_x, _, cap_cpsi, cap_spsi = cap1.unbind(0)
    d = c("d")
    dist = torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-24))
    inv_dist = 1.0 / dist
    rsum = c("rbi") + c("rbj")
    typ = c("typ").long()
    scl = c("scl")

    def radius(tbl, s, u):
        if bf16:
            return sh_power.eval_power_r(tbl * s[:, None],
                                         *contact._unit_trig(u), l1,
                                         bf16=True)
        return sh_power.eval_power_r(tbl, *contact._unit_trig(u),
                                     l1) * s[:, None]

    def side(q_a, q_b, tbl_a, tbl_b, s_a, s_b, rb_b, rm_a, rb_a, d3):
        e_b = quat_rotate_inv(q_a, d3 * inv_dist[:, None])
        rho_star = torch.sqrt(torch.clamp(dist * dist - rb_b * rb_b,
                                          min=0.0))
        rho_c = torch.minimum(torch.maximum(rho_star, rm_a), rb_a)
        cos_gmax = (rho_c * rho_c + dist * dist - rb_b * rb_b) / torch.clamp(
            2.0 * rho_c * dist, min=1e-12)
        cos_gmax = torch.clamp(cos_gmax, -1.0, 1.0 - 1e-6)
        one_m = (1.0 - cos_gmax)[:, None]
        cos_g = 1.0 - one_m * cap_x
        sin_g = torch.sqrt(torch.clamp(1.0 - cos_g * cos_g, min=0.0))
        t1, t2 = contact.orthobasis(e_b)
        dirs = (cos_g[..., None] * e_b[:, None, :]
                + (sin_g * cap_cpsi)[..., None] * t1[:, None, :]
                + (sin_g * cap_spsi)[..., None] * t2[:, None, :])
        r_a = radius(tbl_a, s_a, dirs)
        rel = quat_rotate(q_a[:, None, :], r_a[..., None] * dirs)
        u = quat_rotate_inv(q_b[:, None, :], rel - d3[:, None, :])
        rho = torch.sqrt(torch.clamp((u * u).sum(-1), min=1e-24))
        r_b = radius(tbl_b, s_b, u / rho[..., None])
        return (r_b - rho).amax(-1)

    tbl_i, tbl_j = tbl1[typ[:, 0]], tbl1[typ[:, 1]]
    s_i, s_j = scl[:, 0], scl[:, 1]
    m_ij = side(c("qi"), c("qj"), tbl_i, tbl_j, s_i, s_j, c("rbj"),
                c("rmi"), c("rbi"), d)
    m_ji = side(c("qj"), c("qi"), tbl_j, tbl_i, s_j, s_i, c("rbi"),
                c("rmj"), c("rbj"), -d)
    depth = torch.maximum(m_ij, m_ji) + c("tail")
    if bf16:
        depth = depth + 0.02 * rsum
    # Sphere-separated pairs are not probed but still report a valid
    # upper bound: surfaces lie inside the bounding spheres.
    depth = torch.where(dist < rsum, depth, rsum - dist)
    alive = (c("mask") > 0.5) & (dist > 1e-12)
    return torch.where(alive, depth, torch.full_like(depth, -1e9))
