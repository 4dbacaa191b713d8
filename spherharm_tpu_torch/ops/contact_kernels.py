"""Pair-contact kernels: packing, CUDA wrappers and their plain twins.

Two kernels, both hand-written CUDA C++ for sm_90a (``csrc/``):

* ``pair_contact`` — the stage-2 pair law (``csrc/pair_contact.cu``):
  both-sided cap quadrature, Hertz + damping + friction + rolling, in
  either elastic law: conservative (hand-derived gradient of the depth
  moments) or geometric (inclination-weighted measure, force along the
  integral normal); each with f32 or bfloat16 Horner chains (K3,
  ``SPHERHARM_STAGE2_BF16=1`` for every call, as in the reference).
* ``stage1_depth`` — the r-only probe (``csrc/stage1_probe.cu``): upper
  bound on each pair's max depth, at a truncation degree l1 and in f32
  or bfloat16 (K4 is l1 = lmax in f32, what the prefilter runs; K5 the
  rest, with the reference's defaults l1 = 4, bf16).

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs
its plain PyTorch twin on a CPU tensor; nothing else picks the route. A
wrapper counts its kernel launches in ``<wrapper>.launches``, a dict
keyed by variant.

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
# contact 16, zero padding to 24.
N_OUT = 24
N_PAR = 16


def pad_type_table(tbl):
    """Pad the per-type power table [T, W] to a multiple of 8 rows (all-
    zero, unreachable: type ids < T)."""
    T = tbl.shape[0]
    T8 = -(-T // 8) * 8
    return torch.nn.functional.pad(tbl, (0, 0, 0, T8 - T))


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
    f32 = rows.dtype
    ri = at(rows, pi)[..., :17].to(f32)
    rj = at(rows, pj)[..., :17].to(f32)
    tail = shapes.tail1[ti_t] * si + shapes.tail1[tj_t] * sj
    if probe_only:
        # The r-only probe reads neither materials nor springs.
        mat = ri.new_zeros(pi.shape + (8,))
    else:
        mat = state_mod.pair_material(params, ti_t, tj_t)
    typ = torch.stack([ti_t, tj_t], dim=-1).to(f32)
    scl = torch.stack([si, sj], dim=-1).to(f32)
    packed = torch.cat(
        [ri, rj, hist.to(f32), mask.to(f32)[..., None], d.to(f32),
         tail.to(f32)[..., None], mat.to(f32), typ, scl], dim=-1)
    packed = torch.nn.functional.pad(
        packed, (0, F_PACK - packed.shape[-1])).reshape(-1, F_PACK)
    tbl = pad_type_table(shapes.power_tbl).contiguous()
    cap = torch.stack([shapes.cap_x, shapes.cap_glw, shapes.cap_cpsi,
                       shapes.cap_spsi])
    z = torch.zeros_like(params.dt)
    par = torch.stack([
        params.dt, params.kn, params.kt, params.gamma_n, params.gamma_t,
        params.mu, params.k_roll, params.gamma_roll, params.mu_roll,
        z, z, z, z, z, z, z,
    ], dim=-1).reshape(-1, N_PAR).to(f32)
    return packed, tbl, cap, par


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

# Stage-2 Horner chains in bfloat16 for every pair_contact call that does
# not choose (bf16=None): SPHERHARM_STAGE2_BF16=1, read at import, as the
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
    """Pair contact over packed rows in the conservative or the geometric
    law. packed [P, 64], tbl [T, W] per-type power table, cap [4, G],
    par [R, 16]: R replicas' lists, replica-major, P / R rows each (R = 1
    a single list). Returns [P, 24]. ``bf16`` runs the Horner chains in
    bfloat16 (K3); None takes ``STAGE2_BF16``. CUDA tensors launch
    ``csrc/pair_contact.cu`` once for all R (launches counted per variant
    in ``pair_contact.launches``: law, ``_bf16`` appended for K3); CPU
    tensors run ``pair_contact_plain``."""
    if bf16 is None:
        bf16 = STAGE2_BF16
    par = par.reshape(-1, N_PAR)
    rpr = rows_per_replica(packed.shape[0], par, "pair_contact")
    if packed.device.type == "cpu":
        # Rows are independent and masked rows are zeros: the twin runs on
        # the live rows only (a fixed-capacity list is mostly dead slots).
        # Replicas of the conservative law run a replica at a time, so
        # that each replica's rows form the very tensor its own run forms:
        # its ``** 2.5`` (torch's CPU pow) rounds apart in a vector loop's
        # body and its tail. The geometric law takes every live row at
        # once, each with its replica's par row.
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
    _check_cuda("pair_contact", packed=packed, tbl=tbl, cap=cap, par=par)
    P, T, W, G = packed.shape[0], tbl.shape[0], tbl.shape[1], cap.shape[1]
    if (packed.shape[1] != F_PACK or cap.shape[0] != 4 or par.dim() != 2
            or par.shape[1] != N_PAR or W != sh_power.power_layout(lmax)["W"]):
        raise ValueError("pair_contact: bad input shapes "
                         f"{tuple(packed.shape)} {tuple(tbl.shape)} "
                         f"{tuple(cap.shape)} {tuple(par.shape)}")
    out = torch.empty((P, N_OUT), dtype=torch.float32, device=packed.device)
    if P:
        variant = (LAWS[0] if conservative else LAWS[1]) + (
            "_bf16" if bf16 else "")
        err = cuda_build.library().sh_pair_contact(
            _ptr(packed), _ptr(tbl), T, W, _ptr(cap), G, _ptr(par), lmax,
            P, rpr, int(conservative), int(bf16), _ptr(out),
            _stream(packed.device))
        cuda_build.check(err, f"pair_contact[{variant}]")
        pair_contact.launches[variant] += 1
    return out


pair_contact.launches = {v: 0 for v in VARIANTS}


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
