"""Wall-contact kernel: packing, CUDA wrapper and its plain twin.

One kernel source (``csrc/wall_contact.cu``) with the wall kind as a
template parameter: plane (depth -(p - p0) . u0) and inside-of-cylinder
(depth |p_perp| - R). Per near-wall particle: cap toward the wall,
power-basis r / gradient / normal, inclination-weighted area, depth
moments against the analytic wall, then Hertz + friction + rolling
against the wall surface velocity v0 + W x c.

Packed layouts follow ``spherharm_tpu/ops/walls_pallas.py``: particle rows
[B, 32] (x 0:3, v 3:6, q 6:10, om 10:13, m 13, rmax 14, rchar 15, near 16,
depth_c 17, n_c 18:21, hist 21:27), params [1, 24] (dt, 8 materials, v0,
W, p0, u0, R). Unlike the reference's pre-scaled per-particle table rows
[B, W], the table is the pair kernels' unit-scale per-type one [T8, W]
(``contact_kernels.pad_type_table``), and each particle row carries its
shape type (slot 27) and scale (slot 28), as the pair rows do.

Replicas: R replicas' batches come replica-major, [R * B, 32], with
``par`` [R, 24]; row b reads ``par[b // B]`` (its replica's dt and
materials; the wall's geometry is the same in every row). One launch
serves all R.
"""

from __future__ import annotations

import torch

from spherharm_tpu_torch.ops import contact, cuda_build, sh_power
from spherharm_tpu_torch.ops.contact_kernels import (
    _check_cuda,
    _ptr,
    _stream,
    friction_rolling,
    pad_type_table,
    rows_per_replica,
)
from spherharm_tpu_torch.ops.rotation import quat_rotate, quat_rotate_inv

F_WALL = 32
N_PAR_WALL = 24
N_OUT_WALL = 16  # force 0:3, torque 3:6, hist 6:12, pe 12, contact 13
TYP, SCL = 27, 28  # shape-type id (float) and scale slots
KINDS = ("plane", "cylinder")
# Shared memory a block can take (H100: 227 KB), in floats: the kernel
# stages the [T8, W] table and the [4, G] cap grid.
SMEM_FLOATS = 232_448 // 4


def pack_wall(state, shapes, params, wall, hist, depth_c, n_c, om):
    """Build (packed, tbl, cap, par, kind) kernel inputs for one wall.

    depth_c / n_c: the wall's centre depth and inward normal at each
    particle centre; om: world-frame angular velocities. The wall's
    ``mat`` row (kn, kt, gamma_n, gamma_t, mu, k_roll, gamma_roll,
    mu_roll), where it has one, takes the place of the global materials
    in ``par[1:9]``. With a replica axis (state [R, B, ...], params
    stacked) the rows come replica-major, [R * B, 32], and ``par`` is
    [R, 24]: each replica's dt and materials, the same geometry."""
    from spherharm_tpu_torch.ops.walls import PlaneWall

    f32 = torch.float32
    m = shapes.mass_of(state.shtype, state.scale)
    rmax = shapes.rmax[state.shtype] * state.scale
    rchar = shapes.rchar[state.shtype] * state.scale
    near = state.active & (depth_c > -rmax)
    col = lambda t: t[..., None]
    packed = torch.cat([
        state.x, state.v, state.q, om, col(m), col(rmax), col(rchar),
        col(near).to(f32), col(depth_c), n_c, hist,
        col(state.shtype).to(f32), col(state.scale),
    ], dim=-1).to(f32)
    packed = torch.nn.functional.pad(
        packed, (0, F_WALL - packed.shape[-1])).reshape(-1, F_WALL)
    tbl = pad_type_table(shapes.power_tbl).contiguous()
    cap = torch.stack([shapes.cap_x, shapes.cap_glw, shapes.cap_cpsi,
                       shapes.cap_spsi])
    z = torch.zeros((), dtype=f32, device=packed.device)
    if isinstance(wall, PlaneWall):
        kind = "plane"
        v0 = wall.velocity
        Wv = torch.zeros(3, dtype=f32, device=packed.device)
        p0, u0, R = wall.point, wall.normal, z
    else:
        kind = "cylinder"
        Wv = wall.omega * wall.axis_dir
        v0 = -torch.linalg.cross(Wv, wall.axis_point)
        p0, u0, R = wall.axis_point, wall.axis_dir, wall.radius
    if wall.mat is not None:
        mat8 = list(wall.mat.unbind(0))
    else:
        mat8 = [params.kn, params.kt, params.gamma_n, params.gamma_t,
                params.mu, params.k_roll, params.gamma_roll, params.mu_roll]
    cols = [params.dt, *mat8, *v0.unbind(0), *Wv.unbind(0), *p0.unbind(0),
            *u0.unbind(0), R, z, z]
    # Per-replica parameters ([R]) spread the wall's geometry over R rows.
    par = torch.stack(torch.broadcast_tensors(*cols), dim=-1).reshape(
        -1, N_PAR_WALL).to(f32)
    return packed, tbl, cap, par, kind


def wall_contact_kernel(packed, tbl, cap, par, lmax: int, kind: str):
    """Wall contact over packed particle rows [B, 32] with the per-type
    table tbl [T8, W] and par [R, 24]: R replicas' batches, replica-major,
    B / R rows each (R = 1 a single batch), the wall's geometry (par
    slots 9-23) the same in every row, as ``pack_wall`` writes it.
    Returns [B, 16]. CUDA tensors
    launch ``csrc/wall_contact.cu`` once for all R (launches counted per
    kind in ``wall_contact_kernel.launches``); CPU tensors run
    ``wall_contact_plain``."""
    if kind not in KINDS:
        raise ValueError(f"unknown wall kind {kind!r}")
    par = par.reshape(-1, N_PAR_WALL)
    rpr = rows_per_replica(packed.shape[0], par, "wall_contact")
    if packed.device.type == "cpu":
        return wall_contact_plain(packed, tbl, cap, par, lmax, kind)
    _check_cuda("wall_contact", packed=packed, tbl=tbl, cap=cap, par=par)
    B, T, G = packed.shape[0], tbl.shape[0], cap.shape[1]
    W = sh_power.power_layout(lmax)["W"]
    if (packed.shape[1] != F_WALL or tbl.dim() != 2 or T == 0 or T % 8
            or tbl.shape[1] != W or cap.shape[0] != 4):
        raise ValueError("wall_contact: bad input shapes "
                         f"{tuple(packed.shape)} {tuple(tbl.shape)} "
                         f"{tuple(cap.shape)} {tuple(par.shape)}")
    if T * W + 4 * G > SMEM_FLOATS:
        raise ValueError(f"wall_contact: a [{T}, {W}] table and {G} cap "
                         "nodes exceed a block's shared memory")
    out = torch.empty((B, N_OUT_WALL), dtype=torch.float32,
                      device=packed.device)
    if B:
        err = cuda_build.library().sh_wall_contact(
            _ptr(packed), _ptr(tbl), T, W, _ptr(cap), G, _ptr(par), lmax, B,
            rpr, KINDS.index(kind), _ptr(out), _stream(packed.device))
        cuda_build.check(err, f"wall_contact[{kind}]")
        wall_contact_kernel.launches[kind] += 1
    return out


wall_contact_kernel.launches = {k: 0 for k in KINDS}


def wall_contact_plain(packed, tbl, cap, par, lmax: int, kind: str):
    """Plain twin of the wall kernel (direct tensor version): each
    particle's surface at unit scale from its type's table row, then r and
    its derivatives times its scale (``contact.eval_radius``), as the
    kernel evaluates it. ``par`` [R, 24]: row b reads ``par[b // (B /
    R)]``, as the kernel does."""
    col = lambda k: packed[:, k]
    vec = lambda lo: packed[:, lo:lo + 3]
    cap_x, cap_glw, cap_cpsi, cap_spsi = cap.unbind(0)
    par = par.reshape(-1, N_PAR_WALL)
    if par.shape[0] == 1:
        p = par.reshape(-1)
        node = lambda t: t
    else:  # each row its replica's parameters, against [B, ...] and [B, G, ...]
        rpr = rows_per_replica(packed.shape[0], par, "wall_contact_plain")
        p = par.repeat_interleave(rpr, dim=0)
        node = lambda t: t[:, None]
    dt = node(p[..., 0])
    kn, kt, gn, gt, mu, k_roll, g_roll, mu_roll = p[..., 1:9].unbind(-1)
    v0, Wv = p[..., 9:12], p[..., 12:15]
    p0, u0, R = node(p[..., 15:18]), node(p[..., 18:21]), node(p[..., 21])

    x, v, q, om = vec(0), vec(3), packed[:, 6:10], vec(10)
    m_eff, rmax, r_eff = col(13), col(14), col(15)
    near = col(16) > 0.5
    dc, nc = col(17), vec(18)

    e_b = quat_rotate_inv(q, -nc)
    cos_gmax = torch.clamp(-dc / torch.clamp(rmax, min=1e-12), -1.0,
                           1.0 - 1e-6)
    one_m = (1.0 - cos_gmax)[:, None]
    cos_g = 1.0 - one_m * cap_x
    sin_g = torch.sqrt(torch.clamp(1.0 - cos_g * cos_g, min=0.0))
    t1, t2 = contact.orthobasis(e_b)
    dirs = (cos_g[..., None] * e_b[:, None, :]
            + (sin_g * cap_cpsi)[..., None] * t1[:, None, :]
            + (sin_g * cap_spsi)[..., None] * t2[:, None, :])
    ct, st, cp, sp = contact._unit_trig(dirs)
    typ = col(TYP).long().clamp(0, tbl.shape[0] - 1)
    r, drt, drp = contact.eval_radius(tbl[typ], col(SCL), ct, st, cp, sp,
                                      lmax)
    nb = contact.surface_normal_trig(r, drt, drp, ct, st, cp, sp)
    cos_incl = torch.clamp((nb * dirs).sum(-1), 0.05, 1.0)
    dA = (one_m * cap_glw) * r * r / cos_incl

    rel = quat_rotate(q[:, None, :], r[..., None] * dirs)
    pw = x[:, None, :] + rel
    if kind == "plane":
        depth = -((pw - p0) * u0).sum(-1)
        n_at = u0.expand(pw.shape)
    else:
        r2 = pw - p0
        rv = r2 - (r2 * u0).sum(-1, keepdim=True) * u0
        rad = torch.sqrt(torch.clamp((rv * rv).sum(-1), min=1e-24))
        depth = rad - R
        n_at = -rv / rad[..., None]

    depth = torch.where(near[:, None], torch.clamp(depth, min=0.0), 0.0)
    wd = dA * depth
    s1 = wd.sum(-1)
    s2 = (wd * depth).sum(-1)
    in_contact = near & (s1 > 0)
    denom = torch.clamp(s1, min=1e-30)
    zero = torch.zeros_like(s1)
    delta = torch.where(in_contact, 1.5 * s2 / denom, zero)
    cen = torch.where(in_contact[:, None],
                      (wd[..., None] * rel).sum(-2) / denom[:, None], 0.0)
    nh = (wd[..., None] * n_at).sum(-2)
    nn = torch.sqrt(torch.clamp((nh * nh).sum(-1), min=1e-40))
    n_hat = torch.where((nn > 1e-10)[:, None],
                        nh / torch.clamp(nn, min=1e-12)[:, None], nc)

    cross = contact._cross
    v_rel = v + cross(om, cen) - (v0 + cross(Wv, x + cen))
    vn_mag = (v_rel * n_hat).sum(-1)
    vt = v_rel - vn_mag[:, None] * n_hat
    poly = torch.sqrt(torch.clamp(delta * r_eff, min=0.0))
    fn_mag = torch.clamp(poly * (kn * delta - m_eff * gn * vn_mag), min=0.0)
    bc = lambda s: s.expand(s1.shape)
    xi, f_t, xi_r, tau_roll = friction_rolling(
        packed[:, 21:24], packed[:, 24:27], n_hat, vt, in_contact, poly,
        fn_mag, m_eff, r_eff, om - Wv, dt, bc(kt), bc(gt), bc(mu),
        bc(k_roll), bc(g_roll), bc(mu_roll))
    force = torch.where(in_contact[:, None],
                        fn_mag[:, None] * n_hat + f_t, 0.0)
    torque = cross(cen, force) + tau_roll
    pe = torch.where(in_contact,
                     0.4 * kn * torch.sqrt(r_eff) * delta * delta
                     * torch.sqrt(delta), zero)
    out = torch.cat([force, torque, xi, xi_r, pe[:, None],
                     in_contact.to(pe.dtype)[:, None]], dim=1)
    return torch.nn.functional.pad(out, (0, N_OUT_WALL - out.shape[1]))
