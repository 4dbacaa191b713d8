"""The contact law, plain PyTorch in float64.

For each pair (i, j) a patch-local cap grid on i's surface facing j is
tested against j's surface, and the mirrored pass j into i:

  depth_k = max(r_j(u_k) - rho_k, 0),  S1 = sum A_k depth_k,
  S2 = sum A_k depth_k^2,  delta = 1.5 S2 / S1,
  U = 0.4 kn sqrt(R_eff) delta^2.5,

with A_k = w_k r^2 (conservative law: the elastic force and torques are
the exact gradient of U, here by autograd) or A_k = w_k r^2 / cos(incl)
(geometric law: the Hertz force along the integral normal at the overlap
centroid). Normal damping, a Coulomb-capped tangential spring and a
rolling spring-dashpot-slider act on top (LAMMPS gran/hertz/history with
rolling resistance). Walls (planes and the drum's rotating cylinder) take
the geometric law against the analytic wall surface.

Every radius comes from the direct harmonic sum of ``sh.surface``.
"""

from __future__ import annotations

import torch

from benchmark.reference.motion import cross, quat_rotate, quat_rotate_inv
from benchmark.reference.sh import surface, unit_trig


def normal_from_trig(r, drt, drp, ct, st, cp, sp):
    """Outward unit normal e_r - (r_t / r) e_t - (r_p / (r sin t)) e_p."""
    inv_r = 1.0 / torch.clamp(r, min=1e-12)
    inv_rs = inv_r / torch.clamp(st.abs(), min=1e-6)
    a, b = drt * inv_r, drp * inv_rs
    n = torch.stack([st * cp - a * ct * cp + b * sp,
                     st * sp - a * ct * sp - b * cp,
                     ct + a * st], dim=-1)
    return n / torch.sqrt(torch.clamp((n * n).sum(-1, keepdim=True),
                                      min=1e-24))


def orthobasis(e):
    """(t1, t2) around unit e: h = x-axis unless |e_x| >= 0.9."""
    use_x = e[..., 0:1].abs() < 0.9
    h = torch.cat([use_x, ~use_x, torch.zeros_like(use_x)], -1).to(e.dtype)
    t1 = cross(e, h)
    t1 = t1 / torch.sqrt(torch.clamp((t1 * t1).sum(-1, keepdim=True),
                                     min=1e-24))
    return t1, cross(e, t1)


def cap_dirs(e, cos_gmax, cap):
    """Cap node directions [P, G, 3] about the unit axis e [P, 3] out to
    polar angle acos(cos_gmax), and the node weights' cap factor."""
    cap_x, cap_w, cap_c, cap_s = cap
    one_m = (1.0 - cos_gmax)[:, None]
    cos_g = 1.0 - one_m * cap_x
    sin_g = torch.sqrt(torch.clamp(1.0 - cos_g ** 2, min=0.0))
    t1, t2 = orthobasis(e)
    dirs = (cos_g[..., None] * e[:, None, :]
            + (sin_g * cap_c)[..., None] * t1[:, None, :]
            + (sin_g * cap_s)[..., None] * t2[:, None, :])
    return dirs, one_m * cap_w


def probe(q_a, c_a, q_b, c_b, rb_b, rm_a, rb_a, d, cap, lmax, incl):
    """a's cap nodes against b (d = x_b - x_a). Returns S1, S2, the
    centroid numerator (from x_a) and b's normal numerator."""
    dist = torch.linalg.norm(d, dim=-1)
    e = quat_rotate_inv(q_a, d / torch.clamp(dist, min=1e-12)[:, None])
    rho2 = dist ** 2 - rb_b ** 2
    rho_star = torch.where(rho2 > 0, torch.sqrt(torch.where(rho2 > 0, rho2,
                                                            1.0)), 0.0 * rho2)
    rho_c = torch.minimum(torch.maximum(rho_star, rm_a), rb_a)
    cos_gmax = torch.clamp((rho_c ** 2 + dist ** 2 - rb_b ** 2)
                           / torch.clamp(2.0 * rho_c * dist, min=1e-12),
                           -1.0, 1.0 - 1e-6)
    dirs, w = cap_dirs(e, cos_gmax, cap)
    trig_a = unit_trig(dirs)
    r_a, drt_a, drp_a = surface(c_a, *trig_a, lmax)
    dA = w * r_a ** 2
    if incl:
        n_a = normal_from_trig(r_a, drt_a, drp_a, *trig_a)
        dA = dA / torch.clamp((n_a * dirs).sum(-1), 0.05, 1.0)
    rel = quat_rotate(q_a[:, None, :], r_a[..., None] * dirs)
    u = quat_rotate_inv(q_b[:, None, :], rel - d[:, None, :])
    rho = torch.linalg.norm(u, dim=-1)
    trig_b = unit_trig(u / torch.clamp(rho, min=1e-12)[..., None])
    r_b, drt_b, drp_b = surface(c_b, *trig_b, lmax)
    depth = torch.clamp(r_b - rho, min=0.0)
    wd = dA * depth
    n_b = quat_rotate(q_b[:, None, :],
                      normal_from_trig(r_b, drt_b, drp_b, *trig_b))
    return (wd.sum(-1), (wd * depth).sum(-1), (wd[..., None] * rel).sum(-2),
            (wd[..., None] * n_b).sum(-2))


def both_sides(d, q_i, q_j, geo, cap, lmax, incl):
    c_i, c_j, rb_i, rb_j, rm_i, rm_j = geo
    s1a, s2a, c1, n1 = probe(q_i, c_i, q_j, c_j, rb_j, rm_i, rb_i, d, cap,
                             lmax, incl)
    s1b, s2b, c2, n2 = probe(q_j, c_j, q_i, c_i, rb_i, rm_j, rb_j, -d, cap,
                             lmax, incl)
    return s1a + s1b, s2a + s2b, s1b, c1, c2, n1, n2


def elastic_pe(d, q_i, q_j, geo, kn, r_eff, cap, lmax):
    """The conservative law's sampled elastic energy per pair."""
    dist = torch.linalg.norm(d, dim=-1)
    s1, s2 = both_sides(d, q_i, q_j, geo, cap, lmax, incl=False)[:2]
    on = (dist < geo[2] + geo[3]) & (s1 > 0)
    delta = torch.where(on, 1.5 * s2 / torch.clamp(s1, min=1e-300), 0.0)
    return torch.where(on, 0.4 * kn * torch.sqrt(r_eff)
                       * torch.clamp(delta, min=0.0) ** 2.5, 0.0)


def quat_torque(q, gq):
    """World torque from dU/dq of unit quaternions: tau_k = -0.5 <dU/dq,
    e_k (x) q>."""
    from benchmark.reference.motion import quat_multiply

    e = torch.eye(4, dtype=q.dtype, device=q.device)[1:]
    eq = quat_multiply(e[None, :, :], q[:, None, :])
    return -0.5 * (gq[:, None, :] * eq).sum(-1)


def elastic_grad(d, q_i, q_j, geo, kn, r_eff, cap, lmax):
    """Force on i and both torques as the exact gradient of elastic_pe."""
    with torch.enable_grad():
        d_ = d.detach().requires_grad_(True)
        qi_ = q_i.detach().requires_grad_(True)
        qj_ = q_j.detach().requires_grad_(True)
        pe = elastic_pe(d_, qi_, qj_, geo, kn, r_eff, cap, lmax)
        gd, gqi, gqj = torch.autograd.grad(pe.sum(), (d_, qi_, qj_))
    ti, tj = quat_torque(q_i, gqi), quat_torque(q_j, gqj)
    ok = (torch.isfinite(gd).all(-1) & torch.isfinite(ti).all(-1)
          & torch.isfinite(tj).all(-1))[:, None]
    return (torch.where(ok, gd, 0.0), torch.where(ok, ti, 0.0),
            torch.where(ok, tj, 0.0))


def friction_rolling(hist_t, hist_r, n_hat, vt, on, poly, fn_mag, m_eff,
                     r_eff, dom, dt, kt, gt, mu, k_roll, g_roll, mu_roll):
    """Tangential spring with Coulomb cap and rolling spring-dashpot-
    slider. Returns (xi, f_t, xi_r, tau_roll)."""
    col = lambda a: a[:, None]
    xi = hist_t - (hist_t * n_hat).sum(-1, keepdim=True) * n_hat
    xi = torch.where(col(on), xi + vt * dt, 0.0)
    f_t = -col(poly) * (col(kt) * xi + col(m_eff * gt) * vt)
    ft = torch.sqrt(torch.clamp((f_t * f_t).sum(-1), min=1e-30))
    capf = mu * fn_mag
    over = ft > torch.clamp(capf, min=1e-30)
    f_t = f_t * col(torch.where(over, capf / ft, 1.0))
    xi = torch.where(col(over & (poly > 0)),
                     -(f_t / col(torch.clamp(poly, min=1e-30))
                       + col(m_eff * gt) * vt) / col(torch.clamp(kt, min=1e-30)),
                     xi)
    roll_on = (k_roll > 0) | (g_roll > 0)
    v_roll = -col(r_eff) * cross(n_hat, dom)
    xi_r = hist_r - (hist_r * n_hat).sum(-1, keepdim=True) * n_hat
    xi_r = torch.where(col(on & roll_on), xi_r + v_roll * dt, 0.0)
    f_r = -(col(k_roll) * xi_r + col(g_roll) * v_roll)
    fr = torch.sqrt(torch.clamp((f_r * f_r).sum(-1), min=1e-30))
    cap_r = mu_roll * fn_mag
    over_r = fr > torch.clamp(cap_r, min=1e-30)
    f_r = f_r * col(torch.where(over_r, cap_r / fr, 1.0))
    xi_r = torch.where(col(over_r & (k_roll > 0)),
                       -(f_r + col(g_roll) * v_roll)
                       / col(torch.clamp(k_roll, min=1e-30)), xi_r)
    tau_roll = torch.where(col(on), col(r_eff) * cross(n_hat, f_r), 0.0)
    return xi, f_t, xi_r, tau_roll


def pair_law(side_i, side_j, d, hist, mat, dt, cap, lmax, conservative):
    """One block of pairs. ``side_*``: dicts of per-pair tensors (v, om, q,
    m, rb, rm, rc, coef: the particle's coefficients times its scale);
    d = x_j - x_i (minimum image); hist [P, 6] springs in; mat [8] the
    material (kn, kt, gamma_n, gamma_t, mu, k_roll, gamma_roll,
    mu_roll). Returns force on i, torque on i, torque on j, springs out
    [P, 6], pe [P], in contact [P] (bool)."""
    geo = (side_i["coef"], side_j["coef"], side_i["rb"], side_j["rb"],
           side_i["rm"], side_j["rm"])
    dist = torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-24))
    cull = (dist < side_i["rb"] + side_j["rb"]) & (dist > 1e-12)
    s1, s2, s1b, c1, c2, n1, n2 = both_sides(
        d, side_i["q"], side_j["q"], geo, cap, lmax, incl=not conservative)
    denom = torch.clamp(s1, min=1e-300)
    cen = torch.where((s1 > 0)[:, None],
                      (c1 + c2 + s1b[:, None] * d) / denom[:, None], 0.5 * d)
    n_raw = n1 - n2
    nn = torch.sqrt(torch.clamp((n_raw * n_raw).sum(-1), min=1e-300))
    n_hat = torch.where((nn > 1e-20)[:, None], n_raw / nn[:, None],
                        -d / dist[:, None])
    on = cull & (s1 > 0)
    delta = torch.where(on, 1.5 * s2 / denom, 0.0)
    rci, rcj = side_i["rc"], side_j["rc"]
    r_eff = rci * rcj / torch.clamp(rci + rcj, min=1e-12)
    mi, mj = side_i["m"], side_j["m"]
    m_eff = mi * mj / torch.clamp(mi + mj, min=1e-30)
    poly = torch.sqrt(torch.clamp(delta * r_eff, min=0.0))
    kn, kt, gn, gt, mu, k_roll, g_roll, mu_roll = [m.expand(s1.shape)
                                                   for m in mat]
    arm_i, arm_j = cen, cen - d
    v_rel = (side_i["v"] + cross(side_i["om"], arm_i)
             - side_j["v"] - cross(side_j["om"], arm_j))
    vn = (v_rel * n_hat).sum(-1)
    vt = v_rel - vn[:, None] * n_hat
    fn_mag = torch.clamp(poly * (kn * delta - m_eff * gn * vn), min=0.0)
    xi, f_t, xi_r, tau_roll = friction_rolling(
        hist[:, 0:3], hist[:, 3:6], n_hat, vt, on, poly, fn_mag, m_eff,
        r_eff, side_i["om"] - side_j["om"], dt, kt, gt, mu, k_roll, g_roll,
        mu_roll)
    if conservative:
        f_el, t_ei, t_ej = elastic_grad(d, side_i["q"], side_j["q"], geo, kn,
                                        r_eff, cap, lmax)
        f_vis = torch.where(on[:, None], -(poly * m_eff * gn * vn)[:, None]
                            * n_hat + f_t, 0.0)
        force = f_el + f_vis
        torque = t_ei + cross(arm_i, f_vis) + tau_roll
        torque_j = t_ej + cross(arm_j, -f_vis) - tau_roll
    else:
        force = torch.where(on[:, None], fn_mag[:, None] * n_hat + f_t, 0.0)
        torque = cross(arm_i, force) + tau_roll
        torque_j = cross(arm_j, -force) - tau_roll
    pe = torch.where(on, 0.4 * kn * torch.sqrt(r_eff) * delta ** 2.5, 0.0)
    return force, torque, torque_j, torch.cat([xi, xi_r], -1), pe, on


def wall_law(p, wall, hist, mat, dt, cap, lmax):
    """Particles p (dict: x, v, q, om, m, rb, rc, coef) against one wall
    (dict: kind "plane" with point, normal, velocity; or "cylinder" with
    axis_point, axis_dir, radius, omega). Returns force, torque, springs
    out [B, 6], in contact [B], near (bounding sphere reaching the wall)."""
    x = p["x"]
    if wall["kind"] == "plane":
        dc = -((x - wall["point"]) * wall["normal"]).sum(-1)
        nc = wall["normal"].expand(x.shape)
    else:
        rel = x - wall["axis_point"]
        rv = rel - (rel * wall["axis_dir"]).sum(-1, keepdim=True) * wall["axis_dir"]
        rad = torch.linalg.norm(rv, dim=-1)
        dc = rad - wall["radius"]
        nc = -rv / torch.clamp(rad, min=1e-12)[:, None]
    near = dc > -p["rb"]
    e = quat_rotate_inv(p["q"], -nc)
    cos_gmax = torch.clamp(-dc / torch.clamp(p["rb"], min=1e-12), -1.0,
                           1.0 - 1e-6)
    dirs, w = cap_dirs(e, cos_gmax, cap)
    trig = unit_trig(dirs)
    r, drt, drp = surface(p["coef"], *trig, lmax)
    nb = normal_from_trig(r, drt, drp, *trig)
    dA = w * r * r / torch.clamp((nb * dirs).sum(-1), 0.05, 1.0)
    rel = quat_rotate(p["q"][:, None, :], r[..., None] * dirs)
    pw = x[:, None, :] + rel
    if wall["kind"] == "plane":
        depth = -((pw - wall["point"]) * wall["normal"]).sum(-1)
        n_at = wall["normal"].expand(pw.shape)
        v0 = wall["velocity"]
        W = torch.zeros_like(v0)
    else:
        r2 = pw - wall["axis_point"]
        rv = r2 - (r2 * wall["axis_dir"]).sum(-1, keepdim=True) * wall["axis_dir"]
        radn = torch.sqrt(torch.clamp((rv * rv).sum(-1), min=1e-24))
        depth = radn - wall["radius"]
        n_at = -rv / radn[..., None]
        W = wall["omega"] * wall["axis_dir"]
        v0 = -cross(W, wall["axis_point"])
    depth = torch.where(near[:, None], torch.clamp(depth, min=0.0), 0.0)
    wd = dA * depth
    s1, s2 = wd.sum(-1), (wd * depth).sum(-1)
    on = near & (s1 > 0)
    denom = torch.clamp(s1, min=1e-300)
    delta = torch.where(on, 1.5 * s2 / denom, 0.0)
    cen = torch.where(on[:, None], (wd[..., None] * rel).sum(-2)
                      / denom[:, None], 0.0)
    nh = (wd[..., None] * n_at).sum(-2)
    nn = torch.sqrt(torch.clamp((nh * nh).sum(-1), min=1e-300))
    n_hat = torch.where((nn > 1e-10)[:, None],
                        nh / torch.clamp(nn, min=1e-12)[:, None], nc)
    v_rel = p["v"] + cross(p["om"], cen) - (v0 + cross(W, x + cen))
    vn = (v_rel * n_hat).sum(-1)
    vt = v_rel - vn[:, None] * n_hat
    m_eff, r_eff = p["m"], p["rc"]
    poly = torch.sqrt(torch.clamp(delta * r_eff, min=0.0))
    kn, kt, gn, gt, mu, k_roll, g_roll, mu_roll = mat
    fn_mag = torch.clamp(poly * (kn * delta - m_eff * gn * vn), min=0.0)
    one = torch.ones_like(s1)
    xi, f_t, xi_r, tau_roll = friction_rolling(
        hist[:, 0:3], hist[:, 3:6], n_hat, vt, on, poly, fn_mag, m_eff,
        r_eff, p["om"] - W, dt, kt * one, gt * one, mu * one, k_roll * one,
        g_roll * one, mu_roll * one)
    force = torch.where(on[:, None], fn_mag[:, None] * n_hat + f_t, 0.0)
    torque = cross(cen, force) + tau_roll
    return force, torque, torch.cat([xi, xi_r], -1), on, near
