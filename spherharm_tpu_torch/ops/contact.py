"""SH contact narrow phase: pair list, prefilter, and the plain contact law.

Torch twin of the main-path parts of ``spherharm_tpu/ops/contact.py``.
For each pair (i, j) a patch-local cap grid on i's surface facing j is
tested against j's surface (and the mirrored pass, j into i):

  depth_k = max(r_j(u_k) - rho_k, 0),  S1 = sum A_k depth_k,
  S2 = sum A_k depth_k^2,  delta = 1.5 S2 / S1,
  U = 0.4 kn sqrt(R_eff) delta^2.5.

Two elastic laws. The conservative (exact-gradient) law takes the
elastic force and torques as the gradient of the sampled U (here through
``torch.autograd.grad``; the CUDA kernel ``csrc/pair_contact.cu`` carries
the hand-derived gradient) with the inclination-free measure
A = w dOmega r^2. The geometric law uses the true surface measure
A = w dOmega r^2 / cos(inclination) and puts the Hertz force along the
integral normal at the overlap centroid. Damping, Coulomb-capped
tangential spring and rolling spring-dashpot-slider act on top.

Radii come from the power-basis tables (``ops/sh_power.py``): per-pair
rows of the per-type table, evaluated at unit scale then scaled (in f32),
or scaled first and evaluated with bfloat16 Horner chains (K3's twin,
``eval_radius(bf16=True)``).

The list builders and force sums take a single system or replicas stacked
along a leading axis (``parallel/ensemble.py``): pair lists are then
[R, Pc] of each replica's own slots, compacted per replica into its own
capacity, and the kernels see the replica-major rows [R * Pc, 64] with
one ``par`` row per replica.
"""

from __future__ import annotations

import torch

from spherharm_tpu_torch.core import state as state_mod
from spherharm_tpu_torch.core.state import per_replica, take
from spherharm_tpu_torch.ops import rotation, sh_power
from spherharm_tpu_torch.ops.rotation import quat_rotate, quat_rotate_inv
from spherharm_tpu_torch.utils import spans


def periodic_mask(t, periodic):
    """``t`` [..., 3] with the columns of non-periodic axes multiplied by
    0, the periodic ones kept: a mask applied in Python, so that no mask
    tensor is copied to the device on each call (a copy from host memory
    synchronises, and a CUDA graph cannot capture it)."""
    if all(periodic):
        return t
    return torch.stack([t[..., k] if p else t[..., k] * 0.0
                        for k, p in enumerate(periodic)], dim=-1)


def minimum_image(d, box_lo, box_hi, periodic, tilt=None):
    """Minimum-image displacement for periodic dims.

    ``tilt`` = (xy, xz, yz) triclinic tilt factors (box edge vectors
    a = (Lx, 0, 0), b = (xy, Ly, 0), c = (xz, yz, Lz)): images are removed
    in the order c, b, a, valid for |tilt| <= L/2 (the LAMMPS bound).
    ``tilt=None`` is the orthogonal box. Boxes and tilts [3], or with a
    leading axis [R, 3] against d [R, ..., 3] (one box a replica)."""
    if not any(periodic):
        return d
    return minimum_image_of(d, box_hi - box_lo, periodic, tilt)


def minimum_image_of(d, lengths, periodic, tilt=None):
    """``minimum_image`` for a box of edge lengths ``lengths`` (box_hi -
    box_lo) [3] or [R, 3]."""
    if not any(periodic):
        return d
    L = per_replica(lengths, 1, d.dim())
    if tilt is None:
        return d - periodic_mask(torch.round(d / L) * L, periodic)
    pm = [float(p) for p in periodic]
    L = L[..., 0], L[..., 1], L[..., 2]
    tilt = per_replica(tilt, 1, d.dim())
    xy, xz, yz = tilt[..., 0], tilt[..., 1], tilt[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    n3 = torch.round(dz / L[2]) * pm[2]
    dx = dx - n3 * xz
    dy = dy - n3 * yz
    dz = dz - n3 * L[2]
    n2 = torch.round(dy / L[1]) * pm[1]
    dx = dx - n2 * xy
    dy = dy - n2 * L[1]
    n1 = torch.round(dx / L[0]) * pm[0]
    dx = dx - n1 * L[0]
    return torch.stack([dx, dy, dz], dim=-1)


def unshear_coords(x, box_lo, box_hi, tilt):
    """Positions in the unsheared (orthogonalised) frame: x' = lo + L *
    frac(x), frac = H^-1 (x - lo) by back-substitution through the
    upper-triangular cell matrix H = [a|b|c]. Periodic images are
    orthogonal translations there, so cell binning stays complete under
    tilt (with a tilt-inflated cell size). Boxes and tilts as
    ``minimum_image`` takes them."""
    L = per_replica(box_hi - box_lo, 1, x.dim())
    box_lo = per_replica(box_lo, 1, x.dim())
    tilt = per_replica(tilt, 1, x.dim())
    f3 = (x[..., 2] - box_lo[..., 2]) / L[..., 2]
    f2 = (x[..., 1] - box_lo[..., 1] - tilt[..., 2] * f3) / L[..., 1]
    xp = x[..., 0] - tilt[..., 0] * f2 - tilt[..., 1] * f3
    yp = box_lo[..., 1] + L[..., 1] * f2
    return torch.stack([xp, yp, x[..., 2]], dim=-1)


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _unit_trig(u):
    """(cos t, sin t, cos p, sin p) of unit vectors u[..., 3]."""
    ct = torch.clamp(u[..., 2], -1.0, 1.0)
    st = torch.sqrt(torch.clamp(u[..., 0] ** 2 + u[..., 1] ** 2, min=1e-24))
    inv = 1.0 / torch.clamp(st, min=1e-12)
    return ct, st, u[..., 0] * inv, u[..., 1] * inv


def surface_normal_trig(r, drt, drp, ct, st, cp, sp):
    """Outward unit normal e_r - (r_t/r) e_t - (r_p/(r sin t)) e_p."""
    inv_r = 1.0 / torch.clamp(r, min=1e-12)
    inv_rs = inv_r / torch.clamp(st.abs(), min=1e-6)
    a = drt * inv_r
    b = drp * inv_rs
    n = torch.stack([st * cp - a * ct * cp + b * sp,
                     st * sp - a * ct * sp - b * cp,
                     ct + a * st], dim=-1)
    return n * torch.rsqrt(torch.clamp((n * n).sum(-1, keepdim=True),
                                       min=1e-24))


def orthobasis(e):
    """Orthobasis (t1, t2) around unit e [..., 3], as the kernels build it:
    h = x-axis unless |e_x| >= 0.9, t1 = (e x h)/|e x h|, t2 = e x t1."""
    use_x = e[..., 0:1].abs() < 0.9
    # Built on the device from the mask: no host copy (CUDA graph capture).
    h = torch.cat([use_x, ~use_x, torch.zeros_like(use_x)], dim=-1).to(e.dtype)
    t1 = _cross(e, h)
    t1 = t1 * torch.rsqrt(torch.clamp((t1 * t1).sum(-1, keepdim=True),
                                      min=1e-24))
    return t1, _cross(e, t1)


class _RadiusBf16(torch.autograd.Function):
    """r of pre-scaled table rows with K3's bf16 Horner chains, and the
    gradient the reference's hand backward takes (``_probe_cons``): the
    tangent surface gradient from the bf16 At/Bt chains, dr = drt dtheta +
    drp dphi, applied to the angle cotangents. Autograd through the bf16
    chains would differentiate the rounded A/B chain instead, a different
    number at the bf16 level. drt and drp are outputs, not differentiated.
    """

    @staticmethod
    def forward(ctx, tbl_s, ct, st, cp, sp, lmax):
        r, drt, drp = sh_power.eval_power(tbl_s, ct, st, cp, sp, lmax,
                                          bf16=True)
        ctx.save_for_backward(ct, st, cp, sp, drt, drp)
        ctx.mark_non_differentiable(drt, drp)
        return r, drt, drp

    @staticmethod
    def backward(ctx, g_r, g_drt, g_drp):
        ct, st, cp, sp, drt, drp = ctx.saved_tensors
        # On the sphere: dct = -st dt, dst = ct dt, dcp = -sp dp,
        # dsp = cp dp; these cotangents give g (drt dt + drp dp).
        gt, gp = g_r * drt, g_r * drp
        return None, -st * gt, ct * gt, -sp * gp, cp * gp, None


def eval_radius(tbl, scale, ct, st, cp, sp, lmax: int, bf16: bool = False):
    """(r, dr/dt, dr/dp) of per-pair table rows tbl [P, W] at nodes
    [P, G], evaluated at unit scale and multiplied by scale [P]. With
    ``bf16`` (K3) the rows are scaled first and the Horner chains run in
    bfloat16 (``sh_power.eval_power``), through ``_RadiusBf16``."""
    if bf16:
        return _RadiusBf16.apply(tbl * scale[..., None], ct, st, cp, sp,
                                 lmax)
    r, drt, drp = sh_power.eval_power(tbl, ct, st, cp, sp, lmax)
    s = scale[..., None]
    return r * s, drt * s, drp * s


def surface_probe(q_a, s_a, tbl_a, q_b, s_b, tbl_b, rb_b, rm_a, rb_a, d,
                  cap, lmax: int, incl: bool = False, bf16: bool = False):
    """One-sided probe: a's cap-local surface nodes tested against b.

    Per-pair args (leading dim P): quaternions, scales, unit-scale
    power-table rows [P, W], pre-scaled bounding radius of b and
    inscribed / bounding radius of a; ``d`` = x_b - x_a. ``cap`` is the
    [4, G] grid (x, glw, cpsi, spsi). ``incl`` adds the 1/cos(inclination)
    factor to the measure (the geometric law's true surface area; a's
    outward normal comes from r_a and its angular derivatives). ``bf16``
    evaluates the surfaces with K3's bf16 Horner chains (``eval_radius``).

    Returns s1 [P], s2 [P], centroid_num [P, 3] (relative to x_a) and
    normal_num [P, 3] (b's outward normals, world).
    """
    cap_x, cap_glw, cap_cpsi, cap_spsi = cap
    dist = torch.linalg.norm(d, dim=-1)
    inv_dist = 1.0 / torch.clamp(dist, min=1e-12)
    e_body = quat_rotate_inv(q_a, d * inv_dist[..., None])

    # Cap half-angle: the largest polar angle at which a's surface can lie
    # inside b's bounding sphere (law of cosines). Double-where sqrt
    # guard: the dead branch must not NaN the gradient.
    rho2 = dist**2 - rb_b**2
    rho_star = torch.where(
        rho2 > 0, torch.sqrt(torch.where(rho2 > 0, rho2, 1.0)),
        torch.zeros_like(rho2))
    rho_c = torch.minimum(torch.maximum(rho_star, rm_a), rb_a)
    cos_gmax = (rho_c**2 + dist**2 - rb_b**2) / torch.clamp(
        2.0 * rho_c * dist, min=1e-12)
    cos_gmax = torch.clamp(cos_gmax, -1.0, 1.0 - 1e-6)

    one_m = (1.0 - cos_gmax)[..., None]                 # [P, 1]
    cos_g = 1.0 - one_m * cap_x                          # [P, G]
    # sin(gamma)^2 floor: 1e-12 keeps the conservative law's autograd
    # gradient finite at a full-sphere cap (as _probe_cons); the geometric
    # law takes 0, as the reference's Pallas kernel _probe.
    sin_g = torch.sqrt(torch.clamp(1.0 - cos_g**2,
                                   min=0.0 if incl else 1e-12))
    t1, t2 = orthobasis(e_body)
    dirs = (cos_g[..., None] * e_body[..., None, :]
            + (sin_g * cap_cpsi)[..., None] * t1[..., None, :]
            + (sin_g * cap_spsi)[..., None] * t2[..., None, :])
    ct_a, st_a, cp_a, sp_a = _unit_trig(dirs)
    r_a, drt_a, drp_a = eval_radius(tbl_a, s_a, ct_a, st_a, cp_a, sp_a, lmax,
                                    bf16)
    dA = one_m * cap_glw * r_a**2
    if incl:
        n_a = surface_normal_trig(r_a, drt_a, drp_a, ct_a, st_a, cp_a, sp_a)
        dA = dA / torch.clamp((n_a * dirs).sum(-1), 0.05, 1.0)

    rel = quat_rotate(q_a[..., None, :], r_a[..., None] * dirs)
    u = quat_rotate_inv(q_b[..., None, :], rel - d[..., None, :])
    rho = torch.linalg.norm(u, dim=-1)
    u_hat = u / torch.clamp(rho, min=1e-12)[..., None]
    ct_b, st_b, cp_b, sp_b = _unit_trig(u_hat)
    r_b, drt_b, drp_b = eval_radius(tbl_b, s_b, ct_b, st_b, cp_b, sp_b,
                                    lmax, bf16)

    # Depth moments: no containment indicator, so the sums are continuous
    # in the separation and delta = 1.5 S2/S1 is exact for a sphere lens.
    # (d S1 still jumps when a node crosses the surface: the force is not
    # smooth at the rounding level.)
    depth = torch.clamp(r_b - rho, min=0.0)
    wd = dA * depth
    s1 = wd.sum(-1)
    s2 = (wd * depth).sum(-1)
    centroid_num = (wd[..., None] * rel).sum(-2)
    n_body = surface_normal_trig(r_b, drt_b, drp_b, ct_b, st_b, cp_b, sp_b)
    n_world = quat_rotate(q_b[..., None, :], n_body)
    normal_num = (wd[..., None] * n_world).sum(-2)
    return s1, s2, centroid_num, normal_num


def _both_sides(d, q_i, q_j, geo, cap, lmax, incl: bool = False,
                bf16: bool = False):
    """Both-sided probe sums: (s1, s2, s1b, c1, c2, n1, n2)."""
    s_i, s_j, tbl_i, tbl_j, rb_i, rb_j, rm_i, rm_j = geo
    s1a, s2a, c1, n1 = surface_probe(q_i, s_i, tbl_i, q_j, s_j, tbl_j,
                                     rb_j, rm_i, rb_i, d, cap, lmax, incl,
                                     bf16)
    s1b, s2b, c2, n2 = surface_probe(q_j, s_j, tbl_j, q_i, s_i, tbl_i,
                                     rb_i, rm_j, rb_j, -d, cap, lmax, incl,
                                     bf16)
    return s1a + s1b, s2a + s2b, s1b, c1, c2, n1, n2


def _pair_elastic_pe(d, q_i, q_j, geo, mask, kn, r_eff, cap, lmax: int,
                     bf16: bool = False):
    """Sampled elastic PE per pair as a pure function of (d, q_i, q_j):
    the differentiation target of the conservative law."""
    rb_i, rb_j = geo[4], geo[5]
    dist = torch.linalg.norm(d, dim=-1)
    cull = mask & (dist < rb_i + rb_j) & (dist > 1e-12)
    s1, s2 = _both_sides(d, q_i, q_j, geo, cap, lmax, bf16=bf16)[:2]
    in_contact = cull & (s1 > 0)
    zero = torch.zeros_like(s1)
    delta = torch.where(in_contact, 1.5 * s2 / torch.clamp(s1, min=1e-30),
                        zero)
    return torch.where(
        in_contact,
        0.4 * kn * torch.sqrt(r_eff) * torch.clamp(delta, min=0.0) ** 2.5,
        zero,
    )


def quat_torque(q, gq):
    """World-frame torque [P, 3] from the cotangent gq = dU/dq [P, 4] of
    unit quaternions q [P, 4]: for a rotation q' = dq (x) q with
    dq = (1, dtheta/2), tau_k = -0.5 <dU/dq, e_k (x) q>."""
    e = torch.eye(4, dtype=q.dtype, device=q.device)[1:]  # [3, 4]
    eq = rotation.quat_multiply(e[None, :, :], q[:, None, :])
    return -0.5 * (gq[:, None, :] * eq).sum(-1)


def pair_elastic_grad(d, q_i, q_j, geo, mask, kn, r_eff, cap, lmax: int,
                      bf16: bool = False):
    """Exact-gradient elastic force/torques: F_i = dU/dd (U depends on x
    only through d = x_j - x_i), tau = -dU/dtheta.

    Torque from the quaternion cotangent (``quat_torque``).
    Out-of-contact pairs can produce NaN cotangents through dead-branch
    guards; the true force there is zero, so non-finite rows are masked.
    ``bf16``: K3's surfaces, differentiated as ``_RadiusBf16`` says.
    """
    with torch.enable_grad():
        d_ = d.detach().requires_grad_(True)
        qi_ = q_i.detach().requires_grad_(True)
        qj_ = q_j.detach().requires_grad_(True)
        pe = _pair_elastic_pe(d_, qi_, qj_, geo, mask, kn, r_eff, cap, lmax,
                              bf16)
        gd, gqi, gqj = torch.autograd.grad(pe.sum(), (d_, qi_, qj_),
                                           allow_unused=True)

    f_el = gd
    tau_i = quat_torque(q_i, gqi)
    tau_j = quat_torque(q_j, gqj)
    ok = (torch.isfinite(f_el).all(-1) & torch.isfinite(tau_i).all(-1)
          & torch.isfinite(tau_j).all(-1))[:, None]
    z = torch.zeros_like(f_el)
    return (torch.where(ok, f_el, z), torch.where(ok, tau_i, z),
            torch.where(ok, tau_j, z))


# Packed per-particle row layout [N, ROW_W] (one row-gather per pair side).
ROW_W = 20
_RX, _RV, _RQ, _ROM = slice(0, 3), slice(3, 6), slice(6, 10), slice(10, 13)
_RM_, _RRB, _RRM, _RRC, _RS, _RACT = 13, 14, 15, 16, 17, 18


def particle_rows(state, shapes, active=None):
    """Per-particle data the pair kernels need, packed into [N, ROW_W]:
    x, v, q, omega, m, rmax*s, rmin*s, rchar*s, s, active."""
    om = rotation.omega_from_angmom(
        state.q, state.angmom, shapes.inertia_of(state.shtype, state.scale))
    m = shapes.mass_of(state.shtype, state.scale)
    s = state.scale
    if active is None:
        active = state.active
    cols = [
        state.x, state.v, state.q, om, m[..., None],
        (shapes.rmax[state.shtype] * s)[..., None],
        (shapes.rmin[state.shtype] * s)[..., None],
        (shapes.rchar[state.shtype] * s)[..., None],
        s[..., None], active[..., None],
    ]
    rows = torch.cat([c.to(state.x.dtype) for c in cols], dim=-1)
    return torch.nn.functional.pad(rows, (0, ROW_W - rows.shape[-1]))


def _compact(keep, cap: int, n_src: int):
    """Slots of the first ``cap`` True entries of ``keep`` in order, then
    ``n_src`` (= none). Cumsum + scatter: no host sync, static shape.
    ``keep`` [R, n] compacts each replica's row into its own ``cap``
    slots: one replica never fills another's slack."""
    pos = torch.cumsum(keep.long(), -1) - 1
    tgt = torch.where(keep & (pos < cap), pos, cap)
    sel = torch.full(keep.shape[:-1] + (cap + 1,), n_src, dtype=torch.long,
                     device=keep.device)
    src = torch.arange(keep.shape[-1], device=keep.device)
    sel.scatter_(-1, tgt, src.expand(keep.shape))
    return sel[..., :cap]


def build_pair_list(state, shapes, params, neigh_idx, neigh_mask, hist,
                    owned, pair_cap: int, periodic=(False, False, False),
                    half: bool = True, tilt=None):
    """Compact the [N, K] Verlet tensor into a stable half pair list, once
    per rebuild. Keeps every pair whose bounding spheres can touch before
    the next rebuild (dist < rb_i + rb_j + skin). pair_i stays sorted; a
    stable argsort of pair_j sorts the j-side reaction sum. With a replica
    axis ([R, N, K] in, [R, pair_cap] out) each replica compacts into its
    own capacity and counts its own pairs.

    Returns (fields: dict of NeighborState pair_* tensors, n_pairs);
    ``n_pairs > pair_cap`` means dropped pairs (overflow channel).
    """
    rep = neigh_idx.dim() == 3
    N, K = neigh_idx.shape[-2:]
    dev = neigh_idx.device
    at = lambda t, i: take(t, i, rep)
    rb = shapes.rmax[state.shtype] * state.scale
    d = minimum_image(at(state.x, neigh_idx) - state.x[..., None, :],
                      state.box_lo, state.box_hi, periodic, tilt)
    dist2 = (d * d).sum(-1)
    margin = (rb[..., None] + at(rb, neigh_idx)
              + per_replica(params.skin, 0, neigh_idx.dim()))
    owned_j = at(owned, neigh_idx)
    keep = (neigh_mask & (dist2 < margin * margin) & owned[..., None]
            & at(state.active, neigh_idx))
    if half:
        i_col = torch.arange(N, device=dev)[:, None]
        keep = keep & (~owned_j | (neigh_idx > i_col))

    lead = neigh_idx.shape[:-2]
    flat = keep.reshape(lead + (N * K,))
    n_pairs = flat.sum(-1)
    pair_sel = _compact(flat, pair_cap, N * K)
    valid = pair_sel < N * K
    sel_safe = torch.clamp(pair_sel, max=N * K - 1)
    pi = torch.where(valid, sel_safe // K, N - 1)
    pj = torch.where(valid, at(neigh_idx.reshape(lead + (N * K,)), sel_safe),
                     N - 1)
    pair_both = valid & at(owned_j.reshape(lead + (N * K,)), sel_safe)
    pair_hist = torch.where(
        valid[..., None],
        at(hist.reshape(lead + (N * K, hist.shape[-1])), sel_safe), 0.0)
    # Mirror slot k' with idx[pj, k'] == pi, for the rebuild-time
    # scatter-back of springs into both tag-keyed rows.
    hit = (at(neigh_idx, pj) == pi[..., None]) & at(neigh_mask, pj)
    kk = torch.argmax(hit.to(torch.uint8), dim=-1)
    found = hit.any(-1) & valid & pair_both
    pair_selj = torch.where(found, pj * K + kk, N * K)
    fields = dict(
        pair_i=pi, pair_j=pj, pair_valid=valid, pair_both=pair_both,
        pair_hist=pair_hist, pair_sel=pair_sel, pair_selj=pair_selj,
        pair_jsort=torch.sort(pj, dim=-1, stable=True).indices,
    )
    return fields, n_pairs


def prefilter_pair_list(state, shapes, params, fields, keep_cap: int,
                        k_max: int, window_steps: int = 16,
                        floor_frac: float = 0.25,
                        periodic=(False, False, False), tilt=None,
                        probe_chunk: int = 0, reduce_max=None):
    """Rebuild-time narrow-phase prefilter: keep candidate pairs that can
    touch before the next rebuild.

    The stage-1 r-only probe (full basis, f32, 32-node cap1 grid) gives
    an upper bound on each pair's depth; a pair survives when
    depth > -(0.08 * min(rc_i, rc_j) + b_i + b_j), where b_i is the
    particle's motion budget for the window:

      b_i = clip(T (|v_i| + gmax_i |omega_i|) + T^2 (amax + gmax_i alpmax),
                 floor_frac * skin, skin / 2),   T = window_steps * dt.

    The rebuild trigger (neighbor.approach_ratio) fires when any
    particle's surface motion exceeds its budget. Returns (fields sized
    keep_cap, n_survivors, budget [N]).

    ``reduce_max`` (slabs on the leading axis, ``parallel/halo.py``) maps
    the per-slab maxima amax and alpmax [S, 1] to their maximum over the
    slabs: a slab-local amax would give a ghost row a smaller budget than
    its owner recorded, and the owner's trigger would not protect that
    pair. None keeps each (replica's) own.
    """
    from spherharm_tpu_torch.ops import contact_kernels as ck

    pi, pj = fields["pair_i"], fields["pair_j"]
    rep = pi.dim() == 2
    at = lambda t, i: take(t, i, rep)
    P = pi.shape[-1]
    rows = particle_rows(state, shapes)
    rows_i, rows_j = at(rows, pi), at(rows, pj)
    msk = (fields["pair_valid"] & (rows_i[..., _RACT] > 0.5)
           & (rows_j[..., _RACT] > 0.5))
    dp = minimum_image(rows_j[..., _RX] - rows_i[..., _RX],
                       state.box_lo, state.box_hi, periodic, tilt)
    tail_lo = ck.SLOTS["tail"][0]
    nc_ab = (shapes.lmax + 1) ** 2  # A/B prefix of the power layout
    hw = fields["pair_hist"].shape[-1]
    cap1 = torch.stack([shapes.cap1_x, shapes.cap1_glw,
                        shapes.cap1_cpsi, shapes.cap1_spsi])
    tbl_ab = ck.pad_type_table(shapes.power_tbl)[:, :nc_ab].contiguous()

    def probe(sl):
        # Every replica's chunk of candidates in one launch.
        packed = ck.pack_pairs(
            state, shapes, params, pi[..., sl], pj[..., sl], msk[..., sl],
            dp.new_zeros(dp[..., sl, :].shape[:-1] + (hw,)), dp[..., sl, :],
            rows=rows, probe_only=True,
        )[0]
        packed[:, tail_lo] = 0.0
        out = ck.stage1_depth(packed, tbl_ab, cap1, lmax=shapes.lmax,
                              l1=shapes.lmax, bf16=False)
        return out.reshape(msk[..., sl].shape)

    if probe_chunk and P > probe_chunk:
        depth = torch.cat([probe(slice(s, s + probe_chunk))
                           for s in range(0, P, probe_chunk)], dim=-1)
    else:
        depth = probe(slice(None))

    # Per-particle motion budgets (see docstring).
    nd = rows.dim() - 1  # particle axis and any replica axis
    dt = per_replica(params.dt, 0, nd)
    skin = per_replica(params.skin, 0, nd)
    T = window_steps * dt
    act = rows[..., _RACT] > 0.5
    gmax_s = shapes.gmax[state.shtype] * state.scale
    m = torch.clamp(rows[..., _RM_], min=1e-30)
    speed = torch.linalg.norm(rows[..., _RV], dim=-1)
    omag = torch.linalg.norm(rows[..., _ROM], dim=-1)
    zero = torch.zeros_like(m)
    amax = (torch.where(act, torch.linalg.norm(state.f, dim=-1) / m,
                        zero).amax(-1, keepdim=True)
            + per_replica(torch.linalg.norm(params.gravity, dim=-1), 0, nd))
    inert = shapes.inertia_of(state.shtype, state.scale)
    alpmax = torch.where(
        act, torch.linalg.norm(state.tau, dim=-1)
        / torch.clamp(inert.amin(-1), min=1e-30), zero).amax(-1, keepdim=True)
    if reduce_max is not None:
        amax, alpmax = reduce_max(amax), reduce_max(alpmax)
    budget = torch.minimum(
        torch.maximum(T * (speed + gmax_s * omag)
                      + T * T * (amax + gmax_s * alpmax),
                      floor_frac * skin),
        0.5 * skin)
    budget = torch.where(act, budget, zero)

    rc_pair = torch.minimum(rows_i[..., _RRC], rows_j[..., _RRC])
    margin = 0.08 * rc_pair + at(budget, pi) + at(budget, pj)
    survive = msk & (depth > -margin)

    n_surv = survive.sum(-1)
    sel = _compact(survive, keep_cap, P)
    ok = sel < P
    sels = torch.clamp(sel, max=P - 1)
    N = state.cap
    none = N * k_max  # build_pair_list's "no dense slot"
    # sel is increasing and the invalid tail routes to N-1, so pair_i
    # stays sorted (the i-side segment-sum stays a sorted reduction).
    pair_j = torch.where(ok, at(pj, sels), N - 1)
    fields2 = dict(
        pair_i=torch.where(ok, at(pi, sels), N - 1),
        pair_j=pair_j,
        pair_valid=at(fields["pair_valid"], sels) & ok,
        pair_both=at(fields["pair_both"], sels) & ok,
        pair_hist=torch.where(ok[..., None], at(fields["pair_hist"], sels),
                              0.0),
        pair_sel=torch.where(ok, at(fields["pair_sel"], sels), none),
        pair_selj=torch.where(ok, at(fields["pair_selj"], sels), none),
        pair_jsort=torch.sort(pair_j, dim=-1, stable=True).indices,
    )
    return fields2, n_surv, budget


def pair_hist_to_dense(neigh):
    """Scatter live pair springs back into the tag-keyed [N, K] layout,
    both the (i->j) slot and the mirror (j->i) slot. The mirror's
    tangential part is negated; the rolling part is direction-symmetric.
    """
    N, K, hw = neigh.hist.shape[-3:]
    lead = neigh.hist.shape[:-3]
    val = torch.where(neigh.pair_valid[..., None], neigh.pair_hist, 0.0)
    # The mirror's tangential part (columns 0-2) is negated.
    mirror = torch.cat([-val[..., :3], val[..., 3:]], dim=-1)
    flat = neigh.hist.new_zeros(lead + (N * K + 1, hw))
    if lead:
        r = torch.arange(lead[0], device=flat.device)[:, None]
        flat[r, neigh.pair_sel] = val
        flat[r, neigh.pair_selj] = mirror
    else:
        flat[neigh.pair_sel] = val
        flat[neigh.pair_selj] = mirror
    return flat[..., :-1, :].reshape(lead + (N, K, hw))


# Entries a block of ``prefix_sum``'s first-level scan.
SCAN_BLOCK = 1024


def _row_cumsum(t):
    """cumsum along the last dim by the row-scan kernel. A lone row gets
    a copy beside it: a tensor whose only dim is the scanned one takes the
    1-D path (on the card CUB's decoupled look-back scan, whose float
    result depends on the device's scheduling)."""
    if t.numel() == t.shape[-1]:
        return torch.stack([t, t]).cumsum(-1)[0]
    return t.cumsum(-1)


def prefix_sum(cols):
    """Inclusive prefix sums along the last dim of ``cols`` [..., P], in an
    order the shape alone fixes: blocks of SCAN_BLOCK entries scanned along
    the innermost dim, then the exclusive scan of the block totals added.
    Every row is scanned alike whatever the leading dims, on the CPU and
    on the card, so a run is bitwise repeatable and a replica's row gives
    its single list's bits."""
    lead, P = cols.shape[:-1], cols.shape[-1]
    nb = -(-P // SCAN_BLOCK)
    x = torch.nn.functional.pad(cols, (0, nb * SCAN_BLOCK - P))
    x = _row_cumsum(x.reshape(lead + (nb, SCAN_BLOCK)))
    tot = _row_cumsum(x[..., -1])
    off = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], dim=-1)
    return (x + off[..., None]).reshape(lead + (nb * SCAN_BLOCK,))[..., :P]


def sorted_segment_sum(data, seg_ids, num_segments: int):
    """Sum rows of ``data`` [P, C] into ``num_segments`` segments given
    ascending ``seg_ids``: differences of float64 prefix sums
    (``prefix_sum``, one row a column) at the segment bounds (found by
    binary search). A fixed-order scan, with no atomics and no host sync,
    so results do not depend on the device's scheduling, unlike an atomic
    ``index_add_`` or a 1-D ``torch.cumsum`` on the card.

    With a replica axis (data [R, P, C], seg_ids [R, P]) each replica
    scans its own rows, each as the single list's are scanned: every
    replica's sums are its single run's, bit for bit."""
    ids = torch.arange(num_segments, device=seg_ids.device)
    if seg_ids.dim() == 2:
        ids = ids.repeat(seg_ids.shape[0], 1)
    lo = torch.searchsorted(seg_ids, ids)
    hi = torch.searchsorted(seg_ids, ids, right=True)
    csum = torch.nn.functional.pad(
        prefix_sum(data.double().movedim(-1, -2)), (1, 0))  # [..., C, P+1]
    at = lambda i: torch.gather(
        csum, -1, i[..., None, :].expand(csum.shape[:-1] + i.shape[-1:]))
    return (at(hi) - at(lo)).movedim(-2, -1).to(data.dtype)


def contact_force_pairs(state, shapes, params, neigh,
                        periodic=(False, False, False), tilt=None,
                        conservative: bool = True):
    """Per-step force/torque over the stable pair list (the hot path): the
    pair kernel over the list by index
    (``contact_kernels.pair_contact_indexed``, in the law ``conservative``
    picks), then the sums over its rows (``contact_kernels.pair_reduce``).

    Returns (f [N,3], tau [N,3], pair_hist [Pc,HW], pe_total, virial);
    with a replica axis each gains a leading [R] (pe_total [R], virial
    [R, 3, 3]) and the kernel runs once over all R lists.

    Spans (``utils/spans``): ``pair.pack`` (the particle rows, the law's
    tables and the boxes; counts ``pair.slots``, the slots of the list),
    ``pair.law`` (the kernel gathers each slot's row itself), ``pair.reduce``
    (counts ``pair.live``, the rows the law ran for, and on the card
    ``pair.reduce_rows``, the slots the reduction read).
    """
    from spherharm_tpu_torch.ops import contact_kernels as ck

    dev = state.x.device
    pi, pj = neigh.pair_i, neigh.pair_j
    rep = pi.dim() == 2
    with spans.span("pair.pack", dev):
        rows = particle_rows(state, shapes)
        tbl, cap, par = ck.pair_tables(shapes, params, rows.dtype)
        box = ck.box_rows(state.box_lo, state.box_hi, tilt,
                          pi.shape[0] if rep else 1)
        spans.count("pair.slots", pi.numel())
    with spans.span("pair.law", dev):
        out = ck.pair_contact_indexed(
            rows, state.shtype, pi, pj, neigh.pair_valid, neigh.pair_hist,
            params.pair_tab, tbl, cap, par, box, periodic, lmax=shapes.lmax,
            conservative=conservative)
    out = out.reshape(pi.shape + (ck.N_OUT,))
    with spans.span("pair.reduce", dev):
        f, tau, pe_total, virial = ck.pair_reduce(
            out, pi, pj, neigh.pair_jsort, neigh.pair_both, neigh.pair_valid,
            state.cap)
    return f, tau, out[..., 9:15], pe_total, virial


def contact_force_dense(state, shapes, params, neigh,
                        periodic=(False, False, False), tilt=None,
                        conservative: bool = True):
    """Force/torque over the dense [N, K] neighbour tensor (the path for
    ``pair_capacity == 0``): the N*K rows, pair (i, idx[i, k]) in row
    i * K + k, run through the pair kernel by index as the pair list is.

    Full-list semantics: each contact adds to its own row only (a fixed-
    order sum over K); pe and virial are halved to undo the double count.
    Returns (f [N,3], tau [N,3], hist [N,K,HW], pe_total, virial [3,3]);
    with a replica axis each gains a leading [R].
    """
    from spherharm_tpu_torch.ops import contact_kernels as ck

    N, K = neigh.idx.shape[-2:]
    lead = neigh.idx.shape[:-2]
    rep = bool(lead)
    dev = neigh.idx.device
    with spans.span("pair.pack", dev):
        pi = torch.arange(N, device=dev).repeat_interleave(K)
        pi = pi.expand(lead + (N * K,))
        pj = neigh.idx.reshape(lead + (N * K,))
        rows = particle_rows(state, shapes)
        tbl, cap, par = ck.pair_tables(shapes, params, rows.dtype)
        box = ck.box_rows(state.box_lo, state.box_hi, tilt,
                          lead[0] if rep else 1)
        spans.count("pair.slots", pj.numel())
    with spans.span("pair.law", dev):
        out = ck.pair_contact_indexed(
            rows, state.shtype, pi, pj, neigh.mask.reshape(lead + (N * K,)),
            neigh.hist.reshape(lead + (N * K, -1)), params.pair_tab, tbl, cap,
            par, box, periodic, lmax=shapes.lmax, conservative=conservative)
    out = out.reshape(lead + (N * K, ck.N_OUT))
    force = out[..., 0:3]
    with spans.span("pair.reduce", dev):
        spans.count("pair.live", out[..., 20] > 0.5)
        f = force.reshape(lead + (N, K, 3)).sum(-2)
        tau = out[..., 3:6].reshape(lead + (N, K, 3)).sum(-2)
        pe_total = 0.5 * out[..., 15].sum(-1)
        virial = -0.5 * torch.einsum("rpa,rpb->rab" if rep else "pa,pb->ab",
                                     out[..., 17:20], force)
    return f, tau, out[..., 9:15].reshape(lead + (N, K, -1)), pe_total, virial
