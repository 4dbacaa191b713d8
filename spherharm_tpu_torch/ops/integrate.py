"""Quaternion rigid-body velocity-Verlet integration (torch twin of
``spherharm_tpu/ops/integrate.py``, the LAMMPS ``fix nve/asphere`` scheme).

  initial_integrate:  v += dt/2 f/m;  x += dt v;  L += dt/2 tau;
                      q <- richardson(q, L, I_body, dt)
  final_integrate:    v += dt/2 f/m;  L += dt/2 tau

plus the box: ``apply_deformation`` (strain and shear rates, tilt flip)
and the ``berendsen_box_control`` stress servo.

Each takes a single system or replicas stacked along a leading axis
(``core/state.py``): per-replica dt, rates, targets, boxes and tilts
broadcast over the particle axis (``per_replica``).
"""

from __future__ import annotations

import torch

from spherharm_tpu_torch.core.state import per_replica

from spherharm_tpu_torch.ops.rotation import (
    omega_from_angmom,
    quat_derivative,
    quat_normalize,
)


def _euler_quat(q, angmom, inertia_body, dt):
    omega = omega_from_angmom(q, angmom, inertia_body)
    return quat_normalize(q + dt * quat_derivative(q, omega))


def richardson_quat_update(q, angmom, inertia_body, dt):
    """Second-order quaternion rotation update at fixed angular momentum."""
    q_full = _euler_quat(q, angmom, inertia_body, dt)
    q_half = _euler_quat(q, angmom, inertia_body, 0.5 * dt)
    q_half = _euler_quat(q_half, angmom, inertia_body, 0.5 * dt)
    return quat_normalize(2.0 * q_half - q_full)


def initial_integrate(state, shapes, params):
    """Half-kick velocities/angmom, drift positions, rotate quaternions."""
    m = shapes.mass_of(state.shtype, state.scale)[..., None]
    inertia = shapes.inertia_of(state.shtype, state.scale)
    act = state.active[..., None]
    dt = per_replica(params.dt, 0, 3)
    v = torch.where(act, state.v + 0.5 * dt * state.f / m, state.v)
    x = torch.where(act, state.x + dt * v, state.x)
    angmom = torch.where(act, state.angmom + 0.5 * dt * state.tau,
                         state.angmom)
    q = torch.where(
        act, richardson_quat_update(state.q, angmom, inertia, dt), state.q
    )
    return state.replace(x=x, v=v, q=q, angmom=angmom,
                         step=state.step + 1)


def final_integrate(state, shapes, params):
    """Second half-kick from freshly computed forces/torques."""
    m = shapes.mass_of(state.shtype, state.scale)[..., None]
    act = state.active[..., None]
    dt = per_replica(params.dt, 0, 3)
    v = torch.where(act, state.v + 0.5 * dt * state.f / m, state.v)
    angmom = torch.where(act, state.angmom + 0.5 * dt * state.tau,
                         state.angmom)
    return state.replace(v=v, angmom=angmom)


def apply_deformation(state, x_build, params, periodic=(False, False, False)):
    """Affine box deformation about the box centre (fix deform analogue).

    The diagonal strain rate scales box edges, positions and the build
    positions ``x_build`` (so no spurious skin trigger) by 1 + rate dt;
    the off-diagonal ``shear_rate`` (d vx/dy, d vx/dz, d vy/dz) shears
    them and grows the (xy, xz, yz) tilt (fix deform xy/xz/yz with remap).
    Zero rates are an exact no-op.

    Sustained shear flips the tilt back into |xy|, |xz| <= Lx/2,
    |yz| <= Ly/2 (the LAMMPS flip: a whole box edge vector subtracted, a
    relabelling of the periodic lattice) where the shifted axis is
    periodic; elsewhere ``Simulation._step_core`` flags |tilt| > L/2
    through the overflow channel.

    Returns (state, x_build, flip): ``flip`` [3] is the whole-edge
    multiple removed from each tilt component (zeros when none).
    """
    nd = state.x.dim()
    factor = 1.0 + params.deform_rate * per_replica(params.dt, 0, 2)
    center = 0.5 * (state.box_lo + state.box_hi)
    c = per_replica(center, 1, nd)
    f = per_replica(factor, 1, nd)
    x = c + (state.x - c) * f
    xb = c + (x_build - c) * f
    box_lo = center + (state.box_lo - center) * factor
    box_hi = center + (state.box_hi - center) * factor

    # (d_xy, d_xz, d_yz) increments
    g = params.shear_rate * per_replica(params.dt, 0, 2)
    L = box_hi - box_lo
    gp = per_replica(g, 1, nd)

    def shear(p):
        sx = (p[..., 0] + gp[..., 0] * (p[..., 1] - c[..., 1])
              + gp[..., 1] * (p[..., 2] - c[..., 2]))
        sy = p[..., 1] + gp[..., 2] * (p[..., 2] - c[..., 2])
        return torch.stack([sx, sy, p[..., 2]], dim=-1)

    x = shear(x)
    xb = shear(xb)
    # Tilts are x-offsets (xy, xz) and a y-offset (yz): they scale with
    # the matching diagonal factor, then grow with the shear; shearing
    # the cell vectors b = (xy, Ly, 0), c = (xz, yz, Lz) as positions are
    # sheared gives xz the g_xy * yz cross-term.
    t = state.tilt * torch.stack(
        [factor[..., 0], factor[..., 0], factor[..., 1]], dim=-1)
    xy = t[..., 0] + g[..., 0] * L[..., 1]
    xz = t[..., 1] + g[..., 0] * t[..., 2] + g[..., 1] * L[..., 2]
    yz = t[..., 2] + g[..., 2] * L[..., 2]
    # The flip: yz by the b vector (periodic y), dragging xz by -xy a
    # flip (c' = c - b); then xy and xz by the a vector (periodic x).
    # Positions need no remap: the next wrap uses the current cell.
    can_x = float(periodic[0])
    can_y = float(periodic[1])
    f_yz = torch.round(yz / L[..., 1]) * can_y
    yz = yz - f_yz * L[..., 1]
    xz = xz - f_yz * xy
    f_xy = torch.round(xy / L[..., 0]) * can_x
    f_xz = torch.round(xz / L[..., 0]) * can_x
    xy = xy - f_xy * L[..., 0]
    xz = xz - f_xz * L[..., 0]
    state = state.replace(x=x, box_lo=box_lo, box_hi=box_hi,
                          tilt=torch.stack([xy, xz, yz], dim=-1))
    return state, xb, torch.stack([f_xy, f_xz, f_yz], dim=-1)


def berendsen_box_control(state, x_build, params, virial, shapes):
    """Anisotropic Berendsen stress servo (fix press/berendsen analogue):
    per-axis dilation mu_a = 1 - dt/(3 tau) (P_target_a - P_a), clipped
    to 0.99-1.01 a step, applied about the box centre to the box,
    positions and ``x_build``; the tilt scales by (mu_x, mu_x, mu_y).
    ``virial`` is the step's own; press_tau = 0 gives mu = 1.
    Returns (state, x_build)."""
    m = shapes.mass_of(state.shtype, state.scale)
    rep = state.replicas
    kin = torch.einsum("rn,rna,rna->ra" if rep else "n,na,na->a",
                       torch.where(state.active, m, 0.0), state.v, state.v)
    vol = torch.prod(state.box_hi - state.box_lo, dim=-1)
    p_diag = ((kin + torch.diagonal(virial, dim1=-2, dim2=-1))
              / vol[..., None])
    inv_tau = torch.where(params.press_tau > 0,
                          1.0 / torch.clamp(params.press_tau, min=1e-30),
                          torch.zeros_like(params.press_tau))
    mu = 1.0 - ((params.dt * inv_tau / 3.0)[..., None]
                * (params.press_target - p_diag))
    mu = torch.clamp(mu, 0.99, 1.01)
    center = 0.5 * (state.box_lo + state.box_hi)
    c = per_replica(center, 1, state.x.dim())
    m3 = per_replica(mu, 1, state.x.dim())
    state = state.replace(
        x=c + (state.x - c) * m3,
        box_lo=center + (state.box_lo - center) * mu,
        box_hi=center + (state.box_hi - center) * mu,
        tilt=state.tilt * torch.stack([mu[..., 0], mu[..., 0], mu[..., 1]],
                                      dim=-1),
    )
    return state, c + (x_build - c) * m3


def kinetic_energy(state, shapes):
    """Translational + rotational KE (masked)."""
    m = shapes.mass_of(state.shtype, state.scale)
    inertia = shapes.inertia_of(state.shtype, state.scale)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    ke_t = 0.5 * torch.where(
        state.active, m * (state.v**2).sum(-1), zero).sum(-1)
    omega = omega_from_angmom(state.q, state.angmom, inertia)
    ke_r = 0.5 * torch.where(
        state.active, (omega * state.angmom).sum(-1), zero).sum(-1)
    return ke_t, ke_r
