"""Quaternion rigid-body velocity-Verlet integration (torch twin of
``spherharm_tpu/ops/integrate.py``, the LAMMPS ``fix nve/asphere`` scheme).

  initial_integrate:  v += dt/2 f/m;  x += dt v;  L += dt/2 tau;
                      q <- richardson(q, L, I_body, dt)
  final_integrate:    v += dt/2 f/m;  L += dt/2 tau
"""

from __future__ import annotations

import torch

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
    m = shapes.mass_of(state.shtype, state.scale)[:, None]
    inertia = shapes.inertia_of(state.shtype, state.scale)
    act = state.active[:, None]
    dt = params.dt
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
    m = shapes.mass_of(state.shtype, state.scale)[:, None]
    act = state.active[:, None]
    dt = params.dt
    v = torch.where(act, state.v + 0.5 * dt * state.f / m, state.v)
    angmom = torch.where(act, state.angmom + 0.5 * dt * state.tau,
                         state.angmom)
    return state.replace(v=v, angmom=angmom)


def apply_deformation(state, x_build, params):
    """Affine box deformation about the box centre (fix deform analogue).

    Only the diagonal strain rate is ported; the drum runs with zero
    rates, where this is an exact no-op. Returns (state, x_build)."""
    factor = 1.0 + params.deform_rate * params.dt
    center = 0.5 * (state.box_lo + state.box_hi)
    x = center + (state.x - center) * factor
    xb = center + (x_build - center) * factor
    state = state.replace(
        x=x,
        box_lo=center + (state.box_lo - center) * factor,
        box_hi=center + (state.box_hi - center) * factor,
    )
    return state, xb


def kinetic_energy(state, shapes):
    """Translational + rotational KE (masked)."""
    m = shapes.mass_of(state.shtype, state.scale)
    inertia = shapes.inertia_of(state.shtype, state.scale)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    ke_t = 0.5 * torch.where(
        state.active, m * (state.v**2).sum(-1), zero).sum()
    omega = omega_from_angmom(state.q, state.angmom, inertia)
    ke_r = 0.5 * torch.where(
        state.active, (omega * state.angmom).sum(-1), zero).sum()
    return ke_t, ke_r
