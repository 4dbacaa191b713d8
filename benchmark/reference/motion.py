"""Rigid-body motion and the periodic box, plain PyTorch.

The step is velocity Verlet with a quaternion orientation (LAMMPS
``fix nve/asphere``):

  first half:  v += dt/2 f/m;  x += dt v;  L += dt/2 tau;
               q <- Richardson (two half Euler steps against one whole
               step) at the fixed angular momentum L
  box:         the affine strain rate and the shear about the box centre
               (``fix deform`` with remap), the tilt flipped back into
               |xy|, |xz| <= Lx/2, |yz| <= Ly/2 on periodic axes
  second half: v += dt/2 f/m;  L += dt/2 tau   (with the new forces)
"""

from __future__ import annotations

import torch


def cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def quat_multiply(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def quat_rotate(q, v):
    """Body-frame v into the world frame."""
    w, u = q[..., 0:1], q[..., 1:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def quat_rotate_inv(q, v):
    """World-frame v into the body frame."""
    w, u = q[..., 0:1], -q[..., 1:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def omega(q, angmom, inertia):
    """World angular velocity R I^-1 R^T L."""
    return quat_rotate(q, quat_rotate_inv(q, angmom)
                       / torch.clamp(inertia, min=1e-30))


def _normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def _euler(q, angmom, inertia, dt):
    om = omega(q, angmom, inertia)
    dq = 0.5 * quat_multiply(torch.cat([torch.zeros_like(om[..., :1]), om],
                                       -1), q)
    return _normalize(q + dt * dq)


def rotate_step(q, angmom, inertia, dt):
    """Richardson's second-order orientation update."""
    full = _euler(q, angmom, inertia, dt)
    half = _euler(_euler(q, angmom, inertia, 0.5 * dt), angmom, inertia,
                  0.5 * dt)
    return _normalize(2.0 * half - full)


def first_half(x, v, q, angmom, f, tau, m, inertia, dt):
    v = v + 0.5 * dt * f / m[:, None]
    x = x + dt * v
    angmom = angmom + 0.5 * dt * tau
    return x, v, rotate_step(q, angmom, inertia, dt), angmom


def deform(x, box_lo, box_hi, tilt, rate, shear, dt, periodic):
    """The box and positions after one step of strain ``rate`` [3] and
    shear ``shear`` [3] (d vx/dy, d vx/dz, d vy/dz). Returns (x, box_lo,
    box_hi, tilt)."""
    factor = 1.0 + rate * dt
    c = 0.5 * (box_lo + box_hi)
    x = c + (x - c) * factor
    box_lo = c + (box_lo - c) * factor
    box_hi = c + (box_hi - c) * factor
    g = shear * dt
    L = box_hi - box_lo
    x = torch.stack([x[:, 0] + g[0] * (x[:, 1] - c[1]) + g[1] * (x[:, 2] - c[2]),
                     x[:, 1] + g[2] * (x[:, 2] - c[2]), x[:, 2]], -1)
    t = tilt * torch.stack([factor[0], factor[0], factor[1]])
    xy = t[0] + g[0] * L[1]
    xz = t[1] + g[0] * t[2] + g[1] * L[2]
    yz = t[2] + g[2] * L[2]
    f_yz = torch.round(yz / L[1]) * float(periodic[1])
    yz = yz - f_yz * L[1]
    xz = xz - f_yz * xy
    f_xy = torch.round(xy / L[0]) * float(periodic[0])
    f_xz = torch.round(xz / L[0]) * float(periodic[0])
    return x, box_lo, box_hi, torch.stack([xy - f_xy * L[0],
                                            xz - f_xz * L[0], yz])


def minimum_image(d, box_lo, box_hi, periodic, tilt):
    """Minimum-image displacement, images removed along c, b, a (valid
    for |tilt| <= L/2)."""
    if not any(periodic):
        return d
    L = box_hi - box_lo
    pm = [float(p) for p in periodic]
    xy, xz, yz = tilt[0], tilt[1], tilt[2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    n3 = torch.round(dz / L[2]) * pm[2]
    dx, dy, dz = dx - n3 * xz, dy - n3 * yz, dz - n3 * L[2]
    n2 = torch.round(dy / L[1]) * pm[1]
    dx, dy = dx - n2 * xy, dy - n2 * L[1]
    n1 = torch.round(dx / L[0]) * pm[0]
    return torch.stack([dx - n1 * L[0], dy, dz], dim=-1)
