"""Quaternion and rigid-body rotation primitives (torch twin of
``spherharm_tpu/ops/rotation.py``).

Quaternions are ``[w, x, y, z]`` (scalar first), unit norm, mapping
body-frame vectors to world-frame vectors: ``v_world = R(q) v_body``.
All functions broadcast over leading batch dims.
"""

from __future__ import annotations

import torch


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)


def quat_multiply(a, b):
    """Hamilton product a*b, both [...,4] scalar-first."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    """Conjugate (the inverse of a unit quaternion)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_to_matrix(q):
    """Rotation matrix [..., 3, 3] whose columns are the body axes in the
    world frame."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def quat_from_axis_angle(axis, angle):
    """Unit quaternion of a rotation by ``angle`` about unit ``axis``."""
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    return torch.cat([torch.cos(half)[..., None],
                      torch.sin(half)[..., None] * axis], dim=-1)


def angles_from_unit(u):
    """(theta, phi) spherical angles of unit vectors u [..., 3]: theta in
    [0, pi] from +z, phi in [0, 2 pi)."""
    theta = torch.arccos(torch.clamp(u[..., 2], -1.0, 1.0))
    phi = torch.arctan2(u[..., 1], u[..., 0])
    return theta, torch.where(phi < 0, phi + 2.0 * torch.pi, phi)


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def quat_rotate(q, v):
    """Rotate body-frame vector(s) v [...,3] into the world frame by q."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def quat_rotate_inv(q, v):
    """Rotate world-frame vector(s) into the body frame (R(q)^T v)."""
    w = q[..., 0:1]
    u = -q[..., 1:4]
    t = 2.0 * _cross(u, v)
    return v + w * t + _cross(u, t)


def omega_from_angmom(q, angmom, inertia_body):
    """World-frame angular velocity from world angmom and body principal
    inertia: omega_world = R(q) I_body^{-1} R(q)^T L_world."""
    L_body = quat_rotate_inv(q, angmom)
    w_body = L_body / inertia_body.clamp(min=1e-30)
    return quat_rotate(q, w_body)


def quat_derivative(q, omega_world):
    """dq/dt = 0.5 * (0, omega_world) * q."""
    oq = torch.cat([torch.zeros_like(omega_world[..., :1]), omega_world],
                   dim=-1)
    return 0.5 * quat_multiply(oq, q)
