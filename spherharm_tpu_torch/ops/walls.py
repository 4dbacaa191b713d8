"""Granular wall contacts for SH particles: planes and rotating cylinders
(torch twin of ``spherharm_tpu/ops/walls.py``).

Walls use the same depth-moment cap quadrature and Hertz + history
friction + rolling law as the pair kernel, with the wall as an
infinite-mass flat partner. The narrow phase is the wall kernel
(``walls_kernels.wall_contact_kernel``; CUDA on the card, its plain twin
on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spherharm_tpu_torch.core.state import _Container, take
from spherharm_tpu_torch.ops.rotation import omega_from_angmom
from spherharm_tpu_torch.ops.neighbor import stable_topk_true


def _vec(a, dtype, device):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                           device=device)


def _mat(mat, dtype, device):
    if mat is None:
        return None
    if np.shape(mat) != (8,):
        raise ValueError(f"a wall's mat row takes 8 values, got {mat!r}")
    return _vec(mat, dtype, device)


@dataclass
class PlaneWall(_Container):
    """Half-space wall: particles confined to the side ``normal`` points
    to; depth(p) = -(p - point) . normal. ``velocity`` is the wall's
    surface velocity."""

    point: torch.Tensor
    normal: torch.Tensor
    velocity: torch.Tensor
    # Optional per-wall material row [8] (kn, kt, gamma_n, gamma_t, mu,
    # k_roll, gamma_roll, mu_roll), as LAMMPS fix wall/gran carries its
    # own coefficients; None takes the global SimParams scalars.
    mat: torch.Tensor | None = None

    @classmethod
    def create(cls, point, normal, velocity=(0.0, 0.0, 0.0), mat=None,
               dtype=torch.float32, device="cuda"):
        n = _vec(normal, dtype, device)
        return cls(
            point=_vec(point, dtype, device),
            normal=n / torch.linalg.norm(n),
            velocity=_vec(velocity, dtype, device),
            mat=_mat(mat, dtype, device),
        )

    def depth_and_normal(self, p):
        depth = -((p - self.point) * self.normal).sum(-1)
        return depth, self.normal.expand(p.shape)

    def surface_velocity(self, c):
        """The wall's velocity at contact points ``c`` [..., 3]."""
        return self.velocity.expand(c.shape)

    def angular_velocity(self):
        return torch.zeros((3,), dtype=self.point.dtype,
                           device=self.point.device)


@dataclass
class CylinderWall(_Container):
    """Inside of a (possibly rotating) cylinder — the drum. Axis through
    ``axis_point`` along unit ``axis_dir``; particles inside radius R;
    ``omega`` spins the wall about the axis."""

    axis_point: torch.Tensor
    axis_dir: torch.Tensor
    radius: torch.Tensor
    omega: torch.Tensor
    mat: torch.Tensor | None = None  # see PlaneWall.mat

    @classmethod
    def create(cls, axis_point, axis_dir, radius, omega=0.0, mat=None,
               dtype=torch.float32, device="cuda"):
        ad = _vec(axis_dir, dtype, device)
        return cls(
            axis_point=_vec(axis_point, dtype, device),
            axis_dir=ad / torch.linalg.norm(ad),
            radius=_vec(radius, dtype, device),
            omega=_vec(omega, dtype, device),
            mat=_mat(mat, dtype, device),
        )

    def depth_and_normal(self, p):
        rel = p - self.axis_point
        ax = (rel * self.axis_dir).sum(-1, keepdim=True)
        rad_vec = rel - ax * self.axis_dir
        rad = torch.linalg.norm(rad_vec, dim=-1)
        n = -rad_vec / torch.clamp(rad, min=1e-12)[..., None]  # inward
        return rad - self.radius, n

    def surface_velocity(self, c):
        """The shell's velocity at contact points ``c`` [..., 3]: omega
        axis x (c - axis_point)."""
        rel = c - self.axis_point
        return self.omega * torch.linalg.cross(
            self.axis_dir.expand(rel.shape), rel, dim=-1)

    def angular_velocity(self):
        return self.omega * self.axis_dir


def near_wall_rows(state, shapes, wall, hist, wall_cap: int):
    """The narrow phase's batch under ``wall_cap``: the (up to wall_cap)
    particles whose bounding sphere reaches the wall, near-first in slot
    order (a stable sort, the order ``lax.top_k`` gives), each replica's
    own with a replica axis. Returns (sub-state of wall_cap rows, their
    springs, sel: their slots, sel_ok: which are near, n_near)."""
    rep = state.replicas
    depth_c, _ = wall.depth_and_normal(state.x)
    rmax_all = shapes.rmax[state.shtype] * state.scale
    near_all = state.active & (depth_c > -rmax_all)
    sel = stable_topk_true(near_all, wall_cap)
    at = lambda t: take(t, sel, rep)
    sel_ok = at(near_all)
    sub = state.replace(
        x=at(state.x), v=at(state.v), q=at(state.q),
        angmom=at(state.angmom), scale=at(state.scale),
        shtype=at(state.shtype), active=sel_ok,
    )
    return sub, at(hist), sel, sel_ok, near_all.sum(-1)


def wall_contact(state, shapes, params, wall, hist, wall_cap: int = 0):
    """Hertz/friction/rolling contact of every particle against one wall.

    hist: [N, 6] springs for this wall. Returns (force [N,3],
    torque [N,3], new_hist [N,6], pe [N], n_near).

    wall_cap > 0: only the (up to wall_cap) particles whose bounding
    sphere reaches the wall enter the narrow phase (``near_wall_rows``);
    results scatter back. ``n_near > wall_cap`` means truncation
    (overflow).

    With a replica axis every output gains a leading [R] (n_near [R]),
    each replica compacts its own near rows into its own ``wall_cap``,
    and one kernel launch serves all R.
    """
    from spherharm_tpu_torch.ops import walls_kernels

    if wall_cap and wall_cap < state.cap:
        sub, sub_hist, sel, sel_ok, n_near = near_wall_rows(
            state, shapes, wall, hist, wall_cap)
        fw, tw, hw, pew, _ = wall_contact(sub, shapes, params, wall,
                                          sub_hist)
        ok = sel_ok[..., None]

        def put(v):
            z = torch.zeros(state.x.shape[:-1] + v.shape[sel.dim():],
                            dtype=v.dtype, device=v.device)
            if not state.replicas:
                return z.index_copy_(0, sel, v)
            r = torch.arange(sel.shape[0], device=sel.device)[:, None]
            z[r, sel] = v
            return z

        return (put(torch.where(ok, fw, 0.0)), put(torch.where(ok, tw, 0.0)),
                put(torch.where(ok, hw, 0.0)),
                put(torch.where(sel_ok, pew, 0.0)), n_near)

    depth_c, n_c = wall.depth_and_normal(state.x)
    rmax = shapes.rmax[state.shtype] * state.scale
    near = state.active & (depth_c > -rmax)
    om = omega_from_angmom(state.q, state.angmom,
                           shapes.inertia_of(state.shtype, state.scale))
    packed, tbl, cap, par, kind = walls_kernels.pack_wall(
        state, shapes, params, wall, hist, depth_c, n_c, om)
    out = walls_kernels.wall_contact_kernel(packed, tbl, cap, par,
                                            lmax=shapes.lmax, kind=kind)
    out = out.reshape(state.x.shape[:-1] + out.shape[-1:])
    return (out[..., 0:3], out[..., 3:6], out[..., 6:12], out[..., 12],
            near.sum(-1))
