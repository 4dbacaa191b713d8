"""Per-type quantities the law needs, worked out from the blob
coefficients alone: bounding and inscribed radii, mean radius, volume and
principal inertia (unit density and scale), and the patch-local cap grid.

The definitions are the configuration's (its ``contact_quad``, a 48 x 96
set-up quadrature, the 0.1 % margins on the radii), so that the cap the
reference integrates over is the one the law defines.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.special import roots_legendre

from benchmark.reference.sh import SQRT4PI, SphereQuadrature, basis_np


@dataclass
class RefShapes:
    lmax: int
    coeffs: torch.Tensor    # [T, C]
    rmax: torch.Tensor      # [T]
    rmin: torch.Tensor      # [T]
    rchar: torch.Tensor     # [T]
    vol: torch.Tensor       # [T]
    inertia: torch.Tensor   # [T, 3] principal, unit density and scale
    density: torch.Tensor   # [T]
    cap: torch.Tensor       # [4, G]: x, weight, cos psi, sin psi

    def mass(self, shtype, scale):
        return self.density[shtype] * self.vol[shtype] * scale ** 3

    def inertia_of(self, shtype, scale):
        return (self.density[shtype, None] * self.inertia[shtype]
                * (scale ** 5)[..., None])


def cap_grid(n_gamma: int, n_psi: int):
    """Gauss-Legendre in x in (0, 1) times uniform psi: [4, n_gamma n_psi]."""
    gl_x, gl_w = roots_legendre(n_gamma)
    x1 = (np.asarray(gl_x) + 1.0) / 2.0
    w1 = np.asarray(gl_w) / 2.0
    psi = (np.arange(n_psi) + 0.5) * (2.0 * np.pi / n_psi)
    cx, cp = np.meshgrid(x1, psi, indexing="ij")
    cw, _ = np.meshgrid(w1, psi, indexing="ij")
    return np.stack([cx.ravel(), (cw * (2.0 * np.pi / n_psi)).ravel(),
                     np.cos(cp.ravel()), np.sin(cp.ravel())])


def ref_shapes(coeffs, lmax: int, contact_quad, density=1.0,
               device="cpu") -> RefShapes:
    coeffs = np.atleast_2d(np.asarray(coeffs, np.float64))
    T = coeffs.shape[0]
    sq = SphereQuadrature(48, 96)
    r_s = coeffs @ basis_np(sq.theta, sq.phi, lmax).T       # [T, Gs]
    vol = (sq.weights[None] * r_s ** 3).sum(-1) / 3.0
    w5 = sq.weights[None] * r_s ** 5 / 5.0
    nn = sq.dirs[:, :, None] * sq.dirs[:, None, :]
    inertia = np.einsum("tg,gab->tab", w5, np.eye(3)[None] - nn)
    f = lambda a: torch.tensor(np.asarray(a, np.float64), device=device)
    return RefShapes(
        lmax=lmax, coeffs=f(coeffs), rmax=f(r_s.max(-1) * 1.001),
        rmin=f(r_s.min(-1) * 0.999), rchar=f(coeffs[:, 0] / SQRT4PI),
        vol=f(vol), inertia=f(np.einsum("taa->ta", inertia)),
        density=f(np.broadcast_to(np.asarray(density, np.float64), (T,))),
        cap=f(cap_grid(*contact_quad)))
