"""NumPy SH basis evaluators — setup path only.

A copy of ``spherharm_tpu/ops/sh_np.py`` (the reference package imports
jax at package level, so the port carries its own numpy setup code).
Shape-table precompute runs once on the host in float64. Conventions:
real, fully normalized (4pi-orthonormal), no Condon-Shortley phase.
Parity with the reference's ``build_shapes`` is pinned by
tests/test_torch_setup.py.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import roots_legendre


def _alp_all_np(cos_t, sin_t, lmax: int):
    P = {}
    P[(0, 0)] = np.full_like(cos_t, 1.0 / math.sqrt(4.0 * math.pi))
    for m in range(1, lmax + 1):
        P[(m, m)] = math.sqrt((2 * m + 1) / (2 * m)) * sin_t * P[(m - 1, m - 1)]
    for m in range(0, lmax):
        P[(m + 1, m)] = math.sqrt(2 * m + 3) * cos_t * P[(m, m)]
    for m in range(0, lmax + 1):
        for n in range(m + 2, lmax + 1):
            a = math.sqrt((4 * n * n - 1) / (n * n - m * m))
            b = math.sqrt(
                ((2 * n + 1) / (2 * n - 3))
                * ((n - 1) ** 2 - m * m)
                / (n * n - m * m)
            )
            P[(n, m)] = a * cos_t * P[(n - 1, m)] - b * P[(n - 2, m)]
    return P


def real_sh_basis_np(theta, phi, lmax: int):
    theta = np.asarray(theta, np.float64)
    phi = np.asarray(phi, np.float64)
    P = _alp_all_np(np.cos(theta), np.sin(theta), lmax)
    sq2 = math.sqrt(2.0)
    cos_m = [np.ones_like(phi)]
    sin_m = [np.zeros_like(phi)]
    c1, s1 = np.cos(phi), np.sin(phi)
    for m in range(1, lmax + 1):
        cos_m.append(cos_m[-1] * c1 - sin_m[-1] * s1)
        sin_m.append(sin_m[-1] * c1 + cos_m[-2] * s1)
    cols = []
    for n in range(lmax + 1):
        for m in range(-n, n + 1):
            am = abs(m)
            if m == 0:
                cols.append(P[(n, 0)])
            elif m > 0:
                cols.append(sq2 * P[(n, am)] * cos_m[am])
            else:
                cols.append(sq2 * P[(n, am)] * sin_m[am])
    return np.stack(cols, axis=-1)


def real_sh_basis_grad_np(theta, phi, lmax: int):
    theta = np.asarray(theta, np.float64)
    phi = np.asarray(phi, np.float64)
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    inv_sin = 1.0 / np.maximum(np.abs(sin_t), 1e-6) * np.sign(sin_t + 1e-30)
    P = _alp_all_np(cos_t, sin_t, lmax)
    dP = {}
    for n in range(lmax + 1):
        for m in range(0, n + 1):
            if n == 0:
                dP[(n, m)] = np.zeros_like(cos_t)
                continue
            term = n * cos_t * P[(n, m)]
            if m <= n - 1:
                e = math.sqrt((n * n - m * m) * (2 * n + 1) / (2 * n - 1))
                term = term - e * P[(n - 1, m)]
            dP[(n, m)] = term * inv_sin

    cos_m = [np.ones_like(phi)]
    sin_m = [np.zeros_like(phi)]
    c1, s1 = np.cos(phi), np.sin(phi)
    for m in range(1, lmax + 1):
        cos_m.append(cos_m[-1] * c1 - sin_m[-1] * s1)
        sin_m.append(sin_m[-1] * c1 + cos_m[-2] * s1)
    sq2 = math.sqrt(2.0)
    Y, dYt, dYp = [], [], []
    for n in range(lmax + 1):
        for m in range(-n, n + 1):
            am = abs(m)
            if m == 0:
                Y.append(P[(n, 0)])
                dYt.append(dP[(n, 0)])
                dYp.append(np.zeros_like(phi))
            elif m > 0:
                Y.append(sq2 * P[(n, am)] * cos_m[am])
                dYt.append(sq2 * dP[(n, am)] * cos_m[am])
                dYp.append(-sq2 * am * P[(n, am)] * sin_m[am])
            else:
                Y.append(sq2 * P[(n, am)] * sin_m[am])
                dYt.append(sq2 * dP[(n, am)] * sin_m[am])
                dYp.append(sq2 * am * P[(n, am)] * cos_m[am])
    return np.stack(Y, -1), np.stack(dYt, -1), np.stack(dYp, -1)


class SphereQuadratureNp:
    """NumPy twin of sh_math.SphereQuadrature."""

    def __init__(self, n_theta: int, n_phi: int):
        xs, ws = roots_legendre(n_theta)
        theta = np.arccos(xs)[::-1]
        w_t = ws[::-1]
        phi = (np.arange(n_phi) + 0.5) * (2.0 * np.pi / n_phi)
        tt, pp = np.meshgrid(theta, phi, indexing="ij")
        wt, _ = np.meshgrid(w_t, phi, indexing="ij")
        self.n_nodes = n_theta * n_phi
        self.theta = tt.ravel()
        self.phi = pp.ravel()
        self.weights = (wt * (2.0 * np.pi / n_phi)).ravel()
        st, ct = np.sin(self.theta), np.cos(self.theta)
        sp, cp = np.sin(self.phi), np.cos(self.phi)
        self.dirs = np.stack([st * cp, st * sp, ct], axis=-1)


def surface_normal_np(r, dr_dt, dr_dp, theta, phi):
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    e_r = np.stack([st * cp, st * sp, ct], axis=-1)
    e_t = np.stack([ct * cp, ct * sp, -st], axis=-1)
    e_p = np.stack([-sp, cp, np.zeros_like(sp)], axis=-1)
    inv_r = 1.0 / np.maximum(r, 1e-12)
    inv_rs = inv_r / np.maximum(np.abs(st), 1e-6)
    n = (
        e_r
        - (dr_dt * inv_r)[..., None] * e_t
        - (dr_dp * inv_rs)[..., None] * e_p
    )
    return n / np.clip(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12, None)
