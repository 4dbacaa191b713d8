"""Real spherical harmonics: the shape surface r(theta, phi) = sum c_nm Y_nm.

Real, fully normalized (4 pi-orthonormal) harmonics without the
Condon-Shortley phase, columns ordered n * n + (m + n), m = -n..n, with
cos(m phi) for m > 0 and sin(|m| phi) for m < 0. The associated Legendre
functions come from the standard three-term recurrences, evaluated
directly (no polynomial re-basing), in whatever dtype the inputs carry:
numpy float64 for the per-type set-up, torch float64 for the law.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import roots_legendre

SQRT4PI = math.sqrt(4.0 * math.pi)


def n_coeffs(lmax: int) -> int:
    return (lmax + 1) ** 2


def _legendre(cos_t, sin_t, lmax: int, full):
    """Normalized associated Legendre functions P[(n, m)], m >= 0."""
    P = {(0, 0): full(cos_t, 1.0 / math.sqrt(4.0 * math.pi))}
    for m in range(1, lmax + 1):
        P[(m, m)] = math.sqrt((2 * m + 1) / (2 * m)) * sin_t * P[(m - 1, m - 1)]
    for m in range(0, lmax):
        P[(m + 1, m)] = math.sqrt(2 * m + 3) * cos_t * P[(m, m)]
    for m in range(0, lmax + 1):
        for n in range(m + 2, lmax + 1):
            a = math.sqrt((4 * n * n - 1) / (n * n - m * m))
            b = math.sqrt(((2 * n + 1) / (2 * n - 3))
                          * ((n - 1) ** 2 - m * m) / (n * n - m * m))
            P[(n, m)] = a * cos_t * P[(n - 1, m)] - b * P[(n - 2, m)]
    return P


def _harmonics(cos_t, sin_t, cos_p, sin_p, lmax: int, full, grad: bool):
    """Lists (Y, dY/dtheta, dY/dphi) of the basis columns; the derivative
    lists are empty without ``grad``."""
    P = _legendre(cos_t, sin_t, lmax, full)
    cos_m, sin_m = [full(cos_p, 1.0)], [full(cos_p, 0.0)]
    for m in range(1, lmax + 1):
        cos_m.append(cos_m[-1] * cos_p - sin_m[-1] * sin_p)
        sin_m.append(sin_m[-1] * cos_p + cos_m[-2] * sin_p)
    if grad:
        inv_sin = 1.0 / (sin_t.abs() if torch.is_tensor(sin_t)
                         else np.abs(sin_t)).clip(1e-6)
        dP = {}
        for n in range(lmax + 1):
            for m in range(n + 1):
                if n == 0:
                    dP[(n, m)] = full(cos_t, 0.0)
                    continue
                term = n * cos_t * P[(n, m)]
                if m <= n - 1:
                    e = math.sqrt((n * n - m * m) * (2 * n + 1) / (2 * n - 1))
                    term = term - e * P[(n - 1, m)]
                dP[(n, m)] = term * inv_sin
    sq2 = math.sqrt(2.0)
    Y, dYt, dYp = [], [], []
    for n in range(lmax + 1):
        for m in range(-n, n + 1):
            a = abs(m)
            if m == 0:
                Y.append(P[(n, 0)])
            elif m > 0:
                Y.append(sq2 * P[(n, a)] * cos_m[a])
            else:
                Y.append(sq2 * P[(n, a)] * sin_m[a])
            if not grad:
                continue
            if m == 0:
                dYt.append(dP[(n, 0)])
                dYp.append(full(cos_p, 0.0))
            elif m > 0:
                dYt.append(sq2 * dP[(n, a)] * cos_m[a])
                dYp.append(-sq2 * a * P[(n, a)] * sin_m[a])
            else:
                dYt.append(sq2 * dP[(n, a)] * sin_m[a])
                dYp.append(sq2 * a * P[(n, a)] * cos_m[a])
    return Y, dYt, dYp


def basis_np(theta, phi, lmax: int):
    """[..., (lmax+1)^2] basis at angle arrays (numpy float64)."""
    theta = np.asarray(theta, np.float64)
    phi = np.asarray(phi, np.float64)
    full = lambda like, v: np.full_like(like, v)
    Y, _, _ = _harmonics(np.cos(theta), np.sin(theta), np.cos(phi),
                         np.sin(phi), lmax, full, grad=False)
    return np.stack(Y, axis=-1)


def unit_trig(u):
    """(cos t, sin t, cos p, sin p) of unit vectors u [..., 3]."""
    ct = torch.clamp(u[..., 2], -1.0, 1.0)
    st = torch.sqrt(torch.clamp(u[..., 0] ** 2 + u[..., 1] ** 2, min=1e-24))
    inv = 1.0 / torch.clamp(st, min=1e-12)
    return ct, st, u[..., 0] * inv, u[..., 1] * inv


def surface(coef, ct, st, cp, sp, lmax: int):
    """(r, dr/dtheta, dr/dphi) [P, G] of per-pair coefficient rows coef
    [P, C] (already multiplied by each particle's scale) at nodes [P, G]."""
    full = lambda like, v: torch.full_like(like, v)
    Y, dYt, dYp = _harmonics(ct, st, cp, sp, lmax, full, grad=True)
    r = torch.zeros_like(ct)
    drt = torch.zeros_like(ct)
    drp = torch.zeros_like(ct)
    for k in range(len(Y)):
        c = coef[:, k:k + 1]
        r = r + c * Y[k]
        drt = drt + c * dYt[k]
        drp = drp + c * dYp[k]
    return r, drt, drp


class SphereQuadrature:
    """Gauss-Legendre in cos(theta) x uniform midpoints in phi."""

    def __init__(self, n_theta: int, n_phi: int):
        xs, ws = roots_legendre(n_theta)
        theta = np.arccos(xs)[::-1]
        w_t = ws[::-1]
        phi = (np.arange(n_phi) + 0.5) * (2.0 * np.pi / n_phi)
        tt, pp = np.meshgrid(theta, phi, indexing="ij")
        wt, _ = np.meshgrid(w_t, phi, indexing="ij")
        self.theta = tt.ravel()
        self.phi = pp.ravel()
        self.weights = (wt * (2.0 * np.pi / n_phi)).ravel()
        st, ct = np.sin(self.theta), np.cos(self.theta)
        self.dirs = np.stack([st * np.cos(self.phi), st * np.sin(self.phi),
                              ct], axis=-1)
