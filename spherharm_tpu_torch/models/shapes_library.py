"""Shape pipeline: SH coefficient generation + per-type table precompute.

The numpy parts are a copy of ``spherharm_tpu/models/shapes_library.py``:
everything runs once on the host in float64 numpy with the same seeds, so
both packages build bit-identical tables. Only the final ``Shapes``
container is torch data, in ``dtype`` on ``device``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import roots_legendre

from spherharm_tpu_torch.core.state import Shapes
from spherharm_tpu_torch.ops.sh_np import (
    SphereQuadratureNp,
    real_sh_basis_grad_np,
    real_sh_basis_np,
    surface_normal_np,
)

SQRT4PI = math.sqrt(4.0 * math.pi)


def n_coeffs(lmax: int) -> int:
    return (lmax + 1) ** 2


def sh_index(n: int, m: int) -> int:
    return n * n + (m + n)


def sphere_coeffs(radius: float, lmax: int) -> np.ndarray:
    """A sphere is the single l=0 coefficient a_00 = R * sqrt(4 pi)."""
    c = np.zeros(n_coeffs(lmax))
    c[0] = radius * SQRT4PI
    return c


def project_radius_fn(radius_fn, lmax: int, n_quad: int = 64) -> np.ndarray:
    """Project an arbitrary radius function r(theta, phi) onto the SH basis.

    a_nm = integral r(theta,phi) Y_nm dOmega (orthonormal basis).
    radius_fn: vectorized (theta[G], phi[G]) -> r[G]. This is the hook for
    loading scanned-particle surfaces (config 3, BASELINE.json:9).
    """
    q = SphereQuadratureNp(n_quad, 2 * n_quad)
    Y = real_sh_basis_np(q.theta, q.phi, lmax)  # [G, NC]
    r = np.asarray(radius_fn(q.theta, q.phi), np.float64)
    return np.sum(q.weights[:, None] * r[:, None] * Y, axis=0)


def ellipsoid_coeffs(a: float, b: float, c: float, lmax: int,
                     n_quad: int = 64) -> np.ndarray:
    """SH projection of an axis-aligned ellipsoid's polar radius.

    r(theta,phi) = (sin^2 t (cos^2 p / a^2 + sin^2 p / b^2)
                    + cos^2 t / c^2)^(-1/2).
    Principal axes align with the body frame by construction.
    """

    def fn(theta, phi):
        st2 = np.sin(theta) ** 2
        return 1.0 / np.sqrt(
            st2 * (np.cos(phi) ** 2 / a**2 + np.sin(phi) ** 2 / b**2)
            + np.cos(theta) ** 2 / c**2
        )

    return project_radius_fn(fn, lmax, n_quad)


def blob_coeffs(lmax: int, seed: int = 0, mean_radius: float = 1.0,
                roughness: float = 0.15, spectral_decay: float = 1.5,
                ) -> np.ndarray:
    """Random 'scanned-particle-like' smooth shape with diagonal inertia.

    Generates random coefficients restricted to the symmetry class
    r(t,p) = r(t,-p) = r(t,pi-p) = r(pi-t,p)  (three mirror symmetries:
    only m >= 0 even cosine terms with n+m even), which guarantees the
    body-frame inertia tensor is diagonal — so principal axes are the
    coordinate axes and no Wigner rotation of coefficients is needed.

    Amplitudes decay as n^{-spectral_decay}; the total perturbation is
    rescaled so min r stays >= (1 - 2*roughness) * mean_radius
    (star-convex, r > 0 everywhere).
    """
    rng = np.random.default_rng(seed)
    c = np.zeros(n_coeffs(lmax))
    c[0] = mean_radius * SQRT4PI
    for n in range(2, lmax + 1):
        for m in range(0, n + 1, 2):
            if (n + m) % 2 != 0:
                continue
            amp = mean_radius * roughness / (n**spectral_decay)
            c[sh_index(n, m)] = rng.normal() * amp
    # Safety clamp: rescale perturbation if the surface dips too low.
    q = SphereQuadratureNp(48, 96)
    Y = real_sh_basis_np(q.theta, q.phi, lmax)
    r = Y @ c
    rmin_target = (1.0 - 2.0 * roughness) * mean_radius
    pert_min = float(r.min()) - mean_radius
    if mean_radius + pert_min < rmin_target and pert_min < 0:
        s = (mean_radius - rmin_target) / (-pert_min)
        c[1:] *= s
    return c


def build_shapes(
    coeffs,
    lmax: int,
    density=1.0,
    contact_quad: tuple[int, int] | None = None,
    stage1_quad: tuple[int, int] = (4, 8),
    setup_quad_n: int = 48,
    dtype=torch.float32,
    device="cuda",
) -> Shapes:
    """Precompute all per-type tables (numpy) and pack a ``Shapes``.

    coeffs: [T, (lmax+1)^2] array-like of real SH coefficients.
    contact_quad: (n_gamma, n_psi) of BOTH the per-type full-surface node
      set (walls) and the patch-local cap grid the pair kernel builds per
      contact; defaults to (max(lmax+1, 6), 2*max(lmax+1, 6)) —
      "high-order quadrature" configs raise it.
    """
    coeffs = np.atleast_2d(np.asarray(coeffs, np.float64))
    T = coeffs.shape[0]
    density = np.broadcast_to(np.asarray(density, np.float64), (T,))

    # Contact node set (full-surface; used by walls + diagnostics).
    if contact_quad is None:
        contact_quad = (max(lmax + 1, 6), 2 * max(lmax + 1, 6))
    cq = SphereQuadratureNp(contact_quad[0], contact_quad[1])
    Y, dYt, dYp = real_sh_basis_grad_np(cq.theta, cq.phi, lmax)
    node_r = coeffs @ Y.T          # [T, G]
    node_drt = coeffs @ dYt.T
    node_drp = coeffs @ dYp.T
    node_normals = surface_normal_np(
        node_r, node_drt, node_drp, cq.theta[None, :], cq.phi[None, :]
    )
    cos_ang = np.clip(
        np.sum(node_normals * cq.dirs[None], axis=-1), 0.05, 1.0
    )
    node_area = cq.weights[None, :] * node_r**2 / cos_ang

    # Patch-local cap quadrature grid (flattened n_gamma x n_psi): GL
    # nodes in a unit variable x in (0,1); at runtime the pair kernel maps
    # cos(gamma) = 1 - (1 - cos(gamma_max)) * x, so resolution adapts to
    # the contact-cap size (SURVEY.md 7.3 "patch-local quadrature").
    def _cap_grid(n_gamma, n_psi):
        gl_x, gl_w = roots_legendre(n_gamma)
        cap_x1 = (np.asarray(gl_x) + 1.0) / 2.0     # (0, 1)
        cap_w1 = np.asarray(gl_w) / 2.0             # sums to 1
        psi = (np.arange(n_psi) + 0.5) * (2.0 * np.pi / n_psi)
        cx, cp = np.meshgrid(cap_x1, psi, indexing="ij")
        cw, _ = np.meshgrid(cap_w1, psi, indexing="ij")
        return (cx.ravel(), (cw * (2.0 * np.pi / n_psi)).ravel(),
                np.cos(cp.ravel()), np.sin(cp.ravel()))

    cap_x, cap_glw, cap_cpsi, cap_spsi = _cap_grid(*contact_quad)
    # Coarse stage-1 containment grid (two-stage narrow phase; keep it a
    # lane-friendly 32 nodes).
    cap1_x, cap1_glw, cap1_cpsi, cap1_spsi = _cap_grid(*stage1_quad)

    # High-order setup quadrature for volume / inertia / rmax.
    sq = SphereQuadratureNp(setup_quad_n, 2 * setup_quad_n)
    Ys = real_sh_basis_np(sq.theta, sq.phi, lmax)
    r_s = coeffs @ Ys.T  # [T, Gs]
    vol = np.sum(sq.weights[None] * r_s**3, axis=-1) / 3.0
    w5 = sq.weights[None] * r_s**5 / 5.0
    nn = sq.dirs[:, :, None] * sq.dirs[:, None, :]  # [Gs,3,3]
    inertia_full = np.einsum(
        "tg,gab->tab", w5, np.eye(3)[None] - nn
    )
    rmax = r_s.max(axis=-1) * 1.001
    rmin = r_s.min(axis=-1) * 0.999

    diag = np.einsum("taa->ta", inertia_full)
    off = np.abs(inertia_full - diag[:, :, None] * np.eye(3)[None]).max((1, 2))
    if np.any(off > 1e-3 * diag.max(axis=-1)):
        raise ValueError(
            "Shape inertia tensor is not diagonal — shapes must be given in "
            "their principal frame (max off-diag/diag: "
            f"{float((off / diag.max(-1)).max()):.2e})."
        )

    # Power-basis Horner tables for the hot kernels (ops/sh_power.py);
    # the stage-1 probe gets an l1-truncated r-only (A/B) table plus the
    # conservative truncation tail bound (|Y_lm| <= sqrt((2l+1)/4pi)).
    from spherharm_tpu_torch.ops import sh_power

    l1 = min(4, lmax)
    power_tbl = sh_power.build_power_tables_np(coeffs, lmax)
    ymax = math.sqrt((2 * lmax + 1) / (4.0 * math.pi))
    tail1 = ymax * np.sum(np.abs(coeffs[:, n_coeffs(l1):]), axis=1)
    # Max tangential surface gradient (rotation skin bound; 0 = sphere).
    # Sampled on a DENSE uniform grid (not the coarse contact-quad
    # nodes, whose peaks can fall between samples for rough lmax=8
    # blobs) — a too-small gmax silently voids the prefilter's
    # rotation-trigger guarantee. The grid step bounds the missed-peak
    # error: with ~24 samples per max oscillation (lmax=8 on a 96x192
    # grid), the 1.1 margin dominates it.
    th_d = np.linspace(1e-3, math.pi - 1e-3, 96)
    ph_d = np.linspace(0.0, 2.0 * math.pi, 192, endpoint=False)
    thg, phg = np.meshgrid(th_d, ph_d, indexing="ij")
    gmax = np.zeros(coeffs.shape[0])
    for t in range(coeffs.shape[0]):
        _, drt_d, drp_d = sh_power.eval_power_np(
            power_tbl[t], thg.ravel(), phg.ravel(), lmax
        )
        gt_d = np.sqrt(
            drt_d**2 + (drp_d / np.maximum(np.abs(
                np.sin(thg.ravel())), 1e-3))**2
        )
        gmax[t] = float(gt_d.max()) * 1.1

    f = lambda a: torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return Shapes(
        lmax=lmax,
        coeffs=f(coeffs),
        quad_theta=f(cq.theta),
        quad_phi=f(cq.phi),
        quad_w=f(cq.weights),
        quad_dirs=f(cq.dirs),
        node_r=f(node_r),
        node_normals=f(node_normals),
        node_area=f(node_area),
        rmax=f(rmax),
        rmin=f(rmin),
        rchar=f(coeffs[:, 0] / SQRT4PI),
        cap_x=f(cap_x),
        cap_glw=f(cap_glw),
        cap_cpsi=f(cap_cpsi),
        cap_spsi=f(cap_spsi),
        cap1_x=f(cap1_x),
        cap1_glw=f(cap1_glw),
        cap1_cpsi=f(cap1_cpsi),
        cap1_spsi=f(cap1_spsi),
        vol=f(vol),
        inertia=f(diag),
        density=f(density),
        l1=l1,
        power_tbl=f(power_tbl),
        tail1=f(tail1),
        gmax=f(gmax),
    )
