"""Real spherical-harmonic math on tensors (torch twin of
``spherharm_tpu/ops/sh_math.py``).

Conventions, identical to the reference: surfaces are star-convex radius
fields ``r(theta, phi) = sum_nm a_nm Y_nm`` with *real*, *fully
normalized* spherical harmonics and **no** Condon-Shortley phase,

    Y_n0      = Pbar_n0(cos theta)
    Y_nm, m>0 = sqrt(2) * Pbar_nm(cos theta) * cos(m phi)
    Y_nm, m<0 = sqrt(2) * Pbar_n|m|(cos theta) * sin(|m| phi)

so a sphere of radius R is the single coefficient ``a_00 = R sqrt(4 pi)``.
A coefficient vector has ``(lmax+1)**2`` entries at flat index
``n*n + (m + n)``.

The evaluators are plain functions of tensors: they take device and dtype
from their inputs and unroll the recurrences in Python at a given
``lmax``. ``SphereQuadrature`` / ``default_quadrature`` build their node
tensors on ``device`` (the card unless the caller asks for the CPU).

The port's contact and wall kernels evaluate surfaces in the power basis
(``ops/sh_power.py``); this module is the public shape-math API. Left out
on purpose: the reference's interp-table radius path
(``build_radius_table``, ``interp_radius``, ``interp_radius_batched``),
a CPU-speed expedient the port does not carry: it always evaluates the
surface exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import roots_legendre


def n_coeffs(lmax: int) -> int:
    """Number of real SH coefficients for a given lmax."""
    return (lmax + 1) ** 2


def sh_index(n: int, m: int) -> int:
    """Flat index of the (n, m) real SH coefficient."""
    return n * n + (m + n)


# ---------------------------------------------------------------------------
# Associated Legendre (fully normalized, no Condon-Shortley phase)
# ---------------------------------------------------------------------------


def _alp_all(cos_t, sin_t, lmax: int):
    """All fully-normalized ALPs ``Pbar_nm`` for n <= lmax, 0 <= m <= n,
    by the column-wise recurrence (Holmes & Featherstone 2002 style; the
    coefficients are in the reference's docstring). Returns a dict
    {(n, m): tensor} shaped like ``cos_t``."""
    P = {(0, 0): torch.full_like(cos_t, 1.0 / math.sqrt(4.0 * math.pi))}
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


def _cos_sin_m(phi, lmax: int):
    """cos(m phi), sin(m phi) for m = 0..lmax by chained angle addition."""
    cos_m = [torch.ones_like(phi)]
    sin_m = [torch.zeros_like(phi)]
    c1, s1 = torch.cos(phi), torch.sin(phi)
    for _ in range(1, lmax + 1):
        cos_m.append(cos_m[-1] * c1 - sin_m[-1] * s1)
        sin_m.append(sin_m[-1] * c1 + cos_m[-2] * s1)
    return cos_m, sin_m


def _inv_sin(sin_t):
    """1/sin(t) with the reference's pole guard."""
    return (1.0 / torch.clamp(sin_t.abs(), min=1e-6)
            * torch.sign(sin_t + 1e-30))


def real_sh_basis(theta, phi, lmax: int):
    """Real SH basis values ``Y[..., (lmax+1)**2]`` at (theta, phi)."""
    P = _alp_all(torch.cos(theta), torch.sin(theta), lmax)
    cos_m, sin_m = _cos_sin_m(phi, lmax)
    sq2 = math.sqrt(2.0)
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
    return torch.stack(cols, dim=-1)


def real_sh_basis_grad(theta, phi, lmax: int):
    """Basis values plus angular derivatives: ``(Y, dY_dtheta, dY_dphi)``,
    each ``[..., (lmax+1)**2]``, through the normalized-ALP identity
    sin(t) dPbar_nm/dt = n cos(t) Pbar_nm - e_nm Pbar_{n-1,m},
    e_nm = sqrt((n^2 - m^2) (2n+1)/(2n-1)), with the pole guard on
    1/sin(t)."""
    cos_t = torch.cos(theta)
    inv_sin = _inv_sin(torch.sin(theta))
    P = _alp_all(cos_t, torch.sin(theta), lmax)

    dP = {}
    for n in range(lmax + 1):
        for m in range(0, n + 1):
            if n == 0:
                dP[(n, m)] = torch.zeros_like(cos_t)
                continue
            term = n * cos_t * P[(n, m)]
            if m <= n - 1:
                e = math.sqrt((n * n - m * m) * (2 * n + 1) / (2 * n - 1))
                term = term - e * P[(n - 1, m)]
            dP[(n, m)] = term * inv_sin

    cos_m, sin_m = _cos_sin_m(phi, lmax)
    sq2 = math.sqrt(2.0)
    Y, dYt, dYp = [], [], []
    for n in range(lmax + 1):
        for m in range(-n, n + 1):
            am = abs(m)
            if m == 0:
                Y.append(P[(n, 0)])
                dYt.append(dP[(n, 0)])
                dYp.append(torch.zeros_like(phi))
            elif m > 0:
                Y.append(sq2 * P[(n, am)] * cos_m[am])
                dYt.append(sq2 * dP[(n, am)] * cos_m[am])
                dYp.append(-sq2 * am * P[(n, am)] * sin_m[am])
            else:
                Y.append(sq2 * P[(n, am)] * sin_m[am])
                dYt.append(sq2 * dP[(n, am)] * sin_m[am])
                dYp.append(sq2 * am * P[(n, am)] * cos_m[am])
    return (torch.stack(Y, dim=-1), torch.stack(dYt, dim=-1),
            torch.stack(dYp, dim=-1))


def radius_grad_streaming(coeffs, theta, phi, lmax: int):
    """Radius + angular gradients with immediate coefficient contraction
    (angle API over ``radius_grad_streaming_trig``)."""
    return radius_grad_streaming_trig(
        coeffs, torch.cos(theta), torch.sin(theta), torch.cos(phi),
        torch.sin(phi), lmax)


def radius_grad_streaming_trig(coeffs, cos_t, sin_t, cos_p, sin_p,
                               lmax: int):
    """(r, dr/dtheta, dr/dphi) shaped like ``cos_t``: each (n, m) term is
    multiplied into the running sums as the recurrence produces it, so no
    [..., NC] basis tensor is materialized. Takes trig components, not
    angles.

    coeffs: [..., NC] broadcastable against cos_t's leading dims (coeffs
    [P, NC] with cos_t [P, G] broadcasts each pair's coefficients along
    G)."""
    inv_sin = _inv_sin(sin_t)
    sq2 = math.sqrt(2.0)

    def coef(n, m):
        c = coeffs[..., sh_index(n, m)]
        return c[..., None] if coeffs.ndim == cos_t.ndim else c

    r = torch.zeros_like(cos_t)
    drt = torch.zeros_like(cos_t)
    drp = torch.zeros_like(cos_t)

    c1, s1 = cos_p, sin_p
    cos_m_prev = torch.ones_like(cos_t)
    sin_m_prev = torch.zeros_like(cos_t)

    # March over m (diagonal first): for each m walk n = m .. lmax with
    # the three-term recurrence, two P-columns live at a time.
    P_mm = torch.full_like(cos_t, 1.0 / math.sqrt(4.0 * math.pi))
    for m in range(0, lmax + 1):
        if m > 0:
            P_mm = math.sqrt((2 * m + 1) / (2 * m)) * sin_t * P_mm
            cos_m, sin_m = (
                cos_m_prev * c1 - sin_m_prev * s1,
                sin_m_prev * c1 + cos_m_prev * s1,
            )
            cos_m_prev, sin_m_prev = cos_m, sin_m
        else:
            cos_m, sin_m = cos_m_prev, sin_m_prev

        P_nm1 = None  # P_{n-1, m}
        P_nm = P_mm
        for n in range(m, lmax + 1):
            if n > m:
                if n == m + 1:
                    P_new = math.sqrt(2 * m + 3) * cos_t * P_nm
                else:
                    a = math.sqrt((4 * n * n - 1) / (n * n - m * m))
                    b = math.sqrt(
                        ((2 * n + 1) / (2 * n - 3))
                        * ((n - 1) ** 2 - m * m)
                        / (n * n - m * m)
                    )
                    P_new = a * cos_t * P_nm - b * P_nm1
                P_nm1, P_nm = P_nm, P_new
            if n == 0:
                dP = torch.zeros_like(cos_t)
            else:
                term = n * cos_t * P_nm
                if n - 1 >= m:
                    e = math.sqrt((n * n - m * m) * (2 * n + 1) / (2 * n - 1))
                    term = term - e * P_nm1
                dP = term * inv_sin
            if m == 0:
                a0 = coef(n, 0)
                r = r + a0 * P_nm
                drt = drt + a0 * dP
            else:
                ac = sq2 * coef(n, m)
                as_ = sq2 * coef(n, -m)
                yc = P_nm * cos_m
                ys = P_nm * sin_m
                r = r + ac * yc + as_ * ys
                drt = drt + (ac * cos_m + as_ * sin_m) * dP
                drp = drp + m * (as_ * yc - ac * ys)
    return r, drt, drp


def radius_from_basis(coeffs, basis):
    """``r = sum_c a_c Y_c``: coeffs [..., NC], basis [..., NC]
    (broadcastable) -> [...]."""
    return (coeffs * basis).sum(-1)


# ---------------------------------------------------------------------------
# Quadrature on the sphere
# ---------------------------------------------------------------------------


class SphereQuadrature:
    """Gauss-Legendre (theta) x trapezoid (phi) product grid on S^2.

    Nodes are computed once on the host in float64 and stored in ``dtype``
    on ``device``. ``weights`` are solid-angle weights summing to 4 pi:
    w_gl(theta) * (2 pi / n_phi), the sin(theta) Jacobian inside w_gl
    through the cos(theta) substitution."""

    def __init__(self, n_theta: int, n_phi: int, dtype=torch.float32,
                 device="cuda"):
        xs, ws = roots_legendre(n_theta)  # nodes in cos(theta) on [-1, 1]
        theta = np.arccos(xs)[::-1]  # increasing theta
        w_t = ws[::-1]
        phi = (np.arange(n_phi) + 0.5) * (2.0 * np.pi / n_phi)
        tt, pp = np.meshgrid(theta, phi, indexing="ij")
        wt, _ = np.meshgrid(w_t, phi, indexing="ij")
        f = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)
        self.n_theta = n_theta
        self.n_phi = n_phi
        self.n_nodes = n_theta * n_phi
        self.theta = f(tt.ravel())
        self.phi = f(pp.ravel())
        self.weights = f((wt * (2.0 * np.pi / n_phi)).ravel())
        st, ct = np.sin(tt.ravel()), np.cos(tt.ravel())
        sp, cp = np.sin(pp.ravel()), np.cos(pp.ravel())
        # Unit direction vectors n_hat [G, 3].
        self.dirs = f(np.stack([st * cp, st * sp, ct], axis=-1))


def default_quadrature(lmax: int, oversample: int = 2, dtype=torch.float32,
                       device="cuda"):
    """Quadrature exact for products of degree-lmax surfaces:
    ``n_theta = oversample*(lmax+1)`` GL nodes (at least 4) and
    ``n_phi = 2*n_theta`` trapezoid nodes."""
    n_theta = max(oversample * (lmax + 1), 4)
    return SphereQuadrature(n_theta, 2 * n_theta, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Shape integrals (set-up path: small, once per shape type)
# ---------------------------------------------------------------------------


def shape_volume(coeffs, quad_theta, quad_phi, quad_w, lmax: int):
    """V = (1/3) * integral r^3 dOmega by quadrature."""
    r = radius_from_basis(coeffs, real_sh_basis(quad_theta, quad_phi, lmax))
    return (quad_w * r**3).sum() / 3.0


def shape_inertia(coeffs, quad_theta, quad_phi, quad_w, dirs, lmax: int):
    """Unit-density inertia tensor [3, 3] about the origin:
    I_ab = integral dOmega (r^5/5) (delta_ab - n_a n_b)."""
    r = radius_from_basis(coeffs, real_sh_basis(quad_theta, quad_phi, lmax))
    w5 = quad_w * r**5 / 5.0
    nn = dirs[..., :, None] * dirs[..., None, :]  # [G, 3, 3]
    eye = torch.eye(3, dtype=dirs.dtype, device=dirs.device)
    return (w5[..., None, None] * (eye - nn)).sum(0)


def shape_centroid(coeffs, quad_theta, quad_phi, quad_w, dirs, lmax: int):
    """Centre of mass (unit density): (1/4V) integral r^4 n dOmega."""
    r = radius_from_basis(coeffs, real_sh_basis(quad_theta, quad_phi, lmax))
    vol = (quad_w * r**3).sum() / 3.0
    com = ((quad_w * r**4 / 4.0)[:, None] * dirs).sum(0)
    return com / vol


def shape_rmax(coeffs, lmax: int, n_scan: int = 96) -> float:
    """Conservative bounding-sphere radius: dense scan plus 1 % margin,
    in the dtype and on the device of ``coeffs`` (a numpy array scans in
    float64 on the CPU)."""
    c = torch.as_tensor(coeffs)
    q = SphereQuadrature(n_scan, 2 * n_scan, dtype=c.dtype, device=c.device)
    r = radius_from_basis(c, real_sh_basis(q.theta, q.phi, lmax))
    return float(r.max()) * 1.001


# ---------------------------------------------------------------------------
# Surface normals
# ---------------------------------------------------------------------------


def surface_normal(r, dr_dt, dr_dp, theta, phi):
    """Angle API over ``surface_normal_trig``."""
    return surface_normal_trig(
        r, dr_dt, dr_dp, torch.cos(theta), torch.sin(theta),
        torch.cos(phi), torch.sin(phi))


def surface_normal_trig(r, dr_dt, dr_dp, ct, st, cp, sp):
    """Outward unit normal [..., 3] of the surface p = r(theta, phi) e_r:
    n ~ e_r - (dr/dtheta / r) e_theta - (dr/dphi / (r sin t)) e_phi."""
    e_r = torch.stack([st * cp, st * sp, ct], dim=-1)
    e_t = torch.stack([ct * cp, ct * sp, -st], dim=-1)
    e_p = torch.stack([-sp, cp, torch.zeros_like(sp)], dim=-1)
    inv_r = 1.0 / torch.clamp(r, min=1e-12)
    inv_rs = inv_r / torch.clamp(st.abs(), min=1e-6)
    n = (e_r
         - (dr_dt * inv_r)[..., None] * e_t
         - (dr_dp * inv_rs)[..., None] * e_p)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                           min=1e-12)
