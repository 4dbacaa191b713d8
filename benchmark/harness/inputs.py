"""What the benchmark hands to both sides: the blob coefficients of each
shape type and the geometry of each deployment, from its configuration
file. Nothing here reads anything the program derives.
"""

from __future__ import annotations

import importlib

import numpy as np

from benchmark.reference.sh import SQRT4PI, SphereQuadrature, basis_np, n_coeffs
from benchmark.reference.shapes import ref_shapes


def blob_coeffs(lmax: int, seed: int, mean_radius: float, roughness: float,
                spectral_decay: float = 1.5) -> np.ndarray:
    """A smooth random 'scanned particle' of three mirror symmetries (only
    m >= 0 even cosine terms with n + m even, so the inertia tensor is
    diagonal in the body frame), amplitudes falling as n^-1.5, the
    perturbation rescaled so that min r >= (1 - 2 roughness) mean_radius:
    the reference's ``blob_coeffs``, seed for seed."""
    rng = np.random.default_rng(seed)
    c = np.zeros(n_coeffs(lmax))
    c[0] = mean_radius * SQRT4PI
    for n in range(2, lmax + 1):
        for m in range(0, n + 1, 2):
            if (n + m) % 2:
                continue
            c[n * n + m + n] = rng.normal() * mean_radius * roughness / (
                n ** spectral_decay)
    q = SphereQuadrature(48, 96)
    r = basis_np(q.theta, q.phi, lmax) @ c
    floor = (1.0 - 2.0 * roughness) * mean_radius
    dip = float(r.min()) - mean_radius
    if mean_radius + dip < floor and dip < 0:
        c[1:] *= (mean_radius - floor) / (-dip)
    return c


def contact_quad(cfg) -> tuple:
    """The cap grid (n_gamma, n_psi): the configuration's, or the
    default max(lmax + 1, 6) x twice that."""
    if cfg.get("contact_quad"):
        return tuple(cfg["contact_quad"])
    g = max(cfg["lmax"] + 1, 6)
    return (g, 2 * g)


def deployment(cfg: dict) -> dict:
    """The coefficients, reference shapes and geometry of a configuration:
    the material and the rates here, the box and the walls from the
    builder the configuration names (``builders/<builder>.py``), as plain
    numbers."""
    coeffs = np.stack([
        blob_coeffs(cfg["lmax"], cfg["shape_seed"] + t, cfg["mean_radius"],
                    cfg["roughness"]) for t in range(cfg["n_shape_types"])])
    shapes = ref_shapes(coeffs, cfg["lmax"], contact_quad(cfg),
                        cfg["density"])
    kt = 2.0 / 7.0 * cfg["kn"]
    gt = 0.5 * cfg["gamma_n"]
    mat = [cfg["kn"], kt, cfg["gamma_n"], gt, cfg["mu"], cfg.get("k_roll", 0.0),
           cfg.get("gamma_roll", 0.0), cfg.get("mu_roll", 0.0)]
    geo = dict(coeffs=coeffs, ref_shapes=shapes, mat=mat, n=cfg["n"],
               gravity=list(cfg.get("gravity", [0.0, 0.0, 0.0])),
               deform_rate=list(cfg.get("strain_rate", [0.0] * 3)),
               shear_rate=list(cfg.get("shear_rate", [0.0] * 3)))
    builder(cfg).geometry(cfg, geo)
    return geo


def builder(cfg: dict):
    """The module of the configuration's builder."""
    return importlib.import_module(f"benchmark.builders.{cfg['builder']}")


def reference_config(cfg: dict, geo: dict) -> dict:
    """The plain numbers the reference step takes."""
    return dict(lmax=cfg["lmax"], conservative=cfg["conservative"],
                mat=geo["mat"], dt=cfg["dt"], gravity=geo["gravity"],
                periodic=geo["periodic"], deform_rate=geo["deform_rate"],
                shear_rate=geo["shear_rate"], walls=geo["walls"])
