"""The port's SH math (``spherharm_tpu_torch/ops/sh_math.py``) against the
JAX package's ``ops/sh_math.py`` on the same f32 inputs at lmax 0, 2, 5
and 8, and the reference's own SH oracle tests (tests/test_sh_math.py,
less its two interp-table tests: the port has no interp table;
tests/test_sh_np.py and tests/test_sh_power.py) mirrored on the port's
twins at the reference tests' tolerances.

f32 parity tolerances: both sides run the same recurrences in f32, the
reference under jit (XLA may fuse and reorder), the port eagerly; the
values sit within a few ulps of the f32 scale of the result."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import sph_harm_y

from spherharm_tpu.models import shapes_library as jshapes
from spherharm_tpu.ops import sh_math as jsh
from spherharm_tpu_torch.models import shapes_library as shapes_lib
from spherharm_tpu_torch.ops import sh_math, sh_np, sh_power

from torch_port_util import np32

F64 = torch.float64
CPU = "cpu"
LMAXES = [0, 2, 5, 8]


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _angles(seed, n=40, margin=0.05):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(margin, np.pi - margin, n).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    return theta, phi


def _coeffs(lmax, seed=0):
    return shapes_lib.blob_coeffs(lmax, seed=seed, roughness=0.15)


def _close32(got, ref, scale=None, ulps=64):
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max() if scale is None else scale
    tol = ulps * np.finfo(np.float32).eps * max(scale, 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol)


# -- parity with the JAX package, f32 ---------------------------------------


def test_index_helpers_match_reference():
    for lmax in LMAXES:
        assert sh_math.n_coeffs(lmax) == jsh.n_coeffs(lmax)
        for n in range(lmax + 1):
            for m in range(-n, n + 1):
                assert sh_math.sh_index(n, m) == jsh.sh_index(n, m)


@pytest.mark.parametrize("lmax", LMAXES)
def test_basis_and_alp_match_reference(lmax):
    theta, phi = _angles(lmax)
    ct, st = np.cos(theta), np.sin(theta)
    P_t = sh_math._alp_all(t32(ct), t32(st), lmax)
    P_j = jsh._alp_all(jnp.asarray(ct), jnp.asarray(st), lmax)
    assert P_t.keys() == P_j.keys()
    for k in P_j:
        _close32(np32(P_t[k]), P_j[k], scale=1.0)
    _close32(np32(sh_math.real_sh_basis(t32(theta), t32(phi), lmax)),
             jsh.real_sh_basis(jnp.asarray(theta), jnp.asarray(phi), lmax))
    got = sh_math.real_sh_basis_grad(t32(theta), t32(phi), lmax)
    ref = jsh.real_sh_basis_grad(jnp.asarray(theta), jnp.asarray(phi), lmax)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        _close32(np32(g), r)


@pytest.mark.parametrize("lmax", LMAXES)
def test_radius_streaming_and_normals_match_reference(lmax):
    """radius_grad_streaming (angle API over the _trig form) with
    per-element coefficients broadcast along G, radius_from_basis, and
    surface_normal over the _trig form."""
    theta, phi = _angles(10 + lmax, n=3 * 16)
    theta, phi = theta.reshape(3, 16), phi.reshape(3, 16)
    c = np.stack([_coeffs(lmax, s) for s in range(3)]).astype(np.float32)
    got = sh_math.radius_grad_streaming(t32(c), t32(theta), t32(phi), lmax)
    ref = jsh.radius_grad_streaming(jnp.asarray(c), jnp.asarray(theta),
                                    jnp.asarray(phi), lmax)
    r_scale = float(np.abs(np.asarray(ref[0])).max())
    for g, r in zip(got, ref):
        _close32(np32(g), r, scale=r_scale)
    Y = sh_math.real_sh_basis(t32(theta), t32(phi), lmax)
    _close32(np32(sh_math.radius_from_basis(t32(c)[:, None, :], Y)),
             jsh.radius_from_basis(
                 jnp.asarray(c)[:, None, :],
                 jsh.real_sh_basis(jnp.asarray(theta), jnp.asarray(phi),
                                   lmax)), scale=r_scale)
    n_t = sh_math.surface_normal(*got, t32(theta), t32(phi))
    n_j = jsh.surface_normal(*ref, jnp.asarray(theta), jnp.asarray(phi))
    assert n_t.shape == (3, 16, 3)
    _close32(np32(n_t), n_j, scale=1.0, ulps=256)


@pytest.mark.parametrize("lmax", LMAXES)
def test_quadrature_and_shape_integrals_match_reference(lmax):
    q_t = sh_math.default_quadrature(lmax, device=CPU)
    q_j = jsh.default_quadrature(lmax)
    assert (q_t.n_theta, q_t.n_phi, q_t.n_nodes) == (q_j.n_theta, q_j.n_phi,
                                                     q_j.n_nodes)
    for f in ("theta", "phi", "weights", "dirs"):
        got = getattr(q_t, f)
        assert got.dtype == torch.float32 and got.device.type == CPU
        np.testing.assert_array_equal(np32(got), np.asarray(getattr(q_j, f)))
    c = _coeffs(lmax, 7).astype(np.float32)
    tq = (q_t.theta, q_t.phi, q_t.weights)
    jq = (q_j.theta, q_j.phi, q_j.weights)
    _close32(float(sh_math.shape_volume(t32(c), *tq, lmax)),
             jsh.shape_volume(jnp.asarray(c), *jq, lmax))
    _close32(np32(sh_math.shape_inertia(t32(c), *tq, q_t.dirs, lmax)),
             jsh.shape_inertia(jnp.asarray(c), *jq, q_j.dirs, lmax))
    # The centroid of a mirror-symmetric blob is ~0: hold it to the
    # radius scale.
    _close32(np32(sh_math.shape_centroid(t32(c), *tq, q_t.dirs, lmax)),
             jsh.shape_centroid(jnp.asarray(c), *jq, q_j.dirs, lmax),
             scale=1.0)
    assert sh_math.shape_rmax(t32(c), lmax, n_scan=32) == pytest.approx(
        jsh.shape_rmax(jnp.asarray(c), lmax, n_scan=32), rel=1e-6)


def test_tensors_stay_where_they_are_given():
    """The evaluators take dtype and device from their inputs; the
    quadrature builds on the device asked for (the card by default)."""
    theta, phi = _angles(3)
    Y = sh_math.real_sh_basis(t64(theta), t64(phi), 4)
    assert Y.dtype == F64 and Y.shape == (40, 25)
    q = sh_math.SphereQuadrature(4, 8, dtype=F64, device=CPU)
    assert q.weights.dtype == F64
    assert abs(float(q.weights.sum()) - 4 * math.pi) < 1e-12
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            sh_math.SphereQuadrature(4, 8)


# -- tests/test_sh_math.py, mirrored ---------------------------------------


def scipy_real_sh(n, m, theta, phi):
    """Real, fully-normalized, no-Condon-Shortley SH from scipy's complex Y."""
    if m == 0:
        return np.real(sph_harm_y(n, 0, theta, phi))
    if m > 0:
        return math.sqrt(2.0) * (-1) ** m * np.real(sph_harm_y(n, m, theta, phi))
    return math.sqrt(2.0) * (-1) ** (-m) * np.imag(sph_harm_y(n, -m, theta, phi))


@pytest.mark.parametrize("lmax", LMAXES)
def test_basis_matches_scipy(lmax):
    rng = np.random.default_rng(0)
    theta = rng.uniform(0.05, np.pi - 0.05, 40)
    phi = rng.uniform(0, 2 * np.pi, 40)
    Y = sh_math.real_sh_basis(t64(theta), t64(phi), lmax).numpy()
    for n in range(lmax + 1):
        for m in range(-n, n + 1):
            ref = scipy_real_sh(n, m, theta, phi)
            got = Y[:, sh_math.sh_index(n, m)]
            np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_basis_orthonormal():
    lmax = 6
    q = sh_math.default_quadrature(lmax, oversample=2, dtype=F64, device=CPU)
    Y = sh_math.real_sh_basis(q.theta, q.phi, lmax)
    gram = torch.einsum("g,gi,gj->ij", q.weights, Y, Y).numpy()
    np.testing.assert_allclose(gram, np.eye(sh_math.n_coeffs(lmax)),
                               atol=1e-10)


def test_basis_grad_matches_finite_difference():
    lmax = 6
    rng = np.random.default_rng(1)
    theta = t64(rng.uniform(0.2, np.pi - 0.2, 30))
    phi = t64(rng.uniform(0, 2 * np.pi, 30))
    Y, dYt, dYp = sh_math.real_sh_basis_grad(theta, phi, lmax)
    eps = 1e-6
    basis = lambda th, ph: sh_math.real_sh_basis(th, ph, lmax)
    fd_t = (basis(theta + eps, phi) - basis(theta - eps, phi)) / (2 * eps)
    fd_p = (basis(theta, phi + eps) - basis(theta, phi - eps)) / (2 * eps)
    np.testing.assert_allclose(dYt.numpy(), fd_t.numpy(), atol=1e-5)
    np.testing.assert_allclose(dYp.numpy(), fd_p.numpy(), atol=1e-5)
    np.testing.assert_allclose(Y.numpy(), basis(theta, phi).numpy(),
                               rtol=1e-12)


def test_sphere_volume_inertia():
    lmax, R = 4, 1.7
    c = t64(shapes_lib.sphere_coeffs(R, lmax))
    q = sh_math.default_quadrature(lmax + 2, dtype=F64, device=CPU)
    vol = float(sh_math.shape_volume(c, q.theta, q.phi, q.weights, lmax))
    assert vol == pytest.approx(4.0 / 3.0 * np.pi * R**3, rel=1e-8)
    inertia = sh_math.shape_inertia(c, q.theta, q.phi, q.weights, q.dirs,
                                    lmax).numpy()
    # Unit density: I = (2/5) M R^2, M = rho * V.
    expect = 0.4 * vol * R**2
    np.testing.assert_allclose(inertia, expect * np.eye(3), rtol=1e-8,
                               atol=1e-10 * expect)


def test_ellipsoid_volume_inertia():
    lmax = 8
    a, b, c_ = 1.0, 0.7, 0.5
    coef = t64(shapes_lib.ellipsoid_coeffs(a, b, c_, lmax))
    q = sh_math.default_quadrature(lmax + 4, dtype=F64, device=CPU)
    vol = float(sh_math.shape_volume(coef, q.theta, q.phi, q.weights, lmax))
    # SH truncation at lmax=8 approximates the ellipsoid to ~0.1%.
    assert vol == pytest.approx(4.0 / 3.0 * np.pi * a * b * c_, rel=2e-3)
    inertia = sh_math.shape_inertia(coef, q.theta, q.phi, q.weights, q.dirs,
                                    lmax).numpy()
    expect = vol / 5.0 * np.array([b**2 + c_**2, a**2 + c_**2, a**2 + b**2])
    np.testing.assert_allclose(np.diag(inertia), expect, rtol=2e-2)
    off = inertia - np.diag(np.diag(inertia))
    assert np.abs(off).max() < 1e-6 * np.diag(inertia).max()


def test_blob_star_convex():
    lmax = 8
    coef = t32(shapes_lib.blob_coeffs(lmax, seed=11, roughness=0.25))
    q = sh_math.SphereQuadrature(64, 128, device=CPU)
    r = sh_math.radius_from_basis(coef, sh_math.real_sh_basis(q.theta, q.phi,
                                                              lmax))
    assert float(r.min()) > 0.2  # strictly positive radius everywhere


def test_build_shapes_tables():
    lmax = 4
    coeffs = np.stack([shapes_lib.sphere_coeffs(1.0, lmax),
                       shapes_lib.ellipsoid_coeffs(1.0, 0.8, 0.6, lmax)])
    sh = shapes_lib.build_shapes(coeffs, lmax, density=2.0, device=CPU)
    assert sh.n_types == 2
    assert sh.node_r.shape == (2, sh.quad_theta.shape[0])
    assert float(sh.rchar[0]) == pytest.approx(1.0, rel=1e-6)
    assert float(sh.vol[0]) == pytest.approx(4 / 3 * np.pi, rel=1e-4)
    # Sphere normals point radially outward.
    dots = (sh.node_normals[0] * sh.quad_dirs).sum(-1)
    assert float(dots.min()) > 0.999
    # Mass/inertia helpers include scale laws.
    m = sh.mass_of(torch.tensor([0]), torch.tensor([2.0]))
    assert float(m[0]) == pytest.approx(2.0 * 4 / 3 * np.pi * 8.0, rel=1e-4)


# -- tests/test_sh_np.py, mirrored on the port's numpy twins ----------------


def test_basis_twins_agree():
    rng = np.random.default_rng(0)
    theta = rng.uniform(0.05, np.pi - 0.05, 50)
    phi = rng.uniform(0, 2 * np.pi, 50)
    for lmax in (0, 3, 8):
        a = sh_np.real_sh_basis_np(theta, phi, lmax)
        b = sh_math.real_sh_basis(t64(theta), t64(phi), lmax).numpy()
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)


def test_grad_twins_agree():
    rng = np.random.default_rng(1)
    theta = rng.uniform(0.1, np.pi - 0.1, 30)
    phi = rng.uniform(0, 2 * np.pi, 30)
    lmax = 6
    a = sh_np.real_sh_basis_grad_np(theta, phi, lmax)
    b = sh_math.real_sh_basis_grad(t64(theta), t64(phi), lmax)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y.numpy(), rtol=1e-10, atol=1e-12)


def test_normal_twins_agree():
    """surface_normal vs the numpy set-up twin (the port's stand-in for the
    reference's radius-table twin test, whose table the port leaves out)."""
    rng = np.random.default_rng(2)
    lmax = 4
    theta = rng.uniform(0.1, np.pi - 0.1, 40)
    phi = rng.uniform(0, 2 * np.pi, 40)
    c = _coeffs(lmax, 2)
    Y, dYt, dYp = sh_np.real_sh_basis_grad_np(theta, phi, lmax)
    a = sh_np.surface_normal_np(Y @ c, dYt @ c, dYp @ c, theta, phi)
    b = sh_math.surface_normal(t64(Y @ c), t64(dYt @ c), t64(dYp @ c),
                               t64(theta), t64(phi)).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_quadrature_twins_agree():
    a = sh_np.SphereQuadratureNp(8, 16)
    b = sh_math.SphereQuadrature(8, 16, dtype=F64, device=CPU)
    np.testing.assert_allclose(a.theta, b.theta.numpy())
    np.testing.assert_allclose(a.weights, b.weights.numpy())
    np.testing.assert_allclose(a.dirs, b.dirs.numpy())
    assert abs(a.weights.sum() - 4 * np.pi) < 1e-10


# -- tests/test_sh_power.py, mirrored on the port's power basis -------------


@pytest.mark.parametrize("lmax", [0, 2, 4, 8])
def test_power_tables_match_basis(lmax):
    coeffs = np.stack(
        [shapes_lib.blob_coeffs(lmax, seed=t, mean_radius=0.5,
                                roughness=0.12) for t in range(2)]
        + [shapes_lib.sphere_coeffs(0.4, lmax)])
    if lmax >= 2:
        coeffs = np.concatenate([coeffs, shapes_lib.ellipsoid_coeffs(
            0.55, 0.45, 0.4, lmax)[None]])
    tbl = sh_power.build_power_tables_np(coeffs, lmax)
    rng = np.random.default_rng(3)
    theta = rng.uniform(1e-3, np.pi - 1e-3, 400)
    phi = rng.uniform(0.0, 2 * np.pi, 400)
    Y, dYt, dYp = (b.numpy() for b in sh_math.real_sh_basis_grad(
        t64(theta), t64(phi), lmax))
    for t in range(coeffs.shape[0]):
        r, drt, drp = sh_power.eval_power_np(tbl[t], theta, phi, lmax)
        np.testing.assert_allclose(r, Y @ coeffs[t], rtol=0, atol=1e-11)
        np.testing.assert_allclose(drt, dYt @ coeffs[t], rtol=0, atol=1e-10)
        np.testing.assert_allclose(drp, dYp @ coeffs[t], rtol=0, atol=1e-10)


def test_f32_conditioning_lmax8():
    """Monomial Horner in f32 stays at ~1e-6 relative at lmax=8 against
    the float64 basis contraction."""
    lmax = 8
    c = shapes_lib.blob_coeffs(lmax, seed=0, mean_radius=0.5, roughness=0.12)
    tbl = t32(sh_power.build_power_tables_np(c, lmax))
    rng = np.random.default_rng(1)
    theta = rng.uniform(0, np.pi, 2000)
    phi = rng.uniform(0, 2 * np.pi, 2000)
    Y, dYt, _ = (b.numpy() for b in sh_math.real_sh_basis_grad(
        t64(theta), t64(phi), lmax))
    r, drt, _ = sh_power.eval_power(
        tbl, t32(np.cos(theta)), t32(np.sin(theta)), t32(np.cos(phi)),
        t32(np.sin(phi)), lmax)
    scale = np.abs(Y @ c).max()
    assert np.abs(r.numpy() - Y @ c).max() / scale < 1e-5
    assert np.abs(drt.numpy() - dYt @ c).max() / scale < 1e-5


def test_pole_regularity():
    """The power form is polynomial at the poles: drt and drp -> 0."""
    lmax = 8
    c = shapes_lib.blob_coeffs(lmax, seed=2, mean_radius=0.5, roughness=0.12)
    tbl = sh_power.build_power_tables_np(c, lmax)
    theta = np.array([1e-9, np.pi - 1e-9])
    phi = np.array([0.7, 2.1])
    r, drt, drp = sh_power.eval_power_np(tbl, theta, phi, lmax)
    assert np.all(np.isfinite(r)) and np.all(r > 0.2)
    assert np.all(np.abs(drt) < 1e-6)
    assert np.all(np.abs(drp) < 1e-6)


def test_shapes_carry_power_tables():
    shapes = shapes_lib.build_shapes(
        [shapes_lib.blob_coeffs(8, seed=0, mean_radius=0.5)], 8,
        contact_quad=(8, 16), device=CPU)
    assert shapes.power_tbl.shape == (1, sh_power.power_layout(8)["W"])
    assert float(shapes.tail1[0]) > 0
    assert float(shapes.gmax[0]) > 0
    sph = shapes_lib.build_shapes([shapes_lib.sphere_coeffs(0.5, 0)], 0,
                                  device=CPU)
    assert float(sph.gmax[0]) == 0.0
    assert float(sph.tail1[0]) == 0.0


def test_blob_coeffs_match_reference():
    for lmax in LMAXES:
        np.testing.assert_array_equal(_coeffs(lmax, 4),
                                      jshapes.blob_coeffs(lmax, seed=4,
                                                          roughness=0.15))
