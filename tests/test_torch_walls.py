"""Wall contact of the torch port vs the JAX reference
(ops/walls.py's jnp path with exact SH evaluation): plane and rotating
cylinder, friction + rolling, mid-contact springs, wall_cap compaction,
the per-wall material row. Tolerance 2e-3 |F|max, the reference's own
kernel-vs-jnp bound (tests/test_walls_pallas.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherharm_tpu.core.state import SimParams as JParams
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.models import shapes_library as jshapes
from spherharm_tpu.ops import walls as jwalls
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.ops import walls as twalls

from torch_port_util import blob_coeffs, np32, to_torch


def _system(seed=0, n=48, lmax=4, quad=(8, 16)):
    rng = np.random.default_rng(seed)
    shapes = jshapes.build_shapes(blob_coeffs(lmax, 2, seed=seed), lmax,
                                  contact_quad=quad)
    params = JParams.create(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4,
                            k_roll=2e4, gamma_roll=10.0, mu_roll=0.2,
                            cutoff=1.4, skin=0.2)
    # Positions straddling z = 0.5: through the wall, near it, far away.
    x = rng.uniform(0.8, 5.2, (n, 3))
    x[:, 2] = rng.uniform(0.25, 1.6, n)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = jscen.make_state(
        x, [0, 0, 0], [6, 6, 6], q=q, v=rng.normal(size=(n, 3)) * 0.3,
        angmom=rng.normal(size=(n, 3)) * 0.05,
        scale=rng.uniform(0.85, 1.15, n), shtype=rng.integers(0, 2, n))
    hist = rng.normal(size=(n, 6)).astype(np.float32) * 1e-4
    return shapes, params, state, hist


def _walls(kind, state):
    """Matching (jax, torch) walls; the cylinder case pushes 24 particles
    toward the shell so it sees real contacts."""
    if kind == "plane":
        args = ([0.0, 0.0, 0.5], [0.0, 0.0, 1.0])
        kw = dict(velocity=[0.1, 0.0, 0.0])
        return (jwalls.PlaneWall.create(*args, **kw),
                twalls.PlaneWall.create(*args, device="cpu", **kw), state)
    x = np.array(state.x)
    rel = x[:, :2] - 3.0
    rad = np.linalg.norm(rel, axis=1, keepdims=True)
    x[:24, :2] = 3.0 + rel[:24] / rad[:24] * np.linspace(2.2, 2.85, 24)[:, None]
    args = ([3.0, 3.0, 0.0], [0.0, 0.0, 1.0], 2.8)
    return (jwalls.CylinderWall.create(*args, omega=0.7),
            twalls.CylinderWall.create(*args, omega=0.7, device="cpu"),
            state.replace(x=jnp.asarray(x)))


def _compare(got, ref, tol=2e-3):
    f, t, h, pe = (np32(a) for a in got[:4])
    f_ref, t_ref, h_ref, pe_ref = (np.asarray(a) for a in ref[:4])
    fmag = max(np.abs(f_ref).max(), 1e-6)
    assert fmag > 1.0, "system should have real wall contacts"
    np.testing.assert_allclose(f, f_ref, rtol=0, atol=tol * fmag)
    np.testing.assert_allclose(t, t_ref, rtol=0, atol=tol * fmag)
    np.testing.assert_allclose(
        h, h_ref, rtol=0, atol=1e-6 + 1e-3 * np.abs(h_ref).max())
    np.testing.assert_allclose(pe, pe_ref, rtol=0,
                               atol=tol * max(pe_ref.max(), 1e-6))


def _run_torch(shapes, params, state, wall, hist, **kw):
    return twalls.wall_contact(
        to_torch(tstate.State, state), to_torch(tstate.Shapes, shapes),
        to_torch(tstate.SimParams, params), wall, torch.tensor(hist), **kw)


# (lmax, cap grid): the drum's 8x16 grid at Lmax 4, and the deposition's
# Lmax 8 on its 12x24 grid.
@pytest.mark.parametrize("lmax,quad", [(4, (8, 16)), (8, (12, 24))],
                         ids=["lmax4-8x16", "lmax8-12x24"])
@pytest.mark.parametrize("kind", ["plane", "cylinder"])
def test_wall_contact_matches_reference(kind, lmax, quad):
    shapes, params, state, hist = _system(lmax=lmax, quad=quad)
    jw, tw, state = _walls(kind, state)
    ref = jwalls.wall_contact(state, shapes, params, jw, jnp.asarray(hist),
                              exact=True)
    got = _run_torch(shapes, params, state, tw, hist)
    assert int(got[4]) == int(ref[4])
    _compare(got, ref)


def test_wall_contact_with_compaction():
    """wall_cap compaction + narrow phase == full reference evaluation."""
    shapes, params, state, hist = _system(seed=3)
    jw, tw, state = _walls("plane", state)
    ref = jwalls.wall_contact(state, shapes, params, jw, jnp.asarray(hist),
                              exact=True)
    got = _run_torch(shapes, params, state, tw, hist, wall_cap=32)
    assert 0 < int(got[4]) <= 32 < state.cap
    # Forces, torques and pe match; springs of particles compacted out
    # stay zero instead of carrying the reference's rolling residue.
    fmag = max(np.abs(np.asarray(ref[0])).max(), 1e-6)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(np32(g), np.asarray(r), rtol=0,
                                   atol=2e-3 * fmag)
    np.testing.assert_allclose(
        np32(got[3]), np.asarray(ref[3]), rtol=0,
        atol=2e-3 * max(np.asarray(ref[3]).max(), 1e-6))


def test_per_wall_material_override():
    """A wall's mat row acts as the reference's (ops/walls.py: it replaces
    the global materials): the port's mat wall matches the JAX mat wall
    and the port's plain wall under matching global params, and differs
    from the plain wall under the original params
    (tests/test_walls_pallas.py::test_per_wall_material_override)."""
    shapes, params, state, hist = _system(seed=6)
    soft = [2e4, 8e3, 10.0, 5.0, 0.2, 0.0, 0.0, 0.0]
    args = ([0.0, 0.0, 0.5], [0.0, 0.0, 1.0])
    params_soft = JParams.create(
        dt=1e-4, kn=soft[0], kt=soft[1], gamma_n=soft[2], gamma_t=soft[3],
        mu=soft[4], cutoff=1.4, skin=0.2)
    jref = jwalls.wall_contact(state, shapes, params,
                               jwalls.PlaneWall.create(*args, mat=soft),
                               jnp.asarray(hist), exact=True)
    wall_soft = twalls.PlaneWall.create(*args, mat=soft, device="cpu")
    wall_plain = twalls.PlaneWall.create(*args, device="cpu")
    got = _run_torch(shapes, params, state, wall_soft, hist)
    _compare(got, jref)
    _compare(got, _run_torch(shapes, params_soft, state, wall_plain, hist))
    f_g = np32(_run_torch(shapes, params, state, wall_plain, hist)[0])
    fmag = np.abs(np.asarray(jref[0])).max()
    assert not np.allclose(f_g, np32(got[0]), atol=1e-3 * fmag)


def test_wall_mat_row_takes_eight_values():
    with pytest.raises(ValueError, match="8 values"):
        twalls.CylinderWall.create([0, 0, 0], [0, 1, 0], 3.0, mat=[1.0] * 5,
                                   device="cpu")


@pytest.mark.parametrize("kind", ["plane", "cylinder"])
def test_wall_velocities_match_reference(kind):
    """``surface_velocity`` at contact points and ``angular_velocity`` of
    each wall kind against the reference's methods on the same inputs."""
    rng = np.random.default_rng(3)
    c = rng.uniform(-2.0, 6.0, (2, 17, 3)).astype(np.float32)
    _, _, state, _ = _system()
    jw, tw, _ = _walls(kind, state)
    got = np32(tw.surface_velocity(torch.tensor(c)))
    ref = np.asarray(jw.surface_velocity(jnp.asarray(c)))
    assert got.shape == ref.shape == c.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np32(tw.angular_velocity()),
                               np.asarray(jw.angular_velocity()), rtol=1e-6,
                               atol=0)
    assert (np.abs(ref).max() > 0) and (kind == "plane"
                                        or np.abs(np32(tw.angular_velocity())).max() > 0)
