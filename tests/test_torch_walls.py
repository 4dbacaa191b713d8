"""Wall contact of the torch port vs the JAX reference
(ops/walls.py's jnp path with exact SH evaluation): plane and rotating
cylinder, friction + rolling, mid-contact springs, wall_cap compaction.
Tolerance 2e-3 |F|max, the reference's own kernel-vs-jnp bound
(tests/test_walls_pallas.py)."""

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


def _system(seed=0, n=48, lmax=4):
    rng = np.random.default_rng(seed)
    shapes = jshapes.build_shapes(blob_coeffs(lmax, 2, seed=seed), lmax,
                                  contact_quad=(8, 16))
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


@pytest.mark.parametrize("kind", ["plane", "cylinder"])
def test_wall_contact_matches_reference(kind):
    shapes, params, state, hist = _system()
    jw, tw, state = _walls(kind, state)
    ref = jwalls.wall_contact(state, shapes, params, jw, jnp.asarray(hist),
                              exact=True)
    got = twalls.wall_contact(
        to_torch(tstate.State, state), to_torch(tstate.Shapes, shapes),
        to_torch(tstate.SimParams, params), tw, torch.tensor(hist))
    assert int(got[4]) == int(ref[4])
    _compare(got, ref)


def test_wall_contact_with_compaction():
    """wall_cap compaction + narrow phase == full reference evaluation."""
    shapes, params, state, hist = _system(seed=3)
    jw, tw, state = _walls("plane", state)
    ref = jwalls.wall_contact(state, shapes, params, jw, jnp.asarray(hist),
                              exact=True)
    got = twalls.wall_contact(
        to_torch(tstate.State, state), to_torch(tstate.Shapes, shapes),
        to_torch(tstate.SimParams, params), tw, torch.tensor(hist),
        wall_cap=32)
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
