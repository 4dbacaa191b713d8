"""The geometric contact law's pieces and the dense force path of the torch
port vs the JAX reference: the inclination-weighted surface probe, the
dense [N, K] force path in both laws, and the all-pairs neighbour build.

The JAX side evaluates exactly (``exact=True``, its jnp path). Tolerances
are the reference's own between its twins (tests/test_pallas.py): 2e-3
|F|max for the geometric law, 1e-4 |F|max for the conservative one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherharm_tpu.core.state import SimParams as JParams
from spherharm_tpu.core.state import empty_neighbors as jempty
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.models import shapes_library as jshapes
from spherharm_tpu.ops import contact as jcontact
from spherharm_tpu.ops import neighbor as jnb
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.ops import contact as tcontact
from spherharm_tpu_torch.ops import neighbor as tnb

from torch_port_util import blob_coeffs, np32, to_torch

NP = (False, False, False)


def _system(n=16, box=3.2, seed=5, lmax=4, quad=(8, 16)):
    """n blobs packed in a small box (many touching pairs), with spins,
    velocities and a periodic-free box."""
    rng = np.random.default_rng(seed)
    shapes = jshapes.build_shapes(blob_coeffs(lmax, 2, seed=seed), lmax,
                                  contact_quad=quad)
    params = JParams.create(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4,
                            k_roll=2e4, gamma_roll=10.0, mu_roll=0.2,
                            cutoff=1.3, skin=0.2)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = jscen.make_state(
        rng.uniform(0.5, box - 0.5, (n, 3)), [0, 0, 0], [box] * 3, q=q,
        v=rng.normal(size=(n, 3)) * 0.3,
        angmom=rng.normal(size=(n, 3)) * 0.02,
        scale=rng.uniform(0.85, 1.15, n), shtype=rng.integers(0, 2, n),
        cap=n + 2)  # inactive tail slots
    return shapes, params, state


def test_surface_probe_incl_matches_reference():
    """One-sided probe with the inclination measure: s1, s2, centroid and
    normal sums at 1e-4 of their scale (f32 power basis vs exact ALP)."""
    shapes, _, state = _system(quad=(12, 24))
    n = 16
    pi, pj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sel = pi.ravel() != pj.ravel()
    pi, pj = pi.ravel()[sel], pj.ravel()[sel]
    x, q = np.asarray(state.x), np.asarray(state.q)
    s, t = np.asarray(state.scale), np.asarray(state.shtype)
    rmax, rmin = np.asarray(shapes.rmax), np.asarray(shapes.rmin)
    rchar = np.asarray(shapes.rchar)
    d = (x[pj] - x[pi]).astype(np.float32)
    ref = jcontact.surface_probe(
        q[pi], s[pi], t[pi], q[pj], s[pj], t[pj],
        (rmax[t] * s)[pj], (rmin[t] * s)[pi], (rmax[t] * s)[pi],
        (rchar[t] * s)[pj], jnp.asarray(d), shapes, exact=True, incl=True)
    tsh = to_torch(tstate.Shapes, shapes)
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    cap = torch.stack([tsh.cap_x, tsh.cap_glw, tsh.cap_cpsi, tsh.cap_spsi])
    got = tcontact.surface_probe(
        f(q[pi]), f(s[pi]), tsh.power_tbl[t[pi]], f(q[pj]), f(s[pj]),
        tsh.power_tbl[t[pj]], f((rmax[t] * s)[pj]), f((rmin[t] * s)[pi]),
        f((rmax[t] * s)[pi]), f(d), cap, shapes.lmax, incl=True)
    assert (np.asarray(ref[0]) > 0).sum() > 10  # many overlapping pairs
    for name, g, r in zip(("s1", "s2", "centroid", "normal"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(np32(g), r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)
    # The measure matters: the inclination-free probe differs.
    free = tcontact.surface_probe(
        f(q[pi]), f(s[pi]), tsh.power_tbl[t[pi]], f(q[pj]), f(s[pj]),
        tsh.power_tbl[t[pj]], f((rmax[t] * s)[pj]), f((rmin[t] * s)[pi]),
        f((rmax[t] * s)[pi]), f(d), cap, shapes.lmax)
    assert np.abs(np32(free[0]) - np.asarray(ref[0])).max() > 1e-3 * np.abs(
        np.asarray(ref[0])).max()


@pytest.mark.parametrize("conservative,tol", [(False, 2e-3), (True, 1e-4)])
def test_contact_force_dense_matches_reference(conservative, tol):
    """Dense [N, K] path (all-pairs list, mid-contact springs): per-
    particle force and torque, pe, virial and live springs."""
    shapes, params, state = _system()
    cutoff = float(params.cutoff + params.skin)
    idx, mask, _ = jnb.allpairs_neighbors(state.x, state.active,
                                          state.box_lo, state.box_hi,
                                          cutoff, 8, NP)
    rng = np.random.default_rng(2)
    hist = (rng.normal(size=idx.shape + (6,)) * 1e-4).astype(np.float32)
    jn = jempty(state.cap, idx.shape[1]).replace(
        idx=idx, mask=mask, hist=jnp.asarray(hist))
    ref = jcontact.contact_force_dense(state, shapes, params, jn, exact=True,
                                       conservative=conservative)
    got = tcontact.contact_force_dense(
        to_torch(tstate.State, state), to_torch(tstate.Shapes, shapes),
        to_torch(tstate.SimParams, params),
        to_torch(tstate.NeighborState, jn), conservative=conservative)
    f_ref = np.asarray(ref[0])
    fmag = np.abs(f_ref).max()
    assert fmag > 10.0, "system should have real contacts"
    np.testing.assert_allclose(np32(got[0]), f_ref, rtol=0, atol=tol * fmag)
    np.testing.assert_allclose(np32(got[1]), np.asarray(ref[1]), rtol=0,
                               atol=tol * fmag)
    np.testing.assert_allclose(float(got[3]), float(ref[3]), rtol=tol)
    np.testing.assert_allclose(np32(got[4]), np.asarray(ref[4]), rtol=0,
                               atol=tol * np.abs(np.asarray(ref[4])).max())
    # Springs of live slots (the reference also updates masked slots).
    live = np.asarray(mask)
    h_ref = np.asarray(ref[2])[live]
    np.testing.assert_allclose(np32(got[2])[live], h_ref, rtol=0,
                               atol=1e-6 + 1e-3 * np.abs(h_ref).max())


@pytest.mark.parametrize("k_max", [6, 40])
def test_allpairs_neighbors_matches_reference(k_max):
    """Same neighbour sets and counts; k_max > N clips to N slots."""
    _, params, state = _system(n=24, box=4.0, seed=9)
    cutoff = float(params.cutoff + params.skin)
    ref = jnb.allpairs_neighbors(state.x, state.active, state.box_lo,
                                 state.box_hi, cutoff, k_max, NP)
    ts = to_torch(tstate.State, state)
    got = tnb.allpairs_neighbors(ts.x, ts.active, ts.box_lo, ts.box_hi,
                                 cutoff, k_max, NP)
    assert got[0].shape == tuple(ref[0].shape)
    np.testing.assert_array_equal(np32(got[2]), np.asarray(ref[2]))
    r_idx, r_mask = np.asarray(ref[0]), np.asarray(ref[1])
    g_idx, g_mask = np32(got[0]), np32(got[1])
    for i in range(state.cap):
        assert set(g_idx[i][g_mask[i]]) == set(r_idx[i][r_mask[i]]), i
    assert r_mask.sum() > 20
