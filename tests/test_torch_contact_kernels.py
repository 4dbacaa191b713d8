"""Pair-contact kernels of the torch port vs the JAX reference.

The plain twins (``pair_contact_plain``, ``stage1_depth_plain``) take the
SAME packed f32 inputs as the reference's Pallas kernels, which run here
in interpret mode. The CUDA kernels themselves are compared with their
twins on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherharm_tpu.core.state import SimParams as JParams
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.models import shapes_library as jshapes
from spherharm_tpu.ops import contact_pallas
from spherharm_tpu.ops.contact import minimum_image
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.ops import contact_kernels as ck

from torch_port_util import blob_coeffs, f32_ulps_from, np32, to_torch


def _pairs(lmax, seed=0, n=14, contact_quad=(8, 16)):
    """All ordered pairs of n particles in a small box: a mix of deep,
    grazing and sphere-separated pairs; springs mid-contact."""
    rng = np.random.default_rng(seed)
    shapes = jshapes.build_shapes(blob_coeffs(lmax, 3, seed=seed), lmax,
                                  contact_quad=contact_quad)
    params = JParams.create(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4,
                            k_roll=2e4, gamma_roll=10.0, mu_roll=0.2,
                            cutoff=1.4, skin=0.2)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = jscen.make_state(
        rng.uniform(0.7, 2.5, (n, 3)), [0, 0, 0], [4, 4, 4], q=q,
        v=rng.normal(size=(n, 3)) * 0.2,
        angmom=rng.normal(size=(n, 3)) * 0.02,
        scale=rng.uniform(0.85, 1.15, n), shtype=rng.integers(0, 3, n))
    pi, pj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sel = pi.ravel() != pj.ravel()
    pi = jnp.asarray(pi.ravel()[sel], jnp.int32)
    pj = jnp.asarray(pj.ravel()[sel], jnp.int32)
    mask = jnp.asarray(rng.uniform(size=pi.shape[0]) > 0.05)  # a few dead
    hist = jnp.asarray(rng.normal(size=(pi.shape[0], 6)) * 1e-4, jnp.float32)
    d = minimum_image(state.x[pj] - state.x[pi], state.box_lo, state.box_hi,
                      (False, False, False))
    return shapes, params, state, pi, pj, mask, hist, d


def _check_pair_rows(out, ref, tol_f=1e-4, tol_h=1e-4):
    """Force/torques and pe at tol_f of their scale (the reference's own
    kernel parity bounds, tests/test_pallas.py: 1e-4 conservative, 2e-3
    geometric), springs at tol_h of theirs, identical contact flags."""
    inc = ref[:, 16] > 0.5
    assert inc.sum() > 3, "test system should have several contacts"
    np.testing.assert_array_equal(out[:, 16] > 0.5, inc)
    fmag = max(np.abs(ref[:, 0:3]).max(), 1e-6)
    np.testing.assert_allclose(out[:, 0:9], ref[:, 0:9], rtol=0,
                               atol=tol_f * fmag)
    hmag = np.abs(ref[:, 9:15]).max()
    np.testing.assert_allclose(out[:, 9:15], ref[:, 9:15], rtol=0,
                               atol=1e-6 + tol_h * hmag)
    np.testing.assert_allclose(out[:, 15], ref[:, 15], rtol=0,
                               atol=tol_f * max(ref[:, 15].max(), 1e-6))
    np.testing.assert_array_equal(out[:, 17:], 0.0)


# (lmax, law, cap grid): the conservative law at the reference's 1e-4
# |F|max bound, the geometric law at its 2e-3 (springs 1e-3, as
# tests/test_pallas.py), once on the deposition's 12x24 grid.
LAW_CASES = [
    pytest.param(4, True, (8, 16), id="4"),
    pytest.param(8, True, (8, 16), id="8"),
    pytest.param(4, False, (8, 16), id="4-geometric"),
    pytest.param(8, False, (12, 24), id="8-geometric-12x24"),
]


@pytest.mark.parametrize("lmax,conservative,quad", LAW_CASES)
def test_pair_contact_plain_matches_pallas(lmax, conservative, quad):
    shapes, params, state, pi, pj, mask, hist, d = _pairs(
        lmax, seed=lmax, contact_quad=quad)
    packed, tbl, cap, par = contact_pallas.pack_pairs(
        state, shapes, params, pi, pj, mask, hist, d)
    ref = np.asarray(contact_pallas.pair_contact_pallas(
        packed, tbl, cap, par, lmax=lmax, block=64, interpret=True,
        conservative=conservative, bf16=False))

    # The port's pack_pairs rebuilds the same inputs from its own state.
    ts = to_torch(tstate.State, state)
    t_packed, t_tbl, t_cap, t_par = ck.pack_pairs(
        ts, to_torch(tstate.Shapes, shapes), to_torch(tstate.SimParams,
                                                      params),
        *(torch.tensor(np.asarray(a)) for a in (pi, pj, mask, hist, d)))
    for a, b in ((t_packed, packed), (t_tbl, tbl), (t_cap, cap),
                 (t_par, par)):
        np.testing.assert_allclose(np32(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)

    n0 = dict(ck.pair_contact.launches)
    out = np32(ck.pair_contact(t_packed, t_tbl, t_cap, t_par, lmax=lmax,
                               conservative=conservative))
    assert ck.pair_contact.launches == n0  # CPU tensors: the plain twin
    # Masked rows write zeros (the reference computes them whenever their
    # block of 64 holds a live row, leaving rolling-spring residue there).
    live = np.asarray(mask)
    assert not live.all()
    np.testing.assert_array_equal(out[~live], 0.0)
    if conservative:
        _check_pair_rows(out[live], ref[live])
    else:
        _check_pair_rows(out[live], ref[live], tol_f=2e-3, tol_h=1e-3)


@pytest.mark.parametrize("lmax", [4, 8])
def test_stage1_depth_plain_matches_pallas(lmax):
    """Full-basis f32 probe (l1 = lmax, tail zeroed, as the prefilter runs
    it). Tolerance 1e-5 absolute on depths of order 0.1-1 (f32 rounding of
    the radius chain; the prefilter's own slack is 0.08 rchar)."""
    shapes, params, state, pi, pj, mask, hist, d = _pairs(lmax, seed=3)
    packed, tbl, _, _ = contact_pallas.pack_pairs(
        state, shapes, params, pi, pj, mask, hist, d, probe_only=True)
    packed = packed.at[:, contact_pallas._SLOTS["tail"][0]].set(0.0)
    nc_ab = (lmax + 1) ** 2
    cap1 = jnp.stack([shapes.cap1_x, shapes.cap1_glw, shapes.cap1_cpsi,
                      shapes.cap1_spsi])
    ref = np.asarray(contact_pallas.stage1_depth_pallas(
        packed, tbl[:, :nc_ab], cap1, lmax=lmax, l1=lmax, bf16=False,
        interpret=True))
    t = lambda a: torch.tensor(np.asarray(a))
    out = np32(ck.stage1_depth(t(packed), t(tbl[:, :nc_ab]), t(cap1),
                               lmax=lmax, l1=lmax, bf16=False))
    dead = ref == -1e9
    assert dead.any() and (ref > 0).sum() > 3 and (ref[~dead] < 0).any()
    np.testing.assert_array_equal(out[dead], -1e9)
    np.testing.assert_allclose(out[~dead], ref[~dead], rtol=0, atol=1e-5)


def test_stage1_depth_plain_matches_pallas_row_classes():
    """The full-basis probe over a list that mixes every row class the
    kernel sorts out: the pairs of ``_pairs`` (dead, sphere-separated and
    probed rows), rows whose centres sit 0, 1, 2 and 3 f32 ulps either
    side of touching bounding spheres (d along x, so that dist = |d_x|
    exactly and both sides sort them alike: below rsum probed, at or
    above it rsum - dist), and a full block of masked rows, which the
    reference skips without probing (``contact_pallas.py:776-781``, block
    64 here). Dead rows exactly -1e9, the rest within 1e-5."""
    lmax, block = 8, 64
    shapes, params, state, pi, pj, mask, hist, d = _pairs(lmax, seed=5)
    packed, tbl, _, _ = contact_pallas.pack_pairs(
        state, shapes, params, pi, pj, mask, hist, d, probe_only=True)
    base = np.asarray(packed, np.float32).copy()
    base[:, contact_pallas._SLOTS["tail"][0]] = 0.0
    col = lambda name: contact_pallas._SLOTS[name][0]
    live = np.flatnonzero(base[:, col("mask")] > 0.5)
    ks = list(range(-3, 4))
    touching = base[live[:2 * len(ks)]].copy()
    for r, k in zip(touching, ks + ks):
        rsum = np.float32(r[col("rbi")]) + np.float32(r[col("rbj")])
        r[col("d"):col("d") + 3] = (f32_ulps_from(rsum, k), 0.0, 0.0)
    masked = base[live[:block]].copy()
    masked[:, col("mask")] = 0.0
    head = np.concatenate([base, touching])
    fill = -(-head.shape[0] // block) * block - head.shape[0]
    rows = np.concatenate([head, base[live[:fill]], masked, base[live[-5:]]])
    start = head.shape[0] + fill  # the masked rows fill block start // block
    assert start % block == 0 and (rows[start:start + block, col("mask")] == 0).all()

    nc_ab = (lmax + 1) ** 2
    cap1 = jnp.stack([shapes.cap1_x, shapes.cap1_glw, shapes.cap1_cpsi,
                      shapes.cap1_spsi])
    ref = np.asarray(contact_pallas.stage1_depth_pallas(
        jnp.asarray(rows), tbl[:, :nc_ab], cap1, lmax=lmax, l1=lmax, bf16=False,
        block=block, interpret=True))
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    out = np32(ck.stage1_depth(t(rows), t(tbl[:, :nc_ab]), t(cap1), lmax=lmax, l1=lmax,
                               bf16=False))
    dead = ref == -1e9
    assert dead[start:start + block].all()
    np.testing.assert_array_equal(out[dead], -1e9)
    np.testing.assert_allclose(out[~dead], ref[~dead], rtol=0, atol=1e-5)

    # The touching rows: at or beyond rsum exactly rsum - dist, below it
    # probed (a depth of the surfaces, not the spheres' few ulps).
    at = slice(base.shape[0], base.shape[0] + touching.shape[0])
    rsum = rows[at, col("rbi")] + rows[at, col("rbj")]
    apart = rsum - rows[at, col("d")]
    k = np.array(ks + ks)
    np.testing.assert_array_equal(out[at][k >= 0], apart[k >= 0])
    assert (np.abs(out[at][k < 0] - apart[k < 0]) > 1e-4).all()
    # Every class is there: dead, sphere-separated and probed rows.
    dd = rows[:, col("d"):col("d") + 3].astype(np.float64)
    apart_all = rows[:, col("rbi")] + rows[:, col("rbj")] - np.sqrt((dd * dd).sum(1))
    assert ((~dead) & (apart_all < -1e-3)).sum() > 3
    assert ((~dead) & (apart_all > 1e-3)).sum() > 3
