"""Neighbour build, history remap, pair list and prefilter of the torch
port vs the JAX reference, on the same f32 inputs.

Stable sorts in the port reproduce the reference's slot order exactly
(``lax.top_k`` puts the lowest index first among ties; ``jnp.argsort`` is
stable), so index tensors are compared slot by slot.
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
PERIODIC = (True, True, True)


def _system(n=60, box=5.0, seed=3, lmax=4, skin=0.2, motion=1.0):
    rng = np.random.default_rng(seed)
    shapes = jshapes.build_shapes(blob_coeffs(lmax, 2, seed=seed), lmax,
                                  contact_quad=(8, 16))
    params = JParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                            k_roll=1e3, gamma_roll=1.0, mu_roll=0.1,
                            gravity=(0.0, 0.0, -10.0), cutoff=1.3,
                            skin=skin)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = jscen.make_state(
        rng.uniform(0.4, box - 0.4, (n, 3)), [0, 0, 0], [box] * 3, q=q,
        v=rng.normal(size=(n, 3)) * 0.5 * motion,
        angmom=rng.normal(size=(n, 3)) * 0.01,
        scale=rng.uniform(0.85, 1.15, n), shtype=rng.integers(0, 2, n),
        cap=n + 4)  # inactive tail slots
    state = state.replace(
        f=jnp.asarray(rng.normal(size=(n + 4, 3)) * 20 * motion,
                      jnp.float32),
        tau=jnp.asarray(rng.normal(size=(n + 4, 3)) * motion, jnp.float32))
    t = (to_torch(tstate.Shapes, shapes), to_torch(tstate.SimParams, params),
         to_torch(tstate.State, state))
    return (shapes, params, state), t


def _cells(js, ts, dims=(3, 3, 3), cell_cap=12, k_max=16, periodic=NP):
    shapes, params, state = js
    tshapes, tparams, tst = ts
    cutoff = float(params.cutoff + params.skin)
    ref = jnb.cell_list_neighbors(state.x, state.active, state.box_lo,
                                  state.box_hi, cutoff, dims, cell_cap,
                                  k_max, periodic)
    got = tnb.cell_list_neighbors(tst.x, tst.active, tst.box_lo,
                                  tst.box_hi, tparams.cutoff + tparams.skin,
                                  dims, cell_cap, k_max, periodic)
    return ref, got


@pytest.mark.parametrize("periodic", [NP, PERIODIC])
def test_cell_list_matches_reference(periodic):
    js, ts = _system()
    ref, got = _cells(js, ts, periodic=periodic)
    for name, g, r in zip(("idx", "mask", "count", "cell_overflow"), got,
                          ref):
        np.testing.assert_array_equal(np32(g), np.asarray(r), err_msg=name)
    assert np.asarray(ref[1]).sum() > 50  # real neighbours
    # Row-chunked build is the same build.
    chunked = tnb.cell_list_neighbors(
        ts[2].x, ts[2].active, ts[2].box_lo, ts[2].box_hi,
        ts[1].cutoff + ts[1].skin, (3, 3, 3), 12, 16, periodic,
        row_chunk=16)
    for g, c in zip(got, chunked):
        np.testing.assert_array_equal(np32(g), np32(c))


def test_wrap_and_motion_match_reference():
    js, ts = _system()
    state, tst = js[2], ts[2]
    rng = np.random.default_rng(4)
    x = (np.asarray(state.x) + rng.uniform(-3, 3, (state.cap, 3))).astype(
        np.float32)
    jx, jimg = jnb.wrap_positions(jnp.asarray(x), state.image, state.box_lo,
                                  state.box_hi, PERIODIC)
    tx, timg = tnb.wrap_positions(torch.tensor(x), tst.image, tst.box_lo,
                                  tst.box_hi, PERIODIC)
    np.testing.assert_allclose(np32(tx), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np32(timg), np.asarray(jimg))
    q2 = np.asarray(state.q) + rng.normal(size=(state.cap, 4)) * 0.01
    q2 = (q2 / np.linalg.norm(q2, axis=1, keepdims=True)).astype(np.float32)
    gmax = rng.uniform(0.05, 0.2, state.cap).astype(np.float32)
    budget = rng.uniform(0.01, 0.1, state.cap).astype(np.float32)
    for periodic in (NP, PERIODIC):
        args = (state.x, jnp.asarray(x), state.q, jnp.asarray(q2),
                jnp.asarray(gmax), jnp.asarray(budget), state.active,
                state.box_lo, state.box_hi, periodic)
        targs = (tst.x, torch.tensor(x), tst.q, torch.tensor(q2),
                 torch.tensor(gmax), torch.tensor(budget), tst.active,
                 tst.box_lo, tst.box_hi, periodic)
        np.testing.assert_allclose(float(tnb.approach_ratio(*targs)),
                                   float(jnb.approach_ratio(*args)),
                                   rtol=1e-5)
        np.testing.assert_allclose(
            float(tnb.max_displacement2(tst.x, torch.tensor(x), tst.active,
                                        tst.box_lo, tst.box_hi, periodic)),
            float(jnb.max_displacement2(state.x, jnp.asarray(x),
                                        state.active, state.box_lo,
                                        state.box_hi, periodic)),
            rtol=1e-5)


def test_remap_history_matches_reference():
    rng = np.random.default_rng(7)
    N, K = 40, 8
    # Neighbour tags are unique within a row: at most one match per slot.
    old_key = np.stack([rng.permutation(12)[:K] for _ in range(N)])
    new_key = np.stack([rng.permutation(12)[:K] for _ in range(N)])
    old_mask = rng.uniform(size=(N, K)) > 0.3
    new_mask = rng.uniform(size=(N, K)) > 0.3
    old_hist = rng.normal(size=(N, K, 6)).astype(np.float32)
    row_ok = rng.uniform(size=N) > 0.1
    args = (new_key, new_mask, old_key, old_mask, old_hist, row_ok)
    ref = jnb.remap_history(*(jnp.asarray(a) for a in args))
    got = tnb.remap_history(*(torch.tensor(a) for a in args), chunk=16)
    np.testing.assert_array_equal(np32(got), np.asarray(ref))


def test_pair_list_and_prefilter_match_reference():
    """build_pair_list on the same [N, K] tensor, then the rebuild-time
    prefilter (stage-1 probe: the reference's Pallas kernel in interpret
    mode, the port's plain twin)."""
    # Slow particles and a thin skin: tight motion budgets, so the probe
    # culls real candidates.
    js, ts = _system(n=60, box=4.6, skin=0.06, motion=0.05)
    shapes, params, state = js
    tshapes, tparams, tst = ts
    ref_nb, got_nb = _cells(js, ts)
    idx, mask = ref_nb[0], ref_nb[1]
    rng = np.random.default_rng(1)
    hist = rng.normal(size=idx.shape + (6,)).astype(np.float32) * 1e-3

    rf, rn = jcontact.build_pair_list(state, shapes, params, idx, mask,
                                      jnp.asarray(hist), state.active, 400,
                                      NP)
    gf, gn = tcontact.build_pair_list(tst, tshapes, tparams, got_nb[0],
                                      got_nb[1], torch.tensor(hist),
                                      tst.active, 400, NP)
    assert int(gn) == int(rn) and 20 < int(rn) < 400
    for k in rf:
        np.testing.assert_array_equal(np32(gf[k]), np.asarray(rf[k]),
                                      err_msg=k)

    keep = 160
    rf2, rs, rb = jcontact.prefilter_pair_list(
        state, shapes, params, rf, keep, 16, window_steps=20, periodic=NP)
    gf2, gs, gb = tcontact.prefilter_pair_list(
        tst, tshapes, tparams, gf, keep, 16, window_steps=20, periodic=NP)
    assert int(gs) == int(rs) and 0 < int(rs) < int(rn)
    np.testing.assert_allclose(np32(gb), np.asarray(rb), rtol=1e-6)
    for k in rf2:
        np.testing.assert_array_equal(np32(gf2[k]), np.asarray(rf2[k]),
                                      err_msg=k)
    # A chunked probe is the same probe.
    cf2, cs, cb = tcontact.prefilter_pair_list(
        tst, tshapes, tparams, gf, keep, 16, window_steps=20, periodic=NP,
        probe_chunk=50)
    assert int(cs) == int(gs)
    for k in gf2:
        np.testing.assert_array_equal(np32(cf2[k]), np32(gf2[k]), err_msg=k)

    # Springs scatter back to the dense layout identically.
    jn = jempty(state.cap, 16, pair_cap=keep).replace(
        hist=jnp.zeros(idx.shape + (6,), jnp.float32), **rf2)
    tn = to_torch(tstate.NeighborState, jn)
    np.testing.assert_array_equal(np32(tcontact.pair_hist_to_dense(tn)),
                                  np.asarray(jcontact.pair_hist_to_dense(jn)))


def test_sorted_segment_sum_matches_index_add():
    rng = np.random.default_rng(0)
    seg = torch.tensor(np.sort(rng.integers(0, 30, 200)))
    data = torch.tensor(rng.normal(size=(200, 6)).astype(np.float32))
    got = tcontact.sorted_segment_sum(data, seg, 33)
    ref = torch.zeros(33, 6).index_add_(0, seg, data)
    np.testing.assert_allclose(np32(got), np32(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("P", [1, 1000, 1024, 1025, 5000])
def test_prefix_sum_is_a_per_row_float64_scan(P):
    """``prefix_sum`` (the blocked fixed-order scan under the segment
    sums) is a float64 prefix sum of each row within rounding, and a row
    gives the same bits alone, in a batch of rows and in a batch of
    replicas."""
    rng = np.random.default_rng(P)
    cols = torch.tensor(rng.normal(size=(3, 6, P)))
    got = tcontact.prefix_sum(cols)
    np.testing.assert_allclose(got.numpy(), np.cumsum(cols.numpy(), -1),
                               rtol=1e-12, atol=1e-12 * P)
    assert torch.equal(tcontact.prefix_sum(cols[1]), got[1])
    assert torch.equal(tcontact.prefix_sum(cols[1, 4]), got[1, 4])
