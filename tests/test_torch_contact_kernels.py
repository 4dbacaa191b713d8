"""Pair-contact kernels of the torch port vs the JAX reference.

The plain twins (``pair_contact_plain``, ``stage1_depth_plain``) take the
SAME packed f32 inputs as the reference's Pallas kernels, which run here
in interpret mode. The CUDA kernels themselves are compared with their
twins on the card by tests/test_torch_cuda.py. The pair list read by
index (``pair_contact_indexed``, the step's entry) is held here, on the
CPU, to the packed rows it replaces.
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


# -- the pair list read by index (pair_contact_indexed) ---------------------

def _index_system(seed, periodic=(False, False, False), tilt=None, R=0,
                  lmax=4, n=14):
    """The port's twin of ``_pairs``'s system, every ordered pair a slot
    of its list, a few slots not valid, particle 3 inactive, springs
    mid-contact. Periodic: the particles scattered about the box's corner
    and wrapped into it, so that many pairs meet through an image. With
    ``R`` replicas, each its own positions, dt and kn (so pair_tab [R, T,
    T, 8]). Returns (state, shapes, params, lists, periodic, tilt)."""
    from types import SimpleNamespace

    from spherharm_tpu_torch.models import scenarios, shapes_library
    from spherharm_tpu_torch.parallel import ensemble

    rng = np.random.default_rng(seed)
    shapes = shapes_library.build_shapes(blob_coeffs(lmax, 3, seed), lmax,
                                         contact_quad=(6, 12), device="cpu")
    params = tstate.SimParams.create(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4,
                                     k_roll=2e4, gamma_roll=10.0,
                                     mu_roll=0.2, cutoff=1.4, skin=0.2,
                                     device="cpu")

    def one():
        if any(periodic):
            x = rng.uniform(-1.1, 1.1, (n, 3)) % 4.0
        else:
            x = rng.uniform(0.7, 2.5, (n, 3))
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        st = scenarios.make_state(
            x, [0, 0, 0], [4, 4, 4], q=q, v=rng.normal(size=(n, 3)) * 0.2,
            angmom=rng.normal(size=(n, 3)) * 0.02,
            scale=rng.uniform(0.85, 1.15, n), shtype=rng.integers(0, 3, n),
            tilt=tilt, device="cpu")
        active = st.active.clone()
        active[3] = False
        return st.replace(active=active)

    pi, pj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sel = pi.ravel() != pj.ravel()
    pi, pj = torch.tensor(pi.ravel()[sel]), torch.tensor(pj.ravel()[sel])
    P = pi.shape[0]
    lead = (R,) if R else ()
    lists = SimpleNamespace(
        pair_i=pi.expand(lead + (P,)).contiguous(),
        pair_j=pj.expand(lead + (P,)).contiguous(),
        pair_valid=torch.tensor(rng.uniform(size=lead + (P,)) > 0.05),
        pair_hist=torch.tensor(rng.normal(size=lead + (P, 6)) * 1e-4,
                               dtype=torch.float32))
    if not R:
        st = one()
    else:
        st = ensemble.stack_replicas([one() for _ in range(R)])
        params = ensemble.with_param_sweep(
            params, dt=np.linspace(1e-4, 3e-4, R), kn=np.linspace(5e4, 2e5, R))
    return st, shapes, params, lists, periodic, (
        None if tilt is None else st.tilt)


def _slab_system():
    """A ghost-extended slab list: the sheared two-slab system of
    tests/test_torch_halo.py after its first rebuild (lists [2, P], the
    owned and ghost rows of each slab, periodic along y and z only, one
    par row for both slabs), springs set mid-contact."""
    from spherharm_tpu_torch.models import scenarios, shapes_library
    from spherharm_tpu_torch.parallel.halo import ShardedSimulation

    from torch_port_util import slab_drift_system

    x, v, box, periodic = slab_drift_system(2)
    pair = np.array([[3.95, 0.1, 1.0], [3.95 + 0.85 + 0.9, 3.9, 1.0]])
    x = np.concatenate([x, pair])
    v = np.concatenate([v, [[2.0, 0.0, 0.0]] * 2])
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, 4)], 4,
        contact_quad=(6, 12), device="cpu")
    params = tstate.SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                                     cutoff=1.2, skin=0.3,
                                     shear_rate=(0.25, 0.0, 0.0),
                                     device="cpu")
    sim = ShardedSimulation(
        shapes, params, n_shards=2, device="cpu", box_lo=(0, 0, 0),
        box_hi=tuple(box), periodic=periodic, cap_local=64, halo_cap=32,
        migrate_cap=16, k_max=16, cell_cap=8, pair_capacity=256,
        rebuild_every=10, conservative=False, triclinic=True,
        tilt_pad=0.12 * box[0])
    st0 = scenarios.make_state(x, [0, 0, 0], box, v=v, tilt=(0.85, 0.0, 0.0),
                               device="cpu")
    st, ng, gh = sim.init(st0)
    hist = torch.tensor(np.random.default_rng(4).normal(
        size=ng.pair_hist.shape) * 1e-4, dtype=torch.float32)
    return (sim._extend(st, gh), shapes, params, ng.replace(pair_hist=hist),
            sim.periodic_eff, sim._tilt(st))


INDEX_CASES = {
    "single": (lambda: _index_system(5), True),
    "replicas3": (lambda: _index_system(6, R=3), True),
    "triclinic": (lambda: _index_system(7, periodic=(True, True, True),
                                        tilt=(0.7, -0.4, 0.5)), False),
    "slab": (_slab_system, False),
}


@pytest.mark.parametrize("case", list(INDEX_CASES))
def test_pair_contact_indexed_matches_packed(case):
    """``pair_contact_indexed`` on the CPU: columns 0-16 exactly what
    ``pack_pairs`` + ``pair_contact`` give on the rows, mask and minimum
    image ``contact_force_pairs`` used to pack; d (``minimum_image``'s) in
    columns 17-19 and the mask in column 20; dead slots zero rows. A
    single list, three replicas each with its own pair_tab and dt, a
    periodic triclinic box, and a ghost-extended slab list."""
    from spherharm_tpu_torch.core.state import take
    from spherharm_tpu_torch.ops import contact

    build, cons = INDEX_CASES[case]
    st, shapes, params, lists, periodic, tilt = build()
    pi, pj = lists.pair_i, lists.pair_j
    rep = pi.dim() == 2
    at = lambda t, i: take(t, i, rep)
    rows = contact.particle_rows(st, shapes)
    ri, rj = at(rows, pi), at(rows, pj)
    msk = (lists.pair_valid & (ri[..., contact._RACT] > 0.5)
           & (rj[..., contact._RACT] > 0.5))
    d = contact.minimum_image(rj[..., contact._RX] - ri[..., contact._RX],
                              st.box_lo, st.box_hi, periodic, tilt)
    packed, tbl, cap, par = ck.pack_pairs(st, shapes, params, pi, pj, msk,
                                          lists.pair_hist, d, rows=rows)
    ref = ck.pair_contact(packed, tbl, cap, par, shapes.lmax, cons)

    n0 = dict(ck.pair_contact.launches)
    box = ck.box_rows(st.box_lo, st.box_hi, tilt, pi.shape[0] if rep else 1)
    assert box.shape[-1] == (3 if tilt is None else 6)
    out = ck.pair_contact_indexed(
        rows, st.shtype, pi, pj, lists.pair_valid, lists.pair_hist,
        params.pair_tab, tbl, cap, par, box, periodic, shapes.lmax, cons)
    assert ck.pair_contact.launches == n0  # CPU tensors: the plain twin
    m = msk.reshape(-1)
    assert 0 < int(m.sum()) < m.numel()
    assert int((ref[:, 16] > 0.5).sum()) > 0
    assert torch.equal(out[:, :17], ref[:, :17])
    assert torch.equal(out[:, 17:20],
                       torch.where(m[:, None], d.reshape(-1, 3), 0.0))
    assert torch.equal(out[:, 20], m.to(out.dtype))
    assert not out[~m].any() and not out[:, 21:].any()
    if any(periodic):  # pairs met through an image
        raw = (rj[..., contact._RX] - ri[..., contact._RX]).reshape(-1, 3)
        assert ((raw - d.reshape(-1, 3)).abs().amax(-1)[m] > 1.0).sum() > 3


def _packed_forces(state, shapes, params, neigh, periodic, tilt, cons,
                   dense):
    """``contact_force_pairs`` / ``contact_force_dense`` as they ran on
    packed rows (``pack_pairs``, then ``pair_contact``), the reference of
    the indexed path."""
    from spherharm_tpu_torch.core.state import take
    from spherharm_tpu_torch.ops import contact

    if dense:
        N, K = neigh.idx.shape[-2:]
        pi = torch.arange(N).repeat_interleave(K)
        pj, valid = neigh.idx.reshape(-1), neigh.mask.reshape(-1)
        hist = neigh.hist.reshape(N * K, -1)
    else:
        N = state.cap
        pi, pj, valid, hist = (neigh.pair_i, neigh.pair_j, neigh.pair_valid,
                               neigh.pair_hist)
    at = lambda t, i: take(t, i, False)
    rows = contact.particle_rows(state, shapes)
    ri, rj = at(rows, pi), at(rows, pj)
    msk = valid & (ri[..., contact._RACT] > 0.5) & (rj[..., contact._RACT] > 0.5)
    dp = contact.minimum_image(rj[..., contact._RX] - ri[..., contact._RX],
                               state.box_lo, state.box_hi, periodic, tilt)
    packed, tbl, cap, par = ck.pack_pairs(state, shapes, params, pi, pj, msk,
                                          hist, dp, rows=rows)
    out = ck.pair_contact(packed, tbl, cap, par, shapes.lmax, cons)
    force, pe = out[:, 0:3], out[:, 15]
    if dense:
        return (force.reshape(N, K, 3).sum(-2),
                out[:, 3:6].reshape(N, K, 3).sum(-2),
                out[:, 9:15].reshape(N, K, -1), 0.5 * pe.sum(-1),
                -0.5 * torch.einsum("pa,pb->ab", dp, force))
    acc_i = contact.sorted_segment_sum(out[:, 0:6], pi, N)
    w_j = (msk & neigh.pair_both).to(force.dtype)[:, None]
    perm = neigh.pair_jsort
    acc_j = contact.sorted_segment_sum(
        torch.cat([-force * w_j, out[:, 6:9] * w_j], dim=-1)[perm], pj[perm], N)
    w_pe = torch.where(msk & neigh.pair_both, 1.0, 0.5).to(pe.dtype)
    return (acc_i[:, 0:3] + acc_j[:, 0:3], acc_i[:, 3:6] + acc_j[:, 3:6],
            out[:, 9:15], (pe * w_pe).sum(-1),
            -torch.einsum("p,pa,pb->ab", w_pe, dp, force))


def _force_system(case):
    """(sim, state, neigh) a few steps into its run, springs loaded."""
    from spherharm_tpu_torch.models import scenarios

    from torch_port_util import drum_state, pressed_box_state, triaxial_state

    if case == "pairs-drum":
        sim, st0, _ = scenarios.rotating_drum(
            n=64, lmax=2, k_max=16, pair_capacity=320, stage2_capacity=192,
            rebuild_every=10, device="cpu")
        st = drum_state(sim, st0, "cpu")
    elif case == "pairs-triclinic":
        sim, st0, _ = scenarios.triaxial_cell(
            n=128, fill_fraction=0.09, shear_rate=(0.05, 0.0, 0.0),
            deform_min=0.8, device="cpu")
        st = triaxial_state(st0, "cpu", xy_frac=0.3)[0]
    else:
        sim, st0, _ = scenarios.settling_box(n=27, device="cpu")
        x, angmom = pressed_box_state(np32(st0.x), float(sim.shapes.rmax[0]))
        st = scenarios.make_state(x, np32(st0.box_lo), np32(st0.box_hi),
                                  q=np32(st0.q), angmom=angmom, device="cpu")
    st, ng = sim.init_neighbors(st)
    return (sim,) + sim.run(st, ng, 5)


@pytest.mark.parametrize("case", ["pairs-drum", "pairs-triclinic", "dense"])
def test_contact_forces_through_the_indexed_entry(case):
    """``contact_force_pairs`` (the drum's prefiltered list; the sheared
    triclinic cell's periodic list) and ``contact_force_dense`` (the
    settling box's [N, K] rows) give the same f, tau, springs, pe and
    virial through ``pair_contact_indexed`` as through the packed rows."""
    from spherharm_tpu_torch.ops import contact

    sim, st, ng = _force_system(case)
    dense = case == "dense"
    assert (sim.pair_capacity == 0) == dense
    fn = contact.contact_force_dense if dense else contact.contact_force_pairs
    kw = dict(periodic=sim.periodic, tilt=sim._tilt(st))
    got = fn(st, sim.shapes, sim.params, ng, conservative=sim.conservative,
             **kw)
    want = _packed_forces(st, sim.shapes, sim.params, ng, cons=sim.conservative,
                          dense=dense, **kw)
    assert float(want[3]) > 0  # contacts
    assert float(want[2].abs().max()) > 0  # springs
    for name, a, b in zip(("f", "tau", "springs", "pe", "virial"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", ["drum-build", "drum-prefilter",
                                  "triclinic-build"])
def test_pair_lists_keep_their_live_slots_as_a_prefix(case):
    """``build_pair_list`` (the drum's half list, the sheared triclinic
    cell's periodic one) and ``prefilter_pair_list`` (the drum's stage-2
    list) leave each list's live slots as its prefix and its dead tail at
    pair_i = pair_j = N - 1, last in ``pair_jsort``: what the card's
    ``pair_reduce`` clips its reads at. The simulation's own list after
    its run, and the lists built anew from its state, alike."""
    from spherharm_tpu_torch.ops import contact

    from torch_port_util import hold_live_prefix

    sim, st, ng = _force_system("pairs-" + case.split("-")[0])
    N, tilt = st.cap, sim._tilt(st)
    fields, _ = contact.build_pair_list(
        st, sim.shapes, sim.params, ng.idx, ng.mask, ng.hist, st.active,
        sim.pair_capacity, sim.periodic, tilt=tilt)
    if case.endswith("prefilter"):
        assert sim.prefilter
        fields = contact.prefilter_pair_list(
            st, sim.shapes, sim.params, fields, sim.stage2_capacity, sim.k_max,
            window_steps=sim.rebuild_every, periodic=sim.periodic,
            tilt=tilt)[0]
    for lists in (fields, vars(ng)):
        (L,) = hold_live_prefix(lists, N)
        assert 0 < L < lists["pair_i"].shape[-1]
