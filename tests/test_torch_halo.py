"""The slab decomposition of the torch port (``parallel/halo.py``) vs the
JAX reference's ``ShardedSimulation``, slot for slot, on the CPU.

The reference runs on the virtual CPU mesh of tests/conftest.py, the port
with its S slabs on the shard axis; inputs are made once with numpy.
Five systems, each compiled once on the JAX side (one module-scoped
fixture):

* ``s2``: the tiny system of ``__graft_entry__.dryrun_multichip`` (16 S
  Lmax-4 ellipsoids, 4S x 4 x 4 periodic box, the reference's capacities)
  at S = 2 in the conservative law;
* ``s4``: the same at S = 4 in the geometric law;
* ``wall``: S = 2, x and z not periodic, a plane floor under gravity,
  geometric law: wall springs ride the migration;
* ``shear``: S = 2 triclinic, started at an xy tilt of 0.85 and
  sheared, the tilt pad 0.12 Lx, geometric law, with one more pair in
  contact only through a y image: its left particle just inside slab 0,
  its right one 1.7 past that slab's face (beyond cutoff + skin, within
  it plus the pad), so the contact needs the halo's tilt pad;
* ``pre4``: S = 4 conservative with the prefilter (stage-2 capacity
  128; the reference's with ``use_pallas=True``, its Pallas kernels in
  interpret mode, as tests/test_torch_drum.py runs them): the slack
  maxima taken over the slabs (``reduce_max``), which set every owned
  row's motion budget (held slot for slot).

Each system drifts +x, and one particle per slab boundary starts just
left of it, so the second cadence block's rebuild migrates particles
(asserted). Checked: ``distribute`` puts the same tag in every slot;
after ``init`` the forces agree per slot (2e-3 |F|max geometric, 1e-4
|F|max conservative); after 2 cadence blocks the slots still hold the
same tags, positions within rtol 1e-5, atol 1e-6 L (as
tests/test_torch_triclinic.py), velocities within 1e-4 of their scale,
thermo within rel 1e-3 and the overflow channels at 0. The JAX side
takes ``exact_eval=True`` (its CPU default is the interpolated radius).

Also: ``cell_list_neighbors`` and ``prefilter_pair_list`` with the new
arguments left at None give what they gave before; ``dryrun_sharded``
on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from spherharm_tpu.core.state import SimParams as JSimParams
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.models import shapes_library as jshapes
from spherharm_tpu.ops.walls import PlaneWall as JPlaneWall
from spherharm_tpu.parallel.halo import ShardedSimulation as JSharded
from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.core.state import SimParams
from spherharm_tpu_torch.models import scenarios as tscen
from spherharm_tpu_torch.models import shapes_library
from spherharm_tpu_torch.ops import contact, neighbor
from spherharm_tpu_torch.ops.neighbor import CellGrid
from spherharm_tpu_torch.ops.walls import PlaneWall
from spherharm_tpu_torch.parallel.dryrun import dryrun_sharded
from spherharm_tpu_torch.parallel.halo import ShardedSimulation

from torch_port_util import np32, slab_drift_system

R_EVERY = 10
STEPS = 2 * R_EVERY
LMAX = 4
CPU = torch.device("cpu")


def _build(S, wall=False, cons=False, shear=False, prefilter=False):
    """Both packages' sharded simulations and initial states."""
    x, v, box, periodic = slab_drift_system(S, wall)
    tilt = (0.85, 0.0, 0.0) if shear else None
    if shear:
        # Through the -y image (x shifted by -0.85) the pair is 0.9 apart
        # along x, its semi-axes 0.55 each: in contact.
        pair = np.array([[3.95, 0.1, 1.0], [3.95 + 0.85 + 0.9, 3.9, 1.0]])
        x = np.concatenate([x, pair])
        v = np.concatenate([v, [[2.0, 0.0, 0.0]] * 2])
    q = np.tile([1.0, 0.0, 0.0, 0.0], (x.shape[0], 1))
    grav = (0.0, 0.0, -10.0) if wall else (0.0, 0.0, 0.0)
    pk = dict(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3, cutoff=1.2, skin=0.3,
              gravity=grav,
              shear_rate=(0.25, 0.0, 0.0) if shear else (0.0,) * 3)
    kw = dict(box_lo=(0, 0, 0), box_hi=tuple(box), periodic=periodic,
              cap_local=64, halo_cap=32, migrate_cap=16, k_max=16,
              cell_cap=8, pair_capacity=256, rebuild_every=R_EVERY,
              conservative=cons, stage2_capacity=128 if prefilter else 0)
    if shear:
        kw.update(triclinic=True, tilt_pad=0.12 * box[0])
    jshp = jshapes.build_shapes(
        [jshapes.ellipsoid_coeffs(0.55, 0.45, 0.4, LMAX)], LMAX,
        contact_quad=(6, 12), dtype=jnp.float32)
    tshp = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, LMAX)], LMAX,
        contact_quad=(6, 12), device="cpu")
    jwalls = ((JPlaneWall.create((0, 0, 0), (0, 0, 1)),) if wall else ())
    twalls = ((PlaneWall.create((0, 0, 0), (0, 0, 1), device="cpu"),)
              if wall else ())
    jsim = JSharded(jshp, JSimParams.create(**pk, dtype=jnp.float32),
                    mesh=Mesh(np.array(jax.devices()[:S]), ("x",)),
                    walls=jwalls, exact_eval=True, use_pallas=prefilter,
                    **kw)
    tsim = ShardedSimulation(tshp, SimParams.create(**pk, device="cpu"),
                             n_shards=S, walls=twalls, device="cpu", **kw)
    assert tsim.prefilter == jsim.prefilter == prefilter
    js0 = jscen.make_state(x, [0, 0, 0], box, v=v, q=q, tilt=tilt,
                           dtype=jnp.float32)
    ts0 = tscen.make_state(x, [0, 0, 0], box, v=v, q=q, tilt=tilt,
                           device="cpu")
    return jsim, js0, tsim, ts0, box


def _slots(a, S):
    """A reference leaf [S * rows, ...] as the port's [S, rows, ...]."""
    a = np.asarray(a)
    return a.reshape((S, a.shape[0] // S) + a.shape[1:])


CASES = {"s2": dict(S=2, cons=True), "s4": dict(S=4),
         "wall": dict(S=2, wall=True), "shear": dict(S=2, shear=True),
         "pre4": dict(S=4, cons=True, prefilter=True)}


@pytest.fixture(scope="module")
def runs():
    """Every system through both packages: distribute, init, 2 cadence
    blocks, thermo."""
    out = {}
    for name, case in CASES.items():
        jsim, js0, tsim, ts0, box = _build(**case)
        jd, td = jsim.distribute(js0)[0], tsim.distribute(ts0)[0]
        js, jn, jg = jsim.init(js0)
        ts, tn, tg = tsim.init(ts0)
        ji, ti = (js, jn), (ts, tn)
        js, jn, jg = jsim.run(js, jn, jg, STEPS)
        ts, tn, tg = tsim.run(ts, tn, tg, STEPS)
        out[name] = dict(
            S=case["S"], n=int(ts0.active.sum()), box=box,
            cons=case.get("cons", False), pre=tsim.prefilter, jd=jd,
            td=td, ji=ji, ti=ti, jend=(js, jn), tend=(ts, tn),
            jth=jsim.thermo(js, jn, jg), tth=tsim.thermo(ts, tn, tg))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_distribute_fills_the_same_slots(runs, name):
    r = runs[name]
    S = r["S"]
    np.testing.assert_array_equal(np32(r["td"].active),
                                  _slots(r["jd"].active, S))
    np.testing.assert_array_equal(np32(r["td"].tag), _slots(r["jd"].tag, S))
    np.testing.assert_array_equal(np32(r["td"].x), _slots(r["jd"].x, S))


@pytest.mark.parametrize("name", list(CASES))
def test_init_forces_match_per_slot(runs, name):
    r = runs[name]
    S = r["S"]
    (js, jn), (ts, tn) = r["ji"], r["ti"]
    np.testing.assert_array_equal(np32(ts.tag), _slots(js.tag, S))
    ref = _slots(js.f, S)
    tol = (1e-4 if r["cons"] else 2e-3) * np.abs(ref).max()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(np32(ts.f), ref, rtol=0, atol=tol)
    ref_t = _slots(js.tau, S)
    np.testing.assert_allclose(np32(ts.tau), ref_t, rtol=0,
                               atol=(1e-4 if r["cons"] else 2e-3)
                               * np.abs(ref_t).max())
    assert int(tn.overflow.max()) == int(jn.overflow) == 0
    if r["pre"]:
        _assert_budgets_match(r, jn, tn)


def _assert_budgets_match(r, jn, tn):
    """The prefilter's motion budgets of the owned rows, slot for slot,
    and each slab's stage-2 survivors."""
    S, cl = r["S"], 64
    ref = _slots(jn.budget, S)[:, :cl]
    assert ref.max() > 0
    np.testing.assert_allclose(np32(tn.budget)[:, :cl], ref, rtol=1e-3,
                               atol=1e-3 * ref.max())
    np.testing.assert_array_equal(np32(tn.pair_valid).sum(-1),
                                  _slots(jn.pair_valid, S).sum(-1))


@pytest.mark.parametrize("name", list(CASES))
def test_cadence_blocks_with_migrations_match(runs, name):
    r = runs[name]
    S, L = r["S"], r["box"].max()
    (js, jn), (ts, tn) = r["jend"], r["tend"]
    # Migrations happened: some tag's slab changed since distribute.
    owner = lambda st: {int(t): p for p in range(S)
                        for t, a in zip(np32(st.tag)[p], np32(st.active)[p])
                        if a}
    start, end = owner(r["td"]), owner(ts)
    assert sorted(end) == sorted(start) == list(range(1, r["n"] + 1))
    assert sum(start[t] != end[t] for t in start) >= 1
    np.testing.assert_array_equal(np32(ts.active), _slots(js.active, S))
    np.testing.assert_array_equal(np32(ts.tag), _slots(js.tag, S))
    np.testing.assert_array_equal(np32(ts.image), _slots(js.image, S))
    np.testing.assert_allclose(np32(ts.x), _slots(js.x, S), rtol=1e-5,
                               atol=1e-6 * L)
    v_ref = _slots(js.v, S)
    np.testing.assert_allclose(np32(ts.v), v_ref, rtol=0,
                               atol=1e-4 * np.abs(v_ref).max())
    assert int(tn.overflow.max()) == int(jn.overflow) == 0
    jth, tth = r["jth"], r["tth"]
    assert int(tth["n"]) == int(jth["n"]) == r["n"]
    for k in ("ke", "erot", "pe_pair", "pe_wall", "etot"):
        assert float(tth[k]) == pytest.approx(float(jth[k]), rel=1e-3,
                                              abs=1e-9), k
    s_ref = np.asarray(jth["stress"])
    np.testing.assert_allclose(np32(tth["stress"]), s_ref, rtol=0,
                               atol=1e-3 * np.abs(s_ref).max())
    if r["pre"]:
        _assert_budgets_match(r, jn, tn)
    if name == "wall":
        assert float(tth["pe_wall"]) > 0
        # Wall springs live on owned rows only, in matching slots.
        cl = 64
        wh_ref = _slots(jn.wall_hist, S)[:, :cl]
        np.testing.assert_allclose(np32(tn.wall_hist)[:, :cl], wh_ref,
                                   rtol=0, atol=1e-3 * np.abs(wh_ref).max())
        assert np.abs(wh_ref).max() > 0


def _gas(n=200, seed=3):
    rng = np.random.default_rng(seed)
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, 2)], 2,
        contact_quad=(6, 12), device="cpu")
    box = 7.0
    x = rng.uniform(0.0, box, (n, 3))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = tscen.make_state(x, [0, 0, 0], [box] * 3,
                             v=rng.normal(size=(n, 3)), q=q, device="cpu")
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3, device="cpu")
    return shapes, params, state, box


@pytest.mark.parametrize("tilt", [False, True], ids=["ortho", "tilted"])
def test_cell_list_defaults_unchanged(tilt):
    """bin_lo / bin_hi / owned at None: the box and ``active`` (the
    build before they existed); passed as those, the same bits."""
    shapes, params, state, box = _gas()
    t = torch.tensor([0.4, -0.3, 0.2]) if tilt else None
    cut = 1.5
    args = (state.x, state.active, state.box_lo, state.box_hi, cut, (4, 4, 4),
            16, 24, (True, True, True), t)
    base = neighbor.cell_list_neighbors(*args)
    same = neighbor.cell_list_neighbors(*args, bin_lo=state.box_lo,
                                        bin_hi=state.box_hi,
                                        owned=state.active)
    for a, b in zip(base, same):
        assert torch.equal(a, b)
    # owned rows only get lists; partners still include everyone.
    own = torch.arange(state.cap) < 100
    part = neighbor.cell_list_neighbors(*args, owned=own)
    assert torch.equal(part[0][:100], base[0][:100])
    assert not part[1][100:].any() and part[1][:100].equal(base[1][:100])


def test_prefilter_reduce_max_identity_unchanged():
    """``reduce_max`` at None and the identity give the same bits; on two
    slabs it takes the max over them (a slab with a quiet half gets the
    busy half's budget)."""
    shapes, params, state, box = _gas()
    sim = Simulation(shapes, params, periodic=(True,) * 3,
                     grid=CellGrid([0] * 3, [box] * 3, 1.5), k_max=24,
                     cell_cap=16, pair_capacity=2400, stage2_capacity=1200,
                     device="cpu")
    st, ng = sim.init_neighbors(state)
    idx, mask, _ = sim._build_list(st)
    fields, _ = contact.build_pair_list(st, shapes, params, idx, mask,
                                        ng.hist, st.active, 2400,
                                        (True,) * 3)
    a = contact.prefilter_pair_list(st, shapes, params, fields, 1200, 24,
                                    periodic=(True,) * 3)
    b = contact.prefilter_pair_list(st, shapes, params, fields, 1200, 24,
                                    periodic=(True,) * 3,
                                    reduce_max=lambda t: t)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    # Two copies as slabs, the second at rest: its budgets take the
    # first's acceleration maxima only when reduced.
    two = st.replace(**{f: torch.stack([getattr(st, f), getattr(st, f)])
                        for f in ("x", "v", "q", "angmom", "scale",
                                  "shtype", "tag", "active", "f", "tau")})
    two = two.replace(f=torch.stack([st.f, 0 * st.f]),
                      tau=torch.stack([st.tau, 0 * st.tau]))
    f2 = {k: torch.stack([v, v]) for k, v in fields.items()}
    loc = contact.prefilter_pair_list(two, shapes, params, f2, 1200, 24,
                                      periodic=(True,) * 3)[2]
    glob = contact.prefilter_pair_list(two, shapes, params, f2, 1200, 24,
                                       periodic=(True,) * 3,
                                       reduce_max=lambda t: t.amax(0))[2]
    assert torch.equal(glob[0], loc[0]) and torch.equal(glob[0], a[2])
    assert bool((glob[1] >= loc[1]).all()) and bool((glob[1] > loc[1]).any())


@pytest.mark.parametrize("S", [2, 4])
def test_dryrun_sharded_cpu(S):
    th = dryrun_sharded(S, device="cpu")
    assert int(th["n"]) == 16 * S
    assert bool(torch.isfinite(th["etot"]))
    assert int(th["neigh_overflow"]) == 0
