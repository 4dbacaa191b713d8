"""The brick decomposition of the torch port (``parallel/brick.py``) vs the
JAX reference's ``BrickSimulation``, slot for slot, on the CPU.

The reference runs on the virtual 8-device CPU mesh of tests/conftest.py,
the port with its S bricks on the shard axis (flat, row-major over the
mesh axes: the reference's block order); inputs are made once with numpy
(``torch_port_util.brick_drift_system``: a drift along x and y, one
particle 0.01 below every brick boundary and one below every crossing of
an x and a y boundary, moving diagonally). Five systems, each compiled
once on the JAX side (one module-scoped fixture), Lmax-2 ellipsoids:

* ``xy``: a 2x2 brick in the geometric law;
* ``xyz_cons``: a 2x2x2 brick in the conservative law, drifting along z
  too, with one more pair in contact only through a corner ghost (one
  particle just inside brick (0, 0, 0), its partner just inside brick
  (1, 1, 1), its ghost riding the x, then the y, then the z phase);
* ``tri``: a 2x2 brick, triclinic at a static xy tilt of 1.2, tilt pad
  1.3, box 8 x 8 x 8, with one more pair in contact only through the y
  image (which shifts x by the tilt) and across the x cut;
* ``wall``: a 2x2 brick, x and z not periodic, a plane floor under
  gravity: wall springs ride both migration phases;
* ``weighted``: a 2x2 brick with bounds at 0.4 of the box along x and
  0.6 along y.

Checked: ``distribute`` puts the same tag in every slot; after ``init``
the forces agree per slot (2e-3 |F|max geometric, 1e-4 |F|max
conservative); after 2 cadence blocks (migration at the second block's
rebuild, asserted along every mesh axis and diagonally) the slots hold
the same tags, positions within rtol 1e-5, atol 1e-6 L, velocities
within 1e-4 of their scale, thermo within rel 1e-3 and the overflow
channels at 0, as tests/test_torch_halo.py holds the slabs. The JAX side
takes ``exact_eval=True``.
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
from spherharm_tpu.parallel.brick import BrickSimulation as JBrick
from spherharm_tpu_torch.core.state import SimParams
from spherharm_tpu_torch.models import scenarios as tscen
from spherharm_tpu_torch.models import shapes_library
from spherharm_tpu_torch.ops.walls import PlaneWall
from spherharm_tpu_torch.parallel.brick import BrickSimulation

from torch_port_util import brick_drift_system, np32

R_EVERY = 10
STEPS = 2 * R_EVERY
LMAX = 2
TILT = 1.2
# The extra pairs: (positions, velocity); semi-axes 0.55 along x.
CORNER_PAIR = ([[3.75, 3.75, 3.75], [4.22, 4.22, 4.22]], [0.0, 0.0, 0.0])
# Through the -y image (x shifted by -TILT) 0.9 apart along x.
TILT_PAIR = ([[3.0, 0.1, 2.0], [3.0 + TILT + 0.9, 7.9, 2.0]], [0.3, 0.0, 0.0])


def _build(shape, cons=False, wall=False, tri=False, bounds=None):
    """Both packages' brick simulations and initial states."""
    x, v, box, periodic = brick_drift_system(shape, wall=wall, bounds=bounds,
                                             box_z=8.0 if tri else 6.0)
    extra = CORNER_PAIR if len(shape) == 3 else TILT_PAIR if tri else None
    if extra is not None:
        x = np.concatenate([x, extra[0]])
        v = np.concatenate([v, [extra[1]] * 2])
    q = np.tile([1.0, 0.0, 0.0, 0.0], (x.shape[0], 1))
    tilt = (TILT, 0.0, 0.0) if tri else None
    pk = dict(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3, cutoff=1.2, skin=0.3,
              gravity=(0.0, 0.0, -10.0) if wall else (0.0, 0.0, 0.0))
    kw = dict(box_lo=(0, 0, 0), box_hi=tuple(box), periodic=periodic,
              cap_local=64, halo_cap=48, migrate_cap=16, k_max=24,
              cell_cap=16, pair_capacity=384, rebuild_every=R_EVERY,
              conservative=cons, bounds_frac=bounds)
    if tri:
        kw.update(triclinic=True, tilt_pad=TILT + 0.1)
    jshp = jshapes.build_shapes(
        [jshapes.ellipsoid_coeffs(0.55, 0.45, 0.4, LMAX)], LMAX,
        contact_quad=(6, 12), dtype=jnp.float32)
    tshp = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, LMAX)], LMAX,
        contact_quad=(6, 12), device="cpu")
    jwalls = ((JPlaneWall.create((0, 0, 0), (0, 0, 1)),) if wall else ())
    twalls = ((PlaneWall.create((0, 0, 0), (0, 0, 1), device="cpu"),)
              if wall else ())
    S = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:S]).reshape(shape),
                tuple("xyz"[:len(shape)]))
    jsim = JBrick(jshp, JSimParams.create(**pk, dtype=jnp.float32), mesh=mesh,
                  walls=jwalls, exact_eval=True, **kw)
    tsim = BrickSimulation(tshp, SimParams.create(**pk, device="cpu"),
                           mesh_shape=shape, walls=twalls, device="cpu", **kw)
    js0 = jscen.make_state(x, [0, 0, 0], box, v=v, q=q, tilt=tilt,
                           dtype=jnp.float32)
    ts0 = tscen.make_state(x, [0, 0, 0], box, v=v, q=q, tilt=tilt,
                           device="cpu")
    return jsim, js0, tsim, ts0, box


def _slots(a, S):
    """A reference leaf [S * rows, ...] as the port's [S, rows, ...]."""
    a = np.asarray(a)
    return a.reshape((S, a.shape[0] // S) + a.shape[1:])


CASES = {"xy": dict(shape=(2, 2)),
         "xyz_cons": dict(shape=(2, 2, 2), cons=True),
         "tri": dict(shape=(2, 2), tri=True),
         "wall": dict(shape=(2, 2), wall=True),
         "weighted": dict(shape=(2, 2),
                          bounds={"x": [0.0, 0.4, 1.0], "y": [0.0, 0.6, 1.0]})}


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
            shape=case["shape"], S=tsim.n_shards, n=int(ts0.active.sum()),
            box=box, cons=case.get("cons", False), jd=jd, td=td, ji=ji, ti=ti,
            jend=(js, jn), tend=(ts, tn), jth=jsim.thermo(js, jn, jg),
            tth=tsim.thermo(ts, tn, tg))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_distribute_fills_the_same_slots(runs, name):
    r = runs[name]
    S = r["S"]
    np.testing.assert_array_equal(np32(r["td"].active),
                                  _slots(r["jd"].active, S))
    np.testing.assert_array_equal(np32(r["td"].tag), _slots(r["jd"].tag, S))
    np.testing.assert_array_equal(np32(r["td"].x), _slots(r["jd"].x, S))


def _force_tol(r, ref):
    return (1e-4 if r["cons"] else 2e-3) * np.abs(ref).max()


@pytest.mark.parametrize("name", list(CASES))
def test_init_forces_match_per_slot(runs, name):
    r = runs[name]
    S = r["S"]
    (js, jn), (ts, tn) = r["ji"], r["ti"]
    np.testing.assert_array_equal(np32(ts.tag), _slots(js.tag, S))
    ref = _slots(js.f, S)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(np32(ts.f), ref, rtol=0, atol=_force_tol(r, ref))
    ref_t = _slots(js.tau, S)
    np.testing.assert_allclose(np32(ts.tau), ref_t, rtol=0,
                               atol=_force_tol(r, ref_t))
    assert int(tn.overflow.max()) == int(jn.overflow) == 0
    if name in ("xyz_cons", "tri"):
        # The extra pair (the last two tags) touches only through a corner
        # ghost / the tilted y image: both carry a force.
        tag, act = np32(ts.tag), np32(ts.active)
        f = np.abs(np32(ts.f)).max(-1)
        for t in (r["n"] - 1, r["n"]):
            assert f[act & (tag == t)].max() > 1e-3 * f.max(), t


def _coords(shape, p):
    """The mesh coordinates of flat brick p (row-major, x slowest)."""
    return np.unravel_index(p, shape)


@pytest.mark.parametrize("name", list(CASES))
def test_cadence_blocks_with_migrations_match(runs, name):
    r = runs[name]
    S, shape, L = r["S"], r["shape"], r["box"].max()
    (js, jn), (ts, tn) = r["jend"], r["tend"]
    # Migrations along every mesh axis, and diagonal ones (a tag whose
    # brick changed along two axes in one rebuild).
    owner = lambda st: {int(t): p for p in range(S)
                        for t, a in zip(np32(st.tag)[p], np32(st.active)[p])
                        if a}
    start, end = owner(r["td"]), owner(ts)
    assert sorted(end) == sorted(start) == list(range(1, r["n"] + 1))
    moved = np.array([np.array(_coords(shape, start[t]))
                      != np.array(_coords(shape, end[t])) for t in start])
    assert moved.any(0).all(), moved.sum(0)
    assert (moved.sum(1) >= 2).any()
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
    if name == "wall":
        assert float(tth["pe_wall"]) > 0
        cl = 64
        wh_ref = _slots(jn.wall_hist, S)[:, :cl]
        assert np.abs(wh_ref).max() > 0
        np.testing.assert_allclose(np32(tn.wall_hist)[:, :cl], wh_ref,
                                   rtol=0, atol=1e-3 * np.abs(wh_ref).max())
