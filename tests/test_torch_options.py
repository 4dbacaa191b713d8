"""The ``Simulation`` options of the torch port that the reference's own
tests and its deck use, each against the JAX package on the same numpy
inputs: ``SimParams.with_pair_coeffs`` (tests/test_pair_coeff.py),
``neighbor_mode="static"`` (tests/test_integrate.py, tests/test_walls.py),
the group fixes ``freeze`` / ``setforce`` (io/deck.py), the
``gravity_pe_origin`` of thermo, the setup pass that leaves springs alone
(tests/test_setup_history.py).

The JAX side evaluates exactly (``exact_eval=True``). Trajectories: the
reference's own bounds where a test mirrors one, else positions 1e-5 and
energies 1e-5 relative over short runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherharm_tpu.core.simulation import Simulation as JSimulation
from spherharm_tpu.core.state import SimParams as JParams
from spherharm_tpu.core.state import pair_material as jpair_material
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.models import shapes_library as jshapes
from spherharm_tpu.ops import walls as jwalls
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.models import scenarios as tscen
from spherharm_tpu_torch.models import shapes_library as tshapes
from spherharm_tpu_torch.ops import integrate as tint
from spherharm_tpu_torch.ops import walls as twalls

from torch_port_util import np32, to_torch


def _sims(coeffs, lmax, pkw, x, quad=(12, 24), walls=((), ()), sim_kw=None,
          pair_coeffs=None, **state_kw):
    """Matching (JAX, port) Simulation and set-up state from numpy;
    ``pair_coeffs`` = (n_types, coeffs) for ``with_pair_coeffs``."""
    jshp = jshapes.build_shapes(coeffs, lmax, contact_quad=quad)
    tshp = tshapes.build_shapes(coeffs, lmax, contact_quad=quad, device="cpu")
    jp, tp = JParams.create(**pkw), tstate.SimParams.create(device="cpu",
                                                           **pkw)
    if pair_coeffs:
        jp = jp.with_pair_coeffs(*pair_coeffs)
        tp = tp.with_pair_coeffs(*pair_coeffs)
    sim_kw = dict(conservative=False, **(sim_kw or {}))
    jsim = JSimulation(jshp, jp, walls=walls[0], exact_eval=True, **sim_kw)
    tsim = Simulation(tshp, tp, walls=walls[1], device="cpu", **sim_kw)
    box = state_kw.pop("box", ([-5] * 3, [5] * 3))
    tag = state_kw.pop("tag", None)
    js = jscen.make_state(x, *box, **state_kw)
    ts = tscen.make_state(x, *box, device="cpu", **state_kw)
    if tag is not None:
        js = js.replace(tag=jnp.asarray(tag, js.tag.dtype))
        ts = ts.replace(tag=torch.as_tensor(tag))
    js, jn = jsim.init_neighbors(js)
    ts, tn = tsim.init_neighbors(ts)
    return jsim, js, jn, tsim, ts, tn


def _same_run(jsim, js, jn, tsim, ts, tn, steps, atol=1e-5):
    """``steps`` more steps in both packages: x, v and angmom within
    ``atol`` of their scale (at least 1), forces within 2e-3 |F|max (the
    geometric law's kernel tolerance)."""
    js, jn = jsim.run(js, jn, steps)
    ts, tn = tsim.run(ts, tn, steps)
    jax.block_until_ready(js.x)
    for f, tol in (("x", atol), ("v", atol), ("angmom", atol), ("f", 2e-3)):
        ref = np.asarray(getattr(js, f))
        np.testing.assert_allclose(np32(getattr(ts, f)), ref, rtol=0,
                                   atol=tol * max(1.0, np.abs(ref).max()),
                                   err_msg=f)
    return js, jn, ts, tn


# -- with_pair_coeffs ----------------------------------------------------

def test_geometric_mixing_matches_reference():
    """tests/test_pair_coeff.py's mixing case: explicit diagonals kept,
    the unset diagonal from the scalars, unset off-diagonals mixed
    geometrically (k_roll to 0 where one side has none); the [3, 3, 8]
    table equal to the reference's, on the params' device."""
    kw = dict(dt=1e-3, kn=1e4, kt=4e3, gamma_n=8.0, mu=0.5, k_roll=0.0)
    coeffs = {(0, 0): (9e4, 3e4, 2.0, 1.0, 0.3),
              (1, 1): (1e4, 1e4, 8.0, 4.0, 0.6, 100.0, 1.0, 0.1)}
    jp = JParams.create(**kw).with_pair_coeffs(3, coeffs)
    tp = tstate.SimParams.create(device="cpu", **kw).with_pair_coeffs(
        3, coeffs)
    t = np32(tp.pair_tab)
    assert t.shape == (3, 3, 8) and tp.pair_tab.device.type == "cpu"
    np.testing.assert_array_equal(t, np.asarray(jp.pair_tab))
    assert t[0, 0, 0] == pytest.approx(9e4) and t[2, 2, 1] == pytest.approx(4e3)
    assert t[0, 1, 0] == pytest.approx(np.sqrt(9e4 * 1e4))
    assert t[0, 1, 5] == 0.0
    np.testing.assert_array_equal(t[1, 0], t[0, 1])
    ti, tj = np.array([0, 1, 2, 7]), np.array([1, 1, 0, 0])  # 7 clamps to 2
    np.testing.assert_array_equal(
        np32(tstate.pair_material(tp, torch.as_tensor(ti),
                                  torch.as_tensor(tj))),
        np.asarray(jpair_material(jp, jnp.asarray(ti), jnp.asarray(tj))))
    with pytest.raises(ValueError, match="5 or 8 values"):
        tp.with_pair_coeffs(2, {(0, 1): (1.0, 2.0)})


def _two_spheres(pkw, pair_coeffs=None):
    return _sims([jshapes.sphere_coeffs(0.5, 0)] * 2, 0, pkw,
                 [[-0.51, 0.0, 0.0], [0.51, 0.0, 0.0]], quad=(8, 16),
                 sim_kw=dict(neighbor_mode="allpairs", k_max=4),
                 pair_coeffs=pair_coeffs, box=([-2] * 3, [2] * 3),
                 v=[[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]], shtype=[0, 1])


def test_two_material_headon_equivalence():
    """tests/test_pair_coeff.py's head-on case, started 0.02 apart so the
    collision ends within 400 steps: a (0, 1) entry kn = K2 acts exactly
    like the global scalar K2, the port's table run follows the
    reference's, and differs from the global-K1 physics."""
    k1, k2 = 1e5, 3e4
    pkw = dict(dt=2e-4, gamma_n=0.0, mu=0.0, skin=0.05, cutoff=1.05)
    tab = (2, {(0, 1): (k2, 2 / 7 * k2, 0.0, 0.0, 0.0)})
    jsim, js, jn, tsim, ts, tn = _two_spheres(dict(kn=k1, **pkw), tab)
    assert tuple(tsim.params.pair_tab.shape) == (2, 2, 8)
    js, jn, ts, tn = _same_run(jsim, js, jn, tsim, ts, tn, 400, atol=1e-4)
    _, _, _, tsim_b, tsb, tnb = _two_spheres(dict(kn=k2, **pkw))
    tsb, tnb = tsim_b.run(tsb, tnb, 400)
    np.testing.assert_allclose(np32(ts.x), np32(tsb.x), atol=1e-6)
    np.testing.assert_allclose(np32(ts.v), np32(tsb.v), atol=1e-6)
    _, _, _, tsim_c, tsc, tnc = _two_spheres(dict(kn=k1, **pkw))
    tsc, tnc = tsim_c.run(tsc, tnc, 400)
    assert not np.allclose(np32(ts.x), np32(tsc.x), atol=1e-3)


# -- neighbor_mode="static" ----------------------------------------------

def test_static_free_top_matches_reference():
    """tests/test_integrate.py's free asymmetric top in static mode
    (k_max 1, one particle): |L| exact, the reference's quaternion and
    rotational KE after 200 steps; rebuild_every is ignored."""
    coeffs = [jshapes.ellipsoid_coeffs(1.0, 0.7, 0.5, 6)]
    jsim, js, jn, tsim, ts, tn = _sims(
        coeffs, 6, dict(dt=1e-3, kn=1.0, cutoff=2.5), [[0.0, 0.0, 0.0]],
        quad=(8, 16), sim_kw=dict(neighbor_mode="static", k_max=1,
                                  rebuild_every=7),
        angmom=[[0.4, 0.05, 0.8]])
    assert tsim.neighbor_mode == "static"
    js, jn, ts, tn = _same_run(jsim, js, jn, tsim, ts, tn, 200)
    np.testing.assert_allclose(np32(ts.angmom[0]), [0.4, 0.05, 0.8],
                               atol=1e-7)
    np.testing.assert_allclose(np32(ts.q), np.asarray(js.q), atol=1e-5)
    _, ke_r = tint.kinetic_energy(ts, tsim.shapes)
    assert float(ke_r) == pytest.approx(float(jsim.thermo(js, jn)["erot"]),
                                        rel=1e-5)


def test_static_wall_bounce_matches_reference():
    """tests/test_walls.py's dropped sphere in static mode with a plane
    floor, dropped from 5 mm above it: the list is never rebuilt (x_build
    stays the setup's), the sphere falls, bounces, and its trajectory
    follows the reference's (1e-4 of its scale: a damped bounce in f32)."""
    R = 0.5
    floor = ((0, 0, 0), (0, 0, 1))
    walls = ((jwalls.PlaneWall.create(*floor),),
             (twalls.PlaneWall.create(*floor, device="cpu"),))
    jsim, js, jn, tsim, ts, tn = _sims(
        [jshapes.sphere_coeffs(R, 0)], 0,
        dict(dt=1e-4, kn=1e5, gamma_n=100.0, mu=0.0, gravity=(0, 0, -10.0),
             cutoff=2 * R, skin=0.2 * R), [[0.0, 0.0, R + 0.005]],
        walls=walls, sim_kw=dict(neighbor_mode="static", k_max=1),
        box=([-2, -2, 0], [2, 2, 4]))
    xb0 = np32(tn.x_build).copy()
    vz = []
    for _ in range(3):
        js, jn, ts, tn = _same_run(jsim, js, jn, tsim, ts, tn, 200,
                                   atol=1e-4)
        vz.append(float(ts.v[0, 2]))
        np.testing.assert_array_equal(np32(tn.x_build), xb0)
    assert vz[0] < 0 < vz[-1], vz  # fell, bounced


# -- group fixes ---------------------------------------------------------

def test_group_fixes_match_reference():
    """freeze and setforce (with NULL components) keyed by tag through
    group_tab, on particles whose slots are permuted against their tags;
    applied after pair forces and gravity: forces and a 200-step run equal
    the reference's, frozen members keep their velocity, setforce members
    carry exactly the set components."""
    rng = np.random.default_rng(4)
    n = 12
    x = np.stack([np.arange(n) * 0.95 - 5.0, rng.uniform(-0.05, 0.05, n),
                  rng.uniform(-0.05, 0.05, n)], axis=1)
    perm = rng.permutation(n)
    tags = perm + 1
    group_tab = np.zeros(n + 1, np.int32)
    group_tab[[1, 2, 3]] |= 1  # freeze
    group_tab[[4, 5, 9]] |= 2  # setforce (0.5, NULL, 0)
    group_tab[[9, 10]] |= 4  # setforce (NULL, NULL, -2)
    fixes = (("freeze", 0, (0.0, 0.0, 0.0), (False, False, False)),
             ("setforce", 1, (0.5, 0.0, 0.0), (False, True, False)),
             ("setforce", 2, (0.0, 0.0, -2.0), (True, True, False)))
    jsim, js, jn, tsim, ts, tn = _sims(
        [jshapes.sphere_coeffs(0.5, 0)], 0,
        dict(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.3, gravity=(0, 0, -10.0),
             cutoff=1.05, skin=0.1), x,
        sim_kw=dict(neighbor_mode="allpairs", k_max=4, group_fixes=fixes,
                    group_tab=group_tab),
        box=([-8] * 3, [8] * 3), v=rng.normal(size=(n, 3)) * 0.1, tag=tags)
    f = np32(ts.f)
    np.testing.assert_allclose(f, np.asarray(js.f), rtol=0,
                               atol=1e-5 * np.abs(f).max())
    slot = {int(t): i for i, t in enumerate(tags)}
    for t in (1, 2, 3):
        assert (f[slot[t]] == 0).all() and (np32(ts.tau)[slot[t]] == 0).all()
    for t in (4, 5):
        assert f[slot[t]][0] == 0.5 and f[slot[t]][2] == 0.0
    np.testing.assert_array_equal(f[slot[9]], [0.5, f[slot[9]][1], -2.0])
    assert f[slot[10]][2] == -2.0 and f[slot[10]][0] != 0.0
    assert np.abs(f[slot[6]]).max() > 0  # not a member: untouched
    v0 = np32(ts.v)
    js, jn, ts, tn = _same_run(jsim, js, jn, tsim, ts, tn, 200)
    for t in (1, 2, 3):
        np.testing.assert_array_equal(np32(ts.v)[slot[t]], v0[slot[t]])
    with pytest.raises(ValueError, match="group_tab"):
        Simulation(tsim.shapes, tsim.params, neighbor_mode="allpairs",
                   group_fixes=fixes, device="cpu")


# -- gravity_pe_origin ---------------------------------------------------

def test_gravity_pe_origin_matches_reference():
    """thermo's pe_grav measured from gravity_pe_origin: equal to the
    reference's, and shifted from the origin-0 value by m g . origin."""
    origin = (0.5, -1.0, 2.0)
    pkw = dict(dt=1e-4, kn=1e5, gravity=(1.0, 0.0, -10.0), cutoff=1.05,
               skin=0.1)
    x = [[0.0, 0.0, 1.0], [2.0, 1.0, 3.0]]
    coeffs = [jshapes.sphere_coeffs(0.5, 0)]
    jsim, js, jn, tsim, ts, tn = _sims(
        coeffs, 0, pkw, x,
        sim_kw=dict(neighbor_mode="allpairs", k_max=1,
                    gravity_pe_origin=origin))
    _, _, _, t0sim, t0s, t0n = _sims(coeffs, 0, pkw, x,
                                     sim_kw=dict(neighbor_mode="allpairs",
                                                 k_max=1))
    pe = float(tsim.thermo(ts, tn)["pe_grav"])
    assert pe == pytest.approx(float(jsim.thermo(js, jn)["pe_grav"]),
                               rel=1e-6)
    m = float(tsim.shapes.mass_of(ts.shtype, ts.scale).sum())
    shift = m * (1.0 * origin[0] - 10.0 * origin[2])
    assert pe == pytest.approx(float(t0sim.thermo(t0s, t0n)["pe_grav"])
                               + shift, rel=1e-5)


# -- setup history (tests/test_setup_history.py) -------------------------

def _contacting_pair():
    return _sims([jshapes.sphere_coeffs(0.5, 0)], 0,
                 dict(dt=2e-4, kn=1e5, gamma_n=0.0, mu=0.4, skin=0.05,
                      cutoff=1.05), [[-0.48, 0.0, 0.0], [0.48, 0.0, 0.0]],
                 sim_kw=dict(neighbor_mode="allpairs", k_max=1),
                 box=([-2] * 3, [2] * 3),
                 v=[[0.0, 0.5, 0.0], [0.0, -0.5, 0.0]])


def test_setup_pass_fills_forces_but_not_springs():
    """The setup pass fills f(t0) but leaves every spring at zero; one
    step then advances the tangential spring once, as the reference."""
    jsim, js, jn, tsim, ts, tn = _contacting_pair()
    assert float(ts.f.abs().max()) > 0.0
    for h in (tn.hist, tn.pair_hist, tn.wall_hist):
        assert h.numel() == 0 or float(h.abs().max()) == 0.0
    ref = np.asarray(js.f)
    np.testing.assert_allclose(np32(ts.f), ref, rtol=0,
                               atol=2e-3 * np.abs(ref).max())
    js, jn = jsim.run(js, jn, 1)
    ts, tn = tsim.run(ts, tn, 1)
    assert float(tn.hist.abs().max()) > 0.0
    ref = np.asarray(jn.hist)
    np.testing.assert_allclose(np32(tn.hist), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_first_step_spring_matches_single_tick():
    """The first step's spring is one dt of tangential relative motion
    (speed 1.0, dt 2e-4: ~2e-4; a double tick would be ~2x)."""
    _, _, _, tsim, ts, tn = _contacting_pair()
    ts, tn = tsim.run(ts, tn, 1)
    assert 0.7 * 2e-4 < float(tn.hist.abs().max()) < 1.3 * 2e-4


def test_reference_containers_cross_unchanged():
    """A reference SimParams with a [T, T, 8] pair table, a State with a
    nonzero tilt and a Simulation's group_tab reach the port unchanged."""
    jp = JParams.create(dt=1e-4, kn=1e5, mu=0.3).with_pair_coeffs(
        3, {(0, 2): (2e4, 6e3, 1.0, 0.5, 0.2, 10.0, 0.1, 0.05)})
    tp = to_torch(tstate.SimParams, jp)
    np.testing.assert_array_equal(np32(tp.pair_tab), np.asarray(jp.pair_tab))
    assert tuple(tp.pair_tab.shape) == (3, 3, 8)
    js = jscen.make_state(np.zeros((2, 3)), [0] * 3, [4] * 3,
                          tilt=[0.7, -0.3, 1.1])
    ts = to_torch(tstate.State, js)
    np.testing.assert_array_equal(np32(ts.tilt), np.asarray(js.tilt))
    fixes = (("freeze", 0, (0.0,) * 3, (False,) * 3),)
    shp = [jshapes.sphere_coeffs(0.5, 0)]
    jsim = JSimulation(jshapes.build_shapes(shp, 0), jp, neighbor_mode="allpairs",
                       group_fixes=fixes, group_tab=np.array([0, 1, 0], np.int32))
    tsim = Simulation(tshapes.build_shapes(shp, 0, device="cpu"), tp,
                      neighbor_mode="allpairs", group_fixes=jsim.group_fixes,
                      group_tab=np.asarray(jsim.group_tab), device="cpu")
    np.testing.assert_array_equal(np32(tsim.group_tab), [0, 1, 0])
    assert tsim.group_fixes == jsim.group_fixes
