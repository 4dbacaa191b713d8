"""The damped scenarios and the two-body collision of the torch port vs the
JAX reference, end to end, plus the port's device defaults.

The JAX side evaluates exactly: ``deposition`` takes ``exact_eval=True``;
``settling_box`` and ``two_body_collision`` have no such argument, so the
JAX ``Simulation`` is rebuilt from the builder's shapes, params, grid and
walls with ``exact_eval=True``. Both packages start from the SAME numpy
state, rich in contacts (the builders' loose packings touch nothing in a
few dozen steps).

Tolerances (f32, different summation orders): energies rtol 2e-3,
positions 1e-3 absolute, as tests/test_torch_drum.py; the two-body
collision holds the reference's own energy bounds (tests/test_two_body.py).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from spherharm_tpu.core.simulation import Simulation as JSimulation
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu_torch.core import simulation as tsim_mod
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.models import scenarios as tscen
from spherharm_tpu_torch.models import shapes_library as tshapes
from spherharm_tpu_torch.ops import walls as twalls

from torch_port_util import contact_rich_state, np32, pressed_box_state

STEPS = 40
ENERGIES = ("ke", "erot", "pe_pair", "pe_wall", "pe_grav", "etot")


def _thermo(sim, st, ng):
    return {k: float(v) for k, v in sim.thermo(st, ng).items()
            if np.ndim(v) == 0}


def _compare(jsim, js, jn, tsim, ts, tn, keys=ENERGIES):
    jth, tth = _thermo(jsim, js, jn), _thermo(tsim, ts, tn)
    for th, ng in ((jth, jn), (tth, tn)):
        assert int(ng.overflow) == 0
        assert th["pe_pair"] > 0 and th["pe_wall"] > 0  # not vacuous
    assert int(tth["step"]) == int(jth["step"])
    for k in keys:
        np.testing.assert_allclose(tth[k], jth[k], rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(np32(ts.x), np.asarray(js.x), rtol=0,
                               atol=1e-3)


def test_entry_points_default_to_cuda():
    """Every builder runs on the card unless the caller asks for the CPU;
    without a card a call that names no device raises."""
    fns = [tstate.State.from_numpy, tstate.SimParams.create,
           tstate.zeros_state, tstate.empty_neighbors,
           tsim_mod.Simulation.__init__, tscen.make_state,
           tscen.two_body_collision, tscen.settling_box,
           tscen.rotating_drum, tscen.triaxial_cell, tshapes.build_shapes,
           twalls.PlaneWall.create, twalls.CylinderWall.create]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__qualname__
    if torch.cuda.is_available():
        st = tscen.make_state(np.zeros((2, 3)), [-1] * 3, [1] * 3)
        assert st.x.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tscen.make_state(np.zeros((2, 3)), [-1] * 3, [1] * 3)
        with pytest.raises((AssertionError, RuntimeError)):
            tstate.SimParams.create(dt=1e-4, kn=1e5)


@pytest.mark.parametrize("cons,etol", [(False, 1e-4), (True, 3e-4)])
def test_two_body_headon_matches_reference(cons, etol):
    """Config 1 (allpairs, k_max 1, dense path): the head-on elastic
    collision of tests/test_two_body.py:52 in both packages."""
    kw = dict(gamma_n=0.0, dt=2e-4, conservative=cons)
    j0, jst, _ = jscen.two_body_collision(**kw)
    jsim = JSimulation(j0.shapes, j0.params, neighbor_mode="allpairs",
                       k_max=1, conservative=cons, exact_eval=True)
    js, jn = jsim.init_neighbors(jst)
    tsim, ts, tn = tscen.two_body_collision(device="cpu", **kw)
    e0 = _thermo(tsim, ts, tn)["etot"]
    js, jn = jsim.run(js, jn, 3000)
    ts, tn = tsim.run(ts, tn, 3000)
    v = np32(ts.v)
    assert v[0, 0] == pytest.approx(-1.0, abs=2e-3)  # velocities swap
    assert v[1, 0] == pytest.approx(1.0, abs=2e-3)
    e1 = _thermo(tsim, ts, tn)["etot"]
    assert abs(e1 - e0) / e0 < etol
    np.testing.assert_allclose(v, np.asarray(js.v), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np32(ts.x), np.asarray(js.x), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(e1, float(jsim.thermo(js, jn)["etot"]),
                               rtol=1e-4)


def test_deposition_matches_reference():
    """Config 3 at n = 128, Lmax 4 with the 12x24 cap grid (geometric law,
    pair list 10n, skin-triggered rebuild), 40 steps from a compressed
    drum packing pressed onto the shell and both end caps."""
    kw = dict(n=128, lmax=4)
    jsim, jst0, _ = jscen.deposition(exact_eval=True, **kw)
    tsim, tst0, _ = tscen.deposition(device="cpu", **kw)
    assert not tsim.conservative and tsim.shapes.cap_x.shape[0] == 288
    np.testing.assert_allclose(np32(tst0.x), np.asarray(jst0.x), atol=1e-6)
    R = float(jsim.walls[0].radius)
    L = float(jsim.walls[2].point[1] - jsim.walls[1].point[1])
    shtype = np.asarray(jst0.shtype)
    scale = np.asarray(jst0.scale, np.float64)
    radius = np.asarray(jsim.shapes.rchar, np.float64)[shtype] * scale
    x, angmom = contact_rich_state(np.asarray(jst0.x), radius, R, L)
    state = dict(q=np.asarray(jst0.q), angmom=angmom, scale=scale,
                 shtype=shtype)
    box = (np.asarray(jst0.box_lo), np.asarray(jst0.box_hi))

    js, jn = jsim.run(*jsim.init_neighbors(jscen.make_state(x, *box,
                                                            **state)), STEPS)
    jax.block_until_ready(js.x)
    ts, tn = tsim.run(*tsim.init_neighbors(
        tscen.make_state(x, *box, device="cpu", **state)), STEPS)
    _compare(jsim, js, jn, tsim, ts, tn)


def test_settling_box_matches_reference():
    """Config 2 at n = 64, Lmax 2 (5 plane walls, dense [N, K] path,
    geometric law), 40 steps from the lattice shrunk onto the floor."""
    kw = dict(n=64, lmax=2)
    j0, jst0, _ = jscen.settling_box(**kw)
    jsim = JSimulation(j0.shapes, j0.params, neighbor_mode="cell",
                       grid=j0.grid, k_max=j0.k_max, cell_cap=j0.cell_cap,
                       walls=j0.walls, conservative=False, exact_eval=True)
    tsim, tst0, _ = tscen.settling_box(device="cpu", **kw)
    assert tsim.pair_capacity == 0 and len(tsim.walls) == 5
    assert tsim.grid.dims == j0.grid.dims
    np.testing.assert_allclose(np32(tst0.x), np.asarray(jst0.x), atol=1e-6)
    np.testing.assert_array_equal(np32(tst0.q), np.asarray(jst0.q))
    x, angmom = pressed_box_state(np.asarray(jst0.x),
                                  float(j0.shapes.rmax[0]))
    q = np.asarray(jst0.q)
    box = (np.asarray(jst0.box_lo), np.asarray(jst0.box_hi))

    js, jn = jsim.run(*jsim.init_neighbors(
        jscen.make_state(x, *box, q=q, angmom=angmom)), STEPS)
    jax.block_until_ready(js.x)
    ts, tn = tsim.run(*tsim.init_neighbors(
        tscen.make_state(x, *box, q=q, angmom=angmom, device="cpu")), STEPS)
    _compare(jsim, js, jn, tsim, ts, tn)


def test_geometric_drum_setup_forces_match_reference():
    """rotating_drum(conservative=False) with the prefilter on: the setup
    force pass (pair list, stage-1 probe, geometric pair law, walls) on a
    contact-rich state. The JAX side runs its Pallas kernels in interpret
    mode. Forces and torques at 2e-3 of their scale."""
    kw = dict(n=128, lmax=2, k_max=24, pair_capacity=640,
              stage2_capacity=384, rebuild_every=20, conservative=False)
    jsim, jst0, _ = jscen.rotating_drum(use_pallas=True, exact_eval=True,
                                        **kw)
    tsim, _, _ = tscen.rotating_drum(device="cpu", **kw)
    assert not tsim.conservative and tsim.prefilter
    R = float(jsim.walls[0].radius)
    L = float(jsim.walls[2].point[1] - jsim.walls[1].point[1])
    shtype = np.asarray(jst0.shtype)
    scale = np.asarray(jst0.scale, np.float64)
    radius = np.asarray(jsim.shapes.rchar, np.float64)[shtype] * scale
    x, angmom = contact_rich_state(np.asarray(jst0.x), radius, R, L)
    state = dict(q=np.asarray(jst0.q), angmom=angmom, scale=scale,
                 shtype=shtype)
    box = (np.asarray(jst0.box_lo), np.asarray(jst0.box_hi))
    js, _ = jsim.init_neighbors(jscen.make_state(x, *box, **state))
    ts, tn = tsim.init_neighbors(tscen.make_state(x, *box, device="cpu",
                                                  **state))
    assert int(tn.overflow) == 0 and int(tn.pair_valid.sum()) > 100
    for name in ("f", "tau"):
        ref = np.asarray(getattr(js, name))
        np.testing.assert_allclose(np32(getattr(ts, name)), ref, rtol=0,
                                   atol=2e-3 * np.abs(ref).max(),
                                   err_msg=name)
