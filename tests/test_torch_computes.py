"""Diagnostic computes of the torch port (``core/computes.py``) vs the JAX
reference, mirroring tests/test_computes.py (its deck and dump cases,
``test_deck_compute_command`` and ``test_dump_peratom_compute_column``, are
mirrored in tests/test_torch_deck.py).

The state comes from the reference: a dense periodic gas run 40 steps by
the JAX ``Simulation`` (geometric law, ``exact_eval=True``), handed to the
port through ``from_numpy``, so both packages evaluate the SAME state,
neighbour tensor, pair list and springs. Tolerances: the identities of
the reference's own test (rtol 1e-4); parity rtol 1e-4 on sums of f32
terms, 2e-3 |F|max-scaled on the per-atom stress (the geometric law's
kernel bound, tests/test_pallas.py), exact on counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from spherharm_tpu.core import computes as jcomp
from spherharm_tpu.core.simulation import Simulation as JSimulation
from spherharm_tpu.core.state import SimParams as JParams
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.models import shapes_library as jshapes
from spherharm_tpu.ops.neighbor import CellGrid as JCellGrid
from spherharm_tpu_torch.core import computes
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.ops import contact_kernels as ck
from spherharm_tpu_torch.ops.neighbor import CellGrid

from torch_port_util import np32, to_torch


def _port_sim(jsim, grid=None):
    """The port's Simulation with the reference's shapes, params and
    configuration."""
    return Simulation(to_torch(tstate.Shapes, jsim.shapes),
                      to_torch(tstate.SimParams, jsim.params),
                      periodic=jsim.periodic, grid=grid, k_max=jsim.k_max,
                      cell_cap=jsim.cell_cap,
                      pair_capacity=jsim.pair_capacity, conservative=False,
                      neighbor_mode=jsim.neighbor_mode, device="cpu")


BOX = 4.5


def _dense_gas(n=64, lmax=2, seed=0):
    """tests/test_computes.py's gas, packed tighter (box 4.5, not 6, so
    pairs touch): periodic Lmax 2 ellipsoids, pair list 1024, geometric
    law, 40 steps so contacts carry live springs."""
    rng = np.random.default_rng(seed)
    shapes = jshapes.build_shapes(
        [jshapes.ellipsoid_coeffs(0.55, 0.45, 0.4, lmax)], lmax,
        contact_quad=(6, 12))
    box = BOX
    side = int(np.ceil(n ** (1 / 3)))
    pitch = box / side
    i = np.arange(n)
    x = np.stack([(i % side + 0.5) * pitch, ((i // side) % side + 0.5) * pitch,
                  (i // side**2 + 0.5) * pitch], axis=1)
    x = x + rng.uniform(-0.1, 0.1, (n, 3))
    v = rng.normal(size=(n, 3)) * 0.5
    params = JParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.4,
                            cutoff=1.2, skin=0.3)
    state = jscen.make_state(x, [0, 0, 0], [box] * 3, v=v)
    grid = JCellGrid([0, 0, 0], [box] * 3, 1.5, (True, True, True))
    jsim = JSimulation(shapes, params, periodic=(True, True, True),
                       neighbor_mode="cell", grid=grid, k_max=16,
                       cell_cap=10, pair_capacity=1024, conservative=False,
                       exact_eval=True)
    js, jn = jsim.run(*jsim.init_neighbors(state), 40)
    return jsim, js, jn


@pytest.fixture(scope="module")
def gas():
    """(jsim, js, jn, tsim, ts, tn): the same state in both packages."""
    jsim, js, jn = _dense_gas()
    tsim = _port_sim(jsim, CellGrid([0, 0, 0], [BOX] * 3, 1.5,
                                    (True, True, True)))
    assert tsim.grid.dims == jsim.grid.dims
    ts = to_torch(tstate.State, js)
    tn = to_torch(tstate.NeighborState, jn)
    assert int(tn.pair_valid.sum()) > 10
    return jsim, js, jn, tsim, ts, tn


def test_per_atom_stress_sums_to_global_virial(gas):
    """LAMMPS identity: sum_i S_i == -(thermo stress tensor) * V."""
    *_, tsim, ts, tn = gas
    total = np32(computes.per_atom_stress(tsim, ts, tn).sum(0))
    t = tsim.thermo(ts, tn)
    vol = float((ts.box_hi - ts.box_lo).prod())
    expect = -np32(t["stress"]) * vol
    assert np.abs(expect).max() > 1e-6  # contacts actually present
    np.testing.assert_allclose(total, expect, rtol=1e-4, atol=1e-6)


def test_pressure_compute_matches_thermo_press(gas):
    *_, tsim, ts, tn = gas
    p = float(computes.compute("pressure", tsim, ts, tn))
    assert p == pytest.approx(float(tsim.thermo(ts, tn)["press"]), rel=1e-4,
                              abs=1e-7)


def test_scalar_registry_and_errors(gas):
    *_, tsim, ts, tn = gas
    assert float(computes.compute("temp", tsim, ts, tn)) > 0
    ka = computes.compute("ke/atom", tsim, ts, tn)
    assert float(ka.sum()) == pytest.approx(
        float(computes.compute("ke", tsim, ts, tn)), rel=1e-5)
    with pytest.raises(KeyError, match="unknown compute"):
        computes.compute("cna/atom", tsim, ts, tn)


@pytest.mark.parametrize("style", sorted(computes.SCALAR_COMPUTES)
                         + sorted(computes.PERATOM_COMPUTES))
def test_compute_matches_reference(gas, style):
    jsim, js, jn, tsim, ts, tn = gas
    ref = np.asarray(jcomp.compute(style, jsim, js, jn))
    got = np32(computes.compute(style, tsim, ts, tn))
    assert got.shape == ref.shape
    if style in ("coord/atom", "contact/atom"):
        np.testing.assert_array_equal(got, ref)
        assert ref.sum() > 0
    elif style == "stress/atom":
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-3 * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-7)


def test_computes_stay_f32_under_stage2_bf16(gas, monkeypatch):
    """SPHERHARM_STAGE2_BF16 switches the force calls only: the per-atom
    computes' narrow phase stays f32, as the reference's does, so their
    values do not move by a bit."""
    *_, tsim, ts, tn = gas
    styles = ("stress/atom", "contact/atom")
    f32 = {s: np32(computes.compute(s, tsim, ts, tn)) for s in styles}
    monkeypatch.setattr(ck, "STAGE2_BF16", True)
    for s in styles:
        np.testing.assert_array_equal(np32(computes.compute(s, tsim, ts, tn)),
                                      f32[s], err_msg=s)


def test_coord_and_contact_atom():
    """Two overlapping + one distant sphere: coord counts bounding-sphere
    proximity, contact counts true narrow-phase contacts."""
    lmax = 0
    shapes = jshapes.build_shapes([jshapes.sphere_coeffs(0.5, lmax)], lmax,
                                  contact_quad=(12, 24))
    params = JParams.create(dt=1e-4, kn=1e5, cutoff=1.1, skin=0.2)
    state = jscen.make_state([[0.0, 0, 0], [0.95, 0, 0], [3.0, 0, 0]],
                             [-1, -2, -2], [5, 2, 2])
    jsim = JSimulation(shapes, params, neighbor_mode="allpairs", k_max=4,
                       pair_capacity=16, conservative=False)
    tsim = _port_sim(jsim)
    st, ng = tsim.init_neighbors(to_torch(tstate.State, state))
    coord = np32(computes.compute("coord/atom", tsim, st, ng))
    cont = np32(computes.compute("contact/atom", tsim, st, ng))
    assert list(coord[:3]) == [1, 1, 0]
    assert list(cont[:3]) == [1, 1, 0]
    js, jn = jsim.init_neighbors(state)
    np.testing.assert_array_equal(
        cont, np.asarray(jcomp.compute("contact/atom", jsim, js, jn)))
    assert float(computes.compute("packing", tsim, st, ng)) == pytest.approx(
        float(jcomp.compute("packing", jsim, js, jn)), rel=1e-5)
    assert float(jnp.sum(js.active)) == 3
