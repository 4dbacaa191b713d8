"""The replica ensemble of the torch port (``parallel/ensemble.py``) vs the
JAX reference's and vs its own single runs, on the CPU.

* The two-body restitution sweep of tests/test_ensemble.py, and the same
  sweep against the reference's ``ensemble.run_replicas`` replica by
  replica (the JAX ``Simulation`` rebuilt with ``exact_eval=True``, as
  tests/test_torch_scenarios.py does; its head-on tolerances).
* ``with_param_sweep`` / ``replicate`` / ``from_numpy`` against the
  reference's stacked pytrees, leaf for leaf.
* Every replica of an ensemble equals its own single run (``Simulation.
  step`` with that replica's params) bit for bit, every State and
  NeighborState field (``torch.equal``): the small deposition (pair list,
  walls, ``wall_capacity``, skin trigger), the small conservative drum
  with the prefilter, the sheared triaxial cell (periodic, triclinic, the
  servo) and R = 1 against ``Simulation.step``. Each replica's sums keep
  their single-run order on the CPU: the segment sums scan each
  replica's own [R, P] row, the pair twin runs a replica's live rows at a
  time, and the virial and kinetic einsums happen to agree too, so no
  tolerance is needed. The sweeps make the replicas rebuild at different
  steps, and the tests assert that they did.
* Group fixes in static and all-pairs modes, replica by replica.
* One replica past its pair capacity overflows in its own channel only.
* The batched plain twins equal one call a replica.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherharm_tpu.core import state as jstate
from spherharm_tpu.core.simulation import Simulation as JSimulation
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.parallel import ensemble as jens
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.models import scenarios as tscen
from spherharm_tpu_torch.models import shapes_library
from spherharm_tpu_torch.ops import contact_kernels as ck
from spherharm_tpu_torch.ops import walls_kernels as wk
from spherharm_tpu_torch.ops.rotation import omega_from_angmom
from spherharm_tpu_torch.parallel import ensemble as ens
from spherharm_tpu_torch.utils import validate

from torch_port_util import (blob_coeffs, drum_state, np32, to_torch,
                             triaxial_state)

GAMMAS = [0.0, 50.0, 150.0, 400.0]
SWEEP_STEPS = 3000
CPU = torch.device("cpu")


def _fields(obj):
    return [f.name for f in dataclasses.fields(obj)
            if not f.metadata.get("static")]


@pytest.fixture(scope="module")
def gamma_sweep():
    """tests/test_ensemble.py's restitution sweep in the port: R = 4
    two-body collisions, gamma_n 0-400, 3000 steps."""
    sim, state, neigh = tscen.two_body_collision(
        gamma_n=0.0, dt=2e-4, conservative=False, device="cpu")
    R = len(GAMMAS)
    params = ens.with_param_sweep(sim.params, gamma_n=GAMMAS)
    states, neighs = ens.run_replicas(sim, ens.replicate(state, R),
                                      ens.replicate(neigh, R), params,
                                      SWEEP_STEPS)
    return sim, state, neigh, states


def test_replica_sweep_gamma(gamma_sweep):
    """Higher damping -> lower outgoing speed, and the gamma = 0 replica
    matches the single run."""
    sim, state, neigh, states = gamma_sweep
    v_out = np32(states.v)[:, 0, 0]  # replica, particle 0, x
    speeds = -v_out
    assert speeds[0] > 0.99
    assert np.all(np.diff(speeds) < 0), speeds  # monotone in gamma
    s1, _ = sim.run(state, neigh, SWEEP_STEPS)
    np.testing.assert_allclose(v_out[0], float(s1.v[0, 0]), atol=2e-3)


def test_replica_sweep_matches_reference(gamma_sweep):
    """Each replica of the sweep against the reference's vmapped
    ``run_replicas``: velocities within 1e-3, positions within 1e-4 (the
    head-on collision's tolerances)."""
    *_, states = gamma_sweep
    j0, jst, _ = jscen.two_body_collision(gamma_n=0.0, dt=2e-4,
                                          conservative=False)
    jsim = JSimulation(j0.shapes, j0.params, neighbor_mode="allpairs",
                       k_max=1, conservative=False, exact_eval=True)
    js, jn = jsim.init_neighbors(jst)
    R = len(GAMMAS)
    jp = jens.with_param_sweep(jsim.params,
                               gamma_n=jnp.asarray(GAMMAS, jnp.float32))
    jS, _ = jens.run_replicas(jsim, jens.replicate(js, R),
                              jens.replicate(jn, R), jp, SWEEP_STEPS)
    v, jv = np32(states.v), np.asarray(jS.v)
    assert v.shape == jv.shape == (R, 2, 3)
    for r in range(R):
        np.testing.assert_allclose(v[r], jv[r], rtol=0, atol=1e-3,
                                   err_msg=f"replica {r}")
        np.testing.assert_allclose(np32(states.x)[r], np.asarray(jS.x)[r],
                                   rtol=0, atol=1e-4, err_msg=f"replica {r}")


@pytest.mark.parametrize("sweep", [
    pytest.param(dict(mu=[0.1, 0.45, 0.8]), id="mu"),
    pytest.param(dict(kn=[1e5, 2e5, 4e5], gamma_n=[0.0, 20.0, 40.0]),
                 id="kn-gamma_n"),
    pytest.param(dict(dt=[1e-4, 2e-4, 3e-4]), id="dt"),
    pytest.param(dict(gravity=[[0, 0, -1.0], [0, 0, -5.0], [0, 0, -10.0]]),
                 id="gravity"),
])
def test_with_param_sweep_matches_reference(sweep):
    """Every field and every pair_tab slot equal to the reference's, for
    material sweeps (which overwrite their slot of the whole two-type
    table) and the others; unequal lengths raise in both."""
    jparams = jstate.SimParams.create(
        dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4, k_roll=2e4, gamma_roll=10.0,
        mu_roll=0.2, gravity=(0.0, 0.0, -10.0), skin=0.2, cutoff=1.4
    ).with_pair_coeffs(
        2, {(0, 1): (3e5, 1e5, 30.0, 10.0, 0.2, 1e4, 5.0, 0.1)})
    tparams = to_torch(tstate.SimParams, jparams)
    jp = jens.with_param_sweep(jparams, **{
        k: jnp.asarray(v, jnp.float32) for k, v in sweep.items()})
    tp = ens.with_param_sweep(tparams, **sweep)
    assert tp.pair_tab.shape == (3, 2, 2, 8)
    for name in _fields(tp):
        np.testing.assert_array_equal(np32(getattr(tp, name)),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    with pytest.raises(AssertionError):
        jens.with_param_sweep(jparams, mu=jnp.zeros(3), kn=jnp.ones(2))
    with pytest.raises(ValueError, match="lengths differ"):
        ens.with_param_sweep(tparams, mu=[0.1, 0.2, 0.3], kn=[1e5, 2e5])


def test_replicate_and_from_numpy_take_jax_stacks():
    """The reference's stacked pytrees convert one-to-one: ``from_numpy``
    of ``jens.replicate(obj, R)`` equals ``ens.replicate`` of the
    converted ``obj``, 0-d leaves included; distinct initial conditions
    stacked as the reference stacks them (``jax.tree.map(jnp.stack)``)
    equal ``stack_replicas``, and ``replica`` takes one back out."""
    rng = np.random.default_rng(4)
    jst = jscen.make_state(rng.uniform(0, 3, (6, 3)), [0, 0, 0], [3, 3, 3],
                           v=rng.normal(size=(6, 3)), cap=8)
    jn = jstate.empty_neighbors(8, 4, 2, pair_cap=12)
    jp = jstate.SimParams.create(dt=1e-4, kn=1e5, gamma_n=20.0)
    R = 3
    for cls, obj in ((tstate.State, jst), (tstate.NeighborState, jn),
                     (tstate.SimParams, jp)):
        got = to_torch(cls, jens.replicate(obj, R))
        want = ens.replicate(to_torch(cls, obj), R)
        for name in _fields(want):
            g, w = getattr(got, name), getattr(want, name)
            assert g.shape[0] == R and g.shape == w.shape, name
            assert torch.equal(g, w), name
    moved = jst.replace(x=jst.x + 0.05, v=-jst.v)
    jstack = jax.tree.map(lambda *a: jnp.stack(a), jst, moved)
    tstack = ens.stack_replicas([to_torch(tstate.State, jst),
                                 to_torch(tstate.State, moved)])
    back = ens.replica(tstack, 1)
    for name in _fields(tstack):
        np.testing.assert_array_equal(np32(getattr(tstack, name)),
                                      np.asarray(getattr(jstack, name)),
                                      err_msg=name)
        np.testing.assert_array_equal(np32(getattr(back, name)),
                                      np.asarray(getattr(moved, name)),
                                      err_msg=name)


def _solo(sim, params, state, neigh, steps):
    """One replica's own run: ``Simulation.step`` with its params. Returns
    (state, neigh, steps at which it rebuilt)."""
    one = copy.copy(sim)
    one.params = params
    rebuilt, rebuild = [], one._rebuild

    def counted(st, ng):
        rebuilt.append(int(st.step))
        return rebuild(st, ng)

    one._rebuild = counted
    for _ in range(steps):
        state, neigh = one.step(state, neigh)
    return state, neigh, rebuilt


def _assert_replicas_are_solo_runs(sim, state, neigh, params, steps,
                                   rebuilds_differ=True):
    R = params.dt.shape[0]
    states, neighs = ens.run_replicas(sim, ens.replicate(state, R),
                                      ens.replicate(neigh, R), params, steps)
    assert int(states.step[0]) == int(state.step) + steps
    rebuilt = []
    for r in range(R):
        st, ng, when = _solo(sim, ens.replica(params, r), state, neigh, steps)
        rebuilt.append(tuple(when))
        for obj, solo in ((states, st), (neighs, ng)):
            for name in _fields(solo):
                assert torch.equal(getattr(obj, name)[r], getattr(solo, name)), \
                    f"replica {r}: {type(solo).__name__}.{name}"
        assert int(ng.overflow) == 0
    if rebuilds_differ:
        assert all(rebuilt) and len(set(rebuilt)) > 1, rebuilt
    return states, neighs, rebuilt


def test_deposition_replicas_are_solo_runs():
    """Config 3 at n = 128, Lmax 4 (288 cap nodes, geometric law, pair
    list 10n, skin trigger, three walls with wall_capacity 48 < n), from
    a contact-rich start; mu, dt, skin and gravity swept over R = 3, 30
    steps (the small skins and strong gravity make each replica rebuild
    at its own steps: 4, 6 and 8 rebuilds)."""
    sim, st0, _ = tscen.deposition(n=128, lmax=4, device="cpu")
    sim.wall_capacity = 48
    state, neigh = sim.init_neighbors(drum_state(sim, st0, CPU))
    params = ens.with_param_sweep(
        sim.params, mu=[0.1, 0.5, 0.9], dt=[1e-4, 1.5e-4, 2e-4],
        skin=[0.003, 0.005, 0.008],
        gravity=[[0, 0, -300.0], [0, 0, -600.0], [0, 0, -900.0]])
    states, neighs, _ = _assert_replicas_are_solo_runs(sim, state, neigh,
                                                       params, 30)
    th = ens.thermo(sim, states, neighs, params)
    assert th["etot"].shape == (3,) and th["stress"].shape == (3, 3, 3)
    assert bool((th["pe_pair"] > 0).all() and (th["pe_wall"] > 0).all())


def test_drum_prefilter_replicas_are_solo_runs():
    """The conservative drum at n = 96, Lmax 2 with the prefilter (pair
    cap 5n, stage-2 cap 3n, its approach-ratio trigger), gamma_n, dt and
    skin swept over R = 3, 24 steps; built with a skin of 0.004, so the
    motion budgets are small and each replica rebuilds at its own steps
    (2, 4 and 4 rebuilds)."""
    sim, st0, _ = tscen.rotating_drum(n=96, lmax=2, k_max=24,
                                      pair_capacity=480, stage2_capacity=288,
                                      device="cpu")
    assert sim.prefilter and sim.conservative and sim.rebuild_every == 0
    sim.params = sim.params.replace(skin=torch.tensor(0.004))
    state, neigh = sim.init_neighbors(drum_state(sim, st0, CPU))
    params = ens.with_param_sweep(sim.params, gamma_n=[10.0, 50.0, 200.0],
                                  dt=[1e-4, 2e-4, 3e-4],
                                  skin=[0.004, 0.008, 0.016])
    _assert_replicas_are_solo_runs(sim, state, neigh, params, 24)


def test_triaxial_replicas_are_solo_runs():
    """The periodic sheared triaxial cell (n = 128, fill 0.09: 3 grid
    cells an axis; xy shear 0.05 from just under the flip; the Berendsen
    servo) with a press_target sweep at R = 2: box, tilt, images and all
    equal to each replica's own run."""
    sim, st0, _ = tscen.triaxial_cell(n=128, fill_fraction=0.09,
                                      shear_rate=(0.05, 0.0, 0.0),
                                      press_tau=1.0, device="cpu")
    assert sim.triclinic and sim.press_control
    state, neigh = sim.init_neighbors(
        triaxial_state(st0, CPU, xy_frac=0.5 * (1 - 1e-4))[0])
    params = ens.with_param_sweep(
        sim.params, press_target=[[0.0, 0.0, 0.0], [40.0, 40.0, 40.0]])
    states, _, _ = _assert_replicas_are_solo_runs(sim, state, neigh, params,
                                                  20, rebuilds_differ=False)
    # The xy tilt, started just under +Lx/2, flipped in both, and the
    # servo drove the boxes apart.
    assert bool((states.tilt[:, 0] < 0).all())
    assert not torch.equal(states.box_hi[0], states.box_hi[1])


@pytest.mark.parametrize("mode", ["static", "allpairs"])
def test_group_fixes_replicas_are_solo_runs(mode):
    """Freeze and setforce through ``group_tab`` on tags permuted against
    slots (tests/test_torch_options.py's 12-sphere chain), in static and
    all-pairs neighbour modes (the dense [N, K] path), gravity and dt
    swept over R = 3, 100 steps: every replica equals its single run."""
    rng = np.random.default_rng(4)
    n = 12
    x = np.stack([np.arange(n) * 0.95 - 5.0, rng.uniform(-0.05, 0.05, n),
                  rng.uniform(-0.05, 0.05, n)], axis=1)
    tags = rng.permutation(n) + 1
    group_tab = np.zeros(n + 1, np.int32)
    group_tab[[1, 2, 3]] |= 1
    group_tab[[4, 5, 9]] |= 2
    group_tab[[9, 10]] |= 4
    fixes = (("freeze", 0, (0.0, 0.0, 0.0), (False, False, False)),
             ("setforce", 1, (0.5, 0.0, 0.0), (False, True, False)),
             ("setforce", 2, (0.0, 0.0, -2.0), (True, True, False)))
    shapes = shapes_library.build_shapes(
        [shapes_library.sphere_coeffs(0.5, 0)], 0, device="cpu")
    params = tstate.SimParams.create(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.3,
                                     gravity=(0, 0, -10.0), cutoff=1.05,
                                     skin=0.1, device="cpu")
    sim = Simulation(shapes, params, neighbor_mode=mode, k_max=4,
                     group_fixes=fixes, group_tab=group_tab,
                     conservative=False, device="cpu")
    state = tscen.make_state(x, [-8] * 3, [8] * 3,
                             v=rng.normal(size=(n, 3)) * 0.1, device="cpu")
    state, neigh = sim.init_neighbors(state.replace(tag=torch.as_tensor(tags)))
    sweep = ens.with_param_sweep(
        sim.params, dt=[1e-4, 2e-4, 3e-4],
        gravity=[[0, 0, -10.0], [0, 0, -40.0], [5.0, 0, -20.0]])
    states, _, _ = _assert_replicas_are_solo_runs(sim, state, neigh, sweep,
                                                  100, rebuilds_differ=False)
    frozen = [int(np.nonzero(tags == t)[0][0]) for t in (1, 2, 3)]
    assert torch.equal(states.v[:, frozen], ens.replicate(state, 3).v[:, frozen])


@pytest.mark.parametrize("case", ["two_body", "deposition"])
def test_single_replica_is_step_bit_for_bit(case):
    """R = 1 through ``run_replicas`` equals ``Simulation.step`` n times
    (the dense allpairs path; the pair-list path with walls)."""
    if case == "two_body":
        sim, state, neigh = tscen.two_body_collision(gamma_n=20.0,
                                                     device="cpu")
        steps = 300
    else:
        sim, st0, _ = tscen.deposition(n=64, lmax=2, device="cpu")
        state, neigh = sim.init_neighbors(drum_state(sim, st0, CPU))
        steps = 10
    states, neighs = ens.run_replicas(
        sim, ens.replicate(state, 1), ens.replicate(neigh, 1),
        ens.replicate(sim.params, 1), steps)
    for _ in range(steps):
        state, neigh = sim.step(state, neigh)
    for obj, solo in ((states, state), (neighs, neigh)):
        for name in _fields(solo):
            assert torch.equal(getattr(obj, name)[0], getattr(solo, name)), name


def test_overflow_stays_in_its_replica():
    """Two distinct starts stacked (the builder's loose packing and the
    contact-rich one) with a pair capacity between their candidate
    counts: replica 1's channel carries its count, replica 0's stays 0
    and its list equals its own build; the validate helpers report per
    replica."""
    sim, st0, _ = tscen.deposition(n=128, lmax=2, device="cpu")
    starts = [st0, drum_state(sim, st0, CPU)]
    sizes = [int(sim.init_neighbors(st)[1].pair_valid.sum()) for st in starts]
    assert sizes[1] > sizes[0]
    sim.pair_capacity = (sizes[0] + sizes[1]) // 2
    _, ng0 = sim.init_neighbors(starts[0])
    stacked = copy.copy(sim)
    stacked.params = ens.replicate(sim.params, 2)
    states, neighs = stacked.init_neighbors(ens.stack_replicas(starts))
    assert neighs.overflow.tolist() == [0, sizes[1]]
    assert int(neighs.pair_valid[1].sum()) == sim.pair_capacity
    for name in ("pair_i", "pair_j", "pair_valid", "pair_hist"):
        assert torch.equal(getattr(neighs, name)[0], getattr(ng0, name)), name
    report = validate.audit_capacities(sim, neighs)
    assert report["overflow_channel"] == [(0, 0), (sizes[1], 0)]
    with pytest.raises(RuntimeError, match=rf"\{{1: {sizes[1]}\}}"):
        validate.assert_no_overflow(sim, neighs)
    validate.check_finite(states, "stacked")
    bad = states.replace(v=states.v.clone())
    bad.v[1, 3, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"'v': \[0, 1\]"):
        validate.check_finite(bad, "poisoned")


def _replica_pairs(R, conservative, seed=3, n=10, lmax=4):
    """All ordered pairs of n particles in a small box, packed once a
    replica with that replica's materials (kn, mu, gamma_n scaled) and
    dt: rows [R * P, 64] replica-major and par [R, 16]."""
    rng = np.random.default_rng(seed)
    shapes = shapes_library.build_shapes(blob_coeffs(lmax, 2, seed), lmax,
                                         contact_quad=(8, 16), device="cpu")
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    st = tscen.make_state(
        rng.uniform(0.7, 2.3, (n, 3)), [0, 0, 0], [4, 4, 4], q=q,
        v=rng.normal(size=(n, 3)) * 0.2, angmom=rng.normal(size=(n, 3)) * 0.02,
        scale=rng.uniform(0.85, 1.15, n), shtype=rng.integers(0, 2, n),
        device="cpu")
    pi, pj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sel = pi.ravel() != pj.ravel()
    pi, pj = torch.tensor(pi.ravel()[sel]), torch.tensor(pj.ravel()[sel])
    mask = torch.tensor(rng.uniform(size=pi.shape[0]) > 0.05)
    hist = torch.tensor(rng.normal(size=(pi.shape[0], 6)).astype(np.float32)
                        * 1e-4)
    base = tstate.SimParams.create(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4,
                                   k_roll=2e4, gamma_roll=10.0, mu_roll=0.2,
                                   cutoff=1.4, skin=0.2, device="cpu")
    params = ens.with_param_sweep(
        base, dt=[1e-4 * (r + 1) for r in range(R)],
        kn=[1e5 * (1 + r) for r in range(R)],
        mu=[0.2 + 0.2 * r for r in range(R)],
        gamma_n=[10.0 + 10 * r for r in range(R)])
    stacked = lambda t: t.expand((R,) + t.shape)
    packed, tbl, cap, par = ck.pack_pairs(
        ens.replicate(st, R), shapes, params, stacked(pi), stacked(pj),
        stacked(mask), stacked(hist), stacked(st.x[pj] - st.x[pi]))
    return packed, tbl, cap, par, lmax, params


@pytest.mark.parametrize("conservative", [False, True],
                         ids=["geometric", "conservative"])
def test_batched_pair_twin_is_per_replica_calls(conservative):
    """The pair twin over R = 4 replicas' rows, each reading its own par
    row, equals one call a replica; so does the CPU wrapper."""
    R = 4
    packed, tbl, cap, par, lmax, params = _replica_pairs(R, conservative)
    assert par.shape == (R, ck.N_PAR)
    np.testing.assert_array_equal(np32(par[:, 0]), np32(params.dt))
    out = ck.pair_contact_plain(packed, tbl, cap, par, lmax, conservative)
    via = ck.pair_contact(packed, tbl, cap, par, lmax, conservative)
    P = packed.shape[0] // R
    contacts = []
    for r in range(R):
        blk = slice(r * P, (r + 1) * P)
        one = ck.pair_contact_plain(packed[blk], tbl, cap, par[r:r + 1], lmax,
                                    conservative)
        assert torch.equal(out[blk], one), f"replica {r}"
        assert torch.equal(via[blk], one), f"replica {r} (wrapper)"
        contacts.append(int((one[:, 16] > 0.5).sum()))
    assert min(contacts) > 5
    # The materials and dt reach the rows: the replicas' forces differ.
    assert not torch.equal(out[:P, 0:3], out[P:2 * P, 0:3])


@pytest.mark.parametrize("kind", ["plane", "cylinder"])
def test_batched_wall_twin_is_per_replica_calls(kind):
    """``pack_wall`` of a stacked state and params ([R * B, 32] rows, par
    [R, 24] with each replica's dt and materials) through the wall twin
    equals each replica packed and run alone."""
    from spherharm_tpu_torch.ops import walls as walls_mod

    R, n, lmax = 3, 40, 4
    rng = np.random.default_rng(5)
    shapes = shapes_library.build_shapes(blob_coeffs(lmax, 2), lmax,
                                         device="cpu")
    x = rng.uniform(0.8, 5.2, (n, 3))
    x[:, 2] = rng.uniform(0.25, 1.6, n)
    if kind == "plane":
        wall = walls_mod.PlaneWall.create([0, 0, 0.5], [0, 0, 1],
                                          velocity=[0.1, 0, 0], device="cpu")
    else:
        rel = x[:, :2] - 3.0
        x[:, :2] = 3.0 + rel / np.linalg.norm(rel, axis=1, keepdims=True) \
            * rng.uniform(2.2, 2.85, n)[:, None]
        wall = walls_mod.CylinderWall.create([3, 3, 0], [0, 0, 1], 2.8,
                                             omega=0.7, device="cpu")
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    st = tscen.make_state(x, [0, 0, 0], [6, 6, 6], q=q,
                          v=rng.normal(size=(n, 3)) * 0.3,
                          angmom=rng.normal(size=(n, 3)) * 0.05,
                          scale=rng.uniform(0.85, 1.15, n),
                          shtype=rng.integers(0, 2, n), device="cpu")
    base = tstate.SimParams.create(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4,
                                   k_roll=2e4, gamma_roll=10.0, mu_roll=0.2,
                                   device="cpu")
    params = ens.with_param_sweep(base, dt=[1e-4, 2e-4, 4e-4],
                                  kn=[1e5, 3e5, 5e5], mu=[0.1, 0.4, 0.9])
    hist = torch.tensor(rng.normal(size=(n, 6)).astype(np.float32) * 1e-4)
    om = omega_from_angmom(st.q, st.angmom, shapes.inertia_of(st.shtype,
                                                              st.scale))
    depth_c, n_c = wall.depth_and_normal(st.x)
    stacked = lambda t: t.expand((R,) + t.shape)
    packed, tbl, cap, par, k = wk.pack_wall(
        ens.replicate(st, R), shapes, params, wall, stacked(hist),
        stacked(depth_c), stacked(n_c), stacked(om))
    assert k == kind and packed.shape == (R * n, wk.F_WALL)
    assert par.shape == (R, wk.N_PAR_WALL)
    out = wk.wall_contact_kernel(packed, tbl, cap, par, lmax, kind)
    for r in range(R):
        args = wk.pack_wall(st, shapes, ens.replica(params, r), wall, hist,
                            depth_c, n_c, om)
        one = wk.wall_contact_plain(*args[:4], lmax, kind)
        assert torch.equal(out[r * n:(r + 1) * n], one), f"replica {r}"
    assert int((out[:, 13] > 0.5).sum()) > 3 * R
    assert not torch.equal(out[:n, 0:3], out[n:2 * n, 0:3])
