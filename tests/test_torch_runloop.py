"""The run loops of the torch port (``Simulation.run`` / ``run_inline``,
``parallel/ensemble.run_replicas``) and the helpers it shares with the
JAX package, on the CPU.

* The step is split into units (``_pre``, ``_rebuild_always`` /
  ``_rebuild_stale``, ``_post``) that the card replays as CUDA graphs;
  on the CPU ``run`` calls them eagerly and equals a loop of the
  monolithic step they were cut from (``_monolithic_step`` below, the
  step as it stood before the split), bit for bit, in every field: the
  static cadence, the skin trigger, static neighbour mode and an R = 3
  ensemble.
* ``run_inline`` against the JAX package's ``run_inline`` on an n = 64
  drum, at the drum parity test's tolerances (tests/test_torch_drum.py).
* Mirrors of tests/test_cadence.py's two tests, port against port as the
  reference's are, with their steps cut (400 and 800 there, ``slow``
  tests) to fit the fast tier, and of tests/test_prefilter.py's
  rotation-aware trigger on the port's ``max_approach``.
* The quaternion helpers, ``max_approach`` and the container properties
  against the JAX functions on seeded numpy inputs.

The graph runs themselves need the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherharm_tpu.core import state as jstate
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.models import shapes_library as jshapes
from spherharm_tpu.ops import neighbor as jneighbor
from spherharm_tpu.ops import rotation as jrot
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.core.simulation import Simulation, _keep
from spherharm_tpu_torch.models import scenarios as tscen
from spherharm_tpu_torch.models import shapes_library as tshapes
from spherharm_tpu_torch.ops import integrate, neighbor
from spherharm_tpu_torch.ops import rotation as trot
from spherharm_tpu_torch.parallel import ensemble as ens
from spherharm_tpu_torch.utils import validate

from torch_port_util import contact_rich_state, drum_state, np32, to_torch

CPU = torch.device("cpu")


def _monolithic_step(sim, state, neigh, rebuild):
    """The step before its split into units, kept as the reference of the
    split: one velocity-Verlet step; with replicas, 'check' reads "any
    replica stale" on the host, rebuilds all and keeps the rebuild for
    the stale replicas only."""
    state = integrate.initial_integrate(state, sim.shapes, sim.params)
    state, x_build, _ = integrate.apply_deformation(
        state, neigh.x_build, sim.params, sim.periodic)
    neigh = neigh.replace(x_build=x_build)
    if sim.triclinic:
        L = state.box_hi - state.box_lo
        bound = 0.5 * torch.stack([L[..., 0], L[..., 0], L[..., 1]], dim=-1)
        bad = (state.tilt.abs() > bound * (1 + 1e-6)).any(-1)
        neigh = neigh.replace(overflow=torch.maximum(
            neigh.overflow, torch.where(
                bad, 1 << 21, torch.zeros_like(neigh.overflow))))
    if rebuild == "always":
        viol = sim._stale(state, neigh).long()
        state, neigh = sim._rebuild(state, neigh)
        neigh = neigh.replace(skin_violations=neigh.skin_violations + viol)
    elif rebuild == "check":
        stale = sim._stale(state, neigh)
        if bool(stale.any()):
            new_state, new_neigh = sim._rebuild(state, neigh)
            if stale.dim():
                state = _keep(stale, new_state, state)
                neigh = _keep(stale, new_neigh, neigh)
            else:
                state, neigh = new_state, new_neigh
    state, neigh, aux = sim.compute_forces(state, neigh)
    state = integrate.final_integrate(state, sim.shapes, sim.params)
    if sim.press_control:
        state, x_build = integrate.berendsen_box_control(
            state, neigh.x_build, sim.params, aux["virial"], sim.shapes)
        neigh = neigh.replace(x_build=x_build)
    return state, neigh


def _monolithic_run(sim, state, neigh, steps):
    """The old ``run``: cadence blocks with R > 0, else the check step."""
    R = 0 if sim.neighbor_mode == "static" else sim.rebuild_every
    if R <= 0:
        kind = "never" if sim.neighbor_mode == "static" else "check"
        kinds = [kind] * steps
    else:
        n_blocks, rem = divmod(steps, R)
        kinds = [("always" if k == 0 else "never")
                 for length in [R] * n_blocks + ([rem] if rem else [])
                 for k in range(length)]
    rebuilds = 0
    for kind in kinds:
        x_build = neigh.x_build
        state, neigh = _monolithic_step(sim, state, neigh, kind)
        rebuilds += kind == "always" or (
            kind == "check" and not torch.equal(neigh.x_build, x_build))
    return state, neigh, rebuilds


def _small_drum(rebuild_every, skin=None):
    """The conservative drum at n = 64, Lmax 2, with the prefilter (pair
    cap 5n, stage-2 cap 3n) from a contact-rich start."""
    sim, st0, _ = tscen.rotating_drum(
        n=64, lmax=2, k_max=24, pair_capacity=320, stage2_capacity=192,
        rebuild_every=rebuild_every, device="cpu")
    if skin is not None:
        sim.params = sim.params.replace(skin=torch.tensor(skin))
    return (sim,) + sim.init_neighbors(drum_state(sim, st0, CPU))


def _static_pair():
    """The two-body head-on collision (Lmax 0 spheres) in static
    neighbour mode, the gap closing after ~25 steps."""
    sim, st, _ = tscen.two_body_collision(v0=2.0, gap=0.02, device="cpu")
    static = Simulation(sim.shapes, sim.params, neighbor_mode="static",
                        k_max=1, device="cpu")
    return (static,) + static.init_neighbors(st)


def _ensemble():
    sim, st, ng = _small_drum(0, skin=0.004)
    params = ens.with_param_sweep(sim.params, gamma_n=[10.0, 50.0, 200.0],
                                  dt=[1e-4, 2e-4, 3e-4],
                                  skin=[0.004, 0.008, 0.016])
    return sim, ens.replicate(st, 3), ens.replicate(ng, 3), params


# (case, steps): the cadence takes 2 blocks of R = 3 and a remainder of 2;
# the skin trigger a skin of 0.004, so the drum rebuilds within 24 steps;
# the static pair runs through its contact.
RUN_CASES = [("cadence", 8), ("check", 24), ("static", 40), ("ensemble", 8)]


@pytest.mark.parametrize("case,steps", RUN_CASES,
                         ids=[c for c, _ in RUN_CASES])
def test_run_equals_monolithic_step_loop(case, steps):
    """``run`` (``run_replicas`` for the ensemble) through the units
    equals the monolithic step's loop bit for bit, every State and
    NeighborState field, with at least one rebuild in the window."""
    if case == "ensemble":
        sim, st, ng, params = _ensemble()
        got = ens.run_replicas(sim, st, ng, params, steps)
        want = _monolithic_run(ens._rebind(sim, params), st, ng, steps)
    else:
        sim, st, ng = {"cadence": lambda: _small_drum(3),
                       "check": lambda: _small_drum(0, skin=0.004),
                       "static": _static_pair}[case]()
        got = sim.run(st, ng, steps)
        want = _monolithic_run(sim, st, ng, steps)
    assert validate.bitwise_differences(got, want[:2]) == {}
    assert int(got[0].step.reshape(-1)[0]) == int(st.step.reshape(-1)[0]) + steps
    if case != "static":
        assert want[2] >= 1
        assert bool((got[1].overflow == 0).all())
    else:
        assert float(sim.thermo(*got)["pe_pair"]) > 0.0


def test_run_inline_matches_reference():
    """``run_inline`` (``step`` n times whatever the cadence: here the
    drum's R = 20 is ignored and the prefilter's trigger decides) against
    the JAX package's ``run_inline`` on the n = 64 Lmax 2 conservative
    drum from the same contact-rich numpy state, 12 steps, with the skin
    cut to 0.004 on both sides so the trigger fires: thermo within rtol
    2e-3, positions within 1e-3 (tests/test_torch_drum.py's bounds)."""
    kw = dict(n=64, lmax=2, k_max=24, pair_capacity=320,
              stage2_capacity=192, rebuild_every=20, conservative=True)
    jsim, jst0, _ = jscen.rotating_drum(use_pallas=True, exact_eval=True,
                                        **kw)
    tsim, _, _ = tscen.rotating_drum(device="cpu", **kw)
    jsim.params = jsim.params.replace(skin=jnp.float32(0.004))
    tsim.params = tsim.params.replace(skin=torch.tensor(0.004))
    R = float(jsim.walls[0].radius)
    L = float(jsim.walls[2].point[1] - jsim.walls[1].point[1])
    shtype = np.asarray(jst0.shtype)
    scale = np.asarray(jst0.scale, np.float64)
    radius = np.asarray(jsim.shapes.rchar, np.float64)[shtype] * scale
    x, angmom = contact_rich_state(np.asarray(jst0.x), radius, R, L)
    skw = dict(q=np.asarray(jst0.q), angmom=angmom, scale=scale,
               shtype=shtype)
    box = (np.asarray(jst0.box_lo), np.asarray(jst0.box_hi))

    js, jn = jsim.init_neighbors(jscen.make_state(x, *box, **skw))
    js, jn = jax.jit(lambda s, n: jsim.run_inline(s, n, 12))(js, jn)
    jth = {k: float(v) for k, v in jsim.thermo(js, jn).items()
           if np.ndim(v) == 0}
    ts, tn = tsim.init_neighbors(tscen.make_state(x, *box, device="cpu",
                                                  **skw))
    x_build = tn.x_build
    ts, tn = tsim.run_inline(ts, tn, 12)
    tth = {k: float(v) for k, v in tsim.thermo(ts, tn).items()
           if v.ndim == 0}
    assert not torch.equal(tn.x_build, x_build)  # the trigger fired
    assert int(tth["step"]) == int(jth["step"]) == 12
    assert int(tn.overflow) == int(jn.overflow) == 0
    assert tth["pe_pair"] > 0 and tth["pe_wall"] > 0
    for k in ("ke", "erot", "pe_pair", "pe_wall", "pe_grav", "etot"):
        np.testing.assert_allclose(tth[k], jth[k], rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(np32(ts.x), np.asarray(js.x), rtol=0,
                               atol=1e-3)


def test_cadence_matches_triggered():
    """tests/test_cadence.py's: the Verlet-list guarantee makes forces
    independent of rebuild timing, so the skin-triggered run and the
    R = 10 cadence agree while no skin violation occurred (100 steps,
    400 in the reference's slow test)."""
    kw = dict(n=64, lmax=4, dt=1e-4, k_max=16, drum_omega=0.3,
              n_shape_types=2, contact_quad=(8, 16), pair_capacity=1024,
              drum_radius_factor=8.0, conservative=False, device="cpu")
    sim_a, s_a, n_a = tscen.rotating_drum(**kw)
    sim_b, s_b, n_b = tscen.rotating_drum(**kw, rebuild_every=10)
    s_a, n_a = sim_a.run(s_a, n_a, 100)
    s_b, n_b = sim_b.run(s_b, n_b, 100)
    assert int(n_b.skin_violations) == 0
    np.testing.assert_allclose(np32(s_a.x), np32(s_b.x), atol=1e-5)
    np.testing.assert_allclose(np32(s_a.v), np32(s_b.v), atol=1e-4)


def test_cadence_detects_skin_violation():
    """tests/test_cadence.py's: a cadence far too long for a fast system
    raises the violation counter (detection without branching). Cut from
    R = 400 over 800 steps to R = 40 over 80: the scheduled rebuild at
    step 40 already finds particles beyond skin/2."""
    kw = dict(n=64, lmax=2, dt=1e-3, k_max=16, drum_omega=2.0,
              n_shape_types=1, contact_quad=(6, 12), pair_capacity=1024,
              drum_radius_factor=8.0, conservative=False, device="cpu")
    sim, state, neigh = tscen.rotating_drum(**kw, rebuild_every=40)
    rng = np.random.default_rng(0)
    state = state.replace(v=torch.tensor(
        rng.normal(size=(state.cap, 3)) * 2.0, dtype=torch.float32))
    state, neigh = sim.run(state, neigh, 80)
    assert int(neigh.skin_violations) > 0


def test_rotation_aware_trigger():
    """tests/test_prefilter.py's on the port's ``max_approach``: it grows
    with pure rotation (no displacement) scaled by gmax; spheres
    (gmax = 0) are immune; and gmax * alpha bounds the radial surface
    change of a spinning ellipsoid."""
    lmax = 4
    shapes = tshapes.build_shapes(
        [tshapes.ellipsoid_coeffs(0.7, 0.45, 0.45, lmax),
         tshapes.sphere_coeffs(0.5, lmax)], lmax, device="cpu")
    x = torch.tensor([[1.0, 1.0, 1.0], [3.0, 1.0, 1.0]])
    q0 = torch.tensor([[1.0, 0, 0, 0], [1.0, 0, 0, 0]])
    alpha = 0.3
    qrot = torch.tensor([[np.cos(alpha / 2), 0.0, 0.0, np.sin(alpha / 2)],
                         [1.0, 0, 0, 0]], dtype=torch.float32)
    active = torch.tensor([True, True])
    for types, expect_growth in (([0, 0], True), ([1, 1], False)):
        appr = neighbor.max_approach(
            x, x, qrot, q0, shapes.gmax[torch.tensor(types)], active,
            torch.zeros(3), torch.full((3,), 10.0), (False,) * 3)
        if expect_growth:
            assert float(appr) == pytest.approx(
                float(shapes.gmax[0]) * alpha, rel=1e-4)
        else:
            assert float(appr) < 1e-6
    r_of = lambda a: 1.0 / np.sqrt((np.cos(a) / 0.7) ** 2
                                   + (np.sin(a) / 0.45) ** 2)
    assert float(shapes.gmax[0]) * alpha >= abs(r_of(0.0) - r_of(alpha))


# -- helpers against the JAX package -------------------------------------

def _unit(rng, shape):
    v = rng.normal(size=shape)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _helper_case(name, rng):
    """(port value, JAX value, rtol, atol) of one helper on seeded inputs
    ([5, 7] batches of quaternions, axes, angles and unit vectors)."""
    q = _unit(rng, (5, 7, 4))
    if name == "quat_conjugate":
        return trot.quat_conjugate(torch.tensor(q)), jrot.quat_conjugate(q), 0, 0
    if name == "quat_to_matrix":
        return trot.quat_to_matrix(torch.tensor(q)), jrot.quat_to_matrix(q), 0, 1e-6
    if name == "quat_from_axis_angle":
        axis = _unit(rng, (5, 7, 3))
        ang = rng.uniform(-np.pi, np.pi, (5, 7)).astype(np.float32)
        return (trot.quat_from_axis_angle(torch.tensor(axis), torch.tensor(ang)),
                jrot.quat_from_axis_angle(axis, ang), 0, 1e-6)
    if name == "angles_from_unit":
        u = _unit(rng, (5, 7, 3))
        u[0, 0] = (0.0, 0.0, 1.0)  # the pole and phi's branch cut
        u[0, 1] = (-1.0, 0.0, 0.0)
        return (torch.stack(trot.angles_from_unit(torch.tensor(u))),
                jnp.stack(jrot.angles_from_unit(u)), 0, 2e-6)
    assert name == "max_approach"
    n = 40
    x_build = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    x = (x_build + rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
    q, q_build = _unit(rng, (n, 4)), _unit(rng, (n, 4))
    gmax = rng.uniform(0, 0.3, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.2
    box = (np.zeros(3, np.float32), np.full(3, 4.0, np.float32))
    periodic = (True, False, True)
    t = lambda a: torch.tensor(a)
    return (neighbor.max_approach(t(x), t(x_build), t(q), t(q_build), t(gmax),
                                  t(active), t(box[0]), t(box[1]), periodic),
            jneighbor.max_approach(x, x_build, q, q_build, gmax, active,
                                   *box, periodic), 1e-6, 0)


HELPERS = ["quat_conjugate", "quat_to_matrix", "quat_from_axis_angle",
           "angles_from_unit", "max_approach"]


@pytest.mark.parametrize("name", HELPERS)
def test_helper_matches_reference(name):
    """Each helper on seeded numpy inputs, cast to f32 on both sides: the
    conjugate exact, the rest within a few f32 ulps."""
    got, ref, rtol, atol = _helper_case(name, np.random.default_rng(5))
    ref = np.asarray(ref)
    assert np32(got).shape == ref.shape
    np.testing.assert_allclose(np32(got), ref, rtol=rtol, atol=atol)


def test_container_properties_match_reference():
    """``Shapes.n_nodes``, ``NeighborState.k_max`` and ``pair_cap`` equal
    the reference's on its own containers crossed over, and read the
    replica-stacked form too."""
    shp = jshapes.build_shapes([jshapes.sphere_coeffs(0.5, 2)], 2,
                               contact_quad=(6, 12))
    tshp = tshapes.build_shapes([tshapes.sphere_coeffs(0.5, 2)], 2,
                                contact_quad=(6, 12), device="cpu")
    assert tshp.n_nodes == shp.n_nodes
    jn = jstate.empty_neighbors(12, 5, 2, pair_cap=40)
    tn = to_torch(tstate.NeighborState, jn)
    assert (tn.k_max, tn.pair_cap) == (jn.k_max, jn.pair_cap) == (5, 40)
    stacked = ens.replicate(tn, 3)
    assert (stacked.k_max, stacked.pair_cap) == (5, 40)
