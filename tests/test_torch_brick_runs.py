"""The brick decomposition of the torch port (``parallel/brick.py``) against
its own single-box runs and its slabs, on the CPU: mirrors of the
reference's tests/test_brick.py (all 7) and of the brick leg of
tests/test_sharded_stress.py, with the reference's bounds (x within 2e-3,
v within 5e-3, ke and etot within rel 1e-3 unless a test says otherwise);
then what the port adds: a starved ``migrate_cap``, every ValueError of
the reference's class, the prefilter on a brick, ``dryrun_brick``. The
card's own checks (graph run vs eager run, ``rebalance`` capturing
nothing) are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.core.state import SimParams
from spherharm_tpu_torch.models import scenarios
from spherharm_tpu_torch.ops.neighbor import CellGrid
from spherharm_tpu_torch.parallel.brick import (Brick2DSimulation,
                                                 BrickSimulation)
from spherharm_tpu_torch.parallel.dryrun import dryrun_brick
from spherharm_tpu_torch.parallel.halo import ShardedSimulation, balance_fracs

from test_torch_halo_runs import (PER, _setup, _shapes, _single,
                                  assert_same_by_tag)
from torch_port_util import np32


def _brick(shapes, params, box, mesh_shape=(2, 2), cls=BrickSimulation,
           **kw):
    base = dict(mesh_shape=mesh_shape, box_lo=(0, 0, 0),
                box_hi=(box, box, box), cap_local=96, halo_cap=64,
                migrate_cap=24, periodic=PER, k_max=24, cell_cap=12,
                pair_capacity=768, conservative=False, device="cpu")
    base.update(kw)
    return cls(shapes, params, **base)


def _bricks_of(sim, state):
    """{tag: mesh coordinates} of a brick state's active slots."""
    tag, act = np32(state.tag), np32(state.active)
    return {int(t): np.unravel_index(p, sim.axis.shape)
            for p in range(sim.n_shards) for t in tag[p][act[p]]}


@pytest.mark.parametrize("mesh_shape,seed", [((2, 2), 0), ((2, 2, 2), 7)],
                         ids=["brick2d", "brick3d"])
def test_brick_matches_single_device(mesh_shape, seed):
    """The 2x2 and 2x2x2 bricks == the single box per tag after 120 steps,
    cross-corner contacts and migration over every axis included."""
    shapes, params, state0, box = _setup(n=96, seed=seed)
    sim1 = _single(shapes, params, box)
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, 120)
    t1 = sim1.thermo(s1, n1)
    cls = Brick2DSimulation if len(mesh_shape) == 2 else BrickSimulation
    sim = _brick(shapes, params, box, mesh_shape, cls)
    s, ng, gh = sim.init(state0)
    s, ng, gh = sim.run(s, ng, gh, 120)
    t = sim.thermo(s, ng, gh)
    assert int(t["neigh_overflow"]) == 0
    assert_same_by_tag(s1, s, L=box)
    assert float(t["ke"]) == pytest.approx(float(t1["ke"]), rel=1e-3)
    assert float(t["etot"]) == pytest.approx(float(t1["etot"]), rel=1e-3)


def test_brick2d_migration_both_axes():
    """A strong drift along x AND y crosses brick boundaries along both
    (diagonally too); none lost or duplicated, every brick owns some, and
    ``gather_global`` collects them all."""
    shapes, params, state0, box = _setup(n=64, seed=2)
    state0 = state0.replace(v=state0.v + torch.tensor([2.0, 1.5, 0.0]))
    sim = _brick(shapes, params, box, cls=Brick2DSimulation, cap_local=64,
                 halo_cap=48, migrate_cap=32, pair_capacity=512)
    s, ng, gh = sim.init(state0)
    start = _bricks_of(sim, s)
    for _ in range(6):
        s, ng, gh = sim.run(s, ng, gh, 100)
    end = _bricks_of(sim, s)
    assert sorted(end) == sorted(start) == list(range(1, 65))
    assert int(ng.overflow.max()) == 0
    moved = np.array([np.array(start[t]) != np.array(end[t]) for t in start])
    assert moved.any(0).all() and (moved.sum(1) == 2).any()
    assert len(set(end.values())) == 4
    g = sim.gather_global(s)  # the bricks' slots, brick-major, on the host
    assert g.x.shape == (4 * 64, 3) and g.x.device.type == "cpu"
    assert sorted(np32(g.tag)[np32(g.active)]) == list(range(1, 65))


def test_brick_weighted_bounds_clustered():
    """Weighted per-axis bounds (``balance_fracs`` on x and y): a
    corner-clustered gas fits a cap_local that uniform 2x2 bricks would
    overflow, and matches the single box per tag."""
    rng = np.random.default_rng(11)
    shapes = _shapes()
    box, n = 12.0, 96
    x = np.empty((n, 3))
    x[:72] = rng.uniform(0.5, 4.5, (72, 3))
    x[72:] = rng.uniform(0.5, box - 0.5, (n - 72, 3))
    v = rng.normal(size=(n, 3)) * 0.4
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3, device="cpu")
    state0 = scenarios.make_state(x, [0, 0, 0], [box] * 3, v=v, device="cpu")
    grid = CellGrid([0, 0, 0], [box] * 3, 1.5, PER)
    sim1 = Simulation(shapes, params, periodic=PER, grid=grid, k_max=24,
                      cell_cap=12, pair_capacity=1024, conservative=False,
                      device="cpu")
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, 60)
    min_frac = float(params.cutoff + params.skin) / box
    bounds = {ax: balance_fracs(state0, 2, min_frac=min_frac, axis=d)
              for d, ax in enumerate("xy")}
    assert bounds["x"][1] < 0.45 and bounds["y"][1] < 0.45
    kw = dict(box_hi=(box,) * 3, cap_local=48, halo_cap=48, migrate_cap=24,
              cell_cap=36, pair_capacity=512)
    with pytest.raises(ValueError, match="cap_local"):
        _brick(shapes, params, box, **kw).distribute(state0)
    sim = _brick(shapes, params, box, bounds_frac=bounds, **kw)
    s, ng, gh = sim.init(state0)
    s, ng, gh = sim.run(s, ng, gh, 60)
    t = sim.thermo(s, ng, gh)
    assert int(t["neigh_overflow"]) == 0 and int(t["n"]) == n
    t1 = sim1.thermo(s1, n1)
    assert float(t["ke"]) == pytest.approx(float(t1["ke"]), rel=1e-3)
    assert float(t["etot"]) == pytest.approx(float(t1["etot"]), rel=1e-3)
    assert_same_by_tag(s1, s, x_tol=5e-3, v_tol=np.inf, L=box)


def test_brick2d_gather_restart_roundtrip():
    """``gather_restart`` and ``init(restart=...)`` (the slabs', inherited)
    resume a 2x2 brick run from a checkpoint: it matches the
    uninterrupted run."""
    shapes, params, state0, box = _setup(n=48, seed=5)
    kw = dict(cls=Brick2DSimulation, cap_local=48, halo_cap=32,
              migrate_cap=16, k_max=16, cell_cap=10, pair_capacity=384)
    sim = _brick(shapes, params, box, **kw)
    s, ng, gh = sim.init(state0)
    s, ng, gh = sim.run(s, ng, gh, 150)
    gstate, payload = sim.gather_restart(s, ng)
    sim2 = _brick(shapes, params, box, **kw)
    s2, n2, g2 = sim2.init(gstate, restart=payload)
    s, ng, gh = sim.run(s, ng, gh, 150)
    s2, n2, g2 = sim2.run(s2, n2, g2, 150)
    assert_same_by_tag(s, s2, v_tol=np.inf, L=box)


def test_brick_inrun_rebalance():
    """``rebalance`` moves the bounds of each pack, migrates ownership in
    one forced rebuild, touches no captured graph, and the trajectory
    stays the single box's."""
    shapes, params, state0, box = _setup(n=64, seed=9)
    sim1 = _single(shapes, params, box)
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, 100)
    sim = _brick(shapes, params, box, migrate_cap=32)
    s, ng, gh = sim.init(state0)
    s, ng, gh = sim.run(s, ng, gh, 50)
    graphs = dict(sim._graphs)
    before = [np32(g.fracs).copy() for g in gh]
    s, ng, gh = sim.rebalance(s, ng, gh)
    assert any(not np.allclose(a, np32(g.fracs)) for a, g in zip(before, gh))
    assert sim._graphs == graphs
    s, ng, gh = sim.run(s, ng, gh, 50)
    assert int(sim.thermo(s, ng, gh)["neigh_overflow"]) == 0
    assert_same_by_tag(s1, s, x_tol=3e-3, v_tol=5e-3)


def test_brick_triclinic_matches_single():
    """A statically tilted periodic cell (xy 1.2) over a 2x2 brick == the
    single box: the y seam's ghost shift carries the tilt (the full cell
    vector) and raw-coordinate membership reaches through the pads."""
    rng = np.random.default_rng(12)
    shapes = _shapes()
    box, n, tilt = 8.0, 72, (1.2, 0.0, 0.0)
    side = int(np.ceil(n ** (1 / 3)))
    pitch = box / side
    i = np.arange(n)
    x = np.stack([(i % side + 0.5) * pitch, ((i // side) % side + 0.5) * pitch,
                  (i // side**2 + 0.5) * pitch], axis=1)
    x = x + rng.uniform(-0.06, 0.06, (n, 3))
    v = rng.normal(size=(n, 3)) * 0.5
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3, device="cpu")
    state0 = scenarios.make_state(x, [0, 0, 0], [box] * 3, v=v, q=q,
                                  tilt=tilt, device="cpu")
    grid = CellGrid([0, 0, 0], [box] * 3, 1.5 * 1.4, PER)
    sim1 = Simulation(shapes, params, periodic=PER, grid=grid, k_max=24,
                      cell_cap=16, pair_capacity=1024, triclinic=True,
                      conservative=False, device="cpu")
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, 120)
    sim = _brick(shapes, params, box, halo_cap=72, migrate_cap=32,
                 cell_cap=16, triclinic=True, tilt_pad=1.3)
    s, ng, gh = sim.init(state0)
    s, ng, gh = sim.run(s, ng, gh, 120)
    t = sim.thermo(s, ng, gh)
    assert int(t["neigh_overflow"]) == 0
    assert_same_by_tag(s1, s, x_tol=3e-3, v_tol=np.inf)
    t1 = sim1.thermo(s1, n1)
    assert float(t["etot"]) == pytest.approx(float(t1["etot"]), rel=2e-3)


def _gas(n, box, seed=0, drift=0.0):
    """tests/test_sharded_stress.py's dense periodic ellipsoid gas."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / 3)))
    pitch = box / side
    i = np.arange(n)
    x = np.stack([(i % side + 0.5) * pitch, ((i // side) % side + 0.5) * pitch,
                  (i // side**2 + 0.5) * pitch], axis=1)
    x = x + rng.uniform(-0.06, 0.06, (n, 3)) * pitch
    v = rng.normal(size=(n, 3)) * 0.5
    v[:, 0] += drift
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3, device="cpu")
    return params, scenarios.make_state(x, [0, 0, 0], [box] * 3, v=v, q=q,
                                        device="cpu")


def test_brick_vs_slab_vs_single_long_horizon():
    """One gas, three decompositions (single box, 8 slabs, a 2x2x2 brick),
    200 steps: the same per-tag trajectories within 8e-3 and zero
    overflow everywhere."""
    n, box, steps = 512, 12.0, 200
    params, state0 = _gas(n, box, seed=11, drift=0.5)
    shapes = _shapes()
    grid = CellGrid([0, 0, 0], [box] * 3, 1.5, PER)
    sim1 = Simulation(shapes, params, periodic=PER, grid=grid, k_max=24,
                      cell_cap=16, pair_capacity=8192, conservative=False,
                      device="cpu")
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, steps)
    assert int(n1.overflow) == 0
    kw = dict(box_lo=(0, 0, 0), box_hi=(box,) * 3, cap_local=384,
              migrate_cap=96, periodic=PER, k_max=24, cell_cap=16,
              pair_capacity=2048, conservative=False, device="cpu")
    slabs = ShardedSimulation(shapes, params, n_shards=8, halo_cap=384, **kw)
    brick = BrickSimulation(shapes, params, mesh_shape=(2, 2, 2),
                            halo_cap=256, **kw)
    for sim in (slabs, brick):
        s, ng, gh = sim.init(state0)
        s, ng, gh = sim.run(s, ng, gh, steps)
        assert int(ng.overflow.max()) == 0
        assert_same_by_tag(s1, s, x_tol=8e-3, v_tol=np.inf, L=box)


def test_brick_migrate_cap_overflow_flags_loudly():
    """A starved migrate_cap fires the overflow channel, never drops
    particles silently."""
    params, state0 = _gas(128, 10.0, seed=7, drift=3.0)
    state0 = state0.replace(v=state0.v + torch.tensor([0.0, 3.0, 0.0]))
    sim = _brick(_shapes(), params, 10.0, (4, 2), cap_local=128,
                 halo_cap=128, migrate_cap=1, cell_cap=16,
                 pair_capacity=2048)
    s, ng, gh = sim.init(state0)
    s, ng, gh = sim.run(s, ng, gh, 80)
    assert int(ng.overflow.max()) != 0, (
        "starved migrate_cap did not flag through the overflow channel")


def test_brick_prefilter_matches_single_device():
    """The prefilter on a 2x2x2 brick (stage-2 pair lists, the slack
    maxima global over the bricks, the budget-ratio trigger under pmax)
    tracks the plain single-box run."""
    shapes, params, state0, box = _setup(n=72, seed=5)
    sim1 = _single(shapes, params, box)
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, 60)
    t1 = sim1.thermo(s1, n1)
    sim = _brick(shapes, params, box, (2, 2, 2), stage2_capacity=256)
    s, ng, gh = sim.init(state0)
    assert ng.pair_i.shape == (8, 256)
    s, ng, gh = sim.run(s, ng, gh, 60)
    t = sim.thermo(s, ng, gh)
    assert int(t["neigh_overflow"]) == 0
    assert_same_by_tag(s1, s, x_tol=3e-3, v_tol=5e-3)
    assert float(t["etot"]) == pytest.approx(float(t1["etot"]), rel=2e-3)


def _tilted(tilt):
    shapes, params, state0, box = _setup(n=48, seed=1)
    return shapes, params, state0.replace(
        tilt=torch.tensor(tilt, dtype=torch.float32)), box


BAD = {
    "mesh_1d": (dict(mesh_shape=(4,)), "2D/3D"),
    "mesh_4d": (dict(mesh_shape=(2, 2, 1, 1)), "2D/3D"),
    "mesh_zero": (dict(mesh_shape=(2, 0)), "2D/3D"),
    "tri_no_pad": (dict(triclinic=True), "tilt_pad"),
    "bounds_length": (dict(bounds_frac={"x": [0.0, 1.0]}), "bounds_frac"),
    "bounds_order": (dict(bounds_frac={"y": [0.0, 0.7, 0.6, 1.0]}),
                     "bounds_frac"),
    "bounds_ends": (dict(bounds_frac={"x": [0.1, 0.5, 1.0]}), "bounds_frac"),
    "bounds_axis": (dict(bounds_frac={"z": [0.0, 0.5, 1.0]}), "unknown axes"),
    "too_narrow": (dict(mesh_shape=(6, 2)), "narrowest brick"),
    "tilt_pad_narrow": (dict(triclinic=True, tilt_pad=3.0),
                        "narrowest brick"),
    "brick2d_3d": (dict(cls=Brick2DSimulation, mesh_shape=(2, 2, 2)),
                   "Brick2DSimulation"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_brick_constructor_refuses(case):
    kw, match = BAD[case]
    shapes, params, _, box = _setup(n=48, seed=1)
    with pytest.raises(ValueError, match=match):
        _brick(shapes, params, box, **kw)


@pytest.mark.parametrize("case", ["tilt_not_triclinic", "tilt_past_pad",
                                  "cap_local"])
def test_brick_distribute_refuses(case):
    tilt = (0.0, 0.0, 0.0) if case == "cap_local" else (0.9, 0.0, 0.0)
    shapes, params, state0, box = _tilted(tilt)
    kw = {"tilt_not_triclinic": {},
          "tilt_past_pad": dict(triclinic=True, tilt_pad={"x": 0.5}),
          "cap_local": dict(cap_local=4)}[case]
    match = {"tilt_not_triclinic": "triclinic=False",
             "tilt_past_pad": "exceeds tilt_pad",
             "cap_local": "brick .* cap_local"}[case]
    with pytest.raises(ValueError, match=match):
        _brick(shapes, params, box, **kw).distribute(state0)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 2, 2)],
                         ids=["brick2d", "brick3d"])
def test_dryrun_brick_cpu(mesh_shape):
    th = dryrun_brick(mesh_shape, device="cpu")
    assert int(th["n"]) == 16 * int(np.prod(mesh_shape))
    assert bool(torch.isfinite(th["etot"]))


def test_graph_runner_buffers_take_tuples_of_packs():
    """The graph runner's buffer helpers (``_tensors``, ``_map``,
    ``signature``) take the brick's ghosts, a tuple of GhostPacks: the
    tensors of every pack in order, clones with the tuple's structure,
    a signature that tells the packs apart."""
    from spherharm_tpu_torch.core import runner

    shapes, params, _, box = _setup(n=48, seed=1)
    sim = _brick(shapes, params, box, (2, 2, 2), halo_cap=8)
    gh = sim._fresh_ghosts(torch.float32)
    flat = runner._tensors(gh)
    assert len(flat) == sum(len(runner._tensors(g)) for g in gh) == 3 * 11
    assert all(a is b for a, b in zip(flat, [t for g in gh
                                             for t in runner._tensors(g)]))
    twin = runner._map(torch.clone, gh)
    assert isinstance(twin, tuple) and len(twin) == 3
    for a, b in zip(runner._tensors(twin), flat):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert runner.signature(gh) == sum((runner.signature(g) for g in gh), ())
    assert runner.signature(gh) != runner.signature(gh[:2])
