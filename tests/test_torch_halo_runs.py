"""The slab decomposition of the torch port (``parallel/halo.py``) against
its own single-box runs, on the CPU: mirrors of the reference's sharded
tests (tests/test_sharded.py, test_sharded_stress.py, test_triaxial.py,
test_conservative.py), cut in size or steps to fit tier-1.

Per-tag comparisons take the reference's own sharded-vs-single bounds
(x within 2e-3, v within 5e-3, ke and etot within rel 1e-3, stress within
rtol 2e-2 / atol 1e-3) unless a test says otherwise. The card's own
checks of the same module (graph run vs eager run, card vs CPU) are in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.core.state import SimParams
from spherharm_tpu_torch.io import restart as rio
from spherharm_tpu_torch.models import scenarios, shapes_library
from spherharm_tpu_torch.ops.neighbor import CellGrid
from spherharm_tpu_torch.ops.walls import PlaneWall
from spherharm_tpu_torch.parallel.halo import (ShardedSimulation,
                                                balance_fracs)

from torch_port_util import np32, on_cpu

PER = (True, True, True)


def _shapes(lmax=2):
    return shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, lmax)], lmax,
        contact_quad=(6, 12), device="cpu")


def _setup(n=96, seed=0):
    """tests/test_sharded.py's periodic gas of ellipsoids on a jittered
    lattice (box 8, random velocities and orientations)."""
    rng = np.random.default_rng(seed)
    box = 8.0
    side = int(np.ceil(n ** (1 / 3)))
    pitch = box / side
    i = np.arange(n)
    x = np.stack([(i % side + 0.5) * pitch, ((i // side) % side + 0.5) * pitch,
                  (i // side**2 + 0.5) * pitch], axis=1)
    x = x + rng.uniform(-0.08, 0.08, (n, 3))
    v = rng.normal(size=(n, 3)) * 0.5
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3, device="cpu")
    state = scenarios.make_state(x, [0, 0, 0], [box] * 3, v=v, q=q,
                                 device="cpu")
    return _shapes(), params, state, box


def _single(shapes, params, box, periodic=PER, **kw):
    grid = CellGrid([0, 0, 0], [box, box, box], 1.5, periodic)
    return Simulation(shapes, params, periodic=periodic, grid=grid, k_max=24,
                      cell_cap=12, pair_capacity=1024, conservative=False,
                      device="cpu", **kw)


def _sharded(shapes, params, box, S=4, **kw):
    base = dict(n_shards=S, box_lo=(0, 0, 0), box_hi=(box, box, box),
                cap_local=96, halo_cap=64, migrate_cap=32, periodic=PER,
                k_max=24, cell_cap=12, pair_capacity=768, conservative=False,
                device="cpu")
    base.update(kw)
    return ShardedSimulation(shapes, params, **base)


def by_tag(state, field):
    """{tag: row} of the active slots, either layout."""
    tag = np32(state.tag).reshape(-1)
    act = np32(state.active).reshape(-1)
    arr = np32(getattr(state, field))
    arr = arr.reshape((-1,) + arr.shape[-1:]) if arr.ndim > act.ndim else \
        arr.reshape(-1)
    return {int(t): arr[i] for i, t in enumerate(tag) if act[i]}


def assert_same_by_tag(a, b, x_tol=2e-3, v_tol=5e-3, L=None):
    xa, xb = by_tag(a, "x"), by_tag(b, "x")
    assert set(xa) == set(xb)
    va, vb = by_tag(a, "v"), by_tag(b, "v")
    for t in xa:
        dx = xb[t] - xa[t]
        if L is not None:  # compare modulo the box
            dx = (dx + L / 2) % L - L / 2
        np.testing.assert_allclose(dx, 0.0, atol=x_tol,
                                   err_msg=f"x tag {t}")
        np.testing.assert_allclose(vb[t], va[t], atol=v_tol,
                                   err_msg=f"v tag {t}")


def test_sharded_matches_single_device():
    shapes, params, state0, box = _setup()
    sim1 = _single(shapes, params, box)
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, 60)
    t1 = sim1.thermo(s1, n1)
    sim = _sharded(shapes, params, box)
    s, ng, gh = sim.init(state0)
    s, ng, gh = sim.run(s, ng, gh, 60)
    t = sim.thermo(s, ng, gh)
    assert int(t["neigh_overflow"]) == 0
    assert_same_by_tag(s1, s)
    assert float(t["ke"]) == pytest.approx(float(t1["ke"]), rel=1e-3)
    assert float(t["etot"]) == pytest.approx(float(t1["etot"]), rel=1e-3)
    np.testing.assert_allclose(np32(t["stress"]), np32(t1["stress"]),
                               rtol=2e-2, atol=1e-3)


def test_migration_preserves_particles():
    """A strong x drift carries particles across slab boundaries and the
    seam; none is lost or duplicated, every slab owns some, and
    ``gather_global`` collects them all."""
    shapes, params, state0, box = _setup(n=64, seed=2)
    state0 = state0.replace(v=state0.v + torch.tensor([8.0, 0.0, 0.0]))
    sim = _sharded(shapes, params, box, cap_local=64, halo_cap=48,
                   pair_capacity=512, rebuild_every=10)
    s, ng, gh = sim.init(state0)
    tags0 = sorted(by_tag(s, "x"))
    owner0 = {int(t): p for p in range(4) for t, a in
              zip(np32(s.tag)[p], np32(s.active)[p]) if a}
    s, ng, gh = sim.run(s, ng, gh, 150)
    assert sorted(by_tag(s, "x")) == tags0 == list(range(1, 65))
    owner1 = {int(t): p for p in range(4) for t, a in
              zip(np32(s.tag)[p], np32(s.active)[p]) if a}
    assert sum(owner0[t] != owner1[t] for t in owner0) >= 8
    assert int(ng.overflow.max()) == 0
    assert all(np32(s.active)[p].any() for p in range(4))
    g = sim.gather_global(s)  # the slabs' slots, slab-major, on the host
    assert g.x.shape == (4 * 64, 3) and g.x.device.type == "cpu"
    assert sorted(np32(g.tag)[np32(g.active)]) == tags0


def test_seam_crossing_pairs_match_single_device():
    """tests/test_sharded.py's seam case: one gently overlapping pair
    straddles each slab boundary (x = 0/8, 2, 4, 6) at two heights, with
    a fast common drift so the left member crosses mid-contact. The
    sharded trajectory matches the single one, and at step 64 each
    pair's live spring matches (a spring dropped at migration re-grows
    to only ~40% of the true value by then)."""
    shapes = _shapes()
    box = 8.0
    pts, vel = [], []
    for bi, bx in enumerate((0.0, 2.0, 4.0, 6.0)):
        for hj, z in enumerate((2.0, 6.0)):
            y = 1.5 + 1.5 * bi + 0.35 * hj
            pts.append([(bx - 0.15) % box, y % box, z])
            pts.append([(bx + 0.87) % box, y % box, z])
            vel.append([8.2, 0.05, 0.0])
            vel.append([7.8, -0.05, 0.0])
    params = SimParams.create(dt=5e-4, kn=2e3, gamma_n=10.0, mu=1.0,
                              cutoff=1.2, skin=0.3, device="cpu")
    state0 = scenarios.make_state(np.asarray(pts), [0, 0, 0], [box] * 3,
                                  v=np.asarray(vel), device="cpu")
    grid = CellGrid([0, 0, 0], [box] * 3, 1.5, PER)
    sim1 = Simulation(shapes, params, periodic=PER, grid=grid, k_max=8,
                      cell_cap=8, pair_capacity=256, conservative=False,
                      device="cpu")
    s1, n1 = sim1.init_neighbors(state0)
    sim = _sharded(shapes, params, box, cap_local=32, halo_cap=16,
                   migrate_cap=8, k_max=8, cell_cap=8, pair_capacity=128)
    s, ng, gh = sim.init(state0)

    def live_spring(pi, pj, ok, ph, row_tags, a, b):
        ti, tj = row_tags[pi], row_tags[pj]
        fwd, rev = ok & (ti == a) & (tj == b), ok & (ti == b) & (tj == a)
        if fwd.any():
            return ph[fwd][0, :3]
        if rev.any():
            return -ph[rev][0, :3]
        return None

    for leg in range(4):
        s1, n1 = sim1.run(s1, n1, 64)
        s, ng, gh = sim.run(s, ng, gh, 64)
        assert_same_by_tag(s1, s, x_tol=1e-2, v_tol=1e-2, L=box)
        if leg:
            continue
        for p in range(8):
            a, b = 2 * p + 1, 2 * p + 2
            h1 = live_spring(np32(n1.pair_i), np32(n1.pair_j),
                             np32(n1.pair_valid), np32(n1.pair_hist),
                             np32(n1.row_tag), a, b)
            found = [live_spring(np32(ng.pair_i)[k], np32(ng.pair_j)[k],
                                 np32(ng.pair_valid)[k],
                                 np32(ng.pair_hist)[k], np32(ng.row_tag)[k],
                                 a, b) for k in range(4)]
            h = next(f for f in found if f is not None)
            assert np.linalg.norm(h1) > 1e-4, f"pair {p}: no spring"
            assert np.linalg.norm(h - h1) < 0.25 * np.linalg.norm(h1), p
    assert int(ng.overflow.max()) == 0


@pytest.mark.parametrize("conservative", [False, True], ids=["geo", "cons"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_seam_rows_match_single_by_dtype(dtype, conservative):
    """Forces after ``init`` on pairs that straddle every slab boundary
    and the periodic seam, slabs vs single box. Across the seam the slabs
    shift the sent ghost by +/- Lx and the single box rounds d / Lx, so
    the two part by the rounding of d: within 2e-3 |F|max in float32
    (the bound chip_smoke.py holds the seam rows to), and within 1e-9
    |F|max in float64, where a fault of the shift would still show."""
    box = 8.0
    pts = [[(bx + dx) % box, 1.5 + 1.5 * bi + 0.35 * hj, z]
           for bi, bx in enumerate((0.0, 2.0, 4.0, 6.0))
           for hj, z in enumerate((2.0, 6.0)) for dx in (-0.15, 0.87)]
    shapes = on_cpu(_shapes(), dtype)
    params = SimParams.create(dt=5e-4, kn=2e3, gamma_n=10.0, mu=1.0,
                              cutoff=1.2, skin=0.3, dtype=dtype, device="cpu")
    state0 = scenarios.make_state(np.asarray(pts), [0, 0, 0], [box] * 3,
                                  dtype=dtype, device="cpu")
    grid = CellGrid([0, 0, 0], [box] * 3, 1.5, PER)
    s1, _ = Simulation(shapes, params, periodic=PER, grid=grid, k_max=8,
                       cell_cap=8, pair_capacity=256,
                       conservative=conservative,
                       device="cpu").init_neighbors(state0)
    s = _sharded(shapes, params, box, cap_local=32, halo_cap=16,
                 migrate_cap=8, k_max=8, cell_cap=8, pair_capacity=128,
                 conservative=conservative).init(state0)[0]
    assert s.f.dtype == dtype
    f1, f = by_tag(s1, "f"), by_tag(s, "f")
    scale = max(np.abs(v).max() for v in f1.values())
    assert scale > 0 and all(np.abs(f1[t]).max() > 0 for t in f1)
    gap = max(np.abs(f[t] - f1[t]).max() for t in f1) / scale
    assert gap <= (1e-9 if dtype == torch.float64 else 2e-3)


def test_sharded_restart_roundtrip(tmp_path):
    """gather_restart -> write_restart -> read -> re-init on 2 slabs
    instead of 4 -> run: matches the uninterrupted 4-slab run per tag.
    Two layers rest on a floor wall, so pair AND wall springs are live at
    the checkpoint (dropping either diverges)."""
    rng = np.random.default_rng(6)
    shapes = _shapes()
    box = 8.0
    pts = [[(i % 6) * 1.3 + 0.7 + 0.08 * layer, (i // 6) * 1.3 + 0.7, z]
           for layer, z in enumerate((0.46, 1.32)) for i in range(24)]
    x = np.asarray(pts) + rng.uniform(-0.03, 0.03, (48, 3))
    v = rng.normal(size=(48, 3)) * 0.1
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=30.0, mu=1.0,
                              gravity=(0.0, 0.0, -5.0), cutoff=1.2, skin=0.3,
                              device="cpu")
    state0 = scenarios.make_state(x, [0, 0, 0], [box, box, 4.0], v=v,
                                  device="cpu")
    walls = (PlaneWall.create((0, 0, 0), (0, 0, 1), device="cpu"),)
    kw = dict(walls=walls, box_hi=(box, box, 4.0), cap_local=48,
              halo_cap=32, migrate_cap=16, periodic=(True, True, False),
              k_max=16, cell_cap=12, pair_capacity=512)
    sim_a = _sharded(shapes, params, box, **kw)
    sa, na, ga = sim_a.init(state0)
    sa, na, ga = sim_a.run(sa, na, ga, 250)
    gstate, payload = sim_a.gather_restart(sa, na)
    assert np.abs(payload["wall_hist"]).max() > 0
    assert np.abs(payload["hist"]).max() > 0
    p = tmp_path / "shard.npz"
    rio.write_restart(p, gstate, None, params, extra=payload)
    gstate2, _, params2, extra = rio.read_restart(p, device="cpu")
    sim_b = _sharded(shapes, params2, box, S=2,
                     **dict(kw, cap_local=64, halo_cap=48))
    sb, nb, gb = sim_b.init(gstate2, restart=extra)
    sa, na, ga = sim_a.run(sa, na, ga, 200)
    sb, nb, gb = sim_b.run(sb, nb, gb, 200)
    assert_same_by_tag(sa, sb)
    assert int(nb.overflow.max()) == 0


def test_weighted_balance_matches_uniform():
    """A gas clustered in the left third, balanced by particle-count
    quantiles (``balance_fracs``), runs the same physics as uniform slabs
    with a smaller cap_local (uniform slabs would overflow it)."""
    rng = np.random.default_rng(11)
    shapes = _shapes()
    box = 16.0
    n = 72
    x = np.concatenate([
        rng.uniform([0.3, 0.3, 0.3], [5.0, 7.7, 7.7], (54, 3)),
        rng.uniform([5.5, 0.3, 0.3], [15.7, 7.7, 7.7], (18, 3))])
    v = rng.normal(size=(n, 3)) * 0.4
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3, device="cpu")
    state0 = scenarios.make_state(x, [0, 0, 0], [box, 8.0, 8.0], v=v,
                                  device="cpu")
    kw = dict(box_hi=(box, 8.0, 8.0), halo_cap=48, migrate_cap=24,
              k_max=16, cell_cap=10, pair_capacity=512)
    fr = balance_fracs(state0, 4, min_frac=1.02 * 1.5 / box)
    assert fr[1] < 0.25  # boundaries moved toward the cluster
    sim_u = _sharded(shapes, params, box, cap_local=72, **kw)
    sim_b = _sharded(shapes, params, box, cap_local=48, bounds_frac=fr, **kw)
    with pytest.raises(ValueError, match="cap_local"):
        _sharded(shapes, params, box, cap_local=40, **kw).distribute(state0)
    su, nu, gu = sim_u.init(state0)
    sb, nb, gb = sim_b.init(state0)
    su, nu, gu = sim_u.run(su, nu, gu, 100)
    sb, nb, gb = sim_b.run(sb, nb, gb, 100)
    assert int(nb.overflow.max()) == int(nu.overflow.max()) == 0
    assert_same_by_tag(su, sb, x_tol=1e-3, v_tol=2e-3, L=box)


def test_sharded_prefilter_matches_single_device():
    """The rebuild-time prefilter on the slabs (stage-2 pair list, the
    slack maxima global over the slabs, the budget-ratio trigger under
    pmax) tracks the plain single-box run."""
    shapes, params, state0, box = _setup(n=72, seed=5)
    sim1 = _single(shapes, params, box)
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, 60)
    t1 = sim1.thermo(s1, n1)
    sim = _sharded(shapes, params, box, stage2_capacity=256)
    s, ng, gh = sim.init(state0)
    assert ng.pair_i.shape == (4, 256)  # stage-2 sized pair lists
    s, ng, gh = sim.run(s, ng, gh, 60)
    t = sim.thermo(s, ng, gh)
    assert int(t["neigh_overflow"]) == 0
    assert_same_by_tag(s1, s, x_tol=3e-3, v_tol=5e-3)
    assert float(t["etot"]) == pytest.approx(float(t1["etot"]), rel=2e-3)


def test_inrun_rebalance():
    """rebalance() swaps the slab bounds in ghosts.fracs, migrates
    ownership in one forced rebuild, and the trajectory stays the
    single-box one; the simulation's captured graphs (none on the CPU)
    are not touched."""
    shapes, params, state0, box = _setup(n=72, seed=8)
    sim1 = _single(shapes, params, box)
    s1, n1 = sim1.init_neighbors(state0)
    s1, n1 = sim1.run(s1, n1, 100)
    sim = _sharded(shapes, params, box)
    s, ng, gh = sim.init(state0)
    s, ng, gh = sim.run(s, ng, gh, 50)
    graphs = dict(sim._graphs)
    before = np32(gh.fracs).copy()
    s, ng, gh = sim.rebalance(s, ng, gh)
    assert not np.allclose(before, np32(gh.fracs))
    assert sim._graphs == graphs
    s, ng, gh = sim.run(s, ng, gh, 50)
    assert int(sim.thermo(s, ng, gh)["neigh_overflow"]) == 0
    assert_same_by_tag(s1, s, x_tol=3e-3, v_tol=5e-3)


def test_migrate_cap_overflow_flags_loudly():
    """A starved migrate_cap fires the overflow channel (gated: nonzero
    means truncated physics), never drops particles silently."""
    rng = np.random.default_rng(7)
    n, box = 128, 10.0
    side = int(np.ceil(n ** (1 / 3)))
    pitch = box / side
    i = np.arange(n)
    x = np.stack([(i % side + 0.5) * pitch, ((i // side) % side + 0.5) * pitch,
                  (i // side**2 + 0.5) * pitch], axis=1)
    x = x + rng.uniform(-0.06, 0.06, (n, 3)) * pitch
    v = rng.normal(size=(n, 3)) * 0.5
    v[:, 0] += 3.0
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3, device="cpu")
    state0 = scenarios.make_state(x, [0, 0, 0], [box] * 3, v=v, device="cpu")
    sim = _sharded(_shapes(), params, box, cap_local=128, halo_cap=128,
                   migrate_cap=1, k_max=24, cell_cap=16, pair_capacity=2048,
                   box_hi=(box,) * 3)
    s, ng, gh = sim.init(state0)
    s, ng, gh = sim.run(s, ng, gh, 80)
    assert int(ng.overflow.max()) != 0, (
        "starved migrate_cap did not flag through the overflow channel")


def test_triaxial_sharded_matches_single():
    """``triaxial_cell(sharded=True)`` (2 slabs: the slab width must
    exceed cutoff + skin in this small box) against the single cell:
    same box deformation, ke within rel 2e-3, press within rel 2e-2,
    positions per tag within 3e-3."""
    kw = dict(n=64, lmax=2, strain_rate=(-0.1, -0.1, -0.1), dt=2e-4,
              k_max=24, seed=3, device="cpu")
    sim1, s1, n1 = scenarios.triaxial_cell(**kw)
    sim2, s2, n2, g2 = scenarios.triaxial_cell(**kw, sharded=True,
                                               n_shards=2)
    assert isinstance(sim2, ShardedSimulation) and sim2.cell_cap == 12
    s1, n1 = sim1.run(s1, n1, 100)
    s2, n2, g2 = sim2.run(s2, n2, g2, 100)
    t1, t2 = sim1.thermo(s1, n1), sim2.thermo(s2, n2, g2)
    assert float(t2["ke"]) == pytest.approx(float(t1["ke"]), rel=2e-3)
    assert float(t2["press"]) == pytest.approx(float(t1["press"]), rel=2e-2,
                                               abs=1e-6)
    np.testing.assert_allclose(np32(s2.box_hi), np32(s1.box_hi), rtol=1e-6)
    assert_same_by_tag(s1, s2, x_tol=3e-3, v_tol=np.inf)


def test_sharded_conservative_runs():
    """The conservative law (autograd through the twin) on 2 slabs stays
    finite and counts every particle."""
    rng = np.random.default_rng(4)
    box, n = 8.0, 48
    x = rng.uniform(0.5, box - 0.5, (n, 3))
    v = rng.normal(size=(n, 3)) * 0.4
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3, device="cpu")
    state = scenarios.make_state(x, [0, 0, 0], [box] * 3, v=v, device="cpu")
    sim = _sharded(_shapes(), params, box, S=2, cap_local=64, halo_cap=48,
                   migrate_cap=24, k_max=16, cell_cap=10, pair_capacity=384,
                   conservative=True)
    s, ng, gh = sim.init(state)
    s, ng, gh = sim.run(s, ng, gh, 30)
    t = sim.thermo(s, ng, gh)
    assert np.isfinite(float(t["etot"]))
    assert int(t["n"]) == n
