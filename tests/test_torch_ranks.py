"""One shard a process (``parallel/ranks.py``, ``halo.RankAxis``,
``brick.RankBrickAxes``): gloo ranks in spawned processes on the CPU.

The ranks run ``ranks.run_specs`` on simulations rebuilt from one-process
ones (``ranks.spec_of``); one 4-rank spawn runs every 4-shard system of
this file (module fixture ``rank_runs``), and each system also runs on the
shard axis of this process (``shard_runs``, one thread, as the children).

Against the JAX reference (the virtual 4-device mesh of tests/conftest.py):
``s4``, the S = 4 slab system of tests/test_torch_halo.py, and ``xy``, the
(2, 2) brick of tests/test_torch_brick.py, with their tolerances: tags,
active and images exact; x within rtol 1e-5 / atol 1e-6 L; v within 1e-4
of its scale; thermo within rel 1e-3; forces after ``init`` within 2e-3
|F|max (geometric law).

Against the one-process shard axis (which tier-1 holds to JAX): every
system's snapshots field for field, integer fields exact, float fields
bit-equal in the geometric law; in the conservative law within 1e-6 of
each field's largest magnitude (its plain twin's ``** 2.5`` rounds apart in
a vector loop's body and tail, and a rank's [P] rows put the tail
elsewhere than the shard axis's [S P]: 3.4e-7 after 20 steps); the prefiltered
conservative S = 4 system's global (``reduce_max``) motion budgets slot for
slot; the skin-triggered slab gas rebuilding at the same steps on every
rank; ``rebalance`` taking the same bounds; a restart written on 4 ranks
and resumed on 2 matching the uninterrupted run per tag (x 2e-3, v 5e-3, as
tests/test_sharded.py:301). Errors: a world size that is not ``n_shards``,
gloo with CUDA tensors and CUDA graphs, a rank that hangs past the spawn
timeout.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from spherharm_tpu_torch.core.state import State
from spherharm_tpu_torch.io import restart as rio
from spherharm_tpu_torch.parallel import dryrun as dryrun_mod
from spherharm_tpu_torch.parallel import ranks
from spherharm_tpu_torch.parallel.brick import BrickSimulation, RankBrickAxes
from spherharm_tpu_torch.parallel.halo import RankAxis, ShardedSimulation

from test_torch_brick import _build as brick_build
from test_torch_halo import STEPS, _build as slab_build
from torch_port_util import floor_layers as _floor_layers

TIMEOUT = 300.0
TRIGGER_STEPS = 120
CK_STEPS, RESUME_STEPS = 250, 200
FIELDS = ("x", "v", "q", "angmom", "f", "tau", "tag", "active", "image")
NEIGH = ("overflow", "skin_violations", "budget", "pair_valid", "pair_i",
         "pair_j", "hist", "neigh_tag")


def _systems():
    """{name: (one-process sim, global state, actions, JAX (sim, state)
    or None)}: the 4-shard systems the one rank spawn runs."""
    run = [("run", "", STEPS), ("snap", "end"), ("thermo", "th")]
    jsim, js0, tsim, ts0, _ = slab_build(4)
    bsim, bs0, bt, bts0, _ = brick_build((2, 2))
    _, _, pre, pre0, _ = slab_build(4, cons=True, prefilter=True)
    _, _, gas, gas0, _ = slab_build(4)
    gas.rebuild_every = 0
    _, _, reb, reb0, _ = slab_build(4)
    floor, floor0, _ = _floor_layers()
    return {
        "s4": (tsim, ts0, run, (jsim, js0)),
        "xy": (bt, bts0, run, (bsim, bs0)),
        "pre4": (pre, pre0, run, None),
        "gas": (gas, gas0, [("trigger", "trig", TRIGGER_STEPS),
                            ("snap", "end")], None),
        "rebalance": (reb, reb0, [("run", "", 30), ("rebalance", "fracs"),
                                  ("snap", "rebalanced"), ("run", "", 10),
                                  ("snap", "end"), ("global", "global")],
                      None),
        "restart": (floor, floor0, [("run", "", CK_STEPS),
                                    ("restart", "ck"),
                                    ("run", "", RESUME_STEPS),
                                    ("snap", "end")], None),
    }


@pytest.fixture(scope="module")
def systems():
    return _systems()


@pytest.fixture(scope="module")
def one_thread():
    """The one-process runs on one thread, as the spawned ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rank_runs(systems):
    """{name: [each rank's ``drive`` result]} of one 4-rank gloo spawn."""
    names = list(systems)
    specs = [ranks.spec_of(sim, st0, acts)
             for sim, st0, acts, _ in systems.values()]
    per_rank = ranks.spawn_ranks(ranks.run_specs, 4, "gloo", ["cpu"] * 4,
                                 specs, timeout=TIMEOUT)
    return {n: [r[i] for r in per_rank] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def shard_runs(systems, one_thread):
    """{name: ``drive`` on the shard axis of this process}."""
    return {n: ranks._to_host(ranks.drive(sim, st0, acts))
            for n, (sim, st0, acts, _) in systems.items()}


@pytest.fixture(scope="module")
def jax_runs(systems):
    """{name: (JAX state after init, after STEPS steps, thermo)}."""
    out = {}
    for name in ("s4", "xy"):
        jsim, js0 = systems[name][3]
        js, jn, jg = jsim.init(js0)
        ji = js
        js, jn, jg = jsim.run(js, jn, jg, STEPS)
        out[name] = (ji, js, jsim.thermo(js, jn, jg))
    return out


def _stack(per_rank, key, part=0):
    """The ranks' [1, ...] snapshots of ``key`` (their per-shard fields)
    as [S, ...] dicts."""
    first = per_rank[0][key][part]
    return {f: np.concatenate([r[key][part][f] for r in per_rank])
            for f, v in first.items() if np.ndim(v) >= 1 and v.shape[0] == 1}


def _slots(a, S):
    a = np.asarray(a)
    return a.reshape((S, a.shape[0] // S) + a.shape[1:])


@pytest.mark.parametrize("name", ["s4", "xy"])
def test_ranks_init_matches_jax(rank_runs, jax_runs, name):
    st = _stack(rank_runs[name], "init")
    ji = jax_runs[name][0]
    np.testing.assert_array_equal(st["tag"], _slots(ji.tag, 4))
    np.testing.assert_array_equal(st["active"], _slots(ji.active, 4))
    ref = _slots(ji.f, 4)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(st["f"], ref, rtol=0,
                               atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["s4", "xy"])
def test_ranks_run_matches_jax(systems, rank_runs, jax_runs, name):
    st = _stack(rank_runs[name], "end")
    _, js, jth = jax_runs[name]
    L = float(np.max(systems[name][0].box_hi_np))
    for f in ("tag", "active", "image"):
        np.testing.assert_array_equal(st[f], _slots(getattr(js, f), 4), f)
    np.testing.assert_allclose(st["x"], _slots(js.x, 4), rtol=1e-5,
                               atol=1e-6 * L)
    v_ref = _slots(js.v, 4)
    np.testing.assert_allclose(st["v"], v_ref, rtol=0,
                               atol=1e-4 * np.abs(v_ref).max())
    assert st["tag"][st["active"]].size == int(np.asarray(js.active).sum())
    for r in rank_runs[name]:  # every rank returns the same global thermo
        for k in ("n", "ke", "erot", "pe_pair", "pe_wall", "etot"):
            assert float(r["th"][k]) == pytest.approx(
                float(jth[k]), rel=1e-3, abs=1e-9), k
        np.testing.assert_array_equal(r["th"]["stress"],
                                      rank_runs[name][0]["th"]["stress"])


@pytest.mark.parametrize("name", ["s4", "xy", "pre4", "gas", "rebalance",
                                  "restart"])
def test_ranks_equal_shard_axis(systems, rank_runs, shard_runs, name):
    """Every snapshot of the ranks, stacked, is the one-process run's:
    integers exact, floats bit for bit (the conservative law: within 1e-6
    of the field's largest magnitude)."""
    one, per_rank = shard_runs[name], rank_runs[name]
    cons = systems[name][0].conservative

    def same(a, b, msg):
        if cons and a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=msg)
        else:
            np.testing.assert_array_equal(a, b, msg)

    for key in ("init", "rebalanced", "end"):
        if key not in one:
            continue
        st = _stack(per_rank, key, 0)
        ng = _stack(per_rank, key, 1)
        for f in FIELDS:
            same(st[f], one[key][0][f], f"{key} state.{f}")
        for f in NEIGH:
            same(ng[f], one[key][1][f], f"{key} neigh.{f}")
        for f in ("box_lo", "box_hi", "tilt", "step"):
            for r in per_rank:
                np.testing.assert_array_equal(r[key][0][f], one[key][0][f])


def test_prefilter_budgets_global_on_ranks(rank_runs, shard_runs):
    """The prefiltered conservative slabs: each rank's motion budgets come
    from the slack maxima over all ranks (``pmax``), slot for slot the
    one-process run's, and the stage-2 survivors the same."""
    one = shard_runs["pre4"]
    for key in ("init", "end"):
        ng = _stack(rank_runs["pre4"], key, 1)
        cl = ng["budget"].shape[1] - 2 * 32
        ref = one[key][1]["budget"][:, :cl]
        assert ref.max() > 0 and ng["budget"].shape == (4, 128)
        np.testing.assert_array_equal(ng["budget"][:, :cl], ref)
        np.testing.assert_array_equal(ng["pair_valid"].sum(-1),
                                      one[key][1]["pair_valid"].sum(-1))


def test_trigger_fires_at_the_same_steps_on_every_rank(rank_runs,
                                                       shard_runs):
    steps = [r["trig"] for r in rank_runs["gas"]]
    assert steps[0], "the skin trigger never fired"
    assert all(s == steps[0] for s in steps)
    assert steps[0] == shard_runs["gas"]["trig"]


def test_rebalance_and_gather_global_agree_on_every_rank(rank_runs,
                                                         shard_runs):
    """``rebalance`` takes the one-process bounds on every rank, and
    ``gather_global`` returns the one-process global state on every
    rank."""
    ref = shard_runs["rebalance"]["fracs"][0]
    assert not np.allclose(ref, np.linspace(0.0, 1.0, 5))
    glob = shard_runs["rebalance"]["global"]
    for r in rank_runs["rebalance"]:
        np.testing.assert_array_equal(r["fracs"][0], ref)
        for k, v in glob.items():
            np.testing.assert_array_equal(r["global"][k], v, k)


def test_restart_on_4_ranks_resumes_on_2(rank_runs, shard_runs, tmp_path):
    """gather_restart on 4 ranks (every rank the same payload, the
    one-process one) -> write_restart -> read -> 2 ranks resume: per tag
    the uninterrupted 4-rank run (x 2e-3, v 5e-3)."""
    per_rank = rank_runs["restart"]
    (gst, payload), one = per_rank[0]["ck"], shard_runs["restart"]["ck"]
    for r in per_rank[1:]:
        for k, v in gst.items():
            np.testing.assert_array_equal(r["ck"][0][k], v)
    for k in ("hist_tags", "hist", "wall_hist"):
        np.testing.assert_array_equal(payload[k], one[1][k])
    assert np.abs(payload["wall_hist"]).max() > 0
    assert np.abs(payload["hist"]).max() > 0
    sim, _, resume = _floor_layers()
    p = tmp_path / "ranks.npz"
    rio.write_restart(p, State(**{k: torch.as_tensor(v)
                                  for k, v in gst.items()}),
                      None, sim.params, extra=payload)
    gstate2, _, params2, extra = rio.read_restart(p, device="cpu")
    resume.params = params2
    spec = ranks.spec_of(resume, gstate2,
                         [("run", "", RESUME_STEPS), ("snap", "end")],
                         restart={k: np.asarray(v) for k, v in extra.items()})
    out = ranks.spawn_ranks(ranks.run_specs, 2, "gloo", ["cpu"] * 2, [spec],
                            timeout=TIMEOUT)
    end_b = _stack([o[0] for o in out], "end")
    end_a = _stack(per_rank, "end")
    by = lambda st, f: {int(t): row for t, a, row in zip(
        st["tag"].reshape(-1), st["active"].reshape(-1),
        st[f].reshape((-1,) + st[f].shape[2:])) if a}
    xa, xb = by(end_a, "x"), by(end_b, "x")
    va, vb = by(end_a, "v"), by(end_b, "v")
    assert set(xa) == set(xb) and len(xa) == 48
    for t in xa:
        np.testing.assert_allclose(xb[t], xa[t], rtol=0, atol=2e-3)
        np.testing.assert_allclose(vb[t], va[t], rtol=0, atol=5e-3)
    assert all(int(o[0]["end"][1]["overflow"].max()) == 0 for o in out)


def test_world_size_other_than_n_shards_fails_every_rank(systems):
    """A 4-slab simulation on 2 ranks: every rank raises, and the spawn
    reports the failure."""
    sim, st0, _, _ = systems["s4"]
    spec = ranks.spec_of(sim, st0, [("run", "", 1)])
    with pytest.raises(RuntimeError, match="not n_shards=4"):
        ranks.spawn_ranks(ranks.run_specs, 2, "gloo", ["cpu"] * 2, [spec],
                          timeout=TIMEOUT)


def test_transport_refuses_what_it_cannot_run(systems, tmp_path):
    """On a 1-rank gloo group in this process: a ring of the wrong size, a
    brick of the wrong rank count, and CUDA graphs over gloo's host
    staging of CUDA tensors all raise (never a silent fallback)."""
    sim, _, _, _ = systems["s4"]
    kw = dict(ranks.spec_of(sim, None)["sim"], bounds_frac=None)
    kw.pop("n_shards")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        axis = RankAxis(device="cpu")
        assert axis.n_shards == 1 and axis.n_local == 1
        with pytest.raises(ValueError, match="not n_shards=4"):
            ShardedSimulation(sim.shapes, sim.params, n_shards=4, axis=axis,
                              device="cpu", **kw)
        with pytest.raises(ValueError, match="needs 4 ranks"):
            RankBrickAxes((2, 2), device="cpu")
        cuda_axis = RankAxis(device="cuda")
        assert cuda_axis.stages_through_host("cuda")
        with pytest.raises(ValueError, match="no CUDA graph"):
            ShardedSimulation(sim.shapes, sim.params, n_shards=1,
                              axis=cuda_axis, device="cuda",
                              **dict(kw, cuda_graphs=True))
        # Eager by name is allowed, and a CPU rank never stages.
        ShardedSimulation(sim.shapes, sim.params, n_shards=1, axis=cuda_axis,
                          device="cuda", **dict(kw, cuda_graphs=False))
        assert not axis.stages_through_host("cpu")
        bkw = dict(kw, bounds_frac=None)
        with pytest.raises(ValueError, match="mesh is"):
            BrickSimulation(sim.shapes, sim.params, mesh_shape=(1, 2),
                            axis=RankBrickAxes((1, 1), device="cpu"),
                            device="cpu", **bkw)
    finally:
        dist.destroy_process_group()


def test_hung_rank_fails_within_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[1\] of 2"):
        ranks.spawn_ranks(ranks.stall, 2, "gloo", ["cpu"] * 2, 1, 600.0,
                          timeout=30.0)
    assert time.monotonic() - t0 < 60.0


def test_dryrun_on_cpu_ranks(capsys):
    """``python -m spherharm_tpu_torch.parallel.dryrun 4 --ranks --device
    cpu``: 4 spawned gloo ranks give the one-process thermo."""
    dryrun_mod.main(["4", "--ranks", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    th = dryrun_mod.dryrun_sharded(4, device="cpu")
    assert line.startswith("dryrun_sharded(4) on 4 gloo ranks on cpu: n=64")
    assert f"etot={float(th['etot']):.7g}" in line


@pytest.mark.parametrize("allowed", [range(32), range(10),
                                     range(0, 64, 2)])
def test_rank_cpus_split_the_cpus_into_runs_of_their_own(allowed):
    """Each of 4 ranks keeps an equal contiguous run of the CPUs, no CPU
    to two ranks."""
    got = [ranks.rank_cpus(r, 4, set(allowed)) for r in range(4)]
    k = len(allowed) // 4
    assert all(len(g) == k for g in got)
    assert len(set().union(*got)) == 4 * k
    assert all(max(got[r]) < min(got[r + 1]) for r in range(3))
    assert got[0] == set(sorted(allowed)[:k])


def test_rank_cpus_leave_a_rank_unpinned_with_fewer_cpus_than_ranks():
    assert ranks.rank_cpus(0, 4, {0, 1, 2}) is None
    assert ranks.rank_cpus(3, 4, set(range(4))) == {3}
