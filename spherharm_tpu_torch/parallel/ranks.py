"""One shard a process: the slabs and the bricks over ``torch.distributed``
ranks (the counterpart of the reference's device mesh,
``spherharm_tpu/parallel/halo.py`` ``ShardedSimulation(mesh=...)``).

Each rank holds one shard's tensors [1, ...] on its own device, and the
collectives of ``ShardedSimulation`` / ``BrickSimulation`` go through
``halo.RankAxis`` / ``brick.RankBrickAxes``: NCCL across cards, gloo on
the CPU (or several ranks on one card, eagerly).

* ``init_ranks()``: a rank started by ``torchrun`` joins its group and
  sets its device; returns its ``RankAxis``.
* ``spawn_ranks(fn, n, backend, devices, *args, timeout)``: starts ``n``
  ``spawn`` processes (never ``fork``: a parent may hold threads, JAX's
  among them) that meet through a ``FileStore`` in a fresh temporary
  directory (no TCP port to race for), calls ``fn(axis, *args)`` in each
  and returns each rank's result with its tensors as numpy arrays. A rank
  on a card keeps its threads on CPUs of its own (``rank_cpus``). A rank
  that raises, dies or outlasts ``timeout`` fails the call, and every
  child is killed.
* Workers (here, not in a test module, so that a spawned child imports
  nothing but this package): ``dryrun``, ``run_specs`` (simulations
  rebuilt on the ranks from ``spec_of`` a one-process simulation, each
  driven by ``drive``), ``stall``.

Containers and tensors cross the process boundary as numpy (``ship`` /
``land``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import importlib
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from spherharm_tpu_torch.parallel.brick import BrickSimulation, RankBrickAxes
from spherharm_tpu_torch.parallel.halo import RankAxis, ShardedSimulation


def init_ranks(device=None) -> RankAxis:
    """Join the process group of a ``torchrun`` launch (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT from the
    environment). NCCL when every rank of this host has a card of its
    own (``cuda:<LOCAL_RANK>``), else gloo (ranks share the cards
    round-robin, or the CPU where there is none); ``device="cpu"`` asks
    for gloo on the CPU. Returns the rank's ``RankAxis``."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    local_n = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None:
        device = (torch.device("cuda", local % cards) if cards
                  else torch.device("cpu"))
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" and local_n <= cards else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method="env://",
        **({"device_id": device} if backend == "nccl" else {}))
    return RankAxis(device=device)


def _to_host(obj):
    """``obj`` with every tensor as a numpy array (containers as dicts of
    their fields)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_host(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def ship(obj):
    """A picklable copy of ``obj`` (containers, tensors, and dicts, lists
    and tuples of them) with numpy arrays for tensors, for ``land``."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", obj.detach().cpu().numpy())
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        return ("container", f"{cls.__module__}:{cls.__qualname__}",
                {f.name: ship(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return ("dict", {k: ship(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, [ship(v) for v in obj])
    return ("plain", obj)


def land(shipped, device):
    """The object ``ship`` copied, its tensors on ``device`` with their
    dtypes."""
    kind, *rest = shipped
    if kind == "tensor":
        return torch.as_tensor(rest[0], device=device)
    if kind == "container":
        mod, name = rest[0].split(":")
        cls = getattr(importlib.import_module(mod), name)
        return cls(**{k: land(v, device) for k, v in rest[1].items()})
    if kind == "dict":
        return {k: land(v, device) for k, v in rest[0].items()}
    if kind in ("list", "tuple"):
        vals = [land(v, device) for v in rest[0]]
        return vals if kind == "list" else tuple(vals)
    return rest[0]


def rank_cpus(rank: int, n: int, allowed) -> set | None:
    """The CPUs rank ``rank`` of ``n`` on this host keeps: the ``rank``-th
    of ``n`` equal contiguous runs of ``allowed`` (None where a run would
    be empty)."""
    cpus = sorted(allowed)
    k = len(cpus) // n
    return set(cpus[rank * k:(rank + 1) * k]) if k else None


def _pin(rank: int, n: int):
    """Keep this process's threads on CPUs of its own (``rank_cpus``).
    Every step a rank's host reads the trigger's flag and launches the
    next graph, and every rank waits for the slowest: a thread that
    migrates, or shares a CPU with another rank's, slows them all."""
    cpus = rank_cpus(rank, n, os.sched_getaffinity(0))
    if cpus:
        for tid in os.listdir("/proc/self/task"):
            with contextlib.suppress(ProcessLookupError):  # ended since
                os.sched_setaffinity(int(tid), cpus)


def _child(fn, rank, n, backend, device, store_path, results, timeout, args):
    try:
        torch.set_num_threads(1)
        device = torch.device(device)
        if device.type == "cuda":
            device = torch.device("cuda", device.index or 0)
            torch.cuda.set_device(device)
            _pin(rank, n)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout),
            **({"device_id": device} if backend == "nccl" else {}))
        out = _to_host(fn(RankAxis(device=device), *args))
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, n: int, backend: str, devices, *args,
                timeout: float = 600.0):
    """Run ``fn(axis, *args)`` on ``n`` ranks, one ``spawn`` process each
    (``torch.set_num_threads(1)``; ``devices[r]`` the device of rank r,
    "cuda" card 0; a rank on a card keeps to CPUs of its own,
    ``rank_cpus``), over ``backend`` ("gloo" or "nccl"). ``fn`` must be
    importable by name from a module that a child can import. Returns
    [each rank's result, tensors as numpy]. Raises RuntimeError when a
    rank raises or exits without a result, TimeoutError when the ranks
    have not all returned within ``timeout`` seconds; every child is
    killed then."""
    import multiprocessing as mp

    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="spherharm-ranks-")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, n, backend, str(devices[r]),
                               os.path.join(tmp, "store"), results, timeout,
                               args))
             for r in range(n)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(n)) - set(out))} of {n} gave "
                    f"no result within {timeout:g} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    try:  # a result sent just before its sender exited
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result"
                        ) from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=30)
        return [out[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- workers ----------------------------------------------------------------


def dryrun(axis, shape, cuda_graphs: bool = True):
    """``dryrun_sharded(S)`` (``shape`` = (S,)) or ``dryrun_brick(shape)``
    on this rank's shard; returns the thermo dict."""
    from spherharm_tpu_torch.parallel import dryrun as dr

    if len(shape) == 1:
        return dr.dryrun_sharded(shape[0], device=axis.device, axis=axis,
                                 cuda_graphs=cuda_graphs)
    return dr.dryrun_brick(shape, device=axis.device, axis=RankBrickAxes(
        shape, axis.group, axis.device), cuda_graphs=cuda_graphs)


def stall(axis, rank: int, seconds: float):
    """Rank ``rank`` sleeps ``seconds`` before returning, the others
    return at once: a rank that hangs, for ``spawn_ranks``' timeout."""
    if axis.rank == rank:
        time.sleep(seconds)
    return axis.rank


def spec_of(sim, state, actions=(), restart=None) -> dict:
    """What ``build`` and ``drive`` need to run the one-process slabs or
    bricks ``sim`` from the global ``state`` on ranks: shipped shapes,
    params, walls and state, the constructor's arguments, ``actions`` and
    the ``restart`` payload (numpy)."""
    kw = dict(box_lo=sim.box_lo_np, box_hi=sim.box_hi_np,
              cap_local=sim.cap_local, halo_cap=sim.halo_cap,
              migrate_cap=sim.migrate_cap, periodic=sim.periodic,
              k_max=sim.k_max, cell_cap=sim.cell_cap,
              pair_capacity=sim.pair_capacity, deform_min=sim.deform_min,
              rebuild_every=sim.rebuild_every,
              wall_capacity=sim.wall_capacity,
              stage2_capacity=sim.stage2_capacity, triclinic=sim.triclinic,
              bounds_frac=sim.bounds_frac, conservative=sim.conservative,
              cuda_graphs=sim.cuda_graphs)
    if isinstance(sim, BrickSimulation):
        kw.update(mesh_shape=sim.axis.shape, tilt_pad=sim.tilt_pads)
    else:
        kw.update(n_shards=sim.n_shards, tilt_pad=sim.tilt_pad)
    return {"shapes": ship(sim.shapes), "params": ship(sim.params),
            "walls": [ship(w) for w in sim.walls], "sim": kw,
            "state": ship(state), "actions": list(actions),
            "restart": restart}


def build(spec: dict, device, axis=None):
    """The simulation of ``spec`` on ``device``: ``spec["shapes"]``,
    ``["params"]``, ``["walls"]`` shipped containers, ``["sim"]`` the
    constructor's other keyword arguments (``mesh_shape`` among them: a
    ``BrickSimulation``); ``axis`` a rank's ``RankAxis`` (None: every
    shard on the shard axis of this process). Returns (sim, the shipped
    ``spec["state"]`` landed on ``device``)."""
    shapes, params = land(spec["shapes"], device), land(spec["params"], device)
    walls = tuple(land(w, device) for w in spec.get("walls", ()))
    kw = dict(spec["sim"])
    if "mesh_shape" in kw:
        if axis is not None:
            axis = RankBrickAxes(kw["mesh_shape"], axis.group, axis.device)
        sim = BrickSimulation(shapes, params, walls=walls, device=device,
                              axis=axis, **kw)
    else:
        sim = ShardedSimulation(shapes, params, walls=walls, device=device,
                                axis=axis, **kw)
    return sim, land(spec["state"], device)


def drive(sim, state, actions, restart=None) -> dict:
    """``sim.init(state, restart)``, then ``actions`` in order, each
    (verb, name, *args): ("run", name, n) n steps; ("snap", name) the
    state and neighbour state; ("thermo", name); ("rebalance", name) (the
    new bounds); ("restart", name) ``gather_restart``; ("global", name)
    ``gather_global``; ("trigger", name, n) n single steps, recording
    those that rebuilt (eager steps only); ("ghosts", name) the ghosts;
    ("spans", name, n) n steps with spans on under the profiler from the
    current state, which stays where it was (``spans_run``). The snapshot
    "init" is taken after ``init``. Returns {name: result}."""
    st, ng, gh = sim.init(state, restart=restart)
    out = {"init": (st, ng)}
    for verb, name, *args in actions:
        if verb == "run":
            st, ng, gh = sim.run(st, ng, gh, args[0])
        elif verb == "snap":
            out[name] = (st, ng)
        elif verb == "thermo":
            out[name] = sim.thermo(st, ng, gh)
        elif verb == "rebalance":
            st, ng, gh = sim.rebalance(st, ng, gh)
            packs = gh if isinstance(gh, tuple) else (gh,)
            out[name] = [g.fracs for g in packs]
        elif verb == "restart":
            out[name] = sim.gather_restart(st, ng)
        elif verb == "global":
            out[name] = sim.gather_global(st)
        elif verb == "ghosts":
            out[name] = gh
        elif verb == "spans":
            out[name] = spans_run(sim, st, ng, gh, args[0])
        elif verb == "trigger":
            rebuild, fired = sim._rebuild, []
            sim._rebuild = lambda *a, **k: (fired.append(True),
                                            rebuild(*a, **k))[1]
            steps = []
            try:
                for k in range(args[0]):
                    del fired[:]
                    st, ng, gh = sim.run(st, ng, gh, 1)
                    if fired:
                        steps.append(k + 1)
            finally:
                del sim._rebuild
            out[name] = steps
        else:
            raise ValueError(f"unknown action {verb!r}")
    return out


def spans_run(sim, st, ng, gh, n: int) -> dict:
    """``n`` steps of ``sim.run`` from (st, ng, gh) with spans on,
    profiled (``utils/timing.span_profile``): {"end": (state, neigh)
    after, "summary": the profile's summary}."""
    from spherharm_tpu_torch.utils import timing

    end, summary = timing.span_profile(lambda: sim.run(st, ng, gh, n))
    return {"end": end[:2], "summary": summary}


def run_specs(axis, specs) -> list:
    """``build`` then ``drive`` each of ``specs`` on this rank, in order
    (``spec["actions"]``, ``spec["restart"]``); each result also holds
    its kernel wrappers' launches under "launches"
    (``runner.launch_counts``; the card's only: a CPU tensor takes the
    plain twin)."""
    from spherharm_tpu_torch.core import runner

    outs = []
    for spec in specs:
        before = runner.launch_counts()
        sim, state = build(spec, axis.device, axis)
        out = drive(sim, state, spec["actions"], spec.get("restart"))
        out["launches"] = {k: n - before[k]
                           for k, n in runner.launch_counts().items()}
        outs.append(out)
    return outs
