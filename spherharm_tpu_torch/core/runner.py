"""CUDA graphs of the step: the counterpart of the reference's compiled run
loops (``_run_jit``, ``_run_cadence_jit`` and ``run_inline`` of
``spherharm_tpu/core/simulation.py``).

The reference compiles a whole run into one XLA program. PyTorch issues
each op from Python, so a step of a few hundred small kernels leaves the
card idle while the host launches them. A ``GraphRunner`` captures units
of the step once each as a CUDA graph and replays them:

* the units are functions of named static buffers (``State``,
  ``NeighborState``, ``SimParams`` containers, tuples of containers, or
  plain tensors) that
  return the new values of some of them; each captured unit ends by
  copying its outputs back into the buffers, so replays chain;
* ``load`` copies the caller's containers into the buffers before a run,
  ``result`` hands back clones: nothing a caller holds aliases a buffer
  that a later run overwrites;
* a unit may also return a 0-d ``"flag"`` tensor, copied inside the
  graph to pinned host memory; ``read_flag`` waits on an event after the
  replay and reads it: the one host read of a skin-triggered step;
* every graph of a runner shares one memory pool;
* a runner captures in the stream-capture mode it is given: "global"
  (the default), or "thread_local" where another thread of the process
  keeps working on the card during a capture (NCCL's watchdog queries
  its events; ``parallel/halo.RankAxis``);
* each unit runs once eagerly on a side stream before its capture
  (the kernels' build and load, cuBLAS's handle, each kernel's first
  attribute call, the cached constant tensors of ``ops/neighbor.py``);
* the kernel wrappers count launches in Python, so a capture counts
  each launch once: the runner records each graph's counts at capture,
  takes them (and the warm-up's) back out, and adds them on every replay;
  the host counters of ``utils/spans`` ride the same way, and what the
  warm-up added to its device counters is taken back out;
* with spans on (``utils/spans``) a runner's graphs hold the step's span
  marks and its copies are spans (``runner.store``, ``runner.load``,
  ``runner.result``); replays and captures are host ranges
  (``spherharm.replay.<unit>``, ``spherharm.capture.<unit>``).
  ``cached_runner`` keys runners by the spans state too, so a spans-off
  run never replays a marked graph and switching spans on leaves the
  spans-off runners as they were.

Nothing here falls back: a capture or a replay that fails raises. The
units do not know they are captured, so a step written in them (a
single device's, or later one with a halo exchange) is captured by the
same code. ``cached_runner`` keeps a simulation's runners, keyed by the
signature of their buffers: ``Simulation`` (``core/simulation.py``),
``ShardedSimulation`` (``parallel/halo.py``) and ``BrickSimulation``
(``parallel/brick.py``, whose ghosts are a tuple of packs) build theirs
through it.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import time

import torch

from spherharm_tpu_torch.utils import spans


def kernel_counters():
    """The launch counters of every kernel wrapper (dicts keyed by
    variant)."""
    from spherharm_tpu_torch.ops import contact_kernels as ck
    from spherharm_tpu_torch.ops import walls_kernels as wk

    return (ck.pair_contact.launches, ck.stage1_depth.launches,
            wk.wall_contact_kernel.launches, ck.pair_reduce.launches)


def launch_counts() -> dict:
    """Every kernel wrapper's launches, flat: ``pair_contact_<law>``, the
    stage-1 variants, ``wall_<kind>``, ``pair_reduce``."""
    pair, stage1, wall, reduce = kernel_counters()
    return {**{f"pair_contact_{k}": n for k, n in pair.items()}, **stage1,
            **{f"wall_{k}": n for k, n in wall.items()}, **reduce}


def _tensors(value):
    """The tensors of a buffer value: a container's fields in order, a
    tuple's values' tensors in order, or the tensor itself."""
    if isinstance(value, tuple):
        return [t for v in value for t in _tensors(v)]
    if dataclasses.is_dataclass(value):
        return [getattr(value, f.name) for f in dataclasses.fields(value)
                if not f.metadata.get("static")]
    return [value]


def _map(fn, value):
    if isinstance(value, tuple):
        return tuple(_map(fn, v) for v in value)
    if dataclasses.is_dataclass(value):
        return value.replace(**{
            f.name: fn(getattr(value, f.name))
            for f in dataclasses.fields(value)
            if not f.metadata.get("static")})
    return fn(value)


def signature(value):
    """Shapes, dtypes and devices of a buffer value's tensors: what a
    captured graph is specialised to."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in _tensors(value))


def _snapshot(counters):
    return [dict(c) for c in counters]


class GraphRunner:
    """CUDA graphs of step units over static buffers (see the module
    docstring). ``buffers``: name -> container or tensor, cloned into the
    runner's own buffers."""

    def __init__(self, buffers: dict, capture_error_mode: str = "global"):
        self.buffers = {k: _map(torch.clone, v) for k, v in buffers.items()}
        self.capture_error_mode = capture_error_mode
        self.counters = kernel_counters() + (spans.host_counters(),)
        self.device = _tensors(next(iter(self.buffers.values())))[0].device
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}      # unit name -> (CUDAGraph, launch deltas)
        self.replays = collections.Counter()
        self.capture_s = 0.0  # warm-up and capture, all units
        self._flag = torch.zeros((), dtype=torch.bool, pin_memory=True)
        self._event = torch.cuda.Event()
        self._buffer_storage = {t.untyped_storage().data_ptr()
                                for v in self.buffers.values()
                                for t in _tensors(v)}

    def load(self, **values):
        """Copy the caller's values into the buffers of those names."""
        with spans.span("runner.load", self.device):
            for name, value in values.items():
                for dst, src in zip(_tensors(self.buffers[name]),
                                    _tensors(value)):
                    dst.copy_(src)

    def result(self, *names):
        """Clones of the named buffers."""
        with spans.span("runner.result", self.device):
            return tuple(_map(torch.clone, self.buffers[n]) for n in names)

    def _store(self, out: dict):
        """Copy a unit's outputs into the buffers (and its flag into the
        pinned host flag). An output that shares memory with a buffer (an
        unchanged field handed on under another name) is cloned first, so
        that no copy reads a buffer another copy already overwrote."""
        pairs = []
        for name, value in out.items():
            if name == "flag":
                pairs.append((self._flag, value))
                continue
            for dst, src in zip(_tensors(self.buffers[name]),
                                _tensors(value)):
                if src is dst:
                    continue
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(
                        f"a unit returned {tuple(src.shape)} {src.dtype} "
                        f"for a buffer of {name} of {tuple(dst.shape)} "
                        f"{dst.dtype}")
                pairs.append((dst, src))
        with spans.span("runner.store", self.device):
            pairs = [(d, s.clone() if s.untyped_storage().data_ptr()
                      in self._buffer_storage else s) for d, s in pairs]
            for dst, src in pairs:
                dst.copy_(src, non_blocking=dst is self._flag)

    def capture(self, name: str, unit):
        """Capture ``unit(buffers) -> {buffer name: new value[, "flag":
        0-d bool]}`` as the graph ``name``, after one eager run of it on a
        side stream whose outputs are dropped. Launch counters are left as
        they were before the warm-up, and so are the spans' counters."""
        t0 = time.perf_counter()
        with spans.host("spherharm.capture", name):
            before = _snapshot(self.counters)
            before_dev = spans.device_snapshot()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                unit(self.buffers)
            torch.cuda.current_stream().wait_stream(side)
            spans.restore_device(before_dev)
            warm = _snapshot(self.counters)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode=self.capture_error_mode):
                self._store(unit(self.buffers))
            delta = [{k: c[k] - w.get(k, 0) for k in c} for c, w in
                     zip(self.counters, warm)]
            for c, b in zip(self.counters, before):
                c.clear()
                c.update(b)
        self.graphs[name] = (graph, delta)
        self.capture_s += time.perf_counter() - t0

    def replay(self, name: str):
        graph, delta = self.graphs[name]
        with spans.host("spherharm.replay", name):
            graph.replay()
        for c, d in zip(self.counters, delta):
            for k, n in d.items():
                c[k] = c.get(k, 0) + n
        self.replays[name] += 1

    def read_flag(self) -> bool:
        """The flag of the last replayed unit that set one: one event
        synchronisation, then a read of pinned host memory."""
        self._event.record()
        self._event.synchronize()
        return bool(self._flag)

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds in this runner's pool."""
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == pool)


def same_config(a: dict, b: dict) -> bool:
    """Two ``config_of`` snapshots hold the same objects: the same object,
    or equal plain values (numbers, strings, tuples of them)."""

    def plain(v):
        return (v is None or isinstance(v, (bool, int, float, str))
                or (isinstance(v, tuple) and all(plain(e) for e in v)))

    return a.keys() == b.keys() and all(
        a[k] is b[k] or (plain(a[k]) and plain(b[k]) and a[k] == b[k])
        for k in a)


def config_of(sim) -> dict:
    """What a captured graph of ``sim`` holds fixed besides the buffers:
    every attribute but ``params`` (loaded into a buffer each run) and
    the graph cache."""
    return {k: v for k, v in vars(sim).items()
            if k not in ("params", "_graphs", "cuda_graphs")}


def params_view(sim, buffers: dict):
    """A shallow copy of ``sim`` that reads its params from the runner's
    ``params`` buffer: what a unit steps with."""
    view = copy.copy(sim)
    view.params = buffers["params"]
    return view


def cached_runner(sim, buffers: dict, names: tuple,
                  scratch=None,
                  capture_error_mode: str = "global") -> GraphRunner:
    """The GraphRunner of ``sim`` for the signature of ``buffers`` (name ->
    container or tensor, ``params`` among them), loaded with them, with
    the units ``names`` of ``sim._units()`` captured (in
    ``capture_error_mode``). ``scratch()``: the buffers a new runner adds
    that no caller loads (made only for a new runner). Runners are cached in
    ``sim._graphs`` (its shallow copies share the cache); the cache is
    dropped when an attribute the graphs hold fixed changed (walls, group
    fixes, shapes, ...): params are data, so a new params object of the
    same shapes reuses the graphs. The key holds the spans state
    (``spans.is_on()``): spans on and off keep runners of their own."""
    config = config_of(sim)
    if any(not same_config(r.config, config) for r in sim._graphs.values()):
        sim._graphs.clear()
    key = (spans.is_on(),) + tuple(signature(v) for v in buffers.values())
    runner = sim._graphs.get(key)
    if runner is None:
        runner = GraphRunner({**buffers, **(scratch() if scratch else {})},
                             capture_error_mode)
        runner.config = config
    runner.load(**buffers)
    units = sim._units()
    for name in names:
        if name not in runner.graphs:
            runner.capture(name, units[name])
    sim._graphs[key] = runner
    return runner


def graph_stats(sim) -> dict:
    """The totals of ``sim``'s cached runners: capture seconds (warm-up
    included), pool bytes, graphs captured, replays by unit."""
    runners = list(sim._graphs.values())
    replays = collections.Counter()
    for r in runners:
        replays.update(r.replays)
    return {"runners": len(runners),
            "capture_s": sum(r.capture_s for r in runners),
            "pool_bytes": sum(r.pool_bytes() for r in runners),
            "graphs": sum(len(r.graphs) for r in runners),
            "replays": dict(replays)}
