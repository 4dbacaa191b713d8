"""The measured window: the program's own entry (``run``) driven in blocks
of whole steps until the window's seconds have passed, and, in a traced
run, a slice of it under the profiler.

One block stays queued behind the one running (a CUDA event each), so
the host never waits on an idle card and the window overshoots its
seconds by at most a block. The window ends in a synchronisation; a
sharded run decides to stop together (``stop``: an all-reduce of the
ranks' clocks) and is timed between barriers by its caller.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import trace as trace_mod
from benchmark.reference import motion


def rebuild_replays(sim) -> int:
    """Replays of the rebuild units so far (``graph_stats``)."""
    rep = sim.graph_stats()["replays"]
    return sum(rep.get(k, 0) for k in ("always", "rebuild", "rebuild_post"))


def law_inputs(carry):
    """The fields ``law_rows`` reads, kept from a carry (the tensors a run
    hands back are its own, so holding them costs no copy)."""
    state, neigh = carry[0], carry[1]
    if len(carry) == 3:  # a shard: owned rows, then the ghosts
        g = carry[2]
        both = lambda f: (getattr(state, f)[0], getattr(g, f)[0])
        return dict(x=both("x"), shtype=both("shtype"), scale=both("scale"),
                    active=both("active"), pair_i=neigh.pair_i[0],
                    pair_j=neigh.pair_j[0], pair_valid=neigh.pair_valid[0],
                    box=(state.box_lo, state.box_hi, state.tilt), shard=True)
    return dict(x=state.x, shtype=state.shtype, scale=state.scale,
                active=state.active, pair_i=neigh.pair_i, pair_j=neigh.pair_j,
                pair_valid=neigh.pair_valid,
                box=(state.box_lo, state.box_hi, state.tilt), shard=False)


def law_rows(kept, ref_rb, periodic) -> int:
    """Pairs of the list whose bounding spheres overlap (the law's cull)
    at the kept positions (a shard's x seam is explicit: not periodic)."""
    if kept["shard"]:
        periodic = (False,) + tuple(periodic[1:])
        kept = {k: torch.cat(v) if k in ("x", "shtype", "scale", "active")
                else v for k, v in kept.items()}
    x, act = kept["x"], kept["active"]
    pi, pj, ok = kept["pair_i"], kept["pair_j"], kept["pair_valid"]
    rb = ref_rb.to(x.device, torch.float32)[kept["shtype"]] * kept["scale"]
    lo, hi, tilt = kept["box"]
    d = motion.minimum_image(x[pj] - x[pi], lo, hi, periodic, tilt)
    reach = rb[pi] + rb[pj]
    return int((ok & act[pi] & act[pj]
                & ((d * d).sum(-1) < reach * reach)).sum())


class Window:
    """Drives ``sim.run(*carry, n)``: ``carry`` the (state, neigh[,
    ghosts]) the run hands on."""

    def __init__(self, sim, carry, cuda: bool):
        self.sim, self.carry, self.cuda = sim, carry, cuda

    def step(self, n):
        self.carry = self.sim.run(*self.carry, n)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def run(self, seconds, block, stop=None):
        """Blocks until ``seconds`` have passed; returns (steps, seconds)
        between synchronisations."""
        self.sync()
        t0 = time.perf_counter()
        steps, pending = 0, None
        while True:
            self.step(block)
            steps += block
            if self.cuda:
                ev = torch.cuda.Event()
                ev.record()
                if pending is not None:
                    pending.synchronize()
                pending = ev
            done = time.perf_counter() - t0 >= seconds
            if stop is not None:
                done = stop(done)
            if done:
                break
        self.sync()
        return steps, time.perf_counter() - t0

    def judged(self, pairs, snap):
        """Snapshots ``snap(*carry)`` (before, after) of the judged steps:
        for each (a, b) of ``pairs``, the states ``a`` and ``b`` steps on
        from the window's last state, each through one ``run`` as the
        window calls it (a run hands back new tensors and leaves the
        state it was given as it was). With a = b - 1 the reference redoes
        step b from the state after a: with b = 1 a run's first step (the
        cadence's rebuild step), with b = R its R-th (the cadence's plain
        step on a list R - 1 steps old)."""
        end, snaps = self.carry, {}
        for k in sorted({k for p in pairs for k in p}):
            snaps[k] = snap(*(self.sim.run(*end, k) if k else end))
        return [(snaps[a], snaps[b]) for a, b in pairs]

    def traced_slice(self, steps, ref_rb, periodic):
        """One run of ``steps`` steps under the profiler, as the window runs
        its blocks. Returns (slice summary, pairs that needed the law summed
        over the slice's steps: the lesser count of its two ends)."""
        ends = [law_inputs(self.carry)]
        _, summary = trace_mod.profiled(lambda: self.step(steps))
        ends.append(law_inputs(self.carry))
        return summary, steps * min(law_rows(k, ref_rb, periodic) for k in ends)
