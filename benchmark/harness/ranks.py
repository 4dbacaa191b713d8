"""The sharded cells: one rank a card over NCCL, started with the program's
``parallel/ranks.spawn_ranks`` (its FileStore in a fresh directory under
TMPDIR). Each rank builds its slab of the same start, warms up, runs the
window between barriers (the ranks stop together: an all-reduce of their
clocks after each block), reduces its own traced slice, takes its part of
the judged steps, and returns it all; a rank that fails fails the run.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import cell, inputs, snapshot


def rank_worker(axis, spec, seed, seconds, trace):
    """One rank's part of the run (``cell.measure`` on its slab); the
    coordinates and the guards come back for the parent to merge."""
    import torch.distributed as dist

    dev = axis.device
    bar = {"device_ids": [dev.index]} if dev.type == "cuda" else {}

    def stop(done):
        flag = torch.tensor([float(done)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    res = cell.measure(spec, seed, seconds, trace, dev, time.time(),
                       axis=axis, stop=stop, barrier=lambda: dist.barrier(**bar))
    res.pop("geo")
    res["checks"] = {k: list(v) for k, v in res["checks"].items()}
    res["forbidden"] = cell.forbidden_modules()
    return res


def run_ranks(spec, seed, seconds, trace, t_process, device="cuda",
              worker=rank_worker) -> dict:
    """The ranks' run: NCCL with a card a rank, or gloo on the CPU; each
    rank runs ``worker`` (``rank_worker``'s arguments and result)."""
    from spherharm_tpu_torch.parallel.ranks import spawn_ranks

    S = spec["cfg"]["shards"]
    cuda = torch.device(device).type == "cuda"
    devices = ([torch.device("cuda", r) for r in range(S)] if cuda
               else ["cpu"] * S)
    out = spawn_ranks(worker, S, "nccl" if cuda else "gloo", devices,
                      spec, seed, seconds, trace,
                      timeout=spec["traffic"]["rank_timeout_s"])
    bad = sorted({m for r in out for m in r["forbidden"]})
    if bad:
        raise RuntimeError(f"a rank loaded modules of the JAX package: {bad}")
    r0 = out[0]
    checks = {}
    for r in out:
        for k, (v, lim) in r["checks"].items():
            checks[k] = (max(v, checks.get(k, (v, lim))[0]), lim)
    ev = [{k: max(r["evidence"][i][k] for r in out) for k in r0["evidence"][i]}
          for i in (0, 1)]
    counts = {k: min(r["counts"].get(k, 0) for r in out) for k in r0["counts"]}
    geo = inputs.deployment(spec["cfg"])
    return dict(setup_s=min(r["t_window"] for r in out) - t_process,
                setup_parts=r0["setup_parts"],
                steps=r0["steps"], elapsed=max(r["elapsed"] for r in out),
                n=spec["cfg"]["n"], peak=max(r["peak"] for r in out),
                counts=counts, rebuilds=r0["rebuilds"],
                slices=[s for r in out for s in r["slices"]],
                slice_steps=r0["slice_steps"],
                pair_steps=sum(r["pair_steps"] for r in out),
                evidence=ev, checks=checks, geo=geo, chips=S,
                snaps=[tuple(snapshot.merge([r["snaps"][i][k] for r in out])
                             for k in (0, 1))
                       for i in range(len(r0["snaps"]))])
