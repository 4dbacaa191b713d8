"""Faults planted under the timed path, for the tests that see ``correct``
come out false and for the readings behind the limits
(``readings.py``). Each patches the program in the process that runs it
(on ranks, ``fault_worker`` plants it in each rank).

* ``unchanged``: a step hands back the state it was given;
* ``no_second_kick``: the step's second half-kick is left out;
* ``plain_step_forgets_springs``: the cadence's plain steps (``never``)
  start from zero pair springs (a rebuild step keeps them);
* ``half_batch``: the pair forces of half the particles are left out;
* ``no_exchange``: the ghosts are never refreshed from their owners;
* ``altered``: one particle's pair force is altered where the law
  produces it;
* ``bf16``: the control, the law's bfloat16 path switched on.
"""

from __future__ import annotations

import torch


def apply(name: str, put=setattr):
    """Plant fault ``name``; ``put(obj, attr, value)`` sets each patch
    (pytest's ``monkeypatch.setattr`` undoes them after a test)."""
    from spherharm_tpu_torch.core.simulation import Simulation
    from spherharm_tpu_torch.ops import contact, integrate
    from spherharm_tpu_torch.ops import contact_kernels as ck
    from spherharm_tpu_torch.parallel.halo import ShardedSimulation

    if name == "unchanged":
        put(Simulation, "run", lambda self, state, neigh, n: (state, neigh))
        put(ShardedSimulation, "run", lambda self, st, ng, gh, n: (st, ng, gh))
    elif name == "plain_step_forgets_springs":
        core = Simulation._step_core

        def forgetful(self, state, neigh, rebuild):
            if rebuild == "never":
                neigh = neigh.replace(pair_hist=torch.zeros_like(neigh.pair_hist))
            return core(self, state, neigh, rebuild)

        put(Simulation, "_step_core", forgetful)
    elif name == "no_second_kick":
        put(integrate, "final_integrate", lambda state, shapes, params: state)
    elif name in ("half_batch", "altered"):
        law = contact.contact_force_pairs

        def broken(state, *a, **k):
            f, tau, hist, pe, vir = law(state, *a, **k)
            if name == "half_batch":
                keep = (torch.arange(f.shape[-2], device=f.device) % 2 == 0)
                f = f * keep[:, None]
            else:
                flat = f.reshape(-1, 3).clone()
                top = torch.argmax(torch.linalg.norm(flat, dim=-1))
                flat[top] = 1.5 * flat[top]
                f = flat.reshape(f.shape)
            return f, tau, hist, pe, vir

        put(contact, "contact_force_pairs", broken)
    elif name == "no_exchange":
        put(ShardedSimulation, "_forward_comm", lambda self, state, ghosts: ghosts)
    elif name == "bf16":
        put(ck, "STAGE2_BF16", True)
    else:
        raise ValueError(f"unknown fault {name!r}")


def fault_worker(axis, spec, seed, seconds, trace):
    """``ranks.rank_worker`` with the fault ``spec["fault"]`` planted in
    the rank first."""
    from benchmark.harness import ranks

    apply(spec["fault"])
    return ranks.rank_worker(axis, spec, seed, seconds, trace)
