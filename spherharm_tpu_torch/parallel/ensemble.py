"""Replica ensembles: independent simulations advanced together
(parameter sweeps).

Torch twin of ``spherharm_tpu/parallel/ensemble.py``, the counterpart of
LAMMPS multi-partition replica runs. The reference vmaps the whole step:
one program advances R replicas that differ in state and/or physics
parameters (a friction sweep, a restitution curve). Here every State,
NeighborState and SimParams tensor carries a leading replica axis and
each op of the step runs once over all R replicas: the pair kernel sees
the R pair lists replica-major ([R * Pc, 64] rows, ``par`` [R, 16]), the
wall kernel the R batches ([R * B, 32], ``par`` [R, 24]), the stage-1
probe the R candidate lists, each launched once a step whatever R is.
Lists compact per replica, each into its own capacity, with its own
overflow channel.

    states = ensemble.replicate(state, R)
    neighs = ensemble.replicate(neigh, R)
    params = ensemble.with_param_sweep(sim.params, mu=np.linspace(.1, .8, R))
    states, neighs = ensemble.run_replicas(sim, states, neighs, params, n)
    th = ensemble.thermo(sim, states, neighs, params)  # [R] scalars
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from spherharm_tpu_torch.core.state import SimParams


def _fields(obj):
    return [f for f in dataclasses.fields(obj)
            if not f.metadata.get("static")]


def _map(fn, obj):
    """``obj`` with ``fn`` applied to each tensor field (static fields and
    None kept)."""
    return obj.replace(**{
        f.name: fn(getattr(obj, f.name)) for f in _fields(obj)
        if getattr(obj, f.name) is not None})


def replicate(obj, n: int):
    """Tile a container (State, NeighborState, SimParams) along a new
    leading replica axis: every tensor gains a leading [n], 0-d ones
    included (``overflow``, ``skin_violations``, ``step``, the SimParams
    scalars). Each replica gets its own copy."""
    return _map(lambda t: t.expand((n,) + t.shape).contiguous(), obj)


def stack_replicas(objs):
    """Stack containers of one kind (distinct initial conditions, each
    from ``Simulation.init_neighbors`` of its own state) along a new
    leading replica axis: the reference's ``jax.tree.map(jnp.stack, ...)``.
    """
    first = objs[0]
    return first.replace(**{
        f.name: torch.stack([getattr(o, f.name) for o in objs])
        for f in _fields(first) if getattr(first, f.name) is not None})


def replica(obj, r: int):
    """Replica ``r`` of a stacked container, as a single one."""
    return _map(lambda t: t[r], obj)


# SimParams material scalars mirrored into the per-type-pair table
# (core.state.pair_material reads the table, not the scalars).
_MAT_SLOT = {"kn": 0, "kt": 1, "gamma_n": 2, "gamma_t": 3, "mu": 4,
             "k_roll": 5, "gamma_roll": 6, "mu_roll": 7}


def with_param_sweep(params: SimParams, **overrides) -> SimParams:
    """Replica-stack params with per-replica values for chosen fields.

    Example: ``with_param_sweep(params, mu=np.linspace(0.1, 0.9, 8))``
    returns params with every field tiled to [R, ...] and ``mu`` varying.
    Values take the field's dtype and device; every sweep has the same
    length R.

    Sweeping a material scalar (kn, mu, ...) also overrides that slot of
    the WHOLE pair_tab, which becomes [R, T, T, 8]: material sweeps are
    global; per-type-pair tables and sweeps don't compose (sweep pair_tab
    directly for that)."""
    if not overrides:
        raise ValueError("with_param_sweep: no field to sweep")
    lengths = {k: len(v) for k, v in overrides.items()}
    n = next(iter(lengths.values()))
    if any(v != n for v in lengths.values()):
        raise ValueError(f"sweep lengths differ: {lengths}")
    stacked = replicate(params, n)
    for k, v in overrides.items():
        ref = getattr(params, k)
        val = torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
        if val.shape != (n,) + ref.shape:
            raise ValueError(f"sweep of {k}: shape {tuple(val.shape)}, "
                             f"expected {(n,) + tuple(ref.shape)}")
        stacked = stacked.replace(**{k: val})
        if k in _MAT_SLOT:
            pt = stacked.pair_tab.clone()  # [R, T, T, 8]
            pt[..., _MAT_SLOT[k]] = val.to(pt.dtype).reshape(-1, 1, 1)
            stacked = stacked.replace(pair_tab=pt)
    return stacked


def _rebind(sim, params):
    """A Simulation view with replica-stacked params (same static
    config, the same graph cache)."""
    s = copy.copy(sim)
    s.params = params
    return s


def _check(states, neighs, params):
    if not states.replicas:
        raise ValueError("states carry no replica axis: ensemble.replicate "
                         "or ensemble.stack_replicas them")
    R = states.x.shape[0]
    got = {"neighs": neighs.idx.shape[0] if neighs.idx.dim() == 3 else None,
           "params": params.dt.shape[0] if params.dt.dim() == 1 else None}
    if any(v != R for v in got.values()):
        raise ValueError(f"{R} replicas of state, but {got}")


def run_replicas(sim, states, neighs, params_stack, n_steps: int):
    """Advance R independent replicas of a Simulation together.

    states/neighs: containers with a leading replica axis (``replicate``
    or ``stack_replicas``); params_stack: per-replica SimParams
    (``with_param_sweep``). Returns (states, neighs) with the replica axis.

    Runs what the reference runs under vmap, ``sim.run_inline``:
    ``sim.step`` n_steps times, that is the skin-trigger check on every
    step, even where ``sim.rebuild_every > 0`` (the static cadence is
    ``run``'s, not the step's); static neighbour mode never rebuilds. A
    replica rebuilds exactly when its own trigger fires: each step reads
    "any replica stale" once on the host, rebuilds, and keeps the rebuild
    only for the stale replicas. Every kernel launches once a step for all
    R, and a rebuild step counts once whichever replicas triggered it. On
    the card the steps are CUDA graph replays; the graphs are cached on
    ``sim`` (the rebound view shares its cache) and the params are loaded
    into them on each call, so a new sweep of the same shapes reuses them.
    """
    _check(states, neighs, params_stack)
    return _rebind(sim, params_stack).run_inline(states, neighs, n_steps)


def thermo(sim, states, neighs, params_stack) -> dict:
    """Per-replica thermo: ``Simulation.thermo``'s scalars, each [R] (the
    stress tensor [R, 3, 3]), the counterpart of vmapping ``sim.thermo``.
    """
    _check(states, neighs, params_stack)
    return _rebind(sim, params_stack).thermo(states, neighs)
