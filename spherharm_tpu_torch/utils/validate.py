"""Numerical sanitizers (torch twin of ``spherharm_tpu/utils/validate.py``).

NaN/Inf detection, capacity-overflow audits of the fixed-size tensors,
and determinism checks (same inputs => bitwise-identical outputs). The
force sums are sorted segment-sums, not atomics, so a run is meant to be
bitwise repeatable on one device.

Each audit also reads replica-stacked inputs (``parallel/ensemble.py``),
and then reports per replica.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def check_finite(state, where: str = "") -> None:
    """Raise FloatingPointError if a dynamic field of an active particle
    holds NaN/Inf (host-side audit). The message counts the bad values of
    each field, a list of one count a replica for stacked states."""
    act = state.active[..., None]
    bad = {}
    for f in ("x", "v", "q", "angmom", "f", "tau"):
        n_bad = (~torch.isfinite(getattr(state, f)) & act).sum((-2, -1))
        if bool(n_bad.any()):
            bad[f] = n_bad.tolist()
    if bad:
        raise FloatingPointError(f"non-finite state {where}: {bad}")


def audit_capacities(sim, neigh) -> dict:
    """Report the fixed capacities and the overflow channel.

    The channel is per-source gated: each count is folded in only when it
    exceeds its own capacity, so it is 0 in a healthy run and carries the
    exceeding count when any capacity was breached. Stacked lists give
    one channel a replica: a list of (overflow, 0)."""
    ovf = neigh.overflow
    channel = ([(int(o), 0) for o in ovf] if ovf.dim() else (int(ovf), 0))
    report = {"overflow_channel": channel, "k_max": sim.k_max}
    if sim.pair_capacity:
        report["pair_capacity"] = sim.pair_capacity
    return report


def assert_no_overflow(sim, neigh) -> None:
    """Raise if any fixed capacity was exceeded (gated channel != 0); with
    stacked lists, naming each replica that overflowed."""
    ovf = neigh.overflow
    if ovf.dim():
        bad = {r: int(o) for r, o in enumerate(ovf.tolist()) if o}
        where = f"replicas {bad} (replica: gated channel)"
    else:
        bad = int(ovf)
        where = f"gated channel = {bad}"
    if bad:
        raise RuntimeError(
            f"capacity overflow ({where}): physics was "
            "truncated — raise k_max / cell_cap / pair_capacity / "
            "stage2_capacity / wall_capacity")


def _named_leaves(obj, name: str = ""):
    """(name, array) of each array of a nested result (tensors, arrays,
    scalars inside tuples, lists, dicts and the port's dataclass
    containers), in a fixed order, as numpy; a field's name is its path
    (``x``, ``0.pair_hist``)."""
    sub = lambda key: f"{name}.{key}" if name else str(key)
    if dataclasses.is_dataclass(obj):
        return [a for f in dataclasses.fields(obj)
                for a in _named_leaves(getattr(obj, f.name), sub(f.name))]
    if isinstance(obj, dict):
        return [a for k in sorted(obj) for a in _named_leaves(obj[k], sub(k))]
    if isinstance(obj, (tuple, list)):
        return [a for i, v in enumerate(obj)
                for a in _named_leaves(v, sub(i))]
    if isinstance(obj, torch.Tensor):
        return [(name, obj.detach().cpu().numpy())]
    return [(name, np.asarray(obj))]


def _leaves(obj):
    return [a for _, a in _named_leaves(obj)]


def bitwise_differences(a, b) -> dict:
    """The arrays of two results (nested as ``_named_leaves`` reads them)
    that are not bit for bit equal: {name: largest absolute difference}
    (inf where shapes or dtypes differ; ``"<fields>"`` where the two
    hold different fields). Empty when the two are identical byte for
    byte."""
    la, lb = _named_leaves(a), _named_leaves(b)
    if [n for n, _ in la] != [n for n, _ in lb]:
        return {"<fields>": float("inf")}
    out = {}
    for (name, x), (_, y) in zip(la, lb):
        if x.shape == y.shape and x.dtype == y.dtype:
            if x.tobytes() == y.tobytes():
                continue
            d = np.abs(x.astype(np.float64) - y.astype(np.float64))
            out[name] = float(np.nan_to_num(d, nan=np.inf).max())
        else:
            out[name] = float("inf")
    return out


def determinism_check(run_fn, make_inputs, n: int = 2) -> bool:
    """Same inputs => bitwise-identical outputs: ``run_fn(*make_inputs())``
    ``n`` times, every output array compared bit for bit with the first
    run's."""
    ref = run_fn(*make_inputs())
    return all(not bitwise_differences(ref, run_fn(*make_inputs()))
               for _ in range(n - 1))
