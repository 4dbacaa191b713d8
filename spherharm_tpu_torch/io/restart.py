"""Binary checkpoint / restart of the full simulation state (torch twin of
``spherharm_tpu/io/restart.py``).

One ``.npz`` holds the State, the NeighborState with its contact history
(tangential and rolling springs and their tag keys) and the SimParams,
under the reference's keys (``state.<field>``, ``neigh.<field>``,
``params.<field>``, ``extra.<key>``), so a restart written by either
package loads into the other and the run continues (a sheared
triaxial cell too: ``state.tilt`` and ``params.shear_rate`` carry it).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from spherharm_tpu_torch.core.state import (NeighborState, SimParams, State,
                                            to_numpy)


def _fields(cls):
    return tuple(f.name for f in dataclasses.fields(cls))


_STATE_FIELDS = _fields(State)
_NEIGH_FIELDS = _fields(NeighborState)
_PARAM_FIELDS = _fields(SimParams)


def write_restart(path, state: State, neigh: NeighborState | None,
                  params: SimParams, extra: dict | None = None):
    """Serialize (state, neighbours + history, params) to one .npz file;
    ``neigh=None`` writes a state-only checkpoint."""
    blob = {f"state.{f}": to_numpy(getattr(state, f)) for f in _STATE_FIELDS}
    for f in _NEIGH_FIELDS if neigh is not None else ():
        blob[f"neigh.{f}"] = to_numpy(getattr(neigh, f))
    for f in _PARAM_FIELDS:
        blob[f"params.{f}"] = to_numpy(getattr(params, f))
    for k, v in (extra or {}).items():
        blob[f"extra.{k}"] = to_numpy(v)
    np.savez_compressed(path, **blob)


def read_restart(path, device="cuda"):
    """Load (state, neigh, params, extra) onto ``device``. Fields missing
    from an older file get the reference's structural defaults: identity
    build orientations and zero motion budgets (the first rebuild
    refreshes both), and the scalar-broadcast per-type-pair table."""
    # np.savez appends ".npz" when missing; accept the bare name too.
    if not os.path.exists(path) and os.path.exists(f"{path}.npz"):
        path = f"{path}.npz"
    with np.load(path) as z:
        files = set(z.files)
        state = State.from_numpy({f: z[f"state.{f}"] for f in _STATE_FIELDS},
                                 device=device)
        neigh = None
        if f"neigh.{_NEIGH_FIELDS[0]}" in files:
            nvals = {f: z[f"neigh.{f}"] for f in _NEIGH_FIELDS
                     if f"neigh.{f}" in files}
            cap = nvals["x_build"].shape[0]
            dt = nvals["x_build"].dtype
            if "q_build" not in nvals:
                q_build = np.zeros((cap, 4), dt)
                q_build[:, 0] = 1.0
                nvals["q_build"] = q_build
            if "budget" not in nvals:
                nvals["budget"] = np.zeros((cap,), dt)
            neigh = NeighborState.from_numpy(nvals, device=device)
        pvals = {f: z[f"params.{f}"] for f in _PARAM_FIELDS
                 if f"params.{f}" in files}
        if "pair_tab" not in pvals:
            pvals["pair_tab"] = np.stack(
                [pvals[k] for k in ("kn", "kt", "gamma_n", "gamma_t", "mu",
                                    "k_roll", "gamma_roll", "mu_roll")]
            ).reshape(1, 1, 8)
        params = SimParams.from_numpy(pvals, device=device)
        extra = {k[len("extra."):]: z[k] for k in z.files
                 if k.startswith("extra.")}
    return state, neigh, params, extra
