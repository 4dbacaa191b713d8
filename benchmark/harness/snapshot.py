"""What the reference is handed of the program's state: plain tensors over
the active particles in tag order, and the pair list's rows by tag.

``single``: a one-process simulation's (state, neigh). ``shard``: one
rank's (state, neigh, ghosts) of a sharded run, its owned rows and the
rows of its pair list (owned i, owned or ghost j), with ``seam``: the
tags of its owned particles that have a ghost partner. ``merge`` joins
the shards' parts.
"""

from __future__ import annotations

import torch

FIELDS = ("x", "v", "q", "angmom", "f", "tau", "scale", "shtype")


def _box(state):
    return {k: getattr(state, k).detach().clone()
            for k in ("box_lo", "box_hi", "tilt")}


def _pairs(neigh, tag, active):
    pi, pj = neigh.pair_i, neigh.pair_j
    ok = neigh.pair_valid & active[pi] & active[pj]
    return tag[pi[ok]], tag[pj[ok]], neigh.pair_hist[ok].clone(), pi[ok], pj[ok]


def single(state, neigh) -> dict:
    act = state.active
    order = torch.argsort(state.tag[act])
    out = {f: getattr(state, f)[act][order].clone() for f in FIELDS}
    out["tag"] = state.tag[act][order].clone()
    out["tag_i"], out["tag_j"], out["spring"], _, _ = _pairs(
        neigh, state.tag, act)
    out["wall_hist"] = neigh.wall_hist[act][order].clone()
    out.update(_box(state))
    return out


def shard(state, neigh, ghosts) -> dict:
    st = state
    cl = st.x.shape[1]
    tag = torch.cat([st.tag[0], ghosts.tag[0]])
    active = torch.cat([st.active[0], ghosts.active[0]])
    out = {f: getattr(st, f)[0][st.active[0]].clone() for f in FIELDS}
    out["tag"] = st.tag[0][st.active[0]].clone()
    nb = neigh.replace(**{k: getattr(neigh, k)[0] for k in (
        "pair_i", "pair_j", "pair_valid", "pair_hist")})
    out["tag_i"], out["tag_j"], out["spring"], pi, pj = _pairs(nb, tag, active)
    out["seam"] = torch.unique(tag[pi[pj >= cl]])
    out.update(_box(st))
    return out


def merge(parts: list) -> dict:
    cat = lambda k: torch.cat([torch.as_tensor(p[k]) for p in parts])
    tag = cat("tag")
    order = torch.argsort(tag)
    out = {f: cat(f)[order] for f in FIELDS}
    out["tag"] = tag[order]
    for k in ("tag_i", "tag_j", "spring", "seam"):
        out[k] = cat(k)
    for k in ("box_lo", "box_hi", "tilt"):
        out[k] = torch.as_tensor(parts[0][k])
    return out


def to(snap: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in snap.items()}
