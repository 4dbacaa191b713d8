"""Start states, one module a start, named by a traffic file's ``"start"``
and found by that name: each has ``make(cfg, geo, traffic, gen, device)
-> dict`` (x, v, q, scale, shtype, box_lo, box_hi, tilt), drawn on the
device from the run's seed through ``gen``. Every seed gets the same
geometry and the same distributions, drawn in another order.
"""

from __future__ import annotations

import importlib

import torch


def orientations(n, gen, device):
    """Uniform random unit quaternions [n, 4] (float64)."""
    q = torch.randn((n, 4), generator=gen, device=device, dtype=torch.float64)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def make_start(cfg, geo, traffic, seed: int, device):
    """The start the traffic names, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    mod = importlib.import_module(f"benchmark.starts.{traffic['start']}")
    return mod.make(cfg, geo, traffic, gen, torch.device(device))
