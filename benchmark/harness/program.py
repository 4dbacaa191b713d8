"""The system under test, built from a configuration. The harness imports
the program (``spherharm_tpu_torch``) only here, in ``builders/`` and in
the ranks' launcher; ``window`` and ``snapshot`` read the tensors it
hands back."""

from __future__ import annotations

import torch

from benchmark.harness import inputs


def build(cfg, geo, device, axis=None, cuda_graphs=True):
    """The program's simulation for a configuration: its shape tables and
    parameters here, the simulation from the configuration's builder
    (``axis``: a rank's transport where the builder shards)."""
    from spherharm_tpu_torch.core.state import SimParams
    from spherharm_tpu_torch.models import shapes_library

    shapes = shapes_library.build_shapes(
        geo["coeffs"], cfg["lmax"], density=cfg["density"],
        contact_quad=tuple(cfg["contact_quad"]) if cfg.get("contact_quad")
        else None, device=device)
    kt, gt = geo["mat"][1], geo["mat"][3]
    params = SimParams.create(
        dt=cfg["dt"], kn=cfg["kn"], kt=kt, gamma_n=cfg["gamma_n"],
        gamma_t=gt, mu=cfg["mu"], k_roll=cfg.get("k_roll", 0.0),
        gamma_roll=cfg.get("gamma_roll", 0.0), mu_roll=cfg.get("mu_roll", 0.0),
        gravity=geo["gravity"], skin=geo["skin"], cutoff=geo["cutoff"],
        deform_rate=geo["deform_rate"], shear_rate=geo["shear_rate"],
        device=device)
    return inputs.builder(cfg).simulation(cfg, geo, shapes, params, device,
                                          axis=axis, cuda_graphs=cuda_graphs)


def start_state(start, device):
    """The program's State of a start (``starts.make_start``)."""
    from spherharm_tpu_torch.core.state import zeros_state

    n = start["x"].shape[0]
    st = zeros_state(n, start["box_lo"], start["box_hi"], device=device)
    f32 = lambda t: t.to(device=device, dtype=torch.float32)
    return st.replace(
        x=f32(start["x"]), v=f32(start["v"]), q=f32(start["q"]),
        scale=f32(start["scale"]), shtype=start["shtype"].to(device),
        tag=torch.arange(1, n + 1, device=device),
        active=torch.ones(n, dtype=torch.bool, device=device),
        tilt=torch.tensor(start["tilt"], dtype=torch.float32, device=device))


def initialise(sim, state):
    """The first build and force pass: (state, neigh) or, sharded,
    (state, neigh, ghosts)."""
    if hasattr(sim, "init"):
        return sim.init(state)
    return sim.init_neighbors(state)


def launch_counts() -> dict:
    from spherharm_tpu_torch.core import runner

    return runner.launch_counts()


def thermo(sim, carry) -> dict:
    return sim.thermo(*carry)
