"""Single-collision energy-error probe (the port's copy of the reference
harness ``scripts/conservative_probe.py``).

One deterministic head-on collision of two Lmax-8 blobs (undamped,
frictionless) from free flight to free flight, integrated with the
quaternion velocity-Verlet steps under three force laws:

* ``geom`` — the production geometric law,
  ``contact_kernels.pair_contact_indexed`` on the one pair (K2 on the
  card);
* ``auto`` — F = -dU/dx, tau from dU/dq by ``torch.autograd`` of the SAME
  sampled PE, the pe output of the geometric law's plain twin
  (``pair_contact_plain``; a kernel has no gradient), as the reference
  differentiates ``pair_contact_rows(...)[4]``: conservative by
  construction up to integrator error;
* ``cons`` — the conservative law (K1), ``Simulation(conservative=True)``'s
  elastic forces; its energy counts the PE it is the gradient of.

and prints dE/E across the bounce for each.

    python -m spherharm_tpu_torch.validation.conservative_probe [n_steps] [dt] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spherharm_tpu_torch.core import runner as runner_mod
from spherharm_tpu_torch.core.state import SimParams
from spherharm_tpu_torch.models import scenarios, shapes_library
from spherharm_tpu_torch.ops import contact, integrate
from spherharm_tpu_torch.ops import contact_kernels as ck

MODES = ("geom", "auto", "cons")


def build(dt, kn=1e5, lmax=8, v0=0.5, device="cuda"):
    """Two blobs (seeds 3 and 5, mean radius 0.5, roughness 0.12) on a
    10 x 20 cap grid, 1.5 apart along x (slightly offset), approaching at
    v0 each, random orientations. Returns (shapes, params, state)."""
    coeffs = [shapes_library.blob_coeffs(lmax, seed=s, mean_radius=0.5,
                                         roughness=0.12)
              for s in (3, 5)]
    shapes = shapes_library.build_shapes(coeffs, lmax, contact_quad=(10, 20),
                                         device=device)
    params = SimParams.create(dt=dt, kn=kn, gamma_n=0.0, mu=0.0, skin=0.2,
                              cutoff=1.4, device=device)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = scenarios.make_state(
        [[-0.75, 0.02, -0.03], [0.75, 0.0, 0.0]], [-4, -4, -4], [4, 4, 4],
        q=q, v=[[v0, 0.0, 0.0], [-v0, 0.0, 0.0]], shtype=[0, 1],
        device=device)
    return shapes, params, state


def make_force_fns(shapes, params):
    """{mode: forces(state) -> (f [2, 3], tau [2, 3])} and
    pe_of(state, conservative) -> the sampled elastic PE of the pair
    (0-d), each over the one slot (0, 1) with zero springs. The box is not
    periodic: d = x_1 - x_0."""
    periodic = (False, False, False)

    def slot(state):
        pi = torch.zeros(1, dtype=torch.long, device=state.x.device)
        return (pi, pi + 1, torch.ones(1, dtype=torch.bool, device=pi.device),
                state.x.new_zeros((1, 6)))

    def kernel_row(state, conservative):
        rows = contact.particle_rows(state, shapes)
        return ck.pair_contact_indexed(
            rows, state.shtype, *slot(state), params.pair_tab,
            *ck.pair_tables(shapes, params, rows.dtype),
            ck.box_rows(state.box_lo, state.box_hi, None, 1), periodic,
            lmax=shapes.lmax, conservative=conservative, bf16=False)[0]

    def packed(state):
        pi, pj, mask, hist = slot(state)
        return ck.pack_pairs(state, shapes, params, pi, pj, mask, hist,
                             state.x[1:2] - state.x[0:1])

    def law(conservative):
        def forces(state):
            out = kernel_row(state, conservative)
            return (torch.stack([out[0:3], -out[0:3]]),
                    torch.stack([out[3:6], out[6:9]]))
        return forces

    def forces_auto(state):
        with torch.enable_grad():
            x = state.x.detach().requires_grad_(True)
            q = state.q.detach().requires_grad_(True)
            pe = ck.pair_contact_plain(*packed(state.replace(x=x, q=q)),
                                       lmax=shapes.lmax, conservative=False)
            gx, gq = torch.autograd.grad(pe[:, 15].sum(), (x, q))
        f, tau = -gx, contact.quat_torque(state.q, gq)
        # Dead branches NaN the gradient out of contact, where the force
        # is exactly zero: mask the pair's rows, as the reference does.
        ok = torch.isfinite(f).all() & torch.isfinite(tau).all()
        return torch.where(ok, f, 0.0), torch.where(ok, tau, 0.0)

    def pe_of(state, conservative):
        return kernel_row(state, conservative)[15]

    return ({"geom": law(False), "auto": forces_auto, "cons": law(True)},
            pe_of)


def run(mode: str, n_steps: int, dt: float, device="cuda", out=print):
    """The bounce under ``mode``'s forces for ``n_steps`` velocity-Verlet
    steps; prints dE/E and returns (dE/E, the least centre distance,
    sampled every 50 steps). The energy is ke + erot + the law's sampled
    PE (the geometric one for geom and auto).

    A step is two units: ``pre`` (the first half-step, and whether the
    bounding spheres overlap) and ``post`` (the forces, the second
    half-step). ``auto`` reads that flag each step and runs its autograd
    only where it is set: elsewhere the law culls the pair and its force
    is exactly zero (the ``free`` unit). On CUDA tensors the units are
    CUDA graphs (``core/runner.GraphRunner``), as ``Simulation.run``'s
    are; on the CPU they run eagerly."""
    shapes, params, state = build(dt, device=device)
    forces, pe_of = make_force_fns(shapes, params)
    force = forces[mode]
    conservative = mode == "cons"
    rsum = float((shapes.rmax[state.shtype] * state.scale).sum())

    def pre(b):
        st = integrate.initial_integrate(b["state"], shapes, params)
        return {"state": st,
                "flag": torch.linalg.norm(st.x[1] - st.x[0]) < rsum}

    def post_with(fn):
        def unit(b):
            f, tau = fn(b["state"])
            return {"state": integrate.final_integrate(
                b["state"].replace(f=f, tau=tau), shapes, params)}
        return unit

    zero = lambda st: (torch.zeros_like(st.x), torch.zeros_like(st.x))
    units = {"pre": pre, "post": post_with(force), "free": post_with(zero)}
    if state.x.is_cuda:
        runner = runner_mod.GraphRunner({"state": state})
        for name, unit in units.items():
            runner.capture(name, unit)
        replay = runner.replay
        flag = runner.read_flag
        current = lambda: runner.buffers["state"]
    else:
        buf = {"state": state}

        def replay(name):
            buf.update(units[name](buf))

        flag = lambda: bool(buf["flag"])
        current = lambda: buf["state"]

    def energy(state):
        ke_t, ke_r = integrate.kinetic_energy(state, shapes)
        pe = pe_of(state, conservative)
        return float(ke_t + ke_r + pe), float(pe)

    def gap(state):
        return float(torch.linalg.norm(state.x[1] - state.x[0]))

    e0, _ = energy(state)
    min_gap = 1e9
    for i in range(n_steps):
        replay("pre")
        replay("free" if mode == "auto" and not flag() else "post")
        if i % 50 == 0:
            min_gap = min(min_gap, gap(current()))
    state = current()
    e1, pe1 = energy(state)
    err = (e1 - e0) / e0
    out(f"{mode:5s}: e0 {e0:.8g} -> e1 {e1:.8g}  dE/E {err:+.3e}  "
        f"(min gap {min_gap:.3f}, final gap {gap(state):.3f}, pe1 {pe1:.2e})")
    return err, min_gap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_steps", type=int, nargs="?", default=8000)
    ap.add_argument("dt", type=float, nargs="?", default=1e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    err = {m: run(m, args.n_steps, args.dt, args.device,
                  out=lambda s: print(s, flush=True))[0] for m in MODES}
    print(f"# improvement factor: "
          f"{abs(err['geom']) / max(abs(err['auto']), 1e-15):.1f}x")
    print("# RESULT: dE/E over one bounce: "
          + ", ".join(f"{m} {err[m]:+.3e}" for m in MODES))
    return 0


if __name__ == "__main__":
    sys.exit(main())
