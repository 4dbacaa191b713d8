"""Energy drift of the Lmax-0 collider (the port's copy of the reference
harness ``scripts/drift.py``).

Two undamped Lmax-0 SH spheres in a box periodic along x: they collide,
separate, wrap around and collide again forever, so the Hertzian contact
path runs thousands of times per million steps. Energy is sampled only in
free flight (pe_pair == 0): mid-contact samples would fold in the
analytic-PE-vs-quadrature-force mismatch, a bounded bias, not drift.

    python -m spherharm_tpu_torch.validation.drift [n_steps] [block] \\
        [--device cuda]

prints one line per free-flight sample and ``# RESULT: ... per 1M
steps`` against the reference's <1 % target (``BASELINE.json``).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.core.state import SimParams
from spherharm_tpu_torch.models import scenarios, shapes_library


def build(dt=2e-4, radius=0.5, v0=1.0, kn=1e5, device="cuda"):
    """The reference's ``build_collider``: returns (sim, state, neigh)."""
    lmax = 0
    shapes = shapes_library.build_shapes(
        [shapes_library.sphere_coeffs(radius, lmax)], lmax,
        contact_quad=(12, 24), device=device)
    params = SimParams.create(
        dt=dt, kn=kn, gamma_n=0.0, mu=0.0,
        skin=0.12 * radius, cutoff=2.0 * radius * 1.02, device=device)
    Lx = 6.0 * radius  # both images separated by 3R at start
    state = scenarios.make_state(
        [[1.5 * radius, 0.0, 0.0], [4.5 * radius, 0.0, 0.0]],
        [0.0, -radius * 2, -radius * 2], [Lx, radius * 2, radius * 2],
        v=[[v0, 0.0, 0.0], [-v0, 0.0, 0.0]],  # approach -> collide -> wrap
        device=device)
    sim = Simulation(shapes, params, neighbor_mode="allpairs", k_max=1,
                     periodic=(True, False, False), device=device)
    state, neigh = sim.init_neighbors(state)
    return sim, state, neigh


def device_name(device):
    """The card's name, or "cpu"."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def free_flight(sim, state, neigh, n_steps, block, out=print):
    """``n_steps`` steps of ``sim.run`` in blocks of ``block``, etot read
    after each block and kept where pe_pair == 0 (free flight). Raises
    unless the run starts in free flight. Prints one line a kept sample
    through ``out``. Returns a dict: e0, samples [(step, etot, drift per
    1M steps)], contact_steps (the steps whose sample was mid-contact),
    steps, seconds (wall clock of the blocks and their reads), overflow,
    state, neigh."""
    t0 = sim.thermo(state, neigh)
    if float(t0["pe_pair"]) != 0.0:
        raise RuntimeError("must start in free flight")
    e0 = float(t0["etot"])
    out(f"# e0 = {e0:.8g}  (ke {float(t0['ke']):.6g} "
        f"erot {float(t0['erot']):.6g})")
    done, samples, contact_steps = 0, [], []
    tw = time.perf_counter()
    while done < n_steps:
        state, neigh = sim.run(state, neigh, block)
        done += block
        t = sim.thermo(state, neigh)
        if float(t["pe_pair"]) > 0:
            contact_steps.append(done)
            continue  # mid-contact: skip (bounded PE-definition bias)
        e = float(t["etot"])
        drift = (e - e0) / abs(e0)
        per_m = drift * (1_000_000 / done)
        samples.append((done, e, per_m))
        out(f"step {done:>9d}  etot {e:.8g}  drift {drift:+.3e}  "
            f"-> {per_m:+.4%} / 1M steps")
    return dict(e0=e0, samples=samples, contact_steps=contact_steps,
                steps=done, seconds=time.perf_counter() - tw,
                overflow=int(neigh.overflow), state=state, neigh=neigh)


def summary(sim, res, out=print):
    """The run's rate and overflow, and the drift of its last free-flight
    sample (None where every sample was mid-contact)."""
    out(f"# {res['steps']} steps in {res['seconds']:.1f}s: "
        f"{res['steps'] / res['seconds']:.0f} steps/s on {device_name(sim.device)}; "
        f"{len(res['contact_steps'])} mid-contact samples skipped; "
        f"overflow {res['overflow']}")
    return res["samples"][-1][2] if res["samples"] else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_steps", type=int, nargs="?", default=200_000)
    ap.add_argument("block", type=int, nargs="?", default=None,
                    help="steps between samples (default n_steps // 40)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    block = args.block or max(args.n_steps // 40, 1)
    sim, state, neigh = build(device=args.device)
    res = free_flight(sim, state, neigh, args.n_steps, block,
                      out=lambda s: print(s, flush=True))
    per_m = summary(sim, res)
    if per_m is None:
        print("# every sample was mid-contact; shrink block")
        return 1
    ok = abs(per_m) < 0.01
    print(f"# RESULT: {per_m:+.4%} per 1M steps "
          f"({'PASS' if ok else 'FAIL'} vs <1% target)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
