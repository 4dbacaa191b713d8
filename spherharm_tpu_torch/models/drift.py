"""Energy drift at representative scale: a dense, fully periodic, undamped,
frictionless NVE gas of Lmax 8 blobs through the production path (cell
list, prefiltered pair list, conservative law). The port's copy of the
reference harness ``scripts/drift_scale.py``.

At this density the gas is never in free flight, so etot (ke + erot +
pe_pair) is sampled every block and the secular drift is the slope of a
linear fit over the samples: the quadrature's PE-vs-force mismatch is a
bounded bias at steady contact count, not a slope.

    python -m spherharm_tpu_torch.models.drift --steps 1000000 --block 2000 \\
        --n 10000 [--restart PATH] [--seed 0] [--device cuda]

prints one line per block and ``# RESULT ...`` with the slope per 1M steps
against the reference's <1 % target; exits 1 on capacity overflow. With
``--restart`` it writes a checkpoint every 10 blocks and resumes from it
when the file exists. ``SPHERHARM_STAGE2_BF16=1`` runs every stage-2 call
with bfloat16 Horner chains (K3).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.core.state import SimParams
from spherharm_tpu_torch.models import scenarios, shapes_library
from spherharm_tpu_torch.ops import contact_kernels
from spherharm_tpu_torch.ops.neighbor import CellGrid

LMAX = 8


def build_gas(n, seed=0, dt=1e-4, v0=0.6, phi=0.35, conservative=True,
              device="cuda"):
    """The reference harness's gas (``scripts/drift_scale.py:47-99``):
    two blob types (seeds 3 and 5, roughness 0.12) on an 8x16 cap grid,
    n particles on a jittered cubic lattice in a periodic cube, speeds v0
    in random directions with zero net momentum, random orientations;
    kn 1e5, no damping, no friction; cell list (k_max 24, cell_cap 16),
    pair capacity 6n, stage-2 capacity 3n. The lattice pitch must clear
    the particle diameter, which caps the packing fraction reachable on a
    cubic grid (~0.2 for these blobs): a larger ``phi`` is clamped.
    Returns (Simulation, State)."""
    rng = np.random.default_rng(seed)
    coeffs = [shapes_library.blob_coeffs(LMAX, seed=s, roughness=0.12)
              for s in (3, 5)]
    shapes = shapes_library.build_shapes(coeffs, LMAX, contact_quad=(8, 16),
                                         device=device)
    rmax = float(np.max(shapes.rmax.cpu().numpy()))
    vol = float(np.mean(shapes.vol.cpu().numpy()))
    params = SimParams.create(dt=dt, kn=1e5, gamma_n=0.0, mu=0.0,
                              skin=0.25 * rmax, cutoff=2.0 * rmax * 1.02,
                              device=device)
    m = int(np.ceil(n ** (1 / 3)))
    pitch = max((vol / phi) ** (1.0 / 3.0), 2.12 * rmax)
    box = m * pitch
    idx = np.arange(m ** 3)[:n]
    pts = np.stack([idx % m, (idx // m) % m, idx // (m * m)], axis=1)
    x = (pts + 0.5) * pitch
    x += rng.uniform(-0.04, 0.04, x.shape) * (pitch - 2.0 * rmax)
    v = rng.normal(size=(n, 3))
    v *= v0 / np.linalg.norm(v, axis=1, keepdims=True)
    v -= v.mean(axis=0)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = scenarios.make_state(
        x, [0, 0, 0], [box] * 3, v=v, q=q,
        shtype=rng.integers(0, 2, n).astype(np.int32), device=device)
    grid = CellGrid([0, 0, 0], [box] * 3,
                    float(params.cutoff) + float(params.skin), (True,) * 3)
    sim = Simulation(shapes, params, periodic=(True,) * 3,
                     neighbor_mode="cell", grid=grid, k_max=24, cell_cap=16,
                     pair_capacity=6 * n, stage2_capacity=3 * n,
                     conservative=conservative, device=device)
    return sim, state


def drift_slope(samples):
    """Secular drift of (step, etot) samples: the slope of a linear fit,
    per 1M steps, relative to |etot| of the first sample."""
    s = np.asarray(samples, float)
    slope = np.polyfit(s[:, 0], s[:, 1], 1)[0]
    return slope * 1e6 / abs(s[0, 1])


def main(argv=None):
    from spherharm_tpu_torch.io import restart as restart_io

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1_000_000)
    ap.add_argument("--block", type=int, default=2_000)
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--restart", default=None,
                    help="checkpoint file: written every 10 blocks, resumed "
                         "from when it exists")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.block < 1 or args.steps < 2 * args.block:
        ap.error("--steps must cover at least two blocks: the slope is "
                 "fitted over one etot sample a block")

    sim, state = build_gas(args.n, seed=args.seed, device=args.device)
    done, samples = 0, []
    if args.restart and os.path.exists(args.restart):
        state, neigh, _, extra = restart_io.read_restart(args.restart,
                                                         device=args.device)
        done = int(extra["done"])
        samples = [tuple(row) for row in extra["samples"]]
        print(f"# resumed at step {done}", flush=True)
    else:
        state, neigh = sim.init_neighbors(state)

    def checkpoint():
        restart_io.write_restart(
            args.restart, state, neigh, sim.params,
            extra={"done": done, "samples": np.asarray(samples)})

    t0 = sim.thermo(state, neigh)
    dev = (torch.cuda.get_device_name(sim.device) if sim.device.type == "cuda"
           else "cpu")
    print(f"# n={args.n} steps={args.steps} block={args.block} "
          f"conservative={sim.conservative} "
          f"stage2_bf16={contact_kernels.STAGE2_BF16} device={dev}",
          flush=True)
    print(f"# e[{done}] = {float(t0['etot']):.8g} (ke {float(t0['ke']):.6g} "
          f"erot {float(t0['erot']):.6g} pe {float(t0['pe_pair']):.6g})",
          flush=True)
    nblk = 0
    while done < args.steps:
        tw = time.perf_counter()
        state, neigh = sim.run(state, neigh, args.block)
        done += args.block
        nblk += 1
        th = sim.thermo(state, neigh)
        e = float(th["etot"])
        samples.append((done, e))
        ovf = int(neigh.overflow)
        print(f"step {done:>9d}  etot {e:.8g}  pe {float(th['pe_pair']):.4g}"
              f"  ovf {ovf}  {args.block / (time.perf_counter() - tw):.0f} "
              "steps/s", flush=True)
        if ovf != 0:
            print("# FATAL: overflow — truncated physics", flush=True)
            return 1
        if nblk % 10 == 0:
            if args.restart:
                checkpoint()
            if len(samples) > 10:
                print(f"# interim drift slope: {drift_slope(samples):+.4%} "
                      "per 1M steps", flush=True)
    if args.restart:
        checkpoint()
    per_m = drift_slope(samples)
    ok = abs(per_m) < 0.01
    print(f"# RESULT (N={args.n} Lmax={LMAX}, fitted slope over {done} "
          f"steps): {per_m:+.4%} per 1M steps "
          f"({'PASS' if ok else 'FAIL'} vs <1% target)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
