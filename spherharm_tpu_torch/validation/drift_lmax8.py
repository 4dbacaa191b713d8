"""Energy drift at the metric point, Lmax 8 aspherical particles (the
port's copy of the reference harness ``scripts/drift_lmax8.py``).

Four Lmax-8 blobs in a small fully periodic box, undamped and
frictionless (pure NVE), colliding thousands of times per million steps
through the cap-quadrature contact law on the dense [N, K] path
(``neighbor_mode="allpairs"``, k_max 3). There the plausible drift source
is the contact discretisation, not the integrator, so the two-sphere
collider (``validation/drift.py``) is not sufficient evidence. Energy is
sampled in free flight only (pe_pair == 0).

    python -m spherharm_tpu_torch.validation.drift_lmax8 [n_steps] [block] \\
        [--law geometric|conservative] [--dt 1e-4] [--quad 10] [--device cuda]

``--law``, ``--dt`` and ``--quad`` are the reference's DRIFT_CONSERVATIVE,
DRIFT_DT and DRIFT_QUAD, with its defaults (the geometric law, 1e-4, a
10 x 20 cap grid). Prints one line per free-flight sample and ``# RESULT
(Lmax=8 aspherical): ... per 1M steps`` against the <1 % target.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.core.state import SimParams
from spherharm_tpu_torch.models import scenarios, shapes_library
from spherharm_tpu_torch.validation.drift import free_flight, summary


def build(dt=1e-4, kn=1e5, lmax=8, v0=0.6, seed=0, quad=10,
          conservative=False, device="cuda"):
    """Two blob types (seeds 3 and 5, roughness 0.12) on a (quad, 2 quad)
    cap grid; four particles on a 2 x 2 lattice in a 4.4 rmax periodic
    box, free at the start, speeds v0 in random directions with zero net
    momentum, random orientations; kn, no damping, no friction. Returns
    (sim, state, neigh)."""
    rng = np.random.default_rng(seed)
    coeffs = [shapes_library.blob_coeffs(lmax, seed=s, roughness=0.12)
              for s in (3, 5)]
    shapes = shapes_library.build_shapes(coeffs, lmax,
                                         contact_quad=(quad, 2 * quad),
                                         device=device)
    rmax = float(np.max(shapes.rmax.cpu().numpy()))
    params = SimParams.create(
        dt=dt, kn=kn, gamma_n=0.0, mu=0.0,
        skin=0.25 * rmax, cutoff=2.0 * rmax * 1.02, device=device)
    box = 4.4 * rmax  # 4 particles: free at start, collide constantly
    pitch = box / 2.0
    pts, vel, typ = [], [], []
    for i in range(4):
        cx, cy = i % 2, i // 2
        pts.append([(cx + 0.5) * pitch, (cy + 0.5) * pitch,
                    0.5 * box + 0.12 * rmax * (i - 1.5)])
        v = rng.normal(size=3)
        vel.append(v / np.linalg.norm(v) * v0)
        typ.append(i % 2)
    vel = np.asarray(vel)
    vel -= vel.mean(axis=0)  # zero net momentum
    q = rng.normal(size=(4, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = scenarios.make_state(
        pts, [0, 0, 0], [box, box, box], v=vel, q=q,
        shtype=np.asarray(typ, np.int32), device=device)
    sim = Simulation(shapes, params, neighbor_mode="allpairs", k_max=3,
                     periodic=(True, True, True), conservative=conservative,
                     device=device)
    state, neigh = sim.init_neighbors(state)
    return sim, state, neigh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_steps", type=int, nargs="?", default=1_000_000)
    ap.add_argument("block", type=int, nargs="?", default=20_000)
    ap.add_argument("--law", choices=("geometric", "conservative"),
                    default="geometric")
    ap.add_argument("--dt", type=float, default=1e-4)
    ap.add_argument("--quad", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sim, state, neigh = build(dt=args.dt, quad=args.quad,
                              conservative=args.law == "conservative",
                              device=args.device)
    print(f"# law {args.law} dt {args.dt} cap grid {args.quad}x"
          f"{2 * args.quad}", flush=True)
    res = free_flight(sim, state, neigh, args.n_steps, args.block,
                      out=lambda s: print(s, flush=True))
    per_m = summary(sim, res)
    if per_m is None:
        print("# every sample was mid-contact; shrink block")
        return 1
    ok = abs(per_m) < 0.01
    print(f"# RESULT (Lmax=8 aspherical): {per_m:+.4%} per 1M steps "
          f"({'PASS' if ok else 'FAIL'} vs <1% target)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
