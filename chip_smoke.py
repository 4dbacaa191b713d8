"""Smoke run of the PyTorch + CUDA port (spherharm_tpu_torch) on one GPU.

    python3 chip_smoke.py            # one NVIDIA GPU, from the repo root
    python3 chip_smoke.py --profile  # + a torch.profiler table of 20 steps
                                     #   (build/chip_smoke_profile.txt)

Phases, each fatal on failure (exit code != 0, no result line):

1. build the CUDA kernels from ``spherharm_tpu_torch/csrc`` (nvcc, sm_90a);
2. set up the main-path drum: ``rotating_drum`` at n = 100,000, Lmax 8,
   4 blob types, k_max 24, pair cap 5n, stage-2 cap 3n, cadence R = 20,
   conservative law, on the card;
3. kernel vs plain twin at main-path widths (Lmax 8, the drum's 4 types,
   128-node cap, 32-node cap1 grid, the drum's walls) on contact-rich
   synthetic inputs: max error against the stated tolerance, and CUDA-event
   times of the kernel and of its plain PyTorch twin;
4. a small contact-rich drum (n = 128, Lmax 8) for 40 steps on the card
   and on the CPU (plain twins): thermo and positions must agree;
5. the main path: every launch counter set to 0, 60 steps (3 cadence
   blocks) of the n = 100k drum, counters read; overflow = 0,
   skin_violations = 0, finite etot, every kernel launched; particle-steps/s.

Prints the card's name and power limit (nvidia-smi), one JSON line with the
kernels' launches, errors and times, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_MAIN, LMAX, STEPS, R_EVERY = 100_000, 8, 60, 20
N_PAIRS = 16_384  # kernel-vs-plain batch (the autograd twin's memory bound)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps):
    """Mean CUDA-event time of fn() over reps calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def contact_pairs(sim, dev, rng):
    """N_PAIRS synthetic pairs (2k, 2k+1) of the drum's shapes: surfaces
    from 15% overlapped to 20% apart (rchar scale), random orientations,
    velocities, spins and mid-contact springs; 2% masked rows."""
    import torch

    from spherharm_tpu_torch.models.scenarios import make_state

    P = N_PAIRS
    T = sim.shapes.n_types
    shtype = rng.integers(0, T, 2 * P)
    scale = rng.uniform(0.75, 1.25, 2 * P)
    rc = sim.shapes.rchar.double().cpu().numpy()[shtype] * scale
    e = rng.normal(size=(P, 3))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    dist = rng.uniform(0.85, 1.2, P) * (rc[0::2] + rc[1::2])
    x = np.empty((2 * P, 3))
    x[0::2] = rng.uniform(-5, 5, (P, 3))
    x[1::2] = x[0::2] + dist[:, None] * e
    q = rng.normal(size=(2 * P, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    st = make_state(x, [-8, -8, -8], [8, 8, 8], v=rng.normal(size=(2 * P, 3)) * 0.5,
                    q=q, angmom=rng.normal(size=(2 * P, 3)) * 0.02, scale=scale,
                    shtype=shtype, device=dev)
    pi = torch.arange(0, 2 * P, 2, device=dev)
    pj = pi + 1
    mask = torch.as_tensor(rng.uniform(size=P) > 0.02, device=dev)
    hist = torch.as_tensor(rng.normal(size=(P, 6)) * 1e-4, dtype=torch.float32,
                           device=dev)
    return st, pi, pj, mask, hist, st.x[pj] - st.x[pi]


def wall_particles(sim, kind, dev, rng):
    """wall_capacity particles whose centres sit 0.7-1.05 rchar from the
    drum's cylinder or its y = -L/2 cap (most touch it)."""
    from spherharm_tpu_torch.models.scenarios import make_state

    B = sim.wall_capacity
    T = sim.shapes.n_types
    shtype = rng.integers(0, T, B)
    scale = rng.uniform(0.75, 1.25, B)
    rc = sim.shapes.rchar.double().cpu().numpy()[shtype] * scale
    R = float(sim.walls[0].radius)
    y_cap = float(sim.walls[1].point[1])
    gap = rng.uniform(0.7, 1.05, B) * rc
    if kind == "cylinder":
        ang = rng.uniform(0, 2 * np.pi, B)
        rad = R - gap
        x = np.stack([rad * np.cos(ang), rng.uniform(y_cap + 1, -y_cap - 1, B),
                      rad * np.sin(ang)], axis=1)
    else:
        x = np.stack([rng.uniform(-R / 2, R / 2, B), y_cap + gap,
                      rng.uniform(-R / 2, R / 2, B)], axis=1)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return make_state(x, [-R, y_cap, -R], [R, -y_cap, R],
                      v=rng.normal(size=(B, 3)) * 0.5, q=q,
                      angmom=rng.normal(size=(B, 3)) * 0.02, scale=scale,
                      shtype=shtype, device=dev)


def kernel_phase(sim, dev):
    """Kernel vs plain twin for K1, K4, K6, K7 at main-path widths."""
    import torch

    from spherharm_tpu_torch.ops import contact_kernels as ck
    from spherharm_tpu_torch.ops import walls_kernels as wk
    from spherharm_tpu_torch.ops.rotation import omega_from_angmom

    rng = np.random.default_rng(7)
    shapes, params = sim.shapes, sim.params
    results = {}

    st, pi, pj, mask, hist, d = contact_pairs(sim, dev, rng)
    packed, tbl, cap, par = ck.pack_pairs(st, shapes, params, pi, pj, mask, hist, d)
    out = ck.pair_contact(packed, tbl, cap, par, LMAX)
    ref = ck.pair_contact_plain(packed, tbl, cap, par, LMAX)
    torch.cuda.synchronize()
    inc_ref, inc = ref[:, 16] > 0.5, out[:, 16] > 0.5
    n_contact = int(inc_ref.sum())
    fmag = float(ref[:, 0:3].abs().max())
    row_err = (out[:, 0:9] - ref[:, 0:9]).abs().amax(1)
    err = float(row_err.max())
    n_out = int((row_err > 1e-4 * fmag).sum())
    flips = int((inc != inc_ref).sum())
    # The conservative law is not smooth at the ulp level: d(s1) jumps
    # when a cap node crosses the partner's surface, so rounding alone
    # moves a few rows' forces by up to ~1% (the plain twin itself, on
    # inputs perturbed by 2e-7 relative: 3 of 16,384 rows beyond
    # 1e-4 |F|max, the worst by 1% of its row). Tolerance: every row within
    # 2e-2 |F|max, all but 0.1% of rows within 1e-4 |F|max.
    print(f"K1 pair_contact: P={N_PAIRS} contacts={n_contact} |F|max={fmag:.4g} "
          f"max|dF,dtau|={err:.3g} rows beyond 1e-4*|F|max={n_out} "
          f"(tol: <= {N_PAIRS // 1000} rows; all rows <= 2e-2*|F|max="
          f"{2e-2 * fmag:.3g}) contact-flag flips={flips}")
    require(n_contact > N_PAIRS // 4, "K1 batch has too few contacts")
    require(torch.isfinite(out).all(), "K1 output not finite")
    require(n_out <= N_PAIRS // 1000 and err <= 2e-2 * fmag,
            "K1 disagrees with its plain twin")
    require(flips <= N_PAIRS // 1000, "K1 contact flags disagree")
    results["pair_contact"] = dict(
        err=err, ms=cuda_ms(lambda: ck.pair_contact(packed, tbl, cap, par, LMAX), 20),
        plain_ms=cuda_ms(lambda: ck.pair_contact_plain(packed, tbl, cap, par, LMAX), 3))

    probe = ck.pack_pairs(st, shapes, params, pi, pj, mask, hist, d,
                          probe_only=True)[0]
    probe[:, ck.SLOTS["tail"][0]] = 0.0
    tbl_ab = tbl[:, :(LMAX + 1) ** 2].contiguous()
    cap1 = torch.stack([shapes.cap1_x, shapes.cap1_glw, shapes.cap1_cpsi,
                        shapes.cap1_spsi])
    out = ck.stage1_depth(probe, tbl_ab, cap1, LMAX)
    ref = ck.stage1_depth_plain(probe, tbl_ab, cap1, LMAX)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    n_pos = int((ref > 0).sum())
    print(f"K4 stage1_depth: P={N_PAIRS} depth>0 rows={n_pos} "
          f"max|d depth|={err:.3g} (tol 2e-5)")
    require(n_pos > N_PAIRS // 4, "K4 batch has too few overlapping rows")
    require(err <= 2e-5, "K4 disagrees with its plain twin")
    results["stage1_depth"] = dict(
        err=err, ms=cuda_ms(lambda: ck.stage1_depth(probe, tbl_ab, cap1, LMAX), 20),
        plain_ms=cuda_ms(lambda: ck.stage1_depth_plain(probe, tbl_ab, cap1, LMAX), 3))

    for kind, wall in (("cylinder", sim.walls[0]), ("plane", sim.walls[1])):
        ws = wall_particles(sim, kind, dev, rng)
        depth_c, n_c = wall.depth_and_normal(ws.x)
        om = omega_from_angmom(ws.q, ws.angmom, shapes.inertia_of(ws.shtype, ws.scale))
        whist = torch.as_tensor(rng.normal(size=(ws.cap, 6)) * 1e-4,
                                dtype=torch.float32, device=dev)
        args = wk.pack_wall(ws, shapes, params, wall, whist, depth_c, n_c, om)
        require(args[4] == kind, f"pack_wall picked {args[4]} for {kind}")
        out = wk.wall_contact_kernel(*args[:4], LMAX, kind)
        ref = wk.wall_contact_plain(*args[:4], LMAX, kind)
        torch.cuda.synchronize()
        n_contact = int((ref[:, 13] > 0.5).sum())
        fmag = float(ref[:, 0:3].abs().max())
        err = float((out[:, 0:6] - ref[:, 0:6]).abs().max())
        flips = int(((out[:, 13] > 0.5) != (ref[:, 13] > 0.5)).sum())
        print(f"K{6 if kind == 'cylinder' else 7} wall[{kind}]: B={ws.cap} "
              f"contacts={n_contact} |F|max={fmag:.4g} max|dF,dtau|={err:.3g} "
              f"(tol 1e-4*|F|max={1e-4 * fmag:.3g}) contact-flag flips={flips}")
        require(n_contact > ws.cap // 4, f"wall[{kind}] batch has too few contacts")
        require(torch.isfinite(out).all(), f"wall[{kind}] output not finite")
        require(err <= 1e-4 * fmag, f"wall[{kind}] disagrees with its plain twin")
        require(flips <= max(ws.cap // 1000, 1), f"wall[{kind}] contact flags disagree")
        results[f"wall_{kind}"] = dict(
            err=err, ms=cuda_ms(lambda: wk.wall_contact_kernel(*args[:4], LMAX, kind), 20),
            plain_ms=cuda_ms(lambda: wk.wall_contact_plain(*args[:4], LMAX, kind), 3))
    return results


def small_drum_phase(dev):
    """n = 128 contact-rich drum, 40 steps, card vs CPU plain twins."""
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_util import contact_rich_state

    from spherharm_tpu_torch.models import scenarios

    kw = dict(n=128, lmax=LMAX, k_max=24, pair_capacity=640, stage2_capacity=384,
              rebuild_every=R_EVERY)
    runs = {}
    for device in (dev, torch.device("cpu")):
        sim, st0, _ = scenarios.rotating_drum(device=device, **kw)
        sh = st0.shtype.cpu().numpy()
        sc = st0.scale.double().cpu().numpy()
        R = float(sim.walls[0].radius)
        L = float(sim.walls[2].point[1] - sim.walls[1].point[1])
        radius = sim.shapes.rchar.double().cpu().numpy()[sh] * sc
        x, angmom = contact_rich_state(st0.x.cpu().numpy(), radius, R, L)
        st = scenarios.make_state(x, st0.box_lo.cpu().numpy(), st0.box_hi.cpu().numpy(),
                                  q=st0.q.cpu().numpy(), angmom=angmom, scale=sc,
                                  shtype=sh, device=device)
        st, ng = sim.init_neighbors(st)
        st, ng = sim.run(st, ng, 40)
        th = {k: float(v) for k, v in sim.thermo(st, ng).items() if v.ndim == 0}
        require(int(ng.overflow) == 0 and int(ng.skin_violations) == 0,
                f"small drum on {device}: overflow/skin violations")
        runs[device.type] = (th, st.x.cpu().numpy())
    (tg, xg), (tc, xc) = runs["cuda"], runs["cpu"]
    rel = {k: abs(tg[k] - tc[k]) / max(abs(tc[k]), 1e-30)
           for k in ("ke", "erot", "pe_pair", "pe_wall", "pe_grav", "etot")}
    dx = float(np.abs(xg - xc).max())
    print("small drum n=128 Lmax=8, 40 steps, card vs CPU: "
          + " ".join(f"{k}={tg[k]:.6g}(rel {v:.2e})" for k, v in rel.items())
          + f" max|dx|={dx:.3g} (tol: rel 2e-3, dx 1e-3)")
    require(tc["pe_pair"] > 0 and tc["pe_wall"] > 0 and tc["erot"] > 0,
            "small drum has no contacts")
    require(max(rel.values()) <= 2e-3 and dx <= 1e-3,
            "small drum: card and CPU disagree")


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from spherharm_tpu_torch.models import scenarios
    from spherharm_tpu_torch.ops import contact_kernels as ck
    from spherharm_tpu_torch.ops import cuda_build
    from spherharm_tpu_torch.ops import walls_kernels as wk

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    path, nvcc_s, log = cuda_build.build(ptxas_info=True)
    cuda_build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s (nvcc {nvcc_s:.1f}s) -> "
          f"{path.relative_to(ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    t0 = time.perf_counter()
    sim, state, neigh = scenarios.rotating_drum(
        n=N_MAIN, lmax=LMAX, k_max=24, pair_capacity=5 * N_MAIN,
        stage2_capacity=3 * N_MAIN, rebuild_every=R_EVERY, conservative=True,
        device=dev)
    torch.cuda.synchronize()
    print(f"drum setup: {time.perf_counter() - t0:.1f}s n={N_MAIN} lmax={LMAX} "
          f"grid={sim.grid.dims} pair_cap={sim.pair_capacity} "
          f"stage2_cap={sim.stage2_capacity} wall_cap={sim.wall_capacity}")

    kern = kernel_phase(sim, dev)
    torch.cuda.synchronize()
    small_drum_phase(dev)
    torch.cuda.synchronize()

    # The main path: counters from this run only.
    ck.pair_contact.launches = 0
    ck.stage1_depth.launches = 0
    for k in wk.wall_contact_kernel.launches:
        wk.wall_contact_kernel.launches[k] = 0
    t0 = time.perf_counter()
    state, neigh = sim.run(state, neigh, STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pair_contact": ck.pair_contact.launches,
                "stage1_depth": ck.stage1_depth.launches,
                "wall_cylinder": wk.wall_contact_kernel.launches["cylinder"],
                "wall_plane": wk.wall_contact_kernel.launches["plane"]}
    th = sim.thermo(state, neigh)
    overflow, skin = int(neigh.overflow), int(neigh.skin_violations)
    etot = float(th["etot"])
    rate = N_MAIN * STEPS / wall
    print(f"drum run: {STEPS} steps in {wall:.3f}s -> {rate:.1f} particle-steps/s "
          f"[{smi}] overflow={overflow} skin_violations={skin} etot={etot:.6g} "
          f"pairs_kept={int(neigh.pair_valid.sum())} launches={launches}")
    require(overflow == 0, f"capacity overflow (channel={overflow})")
    require(skin == 0, f"{skin} skin violations at cadence {R_EVERY}")
    require(math.isfinite(etot), "non-finite energy")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the main path never launched: {launches}")

    if "--profile" in argv:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            state, neigh = sim.run(state, neigh, R_EVERY)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        out = ROOT / "build" / "chip_smoke_profile.txt"
        out.parent.mkdir(exist_ok=True)
        out.write_text(f"{smi}\n{table}\n")
        print(table[:6000])

    src = {"pair_contact": ("spherharm_tpu_torch/csrc/pair_contact.cu",
                            "spherharm_tpu/ops/contact_pallas.py:496"),
           "stage1_depth": ("spherharm_tpu_torch/csrc/stage1_probe.cu",
                            "spherharm_tpu/ops/contact_pallas.py:751"),
           "wall_cylinder": ("spherharm_tpu_torch/csrc/wall_contact.cu",
                             "spherharm_tpu/ops/walls_pallas.py:50"),
           "wall_plane": ("spherharm_tpu_torch/csrc/wall_contact.cu",
                          "spherharm_tpu/ops/walls_pallas.py:50")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1], "launches": launches[name],
         "max_abs_err": kern[name]["err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"]}
        for name in src]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
