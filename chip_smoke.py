"""Smoke run of the PyTorch + CUDA port (spherharm_tpu_torch) on one GPU.

    python3 chip_smoke.py            # one NVIDIA GPU, from the repo root
    python3 chip_smoke.py --profile  # + a torch.profiler table of 20 more
                                     #   steps of each path
                                     #   (build/chip_smoke_profile_*.txt)

Phases, each fatal on failure (exit code != 0, no result line):

1. build the CUDA kernels from ``spherharm_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source, in parallel);
2. set up, on the card, the main-path drum (``rotating_drum`` at
   n = 100,000, Lmax 8, 4 blob types, k_max 24, pair cap 5n, stage-2 cap
   3n, cadence R = 20, conservative law), the full-width deposition
   (``deposition`` at n = 10,000 with its own defaults: Lmax 8, 4 blob
   types, 12x24 = 288 cap nodes, geometric law, pair cap 10n,
   skin-triggered rebuild) and the settling box (``settling_box`` at
   n = 500: Lmax 2, one type, 128 cap nodes, 5 plane walls, dense path);
3. every kernel vs its plain twin at the shapes each path gives it, on
   contact-rich synthetic inputs built from that path's shapes and
   parameters: K1 on the drum (Lmax 8, 128 nodes); K2 on the deposition
   (Lmax 8, 288 nodes), the drum's shapes (Lmax 8, 128) and the settling
   box (Lmax 2, 128); K4 on the drum (32 nodes); K6 on the drum and the
   deposition; K7 on the drum, the deposition and the settling box's
   floor. Forces, springs and pe against the stated tolerances,
   contact-flag flips, CUDA-event times of the kernel and of its plain
   PyTorch twin, and the kernel's bound, per case;
4. small contact-rich runs of 40 steps on the card and on the CPU (plain
   twins), thermo and positions compared: the drum (n = 128, Lmax 8), the
   deposition (n = 128, Lmax 8, 288 nodes) and the settling box (n = 64,
   Lmax 2, dense [N, K] path);
5. the paths, each with every launch counter set to 0 just before it and
   read just after: 60 steps (3 cadence blocks) of the n = 100k drum; 100
   steps of the n = 10k deposition from a contact-rich start; 200 steps of
   the n = 500 settling box (5 plane walls, dense path) from its lattice
   pressed onto the floor. Guards: overflow = 0, finite etot, every kernel
   of the path launched (and skin_violations = 0 for the drum's cadence);
   particle-steps/s of each.

Prints the card's name and power limit (nvidia-smi), one JSON line with the
kernels' launches, errors, times and bounds (the path's own shape at the
top level of each kernel, every case under ``cases``), and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_MAIN, LMAX, STEPS, R_EVERY = 100_000, 8, 60, 20
N_DEP, DEP_STEPS = 10_000, 100
N_SETTLE, SETTLE_STEPS = 500, 200
N_PAIRS = 16_384  # kernel-vs-plain batch (the autograd twin's memory bound)
# NVIDIA H100 SXM data sheet: f32 (non-tensor) peak and HBM3 rate.
F32_PEAK, HBM_RATE = 67e12, 3.35e12


def horner_flops(lmax, grad=True):
    """FLOPs of one shk::radius_grad_power (grad) or radius_power_ab call
    (csrc/sh_device.cuh), counted from its loops: an FMA counts 2, any
    other arithmetic op (div, sqrt, min, max included) 1."""
    f = 2 * lmax + (2 * max(lmax - 1, 0) + 1 if grad else 0)
    for m in range(1, lmax + 1):
        runs = 8 * (lmax - m) + 4 if grad else 4 * (lmax - m)
        f += runs + (6 if m > 1 else 0) + 1 + (13 if grad else 4)
    return f


def node_flops():
    """Each kernel's work per cap node, from the ``node-flops[...]`` line
    beside its node loop in csrc/: {name: (FLOPs besides the surface
    evaluations, evaluations, gradient or not, probe sides)}."""
    pat = re.compile(r"node-flops\[(\w+)\]: (\d+) \+ (\d+) x "
                     r"(radius_grad_power|radius_power_ab) per node and side, "
                     r"(\d) sides?")
    table = {}
    for src in sorted((ROOT / "spherharm_tpu_torch" / "csrc").glob("*.cu")):
        for m in pat.finditer(src.read_text()):
            table[m[1]] = (int(m[2]), int(m[3]), m[4] == "radius_grad_power",
                           int(m[5]))
    return table


def bound(name, lmax, G, work_rows, bytes_moved):
    """Least time (ms) the card could take: the larger of the node work of
    this run's working rows (masked and skipped rows do none) over the f32
    peak and the bytes (each input read once, each output written once)
    over the HBM rate."""
    extra, evals, grad, sides = node_flops()[name]
    per_node = sides * (extra + evals * horner_flops(lmax, grad))
    t_ops = work_rows * G * per_node / F32_PEAK
    t_bytes = bytes_moved / HBM_RATE
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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


def wall_particles(sim, wall, kind, B, dev, rng):
    """B particles of the path's shapes whose centres sit 0.7-1.05 rchar
    from ``wall`` (most touch it): inside the drum's cylinder (axis y,
    between its caps) or on the inner side of a plane wall."""
    from spherharm_tpu_torch.models.scenarios import make_state

    T = sim.shapes.n_types
    shtype = rng.integers(0, T, B)
    scale = rng.uniform(0.75, 1.25, B)
    rc = sim.shapes.rchar.double().cpu().numpy()[shtype] * scale
    gap = rng.uniform(0.7, 1.05, B) * rc
    if kind == "cylinder":
        R = float(wall.radius)
        y_cap = float(sim.walls[1].point[1])
        ang = rng.uniform(0, 2 * np.pi, B)
        rad = R - gap
        x = np.stack([rad * np.cos(ang), rng.uniform(y_cap + 1, -y_cap - 1, B),
                      rad * np.sin(ang)], axis=1)
    else:
        p0 = wall.point.double().cpu().numpy()
        nrm = wall.normal.double().cpu().numpy()
        t1 = np.cross(nrm, [1.0, 0, 0] if abs(nrm[0]) < 0.9 else [0, 1.0, 0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(nrm, t1)
        u = rng.uniform(-5, 5, (B, 2))
        x = p0 + gap[:, None] * nrm + u[:, :1] * t1 + u[:, 1:] * t2
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return make_state(x, x.min(0) - 2, x.max(0) + 2,
                      v=rng.normal(size=(B, 3)) * 0.5, q=q,
                      angmom=rng.normal(size=(B, 3)) * 0.02, scale=scale,
                      shtype=shtype, device=dev)


def compare(out, ref, nf, f_tol, loose_rows=0):
    """Hold a kernel's output rows to its plain twin's: forces and torques
    (columns 0:nf) within f_tol |F|max; the springs (nf:nf+6) and pe
    (nf+6) within 1e-6 + 1e-4 of their group's largest value, on the rows
    whose contact flag (nf+7) agrees (a spring is zeroed when its contact
    ends, so a flipped flag, counted apart, moves it by its whole value).
    ``loose_rows`` rows of forces and pe may exceed their tolerance, and
    1% of rows of springs: the springs of grazing contacts rest on a few
    cap nodes, and the plain twin itself, with positions moved by one
    f32 ulp, moves 0.9% of the drum's cylinder rows beyond 1e-4 of the
    spring scale, by up to 9e-4 of it. No row exceeds 2e-2 of its group's
    largest value. Returns (ok, max force error, contact-flag flips,
    text)."""
    agree = (out[:, nf + 7] > 0.5) == (ref[:, nf + 7] > 0.5)
    ok, text = True, []
    for group, cols, rel, floor, rows, allowed in (
            ("F,tau", slice(0, nf), f_tol, 0.0, slice(None), loose_rows),
            ("springs", slice(nf, nf + 6), 1e-4, 1e-6, agree,
             max(out.shape[0] // 100, 1)),
            ("pe", slice(nf + 6, nf + 7), 1e-4, 1e-6, agree, loose_rows)):
        scale = float(ref[:, cols].abs().max())
        err = (out[rows][:, cols] - ref[rows][:, cols]).abs().amax(1)
        top = float(err.max())
        n_beyond = int((err > floor + rel * scale).sum())
        ok = ok and top <= floor + 2e-2 * scale and n_beyond <= allowed
        if group == "F,tau":
            f_err = top
        text.append(f"max|d {group}|={top:.3g} (tol {floor + rel * scale:.3g}; "
                    f"rows beyond {n_beyond}, allowed {allowed})")
    flips = int((~agree).sum())
    text.append(f"contact-flag flips={flips}")
    return ok, f_err, flips, " ".join(text)


def kernel_phase(sim, dep, box, dev):
    """Every kernel vs its plain twin at the shapes each path gives it
    (the drum ``sim``, the deposition ``dep``, the settling box ``box``);
    returns {kernel: [case, ...]}, the path's own shape first, each case
    with its error, times and bound."""
    import torch

    from spherharm_tpu_torch.ops import contact_kernels as ck
    from spherharm_tpu_torch.ops import walls_kernels as wk
    from spherharm_tpu_torch.ops.rotation import omega_from_angmom

    rng = np.random.default_rng(7)
    results = {}
    mask_col = ck.SLOTS["mask"][0]

    def case(name, tag, lmax, G, rows, err, time_kernel, time_plain, work, moved):
        c = dict(path=tag, lmax=lmax, G=G, rows=rows, max_abs_err=err,
                 ms=cuda_ms(time_kernel, 20), plain_ms=cuda_ms(time_plain, 3),
                 **bound(name, lmax, G, work, moved))
        print(f"  {name} on {tag}: {c['ms']:.4f} ms (plain {c['plain_ms']:.2f} ms, "
              f"bound {c['bound_ms']:.4f} ms, {c['bound_by']})")
        results.setdefault(name, []).append(c)

    def pair_law(conservative, tag, path):
        name = "pair_contact_" + ("conservative" if conservative else "geometric")
        label = f"K{1 if conservative else 2} {name} on {tag}"
        lmax = path.shapes.lmax
        st, pi, pj, mask, hist, d = contact_pairs(path, dev, rng)
        packed, tbl, cap, par = ck.pack_pairs(st, path.shapes, path.params, pi, pj,
                                              mask, hist, d)
        out = ck.pair_contact(packed, tbl, cap, par, lmax, conservative)
        ref = ck.pair_contact_plain(packed, tbl, cap, par, lmax, conservative)
        torch.cuda.synchronize()
        n_contact = int((ref[:, 16] > 0.5).sum())
        fmag = float(ref[:, 0:3].abs().max())
        # The conservative law is not smooth at the ulp level: d(s1) jumps
        # when a cap node crosses the partner's surface, so rounding alone
        # moves a few rows by up to ~1% (the plain twin itself, on inputs
        # perturbed by 2e-7 relative: 3 of 16,384 rows beyond 1e-4 |F|max,
        # the worst by 1% of its row): 0.1% of rows may exceed 1e-4, none
        # 2e-2. The geometric law holds every row to the reference's own
        # bound, 2e-3 |F|max (tests/test_pallas.py).
        ok, err, flips, text = compare(
            out, ref, 9, 1e-4 if conservative else 2e-3,
            N_PAIRS // 1000 if conservative else 0)
        G = cap.shape[1]
        print(f"{label}: P={N_PAIRS} lmax={lmax} G={G} contacts={n_contact} "
              f"|F|max={fmag:.4g} {text}")
        require(n_contact > N_PAIRS // 4, f"{label}: batch has too few contacts")
        require(torch.isfinite(out).all(), f"{label}: output not finite")
        require(ok, f"{label}: disagrees with its plain twin")
        require(flips <= N_PAIRS // 1000, f"{label}: contact flags disagree")
        case(name, tag, lmax, G, N_PAIRS, err,
             lambda: ck.pair_contact(packed, tbl, cap, par, lmax, conservative),
             lambda: ck.pair_contact_plain(packed, tbl, cap, par, lmax, conservative),
             int((packed[:, mask_col] > 0.5).sum()), nbytes(packed, tbl, cap, par, out))

    pair_law(True, "drum", sim)
    pair_law(False, "deposition", dep)
    pair_law(False, "drum shapes", sim)
    pair_law(False, "settling box", box)

    shapes = sim.shapes
    st, pi, pj, mask, hist, d = contact_pairs(sim, dev, rng)
    probe = ck.pack_pairs(st, shapes, sim.params, pi, pj, mask, hist, d,
                          probe_only=True)[0]
    probe[:, ck.SLOTS["tail"][0]] = 0.0
    tbl = ck.pad_type_table(shapes.power_tbl).contiguous()
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
    rsum = probe[:, ck.SLOTS["rbi"][0]] + probe[:, ck.SLOTS["rbj"][0]]
    dist = torch.linalg.norm(probe[:, ck.SLOTS["d"][0]:ck.SLOTS["d"][1]], dim=1)
    probed = int(((probe[:, mask_col] > 0.5) & (dist > 1e-12) & (dist < rsum)).sum())
    case("stage1_depth", "drum", LMAX, cap1.shape[1], N_PAIRS, err,
         lambda: ck.stage1_depth(probe, tbl_ab, cap1, LMAX),
         lambda: ck.stage1_depth_plain(probe, tbl_ab, cap1, LMAX),
         probed, nbytes(probe, tbl_ab, cap1, out))

    # Each path's wall batch: wall_capacity compacted rows, or every
    # particle where the path packs them all (wall_capacity 0).
    for kind, tag, path, wall in (
            ("cylinder", "drum", sim, sim.walls[0]),
            ("cylinder", "deposition", dep, dep.walls[0]),
            ("plane", "drum", sim, sim.walls[1]),
            ("plane", "deposition", dep, dep.walls[1]),
            ("plane", "settling box", box, box.walls[0])):
        label = f"K{6 if kind == 'cylinder' else 7} wall[{kind}] on {tag}"
        lmax = path.shapes.lmax
        B = path.wall_capacity or N_SETTLE
        ws = wall_particles(path, wall, kind, B, dev, rng)
        depth_c, n_c = wall.depth_and_normal(ws.x)
        om = omega_from_angmom(ws.q, ws.angmom,
                               path.shapes.inertia_of(ws.shtype, ws.scale))
        whist = torch.as_tensor(rng.normal(size=(B, 6)) * 1e-4,
                                dtype=torch.float32, device=dev)
        args = wk.pack_wall(ws, path.shapes, path.params, wall, whist, depth_c, n_c, om)
        require(args[4] == kind, f"pack_wall picked {args[4]} for {kind}")
        out = wk.wall_contact_kernel(*args[:4], lmax, kind)
        ref = wk.wall_contact_plain(*args[:4], lmax, kind)
        torch.cuda.synchronize()
        n_contact = int((ref[:, 13] > 0.5).sum())
        fmag = float(ref[:, 0:3].abs().max())
        ok, err, flips, text = compare(out, ref, 6, 1e-4)
        G = args[2].shape[1]
        print(f"{label}: B={B} lmax={lmax} G={G} contacts={n_contact} "
              f"|F|max={fmag:.4g} {text}")
        require(n_contact > B // 4, f"{label}: batch has too few contacts")
        require(torch.isfinite(out).all(), f"{label}: output not finite")
        require(ok, f"{label}: disagrees with its plain twin")
        require(flips <= max(B // 1000, 1), f"{label}: contact flags disagree")
        case(f"wall_{kind}", tag, lmax, G, B, err,
             lambda: wk.wall_contact_kernel(*args[:4], lmax, kind),
             lambda: wk.wall_contact_plain(*args[:4], lmax, kind),
             int((args[0][:, 16] > 0.5).sum()), nbytes(*args[:4], out))
    return results


def drum_start(sim, st0, device):
    """The drum's (or deposition's) contact-rich start from its builder
    state (tests/torch_port_util.contact_rich_state)."""
    from torch_port_util import contact_rich_state

    from spherharm_tpu_torch.models import scenarios

    sh = st0.shtype.cpu().numpy()
    sc = st0.scale.double().cpu().numpy()
    R = float(sim.walls[0].radius)
    L = float(sim.walls[2].point[1] - sim.walls[1].point[1])
    radius = sim.shapes.rchar.double().cpu().numpy()[sh] * sc
    x, angmom = contact_rich_state(st0.x.cpu().numpy(), radius, R, L)
    return scenarios.make_state(x, st0.box_lo.cpu().numpy(), st0.box_hi.cpu().numpy(),
                                q=st0.q.cpu().numpy(), angmom=angmom, scale=sc,
                                shtype=sh, device=device)


def box_start(sim, st0, device):
    """The settling box's lattice pressed onto the floor
    (tests/torch_port_util.pressed_box_state)."""
    from torch_port_util import pressed_box_state

    from spherharm_tpu_torch.models import scenarios

    x, angmom = pressed_box_state(st0.x.cpu().numpy(), float(sim.shapes.rmax[0]))
    return scenarios.make_state(x, st0.box_lo.cpu().numpy(), st0.box_hi.cpu().numpy(),
                                q=st0.q.cpu().numpy(), angmom=angmom, device=device)


def card_vs_cpu(label, build, start, dev, steps=40):
    """A small contact-rich run of ``steps`` steps on the card and on the
    CPU (plain twins): thermo within 2e-3 relative, positions within 1e-3,
    pair and wall contacts present."""
    import torch

    runs = {}
    for device in (dev, torch.device("cpu")):
        sim, st0, _ = build(device)
        st, ng = sim.init_neighbors(start(sim, st0, device))
        st, ng = sim.run(st, ng, steps)
        th = {k: float(v) for k, v in sim.thermo(st, ng).items() if v.ndim == 0}
        require(int(ng.overflow) == 0 and int(ng.skin_violations) == 0,
                f"{label} on {device}: overflow/skin violations")
        runs[device.type] = (th, st.x.cpu().numpy())
    (tg, xg), (tc, xc) = runs["cuda"], runs["cpu"]
    rel = {k: abs(tg[k] - tc[k]) / max(abs(tc[k]), 1e-30)
           for k in ("ke", "erot", "pe_pair", "pe_wall", "pe_grav", "etot")}
    dx = float(np.abs(xg - xc).max())
    print(f"{label}, {steps} steps, card vs CPU: "
          + " ".join(f"{k}={tg[k]:.6g}(rel {v:.2e})" for k, v in rel.items())
          + f" max|dx|={dx:.3g} (tol: rel 2e-3, dx 1e-3)")
    require(tc["pe_pair"] > 0 and tc["pe_wall"] > 0, f"{label} has no contacts")
    require(max(rel.values()) <= 2e-3 and dx <= 1e-3,
            f"{label}: card and CPU disagree")


def run_path(label, sim, state, neigh, steps, kernels, smi):
    """Drive one path with every launch counter at 0; returns (state,
    neigh, launches of this run, thermo, seconds a step)."""
    import torch

    from spherharm_tpu_torch.ops import contact_kernels as ck
    from spherharm_tpu_torch.ops import walls_kernels as wk

    counters = (ck.pair_contact.launches, wk.wall_contact_kernel.launches)
    for c in counters:
        for k in c:
            c[k] = 0
    ck.stage1_depth.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, neigh = sim.run(state, neigh, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"pair_contact_conservative": ck.pair_contact.launches["conservative"],
                "pair_contact_geometric": ck.pair_contact.launches["geometric"],
                "stage1_depth": ck.stage1_depth.launches,
                "wall_cylinder": wk.wall_contact_kernel.launches["cylinder"],
                "wall_plane": wk.wall_contact_kernel.launches["plane"]}
    th = sim.thermo(state, neigh)
    n = int(state.n_active)
    overflow, skin = int(neigh.overflow), int(neigh.skin_violations)
    etot = float(th["etot"])
    rate = n * steps / wall
    print(f"{label}: {steps} steps in {wall:.3f}s -> {rate:.1f} particle-steps/s "
          f"[{smi}] overflow={overflow} skin_violations={skin} etot={etot:.6g} "
          f"pe_pair={float(th['pe_pair']):.6g} pe_wall={float(th['pe_wall']):.6g} "
          f"launches={launches}")
    require(overflow == 0, f"{label}: capacity overflow (channel={overflow})")
    require(math.isfinite(etot), f"{label}: non-finite energy")
    require(all(launches[k] > 0 for k in kernels),
            f"{label}: a kernel of the path never launched: {launches}")
    return state, neigh, launches, th, wall / steps


def profile_path(tag, sim, state, neigh, step_s, smi, steps=20):
    """torch.profiler over ``steps`` more steps of a path: its table by
    device time goes to build/chip_smoke_profile_<tag>.txt; the device's
    busy share is its time a step over the path's unprofiled ``step_s``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.run(state, neigh, steps)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # Device rows only: an aten op's row repeats its kernels' time.
    dev_ms = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation) / 1e3 / steps
    summary = (f"{tag}: device time {dev_ms:.4f} ms a step over {steps} profiled "
               f"steps, against {1e3 * step_s:.4f} ms a step unprofiled: device "
               f"busy {dev_ms / (1e3 * step_s):.1%} [{smi}]")
    out = ROOT / "build" / f"chip_smoke_profile_{tag.replace(' ', '_')}.txt"
    out.parent.mkdir(exist_ok=True)
    out.write_text(f"{summary}\n"
                   f"{events.table(sort_by='cuda_time_total', row_limit=40)}\n")
    print(f"profile {summary} -> {out.relative_to(ROOT)}")


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from spherharm_tpu_torch.models import scenarios
    from spherharm_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
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
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    t0 = time.perf_counter()
    sim, state, neigh = scenarios.rotating_drum(
        n=N_MAIN, lmax=LMAX, k_max=24, pair_capacity=5 * N_MAIN,
        stage2_capacity=3 * N_MAIN, rebuild_every=R_EVERY, conservative=True,
        device=dev)
    dep, dep_st0, _ = scenarios.deposition(n=N_DEP, device=dev)
    box, bst0, _ = scenarios.settling_box(n=N_SETTLE, device=dev)
    torch.cuda.synchronize()
    print(f"setup: {time.perf_counter() - t0:.1f}s; drum n={N_MAIN} lmax={LMAX} "
          f"grid={sim.grid.dims} pair_cap={sim.pair_capacity} "
          f"stage2_cap={sim.stage2_capacity} wall_cap={sim.wall_capacity}; "
          f"deposition n={N_DEP} G={dep.shapes.cap_x.shape[0]} k_max={dep.k_max} "
          f"pair_cap={dep.pair_capacity} wall_cap={dep.wall_capacity} "
          f"conservative={dep.conservative}; settling box n={N_SETTLE} "
          f"lmax={box.shapes.lmax} G={box.shapes.cap_x.shape[0]} "
          f"k_max={box.k_max} walls={len(box.walls)} "
          f"conservative={box.conservative}")

    kern = kernel_phase(sim, dep, box, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_vs_cpu("small drum n=128 Lmax=8",
                lambda d: scenarios.rotating_drum(
                    n=128, lmax=LMAX, k_max=24, pair_capacity=640,
                    stage2_capacity=384, rebuild_every=R_EVERY, device=d),
                drum_start, dev)
    card_vs_cpu("small deposition n=128 Lmax=8 12x24",
                lambda d: scenarios.deposition(n=128, device=d), drum_start, dev)
    card_vs_cpu("small settling box n=64 Lmax=2 dense",
                lambda d: scenarios.settling_box(n=64, device=d), box_start, dev)
    torch.cuda.synchronize()
    print(f"card-vs-CPU phases: {time.perf_counter() - t0:.1f}s")

    # The paths: counters from each path's own run only; with --profile,
    # 20 more steps of each under torch.profiler after its counted run.
    profiling = "--profile" in argv
    state, neigh, l_drum, _, step_s = run_path(
        f"drum n={N_MAIN}", sim, state, neigh, STEPS,
        ("pair_contact_conservative", "stage1_depth", "wall_cylinder", "wall_plane"),
        smi)
    skin = int(neigh.skin_violations)
    require(skin == 0, f"drum: {skin} skin violations at cadence {R_EVERY}")
    if profiling:
        profile_path("drum", sim, state, neigh, step_s, smi)
    del sim, state, neigh

    dst, dng = dep.init_neighbors(drum_start(dep, dep_st0, dev))
    dst, dng, l_dep, th, step_s = run_path(
        f"deposition n={N_DEP}", dep, dst, dng, DEP_STEPS,
        ("pair_contact_geometric", "wall_cylinder", "wall_plane"), smi)
    require(float(th["pe_pair"]) > 0, "deposition: no pair contact")
    if profiling:
        profile_path("deposition", dep, dst, dng, step_s, smi)

    bst, bng = box.init_neighbors(box_start(box, bst0, dev))
    bst, bng, l_box, th, step_s = run_path(
        f"settling box n={N_SETTLE}", box, bst, bng, SETTLE_STEPS,
        ("pair_contact_geometric", "wall_plane"), smi)
    require(float(th["pe_pair"]) > 0, "settling box: no pair contact")
    if profiling:
        profile_path("settling box", box, bst, bng, step_s, smi)

    src = {"pair_contact_conservative": ("spherharm_tpu_torch/csrc/pair_contact.cu",
                                         "spherharm_tpu/ops/contact_pallas.py:496"),
           "pair_contact_geometric": ("spherharm_tpu_torch/csrc/pair_contact.cu",
                                      "spherharm_tpu/ops/contact_pallas.py:213"),
           "stage1_depth": ("spherharm_tpu_torch/csrc/stage1_probe.cu",
                            "spherharm_tpu/ops/contact_pallas.py:751"),
           "wall_cylinder": ("spherharm_tpu_torch/csrc/wall_contact.cu",
                             "spherharm_tpu/ops/walls_pallas.py:50"),
           "wall_plane": ("spherharm_tpu_torch/csrc/wall_contact.cu",
                          "spherharm_tpu/ops/walls_pallas.py:139")}
    launches = {k: l_drum[k] + l_dep[k] + l_box[k] for k in src}
    print(f"total wall time: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1], "launches": launches[name],
         "max_abs_err": max(c["max_abs_err"] for c in kern[name]),
         **{k: kern[name][0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, "cases": kern[name]}
        for name in src]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
