"""The four Lmax-8 blobs under the geometric law in the reference
(``scripts/drift_lmax8.py`` with ``exact_eval=True``, the radius the port
and the TPU evaluate) and in the port (``validation/drift_lmax8.py``),
each through its own ``build(seed=...)``.

    python tools/parity/four_blobs.py drift PKG SEED OUT.json [--steps N] [--block B] [--device D]
    python tools/parity/four_blobs.py episodes PKG SEED OUT.npz [--device D] [--fast]
    python tools/parity/four_blobs.py starts RECORD.npz OUT.npz
    python tools/parity/four_blobs.py replay PKG SEED STARTS.npz OUT.json [--device D] [--perturb K] [--f64]
    python tools/parity/four_blobs.py tables EPISODES_DIR REPLAYS_DIR DRIFT_DIR

PKG is ``jax`` (the reference, on the CPU) or ``port`` (``--device cpu``:
the plain twins; ``cuda``: the kernels).

* ``drift``: the port's ``validation.drift.free_flight`` and ``summary``
  over PKG's system (etot every ``--block`` steps, kept where pe_pair ==
  0, as the script's ``main`` does); writes the samples (step, etot,
  drift per 1M steps).
* ``episodes``: step by step until the fifth contact episode (pe_pair from
  0 to > 0 and back to 0) has ended; pe_pair and etot every step, or with
  ``--fast`` (the port) contact read from the pair forces each step (no
  walls, no gravity, no damping: f != 0 iff a cap node is inside) and
  thermo only at the steps around each change; x every step (and v, q,
  angmom with ``--fast``).
* ``starts``: a ``--fast`` record's state 20 steps (free flight) before
  each of its first five episodes.
* ``replay``: each episode from its start state in PKG, stepped until the
  contact has ended; dE = etot after - etot at the start. ``--perturb K``:
  K more runs from the start with every x component moved 1 ulp (f32) up
  or down at random, for the spread of dE under rounding. ``--f64``: shape
  tables, params and state built in float64 (the same law without f32
  rounding).
* ``tables``: the episodes' dE in the three free runs and where their
  positions part; the replays' dE, each port run held to the reference's
  own float32 noise (its spread over its start and the ulp-moved starts,
  plus its float32 - float64), and the port's signed gap to the reference
  in units of that spread over every episode (a bias would show there);
  the drift's per-seed values, mean and spread at 250,000 and 1M steps.
  It reads
  ``{jax,port_cpu,card}_s<seed>.npz`` (``episodes``) in EPISODES_DIR,
  ``{jax,port_cpu,card,jax64,port64}_s<seed>.json`` (``replay``) in
  REPLAYS_DIR and ``{jax,port}_s<seed>.json`` (``drift``) in DRIFT_DIR.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import os
import sys
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
LEAD = 20          # a replay starts this many steps before its episode
EPISODES = 5


def _opts(argv, flags=("--fast", "--f64")):
    """(positional arguments, {option: value}); ``flags`` take no value."""
    pos, kw, it = [], {}, iter(argv)
    for a in it:
        if a in flags:
            kw[a[2:]] = True
        elif a.startswith("--"):
            kw[a[2:]] = next(it)
        else:
            pos.append(a)
    return pos, kw


def _building_in(dtype, targets):
    """Patches, restored on exit, that make each (owner, name) builder of
    ``targets`` build in ``dtype``: its ``dtype=`` for a function, that of
    ``create`` for a class."""
    stack = contextlib.ExitStack()
    for owner, name in targets:
        orig = getattr(owner, name)
        if isinstance(orig, type):
            new = types.SimpleNamespace(
                create=functools.partial(orig.create, dtype=dtype))
        else:
            new = functools.partial(orig, dtype=dtype)
        stack.enter_context(mock.patch.object(owner, name, new))
    return stack


def build(pkg, seed, device="cpu", f64=False):
    """(sim, state, neigh, contact(state, neigh) -> bool, to_array) of the
    four blobs at ``seed`` in ``pkg``; ``f64``: shape tables, params and
    state built in float64."""
    if pkg == "jax":
        import jax
        if f64:
            jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        from spherharm_tpu.core.simulation import Simulation

        spec = importlib.util.spec_from_file_location(
            "drift_lmax8_ref", ROOT / "scripts" / "drift_lmax8.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.Simulation = functools.partial(Simulation, exact_eval=True)
        fdt = jnp.float64 if f64 else jnp.float32
        with _building_in(fdt, [(mod.shapes_library, "build_shapes"),
                                (mod.scenarios, "make_state"),
                                (mod, "SimParams")] if f64 else []):
            sim, state, neigh = mod.build(seed=seed)
        assert sim.exact_eval and not sim.conservative
        arr = lambda a: jnp.asarray(np.asarray(a, np.float32), fdt)
        contact = lambda st, ng: float(sim.thermo(st, ng)["pe_pair"]) > 0
        return sim, state, neigh, contact, arr
    import torch

    from spherharm_tpu_torch.models import shapes_library
    from spherharm_tpu_torch.validation import drift_lmax8

    if device == "cpu":
        torch.set_num_threads(1)
    fdt = torch.float64 if f64 else torch.float32
    with _building_in(fdt, [(shapes_library, "build_shapes"),
                            (drift_lmax8.scenarios, "make_state"),
                            (drift_lmax8, "SimParams")] if f64 else []):
        sim, state, neigh = drift_lmax8.build(seed=seed, device=device)
    arr = lambda a: torch.tensor(np.asarray(a, np.float32), device=device).to(fdt)
    contact = lambda st, ng: bool((st.f != 0).any())
    return sim, state, neigh, contact, arr


def host(t):
    return np.asarray(t.detach().cpu() if hasattr(t, "detach") else t, np.float64)


def cmd_drift(pkg, seed, out, steps=1_000_000, block=20_000, device="cuda"):
    """``validation.drift.free_flight`` and ``summary`` over PKG's system."""
    from spherharm_tpu_torch.validation.drift import free_flight, summary

    sim, state, neigh, _, _ = build(pkg, seed, device)
    res = free_flight(sim, state, neigh, steps, block,
                      out=lambda s: print(f"[{seed}] {s}", flush=True))
    per_m = summary(sim if pkg == "port" else types.SimpleNamespace(device="cpu"),
                    res, out=lambda s: print(f"[{seed}] {s}", flush=True))
    json.dump(dict(package=pkg, seed=seed, device=device, block=block,
                   **{k: res[k] for k in ("e0", "steps", "samples", "seconds",
                                          "overflow")}), open(out, "w"))
    print(f"[{seed}] RESULT {per_m:+.4%} per 1M", flush=True)


def cmd_episodes(pkg, seed, out, device="cpu", fast=False, n_max=150_000):
    """Per-step records until the fifth contact episode has ended."""
    sim, state, neigh, contact, _ = build(pkg, seed, device)

    def thermo(st, ng):
        t = sim.thermo(st, ng)
        return float(t["pe_pair"]), float(t["etot"])

    fields = ("x", "v", "q", "angmom") if fast else ("x",)
    rec = {k: [host(getattr(state, k)[:4])] for k in fields}
    pe0, e0 = thermo(state, neigh)
    flag, marks = [pe0 > 0], {0: (pe0, e0)}
    prev, n_ep, t0 = (state, neigh), 0, time.time()
    for i in range(1, n_max + 1):
        state, neigh = sim.run(state, neigh, 1)
        if fast:
            c = contact(state, neigh)
            if c != flag[-1]:
                marks[i - 1], marks[i] = thermo(*prev), thermo(state, neigh)
        else:
            marks[i] = thermo(state, neigh)
            c = marks[i][0] > 0
        flag.append(c)
        for k in fields:
            rec[k].append(host(getattr(state, k)[:4]))
        prev = (state, neigh)
        if flag[-2] and not c:
            n_ep += 1
            print(f"episode {n_ep} ends at step {i}  t {time.time() - t0:.1f}s",
                  flush=True)
            if n_ep == EPISODES:
                break
    ks = sorted(marks)
    np.savez(out, flag=np.array(flag), mark_step=np.array(ks),
             mark_pe=np.array([marks[k][0] for k in ks]),
             mark_etot=np.array([marks[k][1] for k in ks]),
             **{k: np.array(v) for k, v in rec.items()})
    print(f"# {i} steps {time.time() - t0:.1f}s", flush=True)


def episodes_of(rec):
    """[(first step in contact, first step out, etot before, etot after)]
    of a record's first five episodes."""
    flag = rec["flag"]
    etot = dict(zip(rec["mark_step"].tolist(), rec["mark_etot"].tolist()))
    out, i = [], 1
    while i < len(flag) and len(out) < EPISODES:
        if flag[i] and not flag[i - 1]:
            s = i
            while i < len(flag) and flag[i]:
                i += 1
            if i == len(flag):
                break
            out.append((s, i, etot[s - 1], etot[i]))
        i += 1
    return out


def cmd_starts(record, out):
    rec = np.load(record)
    s0 = [s - LEAD for s, *_ in episodes_of(rec)]
    np.savez(out, start=np.array([s + LEAD for s in s0]),
             **{k: rec[k][s0] for k in ("x", "v", "q", "angmom")})


def cmd_replay(pkg, seed, starts, out, device="cpu", perturb=0, f64=False):
    """Each episode from its start state; dE and, with ``perturb``, the dE
    of ``perturb`` ulp-perturbed starts."""
    rec = np.load(starts)
    sim, st0, _, contact, arr = build(pkg, seed, device, f64)
    zero = arr(np.zeros(tuple(st0.f.shape)))

    def episode(k, sgn=None):
        x = rec["x"][k].astype(np.float32)
        if sgn is not None:
            x = np.nextafter(x, np.where(sgn > 0, np.float32(np.inf),
                                         np.float32(-np.inf)), dtype=np.float32)
        st = st0.replace(x=arr(x), v=arr(rec["v"][k]), q=arr(rec["q"][k]),
                         angmom=arr(rec["angmom"][k]), f=zero, tau=zero)
        st, ng = sim.init_neighbors(st)
        e0, n, inside = float(sim.thermo(st, ng)["etot"]), 0, False
        while True:
            st, ng = sim.run(st, ng, 1)
            n += 1
            c = contact(st, ng)
            inside |= c
            if inside and not c:
                return e0, float(sim.thermo(st, ng)["etot"]), n
            if n > 5000:
                raise RuntimeError(f"episode {k + 1}: no end of contact")

    res, t0 = [], time.time()
    for k, s in enumerate(rec["start"].tolist()):
        e0, e1, n = episode(k)
        row = dict(episode=k + 1, start=s, e0=e0, e1=e1, dE=e1 - e0, steps=n)
        if perturb:
            rng = np.random.default_rng(k)
            row["dE_perturbed"] = []
            for _ in range(int(perturb)):
                a, b, _ = episode(k, rng.choice([-1, 1], size=(4, 3)))
                row["dE_perturbed"].append(b - a)
        res.append(row)
        print(json.dumps(row), f"t {time.time() - t0:.1f}s", flush=True)
    json.dump(dict(package=pkg, seed=seed, device=device, f64=f64,
                   episodes=res), open(out, "w"))


def _load(path):
    return json.load(open(path)) if os.path.exists(path) else None


def cmd_tables(ep_dir, rp_dir, drift_dir, seeds=range(4), n_seeds=8):
    box, free = None, {}
    print("free runs: dE of each episode (first step in contact - first out)")
    for s in seeds:
        runs = {}
        for name in ("jax", "port_cpu", "card"):
            p = Path(ep_dir) / f"{name}_s{s}.npz"
            if p.exists():
                runs[name] = np.load(p)
        if box is None:
            from spherharm_tpu_torch.validation import drift_lmax8
            _, st, _ = drift_lmax8.build(seed=s, device="cpu")
            box = float((st.box_hi - st.box_lo)[0])
        eps = {k: episodes_of(r) for k, r in runs.items()}
        xa = runs["jax"]["x"]
        for k in runs:
            if k == "jax":
                continue
            n = min(len(xa), len(runs[k]["x"]))
            d = xa[:n] - runs[k]["x"][:n]
            d -= box * np.round(d / box)
            bad = np.nonzero(np.abs(d).max(axis=(1, 2)) > 1e-3)[0]
            print(f"seed {s}: x of jax and {k} > 1e-3 apart from step "
                  f"{int(bad[0]) if len(bad) else None} (of {n})")
        free[s] = {k: [e1 - e0 for *_, e0, e1 in e] for k, e in eps.items()}
        for i in range(EPISODES):
            print(f"  {s} ep {i + 1}: " + " | ".join(
                f"{k} {e[i][0]}-{e[i][1]} {e[i][3] - e[i][2]:+.4e}"
                for k, e in eps.items() if i < len(e)))
    print("replays: dE from one start. The rule: each port run's dE (the "
          "replay's and the free run's) within max(1 % of |dE|, the "
          "reference's float32 noise) of the reference's, the noise its "
          "spread over its start and the ulp-moved starts plus |its float32 "
          "- float64|")
    gaps, worst = [], (0.0, None)
    for s in seeds:
        got = {k: _load(Path(rp_dir) / f"{k}_s{s}.json")
               for k in ("jax", "port_cpu", "card", "jax64", "port64")}
        for i in range(EPISODES):
            r = {k: v["episodes"][i] for k, v in got.items() if v}
            ref, j = r["jax64"]["dE"], r["jax"]
            starts = [j["dE"]] + j["dE_perturbed"]
            spread = np.ptp(starts)
            limit = max(0.01 * abs(ref), spread + abs(j["dE"] - ref))
            line = (f"  {s} ep {i + 1} start {j['start']}: f64 jax {ref:+.5e} "
                    f"port {r['port64']['dE']:+.5e} | jax {j['dE']:+.4e} "
                    f"(-f64 {j['dE'] - ref:+.1e}, spread {spread:.1e} over "
                    f"{len(starts)}) limit {limit:.1e}")
            for k in ("port_cpu", "card"):
                pairs = [("replay", r[k]["dE"], j["dE"])] if k in r else []
                if k in free.get(s, {}) and i < len(free[s][k]):
                    pairs.append(("free", free[s][k][i], free[s]["jax"][i]))
                for how, dE, dE_jax in pairs:
                    gap = dE - dE_jax
                    if how == "replay":
                        gaps.append(gap / spread)
                    worst = max(worst, (abs(gap) / limit, f"{s} ep {i + 1} "
                                        f"{k} {how}"))
                    line += (f" | {k} {how} {gap:+.1e} "
                             f"{'agree' if abs(gap) <= limit else 'APART'}")
            print(line)
    g = np.array(gaps)
    print(f"  worst gap / limit {worst[0]:.2f} ({worst[1]}); port replay - jax "
          f"in units of the jax spread over {len(g)} runs: mean {g.mean():+.3f}"
          f" +- {g.std(ddof=1) / np.sqrt(len(g)):.3f} (SE)")
    print("drift per 1M steps (%), last free-flight sample at or before "
          "260,000 (a 250,000-step run's last) and 1M steps")
    vals = {}
    for pkg in ("jax", "port"):
        for s in range(n_seeds):
            d = _load(Path(drift_dir) / f"{pkg}_s{s}.json")
            if not d:
                continue
            for name, at in (("250k", 260_000), ("1M", 1_000_000)):
                ok = [x for x in d["samples"] if x[0] <= at]
                if ok and d["steps"] >= at:
                    vals.setdefault((pkg, name), {})[s] = 100 * ok[-1][2]
    for key, v in sorted(vals.items()):
        a = np.array(list(v.values()))
        print(f"  {key[0]} {key[1]}: " + " ".join(
            f"s{s} {x:+.4f}" for s, x in sorted(v.items()))
              + f" | n {len(a)} mean {a.mean():+.4f} sd {a.std(ddof=1):.4f}"
              f" se {a.std(ddof=1) / np.sqrt(len(a)):.4f}")
    for name in ("250k", "1M"):
        j, p = vals.get(("jax", name)), vals.get(("port", name))
        if j and p and len(j) > 1:
            a, b = np.array(list(j.values())), np.array(list(p.values()))
            se = a.std(ddof=1) / np.sqrt(len(a))
            print(f"  {name}: port mean - jax mean {b.mean() - a.mean():+.4f}"
                  f", 2 SE(jax) {2 * se:.4f}: within "
                  f"{abs(b.mean() - a.mean()) <= 2 * se}")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd, rest = argv[0], argv[1:]
    pos, kw = _opts(rest)
    if cmd == "drift":
        cmd_drift(pos[0], int(pos[1]), pos[2], int(kw.get("steps", 1_000_000)),
                  int(kw.get("block", 20_000)), kw.get("device", "cuda"))
    elif cmd == "episodes":
        cmd_episodes(pos[0], int(pos[1]), pos[2], kw.get("device", "cpu"),
                     kw.get("fast", False))
    elif cmd == "starts":
        cmd_starts(pos[0], pos[1])
    elif cmd == "replay":
        cmd_replay(pos[0], int(pos[1]), pos[2], pos[3], kw.get("device", "cpu"),
                   int(kw.get("perturb", 0)), kw.get("f64", False))
    elif cmd == "tables":
        cmd_tables(*pos)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
