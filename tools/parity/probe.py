"""The conservative probe's bounce in the reference
(``scripts/conservative_probe.py``) and in the port
(``validation/conservative_probe.py``), and their laws along it.

    python tools/parity/probe.py run PKG MODE N_STEPS DT [--device D] [--f64] [--perturb K]
    python tools/parity/probe.py poses N_STEPS DT EVERY OUT.npz
    python tools/parity/probe.py poses64 POSES.npz DT
    python tools/parity/probe.py split FORCES N_STEPS DT

PKG is ``jax`` (the reference, on the CPU) or ``port``; MODE ``geom``,
``auto`` (or ``cons``, the port only).

* ``run``: the harness's own ``run`` (dE/E over one bounce). ``--f64``:
  shape tables, params and state built in float64; ``--perturb K``: the
  start's x moved 1 ulp (f32) up or down in every component at random
  (seed K), for the spread of dE/E under rounding.
* ``poses``: the reference's auto trajectory (its jit step, f32); every
  EVERY steps while the sampled PE is > 0 (and every 1000 otherwise) both
  packages' auto and geom forces and torques from the same f32 pose
  (the port's plain twins), |diff| over |F, tau|max; saves the pose and
  both packages' float32 forces.
* ``poses64``: at those poses in contact, the law in float64 (each
  package with the shape tables and every input in float64; the two
  agree to ~1e-10) and each package's float32 forces against it: in
  float32, and in float64 from float32 tables. Each over |F, tau|max.
* ``split``: the port's auto bounce (its steps, on the CPU) with the
  forces of one package at one precision and the state, so the
  integrator, at another: FORCES is ``<jax|port><32|64>_<32|64>``, e.g.
  ``jax32_64`` (the reference's float32 autograd forces, a float64
  integrator). It parts the bounce's float32 error into the law's and
  the integrator's.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from torch_port_util import jax_f64, on_cpu  # noqa: E402


def _reference():
    spec = importlib.util.spec_from_file_location(
        "conservative_probe_ref", ROOT / "scripts" / "conservative_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _moved(x, k):
    """x (float32) with every component 1 ulp up or down (seed k)."""
    x = np.asarray(x, np.float32)
    sgn = np.random.default_rng(k).choice([-1, 1], size=x.shape)
    return np.nextafter(x, np.where(sgn > 0, np.float32(np.inf),
                                    np.float32(-np.inf)), dtype=np.float32)


def builder(pkg, f64=False, tables64=True):
    """``build(dt, **kw)`` of PKG's probe module; ``f64``: every float of
    the build in float64, the shape tables built in float64 unless
    ``tables64`` is False (then float32 tables cast)."""
    if pkg == "jax":
        import jax.numpy as jnp
        mod = _reference()
        lib, dtype, cast = mod.shapes_library, jnp.float64, jax_f64
    else:
        import torch

        from spherharm_tpu_torch.models import shapes_library as lib
        from spherharm_tpu_torch.validation import conservative_probe as mod
        dtype, cast = torch.float64, lambda o: on_cpu(o, torch.float64)
    build = mod.build
    if not f64:
        return build

    def build64(dt, **kw):
        with (mock.patch.object(lib, "build_shapes", functools.partial(
                lib.build_shapes, dtype=dtype)) if tables64
              else contextlib.nullcontext()):
            return tuple(cast(o) for o in build(dt, **kw))
    return build64


def cmd_run(pkg, mode, n, dt, device="cpu", f64=False, perturb=0):
    if pkg == "jax":
        import jax
        if f64:
            jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        mod = _reference()
        wrap = lambda st: st.replace(x=jnp.asarray(_moved(st.x, perturb), st.x.dtype))
    else:
        import torch

        from spherharm_tpu_torch.validation import conservative_probe as mod
        if device == "cpu":
            torch.set_num_threads(1)
        wrap = lambda st: st.replace(x=torch.tensor(
            _moved(st.x.cpu().numpy(), perturb), dtype=st.x.dtype, device=st.x.device))
    build = builder(pkg, f64)
    moved = lambda dt_, **kw: (lambda sh, pa, st: (sh, pa, wrap(st)))(
        *build(dt_, **kw))
    t = time.time()
    with mock.patch.object(mod, "build", moved if perturb else build):
        if pkg == "jax":
            mod.run(mode, n, dt)
        else:
            mod.run(mode, n, dt, device=device,
                    out=lambda s: print(s, flush=True))
    print(f"# {pkg} {mode} dt {dt} f64 {f64} perturb {perturb}: "
          f"{time.time() - t:.1f}s", flush=True)


def cmd_poses(n_steps, dt, every, out):
    import jax
    import jax.numpy as jnp
    import torch
    from spherharm_tpu.ops import integrate as jint

    from spherharm_tpu_torch.validation import conservative_probe as tp
    torch.set_num_threads(1)
    ref = _reference()
    shapes, params, state = ref.build(dt)
    fa, fg, pe_of, meta_row = ref.make_force_fns(shapes, params)
    mi, mj = meta_row(state, 0), meta_row(state, 1)

    @jax.jit
    def step(state):
        state = jint.initial_integrate(state, shapes, params)
        f, tau = fa(state, mi, mj)
        pad = jnp.zeros((state.cap - 2, 3))
        state = state.replace(f=jnp.concatenate([f, pad]),
                              tau=jnp.concatenate([tau, pad]))
        return jint.final_integrate(state, shapes, params)

    pe_j = jax.jit(lambda s: pe_of(s.x[0], s.x[1], s.q[0], s.q[1], mi, mj))
    ref_fns = {"auto": lambda s: fa(s, mi, mj), "geom": jax.jit(fg)}
    tshapes, tparams, tst = tp.build(dt, device="cpu")
    forces, tpe = tp.make_force_fns(tshapes, tparams)
    rows = []
    for i in range(1, n_steps + 1):
        state = step(state)
        pe = float(pe_j(state))
        if not ((pe > 0 and i % every == 0) or i % 1000 == 0):
            continue
        x, q = np.asarray(state.x[:2]), np.asarray(state.q[:2])
        ts = tst.replace(x=torch.tensor(x), q=torch.tensor(q))
        r = dict(step=i, pe_ref=pe, pe_port=float(tpe(ts, False)), x=x, q=q)
        for mode, fn in ref_fns.items():
            jF, jT = fn(state)
            want = np.concatenate([np.asarray(jF[:2]), np.asarray(jT[:2])], 1)
            f, tau = forces[mode](ts)
            got = np.concatenate([f.numpy(), tau.numpy()], 1)
            r[mode] = (float(np.abs(got - want).max()), float(np.abs(want).max()))
            r[f"jax_{mode}"], r[f"port_{mode}"] = want, got
        rows.append(r)
        print(f"step {i:6d} pe ref {pe:.4e} port {r['pe_port']:.4e}  auto |d| "
              f"{r['auto'][0]:.3e} of {r['auto'][1]:.3e}  geom |d| "
              f"{r['geom'][0]:.3e} of {r['geom'][1]:.3e}", flush=True)
    if not rows:
        raise SystemExit("no pose kept: run 1000 steps or more")
    np.savez(out, **{k: [r[k] for r in rows] for k in rows[0]})


def _stacked(F, T):
    return np.concatenate([np.asarray(F[:2], np.float64),
                           np.asarray(T[:2], np.float64)], 1)


def cmd_poses64(poses, dt):
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    from spherharm_tpu_torch.validation import conservative_probe as tp
    torch.set_num_threads(1)
    ref = _reference()
    P = np.load(poses)
    fns = {}
    for name, tables64 in (("t64", True), ("f32t", False)):
        sh, pa, st = builder("jax", True, tables64)(dt)
        fa, fg, _, meta_row = ref.make_force_fns(sh, pa)
        mi, mj = meta_row(st, 0), meta_row(st, 1)
        tsh, tpa, tst = builder("port", True, tables64)(dt, device="cpu")
        forces, _ = tp.make_force_fns(tsh, tpa)
        fns[name] = (st, {"auto": jax.jit(lambda s, fa=fa, mi=mi, mj=mj: fa(s, mi, mj)),
                          "geom": jax.jit(fg)}, tst, forces)

    def both(name, mode, x, q):
        st, jf, tst, forces = fns[name]
        s = st.replace(x=st.x.at[:2].set(jnp.asarray(x)),
                       q=st.q.at[:2].set(jnp.asarray(q)))
        t = tst.replace(x=torch.tensor(x), q=torch.tensor(q))
        return _stacked(*jf[mode](s)), _stacked(*forces[mode](t))

    print("each over |F, tau|max of the law in float64 (the reference's): "
          "port - jax in float64 | float32 - float64, jax and port | float32 "
          "tables in float64 - float64, jax and port")
    worst = {}
    for i, step in enumerate(P["step"]):
        if P["pe_ref"][i] <= 0:
            continue
        x, q = P["x"][i].astype(np.float64), P["q"][i].astype(np.float64)
        for mode in ("auto", "geom"):
            law, port64 = both("t64", mode, x, q)
            scale = np.abs(law).max()
            err = lambda a: float(np.abs(a - law).max() / scale)
            row = (err(port64), err(P[f"jax_{mode}"][i]), err(P[f"port_{mode}"][i]),
                   *map(err, both("f32t", mode, x, q)))
            worst[mode] = np.maximum(worst.get(mode, 0.0), row)
            print(f"{step:6d} {mode} | {row[0]:.1e} | {row[1]:.2e} {row[2]:.2e} "
                  f"| {row[3]:.2e} {row[4]:.2e}", flush=True)
    for mode, row in worst.items():
        print(f"most {mode} | {row[0]:.1e} | {row[1]:.2e} {row[2]:.2e} | "
              f"{row[3]:.2e} {row[4]:.2e}")


def cmd_split(forces_of, n, dt):
    import torch

    from spherharm_tpu_torch.validation import conservative_probe as tp
    torch.set_num_threads(1)
    pkg, bits = forces_of.split("_")[0][:-2], forces_of.split("_")[0][-2:]
    state_dt = {"32": torch.float32, "64": torch.float64}[forces_of.split("_")[1]]
    sh32, pa32, st32 = tp.build(dt, device="cpu")
    if pkg == "port":
        sh, pa, _ = builder("port", bits == "64")(dt, device="cpu")
        law_dt = {"32": torch.float32, "64": torch.float64}[bits]
        law = tp.make_force_fns(sh, pa)[0]["auto"]

        def auto(state):
            f, tau = law(on_cpu(state, law_dt))
            return f.to(state_dt), tau.to(state_dt)
    else:
        import jax
        import jax.numpy as jnp
        assert bits == "32", "the reference's law runs in float32 here"
        ref = _reference()
        jsh, jpa, jst = ref.build(dt)
        fa, _, _, meta_row = ref.make_force_fns(jsh, jpa)
        mi, mj = meta_row(jst, 0), meta_row(jst, 1)
        law = jax.jit(lambda x, q: fa(jst.replace(
            x=jst.x.at[:2].set(x), q=jst.q.at[:2].set(q)), mi, mj))

        def auto(state):
            f, tau = law(*(jnp.asarray(a.numpy().astype(np.float32))
                           for a in (state.x, state.q)))
            return (torch.tensor(np.asarray(f[:2]), dtype=state_dt),
                    torch.tensor(np.asarray(tau[:2]), dtype=state_dt))
    pe32 = tp.make_force_fns(sh32, pa32)[1]
    t = time.time()
    with mock.patch.object(tp, "build", lambda *a, **k: tuple(
            on_cpu(o, state_dt) for o in (sh32, pa32, st32))), \
            mock.patch.object(tp, "make_force_fns", lambda *a: (
                {"auto": auto},
                lambda st, c: pe32(on_cpu(st, torch.float32), c).to(state_dt))):
        tp.run("auto", n, dt, device="cpu", out=lambda s: print(s, flush=True))
    print(f"# split {forces_of} dt {dt}: {time.time() - t:.1f}s", flush=True)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd, pos, kw, it = argv[0], [], {}, iter(argv[1:])
    for a in it:
        if a == "--f64":
            kw["f64"] = True
        elif a.startswith("--"):
            kw[a[2:]] = next(it)
        else:
            pos.append(a)
    if cmd == "run":
        cmd_run(pos[0], pos[1], int(pos[2]), float(pos[3]),
                kw.get("device", "cpu"), kw.get("f64", False),
                int(kw.get("perturb", 0)))
    elif cmd == "poses":
        cmd_poses(int(pos[0]), float(pos[1]), int(pos[2]), pos[3])
    elif cmd == "poses64":
        cmd_poses64(pos[0], float(pos[1]))
    elif cmd == "split":
        cmd_split(pos[0], int(pos[1]), float(pos[2]))
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
