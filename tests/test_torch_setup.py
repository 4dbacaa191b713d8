"""Torch port vs JAX reference: setup tables, containers, rotation and
integration (spherharm_tpu_torch core/state, models/shapes_library,
ops/sh_power, ops/rotation, ops/integrate)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherharm_tpu.core import state as jstate
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.models import shapes_library as jshapes
from spherharm_tpu.ops import integrate as jint
from spherharm_tpu.ops import rotation as jrot
from spherharm_tpu.ops import sh_power as jpow
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.models import scenarios as tscen
from spherharm_tpu_torch.models import shapes_library as tshapes
from spherharm_tpu_torch.ops import integrate as tint
from spherharm_tpu_torch.ops import rotation as trot
from spherharm_tpu_torch.ops import sh_power as tpow

from torch_port_util import blob_coeffs, np32, to_torch


@pytest.mark.parametrize("lmax", [4, 8])
def test_build_shapes_matches_reference(lmax):
    """Same float64 numpy pipeline, same f32 cast: bit-identical leaves."""
    coeffs = blob_coeffs(lmax, 3, seed=lmax)
    js = jshapes.build_shapes(coeffs, lmax, contact_quad=(8, 16))
    ts = tshapes.build_shapes(coeffs, lmax, contact_quad=(8, 16),
                              device="cpu")
    assert ts.lmax == js.lmax and ts.l1 == js.l1
    W = tpow.power_layout(lmax)["W"]
    assert ts.power_tbl.shape == (3, W)
    if lmax == 8:
        assert W == 177 and (lmax + 1) ** 2 == 81
    for f in dataclasses.fields(ts):
        if f.metadata.get("static"):
            continue
        np.testing.assert_array_equal(np32(getattr(ts, f.name)),
                                      np.asarray(getattr(js, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("kind", ["sphere", "ellipsoid", "blob"])
def test_shape_generators_match_reference(kind):
    lmax = 6
    args = {"sphere": (0.7, lmax), "ellipsoid": (0.6, 0.5, 0.4, lmax),
            "blob": (lmax, 3, 0.5, 0.15)}[kind]
    fn = f"{kind}_coeffs"
    np.testing.assert_array_equal(getattr(tshapes, fn)(*args),
                                  getattr(jshapes, fn)(*args))


@pytest.mark.parametrize("lmax", [4, 8])
def test_eval_power_matches_numpy(lmax):
    """Torch power-basis evaluation (r + gradients, and the r-only A/B
    prefix) vs the reference's numpy evaluator at float64."""
    tbl = jpow.build_power_tables_np(blob_coeffs(lmax, 2), lmax)
    rng = np.random.default_rng(1)
    th = rng.uniform(0.01, np.pi - 0.01, (2, 50))
    ph = rng.uniform(0, 2 * np.pi, (2, 50))
    ref = jpow.eval_power_np(tbl, th, ph, lmax)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    args = [t(np.cos(th)), t(np.sin(th)), t(np.cos(ph)), t(np.sin(ph))]
    got = tpow.eval_power(t(tbl), *args, lmax)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, atol=1e-12)
    r_ab = tpow.eval_power_r(t(tbl[:, : (lmax + 1) ** 2]), *args, lmax)
    np.testing.assert_allclose(r_ab.numpy(), ref[0], rtol=1e-12, atol=1e-12)


def _jax_containers(n=24, lmax=4, seed=2):
    rng = np.random.default_rng(seed)
    shapes = jshapes.build_shapes(blob_coeffs(lmax, 2), lmax,
                                  contact_quad=(8, 16))
    params = jstate.SimParams.create(
        dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4, k_roll=2e4, gamma_roll=10.0,
        mu_roll=0.2, gravity=(0.0, 0.0, -10.0), skin=0.2, cutoff=1.4)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    state = jscen.make_state(
        rng.uniform(0.5, 3.5, (n, 3)), [0, 0, 0], [4, 4, 4],
        v=rng.normal(size=(n, 3)), q=q, angmom=rng.normal(size=(n, 3)) * 0.1,
        scale=rng.uniform(0.8, 1.2, n), shtype=rng.integers(0, 2, n),
        cap=n + 4)
    state = state.replace(
        f=jnp.asarray(rng.normal(size=(n + 4, 3)) * 50, jnp.float32),
        tau=jnp.asarray(rng.normal(size=(n + 4, 3)) * 5, jnp.float32))
    return shapes, params, state


def test_from_numpy_roundtrip():
    """JAX containers -> numpy -> torch keep every leaf (ints as int64)."""
    shapes, params, state = _jax_containers()
    neigh = jstate.empty_neighbors(state.cap, 6, 2, pair_cap=10)
    for cls, obj in ((tstate.Shapes, shapes), (tstate.SimParams, params),
                     (tstate.State, state), (tstate.NeighborState, neigh)):
        tob = to_torch(cls, obj)
        for f in dataclasses.fields(cls):
            got = getattr(tob, f.name)
            want = getattr(obj, f.name)
            if f.metadata.get("static"):
                assert got == want
                continue
            np.testing.assert_array_equal(np32(got), np.asarray(want),
                                          err_msg=f"{cls.__name__}.{f.name}")
    # The builders make the same containers directly.
    ts = tscen.make_state(np.asarray(state.x)[:24], [0, 0, 0], [4, 4, 4],
                          cap=state.cap, device="cpu")
    np.testing.assert_array_equal(np32(ts.active), np.asarray(state.active))
    np.testing.assert_array_equal(np32(ts.tag), np.asarray(state.tag))
    tp = tstate.SimParams.create(
        dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4, k_roll=2e4, gamma_roll=10.0,
        mu_roll=0.2, gravity=(0.0, 0.0, -10.0), skin=0.2, cutoff=1.4,
        device="cpu")
    for f in dataclasses.fields(tp):
        np.testing.assert_array_equal(np32(getattr(tp, f.name)),
                                      np.asarray(getattr(params, f.name)))


def test_rotation_and_integration_match_reference():
    shapes, params, state = _jax_containers(n=40, seed=5)
    ts, tp = to_torch(tstate.Shapes, shapes), to_torch(tstate.SimParams,
                                                       params)
    tst = to_torch(tstate.State, state)
    tol = dict(rtol=2e-6, atol=2e-6)

    v = np.random.default_rng(0).normal(size=(state.cap, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np32(trot.quat_rotate(tst.q, torch.as_tensor(v))),
        np.asarray(jrot.quat_rotate(state.q, jnp.asarray(v))), **tol)
    np.testing.assert_allclose(
        np32(trot.quat_rotate_inv(tst.q, torch.as_tensor(v))),
        np.asarray(jrot.quat_rotate_inv(state.q, jnp.asarray(v))), **tol)
    inertia = shapes.inertia_of(state.shtype, state.scale)
    np.testing.assert_allclose(
        np32(trot.omega_from_angmom(tst.q, tst.angmom,
                                    ts.inertia_of(tst.shtype, tst.scale))),
        np.asarray(jrot.omega_from_angmom(state.q, state.angmom, inertia)),
        rtol=1e-5, atol=1e-5)

    j1 = jint.initial_integrate(state, shapes, params)
    t1 = tint.initial_integrate(tst, ts, tp)
    for name in ("x", "v", "q", "angmom"):
        np.testing.assert_allclose(np32(getattr(t1, name)),
                                   np.asarray(getattr(j1, name)), **tol,
                                   err_msg=name)
    assert int(t1.step) == int(j1.step) == 1
    j2 = jint.final_integrate(j1, shapes, params)
    t2 = tint.final_integrate(t1, ts, tp)
    for name in ("v", "angmom"):
        np.testing.assert_allclose(np32(getattr(t2, name)),
                                   np.asarray(getattr(j2, name)), **tol)
    j3, jxb, _ = jint.apply_deformation(j2, j2.x, params)
    t3, txb, _ = tint.apply_deformation(t2, t2.x, tp)
    np.testing.assert_array_equal(np32(t3.x), np.asarray(j3.x))
    np.testing.assert_array_equal(np32(txb), np.asarray(jxb))
    for a, b in zip(tint.kinetic_energy(t2, ts),
                    jint.kinetic_energy(j2, shapes)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_import_without_jax():
    """The port never imports jax, not even indirectly."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import spherharm_tpu_torch\n"
        "from spherharm_tpu_torch.models import scenarios\n"
        "from spherharm_tpu_torch.ops import contact_kernels, walls_kernels\n"
        "from spherharm_tpu_torch.ops import sh_math\n"
        "from spherharm_tpu_torch.io import data, deck, dump\n"
        "from spherharm_tpu_torch import native\n"
        "from spherharm_tpu_torch.parallel import ensemble\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'spherharm_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
