"""The reference's validation harnesses (``scripts/``) against their port
(``spherharm_tpu_torch/validation/``), each script loaded by path
(``torch_port_util.load_script``; the port imports none of them).

* Builders: shapes, params, state and the Simulation's configuration
  equal to the script's (floats rtol 1e-6). ``packing_n500.py`` and
  ``restitution_curve.py`` build inline in their ``main``: their port
  builders are held to the same calls of the JAX package.
  ``cadence_sweep.py`` dies without a TPU at import, so nothing on the CPU
  compares with it; its drum is ``rotating_drum``, which
  tests/test_torch_scenarios.py holds to the reference.
* Short runs, both packages from one start moved into contact (the JAX
  side ``exact_eval=True``), 20 steps: ke and erot rtol 2e-3, positions
  1e-3 and velocities 5e-3 absolute, the forces of the last step within
  2e-3 |F|max (the four blobs in the geometric law, the collider in the
  conservative law).
* The probe's forces at an overlapping pose against the script's
  ``make_force_fns``: the geometric law (K2's twin) and the autograd
  gradient of its PE, each within 1e-5 |F, tau|max, tighter than the
  reference's own bound for the geometric law, 2e-3 (tests/test_pallas.py):
  both agree to ~1e-6 at this pose (Lmax 4 and 8).
* Each ``main`` with ``--device cpu`` at a tiny size, and the two timing
  tools' smoke runs (n = 128 drum, one cadence, the stage names printed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherharm_tpu.core import state as jstate
from spherharm_tpu.core.simulation import Simulation as JSimulation
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.ops import integrate as jintegrate
from spherharm_tpu.parallel import ensemble as jens
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.ops import integrate
from spherharm_tpu_torch.validation import (
    cadence_sweep,
    conservative_probe,
    drift,
    drift_lmax8,
    packing_n500,
    profile_step,
    restitution_curve,
)

from torch_port_util import load_script, np32

STEPS = 20


def _same_state(ts, js):
    for f in ("x", "v", "q", "angmom", "scale", "box_lo", "box_hi"):
        np.testing.assert_allclose(np32(getattr(ts, f)),
                                   np.asarray(getattr(js, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    for f in ("shtype", "tag", "active"):
        np.testing.assert_array_equal(np32(getattr(ts, f)),
                                      np.asarray(getattr(js, f)), err_msg=f)


def _same_params(tp, jp):
    for f in ("dt", "kn", "kt", "gamma_n", "gamma_t", "mu", "skin", "cutoff",
              "gravity", "pair_tab"):
        np.testing.assert_allclose(np32(getattr(tp, f)),
                                   np.asarray(getattr(jp, f)), rtol=1e-6,
                                   err_msg=f)


def _same_shapes(tsh, jsh):
    for f in ("power_tbl", "rmax", "rmin", "rchar", "vol", "inertia",
              "cap_x", "cap_glw"):
        np.testing.assert_allclose(np32(getattr(tsh, f)),
                                   np.asarray(getattr(jsh, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def _same_setup(tsim, ts, jsim, js):
    _same_state(ts, js)
    _same_params(tsim.params, jsim.params)
    _same_shapes(tsim.shapes, jsim.shapes)
    for f in ("neighbor_mode", "k_max", "periodic", "conservative",
              "pair_capacity", "rebuild_every"):
        assert getattr(tsim, f) == getattr(jsim, f), f


def _same_run(tsim, ts, jsim, js):
    """ke and erot rtol 2e-3, x 1e-3, v 5e-3, the last step's forces
    2e-3 |F|max."""
    tke = [float(e) for e in integrate.kinetic_energy(ts, tsim.shapes)]
    jke = [float(e) for e in jintegrate.kinetic_energy(js, jsim.shapes)]
    np.testing.assert_allclose(tke, jke, rtol=2e-3, atol=1e-12)
    np.testing.assert_allclose(np32(ts.x), np.asarray(js.x), atol=1e-3)
    np.testing.assert_allclose(np32(ts.v), np.asarray(js.v), atol=5e-3)
    jf = np.asarray(js.f)
    fmax = np.abs(jf).max()
    assert fmax > 1.0  # in contact: not vacuous
    np.testing.assert_allclose(np32(ts.f), jf, atol=2e-3 * fmax)


def _no_init(sim, state):
    """A stand-in for the JAX ``Simulation.init_neighbors`` where a test
    needs a builder's set-up only: its first build compiles for seconds on
    the CPU (the interp-table radius)."""
    return state, None


def _empty_lists(cap, k_max):
    """Empty neighbour lists in both packages: a run from them rebuilds at
    its first step, with the forces of the start at zero in both. The JAX
    overflow channel int64, as its rebuild writes it under
    jax_enable_x64 (tests/conftest.py)."""
    jn = jstate.empty_neighbors(cap, k_max, 0)
    return (jn.replace(overflow=jn.overflow.astype(jnp.int64)),
            tstate.empty_neighbors(cap, k_max, 0, device="cpu"))


@pytest.fixture(scope="module")
def four_blob_ref():
    """The reference's four blobs (geometric law, dt 1e-4, 10 x 20)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(JSimulation, "init_neighbors", _no_init)
        return load_script("drift_lmax8").build(dt=1e-4, quad=10)[:2]


def test_drift_lmax8_build_matches_reference(four_blob_ref):
    jsim, js = four_blob_ref
    tsim, ts, tn = drift_lmax8.build(device="cpu")
    _same_setup(tsim, ts, jsim, js)
    assert tsim.shapes.cap_x.shape[0] == 200
    assert float(tsim.thermo(ts, tn)["pe_pair"]) == 0.0  # free flight


def test_drift_lmax8_run_matches_reference(four_blob_ref):
    """Blob 1 moved 0.45 toward blob 0 (centres 1.92 apart, rmax 1.08):
    20 steps in contact from empty lists (``_empty_lists``)."""
    jsim0, js = four_blob_ref
    x = np.asarray(js.x, np.float64)
    x[1, 0] -= 0.45
    jsim = JSimulation(jsim0.shapes, jsim0.params, neighbor_mode="allpairs",
                       k_max=3, periodic=(True,) * 3, conservative=False,
                       exact_eval=True)
    jn, tn = _empty_lists(js.cap, 3)
    js, jn = jsim.run(js.replace(x=jnp.asarray(x, jnp.float32)), jn, STEPS)
    jax.block_until_ready(js.x)
    tsim, ts, _ = drift_lmax8.build(device="cpu")
    ts, tn = tsim.run(ts.replace(x=torch.tensor(x, dtype=torch.float32)), tn,
                      STEPS)
    assert float(tsim.thermo(ts, tn)["pe_pair"]) > 0
    _same_run(tsim, ts, jsim, js)


def test_collider_build_and_run_match_reference(monkeypatch):
    """The collider as built, then both spheres moved 0.26 inward (0.02
    overlap) and 20 steps in the conservative law from empty lists."""
    with monkeypatch.context() as m:
        m.setattr(JSimulation, "init_neighbors", _no_init)
        jsim0, js, _ = load_script("drift").build_collider()
    tsim, ts, _ = drift.build(device="cpu")
    _same_setup(tsim, ts, jsim0, js)
    x = np.asarray(js.x, np.float64)
    x[:, 0] += [0.26, -0.26]
    jsim = JSimulation(jsim0.shapes, jsim0.params, neighbor_mode="allpairs",
                       k_max=1, periodic=(True, False, False),
                       exact_eval=True)
    jn, tn = _empty_lists(js.cap, 1)
    js, jn = jsim.run(js.replace(x=jnp.asarray(x, jnp.float32)), jn, STEPS)
    jax.block_until_ready(js.x)
    ts, tn = tsim.run(ts.replace(x=torch.tensor(x, dtype=torch.float32)), tn,
                      STEPS)
    _same_run(tsim, ts, jsim, js)


@pytest.fixture(scope="module")
def probe_ref():
    return load_script("conservative_probe")


def test_probe_build_matches_reference(probe_ref):
    jshapes, jparams, js = probe_ref.build(1e-4)
    tshapes, tparams, ts = conservative_probe.build(1e-4, device="cpu")
    _same_state(ts, js)
    _same_params(tparams, jparams)
    _same_shapes(tshapes, jshapes)


def test_probe_forces_match_reference(probe_ref):
    """At an overlapping pose (centres 0.9 apart): the geometric law and
    the autograd gradient of its sampled PE, forces and torques. Lmax 4
    on the builder's 10 x 20 cap grid: the JAX gradient's compile at Lmax
    8 costs the CPU ~10 s more (the card runs Lmax 8)."""
    jshapes, jparams, js = probe_ref.build(1e-4, lmax=4)
    x = np.asarray(js.x, np.float64)
    x[:, 0] = [-0.45, 0.45]
    js = js.replace(x=jnp.asarray(x, jnp.float32))
    forces_auto, forces_geom, _, meta_row = probe_ref.make_force_fns(
        jshapes, jparams)
    want = {"auto": forces_auto(js, meta_row(js, 0), meta_row(js, 1)),
            "geom": jax.jit(forces_geom)(js)}
    tshapes, tparams, ts = conservative_probe.build(1e-4, lmax=4,
                                                    device="cpu")
    ts = ts.replace(x=torch.tensor(x, dtype=torch.float32))
    forces, pe_of = conservative_probe.make_force_fns(tshapes, tparams)
    assert float(pe_of(ts, False)) > 0
    for mode, (jf, jtau) in want.items():
        f, tau = forces[mode](ts)
        ref = np.concatenate([np.asarray(jf), np.asarray(jtau)], axis=1)
        got = np.concatenate([np32(f), np32(tau)], axis=1)
        scale = np.abs(ref).max()
        assert scale > 100.0
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale,
                                   err_msg=mode)
    # The conservative law (K1's twin) pushes the pair apart as well.
    f, _ = forces["cons"](ts)
    assert float(f[0, 0]) < 0 < float(f[1, 0])


def test_packing_build_matches_reference(monkeypatch):
    """``build`` is ``settling_box`` at the script's settings (n = 64)."""
    monkeypatch.setattr(JSimulation, "init_neighbors", _no_init)
    jsim, js, _ = jscen.settling_box(n=64, lmax=2, dt=2e-4, gamma_n=400.0,
                                     mu=0.4, k_max=24)
    tsim, ts, _ = packing_n500.build(64, device="cpu")
    _same_setup(tsim, ts, jsim, js)
    assert len(tsim.walls) == len(jsim.walls) == 5
    assert tsim.grid.dims == jsim.grid.dims


def test_restitution_build_matches_reference(monkeypatch):
    """``build`` is the script's two-body collision replicated over
    gamma_n = linspace(0, 700, 8)."""
    monkeypatch.setattr(JSimulation, "init_neighbors", _no_init)
    jsim, js, _ = jscen.two_body_collision(gamma_n=0.0, dt=2e-4)
    n_g = 8
    jp = jens.with_param_sweep(
        jsim.params, gamma_n=jnp.asarray(np.linspace(0.0, 700.0, n_g),
                                         jnp.float32))
    tsim, ts, tn, tp, gammas = restitution_curve.build(n_g, device="cpu")
    _same_state(ts, jens.replicate(js, n_g))
    _same_params(tp, jp)
    _same_shapes(tsim.shapes, jsim.shapes)
    np.testing.assert_array_equal(gammas, np.asarray(jp.gamma_n))
    assert tsim.conservative and jsim.conservative


@pytest.mark.parametrize("law", ["geometric", "conservative"])
def test_drift_lmax8_main_cpu(law, capsys):
    assert drift_lmax8.main(["4", "2", "--law", law, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"# law {law}" in out and "# RESULT (Lmax=8 aspherical)" in out
    assert "step         4" in out


def test_collider_main_cpu(capsys):
    assert drift.main(["20", "10", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "# e0 = " in out and "# RESULT: +0.0000% per 1M steps" in out


def test_probe_main_cpu(capsys):
    assert conservative_probe.main(["4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for mode in conservative_probe.MODES:
        assert f"{mode:5s}: e0 " in out
    assert "# RESULT: dE/E over one bounce" in out


def test_packing_main_cpu(capsys):
    assert packing_n500.main(["27", "2", "--block", "10",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "block   1" in out and "active 27/27; overflow 0" in out
    assert "# RESULT: packing fraction phi = " in out


def test_restitution_main_cpu(capsys):
    """Two replicas, 10 steps: the table printed, then the script's first
    assert fails (no collision yet: e = -1). The collision itself is held
    to the reference's sweep by tests/test_torch_ensemble.py."""
    with pytest.raises(AssertionError, match="elastic limit"):
        restitution_curve.main(["2", "--steps", "10", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "   gamma_n  restitution" in out
    assert "     700.0     -1.00000" in out


def test_cadence_sweep_main_cpu(capsys):
    assert cadence_sweep.main(["--n", "128", "--lmax", "2", "--r", "2",
                               "--steps", "2", "--warm", "2", "--reps", "1",
                               "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("rebuild step:", "plain step:", "block of 20:", "R= 2 ",
                 "# RESULT (cpu): R=2 "):
        assert name in out, name


def test_profile_step_main_cpu(capsys):
    assert profile_step.main(["128", "2", "--settle", "2", "--reps", "1",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in profile_step.STAGES + ("  cell_list", "  remap",
                                       "  pair_build", "  prefilter"):
        assert f"\n{name} " in out or out.startswith(f"{name} "), name
    assert "# RESULT (cpu): step " in out
