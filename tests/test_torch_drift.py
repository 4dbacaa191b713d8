"""The N-scale energy-drift harness of the torch port
(``spherharm_tpu_torch.models.drift``) vs the reference's
``scripts/drift_scale.py``, which the test loads by path (the port keeps
its own copy and imports nothing of it).

The 20-step parity runs both packages on the pair list without the
prefilter (the reference's ``DRIFT_PALLAS=0``: ``use_pallas=False``,
``stage2_capacity=0``), the JAX side with ``exact_eval=True``: the
interpret-mode conservative Pallas kernel is too slow for tier-1 over 20
steps. The prefiltered path is held by the prefilter tests and, on the
card, by ``chip_smoke.py``. Tolerances as tests/test_torch_scenarios.py:
energies rtol 2e-3, positions 1e-3 absolute.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from spherharm_tpu.core.simulation import Simulation as JSimulation
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.ops.neighbor import CellGrid as JCellGrid
from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.models import drift, scenarios
from spherharm_tpu_torch.ops.neighbor import CellGrid

from torch_port_util import np32

N = 64


@pytest.fixture(scope="module")
def ref_build():
    path = Path(__file__).resolve().parents[1] / "scripts" / "drift_scale.py"
    spec = importlib.util.spec_from_file_location("drift_scale_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build


def test_build_gas_matches_reference(ref_build):
    jsim, jst = ref_build(N)
    tsim, tst = drift.build_gas(N, device="cpu")
    for f in ("x", "v", "q", "angmom", "scale", "box_lo", "box_hi"):
        np.testing.assert_allclose(np32(getattr(tst, f)),
                                   np.asarray(getattr(jst, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    for f in ("shtype", "tag", "active"):
        np.testing.assert_array_equal(np32(getattr(tst, f)),
                                      np.asarray(getattr(jst, f)))
    for f in ("dt", "kn", "kt", "gamma_n", "mu", "skin", "cutoff"):
        assert float(getattr(tsim.params, f)) == float(getattr(jsim.params, f))
    np.testing.assert_array_equal(np32(tsim.shapes.power_tbl),
                                  np.asarray(jsim.shapes.power_tbl))
    assert tsim.grid.dims == jsim.grid.dims
    assert tsim.periodic == jsim.periodic == (True, True, True)
    for f in ("k_max", "cell_cap", "pair_capacity", "stage2_capacity",
              "conservative", "prefilter"):
        assert getattr(tsim, f) == getattr(jsim, f), f


def test_gas_20_steps_match_reference(ref_build):
    """The gas compressed homogeneously (positions and periodic box by
    0.9) so contacts form at once, then 20 steps in both packages."""
    jsim0, jst = ref_build(N)
    c = 0.9
    box = float(jst.box_hi[0]) * c
    state = dict(v=np.asarray(jst.v), q=np.asarray(jst.q),
                 shtype=np.asarray(jst.shtype))
    x = np.asarray(jst.x, np.float64) * c
    cut = float(jsim0.params.cutoff) + float(jsim0.params.skin)
    kw = dict(periodic=(True,) * 3, neighbor_mode="cell", k_max=24,
              cell_cap=16, pair_capacity=6 * N, stage2_capacity=0,
              conservative=True)
    jsim = JSimulation(jsim0.shapes, jsim0.params,
                       grid=JCellGrid([0] * 3, [box] * 3, cut, (True,) * 3),
                       use_pallas=False, exact_eval=True, **kw)
    tsim0, _ = drift.build_gas(N, device="cpu")
    tsim = Simulation(tsim0.shapes, tsim0.params,
                      grid=CellGrid([0] * 3, [box] * 3, cut, (True,) * 3),
                      device="cpu", **kw)
    assert not tsim.prefilter and not jsim.prefilter
    js, jn = jsim.run(*jsim.init_neighbors(
        jscen.make_state(x, [0] * 3, [box] * 3, **state)), 20)
    jax.block_until_ready(js.x)
    ts, tn = tsim.run(*tsim.init_neighbors(
        scenarios.make_state(x, [0] * 3, [box] * 3, device="cpu", **state)),
        20)
    jth, tth = jsim.thermo(js, jn), tsim.thermo(ts, tn)
    assert int(jn.overflow) == 0 and int(tn.overflow) == 0
    assert float(jth["pe_pair"]) > 0.1 * float(jth["ke"])  # not vacuous
    for k in ("etot", "pe_pair", "ke", "erot"):
        np.testing.assert_allclose(float(tth[k]), float(jth[k]), rtol=2e-3,
                                   err_msg=k)
    np.testing.assert_allclose(np32(ts.x), np.asarray(js.x), rtol=0,
                               atol=1e-3)


def test_drift_slope_is_the_fitted_slope():
    rng = np.random.default_rng(0)
    steps = np.arange(1, 41) * 2000.0
    etot = -150.0 + 3e-6 * steps + rng.normal(size=steps.shape) * 1e-3
    samples = list(zip(steps, etot))
    want = np.polyfit(steps, etot, 1)[0] * 1e6 / abs(etot[0])
    assert drift.drift_slope(samples) == pytest.approx(want, rel=1e-12)
    assert drift.drift_slope(samples) == pytest.approx(3.0 / 150.0, rel=0.02)


def test_drift_cli_checkpoints_and_resumes(tmp_path, capsys):
    """The command line on the CPU: 2 blocks with a checkpoint, then a
    resumed run to 3 blocks continues from the checkpoint's step and
    samples."""
    ck = str(tmp_path / "gas.npz")
    argv = ["--n", str(N), "--block", "2", "--device", "cpu", "--restart",
            ck]
    assert drift.main(argv + ["--steps", "4"]) == 0
    first = capsys.readouterr().out
    assert "RESULT" in first and Path(ck).exists()
    assert drift.main(argv + ["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "# resumed at step 4" in out
    assert "step         6" in out and "step         2" not in out
    with pytest.raises(SystemExit):  # one block gives no slope
        drift.main(["--steps", "2", "--block", "2", "--device", "cpu"])
