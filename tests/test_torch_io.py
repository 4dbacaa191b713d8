"""Restart and thermo-log I/O of the torch port (``io/restart.py``,
``io/thermo_log.py``): the port's own round trip is bit-exact with
contact history, and a restart written by the JAX package loads into the
port and the run continues as the reference continues it, a sheared
triaxial cell too (tolerances as tests/test_torch_scenarios.py: energies
rtol 2e-3, positions 1e-3)."""

import jax
import numpy as np

from spherharm_tpu.io import restart as jrestart
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu_torch.io import restart, thermo_log
from spherharm_tpu_torch.models import scenarios

from test_torch_triclinic import triaxial_pair
from torch_port_util import contact_rich_state, np32, pressed_box_state


def test_restart_roundtrip_bitexact(tmp_path):
    """Resume reproduces the exact trajectory, friction springs included
    (tests/test_io.py's round trip, from a settling box pressed onto its
    floor so the springs are live)."""
    sim, st0, _ = scenarios.settling_box(n=27, k_max=16, device="cpu")
    x, angmom = pressed_box_state(np32(st0.x), float(sim.shapes.rmax[0]))
    st = scenarios.make_state(x, np32(st0.box_lo), np32(st0.box_hi),
                              q=np32(st0.q), angmom=angmom, device="cpu")
    state, neigh = sim.run(*sim.init_neighbors(st), 30)
    assert float(neigh.hist.abs().max()) > 0
    assert float(neigh.wall_hist.abs().max()) > 0
    path = tmp_path / "rs.npz"
    restart.write_restart(path, state, neigh, sim.params,
                          extra={"done": 30})
    s2, n2, p2, extra = restart.read_restart(tmp_path / "rs", device="cpu")
    assert int(extra["done"]) == 30
    for f in ("kn", "gamma_n", "mu", "pair_tab"):
        np.testing.assert_array_equal(np32(getattr(p2, f)),
                                      np32(getattr(sim.params, f)))
    a_state, a_neigh = sim.run(state, neigh, 20)
    b_state, b_neigh = sim.run(s2, n2, 20)
    for f in ("x", "v", "q", "angmom"):
        np.testing.assert_array_equal(np32(getattr(a_state, f)),
                                      np32(getattr(b_state, f)))
    for f in ("hist", "wall_hist", "idx", "mask"):
        np.testing.assert_array_equal(np32(getattr(a_neigh, f)),
                                      np32(getattr(b_neigh, f)))


def test_jax_restart_continues_in_port(tmp_path):
    """A restart written by the JAX package (deposition, n = 128, Lmax 4,
    pair list with live springs, 20 steps in) loads into the port; 10
    continued steps match the reference's own continuation from the same
    file."""
    kw = dict(n=128, lmax=4)
    jsim, jst0, _ = jscen.deposition(exact_eval=True, **kw)
    tsim, _, _ = scenarios.deposition(device="cpu", **kw)
    R = float(jsim.walls[0].radius)
    L = float(jsim.walls[2].point[1] - jsim.walls[1].point[1])
    shtype = np.asarray(jst0.shtype)
    scale = np.asarray(jst0.scale, np.float64)
    radius = np.asarray(jsim.shapes.rchar, np.float64)[shtype] * scale
    x, angmom = contact_rich_state(np.asarray(jst0.x), radius, R, L)
    js, jn = jsim.run(*jsim.init_neighbors(jscen.make_state(
        x, np.asarray(jst0.box_lo), np.asarray(jst0.box_hi),
        q=np.asarray(jst0.q), angmom=angmom, scale=scale, shtype=shtype)), 20)
    assert float(np.abs(np.asarray(jn.pair_hist)).max()) > 0
    path = tmp_path / "jax.npz"
    jrestart.write_restart(path, js, jn, jsim.params, extra={"done": 20})

    ts, tn, tp, extra = restart.read_restart(path, device="cpu")
    assert int(extra["done"]) == 20 and int(ts.step) == 20
    np.testing.assert_array_equal(np32(tn.pair_hist), np.asarray(jn.pair_hist))
    np.testing.assert_array_equal(np32(tp.kn), np.asarray(jsim.params.kn))
    ts, tn = tsim.run(ts, tn, 10)
    js2, jn2, _, _ = jrestart.read_restart(path)
    js2, jn2 = jsim.run(js2, jn2, 10)
    jax.block_until_ready(js2.x)
    jth = {k: float(v) for k, v in jsim.thermo(js2, jn2).items()
           if np.ndim(v) == 0}
    tth = {k: float(v) for k, v in tsim.thermo(ts, tn).items()
           if v.ndim == 0}
    assert int(tn.overflow) == 0 and tth["pe_pair"] > 0 and tth["pe_wall"] > 0
    assert int(tth["step"]) == int(jth["step"]) == 30
    for k in ("ke", "erot", "pe_pair", "pe_wall", "pe_grav", "etot"):
        np.testing.assert_allclose(tth[k], jth[k], rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(np32(ts.x), np.asarray(js2.x), rtol=0,
                               atol=1e-3)


def test_jax_restart_of_sheared_cell_continues_in_port(tmp_path):
    """A JAX restart of the sheared triaxial cell (n = 128, xy shear, the
    servo on, 15 steps in, its tilt past its flip) loads into the port with
    its tilt and shear_rate, and 10 more steps in the port match the
    reference's own continuation from the same file."""
    jsim, js, jn, tsim, _, _ = triaxial_pair(shear_rate=(0.05, 0.0, 0.0),
                                             press_tau=1.0)
    js, jn = jsim.run(js, jn, 15)
    assert float(js.tilt[0]) < 0  # flipped
    path = tmp_path / "sheared.npz"
    jrestart.write_restart(path, js, jn, jsim.params, extra={"done": 15})
    ts, tn, tp, extra = restart.read_restart(path, device="cpu")
    np.testing.assert_array_equal(np32(ts.tilt), np.asarray(js.tilt))
    for f in ("shear_rate", "press_tau", "pair_tab", "deform_rate"):
        np.testing.assert_array_equal(np32(getattr(tp, f)),
                                      np32(getattr(tsim.params, f)))
    ts, tn = tsim.run(ts, tn, 10)
    js2, jn2, _, _ = jrestart.read_restart(path)
    js2, jn2 = jsim.run(js2, jn2, 10)
    jax.block_until_ready(js2.x)
    assert int(tn.overflow) == int(jn2.overflow) == 0
    np.testing.assert_allclose(np32(ts.tilt), np.asarray(js2.tilt), rtol=1e-5)
    np.testing.assert_allclose(np32(ts.box_hi), np.asarray(js2.box_hi),
                               rtol=1e-6)
    np.testing.assert_array_equal(np32(ts.image), np.asarray(js2.image))
    np.testing.assert_allclose(np32(ts.x), np.asarray(js2.x), rtol=0,
                               atol=1e-4)
    jth, tth = jsim.thermo(js2, jn2), tsim.thermo(ts, tn)
    assert float(tth["pe_pair"]) > 0
    for k in ("ke", "pe_pair", "etot", "press"):
        np.testing.assert_allclose(float(tth[k]), float(jth[k]), rtol=2e-3,
                                   err_msg=k)


def test_thermo_log_roundtrip(tmp_path):
    """Rows logged from Simulation.thermo come back from the log file:
    the header carries the LAMMPS column names, each row the formatted
    values, and ``rows`` / ``series`` keep every scalar (not the stress
    tensor)."""
    sim, st, ng = scenarios.two_body_collision(conservative=False,
                                               device="cpu")
    path = tmp_path / "thermo.log"
    log = thermo_log.ThermoLog(path, echo=False)
    for _ in range(3):
        st, ng = sim.run(st, ng, 250)
        log.log(sim.thermo(st, ng))
    log.close()
    lines = path.read_text().splitlines()
    assert lines[0].split() == [h for _, h, _ in thermo_log.DEFAULT_COLUMNS]
    assert len(lines) == 4
    rows = [[float(v) for v in line.split()] for line in lines[1:]]
    assert [int(r[0]) for r in rows] == [250, 500, 750]
    np.testing.assert_allclose([r[7] for r in rows], log.series("etot"),
                               rtol=1e-5)
    assert "neigh_overflow" in log.rows[0] and "stress" not in log.rows[0]
