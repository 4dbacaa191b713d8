"""Restart and thermo-log I/O of the torch port (``io/restart.py``,
``io/thermo_log.py``): the port's own round trip is bit-exact with
contact history, and a restart written by the JAX package loads into the
port and the run continues as the reference continues it, a sheared
triaxial cell too (tolerances as tests/test_torch_scenarios.py: energies
rtol 2e-3, positions 1e-3)."""

import jax
import pytest
import torch
import numpy as np

from spherharm_tpu.io import restart as jrestart
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu_torch.io import restart, thermo_log
from spherharm_tpu_torch.models import scenarios, shapes_library

from test_torch_triclinic import triaxial_pair
from torch_port_util import (contact_rich_state, np32, pressed_box_state,
                             to_torch)


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


# -- dump, coeff and data files (tests/test_io.py, tests/test_native.py) ----


def _jax_and_port_states():
    """A JAX settling box (n = 8) with motion and spin, and the same state
    and shapes as the port's containers."""
    from spherharm_tpu_torch.core.state import Shapes, State

    jsim, js, _ = jscen.settling_box(n=8, k_max=8)
    rng = np.random.default_rng(5)
    js = js.replace(
        v=jax.numpy.asarray(rng.normal(size=js.v.shape), np.float32),
        angmom=jax.numpy.asarray(rng.normal(size=js.angmom.shape) * 0.1,
                                 np.float32),
        step=js.step + 7)
    return jsim, js, to_torch(Shapes, jsim.shapes), to_torch(State, js)


def test_dump_files_match_reference_bytes(tmp_path):
    """The port's dump of a state is the JAX package's dump of the same
    state, byte for byte (two frames, default and custom columns, a
    per-atom extra column); each package reads the other's."""
    from spherharm_tpu.io import dump as jdump
    from spherharm_tpu_torch.io import dump

    jsim, js, tshapes, ts = _jax_and_port_states()
    extra = np.arange(ts.cap, dtype=np.float32) * 0.5
    cols = ("id", "type", "x", "z", "radius", "scale", "c_k")
    for pkg, st, sh, ex in (("jax", js, jsim.shapes, extra),
                            ("port", ts, tshapes, torch.as_tensor(extra))):
        mod = jdump if pkg == "jax" else dump
        mod.write_dump(tmp_path / f"{pkg}.dump", st, sh,
                       periodic=(True, False, False))
        mod.write_dump(tmp_path / f"{pkg}.dump", st, sh, columns=cols,
                       append=True, extra={"c_k": ex})
    raw = (tmp_path / "port.dump").read_bytes()
    assert raw == (tmp_path / "jax.dump").read_bytes()
    assert raw.startswith(b"ITEM: TIMESTEP\n7\nITEM: NUMBER OF ATOMS\n8\n")
    for reader in (dump.read_dump, jdump.read_dump):
        for pkg in ("jax", "port"):
            a, b = reader(tmp_path / f"{pkg}.dump")
            assert a["columns"] == list(dump.DEFAULT_COLUMNS)
            assert b["columns"] == list(cols) and b["step"] == 7
            np.testing.assert_array_equal(a["data"]["id"], np.arange(1, 9))
            np.testing.assert_allclose(a["data"]["vx"], np32(ts.v)[:, 0],
                                       rtol=1e-7)
            np.testing.assert_allclose(b["data"]["c_k"], extra[:8])


def test_native_formatter_matches_python(tmp_path):
    """The port's native C++ formatter writes the Python formatter's bytes
    (tests/test_native.py's parity, on the two-body state and on rows at
    the edges of %.8g), and ``write_dump`` says which one wrote."""
    from spherharm_tpu_torch import native
    from spherharm_tpu_torch.io import dump

    if native.get_lib() is None:
        pytest.skip("g++ unavailable")
    rows = np.asarray([[1.0, 2.0, 0.5], [2.0, 1.0, -0.25]])
    assert native.format_dump_rows(rows, [1, 1, 0], "HDR\n") == \
        b"HDR\n1 2 0.5\n2 1 -0.25\n"
    np.testing.assert_allclose(
        native.parse_table("1 2.5 -3e4\n7 0.125 9\n", 2, 3),
        [[1, 2.5, -3e4], [7, 0.125, 9]])
    rng = np.random.default_rng(0)
    mat = np.concatenate([np.arange(1, 7)[:, None], rng.integers(1, 3, (6, 1)),
                          [[1e-30], [-123456789.0], [0.1], [-0.0], [3e38],
                           [1.0 / 3.0]]], axis=1)
    cols = ("id", "type", "x")
    hdr = "ITEM: ATOMS id type x\n"
    assert native.format_dump_rows(mat, [1, 1, 0], hdr) == \
        dump._format_rows_python(mat, cols, hdr)
    sim, st, _ = scenarios.two_body_collision(device="cpu")
    assert dump.write_dump(tmp_path / "two.dump", st, sim.shapes) == "native"
    c = dump._column_data(st, sim.shapes, dump.DEFAULT_COLUMNS)
    m = np.stack([c[k] for k in dump.DEFAULT_COLUMNS], axis=1)
    assert (tmp_path / "two.dump").read_bytes().endswith(
        dump._format_rows_python(m, dump.DEFAULT_COLUMNS, ""))


def test_coeff_and_data_files_match_reference_bytes(tmp_path):
    """Coefficient and data files the port writes are the JAX package's
    bytes for the same inputs; each package reads the other's, and the
    port's data file round-trips the state."""
    from spherharm_tpu.io import data as jdata
    from spherharm_tpu_torch.io import data

    lmax = 6
    c = shapes_library.blob_coeffs(lmax, seed=4)
    jdata.write_coeff_file(tmp_path / "j.sh", c, lmax)
    data.write_coeff_file(tmp_path / "t.sh", torch.as_tensor(c), lmax)
    assert (tmp_path / "t.sh").read_bytes() == (tmp_path / "j.sh").read_bytes()
    for path in ("j.sh", "t.sh"):
        c2, lmax2 = data.read_coeff_file(tmp_path / path)
        assert lmax2 == lmax
        np.testing.assert_allclose(c2, c, rtol=1e-15)

    _, js, _, ts = _jax_and_port_states()
    jdata.write_data_file(tmp_path / "j.data", js)
    data.write_data_file(tmp_path / "t.data", ts)
    assert (tmp_path / "t.data").read_bytes() == \
        (tmp_path / "j.data").read_bytes()
    d, dj = (data.read_data_file(tmp_path / "j.data"),
             jdata.read_data_file(tmp_path / "t.data"))
    assert sorted(d) == sorted(dj)
    for k in d:
        np.testing.assert_array_equal(d[k], dj[k])
    assert d["x"].shape == (8, 3)
    for f in ("x", "v", "q", "angmom", "scale"):
        np.testing.assert_allclose(d[f], np32(getattr(ts, f)), rtol=1e-6)

