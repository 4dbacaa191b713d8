"""Triclinic (tilted) periodic cells and the config-5 triaxial shear cell
of the torch port vs the JAX reference: minimum image, wrap, the seam
contact, the shear with its tilt flip, the tilt sentinel, the Berendsen
servo, and ``triaxial_cell`` run end to end.

The sheared cells run at n = 128 with fill fraction 0.09, so the
CellGrid of ``triaxial_cell`` has 3 cells an axis at its ``deform_min``
box (at n = 64 it has one, and the 27-stencil then finds each candidate
once per stencil cell in both packages: the overflow channel fires),
compressed by ``triaxial_start`` into contact. The JAX ``Simulation`` is rebuilt
from the shapes, params and grid ``triaxial_cell`` made, with
``exact_eval=True`` (``triaxial_cell`` takes the interp-table radius on
the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spherharm_tpu.core.simulation import Simulation as JSimulation
from spherharm_tpu.core.state import SimParams as JParams
from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu.models import shapes_library as jshapes
from spherharm_tpu.ops import contact as jcontact
from spherharm_tpu.ops import integrate as jint
from spherharm_tpu.ops import neighbor as jnb
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.models import scenarios as tscen
from spherharm_tpu_torch.models import shapes_library as tshapes
from spherharm_tpu_torch.ops import contact as tcontact
from spherharm_tpu_torch.ops import integrate as tint
from spherharm_tpu_torch.ops import neighbor as tnb

from torch_port_util import np32, triaxial_start

LO = np.zeros(3, np.float32)
HI = np.asarray([8.0, 10.0, 12.0], np.float32)
TILT = np.asarray([2.0, -1.5, 3.0], np.float32)  # (xy, xz, yz), all < L/2
H = np.array([[8.0, 2.0, -1.5], [0.0, 10.0, 3.0], [0.0, 0.0, 12.0]])
PERIODIC = (True, True, True)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_tilted_minimum_image_matches_reference():
    """min-image of d + n1 a + n2 b + n3 c recovers d (the reference's
    test) and equals the reference's, at 1e-5."""
    rng = np.random.default_rng(0)
    d = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    n = rng.integers(-1, 2, (64, 3)).astype(np.float32)
    shifted = (d + n @ H.T).astype(np.float32)
    ref = np.asarray(jcontact.minimum_image(
        jnp.asarray(shifted), LO, HI, PERIODIC, jnp.asarray(TILT)))
    out = np32(tcontact.minimum_image(_t(shifted), _t(LO), _t(HI), PERIODIC,
                                      _t(TILT)))
    np.testing.assert_allclose(out, d, atol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_tilted_wrap_matches_reference():
    """Wrap subtracts whole lattice vectors: images equal the reference's
    exactly, positions to 1e-6, the fractional coordinates in [0, 1) and
    x + image @ H^T the original position."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-15.0, 25.0, (64, 3)).astype(np.float32)
    img0 = np.zeros((64, 3), np.int64)
    jx, jimg = jnb.wrap_positions(jnp.asarray(x), jnp.asarray(img0, jnp.int32),
                                  LO, HI, PERIODIC, jnp.asarray(TILT))
    tx, timg = tnb.wrap_positions(_t(x), _t(img0), _t(LO), _t(HI), PERIODIC,
                                  _t(TILT))
    np.testing.assert_array_equal(np32(timg), np.asarray(jimg))
    np.testing.assert_allclose(np32(tx), np.asarray(jx), rtol=0, atol=1e-6)
    frac = np.linalg.solve(H, (np32(tx) - LO).T).T
    assert frac.min() > -1e-5 and frac.max() < 1 + 1e-5
    np.testing.assert_allclose(np32(tx) + np32(timg) @ H.T, x, atol=1e-4)


def test_seam_contact_equals_interior_contact():
    """A contacting pair straddling the tilted y-seam gives the forces of
    the same pair in the interior (the image shifts by (xy, Ly, 0)), in
    the port's cell list + pair list, and both match the reference's."""
    lmax = 2
    coeffs = [jshapes.ellipsoid_coeffs(0.55, 0.45, 0.4, lmax)]
    box, tilt = 10.0, [2.5, 0.0, 0.0]
    pkw = dict(dt=1e-4, kn=1e4, gamma_n=5.0, mu=0.3, cutoff=1.3, skin=0.3)
    d_rel = np.array([0.55, 0.55, 0.15])
    qb = np.array([0.9, 0.1, 0.3, 0.2])
    q = [[1.0, 0.0, 0.0, 0.0], list(qb / np.linalg.norm(qb))]
    v = [[0.1, -0.05, 0.0], [-0.1, 0.0, 0.05]]
    simkw = dict(periodic=PERIODIC, neighbor_mode="cell", k_max=4, cell_cap=6,
                 pair_capacity=8, triclinic=True, conservative=False)
    jsim = JSimulation(
        jshapes.build_shapes(coeffs, lmax, contact_quad=(8, 16)),
        JParams.create(**pkw), grid=jnb.CellGrid([0, 0, 0], [box] * 3, 2.2),
        exact_eval=True, **simkw)
    tsim = Simulation(
        tshapes.build_shapes(coeffs, lmax, contact_quad=(8, 16), device="cpu"),
        tstate.SimParams.create(device="cpu", **pkw),
        grid=tnb.CellGrid([0, 0, 0], [box] * 3, 2.2), device="cpu", **simkw)

    def forces(xa, xb):
        kw = dict(q=q, v=v, tilt=tilt)
        js, jn = jsim.init_neighbors(jscen.make_state([xa, xb], [0] * 3,
                                                      [box] * 3, **kw))
        ts, tn = tsim.init_neighbors(tscen.make_state(
            [xa, xb], [0] * 3, [box] * 3, device="cpu", **kw))
        ref = np.concatenate([np.asarray(js.f), np.asarray(js.tau)])
        out = np.concatenate([np32(ts.f), np32(ts.tau)])
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=2e-3 * np.abs(ref).max())
        return out

    xa = np.array([5.0, 5.0, 5.0])
    f_in = forces(xa, xa + d_rel)
    assert np.abs(f_in).max() > 0, "pair should be in contact"
    xa2 = np.array([5.0, box - 0.2, 5.0])
    xb2 = xa2 + d_rel - np.array([tilt[0], box, 0.0])
    assert 0 <= xb2[1] < box  # genuinely wrapped
    np.testing.assert_allclose(forces(xa2, xb2), f_in, rtol=1e-4, atol=1e-5)


def _box_state(rng, n, tilt, box=(6.0, 7.0, 8.0)):
    x = rng.uniform(0.0, 1.0, (n, 3)) * np.asarray(box)
    v = rng.normal(size=(n, 3))
    kw = dict(v=v, tilt=tilt, shtype=rng.integers(0, 2, n))
    return (jscen.make_state(x, [0.0] * 3, list(box), **kw),
            tscen.make_state(x, [0.0] * 3, list(box), device="cpu", **kw))


@pytest.mark.parametrize("periodic", [(True, True, True), (True, False, True),
                                      (False, True, True)],
                         ids=["xyz", "y-wall", "x-wall"])
def test_apply_deformation_flips_as_reference(periodic):
    """One large shear step that carries all three tilts past L/2: the
    flips happen exactly where the reference's happen (yz by the b vector
    on a periodic y, dragging xz by xy; xy and xz by the a vector on a
    periodic x), flip counts equal, tilt, box, x and x_build at f32
    precision."""
    rng = np.random.default_rng(5)
    box = np.array([6.0, 7.0, 8.0])
    tilt = [0.49 * box[0], -0.48 * box[0], 0.49 * box[1]]
    js, ts = _box_state(rng, 32, tilt, box)
    pkw = dict(dt=1e-2, kn=1e4, deform_rate=(-0.3, 0.2, 0.1),
               shear_rate=(5.0, -4.0, 6.0))
    jp = JParams.create(**pkw)
    tp = tstate.SimParams.create(device="cpu", **pkw)
    xb = rng.uniform(0.0, 6.0, (32, 3)).astype(np.float32)
    j2, jxb, jflip = jint.apply_deformation(js, jnp.asarray(xb), jp, periodic)
    t2, txb, tflip = tint.apply_deformation(ts, _t(xb), tp, periodic)
    np.testing.assert_array_equal(np32(tflip), np.asarray(jflip))
    expect = [periodic[0] * 1.0, -periodic[0] * 1.0, periodic[1] * 1.0]
    np.testing.assert_array_equal(np32(tflip), expect)
    for a, b in ((t2.tilt, j2.tilt), (t2.box_lo, j2.box_lo),
                 (t2.box_hi, j2.box_hi), (t2.x, j2.x), (txb, jxb)):
        np.testing.assert_allclose(np32(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_tilt_sentinel_on_non_periodic_axis():
    """A sheared cell whose x axis is not periodic cannot flip xy: once
    |xy| passes Lx/2 the step flags overflow 1 << 21, as the reference
    does; while it is inside, nothing is flagged."""
    shapes = [jshapes.sphere_coeffs(0.5, 0)]
    pkw = dict(dt=1e-2, kn=1e4, cutoff=1.2, skin=0.1,
               shear_rate=(2.0, 0.0, 0.0))
    simkw = dict(periodic=(False, True, True), neighbor_mode="allpairs",
                 k_max=1, triclinic=True, conservative=False)
    x = [[1.0, 1.0, 1.0], [3.0, 3.0, 3.0]]
    jsim = JSimulation(jshapes.build_shapes(shapes, 0), JParams.create(**pkw),
                       exact_eval=True, **simkw)
    tsim = Simulation(tshapes.build_shapes(shapes, 0, device="cpu"),
                      tstate.SimParams.create(device="cpu", **pkw),
                      device="cpu", **simkw)
    kw = dict(tilt=[1.87, 0.0, 0.0])  # + 0.08 a step; flagged past 2.0
    js, jn = jsim.init_neighbors(jscen.make_state(x, [0] * 3, [4] * 3, **kw))
    ts, tn = tsim.init_neighbors(tscen.make_state(x, [0] * 3, [4] * 3,
                                                  device="cpu", **kw))
    for step, flagged in ((1, False), (2, True), (3, True)):
        js, jn = jsim.run(js, jn, 1)
        ts, tn = tsim.run(ts, tn, 1)
        np.testing.assert_allclose(np32(ts.tilt), np.asarray(js.tilt),
                                   rtol=1e-6)
        assert int(tn.overflow) == int(jn.overflow), step
        assert (int(tn.overflow) == 1 << 21) == flagged, (step, np32(ts.tilt))


def test_berendsen_box_control_matches_reference():
    """The stress servo: per-axis dilation from the virial and the
    kinetic tensor, clipped to 0.99-1.01 (x clips here), box, positions,
    x_build and tilt scaled alike."""
    rng = np.random.default_rng(2)
    js, ts = _box_state(rng, 40, [0.8, -0.5, 0.3])
    shapes_np = [jshapes.sphere_coeffs(0.4, 0), jshapes.sphere_coeffs(0.5, 0)]
    jshp = jshapes.build_shapes(shapes_np, 0)
    tshp = tshapes.build_shapes(shapes_np, 0, device="cpu")
    pkw = dict(dt=1e-3, kn=1e4, press_target=(5.0, 1.0, -2.0),
               press_tau=2e-3)
    virial = (rng.normal(size=(3, 3)) * [[300.0], [3.0], [3.0]]).astype(
        np.float32)
    xb = rng.uniform(0.0, 6.0, (40, 3)).astype(np.float32)
    j2, jxb = jint.berendsen_box_control(js, jnp.asarray(xb),
                                         JParams.create(**pkw),
                                         jnp.asarray(virial), jshp)
    t2, txb = tint.berendsen_box_control(
        ts, _t(xb), tstate.SimParams.create(device="cpu", **pkw), _t(virial),
        tshp)
    mu = np32(t2.box_hi - t2.box_lo) / np.array([6.0, 7.0, 8.0])
    assert mu[0] == pytest.approx(0.99, abs=1e-6) and 0.99 < mu[1] < 1.01
    for a, b in ((t2.x, j2.x), (txb, jxb), (t2.box_lo, j2.box_lo),
                 (t2.box_hi, j2.box_hi), (t2.tilt, j2.tilt)):
        np.testing.assert_allclose(np32(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    # press_tau = 0: mu = 1, nothing moves beyond the rounding of the
    # shift about the centre.
    t3, txb3 = tint.berendsen_box_control(
        ts, _t(xb), tstate.SimParams.create(dt=1e-3, kn=1e4, device="cpu"),
        _t(virial), tshp)
    np.testing.assert_allclose(np32(t3.x), np32(ts.x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np32(txb3), xb, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np32(t3.tilt), np32(ts.tilt))


N_TRI, FILL, TRI_STEPS = 128, 0.09, 20


def triaxial_pair(flip=True, **kw):
    """The port's ``triaxial_cell(n=128, fill_fraction=0.09, **kw)`` and
    the reference's Simulation rebuilt from its ``triaxial_cell`` with
    ``exact_eval=True``, both set up from the same ``triaxial_start``
    state (overlap 0.02 of a diameter). With ``flip`` and a nonzero
    shear, the start's xy tilt sits 5e-5 Lx under Lx/2, so an xy shear
    rate of 0.03 or more flips it within 20 steps. Returns (jsim, js,
    jn, tsim, ts, tn)."""
    kw = dict(n=N_TRI, fill_fraction=FILL, **kw)
    j0, jst0, _ = jscen.triaxial_cell(**kw)
    tsim, tst0, _ = tscen.triaxial_cell(device="cpu", **kw)
    assert tsim.grid.dims == j0.grid.dims == (3, 3, 3)
    assert tsim.triclinic == j0.triclinic
    assert tsim.press_control == j0.press_control
    assert tsim.pair_capacity == j0.pair_capacity == 12 * N_TRI
    np.testing.assert_array_equal(np32(tst0.x), np.asarray(jst0.x))
    for f in ("pair_tab", "shear_rate", "deform_rate", "press_tau", "skin"):
        np.testing.assert_array_equal(np32(getattr(tsim.params, f)),
                                      np.asarray(getattr(j0.params, f)))
    jsim = JSimulation(
        j0.shapes, j0.params, periodic=j0.periodic, neighbor_mode="cell",
        grid=j0.grid, k_max=j0.k_max, cell_cap=j0.cell_cap,
        pair_capacity=j0.pair_capacity, press_control=j0.press_control,
        triclinic=j0.triclinic, conservative=j0.conservative, exact_eval=True)
    x, lo, hi, _ = triaxial_start(np.asarray(jst0.x), np.asarray(jst0.box_lo),
                                  np.asarray(jst0.box_hi), 0.5, overlap=0.02)
    tilt = [0.5 * (hi[0] - lo[0]) * (1 - 1e-4) if flip and tsim.triclinic
            else 0.0, 0.0, 0.0]
    st = dict(v=np.asarray(jst0.v), q=np.asarray(jst0.q),
              shtype=np.asarray(jst0.shtype), tilt=tilt)
    js, jn = jsim.init_neighbors(jscen.make_state(x, lo, hi, **st))
    ts, tn = tsim.init_neighbors(tscen.make_state(x, lo, hi, device="cpu",
                                                  **st))
    return jsim, js, jn, tsim, ts, tn


def _flips(tilt0, tilt1, L):
    return np.round((np.asarray(tilt0) - np.asarray(tilt1))
                    / np.asarray([L[0], L[0], L[1]])).astype(int)


@pytest.mark.parametrize("shear,press_tau", [
    ((0.05, 0.0, 0.0), 1.0),
    ((0.0, 0.04, -0.03), 0.0),
    ((0.03, -0.02, 0.05), 1.0),
], ids=["xy-servo-flip", "xz-yz", "all-servo"])
def test_sheared_triaxial_matches_reference(shear, press_tau):
    """The sheared triaxial cell (config 5: Lmax 4, 2 blob types, 72 cap
    nodes, geometric law, pair capacity 12n, skin-triggered rebuild, the
    published -0.05 strain rate on each axis), 20 steps from a contact-
    rich start, step by step in both packages: tilt and box at f32
    precision, image counters and flips exactly (the xy case flips once),
    forces within 2e-3 |F|max, thermo press and stress within 1e-3 of
    the stress scale."""
    jsim, js, jn, tsim, ts, tn = triaxial_pair(shear_rate=shear,
                                               press_tau=press_tau)
    assert tsim.triclinic and tsim.shapes.cap_x.shape[0] == 72
    flips_j = flips_t = 0
    for _ in range(TRI_STEPS):
        jt0, tt0 = np.asarray(js.tilt), np32(ts.tilt)
        js, jn = jsim.run(js, jn, 1)
        ts, tn = tsim.run(ts, tn, 1)
        L = np32(ts.box_hi - ts.box_lo)
        flips_j += np.abs(_flips(jt0, js.tilt, L)).sum()
        flips_t += np.abs(_flips(tt0, ts.tilt, L)).sum()
        np.testing.assert_allclose(np32(ts.tilt), np.asarray(js.tilt),
                                   rtol=1e-5, atol=1e-6 * L.max())
        np.testing.assert_allclose(np32(ts.box_hi), np.asarray(js.box_hi),
                                   rtol=1e-6)
    jax.block_until_ready(js.x)
    assert flips_t == flips_j == (1 if shear[0] else 0)
    assert int(tn.overflow) == int(jn.overflow) == 0
    np.testing.assert_array_equal(np32(ts.image), np.asarray(js.image))
    np.testing.assert_allclose(np32(ts.box_lo), np.asarray(js.box_lo),
                               rtol=1e-6, atol=1e-6)
    ref = np.asarray(js.f)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(np32(ts.f), ref, rtol=0,
                               atol=2e-3 * np.abs(ref).max())
    jth, tth = jsim.thermo(js, jn), tsim.thermo(ts, tn)
    assert float(tth["pe_pair"]) > 0
    s_ref = np.asarray(jth["stress"])
    np.testing.assert_allclose(np32(tth["stress"]), s_ref, rtol=0,
                               atol=1e-3 * np.abs(s_ref).max())
    np.testing.assert_allclose(float(tth["press"]), float(jth["press"]),
                               rtol=1e-3)
