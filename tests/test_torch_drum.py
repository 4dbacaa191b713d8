"""The slice as a whole: the torch rotating drum vs the JAX drum.

Both packages build the drum (conservative law, prefilter on with pair cap
5n and stage-2 cap 3n, static cadence R = 20; the JAX side runs its three
Pallas kernels in interpret mode with exact SH evaluation). The builders'
own loose packing has no contact in the first cadence blocks, so both
packages then start from the SAME contact-rich numpy state: the packing
compressed across the drum axis, lowered onto the cylinder, stretched
along the axis onto both end caps, with random angular momentum. After 40
steps (two cadence blocks) thermo and positions must agree.

Lmax 4 keeps the file near a minute on a CPU (the reference's interpret-
mode Pallas compiles dominate; Lmax 8 takes ~110 s alone). The kernels'
Lmax-8 parity is tests/test_torch_contact_kernels.py's.

Tolerances (f32 throughout, different summation orders in the two
packages): energies rtol 2e-3, no tighter than the conservative f32 noise
floor (BASELINE.md config-1 table: 1.5e-3 oblique); positions 1e-3
absolute, 0.2% of a particle radius. Measured agreement is far inside
both (energies ~3e-6 relative, positions ~2e-7).
"""

import jax
import numpy as np
import pytest
import torch

from spherharm_tpu.models import scenarios as jscen
from spherharm_tpu_torch.core import state as tstate
from spherharm_tpu_torch.models import scenarios as tscen

from torch_port_util import contact_rich_state, np32, to_torch

N, LMAX, STEPS = 128, 4, 40
DRUM = dict(n=N, lmax=LMAX, k_max=24, pair_capacity=5 * N,
            stage2_capacity=3 * N, rebuild_every=20, conservative=True)


@pytest.fixture(scope="module")
def drums():
    jsim, jst0, _ = jscen.rotating_drum(use_pallas=True, exact_eval=True,
                                        **DRUM)
    tsim, tst0, _ = tscen.rotating_drum(device="cpu", **DRUM)
    return jsim, jst0, tsim, tst0


def test_drum_builders_agree(drums):
    """Same numpy seeds: the two builders make the same shapes, params,
    walls and initial state."""
    jsim, jst0, tsim, tst0 = drums
    for cls, a, b in ((tstate.Shapes, jsim.shapes, tsim.shapes),
                      (tstate.SimParams, jsim.params, tsim.params)):
        conv = to_torch(cls, a)
        for f in cls.__dataclass_fields__:
            x, y = getattr(conv, f), getattr(b, f)
            if isinstance(x, torch.Tensor):
                np.testing.assert_array_equal(np32(y), np32(x), err_msg=f)
    js = to_torch(tstate.State, jst0)
    for f in ("q", "scale", "shtype", "tag", "active", "box_lo", "box_hi"):
        np.testing.assert_array_equal(np32(getattr(tst0, f)),
                                      np32(getattr(js, f)), err_msg=f)
    np.testing.assert_allclose(np32(tst0.x), np32(js.x), rtol=0, atol=1e-6)
    assert tsim.wall_capacity == jsim.wall_capacity
    assert tsim.grid.dims == jsim.grid.dims
    assert float(tsim.walls[0].radius) == float(jsim.walls[0].radius)


def test_skin_triggered_step_rebuilds_when_stale():
    """Without a cadence, ``run`` steps in check mode: a rebuild runs only
    when some particle outmoved its prefilter motion budget."""
    sim, st, ng = tscen.rotating_drum(device="cpu",
                                      **dict(DRUM, rebuild_every=0))
    x_build = ng.x_build.clone()
    st, ng = sim.run(st, ng, 3)
    assert torch.equal(ng.x_build, x_build)  # slow start: no rebuild
    far = st.replace(x=st.x + 0.5 * torch.as_tensor(sim.params.skin))
    st2, ng2 = sim.step(far, ng)
    assert not torch.equal(ng2.x_build, x_build)
    np.testing.assert_array_equal(np32(ng2.x_build), np32(st2.x))
    assert int(ng2.overflow) == 0


def test_drum_matches_reference_from_contact_rich_state(drums):
    jsim, jst0, tsim, _ = drums
    R = float(jsim.walls[0].radius)
    L = float(jsim.walls[2].point[1] - jsim.walls[1].point[1])
    shtype = np.asarray(jst0.shtype)
    scale = np.asarray(jst0.scale, np.float64)
    radius = np.asarray(jsim.shapes.rchar, np.float64)[shtype] * scale
    x, angmom = contact_rich_state(np.asarray(jst0.x), radius, R, L)
    kw = dict(q=np.asarray(jst0.q), angmom=angmom, scale=scale, shtype=shtype)
    box = (np.asarray(jst0.box_lo), np.asarray(jst0.box_hi))

    js, jn = jsim.init_neighbors(jscen.make_state(x, *box, **kw))
    js, jn = jsim.run(js, jn, STEPS)
    jth = {k: float(v) for k, v in jsim.thermo(js, jn).items()
           if np.ndim(v) == 0}
    jax.block_until_ready(js.x)

    ts, tn = tsim.init_neighbors(tscen.make_state(x, *box, device="cpu",
                                                  **kw))
    ts, tn = tsim.run(ts, tn, STEPS)
    tth = {k: float(v) for k, v in tsim.thermo(ts, tn).items()
           if v.ndim == 0}

    for th, ng in ((jth, jn), (tth, tn)):
        assert int(ng.overflow) == 0 and int(ng.skin_violations) == 0
        # Not vacuous: pair contacts, wall contacts and spin all present.
        assert th["pe_pair"] > 0 and th["pe_wall"] > 0 and th["erot"] > 0
    assert int(tth["step"]) == int(jth["step"]) == STEPS
    for k in ("ke", "erot", "pe_pair", "pe_wall", "pe_grav", "etot"):
        np.testing.assert_allclose(tth[k], jth[k], rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(np32(ts.x), np.asarray(js.x), rtol=0,
                               atol=1e-3)
