"""The port's CUDA kernels vs their plain PyTorch twins, and its CUDA
graph runs vs its eager runs, on the card.

Every test here is ``cuda``-marked and skips without an NVIDIA GPU; the
plain twins themselves are held against the JAX reference by the other
tests/test_torch_*.py files. This file imports no JAX, so it also runs
where JAX is absent:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets JAX up for the reference tests.)
"""

import numpy as np
import pytest
import torch

from spherharm_tpu_torch.core.state import SimParams
from spherharm_tpu_torch.models import scenarios, shapes_library
from spherharm_tpu_torch.ops import contact_kernels as ck
from spherharm_tpu_torch.ops import walls as walls_mod
from spherharm_tpu_torch.ops import walls_kernels as wk
from spherharm_tpu_torch.ops.rotation import omega_from_angmom

from torch_port_util import (blob_coeffs, contact_rich_state,  # noqa: F401
                             cuda_device, f32_ulps_from, np32, pressed_box_state,
                             triaxial_state)

pytestmark = pytest.mark.cuda


def _params(device):
    return SimParams.create(dt=1e-4, kn=1e5, gamma_n=20.0, mu=0.4,
                            k_roll=2e4, gamma_roll=10.0, mu_roll=0.2,
                            cutoff=1.4, skin=0.2, device=device)


def _pairs(lmax, device, seed=11, n=14, contact_quad=(8, 16), params=None):
    """All ordered pairs of n particles in a small box (deep, grazing and
    separated pairs), mid-contact springs, a few masked rows; ``params``
    (default ``_params``) gives the materials."""
    rng = np.random.default_rng(seed)
    shapes = shapes_library.build_shapes(blob_coeffs(lmax, 3, seed), lmax,
                                         contact_quad=contact_quad,
                                         device=device)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    st = scenarios.make_state(
        rng.uniform(0.7, 2.5, (n, 3)), [0, 0, 0], [4, 4, 4], q=q,
        v=rng.normal(size=(n, 3)) * 0.2,
        angmom=rng.normal(size=(n, 3)) * 0.02,
        scale=rng.uniform(0.85, 1.15, n), shtype=rng.integers(0, 3, n),
        device=device)
    pi, pj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sel = pi.ravel() != pj.ravel()
    t = lambda a: torch.tensor(a, device=device)
    pi, pj = t(pi.ravel()[sel]), t(pj.ravel()[sel])
    mask = t(rng.uniform(size=pi.shape[0]) > 0.05)
    hist = t(rng.normal(size=(pi.shape[0], 6)).astype(np.float32) * 1e-4)
    packed, tbl, cap, par = ck.pack_pairs(st, shapes, params or _params(device),
                                          pi, pj, mask, hist, st.x[pj] - st.x[pi])
    return packed, tbl, cap, par, shapes


# (lmax, law, cap grid): K1 at the reference's conservative bound 1e-4
# |F|max, K2 at its geometric bound 2e-3 |F|max on the 128-node 8x16 grid
# and on the deposition's 288-node 12x24 grid, and at the settling box's
# Lmax 2. Both laws at each degree compiled into csrc/ (0 on the two-body
# collision's 12x24 grid, whose 288 nodes leave K1's last 2-node block
# half empty and fill the geometric f32 kernel's 3-node blocks; 2, 4, 8)
# and at lmax 6, which takes the run-time-degree instantiation. The 11x25
# grid's 275 nodes take 3-node blocks with the last partly empty, as the
# triaxial cell's 6x12 grid's 72 nodes do at Lmax 4.
LAW_CASES = [
    pytest.param(0, True, (12, 24), id="0-12x24"),
    pytest.param(2, True, (8, 16), id="2"),
    pytest.param(4, True, (8, 16), id="4"),
    pytest.param(6, True, (8, 16), id="6-run-time-degree"),
    pytest.param(8, True, (8, 16), id="8"),
    pytest.param(8, False, (8, 16), id="8-geometric-8x16"),
    pytest.param(8, False, (12, 24), id="8-geometric-12x24"),
    pytest.param(2, False, (8, 16), id="2-geometric-8x16"),
    pytest.param(0, False, (12, 24), id="0-geometric-12x24"),
    pytest.param(4, False, (8, 16), id="4-geometric-8x16"),
    pytest.param(6, False, (8, 16), id="6-geometric-run-time-degree"),
    pytest.param(8, False, (11, 25), id="8-geometric-11x25"),
    pytest.param(4, False, (6, 12), id="4-geometric-6x12-triaxial"),
]


@pytest.mark.parametrize("lmax,conservative,quad", LAW_CASES)
def test_pair_contact_kernel_matches_plain(lmax, conservative, quad,
                                           cuda_device):
    packed, tbl, cap, par, _ = _pairs(lmax, cuda_device, contact_quad=quad)
    law = "conservative" if conservative else "geometric"
    n0 = dict(ck.pair_contact.launches)
    out = ck.pair_contact(packed, tbl, cap, par, lmax, conservative)
    torch.cuda.synchronize()
    assert ck.pair_contact.launches[law] == n0[law] + 1
    out, ref = np32(out), np32(ck.pair_contact_plain(packed, tbl, cap, par,
                                                     lmax, conservative))
    inc = ref[:, 16] > 0.5
    assert inc.sum() > 3
    np.testing.assert_array_equal(out[:, 16] > 0.5, inc)
    fmag = np.abs(ref[:, 0:3]).max()
    np.testing.assert_allclose(out[:, 0:9], ref[:, 0:9], rtol=0,
                               atol=(1e-4 if conservative else 2e-3) * fmag)
    np.testing.assert_allclose(out[:, 9:16], ref[:, 9:16], rtol=0,
                               atol=1e-6 + 1e-4 * np.abs(ref[:, 9:16]).max())
    np.testing.assert_array_equal(out[:, 17:], 0.0)


@pytest.mark.parametrize("conservative", [True, False],
                         ids=["conservative", "geometric"])
def test_pair_contact_kernel_two_materials(conservative, cuda_device):
    """K1 and K2 with a per-type-pair table (``with_pair_coeffs``: one
    explicit (0, 1) entry, the rest from the scalars and geometric mixing),
    rows of different materials in one launch, at the laws' tolerances."""
    lmax = 4
    params = _params(cuda_device).with_pair_coeffs(
        3, {(0, 1): (3e5, 1e5, 30.0, 10.0, 0.2, 1e4, 5.0, 0.1),
            (2, 2): (5e4, 2e4, 5.0, 2.0, 0.7, 0.0, 0.0, 0.0)})
    packed, tbl, cap, par, _ = _pairs(lmax, cuda_device, params=params)
    assert packed[:, ck.SLOTS["mat"][0]].unique().numel() >= 3
    out = np32(ck.pair_contact(packed, tbl, cap, par, lmax, conservative))
    ref = np32(ck.pair_contact_plain(packed, tbl, cap, par, lmax, conservative))
    inc = ref[:, 16] > 0.5
    assert inc.sum() > 3
    np.testing.assert_array_equal(out[:, 16] > 0.5, inc)
    fmag = np.abs(ref[:, 0:3]).max()
    np.testing.assert_allclose(out[:, 0:9], ref[:, 0:9], rtol=0,
                               atol=(1e-4 if conservative else 2e-3) * fmag)
    np.testing.assert_allclose(out[:, 9:16], ref[:, 9:16], rtol=0,
                               atol=1e-6 + 1e-4 * np.abs(ref[:, 9:16]).max())


# K4 at each degree compiled into csrc/stage1_probe.cu (0, 2, 4, 8) and
# at lmax 6, which takes the run-time-degree instantiation.
@pytest.mark.parametrize("lmax", [
    pytest.param(0, id="0"), pytest.param(2, id="2"), pytest.param(4, id="4"),
    pytest.param(6, id="6-run-time-degree"), pytest.param(8, id="8")])
def test_stage1_kernel_matches_plain(lmax, cuda_device):
    """Tolerance 1e-5 absolute on depths of order 0.1-1."""
    packed, tbl, _, _, shapes = _pairs(lmax, cuda_device)
    packed[:, ck.SLOTS["tail"][0]] = 0.0
    cap1 = torch.stack([shapes.cap1_x, shapes.cap1_glw, shapes.cap1_cpsi,
                        shapes.cap1_spsi])
    tbl_ab = tbl[:, :(lmax + 1) ** 2].contiguous()
    n0 = ck.stage1_depth.launches["stage1_depth"]
    out = ck.stage1_depth(packed, tbl_ab, cap1, lmax, l1=lmax, bf16=False)
    torch.cuda.synchronize()
    assert ck.stage1_depth.launches["stage1_depth"] == n0 + 1
    ref = np32(ck.stage1_depth_plain(packed, tbl_ab, cap1, lmax, l1=lmax,
                                     bf16=False))
    assert (ref == -1e9).any() and (ref > 0).sum() > 3
    np.testing.assert_allclose(np32(out), ref, rtol=0, atol=1e-5)


# (lmax, law, cap grid) of K3: conservative at the compiled Lmax 8 and at
# lmax 6 on the 12x24 grid (the run-time-degree instantiation); geometric
# at Lmax 8 on both grids (the deposition's 12x24 leaves a half-empty node
# block) and at lmax 6.
BF16_CASES = [
    pytest.param(8, True, (8, 16), id="conservative"),
    pytest.param(8, False, (8, 16), id="geometric"),
    pytest.param(6, True, (12, 24), id="conservative-6-run-time-degree-12x24"),
    pytest.param(8, False, (12, 24), id="geometric-12x24"),
    pytest.param(6, False, (8, 16), id="geometric-6-run-time-degree"),
]


@pytest.mark.parametrize("lmax,conservative,quad", BF16_CASES)
def test_pair_contact_bf16_kernel_matches_plain(lmax, conservative, quad,
                                                cuda_device):
    """K3 (bf16 Horner chains) vs its bf16 twin: the chains round alike op
    for op, the f32 assembly differs by f32 ulps. Conservative at
    chip_smoke.py's allowance: forces and torques within 1e-4 |F|max, 0.1 %
    of rows beyond it (the ulp-level jump of the law, where an f32-ulp move
    of a node crosses a bf16 rounding boundary), none beyond 2e-2; springs
    and pe within 1e-6 + 1e-4 of their scale. Geometric within the
    reference's geometric bound 2e-3 |F|max."""
    packed, tbl, cap, par, _ = _pairs(lmax, cuda_device, contact_quad=quad)
    variant = ("conservative" if conservative else "geometric") + "_bf16"
    n0 = dict(ck.pair_contact.launches)
    out = ck.pair_contact(packed, tbl, cap, par, lmax, conservative, bf16=True)
    torch.cuda.synchronize()
    assert ck.pair_contact.launches[variant] == n0[variant] + 1
    out, ref = np32(out), np32(ck.pair_contact_plain(packed, tbl, cap, par,
                                                     lmax, conservative, True))
    inc = ref[:, 16] > 0.5
    assert inc.sum() > 3
    np.testing.assert_array_equal(out[:, 16] > 0.5, inc)
    fmag = np.abs(ref[:, 0:3]).max()
    f_tol = 1e-4 if conservative else 2e-3
    err = np.abs(out[:, 0:9] - ref[:, 0:9]).max(1)
    loose = out.shape[0] // 1000 if conservative else 0
    assert (err > f_tol * fmag).sum() <= loose
    assert err.max() <= 2e-2 * fmag
    np.testing.assert_allclose(out[:, 9:16], ref[:, 9:16], rtol=0,
                               atol=1e-6 + f_tol * np.abs(ref[:, 9:16]).max())
    np.testing.assert_array_equal(out[:, 17:], 0.0)


@pytest.mark.parametrize("l1,bf16", [
    pytest.param(2, False, id="2-f32"), pytest.param(2, True, id="2-bf16"),
    pytest.param(4, False, id="4-f32"), pytest.param(4, True, id="4-bf16")])
def test_stage1_l1_kernel_matches_plain(l1, bf16, cuda_device):
    """K5 (l1 = 2 and 4 of Lmax 8, with the tail column) vs its twin, both
    within 1e-5 rsum: kernel and twin round alike op for op, where running
    the chains in f32 would move r by ~2e-3 rsum. (chip_smoke.py lets 0.1%
    of bf16 rows exceed that by up to a bf16 ulp; this batch has fewer
    than 1000 rows.)"""
    lmax = 8
    packed, _, _, _, shapes = _pairs(lmax, cuda_device)
    cap1 = torch.stack([shapes.cap1_x, shapes.cap1_glw, shapes.cap1_cpsi,
                        shapes.cap1_spsi])
    tbl1 = ck.stage1_table(shapes, l1)
    key = "stage1_depth_l1" + ("_bf16" if bf16 else "")
    n0 = ck.stage1_depth.launches[key]
    out = ck.stage1_depth(packed, tbl1, cap1, lmax, l1=l1, bf16=bf16)
    torch.cuda.synchronize()
    assert ck.stage1_depth.launches[key] == n0 + 1
    ref = np32(ck.stage1_depth_plain(packed, tbl1, cap1, lmax, l1=l1,
                                     bf16=bf16))
    rsum = np32(packed[:, ck.SLOTS["rbi"][0]] + packed[:, ck.SLOTS["rbj"][0]])
    assert (ref == -1e9).any() and (ref > 0).sum() > 3
    assert (np.abs(np32(out) - ref) <= 1e-5 * rsum).all()


def _sorted_rows(packed, P):
    """P rows built from the live rows of ``packed``: 512 dead (masked)
    rows, then 512 sphere-separated ones (d stretched to 3 rsum), then 14
    rows whose centres sit 0-3 f32 ulps either side of touching bounding
    spheres (d along x: dist = |d_x| exactly, so kernel and twin sort them
    alike), then the list itself, repeated. Returns (rows, touching slice,
    ulps of each touching row)."""
    col = lambda name: ck.SLOTS[name][0]
    base = np32(packed)
    live = base[base[:, col("mask")] > 0.5]
    dead = live[np.arange(512) % live.shape[0]].copy()
    dead[:, col("mask")] = 0.0
    apart = live[np.arange(512) % live.shape[0]].copy()
    rsum = apart[:, col("rbi")] + apart[:, col("rbj")]
    dv = apart[:, col("d"):col("d") + 3]
    dv *= (3.0 * rsum / np.linalg.norm(dv, axis=1))[:, None]
    ks = np.tile(np.arange(-3, 4), 2)
    touching = live[:ks.size].copy()
    for r, k in zip(touching, ks):
        rsum = np.float32(r[col("rbi")]) + np.float32(r[col("rbj")])
        r[col("d"):col("d") + 3] = (f32_ulps_from(rsum, k), 0.0, 0.0)
    head = np.concatenate([dead, apart, touching])
    rows = np.concatenate([head, base[np.arange(P - head.shape[0]) % base.shape[0]]])
    return rows, slice(1024, 1024 + ks.size), ks


# (rows, l1, bf16): K4 and K5 bf16 on a short list (32-row tiles) and on a
# long one (256-row tiles, the last one ragged).
SORT_CASES = [
    pytest.param(4_101, 8, False, id="K4-short"),
    pytest.param(131_149, 8, False, id="K4-long"),
    pytest.param(4_101, 4, True, id="K5-bf16-short"),
    pytest.param(131_149, 4, True, id="K5-bf16-long"),
]


@pytest.mark.parametrize("P,l1,bf16", SORT_CASES)
def test_stage1_kernel_sorts_rows_by_thread(P, l1, bf16, cuda_device):
    """The rows a thread sorts out: leading tiles all dead, then all
    sphere-separated, rows a few ulps either side of touching spheres,
    then the ordinary list. Dead rows exactly -1e9, every other row at the
    kernel's tolerance (K4 1e-5, K5 1e-5 rsum); the touching rows at or
    beyond rsum exactly rsum - dist, below it probed."""
    lmax = 8
    packed, tbl, _, _, shapes = _pairs(lmax, cuda_device)
    if l1 == lmax:
        packed[:, ck.SLOTS["tail"][0]] = 0.0
        tbl1 = tbl[:, :(lmax + 1) ** 2].contiguous()
    else:
        tbl1 = ck.stage1_table(shapes, l1)
    cap1 = torch.stack([shapes.cap1_x, shapes.cap1_glw, shapes.cap1_cpsi,
                        shapes.cap1_spsi])
    rows_np, at, ks = _sorted_rows(packed, P)
    rows = torch.tensor(rows_np, device=cuda_device)
    out = np32(ck.stage1_depth(rows, tbl1, cap1, lmax, l1=l1, bf16=bf16))
    ref = np32(ck.stage1_depth_plain(rows, tbl1, cap1, lmax, l1=l1, bf16=bf16))
    rsum = rows_np[:, ck.SLOTS["rbi"][0]] + rows_np[:, ck.SLOTS["rbj"][0]]
    dead = rows_np[:, ck.SLOTS["mask"][0]] <= 0.5
    assert dead[:512].all() and (ref[512:1024] < 0).all() and (ref > 0).sum() > 100
    np.testing.assert_array_equal(out[dead], -1e9)
    np.testing.assert_array_equal(ref[dead], -1e9)
    tol = 1e-5 * rsum if l1 < lmax or bf16 else 1e-5
    assert (np.abs(out - ref)[~dead] <= np.broadcast_to(tol, out.shape)[~dead]).all()
    apart = rsum[at] - rows_np[at, ck.SLOTS["d"][0]]
    np.testing.assert_array_equal(out[at][ks >= 0], apart[ks >= 0])
    assert (np.abs(out[at][ks < 0] - apart[ks < 0]) > 1e-4).all()


# (wall kind, lmax, cap grid): both kinds at Lmax 8 on the drum's 8x16
# grid (2-node blocks) and on the deposition's 12x24 (288 nodes: 3-node
# blocks), at each other degree compiled into csrc/ (0, 2, 4) and at lmax
# 6, which takes the run-time-degree instantiation; the 11x25 grid's 275
# nodes take 3-node blocks with the last partly empty.
WALL_CASES = [
    pytest.param(kind, lmax, quad, id=f"{kind}{tag}")
    for kind in ("plane", "cylinder")
    for lmax, quad, tag in ((8, (8, 16), ""), (8, (12, 24), "-12x24"),
                            (0, (8, 16), "-0"), (2, (8, 16), "-2"),
                            (4, (8, 16), "-4"),
                            (6, (8, 16), "-6-run-time-degree"),
                            (8, (11, 25), "-11x25"))
]


@pytest.mark.parametrize("kind,lmax,quad", WALL_CASES)
def test_wall_kernel_matches_plain(kind, lmax, quad, cuda_device):
    rng = np.random.default_rng(1)
    n = 64
    shapes = shapes_library.build_shapes(blob_coeffs(lmax, 2), lmax,
                                         contact_quad=quad,
                                         device=cuda_device)
    x = rng.uniform(0.8, 5.2, (n, 3))
    x[:, 2] = rng.uniform(0.25, 1.6, n)
    if kind == "plane":
        wall = walls_mod.PlaneWall.create([0, 0, 0.5], [0, 0, 1],
                                          velocity=[0.1, 0, 0],
                                          device=cuda_device)
    else:
        rel = x[:, :2] - 3.0
        x[:, :2] = 3.0 + rel / np.linalg.norm(rel, axis=1, keepdims=True) \
            * rng.uniform(2.2, 2.85, n)[:, None]
        wall = walls_mod.CylinderWall.create([3, 3, 0], [0, 0, 1], 2.8,
                                             omega=0.7, device=cuda_device)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    st = scenarios.make_state(
        x, [0, 0, 0], [6, 6, 6], q=q, v=rng.normal(size=(n, 3)) * 0.3,
        angmom=rng.normal(size=(n, 3)) * 0.05,
        scale=rng.uniform(0.85, 1.15, n), shtype=rng.integers(0, 2, n),
        device=cuda_device)
    depth_c, n_c = wall.depth_and_normal(st.x)
    om = omega_from_angmom(st.q, st.angmom, shapes.inertia_of(st.shtype,
                                                              st.scale))
    hist = torch.tensor(rng.normal(size=(n, 6)).astype(np.float32) * 1e-4,
                        device=cuda_device)
    packed, tbl, cap, par, k = wk.pack_wall(st, shapes, _params(cuda_device),
                                            wall, hist, depth_c, n_c, om)
    assert k == kind
    n0 = wk.wall_contact_kernel.launches[kind]
    out = wk.wall_contact_kernel(packed, tbl, cap, par, lmax, kind)
    torch.cuda.synchronize()
    assert wk.wall_contact_kernel.launches[kind] == n0 + 1
    out = np32(out)
    ref = np32(wk.wall_contact_plain(packed, tbl, cap, par, lmax, kind))
    assert (ref[:, 13] > 0.5).sum() > 3
    np.testing.assert_array_equal(out[:, 13], ref[:, 13])
    fmag = np.abs(ref[:, 0:3]).max()
    np.testing.assert_allclose(out[:, 0:6], ref[:, 0:6], rtol=0,
                               atol=1e-4 * fmag)
    np.testing.assert_allclose(out[:, 6:13], ref[:, 6:13], rtol=0,
                               atol=1e-6 + 1e-4 * np.abs(ref[:, 6:13]).max())


def test_kernels_reject_bad_inputs(cuda_device):
    packed, tbl, cap, par, _ = _pairs(4, cuda_device)
    with pytest.raises(TypeError):
        ck.pair_contact(packed.double(), tbl, cap, par, 4)
    with pytest.raises(ValueError):
        ck.pair_contact(packed, tbl, cap, par, 8)  # table width of lmax 4
    with pytest.raises(ValueError):
        ck.pair_contact(packed, tbl.cpu(), cap, par, 4)
    wpacked = torch.zeros((5, wk.F_WALL), device=cuda_device)
    wpar = torch.zeros((1, wk.N_PAR_WALL), device=cuda_device)
    with pytest.raises(ValueError):  # [T, W] with T not padded to 8
        wk.wall_contact_kernel(wpacked, tbl[:3].contiguous(), cap, wpar, 4,
                               "plane")
    with pytest.raises(ValueError):  # beyond a block's shared memory
        wk.wall_contact_kernel(wpacked, torch.zeros((1200, tbl.shape[1]),
                                                    device=cuda_device),
                               cap, wpar, 4, "plane")


def _card_vs_cpu(runs):
    (tg, xg), (tc, xc) = runs
    for th in (tg, tc):
        assert th["pe_pair"] > 0 and th["pe_wall"] > 0
    for k in ("ke", "erot", "pe_pair", "pe_wall", "pe_grav", "etot"):
        np.testing.assert_allclose(tg[k], tc[k], rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(xg, xc, rtol=0, atol=1e-3)


def _run(sim, st, steps=40):
    st, ng = sim.run(*sim.init_neighbors(st), steps)
    assert int(ng.overflow) == 0
    th = {k: float(v) for k, v in sim.thermo(st, ng).items() if v.ndim == 0}
    return th, np32(st.x)


def test_deposition_on_card_matches_cpu(cuda_device):
    """Deposition at n = 128, Lmax 8, 12x24 cap grid, geometric law (K2),
    40 steps from a contact-rich start: card vs CPU twins."""
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        sim, st0, _ = scenarios.deposition(n=128, device=device)
        sh, sc = np32(st0.shtype), np32(st0.scale).astype(np.float64)
        radius = np32(sim.shapes.rchar).astype(np.float64)[sh] * sc
        R = float(sim.walls[0].radius)
        L = float(sim.walls[2].point[1] - sim.walls[1].point[1])
        x, angmom = contact_rich_state(np32(st0.x), radius, R, L)
        n0 = dict(ck.pair_contact.launches)
        runs.append(_run(sim, scenarios.make_state(
            x, np32(st0.box_lo), np32(st0.box_hi), q=np32(st0.q),
            angmom=angmom, scale=sc, shtype=sh, device=device)))
        if device.type == "cuda":
            assert ck.pair_contact.launches["geometric"] > n0["geometric"]
    _card_vs_cpu(runs)


def test_settling_on_card_matches_cpu(cuda_device):
    """Settling box at n = 64, Lmax 2: dense [N, K] path through K2, five
    plane walls, 40 steps from the lattice pressed onto the floor."""
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        sim, st0, _ = scenarios.settling_box(n=64, device=device)
        x, angmom = pressed_box_state(np32(st0.x), float(sim.shapes.rmax[0]))
        runs.append(_run(sim, scenarios.make_state(
            x, np32(st0.box_lo), np32(st0.box_hi), q=np32(st0.q),
            angmom=angmom, device=device)))
    _card_vs_cpu(runs)


def test_drum_on_card_matches_cpu(cuda_device):
    """The slice end to end: a contact-rich n = 128 Lmax 4 drum, 40 steps
    through the kernels vs through the plain twins on the CPU. Energies
    rtol 2e-3, positions 1e-3 absolute (as tests/test_torch_drum.py)."""
    kw = dict(n=128, lmax=4, k_max=24, pair_capacity=640,
              stage2_capacity=384, rebuild_every=20)
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        sim, st0, _ = scenarios.rotating_drum(device=device, **kw)
        sh, sc = np32(st0.shtype), np32(st0.scale).astype(np.float64)
        radius = np32(sim.shapes.rchar).astype(np.float64)[sh] * sc
        R = float(sim.walls[0].radius)
        L = float(sim.walls[2].point[1] - sim.walls[1].point[1])
        x, angmom = contact_rich_state(np32(st0.x), radius, R, L)
        st = scenarios.make_state(x, np32(st0.box_lo), np32(st0.box_hi),
                                  q=np32(st0.q), angmom=angmom, scale=sc,
                                  shtype=sh, device=device)
        st, ng = sim.run(*sim.init_neighbors(st), 40)
        assert int(ng.overflow) == 0 and int(ng.skin_violations) == 0
        th = {k: float(v) for k, v in sim.thermo(st, ng).items()
              if v.ndim == 0}
        assert th["pe_pair"] > 0 and th["pe_wall"] > 0 and th["erot"] > 0
        runs.append((th, np32(st.x)))
    (tg, xg), (tc, xc) = runs
    for k in ("ke", "erot", "pe_pair", "pe_wall", "pe_grav", "etot"):
        np.testing.assert_allclose(tg[k], tc[k], rtol=2e-3, err_msg=k)
    np.testing.assert_allclose(xg, xc, rtol=0, atol=1e-3)


def test_sheared_triaxial_step_on_card_matches_cpu(cuda_device):
    """One step of the sheared triaxial cell (n = 128, fill 0.09, xy shear,
    the servo on) from a contact-rich start with its xy tilt at the flip:
    forces within 2e-3 |F|max, tilt, box and positions at f32 precision,
    card vs CPU; the card step launched K2."""
    runs = []
    for device in (cuda_device, torch.device("cpu")):
        sim, st0, _ = scenarios.triaxial_cell(
            n=128, fill_fraction=0.09, shear_rate=(0.05, 0.0, 0.0),
            press_tau=1.0, device=device)
        st, ng = sim.init_neighbors(
            triaxial_state(st0, device, xy_frac=0.5 * (1 - 1e-6))[0])
        n0 = ck.pair_contact.launches["geometric"]
        st, ng = sim.run(st, ng, 1)
        if device.type == "cuda":
            assert ck.pair_contact.launches["geometric"] > n0
        assert int(ng.overflow) == 0
        runs.append({k: np32(getattr(st, k)) for k in
                     ("f", "x", "tilt", "box_lo", "box_hi", "image")})
    card, cpu = runs
    assert cpu["tilt"][0] < 0  # flipped in this step
    fmag = np.abs(cpu["f"]).max()
    assert fmag > 0
    np.testing.assert_allclose(card["f"], cpu["f"], rtol=0, atol=2e-3 * fmag)
    for k in ("x", "tilt", "box_lo", "box_hi"):
        np.testing.assert_allclose(card[k], cpu[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(card["image"], cpu["image"])


def test_deck_two_body_cli_on_card(cuda_device, tmp_path):
    """``examples/two_body.in`` through the deck CLI with ``--device cuda``:
    the head-on elastic collision swaps the velocities (the reference's
    tests/test_io.py::test_deck_two_body), read from the last dump frame;
    thermo rows on cadence; etot kept within 5e-3."""
    import subprocess
    import sys

    from torch_port_util import EXAMPLES, cut_deck

    from spherharm_tpu_torch.io.dump import read_dump

    deck = tmp_path / "two_body.in"
    deck.write_text(cut_deck((EXAMPLES / "two_body.in").read_text(),
                             tmp_path, 3000, 250, 500))
    out = subprocess.run(
        [sys.executable, "-m", "spherharm_tpu_torch.io.deck", "--device",
         "cuda", str(deck)], capture_output=True, text=True, timeout=600,
        cwd=EXAMPLES.parent)
    assert out.returncode == 0, out.stderr
    rows = [ln.split() for ln in out.stdout.splitlines()[1:]]
    assert [int(r[0]) for r in rows] == list(range(0, 3001, 250))
    etot = [float(r[7]) for r in rows]
    assert abs(etot[-1] - etot[0]) / abs(etot[0]) < 5e-3
    frames = read_dump(tmp_path / "two_body.dump")
    assert [f["step"] for f in frames] == list(range(0, 3001, 500))
    last = frames[-1]["data"]
    np.testing.assert_array_equal(last["id"], [1, 2])
    assert last["vx"][0] == pytest.approx(-1.0, abs=5e-3)
    assert last["vx"][1] == pytest.approx(1.0, abs=5e-3)


def _replica_rows(packed, par, R, seed=2):
    """R replicas of ``packed``'s rows, replica-major, each with its own
    dt (par row r) and its own materials (kn, gamma_n, mu scaled in the
    rows' mat slots)."""
    rng = np.random.default_rng(seed)
    lo = ck.SLOTS["mat"][0]
    blocks, pars = [], []
    for r in range(R):
        b = packed.clone()
        for k, s in ((0, 1.0 + r), (2, 0.5 + 0.5 * r), (4, 0.25 + 0.25 * r)):
            b[:, lo + k] *= s
        blocks.append(b)
        p = par.clone()
        p[0, 0] *= rng.uniform(0.5, 3.0)
        pars.append(p)
    return torch.cat(blocks).contiguous(), torch.cat(pars).contiguous()


@pytest.mark.parametrize("conservative,bf16", [
    (True, False), (False, False), (True, True), (False, True)],
    ids=["K1", "K2", "K3-conservative", "K3-geometric"])
def test_pair_contact_kernel_replicas(conservative, bf16, cuda_device):
    """R = 4 replicas' rows in one launch, each reading its own par row
    (dt) and materials: the kernel against the batched twin at the
    single-list tolerances, and the batched twin against one twin call a
    replica."""
    R = 4
    packed, tbl, cap, par, _ = _pairs(4, cuda_device)
    packed, par = _replica_rows(packed, par, R)
    variant = ("conservative" if conservative else "geometric") + (
        "_bf16" if bf16 else "")
    n0 = ck.pair_contact.launches[variant]
    out = ck.pair_contact(packed, tbl, cap, par, 4, conservative, bf16)
    torch.cuda.synchronize()
    assert ck.pair_contact.launches[variant] == n0 + 1
    ref = ck.pair_contact_plain(packed, tbl, cap, par, 4, conservative, bf16)
    P = packed.shape[0] // R
    for r in range(R):
        blk = slice(r * P, (r + 1) * P)
        one = ck.pair_contact_plain(packed[blk], tbl, cap, par[r:r + 1], 4,
                                    conservative, bf16)
        np.testing.assert_allclose(np32(ref[blk]), np32(one), rtol=0,
                                   atol=1e-6 * float(one.abs().max()))
    out, ref = np32(out), np32(ref)
    assert (ref[:, 16] > 0.5).sum() > 4 * R
    fmag = np.abs(ref[:, 0:9]).max()
    tol = 2e-3 if not (conservative or bf16) else 1e-4
    bad = np.abs(out[:, 0:9] - ref[:, 0:9]).max(1) > tol * fmag
    assert bad.sum() <= max(1, out.shape[0] // 1000)
    assert not np.array_equal(out[:P, 9:12], out[P:2 * P, 9:12])  # dt differs


def _indexed_lists(shape, device, R=2, n=40, seed=8):
    """R = 2 replicas' pair lists, replica-major, each replica its own
    positions, dt and kn (pair_tab [R, T, T, 8]): every ordered pair of n
    particles a slot, a few slots not valid, particle 3 inactive, then a
    dead tail of 64 slots; springs mid-contact, read through a strided
    view (as a step hands the last output's columns 9:15 on). ``shape``:
    the drum's (Lmax 8, 4 types, 128 nodes, a closed box) or the sheared
    cell's (Lmax 4, 2 types, 72 nodes, a periodic triclinic box, the
    particles scattered about its corner and wrapped into it, so that
    many pairs meet through an image). Returns (state, shapes, params,
    pi, pj, valid, hist, periodic, tilt)."""
    from spherharm_tpu_torch.parallel import ensemble as ens

    rng = np.random.default_rng(seed)
    tri = shape == "triaxial"
    lmax, types, quad = (4, 2, (6, 12)) if tri else (8, 4, (8, 16))
    shapes = shapes_library.build_shapes(blob_coeffs(lmax, types, seed), lmax,
                                         contact_quad=quad, device=device)
    assert shapes.cap_x.shape[0] == (72 if tri else 128)
    periodic = (True, True, True) if tri else (False, False, False)
    tilt = (0.7, -0.4, 0.5) if tri else None
    L = 4.6 if tri else 4.0

    def one():
        x = (rng.uniform(-1.3, 1.3, (n, 3)) % L if tri
             else rng.uniform(0.7, 2.9, (n, 3)))
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        st = scenarios.make_state(
            x, [0, 0, 0], [L, L, L], q=q, v=rng.normal(size=(n, 3)) * 0.2,
            angmom=rng.normal(size=(n, 3)) * 0.02,
            scale=rng.uniform(0.85, 1.15, n), shtype=rng.integers(0, types, n),
            tilt=tilt, device=device)
        active = st.active.clone()
        active[3] = False
        return st.replace(active=active)

    st = ens.stack_replicas([one() for _ in range(R)])
    params = ens.with_param_sweep(_params(device), dt=[1e-4, 3e-4],
                                  kn=[1e5, 3e5])
    pi, pj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    sel = pi.ravel() != pj.ravel()
    pi = np.concatenate([pi.ravel()[sel], np.full(64, n - 1)])
    pj = np.concatenate([pj.ravel()[sel], np.full(64, n - 1)])
    P = pi.shape[0]
    valid = rng.uniform(size=(R, P)) > 0.05
    valid[:, -64:] = False
    t = lambda a: torch.tensor(a, device=device)
    hist = t(rng.normal(size=(R, P, ck.N_OUT)).astype(np.float32) * 1e-4)
    return (st, shapes, params, t(pi).expand(R, P).contiguous(),
            t(pj).expand(R, P).contiguous(), t(valid), hist[..., 9:15],
            periodic, None if tilt is None else st.tilt)


@pytest.mark.parametrize("shape", ["drum", "triaxial"])
@pytest.mark.parametrize("conservative,bf16", [
    (True, False), (False, False), (True, True), (False, True)],
    ids=["K1", "K2", "K3-conservative", "K3-geometric"])
def test_pair_contact_indexed_matches_packed_kernel(shape, conservative, bf16,
                                                    cuda_device):
    """``pair_contact_indexed`` (each warp gathers its row by index) against
    ``pair_contact`` on the packed rows of the same lists, both launched on
    the card, R = 2 replica-major lists: columns 0-16 within 1e-6 of each
    group's scale, d within 1 f32 ulp of ``contact.minimum_image`` on the
    card, the mask in column 20, dead slots (the tail's 64 included) zero
    rows; one launch counted under the packed entry's variant key."""
    from spherharm_tpu_torch.core.state import take
    from spherharm_tpu_torch.ops import contact

    st, shapes, params, pi, pj, valid, hist, periodic, tilt = _indexed_lists(
        shape, cuda_device)
    lmax = shapes.lmax
    at = lambda t, i: take(t, i, True)
    rows = contact.particle_rows(st, shapes)
    ri, rj = at(rows, pi), at(rows, pj)
    msk = valid & (ri[..., contact._RACT] > 0.5) & (rj[..., contact._RACT] > 0.5)
    d = contact.minimum_image(rj[..., contact._RX] - ri[..., contact._RX],
                              st.box_lo, st.box_hi, periodic, tilt)
    packed, tbl, cap, par = ck.pack_pairs(st, shapes, params, pi, pj, msk,
                                          hist, d, rows=rows)
    assert par.shape[0] == 2 and params.pair_tab.dim() == 4
    ref = ck.pair_contact(packed, tbl, cap, par, lmax, conservative, bf16)
    variant = ("conservative" if conservative else "geometric") + (
        "_bf16" if bf16 else "")
    n0 = dict(ck.pair_contact.launches)
    out = ck.pair_contact_indexed(
        rows, st.shtype, pi, pj, valid, hist, params.pair_tab, tbl, cap, par,
        ck.box_rows(st.box_lo, st.box_hi, tilt, 2), periodic, lmax,
        conservative, bf16)
    torch.cuda.synchronize()
    assert ck.pair_contact.launches == dict(n0, **{variant: n0[variant] + 1})

    m = np32(msk).reshape(-1)
    out, ref, d = np32(out), np32(ref), np32(d).reshape(-1, 3)
    assert 0 < m.sum() < m.size and (ref[:, 16] > 0.5).sum() > 8
    for lo, hi in ((0, 3), (3, 9), (9, 15), (15, 17)):
        np.testing.assert_allclose(out[:, lo:hi], ref[:, lo:hi], rtol=0,
                                   atol=1e-6 * np.abs(ref[:, lo:hi]).max())
    live = m.astype(bool)
    assert (np.abs(out[live, 17:20] - d[live])
            <= np.spacing(np.abs(d[live]))).all()
    np.testing.assert_array_equal(out[:, 20], m)
    np.testing.assert_array_equal(out[~live], 0.0)
    np.testing.assert_array_equal(out[:, 21:], 0.0)
    if tilt is not None:  # pairs met through an image
        raw = np32(rj[..., contact._RX] - ri[..., contact._RX]).reshape(-1, 3)
        assert (np.abs(raw - d).max(1)[live] > 1.0).sum() > 8


@pytest.mark.parametrize("kind", ["plane", "cylinder"])
def test_wall_kernel_replicas(kind, cuda_device):
    """R = 3 replicas' wall batches in one launch ([R * B, 32] rows, par
    [R, 24] with each replica's dt and materials): the kernel against the
    batched twin, and the batched twin against one call a replica."""
    from spherharm_tpu_torch.parallel import ensemble as ens

    R, n, lmax = 3, 64, 8
    rng = np.random.default_rng(6)
    shapes = shapes_library.build_shapes(blob_coeffs(lmax, 2), lmax,
                                         device=cuda_device)
    x = rng.uniform(0.8, 5.2, (n, 3))
    x[:, 2] = rng.uniform(0.25, 1.6, n)
    if kind == "plane":
        wall = walls_mod.PlaneWall.create([0, 0, 0.5], [0, 0, 1],
                                          velocity=[0.1, 0, 0],
                                          device=cuda_device)
    else:
        rel = x[:, :2] - 3.0
        x[:, :2] = 3.0 + rel / np.linalg.norm(rel, axis=1, keepdims=True) \
            * rng.uniform(2.2, 2.85, n)[:, None]
        wall = walls_mod.CylinderWall.create([3, 3, 0], [0, 0, 1], 2.8,
                                             omega=0.7, device=cuda_device)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    st = scenarios.make_state(
        x, [0, 0, 0], [6, 6, 6], q=q, v=rng.normal(size=(n, 3)) * 0.3,
        angmom=rng.normal(size=(n, 3)) * 0.05,
        scale=rng.uniform(0.85, 1.15, n), shtype=rng.integers(0, 2, n),
        device=cuda_device)
    params = ens.with_param_sweep(_params(cuda_device), dt=[1e-4, 2e-4, 4e-4],
                                  kn=[1e5, 3e5, 5e5], mu=[0.1, 0.4, 0.9],
                                  gamma_n=[5.0, 20.0, 60.0])
    om = omega_from_angmom(st.q, st.angmom, shapes.inertia_of(st.shtype,
                                                              st.scale))
    depth_c, n_c = wall.depth_and_normal(st.x)
    hist = torch.tensor(rng.normal(size=(n, 6)).astype(np.float32) * 1e-4,
                        device=cuda_device)
    stacked = lambda t: t.expand((R,) + t.shape)
    packed, tbl, cap, par, k = wk.pack_wall(
        ens.replicate(st, R), shapes, params, wall, stacked(hist),
        stacked(depth_c), stacked(n_c), stacked(om))
    assert k == kind and par.shape == (R, wk.N_PAR_WALL)
    n0 = wk.wall_contact_kernel.launches[kind]
    out = wk.wall_contact_kernel(packed, tbl, cap, par, lmax, kind)
    torch.cuda.synchronize()
    assert wk.wall_contact_kernel.launches[kind] == n0 + 1
    ref = wk.wall_contact_plain(packed, tbl, cap, par, lmax, kind)
    for r in range(R):
        args = wk.pack_wall(st, shapes, ens.replica(params, r), wall, hist,
                            depth_c, n_c, om)
        one = wk.wall_contact_plain(*args[:4], lmax, kind)
        np.testing.assert_allclose(np32(ref[r * n:(r + 1) * n]), np32(one),
                                   rtol=0, atol=1e-6 * float(one.abs().max()))
    out, ref = np32(out), np32(ref)
    assert (ref[:, 13] > 0.5).sum() > 3 * R
    np.testing.assert_array_equal(out[:, 13], ref[:, 13])
    fmag = np.abs(ref[:, 0:3]).max()
    np.testing.assert_allclose(out[:, 0:6], ref[:, 0:6], rtol=0,
                               atol=1e-4 * fmag)
    np.testing.assert_allclose(out[:, 6:13], ref[:, 6:13], rtol=0,
                               atol=1e-6 + 1e-4 * np.abs(ref[:, 6:13]).max())


def test_two_body_sweep_on_card(cuda_device):
    """tests/test_ensemble.py's restitution sweep (R = 4, gamma_n 0-400,
    3000 steps) on the card: speeds monotone in gamma, replica 0 within
    2e-3 of the single card run, every replica within 1e-3 of the CPU
    ensemble's, and as many pair-kernel launches as the single run."""
    from spherharm_tpu_torch.parallel import ensemble as ens

    gammas, steps = [0.0, 50.0, 150.0, 400.0], 3000
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        sim, state, neigh = scenarios.two_body_collision(
            gamma_n=0.0, dt=2e-4, conservative=False, device=device)
        params = ens.with_param_sweep(sim.params, gamma_n=gammas)
        n0 = ck.pair_contact.launches["geometric"]
        states, _ = ens.run_replicas(sim, ens.replicate(state, 4),
                                     ens.replicate(neigh, 4), params, steps)
        n1 = ck.pair_contact.launches["geometric"]
        out[device.type] = np32(states.v)
        if device.type == "cuda":
            s1, _ = sim.run(state, neigh, steps)
            n2 = ck.pair_contact.launches["geometric"]
            assert n1 - n0 == n2 - n1 == steps
            v_solo = float(s1.v[0, 0])
    speeds = -out["cuda"][:, 0, 0]
    assert speeds[0] > 0.99
    assert np.all(np.diff(speeds) < 0), speeds
    assert abs(out["cuda"][0, 0, 0] - v_solo) <= 2e-3
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-3)


def test_segment_sum_is_repeatable_on_the_card(cuda_device):
    """The segment sums on a 1.2M-row list (the triaxial cell's size): ten
    calls give the same bits, and an [R, P] replica stack gives each
    replica its single list's bits (``contact.prefix_sum``: no 1-D CUB
    scan, whose float result depends on the device's scheduling)."""
    from spherharm_tpu_torch.ops import contact

    rng = np.random.default_rng(3)
    P, N = 1_200_000, 100_000
    seg = torch.tensor(np.sort(rng.integers(0, N, P)), device=cuda_device)
    data = torch.tensor(rng.normal(size=(P, 6)).astype(np.float32) * 1e3,
                        device=cuda_device)
    first = contact.sorted_segment_sum(data, seg, N)
    for _ in range(9):
        assert torch.equal(contact.sorted_segment_sum(data, seg, N), first)
    stacked = contact.sorted_segment_sum(torch.stack([data, data.flip(0)]),
                                         torch.stack([seg, seg]), N)
    assert torch.equal(stacked[0], first)


# -- CUDA graphs of the step (core/runner.py) ------------------------------

def _graph_drum(device, rebuild_every=20, skin=None):
    """The n = 128 Lmax 4 conservative drum with the prefilter, from its
    contact-rich start; ``skin`` cuts the skin (small motion budgets: the
    skin trigger fires within a few steps)."""
    from torch_port_util import drum_state

    sim, st0, _ = scenarios.rotating_drum(
        n=128, lmax=4, k_max=24, pair_capacity=640, stage2_capacity=384,
        rebuild_every=rebuild_every, device=device)
    if skin is not None:
        sim.params = sim.params.replace(skin=torch.full_like(sim.params.skin,
                                                              skin))
    return (sim,) + sim.init_neighbors(drum_state(sim, st0, device))


def _counts():
    return {**{f"pair_{k}": n for k, n in ck.pair_contact.launches.items()},
            **ck.stage1_depth.launches,
            **{f"wall_{k}": n for k, n in wk.wall_contact_kernel.launches.items()}}


def _launched(run):
    """``run()``'s result and the kernel launches it counted."""
    before = _counts()
    out = run()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in _counts().items()}


def _eager_and_graph(sim, run):
    """``run()`` with the step eager and as CUDA graph replays: (eager
    result, its launches, graph result, its launches)."""
    sim.cuda_graphs = False
    eager, n_eager = _launched(run)
    sim.cuda_graphs = True
    graph, n_graph = _launched(run)
    return eager, n_eager, graph, n_graph


GRAPH_CASES = [("cadence", 25), ("check", 25), ("ensemble", 20)]


@pytest.mark.parametrize("case,steps", GRAPH_CASES,
                         ids=[c for c, _ in GRAPH_CASES])
def test_graph_run_equals_eager(case, steps, cuda_device):
    """The graph run equals the eager run of the same steps bit for bit in
    every State and NeighborState field, with equal kernel launch counts:
    the drum's static cadence (25 steps at R = 20: a block and a
    remainder), its skin trigger (skin 0.004) and an R = 3 ensemble of it
    with gamma_n, dt and skin swept (``run_replicas``)."""
    from spherharm_tpu_torch.parallel import ensemble as ens
    from spherharm_tpu_torch.utils import validate

    if case == "ensemble":
        sim, st, ng = _graph_drum(cuda_device, 0, skin=0.004)
        params = ens.with_param_sweep(sim.params, gamma_n=[10.0, 50.0, 200.0],
                                      dt=[1e-4, 2e-4, 3e-4],
                                      skin=[0.004, 0.008, 0.016])
        st, ng = ens.replicate(st, 3), ens.replicate(ng, 3)
        run = lambda: ens.run_replicas(sim, st, ng, params, steps)
    else:
        sim, st, ng = _graph_drum(cuda_device, 20 if case == "cadence" else 0,
                                  skin=None if case == "cadence" else 0.004)
        run = lambda: sim.run(st, ng, steps)
    eager, n_eager, graph, n_graph = _eager_and_graph(sim, run)
    assert validate.bitwise_differences(graph, eager) == {}
    assert n_graph == n_eager
    stats = sim.graph_stats()
    rebuilds = stats["replays"].get("always", 0) + stats["replays"].get(
        "rebuild_post", 0)
    assert rebuilds >= 1 and stats["pool_bytes"] > 0
    assert n_graph["pair_conservative"] == steps
    assert n_graph["stage1_depth"] == rebuilds


def test_graph_launch_counts_count_replays(cuda_device):
    """The launch counters count a graph's kernels on every replay, not
    once at capture: the n = 64 settling box (dense path, five plane
    walls, skin trigger) launches the pair kernel once and the plane
    kernel five times a step, whether the graphs were just captured or
    are replayed from the cache."""
    sim, st0, _ = scenarios.settling_box(n=64, device=cuda_device)
    x, angmom = pressed_box_state(np32(st0.x), float(sim.shapes.rmax[0]))
    st, ng = sim.init_neighbors(scenarios.make_state(
        x, np32(st0.box_lo), np32(st0.box_hi), q=np32(st0.q), angmom=angmom,
        device=cuda_device))
    for steps in (7, 11):  # a capture, then cached graphs
        _, n = _launched(lambda: sim.run(st, ng, steps))
        assert n["pair_geometric"] == steps and n["wall_plane"] == 5 * steps
    assert sim.graph_stats()["runners"] == 1


def test_graph_run_returns_no_alias(cuda_device):
    """A graph run returns new tensors: a later run (from the same start
    or from its result) leaves the first result as it was, and no
    returned tensor shares memory with the runner's buffers."""
    sim, st, ng = _graph_drum(cuda_device)
    a_st, a_ng = sim.run(st, ng, 5)
    keep = (a_st.x.clone(), a_ng.pair_hist.clone())
    b_st, b_ng = sim.run(a_st, a_ng, 5)
    sim.run(st, ng, 5)
    assert torch.equal(a_st.x, keep[0]) and torch.equal(a_ng.pair_hist, keep[1])
    assert not torch.equal(b_st.x, a_st.x)
    buffers = {t.untyped_storage().data_ptr()
               for r in sim._graphs.values() for v in r.buffers.values()
               for t in ([v] if torch.is_tensor(v) else
                         [getattr(v, f) for f in v.__dataclass_fields__])}
    for obj in (a_st, a_ng, b_st, b_ng):
        for f in obj.__dataclass_fields__:
            assert getattr(obj, f).untyped_storage().data_ptr() not in buffers, f


def test_graph_cache_follows_params_and_walls(cuda_device):
    """Params are data loaded on each run: a new params object of the same
    shapes (a friction change) reuses the graphs and gives the eager run's
    bits; new walls (the drum spun twice as fast) drop the cache and
    capture anew."""
    from spherharm_tpu_torch.utils import validate

    sim, st, ng = _graph_drum(cuda_device)
    sim.run(st, ng, 3)
    sim.params = sim.params.replace(mu=torch.full_like(sim.params.mu, 0.1))
    eager, _, graph, _ = _eager_and_graph(sim, lambda: sim.run(st, ng, 21))
    assert validate.bitwise_differences(graph, eager) == {}
    assert sim.graph_stats()["runners"] == 1
    first = next(iter(sim._graphs.values()))
    drum = sim.walls[0]
    sim.walls = (drum.replace(omega=2.0 * drum.omega),) + sim.walls[1:]
    eager, _, graph, _ = _eager_and_graph(sim, lambda: sim.run(st, ng, 21))
    assert validate.bitwise_differences(graph, eager) == {}
    assert next(iter(sim._graphs.values())) is not first


def test_failed_capture_raises(cuda_device, monkeypatch):
    """A unit that reads the device from the host cannot be captured: the
    graph run raises and caches nothing, where the eager run (asked for by
    name) runs."""
    from spherharm_tpu_torch.core.simulation import Simulation

    sim, st, ng = _graph_drum(cuda_device, 0)
    post = Simulation._post

    def syncing_post(self, state, neigh):
        if float(state.x.sum()) != float(state.x.sum()):  # a host read
            raise AssertionError("non-finite positions")
        return post(self, state, neigh)

    monkeypatch.setattr(Simulation, "_post", syncing_post)
    sim.cuda_graphs = False
    sim.run(st, ng, 2)
    sim.cuda_graphs = True
    with pytest.raises(RuntimeError):
        sim.run(st, ng, 2)
    assert not sim._graphs


def _slab_sim(device, S, wall, rebuild_every, conservative=False):
    """A ``slab_drift_system`` on S slabs (its migrations come at the
    first rebuilds), initialised on ``device``: (sim, state, neigh,
    ghosts)."""
    from spherharm_tpu_torch.ops.walls import PlaneWall
    from spherharm_tpu_torch.parallel.halo import ShardedSimulation

    from torch_port_util import slab_drift_system

    x, v, box, periodic = slab_drift_system(S, wall)
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, 4)], 4,
        contact_quad=(6, 12), device=device)
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3,
                              gravity=(0.0, 0.0, -10.0 if wall else 0.0),
                              device=device)
    walls = ((PlaneWall.create((0, 0, 0), (0, 0, 1), device=device),)
             if wall else ())
    sim = ShardedSimulation(
        shapes, params, n_shards=S, box_lo=(0, 0, 0), box_hi=tuple(box),
        cap_local=64, halo_cap=32, migrate_cap=16, periodic=periodic,
        k_max=16, cell_cap=8, pair_capacity=256, walls=walls,
        rebuild_every=rebuild_every, conservative=conservative, device=device)
    return (sim,) + sim.init(scenarios.make_state(x, [0, 0, 0], box, v=v,
                                                  device=device))


SHARD_CASES = [("s4-cadence-cons", 4, False, 10, True),
               ("s2-wall-check", 2, True, 0, False)]


@pytest.mark.parametrize("case,S,wall,every,cons", SHARD_CASES,
                         ids=[c[0] for c in SHARD_CASES])
def test_sharded_graph_run_equals_eager(case, S, wall, every, cons,
                                        cuda_device):
    """The slab decomposition's graph run (``pre`` / ``pre_check``, a
    rebuild or ``comm``, ``post`` replays) equals its eager run of the
    same 25 steps bit for bit in every State, NeighborState and GhostPack
    field, with equal kernel launches: 4 slabs on the static cadence in
    the conservative law, and 2 slabs with a plane floor on the skin
    trigger. Then ``rebalance`` and a run after it capture no new graph."""
    from spherharm_tpu_torch.utils import validate

    sim, st, ng, gh = _slab_sim(cuda_device, S, wall, every, cons)
    run = lambda: sim.run(st, ng, gh, 25)
    eager, n_eager, graph, n_graph = _eager_and_graph(sim, run)
    assert validate.bitwise_differences(graph, eager) == {}
    assert n_graph == n_eager
    law = "pair_conservative" if cons else "pair_geometric"
    assert n_graph[law] == 25
    assert n_graph["wall_plane"] == (25 if wall else 0)
    stats = sim.graph_stats()
    graphs = stats["graphs"]
    assert stats["replays"]["post"] == 25 and stats["pool_bytes"] > 0
    s, n, g = sim.rebalance(*graph)
    sim.run(s, n, g, 10)
    assert sim.graph_stats()["graphs"] == graphs


def test_sharded_on_card_matches_cpu(cuda_device):
    """2 slabs with x not periodic and a plane floor (K7, wall springs
    migrating) for 40 steps on the card and on the CPU: the same tags,
    positions within 1e-3, thermo within 2e-3 relative, wall contacts."""
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        sim, st, ng, gh = _slab_sim(device, 2, True, 10)
        st, ng, gh = sim.run(st, ng, gh, 40)
        th = sim.thermo(st, ng, gh)
        assert int(th["neigh_overflow"]) == 0
        order = np.argsort(np32(st.tag).reshape(-1))
        act = np32(st.active).reshape(-1)[order]
        out[device.type] = (np32(st.x).reshape(-1, 3)[order][act],
                            {k: float(th[k]) for k in
                             ("ke", "pe_pair", "pe_wall", "etot")})
    (xg, tg), (xc, tc) = out["cuda"], out["cpu"]
    assert tc["pe_wall"] > 0
    np.testing.assert_allclose(xg, xc, rtol=0, atol=1e-3)
    for k in tc:
        assert tg[k] == pytest.approx(tc[k], rel=2e-3), k


def _brick_sim(device, mesh_shape, wall, rebuild_every, conservative=False):
    """A ``brick_drift_system`` on a brick of ``mesh_shape`` (its
    migrations along every mesh axis come at the first rebuilds),
    initialised on ``device``: (sim, state, neigh, ghosts)."""
    from spherharm_tpu_torch.ops.walls import PlaneWall
    from spherharm_tpu_torch.parallel.brick import BrickSimulation

    from torch_port_util import brick_drift_system

    x, v, box, periodic = brick_drift_system(mesh_shape, wall)
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, 4)], 4,
        contact_quad=(6, 12), device=device)
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3,
                              cutoff=1.2, skin=0.3,
                              gravity=(0.0, 0.0, -10.0 if wall else 0.0),
                              device=device)
    walls = ((PlaneWall.create((0, 0, 0), (0, 0, 1), device=device),)
             if wall else ())
    sim = BrickSimulation(
        shapes, params, mesh_shape=mesh_shape, box_lo=(0, 0, 0),
        box_hi=tuple(box), cap_local=64, halo_cap=48, migrate_cap=16,
        periodic=periodic, k_max=24, cell_cap=16, pair_capacity=384,
        walls=walls, rebuild_every=rebuild_every, conservative=conservative,
        device=device)
    return (sim,) + sim.init(scenarios.make_state(x, [0, 0, 0], box, v=v,
                                                  device=device))


BRICK_CASES = [("b222-cadence-cons", (2, 2, 2), False, 10, True),
               ("b22-wall-check", (2, 2), True, 0, False)]


@pytest.mark.parametrize("case,mesh_shape,wall,every,cons", BRICK_CASES,
                         ids=[c[0] for c in BRICK_CASES])
def test_brick_graph_run_equals_eager(case, mesh_shape, wall, every, cons,
                                      cuda_device):
    """The brick's graph run (its ghosts a tuple of packs in the runner's
    buffers) equals its eager run of the same 25 steps bit for bit in
    every State, NeighborState and GhostPack field, with equal kernel
    launches: a 2x2x2 brick on the static cadence in the conservative
    law, and a 2x2 brick with a plane floor on the skin trigger. Then
    ``rebalance`` and a run after it capture no new graph."""
    from spherharm_tpu_torch.utils import validate

    sim, st, ng, gh = _brick_sim(cuda_device, mesh_shape, wall, every, cons)
    run = lambda: sim.run(st, ng, gh, 25)
    eager, n_eager, graph, n_graph = _eager_and_graph(sim, run)
    assert validate.bitwise_differences(graph, eager) == {}
    assert n_graph == n_eager
    law = "pair_conservative" if cons else "pair_geometric"
    assert n_graph[law] == 25
    assert n_graph["wall_plane"] == (25 if wall else 0)
    stats = sim.graph_stats()
    graphs = stats["graphs"]
    assert stats["replays"]["post"] == 25 and stats["pool_bytes"] > 0
    s, n, g = sim.rebalance(*graph)
    sim.run(s, n, g, 10)
    assert sim.graph_stats()["graphs"] == graphs


def test_brick_on_card_matches_cpu(cuda_device):
    """A 2x2 brick with x and z not periodic and a plane floor (K7, wall
    springs migrating along both axes) for 40 steps on the card and on
    the CPU: the same tags, positions within 1e-3, thermo within 2e-3
    relative, wall contacts."""
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        sim, st, ng, gh = _brick_sim(device, (2, 2), True, 10)
        st, ng, gh = sim.run(st, ng, gh, 40)
        th = sim.thermo(st, ng, gh)
        assert int(th["neigh_overflow"]) == 0
        order = np.argsort(np32(st.tag).reshape(-1))
        act = np32(st.active).reshape(-1)[order]
        out[device.type] = (np32(st.x).reshape(-1, 3)[order][act],
                            {k: float(th[k]) for k in
                             ("ke", "pe_pair", "pe_wall", "etot")})
    (xg, tg), (xc, tc) = out["cuda"], out["cpu"]
    assert tc["pe_wall"] > 0
    np.testing.assert_allclose(xg, xc, rtol=0, atol=1e-3)
    for k in tc:
        assert tg[k] == pytest.approx(tc[k], rel=2e-3), k


def _rank_systems(device, graphs):
    """The 4-shard systems the rank tests run: 4 slabs on the cadence
    (``_slab_sim``) and a (2, 2) brick on the skin trigger
    (``_brick_sim``), each with its global start (``gather_global`` of its
    ``init``), ``ranks.spec_of`` 25 steps, a snapshot and thermo, and the
    same run on the shard axis of this process."""
    from spherharm_tpu_torch.parallel import ranks

    acts = [("run", "", 25), ("snap", "end"), ("thermo", "th")]
    specs, ones = [], []
    for sim, st, _, _ in (_slab_sim(device, 4, False, 10),
                          _brick_sim(device, (2, 2), False, 0)):
        start = sim.gather_global(st)
        spec = ranks.spec_of(sim, start, acts)
        spec["sim"]["cuda_graphs"] = graphs
        specs.append(spec)
        sim.cuda_graphs = graphs
        ones.append(ranks._to_host(ranks.drive(sim, start, acts)))
    return specs, ones


def _hold_ranks_to_one_process(per_rank, ones, L=16.0):
    """The ranks' stacked owned rows and global thermo against the
    one-process run: tags and active exact, x within 1e-5 L, v within
    1e-4 of its scale, thermo within rel 1e-5 (the card's reductions
    over [1, n] and [S, n] may take other orders); the pair kernel
    launched in every rank."""
    for j, one in enumerate(ones):
        ranks_j = [r[j] for r in per_rank]
        end = {f: np.concatenate([r["end"][0][f] for r in ranks_j])
               for f in ("x", "v", "tag", "active")}
        ref = one["end"][0]
        np.testing.assert_array_equal(end["tag"], ref["tag"])
        np.testing.assert_array_equal(end["active"], ref["active"])
        np.testing.assert_allclose(end["x"], ref["x"], rtol=0, atol=1e-5 * L)
        np.testing.assert_allclose(end["v"], ref["v"], rtol=0,
                                   atol=1e-4 * np.abs(ref["v"]).max())
        for r in ranks_j:
            for k in ("ke", "pe_pair", "etot"):
                assert float(r["th"][k]) == pytest.approx(
                    float(one["th"][k]), rel=1e-5), k
            assert r["launches"]["pair_contact_geometric"] > 0


def test_ranks_gloo_on_one_card_match_one_process(cuda_device):
    """4 gloo ranks on the one card (eager by name: gloo stages CUDA
    tensors through host memory) run the 4 slabs and the (2, 2) brick as
    the one-process card run does."""
    from spherharm_tpu_torch.parallel import ranks

    specs, ones = _rank_systems(cuda_device, graphs=False)
    per_rank = ranks.spawn_ranks(ranks.run_specs, 4, "gloo", ["cuda"] * 4,
                                 specs, timeout=600)
    _hold_ranks_to_one_process(per_rank, ones)


def test_ranks_nccl_graphs_on_four_cards(cuda_device):
    """4 NCCL ranks, one a card, with CUDA graphs (the p2p and the
    collectives captured in the units): each rank's graph run is its
    eager run bit for bit, and both match the one-process card run.
    Skipped, and the skip printed, with fewer than 4 cards."""
    from spherharm_tpu_torch.parallel import ranks
    from spherharm_tpu_torch.utils import validate

    cards = torch.cuda.device_count()
    if cards < 4:
        print(f"test_ranks_nccl_graphs_on_four_cards: skipped, {cards} card(s)")
        pytest.skip(f"4 NCCL ranks need 4 cards, found {cards}")
    specs, ones = _rank_systems(cuda_device, graphs=True)
    eager = [dict(s, sim=dict(s["sim"], cuda_graphs=False)) for s in specs]
    per_rank = ranks.spawn_ranks(ranks.run_specs, 4, "nccl",
                                 [f"cuda:{r}" for r in range(4)],
                                 specs + eager, timeout=600)
    for r in per_rank:
        for j in range(len(specs)):
            assert validate.bitwise_differences(
                r[j]["end"], r[len(specs) + j]["end"]) == {}
    _hold_ranks_to_one_process(per_rank, ones)


def _need_cards(name, n=4):
    """Skip ``name`` (and print the skip) with fewer than ``n`` cards."""
    cards = torch.cuda.device_count()
    if cards < n:
        print(f"{name}: skipped, {cards} card(s)")
        pytest.skip(f"{n} NCCL ranks need {n} cards, found {cards}")


def test_ranks_nccl_rebalance_on_four_cards(cuda_device):
    """``rebalance`` on 4 NCCL ranks, one a card, with CUDA graphs, held
    to the same run on 4 gloo ranks on one card (eager): the same new
    bounds (moved off the even split), and the same global state after
    the rebalance and 10 more steps (tags exact, x 1e-5 L, v 1e-4 of its
    scale, as ``_hold_ranks_to_one_process``). The bounds are quantiles of
    the gathered x, which moves each by no more than the largest change
    of an x: so they are held to 1e-5 (in units of L) as x is."""
    from spherharm_tpu_torch.parallel import ranks

    _need_cards("test_ranks_nccl_rebalance_on_four_cards")
    sim, st, _, _ = _slab_sim(cuda_device, 4, False, 10)
    acts = [("run", "", 30), ("rebalance", "fracs"), ("run", "", 10),
            ("global", "global")]
    spec = ranks.spec_of(sim, sim.gather_global(st), acts)
    nccl = ranks.spawn_ranks(ranks.run_specs, 4, "nccl",
                             [f"cuda:{r}" for r in range(4)],
                             [dict(spec, sim=dict(spec["sim"], cuda_graphs=True))],
                             timeout=600)
    gloo = ranks.spawn_ranks(ranks.run_specs, 4, "gloo", ["cuda"] * 4,
                             [dict(spec, sim=dict(spec["sim"], cuda_graphs=False))],
                             timeout=600)
    ref = gloo[0][0]
    assert not np.allclose(ref["fracs"][0], np.linspace(0.0, 1.0, 5))
    glob = ref["global"]
    live = glob["active"].astype(bool)
    L = 16.0
    for r in nccl + gloo:
        out = r[0]
        np.testing.assert_allclose(out["fracs"][0], ref["fracs"][0],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(out["global"]["tag"], glob["tag"])
        np.testing.assert_array_equal(out["global"]["active"], glob["active"])
        np.testing.assert_allclose(out["global"]["x"][live], glob["x"][live],
                                   rtol=0, atol=1e-5 * L)
        np.testing.assert_allclose(out["global"]["v"][live], glob["v"][live],
                                   rtol=0,
                                   atol=1e-4 * np.abs(glob["v"][live]).max())
        assert out["launches"]["pair_contact_geometric"] > 0


def test_ranks_nccl_restart_4_to_2(cuda_device, tmp_path):
    """tests/test_torch_ranks.py's 4-to-2 restart on NCCL ranks with CUDA
    graphs: ``gather_restart`` on 4 ranks (one a card) -> write_restart ->
    read onto the card -> 2 ranks resume; per tag the uninterrupted
    4-rank run (x 2e-3, v 5e-3, as tests/test_sharded.py:301), every
    rank's payload the same, overflow 0."""
    from spherharm_tpu_torch.core.state import State
    from spherharm_tpu_torch.io import restart as rio
    from spherharm_tpu_torch.parallel import ranks

    from torch_port_util import floor_layers

    _need_cards("test_ranks_nccl_restart_4_to_2")
    ck_steps, resume_steps = 250, 200
    sim, st0, resume = floor_layers(cuda_device)
    spec = ranks.spec_of(sim, st0, [("run", "", ck_steps), ("restart", "ck"),
                                    ("run", "", resume_steps), ("snap", "end")])
    per_rank = [r[0] for r in ranks.spawn_ranks(
        ranks.run_specs, 4, "nccl", [f"cuda:{r}" for r in range(4)], [spec],
        timeout=600)]
    gst, payload = per_rank[0]["ck"]
    for r in per_rank[1:]:
        for k, v in gst.items():
            np.testing.assert_array_equal(r["ck"][0][k], v)
        for k, v in payload.items():
            np.testing.assert_array_equal(r["ck"][1][k], v)
    assert np.abs(payload["wall_hist"]).max() > 0
    assert np.abs(payload["hist"]).max() > 0
    p = tmp_path / "ranks.npz"
    rio.write_restart(p, State(**{k: torch.as_tensor(v) for k, v in gst.items()}),
                      None, sim.params, extra=payload)
    gstate2, _, params2, extra = rio.read_restart(p, device=cuda_device)
    resume.params = params2
    spec2 = ranks.spec_of(resume, gstate2,
                          [("run", "", resume_steps), ("snap", "end")],
                          restart={k: np.asarray(v) for k, v in extra.items()})
    out = [r[0] for r in ranks.spawn_ranks(
        ranks.run_specs, 2, "nccl", ["cuda:0", "cuda:1"], [spec2], timeout=600)]

    def by_tag(per, f):
        rows = {}
        for r in per:
            st = r["end"][0]
            for t, a, row in zip(st["tag"].reshape(-1), st["active"].reshape(-1),
                                 st[f].reshape((-1,) + st[f].shape[2:])):
                if a:
                    rows[int(t)] = row
        return rows

    xa, xb = by_tag(per_rank, "x"), by_tag(out, "x")
    va, vb = by_tag(per_rank, "v"), by_tag(out, "v")
    assert set(xa) == set(xb) and len(xa) == 48
    for t in xa:
        np.testing.assert_allclose(xb[t], xa[t], rtol=0, atol=2e-3)
        np.testing.assert_allclose(vb[t], va[t], rtol=0, atol=5e-3)
    assert all(int(r["end"][1]["overflow"].max()) == 0 for r in out)
    assert all(r["launches"]["wall_plane"] > 0 for r in per_rank + out)


def test_span_marks_replay_inside_nccl_rank_graphs(cuda_device):
    """With spans on, 4 NCCL ranks, one a card, replay the span marks
    inside their CUDA graphs (4 slabs on the cadence, 25 steps: 3 rebuild
    steps, 22 forward steps): on every rank each step opens ``pair`` and
    each forward step ``halo.forward``, each rebuild ``halo.exchange`` and
    ``halo.migrate``, the transfers ``comm.p2p`` and ``comm.collective``;
    every mark is matched, NCCL's kernels (the p2p's on NCCL's own
    stream) lie in the comm spans and 99 % of the device time in some
    span, the halo's counters count, and the run ends where the spans-off
    run ends, bit for bit. Skipped, and the skip printed, with fewer than
    4 cards."""
    from spherharm_tpu_torch.parallel import ranks

    _need_cards("test_span_marks_replay_inside_nccl_rank_graphs")
    sim, st, _, _ = _slab_sim(cuda_device, 4, False, 10)
    steps = 25
    spec = ranks.spec_of(sim, sim.gather_global(st),
                         [("spans", "on", steps), ("run", "", steps),
                          ("snap", "end")])
    spec["sim"]["cuda_graphs"] = True
    per_rank = ranks.spawn_ranks(ranks.run_specs, 4, "nccl",
                                 [f"cuda:{r}" for r in range(4)], [spec],
                                 timeout=600)
    for r in per_rank:
        out = r[0]
        summary = out["on"]["summary"]
        n = summary["spans_n"]
        assert summary["marks"] > 0 and summary["unmatched"] == 0
        assert n["pair"] == steps and n["halo.forward"] == steps - 3
        assert n["rebuild"] == n["halo.exchange"] == n["halo.migrate"] == 3
        assert n["comm.p2p"] > 0 and n["comm.collective"] > 0
        outside = summary["self_ops"].get("", {})
        assert not [k for k in outside if "nccl" in k.lower()], outside
        assert summary["coverage"] >= 0.99, outside
        nccl = {k: v for name, ops in summary["self_ops"].items()
                if name.startswith("comm.") for k, v in ops.items()
                if "nccl" in k.lower()}
        assert nccl and summary["span_s"]["comm.p2p"] > 0, summary["self_ops"]
        assert summary["group_s"]["halo"] > 0
        assert summary["group_s"]["comm"] > 0
        c = summary["counters"]
        assert c["halo.ghosts"] > 0 and c["halo.owned"] > 0
        assert c["halo.sent"] > 0
        for part_on, part_off in zip(out["on"]["end"], out["end"]):
            for f, v in part_off.items():
                if v is not None:
                    assert np.array_equal(part_on[f], v), f
