"""The yardstick of the port's kernel bounds, pinned without a card.

``chip_smoke.py`` computes each kernel's least time on the card from the
``node-flops[...]`` line beside the kernel's node loop in
``spherharm_tpu_torch/csrc`` and from ``horner_flops``, the FLOPs of one
surface evaluation counted from its loops. A redesign of a kernel must
keep that count (or change it here with its reason): these tests import
``chip_smoke`` on the CPU, where it builds nothing and writes no file.
"""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,bf16", [
    ("pair_contact_conservative", False),
    ("pair_contact_conservative_bf16", True),
])
def test_conservative_node_flops(smoke, name, bf16):
    """K1 / K3 conservative: 468 FLOPs of probe and gradient algebra a
    node, 2 surface evaluations with gradient, 2 sides."""
    assert smoke.node_flops()[name] == (468, 2, True, bf16, 2)


@pytest.mark.parametrize("name,bf16", [
    ("pair_contact_geometric", False),
    ("pair_contact_geometric_bf16", True),
])
def test_geometric_node_flops(smoke, name, bf16):
    """K2 / K3 geometric: 248 FLOPs of probe and normal algebra a node, 2
    surface evaluations with gradient, 2 sides."""
    assert smoke.node_flops()[name] == (248, 2, True, bf16, 2)


@pytest.mark.parametrize("bf16,flops", [(False, (441, 0)), (True, (155, 286))])
def test_horner_flops_at_lmax8(smoke, bf16, flops):
    """One radius_grad_power at Lmax 8: 441 FLOPs in f32; with bf16 the
    286 FLOPs of the Horner chains count at the bf16 rate."""
    assert smoke.horner_flops(8, bf16=bf16) == flops


def test_every_stage2_law_has_a_count(smoke):
    """Each stage-2 variant the launch counters name has its count."""
    table = smoke.node_flops()
    for law in ("conservative", "geometric"):
        for suffix in ("", "_bf16"):
            assert f"pair_contact_{law}{suffix}" in table


@pytest.mark.parametrize("name,per_node_s,lo,hi", [
    # K1 on the drum batch: 1,350 f32 FLOPs a node and side.
    ("pair_contact_conservative", (468 + 2 * 441) / 67e12, 0.082, 0.084),
    # K3 conservative on the gas batch: its 2 x 286 chain FLOPs at the
    # bf16 rate.
    ("pair_contact_conservative_bf16",
     (468 + 2 * 155) / 67e12 + 2 * 286 / 133.8e12, 0.064, 0.066),
])
def test_conservative_bound_unchanged(smoke, name, per_node_s, lo, hi):
    """The bound of 16,056 working rows of 128 nodes at Lmax 8 (the
    synthetic batches' live rows) stays where the run-time-degree kernel's
    count put it: K1 0.083 ms, K3 conservative 0.065 ms, both by
    operations."""
    b = smoke.bound(name, 8, 128, 16_056, 0)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(16_056 * 128 * 2 * per_node_s * 1e3)
    assert lo < b["bound_ms"] < hi


@pytest.mark.parametrize("name,per_node_s,lo,hi", [
    # K2 on the deposition batch: 1,130 f32 FLOPs a node and side.
    ("pair_contact_geometric", (248 + 2 * 441) / 67e12, 0.155, 0.157),
    # K3 geometric: its 2 x 286 chain FLOPs at the bf16 rate.
    ("pair_contact_geometric_bf16",
     (248 + 2 * 155) / 67e12 + 2 * 286 / 133.8e12, 0.116, 0.118),
])
def test_geometric_bound_unchanged(smoke, name, per_node_s, lo, hi):
    """The bound of 16,056 working rows of the deposition's 288 nodes at
    Lmax 8 stays where the run-time-degree kernel's count put it: K2 0.156
    ms, K3 geometric 0.117 ms, both by operations."""
    b = smoke.bound(name, 8, 288, 16_056, 0)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(16_056 * 288 * 2 * per_node_s * 1e3)
    assert lo < b["bound_ms"] < hi


@pytest.mark.parametrize("name,extra", [("wall_plane", 139), ("wall_cylinder", 155)])
def test_wall_node_flops(smoke, name, extra):
    """K7 / K6: the cap, normal and depth algebra of a node (the plane's
    depth a dot product, the cylinder's a radial distance and its normal),
    1 surface evaluation with gradient, 1 side."""
    assert smoke.node_flops()[name] == (extra, 1, True, False, 1)


@pytest.mark.parametrize("name,extra,lo,hi", [
    ("wall_cylinder", 155, 0.0102, 0.0104),
    ("wall_plane", 139, 0.0099, 0.0101),
])
def test_wall_bound_unchanged(smoke, name, extra, lo, hi):
    """The drum's wall batch: its wall capacity at n = 100,000 (9,072 rows,
    ``8 n rmax / R_drum``), every row near the wall, 128 nodes at Lmax 8:
    K6 0.0103 ms, K7 0.0101 ms, both by operations."""
    b = smoke.bound(name, 8, 128, 9_072, 0)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(9_072 * 128 * (extra + 441) / 67e12 * 1e3)
    assert lo < b["bound_ms"] < hi


@pytest.mark.parametrize("name,bf16", [
    ("stage1_depth", False),
    ("stage1_depth_l1", False),
    ("stage1_depth_l1_bf16", True),
])
def test_stage1_node_flops(smoke, name, bf16):
    """K4 / K5: 120 FLOPs of cap, rotation and direction algebra a node, 2
    r-only surface evaluations, 2 sides; K5 bf16 evaluates in bfloat16.
    The redesigned loop keeps the count: the bound prices the function."""
    assert smoke.node_flops()[name] == (120, 2, False, bf16, 2)


@pytest.mark.parametrize("lmax,bf16,flops", [
    (8, False, (210, 0)),
    (4, False, (70, 0)),
    (4, True, (0, 70)),
])
def test_horner_flops_r_only(smoke, lmax, bf16, flops):
    """One radius_power_ab: 210 FLOPs at Lmax 8 (K4), 70 at l1 4 (K5), all
    at the bf16 rate when K5 runs in bfloat16."""
    assert smoke.horner_flops(lmax, grad=False, bf16=bf16) == flops


def test_stage1_bound_unchanged(smoke):
    """K4 on the 16,384-pair batch of the drum's shapes: its 8,898 probed
    rows (the others dead or sphere-separated), 32 cap1 nodes, 2 sides at
    540 FLOPs a node and side: 0.00459 ms by operations, as the
    run-time-degree kernel's count put it."""
    b = smoke.bound("stage1_depth", 8, 32, 8_898, 0)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(8_898 * 32 * 2 * 540 / 67e12 * 1e3)
    assert 0.00458 < b["bound_ms"] < 0.00460


def test_ranking_prices_each_path_at_its_own_list(smoke):
    """A path's launches are priced at the path's own candidate list (the
    stage-1 probe), else its stage-2 list, else its batch; never at
    another path's case."""
    c = lambda path, dev, bnd, ms: dict(path=path, device_ms=dev, bound_ms=bnd, ms=ms)
    kern = {
        "stage1_depth": [c("drum", 0.05, 0.004, 0.06), c("drum candidate list", 0.03, 0.01, 0.04),
                         c("drift gas candidate list", 0.01, 0.002, 0.02)],
        "pair_contact_conservative": [c("drum", 0.3, 0.1, 0.31),
                                      c("drift gas stage-2 list", 0.4, 0.1, 0.42)],
        "wall_plane": [c("drum", 0.04, 0.01, 0.08)],
    }
    counted = {"stage1_depth": [("drum", 3), ("drift gas", 2)],
               "pair_contact_conservative": [("drum", 60), ("drift gas", 100)],
               "wall_plane": [("settling box", 10)]}
    loss = smoke.ranking(kern, counted)
    assert loss["stage1_depth"] == pytest.approx((3 * 0.02 + 2 * 0.008,
                                                  3 * 0.03 + 2 * 0.018))
    assert loss["pair_contact_conservative"] == pytest.approx((60 * 0.2 + 100 * 0.3,
                                                               60 * 0.21 + 100 * 0.32))
    assert loss["wall_plane"] == pytest.approx((10 * 0.03, 10 * 0.07))
    assert smoke.path_case(kern["stage1_depth"], "drum")["path"] == "drum candidate list"
