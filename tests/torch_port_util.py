"""Helpers shared by the torch-port parity tests (tests/test_torch_*.py).

Inputs are made once with numpy and handed to both packages; containers
of the JAX reference cross over through ``from_numpy``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

# Tier-1 runs several pytest-xdist workers on one host: a torch pool per
# worker as wide as the host oversubscribes the cores (measured 8x slower
# on 8 cores and 6 workers). Single-process runs keep the full pool.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def load_script(name: str):
    """The reference's ``scripts/<name>.py`` loaded by path as a module (the
    port keeps its own copy of each harness and imports none of them)."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"{name}_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_torch(cls, jax_obj, device="cpu"):
    """Convert a reference (flax) container to the port's ``cls``."""
    return cls.from_numpy(
        {f.name: getattr(jax_obj, f.name) for f in dataclasses.fields(jax_obj)},
        device=device)


def np32(t):
    """Tensor -> float32/int/bool numpy array."""
    return t.detach().cpu().numpy()


def f32_ulps_from(x, k):
    """The f32 value k ulps above (k < 0: below) the f32 value x."""
    x = np.float32(x)
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.inf if k > 0 else -np.inf), dtype=np.float32)
    return x


def blob_coeffs(lmax: int, n_types: int, seed: int = 0):
    from spherharm_tpu_torch.models import shapes_library

    return np.stack([
        shapes_library.blob_coeffs(lmax, seed=seed + t, mean_radius=0.5,
                                   roughness=0.12)
        for t in range(n_types)
    ])


def contact_rich_state(x, radius, R, L, c=0.84, press=0.04, seed=1):
    """A contact-rich start for the rotating drum (axis along y through the
    origin, radius R, end caps at y = +-L/2) from its loose packing x:
    compress x/z by c about the packing's centre, map y so the outermost
    particles press both end caps, lower the packing onto the cylinder.
    ``radius``: per-particle rchar * scale. Returns (x, random angmom)."""
    x = np.array(x, np.float64)
    ctr = x.mean(0)
    x[:, [0, 2]] = ctr[[0, 2]] + c * (x[:, [0, 2]] - ctr[[0, 2]])
    y = x[:, 1].copy()
    i_lo, i_hi = np.argmin(y - radius), np.argmax(y + radius)
    for _ in range(4):  # y' = a y + b with the extreme extents on the caps
        a = (L + 2 * press - radius[i_lo] - radius[i_hi]) / (y[i_hi] - y[i_lo])
        b = -0.5 * L - press + radius[i_lo] - a * y[i_lo]
        i_lo = np.argmin(a * y + b - radius)
        i_hi = np.argmax(a * y + b + radius)
    x[:, 1] = a * y + b
    # z: lower until the deepest particle presses into the shell.
    h_lo, h_hi = 0.0, R
    for _ in range(60):
        h = 0.5 * (h_lo + h_hi)
        reach = np.hypot(x[:, 0], x[:, 2] - h) + radius
        h_lo, h_hi = (h, h_hi) if reach.max() < R + press else (h_lo, h)
    x[:, 2] -= h_lo
    rng = np.random.default_rng(seed)
    return x, rng.normal(size=x.shape) * 0.01


def drum_state(sim, st0, device):
    """The port's State of ``contact_rich_state`` for a drum or deposition
    ``sim`` from its builder state ``st0``."""
    from spherharm_tpu_torch.models import scenarios

    sh = np32(st0.shtype)
    sc = np32(st0.scale).astype(np.float64)
    radius = np32(sim.shapes.rchar).astype(np.float64)[sh] * sc
    R = float(sim.walls[0].radius)
    L = float(sim.walls[2].point[1] - sim.walls[1].point[1])
    x, angmom = contact_rich_state(np32(st0.x), radius, R, L)
    return scenarios.make_state(x, np32(st0.box_lo), np32(st0.box_hi),
                                q=np32(st0.q), angmom=angmom, scale=sc,
                                shtype=sh, device=device)


def pressed_box_state(x, rmax, c=0.88, floor=0.75, seed=1):
    """A contact-rich start for the settling box (floor at z = 0, box
    centred on the z axis) from its loose lattice x: shrink the lattice by
    c about its bottom centre, so neighbours overlap, and lower it until
    the bottom layer's centres sit ``floor * rmax`` above the floor, so
    most of that layer presses into it. Returns (x, random angmom)."""
    x = np.array(x, np.float64)
    x[:, :2] *= c
    x[:, 2] = c * (x[:, 2] - x[:, 2].min()) + floor * rmax
    rng = np.random.default_rng(seed)
    return x, rng.normal(size=x.shape) * 0.01


def triaxial_start(x, box_lo, box_hi, rchar, overlap=0.05, c_min=0.6):
    """A contact-rich start for the triaxial cell from its jittered cubic
    lattice x (``ceil(n^(1/3))`` sites a side in the cube [box_lo,
    box_hi]): compress positions and box affinely about the centre by
    c = (1 - overlap) * 2 rchar / pitch, so lattice neighbours overlap
    by about ``overlap`` of a diameter, but never below ``c_min`` (the
    ``deform_min`` of ``triaxial_cell``: below it the fixed CellGrid's
    cells shrink under the cutoff). Returns (x, box_lo, box_hi, c)."""
    x = np.array(x, np.float64)
    lo = np.asarray(box_lo, np.float64)
    hi = np.asarray(box_hi, np.float64)
    pitch = (hi[0] - lo[0]) / int(np.ceil(x.shape[0] ** (1 / 3)))
    c = max(c_min, (1.0 - overlap) * 2.0 * rchar / pitch)
    ctr = 0.5 * (lo + hi)
    return (ctr + c * (x - ctr), ctr + c * (lo - ctr), ctr + c * (hi - ctr),
            c)


def triaxial_state(st0, device, overlap=0.02, xy_frac=0.0):
    """The port's State of ``triaxial_start`` from ``triaxial_cell``'s
    state ``st0`` (rchar 0.5, its blobs'), its xy tilt ``xy_frac`` Lx
    (just under 0.5: the shear flips it soon). Returns (State, c)."""
    from spherharm_tpu_torch.models import scenarios

    x, lo, hi, c = triaxial_start(np32(st0.x), np32(st0.box_lo),
                                  np32(st0.box_hi), 0.5, overlap=overlap)
    return scenarios.make_state(
        x, lo, hi, v=np32(st0.v), q=np32(st0.q), shtype=np32(st0.shtype),
        tilt=[xy_frac * (hi[0] - lo[0]), 0.0, 0.0], device=device), c


def on_cpu(container, dtype):
    """A copy of a tensor container on the CPU, its floating-point
    tensors in ``dtype``."""
    kw = {}
    for f in dataclasses.fields(container):
        v = getattr(container, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v.to("cpu", dtype) if v.is_floating_point() else v.cpu()
    return container.replace(**kw)


def jax_f64(container):
    """A copy of a reference (flax) container with every floating-point
    array in float64 (``jax_enable_x64`` on); ``on_cpu`` is the port's."""
    kw = {}
    for f in dataclasses.fields(container):
        v = getattr(container, f.name)
        if np.issubdtype(getattr(v, "dtype", np.int8), np.floating):
            kw[f.name] = v.astype(np.float64)
    return container.replace(**kw)


def slab_drift_system(S, wall=False):
    """A slab system whose first rebuilds migrate particles: the tiny
    system of ``__graft_entry__.dryrun_multichip`` (16 S particles in a
    4S x 4 x 4 box; S slabs of width 4) with a +x drift of 2 and one
    particle per slab boundary moved 0.01 left of it; with ``wall`` a
    layer on a floor at z = 0 (centres 0.35-0.5 up, no vz), x and z not
    periodic. Returns (x, v, box, periodic) as numpy."""
    rng = np.random.default_rng(0)
    n = 16 * S
    box = np.array([4.0 * S, 4.0, 4.0])
    x = rng.uniform(0.6, box[0] - 0.6, (n, 3))
    x[:, 1] %= 4.0
    x[:, 2] %= 4.0
    v = rng.normal(size=(n, 3)) * 0.3
    v[:, 0] += 2.0
    if wall:
        x[:, 2] = rng.uniform(0.35, 0.5, n)
        v[:, 2] = 0.0
        bounds = [4.0 * k for k in range(1, S)]
        periodic = (False, True, False)
    else:
        bounds = [4.0 * k for k in range(S)]
        periodic = (True, True, True)
    taken = set()
    for b in bounds:
        gap = (b - x[:, 0]) % box[0]
        for i in np.argsort(gap):
            if i not in taken:
                taken.add(i)
                x[i, 0] = (b - 0.01) % box[0]
                break
    return x, v, box, periodic


EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def deck_setup_and_rest(text):
    """Split a deck before its first ``run`` or ``label`` line."""
    m = re.search(r"^(run|label)\b", text, re.M)
    return text[:m.start()], text[m.start():]


def cut_deck(text, out_dir, run, thermo, dump_every=None, subs=()):
    """An example deck cut to size: ``subs`` (old, new) replaced verbatim
    first, then each ``run`` to ``run`` steps, the thermo and dump cadences
    (dump: ``thermo``'s unless given) shortened, dump files from ``/tmp/``
    into ``out_dir``, and the example data file by absolute path."""
    dump_every = dump_every or thermo
    for old, new in subs:
        if old not in text:
            raise ValueError(f"cut_deck: {old!r} not in the deck")
        text = text.replace(old, new)
    text = re.sub(r"^run\s+\d+", f"run {run}", text, flags=re.M)
    text = re.sub(r"^thermo\s+\d+", f"thermo {thermo}", text, flags=re.M)
    text = re.sub(r"^(dump\s+\S+\s+\S+\s+custom\s+)\d+\s+/tmp/",
                  rf"\g<1>{dump_every} {out_dir}/", text, flags=re.M)
    return text.replace("examples/two_body.data",
                        str(EXAMPLES / "two_body.data"))


# Two deck runs of one deck held together (tests/test_torch_drum.py's
# multi-step tolerances): thermo within DECK_RTOL |ref| + DECK_ATOL,
# positions within DECK_DX.
DECK_RTOL, DECK_ATOL, DECK_DX = 2e-3, 1e-9, 1e-3


def by_tag(state, field):
    """A state field's active rows in tag order, either package's state."""
    from spherharm_tpu_torch.core.state import to_numpy

    act = to_numpy(state.active)
    tag = to_numpy(state.tag)[act]
    return to_numpy(getattr(state, field))[act][np.argsort(tag)]


def compare_deck_runs(ref, run, keys=("etot", "ke", "pe_pair")):
    """Hold deck runner ``run`` to ``ref`` after the same deck (either
    package's runners): the same thermo steps and atom counts, the same
    final step, the same ids and atom counts in every frame of every dump
    (at least 2 frames each). Returns the worst errors: for each thermo
    key, |run - ref| / (|ref| + DECK_ATOL / DECK_RTOL) over the rows (at
    most DECK_RTOL exactly when every row is within DECK_RTOL |ref| +
    DECK_ATOL); "x", max |dx| of the final positions by tag; "dump_x",
    of the positions in each dump's last frame; "frames", the frames
    read; "ok", every error within its tolerance."""
    from spherharm_tpu_torch.io.dump import read_dump

    rows_r, rows = ref.thermo_log.rows, run.thermo_log.rows
    assert len(rows) == len(rows_r) >= 2, (len(rows), len(rows_r))
    assert all(a["step"] == b["step"] and a["n"] == b["n"]
               for a, b in zip(rows_r, rows)), "thermo steps or atom counts differ"
    assert int(run.state.step) == int(ref.state.step)
    err = {k: max(abs(b[k] - a[k]) / (abs(a[k]) + DECK_ATOL / DECK_RTOL)
                  for a, b in zip(rows_r, rows)) for k in keys}
    err["x"] = float(np.abs(by_tag(run.state, "x") - by_tag(ref.state, "x")).max())
    err["dump_x"], err["frames"] = 0.0, 0
    assert len(run.dumps) == len(ref.dumps)
    for (_, path_r, _, _), (_, path, _, _) in zip(ref.dumps, run.dumps):
        fr, f = read_dump(path_r), read_dump(path)
        assert len(f) == len(fr) >= 2, (len(f), len(fr))
        for a, b in zip(fr, f):
            assert a["step"] == b["step"] and a["n"] == b["n"]
            np.testing.assert_array_equal(b["data"]["id"], a["data"]["id"])
        err["dump_x"] = max(err["dump_x"], *(
            float(np.abs(f[-1]["data"][c] - fr[-1]["data"][c]).max())
            for c in ("x", "y", "z")))
        err["frames"] += len(f)
    err["ok"] = (all(err[k] <= DECK_RTOL for k in keys)
                 and err["x"] <= DECK_DX and err["dump_x"] <= DECK_DX)
    return err


@pytest.fixture
def cuda_device():
    """The card for a ``cuda``-marked test; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def brick_drift_system(mesh_shape, wall=False, bounds=None, box_z=6.0):
    """A brick system whose first rebuilds migrate particles along every
    mesh axis, diagonally too: 16 S particles in a box of 4 (Sx, Sy, Sz)
    (z ``box_z`` on a 2D brick) drifting (2, 1.5, 1) (no z drift on a 2D
    brick), with one particle 0.01 below each brick boundary of each
    axis (the periodic seam's included) moving 2.5 across it, and one
    0.01 below each crossing of an x and a y boundary, moving (2.5, 2.5,
    0), so it changes brick along both; each of those placed along its
    free axis where it is farthest from the others, so that no collision
    turns it back. ``bounds``: {axis: box fractions}, uniform where not
    given; with ``wall`` a layer on a floor at z = 0 (centres 0.35-0.5
    up, no vz), x and z not periodic. Returns (x, v, box, periodic) as
    numpy."""
    rng = np.random.default_rng(0)
    shape = tuple(mesh_shape)
    grid = shape + (1,) * (3 - len(shape))
    n = 16 * int(np.prod(shape))
    box = np.array([4.0 * grid[0], 4.0 * grid[1],
                    4.0 * grid[2] if len(shape) == 3 else box_z])
    x = rng.uniform(0.6, box - 0.6, (n, 3))
    v = rng.normal(size=(n, 3)) * 0.3
    v += [2.0, 1.5, 1.0 if len(shape) == 3 else 0.0]
    periodic = (not wall, True, not wall)
    if wall:
        x[:, 2] = rng.uniform(0.35, 0.5, n)
        v[:, 2] = 0.0
    fracs = {ax: np.asarray((bounds or {}).get(
        ax, np.linspace(0.0, 1.0, p + 1))) for ax, p in zip("xyz", shape)}
    # The boundaries a drifting particle crosses: interior ones, and the
    # seam (0) where the axis is periodic.
    cuts = {ax: [f * box[d] for f in fracs[ax][1:-1]]
            + ([0.0] if periodic[d] else [])
            for d, ax in enumerate("xyz") if ax in fracs}
    taken = []

    def place(axes, b, vel):
        gap = sum(((bb - x[:, d]) % box[d]) for d, bb in zip(axes, b))
        i = next(i for i in np.argsort(gap) if i not in taken)
        taken.append(i)
        x[i, list(axes)] = [(bb - 0.01) % box[d] for d, bb in zip(axes, b)]
        v[i, list(axes)] = vel
        free = next(d for d in (2, 0, 1) if d not in axes)
        if wall and free == 2:
            return
        others = np.delete(x, i, axis=0)
        cand = np.linspace(0.6, box[free] - 0.6, 41)
        trial = np.repeat(x[i][None], cand.size, 0)
        trial[:, free] = cand
        d = trial[:, None] - others[None]
        d -= box * np.round(d / box)
        x[i, free] = cand[np.argmax(np.linalg.norm(d, axis=-1).min(1))]

    for d, ax in enumerate("xyz"):
        for b in cuts.get(ax, []):
            place((d,), (b,), 2.5)
    for bx in cuts["x"]:
        for by in cuts["y"]:
            place((0, 1), (bx, by), 2.5)
            v[taken[-1], 2] = 0.0
    return x, v, box, periodic


def floor_layers(device="cpu"):
    """tests/test_torch_halo_runs.py's restart system on ``device``: two
    layers of Lmax-2 ellipsoids on a plane floor under gravity. Returns
    (the 4-slab sim, the global start, the 2-slab sim a restart resumes
    on)."""
    from spherharm_tpu_torch.core.state import SimParams
    from spherharm_tpu_torch.models import scenarios, shapes_library
    from spherharm_tpu_torch.ops.walls import PlaneWall
    from spherharm_tpu_torch.parallel.halo import ShardedSimulation

    rng = np.random.default_rng(6)
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, 2)], 2,
        contact_quad=(6, 12), device=device)
    box = 8.0
    pts = [[(i % 6) * 1.3 + 0.7 + 0.08 * layer, (i // 6) * 1.3 + 0.7, z]
           for layer, z in enumerate((0.46, 1.32)) for i in range(24)]
    x = np.asarray(pts) + rng.uniform(-0.03, 0.03, (48, 3))
    v = rng.normal(size=(48, 3)) * 0.1
    params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=30.0, mu=1.0,
                              gravity=(0.0, 0.0, -5.0), cutoff=1.2, skin=0.3,
                              device=device)
    state = scenarios.make_state(x, [0, 0, 0], [box, box, 4.0], v=v,
                                 device=device)
    kw = dict(box_lo=(0, 0, 0), box_hi=(box, box, 4.0), migrate_cap=16,
              periodic=(True, True, False), k_max=16, cell_cap=12,
              pair_capacity=512, conservative=False, device=device,
              walls=(PlaneWall.create((0, 0, 0), (0, 0, 1), device=device),))
    sim = ShardedSimulation(shapes, params, n_shards=4, cap_local=48,
                            halo_cap=32, **kw)
    resume = ShardedSimulation(shapes, params, n_shards=2, cap_local=64,
                               halo_cap=48, **kw)
    return sim, state, resume
