"""Scenario builders (torch twin of ``spherharm_tpu/models/scenarios.py``).

Setup randomness comes from ``numpy.random.default_rng(seed)`` in exactly
the reference's order, so both packages build bit-identical inputs. Each
builder returns (Simulation, State, NeighborState) ready to ``run``.
"""

from __future__ import annotations

import numpy as np
import torch

from spherharm_tpu_torch.core.simulation import Simulation
from spherharm_tpu_torch.core.state import SimParams, State, zeros_state
from spherharm_tpu_torch.models import shapes_library
from spherharm_tpu_torch.ops.neighbor import CellGrid
from spherharm_tpu_torch.ops.walls import CylinderWall, PlaneWall
from spherharm_tpu_torch.parallel.halo import ShardedSimulation

# Builders take the reference's arguments less its ``use_pallas`` /
# ``exact_eval`` / ``pair_chunk`` switches (the port always evaluates
# exactly, through the kernels) and the slab decomposition's ``mesh`` /
# ``cap_local`` / ``halo_cap``, plus ``device``.


def make_state(x, box_lo, box_hi, *, v=None, q=None, angmom=None,
               scale=None, shtype=None, cap=None, tilt=None,
               dtype=torch.float32, device="cuda") -> State:
    """Pack numpy arrays into a fixed-capacity State (extra slots
    inactive); ``tilt`` the triclinic (xy, xz, yz)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    cap = cap or n
    st = zeros_state(cap, box_lo, box_hi, dtype, device)
    if tilt is not None:
        st = st.replace(tilt=torch.as_tensor(
            np.asarray(tilt, np.float64), dtype=dtype, device=device))

    def put(field, val):
        field = field.clone()
        field[:n] = torch.tensor(np.asarray(val), dtype=field.dtype,
                                 device=device)
        return field

    st = st.replace(
        x=put(st.x, x),
        tag=put(st.tag, np.arange(1, n + 1)),
        active=put(st.active, np.ones(n, bool)),
    )
    for name, val in (("v", v), ("q", q), ("angmom", angmom),
                      ("scale", scale), ("shtype", shtype)):
        if val is not None:
            st = st.replace(**{name: put(getattr(st, name), val)})
    return st


def two_body_collision(
    radius: float = 0.5,
    v0: float = 1.0,
    kn: float = 1.0e5,
    gamma_n: float = 0.0,
    dt: float = 2.0e-4,
    gap: float = 0.2,
    contact_quad=(12, 24),
    conservative: bool = True,
    dtype=torch.float32,
    device="cuda",
):
    """Config 1: two Lmax=0 sphere-degenerate SH particles, head-on NVE
    collision with Hertzian normal contact (all-pairs neighbours, dense
    force path)."""
    lmax = 0
    shapes = shapes_library.build_shapes(
        [shapes_library.sphere_coeffs(radius, lmax)], lmax, density=1.0,
        contact_quad=contact_quad, dtype=dtype, device=device)
    params = SimParams.create(
        dt=dt, kn=kn, gamma_n=gamma_n, mu=0.0,
        skin=0.1 * radius, cutoff=2.0 * radius * 1.05, dtype=dtype,
        device=device)
    half = radius + gap / 2
    box = 4 * radius
    state = make_state(
        [[-half, 0.0, 0.0], [half, 0.0, 0.0]],
        [-box, -box, -box], [box, box, box],
        v=[[v0, 0.0, 0.0], [-v0, 0.0, 0.0]], dtype=dtype, device=device)
    sim = Simulation(shapes, params, neighbor_mode="allpairs", k_max=1,
                     conservative=conservative, device=device)
    state, neigh = sim.init_neighbors(state)
    return sim, state, neigh


def settling_box(
    n: int = 500,
    lmax: int = 2,
    aspect=(1.0, 0.8, 0.65),
    mean_radius: float = 0.5,
    kn: float = 1.0e5,
    gamma_n: float = 50.0,
    mu: float = 0.3,
    dt: float = 1.0e-4,
    box_side: float | None = None,
    seed: int = 0,
    k_max: int = 32,
    conservative: bool = False,
    dtype=torch.float32,
    device="cuda",
):
    """Config 2: ~500 Lmax=2 ellipsoid-like particles settling under
    gravity into a box with 5 plane walls, Hertz + Coulomb friction,
    dense [N, K] force path. Damped: the geometric law by default."""
    a = mean_radius * np.asarray(aspect) / np.cbrt(np.prod(aspect))
    shapes = shapes_library.build_shapes(
        [shapes_library.ellipsoid_coeffs(a[0], a[1], a[2], lmax)], lmax,
        density=1.0, contact_quad=(8, 16), dtype=dtype, device=device)
    rmax = float(shapes.rmax[0])
    side_cells = int(np.ceil(n ** (1 / 3)))
    if box_side is None:
        # Loose lattice that settles to roughly a half-full box.
        box_side = 2.2 * rmax * side_cells
    rng = np.random.default_rng(seed)
    pitch = 2.05 * rmax
    i = np.arange(n)
    x = np.stack([
        (i % side_cells + 0.5) * pitch - box_side / 2,
        ((i // side_cells) % side_cells + 0.5) * pitch - box_side / 2,
        (i // side_cells**2 + 0.5) * pitch + rmax,
    ], axis=1) + rng.uniform(-0.05, 0.05, (n, 3)) * rmax
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    height = box_side + pitch * (n // side_cells**2 + 2)
    box_lo = (-box_side / 2, -box_side / 2, 0.0)
    box_hi = (box_side / 2, box_side / 2, height)

    params = SimParams.create(
        dt=dt, kn=kn, gamma_n=gamma_n, mu=mu, gravity=(0.0, 0.0, -10.0),
        skin=0.4 * rmax, cutoff=2.0 * rmax, dtype=dtype, device=device)
    grid = CellGrid(box_lo, box_hi, 2.0 * rmax + 0.4 * rmax)
    wk = dict(dtype=dtype, device=device)
    walls = (
        PlaneWall.create((0, 0, 0), (0, 0, 1), **wk),
        PlaneWall.create((-box_side / 2, 0, 0), (1, 0, 0), **wk),
        PlaneWall.create((box_side / 2, 0, 0), (-1, 0, 0), **wk),
        PlaneWall.create((0, -box_side / 2, 0), (0, 1, 0), **wk),
        PlaneWall.create((0, box_side / 2, 0), (0, -1, 0), **wk),
    )
    state = make_state(x, box_lo, box_hi, q=q, dtype=dtype, device=device)
    sim = Simulation(shapes, params, neighbor_mode="cell", grid=grid,
                     k_max=k_max, cell_cap=12, walls=walls,
                     conservative=conservative, device=device)
    state, neigh = sim.init_neighbors(state)
    return sim, state, neigh


def rotating_drum(
    n: int = 100_000,
    lmax: int = 8,
    mean_radius: float = 0.5,
    poly_spread: float = 0.25,
    n_shape_types: int = 4,
    drum_radius_factor: float | None = None,
    drum_omega: float = 0.5,
    kn: float = 1.0e5,
    gamma_n: float = 50.0,
    mu: float = 0.5,
    k_roll: float = 2.0e4,
    gamma_roll: float = 20.0,
    mu_roll: float = 0.2,
    dt: float = 1.0e-4,
    seed: int = 0,
    k_max: int = 24,
    pair_capacity: int | None = None,
    contact_quad=(8, 16),
    rebuild_every: int = 0,
    stage2_capacity: int = 0,
    conservative: bool = True,
    rebuild_chunk: int | None = None,
    dtype=torch.float32,
    device="cuda",
):
    """Config 4: N polydisperse Lmax=8 blobs in a rotating drum, friction +
    rolling, full neighbour-rebuild cadence: the main path."""
    rng = np.random.default_rng(seed)
    coeffs = np.stack([
        shapes_library.blob_coeffs(lmax, seed=seed + t,
                                   mean_radius=mean_radius, roughness=0.12)
        for t in range(n_shape_types)
    ])
    shapes = shapes_library.build_shapes(
        coeffs, lmax, density=1.0, contact_quad=contact_quad, dtype=dtype,
        device=device)
    rmax = float(shapes.rmax.max()) * (1 + poly_spread)

    # Drum: axis along y, length = radius, sized so the initial simple-cubic
    # packing (pitch 2.05*rmax) fills ~40% of the cross-section.
    pitch = 2.05 * rmax
    if drum_radius_factor is None:
        R_drum = pitch * (2.5 * n / np.pi) ** (1 / 3)
    else:
        R_drum = drum_radius_factor * rmax
    L_drum = R_drum

    # Initial loose packing from the bottom of the drum up.
    nx = int(2 * R_drum / pitch) - 1
    ny = int(L_drum / pitch)
    px = -R_drum + (np.arange(nx) + 0.5) * pitch
    py = -L_drum / 2 + (np.arange(ny) + 0.5) * pitch
    layers = []
    count = 0
    z = -R_drum + pitch
    while count < n and z < R_drum:
        inside = px**2 + z**2 < (R_drum - pitch) ** 2
        gx, gy = np.meshgrid(px[inside], py, indexing="ij")
        layer = np.stack([gx.ravel(), gy.ravel(),
                          np.full(gx.size, z)], axis=1)
        layers.append(layer)
        count += layer.shape[0]
        z += pitch
    if count < n:
        raise ValueError(
            f"drum too small: packed {count} < {n}; raise drum_radius_factor")
    x = np.concatenate(layers)[:n] + rng.uniform(-0.02, 0.02, (n, 3)) * rmax
    scale = rng.uniform(1 - poly_spread, 1 + poly_spread, n)
    shtype = rng.integers(0, n_shape_types, n)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)

    box = R_drum * 1.1
    box_lo = (-box, -L_drum / 2 - rmax, -box)
    box_hi = (box, L_drum / 2 + rmax, box)
    params = SimParams.create(
        dt=dt, kn=kn, gamma_n=gamma_n, mu=mu,
        k_roll=k_roll, gamma_roll=gamma_roll, mu_roll=mu_roll,
        gravity=(0.0, 0.0, -10.0),
        skin=0.4 * rmax, cutoff=2.0 * rmax, dtype=dtype, device=device,
    )
    grid = CellGrid(box_lo, box_hi, 2.4 * rmax)
    wk = dict(dtype=dtype, device=device)
    walls = (
        CylinderWall.create((0, 0, 0), (0, 1, 0), R_drum, omega=drum_omega,
                            **wk),
        PlaneWall.create((0, -L_drum / 2, 0), (0, 1, 0), **wk),
        PlaneWall.create((0, L_drum / 2, 0), (0, -1, 0), **wk),
    )
    state = make_state(x, box_lo, box_hi, q=q, scale=scale, shtype=shtype,
                       dtype=dtype, device=device)
    if pair_capacity is None:
        pair_capacity = 10 * n
    # Near-wall fraction ~ (shell area * rmax) / drum volume.
    wall_cap = max(1024, min(n, int(8.0 * n * rmax / R_drum)))
    sim = Simulation(
        shapes, params, grid=grid, k_max=k_max, cell_cap=10, walls=walls,
        pair_capacity=pair_capacity, rebuild_every=rebuild_every,
        wall_capacity=wall_cap, stage2_capacity=stage2_capacity,
        rebuild_chunk=rebuild_chunk, conservative=conservative,
        device=device,
    )
    state, neigh = sim.init_neighbors(state)
    return sim, state, neigh


def deposition(n: int = 10_000, lmax: int = 8, contact_quad=(12, 24), **kw):
    """Config 3: deposition of scanned-shape Lmax=8 particles with the
    high-order 12x24 cap grid: the drum's geometry, not spinning. Damped:
    the geometric law by default."""
    kw.setdefault("conservative", False)
    return rotating_drum(n=n, lmax=lmax, drum_omega=0.0,
                         contact_quad=contact_quad, **kw)


def triaxial_cell(
    n: int = 512,
    lmax: int = 4,
    mean_radius: float = 0.5,
    fill_fraction: float = 0.35,
    strain_rate=(-0.05, -0.05, -0.05),
    shear_rate=(0.0, 0.0, 0.0),
    press_target: float = 0.0,
    press_tau: float = 0.0,
    kn: float = 1.0e5,
    gamma_n: float = 50.0,
    mu: float = 0.4,
    dt: float = 1.0e-4,
    seed: int = 0,
    k_max: int = 32,
    n_shape_types: int = 2,
    deform_min: float = 0.6,
    dtype=torch.float32,
    sharded: bool = False,
    n_shards: int | None = None,
    cap_local: int = 0,
    halo_cap: int = 0,
    conservative: bool = False,
    device="cuda",
    axis=None,
    cuda_graphs: bool = True,
):
    """Config 5: triaxial shear cell, periodic on every axis, with
    stress-tensor output. The diagonal strain rate compresses the cell
    about its centre; a nonzero ``shear_rate`` shears it (triclinic, with
    the tilt flip); ``press_tau > 0`` turns on the Berendsen servo toward
    ``press_target``. The grid's cells are sized for the box at
    ``deform_min`` of its start (1.4x wider when triclinic: binning runs
    in the unsheared frame). Geometric law by default.

    ``sharded=True`` builds the slab-decomposed variant instead
    (``parallel/halo.ShardedSimulation``, ``n_shards`` slabs along x on
    the leading axis, default 4; no servo, as in the reference) with the
    reference's capacities: cap_local 4n/S, halo_cap 2n/S (each at least
    64, or as given), pair cap 12n/S, cell_cap 12 and a tilt pad of 0.12
    box when sheared; ``axis`` a rank's ``parallel/halo.RankAxis`` runs
    one slab a process (S its ranks unless given). Returns (sim, state,
    neigh, ghosts) then. ``cuda_graphs`` as ``Simulation``'s."""
    rng = np.random.default_rng(seed)
    coeffs = np.stack([
        shapes_library.blob_coeffs(lmax, seed=seed + 100 + t,
                                   mean_radius=mean_radius, roughness=0.10)
        for t in range(n_shape_types)
    ])
    shapes = shapes_library.build_shapes(coeffs, lmax, density=1.0,
                                         dtype=dtype, device=device)
    rmax = float(shapes.rmax.max())

    # Cubic periodic cell sized for the target initial solid fraction.
    vol_mean = float(shapes.vol.mean())
    box = (n * vol_mean / fill_fraction) ** (1 / 3)
    side = int(np.ceil(n ** (1 / 3)))
    pitch = box / side
    if pitch < 2.0 * rmax:
        raise ValueError("fill_fraction too high for non-overlapping start")
    i = np.arange(n)
    x = np.stack([(i % side + 0.5) * pitch, ((i // side) % side + 0.5) * pitch,
                  (i // side**2 + 0.5) * pitch], axis=1)
    x = x + rng.uniform(-0.05, 0.05, (n, 3)) * rmax
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.normal(size=(n, 3)) * 0.05
    shtype = rng.integers(0, n_shape_types, n)

    params = SimParams.create(
        dt=dt, kn=kn, gamma_n=gamma_n, mu=mu,
        skin=0.4 * rmax, cutoff=2.0 * rmax,
        deform_rate=strain_rate, shear_rate=shear_rate,
        press_target=(press_target,) * 3, press_tau=press_tau,
        dtype=dtype, device=device)
    state = make_state(x, [0, 0, 0], [box, box, box], v=v, q=q,
                       shtype=shtype, dtype=dtype, device=device)
    periodic = (True, True, True)
    triclinic = any(abs(r) > 0 for r in shear_rate)
    if sharded:
        if n_shards is None:
            n_shards = 4 if axis is None else axis.n_shards
        sim = ShardedSimulation(
            shapes, params, n_shards=n_shards, box_lo=(0, 0, 0),
            box_hi=(box, box, box),
            cap_local=cap_local or max(4 * n // n_shards, 64),
            halo_cap=halo_cap or max(2 * n // n_shards, 64),
            periodic=periodic, k_max=k_max, cell_cap=12,
            pair_capacity=max(12 * n // n_shards, 256),
            deform_min=deform_min, triclinic=triclinic,
            conservative=conservative,
            # covers |xy| up to 12% of the box
            tilt_pad=0.12 * box if triclinic else 0.0, device=device,
            axis=axis, cuda_graphs=cuda_graphs)
        return (sim,) + sim.init(state)
    grid = CellGrid([0, 0, 0], [box * deform_min] * 3,
                    2.4 * rmax * (1.4 if triclinic else 1.0), periodic)
    sim = Simulation(
        shapes, params, periodic=periodic, neighbor_mode="cell", grid=grid,
        k_max=k_max, cell_cap=16, pair_capacity=max(12 * n, 512),
        press_control=press_tau > 0, triclinic=triclinic,
        conservative=conservative, device=device, cuda_graphs=cuda_graphs)
    state, neigh = sim.init_neighbors(state)
    return sim, state, neigh
