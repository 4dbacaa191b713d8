"""Core containers: State, Shapes, NeighborState, SimParams.

Torch twin of ``spherharm_tpu/core/state.py``: dataclasses of tensors with
a ``replace`` method in place of flax structs. Fixed capacity everywhere:
``State`` holds ``cap`` particle slots with an ``active`` mask, and
``NeighborState`` holds a fixed-K neighbour tensor plus fixed-capacity pair
lists, so every shape is static across steps.

Index-like fields (types, tags, neighbour and pair indices) are int64, the
dtype torch indexing and scatter ops take; float fields are f32.

``from_numpy`` on each container takes a mapping of field name -> array
(for example the leaves of the reference package's containers, converted
with ``np.asarray``) and builds the torch container on ``device``. Every
builder here defaults to ``device="cuda"``: the CPU is asked for by name.

Replica ensembles (``parallel/ensemble.py``) stack the containers along a
new leading replica axis: every State / NeighborState / SimParams tensor
gains a leading ``[R]``, 0-d ones included, and the ops take either form
(``per_replica`` and ``take`` are their two idioms). A stacked pytree of
the reference package (numpy leaves with the replica axis) converts
through ``from_numpy`` as a single one does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields

import numpy as np
import torch


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int64), device=device)
    return torch.tensor(a.astype(np.float32), device=device)


def to_numpy(a):
    """A tensor (on any device) or array-like as a numpy array on the host:
    the inverse of ``from_numpy``'s conversion, for the I/O modules."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


class _Container:
    """replace / from_numpy shared by the tensor dataclasses."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_numpy(cls, arrays, device="cuda"):
        """Build from a mapping field -> array; extra keys are ignored."""
        kw = {}
        for f in fields(cls):
            v = arrays[f.name]
            kw[f.name] = v if f.metadata.get("static") else _to_tensor(
                v, device)
        return cls(**kw)


def _static():
    return field(metadata={"static": True})


@dataclass
class State(_Container):
    """Dynamic per-particle state + box."""

    x: torch.Tensor        # [cap, 3] positions (world)
    v: torch.Tensor        # [cap, 3] velocities
    q: torch.Tensor        # [cap, 4] orientation quaternions (scalar first)
    angmom: torch.Tensor   # [cap, 3] angular momentum (world frame)
    f: torch.Tensor        # [cap, 3] force accumulator
    tau: torch.Tensor      # [cap, 3] torque accumulator
    scale: torch.Tensor    # [cap]    per-particle size factor
    shtype: torch.Tensor   # [cap]    shape-type index into Shapes tables
    tag: torch.Tensor      # [cap]    persistent particle id (1-based, 0 empty)
    active: torch.Tensor   # [cap]    bool slot validity
    image: torch.Tensor    # [cap, 3] PBC image counters
    box_lo: torch.Tensor   # [3]
    box_hi: torch.Tensor   # [3]
    tilt: torch.Tensor     # [3] triclinic tilt factors (xy, xz, yz)
    step: torch.Tensor     # scalar timestep counter

    @property
    def cap(self) -> int:
        return self.x.shape[-2]

    @property
    def replicas(self) -> bool:
        """True when the fields carry a leading replica axis."""
        return self.x.dim() == 3

    @property
    def n_active(self):
        return self.active.sum(-1)


@dataclass
class Shapes(_Container):
    """Static per-shape-type data, precomputed at setup (numpy, float64).

    The reference's ``table`` (interp radius tables) is not carried: the
    port always evaluates the SH surface exactly, in the power basis.
    """

    lmax: int = _static()
    coeffs: torch.Tensor       # [T, (lmax+1)^2] real SH coefficients
    quad_theta: torch.Tensor   # [G]
    quad_phi: torch.Tensor     # [G]
    quad_w: torch.Tensor       # [G] solid-angle weights (sum 4 pi)
    quad_dirs: torch.Tensor    # [G, 3] unit directions (body frame)
    node_r: torch.Tensor       # [T, G] body-frame radius at each node
    node_normals: torch.Tensor  # [T, G, 3] outward unit normals
    node_area: torch.Tensor    # [T, G] area element
    rmax: torch.Tensor         # [T] bounding-sphere radius
    rmin: torch.Tensor         # [T] inscribed-sphere radius
    rchar: torch.Tensor        # [T] mean radius a_00/sqrt(4pi)
    # Patch-local contact cap grid (flattened n_gamma x n_psi): cap_x in
    # (0,1) maps to cos(gamma) = 1 - (1 - cos(gamma_max)) * cap_x per pair.
    cap_x: torch.Tensor        # [Gc]
    cap_glw: torch.Tensor      # [Gc]
    cap_cpsi: torch.Tensor     # [Gc]
    cap_spsi: torch.Tensor     # [Gc]
    # Coarse stage-1 cap grid (rebuild-time r-only prefilter probe).
    cap1_x: torch.Tensor       # [G1]
    cap1_glw: torch.Tensor     # [G1]
    cap1_cpsi: torch.Tensor    # [G1]
    cap1_spsi: torch.Tensor    # [G1]
    vol: torch.Tensor          # [T] volume (unit scale)
    inertia: torch.Tensor      # [T, 3] principal inertia (unit scale)
    density: torch.Tensor      # [T]
    l1: int = _static()        # stage-1 truncation degree
    power_tbl: torch.Tensor    # [T, W(lmax)] power-basis tables
    tail1: torch.Tensor        # [T] stage-1 truncation tail bound
    gmax: torch.Tensor         # [T] max tangential |grad r|

    @property
    def n_types(self) -> int:
        return self.coeffs.shape[0]

    @property
    def n_nodes(self) -> int:
        return self.quad_theta.shape[0]

    def mass_of(self, shtype, scale):
        return self.density[shtype] * self.vol[shtype] * scale**3

    def inertia_of(self, shtype, scale):
        return (
            self.density[shtype, None]
            * self.inertia[shtype]
            * (scale**5)[..., None]
        )


@dataclass
class NeighborState(_Container):
    """Fixed-capacity Verlet neighbour tensor, contact history, pair list.

    ``idx`` is a FULL list (pair (i, j) in both rows). ``hist`` holds the
    rebuild-time, tag-keyed spring snapshot; between rebuilds the live
    springs ride in ``pair_hist`` over the half pair list.
    """

    idx: torch.Tensor        # [cap, K] neighbour slot indices (0 if invalid)
    mask: torch.Tensor       # [cap, K] bool validity
    hist: torch.Tensor       # [cap, K, HW] springs (rebuild-time snapshot)
    neigh_tag: torch.Tensor  # [cap, K] neighbour tags at build time
    row_tag: torch.Tensor    # [cap] owner tag of each row at build time
    wall_hist: torch.Tensor  # [cap, W, HW] per-wall springs
    x_build: torch.Tensor    # [cap, 3] positions at build time
    q_build: torch.Tensor    # [cap, 4] orientations at build time
    budget: torch.Tensor     # [cap] per-particle motion budget (prefilter)
    overflow: torch.Tensor   # scalar: per-source capacity overflow channel
    skin_violations: torch.Tensor  # scalar: stale-list count at rebuilds
    pair_i: torch.Tensor     # [Pc] row slot (sorted ascending)
    pair_j: torch.Tensor     # [Pc] partner slot
    pair_valid: torch.Tensor  # [Pc] bool
    pair_both: torch.Tensor  # [Pc] bool: apply the reaction to j too
    pair_hist: torch.Tensor  # [Pc, HW] live tangential + rolling springs
    pair_sel: torch.Tensor   # [Pc] flat cap*K slot of (i->j); cap*K = none
    pair_selj: torch.Tensor  # [Pc] flat slot of the mirror (j->i) entry
    pair_jsort: torch.Tensor  # [Pc] permutation sorting pair_j

    @property
    def k_max(self) -> int:
        return self.idx.shape[-1]

    @property
    def pair_cap(self) -> int:
        return self.pair_i.shape[-1]


@dataclass
class SimParams(_Container):
    """Physics + integration parameters (0-d / small f32 tensors).

    Contact law (LAMMPS gran/hertz/history + rolling spring-dashpot-
    slider); see ``spherharm_tpu/core/state.py`` for the formulas.
    ``pair_tab`` is the per-type-pair material table [T, T, 8] of
    (kn, kt, gamma_n, gamma_t, mu, k_roll, gamma_roll, mu_roll); create()
    emits a [1, 1, 8] broadcast of the global scalars.
    """

    dt: torch.Tensor
    kn: torch.Tensor
    kt: torch.Tensor
    gamma_n: torch.Tensor
    gamma_t: torch.Tensor
    mu: torch.Tensor
    k_roll: torch.Tensor
    gamma_roll: torch.Tensor
    mu_roll: torch.Tensor
    gravity: torch.Tensor       # [3]
    skin: torch.Tensor          # Verlet skin distance
    cutoff: torch.Tensor        # neighbour cutoff
    deform_rate: torch.Tensor   # [3] diagonal engineering strain rate
    shear_rate: torch.Tensor    # [3] off-diagonal shear rates
    press_target: torch.Tensor  # [3]
    press_tau: torch.Tensor
    pair_tab: torch.Tensor      # [T, T, 8]

    @classmethod
    def create(cls, dt, kn, kt=None, gamma_n=0.0, gamma_t=None, mu=0.5,
               k_roll=0.0, gamma_roll=0.0, mu_roll=0.0,
               gravity=(0.0, 0.0, 0.0), skin=0.0, cutoff=1.0,
               deform_rate=(0.0, 0.0, 0.0), shear_rate=(0.0, 0.0, 0.0),
               press_target=(0.0, 0.0, 0.0), press_tau=0.0,
               dtype=torch.float32, device="cuda"):
        if kt is None:
            kt = 2.0 / 7.0 * kn
        if gamma_t is None:
            gamma_t = 0.5 * gamma_n
        f = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                                      device=device)
        pair_tab = torch.stack(
            [f(kn), f(kt), f(gamma_n), f(gamma_t), f(mu),
             f(k_roll), f(gamma_roll), f(mu_roll)]
        ).reshape(1, 1, 8)
        return cls(
            dt=f(dt), kn=f(kn), kt=f(kt), gamma_n=f(gamma_n),
            gamma_t=f(gamma_t), mu=f(mu),
            k_roll=f(k_roll), gamma_roll=f(gamma_roll), mu_roll=f(mu_roll),
            gravity=f(gravity), skin=f(skin), cutoff=f(cutoff),
            deform_rate=f(deform_rate), shear_rate=f(shear_rate),
            press_target=f(press_target), press_tau=f(press_tau),
            pair_tab=pair_tab,
        )

    def with_pair_coeffs(self, n_types: int, coeffs: dict):
        """Per-type-pair material table from explicit ``pair_coeff i j``
        entries: {(i, j): (kn, kt, gamma_n, gamma_t, mu[, k_roll,
        gamma_roll, mu_roll])}, 0-based types in either order.

        Unset diagonal entries default to the global scalars; unset
        off-diagonal (i, j) mix geometrically from the diagonals,
        sqrt(c_ii * c_jj) componentwise (LAMMPS granular ``mix
        geometric``: a component disabled in either material is disabled
        for the pair). Returns params with a [T, T, 8] ``pair_tab`` on
        the params' device."""
        diag_default = np.array([
            float(self.kn), float(self.kt), float(self.gamma_n),
            float(self.gamma_t), float(self.mu), float(self.k_roll),
            float(self.gamma_roll), float(self.mu_roll),
        ])
        tab = np.zeros((n_types, n_types, 8))
        have = np.zeros((n_types, n_types), bool)
        for (i, j), vals in coeffs.items():
            v = np.asarray([float(x) for x in vals])
            if v.shape[0] == 5:
                v = np.concatenate([v, np.zeros(3)])
            if v.shape[0] != 8:
                raise ValueError(
                    f"pair_coeff needs 5 or 8 values, got {v.shape[0]}")
            tab[i, j] = tab[j, i] = v
            have[i, j] = have[j, i] = True
        for i in range(n_types):
            if not have[i, i]:
                tab[i, i] = diag_default
        for i in range(n_types):
            for j in range(i + 1, n_types):
                if not have[i, j]:
                    tab[i, j] = tab[j, i] = np.sqrt(tab[i, i] * tab[j, j])
        return self.replace(pair_tab=torch.as_tensor(
            tab, dtype=self.kn.dtype, device=self.kn.device))


def per_replica(t, base: int, nd: int):
    """A parameter or box value against per-particle or per-pair data:
    ``t`` of its base rank ``base`` (0 a scalar, 1 a [3] vector) passes
    unchanged; with a leading replica axis, [R, *s] becomes [R, 1, ..., 1,
    *s] of ``nd`` dims, to broadcast against data of ``nd`` dims whose
    first axis is the replica axis. A Python number passes unchanged."""
    if not torch.is_tensor(t) or t.dim() == base:
        return t
    return t.reshape(t.shape[:1] + (1,) * (nd - t.dim()) + t.shape[1:])


def take(t, idx, replicas: bool):
    """``t[idx]``; with ``replicas``, t [R, N, ...] and idx [R, ...] index
    each replica's own rows (the slots of a replica are its own)."""
    if not replicas:
        return t[idx]
    r = torch.arange(idx.shape[0], device=idx.device)
    return t[r.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def pair_material(params: SimParams, t_i, t_j):
    """Per-pair material rows [..., 8] from the [T, T, 8] table. Indices
    clamp to the table size, so the [1, 1, 8] default serves any T. A
    replica-stacked table [R, T, T, 8] (``ensemble.with_param_sweep``)
    gives each replica's pairs t_i, t_j [R, ...] its own row."""
    return table_material(params.pair_tab, t_i, t_j)


def table_material(tab, t_i, t_j):
    """``pair_material`` of the table ``tab`` itself."""
    tp = tab.shape[-2]
    ti = torch.clamp(t_i, max=tp - 1)
    tj = torch.clamp(t_j, max=tp - 1)
    if tab.dim() == 4:
        r = torch.arange(tab.shape[0], device=ti.device)
        return tab[r.reshape((-1,) + (1,) * (ti.dim() - 1)), ti, tj]
    return tab[ti, tj]


def zeros_state(cap: int, box_lo, box_hi, dtype=torch.float32,
                device="cuda") -> State:
    """An empty fixed-capacity State (all slots inactive)."""
    fz = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    iz = lambda *s: torch.zeros(s, dtype=torch.long, device=device)
    q0 = fz(cap, 4)
    q0[:, 0] = 1.0
    box = lambda b: torch.as_tensor(np.asarray(b, np.float64), dtype=dtype,
                                    device=device)
    return State(
        x=fz(cap, 3), v=fz(cap, 3), q=q0, angmom=fz(cap, 3),
        f=fz(cap, 3), tau=fz(cap, 3),
        scale=torch.ones(cap, dtype=dtype, device=device),
        shtype=iz(cap), tag=iz(cap),
        active=torch.zeros(cap, dtype=torch.bool, device=device),
        image=iz(cap, 3),
        box_lo=box(box_lo), box_hi=box(box_hi),
        tilt=fz(3), step=torch.zeros((), dtype=torch.long, device=device),
    )


# Width of the per-contact spring state: 3 tangential + 3 rolling.
HIST_W = 6


def empty_neighbors(cap: int, k_max: int, n_walls: int = 0,
                    dtype=torch.float32, pair_cap: int = 0,
                    device="cuda", replicas: int = 0) -> NeighborState:
    """Empty lists; ``replicas`` > 0 stacks that many along a leading
    replica axis."""
    if replicas:
        one = empty_neighbors(cap, k_max, n_walls, dtype, pair_cap, device)
        return NeighborState(**{
            f.name: getattr(one, f.name).expand(
                (replicas,) + getattr(one, f.name).shape).contiguous()
            for f in fields(one)})
    fz = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    iz = lambda *s: torch.zeros(s, dtype=torch.long, device=device)
    bz = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)
    q_build = fz(cap, 4)
    q_build[:, 0] = 1.0
    none = torch.full((pair_cap,), cap * k_max, dtype=torch.long,
                      device=device)
    return NeighborState(
        idx=iz(cap, k_max), mask=bz(cap, k_max),
        hist=fz(cap, k_max, HIST_W), neigh_tag=iz(cap, k_max),
        row_tag=iz(cap), wall_hist=fz(cap, max(n_walls, 1), HIST_W),
        x_build=fz(cap, 3), q_build=q_build, budget=fz(cap),
        overflow=iz(), skin_violations=iz(),
        pair_i=iz(pair_cap), pair_j=iz(pair_cap),
        pair_valid=bz(pair_cap), pair_both=bz(pair_cap),
        pair_hist=fz(pair_cap, HIST_W),
        pair_sel=none, pair_selj=none.clone(),
        pair_jsort=iz(pair_cap),
    )
