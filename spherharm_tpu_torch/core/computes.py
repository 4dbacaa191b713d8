"""Diagnostic computes (torch twin of ``spherharm_tpu/core/computes.py``).

The reference's Compute styles as functions of (sim, state, neigh):
packing fraction, KE, temperature, angular speed and the per-atom ke,
stress, coordination and contact counts, looked up by name through
``compute``. The per-atom computes that need contact forces rerun the
narrow phase over the stable pair list at diagnostic cadence, in the
geometric law as the reference's diagnostic pass does, through
``contact_kernels.pair_contact_indexed`` (so on the card they launch the
pair kernel), and sum per atom with the sorted segment-sums, never atomics.
"""

from __future__ import annotations

import torch

from spherharm_tpu_torch.ops import contact
from spherharm_tpu_torch.ops import contact_kernels as ck
from spherharm_tpu_torch.ops.rotation import omega_from_angmom


def particle_volumes(state, shapes):
    return torch.where(state.active,
                       shapes.vol[state.shtype] * state.scale**3, 0.0)


def packing_fraction_box(state, shapes):
    """Solid fraction of a settled bed in a box (config 2): bed height
    h = 2 * (volume-weighted mean particle height above the floor), exact
    for a uniform slab and robust to a few stray bouncers."""
    vols = particle_volumes(state, shapes)
    z_rel = torch.where(state.active, state.x[:, 2] - state.box_lo[2], 0.0)
    z_mean = (vols * z_rel).sum() / torch.clamp(vols.sum(), min=1e-30)
    bed_h = torch.clamp(2.0 * z_mean, min=1e-9)
    footprint = ((state.box_hi[0] - state.box_lo[0])
                 * (state.box_hi[1] - state.box_lo[1]))
    return vols.sum() / (footprint * bed_h)


def per_atom_ke(state, shapes):
    """Translational KE per particle (LAMMPS compute ke/atom)."""
    m = shapes.mass_of(state.shtype, state.scale)
    return torch.where(state.active, 0.5 * m * (state.v**2).sum(-1), 0.0)


def mean_kinetic_energy(state, shapes):
    """Per-particle translational KE (settling convergence monitor)."""
    return per_atom_ke(state, shapes).sum() / torch.clamp(
        state.active.sum(), min=1)


def angular_speed(state, shapes):
    """|omega| per particle (compute omega/atom)."""
    inertia = shapes.inertia_of(state.shtype, state.scale)
    om = omega_from_angmom(state.q, state.angmom, inertia)
    return torch.where(state.active, torch.linalg.norm(om, dim=-1), 0.0)


def temperature(state, shapes):
    """Granular temperature: mean translational KE per dof (compute
    temp)."""
    n = torch.clamp(state.active.sum(), min=1)
    return 2.0 * per_atom_ke(state, shapes).sum() / (3.0 * n)


def _pair_pass(sim, state, neigh):
    """The narrow phase over the stable pair list, geometric law in f32
    whatever ``SPHERHARM_STAGE2_BF16`` says (the reference's computes run
    its f32 ``pair_contact_rows``), current springs: returns (kernel output
    rows [P, 24], minimum-image d [P, 3], live-pair mask [P]), d and the
    mask as the law's rows carry them (zero d where dead)."""
    rows = contact.particle_rows(state, sim.shapes)
    tbl, cap, par = ck.pair_tables(sim.shapes, sim.params, rows.dtype)
    out = ck.pair_contact_indexed(
        rows, state.shtype, neigh.pair_i, neigh.pair_j, neigh.pair_valid,
        neigh.pair_hist, sim.params.pair_tab, tbl, cap, par,
        ck.box_rows(state.box_lo, state.box_hi, sim._tilt(state), 1),
        sim.periodic, lmax=sim.shapes.lmax, conservative=False, bf16=False)
    return out, out[:, 17:20], out[:, 20] > 0.5


def _per_atom_sum(neigh, val, w_j, n):
    """sum_i over pairs (i, .) of val plus, for half-list pairs, over pairs
    (., j) of val * w_j: two sorted segment-sums (pair_i is sorted,
    pair_jsort sorts pair_j)."""
    flat = val.reshape(val.shape[0], -1)
    acc = contact.sorted_segment_sum(flat, neigh.pair_i, n)
    perm = neigh.pair_jsort
    acc = acc + contact.sorted_segment_sum((flat * w_j[:, None])[perm],
                                           neigh.pair_j[perm], n)
    return acc.reshape((n,) + val.shape[1:])


def per_atom_stress(sim, state, neigh):
    """Per-atom virial stress tensor [cap, 3, 3] (compute stress/atom),
    LAMMPS convention (stress * volume, so sum_i S_i = -(thermo stress) V):
    S_i = -m_i v_i (x) v_i + 1/2 sum_pairs d (x) f_i, each pair giving
    half to each member (the reaction pair has the same outer product)."""
    out, d, msk = _pair_pass(sim, state, neigh)
    force = out[:, 0:3]
    w_pair = 0.5 * d[:, :, None] * force[:, None, :]
    w_j = (msk & neigh.pair_both).to(force.dtype)
    s = _per_atom_sum(neigh, w_pair, w_j, state.cap)
    m = sim.shapes.mass_of(state.shtype, state.scale)
    kin = -m[:, None, None] * state.v[:, :, None] * state.v[:, None, :]
    return torch.where(state.active[:, None, None], s + kin, 0.0)


def coordination(sim, state, neigh):
    """Bounding-sphere coordination per atom (compute coord/atom):
    neighbours with centre distance < rb_i + rb_j, over the full [N, K]
    Verlet tensor (the prefiltered pair list would undercount)."""
    idx, mask = neigh.idx[:state.cap], neigh.mask[:state.cap]
    rb = sim.shapes.rmax[state.shtype] * state.scale
    d = contact.minimum_image(state.x[idx] - state.x[:, None, :],
                              state.box_lo, state.box_hi, sim.periodic,
                              sim._tilt(state))
    rsum = rb[:, None] + rb[idx]
    hit = mask & ((d * d).sum(-1) < rsum * rsum)
    return torch.where(state.active, hit.sum(1), 0)


def contacts_per_atom(sim, state, neigh):
    """True contact count per atom (compute contact/atom) from the narrow
    phase over the stable pair list."""
    out, _, msk = _pair_pass(sim, state, neigh)
    inc = out[:, 16] > 0.5
    c = _per_atom_sum(neigh, inc.to(out.dtype),
                      (msk & neigh.pair_both).to(out.dtype), state.cap)
    return torch.where(state.active, torch.round(c).long(), 0)


# -- compute registry (the reference's Modify/Compute lookup) -------------
#
# Scalar computes: fn(sim, state, neigh) -> 0-d tensor.
# Per-atom computes: fn(sim, state, neigh) -> [cap, ...].
SCALAR_COMPUTES = {
    "temp": lambda sim, st, ng: temperature(st, sim.shapes),
    "ke": lambda sim, st, ng: per_atom_ke(st, sim.shapes).sum(),
    "pressure": lambda sim, st, ng: -torch.trace(
        per_atom_stress(sim, st, ng).sum(0)
    ) / (3.0 * torch.prod(st.box_hi - st.box_lo)),
    "packing": lambda sim, st, ng: packing_fraction_box(st, sim.shapes),
}
PERATOM_COMPUTES = {
    "ke/atom": lambda sim, st, ng: per_atom_ke(st, sim.shapes),
    "stress/atom": per_atom_stress,
    "omega/atom": lambda sim, st, ng: angular_speed(st, sim.shapes),
    "coord/atom": coordination,
    "contact/atom": contacts_per_atom,
}


def compute(style: str, sim, state, neigh):
    """Evaluate a registered compute style by name."""
    if style in SCALAR_COMPUTES:
        return SCALAR_COMPUTES[style](sim, state, neigh)
    if style in PERATOM_COMPUTES:
        return PERATOM_COMPUTES[style](sim, state, neigh)
    raise KeyError(
        f"unknown compute style {style!r}; "
        f"known: {sorted(SCALAR_COMPUTES) + sorted(PERATOM_COMPUTES)}")
