"""SH coefficient-table files + LAMMPS-style data files (torch twin of
``spherharm_tpu/io/data.py``: the same bytes for the same state).

Covers the reference's read_data / per-type coefficient-table loading
(SURVEY.md section 2 B.7: "SH decks add per-type coefficient-table
files"). Two formats:

1. Coefficient table (text): header line ``lmax <L>``, then one line per
   (n, m) coefficient: ``n m value``. Missing entries are zero. This is
   the natural exchange format for scanned-particle surfaces.

2. Data file (LAMMPS-data-like): header with atom count / box bounds,
   an ``Atoms`` section with rows
       id type scale x y z quatw quati quatj quatk
   and optional ``Velocities`` rows: id vx vy vz wx wy wz (angmom).
"""

from __future__ import annotations

import numpy as np

from spherharm_tpu_torch.core.state import to_numpy
from spherharm_tpu_torch.models.shapes_library import n_coeffs, sh_index


def write_coeff_file(path, coeffs, lmax: int):
    coeffs = to_numpy(coeffs)
    with open(path, "w") as f:
        f.write(f"lmax {lmax}\n")
        for n in range(lmax + 1):
            for m in range(-n, n + 1):
                v = coeffs[sh_index(n, m)]
                if v != 0.0:
                    f.write(f"{n} {m} {float(v):.17g}\n")


def read_coeff_file(path):
    """Returns (coeffs [(lmax+1)^2], lmax)."""
    with open(path) as f:
        lines = [ln.split("#")[0].strip() for ln in f]
    lines = [ln for ln in lines if ln]
    head = lines[0].split()
    if head[0] != "lmax":
        raise ValueError(f"bad coeff file header: {lines[0]}")
    lmax = int(head[1])
    c = np.zeros(n_coeffs(lmax))
    for ln in lines[1:]:
        n_s, m_s, v_s = ln.split()
        c[sh_index(int(n_s), int(m_s))] = float(v_s)
    return c, lmax


def write_data_file(path, state, periodic=(False, False, False)):
    """Write a LAMMPS-style data file of the current configuration (the
    state's tensors come to the host once)."""
    host = {k: to_numpy(getattr(state, k)) for k in (
        "active", "tag", "x", "v", "q", "angmom", "shtype", "scale",
        "box_lo", "box_hi")}
    sel = np.flatnonzero(host["active"])
    order = np.argsort(host["tag"][sel])
    sel = sel[order]
    x = host["x"][sel]
    v = host["v"][sel]
    q = host["q"][sel]
    L = host["angmom"][sel]
    typ = host["shtype"][sel] + 1
    scale = host["scale"][sel]
    tag = host["tag"][sel]
    lo = host["box_lo"]
    hi = host["box_hi"]
    with open(path, "w") as f:
        f.write("# spherharm_tpu data file\n\n")
        f.write(f"{len(sel)} atoms\n")
        f.write(f"{int(typ.max()) if len(sel) else 1} atom types\n\n")
        f.write(f"{float(lo[0]):.9g} {float(hi[0]):.9g} xlo xhi\n")
        f.write(f"{float(lo[1]):.9g} {float(hi[1]):.9g} ylo yhi\n")
        f.write(f"{float(lo[2]):.9g} {float(hi[2]):.9g} zlo zhi\n\n")
        f.write("Atoms\n\n")
        for i in range(len(sel)):
            f.write(
                f"{tag[i]} {typ[i]} {scale[i]:.9g} "
                f"{x[i,0]:.9g} {x[i,1]:.9g} {x[i,2]:.9g} "
                f"{q[i,0]:.9g} {q[i,1]:.9g} {q[i,2]:.9g} {q[i,3]:.9g}\n"
            )
        f.write("\nVelocities\n\n")
        for i in range(len(sel)):
            f.write(
                f"{tag[i]} {v[i,0]:.9g} {v[i,1]:.9g} {v[i,2]:.9g} "
                f"{L[i,0]:.9g} {L[i,1]:.9g} {L[i,2]:.9g}\n"
            )


def read_data_file(path):
    """Parse a data file -> dict of arrays (host-side)."""
    with open(path) as f:
        raw = [ln.split("#")[0].rstrip() for ln in f]
    n_atoms = 0
    box_lo = np.zeros(3)
    box_hi = np.ones(3)
    i = 0
    section = None
    atoms, vels = [], []
    while i < len(raw):
        ln = raw[i].strip()
        i += 1
        if not ln:
            continue
        if ln.endswith("atoms"):
            n_atoms = int(ln.split()[0])
        elif ln.endswith("atom types"):
            pass
        elif ln.endswith("xlo xhi"):
            box_lo[0], box_hi[0] = map(float, ln.split()[:2])
        elif ln.endswith("ylo yhi"):
            box_lo[1], box_hi[1] = map(float, ln.split()[:2])
        elif ln.endswith("zlo zhi"):
            box_lo[2], box_hi[2] = map(float, ln.split()[:2])
        elif ln == "Atoms":
            section = "atoms"
        elif ln == "Velocities":
            section = "velocities"
        elif section == "atoms":
            atoms.append([float(v) for v in ln.split()])
        elif section == "velocities":
            vels.append([float(v) for v in ln.split()])
    atoms = np.asarray(atoms)
    if atoms.shape[0] != n_atoms:
        raise ValueError(f"{path}: {atoms.shape[0]} Atoms rows, header says "
                         f"{n_atoms}")
    out = {
        "tag": atoms[:, 0].astype(np.int32),
        "shtype": atoms[:, 1].astype(np.int32) - 1,
        "scale": atoms[:, 2],
        "x": atoms[:, 3:6],
        "q": atoms[:, 6:10],
        "box_lo": box_lo,
        "box_hi": box_hi,
    }
    if vels:
        vels = np.asarray(vels)
        order = np.argsort(vels[:, 0])
        vels = vels[order]
        aorder = np.argsort(out["tag"])
        inv = np.empty_like(aorder)
        inv[aorder] = np.arange(len(aorder))
        out["v"] = vels[:, 1:4][inv]
        out["angmom"] = vels[:, 4:7][inv]
    return out
