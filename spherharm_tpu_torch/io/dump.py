"""LAMMPS ``dump custom``-format trajectory writer and reader (torch twin
of ``spherharm_tpu/io/dump.py``; the same bytes for the same state).
Text format:

    ITEM: TIMESTEP
    <step>
    ITEM: NUMBER OF ATOMS
    <n>
    ITEM: BOX BOUNDS pp pp ff
    <xlo> <xhi>
    ...
    ITEM: ATOMS id type x y z ...
    <rows sorted by id>

The state's tensors come to the host once per frame, in ``_column_data``.
"""

from __future__ import annotations

import numpy as np

from spherharm_tpu_torch import native
from spherharm_tpu_torch.core.state import to_numpy

DEFAULT_COLUMNS = (
    "id", "type", "x", "y", "z", "vx", "vy", "vz",
    "quatw", "quati", "quatj", "quatk",
    "angmomx", "angmomy", "angmomz", "radius",
)


def _column_data(state, shapes, columns, extra=None):
    """Per-particle columns of the active rows, sorted by tag, as numpy.

    ``extra``: additional [cap]-sized per-particle tensors or arrays (per-
    atom compute values referenced as ``c_<id>`` dump columns)."""
    sel = np.flatnonzero(to_numpy(state.active))
    x = to_numpy(state.x)[sel]
    v = to_numpy(state.v)[sel]
    q = to_numpy(state.q)[sel]
    L = to_numpy(state.angmom)[sel]
    tag = to_numpy(state.tag)[sel]
    shtype = to_numpy(state.shtype)[sel]
    scale = to_numpy(state.scale)[sel]
    rchar = to_numpy(shapes.rchar)[shtype]
    pools = {
        "id": tag, "type": shtype + 1,  # LAMMPS types are 1-based
        "x": x[:, 0], "y": x[:, 1], "z": x[:, 2],
        "vx": v[:, 0], "vy": v[:, 1], "vz": v[:, 2],
        "quatw": q[:, 0], "quati": q[:, 1], "quatj": q[:, 2], "quatk": q[:, 3],
        "angmomx": L[:, 0], "angmomy": L[:, 1], "angmomz": L[:, 2],
        "radius": rchar * scale,
        "scale": scale,
    }
    for name, arr in (extra or {}).items():
        pools[name] = to_numpy(arr)[sel]
    order = np.argsort(tag)
    return {c: pools[c][order] for c in columns}


def _format_rows_python(mat, columns, header):
    """The formatter of last resort: the native one's bytes, in Python."""
    lines = [header]
    for row in mat:
        lines.append(" ".join(
            str(int(v)) if c in ("id", "type") else "%.8g" % v
            for c, v in zip(columns, row)
        ) + "\n")
    return "".join(lines).encode()


def write_dump(path, state, shapes, periodic=(False, False, False),
               columns=DEFAULT_COLUMNS, append=False, extra=None):
    """Write one snapshot in LAMMPS dump custom text format. Rows go
    through the native C++ formatter (``spherharm_tpu_torch.native``)
    when it builds, else through Python. Returns which wrote the frame:
    "native" or "python"."""
    cols = _column_data(state, shapes, columns, extra=extra)
    n = len(cols[columns[0]])
    lo = to_numpy(state.box_lo)
    hi = to_numpy(state.box_hi)
    bflags = " ".join("pp" if p else "ff" for p in periodic)
    header = "ITEM: TIMESTEP\n%d\n" % int(state.step)
    header += "ITEM: NUMBER OF ATOMS\n%d\n" % n
    header += "ITEM: BOX BOUNDS %s\n" % bflags
    for d in range(3):
        header += "%.9g %.9g\n" % (lo[d], hi[d])
    header += "ITEM: ATOMS %s\n" % " ".join(columns)
    mat = np.stack([cols[c] for c in columns], axis=1)
    int_mask = np.asarray(
        [1 if c in ("id", "type") else 0 for c in columns], np.int32
    )
    blob = native.format_dump_rows(mat, int_mask, header)
    formatter = "native"
    if blob is None:
        blob, formatter = _format_rows_python(mat, columns, header), "python"
    with open(path, "ab" if append else "wb") as f:
        f.write(blob)
    return formatter


def read_dump(path):
    """Parse a (single- or multi-snapshot) dump file -> list of dicts."""
    frames = []
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        if not (lines[i].startswith("ITEM: TIMESTEP")
                and lines[i + 2].startswith("ITEM: NUMBER OF ATOMS")
                and lines[i + 4].startswith("ITEM: BOX BOUNDS")):
            raise ValueError(f"{path}: line {i + 1} does not start a dump "
                             "frame")
        step = int(lines[i + 1])
        n = int(lines[i + 3])
        bounds = np.array(
            [[float(v) for v in lines[i + 5 + d].split()] for d in range(3)]
        )
        header = lines[i + 8].split()[2:]
        rows = np.array(
            [[float(v) for v in lines[i + 9 + r].split()] for r in range(n)]
        )
        frames.append({
            "step": step, "n": n, "bounds": bounds,
            "columns": header,
            "data": {c: rows[:, k] for k, c in enumerate(header)},
        })
        i += 9 + n
    return frames
