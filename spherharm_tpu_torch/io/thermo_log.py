"""LAMMPS-style thermo table logging, screen and log file (torch twin of
``spherharm_tpu/io/thermo_log.py``): the same column names and formats
(Step, Atoms, KinEng, RotKE, PairEng, WallEng, GravEng, TotEng, Press),
fed by ``Simulation.thermo``'s dict of 0-d tensors."""

from __future__ import annotations

DEFAULT_COLUMNS = (
    ("step", "Step", "%10d"),
    ("n", "Atoms", "%8d"),
    ("ke", "KinEng", "%14.6g"),
    ("erot", "RotKE", "%14.6g"),
    ("pe_pair", "PairEng", "%14.6g"),
    ("pe_wall", "WallEng", "%14.6g"),
    ("pe_grav", "GravEng", "%14.6g"),
    ("etot", "TotEng", "%14.6g"),
    ("press", "Press", "%14.6g"),
)


class ThermoLog:
    """Accumulates thermo rows; mirrors them to screen and/or a log file
    (opened at construction, closed by ``close``)."""

    def __init__(self, path=None, columns=DEFAULT_COLUMNS, echo=True):
        self.path = path
        self.columns = columns
        self.echo = echo
        self.rows = []
        self._file = open(path, "w") if path else None
        self._wrote_header = False

    def header(self):
        return " ".join(h.rjust(len(fmt % 0) if "d" in fmt else 14)
                        for _, h, fmt in self.columns)

    def log(self, thermo: dict):
        row = {k: float(thermo[k]) for k, _, _ in self.columns if k in thermo}
        # Other scalar entries (compute results) ride along in the row dict
        # without a fixed-format column; tensors of several values do not.
        for k, v in thermo.items():
            if k not in row:
                try:
                    row[k] = float(v)
                except (TypeError, ValueError, RuntimeError):
                    pass
        self.rows.append(row)
        cells = []
        for key, _, fmt in self.columns:
            v = thermo.get(key, 0)
            v = int(v) if "d" in fmt else float(v)
            cells.append(fmt % v)
        out = ""
        if not self._wrote_header:
            out = self.header() + "\n"
            self._wrote_header = True
        out += " ".join(cells)
        if self.echo:
            print(out)
        if self._file:
            self._file.write(out + "\n")
            self._file.flush()

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    def series(self, key):
        return [r[key] for r in self.rows]
