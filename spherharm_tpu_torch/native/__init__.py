"""Native (C++) host-side I/O: the dump-frame formatter and the numeric
table parser of ``dumpio.cpp`` (a copy of the JAX package's
``spherharm_tpu/native``), bound with ctypes.

At first use g++ builds ``dumpio.cpp`` into ``build/spherharm_tpu_torch/``
beside the package (the directory of the CUDA kernels, listed in
``.gitignore``), under a file name that carries a hash of the source, so
an edited source rebuilds. This is host I/O, not a device path: where the
toolchain is missing, ``get_lib`` returns None and the callers format in
Python, as the reference's do; ``io.dump.write_dump`` returns which
formatter wrote the frame.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from spherharm_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "dumpio.cpp"
FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"dumpio_{h.hexdigest()[:16]}.so"


def _build_and_load():
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, so)  # atomic: concurrent builders never see a stub
    lib = ctypes.CDLL(str(so))
    lib.sh_format_dump.restype = ctypes.c_int64
    lib.sh_format_dump.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.sh_parse_table.restype = ctypes.c_int64
    lib.sh_parse_table.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    return lib


@functools.cache
def get_lib():
    """The native library, or None when g++ cannot build or load it."""
    try:
        return _build_and_load()
    except (OSError, subprocess.CalledProcessError):
        return None


def format_dump_rows(rows: np.ndarray, int_mask, header: str) -> bytes | None:
    """Format a frame (header + numeric rows) natively; None -> the caller
    formats in Python."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    n_rows, n_cols = rows.shape
    mask = np.ascontiguousarray(int_mask, dtype=np.int32)
    if mask.shape != (n_cols,):
        raise ValueError(f"int_mask has {mask.shape} entries for {n_cols} "
                         "columns")
    hdr = header.encode()
    cap = len(hdr) + 32 * n_rows * n_cols + n_rows + 64
    buf = ctypes.create_string_buffer(cap)
    written = lib.sh_format_dump(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_rows, n_cols,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hdr, cap, buf,
    )
    if written < 0:
        return None
    return buf.raw[:written]


def parse_table(text: str, n_rows: int, n_cols: int) -> np.ndarray | None:
    """Parse a whitespace-separated numeric table natively; None -> the
    caller parses in Python."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((n_rows, n_cols), dtype=np.float64)
    got = lib.sh_parse_table(
        text.encode(), n_rows, n_cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if got != n_rows:
        return None
    return out
