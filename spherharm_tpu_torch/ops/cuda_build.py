"""Build and load the CUDA kernels (``spherharm_tpu_torch/csrc``).

At first use, nvcc compiles every ``.cu`` source of the kernels for
sm_90a, one nvcc process per source, all started together, and links the
objects into one shared library with a plain C interface, under
``build/spherharm_tpu_torch/`` beside the package (listed in
``.gitignore``). The span marks (``csrc/span_marks.cu``) are a library of
their own, ``span_library``, built only when spans are switched on. The file name carries a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing library. The library is bound with
ctypes: every pointer and the stream are ``c_void_p``, every C entry
returns ``cudaGetLastError()``.

A failed build or load raises; nothing falls back to another route.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spherharm_tpu_torch"
SOURCES = ("pair_contact.cu", "pair_contact_cons.cu", "pair_reduce.cu",
           "stage1_probe.cu", "wall_contact.cu")
HEADERS = ("sh_device.cuh", "sh_nodes.cuh", "pair_contact.cuh")
SPAN_SOURCES = ("span_marks.cu",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # rows, typ, N, pi, pj, valid, hist, hist_stride, pair_tab, tp,
    # tab_rep, box, box_w, px, py, pz, ppl, tbl, T, W, cap, G, par, lmax,
    # P, rows_per_replica, conservative, bf16, out, stream
    "sh_pair_contact_indexed": (_P, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I,
                                _P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _I,
                                _P, _I, _I, _I, _I, _I, _P, _P),
    # out, pi, pj, perm, both, valid, N, P, lists, f, tau, pe, virial,
    # part, part_n, stats, stream
    "sh_pair_reduce": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P, _P),
    # N
    "sh_pair_reduce_blocks": (_I,),
    # packed, tbl1, T, W, cap1, G, l1, bf16, P, out, stream
    "sh_stage1_depth": (_P, _P, _I, _I, _P, _I, _I, _I, _I, _P, _P),
    # packed, tbl, T, W, cap, G, par, lmax, B, rows_per_replica, kind,
    # out, stream
    "sh_wall_contact": (_P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P),
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of spherharm_tpu_torch cannot be built")


def library_path(sources=SOURCES, headers=HEADERS,
                 stem="libspherharm_kernels") -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in headers + sources:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build(ptxas_info: bool = False, sources=SOURCES, headers=HEADERS,
          stem="libspherharm_kernels"):
    """Compile ``sources`` (default: the kernels) unless the library for
    these sources exists.

    Returns (path, seconds spent compiling, compiler output)."""
    path = library_path(sources, headers, stem)
    if path.exists():
        return path, 0.0, ""
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    ptxas = ["-Xptxas", "-v"] if ptxas_info else []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        objs = [os.path.join(tmp, f"{name}.o") for name in sources]
        cmds = [[nvcc, *NVCC_FLAGS, *ptxas, "-I", str(CSRC), "-c", "-o", obj,
                 str(CSRC / name)] for name, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, *ARCH, "-shared", "-o", lib, *objs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(lib, path)  # atomic: concurrent builders never see a stub
    return path, time.perf_counter() - t0, "".join(logs)


@functools.cache
def library():
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sh_error_string.argtypes = (ctypes.c_int,)
    lib.sh_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def span_library():
    """The loaded span-mark library (``csrc/span_marks.cu``; built on
    first call), checked to hold every span of ``utils/spans.SPANS``."""
    from spherharm_tpu_torch.utils import spans

    lib = ctypes.CDLL(str(build(sources=SPAN_SOURCES, headers=(),
                                stem="libspherharm_spans")[0]))
    lib.sh_span_count.argtypes = ()
    lib.sh_span_count.restype = ctypes.c_int
    lib.sh_span_mark.argtypes = (_I, _P)
    lib.sh_span_mark.restype = ctypes.c_int
    lib.sh_span_error_string.argtypes = (ctypes.c_int,)
    lib.sh_span_error_string.restype = ctypes.c_char_p
    if lib.sh_span_count() != len(spans.SPANS):
        raise RuntimeError(f"csrc/span_marks.cu holds {lib.sh_span_count()} "
                           f"spans, utils/spans.SPANS {len(spans.SPANS)}")
    return lib


def check(err: int, what: str):
    """Raise if a kernel entry reported a CUDA error."""
    if err != 0:
        msg = library().sh_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
