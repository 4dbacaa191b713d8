"""spherharm_tpu_torch — the PyTorch + CUDA port of the SH DEM engine.

Same physics as ``spherharm_tpu`` (the JAX reference package beside it):
spherical-harmonic particles, both-sided cap-quadrature contact in the
conservative (exact-gradient) and the geometric elastic law, plane/cylinder
walls, cell-list or all-pairs neighbours with tag-keyed contact history,
pair-list or dense [N, K] force paths, rebuild-cadence prefilter,
quaternion velocity-Verlet.

Layout mirrors the reference (``core/``, ``ops/``, ``models/``, ``io/``,
``utils/``, ``parallel/`` with the replica ensemble). The hot
kernels are hand-written CUDA C++ for sm_90a (``csrc/``), built with nvcc
at first use and bound with ctypes (``ops/cuda_build.py``). Tensor device
decides the route: CUDA tensors launch the kernels, CPU tensors take each
kernel's plain PyTorch twin. Every builder defaults to ``device="cuda"``;
pass ``device="cpu"`` to run on the CPU.

f32 throughout, except the reference's bfloat16 kernel variants (K3 under
SPHERHARM_STAGE2_BF16=1, K5 by argument); TF32 is switched off here, at
package import.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from spherharm_tpu_torch.core.state import (  # noqa: E402,F401
    NeighborState,
    Shapes,
    SimParams,
    State,
)
from spherharm_tpu_torch.core.simulation import Simulation  # noqa: E402,F401
