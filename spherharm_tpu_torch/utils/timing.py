"""Per-section timing breakdown (torch twin of
``spherharm_tpu/utils/timing.py``): the reference Timer's 5-bucket table.

LAMMPS accumulates wall time per section (Pair, Neigh, Comm, Modify,
Output). This harness times dedicated eager calls of each stage on the
live state (``Simulation.run`` replays CUDA graphs of whole steps on the
card; these calls run the stages' ops one by one): CUDA events around the calls on the card
(the device's time, launches queued back to back), ``time.perf_counter``
on the CPU. These are measurement tools, not a benchmark.

``trace`` wraps ``torch.profiler`` for deep dives.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

from spherharm_tpu_torch.ops import integrate

# Default trace directory: build/ beside the package (listed in
# .gitignore).
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "spherharm_trace"


def _timeit(fn, device, repeats=3):
    """Seconds per call of fn(), after one warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / 1e3 / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) / repeats


def breakdown(sim, state, neigh, repeats: int = 3) -> dict:
    """Time each pipeline section on one device. Returns {section:
    seconds-per-call}:
      Pair    - contact force evaluation (pair and wall kernels)
      Neigh   - full neighbour rebuild (bin + list + history remap + pair
                list + prefilter)
      Comm    - halo exchange: 0 on one device (no ghosts)
      Modify  - integration (initial + final half-steps)
      Output  - thermo reduction
    """
    dev = state.x.device
    return {
        "Pair": _timeit(lambda: sim.compute_forces(state, neigh), dev,
                        repeats),
        "Neigh": _timeit(lambda: sim._rebuild(state, neigh), dev, repeats),
        "Comm": 0.0,
        "Modify": _timeit(lambda: integrate.final_integrate(
            integrate.initial_integrate(state, sim.shapes, sim.params),
            sim.shapes, sim.params), dev, repeats),
        "Output": _timeit(lambda: sim.thermo(state, neigh)["etot"], dev,
                          repeats),
    }


def print_breakdown(sections: dict, total_step_s: float | None = None):
    """Render the LAMMPS-style timing table."""
    tot = sum(sections.values())
    print(f"{'Section':<10}{'time/call (s)':>16}{'% of sections':>16}")
    for k, v in sections.items():
        pct = 100.0 * v / tot if tot else 0.0
        print(f"{k:<10}{v:>16.5f}{pct:>15.1f}%")
    if total_step_s is not None:
        print(f"{'Step':<10}{total_step_s:>16.5f}  (measured step)")


@contextlib.contextmanager
def trace(logdir=TRACE_DIR):
    """torch.profiler over the block (CPU and, where there is a card, CUDA
    activity); writes a Chrome trace ``trace.json`` into ``logdir`` and
    yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))
