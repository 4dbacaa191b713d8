"""Smoke run of the PyTorch + CUDA port (spherharm_tpu_torch) on one GPU.

    python3 chip_smoke.py            # one NVIDIA GPU, from the repo root
    python3 chip_smoke.py --profile  # + each path's eager torch.profiler
                                     #   table (build/chip_smoke_profile_*.txt)
    python3 chip_smoke.py --ranks 4  # four GPUs: the sharded paths one shard
                                     #   a card over NCCL (``ranks_main``)

Phases, each fatal on failure (exit code != 0, no result line):

1. build the CUDA kernels from ``spherharm_tpu_torch/csrc`` (nvcc, sm_90a,
   one process per source, in parallel); print ptxas's registers and
   spills, and the instruction mix of the Lmax-8 node loops of both
   stage-2 laws, f32 and bf16, of both wall kinds and of the stage-1
   probe (Lmax 8 f32, K4; l1 4 bf16, K5) (cuobjdump);
2. set up, on the card, the main-path drum (``rotating_drum`` at
   n = 100,000, Lmax 8, 4 blob types, k_max 24, pair cap 5n, stage-2 cap
   3n, cadence R = 20, conservative law), the full-width deposition
   (``deposition`` at n = 10,000 with its own defaults: Lmax 8, 4 blob
   types, 12x24 = 288 cap nodes, geometric law, pair cap 10n,
   skin-triggered rebuild), the settling box (``settling_box`` at
   n = 500: Lmax 2, one type, 128 cap nodes, 5 plane walls, dense path)
   the drift gas (``models/drift.build_gas`` at n = 10,000: the
   reference's energy-drift harness, a periodic undamped NVE gas of Lmax 8
   blobs, 128 cap nodes, pair cap 6n, stage-2 cap 3n, conservative law)
   and the sheared triaxial cell (``triaxial_cell`` at n = 100,000,
   config 5: Lmax 4, 2 blob types, 6x12 = 72 cap nodes, geometric law,
   pair cap 12n, skin-triggered rebuild, strain rate -0.05 on each axis,
   shear_rate (0.05, 0, 0) so triclinic, no servo; ``deform_min`` 0.8);
3. every kernel vs its plain twin at the shapes each path gives it, on
   contact-rich synthetic inputs built from that path's shapes and
   parameters: K1 on the drum (Lmax 8, 128 nodes); K2 on the deposition
   (Lmax 8, 288 nodes), the drum's shapes (Lmax 8, 128) and the settling
   box (Lmax 2, 128); K3 (bf16 chains) conservative on the drift gas
   (Lmax 8, 128) and geometric on the deposition (288); K4 on 16,384
   pairs of the drum's shapes (32 nodes; the batch the unit tests
   mirror); K6 on the drum and the deposition; K7 on the drum, the
   deposition and the settling box's floor; K2 on the triaxial cell's
   shapes (Lmax 4, 72 nodes: 3-node blocks, the last partial); K1 on the
   drum's and K2 on the triaxial cell's shapes with a two-material
   ``pair_tab`` (``with_pair_coeffs``: one explicit (0, 1) entry, the
   rest from the scalars and geometric mixing); and with R = 4 replicas
   in one launch (``ensemble_kernel_cases``: each replica's rows with its
   own dt, kn, gamma_n and mu, par [4, 16] / [4, 24]) K1 and K3
   conservative on the drum's shapes, K2 and K3 geometric on the
   deposition's, K6 and K7 on the deposition's walls, each held to the
   batched twin and the batched twin to one twin call a replica. Forces,
   springs and pe against the stated tolerances, contact-flag flips,
   CUDA-event times of a wrapper call and of the plain PyTorch twin, the
   kernel's own device time (``device_ms``: 20 launches back to back
   between CUDA events) and its bound, per case;
4. small contact-rich runs of 40 steps on the card and on the CPU (plain
   twins), thermo and positions compared: the drum (n = 128, Lmax 8), the
   deposition (n = 128, Lmax 8, 288 nodes) and the settling box (n = 64,
   Lmax 2, dense [N, K] path); and the sheared triaxial cell (n = 128,
   fill 0.09 so its grid has 3 cells an axis, xy shear 0.05, the servo
   on), its xy tilt started 5e-5 Lx under Lx/2 so the shear flips it:
   flips (at least one), image counters, tilt, box, thermo, press and
   the stress tensor compared; then two R = 3 replica ensembles through
   ``ensemble.run_replicas`` (``ensemble_card_vs_cpu``): the n = 128
   deposition with a mu sweep and the n = 128 conservative drum with
   the prefilter and a gamma_n sweep (K1, K4, K6, K7), thermo and
   positions per replica; then the slabs (``sharded_card_vs_cpu``):
   ``dryrun_sharded(4)``, the sheared triaxial cell at n = 1,000 on 4
   slabs (xy shear 0.05, ``deform_min`` 0.8, compressed into contact;
   n = 128 is too small a box for 4 slabs under the 0.12-box tilt pad)
   and 2 slabs with x not periodic and a plane floor (K7, wall springs
   migrating), 40 steps each on the card and on the CPU: thermo, stress,
   tilt, box, images and positions by tag; then the bricks the same way
   (``sharded_card_vs_cpu(brick=True)``): ``dryrun_brick`` on (2, 2) and
   on (2, 2, 2), the n = 1,000 sheared cell on a (2, 2, 2) brick
   (``brick_triaxial_sim``) and a (2, 2) brick with x and z not periodic
   and a plane floor (K7, wall springs migrating along both axes);
5. the paths, each through the entry point a user calls (``Simulation.
   run``, ``ensemble.run_replicas``, the deck's ``run``), which replays
   CUDA graphs of the step (``core/runner.py``). Each path first runs
   ``graph_vs_eager`` from its start: a few steps (``*_EAGER``; the
   drum's 25 at R = 20 are a cadence block and a remainder) eagerly
   (``cuda_graphs=False``; host-clock rate, then its first 20 steps
   again under torch.profiler for the device's ms a step) and as graph
   replays
   (capturing them), and once more from the cached graphs under
   ``torch.cuda.set_sync_debug_mode("error")``: both graph runs equal the
   eager run bit for bit in every State and NeighborState field (x, v,
   q, angmom, image, tilt, box, springs, overflow, skin_violations, ...),
   with equal kernel launch counts (the wrappers count a graph's launches
   on each replay); then one eager plain step and one eager rebuild step
   under the same sync debug mode (check mode's one read a step, an event
   synchronisation, is not one it sees). Then its run, with every launch
   counter set to 0 just before it and read just after, prints eager and
   graph particle-steps/s, the graph run's device busy share (the eager
   profile's device ms a step over the graph run's ms a step), capture
   seconds and graph pool bytes: 60 steps (3 cadence blocks) of the
   n = 100k drum; 100
   steps of the n = 10k deposition from a contact-rich start; 200 steps of
   the n = 500 settling box (5 plane walls, dense path) from its lattice
   pressed onto the floor; 2,000 steps of the n = 10k drift gas after
   3,000 unmeasured ones from its lattice (its first contacts form after
   ~1,800), etot and pe_pair sampled every 100 steps (the series and the
   fitted slope printed); 60 steps of the n = 100k sheared triaxial cell
   from its lattice compressed into contact (mean coordination printed
   at its start and end; finite stress; pe_pair > 0 at start and end; its
   xy tilt held to the reference's recurrence replayed in float64); and
   right after the deposition the replica ensemble (``ensemble_path``):
   that deposition replicated to 8 replicas with mu swept 0.1-0.8, 100
   steps of ``ensemble.run_replicas`` (80,000 particles, 800,000 pair
   slots), overflow 0, finite etot and pair contacts in every replica,
   replicas 0 and 7 held to single card runs of the same start with
   their own mu, which launch K2, K6 and K7 as often as the ensemble
   did. Guards:
   overflow = 0, finite etot, every kernel
   of the path launched (and skin_violations = 0 for the drum's cadence,
   pair contacts by the end of the deposition and settling box, and at
   every sample of the gas); particle-steps/s of each;
5b. the slab decomposition's paths (``ShardedSimulation.run`` on
   N_SHARDS = 4 slabs, CUDA graphs of its units ``pre`` / ``pre_check``,
   ``always`` / ``rebuild`` / ``comm``, ``post``; ``sharded_path``), each
   run counted from its first step, fatal unless it replayed a rebuild
   graph, with ``graph_vs_eager`` over the first run of steps that
   rebuilt, its rates, the rebuilds, the tags that changed slab, the
   ghosts of each slab and the largest halo send against ``halo_cap``:
   right after the triaxial cell, the n = 100k sheared cell on 4 slabs
   (``triaxial_cell(sharded=True)``, the reference's capacities, a
   rebuild every SHARD_TRI_EVERY steps) from the same start, its forces
   after ``init`` within 2e-3 |F|max of the single cell's, 60 steps held
   to the single run's end with the reference's sharded-vs-single bounds
   (tests/test_sharded.py:90-103: x 2e-3, v 5e-3, ke and etot rel 1e-3,
   stress rtol 2e-2 / atol 1e-3), then K2 on its 4 x 300,000-slot pair
   lists; right after the drift gas, the n = 10k gas on 4 slabs from the
   gas's step 5,000 (forces after ``init`` within 1e-4 |F|max on all but
   0.1 % of the rows away from the periodic x seam, none past 2e-2, and
   none past 2e-3 within the halo depth of the seam; ``seam_witness``:
   the seam rows' gap in float32 and float64 on the CPU twins, the
   float64 one under 1e-9), on its skin trigger until a run of
   SHARD_GAS_BLOCK steps has rebuilt, its first 200 steps held to 200
   single card steps with the same bounds, its forces at the end of the
   run held to a fresh single build at the same positions, then K1 on
   its stage-2 lists and K4 on the candidate lists a rebuild of the slabs
   builds;
5c. the brick decomposition's paths (``BrickSimulation.run`` on a
   BRICK = (2, 2, 2) brick, the same graph units, ``sharded_path``: the
   ghosts of each phase and the largest send of each axis, the tags that
   changed brick along each axis and along two or more), each right
   after its slab path and driven as it: the n = 100k sheared cell
   (``brick_triaxial_sim``: cap_local 4n/S, halo_cap n/S a side for each
   axis, pair cap 12n/S, cell_cap 12, the tilt pad 0.12 box along x
   only) from the same start, a rebuild every SHARD_TRI_EVERY steps, its
   forces after ``init`` within 2e-3 |F|max of the single cell's, 60
   steps held to the single run's end with the same bounds, then K2 on
   its 8 x 150,000-slot pair lists; the n = 10k gas from step 5,000 on
   (2, 2, 2) (cap_local 4n/S, halo_cap 2n/S, pair cap 8n/S, stage-2 cap
   4n/S), its forces after ``init`` within 1e-4 |F|max away from the
   periodic seams of all three axes and within 2e-3 near them, on its
   skin trigger until a run has rebuilt, its first 200 steps held to the
   single card run, its forces at the end held to a fresh single build,
   then K1 on its stage-2 lists and K4 on its candidate lists;
5d. right after the bricks' triaxial path, one shard a process
   (``rank_phase``): one ``parallel/ranks.spawn_ranks`` call starts RANKS
   gloo processes on this card (eager by name: gloo stages CUDA tensors
   through host memory), which run ``dryrun_sharded(RANKS)`` and
   ``dryrun_brick(RANK_BRICK)`` (held to the one-process card runs), the
   sheared cell at n = SHARD_TRI_SMALL on RANKS rank slabs for 40 steps
   (held to the one-process RANKS-slab card run: per tag 1e-3, thermo
   2e-3; bit-equality printed) and the n = N_TRI sheared cell on RANKS
   rank slabs (``triaxial_cell(sharded=True, axis=RankAxis(...))``),
   TRI_STEPS steps a rebuild every SHARD_TRI_EVERY, held to the single
   card run with the reference's sharded bounds; each rank's ms a step,
   p2p bytes, rebuilds, ghosts and launches printed; fatal if a rank
   fails or K2 did not launch in every rank;
6. each law's kernels on its path's own stage-2 list after the path's
   run: K2 and K3 geometric on the deposition's (all 100,000 slots, pair
   cap 10n, no prefilter), K2 on the 8-replica ensemble's (800,000 slots,
   one launch; each replica's rows with its own par row) and K6/K7 on
   its wall batches (8 x wall_capacity rows), K2 on the triaxial cell's
   (1,200,000 slots),
   K1 and K3 conservative on the drift gas's (30,000 slots); each list
   timed whole, up to 16,384 live rows held to
   the twin and every masked row to zero;
   K4 on the candidate list a rebuild builds after the path's run, on the
   drum's (all 500,000 slots, pair cap 5n) and the drift gas's (60,000):
   the row classes printed, each list timed whole, up to 16,384 probed
   rows held to the twin, every dead row to -1e9 and every
   sphere-separated row to rsum - dist; K5 (l1 = 4, f32 and bf16) vs its
   twin on the drift gas's list with the tail column: K5 >= K4 on every
   probed row, fatal otherwise;
7. the bf16 phase in a child process started with
   SPHERHARM_STAGE2_BF16=1: the drift gas (as in step 5) and the
   deposition (100 steps) with every stage-2 call through K3. Guards: K3
   launched in both laws, no K1/K2 launch, overflow = 0, finite etot; the
   child's failure fails the run. Prints etot bf16 - f32 at equal steps
   and both slopes;
8. (run between the triaxial cell's path and the drift gas's) the deck
   runner, ``spherharm_tpu_torch.io.deck``: every ``examples/*.in`` deck,
   and ``two_materials.in`` again with ``conservative off``, on the card
   (counters set to 0 just before each) and on the CPU, cut to 30 steps
   (``deck_cuts``), dumps into build/chip_smoke_decks/: thermo
   etot, ke and pe_pair within rtol 2e-3, positions within 1e-3, the same
   ids in every dump frame, overflow 0 (``DECKS_THAT_OVERFLOW``: the CPU's
   count; they overflow in the reference too); then ``DRUM_DECK``, ``examples/drum.in`` at
   full size (Lmax 8, conservative, no prefilter, pair cap 4n, k_max 32,
   cell_cap 12: the deck's own capacities), its set-up, ``graph_vs_eager``
   over 30 steps of its Simulation, then its 60 steps, on the card only:
   particle-steps/s, pe_pair at start and end, K1/K6/K7 launches, the
   dump's bytes, formatter and write time. Guards: overflow 0, finite
   etot, pe_pair > 0 at step 0, K1, K6 and K7 launched, the native
   formatter, the dump read back with the state's tags. Then K1 on that
   deck's own pair list after its run (all 357,120 slots, as in step 6).
9. the reference's validation harnesses (``spherharm_tpu_torch/validation``),
   each through its module's functions at a cut length, counters set to
   0 just before each and read just after: right after the drum's path,
   on the warm drum, the cadence sweep (``cadence_phase``: the rebuild
   step, the plain step and a block of 20 as graph replays between CUDA
   events; one row per cadence of CADENCES, one block each) and the
   span profile (``profile_step``'s table of the step's spans); after the drift gas (``validation_phase``)
   the four blobs under the geometric law (K2) and the conservative law
   (K1) and the Lmax-0 collider (K1), each until a collision and a
   free-flight sample after it (drift and rate printed), the restitution
   sweep (R = 8, 3,000 steps, the script's asserts, its table within
   1e-3 of the module's run on the CPU in a child process), the settling
   box's first PACK_BLOCKS blocks (phi, ke, overflow 0, no particle lost)
   and the conservative probe's three rows (geom K2, auto the autograd
   twin, cons K1; the bounce reached). Step 3 holds K1 and K2 at the four
   blobs' 10x20 = 200 cap nodes and K1 at the collider's spheres to their
   twins.

Prints each path's eager and graph rates, busy share, capture seconds
and pool bytes in one JSON line (``GRAPH_ROWS``), the kernels ranked by
launches x (device_ms - bound_ms) over this run (``ranking``; each path's launches at that path's own candidate list,
else its stage-2 list, else its batch), the card's name and power limit
(nvidia-smi), one JSON line with the kernels' launches, errors, times and
bounds (at the top level of each kernel the case the ranking prices for
its first path, every case under ``cases``; K3's
launches are the child's, K5's those of step 6; ``ms`` is a wrapper call
timed by CUDA events, ``device_ms`` the kernel alone), and as the last
line ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA
device.

With ``--ranks RANKS`` (RANKS cards; fewer is a failure): the n = N_TRI
sheared cell on RANKS slabs and on a RANK_BRICK brick and the n = N_GAS
gas on RANKS slabs, one shard a card over NCCL with CUDA graphs
(``ranks_main``: the single and one-card shard-axis runs of the same call
first, ``rank_references``; each rank's graph and eager ms a step, rate,
p2p bytes a step, NCCL kernels' share of the device time, busy share,
ghosts, migrants; each rank's graph run bit-equal to its eager run, each
path held to its single card run and to the one-card shard-axis run with
the reference's sharded bounds), and the contract line with ``count``
RANKS.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_MAIN, LMAX, STEPS, R_EVERY = 100_000, 8, 60, 20
N_DEP, DEP_STEPS = 10_000, 100
N_SETTLE, SETTLE_STEPS = 500, 200
N_GAS, GAS_WARM, GAS_STEPS, GAS_EVERY = 10_000, 3000, 2000, 100
# The triaxial cell: shear (0.05, 0, 0) as the reference's config-5 shear
# test (tests/test_triclinic.py:111). deform_min 0.8, not triaxial_cell's
# default 0.6: at 0.6 the tilt-inflated grid has 18 cells an axis for the 47
# lattice sites, 17.8 particles a cell against cell_cap 16 (overflow).
N_TRI, TRI_STEPS, TRI_SHEAR, TRI_DEFORM_MIN = 100_000, 60, (0.05, 0.0, 0.0), 0.8
# The slab decomposition (parallel/halo.py): N_SHARDS slabs on the shard
# axis of the card's tensors. The sheared cell's tilt pad (0.12 box) caps
# S at 4: the narrowest slab must reach 2.4 rmax + 0.12 box. Its small
# card-vs-CPU case runs n = SHARD_TRI_SMALL at the builder's fill: at
# n = 128 (fill 0.09) a quarter of the box (2.27) is under that depth
# (2.35). Each sharded path's run rebuilds inside it: the n = 100k sheared
# cell on a cadence of SHARD_TRI_EVERY steps (its TRI_STEPS steps hold
# three rebuilds), the n = 10k gas on its skin trigger (about one rebuild
# in 700 steps on the single gas) in blocks of SHARD_GAS_BLOCK steps until
# a block has rebuilt, at most SHARD_GAS_BLOCKS blocks; the gas's
# trajectory is held to the single card run's over its first
# SHARD_GAS_STEPS steps.
N_SHARDS, SHARD_TRI_SMALL, SHARD_TRI_EVERY, SHARD_GAS_STEPS = 4, 1000, 20, 200
SHARD_GAS_BLOCK, SHARD_GAS_BLOCKS = 100, 30
# The brick decomposition (parallel/brick.py): the same two cells, the same
# cadence, trigger and horizons, on a BRICK brick on the shard axis.
BRICK = (2, 2, 2)
BRICK_TRI = "triaxial brick 2x2x2"
BRICK_GAS = "drift gas brick 2x2x2"
# One shard a process (parallel/ranks.py): RANKS ranks, as slabs or a
# RANK_BRICK brick; the default run spawns them as gloo processes on its one
# card, ``--ranks RANKS`` as NCCL ranks one a card. A rank phase that has
# not returned in RANK_TIMEOUT seconds fails.
RANKS, RANK_BRICK, RANK_TIMEOUT = 4, (2, 2), 900.0
# The two-material (0, 1) pair_coeff row: kn, kt, gamma_n, gamma_t, mu,
# k_roll, gamma_roll, mu_roll.
TWO_MATERIAL = (3e5, 1e5, 30.0, 10.0, 0.2, 1e4, 5.0, 0.1)
N_PAIRS = 16_384  # kernel-vs-plain batch (the autograd twin's memory bound)
# The replica ensemble: config 3's deposition replicated N_ENS times with a
# friction sweep, ENS_STEPS steps; the R = ENS_CASE_R kernel cases and the
# R = ENS_CHECK_R card-vs-CPU ensembles.
N_ENS, ENS_STEPS, ENS_MU = 8, 100, (0.1, 0.8)
# Eager steps beside each path's graph run (graph_vs_eager: the bit-for-bit
# reference, the eager rate, the eager profile's device time): the drum's
# one cadence block and a remainder; fewer than the path's own steps where
# the eager step is slow.
DRUM_EAGER, DEP_EAGER, ENS_EAGER, SETTLE_EAGER = 25, 50, 30, 100
TRI_EAGER, GAS_EAGER, DECK_EAGER = 30, 200, 30
# Eager steps under torch.profiler for a path's device time a step (the
# first steps of its eager run; one cadence block on the drum): the
# profiler's processing of a window grows with its events.
PROFILE_STEPS = 20
# --profile: each path's eager profile table under build/.
PROFILE_TABLES = False
ENS_CASE_R, ENS_CHECK_R = 4, 3
# The reference's validation harnesses (spherharm_tpu_torch/validation/) at
# cut lengths: the four blobs under each law (the geometric law at each of
# FOUR_BLOB_SEEDS) and the collider, etot read every *_BLOCK steps (shorter
# than a collision: about 540 steps for the blobs, 117 for the spheres, so
# every collision shows as a mid-contact sample); the restitution sweep at
# the script's R and length; the settling box's first blocks; the probe's
# bounce at the script's length; the drum's cadences (CADENCES, 0 the skin
# trigger), one block each.
FOUR_BLOB_STEPS, FOUR_BLOB_BLOCK = 12_000, 250
FOUR_BLOB_SEEDS = (0, 1, 2, 3)
COLLIDER_STEPS, COLLIDER_BLOCK = 6_000, 100
REST_R, REST_STEPS = 8, 3000
PACK_BLOCKS, PACK_BLOCK = 2, 1000
PROBE_STEPS = 8000
CADENCES = (20, 40, 80, 0)
# NVIDIA H100 SXM data sheet: f32 (non-tensor) peak and HBM3 rate. A
# kernel's operations are timed at the peak of their type: the bf16
# Horner FLOPs of K3 and K5 at the bf16 non-tensor peak (133.8 TFLOP/s,
# NVIDIA H100 Tensor Core GPU Architecture whitepaper), the rest at f32.
F32_PEAK, BF16_PEAK, HBM_RATE = 67e12, 133.8e12, 3.35e12
BF16_CHILD = "--bf16-child"


def horner_flops(lmax, grad=True, bf16=False):
    """FLOPs of one shk::radius_grad_power (grad) or radius_power_ab call at
    degree lmax (csrc/sh_device.cuh), counted from its loops: an FMA counts
    2, any other arithmetic op (div, sqrt, min, max included) 1. Returns
    (f32 FLOPs, bf16 FLOPs): with bf16 the Horner chains of
    radius_grad_power, and all of radius_power_ab, run in bfloat16."""
    chains = 2 * lmax + (2 * max(lmax - 1, 0) if grad else 0)
    rest = 1 if grad else 0
    for m in range(1, lmax + 1):
        chains += 8 * (lmax - m) + 4 if grad else 4 * (lmax - m)
        rest += (6 if m > 1 else 0) + 1 + (13 if grad else 4)
    if not bf16:
        return chains + rest, 0
    return (rest, chains) if grad else (0, chains + rest)


def node_flops():
    """Each kernel's work per cap node, from the ``node-flops[...]`` line
    beside its node loop in csrc/: {name: (FLOPs besides the surface
    evaluations, evaluations, gradient or not, bf16 or not, probe
    sides)}."""
    pat = re.compile(r"node-flops\[(\w+)\]: (\d+) \+ (\d+) x "
                     r"(radius_grad_power|radius_power_ab)(_bf16)? per node "
                     r"and side, (\d) sides?")
    table = {}
    for src in sorted((ROOT / "spherharm_tpu_torch" / "csrc").glob("*.cu")):
        for m in pat.finditer(src.read_text()):
            table[m[1]] = (int(m[2]), int(m[3]), m[4] == "radius_grad_power",
                           bool(m[5]), int(m[6]))
    return table


def bound(name, lmax, G, work_rows, bytes_moved):
    """Least time (ms) the card could take: the larger of the node work of
    this run's working rows (masked and skipped rows do none), each type of
    operation over its peak, and the bytes (each input read once, each
    output written once) over the HBM rate. ``lmax``: the degree the
    surfaces are evaluated at."""
    extra, evals, grad, bf16, sides = node_flops()[name]
    f32_ev, bf16_ev = horner_flops(lmax, grad, bf16)
    nodes = work_rows * G * sides
    t_ops = nodes * ((extra + evals * f32_ev) / F32_PEAK
                     + evals * bf16_ev / BF16_PEAK)
    t_bytes = bytes_moved / HBM_RATE
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def stage1_bytes(packed, alive, probed, *once):
    """Bytes the stage-1 probe must move over a [P, 64] list, by row class
    in 32-byte sectors: a dead row (masked, or d = 0) only the sector of
    its mask and d; a live row apart by its bounding spheres the sectors
    of mask, d, rbi and rbj; a probed row the sectors of every slot the
    probe reads; ``once`` (tables, cap grid, output) whole."""
    from spherharm_tpu_torch.ops import contact_kernels as ck

    def row_bytes(*names):
        return 32 * len({4 * c // 32 for n in names for c in range(*ck.SLOTS[n])})

    n_alive, n_probed = int(alive.sum()), int(probed.sum())
    return (row_bytes("mask", "d") * (packed.shape[0] - n_alive)
            + row_bytes("mask", "d", "rbi", "rbj") * (n_alive - n_probed)
            + row_bytes("qi", "qj", "rbi", "rbj", "rmi", "rmj", "mask", "d", "tail",
                        "typ", "scl") * n_probed
            + nbytes(*once))


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps):
    """Mean CUDA-event time of fn() over reps calls, after one warm-up: for
    a kernel's wrapper, the time a call takes, which for a kernel shorter
    than the wrapper's host work is the host's issue interval."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# Each kernel-line name's C entry in csrc/ (device_ms times its launches).
ENTRIES = {"pair_contact": "sh_pair_contact", "stage1_depth": "sh_stage1_depth",
           "wall": "sh_wall_contact"}

# Cycles the stream spins before the timed launches (about 5 ms at the
# H100's clock; four times more at each retake): the host queues the start
# event, the launches and the stop event while the stream is still busy.
SPIN_CYCLES = 10_000_000


def kernel_entry(name):
    return next(entry for key, entry in ENTRIES.items() if name.startswith(key))


def device_ms(fn, entry, reps=20):
    """Device time a launch of the kernel that the C entry ``entry``
    launches, at fn()'s inputs: after one warm-up call, one more call of
    fn() whose call of the entry becomes reps calls with its arguments,
    queued back to back between two CUDA events behind a spin kernel, so
    the interval is the stream's time on the reps launches (each kernel's
    run and the stream's start of the next), not the host's issue time.
    Retaken with a longer spin if the stream reached the start event
    before the host had queued the stop event; fails after three such
    windows, or unless fn() called the entry once."""
    import torch
    from spherharm_tpu_torch.ops import cuda_build

    lib = cuda_build.library()
    raw = getattr(lib, entry)
    fn()
    for window in range(3):
        marks = []

        def timed(*args):
            torch.cuda._sleep(SPIN_CYCLES * 4 ** window)
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            errs = [raw(*args) for _ in range(reps)]
            stop.record()
            marks.append((start, stop, start.query()))
            return next((e for e in errs if e), 0)

        setattr(lib, entry, timed)
        try:
            fn()
        finally:
            setattr(lib, entry, raw)
        torch.cuda.synchronize()
        require(len(marks) == 1, f"{entry} was called {len(marks)} times in one call, "
                "once expected")
        start, stop, reached = marks[0]
        if not reached:
            return start.elapsed_time(stop) / reps
        print(f"  device_ms: the stream reached {entry}'s start event before its "
              f"launches were queued (window {window + 1} of 3)")
    require(False, f"device_ms: no window of {entry} was queued behind its spin")


def print_node_loop_sass(lib, nvcc):
    """Print the instruction mix of the node loops of the stage-2 kernels
    of both laws at Lmax 8 (f32 and bf16; the geometric kernel's at each
    node block NB), of the wall kernel of both kinds at Lmax 8 (each NB)
    and of the stage-1 probe at Lmax 8 f32 (K4) and l1 4 bf16 (K5) in
    ``lib``'s SASS: in each, the longest backward branch whose body holds
    no shuffle (the side sums and the probe's max come after the loop).
    Reads the library only; prints a note instead where cuobjdump is
    missing."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    if not cuobjdump.exists():
        print(f"  sass: {cuobjdump} not found")
        return
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        print(f"  sass: cuobjdump failed ({proc.returncode}): {proc.stderr[-300:]}")
        return
    for fn in re.split(r"\n\s*Function : ", proc.stdout)[1:]:
        head = fn.split("\n", 1)[0]
        m = re.search(r"pair_(conservative|geometric)_kernelILi8ELb([01])E(?:Li(\d)E)?", head)
        w = re.search(r"wall_kernelILi([01])ELi8ELi(\d)E", head)
        s1 = re.search(r"stage1_kernelILi(8ELb0|4ELb1)E", head)
        if not (m or w or s1):
            continue
        ops = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", fn)]
        body = lambda lo, hi: [op for a, op in ops if lo <= a <= hi]
        loops = [(int(t, 16), int(a, 16)) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/[^\n]*?BRA (0x[0-9a-f]+)", fn)]
        loops = [(t, a) for t, a in loops if t < a and "SHFL" not in body(t, a)]
        if not loops:
            continue
        mix = collections.Counter(body(*max(loops, key=lambda ta: ta[1] - ta[0])))
        if s1:
            label = "stage1 " + ("<8,f32>" if s1.group(1) == "8ELb0" else "<4,bf16>")
        elif w:
            label = f"wall_{('plane', 'cylinder')[int(w.group(1))]} <8,NB={w.group(2)}>"
        else:
            label = f"{m.group(1)} <8," + ("bf16" if m.group(2) == "1" else "f32") + (
                f",NB={m.group(3)}" if m.group(3) else "") + ">"
        print(f"  sass {label} node loop: "
              f"{sum(mix.values())} instructions; "
              + " ".join(f"{op}={n}" for op, n in mix.most_common(16)))


def contact_pairs(sim, dev, rng):
    """N_PAIRS synthetic pairs (2k, 2k+1) of the drum's shapes: surfaces
    from 15% overlapped to 20% apart (rchar scale), random orientations,
    velocities, spins and mid-contact springs; 2% masked rows."""
    import torch

    from spherharm_tpu_torch.models.scenarios import make_state

    P = N_PAIRS
    T = sim.shapes.n_types
    shtype = rng.integers(0, T, 2 * P)
    scale = rng.uniform(0.75, 1.25, 2 * P)
    rc = sim.shapes.rchar.double().cpu().numpy()[shtype] * scale
    e = rng.normal(size=(P, 3))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    dist = rng.uniform(0.85, 1.2, P) * (rc[0::2] + rc[1::2])
    x = np.empty((2 * P, 3))
    x[0::2] = rng.uniform(-5, 5, (P, 3))
    x[1::2] = x[0::2] + dist[:, None] * e
    q = rng.normal(size=(2 * P, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    st = make_state(x, [-8, -8, -8], [8, 8, 8], v=rng.normal(size=(2 * P, 3)) * 0.5,
                    q=q, angmom=rng.normal(size=(2 * P, 3)) * 0.02, scale=scale,
                    shtype=shtype, device=dev)
    pi = torch.arange(0, 2 * P, 2, device=dev)
    pj = pi + 1
    mask = torch.as_tensor(rng.uniform(size=P) > 0.02, device=dev)
    hist = torch.as_tensor(rng.normal(size=(P, 6)) * 1e-4, dtype=torch.float32,
                           device=dev)
    return st, pi, pj, mask, hist, st.x[pj] - st.x[pi]


def wall_particles(sim, wall, kind, B, dev, rng):
    """B particles of the path's shapes whose centres sit 0.7-1.05 rchar
    from ``wall`` (most touch it): inside the drum's cylinder (axis y,
    between its caps) or on the inner side of a plane wall."""
    from spherharm_tpu_torch.models.scenarios import make_state

    T = sim.shapes.n_types
    shtype = rng.integers(0, T, B)
    scale = rng.uniform(0.75, 1.25, B)
    rc = sim.shapes.rchar.double().cpu().numpy()[shtype] * scale
    gap = rng.uniform(0.7, 1.05, B) * rc
    if kind == "cylinder":
        R = float(wall.radius)
        y_cap = float(sim.walls[1].point[1])
        ang = rng.uniform(0, 2 * np.pi, B)
        rad = R - gap
        x = np.stack([rad * np.cos(ang), rng.uniform(y_cap + 1, -y_cap - 1, B),
                      rad * np.sin(ang)], axis=1)
    else:
        p0 = wall.point.double().cpu().numpy()
        nrm = wall.normal.double().cpu().numpy()
        t1 = np.cross(nrm, [1.0, 0, 0] if abs(nrm[0]) < 0.9 else [0, 1.0, 0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(nrm, t1)
        u = rng.uniform(-5, 5, (B, 2))
        x = p0 + gap[:, None] * nrm + u[:, :1] * t1 + u[:, 1:] * t2
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return make_state(x, x.min(0) - 2, x.max(0) + 2,
                      v=rng.normal(size=(B, 3)) * 0.5, q=q,
                      angmom=rng.normal(size=(B, 3)) * 0.02, scale=scale,
                      shtype=shtype, device=dev)


def compare(out, ref, nf, f_tol, loose_rows=0):
    """Hold a kernel's output rows to its plain twin's: forces and torques
    (columns 0:nf) within f_tol |F|max; the springs (nf:nf+6) and pe
    (nf+6) within 1e-6 + 1e-4 of their group's largest value, on the rows
    whose contact flag (nf+7) agrees (a spring is zeroed when its contact
    ends, so a flipped flag, counted apart, moves it by its whole value).
    ``loose_rows`` rows of forces and pe may exceed their tolerance, and
    1% of rows of springs: the springs of grazing contacts rest on a few
    cap nodes, and the plain twin itself, with positions moved by one
    f32 ulp, moves 0.9% of the drum's cylinder rows beyond 1e-4 of the
    spring scale, by up to 9e-4 of it. No row exceeds 2e-2 of its group's
    largest value. Returns (ok, max force error, contact-flag flips,
    text)."""
    agree = (out[:, nf + 7] > 0.5) == (ref[:, nf + 7] > 0.5)
    ok, text = True, []
    for group, cols, rel, floor, rows, allowed in (
            ("F,tau", slice(0, nf), f_tol, 0.0, slice(None), loose_rows),
            ("springs", slice(nf, nf + 6), 1e-4, 1e-6, agree,
             max(out.shape[0] // 100, 1)),
            ("pe", slice(nf + 6, nf + 7), 1e-4, 1e-6, agree, loose_rows)):
        scale = float(ref[:, cols].abs().max())
        err = (out[rows][:, cols] - ref[rows][:, cols]).abs().amax(1)
        top = float(err.max())
        n_beyond = int((err > floor + rel * scale).sum())
        ok = ok and top <= floor + 2e-2 * scale and n_beyond <= allowed
        if group == "F,tau":
            f_err = top
        text.append(f"max|d {group}|={top:.3g} (tol {floor + rel * scale:.3g}; "
                    f"rows beyond {n_beyond}, allowed {allowed})")
    flips = int((~agree).sum())
    text.append(f"contact-flag flips={flips}")
    return ok, f_err, flips, " ".join(text)


def case(results, name, tag, lmax, G, rows, err, time_kernel, time_plain, work,
         moved, degree=None, **extra):
    """Time one kernel case: ``ms``, a wrapper call (CUDA events over 20
    calls); ``device_ms``, the kernel alone (``device_ms``: 20 launches
    queued back to back); ``plain_ms``, the plain twin (CUDA events over 3 calls). Its
    bound at evaluation degree ``degree`` (default lmax). Appends it, with
    ``extra``, to ``results[name]``."""
    c = dict(path=tag, lmax=lmax, G=G, rows=rows, max_abs_err=err,
             ms=cuda_ms(time_kernel, 20),
             device_ms=device_ms(time_kernel, kernel_entry(name)),
             plain_ms=cuda_ms(time_plain, 3),
             **bound(name, degree or lmax, G, work, moved), **extra)
    if degree is not None:
        c["l1"] = degree
    print(f"  {name} on {tag}: device {c['device_ms']:.4f} ms, wrapper call "
          f"{c['ms']:.4f} ms (plain {c['plain_ms']:.2f} ms, bound "
          f"{c['bound_ms']:.4f} ms, {c['bound_by']})")
    results.setdefault(name, []).append(c)


def pair_batch(results, conservative, tag, path, dev, rng, bf16=False, params=None):
    """K1 (``conservative``) or K2, or K3 with ``bf16``, against its plain
    twin on N_PAIRS synthetic pairs (``contact_pairs``) of ``path``'s
    shapes and parameters (``params``, where given): each row held to the
    twin, the case recorded under ``tag``."""
    import torch

    from spherharm_tpu_torch.ops import contact_kernels as ck

    law = "conservative" if conservative else "geometric"
    name = f"pair_contact_{law}" + ("_bf16" if bf16 else "")
    label = f"K{3 if bf16 else 1 if conservative else 2} {name} on {tag}"
    lmax = path.shapes.lmax
    st, pi, pj, mask, hist, d = contact_pairs(path, dev, rng)
    packed, tbl, cap, par = ck.pack_pairs(st, path.shapes, params or path.params,
                                          pi, pj, mask, hist, d)
    if params is not None:
        kn = packed[:, ck.SLOTS["mat"][0]].unique()
        print(f"{label}: pair_tab {tuple(params.pair_tab.shape)}, row kn values "
              f"{[float(k) for k in kn]}")
        require(kn.numel() > 1, f"{label}: every row has the same material")
    out = ck.pair_contact(packed, tbl, cap, par, lmax, conservative, bf16)
    ref = ck.pair_contact_plain(packed, tbl, cap, par, lmax, conservative, bf16)
    torch.cuda.synchronize()
    n_contact = int((ref[:, 16] > 0.5).sum())
    fmag = float(ref[:, 0:3].abs().max())
    # The conservative law is not smooth at the ulp level: d(s1) jumps
    # when a cap node crosses the partner's surface, so rounding alone
    # moves a few rows by up to ~1% (the plain twin itself, on inputs
    # perturbed by 2e-7 relative: 3 of 16,384 rows beyond 1e-4 |F|max,
    # the worst by 1% of its row): 0.1% of rows may exceed 1e-4, none
    # 2e-2. The geometric law holds every row to the reference's own
    # bound, 2e-3 |F|max (tests/test_pallas.py). K3 rounds its chains
    # as its twin does, op for op, but where an f32-ulp difference in
    # a node's cos(theta) crosses a bf16 rounding boundary the chains
    # differ by a bf16 ulp (first card run: at most 4 of 16,384 rows
    # beyond 1e-4 |F|max, the worst 5.1e-4; pe 3 rows beyond 1e-4): in
    # both laws 0.1% of rows may exceed 1e-4, none 2e-2.
    ok, err, flips, text = compare(
        out, ref, 9, 1e-4 if conservative or bf16 else 2e-3,
        N_PAIRS // 1000 if conservative or bf16 else 0)
    G = cap.shape[1]
    print(f"{label}: P={N_PAIRS} lmax={lmax} G={G} contacts={n_contact} "
          f"|F|max={fmag:.4g} {text}")
    require(n_contact > N_PAIRS // 4, f"{label}: batch has too few contacts")
    require(torch.isfinite(out).all(), f"{label}: output not finite")
    require(ok, f"{label}: disagrees with its plain twin")
    require(flips <= N_PAIRS // 1000, f"{label}: contact flags disagree")
    case(results, name, tag, lmax, G, N_PAIRS, err,
         lambda: ck.pair_contact(packed, tbl, cap, par, lmax, conservative, bf16),
         lambda: ck.pair_contact_plain(packed, tbl, cap, par, lmax, conservative,
                                       bf16),
         int((packed[:, ck.SLOTS["mask"][0]] > 0.5).sum()),
         nbytes(packed, tbl, cap, par, out))


def wall_batch(results, kind, tag, path, wall, B, dev, rng):
    """K6 (``kind`` "cylinder") or K7 against its plain twin on B synthetic
    particles of ``path``'s shapes touching ``wall`` (``wall_particles``),
    the case recorded under ``tag``."""
    import torch

    from spherharm_tpu_torch.ops import walls_kernels as wk
    from spherharm_tpu_torch.ops.rotation import omega_from_angmom

    label = f"K{6 if kind == 'cylinder' else 7} wall[{kind}] on {tag}"
    lmax = path.shapes.lmax
    ws = wall_particles(path, wall, kind, B, dev, rng)
    depth_c, n_c = wall.depth_and_normal(ws.x)
    om = omega_from_angmom(ws.q, ws.angmom, path.shapes.inertia_of(ws.shtype, ws.scale))
    whist = torch.as_tensor(rng.normal(size=(B, 6)) * 1e-4, dtype=torch.float32,
                            device=dev)
    args = wk.pack_wall(ws, path.shapes, path.params, wall, whist, depth_c, n_c, om)
    require(args[4] == kind, f"pack_wall picked {args[4]} for {kind}")
    out = wk.wall_contact_kernel(*args[:4], lmax, kind)
    ref = wk.wall_contact_plain(*args[:4], lmax, kind)
    torch.cuda.synchronize()
    n_contact = int((ref[:, 13] > 0.5).sum())
    fmag = float(ref[:, 0:3].abs().max())
    ok, err, flips, text = compare(out, ref, 6, 1e-4)
    G = args[2].shape[1]
    print(f"{label}: B={B} lmax={lmax} G={G} contacts={n_contact} "
          f"|F|max={fmag:.4g} {text}")
    require(n_contact > B // 4, f"{label}: batch has too few contacts")
    require(torch.isfinite(out).all(), f"{label}: output not finite")
    require(ok, f"{label}: disagrees with its plain twin")
    require(flips <= max(B // 1000, 1), f"{label}: contact flags disagree")
    case(results, f"wall_{kind}", tag, lmax, G, B, err,
         lambda: wk.wall_contact_kernel(*args[:4], lmax, kind),
         lambda: wk.wall_contact_plain(*args[:4], lmax, kind),
         int((args[0][:, 16] > 0.5).sum()), nbytes(*args[:4], out))


def kernel_phase(sim, dep, box, gas, tri, blobs, collider, dev):
    """Every kernel vs its plain twin at the shapes each path gives it
    (the drum ``sim``, the deposition ``dep``, the settling box ``box``,
    the drift gas ``gas``, the triaxial cell ``tri``, the validation
    harnesses' four blobs ``blobs`` and collider ``collider``); returns {kernel: [case, ...]}, the path's own
    shape first, each case with its error, times and bound. K5 runs later,
    on the drift gas's candidate list (``stage1_l1_phase``)."""
    import torch

    from spherharm_tpu_torch.ops import contact_kernels as ck

    rng = np.random.default_rng(7)
    results = {}
    mask_col = ck.SLOTS["mask"][0]
    for conservative, tag, path, bf16 in ((True, "drum", sim, False),
                                          (False, "deposition", dep, False),
                                          (False, "drum shapes", sim, False),
                                          (False, "settling box", box, False),
                                          (False, "triaxial", tri, False),
                                          (True, "drift gas", gas, True),
                                          (False, "deposition", dep, True)):
        pair_batch(results, conservative, tag, path, dev, rng, bf16=bf16)
    # The validation harnesses' shapes: the four blobs' 10 x 20 = 200 cap
    # nodes under both laws (the last node block of K2 partial), the
    # collider's Lmax-0 spheres (288) under K1.
    for conservative, tag, path in ((False, "four-blob geometric", blobs),
                                    (True, "four-blob conservative", blobs),
                                    (True, "collider", collider)):
        pair_batch(results, conservative, tag, path, dev, rng)
    for conservative, tag, path in ((True, "drum two-material", sim),
                                    (False, "triaxial two-material", tri)):
        pair_batch(results, conservative, tag, path, dev, rng,
                   params=path.params.with_pair_coeffs(
                       path.shapes.n_types, {(0, 1): TWO_MATERIAL}))

    shapes = sim.shapes
    st, pi, pj, mask, hist, d = contact_pairs(sim, dev, rng)
    probe = ck.pack_pairs(st, shapes, sim.params, pi, pj, mask, hist, d,
                          probe_only=True)[0]
    probe[:, ck.SLOTS["tail"][0]] = 0.0
    tbl = ck.pad_type_table(shapes.power_tbl).contiguous()
    tbl_ab = tbl[:, :(LMAX + 1) ** 2].contiguous()
    cap1 = torch.stack([shapes.cap1_x, shapes.cap1_glw, shapes.cap1_cpsi,
                        shapes.cap1_spsi])
    out = ck.stage1_depth(probe, tbl_ab, cap1, LMAX, l1=LMAX, bf16=False)
    ref = ck.stage1_depth_plain(probe, tbl_ab, cap1, LMAX, l1=LMAX, bf16=False)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    n_pos = int((ref > 0).sum())
    print(f"K4 stage1_depth: P={N_PAIRS} depth>0 rows={n_pos} "
          f"max|d depth|={err:.3g} (tol 2e-5)")
    require(n_pos > N_PAIRS // 4, "K4 batch has too few overlapping rows")
    require(err <= 2e-5, "K4 disagrees with its plain twin")
    rsum = probe[:, ck.SLOTS["rbi"][0]] + probe[:, ck.SLOTS["rbj"][0]]
    dist = torch.linalg.norm(probe[:, ck.SLOTS["d"][0]:ck.SLOTS["d"][1]], dim=1)
    alive = (probe[:, mask_col] > 0.5) & (dist > 1e-12)
    probed = alive & (dist < rsum)
    case(results, "stage1_depth", "drum", LMAX, cap1.shape[1], N_PAIRS, err,
         lambda: ck.stage1_depth(probe, tbl_ab, cap1, LMAX, l1=LMAX, bf16=False),
         lambda: ck.stage1_depth_plain(probe, tbl_ab, cap1, LMAX, l1=LMAX, bf16=False),
         int(probed.sum()), stage1_bytes(probe, alive, probed, tbl_ab, cap1, out))

    # Each path's wall batch: wall_capacity compacted rows, or every
    # particle where the path packs them all (wall_capacity 0).
    for kind, tag, path, wall in (
            ("cylinder", "drum", sim, sim.walls[0]),
            ("cylinder", "deposition", dep, dep.walls[0]),
            ("plane", "drum", sim, sim.walls[1]),
            ("plane", "deposition", dep, dep.walls[1]),
            ("plane", "settling box", box, box.walls[0])):
        wall_batch(results, kind, tag, path, wall, path.wall_capacity or N_SETTLE,
                   dev, rng)
    ensemble_kernel_cases(results, sim, dep, dev, rng)
    return results


def stage2_list_phase(tag, path, state, neigh, results, bf16s=(False, True),
                      case_tag=None, min_live=1000, need_contact=True, params=None):
    """The stage-2 kernels of ``path``'s law, in f32 and in bf16 (``bf16s``),
    on the path's own stage-2 list, packed from ``state`` after its run as
    ``contact.contact_force_pairs`` packs it, every slot: each kernel
    timed on the whole list as the case ``case_tag`` (default "{tag}
    stage-2 list"; its bound from the list's live rows);
    the rows of that same call held to the twin on up to N_PAIRS of the
    live rows (the autograd twin's memory bound; the plain time is of
    those rows; a list with no live row, its first row) at the synthetic
    batches' tolerances, and its masked rows to zero. Fails where the
    list has fewer than ``min_live`` live rows, or no contact with
    ``need_contact``. A replica ensemble's lists (``state`` and ``neigh``
    stacked, ``params`` its stacked params) run as the one launch its
    step makes, [R * Pc] rows with a par row a replica; the twin's rows
    take their replica's par row."""
    import torch

    from spherharm_tpu_torch.core.state import take
    from spherharm_tpu_torch.ops import contact
    from spherharm_tpu_torch.ops import contact_kernels as ck

    shapes, lmax, cons = path.shapes, path.shapes.lmax, path.conservative
    pi, pj = neigh.pair_i, neigh.pair_j
    at = lambda t, i: take(t, i, state.replicas)
    rows = contact.particle_rows(state, shapes)
    rows_i, rows_j = at(rows, pi), at(rows, pj)
    live = (neigh.pair_valid & (rows_i[..., contact._RACT] > 0.5)
            & (rows_j[..., contact._RACT] > 0.5))
    dp = contact.minimum_image(rows_j[..., contact._RX] - rows_i[..., contact._RX],
                               state.box_lo, state.box_hi, path.periodic,
                               path._tilt(state))
    packed, tbl, cap, par = ck.pack_pairs(state, shapes, params or path.params, pi, pj,
                                          live, neigh.pair_hist, dp, rows=rows)
    live = live.reshape(-1)
    idx = torch.nonzero(live).flatten()[:N_PAIRS]
    if idx.numel() == 0:
        idx = torch.zeros(1, dtype=torch.long, device=live.device)
    sub = packed[idx].contiguous()
    sub_par = par if par.shape[0] == 1 else par[idx // pi.shape[-1]].contiguous()
    P, n_live, n_sub, G = packed.shape[0], int(live.sum()), sub.shape[0], cap.shape[1]
    case_tag = case_tag or f"{tag} stage-2 list"
    require(n_live >= min_live, f"{case_tag}: only {n_live} live rows")
    for bf16 in bf16s:
        name = f"pair_contact_{'conservative' if cons else 'geometric'}" + (
            "_bf16" if bf16 else "")
        label = f"K{3 if bf16 else 1 if cons else 2} {name} on the {case_tag}"
        full = ck.pair_contact(packed, tbl, cap, par, lmax, cons, bf16)
        ref = ck.pair_contact_plain(sub, tbl, cap, sub_par, lmax, cons, bf16)
        torch.cuda.synchronize()
        n_contact = int((ref[:, 16] > 0.5).sum())
        loose = cons or bf16  # as in pair_batch
        ok, err, flips, text = compare(full[idx], ref, 9, 1e-4 if loose else 2e-3,
                                       n_sub // 1000 if loose else 0)
        print(f"{label}: P={P} lmax={lmax} G={G} live={n_live} compared={n_sub} "
              f"contacts={n_contact} |F|max={float(ref[:, 0:3].abs().max()):.4g} {text}")
        require(n_contact > 0 or not need_contact, f"{label}: no contact on the list")
        require(bool(torch.isfinite(full).all()), f"{label}: output not finite")
        require(bool((full[~live] == 0).all()), f"{label}: a masked row is not zero")
        require(ok, f"{label}: disagrees with its plain twin")
        require(flips <= n_sub // 1000, f"{label}: contact flags disagree")
        case(results, name, case_tag, lmax, G, P, err,
             lambda: ck.pair_contact(packed, tbl, cap, par, lmax, cons, bf16),
             lambda: ck.pair_contact_plain(sub, tbl, cap, sub_par, lmax, cons, bf16),
             n_live, nbytes(packed, tbl, cap, par, full), live_rows=n_live,
             plain_rows=n_sub)


def wall_list_phase(tag, path, state, neigh, results, params=None):
    """K6 and K7 on ``path``'s own wall batches, packed from ``state``
    after its run as ``walls.wall_contact`` packs them (every particle,
    or with a wall_capacity the near rows it compacts,
    ``walls.near_wall_rows``), for the first wall of each kind: each
    kernel timed on the whole batch as the case "{tag} wall batch" (its
    bound from the near rows), the rows of that same call held to the
    twin on up to N_PAIRS rows, the near rows first (the plain time is
    of those rows). A replica ensemble (``state`` and ``neigh`` stacked,
    ``params`` its stacked params) packs its R batches into the one launch
    its step makes; the twin's rows take their replica's par row."""
    import torch

    from spherharm_tpu_torch.ops import walls_kernels as wk
    from spherharm_tpu_torch.ops.rotation import omega_from_angmom
    from spherharm_tpu_torch.ops.walls import near_wall_rows

    shapes, lmax = path.shapes, path.shapes.lmax
    done = set()
    for w_i, wall in enumerate(path.walls):
        st, hist = state, neigh.wall_hist[..., w_i, :]
        if path.wall_capacity and path.wall_capacity < state.cap:
            st, hist = near_wall_rows(state, shapes, wall, hist, path.wall_capacity)[:2]
        om = omega_from_angmom(st.q, st.angmom, shapes.inertia_of(st.shtype, st.scale))
        depth_c, n_c = wall.depth_and_normal(st.x)
        packed, tbl, cap, par, kind = wk.pack_wall(
            st, shapes, params or path.params, wall, hist, depth_c, n_c, om)
        if kind in done:
            continue
        done.add(kind)
        label = f"K{6 if kind == 'cylinder' else 7} wall[{kind}] on the {tag} wall batch"
        near = packed[:, 16] > 0.5
        idx = torch.argsort((~near).to(torch.int8), stable=True)[:N_PAIRS]
        sub = packed[idx].contiguous()
        rows_rep = packed.shape[0] // par.shape[0]
        sub_par = par if par.shape[0] == 1 else par[idx // rows_rep].contiguous()
        full = wk.wall_contact_kernel(packed, tbl, cap, par, lmax, kind)
        ref = wk.wall_contact_plain(sub, tbl, cap, sub_par, lmax, kind)
        torch.cuda.synchronize()
        B, n_near, n_sub, G = packed.shape[0], int(near.sum()), sub.shape[0], cap.shape[1]
        ok, err, flips, text = compare(full[idx], ref, 6, 1e-4)
        print(f"{label}: B={B} lmax={lmax} G={G} near={n_near} compared={n_sub} "
              f"contacts={int((ref[:, 13] > 0.5).sum())} "
              f"|F|max={float(ref[:, 0:3].abs().max()):.4g} {text}")
        require(bool(torch.isfinite(full).all()), f"{label}: output not finite")
        require(ok, f"{label}: disagrees with its plain twin")
        require(flips <= max(n_sub // 1000, 1), f"{label}: contact flags disagree")
        case(results, f"wall_{kind}", f"{tag} wall batch", lmax, G, B, err,
             lambda: wk.wall_contact_kernel(packed, tbl, cap, par, lmax, kind),
             lambda: wk.wall_contact_plain(sub, tbl, cap, sub_par, lmax, kind),
             n_near, nbytes(packed, tbl, cap, par, full), near_rows=n_near,
             plain_rows=n_sub)


def deck_kernel_cases(tag, runner, results, dev, rng, example=True):
    """Each kernel a deck launched, against its plain twin at the deck's
    own shapes, after its card run (``runner``): its pair law on N_PAIRS
    synthetic pairs of its shapes and pair_tab (``pair_batch``) and on its
    own pair list ("{tag} pair list"); each wall kind on synthetic
    particles touching its first wall of the kind (``wall_batch``: as many
    as the deck has, at most N_PAIRS) and on its own wall batches
    (``wall_list_phase``). An ``example`` deck's list may hold no live row
    or contact: settling.in and shear_cell.in touch nowhere in their cut,
    so the synthetic batches carry their check."""
    from spherharm_tpu_torch.ops.walls import PlaneWall

    sim, state, neigh = runner.sim, runner.state, runner.neigh
    pair_batch(results, sim.conservative, tag, sim, dev, rng)
    stage2_list_phase(tag, sim, state, neigh, results, bf16s=(False,),
                      case_tag=f"{tag} pair list", min_live=0 if example else 1000,
                      need_contact=not example)
    B = min(int(state.n_active), N_PAIRS)
    for kind in ("cylinder", "plane"):
        wall = next((w for w in sim.walls
                     if isinstance(w, PlaneWall) == (kind == "plane")), None)
        if wall is not None:
            wall_batch(results, kind, tag, sim, wall, B, dev, rng)
    if sim.walls:
        wall_list_phase(tag, sim, state, neigh, results)


def candidate_list(path, state, neigh):
    """The candidate list a rebuild of ``path`` builds at ``state`` (wrap,
    neighbour list, ``contact.build_pair_list``, every slot of the pair
    capacity), packed for the stage-1 probe as
    ``contact.prefilter_pair_list`` packs it, the tail column kept. Returns
    (packed [P, 64], live rows, candidates)."""
    import torch

    from spherharm_tpu_torch.ops import contact, neighbor
    from spherharm_tpu_torch.ops import contact_kernels as ck

    shapes = path.shapes
    x, image = neighbor.wrap_positions(state.x, state.image, state.box_lo,
                                       state.box_hi, path.periodic, path._tilt(state))
    st = state.replace(x=x, image=image)
    idx, mask, _ = path._build_list(st)
    fields, n_cand = contact.build_pair_list(
        st, shapes, path.params, idx, mask, torch.zeros_like(neigh.hist), st.active,
        path.pair_capacity, path.periodic, tilt=path._tilt(st))
    pi, pj = fields["pair_i"], fields["pair_j"]
    rows = contact.particle_rows(st, shapes)
    live = (fields["pair_valid"] & (rows[pi, contact._RACT] > 0.5)
            & (rows[pj, contact._RACT] > 0.5))
    dp = contact.minimum_image(rows[pj][:, contact._RX] - rows[pi][:, contact._RX],
                               st.box_lo, st.box_hi, path.periodic, path._tilt(st))
    packed = ck.pack_pairs(st, shapes, path.params, pi, pj, live,
                           dp.new_zeros((pi.shape[0], 6)), dp, rows=rows,
                           probe_only=True)[0]
    return packed, live, int(n_cand)


def stage1_list_phase(tag, path, state, neigh, results, cand=None):
    """K4 (full basis, tail zeroed, as the prefilter runs it) on the whole
    candidate list a rebuild of ``path`` builds at ``state``, timed as the
    case ``"{tag} candidate list"`` (its bound from the list's probed rows
    and ``stage1_bytes``). That call's rows are held to: the plain twin at
    2e-5 on up to N_PAIRS probed rows (where none is probed, on N_PAIRS
    rows of the list; the plain time is of those rows); -1e9 exactly on
    every dead row; rsum - dist within 1e-6 on every sphere-separated row.
    Rows within 1e-6 rsum of touching spheres may be sorted either way by
    the kernel's rounding of dist and are held to neither. Returns
    (packed with its tail, alive rows, rsum, probed rows, K4's output).
    ``cand``: (packed, live, candidates) of a list built elsewhere (the
    slabs', ``sharded_candidate_list``)."""
    import torch

    from spherharm_tpu_torch.ops import contact_kernels as ck

    shapes, lmax = path.shapes, path.shapes.lmax
    packed, live, n_cand = cand or candidate_list(path, state, neigh)
    zeroed = packed.clone()
    zeroed[:, ck.SLOTS["tail"][0]] = 0.0
    cap1 = torch.stack([shapes.cap1_x, shapes.cap1_glw, shapes.cap1_cpsi,
                        shapes.cap1_spsi])
    tbl_ab = ck.pad_type_table(shapes.power_tbl)[:, :(lmax + 1) ** 2].contiguous()
    out = ck.stage1_depth(zeroed, tbl_ab, cap1, lmax, l1=lmax, bf16=False)
    d = packed[:, ck.SLOTS["d"][0]:ck.SLOTS["d"][1]]
    dist = torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-24))
    rsum = packed[:, ck.SLOTS["rbi"][0]] + packed[:, ck.SLOTS["rbj"][0]]
    alive = live & (dist > 1e-12)
    probed = alive & (dist < rsum)
    band = (dist - rsum).abs() <= 1e-6 * rsum
    sep = alive & ~probed & ~band
    idx = torch.nonzero(probed & ~band).flatten()[:N_PAIRS]
    if idx.numel() == 0:
        idx = torch.nonzero(~band).flatten()[:N_PAIRS]
    sub = zeroed[idx].contiguous()
    ref = ck.stage1_depth_plain(sub, tbl_ab, cap1, lmax, l1=lmax, bf16=False)
    torch.cuda.synchronize()
    P, n_alive, n_probed = packed.shape[0], int(alive.sum()), int(probed.sum())
    err = float((out[idx] - ref).abs().max())
    sep_err = float((out[sep] - (rsum - dist)[sep]).abs().max()) if sep.any() else 0.0
    dead_ok = bool((out[~alive] == -1e9).all())
    label = f"K4 stage1_depth on the {tag}'s candidate list"
    print(f"{tag} candidate list: {n_cand} candidates in {P} slots, {int(live.sum())} "
          f"live, {n_alive - n_probed} sphere-separated, {n_probed} probed (bounding "
          f"spheres overlap), {int((alive & band).sum())} within 1e-6 rsum of touching")
    print(f"{label}: max|d depth| on {idx.numel()} rows vs the twin={err:.3g} (tol 2e-5); "
          f"separated rows max|depth - (rsum - dist)|={sep_err:.3g} (tol 1e-6); dead rows "
          f"all -1e9: {dead_ok}")
    require(bool(torch.isfinite(out[alive]).all()), f"{label}: output not finite")
    require(err <= 2e-5, f"{label}: disagrees with its plain twin")
    require(sep_err <= 1e-6, f"{label}: a sphere-separated row is not rsum - dist")
    require(dead_ok, f"{label}: a dead row is not -1e9")
    case(results, "stage1_depth", f"{tag} candidate list", lmax, cap1.shape[1], P, err,
         lambda: ck.stage1_depth(zeroed, tbl_ab, cap1, lmax, l1=lmax, bf16=False),
         lambda: ck.stage1_depth_plain(sub, tbl_ab, cap1, lmax, l1=lmax, bf16=False),
         n_probed, stage1_bytes(packed, alive, probed, tbl_ab, cap1, out),
         live_rows=n_alive, probed_rows=n_probed, plain_rows=idx.numel())
    return packed, alive, rsum, probed, out


def stage1_l1_phase(gas, state, neigh, results):
    """K4 on the candidate list a rebuild of the drift gas builds at
    ``state`` (``stage1_list_phase``), then K5 (l1 = 4 of Lmax 8, f32 and
    bf16, with the tail column) vs its plain twin on the same list. K5 >=
    K4 on every probed live row, or the run fails. ``state`` is the gas
    after its drift path: at its start the lattice pitch clears 2 rmax, so
    no pair would be probed. Returns the K5 launches of this phase."""
    import torch

    from spherharm_tpu_torch.ops import contact_kernels as ck

    l1, shapes = 4, gas.shapes
    packed, alive, rsum, probed, k4 = stage1_list_phase(
        "drift gas", gas, state, neigh, results)
    cap1 = torch.stack([shapes.cap1_x, shapes.cap1_glw, shapes.cap1_cpsi,
                        shapes.cap1_spsi])
    tbl1 = ck.stage1_table(shapes, l1)
    P, n_probed = packed.shape[0], int(probed.sum())
    require(n_probed > 1000, "K5: too few probed rows on the drift gas's list")
    for k in ck.stage1_depth.launches:
        ck.stage1_depth.launches[k] = 0
    for bf16 in (False, True):
        name = "stage1_depth_l1" + ("_bf16" if bf16 else "")
        out = ck.stage1_depth(packed, tbl1, cap1, LMAX, l1=l1, bf16=bf16)
        ref = ck.stage1_depth_plain(packed, tbl1, cap1, LMAX, l1=l1, bf16=bf16)
        torch.cuda.synchronize()
        # Kernel and twin round alike op for op (bf16: an f32 op on bf16
        # values, rounded once), so both are held to 1e-5 of rsum, as K4
        # is to 1e-5 on depths of order 1; a K5 that ran its chains in f32
        # would miss that on most probed rows (the bf16 rounding moves r
        # by ~2e-3 rsum). Where an f32-ulp difference in a node's direction
        # crosses a bf16 rounding boundary, that node's r moves by a bf16
        # ulp (first card run: 2 of 7,055 probed rows, the worst 7.5e-3):
        # in bf16, 0.1% of the probed rows may exceed 1e-5 rsum, none one
        # bf16 ulp of rsum (2^-7 rsum).
        err = (out - ref).abs()
        n_bad = int((err > 1e-5 * rsum).sum())
        allowed = n_probed // 1000 if bf16 else 0
        margin = (out - k4)[probed]
        n_below = int((margin < 0).sum())
        print(f"K5 {name} on drift gas: P={P} l1={l1} probed={n_probed} "
              f"max|d depth|={float(err.max()):.3g} (tol 1e-5 rsum; rows beyond "
              f"{n_bad}, allowed {allowed}) K5-K4 on probed rows: "
              f"min {float(margin.min()):.4g}, rows below 0: {n_below}")
        require(n_bad <= allowed and bool((err <= 2.0 ** -7 * rsum).all()),
                f"K5 {name} disagrees with its plain twin")
        require(n_below == 0, f"K5 {name} falls below the full-basis probe K4 on "
                f"{n_below} probed rows: a finding about the reference's truncation "
                "bound (ROADMAP Queue 3), never a tolerance to loosen")
        case(results, name, "drift gas candidate list", LMAX, cap1.shape[1], P,
             float(err.max()),
             lambda: ck.stage1_depth(packed, tbl1, cap1, LMAX, l1=l1, bf16=bf16),
             lambda: ck.stage1_depth_plain(packed, tbl1, cap1, LMAX, l1=l1, bf16=bf16),
             n_probed, stage1_bytes(packed, alive, probed, tbl1, cap1, out), degree=l1)
    return {k: ck.stage1_depth.launches[k]
            for k in ("stage1_depth_l1", "stage1_depth_l1_bf16")}


def drum_start(sim, st0, device):
    """The drum's (or deposition's) contact-rich start from its builder
    state (tests/torch_port_util.contact_rich_state)."""
    from torch_port_util import contact_rich_state

    from spherharm_tpu_torch.models import scenarios

    sh = st0.shtype.cpu().numpy()
    sc = st0.scale.double().cpu().numpy()
    R = float(sim.walls[0].radius)
    L = float(sim.walls[2].point[1] - sim.walls[1].point[1])
    radius = sim.shapes.rchar.double().cpu().numpy()[sh] * sc
    x, angmom = contact_rich_state(st0.x.cpu().numpy(), radius, R, L)
    return scenarios.make_state(x, st0.box_lo.cpu().numpy(), st0.box_hi.cpu().numpy(),
                                q=st0.q.cpu().numpy(), angmom=angmom, scale=sc,
                                shtype=sh, device=device)


def box_start(sim, st0, device):
    """The settling box's lattice pressed onto the floor
    (tests/torch_port_util.pressed_box_state)."""
    from torch_port_util import pressed_box_state

    from spherharm_tpu_torch.models import scenarios

    x, angmom = pressed_box_state(st0.x.cpu().numpy(), float(sim.shapes.rmax[0]))
    return scenarios.make_state(x, st0.box_lo.cpu().numpy(), st0.box_hi.cpu().numpy(),
                                q=st0.q.cpu().numpy(), angmom=angmom, device=device)


def card_vs_cpu(label, build, start, dev, steps=40):
    """A small contact-rich run of ``steps`` steps on the card and on the
    CPU (plain twins): thermo within 2e-3 relative, positions within 1e-3,
    pair and wall contacts present."""
    import torch

    runs = {}
    for device in (dev, torch.device("cpu")):
        sim, st0, _ = build(device)
        st, ng = sim.init_neighbors(start(sim, st0, device))
        st, ng = sim.run(st, ng, steps)
        th = {k: float(v) for k, v in sim.thermo(st, ng).items() if v.ndim == 0}
        require(int(ng.overflow) == 0 and int(ng.skin_violations) == 0,
                f"{label} on {device}: overflow/skin violations")
        runs[device.type] = (th, st.x.cpu().numpy())
    (tg, xg), (tc, xc) = runs["cuda"], runs["cpu"]
    rel = {k: abs(tg[k] - tc[k]) / max(abs(tc[k]), 1e-30)
           for k in ("ke", "erot", "pe_pair", "pe_wall", "pe_grav", "etot")}
    dx = float(np.abs(xg - xc).max())
    print(f"{label}, {steps} steps, card vs CPU: "
          + " ".join(f"{k}={tg[k]:.6g}(rel {v:.2e})" for k, v in rel.items())
          + f" max|dx|={dx:.3g} (tol: rel 2e-3, dx 1e-3)")
    require(tc["pe_pair"] > 0 and tc["pe_wall"] > 0, f"{label} has no contacts")
    require(max(rel.values()) <= 2e-3 and dx <= 1e-3,
            f"{label}: card and CPU disagree")


def triaxial_card_vs_cpu(dev, steps=40):
    """The small sheared triaxial cell (n = 128, fill 0.09: 3 grid cells an
    axis; xy shear 0.05, the servo on) for ``steps`` steps on the card and
    on the CPU, from ``triaxial_state`` with its xy tilt 5e-5 Lx under
    Lx/2: the flips counted step by step (at least one, equal on both),
    image counters equal, tilt within 1e-5 relative, box within 1e-6,
    thermo and press within 2e-3 relative, the stress tensor within 2e-3
    of its scale, positions within 1e-3."""
    import torch

    from torch_port_util import triaxial_state

    from spherharm_tpu_torch.models import scenarios

    runs = []
    for device in (dev, torch.device("cpu")):
        sim, st0, _ = scenarios.triaxial_cell(
            n=128, fill_fraction=0.09, shear_rate=TRI_SHEAR, press_tau=1.0,
            device=device)
        require(sim.grid.dims == (3, 3, 3) and sim.triclinic and sim.press_control,
                f"small triaxial: grid {sim.grid.dims}")
        st, ng = sim.init_neighbors(triaxial_state(st0, device,
                                                   xy_frac=0.5 * (1 - 1e-4))[0])
        flips = 0
        for _ in range(steps):
            xy0 = float(st.tilt[0])
            st, ng = sim.step(st, ng)
            flips += round(abs(xy0 - float(st.tilt[0])) / float(st.box_hi[0] - st.box_lo[0]))
        th = sim.thermo(st, ng)
        require(int(ng.overflow) == 0, f"small triaxial on {device}: overflow")
        runs.append((
            {k: float(v) for k, v in th.items() if v.ndim == 0},
            {k: getattr(st, k).cpu().numpy() for k in ("x", "tilt", "box_lo", "box_hi",
                                                       "image")},
            th["stress"].cpu().numpy(), flips))
    (tg, sg, stress_g, fg), (tc, sc, stress_c, fc) = runs
    rel = {k: abs(tg[k] - tc[k]) / max(abs(tc[k]), 1e-30)
           for k in ("ke", "erot", "pe_pair", "etot", "press")}
    d_tilt = float(np.abs(sg["tilt"] - sc["tilt"]).max() / np.abs(sc["tilt"]).max())
    d_box = float(max(np.abs(sg[k] - sc[k]).max() for k in ("box_lo", "box_hi")))
    d_stress = float(np.abs(stress_g - stress_c).max() / np.abs(stress_c).max())
    dx = float(np.abs(sg["x"] - sc["x"]).max())
    same_image = bool((sg["image"] == sc["image"]).all())
    print(f"small sheared triaxial n=128 Lmax=4, {steps} steps, card vs CPU: flips "
          f"{fg} / {fc}, tilt {sg['tilt']} (rel {d_tilt:.2e}), max|d box|={d_box:.3g}, "
          "images equal: " + str(same_image) + " "
          + " ".join(f"{k}={tg[k]:.6g}(rel {v:.2e})" for k, v in rel.items())
          + f" stress rel {d_stress:.2e} max|dx|={dx:.3g} (tol: tilt 1e-5, box 1e-6 "
          "rel, thermo and stress 2e-3, dx 1e-3)")
    require(fc >= 1 and fg == fc, f"small triaxial: flips card {fg}, CPU {fc}")
    require(tc["pe_pair"] > 0, "small triaxial has no contacts")
    require(same_image and d_tilt <= 1e-5
            and d_box <= 1e-6 * float(np.abs(sc["box_hi"]).max())
            and max(rel.values()) <= 2e-3 and d_stress <= 2e-3 and dx <= 1e-3,
            "small triaxial: card and CPU disagree")


def triaxial_path(tri, st0, dev, smi):
    """The n = 100k sheared triaxial cell from its lattice compressed into
    contact (``triaxial_state``), TRI_STEPS steps through ``run_path``.
    Guards besides run_path's: pe_pair > 0 and a finite stress tensor at
    the start and the end, no flip, and the xy tilt within 1e-5 relative
    of the reference's recurrence (xy <- xy f_x + g_xy L_y, L_y <- L_y f_y
    each step, spherharm_tpu/ops/integrate.py:117-118) replayed in float64
    from the start's box and the params. Prints the mean coordination at
    the start and the end. Returns (state, neigh, launches, seconds a
    step)."""
    import torch

    from torch_port_util import triaxial_state

    from spherharm_tpu_torch.core import computes

    state, c = triaxial_state(st0, dev)
    state, neigh = tri.init_neighbors(state)
    ends = []
    for when in ("start", "end"):
        if when == "end":
            state, neigh, launches, _, step_s, _ = run_path(
                f"triaxial n={N_TRI}", tri, state, neigh, TRI_STEPS,
                ("pair_contact_geometric",), smi, TRI_EAGER)
        th = tri.thermo(state, neigh)
        coord = float(computes.coordination(tri, state, neigh)[state.active].double().mean())
        stress = th["stress"].cpu().numpy()
        print(f"triaxial {when}: mean coordination {coord:.4f}, pe_pair "
              f"{float(th['pe_pair']):.6g}, press {float(th['press']):.6g}, tilt "
              f"{state.tilt.cpu().numpy()}, box {(state.box_hi - state.box_lo).cpu().numpy()}")
        require(float(th["pe_pair"]) > 0, f"triaxial {when}: no pair contact")
        require(np.isfinite(stress).all(), f"triaxial {when}: stress not finite")
        ends.append((float(state.box_hi[1] - state.box_lo[1]), float(state.tilt[0])))
    print(f"triaxial: compressed by {c:.4f} into contact; {1e3 * step_s:.3f} ms a step")
    p = tri.params
    f_x, f_y = (1.0 + float(p.deform_rate[k]) * float(p.dt) for k in (0, 1))
    g = float(p.shear_rate[0]) * float(p.dt)
    (ly, xy), (_, xy_end) = ends
    for _ in range(TRI_STEPS):
        ly *= f_y
        xy = xy * f_x + g * ly
    rel = abs(xy_end - xy) / abs(xy)
    print(f"triaxial: xy tilt {xy_end:.8g}, float64 replay {xy:.8g} (rel {rel:.2e}, "
          "tol 1e-5)")
    require(rel <= 1e-5, "triaxial: xy tilt off the replayed recurrence")
    torch.cuda.synchronize()
    return state, neigh, launches, step_s


def ensemble_sweep(params, R):
    """The kernel cases' per-replica parameters: dt from 0.5x to 2x,
    kn from 1x to 3x, gamma_n from 0.5x to 4x, mu from 0.2 to 0.8."""
    from spherharm_tpu_torch.parallel import ensemble as ens

    f = lambda lo, hi: np.linspace(lo, hi, R)
    return ens.with_param_sweep(
        params, dt=float(params.dt) * f(0.5, 2.0), kn=float(params.kn) * f(1.0, 3.0),
        gamma_n=float(params.gamma_n) * f(0.5, 4.0), mu=f(0.2, 0.8))


def twin_per_replica(twin, packed, par, ref):
    """Largest |batched twin - one twin call a replica| over the rows,
    relative to the output's scale, and whether every row is bit-equal."""
    import torch

    R = par.shape[0]
    P = packed.shape[0] // R
    worst, same = 0.0, True
    for r in range(R):
        blk = slice(r * P, (r + 1) * P)
        one = twin(packed[blk], par[r:r + 1])
        worst = max(worst, float((ref[blk] - one).abs().max()))
        same = same and bool(torch.equal(ref[blk], one))
    return worst / max(float(ref.abs().max()), 1e-30), same


def ensemble_kernel_cases(results, sim, dep, dev, rng):
    """The kernels with R = ENS_CASE_R replicas in one launch, each
    replica's rows with its own dt, materials (``ensemble_sweep``) and
    contacts: K1 and K3 conservative on the drum's shapes, K2 and K3
    geometric on the deposition's (N_PAIRS // R synthetic pairs a
    replica, ``contact_pairs``), K6 and K7 on the deposition's walls
    (its wall_capacity rows a replica, ``wall_particles``). Each held to
    the batched twin at the single-list tolerances, the batched twin to
    one twin call a replica (1e-6 of the output's scale; bit-equality
    printed), and recorded as a case "<path> R=4"."""
    import torch

    from spherharm_tpu_torch.ops import contact_kernels as ck
    from spherharm_tpu_torch.ops import walls_kernels as wk
    from spherharm_tpu_torch.ops.rotation import omega_from_angmom
    from spherharm_tpu_torch.parallel import ensemble as ens

    R = ENS_CASE_R
    P = N_PAIRS // R
    blocks = lambda t: torch.stack([t[r * P:(r + 1) * P] for r in range(R)])
    for conservative, bf16, path, tag in ((True, False, sim, "drum"),
                                          (True, True, sim, "drum"),
                                          (False, False, dep, "deposition"),
                                          (False, True, dep, "deposition")):
        name = f"pair_contact_{'conservative' if conservative else 'geometric'}" + (
            "_bf16" if bf16 else "")
        label = f"K{3 if bf16 else 1 if conservative else 2} {name} on {tag} R={R}"
        lmax = path.shapes.lmax
        st, pi, pj, mask, hist, d = contact_pairs(path, dev, rng)
        packed, tbl, cap, par = ck.pack_pairs(
            ens.replicate(st, R), path.shapes, ensemble_sweep(path.params, R),
            blocks(pi), blocks(pj), blocks(mask), blocks(hist), blocks(d))
        require(par.shape == (R, ck.N_PAR), f"{label}: par {tuple(par.shape)}")
        out = ck.pair_contact(packed, tbl, cap, par, lmax, conservative, bf16)
        ref = ck.pair_contact_plain(packed, tbl, cap, par, lmax, conservative, bf16)
        dev_rel, same = twin_per_replica(
            lambda pk, pr: ck.pair_contact_plain(pk, tbl, cap, pr, lmax, conservative,
                                                 bf16), packed, par, ref)
        torch.cuda.synchronize()
        loose = conservative or bf16  # as in pair_batch
        ok, err, flips, text = compare(out, ref, 9, 1e-4 if loose else 2e-3,
                                       N_PAIRS // 1000 if loose else 0)
        n_contact = [int((ref[r * P:(r + 1) * P, 16] > 0.5).sum()) for r in range(R)]
        print(f"{label}: {P} rows a replica, lmax={lmax} G={cap.shape[1]} contacts "
              f"{n_contact}; batched twin vs a twin call a replica: max rel "
              f"{dev_rel:.2e} (bit-equal: {same}); kernel vs batched twin: {text}")
        require(min(n_contact) > P // 4, f"{label}: a replica has too few contacts")
        require(bool(torch.isfinite(out).all()), f"{label}: output not finite")
        require(dev_rel <= 1e-6, f"{label}: batched twin differs from per-replica calls")
        require(ok, f"{label}: disagrees with its plain twin")
        require(flips <= N_PAIRS // 1000, f"{label}: contact flags disagree")
        case(results, name, f"{tag} R={R}", lmax, cap.shape[1], N_PAIRS, err,
             lambda: ck.pair_contact(packed, tbl, cap, par, lmax, conservative, bf16),
             lambda: ck.pair_contact_plain(packed, tbl, cap, par, lmax, conservative,
                                           bf16),
             int((packed[:, ck.SLOTS["mask"][0]] > 0.5).sum()),
             nbytes(packed, tbl, cap, par, out), replicas=R)

    B, lmax = dep.wall_capacity, dep.shapes.lmax
    for kind, wall in (("cylinder", dep.walls[0]), ("plane", dep.walls[1])):
        label = f"K{6 if kind == 'cylinder' else 7} wall[{kind}] on deposition R={R}"
        ws = ens.stack_replicas([wall_particles(dep, wall, kind, B, dev, rng)
                                 for _ in range(R)])
        depth_c, n_c = wall.depth_and_normal(ws.x)
        om = omega_from_angmom(ws.q, ws.angmom, dep.shapes.inertia_of(ws.shtype, ws.scale))
        whist = torch.as_tensor(rng.normal(size=(R, B, 6)) * 1e-4, dtype=torch.float32,
                                device=dev)
        args = wk.pack_wall(ws, dep.shapes, ensemble_sweep(dep.params, R), wall, whist,
                            depth_c, n_c, om)
        require(args[4] == kind and args[3].shape == (R, wk.N_PAR_WALL),
                f"{label}: pack_wall gave {args[4]}, par {tuple(args[3].shape)}")
        out = wk.wall_contact_kernel(*args[:4], lmax, kind)
        ref = wk.wall_contact_plain(*args[:4], lmax, kind)
        dev_rel, same = twin_per_replica(
            lambda pk, pr: wk.wall_contact_plain(pk, args[1], args[2], pr, lmax, kind),
            args[0], args[3], ref)
        torch.cuda.synchronize()
        ok, err, flips, text = compare(out, ref, 6, 1e-4)
        n_contact = int((ref[:, 13] > 0.5).sum())
        print(f"{label}: {B} rows a replica, lmax={lmax} G={args[2].shape[1]} "
              f"contacts={n_contact}; batched twin vs a twin call a replica: max rel "
              f"{dev_rel:.2e} (bit-equal: {same}); kernel vs batched twin: {text}")
        require(n_contact > R * B // 4, f"{label}: batch has too few contacts")
        require(bool(torch.isfinite(out).all()), f"{label}: output not finite")
        require(dev_rel <= 1e-6, f"{label}: batched twin differs from per-replica calls")
        require(ok, f"{label}: disagrees with its plain twin")
        require(flips <= max(R * B // 1000, 1), f"{label}: contact flags disagree")
        case(results, f"wall_{kind}", f"deposition R={R}", lmax, args[2].shape[1], R * B,
             err, lambda: wk.wall_contact_kernel(*args[:4], lmax, kind),
             lambda: wk.wall_contact_plain(*args[:4], lmax, kind),
             int((args[0][:, 16] > 0.5).sum()), nbytes(*args[:4], out), replicas=R)


class counting_rebuilds:
    """Counts the rebuild steps of ``sim`` (one a step, whichever replicas
    it serves) while active: its eager ``Simulation._rebuild`` calls, and
    the replays of its CUDA graphs that rebuild (``always``,
    ``rebuild_post``); the calls a warm-up or a capture makes do not
    count."""

    REBUILDING = ("always", "rebuild_post")

    def __init__(self, sim):
        self.sim = sim

    def _replays(self):
        replays = self.sim.graph_stats()["replays"]
        return sum(replays.get(k, 0) for k in self.REBUILDING)

    def __enter__(self):
        from spherharm_tpu_torch.core.simulation import Simulation

        self.n, self._orig, self._r0 = 0, Simulation._rebuild, self._replays()

        def counted(sim, state, neigh):
            if not sim._graphed(state, 1):
                self.n += 1
            return self._orig(sim, state, neigh)

        Simulation._rebuild = counted
        return self

    def __exit__(self, *exc):
        from spherharm_tpu_torch.core.simulation import Simulation

        Simulation._rebuild = self._orig
        self.n += self._replays() - self._r0


def with_skin(built, skin):
    """A builder's (sim, state, neigh) with the sim's skin set to
    ``skin``."""
    import torch

    sim = built[0]
    sim.params = sim.params.replace(skin=torch.full_like(sim.params.skin, skin))
    return built


def ensemble_card_vs_cpu(label, build, sweep, dev, kernels=(), steps=40):
    """A small replica ensemble (``sweep``: with_param_sweep's fields, R
    values each) from the contact-rich start, ``steps`` steps through
    ``ensemble.run_replicas`` on the card and on the CPU: each replica's
    thermo within 2e-3 relative and positions within 1e-3, pair and wall
    contacts in every replica, overflow 0, and on the card each of
    ``kernels`` launched, the pair kernel once a step and the stage-1
    probe once a rebuild step, for all R (the rebuild steps of both
    printed)."""
    import torch

    from spherharm_tpu_torch.parallel import ensemble as ens

    runs = []
    keys = ("ke", "erot", "pe_pair", "pe_wall", "pe_grav", "etot")
    for device in (dev, torch.device("cpu")):
        sim, st0, _ = build(device)
        st, ng = sim.init_neighbors(drum_start(sim, st0, device))
        params = ens.with_param_sweep(sim.params, **sweep)
        R = params.dt.shape[0]
        reset_counts()
        with counting_rebuilds(sim) as rb:
            S, N = ens.run_replicas(sim, ens.replicate(st, R), ens.replicate(ng, R),
                                    params, steps)
        launches = launch_counts()
        th = ens.thermo(sim, S, N, params)
        require(N.overflow.tolist() == [0] * R, f"{label} on {device}: overflow "
                f"{N.overflow.tolist()}")
        runs.append(({k: th[k].cpu().numpy() for k in keys}, S.x.cpu().numpy(), rb.n,
                     launches))
    (tg, xg, rb_g, lg), (tc, xc, rb_c, _) = runs
    law = f"pair_contact_{'conservative' if sim.conservative else 'geometric'}"
    probes = lg["stage1_depth"]
    rel = {k: float((np.abs(tg[k] - tc[k]) / np.maximum(np.abs(tc[k]), 1e-30)).max())
           for k in keys}
    dx = float(np.abs(xg - xc).max())
    print(f"{label}, R={R}, {steps} steps, card vs CPU, worst replica: "
          + " ".join(f"{k} rel {v:.2e}" for k, v in rel.items())
          + f" max|dx|={dx:.3g}; rebuild steps card {rb_g} / CPU {rb_c}; card launches "
          f"{law} {lg[law]}, stage1_depth {probes}; etot by replica (card) "
          + " ".join(f"{e:.7g}" for e in tg["etot"]) + " (tol: rel 2e-3, dx 1e-3)")
    require(all(lg[k] > 0 for k in kernels) and lg[law] == steps
            and probes == (rb_g if sim.prefilter else 0),
            f"{label}: launches {lg} for {steps} steps, rebuild steps card {rb_g}, "
            f"CPU {rb_c}")
    require(bool((tc["pe_pair"] > 0).all() and (tc["pe_wall"] > 0).all()),
            f"{label}: a replica has no contacts")
    require(max(rel.values()) <= 2e-3 and dx <= 1e-3,
            f"{label}: card and CPU disagree")


def ensemble_path(dep, st0, dev, smi, results, dep_rate):
    """The full-width ensemble: config 3's deposition (n = N_DEP) from its
    contact-rich start, ``ensemble.replicate``d to N_ENS replicas with
    ``with_param_sweep(mu=linspace(*ENS_MU, N_ENS))``; ENS_EAGER steps
    eager and as CUDA graphs (``graph_vs_eager``), then ENS_STEPS steps of
    ``run_replicas``, every launch counter at 0 just before. Guards:
    overflow 0, finite etot and pe_pair > 0 in every replica; replicas 0
    and N_ENS - 1 held to a single card run of the same start with their
    own mu (positions within 1e-3, thermo within 2e-3 relative; the
    largest differences and bit-equality printed), which launches K2, K6
    and K7 as often as the ensemble did. Prints particle-steps/s (R N
    steps / s) beside ``dep_rate`` (the deposition path's) and the
    single runs', and the rebuild steps of each. Then K2 and K6/K7 on the
    ensemble's own lists (``stage2_list_phase``, ``wall_list_phase``).
    Returns (launches, seconds a step)."""
    import copy

    import torch

    from spherharm_tpu_torch.parallel import ensemble as ens

    tag = f"deposition R={N_ENS}"
    st, ng = dep.init_neighbors(drum_start(dep, st0, dev))
    params = ens.with_param_sweep(dep.params, mu=np.linspace(*ENS_MU, N_ENS))
    states, neighs = ens.replicate(st, N_ENS), ens.replicate(ng, N_ENS)
    n = int(st.n_active)
    ref = graph_vs_eager(tag, dep, lambda k: ens.run_replicas(dep, states, neighs,
                                                              params, k),
                         ENS_EAGER, ens._rebind(dep, params), states, neighs)
    reset_counts()
    torch.cuda.synchronize()
    with counting_rebuilds(dep) as rb:
        t0 = time.perf_counter()
        S, N = ens.run_replicas(dep, states, neighs, params, ENS_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    th = ens.thermo(dep, S, N, params)
    rate = N_ENS * n * ENS_STEPS / wall
    graph_row(tag, N_ENS * n, ref, wall / ENS_STEPS, smi)
    print(f"{tag}, mu {ENS_MU[0]}-{ENS_MU[1]}: {ENS_STEPS} steps in {wall:.3f}s -> "
          f"{rate:.1f} particle-steps/s ({N_ENS} x {n} particles; the deposition "
          f"path {dep_rate:.1f}) [{smi}] rebuild steps {rb.n}; overflow "
          f"{N.overflow.tolist()} launches={ {k: v for k, v in launches.items() if v} }")
    print(f"{tag}: by replica etot " + " ".join(f"{float(e):.7g}" for e in th["etot"])
          + "; pe_pair " + " ".join(f"{float(e):.5g}" for e in th["pe_pair"])
          + "; ke " + " ".join(f"{float(e):.5g}" for e in th["ke"]))
    require(N.overflow.tolist() == [0] * N_ENS, f"{tag}: capacity overflow")
    require(bool(torch.isfinite(th["etot"]).all()), f"{tag}: non-finite energy")
    require(bool((th["pe_pair"] > 0).all()), f"{tag}: a replica has no pair contact")
    kernels = ("pair_contact_geometric", "wall_cylinder", "wall_plane")
    require(all(launches[k] > 0 for k in kernels),
            f"{tag}: a kernel of the path never launched: {launches}")
    for r in (0, N_ENS - 1):
        one = copy.copy(dep)
        one.params = ens.replica(params, r)
        reset_counts()
        torch.cuda.synchronize()
        with counting_rebuilds(one) as rb1:
            t0 = time.perf_counter()
            s1, n1 = one.run(st, ng, ENS_STEPS)
            torch.cuda.synchronize()
            solo = time.perf_counter() - t0
        solo_l = launch_counts()
        th1 = one.thermo(s1, n1)
        dx = float((S.x[r] - s1.x).abs().max())
        dv = float((S.v[r] - s1.v).abs().max())
        rel = {k: abs(float(th[k][r]) - float(th1[k])) / max(abs(float(th1[k])), 1e-30)
               for k in ("ke", "pe_pair", "pe_wall", "etot")}
        same = all(bool(torch.equal(getattr(S, f)[r], getattr(s1, f)))
                   for f in ("x", "v", "q", "angmom"))
        print(f"{tag} replica {r} (mu {float(params.mu[r]):.3g}) vs its single card run "
              f"({n * ENS_STEPS / solo:.1f} particle-steps/s, rebuild steps {rb1.n}): "
              f"max|dx|={dx:.3g} max|dv|={dv:.3g} "
              + " ".join(f"{k} rel {v:.2e}" for k, v in rel.items())
              + f"; x, v, q, angmom bit-equal: {same} (tol: dx 1e-3, rel 2e-3)")
        require(dx <= 1e-3 and max(rel.values()) <= 2e-3,
                f"{tag}: replica {r} disagrees with its single run")
        require(all(solo_l[k] == launches[k] for k in kernels),
                f"{tag}: launches {launches} against a single run's {solo_l}")
    stage2_list_phase(tag, dep, S, N, results, bf16s=(False,), params=params)
    wall_list_phase(tag, dep, S, N, results, params=params)
    return launches, wall / ENS_STEPS


def block_graph_phase(sim, state, neigh, smi, pairs=2):
    """The cadence runs' design choice, measured on the drum: STEPS steps
    from (state, neigh) as ``Simulation.run``'s per-step graph replays (a
    rebuild step, then plain steps) against one CUDA graph of a whole
    R_EVERY-step block (a ``GraphRunner`` unit of R_EVERY ``_step_core``
    calls) replayed STEPS / R_EVERY times: bit-equal (fatal otherwise),
    each one's capture seconds and pool bytes, and ms a step in ``pairs``
    pairs of turns (per-step, block, block, per-step, ...)."""
    import copy

    import torch

    from spherharm_tpu_torch.core.runner import GraphRunner
    from spherharm_tpu_torch.utils import validate

    per_step = lambda: sim.run(state, neigh, STEPS)
    blk = GraphRunner(dict(state=state, neigh=neigh, params=sim.params))

    def block(b):
        view = copy.copy(sim)
        view.params = b["params"]
        s, n = b["state"], b["neigh"]
        for k in range(R_EVERY):
            s, n = view._step_core(s, n, "always" if k == 0 else "never")
        return {"state": s, "neigh": n}

    blk.capture("block", block)

    def by_block():
        blk.load(state=state, neigh=neigh, params=sim.params)
        for _ in range(STEPS // R_EVERY):
            blk.replay("block")
        return blk.result("state", "neigh")

    diff = validate.bitwise_differences(per_step(), by_block())
    times = {"per-step": [], "block": []}
    for turn in range(2 * pairs):
        order = ("per-step", "block") if turn % 2 == 0 else ("block", "per-step")
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (per_step if name == "per-step" else by_block)()
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0) / STEPS)
    stats = sim.graph_stats()
    print(f"drum {STEPS} steps, per-step graphs vs one graph of a {R_EVERY}-step block: "
          + ("bit-equal" if not diff else f"DIFFERENT {diff}") + "; ms a step in turns "
          + "; ".join(f"{k} " + " ".join(f"{t:.4f}" for t in v) for k, v in times.items())
          + f"; capture {stats['capture_s']:.3f}s / {blk.capture_s:.3f}s, pool "
          f"{stats['pool_bytes']} / {blk.pool_bytes()} bytes [{smi}]")
    require(not diff, "drum: the block graph's run is not the per-step graphs' bit for bit")


def scan_phase(dev):
    """Repeatability of the float64 prefix sums under the segment sums on a
    1.2M-row list (the triaxial cell's pair list): 20 repeats each of a
    1-D ``torch.cumsum`` (on the card CUB's look-back scan) and of
    ``contact.prefix_sum`` over 6 columns, each against its first result,
    and of ``sorted_segment_sum`` over 100,000 segments; times by CUDA
    events. Fatal if ``prefix_sum`` or the segment sum varies."""
    import torch

    from spherharm_tpu_torch.ops import contact

    gen = torch.Generator(device=dev).manual_seed(5)
    P, N = 1_200_000, 100_000
    data = torch.randn(P, 6, device=dev, generator=gen) * 1e3
    cols = data.double().t().contiguous()
    seg = torch.sort(torch.randint(0, N, (P,), device=dev, generator=gen)).values
    cases = {"1-D torch.cumsum, one column": lambda: torch.cumsum(cols[0], 0),
             "contact.prefix_sum, 6 columns": lambda: contact.prefix_sum(cols),
             "contact.sorted_segment_sum": lambda: contact.sorted_segment_sum(data, seg, N)}
    varied = {}
    for name, fn in cases.items():
        first = fn()
        varied[name] = sum(not torch.equal(fn(), first) for _ in range(20))
        print(f"{name} on {P} rows: {varied[name]} of 20 repeats differ from the first; "
              f"{cuda_ms(fn, 20):.4f} ms a call")
    require(varied["contact.prefix_sum, 6 columns"] == 0
            and varied["contact.sorted_segment_sum"] == 0,
            "the segment sums' prefix sums are not repeatable")


def launch_counts():
    """Every kernel wrapper's launch counter, by kernel-line name."""
    from spherharm_tpu_torch.core import runner

    return runner.launch_counts()


def reset_counts():
    from spherharm_tpu_torch.ops import contact_kernels as ck
    from spherharm_tpu_torch.ops import walls_kernels as wk

    for c in (ck.pair_contact.launches, ck.stage1_depth.launches,
              wk.wall_contact_kernel.launches):
        for k in c:
            c[k] = 0


@contextlib.contextmanager
def sync_errors():
    """Inside, a host synchronisation that torch's sync debug mode sees
    raises (the check mode's event synchronisation is not one it sees)."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def eager(sim):
    """``sim`` (and the views made of it inside) stepping eagerly."""
    sim.cuda_graphs = False
    try:
        yield
    finally:
        sim.cuda_graphs = True


def eager_profile(tag, run, steps):
    """torch.profiler over run() (``steps`` eager steps): the device's time
    a step in ms, from the device rows (an aten op's row repeats its
    kernels' time). With --profile its table goes to
    build/chip_smoke_profile_<tag>.txt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation) / 1e3 / steps
    require(dev_ms > 0, f"{tag}: the profile holds no device time")
    if PROFILE_TABLES:
        out = ROOT / "build" / ("chip_smoke_profile_" + re.sub(r"\W+", "_", tag) + ".txt")
        out.parent.mkdir(exist_ok=True)
        out.write_text(f"{tag}: {steps} eager steps, device time {dev_ms:.4f} ms a step\n"
                       f"{events.table(sort_by='cuda_time_total', row_limit=40)}\n")
        print(f"profile {tag} -> {out.relative_to(ROOT)}")
    return dev_ms


def graph_vs_eager(label, sim, run, steps, view, state, neigh, one_step=None):
    """``run(steps)`` from one start with ``sim`` stepping eagerly
    (``cuda_graphs=False``), then as CUDA graph replays (capturing them
    where not yet cached), then once more from the cached graphs under
    ``sync_errors``: the graph runs equal the eager run bit for bit in
    every State and NeighborState field (``validate.bitwise_differences``:
    each differing field and its largest difference printed, fatal), with
    equal kernel launches. Then one eager plain step and one eager rebuild
    step of ``view`` (``sim`` or its replica view) from (state, neigh)
    under ``sync_errors`` (``one_step(kind)`` in place of ``view._step_core``
    where given: the slabs' step). Returns the eager ms a step (host clock), the
    device ms a step (``eager_profile`` of the first PROFILE_STEPS of
    them, eager again), and the
    capture seconds and pool bytes of ``sim``'s graphs."""
    import torch

    from spherharm_tpu_torch.utils import validate

    t_phase = time.perf_counter()
    with eager(sim):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = run(steps)
        torch.cuda.synchronize()
        eager_ms = 1e3 * (time.perf_counter() - t0) / steps
        l_eager = launch_counts()
        k = min(steps, PROFILE_STEPS)
        dev_ms = eager_profile(label, lambda: run(k), k)
    reset_counts()
    got = run(steps)
    torch.cuda.synchronize()
    l_graph = launch_counts()
    with sync_errors():
        again = run(steps)
        torch.cuda.synchronize()
    diff = validate.bitwise_differences(got, ref)
    diff_again = validate.bitwise_differences(again, ref)
    stats = sim.graph_stats()
    print(f"{label}: {steps} steps eager vs CUDA graphs: "
          + ("bit-equal in every field" if not diff else
             "DIFFERENT: " + ", ".join(f"{k} max|d|={v:.3g}" for k, v in diff.items()))
          + "; from cached graphs under sync-debug error: "
          + ("bit-equal" if not diff_again else f"DIFFERENT {diff_again}")
          + f"; launches eager {'equal' if l_eager == l_graph else l_eager}, graph "
          f"{ {k: v for k, v in l_graph.items() if v} }; graph replays "
          f"{stats['replays']}")
    require(not diff and not diff_again, f"{label}: the CUDA graph run is not the "
            "eager run bit for bit")
    require(l_eager == l_graph, f"{label}: launches eager {l_eager}, graph {l_graph}")
    one_step = one_step or (lambda kind: view._step_core(state, neigh, kind))
    for kind in ("never", "always"):
        with sync_errors():
            one_step(kind)
    torch.cuda.synchronize()
    print(f"{label}: one eager plain step and one eager rebuild step under "
          "set_sync_debug_mode('error'): no host synchronisation; eager vs graph "
          f"checks {time.perf_counter() - t_phase:.1f}s")
    return dict(eager_ms=eager_ms, device_ms=dev_ms, capture_s=stats["capture_s"],
                pool_bytes=stats["pool_bytes"])


# Each path's eager against graph comparison and rates ({label: row}).
GRAPH_ROWS = {}


def graph_row(label, n, ref, step_s, smi):
    """Print and keep a path's eager and graph particle-steps/s (``n``
    particles; ``ref`` from ``graph_vs_eager``; ``step_s`` the graph run's
    seconds a step) and the graph run's device busy share: the eager
    profile's device ms a step over the graph run's ms a step."""
    row = dict(eager_rate=1e3 * n / ref["eager_ms"], graph_rate=n / step_s,
               busy=ref["device_ms"] / (1e3 * step_s), device_ms=ref["device_ms"],
               graph_ms=1e3 * step_s, eager_ms=ref["eager_ms"],
               capture_s=ref["capture_s"], pool_bytes=ref["pool_bytes"])
    GRAPH_ROWS[label] = row
    print(f"{label}: eager {row['eager_rate']:.1f}, CUDA graphs {row['graph_rate']:.1f} "
          f"particle-steps/s ({row['eager_ms']:.4f} vs {row['graph_ms']:.4f} ms a step); "
          f"device {row['device_ms']:.4f} ms a step (eager profile): graph run busy "
          f"{row['busy']:.1%}; capture {row['capture_s']:.3f}s, graph pool "
          f"{row['pool_bytes']} bytes [{smi}]")


def run_path(label, sim, state, neigh, steps, kernels, smi, eager_steps, every=0):
    """Drive one path: ``graph_vs_eager`` over its first ``eager_steps``,
    then its run of ``steps`` with every launch counter at 0, sampling
    etot every ``every`` steps (0: none) as the drift harness does;
    returns (state, neigh, launches of this run, thermo, seconds a step,
    [(step, etot, pe_pair)])."""
    import torch

    ref = graph_vs_eager(label, sim, lambda k: sim.run(state, neigh, k),
                         eager_steps, sim, state, neigh)
    reset_counts()
    samples = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if every:
        for done in range(every, steps + 1, every):
            state, neigh = sim.run(state, neigh, every)
            th = sim.thermo(state, neigh)
            samples.append((done, float(th["etot"]), float(th["pe_pair"])))
    else:
        state, neigh = sim.run(state, neigh, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    th = sim.thermo(state, neigh)
    n = int(state.n_active)
    overflow, skin = int(neigh.overflow), int(neigh.skin_violations)
    etot = float(th["etot"])
    rate = n * steps / wall
    print(f"{label}: {steps} steps in {wall:.3f}s -> {rate:.1f} particle-steps/s "
          f"[{smi}] overflow={overflow} skin_violations={skin} etot={etot:.6g} "
          f"pe_pair={float(th['pe_pair']):.6g} pe_wall={float(th['pe_wall']):.6g} "
          f"launches={ {k: v for k, v in launches.items() if v} }")
    graph_row(label, n, ref, wall / steps, smi)
    require(overflow == 0, f"{label}: capacity overflow (channel={overflow})")
    require(math.isfinite(etot) and all(math.isfinite(s[1]) for s in samples),
            f"{label}: non-finite energy")
    require(all(launches[k] > 0 for k in kernels),
            f"{label}: a kernel of the path never launched: {launches}")
    return state, neigh, launches, th, wall / steps, samples


def drift_path(label, gas, state, neigh, kernels, smi):
    """The drift gas from its lattice: GAS_WARM steps unmeasured (its
    first contacts form after ~1,800), then the measured GAS_STEPS steps
    sampled every GAS_EVERY steps, with pair contacts at every sample;
    prints the etot and pe_pair series and the fitted slope. Returns
    (state, neigh, launches, samples, slope, seconds a step)."""
    from spherharm_tpu_torch.models import drift

    state, neigh = gas.run(state, neigh, GAS_WARM)
    pe0 = float(gas.thermo(state, neigh)["pe_pair"])
    require(pe0 > 0, f"{label}: no pair contact after {GAS_WARM} steps")
    state, neigh, launches, th, step_s, samples = run_path(
        label, gas, state, neigh, GAS_STEPS, kernels, smi, GAS_EAGER, every=GAS_EVERY)
    slope = drift.drift_slope(samples)
    print(f"{label}: from step {GAS_WARM} (pe_pair {pe0:.6g}), every {GAS_EVERY} "
          "steps: etot " + " ".join(f"{s[1]:.8g}" for s in samples)
          + "; pe_pair " + " ".join(f"{s[2]:.4g}" for s in samples))
    print(f"{label}: fitted drift {slope:+.4%} per 1M steps over {GAS_STEPS} steps "
          "(too short to judge drift)")
    require(all(s[2] > 0 for s in samples),
            f"{label}: a sample of the measured window has no pair contact")
    return state, neigh, launches, samples, slope, step_s


DECK_DIR = ROOT / "build" / "chip_smoke_decks"
DECK_DUMP_EVERY = 15  # dump frames at steps 0, 15 and 30 of a cut deck
# Example decks whose overflow channel fires in the reference's runner as
# well: triaxial.in (a periodic axis of 2 grid cells), two_materials.in
# (830 pairs at set-up in the runner's pair capacity of 600).
DECKS_THAT_OVERFLOW = ("triaxial.in", "two_materials.in")


def deck_cuts():
    """The example decks as the deck phase runs them: (label, text, run,
    thermo). Each takes at most 32 steps in all (shear_cell.in's four
    stages 8 each; the CPU twins' time bounds the cut); thermo every 10
    (4), dumps every 15;
    two_materials.in once more with ``conservative off`` (K2 with a
    two-material pair_tab through the deck)."""
    from torch_port_util import EXAMPLES

    out = []
    for path in sorted(EXAMPLES.glob("*.in")):
        text = path.read_text()
        run, thermo = (8, 4) if path.name == "shear_cell.in" else (30, 10)
        out.append((path.name, text, run, thermo))
        if path.name == "two_materials.in":
            out.append((f"{path.name} conservative off",
                        text.replace("lmax 8\n", "lmax 8 conservative off\n"),
                        run, thermo))
    return out


def deck_examples_phase(dev, results):
    """Every example deck through ``spherharm_tpu_torch.io.deck`` on the card
    (counters set to 0 just before, read just after) and on the CPU, held
    together by ``torch_port_util.compare_deck_runs`` (thermo etot, ke and
    pe_pair at rtol 2e-3, positions at the end and in each dump's last
    frame within 1e-3, the same ids and atom counts in every dump frame);
    overflow 0, but for DECKS_THAT_OVERFLOW, which overflow in the
    reference as well (there the same count on the card and the CPU).
    After each card run, ``deck_kernel_cases`` holds the deck's kernels to
    their twins at its shapes (cases "deck <label>" in ``results``).
    Returns {label: launches}."""
    import shutil

    import torch

    from torch_port_util import DECK_DX, DECK_RTOL, compare_deck_runs, cut_deck

    from spherharm_tpu_torch.io.deck import DeckRunner

    rng = np.random.default_rng(11)
    launched = {}
    for label, text, run, thermo in deck_cuts():
        runs = []  # the card's run, then the CPU's
        for device in (dev, torch.device("cpu")):
            out_dir = DECK_DIR / label.replace(" ", "_") / device.type
            shutil.rmtree(out_dir, ignore_errors=True)
            out_dir.mkdir(parents=True)
            deck = cut_deck(text, out_dir, run, thermo, DECK_DUMP_EVERY)
            if device == dev:
                torch.cuda.synchronize()
                reset_counts()
            t0 = time.perf_counter()
            r = DeckRunner(device=device).run_text(deck)
            if device == dev:
                torch.cuda.synchronize()
                launched[label] = launch_counts()
            secs = time.perf_counter() - t0
            runs.append(r)
            print(f"deck {label} on {device.type}: n={int(r.state.n_active)} "
                  f"steps={r.total_steps} {secs:.2f}s overflow={int(r.neigh.overflow)}"
                  + (f" launches={ {k: v for k, v in launched[label].items() if v} }"
                     if device == dev else ""))
            if device == dev:
                deck_kernel_cases(f"deck {label}", r, results, dev, rng)
        g, c = runs
        # Two example decks overflow in the reference too (ROADMAP Queue 3,
        # tests/test_torch_deck.py::test_example_overflows_as_reference):
        # the card must truncate as the CPU does.
        ovf = (int(g.neigh.overflow), int(c.neigh.overflow))
        require(ovf[0] == ovf[1] and (ovf[0] == 0 or label.split()[0]
                                      in DECKS_THAT_OVERFLOW),
                f"deck {label}: overflow {ovf[0]} on the card, {ovf[1]} on the CPU")
        rows = c.thermo_log.rows
        err = compare_deck_runs(c, g)
        print(f"deck {label}, card vs CPU: "
              + " ".join(f"{k} rel {err[k]:.2e}" for k in ("etot", "ke", "pe_pair"))
              + f" (pe_pair {rows[0]['pe_pair']:.6g} -> {rows[-1]['pe_pair']:.6g}) "
              f"max|dx| {err['x']:.3g}, last dump frame {err['dump_x']:.3g} "
              f"({err['frames']} frames; tol: rel {DECK_RTOL}, dx {DECK_DX})")
        require(err["ok"], f"deck {label}: card and CPU disagree")
    return launched


# The full-size drum deck: examples/drum.in command for command, its
# geometry scaled (box, drum radius 100, end planes at y = +-52, lattice
# pitch 2.2 over a fill 140 x 98 x 68 below the axis); 60 steps, thermo
# every 20, one dump after the run (all default columns).
DRUM_DECK = """\
units           lj
dimension       3
boundary        f f f
atom_style      spherharm

region          box block -101 101 -53 53 -101 101
create_box      2 box
shape           1 blob 11 0.12
shape           2 blob 12 0.12
density         1 1.0
density         2 1.0

lattice         sc 2.2
region          fill block -70 70 -49 49 -70 -2
create_atoms    1 region fill seed 3 scale 0.8 1.2

pair_style      spherharm 1e5 2.857e4 50.0 25.0 0.5 lmax 8
pair_coeff      * *
neighbor        0.25 bin

fix             1 all nve/sh
fix             2 all gravity 10.0 vector 0 0 -1
fix             3 all wall/gran cylinder 0 0 0  0 1 0  100.0 0.5
fix             4 all wall/gran plane 0 -52 0  0 1 0
fix             5 all wall/gran plane 0 52 0  0 -1 0

timestep        1e-4
thermo          20
run             60
dump            1 all custom 1 {dump}
run             0
"""
DRUM_DECK_STEPS = 60


def deck_drum_phase(dev, smi):
    """DRUM_DECK on the card through ``DeckRunner``: its set-up (the lines
    before its first ``run``, and the materialised Simulation), then
    ``graph_vs_eager`` over DECK_EAGER steps of its Simulation from the
    set-up state, then its ``run`` commands (counters set to 0 just
    before, read just after): particle-steps/s from the host clock
    (synchronized) between the thermo rows of steps 0 and 60; pe_pair at
    the start and the end;
    the dump's bytes, its formatter and the seconds of one more
    ``write_dump`` of the final state (the same bytes). Guards: overflow 0,
    finite etot, pe_pair > 0 at step 0, K1, K6 and K7 launched, the native
    formatter, ``read_dump`` giving n rows whose ids are the tags. Returns
    (launches, runner, seconds a step)."""
    import torch

    from torch_port_util import deck_setup_and_rest

    from spherharm_tpu_torch.io import dump
    from spherharm_tpu_torch.io.deck import DeckRunner

    DECK_DIR.mkdir(parents=True, exist_ok=True)
    path = DECK_DIR / "drum_full.dump"
    r = DeckRunner(device=dev)
    stamps = []
    log = r.thermo_log.log

    def stamped(row):  # the device is idle once the row reached the host
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        log(row)

    r.thermo_log.log = stamped
    setup, rest = deck_setup_and_rest(DRUM_DECK.format(dump=path))
    t0 = time.perf_counter()
    r.run_text(setup)
    r._materialize()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ref = graph_vs_eager("deck drum full", r.sim,
                         lambda k: r.sim.run(r.state, r.neigh, k), DECK_EAGER, r.sim,
                         r.state, r.neigh)
    torch.cuda.synchronize()
    reset_counts()
    r.run_text(rest)
    torch.cuda.synchronize()
    launches = launch_counts()
    rows = r.thermo_log.rows
    n = int(r.state.n_active)
    step_s = (stamps[3] - stamps[0]) / DRUM_DECK_STEPS
    t1 = time.perf_counter()
    dump_fmt = dump.write_dump(DECK_DIR / "drum_full_again.dump", r.state, r.sim.shapes,
                               periodic=r.periodic)
    write_s = time.perf_counter() - t1
    nbytes = path.stat().st_size
    frames = dump.read_dump(path)
    act = r.state.active.cpu().numpy()
    tags = np.sort(r.state.tag.cpu().numpy()[act])
    overflow = int(r.neigh.overflow)
    print(f"deck drum full: n={n} lmax={r.sim.shapes.lmax} grid={r.sim.grid.dims} "
          f"pair_cap={r.sim.pair_capacity} k_max={r.sim.k_max} "
          f"cell_cap={r.sim.cell_cap}; set-up {setup_s:.2f}s; "
          f"{DRUM_DECK_STEPS} steps (thermo every 20 included) in "
          f"{DRUM_DECK_STEPS * step_s:.3f}s -> {n / step_s:.1f} particle-steps/s "
          f"[{smi}] overflow={overflow} pe_pair {rows[0]['pe_pair']:.6g} -> "
          f"{rows[3]['pe_pair']:.6g} etot {rows[0]['etot']:.6g} -> "
          f"{rows[3]['etot']:.6g} launches={ {k: v for k, v in launches.items() if v} }")
    print(f"deck drum full dump: {nbytes} bytes, formatter {r.dump_formatters}, "
          f"one more write_dump {write_s:.3f}s ({dump_fmt}), read back "
          f"{[f['n'] for f in frames]} rows")
    require(overflow == 0, f"deck drum full: overflow (channel={overflow})")
    require(all(math.isfinite(row["etot"]) for row in rows), "deck drum full: "
            "non-finite etot")
    require(rows[0]["pe_pair"] > 0, "deck drum full: no pair contact at step 0")
    require(all(launches[k] > 0 for k in ("pair_contact_conservative", "wall_cylinder",
                                          "wall_plane")),
            f"deck drum full: a kernel of the path never launched: {launches}")
    require(r.dump_formatters == ["native"] and dump_fmt == "native",
            f"deck drum full: dump formatter {r.dump_formatters}")
    require(len(frames) == 1 and frames[0]["n"] == n
            and np.array_equal(np.sort(frames[0]["data"]["id"]), tags)
            and np.array_equal(frames[0]["data"]["id"], tags),
            "deck drum full: the dump does not read back as the state's tags")
    require((DECK_DIR / "drum_full_again.dump").read_bytes() == path.read_bytes(),
            "deck drum full: write_dump of the same state wrote other bytes")
    graph_row("deck drum full", n, ref, step_s, smi)
    return launches, r, step_s


CHILD_TAG = "BF16_CHILD_RESULT "


def bf16_child(smi):
    """The bf16 phase, in a process started with SPHERHARM_STAGE2_BF16=1 as
    a user would set it: the drift gas and the deposition, every stage-2
    call through K3 and none through K1/K2. Prints one tagged JSON line of
    launches and results for the parent."""
    import torch

    from spherharm_tpu_torch.models import drift, scenarios
    from spherharm_tpu_torch.ops import contact_kernels as ck

    require(ck.STAGE2_BF16, "bf16 child: SPHERHARM_STAGE2_BF16 is not set")
    dev = torch.device("cuda")
    gas, st0 = drift.build_gas(N_GAS, device=dev)
    gst, gng = gas.init_neighbors(st0)
    _, _, l_gas, samples, slope, gas_s = drift_path(
        f"drift gas n={N_GAS} bf16", gas, gst, gng,
        ("pair_contact_conservative_bf16", "stage1_depth"), smi)
    dep, dep_st0, _ = scenarios.deposition(n=N_DEP, device=dev)
    dst, dng = dep.init_neighbors(drum_start(dep, dep_st0, dev))
    _, _, l_dep, th, dep_s, _ = run_path(
        f"deposition n={N_DEP} bf16", dep, dst, dng, DEP_STEPS,
        ("pair_contact_geometric_bf16", "wall_cylinder", "wall_plane"), smi, DEP_EAGER)
    require(float(th["pe_pair"]) > 0, "bf16 deposition: no pair contact")
    for label, launches in (("drift gas", l_gas), ("deposition", l_dep)):
        f32 = launches["pair_contact_conservative"] + launches["pair_contact_geometric"]
        require(f32 == 0, f"bf16 child: {f32} f32 stage-2 launches on the {label}")
    print(CHILD_TAG + json.dumps({
        "gas": l_gas, "deposition": l_dep, "samples": samples, "slope": slope,
        "gas_step_s": gas_s, "dep_step_s": dep_s,
        "dep_etot": float(th["etot"])}))


def bf16_phase():
    """Run ``bf16_child`` in a child process (SPHERHARM_STAGE2_BF16=1); its
    output is echoed; a child that fails fails the run. Returns its
    result."""
    env = dict(os.environ, SPHERHARM_STAGE2_BF16="1")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), BF16_CHILD],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith(CHILD_TAG):
            print(f"  [bf16 child] {line}")
    if proc.returncode != 0:
        print(proc.stderr[-6000:], file=sys.stderr)
    require(proc.returncode == 0, f"bf16 child exited with {proc.returncode}")
    tagged = [line for line in lines if line.startswith(CHILD_TAG)]
    require(len(tagged) == 1, "bf16 child printed no result")
    return json.loads(tagged[0][len(CHILD_TAG):])


def shard_owners(state):
    """{tag: slab} of a sharded state's active slots."""
    tag, act = state.tag.cpu().numpy(), state.active.cpu().numpy()
    return {int(t): p for p in range(tag.shape[0]) for t in tag[p][act[p]]}


def list_view(sim):
    """What ``stage2_list_phase`` reads of a path, for the slabs' lists:
    they pair rows of the extended (owned + ghost) state, imaged on y
    and z only."""
    import types

    return types.SimpleNamespace(shapes=sim.shapes, conservative=sim.conservative,
                                 periodic=sim.periodic_eff, _tilt=sim._tilt,
                                 params=sim.params)


def sharded_candidate_list(sim, state, neigh, ghosts):
    """The candidate lists a rebuild of the slabs builds at (state, neigh,
    ghosts) (``ShardedSimulation._rebuild`` without the prefilter: every
    slot of each slab's pair capacity), packed for the stage-1 probe as
    ``contact.prefilter_pair_list`` packs them, [S * pair_capacity, 64],
    the tail column kept. Returns (packed, live rows, candidates)."""
    import copy

    from spherharm_tpu_torch.core.state import take
    from spherharm_tpu_torch.ops import contact
    from spherharm_tpu_torch.ops import contact_kernels as ck

    view = copy.copy(sim)
    view.prefilter = False
    st, ng, gh = view._rebuild(state, neigh, ghosts)
    ext = sim._extend(st, gh)
    pi, pj = ng.pair_i, ng.pair_j
    rows = contact.particle_rows(ext, sim.shapes)
    ri, rj = take(rows, pi, True), take(rows, pj, True)
    live = (ng.pair_valid & (ri[..., contact._RACT] > 0.5)
            & (rj[..., contact._RACT] > 0.5))
    dp = contact.minimum_image(rj[..., contact._RX] - ri[..., contact._RX], ext.box_lo,
                               ext.box_hi, sim.periodic_eff, sim._tilt(ext))
    packed = ck.pack_pairs(ext, sim.shapes, sim.params, pi, pj, live,
                           dp.new_zeros(pi.shape + (6,)), dp, rows=rows,
                           probe_only=True)[0]
    return packed, live.reshape(-1), int(ng.pair_valid.sum())


def by_tag_gap(a, b, periodic):
    """Per tag, the largest |position difference| (minimum image in b's
    box and tilt) and |velocity difference| between two runs' states,
    either layout; fatal unless both hold the same tags."""
    import torch

    from torch_port_util import by_tag

    from spherharm_tpu_torch.ops import contact

    ta, tb = by_tag(a, "tag"), by_tag(b, "tag")
    require(np.array_equal(ta, tb), "the two runs hold different tags")
    dev = b.x.device
    d = contact.minimum_image(torch.as_tensor(by_tag(a, "x") - by_tag(b, "x"),
                                              device=dev),
                              b.box_lo, b.box_hi, periodic, b.tilt)
    return (float(d.abs().max()),
            float(np.abs(by_tag(a, "v") - by_tag(b, "v")).max()))


def force_gap(a, b, rows=None):
    """Per tag, |f_a - f_b| over |f_b|max, on the rows ``rows`` (a mask in
    tag order; default all): (largest, share of those rows past 1e-4)."""
    from torch_port_util import by_tag

    fa, fb = by_tag(a, "f"), by_tag(b, "f")
    err = np.abs(fa - fb).max(1) / max(float(np.abs(fb).max()), 1e-30)
    err = err if rows is None else err[rows]
    return (float(err.max()), float((err > 1e-4).mean())) if err.size else (0.0, 0.0)


def halo_depths(sim):
    """{mesh axis: halo depth} of a sharded simulation (the slabs': x)."""
    if hasattr(sim, "halo_depth_ax"):
        return {ax: sim.halo_depth_ax[ax] for ax in sim.axis.names}
    return {"x": sim.halo_depth}


def moved_by_axis(sim, before, after):
    """The tags whose shard changed between two ``shard_owners``: (count
    along each mesh axis (the slabs': x), count along two axes or more)."""
    shape = getattr(sim.axis, "shape", (sim.n_shards,))
    tags = sorted(before)
    a = np.stack(np.unravel_index([before[t] for t in tags], shape), axis=1)
    b = np.stack(np.unravel_index([after[t] for t in tags], shape), axis=1)
    moved = a != b
    return moved.sum(0).tolist(), int((moved.sum(1) >= 2).sum())


def brick_triaxial_sim(single, box, n, device, mesh=BRICK):
    """The sheared triaxial cell ``single`` (``triaxial_cell``'s, built
    with its box of side ``box``) on a ``mesh`` brick, with the reference's
    sharded capacities and the slab cell's tilt pad along x only (only
    xy is sheared: a y image shifts x, nothing shifts y): cap_local 4n/S,
    halo_cap n/S a side for each axis (at least 64), pair cap 12n/S,
    cell_cap 12, tilt pad {x: 0.12 box, y: 0}."""
    from spherharm_tpu_torch.parallel.brick import BrickSimulation

    S = int(np.prod(mesh))
    return BrickSimulation(
        single.shapes, single.params, mesh_shape=mesh, box_lo=(0, 0, 0),
        box_hi=(box,) * 3, cap_local=max(4 * n // S, 64), halo_cap=max(n // S, 64),
        periodic=(True,) * 3, k_max=single.k_max, cell_cap=12,
        pair_capacity=max(12 * n // S, 256), deform_min=TRI_DEFORM_MIN, triclinic=True,
        tilt_pad={"x": 0.12 * box, "y": 0.0}, conservative=single.conservative,
        device=device)


def sharded_card_vs_cpu(dev, results, brick=False, steps=40):
    """The slabs (``brick``: the bricks) on the card and on the CPU (plain
    twins): the dry run (``dryrun_sharded(N_SHARDS)``; with ``brick``
    ``dryrun_brick`` on (2, 2) and on (2, 2, 2): one step of 16 S Lmax-4
    ellipsoids); the sheared triaxial cell at n = SHARD_TRI_SMALL on
    N_SHARDS slabs (on a BRICK brick, ``brick_triaxial_sim``) (xy shear
    0.05, ``deform_min`` 0.8, its lattice compressed into contact,
    ``triaxial_state``) for ``steps`` steps: thermo and press within 2e-3
    relative, the stress tensor within 2e-3 of its scale, the xy tilt
    within 1e-5 relative, the box within 1e-6, image counters and tags
    equal per tag, positions within 1e-3; and 2 slabs with x not periodic
    and a plane floor (``slab_drift_system(2, wall=True)``; with ``brick``
    a (2, 2) brick with x and z not periodic, ``brick_drift_system``) for
    ``steps`` steps, K7 and wall springs migrating (along both axes of
    the brick): thermo within 2e-3, positions within 1e-3, wall contacts,
    migrations, K7 launched, and K7 on the card run's own wall batch
    (``wall_list_phase``: every owned slot of every shard) held to its
    twin."""
    import torch

    from torch_port_util import (brick_drift_system, by_tag, slab_drift_system,
                                 triaxial_state)

    from spherharm_tpu_torch.core.state import SimParams
    from spherharm_tpu_torch.models import scenarios, shapes_library
    from spherharm_tpu_torch.ops.walls import PlaneWall
    from spherharm_tpu_torch.parallel.brick import BrickSimulation
    from spherharm_tpu_torch.parallel.dryrun import dryrun_brick, dryrun_sharded
    from spherharm_tpu_torch.parallel.halo import ShardedSimulation

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    word = "brick" if brick else "slab"
    dryruns = ([(f"dryrun_brick({m})", lambda d, m=m: dryrun_brick(m, device=d),
                 16 * int(np.prod(m))) for m in ((2, 2), (2, 2, 2))] if brick else
               [(f"dryrun_sharded({N_SHARDS})",
                 lambda d: dryrun_sharded(N_SHARDS, device=d), 16 * N_SHARDS)])
    for label, dryrun, n in dryruns:
        th = [dryrun(d) for d in (dev, cpu)]
        rel = {k: abs(float(th[0][k]) - float(th[1][k])) / max(abs(float(th[1][k])), 1e-30)
               for k in ("ke", "erot", "pe_pair", "etot")}
        print(f"{label}, card vs CPU: n={int(th[0]['n'])} "
              + " ".join(f"{k}={float(th[0][k]):.7g}(rel {v:.2e})" for k, v in rel.items())
              + f" overflow {int(th[0]['neigh_overflow'])} / {int(th[1]['neigh_overflow'])}"
              " (tol 2e-3)")
        require(int(th[0]["n"]) == n and max(rel.values()) <= 2e-3
                and int(th[0]["neigh_overflow"]) == int(th[1]["neigh_overflow"]),
                f"{label}: card and CPU disagree")

    runs = []
    for device in (dev, cpu):
        single, st0, _ = scenarios.triaxial_cell(n=SHARD_TRI_SMALL, shear_rate=TRI_SHEAR,
                                                 deform_min=TRI_DEFORM_MIN, device=device)
        if brick:
            sim = brick_triaxial_sim(single, float(st0.box_hi[0]), SHARD_TRI_SMALL, device)
        else:
            sim = scenarios.triaxial_cell(n=SHARD_TRI_SMALL, shear_rate=TRI_SHEAR,
                                          deform_min=TRI_DEFORM_MIN, sharded=True,
                                          n_shards=N_SHARDS, device=device)[0]
        st, ng, gh = sim.init(triaxial_state(st0, device)[0])
        owners = shard_owners(st)
        st, ng, gh = sim.run(st, ng, gh, steps)
        t = sim.thermo(st, ng, gh)
        require(int(t["neigh_overflow"]) == 0, f"small sheared {word}s on {device}: "
                f"overflow {int(t['neigh_overflow'])}")
        runs.append((sim, st, {k: float(v) for k, v in t.items() if v.ndim == 0},
                     t["stress"].cpu().numpy(), moved_by_axis(sim, owners, shard_owners(st))))
    (sim, sg, tg, stress_g, mg), (_, sc, tc, stress_c, mc) = runs
    rel = {k: abs(tg[k] - tc[k]) / max(abs(tc[k]), 1e-30)
           for k in ("ke", "erot", "pe_pair", "etot", "press")}
    tilt_g, tilt_c = sg.tilt.cpu().numpy(), sc.tilt.cpu().numpy()
    d_tilt = float(np.abs(tilt_g - tilt_c).max() / np.abs(tilt_c).max())
    d_box = float(max(np.abs(getattr(sg, k).cpu().numpy() - getattr(sc, k).numpy()).max()
                      for k in ("box_lo", "box_hi")))
    d_stress = float(np.abs(stress_g - stress_c).max() / np.abs(stress_c).max())
    same_image = bool(np.array_equal(by_tag(sg, "image"), by_tag(sc, "image")))
    dx, _ = by_tag_gap(sg, sc.replace(**{f: getattr(sc, f).to(dev) for f in
                                         ("x", "v", "box_lo", "box_hi", "tilt")}),
                       (True,) * 3)
    shape = BRICK if brick else N_SHARDS
    print(f"small sheared triaxial n={SHARD_TRI_SMALL} on {shape} {word}s (grid "
          f"{sim.grid_dims}, halo depth {halo_depths(sim)}), "
          f"{steps} steps, card vs CPU: tilt {tilt_g} (rel {d_tilt:.2e}), max|d box|="
          f"{d_box:.3g}, images equal: {same_image}, tags that changed {word} by axis "
          f"(along two or more) {mg} / {mc} "
          + " ".join(f"{k}={tg[k]:.6g}(rel {v:.2e})" for k, v in rel.items())
          + f" stress rel {d_stress:.2e} max|dx|={dx:.3g} (tol: tilt 1e-5, box 1e-6 rel, "
          "thermo and stress 2e-3, dx 1e-3)")
    require(tc["pe_pair"] > 0, f"small sheared {word}s: no contacts")
    require(same_image and d_tilt <= 1e-5
            and d_box <= 1e-6 * float(np.abs(sc.box_hi.numpy()).max())
            and max(rel.values()) <= 2e-3 and d_stress <= 2e-3 and dx <= 1e-3,
            f"small sheared {word}s: card and CPU disagree")

    runs = []
    for device in (dev, cpu):
        if brick:
            x, v, box, periodic = brick_drift_system((2, 2), wall=True)
        else:
            x, v, box, periodic = slab_drift_system(2, wall=True)
        shapes = shapes_library.build_shapes(
            [shapes_library.ellipsoid_coeffs(0.55, 0.45, 0.4, 4)], 4,
            contact_quad=(6, 12), device=device)
        params = SimParams.create(dt=1e-3, kn=1e4, gamma_n=5.0, mu=0.3, cutoff=1.2,
                                  skin=0.3, gravity=(0.0, 0.0, -10.0), device=device)
        kw = dict(box_lo=(0, 0, 0), box_hi=tuple(box), migrate_cap=16, periodic=periodic,
                  rebuild_every=10, conservative=False, device=device,
                  walls=(PlaneWall.create((0, 0, 0), (0, 0, 1), device=device),))
        if brick:
            sim = BrickSimulation(shapes, params, mesh_shape=(2, 2), cap_local=64,
                                  halo_cap=48, k_max=24, cell_cap=16, pair_capacity=384,
                                  **kw)
        else:
            sim = ShardedSimulation(shapes, params, n_shards=2, cap_local=64, halo_cap=32,
                                    k_max=16, cell_cap=8, pair_capacity=256, **kw)
        st, ng, gh = sim.init(scenarios.make_state(x, [0, 0, 0], box, v=v, device=device))
        owners = shard_owners(st)
        reset_counts()
        st, ng, gh = sim.run(st, ng, gh, steps)
        launches = launch_counts()
        t = sim.thermo(st, ng, gh)
        require(int(t["neigh_overflow"]) == 0, f"{word} floor on {device}: overflow")
        runs.append((st, {k: float(v) for k, v in t.items() if v.ndim == 0},
                     moved_by_axis(sim, owners, shard_owners(st)),
                     float(ng.wall_hist.abs().max()), launches))
        if device == dev:
            wall_list_phase(f"{word} floor", sim, st,
                            ng.replace(wall_hist=ng.wall_hist[:, :sim.cap_local]), results)
    (sg, tg, mg, wg, lg), (sc, tc, mc, wc, _) = runs
    rel = {k: abs(tg[k] - tc[k]) / max(abs(tc[k]), 1e-30)
           for k in ("ke", "pe_pair", "pe_wall", "etot")}
    dx = float(np.abs(by_tag(sg, "x") - by_tag(sc, "x")).max())
    print(f"{'a (2, 2) brick' if brick else '2 slabs'}, x not periodic, plane floor, "
          f"n={x.shape[0]}, {steps} steps, card vs CPU: tags that changed {word} by axis "
          f"(along two or more) {mg} / {mc}, largest wall spring {wg:.3g} / {wc:.3g}, "
          + " ".join(f"{k}={tg[k]:.6g}(rel {v:.2e})" for k, v in rel.items())
          + f" max|dx|={dx:.3g} (tol: thermo 2e-3, dx 1e-3); card launches "
          f"{ {k: v for k, v in lg.items() if v} }")
    require(tc["pe_wall"] > 0 and all(mc[0]) and wc > 0, f"{word} floor: no wall "
            "contact, or no migration along an axis")
    require(lg["wall_plane"] > 0, f"{word} floor: K7 never launched on the card")
    require(max(rel.values()) <= 2e-3 and dx <= 1e-3,
            f"{word} floor: card and CPU disagree")
    print(f"{word} card-vs-CPU phases: {time.perf_counter() - t0:.1f}s")


def rebuild_replays(sim):
    """The replays of ``sim``'s rebuilding graphs (``always``, ``rebuild``)."""
    return sum(r.replays.get(k, 0) for r in sim._graphs.values()
               for k in ("always", "rebuild"))


def sharded_path(label, sim, state, neigh, ghosts, kernels, smi, block, n_blocks,
                 max_blocks=0):
    """Drive the slabs through ``ShardedSimulation.run``: one step to
    capture the graphs (dropped), then, with every launch counter at 0,
    ``n_blocks`` runs of ``block`` steps (more, up to ``max_blocks``, until
    one has replayed a rebuilding graph). Fatal unless the run rebuilt,
    overflow and skin violations read 0, etot is finite and every kernel
    of ``kernels`` launched. Then ``graph_vs_eager`` over the first block
    that rebuilt, from its start (the eager plain and rebuild steps being
    ``_local_step``'s 'comm' and 'always'): fatal unless its two graph runs
    replayed a rebuild too. Prints the rates, the rebuilds, the tags that
    changed shard over the run along each mesh axis (and along two or
    more), and for each mesh axis (a slab's: x) the ghosts of each shard
    and the largest one-side halo send of the last rebuild against
    ``halo_cap``. Returns (each block's end [(state, neigh, ghosts)],
    launches, thermo, seconds a step)."""
    import torch

    sim.run(state, neigh, ghosts, 1)
    owners = shard_owners(state)
    ends, rebuilt = [], None
    reset_counts()
    r0 = rebuild_replays(sim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(ends) < n_blocks or (rebuilt is None and len(ends) < max_blocks):
        r = rebuild_replays(sim)
        start = ends[-1] if ends else (state, neigh, ghosts)
        ends.append(sim.run(*start, block))
        if rebuilt is None and rebuild_replays(sim) > r:
            rebuilt = (len(ends) - 1, start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    rebuilds = rebuild_replays(sim) - r0
    steps = block * len(ends)
    state, neigh, ghosts = ends[-1]
    th = sim.thermo(state, neigh, ghosts)
    n = int(th["n"])
    overflow = int(neigh.overflow.max())
    skin = int(neigh.skin_violations.max())
    moved, diagonal = moved_by_axis(sim, owners, shard_owners(state))
    H = sim.halo_cap
    packs = ghosts if isinstance(ghosts, tuple) else (ghosts,)
    names = getattr(sim.axis, "names", "x")
    halo = "; ".join(
        f"{ax}: ghosts by shard {g.active.sum(-1).tolist()}, largest one-side send "
        f"{int(torch.stack([g.send_mask[:, :H].sum(-1), g.send_mask[:, H:].sum(-1)]).max())}"
        f" of halo_cap {H}" for ax, g in zip(names, packs))
    print(f"{label}: {steps} steps in {wall:.3f}s -> {n * steps / wall:.1f} particle-steps/s "
          f"[{smi}] in {len(ends)} runs of {block}; rebuilds {rebuilds} (first in steps "
          f"{'none' if rebuilt is None else f'{rebuilt[0] * block + 1}-{(rebuilt[0] + 1) * block}'}"
          f") overflow={overflow} skin_violations={skin} etot={float(th['etot']):.6g} "
          f"pe_pair={float(th['pe_pair']):.6g}; tags that changed shard by axis {moved} "
          f"(along two or more: {diagonal}); halo by axis (the last rebuild's) {halo}; "
          f"launches={ {k: v for k, v in launches.items() if v} }")
    require(rebuilt is not None and rebuilds > 0,
            f"{label}: the run never replayed a rebuild in {steps} steps")
    require(overflow == 0, f"{label}: capacity overflow (channel={overflow})")
    require(skin == 0, f"{label}: {skin} skin violations")
    require(math.isfinite(float(th["etot"])), f"{label}: non-finite energy")
    require(all(launches[k] > 0 for k in kernels),
            f"{label}: a kernel of the path never launched: {launches}")
    ws, wn, wg = rebuilt[1]
    one = lambda kind: sim._local_step(ws, wn, wg, "comm" if kind == "never" else "always")
    r = rebuild_replays(sim)
    ref = graph_vs_eager(f"{label}, steps {rebuilt[0] * block + 1}-"
                         f"{(rebuilt[0] + 1) * block}", sim,
                         lambda k: sim.run(ws, wn, wg, k), block, sim, ws, wn,
                         one_step=one)
    require(rebuild_replays(sim) - r >= 2,
            f"{label}: the eager-vs-graph window replayed no rebuild")
    graph_row(label, n, ref, wall / steps, smi)
    return ends, launches, th, wall / steps


def sharded_vs_single(label, sharded, single, periodic, what="the single card run"):
    """Hold a sharded run's end to the single card run's of the same start
    and steps, with the reference's sharded-vs-single bounds
    (tests/test_sharded.py:90-103): per tag x within 2e-3 (minimum image)
    and v within 5e-3, ke and etot within rel 1e-3, stress within rtol
    2e-2 / atol 1e-3."""
    (st, th), (s1, th1) = sharded, single
    dx, dv = by_tag_gap(st, s1, periodic)
    rel = {k: abs(float(th[k]) - float(th1[k])) / abs(float(th1[k])) for k in ("ke", "etot")}
    a, b = th["stress"].cpu().numpy(), th1["stress"].cpu().numpy()
    stress_ok = bool(np.all(np.abs(a - b) <= 1e-3 + 2e-2 * np.abs(b)))
    print(f"{label} vs {what}: max|dx|={dx:.3g} max|dv|={dv:.3g} "
          + " ".join(f"{k} rel {v:.2e}" for k, v in rel.items())
          + f" stress max|d|={float(np.abs(a - b).max()):.3g} (scale "
          f"{float(np.abs(b).max()):.3g}) (tol: dx 2e-3, dv 5e-3, ke/etot 1e-3, stress "
          "rtol 2e-2 atol 1e-3)")
    require(dx <= 2e-3 and dv <= 5e-3 and max(rel.values()) <= 1e-3 and stress_ok,
            f"{label}: disagrees with {what}")


def sharded_triaxial_phase(tri, st0, single_end, dev, smi, results, brick=False,
                           mesh=BRICK):
    """The n = N_TRI sheared triaxial cell on N_SHARDS slabs
    (``triaxial_cell(sharded=True)``: the reference's capacities, cap_local
    4n/S, halo_cap 2n/S, pair cap 12n/S, cell_cap 12, tilt pad 0.12 box;
    with ``brick`` on a ``mesh`` brick, ``brick_triaxial_sim``: halo_cap n/S
    a side for each axis, the tilt pad along x only),
    rebuilt on a cadence of SHARD_TRI_EVERY steps, from ``triaxial_path``'s
    start (``triaxial_state``): its forces after ``init`` held per tag to
    the single cell's ``init_neighbors`` within 2e-3 |F|max;
    ``sharded_path`` over TRI_STEPS steps in runs of SHARD_TRI_EVERY, each
    starting with a rebuild (wrap, migration, re-halo, the slabs' cell
    list and pair lists); the end held to ``single_end`` (the single card
    run's end and thermo, the same start and steps: ``sharded_vs_single``);
    then K2 on its own pair lists (S x 12n/S slots, one launch). Returns
    the run's launches and its end (state, thermo)."""
    import torch

    from torch_port_util import triaxial_state

    from spherharm_tpu_torch.models import scenarios

    t0 = time.perf_counter()
    tag = (f"triaxial brick {'x'.join(map(str, mesh))}" if brick
           else f"triaxial S={N_SHARDS}")
    start = triaxial_state(st0, dev)[0]
    if brick:
        sim = brick_triaxial_sim(tri, float(st0.box_hi[0]), N_TRI, dev, mesh)
    else:
        sim = scenarios.triaxial_cell(n=N_TRI, shear_rate=TRI_SHEAR,
                                      deform_min=TRI_DEFORM_MIN, sharded=True,
                                      n_shards=N_SHARDS, device=dev)[0]
    sim.rebuild_every = SHARD_TRI_EVERY
    torch.cuda.empty_cache()
    st, ng, gh = sim.init(start)
    s1, _ = tri.init_neighbors(start)
    top, share = force_gap(st, s1)
    print(f"{tag}: n={N_TRI}, cap_local {sim.cap_local}, halo_cap {sim.halo_cap}, "
          f"{sim.n_shards} x {sim.cap_ext} extended rows, grid {sim.grid_dims}, halo depth "
          f"{halo_depths(sim)}, narrowest shard "
          f"{sim.slab_w}, pair cap {sim.pair_capacity} a shard, a rebuild every "
          f"{sim.rebuild_every} steps; forces after init vs the single cell's: max "
          f"{top:.3g} |F|max, {share:.2%} of rows past 1e-4 (tol 2e-3); set-up "
          f"{time.perf_counter() - t0:.1f}s")
    require(top <= 2e-3, f"{tag}: forces after init disagree with the single cell's")
    del s1
    ends, launches, th, _ = sharded_path(
        tag, sim, st, ng, gh, ("pair_contact_geometric",), smi, SHARD_TRI_EVERY,
        TRI_STEPS // SHARD_TRI_EVERY)
    st, ng, gh = ends[-1]
    sharded_vs_single(tag, (st, th), single_end, (True,) * 3)
    stage2_list_phase(tag, list_view(sim), sim._extend(st, gh), ng, results,
                      bf16s=(False,), case_tag=f"{tag} pair list")
    print(f"{tag} phase: {time.perf_counter() - t0:.1f}s")
    return launches, (st, th)


def held_forces(label, sharded, single, sim):
    """A sharded state's forces held per tag to a single box's at the
    same positions: on the rows farther than the halo depth from the
    periodic seam of every sharded axis within 1e-4 |F|max on all but
    0.1 % of them, none past 2e-2; within it, none past 2e-3 (there the
    slabs and bricks image by shifting the sent ghost by the cell vector
    and the single box by rounding d / L, so d rounds apart by ~ulp(L):
    ``seam_witness``)."""
    from torch_port_util import by_tag

    x = by_tag(single, "x")
    seam = np.zeros(x.shape[0], bool)
    for ax, depth in halo_depths(sim).items():
        d = "xyz".index(ax)
        lo, hi = float(single.box_lo[d]), float(single.box_hi[d])
        seam |= np.minimum(x[:, d] - lo, hi - x[:, d]) < depth
    top, share = force_gap(sharded, single, ~seam)
    top_s, share_s = force_gap(sharded, single, seam)
    n_f = int((single.f.abs().amax(-1) > 0).sum())
    print(f"{label} ({n_f} of {x.shape[0]} rows carry a force): away from the periodic seams "
          f"max {top:.3g} |F|max, {share:.3%} of {int((~seam).sum())} rows past 1e-4 "
          f"(tol: 0.1% past 1e-4, none past 2e-2); within the halo depth of the seam max "
          f"{top_s:.3g}, {share_s:.3%} of {int(seam.sum())} rows past 1e-4 (tol: none "
          "past 2e-3)")
    require(top <= 2e-2 and share <= 1e-3 and top_s <= 2e-3,
            f"{label}: the slabs' forces disagree with the single box's")


def seam_witness(gas, gst, sim):
    """Why the seam rows part: the slabs' forces after ``init`` against the
    single box's, on the CPU twins in float32 and in float64, for the
    particles within two halo depths of the periodic x seam (every contact
    of a row within one halo depth of it is kept). A gap that comes from
    rounding d (~ulp(Lx)) all but vanishes in float64; a fault of the
    seam's ghost shift would not. Fatal unless the float64 gap is under
    1e-9 |F|max. Returns {dtype name: largest gap on the seam rows}."""
    import torch

    from torch_port_util import on_cpu

    from spherharm_tpu_torch.core.simulation import Simulation
    from spherharm_tpu_torch.parallel.halo import ShardedSimulation

    t0 = time.perf_counter()
    x = gst.x[:, 0].cpu().numpy()
    lo, hi = float(gst.box_lo[0]), float(gst.box_hi[0])
    d = np.minimum(x - lo, hi - x)
    near = torch.as_tensor((d < 2 * sim.halo_depth) & gst.active.cpu().numpy())
    gaps = {}
    for dtype in (torch.float32, torch.float64):
        start = on_cpu(gst, dtype)
        start = start.replace(**{f: getattr(start, f)[near] for f in
                                 ("x", "v", "q", "angmom", "f", "tau", "scale", "shtype",
                                  "tag", "active", "image")})
        shapes, params = on_cpu(gas.shapes, dtype), on_cpu(gas.params, dtype)
        single = Simulation(shapes, params, periodic=(True,) * 3, neighbor_mode="cell",
                            grid=gas.grid, k_max=gas.k_max, cell_cap=gas.cell_cap,
                            pair_capacity=gas.pair_capacity,
                            stage2_capacity=gas.stage2_capacity,
                            conservative=gas.conservative, device="cpu")
        slabs = ShardedSimulation(
            shapes, params, n_shards=sim.n_shards, box_lo=sim.box_lo_np,
            box_hi=sim.box_hi_np, cap_local=sim.cap_local, halo_cap=sim.halo_cap,
            periodic=sim.periodic, k_max=sim.k_max, cell_cap=sim.cell_cap,
            pair_capacity=sim.pair_capacity, stage2_capacity=sim.stage2_capacity,
            conservative=sim.conservative, device="cpu")
        s1, _ = single.init_neighbors(start)
        st = slabs.init(start)[0]
        seam = d[near.numpy()] < sim.halo_depth
        order = np.argsort(start.tag.numpy())
        gaps[str(dtype).split(".")[-1]] = force_gap(st, s1, seam[order])[0]
    print(f"seam witness, {int(near.sum())} particles within {2 * sim.halo_depth:.4g} of "
          f"the x seam, forces after init, slabs vs single box on the CPU twins, on the "
          f"rows within the halo depth of it: largest gap "
          + ", ".join(f"{k} {v:.3g} |F|max" for k, v in gaps.items())
          + f" (tol: float64 1e-9); {time.perf_counter() - t0:.1f}s")
    require(gaps["float64"] <= 1e-9, "seam witness: the slabs' seam rows part from the "
            "single box's in float64 too")
    return gaps


def gas_shard_sim(gas, gst, shape):
    """The n = N_GAS drift gas ``gas`` (at its state ``gst``) on ``shape``
    slabs (an int) or a ``shape`` brick: cap_local 4n/S, halo_cap 2n/S,
    pair cap 8n/S, stage-2 cap 4n/S, the single gas's k_max, cell_cap and
    law, its skin trigger."""
    from spherharm_tpu_torch.parallel.brick import BrickSimulation
    from spherharm_tpu_torch.parallel.halo import ShardedSimulation

    n, S = N_GAS, int(np.prod(shape))
    kw = dict(box_lo=gst.box_lo.cpu().numpy(), box_hi=gst.box_hi.cpu().numpy(),
              cap_local=4 * n // S, halo_cap=2 * n // S, periodic=(True,) * 3,
              k_max=gas.k_max, cell_cap=gas.cell_cap, pair_capacity=8 * n // S,
              stage2_capacity=4 * n // S, conservative=gas.conservative,
              device=gst.x.device)
    if isinstance(shape, tuple):
        return BrickSimulation(gas.shapes, gas.params, mesh_shape=shape, **kw)
    return ShardedSimulation(gas.shapes, gas.params, n_shards=S, **kw)


def sharded_gas_phase(gas, gst, gng, smi, results, brick=False):
    """The n = N_GAS drift gas on N_SHARDS slabs (with ``brick`` on a
    BRICK brick, halo_cap 2n/S a side for each axis, no ``seam_witness``)
    (cap_local 4n/S and
    halo_cap 2n/S, as the reference sizes the sharded triaxial cell; its
    pair cap 6n and stage-2 cap 3n split over the slabs with a third more
    for the owned-ghost pairs each slab holds: 8n/S and 4n/S; k_max 24,
    cell_cap 16, the skin trigger) from the drift path's end (step
    GAS_WARM + GAS_STEPS): forces after ``init`` held per tag to the single
    gas's ``init_neighbors`` of that state (``held_forces``) and the seam's
    ``seam_witness``; ``sharded_path`` in runs of SHARD_GAS_BLOCK steps
    until one has rebuilt (the prefilter's K4 with the slack maxima global
    over the slabs, migration, re-halo); its state after SHARD_GAS_STEPS
    steps held to SHARD_GAS_STEPS single card steps from the same start
    (``sharded_vs_single``); its forces at the end of the run, on the
    lists of the run's last rebuild, held to a fresh single build at the
    same positions (``held_forces``: the gas has no friction or damping,
    so its forces are those of the positions alone); then K1 on its own
    stage-2 lists and K4 on the candidate lists a rebuild of the slabs
    builds (``sharded_candidate_list``). Returns the run's launches and
    (state, thermo) after SHARD_GAS_STEPS steps."""
    t0 = time.perf_counter()
    tag = BRICK_GAS if brick else f"drift gas S={N_SHARDS}"
    sim = gas_shard_sim(gas, gst, BRICK if brick else N_SHARDS)
    S = sim.n_shards
    st, ng, gh = sim.init(gst)
    s1, _ = gas.init_neighbors(gst)
    print(f"{tag}: {S} x {sim.cap_ext} extended rows, grid {sim.grid_dims}, halo depth "
          f"{halo_depths(sim)}, narrowest shard {sim.slab_w}")
    held_forces(f"{tag}: forces after init vs the single gas's init", st, s1, sim)
    del s1
    if not brick:
        seam_witness(gas, gst, sim)
    k = SHARD_GAS_STEPS // SHARD_GAS_BLOCK
    ends, launches, th, _ = sharded_path(
        tag, sim, st, ng, gh, ("pair_contact_conservative", "stage1_depth"), smi,
        SHARD_GAS_BLOCK, k, SHARD_GAS_BLOCKS)
    s1, n1 = gas.run(gst, gng, SHARD_GAS_STEPS)
    se, ne, ge = ends[k - 1]
    held = (se, sim.thermo(se, ne, ge))
    sharded_vs_single(f"{tag} after {SHARD_GAS_STEPS} steps", held,
                      (s1, gas.thermo(s1, n1)), (True,) * 3)
    st, ng, gh = ends[-1]
    steps = SHARD_GAS_BLOCK * len(ends)
    s1, n1 = gas.run(s1, n1, steps - SHARD_GAS_STEPS)
    dx, dv = by_tag_gap(st, s1, (True,) * 3)
    t1 = gas.thermo(s1, n1)
    print(f"{tag} after {steps} steps vs the single card run (not held: the two "
          f"trajectories part as rounding grows): max|dx|={dx:.3g} max|dv|={dv:.3g} "
          + " ".join(f"{q} rel {abs(float(th[q]) - float(t1[q])) / abs(float(t1[q])):.2e}"
                     for q in ("ke", "etot")))
    fresh, _ = gas.init_neighbors(sim.gather_restart(st, ng)[0])
    held_forces(f"{tag}: forces after {steps} steps (lists of the run's last rebuild) vs "
                "a fresh single build at the same positions", st, fresh, sim)
    del s1, n1, fresh
    view = list_view(sim)
    stage2_list_phase(tag, view, sim._extend(st, gh), ng, results, bf16s=(False,))
    stage1_list_phase(tag, view, st, ng, results,
                      cand=sharded_candidate_list(sim, st, ng, gh))
    print(f"{tag} phase: {time.perf_counter() - t0:.1f}s")
    return launches, held


# -- one shard a process (parallel/ranks.py) ----------------------------------


def rank_owned(st):
    """A rank's owned tags, as a list (its one shard's active rows)."""
    return st.tag[st.active].tolist()


def rank_profile(run, steps, sync=None):
    """torch.profiler over ``run()`` (``steps`` steps) on this rank:
    (device ms a step, the NCCL kernels' ms a step). An NCCL kernel's time
    includes its wait for the peers. ``sync()``: run in a discarded
    window before the profiled one (a barrier of the ranks, the card
    idle), so that the profiled window holds this run's kernels only and
    opens with the ranks in step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    plan = schedule(wait=0, warmup=1, active=1, repeat=1) if sync else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=plan) as prof:
        if sync:
            sync()
            prof.step()
        run()
        torch.cuda.synchronize()
        if sync:
            prof.step()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    total = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    nccl = sum(e.self_device_time_total for e in dev
               if "nccl" in e.key.lower()) / 1e3 / steps
    return total, nccl


def rank_path(axis, label, block, n_blocks, max_blocks=0, graphs=True, spec=None,
              cell_n=0, every=0, held_at=0, must_rebuild=True):
    """One rank's share of a sharded path: the simulation built on this
    rank (``cell_n``: ``triaxial_cell(n=cell_n, sharded=True, axis=axis)``
    rebuilt every ``every`` steps, 0: its skin trigger; else
    ``ranks.build(spec)``), ``init`` from ``spec["state"]``, then runs of
    ``block`` steps with every launch counter at 0 (``n_blocks``, more up
    to ``max_blocks`` until one has rebuilt), as CUDA graph replays
    (``graphs``; the graphs captured by a run of ``block`` steps before,
    dropped) or eagerly. With graphs, the first run that rebuilt (else the first) again
    eagerly from its start (bit for bit the graph run's; its host-clock ms
    a step and the bytes ``ring_shift`` sent a step), and its first
    PROFILE_STEPS steps under torch.profiler, eagerly and as graph replays
    (device ms a step, the NCCL kernels' share; an eager NCCL kernel also
    waits for the peers' host launches; the graph replays' window opens
    right after a barrier of the ranks, ``rank_profile(sync=...)``). Returns
    this rank's figures, its owned rows at ``init``, after ``held_at``
    steps and at the end, and the global thermo at those. Fatal unless a
    run rebuilt (``must_rebuild``)."""
    import torch
    import torch.distributed as dist

    from spherharm_tpu_torch.models import scenarios
    from spherharm_tpu_torch.parallel import ranks
    from spherharm_tpu_torch.utils import validate

    t_set = time.perf_counter()
    dev = axis.device
    start = ranks.land(spec["state"], dev)
    if cell_n:
        sim = scenarios.triaxial_cell(n=cell_n, shear_rate=TRI_SHEAR,
                                      deform_min=TRI_DEFORM_MIN, sharded=True, axis=axis,
                                      device=dev, cuda_graphs=graphs)[0]
        sim.rebuild_every = every
    else:
        sim, _ = ranks.build(dict(spec, sim=dict(spec["sim"], cuda_graphs=graphs)), dev,
                             axis)
    st, ng, gh = sim.init(start)
    rows = lambda s: {f: getattr(s, f) for f in ("x", "v", "f", "tag", "active")}
    out = {"rank": axis.rank, "device": torch.cuda.get_device_name(dev), "init": rows(st),
           "owned0": rank_owned(st)}
    fired = [0]
    if graphs:
        # Capture, and warm the card (clocks) with one run of ``block``
        # steps from the start, dropped.
        sim.run(st, ng, gh, block)
        count = lambda: rebuild_replays(sim)
    else:
        rebuild = sim._rebuild
        sim._rebuild = lambda *a, **k: (fired.__setitem__(0, fired[0] + 1),
                                        rebuild(*a, **k))[1]
        count = lambda: fired[0]
    ends, rebuilt = [], None
    reset_counts()
    sent0 = sim.axis.sent_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r0 = count()
    while len(ends) < n_blocks or (rebuilt is None and len(ends) < max_blocks):
        r = count()
        first = ends[-1] if ends else (st, ng, gh)
        ends.append(sim.run(*first, block))
        if rebuilt is None and count() > r:
            rebuilt = (len(ends) - 1, first)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = block * len(ends)
    out.update(launches=launch_counts(), rebuilds=count() - r0, steps=steps,
               ms=1e3 * wall / steps,
               first_rebuild=None if rebuilt is None else rebuilt[0] * block + 1)
    require(rebuilt is not None or not must_rebuild,
            f"{label} rank {axis.rank}: no rebuild in {steps} steps")
    if graphs:
        k, (ws, wn, wg) = rebuilt if rebuilt is not None else (0, (st, ng, gh))
        with eager(sim):
            sent0 = sim.axis.sent_bytes
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = sim.run(ws, wn, wg, block)
            torch.cuda.synchronize()
            out["eager_ms"] = 1e3 * (time.perf_counter() - t0) / block
            out["sent_per_step"] = (sim.axis.sent_bytes - sent0) / block
            n_prof = min(block, PROFILE_STEPS)
            out["device_ms"], out["nccl_ms"] = rank_profile(
                lambda: sim.run(ws, wn, wg, n_prof), n_prof)
        out["graph_device_ms"], out["graph_nccl_ms"] = rank_profile(
            lambda: sim.run(ws, wn, wg, n_prof), n_prof, sync=lambda: (
                torch.cuda.synchronize(),
                dist.barrier(group=sim.axis.group, device_ids=[dev.index]),
                torch.cuda.synchronize()))
        diff = validate.bitwise_differences(ends[k], ref)
        out["graph_vs_eager"] = {k2: v for k2, v in diff.items()}
        stats = sim.graph_stats()
        out.update(capture_s=stats["capture_s"], pool_bytes=stats["pool_bytes"],
                   replays=stats["replays"])
    else:
        out["sent_per_step"] = (sim.axis.sent_bytes - sent0) / steps
    st, ng, gh = ends[-1]
    th = lambda e: {k: v for k, v in sim.thermo(*e).items()}
    out.update(end=rows(st), end_th=th(ends[-1]), owned=rank_owned(st),
               overflow=int(ng.overflow.max()), skin=int(ng.skin_violations.max()))
    if held_at:
        e = ends[held_at // block - 1]
        out.update(held=rows(e[0]), held_th=th(e))
    packs = gh if isinstance(gh, tuple) else (gh,)
    H = sim.halo_cap
    out["ghosts"] = [int(g.active.sum()) for g in packs]
    out["largest_send"] = [int(max(g.send_mask[:, :H].sum(), g.send_mask[:, H:].sum()))
                           for g in packs]
    out["setup_s"] = time.perf_counter() - t_set - wall
    return out


def rank_jobs(axis, jobs):
    """The spawned ranks' work: each job (kind, keyword arguments) in
    order, "dryrun" (``ranks.dryrun``) or "path" (``rank_path``)."""
    from spherharm_tpu_torch.parallel import ranks

    return [ranks.dryrun(axis, **kw) if kind == "dryrun" else rank_path(axis, **kw)
            for kind, kw in jobs]


def rank_state(per_rank, key):
    """The ranks' owned rows of ``key`` as one state-like namespace (by
    tag: ``torch_port_util.by_tag``)."""
    import types

    return types.SimpleNamespace(**{f: np.concatenate([r[key][f] for r in per_rank])
                                    for f in per_rank[0][key]})


def rank_thermo(per_rank, key):
    """Rank 0's global thermo ``key`` as tensors; fatal unless every rank
    returned the same bits."""
    import torch

    th = per_rank[0][key]
    require(all(all(np.array_equal(r[key][k], v) for k, v in th.items())
                for r in per_rank), f"the ranks' thermo {key} differ")
    return {k: torch.as_tensor(v) for k, v in th.items()}


def rank_moved(per_rank):
    """Tags that changed rank over a run."""
    before = {t: r["rank"] for r in per_rank for t in r["owned0"]}
    after = {t: r["rank"] for r in per_rank for t in r["owned"]}
    require(sorted(before) == sorted(after), "the ranks lost or duplicated a particle")
    return sum(before[t] != after[t] for t in before)


def rank_rows(label, per_rank, n, smi, one_card=None):
    """Print each rank's figures of a path (and the one-card shard-axis
    row of the same call beside them); fatal on overflow, skin
    violations, a graph run that is not its eager run, or a rank whose
    pair kernel never launched."""
    moved = rank_moved(per_rank)
    for r in per_rank:
        graph = "graph_vs_eager" in r
        rate = 1e3 * n / r["ms"]
        line = (f"{label} rank {r['rank']} ({r['device']}): {r['steps']} steps, "
                f"{'graph' if graph else 'eager'} {r['ms']:.4f} ms a step "
                f"({rate:.1f} particle-steps/s)")
        if graph:
            gdev, gnccl = r["graph_device_ms"], r["graph_nccl_ms"]
            line += (f", eager {r['eager_ms']:.4f} ms a step; graph replays' profile: device "
                     f"{gdev:.4f} ms a step, NCCL kernels {gnccl:.4f} "
                     f"({gnccl / max(gdev, 1e-9):.1%} of it), the rest {gdev - gnccl:.4f}; "
                     f"graph run busy {gdev / r['ms']:.1%}; eager profile: device "
                     f"{r['device_ms']:.4f}, NCCL {r['nccl_ms']:.4f} (waiting on the peers' host "
                     f"launches included); graph vs eager "
                     + ("bit-equal" if not r["graph_vs_eager"] else
                        f"DIFFERENT {r['graph_vs_eager']}")
                     + f"; capture {r['capture_s']:.3f}s, pool {r['pool_bytes']} bytes")
        line += (f"; p2p bytes sent a step {r['sent_per_step']:.0f}; rebuilds {r['rebuilds']} "
                 f"(first in the run from step {r['first_rebuild']}); ghosts by axis "
                 f"{r['ghosts']}, largest send {r['largest_send']}; set-up "
                 f"{r['setup_s']:.1f}s; launches "
                 f"{ {k: v for k, v in r['launches'].items() if v} } [{smi}]")
        print(line)
        require(r["overflow"] == 0 and r["skin"] == 0,
                f"{label} rank {r['rank']}: overflow {r['overflow']}, skin {r['skin']}")
        require(not r.get("graph_vs_eager"),
                f"{label} rank {r['rank']}: the graph run is not the eager run")
    print(f"{label}: {moved} tags changed rank"
          + ("" if one_card is None else
             f"; beside it one card's shard axis: graph {one_card['graph_ms']:.4f} ms a step, "
             f"eager {one_card['eager_ms']:.4f}, device {one_card['device_ms']:.4f}, busy "
             f"{one_card['busy']:.1%}"))


def rank_vs(label, per_rank, key, ref, what):
    """Per tag x, v and thermo of the ranks' ``key`` against a one-process
    run's (state, thermo) ``ref`` (``what`` names it): printed, with
    whether every row is bit for bit the same. Returns (dx, dv, the
    largest relative thermo gap)."""
    from torch_port_util import by_tag

    st, th = rank_state(per_rank, key), rank_thermo(per_rank, f"{key}_th")
    dx, dv = by_tag_gap(st, ref[0], (True,) * 3)
    rel = max(abs(float(th[k]) - float(ref[1][k])) / max(abs(float(ref[1][k])), 1e-30)
              for k in ("ke", "etot", "pe_pair"))
    same = all(np.array_equal(by_tag(st, f), by_tag(ref[0], f)) for f in ("x", "v"))
    print(f"{label} vs {what}: max|dx|={dx:.3g} max|dv|={dv:.3g} thermo rel {rel:.2e}; "
          f"{'bit-equal x and v' if same else 'not bit-equal'}")
    return dx, dv, rel


def rank_phase(dev, smi, tri, tri_st0, single_end):
    """The default run's ranks: one ``spawn_ranks`` call of RANKS gloo
    processes on this one card (eager: gloo stages CUDA tensors through
    host memory, which no CUDA graph holds), each running
    ``dryrun_sharded(RANKS)`` and ``dryrun_brick(RANK_BRICK)`` (thermo
    within 2e-3 of the one-process card run's, the same overflow), the
    sheared cell at n = SHARD_TRI_SMALL on RANKS rank slabs for 40 steps
    (its skin trigger) against the one-process RANKS-slab card run (per
    tag within 1e-3, thermo within 2e-3; bit-equality printed) and the
    n = N_TRI sheared cell on RANKS rank slabs for TRI_STEPS steps, a
    rebuild every SHARD_TRI_EVERY, against the single card run with the
    reference's sharded bounds (``sharded_vs_single``). Fatal if a rank
    fails or K2 did not launch in every rank."""
    import torch

    from torch_port_util import triaxial_state

    from spherharm_tpu_torch.models import scenarios
    from spherharm_tpu_torch.parallel import ranks
    from spherharm_tpu_torch.parallel.dryrun import dryrun_brick, dryrun_sharded

    t0 = time.perf_counter()
    small, small_st0, _ = scenarios.triaxial_cell(n=SHARD_TRI_SMALL, shear_rate=TRI_SHEAR,
                                                  deform_min=TRI_DEFORM_MIN, device=dev)
    small_start = triaxial_state(small_st0, dev)[0]
    del small
    sim = scenarios.triaxial_cell(n=SHARD_TRI_SMALL, shear_rate=TRI_SHEAR,
                                  deform_min=TRI_DEFORM_MIN, sharded=True, n_shards=RANKS,
                                  device=dev)[0]
    st, ng, gh = sim.run(*sim.init(small_start), 40)
    small_end = (st, sim.thermo(st, ng, gh))
    dry = [dryrun_sharded(RANKS, device=dev), dryrun_brick(RANK_BRICK, device=dev)]
    start = triaxial_state(tri_st0, dev)[0]
    jobs = [("dryrun", dict(shape=(RANKS,), cuda_graphs=False)),
            ("dryrun", dict(shape=RANK_BRICK, cuda_graphs=False)),
            ("path", dict(label="small sheared cell", block=40, n_blocks=1, graphs=False,
                          spec={"state": ranks.ship(small_start)},
                          cell_n=SHARD_TRI_SMALL, must_rebuild=False)),
            ("path", dict(label="triaxial ranks", block=SHARD_TRI_EVERY,
                          n_blocks=TRI_STEPS // SHARD_TRI_EVERY, graphs=False,
                          spec={"state": ranks.ship(start)}, cell_n=N_TRI,
                          every=SHARD_TRI_EVERY))]
    del sim, st, ng, gh, start
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    per_rank = ranks.spawn_ranks(rank_jobs, RANKS, "gloo", [str(dev)] * RANKS, jobs,
                                 timeout=RANK_TIMEOUT)
    print(f"rank phase: {RANKS} gloo ranks on {torch.cuda.get_device_name(dev)}, "
          f"spawned and run in {time.perf_counter() - t1:.1f}s")
    for j, (label, ref) in enumerate(zip((f"dryrun_sharded({RANKS})",
                                          f"dryrun_brick({RANK_BRICK})"), dry)):
        ths = [r[j] for r in per_rank]
        rel = max(abs(float(t[k]) - float(ref[k])) / max(abs(float(ref[k])), 1e-30)
                  for t in ths for k in ("ke", "erot", "pe_pair", "etot"))
        ovf = {int(t["neigh_overflow"]) for t in ths}
        print(f"{label} on {RANKS} gloo ranks vs one process, card: n={int(ths[0]['n'])} "
              f"etot={float(ths[0]['etot']):.7g} (rel {rel:.2e}, tol 2e-3) overflow "
              f"{ovf} / {int(ref['neigh_overflow'])}")
        require(rel <= 2e-3 and ovf == {int(ref["neigh_overflow"])},
                f"{label} on ranks disagrees with the one-process run")
    small_r = [r[2] for r in per_rank]
    rank_rows(f"small sheared cell n={SHARD_TRI_SMALL} on {RANKS} gloo ranks", small_r,
              SHARD_TRI_SMALL, smi)
    dx, _, rel = rank_vs(f"small sheared cell on {RANKS} gloo ranks", small_r, "end",
                         small_end, f"the one-process {RANKS}-slab card run")
    require(dx <= 1e-3 and rel <= 2e-3, "small sheared cell: ranks and one process disagree")
    big = [r[3] for r in per_rank]
    rank_rows(f"triaxial n={N_TRI} on {RANKS} gloo ranks", big, N_TRI, smi)
    require(all(r["launches"]["pair_contact_geometric"] > 0 for r in big),
            "triaxial ranks: K2 did not launch in every rank")
    rank_vs(f"triaxial n={N_TRI} on {RANKS} gloo ranks", big, "end", single_end,
            "the single card run")
    sharded_vs_single(f"triaxial n={N_TRI} on {RANKS} gloo ranks",
                      (rank_state(big, "end"), rank_thermo(big, "end_th")), single_end,
                      (True,) * 3)
    print(f"rank phase: {time.perf_counter() - t0:.1f}s")
    return {"ranks": [r["launches"] for r in big]}


def quiet(_line):
    """An ``out`` callback that drops a harness's per-sample lines."""


def cadence_phase(sim, state, neigh, smi):
    """The cadence sweep and the span profile
    (``validation/cadence_sweep.py``, ``validation/profile_step.py``) on the
    main-path drum warmed up by its own run: the rebuild step, the plain
    step and a block of R_EVERY (graph replays between CUDA events), one
    row per cadence of ``CADENCES`` (one block each: 3R steps, 60 for the
    trigger; a row with skin violations or overflow void, as in the
    reference), then the span profile of 3 R_EVERY steps (every span of
    ``utils/spans`` opened, 98 % of the device time in some span). Returns
    {path: launches}."""
    import torch

    from spherharm_tpu_torch.utils import spans, timing
    from spherharm_tpu_torch.validation import cadence_sweep, profile_step

    t0 = time.perf_counter()
    counted = {}
    pr = lambda line: print(f"cadence sweep: {line}")
    rows = cadence_sweep.block_decomposition(sim, state, neigh, out=pr)
    require(rows["rebuild step"] > rows["plain step"] > 0,
            f"cadence sweep: a rebuild step not dearer than a plain one: {rows}")
    for r in CADENCES:
        reset_counts()
        row = cadence_sweep.sweep_row(sim, state, r, 3 * r if r else 60, out=pr)
        counted[f"cadence sweep R={r}"] = launch_counts()
        torch.cuda.empty_cache()
        print(f"cadence sweep R={r}: {row} [{smi}]")
        require(row["rate"] > 0, f"cadence sweep R={r}: no rate")
        need = ("pair_contact_conservative", "wall_cylinder", "wall_plane") + (
            ("stage1_depth",) if r else ())
        require(all(counted[f"cadence sweep R={r}"][k] for k in need),
                f"cadence sweep R={r}: a kernel never launched: "
                f"{counted[f'cadence sweep R={r}']}")
    reset_counts()
    steps = 3 * R_EVERY
    _, summary = timing.span_profile(lambda: sim.run(state, neigh, steps))
    counted["profile"] = launch_counts()
    profile_step.print_profile(summary, steps,
                               out=lambda line: print(f"profile: {line}"))
    missing = [k for k in spans.SPANS if not summary["spans_n"].get(k)]
    require(not missing, f"profile: spans never opened on the card: {missing}")
    require(summary["coverage"] >= 0.98,
            f"profile: the spans cover {summary['coverage']} of the device time")
    print(f"cadence sweep and profile phase: {time.perf_counter() - t0:.1f}s [{smi}]")
    return counted


def free_flight_phase(label, built, steps, block, kernel, smi):
    """A drift harness (``validation/drift_lmax8.py``, ``validation/drift.py``)
    for ``steps`` steps sampled every ``block``: at least one mid-contact
    sample (pe_pair > 0) and a free-flight sample after it, overflow 0,
    ``kernel`` launched; prints the drift of the last free-flight sample
    per 1M steps and the rate. Returns the run's launches."""
    from spherharm_tpu_torch.validation import drift

    sim, state, neigh = built
    reset_counts()
    res = drift.free_flight(sim, state, neigh, steps, block, out=quiet)
    launches = launch_counts()
    per_m = drift.summary(sim, res, out=lambda line: print(f"{label}: {line}"))
    contact = res["contact_steps"]
    after = [s for s in res["samples"] if contact and s[0] > contact[0]]
    print(f"{label}: {steps} steps, a sample every {block}: mid-contact at steps "
          f"{contact[:8]}{' ...' if len(contact) > 8 else ''}; last free-flight "
          f"sample step {res['samples'][-1][0] if res['samples'] else None}, "
          f"drift {'none' if per_m is None else f'{per_m:+.4%}'} per 1M steps "
          "(too short to judge drift); launches "
          f"{ {k: v for k, v in launches.items() if v} } [{smi}]")
    require(contact, f"{label}: no collision (pe_pair > 0) in {steps} steps")
    require(after, f"{label}: no free-flight sample after the first collision")
    require(res["overflow"] == 0, f"{label}: overflow {res['overflow']}")
    require(all(math.isfinite(s[1]) for s in res["samples"]), f"{label}: etot not finite")
    require(launches[kernel] > 0, f"{label}: {kernel} never launched")
    return launches


def restitution_cpu_child():
    """The restitution sweep through the plain twins on the CPU (the
    module's ``main``: REST_R replicas, REST_STEPS steps) in a child
    process, started with the run so that it runs beside the card's
    phases; killed at exit if it is still running."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "spherharm_tpu_torch.validation.restitution_curve",
         str(REST_R), "--steps", str(REST_STEPS), "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc


def four_blob_label(law, seed):
    """The four blobs' path name: the law, and the seed under the
    geometric law."""
    return f"four-blob {law}" + (f" seed {seed}" if law == "geometric" else "")


def validation_phase(dev, smi, cpu_sweep):
    """The reference's validation harnesses (``spherharm_tpu_torch/validation``)
    on the card at cut lengths, each through its module's own functions,
    counters set to 0 just before each and read just after: the four blobs
    under the geometric law at each of FOUR_BLOB_SEEDS and under the
    conservative law at seed 0, and the collider (``free_flight_phase``); the
    restitution sweep (R = REST_R, REST_STEPS steps, the script's asserts,
    its table held within 1e-3 to the same sweep through the plain twins on
    the CPU, ``cpu_sweep`` from ``restitution_cpu_child``);
    the settling box's first PACK_BLOCKS blocks of PACK_BLOCK steps (phi
    and ke printed, overflow 0, no particle lost); the conservative probe's
    three rows (PROBE_STEPS steps each, the bounce reached). Returns
    {path: launches}."""
    from spherharm_tpu_torch.validation import (conservative_probe, drift,
                                                drift_lmax8, packing_n500,
                                                restitution_curve)

    t_phase = time.perf_counter()
    counted = {}
    for law, seed in ([("geometric", s) for s in FOUR_BLOB_SEEDS]
                      + [("conservative", 0)]):
        label = four_blob_label(law, seed)
        t0 = time.perf_counter()
        counted[label] = free_flight_phase(
            label, drift_lmax8.build(seed=seed, conservative=law == "conservative",
                                     device=dev),
            FOUR_BLOB_STEPS, FOUR_BLOB_BLOCK, f"pair_contact_{law}", smi)
        print(f"{label}: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    counted["collider"] = free_flight_phase(
        "collider", drift.build(device=dev), COLLIDER_STEPS, COLLIDER_BLOCK,
        "pair_contact_conservative", smi)
    print(f"collider: {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    built = restitution_curve.build(REST_R, device=dev)
    reset_counts()
    e, states, _ = restitution_curve.curve(*built[:4], REST_STEPS)
    label = f"restitution R={REST_R}"
    counted[label] = launch_counts()
    print(f"{label}: gamma_n {built[4].tolist()} -> e {e.tolist()} "
          f"({time.perf_counter() - t0:.1f}s) [{smi}]")
    try:
        restitution_curve.check(e)
    except AssertionError as err:
        require(False, f"{label}: {err}")
    require(counted[label]["pair_contact_conservative"] > 0,
            f"{label}: K1 never launched")
    out, _ = cpu_sweep.communicate(timeout=600)
    require(cpu_sweep.returncode == 0, f"{label} on the CPU failed:\n{out}")
    e_cpu = np.array(out.split("# RESULT: e(gamma_n) = ")[1].split(), float)
    gap = float(np.abs(e - e_cpu).max())
    print(f"{label}: card vs the plain twins on the CPU: max|d e| = {gap:.3g} "
          f"(tol 1e-3); CPU e {e_cpu.tolist()}")
    require(gap <= 1e-3, f"{label}: the card's table is not the CPU's")

    t0 = time.perf_counter()
    sim, state, neigh = packing_n500.build(500, device=dev)
    reset_counts()
    state, neigh, phi, _ = packing_n500.settle(
        sim, state, neigh, PACK_BLOCKS, PACK_BLOCK,
        out=lambda line: print(f"packing n=500: {line}"))
    counted["packing n=500"] = launch_counts()
    n_act, ovf = int(state.n_active), int(neigh.overflow)
    print(f"packing n=500: {PACK_BLOCKS} blocks of {PACK_BLOCK} steps, phi "
          f"{phi:.4f}, active {n_act}/500, overflow {ovf} "
          f"({time.perf_counter() - t0:.1f}s) [{smi}]")
    require(n_act == 500 and ovf == 0, "packing n=500: lost particles or overflow")
    require(all(counted["packing n=500"][k] for k in ("pair_contact_geometric",
                                                       "wall_plane")),
            f"packing n=500: a kernel never launched: {counted['packing n=500']}")

    shapes, _, st = conservative_probe.build(1e-4, device=dev)
    rsum = float((shapes.rmax[st.shtype] * st.scale).sum())
    for mode in conservative_probe.MODES:
        t0 = time.perf_counter()
        reset_counts()
        err, min_gap = conservative_probe.run(
            mode, PROBE_STEPS, 1e-4, dev, out=lambda line: print(f"probe {line}"))
        counted[f"probe {mode}"] = launch_counts()
        print(f"probe {mode}: {time.perf_counter() - t0:.1f}s [{smi}]")
        require(math.isfinite(err), f"probe {mode}: dE/E not finite")
        require(min_gap < rsum, f"probe {mode}: no bounce (min gap {min_gap:.3f})")
    for mode, law in (("geom", "geometric"), ("cons", "conservative")):
        require(counted[f"probe {mode}"][f"pair_contact_{law}"] >= PROBE_STEPS,
                f"probe {mode}: its kernel did not run every step")
    print(f"validation harnesses phase: {time.perf_counter() - t_phase:.1f}s")
    return counted


# The validation paths priced at the case of the shapes they run
# (``path_case``): the packing at the settling box's, the cadence sweep
# and the profile at the drum's.
CASE_OF = {"packing n=500": "settling box", "profile": "drum",
           **{f"cadence sweep R={r}": "drum" for r in CADENCES}}


def path_case(cases, path):
    """A kernel's case for ``path``: the path's own candidate list (the
    stage-1 probe), else its own stage-2 or pair list or wall batch, else
    its synthetic batch, else the kernel's first case. ``CASE_OF`` names
    the batch of a validation path."""
    path = CASE_OF.get(path, path)
    for tag in (f"{path} candidate list", f"{path} stage-2 list", f"{path} pair list",
                f"{path} wall batch", path):
        c = next((c for c in cases if c["path"] == tag), None)
        if c is not None:
            return c
    return cases[0]


def ranking(kern, counted):
    """Each kernel's time over its bound in this run, in ms: the sum over
    the paths that launched it (``counted``: {kernel: [(path, launches)]})
    of launches x (time - bound_ms) at that path's case (``path_case``);
    by the kernel's device time (``device_ms``) and by the wrapper call's
    (``ms``). Returns {kernel: (loss by device_ms, loss by ms)}."""
    out = {}
    for name, paths in counted.items():
        cases = kern[name]
        loss = [0.0, 0.0]
        for path, n in paths:
            c = path_case(cases, path)
            loss[0] += n * (c["device_ms"] - c["bound_ms"])
            loss[1] += n * (c["ms"] - c["bound_ms"])
        out[name] = tuple(loss)
    return out


def rank_references(dev, smi, n_ranks, kern):
    """On card ``dev``, in this process: the n = N_TRI sheared cell's single
    card run (TRI_STEPS steps), its one-card shard-axis runs on RANKS slabs
    and on a RANK_BRICK brick (``sharded_triaxial_phase``), the drift gas to
    step GAS_WARM + GAS_STEPS, its single card run of SHARD_GAS_STEPS
    steps and its one-card RANKS-slab run (``sharded_gas_phase``). Returns
    [(label, particles, one-card GRAPH_ROWS label, single (state, thermo),
    one-card (state, thermo), the kernels of the path, the rank job)]: the
    cell on ``n_ranks`` rank slabs (``triaxial_cell(sharded=True,
    axis=...)``) and on the RANK_BRICK brick (when ``n_ranks`` fills it),
    TRI_STEPS steps a rebuild every SHARD_TRI_EVERY, and the gas on
    ``n_ranks`` rank slabs on its trigger in runs of SHARD_GAS_BLOCK until
    one rebuilt."""
    import torch

    from torch_port_util import triaxial_state

    from spherharm_tpu_torch.models import drift, scenarios
    from spherharm_tpu_torch.parallel import ranks

    tri, tri_st0, _ = scenarios.triaxial_cell(n=N_TRI, shear_rate=TRI_SHEAR,
                                              deform_min=TRI_DEFORM_MIN, device=dev)
    start = triaxial_state(tri_st0, dev)[0]
    s1, n1 = tri.run(*tri.init_neighbors(start), TRI_STEPS)
    single_end = (s1, tri.thermo(s1, n1))
    _, slabs_end = sharded_triaxial_phase(tri, tri_st0, single_end, dev, smi, kern)
    torch.cuda.empty_cache()
    out = [(f"triaxial n={N_TRI} on {n_ranks} ranks", N_TRI, f"triaxial S={N_SHARDS}",
            single_end, slabs_end, ("pair_contact_geometric",),
            ("path", dict(label="triaxial", block=SHARD_TRI_EVERY,
                          n_blocks=TRI_STEPS // SHARD_TRI_EVERY,
                          spec={"state": ranks.ship(start)}, cell_n=N_TRI,
                          every=SHARD_TRI_EVERY)))]
    if n_ranks == int(np.prod(RANK_BRICK)):
        _, brick_end = sharded_triaxial_phase(tri, tri_st0, single_end, dev, smi, kern,
                                              brick=True, mesh=RANK_BRICK)
        torch.cuda.empty_cache()
        brick = brick_triaxial_sim(tri, float(tri_st0.box_hi[0]), N_TRI, dev, RANK_BRICK)
        brick.rebuild_every = SHARD_TRI_EVERY
        mesh = "x".join(map(str, RANK_BRICK))
        out.append((f"triaxial n={N_TRI} on a {mesh} brick of ranks", N_TRI,
                    f"triaxial brick {mesh}", single_end, brick_end,
                    ("pair_contact_geometric",),
                    ("path", dict(label="triaxial brick", block=SHARD_TRI_EVERY,
                                  n_blocks=TRI_STEPS // SHARD_TRI_EVERY,
                                  spec=ranks.spec_of(brick, start)))))
    gas, gas_st0 = drift.build_gas(N_GAS, device=dev)
    gst, gng = gas.run(*gas.init_neighbors(gas_st0), GAS_WARM + GAS_STEPS)
    _, gas_held = sharded_gas_phase(gas, gst, gng, smi, kern)
    s1, n1 = gas.run(gst, gng, SHARD_GAS_STEPS)
    out.append((f"drift gas n={N_GAS} on {n_ranks} ranks", N_GAS, f"drift gas S={N_SHARDS}",
                (s1, gas.thermo(s1, n1)), gas_held,
                ("pair_contact_conservative", "stage1_depth"),
                ("path", dict(label="drift gas", block=SHARD_GAS_BLOCK,
                              n_blocks=SHARD_GAS_STEPS // SHARD_GAS_BLOCK,
                              max_blocks=SHARD_GAS_BLOCKS,
                              spec=ranks.spec_of(gas_shard_sim(gas, gst, n_ranks), gst),
                              held_at=SHARD_GAS_STEPS))))
    return out


def rank_results(refs, per_rank, smi):
    """Each rank path of ``refs`` (``rank_references``) from the ranks'
    results: ``rank_rows`` beside its one-card row, its kernels launched
    in every rank, its state (the gas's after SHARD_GAS_STEPS steps) held
    to the single card run and to the one-card shard-axis run with the
    reference's sharded bounds (``sharded_vs_single``)."""
    for j, (label, n, one, single, held, kernels, _) in enumerate(refs):
        rows = [r[j] for r in per_rank]
        rank_rows(label, rows, n, smi, GRAPH_ROWS[one])
        require(all(r["launches"][k] > 0 for r in rows for k in kernels),
                f"{label}: a kernel of the path did not launch in every rank")
        key = "held" if "held" in rows[0] else "end"
        got = (rank_state(rows, key), rank_thermo(rows, f"{key}_th"))
        label = f"{label}, {'held' if key == 'held' else 'end'}"
        sharded_vs_single(label, got, single, (True,) * 3)
        rank_vs(label, rows, key, held, "the one-card shard-axis run")
        sharded_vs_single(label, got, held, (True,) * 3, "the one-card shard-axis run")


def ranks_main(n_ranks, smi):
    """``--ranks RANKS``: the sharded paths one shard a card over NCCL
    (``spawn_ranks``, one process a card, CUDA graphs with the NCCL p2p
    and collectives captured in the units): ``rank_references`` on card 0
    in this process, then the rank jobs, each rank's graph run bit-equal
    to its eager run, checked by ``rank_results``. Returns the exit code;
    fewer than RANKS cards is a failure."""
    import torch

    from spherharm_tpu_torch.ops import cuda_build
    from spherharm_tpu_torch.parallel import ranks

    cards = torch.cuda.device_count()
    if n_ranks != RANKS or cards < n_ranks:
        print(f"chip_smoke: --ranks {n_ranks} needs {RANKS} ranks on {RANKS} cards "
              f"(found {cards} cards)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    print(smi)
    t0 = time.perf_counter()
    cuda_build.build()
    cuda_build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s")
    refs = rank_references(torch.device("cuda", 0), smi, n_ranks, {})
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    per_rank = ranks.spawn_ranks(rank_jobs, n_ranks, "nccl",
                                 [f"cuda:{r}" for r in range(n_ranks)],
                                 [ref[-1] for ref in refs], timeout=RANK_TIMEOUT)
    print(f"{n_ranks} NCCL ranks, one a card: spawned and run in "
          f"{time.perf_counter() - t1:.1f}s")
    rank_results(refs, per_rank, smi)
    print(f"total wall time: {time.perf_counter() - t_start:.1f}s")
    smi_all = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print("; ".join(smi_all[:n_ranks]))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n_ranks}}))
    return 0


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from spherharm_tpu_torch.models import drift, scenarios
    from spherharm_tpu_torch.ops import contact_kernels as ck
    from spherharm_tpu_torch.ops import cuda_build
    from spherharm_tpu_torch.validation import drift as vdrift
    from spherharm_tpu_torch.validation import drift_lmax8

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if BF16_CHILD in argv:
        bf16_child(smi)
        return 0
    if "--ranks" in argv:
        return ranks_main(int(argv[argv.index("--ranks") + 1]), smi)
    require(not ck.STAGE2_BF16, "run without SPHERHARM_STAGE2_BF16: the bf16 "
            "phase sets it in a child process")
    cpu_sweep = restitution_cpu_child()

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    path, nvcc_s, log = cuda_build.build(ptxas_info=True)
    cuda_build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s (nvcc {nvcc_s:.1f}s) -> "
          f"{path.relative_to(ROOT)}")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    print_node_loop_sass(path, cuda_build.nvcc_path())

    t0 = time.perf_counter()
    sim, state, neigh = scenarios.rotating_drum(
        n=N_MAIN, lmax=LMAX, k_max=24, pair_capacity=5 * N_MAIN,
        stage2_capacity=3 * N_MAIN, rebuild_every=R_EVERY, conservative=True,
        device=dev)
    dep, dep_st0, _ = scenarios.deposition(n=N_DEP, device=dev)
    box, bst0, _ = scenarios.settling_box(n=N_SETTLE, device=dev)
    gas, gas_st0 = drift.build_gas(N_GAS, device=dev)
    gst, gng = gas.init_neighbors(gas_st0)
    tri, tri_st0, _ = scenarios.triaxial_cell(n=N_TRI, shear_rate=TRI_SHEAR,
                                              deform_min=TRI_DEFORM_MIN, device=dev)
    blobs = drift_lmax8.build(device=dev)[0]
    collider = vdrift.build(device=dev)[0]
    torch.cuda.synchronize()
    print(f"setup: {time.perf_counter() - t0:.1f}s; drum n={N_MAIN} lmax={LMAX} "
          f"grid={sim.grid.dims} pair_cap={sim.pair_capacity} "
          f"stage2_cap={sim.stage2_capacity} wall_cap={sim.wall_capacity}; "
          f"deposition n={N_DEP} G={dep.shapes.cap_x.shape[0]} k_max={dep.k_max} "
          f"pair_cap={dep.pair_capacity} wall_cap={dep.wall_capacity} "
          f"conservative={dep.conservative}; settling box n={N_SETTLE} "
          f"lmax={box.shapes.lmax} G={box.shapes.cap_x.shape[0]} "
          f"k_max={box.k_max} walls={len(box.walls)} "
          f"conservative={box.conservative}; drift gas n={N_GAS} "
          f"lmax={gas.shapes.lmax} box={float(gas_st0.box_hi[0]):.4g} periodic "
          f"grid={gas.grid.dims} pair_cap={gas.pair_capacity} "
          f"stage2_cap={gas.stage2_capacity} conservative={gas.conservative}; "
          f"triaxial n={N_TRI} lmax={tri.shapes.lmax} G={tri.shapes.cap_x.shape[0]} "
          f"box={float(tri_st0.box_hi[0]):.4g} grid={tri.grid.dims} "
          f"pair_cap={tri.pair_capacity} triclinic={tri.triclinic} "
          f"conservative={tri.conservative}")

    kern = kernel_phase(sim, dep, box, gas, tri, blobs, collider, dev)
    del blobs, collider
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_vs_cpu("small drum n=128 Lmax=8",
                lambda d: scenarios.rotating_drum(
                    n=128, lmax=LMAX, k_max=24, pair_capacity=640,
                    stage2_capacity=384, rebuild_every=R_EVERY, device=d),
                drum_start, dev)
    card_vs_cpu("small deposition n=128 Lmax=8 12x24",
                lambda d: scenarios.deposition(n=128, device=d), drum_start, dev)
    card_vs_cpu("small settling box n=64 Lmax=2 dense",
                lambda d: scenarios.settling_box(n=64, device=d), box_start, dev)
    triaxial_card_vs_cpu(dev)
    sharded_card_vs_cpu(dev, kern)
    sharded_card_vs_cpu(dev, kern, brick=True)
    f = lambda lo, hi: np.linspace(lo, hi, ENS_CHECK_R)
    ensemble_card_vs_cpu("small deposition ensemble n=128 Lmax=8 12x24, mu sweep",
                         lambda d: scenarios.deposition(n=128, device=d),
                         dict(mu=f(0.1, 0.8)), dev,
                         ("pair_contact_geometric", "wall_cylinder", "wall_plane"))
    # The drum built with a skin of 0.004 (small motion budgets) and dt
    # and skin swept too: run_replicas checks the trigger every step, and
    # each replica rebuilds at its own steps within the 40.
    ensemble_card_vs_cpu("small drum ensemble n=128 Lmax=8 prefilter, gamma_n sweep",
                         lambda d: with_skin(scenarios.rotating_drum(
                             n=128, lmax=LMAX, k_max=24, pair_capacity=640,
                             stage2_capacity=384, rebuild_every=R_EVERY, device=d),
                             0.004),
                         dict(gamma_n=f(10.0, 200.0), dt=f(1e-4, 2e-4),
                              skin=f(0.004, 0.012)), dev,
                         ("pair_contact_conservative", "stage1_depth", "wall_cylinder",
                          "wall_plane"))
    torch.cuda.synchronize()
    print(f"card-vs-CPU phases: {time.perf_counter() - t0:.1f}s")

    # The paths: counters from each path's own run only, each run beside
    # its eager steps (graph_vs_eager); with --profile their eager profile
    # tables go to build/.
    global PROFILE_TABLES
    PROFILE_TABLES = "--profile" in argv
    scan_phase(dev)
    drum0 = (state, neigh)
    state, neigh, l_drum, _, step_s, _ = run_path(
        f"drum n={N_MAIN}", sim, state, neigh, STEPS,
        ("pair_contact_conservative", "stage1_depth", "wall_cylinder", "wall_plane"),
        smi, DRUM_EAGER)
    block_graph_phase(sim, *drum0, smi)
    del drum0
    skin = int(neigh.skin_violations)
    require(skin == 0, f"drum: {skin} skin violations at cadence {R_EVERY}")
    stage1_list_phase("drum", sim, state, neigh, kern)
    l_cadence = cadence_phase(sim, state, neigh, smi)
    del sim, state, neigh
    torch.cuda.empty_cache()

    dst, dng = dep.init_neighbors(drum_start(dep, dep_st0, dev))
    dst, dng, l_dep, th, step_s, _ = run_path(
        f"deposition n={N_DEP}", dep, dst, dng, DEP_STEPS,
        ("pair_contact_geometric", "wall_cylinder", "wall_plane"), smi, DEP_EAGER)
    require(float(th["pe_pair"]) > 0, "deposition: no pair contact")
    stage2_list_phase("deposition", dep, dst, dng, kern)
    del dst, dng
    t0 = time.perf_counter()
    l_ens, _ = ensemble_path(dep, dep_st0, dev, smi, kern, N_DEP / step_s)
    torch.cuda.empty_cache()
    print(f"ensemble phase: {time.perf_counter() - t0:.1f}s")

    bst, bng = box.init_neighbors(box_start(box, bst0, dev))
    bst, bng, l_box, th, step_s, _ = run_path(
        f"settling box n={N_SETTLE}", box, bst, bng, SETTLE_STEPS,
        ("pair_contact_geometric", "wall_plane"), smi, SETTLE_EAGER)
    require(float(th["pe_pair"]) > 0, "settling box: no pair contact")
    del dep, box, bst, bng

    tst, tng, l_tri, step_s = triaxial_path(tri, tri_st0, dev, smi)
    stage2_list_phase("triaxial", tri, tst, tng, kern, bf16s=(False,),
                      case_tag="triaxial pair list")
    single_end = (tst, tri.thermo(tst, tng))
    l_tri_s = sharded_triaxial_phase(tri, tri_st0, single_end, dev, smi, kern)[0]
    torch.cuda.empty_cache()
    l_tri_b = sharded_triaxial_phase(tri, tri_st0, single_end, dev, smi, kern,
                                     brick=True)[0]
    torch.cuda.empty_cache()
    l_ranks = rank_phase(dev, smi, tri, tri_st0, single_end)
    del tri, tri_st0, tst, tng, single_end
    torch.cuda.empty_cache()

    # The deck runner: every example deck on the card and on the CPU, then
    # the full-size drum deck on the card.
    t0 = time.perf_counter()
    l_decks = deck_examples_phase(dev, kern)
    print(f"deck examples phase: {time.perf_counter() - t0:.1f}s")
    l_deck_drum, runner, _ = deck_drum_phase(dev, smi)
    deck_kernel_cases("deck drum full", runner, kern, dev, np.random.default_rng(13),
                      example=False)
    del runner
    torch.cuda.empty_cache()

    # The drift gas (periodic, no walls): f32 here, bf16 stage-2 in a child
    # process under SPHERHARM_STAGE2_BF16=1 (with the deposition).
    gst, gng, l_gas, samples, slope, step_s = drift_path(
        f"drift gas n={N_GAS} f32", gas, gst, gng,
        ("pair_contact_conservative", "stage1_depth"), smi)
    stage2_list_phase("drift gas", gas, gst, gng, kern)
    l_k5 = stage1_l1_phase(gas, gst, gng, kern)
    l_gas_s = sharded_gas_phase(gas, gst, gng, smi, kern)[0]
    torch.cuda.empty_cache()
    l_gas_b = sharded_gas_phase(gas, gst, gng, smi, kern, brick=True)[0]
    del gas, gst, gng
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    child = bf16_phase()
    diffs = [b[1] - f[1] for f, b in zip(samples, child["samples"])]
    print(f"bf16 child: {time.perf_counter() - t0:.1f}s; drift gas etot bf16 - f32 "
          f"every {GAS_EVERY} steps: " + " ".join(f"{d:+.4g}" for d in diffs))
    print(f"drift gas fitted slope over {GAS_STEPS} steps: f32 {slope:+.4%}, bf16 "
          f"{child['slope']:+.4%} per 1M steps [{smi}]")

    l_valid = validation_phase(dev, smi, cpu_sweep)
    torch.cuda.empty_cache()

    k3 = ("pair_contact_conservative_bf16", "pair_contact_geometric_bf16")
    src = {"pair_contact_conservative": ("spherharm_tpu_torch/csrc/pair_contact_cons.cu",
                                         "spherharm_tpu/ops/contact_pallas.py:496"),
           "pair_contact_geometric": ("spherharm_tpu_torch/csrc/pair_contact.cu",
                                      "spherharm_tpu/ops/contact_pallas.py:213"),
           "pair_contact_conservative_bf16": (
               "spherharm_tpu_torch/csrc/pair_contact_cons.cu",
               "spherharm_tpu/ops/contact_pallas.py:142"),
           "pair_contact_geometric_bf16": ("spherharm_tpu_torch/csrc/pair_contact.cu",
                                           "spherharm_tpu/ops/contact_pallas.py:142"),
           "stage1_depth": ("spherharm_tpu_torch/csrc/stage1_probe.cu",
                            "spherharm_tpu/ops/contact_pallas.py:751"),
           "stage1_depth_l1": ("spherharm_tpu_torch/csrc/stage1_probe.cu",
                               "spherharm_tpu/ops/contact_pallas.py:751"),
           "stage1_depth_l1_bf16": ("spherharm_tpu_torch/csrc/stage1_probe.cu",
                                    "spherharm_tpu/ops/contact_pallas.py:841"),
           "wall_cylinder": ("spherharm_tpu_torch/csrc/wall_contact.cu",
                             "spherharm_tpu/ops/walls_pallas.py:50"),
           "wall_plane": ("spherharm_tpu_torch/csrc/wall_contact.cu",
                          "spherharm_tpu/ops/walls_pallas.py:139")}
    by_path = {"drum": l_drum, "deposition": l_dep, f"deposition R={N_ENS}": l_ens,
               "settling box": l_box,
               "triaxial": l_tri, "drift gas": l_gas, "deck drum full": l_deck_drum,
               f"triaxial S={N_SHARDS}": l_tri_s, f"drift gas S={N_SHARDS}": l_gas_s,
               BRICK_TRI: l_tri_b, BRICK_GAS: l_gas_b,
               f"triaxial {RANKS} gloo ranks": {
                   k: sum(d[k] for d in l_ranks["ranks"]) for k in l_ranks["ranks"][0]},
               **{f"deck {label}": n for label, n in l_decks.items()},
               **l_cadence, **l_valid}
    counted = {k: [(p, n[k]) for p, n in by_path.items() if n[k]] for k in src}
    counted.update({k: [(p, child[c][k]) for p, c in (("drift gas", "gas"),
                                                      ("deposition", "deposition"))
                        if child[c][k]] for k in k3})
    counted.update({k: [("drift gas", n)] for k, n in l_k5.items()})
    launches = {k: sum(n for _, n in counted[k]) for k in src}
    # The validation harnesses' tiny systems (lists of 2-12 rows) would be
    # priced at their 16,384-row batch: they count in the launches, not in
    # the ranking.
    tiny = {p for p in l_valid if p != "packing n=500"}
    loss = ranking(kern, {k: [(p, n) for p, n in v if p not in tiny]
                          for k, v in counted.items()})
    print("ranking by launches x (device_ms - bound_ms), ms of this run "
          "(by the wrapper call's ms in brackets): " + "; ".join(
              f"{k} {d:.2f} ({w:.2f})"
              for k, (d, w) in sorted(loss.items(), key=lambda kv: -kv[1][0])))
    notes = {k: {"path": "chip_smoke kernel phase (no Simulation path calls it, "
                         "as in the reference)"} for k in l_k5}
    notes.update({k: {"path": "bf16 child under SPHERHARM_STAGE2_BF16=1: drift "
                              "gas + deposition"} for k in k3})
    # At the top level of each kernel: the case of the first path that
    # launched it (path_case), as the ranking prices it.
    top = {k: path_case(kern[k], counted[k][0][0]) if counted[k] else kern[k][0]
           for k in src}
    print(f"paths, eager vs CUDA graphs [{smi}]: " + json.dumps(GRAPH_ROWS))
    print(f"total wall time: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0],
         "replaces": src[name][1], "launches": launches[name],
         "max_abs_err": max(c["max_abs_err"] for c in kern[name]),
         **{k: top[name][k]
            for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, **notes.get(name, {}), "cases": kern[name]}
        for name in src]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
