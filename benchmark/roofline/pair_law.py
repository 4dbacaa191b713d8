"""The least work of the stage-2 pair law, counted from the law's
definition, whatever kernel implements it.

Per pair that needs the law (bounding spheres overlapping: the law's own
cull), per side (i's cap against j, then j's against i) and per cap node:

* two surfaces with both angular derivatives: a's radius at the node
  (with its derivatives: the geometric law's inclination, the
  conservative law's gradient through a's rotation) and b's at the
  node's image (with its derivatives: b's outward normal). A surface of
  degree L is a sum of (L+1)^2 coefficients times harmonics; r, dr/dtheta
  and dr/dphi are three such sums, each a multiply and an add per term:
  6 (L+1)^2 operations. The harmonics themselves are not counted, so
  this is a lower bound for any evaluation scheme.
* the node's geometry (``GEOMETRY``): its direction on a's cap, two
  quaternion rotations, the node's image in b's frame and its trigonometry,
  the depth, the measure, the depth moments and the centroid and normal
  sums;
* the conservative law adds the exact gradient of the depth moments
  (``GRADIENT``): the chain rule through the node's image back to d and
  both orientations.

Bytes: each pair's inputs once and its outputs once (``BYTES_PER_PAIR``),
and once a step the per-type coefficient table and the cap grid.
"""

from __future__ import annotations

GEOMETRY = 90
GRADIENT = 60

# Floats a pair moves: per side position 3, orientation 4, velocity 3,
# angular velocity 3, mass 1, type 1, scale 1 (16, twice); springs in 6
# and out 6; force 3, both torques 6, energy 1.
BYTES_PER_PAIR = 4 * (2 * 16 + 12 + 10)


def surface_ops(lmax: int) -> int:
    return 6 * (lmax + 1) ** 2


def ops_per_node(lmax: int, conservative: bool) -> int:
    """Operations a side spends on one cap node."""
    return 2 * surface_ops(lmax) + GEOMETRY + (GRADIENT if conservative else 0)


def work(pair_steps: int, lmax: int, nodes: int, conservative: bool,
         n_types: int, steps: int) -> tuple[float, float]:
    """(operations, bytes) of ``pair_steps`` pair evaluations (pairs that
    need the law, summed over the steps) over ``steps`` steps."""
    ops = float(pair_steps) * nodes * 2 * ops_per_node(lmax, conservative)
    once = 4 * (n_types * (lmax + 1) ** 2 + 4 * nodes)
    return ops, float(pair_steps) * BYTES_PER_PAIR + steps * once
