"""Spatial domain decomposition: slabs along x with halo exchange (torch
twin of ``spherharm_tpu/parallel/halo.py``).

The reference shards particle arrays over a device mesh and exchanges
halos with ``lax.ppermute``. Here the S slabs live on a leading shard
axis of every tensor, as the replicas of ``parallel/ensemble.py`` do:
State fields are [S, cap_local, ...], NeighborState fields [S, cap_ext,
...] (owned rows first, then the ghosts), GhostPack fields [S, 2H, ...].
Each op of the step runs once over all S slabs (each kernel launches once
a step for all of them), every compaction is each slab's own, and the
collectives go through a transport (``ShardAxis``):

  ppermute one hop round the ring -> ``ring_shift`` (a roll along the axis)
  psum / pmax                     -> ``psum`` / ``pmax`` over the axis

The box, tilt and step are the slabs' common values (0-d or [3]), as the
reference keeps them replicated. Mapping of the reference's comm surface
(LAMMPS's Comm):

  exchange()      -> ``_migrate``: leavers selected into fixed-capacity
                     buffers, shifted to the ring neighbours, placed in
                     free slots (rebuild steps only), springs carried
  borders()       -> ``_halo_membership``: owned particles within
                     cutoff + skin (+ tilt pad) of a slab face
  forward_comm()  -> ``_forward_comm``: every step, the ghosts' x, v, q,
                     angmom refreshed from the stored send indices
  reverse_comm()  -> not needed: every owner computes its own forces
                     from its ghosts (owned-ghost pairs are one-sided)

Ghost slots: [:H] mirror the LEFT neighbour's right edge, [H:] the RIGHT
neighbour's left edge; across the periodic seam the sender shifts x by
+/- Lx, so nothing downstream images along x.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from spherharm_tpu_torch.core import runner as runner_mod
from spherharm_tpu_torch.core.state import (
    NeighborState,
    State,
    _Container,
    _to_tensor,
    empty_neighbors,
    take,
    to_numpy,
)
from spherharm_tpu_torch.ops import contact, integrate, neighbor
from spherharm_tpu_torch.ops import walls as walls_mod

# Particle fields that travel in migration / halo buffers.
COMM_FIELDS = ("x", "v", "q", "angmom", "scale", "shtype", "tag", "image")
# Row blocks of the cell list's stencil stage over the S * cap_ext
# extended rows (the reference's cell_list_neighbors default): bounds its
# [rows, 27 * cell_cap] transients.
ROW_CHUNK = 262144


def balance_fracs(state_global, n_shards: int, min_frac: float = 0.0,
                  axis: int = 0):
    """Weighted slab boundaries for equal particle counts per shard (the
    LAMMPS ``balance x weighted`` analogue): per-shard quantiles of the
    active particles' coordinate ``axis``, as box fractions [S + 1],
    clamped so no slab is narrower than ``min_frac`` of the box (pass
    (cutoff + skin + tilt_pad) / Lx to keep every slab halo-legal). For
    initial bounds; mid-run, ``ShardedSimulation.rebalance``."""
    x = to_numpy(state_global.x)
    act = to_numpy(state_global.active)
    lo = float(to_numpy(state_global.box_lo)[axis])
    hi = float(to_numpy(state_global.box_hi)[axis])
    xf = np.clip((x[act, axis] - lo) / (hi - lo), 0.0, 1.0)
    qs = np.quantile(xf, np.linspace(0.0, 1.0, n_shards + 1))
    qs[0], qs[-1] = 0.0, 1.0
    if min_frac > 0.0:
        if min_frac * n_shards > 1.0:
            raise ValueError("min_frac too large for this shard count")
        for i in range(1, n_shards):          # left-to-right pass
            qs[i] = max(qs[i], qs[i - 1] + min_frac)
        for i in range(n_shards - 1, 0, -1):  # right-to-left pass
            qs[i] = min(qs[i], qs[i + 1] - min_frac)
    return qs


def clamped_quantile_fracs(xf, old, n: int, min_frac: float):
    """Equal-count boundary fractions for one axis, clamped for in-run
    rebalancing: each interior boundary stays strictly inside its old
    neighbours (ownership moves at most one shard, which the one-hop
    migration routes in one forced rebuild) and every window keeps at
    least ``min_frac`` width (halo and bin-grid legality)."""
    qs = np.quantile(xf, np.linspace(0.0, 1.0, n + 1))
    qs[0], qs[-1] = 0.0, 1.0
    for i in range(1, n):
        qs[i] = np.clip(qs[i], old[i - 1] + min_frac,
                        old[i + 1] - min_frac)
    for i in range(1, n):          # monotone + min width, L->R
        qs[i] = max(qs[i], qs[i - 1] + min_frac)
    for i in range(n - 1, 0, -1):  # R->L
        qs[i] = min(qs[i], qs[i + 1] - min_frac)
    if np.any(np.diff(qs) <= 0):
        raise ValueError(
            f"rebalance could not find halo-legal bounds "
            f"(min_frac={min_frac:.3g}, n={n})"
        )
    return qs


@dataclass
class GhostPack(_Container):
    """Ghost mirrors + forward-comm routing (rebuilt at each re-neighbour),
    [S, 2H, ...] with the shard axis."""

    x: torch.Tensor          # [S, 2H, 3]
    v: torch.Tensor          # [S, 2H, 3]
    q: torch.Tensor          # [S, 2H, 4]
    angmom: torch.Tensor     # [S, 2H, 3]
    scale: torch.Tensor      # [S, 2H]
    shtype: torch.Tensor     # [S, 2H]
    tag: torch.Tensor        # [S, 2H]
    active: torch.Tensor     # [S, 2H] bool
    send_idx: torch.Tensor   # [S, 2H] my slots to forward ([:H] left, [H:] right)
    send_mask: torch.Tensor  # [S, 2H] bool
    # [S + 1] slab boundaries as box fractions, common to the slabs. A
    # tensor (not a constant of the step), so an in-run rebalance swaps
    # its values and the captured step graphs stay valid.
    fracs: torch.Tensor | None = None


def empty_ghosts(h_cap: int, dtype=torch.float32, fracs=None,
                 device="cuda", n_shards: int = 0) -> GhostPack:
    """Empty ghost buffers of 2 h_cap slots; ``n_shards`` > 0 stacks that
    many along a leading shard axis."""
    lead = (n_shards,) if n_shards else ()
    H2 = 2 * h_cap
    fz = lambda *s: torch.zeros(lead + s, dtype=dtype, device=device)
    iz = lambda *s: torch.zeros(lead + s, dtype=torch.long, device=device)
    bz = lambda *s: torch.zeros(lead + s, dtype=torch.bool, device=device)
    q = fz(H2, 4)
    q[..., 0] = 1.0
    return GhostPack(
        fracs=fracs, x=fz(H2, 3), v=fz(H2, 3), q=q, angmom=fz(H2, 3),
        scale=torch.ones(lead + (H2,), dtype=dtype, device=device),
        shtype=iz(H2), tag=iz(H2), active=bz(H2), send_idx=iz(H2),
        send_mask=bz(H2),
    )


def _select_fill(mask, cap: int):
    """Indices of up to ``cap`` True entries of each row of ``mask``
    (lowest index first, as ``lax.top_k`` orders them), + validity."""
    idx = neighbor.stable_topk_true(mask, cap)
    return idx, torch.gather(mask, -1, idx)


class ShardAxis:
    """The transport of the slabs: S slabs on the leading axis of one
    device's tensors. Every collective of ``ShardedSimulation`` goes
    through ``ring_shift``, ``psum``, ``pmax`` and ``gather``.

    ``n_shards`` is the ring's size; ``local`` the ring indices of the
    shards this process holds, one a row of the leading axis (here all S;
    ``n_local`` of them)."""

    # The stream-capture mode of the step's graphs (core/runner.py).
    capture_error_mode = "global"

    def __init__(self, n_shards: int):
        self.n_shards = int(n_shards)
        self.local = tuple(range(self.n_shards))

    @property
    def n_local(self) -> int:
        return len(self.local)

    def index(self, device):
        """The ring index of each shard held here, [n_local]."""
        lo = self.local[0]
        return torch.arange(lo, lo + self.n_local, device=device)

    def ring_shift(self, val, direction: str):
        """One hop round the ring: "left" sends to slab idx - 1, so slab i
        receives slab i + 1's buffer; "right" the other way."""
        if direction not in ("left", "right"):
            raise ValueError(f"unknown ring direction {direction!r}")
        return torch.roll(val, -1 if direction == "left" else 1, dims=0)

    def psum(self, val):
        """The sum over the slabs, added in slab order."""
        out = val[0]
        for i in range(1, self.n_shards):
            out = out + val[i]
        return out

    def pmax(self, val):
        """The maximum over the slabs."""
        return val.amax(0)

    def gather(self, val):
        """Every shard's block of ``val`` [n_local, ...], [S, ...] in ring
        order (host-side helpers: restarts, dumps, rebalance)."""
        return val

    def stages_through_host(self, device) -> bool:
        """Whether a collective on ``device`` tensors syncs with the host
        (then no CUDA graph can hold it)."""
        return False


class RankAxis(ShardAxis):
    """The transport of one shard a process: ``torch.distributed`` ranks,
    the shard's tensors [1, ...] on the rank's device, ring index = rank.

    ``ring_shift`` is one matched send/recv pair with the ranks one hop
    away (``batch_isend_irecv``, one batch a direction: NCCL's p2p has no
    tags, and on a 2-wide ring both hops go to the same peer); ``psum``
    gathers every rank's value and adds them in rank order (never NCCL's
    ``all_reduce(SUM)``, whose order NCCL picks), so it rounds as
    ``ShardAxis.psum``; ``pmax`` is ``all_reduce(MAX)``; ``gather`` is
    ``all_gather``. Bool tensors travel as uint8. On gloo, CUDA tensors
    are staged through pinned host buffers: a host sync, so a simulation
    refuses CUDA graphs on that combination.

    ``group``: the process group (default the world); ``device``: the
    rank's device (default ``cuda:<LOCAL_RANK>``, the CPU only by name).
    ``sent_bytes`` counts the bytes ``ring_shift`` sent (a Python count:
    a captured graph adds none on replay)."""

    capture_error_mode = "thread_local"

    def __init__(self, group=None, device=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.n_shards = dist.get_world_size(group)
        self.local = (self.rank,)
        self.backend = dist.get_backend(group)
        if device is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             self.rank)))
        self.device = torch.device(device)
        self.sent_bytes = 0

    def stages_through_host(self, device) -> bool:
        return self.backend == "gloo" and torch.device(device).type == "cuda"

    def _wire(self, val):
        """``val`` as the backend takes it: contiguous, bool as uint8, on
        the host for gloo."""
        t = val.contiguous()
        if t.dtype == torch.bool:
            t = t.view(torch.uint8)
        if self.stages_through_host(t.device):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            t = host.copy_(t)
        return t

    def _unwire(self, t, like):
        """A received buffer back on ``like``'s device and dtype."""
        if t.device != like.device:
            t = t.to(like.device)
        return t.view(torch.bool) if like.dtype == torch.bool else t

    def _exchange(self, val, dst: int, src: int):
        """Send ``val`` to rank ``dst`` and receive the same shape from
        rank ``src``, as one batch."""
        send = self._wire(val)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, group=self.group, group_peer=dst),
               dist.P2POp(dist.irecv, recv, group=self.group, group_peer=src)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.sent_bytes += send.numel() * send.element_size()
        return self._unwire(recv, val)

    def ring_shift(self, val, direction: str):
        if direction not in ("left", "right"):
            raise ValueError(f"unknown ring direction {direction!r}")
        S, r = self.n_shards, self.rank
        if S == 1:
            return val
        step = 1 if direction == "left" else -1
        return self._exchange(val, (r - step) % S, (r + step) % S)

    def _all_gather(self, val):
        """[every rank's ``val``] in rank order."""
        t = self._wire(val)
        parts = [torch.empty_like(t) for _ in range(self.n_shards)]
        dist.all_gather(parts, t, group=self.group)
        return [self._unwire(p, val) for p in parts]

    def psum(self, val):
        parts = self._all_gather(val[0])
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def pmax(self, val):
        t = self._wire(val.amax(0))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return self._unwire(t, val)

    def gather(self, val):
        return torch.stack(self._all_gather(val[0]))


class ShardedSimulation:
    """Slab-decomposed DEM (config 5): S slabs along x, stacked on a
    leading shard axis of one device's tensors (``ShardAxis``), or one
    slab a process (``axis=RankAxis(...)``: the shard's tensors [1, ...],
    the collectives over ``torch.distributed``).

    Static configuration mirrors ``Simulation``. ``n_shards`` stands where
    the reference's ``mesh`` stood; a given ``axis`` must have that ring
    size. The pair list is the prefiltered
    stage-2 list when ``stage2_capacity > 0``. On CUDA tensors ``run``
    replays CUDA graphs of the step's units (``cuda_graphs=False`` asks
    for eager steps); ``init``, ``rebalance`` and ``thermo`` run eagerly.
    On ranks every rank is given the same global State and keeps its own
    slab; ``gather_global``, ``gather_restart``, ``rebalance`` and
    ``thermo`` return the same global values on every rank.
    """

    shard_name = "slab"

    def __init__(
        self,
        shapes,
        params,
        *,
        n_shards: int,
        box_lo,
        box_hi,
        cap_local: int,
        halo_cap: int,
        migrate_cap: int = 0,
        periodic=(True, True, True),
        k_max: int = 32,
        cell_cap: int = 8,
        pair_capacity: int = 0,
        walls: tuple = (),
        deform_min: float = 1.0,
        rebuild_every: int = 0,
        wall_capacity: int = 0,
        stage2_capacity: int = 0,
        triclinic: bool = False,
        tilt_pad: float = 0.0,
        bounds_frac=None,
        conservative: bool = True,
        device="cuda",
        cuda_graphs: bool = True,
        axis: ShardAxis | None = None,
    ):
        self.shapes = shapes
        self.params = params
        self.n_shards = int(n_shards)
        self.axis = ShardAxis(self.n_shards) if axis is None else axis
        if self.axis.n_shards != self.n_shards:
            raise ValueError(
                f"the transport's ring has {self.axis.n_shards} shards, "
                f"not n_shards={self.n_shards}")
        self.cap_local = int(cap_local)
        self.halo_cap = int(halo_cap)
        self.migrate_cap = int(migrate_cap) or max(halo_cap // 2, 16)
        self.periodic = tuple(bool(p) for p in periodic)
        self.k_max = int(k_max)
        self.cell_cap = int(cell_cap)
        self.pair_capacity = int(pair_capacity) or 8 * cap_local
        self.walls = tuple(walls)
        self.rebuild_every = int(rebuild_every)
        self.wall_capacity = int(wall_capacity)
        self.stage2_capacity = int(stage2_capacity)
        # Rebuild-time prefilter: the persistent pair list is the stage-2
        # compaction of the candidate list (see core/simulation.py).
        self.prefilter = self.stage2_capacity > 0
        self.conservative = bool(conservative)
        # Triclinic slabs: a y/z-crossing image shifts x by the tilt, so
        # raw-x halo membership must reach tilt_pad further (set tilt_pad
        # >= max |xy| + |xz| the run will see).
        self.triclinic = bool(triclinic)
        self.tilt_pad = float(tilt_pad)
        if triclinic and tilt_pad <= 0.0:
            raise ValueError("triclinic sharding needs tilt_pad >= max "
                             "|xy|+|xz| expected during the run")
        self.device = torch.device(device)
        self.cuda_graphs = bool(cuda_graphs)
        self._graphs = {}
        self._check_graphs(self.device)

        self.box_lo_np = np.asarray(box_lo, np.float64)
        self.box_hi_np = np.asarray(box_hi, np.float64)
        Lx = self.box_hi_np[0] - self.box_lo_np[0]
        # Weighted slab boundaries as box fractions (deformation rescales
        # them with the box); default uniform (balance_fracs for weighted).
        if bounds_frac is None:
            bounds_frac = np.linspace(0.0, 1.0, self.n_shards + 1)
        self.bounds_frac = np.asarray(bounds_frac, np.float64)
        if (self.bounds_frac.shape != (self.n_shards + 1,)
                or self.bounds_frac[0] != 0.0 or self.bounds_frac[-1] != 1.0
                or np.any(np.diff(self.bounds_frac) <= 0)):
            raise ValueError(
                "bounds_frac must be increasing, length n_shards+1, "
                "with ends 0 and 1"
            )
        slab_widths = np.diff(self.bounds_frac) * Lx
        self.slab_w = float(slab_widths.min())
        cutoff_total = float(params.cutoff + params.skin)
        self.halo_depth = cutoff_total + self.tilt_pad
        if self.slab_w < self.halo_depth:
            raise ValueError(
                f"narrowest slab {self.slab_w:.3g} < cutoff+skin "
                f"{self.halo_depth:.3g}: too many shards (or too skewed "
                "a balance) for this box"
            )
        # One bin grid for every slab, covering slab + halo margin: the
        # dims are a constant of the step while each slab's extent is its
        # own, so cells stay >= cutoff for the NARROWEST slab (wider slabs
        # get larger cells, always safe for the stencil), sized for the
        # smallest box the run will see (deform_min < 1 compresses).
        bin_lo = np.array(
            [-self.halo_depth, self.box_lo_np[1], self.box_lo_np[2]])
        bin_hi = np.array(
            [self.slab_w + self.halo_depth, self.box_hi_np[1],
             self.box_hi_np[2]])
        dims = np.maximum(
            np.floor(float(deform_min) * (bin_hi - bin_lo) / cutoff_total)
            .astype(int), 1)
        self.grid_dims = tuple(int(v) for v in dims)
        # Kept for the rebalance clamp: the bin-grid legality floor must
        # use the worst-case compression the grid was sized with.
        self.deform_min = float(deform_min)
        # Periodicity for pair math: x images are explicit ghosts.
        self.periodic_eff = (False, self.periodic[1], self.periodic[2])

    @property
    def cap_ext(self) -> int:
        return self.cap_local + 2 * self.halo_cap

    @property
    def n_local(self) -> int:
        """The shards this process holds: the leading dim of its tensors."""
        return self.axis.n_local

    def _check_graphs(self, device):
        """Refuse CUDA graphs over a transport that syncs with the host
        (gloo's staging of CUDA tensors): never a silent eager run."""
        device = torch.device(device)
        if (self.cuda_graphs and device.type == "cuda"
                and self.axis.stages_through_host(device)):
            raise ValueError(
                "this transport stages CUDA tensors through host memory "
                "(gloo), which no CUDA graph can capture: pass "
                "cuda_graphs=False, or use NCCL")

    @property
    def pair_list_cap(self) -> int:
        """Persistent per-slab pair-list capacity (the stage-2 cap when
        the prefilter is on)."""
        return (self.stage2_capacity if self.prefilter
                else self.pair_capacity)

    @property
    def _window_steps(self) -> int:
        """Motion-budget horizon of the prefilter."""
        return self.rebuild_every if self.rebuild_every > 0 else 16

    def _tilt(self, state: State):
        return state.tilt if self.triclinic else None

    # -- distribution (host-side) ------------------------------------------

    def distribute(self, state_global: State, restart: dict | None = None):
        """Partition a single-box State into per-slab slots on the device:
        (state [S, cap_local], neigh [S, cap_ext], ghosts [S, 2H]).

        ``restart`` (from :meth:`gather_restart`) carries tag-keyed
        contact history aligned with ``state_global``'s rows:
        ``hist_tags`` [n, K], ``hist`` [n, K, HW], ``wall_hist``
        [n, W, HW]. It seeds the neighbour state's durable (rebuild-time)
        layout so the first rebuild's remap recovers every spring.
        """
        S, cl, dev = self.n_local, self.cap_local, self.device
        active = to_numpy(state_global.active)
        owner = self._owner_np(to_numpy(state_global.x))
        # Every process checks every shard's count, so all of them raise.
        counts = np.bincount(owner[active], minlength=self.n_shards)
        if np.any(counts > cl):
            p = int(np.argmax(counts > cl))
            raise ValueError(
                f"{self.shard_name} {p} holds {counts[p]} > cap_local={cl}")
        locals_, sels = [], []
        for p in self.axis.local:
            sel = np.flatnonzero(active & (owner == p))
            sels.append(sel)
            pad = cl - sel.size
            rows = {}
            for f in COMM_FIELDS + ("active",):
                v = to_numpy(getattr(state_global, f))[sel]
                rows[f] = np.concatenate(
                    [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0)
            rows["active"][sel.size:] = False
            rows["q"][sel.size:, 0] = 1.0
            rows["scale"][sel.size:] = 1.0
            locals_.append(rows)

        def cat(f):
            a = np.stack([loc[f] for loc in locals_])
            # Floats keep their width: a float64 state stays float64.
            return (torch.as_tensor(a, device=dev)
                    if np.issubdtype(a.dtype, np.floating)
                    else _to_tensor(a, dev))

        dtype = state_global.x.dtype
        put = lambda t: t.to(dev)
        fz = torch.zeros((S, cl, 3), dtype=dtype, device=dev)
        st = State(
            x=cat("x").to(dtype), v=cat("v").to(dtype),
            q=cat("q").to(dtype), angmom=cat("angmom").to(dtype),
            f=fz, tau=fz.clone(),
            scale=cat("scale").to(dtype), shtype=cat("shtype"),
            tag=cat("tag"), active=cat("active"), image=cat("image"),
            box_lo=put(state_global.box_lo), box_hi=put(state_global.box_hi),
            tilt=put(state_global.tilt), step=put(state_global.step),
        )
        neigh = empty_neighbors(
            self.cap_ext, self.k_max, len(self.walls), dtype=dtype,
            pair_cap=self.pair_list_cap, device=dev, replicas=S)
        if restart is not None:
            # Seed the durable tag-keyed layout in the extended row space
            # (owned rows lead each slab's block); init skips the
            # pair->dense fold so this survives to the remap.
            ce, K = self.cap_ext, self.k_max
            hw = neigh.hist.shape[-1]
            W = neigh.wall_hist.shape[-2]
            nt = np.zeros((S, ce, K), np.int64)
            nh = np.zeros((S, ce, K, hw), np.float32)
            wh = np.zeros((S, ce, W, hw), np.float32)
            rt = np.zeros((S, ce), np.int64)
            tags_g = to_numpy(state_global.tag)
            for p, sel in enumerate(sels):
                n_p = sel.size
                nt[p, :n_p] = np.asarray(restart["hist_tags"])[sel]
                nh[p, :n_p] = np.asarray(restart["hist"])[sel]
                if len(self.walls):
                    wh[p, :n_p] = np.asarray(restart["wall_hist"])[sel]
                rt[p, :n_p] = tags_g[sel]
            neigh = neigh.replace(
                neigh_tag=_to_tensor(nt, dev),
                hist=_to_tensor(nh, dev).to(neigh.hist.dtype),
                wall_hist=_to_tensor(wh, dev).to(neigh.wall_hist.dtype),
                row_tag=_to_tensor(rt, dev),
                mask=_to_tensor(nt > 0, dev),
            )
        return st, neigh, self._fresh_ghosts(dtype)

    def _owner_np(self, x):
        """The slab of each row of the host positions ``x`` [n, 3] under
        the initial bounds."""
        Lx = self.box_hi_np[0] - self.box_lo_np[0]
        xf = (x[:, 0] - self.box_lo_np[0]) / Lx
        return np.clip(
            np.searchsorted(self.bounds_frac[1:-1], xf, side="right"),
            0, self.n_shards - 1)

    def _fresh_ghosts(self, dtype):
        """Empty ghost buffers. The slab bounds ride the GhostPack as a
        tensor: rebalance() swaps its values and the step graphs stay
        valid."""
        return empty_ghosts(
            self.halo_cap, dtype, device=self.device, n_shards=self.n_local,
            fracs=torch.as_tensor(self.bounds_frac, dtype=dtype,
                                  device=self.device))

    # -- per-slab building blocks (all slabs at once) ----------------------

    def _index(self, state):
        return self.axis.index(state.x.device)

    def _seam_shifts(self, state):
        """x-shift a SENT particle gets (periodic seam unwrap), [S] each
        for the left and the right send."""
        idx = self._index(state)
        Lx = state.box_hi[0] - state.box_lo[0]
        zero = torch.zeros_like(Lx)
        left_send = torch.where(idx == 0, Lx, zero)  # 0 -> S-1: x += Lx
        right_send = torch.where(idx == self.n_shards - 1, -Lx, zero)
        return left_send, right_send

    def _slab_edges(self, state, fracs):
        """(slab_lo, slab_hi) [n_local] of each slab held here under the
        bounds ``fracs`` (fractions of the current box length)."""
        idx = self._index(state)
        fr = fracs.to(state.x.dtype)
        Lx = state.box_hi[0] - state.box_lo[0]
        return (state.box_lo[0] + fr[idx] * Lx,
                state.box_lo[0] + fr[idx + 1] * Lx)

    def _slab_of(self, state, x0, fracs):
        """Owner slab of x-coordinates ``x0`` (weighted searchsorted)."""
        fr = fracs[1:-1].to(state.x.dtype).contiguous()
        Lx = state.box_hi[0] - state.box_lo[0]
        xf = (x0 - state.box_lo[0]) / Lx
        return torch.clamp(torch.searchsorted(fr, xf, right=True),
                           0, self.n_shards - 1)

    def _has_left(self, idx):
        if self.periodic[0]:
            return torch.ones_like(idx, dtype=torch.bool)
        return idx > 0

    def _has_right(self, idx):
        if self.periodic[0]:
            return torch.ones_like(idx, dtype=torch.bool)
        return idx < self.n_shards - 1

    def _gather_send(self, state, send_idx, send_mask):
        """Gather + ship the forward-comm fields; returns ghost field dict."""
        ax = self.axis
        sl, sr = self._seam_shifts(state)
        S, H = self.n_local, self.halo_cap
        out = {}
        for f in ("x", "v", "q", "angmom"):
            vals = take(getattr(state, f), send_idx, True)
            if f == "x":
                shift = torch.cat([sl[:, None].expand(S, H),
                                   sr[:, None].expand(S, H)], dim=1)
                vals = torch.cat([(vals[..., 0] + shift)[..., None],
                                  vals[..., 1:]], dim=-1)
            from_right = ax.ring_shift(vals[:, :H], "left")
            from_left = ax.ring_shift(vals[:, H:], "right")
            out[f] = torch.cat([from_left, from_right], dim=1)
        return out

    def _halo_membership(self, state, fracs):
        """Select owned particles within halo_depth of each slab face."""
        idx = self._index(state)
        slab_lo, slab_hi = self._slab_edges(state, fracs)
        x0 = state.x[..., 0]
        near_l = (state.active & (x0 < (slab_lo + self.halo_depth)[:, None])
                  & self._has_left(idx)[:, None])
        near_r = (state.active
                  & (x0 >= (slab_hi - self.halo_depth)[:, None])
                  & self._has_right(idx)[:, None])
        il, vl = _select_fill(near_l, self.halo_cap)
        ir, vr = _select_fill(near_r, self.halo_cap)
        send_idx = torch.cat([il, ir], dim=1)
        send_mask = torch.cat([vl, vr], dim=1)
        overflow = torch.maximum(near_l.sum(-1), near_r.sum(-1))
        return send_idx, send_mask, overflow

    def _migrate(self, state, neigh, fracs):
        """Move owned particles whose slab changed to the ring neighbours.

        Positions are wrapped before migration (in _rebuild), so a
        seam-crossing particle's x already lies in the destination slab's
        range: migration buffers carry coordinates verbatim (the +/- Lx
        seam shift is for ghost export only).

        Contact history migrates with the particle: its old-list row
        (neigh_tag, mask, hist) and wall springs land in the receiver's
        neighbour arrays at the new slot, row_tag set to the arriving
        tag, so the next remap_history carries the springs into the new
        build (FixNeighHistory riding pack_exchange in LAMMPS).
        """
        idx = self._index(state)
        tgt = self._slab_of(state, state.x[..., 0], fracs)
        return self._move(state, neigh, idx, self.n_shards, tgt,
                          self._has_left(idx), self._has_right(idx),
                          self.axis.ring_shift)

    def _move(self, state, neigh, idx, n, tgt, has_lo, has_hi, shift):
        """One migration phase round a ring of ``n`` shards: each shard's
        ring index ``idx`` [S], its rows' target index ``tgt`` [S, cap_local],
        whether it has a lower / upper neighbour ``has_lo`` / ``has_hi``
        [S], and the ring's ``shift(val, direction)``. Returns (state,
        neigh, migration overflow [S])."""
        S, M, cl = self.n_local, self.migrate_cap, self.cap_local
        idx = idx[:, None]
        moving = state.active & (tgt != idx)
        go_left = moving & (tgt == (idx - 1) % n) & has_lo[:, None]
        # On a 2-shard ring left and right neighbour coincide: ~go_left
        # keeps each migrant in exactly one buffer (no duplication).
        go_right = (moving & (tgt == (idx + 1) % n) & has_hi[:, None]
                    & ~go_left)
        # A particle more than one slab from home cannot be routed in one
        # hop: flag it through the overflow channel (sentinel 1 << 20).
        far = moving & ~go_left & ~go_right
        il, vl = _select_fill(go_left, M)
        ir, vr = _select_fill(go_right, M)
        mig_overflow = torch.maximum(go_left.sum(-1), go_right.sum(-1))
        big = torch.full_like(mig_overflow, 1 << 20)
        mig_overflow = torch.where(far.any(-1), big, mig_overflow)

        hist_fields = {"ntag": neigh.neigh_tag, "nmask": neigh.mask,
                       "nhist": neigh.hist, "whist": neigh.wall_hist}
        arrays = {f: getattr(state, f) for f in COMM_FIELDS}
        arrays.update(hist_fields)
        # I receive from the LEFT neighbour's right buffer, then from the
        # RIGHT neighbour's left buffer.
        recv = {f: torch.cat([shift(take(a, ir, True), "right"),
                              shift(take(a, il, True), "left")], dim=1)
                for f, a in arrays.items()}
        recv_valid = torch.cat([shift(vr, "right"), shift(vl, "left")],
                               dim=1)

        # Deactivate leavers, then place arrivals into free slots: the
        # k-th valid arrival takes the k-th free slot (the two halves are
        # each prefix-valid, so pairing arrival i with free slot i would
        # starve the second half). An arrival past the free slots is a
        # cap_local overflow, flagged; its writes go to a pad row.
        active = state.active & ~(go_left | go_right)
        free_idx, free_ok = _select_fill(~active, 2 * M)
        rank = torch.where(recv_valid, torch.cumsum(recv_valid.long(), -1) - 1,
                           2 * M - 1)
        place = recv_valid & torch.gather(free_ok, 1, rank)
        slot_rows = torch.gather(free_idx, 1, rank)
        mig_overflow = torch.where((recv_valid & ~place).any(-1), big,
                                   mig_overflow)
        rows = torch.arange(S, device=idx.device)[:, None]

        def scatter(field, val, sentinel):
            pad = field.new_zeros((S, 1) + field.shape[2:])
            ext = torch.cat([field, pad], dim=1)
            ext[rows, torch.where(place, slot_rows, sentinel)] = val
            return ext[:, :-1]

        new_fields = {f: scatter(getattr(state, f), recv[f], cl)
                      for f in COMM_FIELDS}
        state = state.replace(active=scatter(active, place, cl), **new_fields)
        ce = neigh.hist.shape[1]
        neigh = neigh.replace(
            neigh_tag=scatter(neigh.neigh_tag, recv["ntag"], ce),
            mask=scatter(neigh.mask, recv["nmask"], ce),
            hist=scatter(neigh.hist, recv["nhist"], ce),
            wall_hist=scatter(neigh.wall_hist, recv["whist"], ce),
            row_tag=scatter(neigh.row_tag, recv["tag"], ce),
        )
        return state, neigh, mig_overflow

    def _extend(self, state: State, ghosts: GhostPack):
        """Owned + ghost slots as one extended State [S, cap_ext]."""
        z3 = torch.zeros((self.n_local, 2 * self.halo_cap, 3),
                         dtype=state.x.dtype, device=state.x.device)
        cat = lambda a, b: torch.cat([a, b], dim=1)
        return state.replace(
            x=cat(state.x, ghosts.x), v=cat(state.v, ghosts.v),
            q=cat(state.q, ghosts.q), angmom=cat(state.angmom, ghosts.angmom),
            scale=cat(state.scale, ghosts.scale),
            shtype=cat(state.shtype, ghosts.shtype),
            tag=cat(state.tag, ghosts.tag),
            active=cat(state.active, ghosts.active),
            f=cat(state.f, z3), tau=cat(state.tau, z3),
            image=cat(state.image, z3.long()),
        )

    def _owned_mask(self, device):
        """[cap_ext]: the owned rows of a slab's extended block."""
        return torch.arange(self.cap_ext, device=device) < self.cap_local

    def _stale(self, state, neigh):
        """The global rebuild trigger (0-d bool, pmax over the slabs):
        the budget-ratio check of the prefiltered list (each slab checks
        its OWNED rows; ghosts are checked by their owner), plain skin/2
        displacement otherwise."""
        cl = self.cap_local
        if self.prefilter:
            gmax_s = self.shapes.gmax[state.shtype] * state.scale
            ratio = neighbor.approach_ratio(
                state.x, neigh.x_build[:, :cl], state.q,
                neigh.q_build[:, :cl], gmax_s, neigh.budget[:, :cl],
                state.active, state.box_lo, state.box_hi, self.periodic,
                self._tilt(state))
            return self.axis.pmax(ratio) > 1.0
        disp2 = neighbor.max_displacement2(
            state.x, neigh.x_build[:, :cl], state.active, state.box_lo,
            state.box_hi, self.periodic, self._tilt(state))
        return self.axis.pmax(disp2) > (0.5 * self.params.skin) ** 2

    def _exchange(self, state, neigh, ghosts):
        """exchange() then borders(): migration under the bounds riding
        the ghosts, and new ghosts. Returns (state, neigh, ghosts,
        migration overflow [S], halo overflow [S])."""
        ax, H = self.axis, self.halo_cap
        fracs = ghosts.fracs
        state, neigh, mig_ovf = self._migrate(state, neigh, fracs)
        send_idx, send_mask, halo_ovf = self._halo_membership(state, fracs)
        g = self._gather_send(state, send_idx, send_mask)
        for f in ("scale", "shtype", "tag"):
            vals = take(getattr(state, f), send_idx, True)
            g[f] = torch.cat([ax.ring_shift(vals[:, H:], "right"),
                              ax.ring_shift(vals[:, :H], "left")], dim=1)
        # I receive: from LEFT neighbour's right-send, from RIGHT's left-send.
        g_active = torch.cat([ax.ring_shift(send_mask[:, H:], "right"),
                              ax.ring_shift(send_mask[:, :H], "left")], dim=1)
        ghosts = GhostPack(active=g_active, send_idx=send_idx,
                           send_mask=send_mask, fracs=fracs, **g)
        return state, neigh, ghosts, mig_ovf, halo_ovf

    def _bin_window(self, state, ghosts):
        """Each shard's binning window (bin_lo, bin_hi) [n_local, 3]: its
        slab and the halo depth each side along x, the box along y and z."""
        S = self.n_local
        slab_lo, slab_hi = self._slab_edges(state, ghosts.fracs)
        lo, hi = state.box_lo, state.box_hi
        bin_lo = torch.stack([slab_lo - self.halo_depth, lo[1].expand(S),
                              lo[2].expand(S)], dim=-1)
        bin_hi = torch.stack([slab_hi + self.halo_depth, hi[1].expand(S),
                              hi[2].expand(S)], dim=-1)
        return bin_lo, bin_hi

    def _rebuild(self, state: State, neigh: NeighborState, ghosts: GhostPack,
                 fold: bool = True):
        """exchange() + borders() + neighbour build + history remap.

        ``fold=False`` (init/restore only): the durable [N, K] hist is
        already authoritative (zeros on a fresh start, seeded springs on
        a restart) and the pair list is empty, so folding would wipe it.
        """
        ax, S = self.axis, self.n_local
        tilt = self._tilt(state)
        x, image = neighbor.wrap_positions(
            state.x, state.image, state.box_lo, state.box_hi, self.periodic,
            tilt)
        state = state.replace(x=x, image=image)
        # Fold live pair-space springs back into the tag-keyed [N, K]
        # layout FIRST: migration ships [N, K] rows, and remap reads them.
        if fold:
            neigh = neigh.replace(hist=contact.pair_hist_to_dense(neigh))
        state, neigh, ghosts, mig_ovf, halo_ovf = self._exchange(
            state, neigh, ghosts)
        ext = self._extend(state, ghosts)
        bin_lo, bin_hi = self._bin_window(state, ghosts)
        lo, hi = state.box_lo, state.box_hi
        cutoff = self.params.cutoff + self.params.skin
        owned = self._owned_mask(x.device) & ext.active
        nidx, nmask, count, cell_ovf = neighbor.cell_list_neighbors(
            ext.x, ext.active, lo.expand(S, 3), hi.expand(S, 3),
            cutoff.expand(S), self.grid_dims, self.cell_cap, self.k_max,
            self.periodic_eff, None if tilt is None else tilt.expand(S, 3),
            row_chunk=ROW_CHUNK, bin_lo=bin_lo, bin_hi=bin_hi,
            owned=owned)
        neigh_tag = torch.where(nmask, take(ext.tag, nidx, True), 0)
        row_ok = neigh.row_tag == ext.tag
        hist = neighbor.remap_history(
            neigh_tag, nmask, neigh.neigh_tag, neigh.mask, neigh.hist, row_ok)
        pair_fields, n_pairs = contact.build_pair_list(
            ext, self.shapes, self.params, nidx, nmask, hist, owned,
            self.pair_capacity, self.periodic_eff, tilt=tilt)
        zero = torch.zeros_like(n_pairs)
        n_surv = zero
        if self.prefilter:
            pair_fields, n_surv, budget = contact.prefilter_pair_list(
                ext, self.shapes, self.params, pair_fields,
                self.stage2_capacity, self.k_max,
                window_steps=self._window_steps,
                periodic=self.periodic_eff, tilt=tilt,
                reduce_max=ax.pmax)
            neigh = neigh.replace(budget=budget)
        # Per-source gating: each count contributes only past its OWN
        # capacity, so nonzero overflow always means truncated physics.
        gate = lambda n, cap: torch.where(n > cap, n, zero)
        mx = count.amax(-1)
        overflow = torch.stack([
            gate(mx, self.k_max), gate(cell_ovf, self.cell_cap),
            gate(mig_ovf, self.migrate_cap), gate(halo_ovf, self.halo_cap),
            gate(n_pairs, self.pair_capacity),
            gate(n_surv, self.stage2_capacity)]).amax(0)
        overflow = ax.pmax(overflow).expand(S)
        neigh = neigh.replace(
            idx=nidx, mask=nmask, hist=hist, neigh_tag=neigh_tag,
            row_tag=ext.tag, x_build=ext.x, q_build=ext.q,
            overflow=torch.maximum(neigh.overflow, overflow),
            **pair_fields,
        )
        return state, neigh, ghosts

    def _forward_comm(self, state: State, ghosts: GhostPack):
        """Refresh the ghosts' x, v, q, angmom from their owners."""
        g = self._gather_send(state, ghosts.send_idx, ghosts.send_mask)
        return ghosts.replace(x=g["x"], v=g["v"], q=g["q"],
                              angmom=g["angmom"])

    def _forces(self, state: State, neigh: NeighborState, ghosts: GhostPack):
        """Pair, wall and gravity forces on the owned rows."""
        cl = self.cap_local
        ext = self._extend(state, ghosts)
        f, tau, pair_hist, pe_pair, virial = contact.contact_force_pairs(
            ext, self.shapes, self.params, neigh,
            periodic=self.periodic_eff, tilt=self._tilt(state),
            conservative=self.conservative)
        neigh = neigh.replace(pair_hist=pair_hist)
        # Reactions onto ghost rows are dropped here: owned-ghost pairs
        # are one-sided (pair_both False) and the ghost's owner evaluates
        # its own copy (Newton off).
        f, tau = f[:, :cl], tau[:, :cl]

        pe_wall = torch.zeros_like(pe_pair)
        overflow = neigh.overflow
        wall_hists = []
        for w_i, wall in enumerate(self.walls):
            wf, wt, whist, wpe, n_near = walls_mod.wall_contact(
                state, self.shapes, self.params, wall,
                neigh.wall_hist[:, :cl, w_i], wall_cap=self.wall_capacity)
            f = f + wf
            tau = tau + wt
            pe_wall = pe_wall + wpe.sum(-1)
            wall_hists.append(whist)
            if self.wall_capacity:
                overflow = torch.maximum(overflow, torch.where(
                    n_near > self.wall_capacity, n_near,
                    torch.zeros_like(n_near)))
        if wall_hists:
            neigh = neigh.replace(wall_hist=torch.cat(
                [torch.stack(wall_hists, dim=-2), neigh.wall_hist[:, cl:]],
                dim=1))
        neigh = neigh.replace(overflow=overflow)
        m = self.shapes.mass_of(state.shtype, state.scale)
        f = f + torch.where(state.active[..., None],
                            m[..., None] * self.params.gravity, 0.0)
        state = state.replace(f=f, tau=tau)
        return state, neigh, {"pe_pair": pe_pair, "pe_wall": pe_wall,
                              "virial": virial}

    # -- stepping -------------------------------------------------------------
    #
    # The step is four units that never read the device from the host:
    # ``_pre`` (integrate, deformation, the tilt sentinel and, in check
    # mode, the global stale flag), a rebuild (``_rebuild_always`` on the
    # cadence, ``_rebuild`` when the trigger fired), ``_forward_comm`` on
    # the other steps, and ``_post`` (forces, final integrate).

    def _pre(self, state: State, neigh: NeighborState, check: bool):
        state = integrate.initial_integrate(state, self.shapes, self.params)
        state, x_build, _ = integrate.apply_deformation(
            state, neigh.x_build, self.params, self.periodic)
        neigh = neigh.replace(x_build=x_build)
        if self.triclinic:
            # A tilt past L/2 on an axis that cannot flip: fail loudly
            # through the overflow channel (sentinel 1 << 21).
            L = state.box_hi - state.box_lo
            bound = 0.5 * torch.stack([L[0], L[0], L[1]])
            bad = (state.tilt.abs() > bound * (1 + 1e-6)).any()
            neigh = neigh.replace(overflow=torch.maximum(
                neigh.overflow, torch.where(
                    bad, 1 << 21, torch.zeros_like(neigh.overflow))))
        return state, neigh, self._stale(state, neigh) if check else None

    def _rebuild_always(self, state, neigh, ghosts):
        """A scheduled rebuild, recording (not branching on) a stale list
        in ``skin_violations``."""
        viol = self._stale(state, neigh).long()
        state, neigh, ghosts = self._rebuild(state, neigh, ghosts)
        return state, neigh.replace(
            skin_violations=neigh.skin_violations + viol), ghosts

    def _post(self, state, neigh, ghosts):
        state, neigh, aux = self._forces(state, neigh, ghosts)
        state = integrate.final_integrate(state, self.shapes, self.params)
        return state, neigh, aux

    def _local_step(self, state: State, neigh: NeighborState,
                    ghosts: GhostPack, rebuild: str = "check"):
        """One step, eagerly. rebuild: 'check' (the global skin trigger,
        read on the host), 'always' (static cadence, skin violations
        counted), 'comm' (forward comm only: the between-rebuild steps
        of the cadence). Returns (state, neigh, ghosts, aux)."""
        state, neigh, stale = self._pre(state, neigh, rebuild == "check")
        if rebuild == "always":
            state, neigh, ghosts = self._rebuild_always(state, neigh, ghosts)
        elif rebuild == "check" and bool(stale):
            state, neigh, ghosts = self._rebuild(state, neigh, ghosts)
        else:
            ghosts = self._forward_comm(state, ghosts)
        state, neigh, aux = self._post(state, neigh, ghosts)
        return state, neigh, ghosts, aux

    # -- public entry points ---------------------------------------------------

    def init(self, state_global: State, restart: dict | None = None):
        """Distribute + first rebuild (Verlet::setup analogue). Pass
        ``restart`` (from :meth:`gather_restart`) to resume with contact
        history intact across an arbitrary re-sharding."""
        state, neigh, ghosts = self.distribute(state_global, restart=restart)
        # fold=False: at init the durable hist (zeros, or the restart
        # seed) is authoritative and the pair list is still empty.
        state, neigh, ghosts = self._rebuild(state, neigh, ghosts, fold=False)
        return self._refresh_forces(state, neigh, ghosts)

    def _refresh_forces(self, state, neigh, ghosts):
        """f/tau at the current configuration without advancing springs:
        the next step integrates this same configuration (see
        Simulation.init_neighbors). Returns (state, neigh, ghosts)."""
        hist0, whist0 = neigh.pair_hist, neigh.wall_hist
        state, neigh, _ = self._forces(state, neigh, ghosts)
        return state, neigh.replace(pair_hist=hist0, wall_hist=whist0), ghosts

    def run(self, state, neigh, ghosts, n_steps: int):
        """``n_steps`` steps. With ``rebuild_every = R > 0`` the static
        cadence: blocks of one rebuild step + R-1 forward-comm steps, the
        remainder a short block scheduled the same way (never through the
        check path: its motion budget is spent by the end of the last
        block). With R = 0 the global skin trigger decides each step.

        On CUDA tensors (unless ``cuda_graphs`` is off) each step replays
        CUDA graphs of the step's units: ``pre`` (``pre_check`` with the
        stale flag, one event synchronisation and a pinned read), then
        ``always`` / ``rebuild`` or ``comm``, then ``post``. Returns new
        tensors (state, neigh, ghosts)."""
        R = self.rebuild_every
        if R > 0:
            n_blocks, rem = divmod(n_steps, R)
            kinds = [("always" if k == 0 else "comm")
                     for length in [R] * n_blocks + ([rem] if rem else [])
                     for k in range(length)]
        else:
            kinds = ["check"] * n_steps
        self._check_graphs(state.x.device)
        if not (self.cuda_graphs and state.x.is_cuda and n_steps > 0):
            for kind in kinds:
                state, neigh, ghosts, _ = self._local_step(
                    state, neigh, ghosts, kind)
            return state, neigh, ghosts
        runner = self._runner(state, neigh, ghosts,
                              ("pre", "always", "comm", "post") if R > 0
                              else ("pre_check", "rebuild", "comm", "post"))
        for kind in kinds:
            if kind == "check":
                runner.replay("pre_check")
                runner.replay("rebuild" if runner.read_flag() else "comm")
            else:
                runner.replay("pre")
                runner.replay(kind)
            runner.replay("post")
        return runner.result("state", "neigh", "ghosts")

    def rebalance(self, state, neigh, ghosts):
        """In-run load rebalance (LAMMPS ``fix balance`` / ``balance x
        weighted``): new bounds from the current particles' x-quantiles,
        swapped into ``ghosts.fracs``, then one forced rebuild (migrate +
        re-halo) and a force refresh, eagerly. The bounds are data of the
        step, so the next ``run`` replays the graphs it has.

        Each boundary stays strictly inside its old neighbouring
        boundaries (every particle's owner moves at most one slab, which
        the one-hop migration routes in the forced rebuild), and each slab
        stays halo-legal and wide enough for the static bin grid's cells
        to stay >= cutoff. Call between run() blocks at the balance
        cadence. On ranks the quantiles read every slab's particles
        (gathered), so every rank takes the same bounds. Returns (state,
        neigh, ghosts).
        """
        xs = to_numpy(self.axis.gather(state.x))
        act = to_numpy(self.axis.gather(state.active))
        lo = float(to_numpy(state.box_lo)[0])
        hi = float(to_numpy(state.box_hi)[0])
        Lx = hi - lo
        xf = np.clip((xs[act][:, 0] - lo) / Lx, 0.0, 1.0)
        cutoff_total = float(self.params.cutoff + self.params.skin) \
            + self.tilt_pad
        # Bin-grid legality floor: the grid was sized for the most-
        # compressed box (deform_min), so the narrowest legal window
        # divides it back out.
        min_w = max(self.halo_depth,
                    self.grid_dims[0] * cutoff_total / self.deform_min
                    - 2 * self.halo_depth)
        min_frac = min_w / Lx * (1.0 + 1e-3)
        old = to_numpy(ghosts.fracs).astype(np.float64)
        qs = clamped_quantile_fracs(xf, old, self.n_shards, min_frac)
        ghosts = ghosts.replace(fracs=torch.as_tensor(
            qs, dtype=ghosts.fracs.dtype, device=ghosts.fracs.device))
        state, neigh, ghosts = self._rebuild(state, neigh, ghosts, fold=True)
        return self._refresh_forces(state, neigh, ghosts)

    def thermo(self, state, neigh, ghosts) -> dict:
        """LAMMPS-thermo-style scalars summed over the slabs in slab order
        (0-d tensors; ``stress`` [3, 3]; ``neigh_overflow`` the max)."""
        ax = self.axis
        state, neigh, aux = self._forces(state, neigh, ghosts)
        ke_t, ke_r = integrate.kinetic_energy(state, self.shapes)
        m = self.shapes.mass_of(state.shtype, state.scale)
        pe_grav = -torch.where(
            state.active, m * (self.params.gravity * state.x).sum(-1),
            0.0).sum(-1)
        kin = torch.einsum("rn,rna,rnb->rab",
                           torch.where(state.active, m, 0.0), state.v,
                           state.v)
        sc = {"n": state.active.sum(-1), "ke": ke_t, "erot": ke_r,
              "pe_pair": aux["pe_pair"], "pe_wall": aux["pe_wall"],
              "pe_grav": pe_grav}
        sc = {k: ax.psum(v) for k, v in sc.items()}
        vol_box = torch.prod(state.box_hi - state.box_lo)
        stress = (ax.psum(kin) + ax.psum(aux["virial"])) / vol_box
        sc["etot"] = (sc["ke"] + sc["erot"] + sc["pe_pair"] + sc["pe_wall"]
                      + sc["pe_grav"])
        sc["press"] = torch.trace(stress) / 3.0
        sc["stress"] = stress
        sc["step"] = state.step
        sc["neigh_overflow"] = ax.pmax(neigh.overflow)
        return sc

    def gather_restart(self, state, neigh):
        """Restart payload: the dense global State (active rows in slot
        order, on the state's device) + tag-keyed contact history (live
        pair springs folded in) as numpy arrays aligned row for row with
        it; round-trips through io.restart's extra fields."""
        neigh = neigh.replace(hist=contact.pair_hist_to_dense(neigh))
        g = self.axis.gather
        state = state.replace(**{f: g(getattr(state, f)) for f in
                                 ("x", "v", "q", "angmom", "scale", "shtype",
                                  "tag", "active", "image")})
        neigh = neigh.replace(neigh_tag=g(neigh.neigh_tag), hist=g(neigh.hist),
                              wall_hist=g(neigh.wall_hist))
        S, cl, ce = self.n_shards, self.cap_local, self.cap_ext
        act = to_numpy(state.active).reshape(-1)
        sel = np.flatnonzero(act)                 # into [S * cap_local]
        blk = sel // cl
        nrow = blk * ce + (sel - blk * cl)        # matching ext rows
        sel_t = torch.as_tensor(sel, device=state.x.device)
        flat = lambda t: t.reshape((S * t.shape[1],) + t.shape[2:])
        pick = lambda f: flat(getattr(state, f))[sel_t]
        n = sel.size
        z3 = torch.zeros((n, 3), dtype=state.x.dtype, device=state.x.device)
        gstate = State(
            x=pick("x"), v=pick("v"), q=pick("q"), angmom=pick("angmom"),
            f=z3, tau=z3.clone(), scale=pick("scale"), shtype=pick("shtype"),
            tag=pick("tag"), active=torch.ones_like(pick("active")),
            image=pick("image"), box_lo=state.box_lo.clone(),
            box_hi=state.box_hi.clone(), tilt=state.tilt.clone(),
            step=state.step.clone(),
        )
        payload = {
            "hist_tags": to_numpy(flat(neigh.neigh_tag))[nrow],
            "hist": to_numpy(flat(neigh.hist))[nrow],
            "wall_hist": to_numpy(flat(neigh.wall_hist))[nrow],
        }
        return gstate, payload

    def gather_global(self, state) -> State:
        """The slabs' state as one host-side State of S * cap_local slots
        (slab-major; inactive slots kept), for dumps and restarts."""
        flat = lambda t: self.axis.gather(t).reshape((-1,) + t.shape[2:])
        per = {f: flat(getattr(state, f)) for f in
               ("x", "v", "q", "angmom", "f", "tau", "scale", "shtype",
                "tag", "active", "image")}
        return State(**{k: v.cpu() for k, v in per.items()},
                     box_lo=state.box_lo.cpu(), box_hi=state.box_hi.cpu(),
                     tilt=state.tilt.cpu(), step=state.step.cpu())

    # -- CUDA graphs -------------------------------------------------------

    def _units(self):
        """The graph units, as functions of the runner's buffers (state,
        neigh, ghosts, params), run by a view of this simulation that
        reads its params from the buffer."""
        view = runner_mod.params_view

        def pre(check):
            def unit(b):
                s, n, stale = view(self, b)._pre(b["state"], b["neigh"],
                                                 check)
                out = {"state": s, "neigh": n}
                if check:
                    out["flag"] = stale
                return out
            return unit

        def rebuild(always):
            def unit(b):
                sim = view(self, b)
                fn = sim._rebuild_always if always else sim._rebuild
                s, n, g = fn(b["state"], b["neigh"], b["ghosts"])
                return {"state": s, "neigh": n, "ghosts": g}
            return unit

        def comm(b):
            return {"ghosts": view(self, b)._forward_comm(b["state"],
                                                          b["ghosts"])}

        def post(b):
            s, n, _ = view(self, b)._post(b["state"], b["neigh"],
                                          b["ghosts"])
            return {"state": s, "neigh": n}

        return {"pre": pre(False), "pre_check": pre(True),
                "always": rebuild(True), "rebuild": rebuild(False),
                "comm": comm, "post": post}

    def _runner(self, state, neigh, ghosts, names: tuple):
        """The GraphRunner for these buffers' signature with the units
        ``names`` captured, loaded with (state, neigh, ghosts, params)
        (``runner.cached_runner``)."""
        return runner_mod.cached_runner(
            self, dict(state=state, neigh=neigh, ghosts=ghosts,
                       params=self.params), names,
            capture_error_mode=self.axis.capture_error_mode)

    def graph_stats(self) -> dict:
        """The cached runners' totals (``runner.graph_stats``)."""
        return runner_mod.graph_stats(self)
