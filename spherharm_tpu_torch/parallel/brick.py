"""2D/3D brick decomposition with weighted per-axis bounds (torch twin of
``spherharm_tpu/parallel/brick.py``).

The slab decomposition (``parallel/halo.py``) cut along x only. Here the
box is cut along x and y, or x, y and z, as the reference's
``Comm::set_proc_grid`` factorises ranks into a 3D brick (SURVEY.md 2 B.6;
3.5). The S = Sx * Sy (* Sz) bricks live on the leading shard axis of one
device's tensors, flat in row-major order with x slowest (the reference's
block order), and the collectives go through ``BrickAxes``: a ring per
mesh axis. An N-D exchange is a composition of N 1D exchanges (how the
reference's 6-way brick exchange covers all 26 neighbours):

  migrate:  leavers move one hop along x, THEN y, THEN z, so a diagonal
            migrant takes every phase within one rebuild;
  halo:     phase k ships the axis-k faces of the owned rows and of the
            ghosts of the phases before it, so edge and corner ghosts ride
            the later phases;
  forward:  each phase re-gathers from the view the phases before it have
            already refreshed (in that order: else corner ghosts lag a
            step).

Extended rows of a brick: [owned cap_local | 2 halo_cap ghosts per mesh
axis]; ``ghosts`` is a tuple of one ``GhostPack`` per mesh axis, each
carrying its axis' bounds (``fracs``). Everything downstream (the binning
window, the pair list, forces, the step, its graphs, thermo, restarts) is
``ShardedSimulation``'s.

Sheared (triclinic) bricks own and bin their rows in raw coordinates, as
the slabs do: the seam shift of a sent ghost is the axis' full cell
vector, and ``tilt_pad`` widens the x (and y) halo to reach through the
tilt. The reference's module docstring calls triclinic "not supported";
its code supports it, and so does this port.
"""

from __future__ import annotations

import numpy as np
import torch

from spherharm_tpu_torch.core.state import take, to_numpy
from spherharm_tpu_torch.parallel.halo import (
    GhostPack,
    RankAxis,
    ShardAxis,
    ShardedSimulation,
    _select_fill,
    clamped_quantile_fracs,
    empty_ghosts,
)

AXES = "xyz"


class BrickAxes(ShardAxis):
    """The transport of the bricks: S = prod(``mesh_shape``) bricks on the
    leading axis of one device's tensors, row-major over the mesh axes
    (x slowest: the stride of x is Sy * Sz). ``ring_shift`` takes one hop
    round one mesh axis' ring; ``psum`` (in flat order) and ``pmax`` run
    over all S, as the slabs' do."""

    def __init__(self, mesh_shape):
        self._set_mesh(mesh_shape)
        ShardAxis.__init__(self, int(np.prod(self.shape)))

    def _set_mesh(self, mesh_shape):
        self.shape = tuple(int(s) for s in mesh_shape)
        self.names = AXES[:len(self.shape)]

    def size(self, axis: str) -> int:
        return self.shape[self.names.index(axis)]

    def _stride(self, axis: str) -> int:
        return int(np.prod(self.shape[self.names.index(axis) + 1:]))

    def index(self, device, axis: str):
        """The coordinate on mesh axis ``axis`` of each brick held here,
        [n_local]."""
        flat = super().index(device)
        return flat // self._stride(axis) % self.size(axis)

    def ring_shift(self, val, direction: str, axis: str):
        """One hop round the ring of mesh axis ``axis``: "left" sends to
        the brick at coordinate - 1, so each brick receives the buffer of
        its neighbour at + 1; "right" the other way."""
        if direction not in ("left", "right"):
            raise ValueError(f"unknown ring direction {direction!r}")
        grid = val.reshape(self.shape + val.shape[1:])
        return torch.roll(grid, -1 if direction == "left" else 1,
                          dims=self.names.index(axis)).reshape(val.shape)


class RankBrickAxes(BrickAxes, RankAxis):
    """The bricks' transport of one brick a process (``RankAxis``): ranks
    numbered flat and row-major over ``mesh_shape``, x slowest, as the
    bricks of ``BrickAxes``. ``ring_shift(val, direction, axis)`` swaps
    with the ranks whose coordinate along ``axis`` is one less and one
    more (mod its size; the identity on an axis of size 1); ``psum``,
    ``pmax`` and ``gather`` run over every rank."""

    def __init__(self, mesh_shape, group=None, device=None):
        self._set_mesh(mesh_shape)
        RankAxis.__init__(self, group, device)
        if int(np.prod(self.shape)) != self.n_shards:
            raise ValueError(
                f"a {self.shape} brick needs {int(np.prod(self.shape))} "
                f"ranks, the group has {self.n_shards}")

    def ring_shift(self, val, direction: str, axis: str):
        if direction not in ("left", "right"):
            raise ValueError(f"unknown ring direction {direction!r}")
        n, stride = self.size(axis), self._stride(axis)
        if n == 1:
            return val
        c = self.rank // stride % n
        step = 1 if direction == "left" else -1
        peer = lambda k: self.rank + ((c + k) % n - c) * stride
        return self._exchange(val, peer(-step), peer(step))


class BrickSimulation(ShardedSimulation):
    """DEM over a 2D (x, y) or 3D (x, y, z) brick of S = prod(``mesh_shape``)
    shards on a leading shard axis of one device's tensors (``BrickAxes``).

    ``mesh_shape`` = (Sx, Sy) or (Sx, Sy, Sz) stands where the reference's
    mesh stood; ``axis=RankBrickAxes(mesh_shape)`` runs one brick a
    process. ``bounds_frac``: {axis: [n_axis + 1] box fractions}
    (uniform where not given; ``halo.balance_fracs(..., axis=d)`` per axis
    for weighted bounds). ``tilt_pad``: a scalar (the x and y reaches) or
    {"x": .., "y": ..}; the x halo must reach max |xy| + |xz|, the y halo
    max |yz|. Everything else as ``ShardedSimulation``; ``init``, ``run``,
    ``rebalance``, ``thermo``, ``gather_restart`` and ``gather_global``
    return what the slabs' do, with ``ghosts`` a tuple of one GhostPack per
    mesh axis.
    """

    shard_name = "brick"

    def __init__(
        self,
        shapes,
        params,
        *,
        mesh_shape,
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
        conservative: bool = True,
        bounds_frac: dict | None = None,
        triclinic: bool = False,
        tilt_pad=0.0,
        device="cuda",
        cuda_graphs: bool = True,
        axis: BrickAxes | None = None,
    ):
        mesh_shape = tuple(mesh_shape)
        if len(mesh_shape) not in (2, 3) or any(
                int(s) != s or s < 1 for s in mesh_shape):
            raise ValueError(
                "BrickSimulation needs a 2D/3D mesh_shape (Sx, Sy) or "
                f"(Sx, Sy, Sz) of positive integers, got {mesh_shape!r}")
        self.shapes = shapes
        self.params = params
        self.axis = BrickAxes(mesh_shape) if axis is None else axis
        if self.axis.shape != tuple(int(s) for s in mesh_shape):
            raise ValueError(f"the transport's mesh is {self.axis.shape}, "
                             f"not mesh_shape={mesh_shape}")
        self.n_shards = self.axis.n_shards
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
        self.prefilter = self.stage2_capacity > 0
        self.conservative = bool(conservative)
        self.device = torch.device(device)
        self.cuda_graphs = bool(cuda_graphs)
        self._graphs = {}
        self._check_graphs(self.device)
        # Triclinic bricks own and bin in raw coordinates with per-axis
        # halo inflation: a y/z-crossing image shifts x by the tilt, so
        # the x halo must reach |xy| + |xz| further, the y halo |yz|; z
        # is exact.
        self.triclinic = bool(triclinic)
        if isinstance(tilt_pad, dict):
            pads = {"x": float(tilt_pad.get("x", 0.0)),
                    "y": float(tilt_pad.get("y", 0.0)), "z": 0.0}
        else:
            pads = {"x": float(tilt_pad), "y": float(tilt_pad), "z": 0.0}
        self.tilt_pads = pads
        if triclinic and all(v <= 0.0 for v in pads.values()):
            raise ValueError("triclinic brick needs tilt_pad > 0 "
                             "(>= max |xy|+|xz| for x, >= max |yz| for y)")

        self.box_lo_np = np.asarray(box_lo, np.float64)
        self.box_hi_np = np.asarray(box_hi, np.float64)
        L = self.box_hi_np - self.box_lo_np
        cutoff_total = float(params.cutoff + params.skin)
        self.halo_depth_ax = {ax: cutoff_total + pads[ax] for ax in AXES}

        # Weighted per-axis boundaries as box fractions (uniform default).
        bounds_frac = dict(bounds_frac or {})
        self.bounds_frac = {}
        for ax in self.axis.names:
            n = self.axis.size(ax)
            bf = np.asarray(bounds_frac.pop(ax, np.linspace(0.0, 1.0, n + 1)),
                            np.float64)
            if (bf.shape != (n + 1,) or bf[0] != 0.0 or bf[-1] != 1.0
                    or np.any(np.diff(bf) <= 0)):
                raise ValueError(
                    f"bounds_frac[{ax!r}] must be increasing, length "
                    f"n_{ax}+1, with ends 0 and 1")
            self.bounds_frac[ax] = bf
        if bounds_frac:
            raise ValueError(f"bounds_frac for unknown axes: "
                             f"{sorted(bounds_frac)}")
        # The narrowest brick along each sharded axis must cover its halo.
        self.slab_w = {}
        for d, ax in enumerate(self.axis.names):
            self.slab_w[ax] = float((np.diff(self.bounds_frac[ax]) * L[d]).min())
            if (self.axis.size(ax) > 1
                    and self.slab_w[ax] < self.halo_depth_ax[ax]):
                raise ValueError(
                    f"axis {ax}: narrowest brick width {self.slab_w[ax]:.3g} "
                    f"< halo depth {self.halo_depth_ax[ax]:.3g}: too many "
                    "shards (or too skewed a balance) for this box")
        # One bin grid for every brick over its window and halo margins
        # (the whole box along an unsharded axis), cells >= cutoff for the
        # narrowest brick at the most compressed box (deform_min). Sheared
        # binning runs in the unsheared frame, where a raw-cutoff neighbour
        # inflates by up to |tilt| / L per coupled axis: the cells grow by
        # that, so the 27-stencil stays complete at the padded tilt.
        bin_ext = np.array([
            self.slab_w[ax] + 2 * self.halo_depth_ax[ax]
            if ax in self.axis.names else L[d] for d, ax in enumerate(AXES)])
        self._infl = 1.0
        if triclinic:
            self._infl = 1.0 + min((pads["x"] + pads["y"]) / float(L.min()),
                                   1.0)
        dims = np.maximum(np.floor(
            float(deform_min) * bin_ext / (cutoff_total * self._infl))
            .astype(int), 1)
        self.grid_dims = tuple(int(v) for v in dims)
        self.deform_min = float(deform_min)
        # Sharded axes image through the seam-shifted ghosts; only the
        # unsharded ones take the minimum image.
        self.periodic_eff = tuple(
            self.periodic[d] and AXES[d] not in self.axis.names
            for d in range(3))

    @property
    def n_axes(self) -> int:
        return len(self.axis.names)

    @property
    def cap_ext(self) -> int:
        return self.cap_local + 2 * self.halo_cap * self.n_axes

    # -- distribution (host-side) ------------------------------------------

    def distribute(self, state_global, restart: dict | None = None):
        """Partition a single-box State into per-brick slots (raw-coordinate
        ownership; a tilted state needs ``triclinic=True`` and pads that
        reach its tilt): (state [S, cap_local], neigh [S, cap_ext], ghosts:
        one GhostPack [S, 2H] per mesh axis)."""
        tilt0 = to_numpy(state_global.tilt).astype(np.float64)
        if not self.triclinic and bool(np.any(tilt0 != 0.0)):
            raise ValueError(
                "state has triclinic tilt but the brick was built with "
                "triclinic=False — pass triclinic=True and tilt_pad")
        if self.triclinic:
            need_x = abs(tilt0[0]) + abs(tilt0[1])
            need_y = abs(tilt0[2])
            if (need_x > self.tilt_pads["x"] + 1e-9
                    or need_y > self.tilt_pads["y"] + 1e-9):
                raise ValueError(
                    f"initial tilt {tilt0} exceeds tilt_pad "
                    f"{self.tilt_pads} — halos would under-reach")
        return super().distribute(state_global, restart=restart)

    def _owner_np(self, x):
        """The flat brick of each row of the host positions ``x`` [n, 3]
        under the initial bounds (row-major over the mesh axes)."""
        L = self.box_hi_np - self.box_lo_np
        block = np.zeros(x.shape[0], np.int64)
        for ax in self.axis.names:
            d = AXES.index(ax)
            f = (x[:, d] - self.box_lo_np[d]) / L[d]
            b = np.clip(np.searchsorted(self.bounds_frac[ax][1:-1], f,
                                        side="right"),
                        0, self.axis.size(ax) - 1)
            block = block * self.axis.size(ax) + b
        return block

    def _fresh_ghosts(self, dtype):
        """Empty ghost buffers, one pack per mesh axis, each carrying that
        axis' bounds as a tensor (rebalance() swaps its values)."""
        return tuple(
            empty_ghosts(self.halo_cap, dtype, device=self.device,
                         n_shards=self.n_local,
                         fracs=torch.as_tensor(self.bounds_frac[ax],
                                               dtype=dtype,
                                               device=self.device))
            for ax in self.axis.names)

    # -- per-axis building blocks (all bricks at once) ---------------------

    def _edges(self, state, axis: str, fracs):
        """(lo, hi) [n_local] of each brick's window along ``axis`` under the
        bounds ``fracs`` (fractions of the current box)."""
        d = AXES.index(axis)
        idx = self.axis.index(state.x.device, axis)
        fr = fracs.to(state.x.dtype)
        L = state.box_hi[d] - state.box_lo[d]
        return (state.box_lo[d] + fr[idx] * L,
                state.box_lo[d] + fr[idx + 1] * L)

    def _has_lo(self, axis: str, device):
        idx = self.axis.index(device, axis)
        if self.periodic[AXES.index(axis)]:
            return torch.ones_like(idx, dtype=torch.bool)
        return idx > 0

    def _has_hi(self, axis: str, device):
        idx = self.axis.index(device, axis)
        if self.periodic[AXES.index(axis)]:
            return torch.ones_like(idx, dtype=torch.bool)
        return idx < self.axis.size(axis) - 1

    def _seam(self, axis: str, state):
        """The shift vector [S, 3] a ghost sent to the lower and to the
        upper neighbour gets across the periodic seam: the axis' full
        cell vector, so sheared images are exact (a = (Lx, 0, 0), b = (xy,
        Ly, 0), c = (xz, yz, Lz))."""
        L = state.box_hi - state.box_lo
        t = state.tilt if self.triclinic else torch.zeros_like(L)
        z = torch.zeros_like(L[0])
        if axis == "x":
            cv = torch.stack([L[0], z, z])
        elif axis == "y":
            cv = torch.stack([t[0], L[1], z])
        else:
            cv = torch.stack([t[1], t[2], L[2]])
        idx = self.axis.index(state.x.device, axis)
        n = self.axis.size(axis)
        lo_send = torch.where(idx == 0, 1.0, 0.0).to(state.x.dtype)
        hi_send = torch.where(idx == n - 1, -1.0, 0.0).to(state.x.dtype)
        return lo_send[:, None] * cv, hi_send[:, None] * cv

    def _membership(self, coords, active, axis: str, state, fracs):
        """The halo senders along ``axis`` among the rows ``coords`` /
        ``active`` [S, rows]: those within the axis' halo depth of a face
        of their brick. Returns (send_idx, send_mask [S, 2H], overflow
        [S])."""
        h = self.halo_depth_ax[axis]
        lo, hi = self._edges(state, axis, fracs)
        dev = coords.device
        near_l = (active & (coords < (lo + h)[:, None])
                  & self._has_lo(axis, dev)[:, None])
        near_r = (active & (coords >= (hi - h)[:, None])
                  & self._has_hi(axis, dev)[:, None])
        il, vl = _select_fill(near_l, self.halo_cap)
        ir, vr = _select_fill(near_r, self.halo_cap)
        overflow = torch.maximum(near_l.sum(-1), near_r.sum(-1))
        return (torch.cat([il, ir], dim=1), torch.cat([vl, vr], dim=1),
                overflow)

    def _ship_fields(self, fields: dict, send_idx, axis: str, state):
        """Gather ``fields`` at ``send_idx``, seam-shift x by the cell
        vector, and exchange both directions along ``axis``: each brick
        receives [:H] from its lower neighbour's upper face, [H:] from its
        upper neighbour's lower face."""
        sl, sr = self._seam(axis, state)
        H = self.halo_cap
        shift = self.axis.ring_shift
        out = {}
        for f, arr in fields.items():
            vals = take(arr, send_idx, True)
            if f == "x":
                vals = torch.cat([vals[:, :H] + sl[:, None],
                                  vals[:, H:] + sr[:, None]], dim=1)
            out[f] = torch.cat([shift(vals[:, H:], "right", axis),
                                shift(vals[:, :H], "left", axis)], dim=1)
        return out

    def _tgt_axis(self, state, axis: str, fracs):
        """The coordinate along ``axis`` of each owned row's brick: the
        count of interior bounds at or below it."""
        d = AXES.index(axis)
        n = self.axis.size(axis)
        if n == 1:
            return torch.zeros_like(state.tag)
        L = state.box_hi[d] - state.box_lo[d]
        f = (state.x[..., d] - state.box_lo[d]) / L
        inner = fracs[1:-1].to(state.x.dtype)
        tgt = (f[..., None] >= inner).sum(-1)
        return torch.clamp(tgt, 0, n - 1)

    def _migrate_axis(self, state, neigh, axis: str, fracs):
        """One migration phase along mesh axis ``axis``
        (``ShardedSimulation._move`` round that axis' ring)."""
        dev = state.x.device
        return self._move(
            state, neigh, self.axis.index(dev, axis), self.axis.size(axis),
            self._tgt_axis(state, axis, fracs), self._has_lo(axis, dev),
            self._has_hi(axis, dev),
            lambda v, direction: self.axis.ring_shift(v, direction, axis))

    def _migrate(self, state, neigh, fracs):
        """One migration phase a mesh axis, x then y then z, so a diagonal
        migrant crosses in one rebuild. ``fracs``: the bounds of each mesh
        axis, in axis order. Returns (state, neigh, overflow [S])."""
        ovf = torch.zeros(self.n_local, dtype=torch.long,
                          device=state.x.device)
        for ax, fr in zip(self.axis.names, fracs):
            state, neigh, o = self._migrate_axis(state, neigh, ax, fr)
            ovf = torch.maximum(ovf, o)
        return state, neigh, ovf

    # -- extended view and halo --------------------------------------------

    def _extend(self, state, ghosts):
        """Owned + every axis' ghost slots as one extended State [S,
        cap_ext]."""
        z3 = torch.zeros((self.n_local, self.cap_ext - self.cap_local, 3),
                         dtype=state.x.dtype, device=state.x.device)
        cat = lambda f: torch.cat(
            [getattr(state, f)] + [getattr(g, f) for g in ghosts], dim=1)
        return state.replace(
            x=cat("x"), v=cat("v"), q=cat("q"), angmom=cat("angmom"),
            scale=cat("scale"), shtype=cat("shtype"), tag=cat("tag"),
            active=cat("active"),
            f=torch.cat([state.f, z3], dim=1),
            tau=torch.cat([state.tau, z3], dim=1),
            image=torch.cat([state.image, z3.long()], dim=1),
        )

    def _build_ghosts(self, state, ghosts):
        """borders() in phases: phase k selects the axis-k faces of the
        owned rows and of the ghosts of phases < k and ships them. Returns
        (new packs carrying the old packs' bounds, halo overflow [S])."""
        send_f = ("x", "v", "q", "angmom", "scale", "shtype", "tag")
        ext = {f: getattr(state, f) for f in send_f}
        act = state.active
        H = self.halo_cap
        shift = self.axis.ring_shift
        packs = []
        ovf = torch.zeros(self.n_local, dtype=torch.long,
                          device=state.x.device)
        for g, ax in zip(ghosts, self.axis.names):
            s_idx, s_mask, o = self._membership(
                ext["x"][..., AXES.index(ax)], act, ax, state, g.fracs)
            recv = self._ship_fields(ext, s_idx, ax, state)
            g_act = torch.cat([shift(s_mask[:, H:], "right", ax),
                               shift(s_mask[:, :H], "left", ax)], dim=1)
            packs.append(GhostPack(active=g_act, send_idx=s_idx,
                                   send_mask=s_mask, fracs=g.fracs, **recv))
            ovf = torch.maximum(ovf, o)
            ext = {f: torch.cat([ext[f], recv[f]], dim=1) for f in send_f}
            act = torch.cat([act, g_act], dim=1)
        return tuple(packs), ovf

    def _exchange(self, state, neigh, ghosts):
        state, neigh, mig_ovf = self._migrate(
            state, neigh, tuple(g.fracs for g in ghosts))
        ghosts, halo_ovf = self._build_ghosts(state, ghosts)
        return state, neigh, ghosts, mig_ovf, halo_ovf

    def _bin_window(self, state, ghosts):
        """Each brick's binning window (bin_lo, bin_hi) [S, 3]: its brick
        and the axis' halo depth each side along a sharded axis, the box
        along an unsharded one."""
        fracs = {ax: g.fracs for ax, g in zip(self.axis.names, ghosts)}
        lo3, hi3 = [], []
        for d, ax in enumerate(AXES):
            if ax in fracs:
                lo, hi = self._edges(state, ax, fracs[ax])
                lo3.append(lo - self.halo_depth_ax[ax])
                hi3.append(hi + self.halo_depth_ax[ax])
            else:
                lo3.append(state.box_lo[d].expand(self.n_local))
                hi3.append(state.box_hi[d].expand(self.n_local))
        return torch.stack(lo3, dim=-1), torch.stack(hi3, dim=-1)

    def _forward_comm(self, state, ghosts):
        """Refresh every pack's x, v, q, angmom, phase by phase from the
        view the earlier phases have already refreshed (the routing of the
        last rebuild)."""
        dyn = ("x", "v", "q", "angmom")
        ext = {f: getattr(state, f) for f in dyn}
        packs = []
        for g, ax in zip(ghosts, self.axis.names):
            recv = self._ship_fields(ext, g.send_idx, ax, state)
            packs.append(g.replace(**recv))
            ext = {f: torch.cat([ext[f], recv[f]], dim=1) for f in dyn}
        return tuple(packs)

    # -- rebalance ---------------------------------------------------------

    def rebalance(self, state, neigh, ghosts):
        """In-run per-axis rebalance (the product-cut analogue of the
        reference's RCB balancer): new bounds along each sharded axis from
        the active particles' quantiles, clamped as the slabs' are (each
        boundary strictly inside its old neighbours, so an owner moves at
        most one brick an axis, which one forced rebuild's migration
        phases route; every window halo-legal and wide enough for the bin
        grid's cells, undoing the sheared inflation and ``deform_min``),
        swapped into each pack's ``fracs``; then one forced rebuild and a
        force refresh, eagerly. Nothing is captured. Returns (state,
        neigh, ghosts)."""
        xs = to_numpy(self.axis.gather(state.x))
        act = to_numpy(self.axis.gather(state.active))
        lo_all, hi_all = to_numpy(state.box_lo), to_numpy(state.box_hi)
        cutoff_total = float(self.params.cutoff + self.params.skin)
        packs = []
        for g, ax in zip(ghosts, self.axis.names):
            d, n = AXES.index(ax), self.axis.size(ax)
            if n < 2:
                packs.append(g)
                continue
            L = float(hi_all[d]) - float(lo_all[d])
            xf = np.clip((xs[act][:, d] - float(lo_all[d])) / L, 0.0, 1.0)
            h = self.halo_depth_ax[ax]
            min_w = max(h, self.grid_dims[d] * cutoff_total * self._infl
                        / self.deform_min - 2 * h)
            qs = clamped_quantile_fracs(
                xf, to_numpy(g.fracs).astype(np.float64), n,
                min_w / L * (1.0 + 1e-3))
            packs.append(g.replace(fracs=torch.as_tensor(
                qs, dtype=g.fracs.dtype, device=g.fracs.device)))
        state, neigh, ghosts = self._rebuild(state, neigh, tuple(packs),
                                             fold=True)
        return self._refresh_forces(state, neigh, ghosts)


class Brick2DSimulation(BrickSimulation):
    """The 2D (x, y) brick: ``BrickSimulation`` that refuses a 3D
    ``mesh_shape``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.n_axes != 2:
            raise ValueError("Brick2DSimulation needs a 2D ('x','y') mesh")
