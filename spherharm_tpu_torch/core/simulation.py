"""The timestep driver (torch twin of ``spherharm_tpu/core/simulation.py``).

Per step:

  initial_integrate   (half kick + drift + quaternion Richardson update)
  rebuild             (static cadence every ``rebuild_every`` steps, or when
                       the skin trigger fires: wrap, re-bin cells, rebuild
                       the [N,K] list, remap history, rebuild + prefilter
                       the pair list)
  force eval          (SH pair kernel over the pair list, or over the
                       dense [N,K] tensor when pair_capacity == 0; wall
                       kernels; gravity; group fixes)
  final_integrate     (second half kick; then the Berendsen box servo
                       when ``press_control``)

The step is written as units that never read the device from the host:
``_pre`` (initial integrate, deformation, the tilt sentinel and, in check
mode, the stale flag), ``_rebuild_always`` / ``_rebuild_stale`` and
``_post`` (forces, final integrate, the servo). ``_step_core`` calls them
eagerly; on CUDA tensors ``run``, ``run_inline`` and
``parallel/ensemble.run_replicas`` replay them as CUDA graphs
(``core/runner.py``; ``cuda_graphs=False`` asks for the eager loop), the
counterpart of the reference's jitted ``_run_cadence_jit`` / ``_run_jit``
scans. Capacities are fixed and overflow is recorded in ``neigh.overflow``
(per-source gated: any nonzero value means physics was truncated), so
every shape is static across steps.

Kernels run where the tensors live: CUDA tensors launch the hand-written
kernels, CPU tensors their plain twins.

With spans on (``utils/spans``) the units mark their layers: ``step.pre``,
``step.trigger`` (the skin trigger or motion budget), ``rebuild`` and its
stages, ``pair`` (``ops/contact.py``: ``pair.pack``, ``pair.law``,
``pair.reduce``), ``walls``, ``step.post``; ``run`` and ``run_inline``
are the host range ``spherharm.run``, and a check-mode step's wait on its
flag and launch of its second unit ``spherharm.trigger``.

The step also takes replicas stacked along a leading axis, with
``params`` stacked alike (``parallel/ensemble.py``, which drives it):
every op runs once over all replicas, and in check mode each replica
rebuilds exactly when its own trigger fires.
"""

from __future__ import annotations

import numpy as np
import torch

from spherharm_tpu_torch.core import runner as runner_mod
from spherharm_tpu_torch.core.state import (
    NeighborState,
    Shapes,
    SimParams,
    State,
    empty_neighbors,
    per_replica,
    take,
)
from spherharm_tpu_torch.ops import contact, integrate, neighbor
from spherharm_tpu_torch.ops import walls as walls_mod
from spherharm_tpu_torch.utils import spans


class Simulation:
    """Binds static configuration: capacities, cadence, walls, elastic
    law, box control, group fixes, device.

    ``conservative`` picks the elastic law: the exact gradient of the
    sampled PE (the default) or the geometric assembly. ``neighbor_mode``
    is "cell" (needs ``grid``), "allpairs" (O(N^2), small systems) or
    "static" (the allpairs list built once at setup and never rebuilt;
    ``rebuild_every`` is ignored). ``pair_capacity == 0`` evaluates
    contacts over the dense [N, K] tensor instead of a pair list.

    ``triclinic`` threads ``state.tilt`` through every geometric op (size
    the CellGrid with a tilt-inflated cutoff: binning runs in the
    unsheared frame). ``press_control`` runs the Berendsen servo after
    each step. ``gravity_pe_origin`` is the zero of thermo's pe_grav.
    ``group_fixes`` (LAMMPS ``fix freeze`` / ``fix setforce`` with NULL
    components) act last in ``compute_forces``; each entry is
    ("freeze", bit, (0, 0, 0), (0, 0, 0)) or ("setforce", bit, values3,
    keep3), keep marking NULL components, and a particle is a member when
    bit ``bit`` of ``group_tab[tag]`` is set.

    ``cuda_graphs`` (default on): on CUDA tensors, ``run`` and
    ``run_inline`` replay CUDA graphs of the step's units, captured at a
    Simulation's first run at a given state shape and kept; off, they run
    the step eagerly (a profile, a timing breakdown, the graph's own
    bit-equality check). CPU tensors always run eagerly."""

    def __init__(
        self,
        shapes: Shapes,
        params: SimParams,
        *,
        periodic=(False, False, False),
        neighbor_mode: str = "cell",
        k_max: int = 32,
        cell_cap: int = 8,
        grid: neighbor.CellGrid | None = None,
        walls: tuple = (),
        pair_capacity: int = 0,
        rebuild_chunk: int | None = None,
        rebuild_every: int = 0,
        wall_capacity: int = 0,
        stage2_capacity: int = 0,
        triclinic: bool = False,
        press_control: bool = False,
        conservative: bool = True,
        gravity_pe_origin=(0.0, 0.0, 0.0),
        group_fixes: tuple = (),
        group_tab=None,
        device="cuda",
        cuda_graphs: bool = True,
    ):
        if neighbor_mode not in ("cell", "allpairs", "static"):
            raise ValueError(f"unknown neighbor_mode {neighbor_mode!r}")
        if neighbor_mode == "cell" and grid is None:
            raise ValueError("neighbor_mode='cell' requires a CellGrid")
        if group_fixes and group_tab is None:
            raise ValueError("group_fixes requires group_tab")
        for kind, *_ in group_fixes:
            if kind not in ("freeze", "setforce"):
                raise ValueError(f"unknown group fix {kind!r}")
        self.shapes = shapes
        self.params = params
        self.grid = grid
        self.periodic = tuple(bool(p) for p in periodic)
        self.neighbor_mode = neighbor_mode
        self.k_max = int(k_max)
        self.cell_cap = int(cell_cap)
        self.walls = tuple(walls)
        self.pair_capacity = int(pair_capacity)
        # Chunking only bounds rebuild transients at large N: unchunked up
        # to pair_capacity ~1.5M, 262144-row chunks beyond.
        if rebuild_chunk is None:
            rebuild_chunk = 0 if self.pair_capacity <= 1_500_000 else 262144
        self.rebuild_chunk = int(rebuild_chunk)
        self.rebuild_every = int(rebuild_every)
        self.wall_capacity = int(wall_capacity)
        self.stage2_capacity = int(stage2_capacity)
        # Rebuild-time prefilter: the candidate list (pair_capacity) is
        # probed once per rebuild and compacted to stage2_capacity
        # near-contact pairs, the persistent per-step list.
        self.prefilter = self.stage2_capacity > 0 and self.pair_capacity > 0
        self.conservative = bool(conservative)
        self.triclinic = bool(triclinic)
        self.press_control = bool(press_control)
        self.device = torch.device(device)
        self.gravity_pe_origin = torch.as_tensor(
            gravity_pe_origin, dtype=params.dt.dtype, device=self.device)
        self.group_fixes = tuple(group_fixes)
        self.group_tab = None if group_tab is None else torch.as_tensor(
            np.array(group_tab, dtype=np.int64), device=self.device)
        # setforce's values and keep mask on the device once: a copy from
        # host memory on each step would synchronise.
        self._setforce = {
            i: (torch.as_tensor(vals, dtype=params.dt.dtype,
                                device=self.device),
                torch.as_tensor(keep, dtype=torch.bool, device=self.device))
            for i, (kind, _, vals, keep) in enumerate(self.group_fixes)
            if kind == "setforce"}
        self.cuda_graphs = bool(cuda_graphs)
        # GraphRunners by state signature, shared with shallow copies
        # (ensemble._rebind): see _runner.
        self._graphs = {}

    @property
    def pair_list_cap(self) -> int:
        return self.stage2_capacity if self.prefilter else self.pair_capacity

    def _tilt(self, state: State):
        return state.tilt if self.triclinic else None

    # -- neighbour handling ----------------------------------------------

    def _stale(self, state: State, neigh: NeighborState):
        """True (0-d bool tensor; [R] with replicas) when the lists may be
        incomplete: prefiltered list — some particle's surface motion
        exceeded its motion budget; plain candidate list — displacement
        beyond skin/2."""
        if self.prefilter:
            gmax_s = self.shapes.gmax[state.shtype] * state.scale
            ratio = neighbor.approach_ratio(
                state.x, neigh.x_build, state.q, neigh.q_build, gmax_s,
                neigh.budget, state.active, state.box_lo, state.box_hi,
                self.periodic, self._tilt(state))
            return ratio > 1.0
        disp2 = neighbor.max_displacement2(
            state.x, neigh.x_build, state.active, state.box_lo,
            state.box_hi, self.periodic, self._tilt(state))
        return disp2 > (0.5 * self.params.skin) ** 2

    def _build_list(self, state: State):
        cutoff = self.params.cutoff + self.params.skin
        if self.neighbor_mode in ("allpairs", "static"):
            idx, mask, count = neighbor.allpairs_neighbors(
                state.x, state.active, state.box_lo, state.box_hi, cutoff,
                self.k_max, self.periodic, self._tilt(state))
            mx = count.amax(-1)
            return idx, mask, torch.where(mx > self.k_max, mx,
                                          torch.zeros_like(mx))
        idx, mask, count, cell_ovf = neighbor.cell_list_neighbors(
            state.x, state.active, state.box_lo, state.box_hi, cutoff,
            self.grid.dims, self.cell_cap, self.k_max, self.periodic,
            self._tilt(state), row_chunk=self.rebuild_chunk)
        mx = count.amax(-1)
        zero = torch.zeros_like(mx)
        return idx, mask, torch.maximum(
            torch.where(mx > self.k_max, mx, zero),
            torch.where(cell_ovf > self.cell_cap, cell_ovf, zero))

    def _rebuild(self, state: State, neigh: NeighborState):
        with spans.span("rebuild", state.x.device):
            return self._rebuild_spanned(state, neigh)

    def _rebuild_spanned(self, state: State, neigh: NeighborState):
        dev = state.x.device
        x, image = neighbor.wrap_positions(
            state.x, state.image, state.box_lo, state.box_hi, self.periodic,
            self._tilt(state))
        state = state.replace(x=x, image=image)
        with spans.span("rebuild.cell_list", dev):
            idx, mask, overflow = self._build_list(state)
        with spans.span("rebuild.remap", dev):
            if self.pair_capacity > 0:
                # Live springs ride in pair space between rebuilds; fold
                # them back into the tag-keyed [N, K] layout to remap.
                neigh = neigh.replace(hist=contact.pair_hist_to_dense(neigh))
            neigh_tag = torch.where(mask, take(state.tag, idx, state.replicas),
                                    0)
            row_ok = neigh.row_tag == state.tag  # single device: slots stable
            hist = neighbor.remap_history(
                neigh_tag, mask, neigh.neigh_tag, neigh.mask, neigh.hist,
                row_ok)
        neigh = neigh.replace(
            idx=idx, mask=mask, hist=hist, neigh_tag=neigh_tag,
            row_tag=state.tag, x_build=state.x, q_build=state.q,
            overflow=torch.maximum(neigh.overflow, overflow))
        if self.pair_capacity <= 0:
            return state, neigh
        with spans.span("rebuild.pair_build", dev):
            pair_fields, n_pairs = contact.build_pair_list(
                state, self.shapes, self.params, idx, mask, hist,
                state.active, self.pair_capacity, self.periodic,
                tilt=self._tilt(state))
            zero = torch.zeros_like(n_pairs)
            overflow = torch.maximum(
                neigh.overflow,
                torch.where(n_pairs > self.pair_capacity, n_pairs, zero))
        if self.prefilter:
            with spans.span("rebuild.prefilter", dev):
                pair_fields, n_surv, budget = contact.prefilter_pair_list(
                    state, self.shapes, self.params, pair_fields,
                    self.stage2_capacity, self.k_max,
                    # Motion-budget horizon: the cadence, or an estimate
                    # when the skin trigger decides.
                    window_steps=self.rebuild_every or 16,
                    periodic=self.periodic, tilt=self._tilt(state),
                    probe_chunk=self.rebuild_chunk)
                overflow = torch.maximum(
                    overflow,
                    torch.where(n_surv > self.stage2_capacity, n_surv, zero))
            neigh = neigh.replace(budget=budget)
        return state, neigh.replace(overflow=overflow, **pair_fields)

    def init_neighbors(self, state: State) -> tuple[State, NeighborState]:
        """First build + setup force pass (the Verlet::setup analogue):
        forces are filled so the first half-kick integrates f(t0); the
        setup pass does not advance spring history. Replicas (with
        ``params`` stacked alike) each get their own lists."""
        neigh = empty_neighbors(
            state.cap, self.k_max, len(self.walls), dtype=state.x.dtype,
            pair_cap=self.pair_list_cap, device=state.x.device,
            replicas=state.x.shape[0] if state.replicas else 0)
        state, neigh = self._rebuild(state, neigh)
        hists0 = (neigh.hist, neigh.pair_hist, neigh.wall_hist)
        state, neigh, _ = self.compute_forces(state, neigh)
        neigh = neigh.replace(hist=hists0[0], pair_hist=hists0[1],
                              wall_hist=hists0[2])
        return state, neigh

    # -- forces -----------------------------------------------------------

    def compute_forces(self, state: State, neigh: NeighborState):
        """Fill f/tau; returns (state, neigh with updated springs, aux)."""
        dev = state.x.device
        with spans.span("pair", dev):
            if self.pair_capacity > 0:
                f, tau, pair_hist, pe_pair, virial = (
                    contact.contact_force_pairs(
                        state, self.shapes, self.params, neigh,
                        periodic=self.periodic, tilt=self._tilt(state),
                        conservative=self.conservative))
                neigh = neigh.replace(pair_hist=pair_hist)
            else:
                f, tau, hist, pe_pair, virial = contact.contact_force_dense(
                    state, self.shapes, self.params, neigh,
                    periodic=self.periodic, tilt=self._tilt(state),
                    conservative=self.conservative)
                neigh = neigh.replace(hist=hist)

        with spans.span("walls", dev):
            f, tau, neigh, pe_wall = self._wall_forces(state, neigh, f, tau)
        with spans.span("step.post", dev):
            state = self._body_forces(state, f, tau)
        return state, neigh, {"pe_pair": pe_pair, "pe_wall": pe_wall,
                              "virial": virial}

    def _wall_forces(self, state: State, neigh: NeighborState, f, tau):
        """Every wall's forces and torques added to (f, tau); returns (f,
        tau, neigh with the wall springs and overflow, pe_wall)."""
        pe_wall = torch.zeros((), dtype=f.dtype, device=f.device)
        wall_hists = []
        overflow = neigh.overflow
        for w_i, wall in enumerate(self.walls):
            wf, wt, whist, wpe, n_near = walls_mod.wall_contact(
                state, self.shapes, self.params, wall,
                neigh.wall_hist[..., w_i, :], wall_cap=self.wall_capacity)
            f = f + wf
            tau = tau + wt
            pe_wall = pe_wall + wpe.sum(-1)
            wall_hists.append(whist)
            if self.wall_capacity:
                overflow = torch.maximum(overflow, torch.where(
                    n_near > self.wall_capacity, n_near,
                    torch.zeros_like(n_near)))
        if wall_hists:
            neigh = neigh.replace(wall_hist=torch.stack(wall_hists, dim=-2))
        return f, tau, neigh.replace(overflow=overflow), pe_wall

    def _body_forces(self, state: State, f, tau) -> State:
        """Gravity, then the group fixes, on (f, tau): the state with
        them."""
        m = self.shapes.mass_of(state.shtype, state.scale)
        g = per_replica(self.params.gravity, 1, f.dim())
        f = f + torch.where(state.active[..., None], m[..., None] * g, 0.0)
        # Group fixes act last, after pair, wall and gravity forces (the
        # reference's post_force order: setforce overrides what summed).
        if self.group_fixes:
            bits = self.group_tab[torch.clamp(
                state.tag, 0, self.group_tab.shape[0] - 1)]
            for i, (kind, bit, _, _) in enumerate(self.group_fixes):
                mem3 = (state.active & ((bits & (1 << bit)) != 0))[..., None]
                if kind == "freeze":
                    f = torch.where(mem3, 0.0, f)
                    tau = torch.where(mem3, 0.0, tau)
                else:  # setforce
                    v, kp = self._setforce[i]
                    f = torch.where(mem3 & ~kp, v, f)
        return state.replace(f=f, tau=tau)

    # -- stepping ---------------------------------------------------------

    def _pre(self, state: State, neigh: NeighborState, check: bool):
        """The step's first unit: initial integrate, deformation and the
        tilt sentinel. Returns (state, neigh, stale): with ``check`` the
        skin trigger (``_stale``: 0-d, or [R] with replicas), else None."""
        with spans.span("step.pre", state.x.device):
            state, neigh = self._pre_spanned(state, neigh)
        if not check:
            return state, neigh, None
        with spans.span("step.trigger", state.x.device):
            return state, neigh, self._stale(state, neigh)

    def _pre_spanned(self, state: State, neigh: NeighborState):
        state = integrate.initial_integrate(state, self.shapes, self.params)
        state, x_build, _ = integrate.apply_deformation(
            state, neigh.x_build, self.params, self.periodic)
        neigh = neigh.replace(x_build=x_build)
        if self.triclinic:
            # A tilt past L/2 on an axis that cannot flip (not periodic)
            # breaks minimum_image's sequential image removal: fail
            # loudly through the overflow channel (sentinel 1 << 21).
            L = state.box_hi - state.box_lo
            bound = 0.5 * torch.stack([L[..., 0], L[..., 0], L[..., 1]],
                                      dim=-1)
            bad = (state.tilt.abs() > bound * (1 + 1e-6)).any(-1)
            neigh = neigh.replace(overflow=torch.maximum(
                neigh.overflow, torch.where(
                    bad, 1 << 21, torch.zeros_like(neigh.overflow))))
        return state, neigh

    def _rebuild_always(self, state: State, neigh: NeighborState):
        """A scheduled rebuild, recording (not branching on) a stale list
        in ``skin_violations``."""
        dev = state.x.device
        with spans.span("step.trigger", dev):
            viol = self._stale(state, neigh).long()
        state, neigh = self._rebuild(state, neigh)
        with spans.span("step.trigger", dev):
            return state, neigh.replace(
                skin_violations=neigh.skin_violations + viol)

    def _rebuild_stale(self, state: State, neigh: NeighborState, stale):
        """The skin trigger's rebuild, run when ``stale`` is set somewhere.
        With replicas it rebuilds all and keeps the rebuild for the stale
        replicas only (``stale`` [R]), so each rebuilds exactly when its
        own trigger fires: a per-replica select in place of the
        reference's lax.cond under vmap."""
        new_state, new_neigh = self._rebuild(state, neigh)
        if not stale.dim():
            return new_state, new_neigh
        with spans.span("step.trigger", state.x.device):
            return (_keep(stale, new_state, state),
                    _keep(stale, new_neigh, neigh))

    def _post(self, state: State, neigh: NeighborState):
        """The step's last unit: forces, final integrate, the servo."""
        state, neigh, aux = self.compute_forces(state, neigh)
        with spans.span("step.post", state.x.device):
            state = integrate.final_integrate(state, self.shapes, self.params)
            if self.press_control:
                state, x_build = integrate.berendsen_box_control(
                    state, neigh.x_build, self.params, aux["virial"],
                    self.shapes)
                neigh = neigh.replace(x_build=x_build)
        return state, neigh

    def _step_core(self, state: State, neigh: NeighborState, rebuild: str):
        """One velocity-Verlet step, eagerly. rebuild: 'always' (scheduled
        rebuild, first recording, not branching on, a stale list), 'check'
        (rebuild when the skin trigger fires; reads "any stale" on the
        host) or 'never'."""
        state, neigh, stale = self._pre(state, neigh, rebuild == "check")
        if rebuild == "always":
            state, neigh = self._rebuild_always(state, neigh)
        elif rebuild == "check" and bool(stale.any()):
            state, neigh = self._rebuild_stale(state, neigh, stale)
        return self._post(state, neigh)

    def step(self, state: State, neigh: NeighborState):
        """One step with the skin-triggered rebuild (none in static
        mode), eagerly."""
        return self._step_core(
            state, neigh, "never" if self.neighbor_mode == "static"
            else "check")

    def run(self, state: State, neigh: NeighborState, n_steps: int):
        """``n_steps`` steps. With ``rebuild_every = R > 0`` the static
        cadence (LAMMPS ``neigh_modify every R check no``): blocks of one
        rebuild step + R-1 plain steps, a remainder being a short block
        (one rebuild + rem-1 plain steps); skin violations are counted in
        ``neigh.skin_violations``. With R = 0, or in static mode,
        ``run_inline``: ``step`` n_steps times.

        On CUDA tensors (unless ``cuda_graphs`` is off) each step is a
        replay of a captured rebuild step or plain step, in that order;
        the returned containers are new tensors."""
        R = 0 if self.neighbor_mode == "static" else self.rebuild_every
        if R <= 0:
            return self.run_inline(state, neigh, n_steps)
        n_blocks, rem = divmod(n_steps, R)
        kinds = [("always" if k == 0 else "never")
                 for length in [R] * n_blocks + ([rem] if rem else [])
                 for k in range(length)]
        with spans.host("spherharm.run"):
            return self._run_kinds(state, neigh, kinds)

    def run_units(self, state: State, neigh: NeighborState, kinds,
                  events=None):
        """The units ``kinds`` (names of ``_units()``: "always", "never",
        "pre", "post", "rebuild_post") run in order from (state, neigh),
        each on the buffers the one before left: on CUDA tensors (unless
        ``cuda_graphs`` is off) replays of their graphs, captured at the
        first call; else eagerly. ``events``, a pair of CUDA events, is
        recorded around the replays alone (after the load of (state,
        neigh), before the copy of the result). Returns new (state,
        neigh)."""
        with spans.host("spherharm.run"):
            return self._run_kinds(state, neigh, list(kinds), events)

    def _run_kinds(self, state, neigh, kinds, events=None):
        if not self._graphed(state, len(kinds)):
            b = dict(state=state, neigh=neigh, params=self.params,
                     stale=torch.zeros(state.x.shape[:-2], dtype=torch.bool,
                                       device=state.x.device))
            units = self._units()
            for kind in kinds:
                out = units[kind](b)
                out.pop("flag", None)
                b.update(out)
            return b["state"], b["neigh"]
        runner = self._runner(state, neigh, tuple(dict.fromkeys(kinds)))
        if events:
            events[0].record()
        for kind in kinds:
            runner.replay(kind)
        if events:
            events[1].record()
        return runner.result("state", "neigh")

    def run_inline(self, state: State, neigh: NeighborState, n_steps: int):
        """``step`` n_steps times, whatever ``rebuild_every`` is: the
        reference's ``run_inline`` (what ``ensemble.run_replicas`` runs).

        On CUDA tensors (unless ``cuda_graphs`` is off) a step is two
        graph replays and one host read: ``_pre`` with the stale flag
        (reduced over replicas) copied to pinned memory; an event
        synchronisation and the read; then ``_post``, or ``_rebuild_stale``
        and ``_post`` as one graph when the flag is set. Static mode
        replays the plain step."""
        with spans.host("spherharm.run"):
            return self._run_inline(state, neigh, n_steps)

    def _run_inline(self, state: State, neigh: NeighborState, n_steps: int):
        if not self._graphed(state, n_steps):
            for _ in range(n_steps):
                state, neigh = self.step(state, neigh)
            return state, neigh
        if self.neighbor_mode == "static":
            runner = self._runner(state, neigh, ("never",))
            for _ in range(n_steps):
                runner.replay("never")
        else:
            runner = self._runner(state, neigh,
                                  ("pre", "post", "rebuild_post"))
            for _ in range(n_steps):
                runner.replay("pre")
                with spans.host("spherharm.trigger"):
                    runner.replay("rebuild_post" if runner.read_flag()
                                  else "post")
        return runner.result("state", "neigh")

    # -- CUDA graphs --------------------------------------------------------

    def _graphed(self, state: State, n_steps: int) -> bool:
        return self.cuda_graphs and state.x.is_cuda and n_steps > 0

    def _units(self):
        """The graph units, as functions of the runner's buffers (state,
        neigh, params, stale), run by a view of this Simulation that reads
        its params from the buffer."""
        view = runner_mod.params_view

        def step(kind):
            def unit(b):
                s, n = view(self, b)._step_core(b["state"], b["neigh"], kind)
                return {"state": s, "neigh": n}
            return unit

        def pre(b):
            s, n, stale = view(self, b)._pre(b["state"], b["neigh"],
                                             check=True)
            with spans.span("step.trigger", s.x.device):
                return {"state": s, "neigh": n, "stale": stale,
                        "flag": stale.any()}

        def post(b):
            s, n = view(self, b)._post(b["state"], b["neigh"])
            return {"state": s, "neigh": n}

        def rebuild_post(b):
            sim = view(self, b)
            s, n = sim._rebuild_stale(b["state"], b["neigh"], b["stale"])
            s, n = sim._post(s, n)
            return {"state": s, "neigh": n}

        return {"always": step("always"), "never": step("never"),
                "pre": pre, "post": post, "rebuild_post": rebuild_post}

    def _runner(self, state: State, neigh: NeighborState, names: tuple):
        """The GraphRunner for this state's signature with the units
        ``names`` captured, loaded with (state, neigh, params)
        (``runner.cached_runner``; the stale flags a scratch buffer)."""
        return runner_mod.cached_runner(
            self, dict(state=state, neigh=neigh, params=self.params), names,
            scratch=lambda: dict(stale=torch.zeros(
                state.x.shape[:-2], dtype=torch.bool,
                device=state.x.device)))

    def graph_stats(self) -> dict:
        """The cached runners' totals (``runner.graph_stats``)."""
        return runner_mod.graph_stats(self)

    # -- observables --------------------------------------------------------

    def thermo(self, state: State, neigh: NeighborState) -> dict:
        """LAMMPS-thermo-style scalars (0-d tensors; no host sync). With
        replicas each is one a replica ([R]; the stress tensor [R, 3, 3]):
        the counterpart of the reference's thermo under vmap."""
        shapes, params = self.shapes, self.params
        state, neigh, aux = self.compute_forces(state, neigh)
        ke_t, ke_r = integrate.kinetic_energy(state, shapes)
        m = shapes.mass_of(state.shtype, state.scale)
        rep = state.replicas
        pe_grav = -torch.where(
            state.active,
            m * (per_replica(params.gravity, 1, 3 if rep else 2)
                 * (state.x - self.gravity_pe_origin)).sum(-1),
            0.0).sum(-1)
        vol_box = torch.prod(state.box_hi - state.box_lo, dim=-1)
        kin = torch.einsum("rn,rna,rnb->rab" if rep else "n,na,nb->ab",
                           torch.where(state.active, m, 0.0), state.v,
                           state.v)
        stress = (kin + aux["virial"]) / vol_box[..., None, None]
        return {
            "step": state.step,
            "n": state.n_active,
            "ke": ke_t,
            "erot": ke_r,
            "pe_pair": aux["pe_pair"],
            "pe_wall": aux["pe_wall"],
            "pe_grav": pe_grav,
            "etot": ke_t + ke_r + aux["pe_pair"] + aux["pe_wall"] + pe_grav,
            "press": (torch.diagonal(stress, dim1=-2, dim2=-1).sum(-1) if rep
                      else torch.trace(stress)) / 3.0,
            "stress": stress,
            "neigh_overflow": neigh.overflow,
        }


def _keep(mask, new, old):
    """Field by field, ``new`` for the replicas where ``mask`` [R] is set,
    else ``old``."""
    return old.replace(**{
        f: torch.where(per_replica(mask, 0, getattr(old, f).dim()),
                       getattr(new, f), getattr(old, f))
        for f in old.__dataclass_fields__})
