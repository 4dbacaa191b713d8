"""Spans and counters inside the step (``utils/spans.py``), their reader
(``utils/timing.reduce_spans``, ``span_profile``, ``span_metrics``) and
``Simulation.run_units``.

CPU tests: spans off leave no trace; on, the host ranges nest as the
layers do; ``pair.live`` and ``pair.slots`` against an independent count;
the reducer on synthetic event lists; ``tools/span_cells.py`` on the
benchmark's cells at a tiny size; the marker kernels' list against
``spans.SPANS``. ``cuda``-marked tests (skipped without a card): the marks
replay inside the graphs; ``run_units``' events time the replays alone;
a spans-off runner launches, counts and holds
what one captured before spans were ever on does; the marks' library is
not loaded until spans are on. This file imports no JAX:

    python -m pytest tests/test_torch_spans.py --noconftest -q
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from spherharm_tpu_torch.models import scenarios
from spherharm_tpu_torch.ops import cuda_build
from spherharm_tpu_torch.utils import spans, timing
from spherharm_tpu_torch.utils.timing import Event

from torch_port_util import cuda_device, drum_state  # noqa: F401

LAYERS = ("step.pre", "step.trigger", "rebuild", "pair", "walls",
          "step.post")


@pytest.fixture(autouse=True)
def _spans_off():
    """Every test starts and ends with spans off and counters at zero."""
    spans.enabled(False)
    spans.reset()
    yield
    spans.enabled(False)
    spans.reset()


def _drum(device, rebuild_every=10, n=64, lmax=2, **kw):
    """The small prefiltered drum from its contact-rich start."""
    sim, st0, _ = scenarios.rotating_drum(
        n=n, lmax=lmax, k_max=16, pair_capacity=5 * n,
        stage2_capacity=3 * n, rebuild_every=rebuild_every, device=device,
        **kw)
    return (sim,) + sim.init_neighbors(drum_state(sim, st0, device))


def _box():
    """The n = 27 settling box: the dense [N, K] path, five plane walls."""
    sim, st0, _ = scenarios.settling_box(n=27, device="cpu")
    return (sim,) + sim.init_neighbors(st0)


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return timing.kineto_events(prof)


def _inside(inner, outer):
    return outer.start <= inner.start and inner.end <= outer.end


# -- spans off and on, on the CPU ------------------------------------------

def test_spans_off_leave_no_trace():
    """Off (the default), a profiled run shows no span and no
    ``spherharm.*`` range, and no counter counts; ``span`` hands back the
    one shared null context."""
    sim, st, ng = _drum("cpu")
    names = {e.name for e in _profiled(lambda: sim.run(st, ng, 12))}
    assert not {n for n in names if n.startswith("spherharm")}
    assert not names & set(spans.SPANS)
    assert spans.counters() == {}
    assert spans.span("pair", torch.device("cpu")) is spans.span(
        "walls", torch.device("cpu"))


def test_enabled_is_a_setter_and_a_context_manager():
    with spans.enabled(True):
        assert spans.is_on()
        with spans.enabled(False):
            assert not spans.is_on()
        assert spans.is_on()
    assert not spans.is_on()
    spans.enabled(True)
    assert spans.is_on()
    spans.count("x", 3)
    spans.count("y", torch.tensor([True, False, True]))
    assert spans.counters() == {"x": 3, "y": 2}
    spans.reset()
    assert spans.counters() == {}


NEST_CASES = ["cadence", "check", "dense"]


@pytest.mark.parametrize("case", NEST_CASES)
def test_host_spans_nest_as_the_layers(case):
    """With spans on, a CPU run's host ranges nest as the step's layers:
    the layers inside ``spherharm.run`` and in no other layer, the
    rebuild's and the pair forces' stages inside ``rebuild`` and ``pair``
    (the drum at cadence 10, the drum's skin trigger, the box's dense
    path)."""
    if case == "dense":
        sim, st, ng = _box()
    else:
        sim, st, ng = _drum("cpu", 10 if case == "cadence" else 0)
    steps = 12
    with spans.enabled(True):
        events = _profiled(lambda: sim.run(st, ng, steps))
    runs = [e for e in events if e.name == "spherharm.run"]
    assert len(runs) == 1
    by = lambda n: [e for e in events if e.name == n]
    assert len(by("pair")) == len(by("step.pre")) == steps
    assert len(by("step.post")) == 2 * steps
    assert len(by("walls")) == steps
    assert by("rebuild") if case == "cadence" else True
    for name in LAYERS:
        for e in by(name):
            assert _inside(e, runs[0]), name
            assert not any(_inside(e, o) for o in events
                           if o.name in LAYERS and o is not e), name
    for parent, stages in (("rebuild", ("rebuild.cell_list", "rebuild.remap",
                                        "rebuild.pair_build",
                                        "rebuild.prefilter")),
                           ("pair", ("pair.pack", "pair.law",
                                     "pair.reduce"))):
        for name in stages:
            for e in by(name):
                assert any(_inside(e, p) for p in by(parent)), name
    assert by("pair.pack") and by("pair.law") and by("pair.reduce")


@pytest.mark.parametrize("case", ["pairs", "dense"])
def test_pair_counters_count_live_rows(case):
    """``pair.live`` is the sum over the steps of the rows the law runs
    for (``pair_valid`` with both ends active: here five particles are
    switched off, so the list holds rows the law skips until a rebuild),
    and ``pair.slots`` the slots packed a step times the steps: the drum's
    pair list under its skin trigger, the box's dense [N, K] rows."""
    sim, st, ng = _box() if case == "dense" else _drum("cpu", 0)
    off = torch.zeros_like(st.active)
    off[[1, 5, 9, 13, 20]] = True
    st = st.replace(active=st.active & ~off)
    steps = 6
    live, s, n = 0, st, ng
    for _ in range(steps):
        s, n = sim.run(s, n, 1)
        if case == "dense":
            ok = n.mask & s.active[:, None] & s.active[n.idx]
        else:
            ok = n.pair_valid & s.active[n.pair_i] & s.active[n.pair_j]
        live += int(ok.sum())
    slots = n.mask.numel() if case == "dense" else n.pair_i.numel()
    with spans.enabled(True):
        sim.run(st, ng, steps)
    got = spans.counters()
    assert got == {"pair.slots": slots * steps, "pair.live": live}
    assert 0 < live < slots * steps


def test_run_units_equals_run():
    """``run_units`` of a cadence block's units equals ``run`` of the
    block bit for bit, and leaves its inputs as they were."""
    sim, st, ng = _drum("cpu", 10)
    keep = st.x.clone()
    a = sim.run(st, ng, 10)
    b = sim.run_units(st, ng, ["always"] + ["never"] * 9)
    for x, y in zip(a, b):
        for f in x.__dataclass_fields__:
            assert torch.equal(getattr(x, f), getattr(y, f)), f
    assert torch.equal(st.x, keep)
    pre_post = sim.run_units(st, ng, ("pre", "post"))
    assert torch.equal(pre_post[0].x, sim.step(st, ng)[0].x)


# -- the reducer on synthetic events ---------------------------------------

def _mark(t, name, end, stream=7):
    return Event(t, t + 1, spans.mark_symbol(name, end), True, stream)


def _op(t0, t1, name="k", stream=7):
    return Event(t0, t1, name, True, stream)


def test_reduce_spans_marks_nesting_and_self_time():
    """Each operation adds to every span open on its stream and to the
    innermost one's self time; one in no span is ``outside_s``; marks are
    counted apart from the operations."""
    ev = [Event(0, 1000, timing.WINDOW, False, 0),
          _mark(10, "pair", False), _mark(12, "pair.pack", False),
          _op(20, 120, "gather"), _mark(121, "pair.pack", True),
          _mark(123, "pair.law", False), _op(130, 430, "K1"),
          _mark(431, "pair.law", True), _op(440, 460, "cat"),
          _mark(461, "pair", True), _op(500, 540, "copy"),
          _op(2000, 2100, "after the window")]
    r = timing.reduce_spans(ev)
    ns = 1e-9
    assert r["span_s"] == pytest.approx(
        {"pair": 420 * ns, "pair.pack": 100 * ns, "pair.law": 300 * ns})
    assert r["self_s"] == pytest.approx(
        {"pair": 20 * ns, "pair.pack": 100 * ns, "pair.law": 300 * ns})
    assert r["spans_n"] == {"pair": 1, "pair.pack": 1, "pair.law": 1}
    assert {k: {o: round(t / ns) for o, t in v.items()}
            for k, v in r["self_ops"].items()} == {
        "pair": {"cat": 20}, "pair.pack": {"gather": 100},
        "pair.law": {"K1": 300}, "": {"copy": 40}}
    assert r["outside_s"] == pytest.approx(40 * ns)
    assert r["ops_s"] == pytest.approx(460 * ns)
    assert r["coverage"] == pytest.approx(420 / 460)
    assert (r["marks"], r["unmatched"]) == (6, 0)
    assert r["marks_s"] == pytest.approx(6 * ns)
    assert r["window_s"] == pytest.approx(1000 * ns)


def test_reduce_spans_takes_device_events_by_their_launch():
    """A device event belongs to the window when the host call that
    launched it does, whatever its own time on the device's clock; one
    with no launch linked is taken by its time."""
    ev = [Event(100, 200, timing.WINDOW, False, 0),
          _op(90, 95, "launched inside, timed before")._replace(launch=120),
          _op(150, 160, "launched before")._replace(launch=50),
          _op(205, 230, "launched inside, timed after")._replace(launch=190),
          _op(170, 180, "no launch linked")]
    r = timing.reduce_spans(ev)
    assert r["ops_s"] == pytest.approx(40e-9)
    assert r["self_ops"][""] == pytest.approx({
        "launched inside, timed before": 5e-9,
        "launched inside, timed after": 25e-9, "no launch linked": 10e-9})
    assert r["clipped"] == 1


def test_reduce_spans_streams_and_unmatched_ends():
    """Streams keep their own stacks; an end with no open span is counted
    and changes nothing; an end closes every span opened inside it."""
    ev = [_mark(0, "rebuild", False), _mark(2, "rebuild.remap", False),
          _op(5, 15, "on 7"), _op(6, 16, "on 9", stream=9),
          _mark(20, "walls", True), _mark(22, "rebuild", True),
          _op(30, 40, "after")]
    r = timing.reduce_spans(ev)
    assert r["span_s"] == pytest.approx({"rebuild": 10e-9,
                                         "rebuild.remap": 10e-9})
    assert r["outside_s"] == pytest.approx(20e-9)
    assert r["unmatched"] == 1


def test_reduce_spans_idle_under_the_trigger():
    """Each gap between device operations is timed on the device's clock
    and put down to the ``spherharm.*`` ranges over the launch call of the
    operation after it, however far the device's clock is from the
    host's: the trigger's wait and launch under ``spherharm.trigger`` (and
    its ``spherharm.replay.post``); a gap between the operations of one
    launch apart."""
    host = lambda t0, t1, name: Event(t0, t1, name, False, 0)
    dev = lambda t0, t1, name, launch: _op(5000 + t0, 5000 + t1,
                                           name)._replace(launch=launch)
    ev = [host(0, 1000, timing.WINDOW), host(0, 1000, "spherharm.run"),
          host(0, 50, "spherharm.replay.pre"),
          host(90, 300, "spherharm.trigger"),
          host(200, 300, "spherharm.replay.post"),
          host(380, 420, "spherharm.replay.pre"),
          dev(20, 100, "pre", 10), dev(100, 120, "pre", 10),
          dev(230, 250, "post", 210),  # gap 120-230: the wait and launch
          dev(260, 900, "post", 210),  # gap 250-260: inside one launch
          dev(950, 990, "pre", 400)]   # gap 900-950: the next step's launch
    r = timing.reduce_spans(ev)
    assert r["busy_s"] == pytest.approx(800e-9)
    assert r["idle_s"] == pytest.approx({
        "spherharm.run": 160e-9, "spherharm.trigger": 110e-9,
        "spherharm.replay.post": 110e-9, "spherharm.replay.pre": 50e-9,
        timing.INSIDE: 10e-9})
    assert r["idle_inner_s"] == pytest.approx({
        "spherharm.replay.post": 110e-9, "spherharm.replay.pre": 50e-9,
        timing.INSIDE: 10e-9})
    m = timing.span_metrics(dict(r, counters={}), steps=1)
    assert m["trigger_idle_ms_per_step"] == pytest.approx(110e-6)


@pytest.mark.parametrize("clock", ["device", "host"])
def test_span_metrics_on_a_synthetic_profile(clock):
    """``span_metrics``: pack time a step, rebuild time a rebuild, idle
    under the trigger a step, live rows over slots; on the device's clock
    where the profile has device operations, else on the host's."""
    times = {"pair.pack": 0.02, "rebuild": 0.015}
    counts = {"rebuild": 5, "pair.pack": 10}
    summary = dict(ops_s=1.0 if clock == "device" else 0.0,
                   span_s=times if clock == "device" else {},
                   self_s={}, spans_n=counts if clock == "device" else {},
                   host_s=times if clock == "host" else {},
                   host_n=counts if clock == "host" else {},
                   idle_s={"spherharm.trigger": 0.004},
                   counters={"pair.slots": 1_200_000 * 10,
                             "pair.live": 3_000_000})
    m = timing.span_metrics(summary, steps=10)
    assert m == pytest.approx(dict(pack_ms_per_step=2.0, rebuild_ms=3.0,
                                   trigger_idle_ms_per_step=0.4,
                                   pair_live_pct=25.0))
    summary.update(counters={}, spans_n={}, host_n={})
    m = timing.span_metrics(summary, steps=10)
    assert m["rebuild_ms"] is None and m["pair_live_pct"] is None
    assert m["pack_ms_per_step"] is None


def test_span_profile_on_the_cpu():
    """``span_profile`` on the CPU: host ranges only, no device time, the
    counters of the profiled call alone (the warm call's reset away)."""
    sim, st, ng = _drum("cpu", 10)
    _, r = timing.span_profile(lambda: sim.run(st, ng, 10))
    assert r["ops_s"] == 0 and r["coverage"] is None and r["marks"] == 0
    assert r["host_n"]["pair"] == 10 and r["host_n"]["rebuild"] == 1
    assert r["counters"]["pair.slots"] == 10 * sim.pair_list_cap
    assert not spans.is_on()


@pytest.mark.parametrize("workload,overrides,traffic", [
    ("drum.bed", {"n": 300, "lmax": 2, "contact_quad": [4, 8]},
     {"warmup_steps": 10, "block_steps": 10, "trace_steps": 10}),
    ("triaxial.shear", {"n": 512}, {"block_steps": 10, "trace_steps": 10})])
def test_span_cells_reads_a_cell_at_tiny_size(workload, overrides, traffic):
    """``tools/span_cells.py`` on a benchmark cell cut to a tiny size, on
    the CPU: each step opens the step's layers once, the drum's slice
    holds its rebuild, and the live share of the counters is the pair
    list's at the slice's ends."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "span_cells", root / "tools" / "span_cells.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    r = tool.cell_spans(workload, 2 ** 33 + 7, 0.05, 1, "cpu", overrides,
                        traffic)
    steps = traffic["trace_steps"]
    assert r["clock"] == "host" and r["steps"] == steps
    for name in ("step.pre", "pair", "pair.pack", "walls"):
        assert r["spans_n"][name] == steps, name
    drum = workload == "drum.bed"
    assert r["spans_n"]["step.trigger"] == (2 if drum else steps)
    assert bool(r["rebuild_stage_ms"]) == drum
    (m,) = r["metrics"]
    assert r["counters"]["pair.live"] <= r["counters"]["pair.slots"]
    assert m["pair_live_pct"] == pytest.approx(r["evidence_live_pct"],
                                               abs=2.0)
    assert not spans.is_on()


def test_marks_source_lists_every_span():
    """csrc/span_marks.cu's SPAN_LIST is ``spans.SPANS`` in order, and its
    symbols are ``spans.mark_symbol``'s."""
    src = (cuda_build.CSRC / "span_marks.cu").read_text()
    block = src[src.index("#define SPAN_LIST"):src.index("#define SPAN_KERNELS")]
    assert re.findall(r"X\((\w+)\)", block) == [
        n.replace(".", "_") for n in spans.SPANS]
    assert "spherharm_span__##s##__begin()" in src
    assert spans.mark_symbol("pair.pack", False) == \
        "spherharm_span__pair_pack__begin"
    assert cuda_build.SPAN_SOURCES == ("span_marks.cu",)
    assert "span_marks.cu" not in cuda_build.SOURCES


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cadence", "check"])
def test_marks_replay_inside_graphs(case, cuda_device):
    """With spans on, the marker kernels replay inside the graphs: every
    device operation of the run lies in a span, each step opens one
    ``pair`` span, the trigger's wait is idle time under its host range,
    the counters count, and the run's result is the spans-off run's bit
    for bit, from a runner of its own (the drum at cadence 20, and under
    its skin trigger)."""
    sim, st, ng = _drum(cuda_device, 20 if case == "cadence" else 0, n=128,
                        lmax=4)
    steps = 25
    plain = sim.run(st, ng, steps)
    marked, r = timing.span_profile(lambda: sim.run(st, ng, steps))
    for x, y in zip(plain, marked):
        for f in x.__dataclass_fields__:
            assert torch.equal(getattr(x, f), getattr(y, f)), f
    assert r["marks"] > 0 and r["unmatched"] == 0
    assert r["outside_s"] == 0, r["self_ops"].get("")
    assert r["coverage"] == 1.0
    assert r["spans_n"]["pair"] == steps
    assert r["spans_n"]["runner.store"] >= steps
    assert r["counters"]["pair.slots"] == steps * sim.pair_list_cap
    assert r["counters"]["pair.live"] > 0
    if case == "cadence":
        assert r["spans_n"]["rebuild"] == 2
    else:
        assert r["idle_s"].get("spherharm.trigger", 0) > 0
    assert sim.graph_stats()["runners"] == 2


@pytest.mark.cuda
def test_run_units_events_time_the_replays_alone(cuda_device):
    """``run_units``'s events lie around the replays, inside a pair
    recorded around the whole call (with the load and the result's
    copy), and the result is the run's."""
    sim, st, ng = _drum(cuda_device, 20, n=128, lmax=4)
    kinds = ["always"] + ["never"] * 19
    plain = sim.run(st, ng, 20)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    got = sim.run_units(st, ng, kinds, events=(ev[1], ev[2]))
    ev[3].record()
    ev[3].synchronize()
    assert 0 < ev[1].elapsed_time(ev[2]) < ev[0].elapsed_time(ev[3])
    assert torch.equal(got[0].x, plain[0].x)


@pytest.mark.cuda
def test_pair_live_on_the_card(cuda_device):
    """On the card ``pair.live`` (summed inside the graphs) equals the
    count of live rows over the steps, step by step from the run's own
    lists (the skin trigger's, one step a run)."""
    sim, st, ng = _drum(cuda_device, 0, n=128, lmax=4)
    steps = 8
    live, s, n = 0, st, ng
    for _ in range(steps):
        s, n = sim.run(s, n, 1)
        live += int((n.pair_valid & s.active[n.pair_i]
                     & s.active[n.pair_j]).sum())
    with spans.enabled(True):
        sim.run(st, ng, 1)  # captures the spans-on graphs
        spans.reset()
        sim.run(st, ng, steps)
    assert spans.counters() == {"pair.slots": steps * sim.pair_list_cap,
                                "pair.live": live}


FRESH = r"""
import collections, json, sys
import torch
from spherharm_tpu_torch.models import scenarios
from spherharm_tpu_torch.ops import cuda_build
from spherharm_tpu_torch.core import runner as runner_mod
from spherharm_tpu_torch.utils import spans, timing

def drum():
    sim, st0, _ = scenarios.rotating_drum(
        n=128, lmax=4, k_max=24, pair_capacity=640, stage2_capacity=384,
        rebuild_every=20, device="cuda")
    return (sim,) + sim.init_neighbors(st0)

def launched(sim, st, ng):
    before = runner_mod.launch_counts()
    _, events = timing.profiled(lambda: sim.run(st, ng, 25))
    w = [e for e in events if e.name == timing.WINDOW][0]
    kernels = collections.Counter(
        e.name for e in events
        if e.device and w.start <= e.start and e.end <= w.end)
    return ({k: v - before[k] for k, v in runner_mod.launch_counts().items()},
            dict(kernels))

out = {}
# Another drum's capture first, so that neither drum below is the process's
# first capture (which also takes cuBLAS's workspace for the capture
# stream into its pool); "after" runs it with spans on.
other = drum()
with spans.enabled(sys.argv[1] == "after"):
    other[0].run(*other[1:], 25)
sim, st, ng = drum()
sim.run(st, ng, 25)
out["pool"] = sim.graph_stats()["pool_bytes"]
out["counts"], out["kernels"] = launched(sim, st, ng)
out["loaded"] = cuda_build.span_library.cache_info().currsize
if sys.argv[1] == "never":
    with spans.enabled(True):
        out["loaded_on"] = cuda_build.span_library.cache_info().currsize
        sim.run(st, ng, 25)
    out["runners"] = sim.graph_stats()["runners"]
    off = [r for k, r in sim._graphs.items() if not k[0]]
    out["pool_after"] = off[0].pool_bytes()
    out["counts_after"], out["kernels_after"] = launched(sim, st, ng)
print("FRESH " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def fresh_process():
    """Two new processes (``FRESH``), each running another drum before
    its drum's spans-off run: "never", with spans never on before that
    run, then on for one run and off again; "after", with the other drum
    run with spans on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    root = Path(__file__).resolve().parents[1]
    out = {}
    for mode in ("never", "after"):
        p = subprocess.run([sys.executable, "-c", FRESH, mode], cwd=root,
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-4000:]
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("FRESH ")]
        out[mode] = json.loads(line[-1][len("FRESH "):])
    return out


@pytest.mark.cuda
def test_spans_off_runner_is_untouched_by_spans(fresh_process):
    """A spans-off runner launches the same kernels, counts the same
    launches and holds the same pool after spans were on as before (spans
    on kept a runner of their own), and so does one captured after spans
    were on, as one captured where they never were."""
    never, after = fresh_process["never"], fresh_process["after"]
    assert never["runners"] == 2
    for run in (never["kernels_after"], after["kernels"]):
        assert not any(k.startswith(spans.MARK_PREFIX) for k in run)
    pools = (never["pool"], never["pool_after"], after["pool"])
    assert len(set(pools)) == 1, pools
    assert never["counts_after"] == never["counts"] == after["counts"]
    assert never["kernels_after"] == never["kernels"] == after["kernels"]


@pytest.mark.cuda
def test_marks_library_loads_only_when_spans_go_on(fresh_process):
    """The marks' library is neither built nor loaded by a spans-off run,
    and is loaded when spans are switched on."""
    never = fresh_process["never"]
    assert (never["loaded"], never["loaded_on"]) == (0, 1)
