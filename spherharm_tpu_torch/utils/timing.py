"""Profiles of the port (torch twin of ``spherharm_tpu/utils/timing.py``'s
tracing): ``trace`` writes a ``torch.profiler`` Chrome trace, and
``span_profile`` / ``reduce_spans`` read the spans of ``utils/spans``
out of one.

``reduce_spans`` takes a profile's events. Kineto puts CUPTI's device
timestamps and the host's on one time base, but the two clocks of a
profile have been seen to disagree by up to 2 ms, so no device time is
compared with a host time: each device event is tied to the host call
that launched it (its correlation id).

* Each device operation lies in the spans whose marker kernels
  (``spans.mark_symbol``) opened and have not closed on its stream: it
  adds to each of those spans' total and to the innermost one's self
  time, or to ``outside_s`` where none is open;
* each gap between device operations (the union of their intervals) is
  idle time, timed on the device's clock alone. It is put down to what
  the device waited for: the host call that launched the operation after
  it. A gap between operations of one launch call (the kernels of one
  graph replay) is ``INSIDE``'s; any other goes to every ``spherharm.*``
  host range over that launch call (``idle_s``) and to the innermost of
  them (``idle_inner_s``). Host ranges and launch calls share the host's
  clock, so the two clocks are never compared;
* host ranges of the device spans' names are timed too (``host_s``): on
  the CPU a span is a host range alone, and they are its times.

These are measurement tools, not a benchmark.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from pathlib import Path

import torch

from spherharm_tpu_torch.utils import spans

# Default trace directory: build/ beside the package (listed in
# .gitignore).
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "spherharm_trace"
# The host range around a profiled call (``span_profile``).
WINDOW = "span_profile.window"
HOST_PREFIX = "spherharm."
# Idle time between operations of one launch call (``reduce_spans``).
INSIDE = "inside one launch"

# start and end in ns on the profile's clock; device: on a card; stream:
# the device stream (0 on the host); launch: a device event's host launch
# call's start (None where the profile links none).
Event = collections.namedtuple("Event", "start end name device stream launch",
                               defaults=(None,))

_MARKS = {spans.mark_symbol(n, end): (n, end)
          for n in spans.SPANS for end in (False, True)}
_SPAN_NAMES = frozenset(spans.SPANS)


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


def kineto_events(prof) -> list:
    """A finished profile's events as ``Event``s, each device event with
    the start of the host call that launched it (by correlation id). The
    device's copies of host ranges (user annotations on the device) are
    left out."""
    from torch.autograd import DeviceType

    evs = list(prof.profiler.kineto_results.events())
    calls = {ev.correlation_id(): int(ev.start_ns()) for ev in evs
             if ev.device_type() != DeviceType.CUDA and ev.correlation_id()}
    out = []
    for ev in evs:
        on_dev = ev.device_type() == DeviceType.CUDA
        if on_dev and ev.is_user_annotation():
            continue
        s = int(ev.start_ns())
        launch = (calls.get(ev.linked_correlation_id() or ev.correlation_id())
                  if on_dev else None)
        out.append(Event(s, s + int(ev.duration_ns()), ev.name(), on_dev,
                         int(ev.device_resource_id()) if on_dev else 0,
                         launch))
    return out


def _device_spans(dev):
    """Walks the device events in time order, each stream its own stack
    of open spans. Returns (span_s, self_s, spans_n, self_ops, outside_s,
    ops_s, marks_s, marks, unmatched); seconds."""
    span_s, self_s, spans_n = (collections.Counter() for _ in range(3))
    self_ops = collections.defaultdict(collections.Counter)
    outside = ops = marks_ns = 0
    marks = unmatched = 0
    stacks = collections.defaultdict(list)
    for ev in dev:
        dur = ev.end - ev.start
        stack = stacks[ev.stream]
        mark = _MARKS.get(ev.name)
        if mark is not None:
            marks += 1
            marks_ns += dur
            name, end = mark
            if not end:
                stack.append(name)
                spans_n[name] += 1
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name):]
            else:
                unmatched += 1
            continue
        ops += dur
        inner = stack[-1] if stack else ""
        self_ops[inner][ev.name] += dur * 1e-9
        if not stack:
            outside += dur
            continue
        for name in set(stack):
            span_s[name] += dur * 1e-9
        self_s[inner] += dur * 1e-9
    return (dict(span_s), dict(self_s), dict(spans_n),
            {k: dict(v) for k, v in self_ops.items()}, outside * 1e-9,
            ops * 1e-9, marks_ns * 1e-9, marks, unmatched)


def _gaps(dev):
    """(busy seconds, the gaps of the union of ``dev``'s intervals between
    the first operation's start and the last one's end): each gap
    (seconds, the event that ends the union before it, the event after
    it). The device's clock alone."""
    busy, gaps, cur_s, cur_e, last = 0, [], None, None, None
    for ev in dev:
        if cur_s is None or ev.start > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
                gaps.append(((ev.start - cur_e) * 1e-9, last, ev))
            cur_s, cur_e, last = ev.start, ev.end, ev
        elif ev.end > cur_e:
            cur_e, last = ev.end, ev
    if cur_s is not None:
        busy += cur_e - cur_s
    return busy * 1e-9, gaps


def _launch(ev):
    """A device event's launch call's start (its own start where the
    profile links none)."""
    return ev.start if ev.launch is None else ev.launch


def _idle(gaps, host):
    """Idle seconds by what the device waited for (see the module
    docstring): (by every ``spherharm.*`` range over the launch of the
    operation after the gap, by the innermost; ``INSIDE`` for a gap inside
    one launch's operations, "" where no range is)."""
    ranges = sorted((h for h in host if h.name.startswith(HOST_PREFIX)),
                    key=lambda h: h.start)
    starts = [h.start for h in ranges]
    every, inner = collections.Counter(), collections.Counter()
    timed = []
    for sec, before, after in gaps:
        if before.launch is not None and before.launch == after.launch:
            every[INSIDE] += sec
            inner[INSIDE] += sec
        else:
            timed.append((_launch(after), sec))
    open_, k = [], 0
    for at, sec in sorted(timed):
        k2 = bisect.bisect_right(starts, at)
        open_.extend(ranges[k:k2])
        k = k2
        open_ = [h for h in open_ if h.end >= at]
        for name in {h.name for h in open_}:
            every[name] += sec
        inner[min(open_, key=lambda h: h.end - h.start).name
              if open_ else ""] += sec
    return dict(every), dict(inner)


def reduce_spans(events) -> dict:
    """The spans of a profile's ``Event``s inside its ``WINDOW`` host range
    (all of them where there is none; a device event by its launch call
    where the profile links one); seconds throughout.

    ``window_s`` (the host range's length), ``busy_s`` (the union of
    the device events, which the idle gaps lie between), ``ops_s``
    (device operations, marks left out), ``marks_s`` and ``marks`` (the
    marker kernels' time and count), ``span_s`` and ``self_s`` (device
    time in each span, and in it as the innermost), ``spans_n`` (times
    each span opened on the device), ``self_ops`` (the self time of each
    span by operation name; "" for no span), ``outside_s`` (device
    operations in no span), ``coverage`` (the share of ``ops_s`` in some
    span; None without device operations), ``unmatched`` (ends of spans
    not open), ``clipped`` (device events left out as outside the
    window),
    ``idle_s`` / ``idle_inner_s`` (gaps by what the device waited for,
    see the module docstring), ``host_s`` / ``host_n`` (host ranges of
    the device spans' names: time and count)."""
    win = [e for e in events if not e.device and e.name == WINDOW]
    if win:
        w0, w1 = win[0].start, win[0].end
    else:
        w0 = min((e.start for e in events), default=0)
        w1 = max((e.end for e in events), default=0)
    # A device event is the window's when its launch call is.
    inside = lambda e: (w0 <= e.launch <= w1 if e.launch is not None
                        else e.end > w0 and e.start < w1)
    dev = sorted((e for e in events if e.device and inside(e)),
                 key=lambda e: (e.start, e.end))
    clipped = sum(e.device for e in events) - len(dev)
    host = [e for e in events if not e.device and e.end > w0 and e.start < w1]
    (span_s, self_s, spans_n, self_ops, outside, ops, marks_s, marks,
     unmatched) = _device_spans(dev)
    busy, gaps = _gaps(dev)
    idle, idle_inner = _idle(gaps, host) if dev else ({}, {})
    host_s, host_n = collections.Counter(), collections.Counter()
    for h in host:
        if h.name in _SPAN_NAMES:
            host_s[h.name] += (h.end - h.start) * 1e-9
            host_n[h.name] += 1
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy, ops_s=ops,
                marks_s=marks_s, marks=marks, span_s=span_s, self_s=self_s,
                spans_n=spans_n, self_ops=self_ops, outside_s=outside,
                coverage=1.0 - outside / ops if ops > 0 else None,
                unmatched=unmatched, clipped=clipped, idle_s=idle,
                idle_inner_s=idle_inner,
                host_s=dict(host_s), host_n=dict(host_n))


def _settle(cuda: bool):
    """Device work, a synchronisation and a pause outside the window: the
    device's tracer has been seen to drop the first and last few
    operations of a profile."""
    if cuda:
        x = torch.zeros(1, device="cuda")
        for _ in range(16):
            x.add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)


def profiled(fn):
    """``fn()`` under torch.profiler (CPU and, where there is a card,
    CUDA activity), inside the ``WINDOW`` host range that ends after a
    synchronisation, with ``_settle`` before and after it. Returns (fn's
    result, the profile's ``Event``s)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        _settle(cuda)
        with record_function(WINDOW):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
        _settle(cuda)
    return out, kineto_events(prof)


def span_profile(fn):
    """``fn()`` with spans on, ``profiled``, after one call of it with
    spans on outside the profile (it captures the spans-on graphs) and
    the counters reset. ``fn`` should leave its inputs as
    they were (``Simulation.run`` does). Returns (the profiled call's
    result, ``reduce_spans`` of its profile with ``counters``:
    ``spans.counters()`` after it)."""
    with spans.enabled(True):
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        spans.reset()
        out, events = profiled(fn)
        counts = spans.counters()
    summary = reduce_spans(events)
    summary["counters"] = counts
    return out, summary


def span_times(summary):
    """(seconds by span, self seconds by span or None, times each span
    opened, the clock): the device's where the profile has device
    operations, else the host ranges' (the CPU)."""
    if summary["ops_s"] > 0:
        return (summary["span_s"], summary["self_s"], summary["spans_n"],
                "device")
    return summary["host_s"], None, summary["host_n"], "host"


def span_metrics(summary, steps: int) -> dict:
    """The per-layer numbers of a ``span_profile`` of ``steps`` steps, on
    its clock (``span_times``): ``pack_ms_per_step`` (time in
    ``pair.pack`` a step: a span the tracer lost does not count),
    ``rebuild_ms`` (time in ``rebuild`` a rebuild; None without one),
    ``trigger_idle_ms_per_step`` (idle time before operations launched
    under ``spherharm.trigger``, a step: the device's wait for the flag's
    read and the second unit's launch), ``pair_live_pct`` (``pair.live``
    over ``pair.slots``, in %; None without slots counted)."""
    t, _, n, _ = span_times(summary)
    c = summary["counters"]
    slots = c.get("pair.slots", 0)
    return dict(
        pack_ms_per_step=(1e3 * t.get("pair.pack", 0.0) / n["pair.pack"]
                          if n.get("pair.pack") else None),
        rebuild_ms=(1e3 * t.get("rebuild", 0.0) / n["rebuild"]
                    if n.get("rebuild") else None),
        trigger_idle_ms_per_step=1e3 * summary["idle_s"].get(
            "spherharm.trigger", 0.0) / steps,
        pair_live_pct=(100.0 * c.get("pair.live", 0) / slots if slots
                       else None))
