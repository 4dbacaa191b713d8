"""A slice of the window under ``torch.profiler`` (CPU and CUDA), reduced in
memory to what the per-layer readers take; no trace file is written.

``Slice`` after ``profiled(fn)``:

* ``window_s``: the slice's length, from the trace's own clock (the
  ``benchmark.slice`` range, which ends after a synchronisation);
* ``busy_s``: the union of the device operations' intervals inside it;
* ``device_ops``: seconds of device time by operation name;
* ``idle_gaps``: the gaps between device operations, longest first, each
  named by the innermost host operation running at its middle;
* ``profiler_s``: the part of those gaps under the profiler's own host
  operations (its activity buffer requests), which an untraced run has
  not.
"""

from __future__ import annotations

import collections

import torch

SLICE = "benchmark.slice"
PROFILER_OPS = ("Activity Buffer Request",)


def _ns(ev, which):
    f = getattr(ev, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{which}_us")() * 1000)


def _annotation(ev) -> bool:
    """A range marked by the host (a user annotation), not an operation."""
    f = getattr(ev, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def _end_ns(ev):
    if hasattr(ev, "end_ns"):
        return int(ev.end_ns())
    return _ns(ev, "start") + int(ev.duration_ns())


class Slice:
    def __init__(self, events):
        from torch.autograd import DeviceType

        dev, host, window = [], [], None
        for ev in events:
            s, e = _ns(ev, "start"), _end_ns(ev)
            on_device = ev.device_type() == DeviceType.CUDA
            if ev.name() == SLICE:
                if not on_device:
                    window = (s, e)
            elif on_device:
                if not _annotation(ev):
                    dev.append((s, e, ev.name()))
            else:
                host.append((s, e, ev.name()))
        if window is None:
            raise RuntimeError("the profiled slice has no window range")
        w0, w1 = window
        self.window_s = (w1 - w0) * 1e-9
        dev = sorted((max(s, w0), min(e, w1), n) for s, e, n in dev
                     if e > w0 and s < w1)
        self.device_ops = collections.Counter()
        for s, e, n in dev:
            self.device_ops[n] += (e - s) * 1e-9
        busy, gaps, cur_s, cur_e = 0, [], None, w0
        for s, e, _ in dev:
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                if s > cur_e:
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        if w1 > cur_e:
            gaps.append((cur_e, w1))
        self.busy_s = busy * 1e-9
        own = [(hs, he) for hs, he, n in host if n in PROFILER_OPS]
        self.profiler_s = sum(max(0, min(g1, he) - max(g0, hs))
                              for g0, g1 in gaps for hs, he in own) * 1e-9
        gaps.sort(key=lambda g: g[0] - g[1])
        host.sort()
        self.idle_gaps = []
        for g0, g1 in gaps[:10]:
            mid = 0.5 * (g0 + g1)
            over = [(e - s, n) for s, e, n in host if s <= mid <= e]
            name = min(over)[1] if over else "no host operation"
            self.idle_gaps.append((name, (g1 - g0) * 1e-9))

    def summary(self) -> dict:
        return dict(window_s=self.window_s, busy_s=self.busy_s,
                    profiler_s=self.profiler_s,
                    device_ops=dict(self.device_ops),
                    idle_gaps=self.idle_gaps)


def profiled(fn):
    """Run ``fn()`` under the profiler; returns (fn's result, the Slice
    summary dict)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    return out, Slice(prof.profiler.kineto_results.events()).summary()
