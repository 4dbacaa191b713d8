"""Spans and counters inside the step, on the profiler's clock.

Off by default; ``enabled(True)`` switches them on (a setter, and a
context manager that restores the previous state on exit). Off, ``span``,
``host`` and ``count`` test one flag and return: they launch nothing,
allocate nothing and build nothing.

On:

* ``span(name, device)`` marks a layer of the step. A host range
  (``torch.profiler.record_function``) does not replay with a CUDA graph,
  so on a CUDA device the span also launches a pair of empty marker
  kernels on the current stream, ``spherharm_span__<name>__begin`` and
  ``..__end`` (the dots of the name as underscores), from
  ``csrc/span_marks.cu``: captured into a unit's graph, they replay with
  it, and every device operation between them on that stream lies in the
  span (``utils/timing.reduce_spans``). The library is built
  (``ops/cuda_build.span_library``) the first time spans are switched on
  where there is a card. On the CPU a span is the host range alone.
* ``host(name[, unit])`` is a host range alone: the runner's replays and
  captures, a run, the trigger's wait and launch (``spherharm.*``).
* ``count(name, value)`` adds to a counter: a Python number to a host
  counter (the runner records what a capture counted and adds it again
  on every replay, as it does kernel launches), a tensor's sum to a
  device counter (a 0-d tensor the captured graphs add into).
  ``counters()`` reads the totals (one synchronisation for the device
  counters), ``reset()`` zeroes them in place.

The runner keys its graphs by ``is_on()`` (``core/runner.cached_runner``):
marks are captured only into the graphs of a spans-on runner, and a
spans-off run never replays them.
"""

from __future__ import annotations

import contextlib

import torch

# Every device span, in the order of csrc/span_marks.cu's SPAN_LIST: the
# marker kernels of SPANS[i] are entries 2 i (begin) and 2 i + 1 (end).
SPANS = (
    "step.pre", "step.trigger",
    "rebuild", "rebuild.cell_list", "rebuild.remap", "rebuild.pair_build",
    "rebuild.prefilter",
    "pair", "pair.pack", "pair.law", "pair.reduce",
    "walls", "step.post",
    "runner.store", "runner.load", "runner.result",
    "halo.migrate", "halo.exchange", "halo.forward",
    "comm.p2p", "comm.collective",
)
MARK_PREFIX = "spherharm_span__"
_INDEX = {name: i for i, name in enumerate(SPANS)}
_NULL = contextlib.nullcontext()

_on = False
_host = {}    # host counters: name -> number (one dict for the process)
_device = {}  # device counters: (name, device) -> 0-d tensor


def mark_symbol(name: str, end: bool) -> str:
    """The marker kernel's symbol of span ``name``'s begin or end."""
    return (f"{MARK_PREFIX}{name.replace('.', '_')}__"
            f"{'end' if end else 'begin'}")


def is_on() -> bool:
    return _on


class enabled:
    """Switches spans on or off now; as a context manager, restores the
    previous state on exit. Switching on where there is a card builds
    and loads the marker kernels (once a process)."""

    def __init__(self, on: bool = True):
        global _on
        self._prev = _on
        if on and torch.cuda.is_available():
            from spherharm_tpu_torch.ops import cuda_build

            cuda_build.span_library()
        _on = bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _on
        _on = self._prev
        return False


def _mark(i: int, device):
    from spherharm_tpu_torch.ops import cuda_build

    lib = cuda_build.span_library()
    err = lib.sh_span_mark(i, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"span mark {i}: CUDA error {err} "
                           f"({lib.sh_span_error_string(err).decode()})")


class _Span:
    __slots__ = ("name", "index", "device", "range")

    def __init__(self, name, device):
        self.name, self.index = name, 2 * _INDEX[name]
        self.device = device if device.type == "cuda" else None
        self.range = torch.profiler.record_function(name)

    def __enter__(self):
        self.range.__enter__()
        if self.device is not None:
            _mark(self.index, self.device)
        return self

    def __exit__(self, *exc):
        if self.device is not None:
            _mark(self.index + 1, self.device)
        self.range.__exit__(*exc)
        return False


def span(name: str, device):
    """A device span of ``SPANS`` on ``device`` (a ``torch.device``) over
    the block; nothing while spans are off."""
    if not _on:
        return _NULL
    return _Span(name, torch.device(device))


def host(name: str, unit: str | None = None):
    """A host range ``name`` (``name.unit`` where a unit is given) over
    the block; nothing while spans are off."""
    if not _on:
        return _NULL
    return torch.profiler.record_function(
        name if unit is None else f"{name}.{unit}")


def count(name: str, value):
    """Adds ``value`` to counter ``name``: a number to the host counter,
    a tensor's sum to the device counter on its device. Nothing while
    spans are off."""
    if not _on:
        return
    if not torch.is_tensor(value):
        _host[name] = _host.get(name, 0) + value
        return
    key = (name, value.device)
    acc = _device.get(key)
    if acc is None:
        if value.is_cuda and torch.cuda.is_current_stream_capturing():
            # A zero made inside a capture would replay with the graph.
            raise RuntimeError(f"counter {name!r} first counted inside a "
                               "graph capture (the warm-up makes it)")
        acc = _device[key] = torch.zeros(
            (), device=value.device,
            dtype=torch.float64 if value.is_floating_point() else torch.int64)
    acc.add_(value.sum().to(acc.dtype))


def host_counters() -> dict:
    """The host counters' dict itself (the runner records and replays
    what a capture adds to it)."""
    return _host


def device_snapshot() -> dict:
    """Copies of the device counters (``restore_device``)."""
    return {k: v.clone() for k, v in _device.items()}


def restore_device(snap: dict):
    """Sets the device counters back to ``snap`` in place: those made
    since to zero."""
    for k, v in _device.items():
        if k in snap:
            v.copy_(snap[k])
        else:
            v.zero_()


def counters() -> dict:
    """Totals of every counter: host counters as they are, device
    counters summed over their devices, read in one synchronisation a
    device (one that reads 0 is left out: a replay adds to a device
    counter without Python knowing)."""
    out = dict(_host)
    by_dev = {}
    for k, v in _device.items():
        by_dev.setdefault(v.device, []).append(k)
    for keys in by_dev.values():
        vals = torch.stack([_device[k].double() for k in keys]).tolist()
        for (name, _), x in zip(keys, vals):
            if x:
                x = x if _device[(name, _)].is_floating_point() else int(x)
                out[name] = out.get(name, 0) + x
    return out


def reset():
    """Zeroes every counter in place (captured graphs hold the device
    counters' memory)."""
    _host.clear()
    for v in _device.values():
        v.zero_()
