"""Per-layer metrics: one module a metric, named as in BENCHMARK.json,
each with ``read(ctx) -> float | None`` (None: nothing to read in this
cell; the harness then leaves the metric out of the line).

``ctx``: ``slices`` (each rank's traced slice: ``window_s``, ``busy_s``,
``profiler_s``, ``device_ops`` {name: seconds}, ``idle_gaps``),
``steps`` (the window's steps), ``slice_steps``, ``rebuilds`` (rebuild
replays in the window), ``law`` (``conservative``, ``lmax``, ``nodes``,
``n_types``, ``pair_steps``: pairs that needed the law, summed over the
slice's steps and the ranks), ``peaks`` (``roofline/peaks.json``).
"""

from benchmark.roofline import pair_law


def law_roofline(ctx, conservative: bool, kernel: str):
    law = ctx["law"]
    if law["conservative"] != conservative or not law["pair_steps"]:
        return None
    t = sum(sum(v for n, v in s["device_ops"].items() if kernel in n)
            for s in ctx["slices"])
    if t <= 0:
        return None
    ops, nbytes = pair_law.work(law["pair_steps"], law["lmax"], law["nodes"],
                                conservative, law["n_types"],
                                ctx["slice_steps"] * len(ctx["slices"]))
    least = max(ops / ctx["peaks"]["f32_flops"],
                nbytes / ctx["peaks"]["bytes_per_s"])
    return 100.0 * least / t
