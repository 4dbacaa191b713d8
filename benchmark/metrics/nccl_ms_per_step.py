"""Device milliseconds a step of the kernels named ``nccl*`` in the
traced slice, of the rank with the most. A collective's kernel runs from
its launch until its peers arrive, so this holds the waits on the slowest
rank as well as the transfers."""


def read(ctx):
    per_rank = [sum(t for n, t in s["device_ops"].items()
                    if "nccl" in n.lower()) for s in ctx["slices"]]
    if len(per_rank) < 2 or not any(per_rank) or not ctx["slice_steps"]:
        return None
    return 1e3 * max(per_rank) / ctx["slice_steps"]
