"""Share of the traced slice's wall time in which no device operation
ran (the union of the operations' intervals), in %; of the idlest rank
where there are several. The gaps under the profiler's own host
operations (``profiler_s``), which an untraced run has not, are left out
of both the idle time and the slice."""


def read(ctx):
    shares = [100.0 * (s["window_s"] - s["busy_s"] - s["profiler_s"])
              / (s["window_s"] - s["profiler_s"])
              for s in ctx["slices"] if s["window_s"] > 0 and s["busy_s"] > 0]
    return max(shares) if shares else None
