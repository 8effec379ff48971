"""The sweep's share of its roofline inside a step application of the
solve, in %: the least time one sweep's work could take over the sweep
kernels' device time per traced step application."""


def read(run):
    n = run.results.get("traced_applications")
    if not n or run.trace is None or not run.config["sweep"]["kernels"]:
        return None
    t = run.trace.kernel_s(run.config["sweep"]["kernels"]) / n
    return None if t <= 0 else 100.0 * run.bound_s() / t
