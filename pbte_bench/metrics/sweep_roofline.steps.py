"""The sweep's share of its roofline in a step, in %: the least time its
work could take on the card (``costs/``, ``peaks.json``) over its device
time per traced step. The sweep's device time is that of the kernels the
configuration's ``sweep.kernels`` names, or, where it names none (a sweep
of library products that the trace cannot tell from the closure's), of
every kernel of the step."""


def read(run):
    n = run.results.get("traced_steps")
    if not n or run.trace is None:
        return None
    t = run.trace.kernel_s(run.config["sweep"]["kernels"]) / n
    return None if t <= 0 else 100.0 * run.bound_s() / t
