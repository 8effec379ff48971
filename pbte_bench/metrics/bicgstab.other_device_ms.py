"""Device milliseconds per step application outside the sweep's kernels
(the closure, the Krylov driver's vector updates and inner products), in
the traced solve."""


def read(run):
    n = run.results.get("traced_applications")
    k = run.config["sweep"]["kernels"]
    if not n or run.trace is None or not k or run.trace.busy_s <= 0:
        return None
    return (run.trace.kernel_s() - run.trace.kernel_s(k)) / n * 1e3
