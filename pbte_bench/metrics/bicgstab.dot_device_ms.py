"""Device milliseconds per step application of the traced solve in the
Krylov driver's inner products, from the program's own span
``pbte.bicgstab.dot``."""

from pbte_bench import registry


def read(run):
    if not run.results.get("traced_applications"):
        return None
    t = registry.per_step_s(run, ["pbte.bicgstab.dot"])
    return None if t is None else t * 1e3
