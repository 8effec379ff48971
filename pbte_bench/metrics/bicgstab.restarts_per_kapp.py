"""BiCGStab's restarts of its recurrence (on a plateau or a breakdown) per
1000 step applications, over every solve of the run, from the program's
counters ``bicgstab.restarts.*`` and ``bicgstab.step_applications``."""

from pbte_bench import registry


def read(run):
    rep = registry.report(run)
    if rep is None:
        return None
    counts = rep["counts"]
    n = counts.get("bicgstab.step_applications", 0)
    if not n:
        return None
    restarts = sum(c for k, c in counts.items()
                   if k.startswith("bicgstab.restarts."))
    return 1000.0 * restarts / n
