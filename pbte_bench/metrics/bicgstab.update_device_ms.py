"""Device milliseconds per step application of the traced solve in the
Krylov driver's vector updates, from the program's own span: the self
time of ``pbte.bicgstab.update`` (its inner products left out)."""

from pbte_bench import registry


def read(run):
    if not run.results.get("traced_applications"):
        return None
    t = registry.per_step_s(run, ["pbte.bicgstab.update"],
                            key="self_device_s")
    return None if t is None else t * 1e3
