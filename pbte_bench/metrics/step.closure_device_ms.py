"""Device milliseconds per traced step outside the sweep, from the
program's own spans: ``pbte.step.sources`` (the lagged Tc slab and the
closure sources) and ``pbte.step.macroscopic`` (the partials' sum, Tc, Tv
and the residual)."""

from pbte_bench import registry


def read(run):
    if not run.results.get("traced_steps"):
        return None
    t = registry.per_step_s(run, ["pbte.step.sources",
                                  "pbte.step.macroscopic"])
    return None if t is None else t * 1e3
