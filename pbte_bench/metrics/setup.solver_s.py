"""Host seconds of the solver's constructor, from the program's own
set-up stage ``pbte.setup.solver``."""

from pbte_bench import registry


def read(run):
    return registry.stage_s(run, "pbte.setup.solver")
