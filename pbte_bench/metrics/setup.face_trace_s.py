"""Host seconds of the face traces' inverse geometry map in the assembly
(``fem.assembly.inverse_map``), from the program's own set-up stage
``pbte.setup.face_trace``."""

from pbte_bench import registry


def read(run):
    return registry.stage_s(run, "pbte.setup.face_trace")
