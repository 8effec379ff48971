"""Host seconds of the program's assembly of the problem (mesh, element
operators, angles, phonon tables), on the benchmark's clock around the
call."""


def read(run):
    return run.spans.get("setup.assembly_s")
