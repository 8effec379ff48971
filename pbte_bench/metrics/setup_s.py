"""Seconds from the process's start until the window opens: imports, the
host assembly, the solver's constructor and the warm-up (with the kernels'
build on a checkout's first run)."""


def read(run):
    return run.spans.get("setup_s")
