"""Seconds of the solver's constructor and its first step (a solve's
first three step applications), ending in a synchronise."""


def read(run):
    return run.spans.get("setup.init_s")
