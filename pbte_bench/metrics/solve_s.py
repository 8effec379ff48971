"""Seconds to the stated tolerance: the wall time of every solve the
window completed, each ending in a synchronise, over their count."""


def read(run):
    solves = run.results.get("solves")
    if not solves:
        return None
    return sum(s["seconds"] for s in solves) / len(solves)
