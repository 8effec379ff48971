"""Step applications per solve (``SolveResult.iterations``), the mean over
the window's solves."""


def read(run):
    solves = run.results.get("solves")
    if not solves:
        return None
    return sum(s["applications"] for s in solves) / len(solves)
