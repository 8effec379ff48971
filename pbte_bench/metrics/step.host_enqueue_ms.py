"""Host milliseconds of one ``step()`` call without a synchronise, the
mean over the window's steps: what the host spends to enqueue a step."""


def read(run):
    r = run.results
    if not r.get("steps"):
        return None
    return r["enqueue_s"] / r["steps"] * 1e3
