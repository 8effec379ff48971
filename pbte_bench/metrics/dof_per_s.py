"""Element-ordinate DOF per second: steps K BS ne D over the whole window
(host clock, the window closed by a synchronise)."""


def read(run):
    r = run.results
    if "steps" not in r:
        return None
    return r["steps"] * r["dof_per_step"] / r["window_s"]
