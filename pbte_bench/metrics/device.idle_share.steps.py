"""1 - (union of device intervals) / (traced window) over the traced
steps."""


def read(run):
    if not run.results.get("traced_steps") or run.trace is None:
        return None
    if run.trace.busy_s <= 0:  # no device events: nothing to read
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
