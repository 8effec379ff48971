"""The sweep's share of its roofline in a step, in %, from the program's
own span: the least time its work could take on the card (``costs/``,
``peaks.json``) over the device time of the ``pbte.step.sweep`` spans
(the stream's time between each span's CUDA events, every bucket's) per
traced step."""

from pbte_bench import registry


def read(run):
    if not run.results.get("traced_steps"):
        return None
    t = registry.per_step_s(run, ["pbte.step.sweep"])
    return None if not t or t <= 0 else 100.0 * run.bound_s() / t
