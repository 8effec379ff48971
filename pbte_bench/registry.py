"""The program's own spans and counters (``pbte_tpu_torch.tracing``), read
after a traced run by the per-layer metrics of source ``program_span`` and
``program_counter``.

The program records its hot spans only while the profiler runs, which in a
run is the traced segment alone: a span's ``calls`` are those of the traced
steps or solve. Set-up stages and counters cover the whole run. A program
without the registry, a run with ``--trace 0`` and an empty registry give
nothing to read (None)."""

from __future__ import annotations


def report(run):
    """``tracing.report()`` after a traced run, or None."""
    if not run.trace_on or run.trace is None:
        return None
    try:
        from pbte_tpu_torch import tracing
    except ImportError:  # a program without the registry
        return None
    rep = tracing.report()
    return rep if any(rep.values()) else None


def per_step_s(run, names, key="device_s"):
    """Seconds of the spans ``names`` (``key`` summed over their calls) per
    call of ``pbte.step`` in the traced segment, on the card only (a CPU
    run's span times are host times: no device reading); None where the
    program recorded none of them."""
    rep = report(run)
    if rep is None or run.device.type != "cuda":
        return None
    spans = rep["spans"]
    n = spans.get("pbte.step", {}).get("calls", 0)
    found = [spans[name][key] for name in names if name in spans]
    if not n or not found:
        return None
    return sum(found) / n


def stage_s(run, name):
    """Host seconds of the set-up stage ``name`` over the run, or None."""
    rep = report(run)
    if rep is None or name not in rep["stages"]:
        return None
    return rep["stages"][name]["host_s"]
