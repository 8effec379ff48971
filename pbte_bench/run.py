"""Run one benchmark cell once on the card and print its result line.

    python3 pbte_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic and
metrics are those ``BENCHMARK.json`` names (``harness.py``). The last line
of standard output is one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics`` and ``device`` (with ``--trace 1`` the per-layer
metrics and ``breakdown``), and, last, ``checks``: each number compared
with its limit, which also end standard error. ``--control 1`` runs the
cell's control (the program in the state type below the stated one),
which has to come out not correct.

Exits 1 without printing a result when no CUDA device is visible (no
fall-back to the CPU), and 3 when a module of JAX or of the JAX package is
loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from pbte_bench import harness

    bench = harness.load_benchmark(REPO)
    need = harness.find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        harness.log(f"needs {need} CUDA device(s); "
                    f"{torch.cuda.device_count()} visible")
        return 1
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda",
                            control=bool(args.control), bench=bench,
                            t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process: {bad}")
        return 3
    for name, c in line["checks"].items():
        harness.log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
