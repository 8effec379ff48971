"""Run a function on a grid of local ranks, each a spawned process.

``run_ranks(fn, world_size, args, workdir)`` starts ``world_size`` fresh
Python processes (the ``spawn`` start method: no state is inherited), joins
them in one ``torch.distributed`` process group through a ``file://``
rendezvous under ``workdir`` (no port to collide on), calls ``fn(rank,
world_size, *args)`` in each and returns the ranks' return values in rank
order. Each rank hands its value back through a pickle under ``workdir``.
The join has a deadline: a rank still running at ``timeout`` seconds
(a hang in a collective, say) is killed with the others, and the call
raises ``TimeoutError``; a rank that raises makes the call raise
``RuntimeError`` with that rank's traceback. The backend is gloo (NCCL
takes one GPU a rank, and these ranks may share one), and each rank runs
on one torch thread.
"""

from __future__ import annotations

import pickle
import time
import traceback
from pathlib import Path


def _rank_main(fn, rank, world_size, workdir, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = Path(workdir) / f"rank{rank}.pkl"
    try:
        if world_size > 1:
            dist.init_process_group(
                "gloo", init_method=f"file://{Path(workdir) / 'rendezvous'}",
                world_size=world_size, rank=rank)
        value = ("ok", fn(rank, world_size, *args))
    except BaseException:  # noqa: BLE001 - handed to the parent
        value = ("err", traceback.format_exc())
    finally:
        if world_size > 1 and dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(value, f)


def run_ranks(fn, world_size, args=(), workdir=None, timeout=120.0):
    """``[fn(r, world_size, *args) for r in ranks]``, each rank a spawned
    process in one process group (see the module docstring)."""
    import multiprocessing as mp
    import tempfile

    workdir = Path(workdir or tempfile.mkdtemp(prefix="pbte_ranks_"))
    workdir.mkdir(parents=True, exist_ok=True)
    rdv = workdir / "rendezvous"
    if rdv.exists():
        rdv.unlink()
    for r in range(world_size):
        (workdir / f"rank{r}.pkl").unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, str(workdir), tuple(args)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if hung:
        raise TimeoutError(
            f"ranks {hung} of {world_size} still running after {timeout} s "
            "(a collective that not every rank entered?)")
    results, errors = [], []
    for r, p in enumerate(procs):
        path = workdir / f"rank{r}.pkl"
        if not path.exists():
            errors.append(f"rank {r} exited with code {p.exitcode} and no "
                          "result")
            continue
        with open(path, "rb") as f:
            kind, value = pickle.load(f)
        if kind == "err":
            errors.append(f"rank {r}:\n{value}")
        results.append(value)
    if errors:
        raise RuntimeError("\n".join(errors))
    return results
