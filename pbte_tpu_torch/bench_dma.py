"""Copy-bandwidth probe on the GPU: the plain copy against the hand-written
K2 (``auto_copy``) and K3 (``manual_copy``) kernels.

Port of ``scripts/bench_pallas_dma.py:main``. It copies a
``(total_rows, 128)`` float32 array (``--total-mb``, default
``DMA_TOTAL_MB`` or 512 MB each way) and reports GB/s with bytes = read +
write, as the script counts them:

- ``plain``: ``x + 0.0`` (the script's ``xla_copy``);
- ``auto/<tile>``: K2, one CTA per tile, swept over the tile bytes;
- ``manual/<bufs>x<stage>``: K3, persistent CTAs with an n_bufs-deep
  shared-memory pipeline, swept over n_bufs and the stage bytes.

The script's 0.5-8 MB blocks are TPU VMEM tiles; a CTA has 227 KB of shared
memory, so the sweep here is in per-CTA tile and stage bytes, and the JSON
records that mapping. Every output is checked with ``torch.equal`` against
the input. Each kernel row is timed in turns with the plain copy: ``ROUNDS``
rounds, each a CUDA-event window of ``--reps`` launches of the kernel and one
of the plain copy, in alternating order. A row reports the median of its
kernel windows, the median of its plain windows, and the kernel's rate over
the plain rate per round (median, min, max).

Usage (on a machine with a CUDA GPU)::

    python -m pbte_tpu_torch.bench_dma [--total-mb 512] [--reps 20] [--out F]

It prints the JSON to stdout, or writes it to ``--out``; it exits 1 without
a GPU and refuses to write under the repository's ``bench_artifacts/``
(those files are the JAX package's TPU results).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys

import torch

from pbte_tpu_torch.ops import dma_copy

SUB = 8  # the script rounds rows to its sublane count
AUTO_ROWS = (8, 16, 32, 64, 128)  # K2 tiles of 4-64 KB
MANUAL_ROWS = (16, 32, 48)  # K3 stages of 8, 16 and 24 KB
ROUNDS = 7
_TPU_ARTIFACTS = pathlib.Path(__file__).resolve().parent.parent / "bench_artifacts"


def total_rows_for(total_mb: float) -> int:
    """Rows of 128 float32 in total_mb megabytes (the script's rounding)."""
    return int(total_mb * 1e6 / dma_copy.ROW_BYTES // SUB * SUB)


def card_name_power() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def configs():
    """(name, fn, mapping) of every row after ``plain``."""
    rows = []
    for r in AUTO_ROWS:
        kb = r * dma_copy.ROW_BYTES // 1024
        rows.append((
            f"auto/{kb}KB",
            lambda x, r=r: dma_copy.auto_copy(x, r),
            dict(kernel="K2", tile_bytes=r * dma_copy.ROW_BYTES,
                 rows_per_block=r, threads=dma_copy.auto_threads(r),
                 smem_per_cta=dma_copy.auto_smem_bytes(r)),
        ))
    for r in MANUAL_ROWS:
        kb = r * dma_copy.ROW_BYTES // 1024
        for bufs in dma_copy.N_BUFS:
            rows.append((
                f"manual/{bufs}x{kb}KB",
                lambda x, r=r, bufs=bufs: dma_copy.manual_copy(x, r, bufs),
                dict(kernel="K3", stage_bytes=r * dma_copy.ROW_BYTES,
                     rows_per_block=r, n_bufs=bufs,
                     smem_per_cta=dma_copy.manual_smem_bytes(r, bufs)),
            ))
    return rows


def time_paired(fn, plain, x, reps):
    """fn(x) and plain(x) in turns after one warm-up each: ``ROUNDS`` rounds
    of one CUDA-event window of ``reps`` launches of each, the order
    alternating from round to round. One untimed launch goes ahead of each
    window, so the window opens with the device busy and the host's launch
    cost stays out of it. Returns (fn ms, plain ms), one mean per window."""
    fn(x)
    plain(x)
    torch.cuda.synchronize()
    got = {fn: [], plain: []}
    for r in range(ROUNDS):
        for f in ((plain, fn) if r % 2 == 0 else (fn, plain)):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            f(x)
            e0.record()
            for _ in range(reps):
                f(x)
            e1.record()
            torch.cuda.synchronize()
            got[f].append(e0.elapsed_time(e1) / reps)
    return got[fn], got[plain]


def run(total_mb: float = 512.0, reps: int = 20, seed: int = 0) -> dict:
    """Check and time every row on the current CUDA device, each kernel row
    in turns with the plain copy; returns the result dict. Raises if an
    output differs from the input."""
    if not torch.cuda.is_available():
        raise RuntimeError("the copy probe runs on a CUDA GPU only")
    rows = total_rows_for(total_mb)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, dma_copy.LANE), generator=gen, device="cuda")
    nbytes = 2 * x.numel() * x.element_size()  # read + write
    plain = dma_copy.copy_ref
    gbs, ms, plain_ms, vs_plain = {}, {}, {}, {}
    mapping = {"plain": dict(kernel="plain")}
    all_plain = []
    for name, fn, info in configs():
        y = fn(x)
        torch.cuda.synchronize()
        if not torch.equal(y, x):
            raise RuntimeError(f"{name}: the copy differs from its input")
        del y
        if info["kernel"] == "K3":
            info = dict(info, grid=dma_copy.manual_copy.last_grid)
        else:
            info = dict(info, grid=-(-(nbytes // 2) // info["tile_bytes"]))
        k, p = time_paired(fn, plain, x, reps)
        all_plain += p
        ms[name] = statistics.median(k)
        plain_ms[name] = statistics.median(p)
        ratio = [b / a for a, b in zip(k, p)]  # kernel rate / plain rate
        vs_plain[name] = {"median": statistics.median(ratio),
                          "min": min(ratio), "max": max(ratio)}
        gbs[name] = nbytes / (ms[name] * 1e-3) / 1e9
        mapping[name] = info
    ms["plain"] = statistics.median(all_plain)
    gbs["plain"] = nbytes / (ms["plain"] * 1e-3) / 1e9
    best = max(gbs, key=gbs.get)
    return {
        "metric": "dma_copy_bandwidth",
        "device": torch.cuda.get_device_name(0),
        "card": card_name_power(),
        "total_mb_each_way": total_mb,
        "total_rows": rows,
        "bytes_per_call": nbytes,
        "gbs": gbs,
        "ms": ms,
        "plain_ms": plain_ms,
        "rate_vs_plain": vs_plain,
        "best": {"name": best, "gbs": gbs[best]},
        "mapping": mapping,
        "tpu_sweep": "scripts/bench_pallas_dma.py swept 0.5-8 MB VMEM "
                     "blocks; here per-CTA tile (K2) and stage (K3) bytes",
        "protocol": f"CUDA events; each kernel row in turns with the plain "
                    f"copy, {ROUNDS} rounds of one {reps}-launch window each "
                    f"after 1 warm-up, 1 untimed launch ahead of each "
                    f"window; ms = median window, plain_ms = the plain "
                    f"median of the same rounds, ms['plain'] = median of "
                    f"every plain window; bytes = read + write, every output "
                    f"torch.equal to x",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--total-mb", type=float,
                    default=float(os.environ.get("DMA_TOTAL_MB", 512)))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    if args.out is not None:
        out = pathlib.Path(args.out).resolve()
        if _TPU_ARTIFACTS in out.parents:
            print(f"refusing to write under {_TPU_ARTIFACTS}: those are the "
                  "JAX package's TPU results", file=sys.stderr)
            return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the copy probe runs on a GPU only",
              file=sys.stderr)
        return 1
    res = run(args.total_mb, args.reps, args.seed)
    text = json.dumps(res, indent=2)
    if args.out is None:
        print(text)
    else:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text + "\n")
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
