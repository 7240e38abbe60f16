"""Benchmarks of the port on one NVIDIA GPU, and what they share.

* :mod:`.count` -- the counterpart of ``bench.py``: the headline metric
  ``kmer_match_reads_per_s_ecoli_scale``.
* :mod:`.probe_study` -- the counterpart of ``benchmarks/probe_bench3.py``:
  the count step's row gather (``row_gather_kernel``) and scatter.
* :mod:`.exact_study` -- design studies of the exact count: its kernels
  beside any other tree's, its add stage's slice sizes, its parts.
* :mod:`.fp_bin_study` -- design studies of count_fp's bin sort: its
  kernels beside any other tree's, its fan-out and rows per block.
* :mod:`.sanitize_counts` -- the count kernels once each at a reduced
  shape, for compute-sanitizer to watch.
* :mod:`.fetch_study` -- the stream-end count fetch: each route alone, and
  every finish of identify-ecoli and of the count, beside any other tree's.

All measure on a CUDA device and raise without one: no number here comes
from the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Callable

import torch


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` reports
    them; every number a benchmark keeps goes beside it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_device(device) -> torch.device:
    """``device`` as a CUDA ``torch.device``; raises for any other."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"a benchmark measures on a CUDA device, not "
                           f"{dev} (torch.cuda.is_available() = "
                           f"{torch.cuda.is_available()})")
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls on the current CUDA
    stream, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# the published peaks a bound is taken against (NVIDIA's H100 SXM data
# sheet, 700 W): device memory, and the 32-bit rate outside the tensor
# cores, which the count kernels' integer hashing and compares run at best
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12


def bound_ms(n_bytes: float, n_ops: float = 0.0) -> tuple:
    """``(ms, "bytes" or "operations")``: the least time the card could
    take to move ``n_bytes`` (each input read once, each output written
    once) and do ``n_ops``, and which of the two bounds it."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_S, n_ops / SCALAR_OPS_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")
