"""Multi-host counting: ``torch.distributed`` bootstrap, host-level input
sharding and the merge of per-process count vectors.

Port of ``strainscan_tpu/parallel/distributed.py``.  Every process streams
every Nth read batch of the sample (``identify/count.py::count_sample``),
counts it on its own device, and the per-process count vectors are summed
once at the end (:func:`merge_counts`).  Everything downstream of the
counts (CST search, L2 vote, reports) runs replicated, so every process
writes the same reports.

The process group uses the gloo backend: the merge moves host arrays.

Usage, one process per GPU, e.g. under ``torchrun``, which sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``.  With ``--device cuda`` each process counts on
``cuda:LOCAL_RANK`` of the GPUs it sees (:func:`local_device_index`), so
``--nproc-per-node`` equal to the host's GPU count uses every card::

    torchrun --nnodes 2 --node-rank 0 --nproc-per-node 4 \\
        --master-addr HOST --master-port 29500 \\
        -m strainscan_tpu_torch.cli identify -i s.fq -d DB -o out

or with explicit arguments::

    from strainscan_tpu_torch.parallel import distributed as dist
    dist.initialize("10.0.0.1:29500", num_processes=2, process_id=0)
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

log = logging.getLogger("strainscan_tpu_torch.distributed")

INT32_MAX = np.iinfo(np.int32).max


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the gloo process group.  ``coordinator_address`` is
    ``host:port`` of rank 0; without arguments the group reads torchrun's
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``."""
    if coordinator_address is None:
        tdist.init_process_group("gloo", init_method="env://")
    else:
        tdist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    log.info("torch.distributed up: process %d/%d", tdist.get_rank(),
             tdist.get_world_size())


def process_info() -> Tuple[int, int]:
    """(process_index, process_count); (0, 1) when not distributed."""
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def shard_paths(paths: Sequence[str]) -> List[str]:
    """Round-robin file assignment for this process (multi-file inputs)."""
    idx, n = process_info()
    return [p for i, p in enumerate(paths) if i % n == idx]


def shard_range(n_items: int) -> Tuple[int, int]:
    """Contiguous [start, stop) slice of a work list for this process."""
    idx, n = process_info()
    per = -(-n_items // n)
    return min(idx * per, n_items), min((idx + 1) * per, n_items)


def local_device_index(n_devices: int) -> int:
    """This process's GPU among the ``n_devices`` it sees: torchrun's
    ``LOCAL_RANK`` modulo the count (0 without it), so processes that share
    a host spread over its cards, and a process given one card with
    ``CUDA_VISIBLE_DEVICES`` takes that card."""
    return int(os.environ.get("LOCAL_RANK", "0")) % n_devices


def maybe_initialize() -> bool:
    """Env-gated bootstrap used by the CLI: a no-op unless ``MASTER_ADDR``
    is set and no group is up yet.  Returns True if it joined a group."""
    if not os.environ.get("MASTER_ADDR") or tdist.is_initialized():
        return False
    initialize()
    return True


def merge_counts(counts: np.ndarray) -> np.ndarray:
    """Sum the per-process int32 count vectors (an int64 all-reduce, exact)
    and return int32; raises OverflowError if a sum exceeds int32.  A
    no-op when single-process."""
    if process_info()[1] == 1:
        return counts
    total = torch.from_numpy(np.asarray(counts, dtype=np.int64))
    tdist.all_reduce(total, op=tdist.ReduceOp.SUM)
    out = total.numpy()
    if out.size and out.max() > INT32_MAX:
        raise OverflowError(f"merged count {int(out.max())} exceeds int32")
    return out.astype(np.int32)
