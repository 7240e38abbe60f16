"""Bytes and operations a restricted count needs, whatever implements it.

For one batch of reads against a fingerprint table (the arithmetic behind
the count kernels' bounds in ``PERF.md``): the batch's payload read once
(2-bit words of the padded rows, and a 2-byte valid length per row, or a
validity bit per base where a row has an N inside), each distinct table row
its windows fall in read once, and each distinct 32-byte sector of the
slot-space int32 counts that a hit touches read and written once.
Operations: the hashing of each valid window and the fingerprint compares
of its row (up to the matching lane for a hit, the whole row for a miss).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.peaks import least_s

# integer operations per hashed window: four fmix32 of 8 operations, the
# seed and constant XORs, and the rolling forward and reverse keys
HASH_OPS = 44
SECTOR_SLOTS = 8      # int32 counts per 32-byte sector


def batch_work(codes: np.ndarray, padded_len: int, bucket: int, probe) -> tuple:
    """``(bytes, operations)`` of one batch: ``codes`` its uint8 rows,
    ``probe`` the reference's :class:`..reference.fptable.Probe` of its
    valid windows."""
    b = codes.shape[0]
    words = b * -(-padded_len // 16) * 4
    prefix = _prefix_valid(codes)
    validity = b * 2 if prefix else b * -(-padded_len // 8)
    rows = int(torch.unique(probe.rows).numel())
    sectors = int(torch.unique(probe.slots // SECTOR_SLOTS).numel())
    n_valid = int(probe.rows.numel())
    hits = int(probe.slots.numel())
    lanes = int((probe.slots % bucket + 1).sum())
    n_bytes = words + validity + rows * bucket * 4 + sectors * 64 + 8
    n_ops = n_valid * HASH_OPS + lanes + bucket * (n_valid - hits)
    return n_bytes, n_ops


def _prefix_valid(codes: np.ndarray) -> bool:
    """True when every row's bases form a prefix (no N before a base)."""
    bad = codes >= 4
    return not bool((bad[:, :-1] & ~bad[:, 1:]).any())


def least_time(work) -> float:
    """Σ least seconds over ``(bytes, operations)`` pairs."""
    return sum(least_s(b, o) for b, o in work)
