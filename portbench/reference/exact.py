"""Exact restricted counts, from the keys and the reads alone.

Every valid window of a read, on the read's own strand, is looked up in the
sorted keys: a window counts to a key only when it is that key.  No table,
no hash and no fingerprint, so a count held to this one is held to the
configurations' guarantee (exact up to the fingerprint's strays, which only
add) and not to how a table places its keys.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import fptable


def count(keys: torch.Tensor, reads: np.ndarray, device,
          batch: int = 65536, k: int = fptable.K) -> np.ndarray:
    """int64 id-space counts of ``reads`` (uint8 code rows); ``keys`` are
    ascending int64 packed k-mers, id = position."""
    n = keys.numel()
    if n > 1 and bool((keys[1:] <= keys[:-1]).any()):
        raise ValueError("keys must be ascending and distinct")
    counts = torch.zeros(n, dtype=torch.int64, device=device)
    for b in fptable.batches(reads, batch):
        codes = torch.from_numpy(np.ascontiguousarray(b)).to(device)
        windows, valid = fptable.window_keys(codes, k)
        windows = windows[valid]
        pos = torch.searchsorted(keys, windows).clamp(max=max(n - 1, 0))
        hit = keys[pos] == windows
        counts += torch.bincount(pos[hit], minlength=n)
    return counts.cpu().numpy()
