"""The fingerprint table and the count, from the keys and the reads alone.

The table is StrainScan-TPU's single-probe fingerprint table: ``n_buckets``
rows (the least power of two that keeps the load at most 0.5) of ``bucket``
= 64 uint32 fingerprints; a key's row is ``mix(hi ^ seed, lo)`` and its
fingerprint ``fp2(lo, hi)`` (two rounds of MurmurHash3's fmix32 each); the
seed is the least one under which no row overflows and no two keys of a row
share a fingerprint.  A window that misses every key can still match a
fingerprint of its row (a stray), so the reference rebuilds the table and
counts through it, and its counts equal a sound program's bit for bit.

``fp_bits`` below 32 keeps only the fingerprint's low bits (seed and
placement unchanged, the first matching lane wins): the control, a table
of narrower fingerprints.

uint32 values live in int64 tensors; a product of two of them is taken in
16-bit halves, so no int64 product overflows.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

M32 = 0xFFFFFFFF
K = 31
BUCKET = 64
LOAD = 0.5
MAX_SEED_TRIES = 32
EMPTY = -1


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for ``a`` in ``[0, 2**32)``."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def row_hash(hi, lo, seed: int) -> torch.Tensor:
    return fmix32(fmix32(hi ^ (0x9E3779B9 ^ seed)) ^ lo)


def fingerprint(hi, lo) -> torch.Tensor:
    return fmix32(fmix32(lo ^ 0x85EBCA6B) ^ hi)


def split(keys: torch.Tensor):
    """(hi, lo) 32-bit halves of int64 packed k-mers."""
    return keys >> 32, keys & M32


@dataclasses.dataclass
class Table:
    fp: torch.Tensor      # int64 [n_buckets, bucket]; EMPTY where no key
    ids: torch.Tensor     # int64 [n_buckets, bucket]; EMPTY where no key
    n_buckets: int
    bucket: int
    seed: int
    n_keys: int
    fp_bits: int = 32

    @property
    def fp_mask(self) -> int:
        return (1 << self.fp_bits) - 1


def _place(keys: torch.Tensor, n_buckets: int, bucket: int,
           seed: int) -> Optional[Table]:
    """One placement at a seed: keys in id order take their row's lanes in
    turn; None when a row overflows or two keys of a row share a print."""
    hi, lo = split(keys)
    rows = row_hash(hi, lo, seed) & (n_buckets - 1)
    fill = torch.bincount(rows, minlength=n_buckets)
    if int(fill.max()) > bucket:
        return None
    order = torch.sort(rows, stable=True).indices
    rs = rows[order]
    start = torch.cumsum(fill, 0) - fill
    lane = torch.arange(keys.numel(), device=keys.device) - start[rs]
    pos = rs * bucket + lane
    fp = torch.full((n_buckets * bucket,), EMPTY, dtype=torch.int64,
                    device=keys.device)
    ids = torch.full_like(fp, EMPTY)
    fp[pos] = fingerprint(hi, lo)[order]
    ids[pos] = order
    fp, ids = fp.view(n_buckets, bucket), ids.view(n_buckets, bucket)
    srt = torch.sort(fp, dim=1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != EMPTY)).any()):
        return None
    return Table(fp, ids, n_buckets, bucket, seed, keys.numel())


def build(keys: torch.Tensor, bucket: int = BUCKET) -> Table:
    """The table of ``keys`` (int64 packed k-mers; id = position)."""
    n = keys.numel()
    n_buckets = 1
    while n_buckets * bucket * LOAD < max(n, 1):
        n_buckets *= 2
    while True:
        for seed in range(MAX_SEED_TRIES):
            t = _place(keys, n_buckets, bucket, seed)
            if t is not None:
                return t
        n_buckets *= 2


def narrowed(t: Table, fp_bits: int) -> Table:
    """The same table with ``fp_bits``-bit fingerprints (the control)."""
    mask = (1 << fp_bits) - 1
    fp = torch.where(t.fp == EMPTY, t.fp, t.fp & mask)
    return dataclasses.replace(t, fp=fp, fp_bits=fp_bits)


def window_keys(codes: torch.Tensor, k: int = K):
    """int64 keys ``[n, L-k+1]`` of every window of uint8 code rows, and
    whether each window holds only bases (codes < 4)."""
    c = codes.to(torch.int64)
    m = c.shape[1] - k + 1
    key = torch.zeros((c.shape[0], m), dtype=torch.int64, device=c.device)
    for j in range(k):
        key = (key << 2) | (c[:, j:j + m] & 3)
    bad = torch.nn.functional.pad((c >= 4).to(torch.int32).cumsum(1), (1, 0))
    return key, (bad[:, k:] - bad[:, :-k]) == 0


@dataclasses.dataclass
class Probe:
    """The windows of one batch against a table: the valid windows' rows,
    and the hit windows' ids and slots (row * bucket + lane)."""

    rows: torch.Tensor
    ids: torch.Tensor
    slots: torch.Tensor


def probe(t: Table, keys: torch.Tensor, block: int = 1 << 19) -> Probe:
    """Look up flat int64 ``keys`` (valid windows only)."""
    rows_out, ids_out, slots_out = [], [], []
    for i in range(0, keys.numel(), block):
        hi, lo = split(keys[i:i + block])
        rows = row_hash(hi, lo, t.seed) & (t.n_buckets - 1)
        f = fingerprint(hi, lo) & t.fp_mask
        hit = t.fp[rows] == f[:, None]
        found = hit.any(1)
        lane = hit.to(torch.int8).argmax(1)
        slot = rows * t.bucket + lane
        rows_out.append(rows)
        ids_out.append(t.ids.view(-1)[slot[found]])
        slots_out.append(slot[found])
    if not rows_out:
        e = torch.empty(0, dtype=torch.int64, device=keys.device)
        return Probe(e, e, e)
    return Probe(torch.cat(rows_out), torch.cat(ids_out),
                 torch.cat(slots_out))


def batches(reads: np.ndarray, batch: int) -> Iterator[np.ndarray]:
    for i in range(0, reads.shape[0], batch):
        yield reads[i:i + batch]


def count(t: Table, reads: np.ndarray, device, batch: int = 65536,
          k: int = K, on_batch=None) -> np.ndarray:
    """int32 id-space counts of every valid window of ``reads`` (uint8 code
    rows), on the read's own strand.  ``on_batch(codes, keys, probe)`` sees
    each batch of ``batch`` reads, as the program batches a file."""
    counts = torch.zeros(t.n_keys, dtype=torch.int64, device=device)
    for b in batches(reads, batch):
        codes = torch.from_numpy(np.ascontiguousarray(b)).to(device)
        keys, valid = window_keys(codes, k)
        p = probe(t, keys[valid])
        counts += torch.bincount(p.ids, minlength=t.n_keys)
        if on_batch is not None:
            on_batch(b, keys[valid], p)
    return counts.to(torch.int32).cpu().numpy()


def genome_keys(genome: np.ndarray, device, k: int = K) -> np.ndarray:
    """Sorted distinct packed k-mers of both strands of a code genome
    (uint64)."""
    out = []
    for g in (genome, (3 - genome[::-1]).copy()):
        c = torch.from_numpy(g).to(device)[None]
        keys, _ = window_keys(c, k)
        out.append(keys.view(-1))
    keys = torch.unique(torch.cat(out))
    return keys.cpu().numpy().view(np.uint64)


def keys_tensor(keys: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(keys).view(np.int64)).to(
        device)
