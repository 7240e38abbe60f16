"""Fingerprint-table hashing and lookup on tensors, and the device table.

Port of the device half of ``strainscan_tpu/index/hashtable.py``
(``mix_jnp``, ``fp2_jnp``, ``lookup_fp_device``, ``lookup_device``).  Table
construction stays the shared host code (``FpTable.build`` /
``from_kmer_table``, ``KmerTable.build``); this module turns a host
:class:`FpTable` or :class:`KmerTable` into device tensors, once per device.

uint32 values are int64 tensors in ``[0, 2**32)`` (see :mod:`..kmer.device`);
the device tables are int32 tensors holding the uint32 bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from strainscan_tpu.index.hashtable import FpTable, KmerTable
from strainscan_tpu_torch.kmer.device import M32, from_u32, u32_to_i32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def mix(hi: torch.Tensor, lo: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Seeded bucket hash of packed (hi, lo) k-mers (``mix_jnp``)."""
    return _fmix(_fmix(hi ^ ((0x9E3779B9 ^ seed) & M32)) ^ lo)


def fp2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Bucket-independent fingerprint hash (``fp2_jnp``)."""
    return _fmix(_fmix(lo ^ 0x85EBCA6B) ^ hi)


def lookup_fp_from_prep(fp_table: torch.Tensor, bucket_or_neg: torch.Tensor,
                        fp: torch.Tensor, bucket: int) -> torch.Tensor:
    """Slot ids (bucket_idx * bucket + first matching lane; -1 miss) from
    per-window (bucket or -1, int32 fingerprint bits).

    ``fp_table``: int32 ``[n_buckets, bucket]``.  The LOWEST matching lane
    wins, as ``argmax(hit)`` does in the JAX lookup."""
    shape = bucket_or_neg.shape
    b = bucket_or_neg.reshape(-1).clamp(min=0)
    rows = fp_table.index_select(0, b)                  # [Q, bucket]
    hit = rows == fp.reshape(-1, 1)
    lane = hit.to(torch.uint8).argmax(dim=1)
    found = hit.any(dim=1) & (bucket_or_neg.reshape(-1) >= 0)
    slot = b.to(torch.int64) * bucket + lane
    return torch.where(found, slot, -1).to(torch.int32).reshape(shape)


def lookup_fp(fp_table: torch.Tensor, n_buckets: int, bucket: int, seed: int,
              hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Single-gather lookup of packed k-mers (``lookup_fp_device``):
    int32 slot ids, -1 miss."""
    b = (mix(hi, lo, seed) & (n_buckets - 1)).to(torch.int32)
    return lookup_fp_from_prep(fp_table, b, u32_to_i32(fp2(hi, lo)), bucket)


def lookup_exact(table: torch.Tensor, n_buckets: int, max_probe: int,
                 hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Exact lookup over the interleaved table (``lookup_device``): int32
    ids of the queries' k-mers, -1 miss, same shape as ``hi``.

    ``table``: int32 ``[n_buckets, 3 * BUCKET]`` (``KmerTable.interleaved``:
    hi, lo, val per slot).  The bucket hash is the UNSEEDED ``mix``; probe
    ``p`` reads row ``(bucket + p) & (n_buckets - 1)``; a lane hits when
    both halves match and its value is >= 0, a row yields the largest hit
    value, and the first probe that hits wins."""
    shape = hi.shape
    hi = hi.reshape(-1)
    lo = lo.reshape(-1)
    b = (mix(hi, lo) & (n_buckets - 1)).to(torch.int64)
    out = torch.full(hi.shape, -1, dtype=torch.int32, device=hi.device)
    for p in range(max_probe):
        rows = table.index_select(0, (b + p) & (n_buckets - 1))  # [Q, 24]
        thi = rows[:, 0::3].to(torch.int64) & M32
        tlo = rows[:, 1::3].to(torch.int64) & M32
        tval = rows[:, 2::3]
        hit = (thi == hi[:, None]) & (tlo == lo[:, None]) & (tval >= 0)
        found = torch.where(hit, tval, -1).amax(dim=1)
        out = torch.where(out < 0, found, out)
    return out.reshape(shape)


@dataclasses.dataclass
class DeviceKmerTable:
    """A :class:`KmerTable` resident on one device (exact probe mode)."""

    table: torch.Tensor       # int32 [n_buckets, 3 * BUCKET] interleaved
    n_buckets: int
    max_probe: int
    n_keys: int


def kmer_table_to_device(table: KmerTable,
                         device: torch.device) -> DeviceKmerTable:
    """Upload ``table.interleaved()`` to ``device``, cached on the table
    per device, as :func:`fp_table_to_device` caches."""
    device = torch.device(device)
    cache = getattr(table, "_torch_exact_tables", None)
    if cache is None:
        cache = {}
        object.__setattr__(table, "_torch_exact_tables", cache)
    out = cache.get(str(device))
    if out is None:
        inter = torch.from_numpy(table.interleaved())
        out = DeviceKmerTable(table=inter.to(device),
                              n_buckets=table.n_buckets,
                              max_probe=table.max_probe,
                              n_keys=table.n_keys)
        cache[str(device)] = out
    return out


@dataclasses.dataclass
class DeviceFpTable:
    """An :class:`FpTable` resident on one device."""

    fp: torch.Tensor          # int32 [n_buckets, bucket] (uint32 bits)
    slot_of_id: torch.Tensor  # int32 [n_keys]
    n_buckets: int
    bucket: int
    seed: int


def fp_table_of(table: KmerTable) -> FpTable:
    """The fingerprint table of an exact table, derived once and cached on
    the table object (the attribute the JAX pipeline and the DB loader use,
    so a loaded sidecar is reused)."""
    fpt = getattr(table, "_fp_cache", None)
    if fpt is None:
        fpt = FpTable.from_kmer_table(table)
        object.__setattr__(table, "_fp_cache", fpt)
    return fpt


def fp_table_to_device(fpt: FpTable, device: torch.device) -> DeviceFpTable:
    """Upload ``fpt`` to ``device``, cached on the FpTable per device, so a
    process that identifies many samples uploads the table once."""
    device = torch.device(device)
    cache = getattr(fpt, "_torch_tables", None)
    if cache is None:
        cache = {}
        object.__setattr__(fpt, "_torch_tables", cache)
    out = cache.get(str(device))
    if out is None:
        fp = from_u32(fpt.fp.reshape(fpt.n_buckets, fpt.bucket))
        soi = torch.from_numpy(np.ascontiguousarray(fpt.slot_of_id(),
                                                    dtype=np.int32))
        out = DeviceFpTable(fp=fp.to(device), slot_of_id=soi.to(device),
                            n_buckets=fpt.n_buckets, bucket=fpt.bucket,
                            seed=fpt.seed)
        cache[str(device)] = out
    return out
