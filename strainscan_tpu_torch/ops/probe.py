"""Kernel wrappers of the count hot path, each beside its plain twin.

* :func:`probe_prep` -> ``probe_prep_kernel``: per-window (bucket, fp) of
  uint8 code rows; port of the Pallas kernel
  ``strainscan_tpu/ops/pallas_probe.py::probe_prep``.
* :func:`count_fp` -> ``count_fp_kernel``: the fused main-path kernel:
  unpack the 2-bit words, hash every window, probe its fingerprint row and
  add one to its slot (or to the trash slot) in place.
* :func:`count_exact` -> ``count_exact_kernel``: the exact probe mode: the
  same unpack and window packing, then up to ``max_probe`` reads of the
  interleaved exact-table row, and one added to the k-mer's id (or to the
  trash entry) in place.

Both count wrappers take a read batch in one of three payload forms: int32
2-bit words with ``vlen`` (valid prefix lengths) or ``vbytes`` (validity
bits), or uint8 raw codes ``[B, L]`` (then neither ``vlen`` nor ``vbytes``).

A tensor on the CPU goes to the plain twin (``*_plain``).  A CUDA tensor
launches the kernel on ``torch.cuda.current_stream()`` without
synchronising, or raises.  ``LAUNCHES`` counts kernel launches per kernel
name; callers reset it with :func:`reset_launches`.
"""

from __future__ import annotations

from typing import Optional

import torch

from strainscan_tpu_torch.index.hashtable import (fp2, lookup_exact,
                                                  lookup_fp_from_prep, mix)
from strainscan_tpu_torch.kmer import device as kdev
from strainscan_tpu_torch.ops import _build

# every kernel's launches, the measurement path's row_gather_kernel
# (ops/gather.py) included, so reset_launches covers them all
LAUNCHES = {"probe_prep_kernel": 0, "count_fp_kernel": 0,
            "count_exact_kernel": 0, "row_gather_kernel": 0}

# rows per chunk of the plain counts: bounds their [rows * M, row] gathers
# (1.9 GB at 8192 x 226 x 64 int32 plus temporaries)
PLAIN_CHUNK_ROWS = 8192


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {ndim}-D {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _route(*tensors: torch.Tensor) -> bool:
    """True for the CUDA kernel, False for the plain twin; raises on a
    mixed or unsupported placement."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


# ------------------------------------------------------------ probe_prep
def probe_prep_plain(codes: torch.Tensor, *, k: int, n_buckets: int,
                     seed: int, canonical: bool = False):
    """Plain twin of :func:`probe_prep`."""
    hi, lo, valid = kdev.extract_kmers(codes, k)
    if canonical:
        hi, lo = kdev.canonical(hi, lo, k)
    b = (mix(hi, lo, seed) & (n_buckets - 1)).to(torch.int32)
    return (torch.where(valid, b, -1).to(torch.int32),
            kdev.u32_to_i32(fp2(hi, lo)))


def probe_prep(codes: torch.Tensor, *, k: int, n_buckets: int, seed: int,
               canonical: bool = False):
    """All read windows' (bucket, fingerprint) pairs.

    Args:
      codes: uint8 ``[B, L]`` encoded reads (0..3 bases, >= 4 invalid/pad).
      k: k-mer size (<= 31).
      n_buckets: power-of-two bucket count of the fingerprint table.
      seed: bucket-hash seed of the table.
      canonical: hash min(fwd, revcomp) of each window.

    Returns:
      ``(bucket_or_neg int32 [B, M], fp int32 [B, M])`` with ``M = L-k+1``;
      ``fp`` holds the uint32 fingerprint bits, bucket is -1 for windows
      holding an invalid code.
    """
    _check(codes, "codes", torch.uint8, 2)
    b, length = codes.shape
    m = length - k + 1
    if not 1 <= k <= 31 or m <= 0:
        raise ValueError(f"k={k} does not fit reads of length {length}")
    if n_buckets & (n_buckets - 1) or not 0 < n_buckets <= 1 << 31:
        raise ValueError(f"n_buckets={n_buckets} is not a power of two")
    if not _route(codes):
        return probe_prep_plain(codes, k=k, n_buckets=n_buckets, seed=seed,
                                canonical=canonical)
    bucket = torch.empty((b, m), dtype=torch.int32, device=codes.device)
    fp = torch.empty((b, m), dtype=torch.int32, device=codes.device)
    lib = _build.lib()
    _build.check(lib.probe_prep_launch(
        codes.device.index, codes.data_ptr(), b, length, k, int(canonical),
        n_buckets, seed & 0xFFFFFFFF, bucket.data_ptr(), fp.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream),
        "probe_prep_kernel launch")
    LAUNCHES["probe_prep_kernel"] += 1
    return bucket, fp


# ---------------------------------------------------------- read payloads
def _payload(words: torch.Tensor, vlen: Optional[torch.Tensor],
             vbytes: Optional[torch.Tensor],
             length: int) -> Optional[torch.Tensor]:
    """Check a read batch; return its validity tensor (None for codes)."""
    if vlen is None and vbytes is None:
        _check(words, "codes", torch.uint8, 2)
        if words.shape[1] != length:
            raise ValueError(f"codes rows hold {words.shape[1]} bases, "
                             f"not {length}")
        return None
    _check(words, "words", torch.int32, 2)
    if words.shape[1] * 16 < length:
        raise ValueError(f"{words.shape[1]} words cannot hold {length} bases")
    if vlen is not None and vbytes is not None:
        raise ValueError("pass at most one of vlen and vbytes")
    if vlen is not None:
        _check(vlen, "vlen", torch.uint16, 1)
        if vlen.shape[0] != words.shape[0]:
            raise ValueError("vlen rows differ from words rows")
        return vlen
    _check(vbytes, "vbytes", torch.uint8, 2)
    if vbytes.shape[0] != words.shape[0] or vbytes.shape[1] * 8 < length:
        raise ValueError(f"vbytes {tuple(vbytes.shape)} do not cover "
                         f"{words.shape[0]} rows of {length} bases")
    return vbytes


def _chunks(words: torch.Tensor, vlen: Optional[torch.Tensor],
            vbytes: Optional[torch.Tensor], length: int):
    """uint8 codes of the batch, PLAIN_CHUNK_ROWS rows at a time."""
    for i in range(0, words.shape[0], PLAIN_CHUNK_ROWS):
        w = words[i:i + PLAIN_CHUNK_ROWS]
        if vlen is not None:
            yield kdev.unpack_codes_vlen(w, vlen[i:i + PLAIN_CHUNK_ROWS],
                                         length)
        elif vbytes is not None:
            yield kdev.unpack_codes(w, vbytes[i:i + PLAIN_CHUNK_ROWS], length)
        else:
            yield w


def _batch_args(words: torch.Tensor, vlen: Optional[torch.Tensor],
                vbytes: Optional[torch.Tensor], length: int, k: int,
                canonical: bool) -> tuple:
    """The leading arguments both C count entry points take: device,
    codes/words/vlen/vbytes pointers (None where absent), n_rows, W, VB,
    L, k, canonical."""
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    raw = vlen is None and vbytes is None
    return (words.device.index, words.data_ptr() if raw else None,
            None if raw else words.data_ptr(), ptr(vlen), ptr(vbytes),
            words.shape[0], 0 if raw else words.shape[1],
            0 if vbytes is None else vbytes.shape[1], length, k,
            int(canonical))


def _check_k(k: int, length: int) -> None:
    if not 1 <= k <= 31 or length - k + 1 <= 0:
        raise ValueError(f"k={k} does not fit reads of length {length}")


def _add_ones(counts: torch.Tensor, slots: torch.Tensor, trash: int) -> None:
    """counts[slot] += 1 for every hit slot; the rest into counts[trash]."""
    slots = slots.reshape(-1).to(torch.int64)
    safe = torch.where((slots >= 0) & (slots < trash), slots, trash)
    counts.index_add_(0, safe, torch.ones_like(safe, dtype=counts.dtype))


# -------------------------------------------------------------- count_fp
def count_fp_plain(counts: torch.Tensor, words: torch.Tensor,
                   fp_table: torch.Tensor, *, length: int, k: int, seed: int,
                   canonical: bool = False,
                   vlen: Optional[torch.Tensor] = None,
                   vbytes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of :func:`count_fp`, in row chunks of PLAIN_CHUNK_ROWS."""
    n_buckets, bucket = fp_table.shape
    for codes in _chunks(words, vlen, vbytes, length):
        b, fp = probe_prep_plain(codes, k=k, n_buckets=n_buckets, seed=seed,
                                 canonical=canonical)
        _add_ones(counts, lookup_fp_from_prep(fp_table, b, fp, bucket),
                  n_buckets * bucket)
    return counts


def count_fp(counts: torch.Tensor, words: torch.Tensor,
             fp_table: torch.Tensor, *, length: int, k: int, seed: int,
             canonical: bool = False, vlen: Optional[torch.Tensor] = None,
             vbytes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add one read batch into slot-space ``counts`` IN PLACE.

    Args:
      counts: int32 ``[n_buckets * bucket + 1]``; the last entry is the
        trash slot, which gains one per window that does not hit.
      words: int32 ``[B, ceil(L/16)]`` 2-bit packed bases (uint32 bits,
        ``pack.bitpack_codes``), or uint8 ``[B, L]`` raw codes.
      fp_table: int32 ``[n_buckets, bucket]`` fingerprints (uint32 bits).
      length: read length L the batch encodes.
      vlen: uint16 ``[B]`` valid prefix lengths, or
      vbytes: uint8 ``[B, ceil(L/8)]`` LSB-first validity bits; neither
        for raw codes.

    Returns ``counts``.
    """
    valid = _payload(words, vlen, vbytes, length)
    _check(fp_table, "fp_table", torch.int32, 2)
    _check(counts, "counts", torch.int32, 1)
    n_buckets, bucket = fp_table.shape
    if counts.shape[0] != n_buckets * bucket + 1:
        raise ValueError(f"counts has {counts.shape[0]} entries, want "
                         f"{n_buckets * bucket + 1}")
    if n_buckets & (n_buckets - 1):
        raise ValueError(f"n_buckets={n_buckets} is not a power of two")
    _check_k(k, length)
    extra = () if valid is None else (valid,)
    if not _route(counts, words, fp_table, *extra):
        return count_fp_plain(counts, words, fp_table, length=length, k=k,
                              seed=seed, canonical=canonical, vlen=vlen,
                              vbytes=vbytes)
    lib = _build.lib()
    _build.check(lib.count_fp_launch(
        *_batch_args(words, vlen, vbytes, length, k, canonical),
        fp_table.data_ptr(), n_buckets, bucket, seed & 0xFFFFFFFF,
        counts.data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream),
        "count_fp_kernel launch")
    LAUNCHES["count_fp_kernel"] += 1
    return counts


# ----------------------------------------------------------- count_exact
def count_exact_plain(counts: torch.Tensor, words: torch.Tensor,
                      table: torch.Tensor, *, length: int, k: int,
                      max_probe: int, canonical: bool = False,
                      vlen: Optional[torch.Tensor] = None,
                      vbytes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of :func:`count_exact`, in row chunks of
    PLAIN_CHUNK_ROWS (``_count_core`` of the JAX package)."""
    n_buckets = table.shape[0]
    for codes in _chunks(words, vlen, vbytes, length):
        hi, lo, ok = kdev.extract_kmers(codes, k)
        if canonical:
            hi, lo = kdev.canonical(hi, lo, k)
        ids = lookup_exact(table, n_buckets, max_probe, hi, lo)
        _add_ones(counts, torch.where(ok, ids, -1), counts.shape[0] - 1)
    return counts


def count_exact(counts: torch.Tensor, words: torch.Tensor,
                table: torch.Tensor, *, length: int, k: int, max_probe: int,
                canonical: bool = False, vlen: Optional[torch.Tensor] = None,
                vbytes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add one read batch into id-space ``counts`` IN PLACE, exact probe.

    Args:
      counts: int32 ``[n_keys + 1]``; the last entry is the trash entry,
        which gains one per window that does not hit.
      words, length, vlen, vbytes: the read batch, as for :func:`count_fp`.
      table: int32 ``[n_buckets, 24]`` interleaved exact table
        (``KmerTable.interleaved``: hi, lo, val per slot).
      max_probe: rows probed per window (``KmerTable.max_probe``).

    Returns ``counts``.
    """
    valid = _payload(words, vlen, vbytes, length)
    _check(table, "table", torch.int32, 2)
    _check(counts, "counts", torch.int32, 1)
    n_buckets = table.shape[0]
    if table.shape[1] != 24:
        raise ValueError(f"table rows hold {table.shape[1]} int32, want 24")
    if n_buckets & (n_buckets - 1) or n_buckets == 0:
        raise ValueError(f"n_buckets={n_buckets} is not a power of two")
    _check_k(k, length)
    extra = () if valid is None else (valid,)
    if not _route(counts, words, table, *extra):
        return count_exact_plain(counts, words, table, length=length, k=k,
                                 max_probe=max_probe, canonical=canonical,
                                 vlen=vlen, vbytes=vbytes)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (row vector loads)")
    lib = _build.lib()
    _build.check(lib.count_exact_launch(
        *_batch_args(words, vlen, vbytes, length, k, canonical),
        table.data_ptr(), n_buckets, max_probe, counts.shape[0] - 1,
        counts.data_ptr(),
        torch.cuda.current_stream(words.device).cuda_stream),
        "count_exact_kernel launch")
    LAUNCHES["count_exact_kernel"] += 1
    return counts
