"""Kernel wrappers of the count hot path, each beside its plain twin.

* :func:`probe_prep` -> ``probe_prep_kernel``: per-window (bucket, fp) of
  uint8 code rows; port of the Pallas kernel
  ``strainscan_tpu/ops/pallas_probe.py::probe_prep``.
* :func:`count_fp`: the main-path count of a read batch into slot-space
  counts, in place, as four kernels (``csrc/count_fp_bins.cu``):
  :func:`fp_bin_count` -> ``fp_bin_count_kernel`` (walk each read's valid
  windows with a rolling key, count them per bin of buckets),
  :func:`bin_scan` -> ``bin_scan_kernel`` (bin starts),
  :func:`fp_bin_scatter` -> ``fp_bin_scatter_kernel`` (each window's
  ``(fp, bucket)`` into bin order) and :func:`fp_bin_probe` ->
  ``fp_bin_probe_kernel`` (each bin's table rows staged in shared memory,
  its windows resolved there, one added to the hit slot or to the trash
  slot).  :func:`fp_bin_parity` holds each against its twin.
* :func:`count_exact`: the exact probe mode, in place, as two kernels
  (``csrc/count_exact.cu``): :func:`exact_probe` -> ``count_exact_kernel``
  (each read's valid windows walked with the same rolling key, queued per
  warp, then up to ``max_probe`` reads of the interleaved exact-table row;
  misses into the trash entry, hit ids into a hit list) and
  :func:`exact_apply` -> ``exact_apply_kernel`` (one added to each listed
  id, one L2-sized slice of the id space at a time).  :func:`exact_parity`
  holds each against what it must compute.

Both count wrappers take a read batch in one of three payload forms: int32
2-bit words with ``vlen`` (valid prefix lengths) or ``vbytes`` (validity
bits), or uint8 raw codes ``[B, L]`` (then neither ``vlen`` nor ``vbytes``).

A tensor on the CPU goes to the plain twin (``*_plain``).  A CUDA tensor
launches the kernel on ``torch.cuda.current_stream()`` without
synchronising, or raises.  ``LAUNCHES`` counts kernel launches per kernel
name; callers reset it with :func:`reset_launches`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from strainscan_tpu_torch.index.hashtable import (fp2, lookup_exact,
                                                  lookup_fp_from_prep, mix)
from strainscan_tpu_torch.kmer import device as kdev
from strainscan_tpu_torch.ops import _build

# every kernel's launches, the measurement path's row_gather_kernel
# (ops/gather.py) included, so reset_launches covers them all
LAUNCHES = {"probe_prep_kernel": 0, "fp_bin_count_kernel": 0,
            "bin_scan_kernel": 0, "fp_bin_scatter_kernel": 0,
            "fp_bin_probe_kernel": 0, "count_exact_kernel": 0,
            "exact_apply_kernel": 0, "row_gather_kernel": 0}

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
# The binned design of count_fp (csrc/count_fp_bins.cu): a bin is a slice of
# 2**shift consecutive buckets, at most SLICE_BYTES of table, so a block can
# stage it in shared memory; the count and scatter kernels keep a histogram
# of at most MAX_BINS bins in shared memory, so a table of more than
# MAX_BINS * SLICE_BYTES (2 GiB) gets larger bins whose rows are read from
# global memory.
SLICE_BYTES = 1 << 16
MAX_BINS = 1 << 15
RUN = 64              # windows per thread work item (kRun)
# count and scatter blocks per multiprocessor: at 16 (two waves of 32-row
# blocks at 65,536 reads) the scatter's concurrent pair writes cover half
# the pairs buffer, not all of it; chip_smoke.py times 1, 4 and 16
BLOCKS_PER_SM = 16
# rows per chunk of the plain probe (its [rows, bucket] gather: 256 MiB at
# bucket 64)
PLAIN_CHUNK_PAIRS = 1 << 20


def fp_bin_shift(n_buckets: int, bucket: int) -> int:
    """log2 of the buckets per bin of a ``[n_buckets, bucket]`` table."""
    rows = max(1, SLICE_BYTES // (4 * bucket))
    shift = min(rows.bit_length() - 1, n_buckets.bit_length() - 1)
    while n_buckets >> shift > MAX_BINS:
        shift += 1
    return shift


def fp_bin_stride(bucket: int, shift: int, vec: bool) -> int:
    """Words per row of a bin staged in shared memory (padded so that rows
    start on different banks), or 0 when the bin does not fit."""
    if (bucket << shift) * 4 > SLICE_BYTES:
        return 0
    return bucket + 4 if vec else bucket | 1


def fp_bin_blocks(n_rows: int, device: torch.device) -> tuple:
    """``(n_blocks, rows_per_block)`` of the count and scatter kernels."""
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 8)
    per = max(1, -(-n_rows // (BLOCKS_PER_SM * sms)))
    return -(-n_rows // per), per


class FpScratch:
    """The binned count's device buffers, per device, grown on demand and
    reused by every batch: the bin totals (all zero between batches), the
    bin starts, each block's offsets inside the bins and the binned
    ``(fp, bucket)`` pairs (8 B per window).  A pipeline holds one; batches
    on one device must run on one stream."""

    def __init__(self):
        self._bufs: dict = {}

    def buffers(self, device: torch.device, n_bins: int, n_blocks: int,
                n_pairs: int):
        """``(bin_count [n_bins], bin_start [n_bins + 1], block_base
        [n_blocks, n_bins], pairs [n_pairs, 2])`` int32 on ``device``."""
        want = (n_bins, n_bins + 1, n_blocks * n_bins, max(n_pairs, 1))
        have = self._bufs.get(str(device))
        if have is None or any(h.shape[0] < w for h, w in zip(have, want)):
            size = want if have is None else [
                max(h.shape[0], w) for h, w in zip(have, want)]
            have = (torch.zeros(size[0], dtype=torch.int32, device=device),
                    torch.empty(size[1], dtype=torch.int32, device=device),
                    torch.empty(size[2], dtype=torch.int32, device=device),
                    torch.empty((size[3], 2), dtype=torch.int32,
                                device=device))
            self._bufs[str(device)] = have
        bc, bs, bb, pairs = have
        return (bc[:n_bins], bs[:n_bins + 1],
                bb[:n_blocks * n_bins].view(n_blocks, n_bins),
                pairs[:max(n_pairs, 1)])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _valid_windows(words, vlen, vbytes, length, k, seed, n_buckets,
                   canonical):
    """Plain walk of a batch: per chunk of rows, ``(row0, bucket_or_neg
    [rows, M], fp [rows, M])``."""
    row0 = 0
    for codes in _chunks(words, vlen, vbytes, length):
        b, fp = probe_prep_plain(codes, k=k, n_buckets=n_buckets, seed=seed,
                                 canonical=canonical)
        yield row0, b, fp
        row0 += codes.shape[0]


def _binned(words, vlen, vbytes, length, k, seed, n_buckets, canonical,
            shift, rows_per_block, n_bins):
    """Every valid window of a batch in row-major order: ``(cell, fp,
    bucket)`` with cell = block * n_bins + bin, and the non-valid count."""
    cells, fps, bks, bad = [], [], [], 0
    for row0, b, fp in _valid_windows(words, vlen, vbytes, length, k, seed,
                                      n_buckets, canonical):
        rows = torch.arange(row0, row0 + b.shape[0], device=b.device)
        blk = (rows // rows_per_block)[:, None].expand_as(b)
        ok = b >= 0
        bad += int((~ok).sum())
        cells.append(blk[ok].to(torch.int64) * n_bins
                     + (b[ok] >> shift).to(torch.int64))
        fps.append(fp[ok])
        bks.append(b[ok])
    return torch.cat(cells), torch.cat(fps), torch.cat(bks), bad


def fp_bin_count_plain(bin_count, block_base, counts, words, *, length, k,
                       seed, n_buckets, shift, rows_per_block,
                       canonical=False, vlen=None, vbytes=None):
    """Plain twin of :func:`fp_bin_count`: blocks reserve their ranges in
    block order (the kernel's order is the atomics' order)."""
    n_blocks, n_bins = block_base.shape
    cells, _, _, bad = _binned(words, vlen, vbytes, length, k, seed,
                               n_buckets, canonical, shift, rows_per_block,
                               n_bins)
    hist = torch.bincount(cells, minlength=n_blocks * n_bins).view(
        n_blocks, n_bins)
    base = hist.cumsum(0) - hist + bin_count.to(torch.int64)
    block_base.copy_(torch.where(hist > 0, base, 0))
    bin_count += hist.sum(0).to(torch.int32)
    counts[-1] += bad
    return bin_count


def fp_bin_count(bin_count: torch.Tensor, block_base: torch.Tensor,
                 counts: torch.Tensor, words: torch.Tensor, *, length: int,
                 k: int, seed: int, n_buckets: int, shift: int,
                 rows_per_block: int, canonical: bool = False,
                 vlen: Optional[torch.Tensor] = None,
                 vbytes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First pass of the binned count: add the batch's valid windows per
    bin (``bucket >> shift``) into ``bin_count`` int32 ``[n_bins]``, write
    each block's offset inside each bin into ``block_base`` int32
    ``[n_blocks, n_bins]`` (block i: rows ``[i * rows_per_block, (i + 1) *
    rows_per_block)``), and add the invalid and padding windows to the
    trash slot ``counts[-1]``.  The batch is as for :func:`count_fp`."""
    valid = _payload(words, vlen, vbytes, length)
    for t, name in ((bin_count, "bin_count"), (counts, "counts")):
        _check(t, name, torch.int32, 1)
    _check(block_base, "block_base", torch.int32, 2)
    _check_k(k, length)
    n_blocks, n_bins = block_base.shape
    if (bin_count.shape[0] != n_bins or n_bins != n_buckets >> shift
            or -(-words.shape[0] // rows_per_block) != n_blocks):
        raise ValueError(f"{n_blocks} x {n_bins} blocks x bins do not fit "
                         f"{words.shape[0]} rows of {rows_per_block} and "
                         f"{n_buckets} >> {shift} buckets")
    extra = () if valid is None else (valid,)
    kw = dict(length=length, k=k, seed=seed, n_buckets=n_buckets,
              shift=shift, rows_per_block=rows_per_block,
              canonical=canonical, vlen=vlen, vbytes=vbytes)
    if not _route(bin_count, block_base, counts, words, *extra):
        return fp_bin_count_plain(bin_count, block_base, counts, words, **kw)
    _build.check(_build.lib().fp_bin_count_launch(
        *_batch_args(words, vlen, vbytes, length, k, canonical), n_buckets,
        seed & 0xFFFFFFFF, shift, n_bins, n_blocks, rows_per_block,
        bin_count.data_ptr(), block_base.data_ptr(), counts.data_ptr(),
        counts.shape[0] - 1, _stream(words)), "fp_bin_count_kernel launch")
    LAUNCHES["fp_bin_count_kernel"] += 1
    return bin_count


def bin_scan_plain(bin_count: torch.Tensor,
                   bin_start: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`bin_scan`."""
    bin_start[0] = 0
    bin_start[1:] = bin_count.cumsum(0)
    bin_count.zero_()
    return bin_start


def bin_scan(bin_count: torch.Tensor, bin_start: torch.Tensor) -> torch.Tensor:
    """``bin_start`` int32 ``[n_bins + 1]`` = the exclusive prefix sums of
    ``bin_count`` int32 ``[n_bins]`` and their total; zeroes
    ``bin_count`` for the next batch."""
    _check(bin_count, "bin_count", torch.int32, 1)
    _check(bin_start, "bin_start", torch.int32, 1)
    if bin_start.shape[0] != bin_count.shape[0] + 1:
        raise ValueError("bin_start must hold one entry more than bin_count")
    if not _route(bin_count, bin_start):
        return bin_scan_plain(bin_count, bin_start)
    _build.check(_build.lib().bin_scan_launch(
        bin_count.device.index, bin_count.data_ptr(), bin_count.shape[0],
        bin_start.data_ptr(), _stream(bin_count)), "bin_scan_kernel launch")
    LAUNCHES["bin_scan_kernel"] += 1
    return bin_start


def fp_bin_scatter_plain(pairs, bin_start, block_base, words, *, length, k,
                         seed, n_buckets, shift, rows_per_block,
                         canonical=False, vlen=None, vbytes=None):
    """Plain twin of :func:`fp_bin_scatter`: inside a block's range of a
    bin the windows keep row-major order (the kernel's order is the
    atomics' order)."""
    n_bins = block_base.shape[1]
    cells, fps, bks, _ = _binned(words, vlen, vbytes, length, k, seed,
                                 n_buckets, canonical, shift,
                                 rows_per_block, n_bins)
    order = torch.argsort(cells, stable=True)
    cells = cells[order]
    first = torch.searchsorted(cells, cells, right=False)
    rank = torch.arange(cells.shape[0], device=cells.device) - first
    pos = (bin_start[:-1].to(torch.int64)[cells % n_bins]
           + block_base.reshape(-1).to(torch.int64)[cells] + rank)
    pairs[pos, 0] = fps[order]
    pairs[pos, 1] = bks[order]
    return pairs


def fp_bin_scatter(pairs: torch.Tensor, bin_start: torch.Tensor,
                   block_base: torch.Tensor, words: torch.Tensor, *,
                   length: int, k: int, seed: int, n_buckets: int,
                   shift: int, rows_per_block: int, canonical: bool = False,
                   vlen: Optional[torch.Tensor] = None,
                   vbytes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Second pass of the binned count: write every valid window's
    ``(fp, bucket)`` into ``pairs`` int32 ``[>= bin_start[-1], 2]`` in bin
    order, at ``bin_start[bin] + block_base[block, bin]`` plus its rank
    among its block's windows of that bin.  The same batch and blocks as
    :func:`fp_bin_count`."""
    valid = _payload(words, vlen, vbytes, length)
    _check(pairs, "pairs", torch.int32, 2)
    _check(bin_start, "bin_start", torch.int32, 1)
    _check(block_base, "block_base", torch.int32, 2)
    _check_k(k, length)
    n_blocks, n_bins = block_base.shape
    if (bin_start.shape[0] != n_bins + 1 or pairs.shape[1] != 2
            or n_bins != n_buckets >> shift
            or -(-words.shape[0] // rows_per_block) != n_blocks):
        raise ValueError("pairs, bin_start and block_base do not fit the "
                         "batch")
    extra = () if valid is None else (valid,)
    kw = dict(length=length, k=k, seed=seed, n_buckets=n_buckets,
              shift=shift, rows_per_block=rows_per_block,
              canonical=canonical, vlen=vlen, vbytes=vbytes)
    if not _route(pairs, bin_start, block_base, words, *extra):
        return fp_bin_scatter_plain(pairs, bin_start, block_base, words, **kw)
    _build.check(_build.lib().fp_bin_scatter_launch(
        *_batch_args(words, vlen, vbytes, length, k, canonical), n_buckets,
        seed & 0xFFFFFFFF, shift, n_bins, n_blocks, rows_per_block,
        bin_start.data_ptr(), block_base.data_ptr(), pairs.data_ptr(),
        _stream(words)), "fp_bin_scatter_kernel launch")
    LAUNCHES["fp_bin_scatter_kernel"] += 1
    return pairs


def fp_bin_probe_plain(counts: torch.Tensor, pairs: torch.Tensor,
                       bin_start: torch.Tensor, fp_table: torch.Tensor, *,
                       shift: int) -> torch.Tensor:
    """Plain twin of :func:`fp_bin_probe`, PLAIN_CHUNK_PAIRS at a time."""
    bucket = fp_table.shape[1]
    trash = counts.shape[0] - 1
    for i in range(0, int(bin_start[-1]), PLAIN_CHUNK_PAIRS):
        p = pairs[i:min(i + PLAIN_CHUNK_PAIRS, int(bin_start[-1]))]
        _add_ones(counts, lookup_fp_from_prep(fp_table, p[:, 1], p[:, 0],
                                              bucket), trash)
    return counts


def fp_bin_probe(counts: torch.Tensor, pairs: torch.Tensor,
                 bin_start: torch.Tensor, fp_table: torch.Tensor, *,
                 shift: int) -> torch.Tensor:
    """Last pass of the binned count: look every binned ``(fp, bucket)``
    pair up in its fingerprint row (the lowest matching lane) and add one to
    its slot of ``counts``, or to the trash slot ``counts[-1]`` on a miss.
    A persistent grid walks the bins, staging each bin's rows in shared
    memory."""
    _check(counts, "counts", torch.int32, 1)
    _check(pairs, "pairs", torch.int32, 2)
    _check(bin_start, "bin_start", torch.int32, 1)
    _check(fp_table, "fp_table", torch.int32, 2)
    n_buckets, bucket = fp_table.shape
    n_bins = bin_start.shape[0] - 1
    if counts.shape[0] != n_buckets * bucket + 1:
        raise ValueError(f"counts has {counts.shape[0]} entries, want "
                         f"{n_buckets * bucket + 1}")
    if n_bins != n_buckets >> shift or n_bins << shift != n_buckets:
        raise ValueError(f"{n_bins} bins do not tile {n_buckets} buckets "
                         f"at shift {shift}")
    if not _route(counts, pairs, bin_start, fp_table):
        return fp_bin_probe_plain(counts, pairs, bin_start, fp_table,
                                  shift=shift)
    vec = bucket % 4 == 0 and fp_table.data_ptr() % 16 == 0
    _build.check(_build.lib().fp_bin_probe_launch(
        counts.device.index, pairs.data_ptr(), bin_start.data_ptr(), n_bins,
        fp_table.data_ptr(), bucket, shift, fp_bin_stride(bucket, shift, vec),
        int(vec), counts.data_ptr(), counts.shape[0] - 1, _stream(counts)),
        "fp_bin_probe_kernel launch")
    LAUNCHES["fp_bin_probe_kernel"] += 1
    return counts


def count_fp_plain(counts: torch.Tensor, words: torch.Tensor,
                   fp_table: torch.Tensor, *, length: int, k: int, seed: int,
                   canonical: bool = False,
                   vlen: Optional[torch.Tensor] = None,
                   vbytes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of :func:`count_fp`, in row chunks of PLAIN_CHUNK_ROWS."""
    n_buckets, bucket = fp_table.shape
    for _, b, fp in _valid_windows(words, vlen, vbytes, length, k, seed,
                                   n_buckets, canonical):
        _add_ones(counts, lookup_fp_from_prep(fp_table, b, fp, bucket),
                  n_buckets * bucket)
    return counts


def count_fp(counts: torch.Tensor, words: torch.Tensor,
             fp_table: torch.Tensor, *, length: int, k: int, seed: int,
             canonical: bool = False, vlen: Optional[torch.Tensor] = None,
             vbytes: Optional[torch.Tensor] = None,
             scratch: Optional[FpScratch] = None) -> torch.Tensor:
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
      scratch: the buffers of the binned kernels (a caller that counts many
        batches keeps one); a fresh one when None.

    On a CUDA device: :func:`fp_bin_count`, :func:`bin_scan`,
    :func:`fp_bin_scatter`, :func:`fp_bin_probe`.  Returns ``counts``.
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
    n_rows = words.shape[0]
    if n_rows == 0:
        return counts
    shift = fp_bin_shift(n_buckets, bucket)
    n_blocks, per = fp_bin_blocks(n_rows, words.device)
    bin_count, bin_start, block_base, pairs = (scratch or FpScratch()).buffers(
        words.device, n_buckets >> shift, n_blocks,
        n_rows * (length - k + 1))
    kw = dict(length=length, k=k, seed=seed, n_buckets=n_buckets,
              shift=shift, rows_per_block=per, canonical=canonical,
              vlen=vlen, vbytes=vbytes)
    fp_bin_count(bin_count, block_base, counts, words, **kw)
    bin_scan(bin_count, bin_start)
    fp_bin_scatter(pairs, bin_start, block_base, words, **kw)
    return fp_bin_probe(counts, pairs, bin_start, fp_table, shift=shift)


def fp_bin_parity(words: torch.Tensor, fp_table: torch.Tensor, *,
                  length: int, k: int, seed: int, canonical: bool = False,
                  vlen: Optional[torch.Tensor] = None,
                  vbytes: Optional[torch.Tensor] = None) -> dict:
    """Each binned kernel against its plain twin on the same inputs:
    ``{kernel name: max |kernel - plain|}`` over what it writes.  The bin
    totals, bin starts, trash slot and probe counts must be equal; the
    pairs, as a multiset within each bin (the kernels' order inside a bin is
    the order of their atomics, and a wrong block offset would overwrite
    pairs); the probe runs both on the plain scatter's pairs."""
    dev = words.device
    n_buckets, bucket = fp_table.shape
    shift = fp_bin_shift(n_buckets, bucket)
    n_bins = n_buckets >> shift
    n_blocks, per = fp_bin_blocks(words.shape[0], dev)
    kw = dict(length=length, k=k, seed=seed, n_buckets=n_buckets,
              shift=shift, rows_per_block=per, canonical=canonical,
              vlen=vlen, vbytes=vbytes)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    def err(a, b):
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return int(d.max()) if d.numel() else 0

    bc, bb, c = zeros(n_bins), zeros(n_blocks, n_bins), zeros(
        n_buckets * bucket + 1)
    pbc, pbb, pc = bc.clone(), bb.clone(), c.clone()
    fp_bin_count(bc, bb, c, words, **kw)
    fp_bin_count_plain(pbc, pbb, pc, words, **kw)
    out = {"fp_bin_count_kernel": max(err(bc, pbc), err(c, pc))}
    bs, pbs = zeros(n_bins + 1), zeros(n_bins + 1)
    bin_scan(bc, bs)
    bin_scan_plain(pbc, pbs)
    out["bin_scan_kernel"] = max(err(bs, pbs), err(bc, pbc))
    n = int(pbs[-1])
    pairs, ppairs = zeros(max(n, 1), 2), zeros(max(n, 1), 2)
    fp_bin_scatter(pairs, bs, bb, words, **kw)
    fp_bin_scatter_plain(ppairs, pbs, pbb, words, **kw)

    def keys(p):
        p = p[:n].to(torch.int64)
        return torch.sort((p[:, 1] << 32) | (p[:, 0] & 0xFFFFFFFF)).values

    pos = torch.arange(n, device=dev)
    in_bin = (pairs[:n, 1] >> shift).to(torch.int64) == (
        torch.searchsorted(pbs.to(torch.int64), pos, right=True) - 1)
    out["fp_bin_scatter_kernel"] = (err(keys(pairs), keys(ppairs))
                                    if bool(in_bin.all()) else 1 << 62)
    c1, c2 = c.clone(), c.clone()
    fp_bin_probe(c1, ppairs, pbs, fp_table, shift=shift)
    fp_bin_probe_plain(c2, ppairs, pbs, fp_table, shift=shift)
    out["fp_bin_probe_kernel"] = err(c1, c2)
    return out


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


def _exact_checks(counts, words, table, length, k, vlen, vbytes):
    """Check count_exact's arguments; return the tensors to route on."""
    valid = _payload(words, vlen, vbytes, length)
    _check(table, "table", torch.int32, 2)
    _check(counts, "counts", torch.int32, 1)
    n_buckets = table.shape[0]
    if table.shape[1] != 24:
        raise ValueError(f"table rows hold {table.shape[1]} int32, want 24")
    if n_buckets & (n_buckets - 1) or n_buckets == 0:
        raise ValueError(f"n_buckets={n_buckets} is not a power of two")
    _check_k(k, length)
    return (counts, words, table) + (() if valid is None else (valid,))


def exact_probe_plain(counts: torch.Tensor, words: torch.Tensor,
                      table: torch.Tensor, *, length: int, k: int,
                      max_probe: int, canonical: bool = False,
                      vlen: Optional[torch.Tensor] = None,
                      vbytes: Optional[torch.Tensor] = None) -> tuple:
    """Plain twin of :func:`exact_probe`: one region that lists every hit
    in window order."""
    n_keys = counts.shape[0] - 1
    ids = []
    for codes in _chunks(words, vlen, vbytes, length):
        hi, lo, ok = kdev.extract_kmers(codes, k)
        if canonical:
            hi, lo = kdev.canonical(hi, lo, k)
        got = lookup_exact(table, table.shape[0], max_probe, hi, lo)
        ids.append(got[ok & (got >= 0) & (got < n_keys)].to(torch.int32))
    hits = torch.cat(ids).view(1, -1) if ids else torch.zeros(
        (1, 0), dtype=torch.int32, device=words.device)
    counts[n_keys] += words.shape[0] * (length - k + 1) - hits.shape[1]
    return hits, torch.tensor([hits.shape[1]], dtype=torch.int32,
                              device=words.device)


def exact_probe(counts: torch.Tensor, words: torch.Tensor,
                table: torch.Tensor, *, length: int, k: int, max_probe: int,
                canonical: bool = False, vlen: Optional[torch.Tensor] = None,
                vbytes: Optional[torch.Tensor] = None) -> tuple:
    """The probe stage of :func:`count_exact`: every window that misses (or
    is invalid, or padding) adds one to the trash entry ``counts[n_keys]``,
    and the ids of the hits are listed.

    Returns the hit list ``(hits int32 [regions, region], n_hits int32
    [regions])``: region r lists ids in its first ``n_hits[r]`` entries (the
    rest is unset).  The kernel's regions, their size and the order inside
    them are its own (``csrc/count_exact.cu`` sizes the list); only the
    multiset of listed ids is the stage's result.
    """
    route = _exact_checks(counts, words, table, length, k, vlen, vbytes)
    kw = dict(length=length, k=k, max_probe=max_probe, canonical=canonical,
              vlen=vlen, vbytes=vbytes)
    if not _route(*route):
        return exact_probe_plain(counts, words, table, **kw)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (row vector loads)")
    lib = _build.lib()
    args = _batch_args(words, vlen, vbytes, length, k, canonical)
    shape = (ctypes.c_longlong * 2)()
    lib.count_exact_list_shape(*args, shape)
    hits = torch.empty((shape[0], shape[1]), dtype=torch.int32,
                       device=words.device)
    n_hits = torch.empty(shape[0], dtype=torch.int32, device=words.device)
    _build.check(lib.count_exact_launch(
        *args, table.data_ptr(), table.shape[0], max_probe,
        counts.shape[0] - 1, counts.data_ptr(), hits.data_ptr(), shape[1],
        n_hits.data_ptr(), _stream(words)), "count_exact_kernel launch")
    LAUNCHES["count_exact_kernel"] += 1
    return hits, n_hits


def listed_ids(hits: torch.Tensor, n_hits: torch.Tensor) -> torch.Tensor:
    """The listed ids of a hit list, int64."""
    mask = (torch.arange(hits.shape[1], device=hits.device)[None, :]
            < n_hits[:, None])
    return hits[mask].to(torch.int64)


def exact_apply_plain(counts: torch.Tensor, hits: torch.Tensor,
                      n_hits: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`exact_apply`."""
    ids = listed_ids(hits, n_hits)
    counts.index_add_(0, ids, torch.ones_like(ids, dtype=counts.dtype))
    return counts


def exact_apply(counts: torch.Tensor, hits: torch.Tensor,
                n_hits: torch.Tensor, *, slice_ids: int = 0) -> torch.Tensor:
    """The add stage of :func:`count_exact`: one added to ``counts[id]``
    for each id of the hit list of :func:`exact_probe`, in place, one slice
    of ``slice_ids`` ids of ``counts`` at a time (0: the kernel's choice, a
    third of the card's L2).  Returns ``counts``."""
    _check(counts, "counts", torch.int32, 1)
    _check(hits, "hits", torch.int32, 2)
    _check(n_hits, "n_hits", torch.int32, 1)
    if n_hits.shape[0] != hits.shape[0]:
        raise ValueError("n_hits rows differ from hits rows")
    if not _route(counts, hits, n_hits):
        return exact_apply_plain(counts, hits, n_hits)
    _build.check(_build.lib().exact_apply_launch(
        counts.device.index, hits.data_ptr(), n_hits.data_ptr(),
        hits.shape[1], hits.shape[0], counts.data_ptr(), counts.shape[0] - 1,
        slice_ids, _stream(counts)), "exact_apply_kernel launch")
    LAUNCHES["exact_apply_kernel"] += 1
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
    route = _exact_checks(counts, words, table, length, k, vlen, vbytes)
    kw = dict(length=length, k=k, max_probe=max_probe, canonical=canonical,
              vlen=vlen, vbytes=vbytes)
    if not _route(*route):
        return count_exact_plain(counts, words, table, **kw)
    return exact_apply(counts, *exact_probe(counts, words, table, **kw))


def exact_parity(words: torch.Tensor, table: torch.Tensor, n_keys: int, *,
                 length: int, k: int, max_probe: int, canonical: bool = False,
                 vlen: Optional[torch.Tensor] = None,
                 vbytes: Optional[torch.Tensor] = None,
                 slice_ids: int = 0) -> dict:
    """Each kernel of :func:`count_exact` against what it must compute, on
    the same inputs: ``{kernel name: max |kernel - plain|}``.  The probe's
    trash entry and the bincount of its listed ids must equal
    :func:`count_exact_plain`'s counts (the list's layout and order are the
    kernel's own); the add stage runs beside its plain twin on the probe's
    list."""
    kw = dict(length=length, k=k, max_probe=max_probe, canonical=canonical,
              vlen=vlen, vbytes=vbytes)

    def err(a, b):
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return int(d.max()) if d.numel() else 0

    want = torch.zeros(n_keys + 1, dtype=torch.int32, device=words.device)
    count_exact_plain(want, words, table, **kw)
    got = torch.zeros_like(want)
    hits, n_hits = exact_probe(got, words, table, **kw)
    ids = listed_ids(hits, n_hits)
    stray = (ids < 0) | (ids >= n_keys)   # listed, but not an id
    got[:-1] += torch.bincount(ids[~stray], minlength=n_keys).to(torch.int32)
    out = {"count_exact_kernel": max(err(got, want), int(stray.sum()))}
    a1, a2 = torch.zeros_like(want), torch.zeros_like(want)
    exact_apply(a1, hits, n_hits, slice_ids=slice_ids)
    exact_apply_plain(a2, hits, n_hits)
    out["exact_apply_kernel"] = err(a1, a2)
    return out
