"""Kernel wrappers of the count hot path, each beside its plain twin.

* :func:`probe_prep` -> ``probe_prep_kernel``: per-window (bucket, fp) of
  uint8 code rows; port of the Pallas kernel
  ``strainscan_tpu/ops/pallas_probe.py::probe_prep``.
* :func:`count_fp`: the main-path count of a read batch into slot-space
  counts, in place, as four kernels (``csrc/count_fp_bins.cu``): a bin sort
  of the batch's windows by table slice (:func:`fp_bin_front`), then the
  probe.  :func:`fp_coarse_count` -> ``fp_coarse_count_kernel`` (walk each
  read's valid windows with a rolling key, count them per coarse bin of
  buckets, reserve each block's range), :func:`fp_coarse_scatter` ->
  ``fp_coarse_scatter_kernel`` (walk again, write each window's ``(fp,
  bucket)`` into coarse-bin order through shared memory),
  :func:`fp_fine_split` -> ``fp_fine_split_kernel`` (each coarse bin's pairs
  into fine-bin order, and the fine bins' starts) and :func:`fp_bin_probe`
  -> ``fp_bin_probe_kernel`` (each fine bin's table rows staged in shared
  memory, its windows resolved there, one added to the hit slot or to the
  trash slot).  :func:`fp_bin_parity` holds each against its twin.
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
from typing import NamedTuple, Optional

import torch

from strainscan_tpu_torch.index.hashtable import (fp2, lookup_exact,
                                                  lookup_fp_from_prep, mix)
from strainscan_tpu_torch.kmer import device as kdev
from strainscan_tpu_torch.ops import _build

# every kernel's launches, the measurement path's row_gather_kernel
# (ops/gather.py) included, so reset_launches covers them all
LAUNCHES = {"probe_prep_kernel": 0, "fp_coarse_count_kernel": 0,
            "fp_coarse_scatter_kernel": 0, "fp_fine_split_kernel": 0,
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
# The binned design of count_fp (csrc/count_fp_bins.cu).  A fine bin is a
# slice of 2**shift consecutive buckets, at most SLICE_BYTES of table, so a
# probe block can stage it in shared memory; a table of more than MAX_BINS *
# SLICE_BYTES (2 GiB) gets larger fine bins whose rows are read from global
# memory.  The windows reach the probe grouped by fine bin through a bin sort
# of two digits: a coarse bin is a run of consecutive fine bins, at most
# COARSE_BINS of them in all.
SLICE_BYTES = 1 << 16
MAX_BINS = 1 << 15
# coarse bins of the first digit (at most 256, kBinThreads: one per thread
# of the coarse passes); bench/fp_bin_study.py times 64, 128 and 256
COARSE_BINS = 256
# coarse-pass blocks per multiprocessor, from which the rows per block
# follow; bench/fp_bin_study.py times other rows per block
BLOCKS_PER_SM = 16
# pairs (8 B each) a coarse-scatter block stages in shared memory; a block
# takes fewer rows when their windows would not fit
STAGE_PAIRS = 8192
MAX_FINE = 1024       # fine bins per coarse bin (kSplitThreads)
# rows per chunk of the plain probe (its [rows, bucket] gather: 256 MiB at
# bucket 64)
PLAIN_CHUNK_PAIRS = 1 << 20


def fp_bin_shift(n_buckets: int, bucket: int) -> int:
    """log2 of the buckets per fine bin of a ``[n_buckets, bucket]``
    table."""
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


class FpGeometry(NamedTuple):
    """How the binned count cuts one table and batch shape."""
    shift: int            # fine bin = bucket >> shift
    coarse_shift: int     # coarse bin = bucket >> coarse_shift
    n_bins: int           # fine bins
    n_coarse: int         # coarse bins
    n_blocks: int         # blocks of the two coarse passes
    rows_per_block: int
    stage_cap: int        # pairs a coarse-scatter block stages


def fp_bin_geometry(n_buckets: int, bucket: int, n_rows: int, windows: int,
                    device: torch.device, *,
                    coarse_bins: Optional[int] = None,
                    rows_per_block: Optional[int] = None) -> FpGeometry:
    """The geometry of a batch of ``n_rows`` reads of ``windows`` windows
    each against a ``[n_buckets, bucket]`` table.  By default COARSE_BINS
    coarse bins (more where a coarse bin would hold more than MAX_FINE fine
    bins), and a block takes the rows that spread the batch over
    BLOCKS_PER_SM blocks per multiprocessor, fewer where their windows would
    overflow STAGE_PAIRS."""
    coarse_bins = COARSE_BINS if coarse_bins is None else coarse_bins
    if coarse_bins & (coarse_bins - 1) or not 0 < coarse_bins <= 256:
        raise ValueError(f"coarse_bins={coarse_bins}: a power of two, "
                         f"at most 256")
    shift = fp_bin_shift(n_buckets, bucket)
    n_bins = n_buckets >> shift
    n_coarse = max(min(coarse_bins, n_bins), n_bins // MAX_FINE)
    coarse_shift = shift + (n_bins // n_coarse).bit_length() - 1
    if rows_per_block is None:
        sms = (torch.cuda.get_device_properties(device).multi_processor_count
               if device.type == "cuda" else 8)
        rows_per_block = max(1, min(-(-n_rows // (BLOCKS_PER_SM * sms)),
                                    STAGE_PAIRS // windows))
    return FpGeometry(shift, coarse_shift, n_bins, n_coarse,
                      -(-n_rows // rows_per_block), rows_per_block,
                      min(rows_per_block * windows, STAGE_PAIRS))


class FpBuffers(NamedTuple):
    """One batch's view of an :class:`FpScratch` (int32 on one device)."""
    coarse_count: torch.Tensor   # [n_coarse], zero between batches
    coarse_start: torch.Tensor   # [n_coarse + 1]
    block_base: torch.Tensor     # [n_blocks, 2, n_coarse]: start, length
    coarse_pairs: torch.Tensor   # [n_pairs, 2] (fp, bucket), by coarse bin
    bin_start: torch.Tensor      # [n_bins + 1]
    pairs: torch.Tensor          # [n_pairs, 2] (fp, bucket), by fine bin


class FpScratch:
    """The binned count's device buffers, per device, grown on demand and
    reused by every batch (:class:`FpBuffers`).  A pipeline holds one;
    batches on one device must run on one stream."""

    def __init__(self):
        self._bufs: dict = {}

    def buffers(self, device: torch.device, g: FpGeometry,
                n_pairs: int) -> FpBuffers:
        """The buffers of a batch of ``n_pairs`` windows at geometry ``g``
        on ``device``."""
        n_pairs = max(n_pairs, 1)
        want = (g.n_coarse, g.n_coarse + 1, g.n_blocks * 2 * g.n_coarse,
                2 * n_pairs, g.n_bins + 1, 2 * n_pairs)
        have = self._bufs.get(str(device))
        if have is None or any(h.shape[0] < w for h, w in zip(have, want)):
            size = want if have is None else [
                max(h.shape[0], w) for h, w in zip(have, want)]
            have = [torch.zeros(size[0], dtype=torch.int32, device=device)]
            have += [torch.empty(s, dtype=torch.int32, device=device)
                     for s in size[1:]]
            self._bufs[str(device)] = have
        cc, cs, bb, cp, bs, pairs = (h[:w] for h, w in zip(have, want))
        return FpBuffers(cc, cs, bb.view(g.n_blocks, 2, g.n_coarse),
                         cp.view(n_pairs, 2), bs, pairs.view(n_pairs, 2))


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
    bucket)`` with cell = block * n_bins + (bucket >> shift), and the
    non-valid count."""
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


def _check_coarse(block_base, n_rows, n_buckets, coarse_shift,
                  rows_per_block) -> None:
    n_blocks, two, n_coarse = block_base.shape
    if (two != 2 or n_coarse != n_buckets >> coarse_shift or n_coarse > 256
            or n_coarse << coarse_shift != n_buckets
            or -(-n_rows // rows_per_block) != n_blocks):
        raise ValueError(f"block_base {tuple(block_base.shape)} does not fit "
                         f"{n_rows} rows of {rows_per_block} a block and "
                         f"{n_buckets} >> {coarse_shift} buckets (at most "
                         f"256 coarse bins)")


def fp_coarse_count_plain(coarse_count, block_base, counts, words, *, length,
                          k, seed, n_buckets, coarse_shift, rows_per_block,
                          canonical=False, vlen=None, vbytes=None):
    """Plain twin of :func:`fp_coarse_count`: blocks reserve their ranges in
    block order (the kernel's order is the atomics' order)."""
    n_blocks, _, n_coarse = block_base.shape
    cells, _, _, bad = _binned(words, vlen, vbytes, length, k, seed,
                               n_buckets, canonical, coarse_shift,
                               rows_per_block, n_coarse)
    hist = torch.bincount(cells, minlength=n_blocks * n_coarse).view(
        n_blocks, n_coarse)
    base = hist.cumsum(0) - hist + coarse_count.to(torch.int64)
    block_base[:, 0] = torch.where(hist > 0, base, 0)
    block_base[:, 1] = hist
    coarse_count += hist.sum(0).to(torch.int32)
    counts[-1] += bad
    return coarse_count


def fp_coarse_count(coarse_count: torch.Tensor, block_base: torch.Tensor,
                    counts: torch.Tensor, words: torch.Tensor, *, length: int,
                    k: int, seed: int, n_buckets: int, coarse_shift: int,
                    rows_per_block: int, canonical: bool = False,
                    vlen: Optional[torch.Tensor] = None,
                    vbytes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First pass of the binned count: add the batch's valid windows per
    coarse bin (``bucket >> coarse_shift``) into ``coarse_count`` int32
    ``[n_coarse]``, write each block's range inside each coarse bin into
    ``block_base`` int32 ``[n_blocks, 2, n_coarse]`` (its start, its
    length; block i: rows ``[i * rows_per_block, (i + 1) *
    rows_per_block)``), and add the invalid and padding windows to the trash
    slot ``counts[-1]``.  The batch is as for :func:`count_fp`."""
    valid = _payload(words, vlen, vbytes, length)
    for t, name in ((coarse_count, "coarse_count"), (counts, "counts")):
        _check(t, name, torch.int32, 1)
    _check(block_base, "block_base", torch.int32, 3)
    _check_k(k, length)
    _check_coarse(block_base, words.shape[0], n_buckets, coarse_shift,
                  rows_per_block)
    n_blocks, _, n_coarse = block_base.shape
    if coarse_count.shape[0] != n_coarse:
        raise ValueError(f"coarse_count holds {coarse_count.shape[0]} "
                         f"totals, not {n_coarse}")
    extra = () if valid is None else (valid,)
    kw = dict(length=length, k=k, seed=seed, n_buckets=n_buckets,
              coarse_shift=coarse_shift, rows_per_block=rows_per_block,
              canonical=canonical, vlen=vlen, vbytes=vbytes)
    if not _route(coarse_count, block_base, counts, words, *extra):
        return fp_coarse_count_plain(coarse_count, block_base, counts, words,
                                     **kw)
    _build.check(_build.lib().fp_coarse_count_launch(
        *_batch_args(words, vlen, vbytes, length, k, canonical), n_buckets,
        seed & 0xFFFFFFFF, coarse_shift, n_coarse, n_blocks, rows_per_block,
        coarse_count.data_ptr(), block_base.data_ptr(), counts.data_ptr(),
        counts.shape[0] - 1, _stream(words)), "fp_coarse_count_kernel launch")
    LAUNCHES["fp_coarse_count_kernel"] += 1
    return coarse_count


def fp_coarse_scatter_plain(coarse_pairs, coarse_start, coarse_count,
                            block_base, words, *, length, k, seed, n_buckets,
                            coarse_shift, rows_per_block, canonical=False,
                            vlen=None, vbytes=None):
    """Plain twin of :func:`fp_coarse_scatter`: inside a block's range of a
    coarse bin the windows keep row-major order (the kernel's order is the
    order of its shared atomics)."""
    n_coarse = coarse_count.shape[0]
    coarse_start[0] = 0
    coarse_start[1:] = coarse_count.cumsum(0)
    cells, fps, bks, _ = _binned(words, vlen, vbytes, length, k, seed,
                                 n_buckets, canonical, coarse_shift,
                                 rows_per_block, n_coarse)
    order = torch.argsort(cells, stable=True)
    cells = cells[order]
    first = torch.searchsorted(cells, cells, right=False)
    rank = torch.arange(cells.shape[0], device=cells.device) - first
    pos = (coarse_start[:-1].to(torch.int64)[cells % n_coarse]
           + block_base[:, 0].reshape(-1).to(torch.int64)[cells] + rank)
    coarse_pairs[pos, 0] = fps[order]
    coarse_pairs[pos, 1] = bks[order]
    return coarse_pairs


def fp_coarse_scatter(coarse_pairs: torch.Tensor, coarse_start: torch.Tensor,
                      coarse_count: torch.Tensor, block_base: torch.Tensor,
                      words: torch.Tensor, *, length: int, k: int, seed: int,
                      n_buckets: int, coarse_shift: int, rows_per_block: int,
                      stage_cap: int, canonical: bool = False,
                      vlen: Optional[torch.Tensor] = None,
                      vbytes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Second pass of the binned count: ``coarse_start`` int32
    ``[n_coarse + 1]`` = the exclusive prefix sums of ``coarse_count`` and
    their total, and every valid window's ``(fp, bucket)`` into
    ``coarse_pairs`` int32 ``[>= coarse_start[-1], 2]`` grouped by coarse
    bin, each block's in its range of :func:`fp_coarse_count`'s
    ``block_base``.  The same batch and blocks as :func:`fp_coarse_count`; a
    block stages up to ``stage_cap`` pairs in shared memory to write them
    in runs (one with more writes each pair on its own)."""
    valid = _payload(words, vlen, vbytes, length)
    _check(coarse_pairs, "coarse_pairs", torch.int32, 2)
    _check(coarse_start, "coarse_start", torch.int32, 1)
    _check(coarse_count, "coarse_count", torch.int32, 1)
    _check(block_base, "block_base", torch.int32, 3)
    _check_k(k, length)
    _check_coarse(block_base, words.shape[0], n_buckets, coarse_shift,
                  rows_per_block)
    n_blocks, _, n_coarse = block_base.shape
    if (coarse_count.shape[0] != n_coarse
            or coarse_start.shape[0] != n_coarse + 1
            or coarse_pairs.shape[1] != 2 or stage_cap < 0):
        raise ValueError("coarse_pairs, coarse_start and coarse_count do not "
                         "fit block_base")
    extra = () if valid is None else (valid,)
    kw = dict(length=length, k=k, seed=seed, n_buckets=n_buckets,
              coarse_shift=coarse_shift, rows_per_block=rows_per_block,
              canonical=canonical, vlen=vlen, vbytes=vbytes)
    if not _route(coarse_pairs, coarse_start, coarse_count, block_base,
                  words, *extra):
        return fp_coarse_scatter_plain(coarse_pairs, coarse_start,
                                       coarse_count, block_base, words, **kw)
    _build.check(_build.lib().fp_coarse_scatter_launch(
        *_batch_args(words, vlen, vbytes, length, k, canonical), n_buckets,
        seed & 0xFFFFFFFF, coarse_shift, n_coarse, n_blocks, rows_per_block,
        stage_cap, coarse_count.data_ptr(), block_base.data_ptr(),
        coarse_start.data_ptr(), coarse_pairs.data_ptr(), _stream(words)),
        "fp_coarse_scatter_kernel launch")
    LAUNCHES["fp_coarse_scatter_kernel"] += 1
    return coarse_pairs


def fp_fine_split_plain(pairs, bin_start, coarse_count, coarse_pairs,
                        coarse_start, *, shift):
    """Plain twin of :func:`fp_fine_split`: a stable sort by fine bin."""
    n = int(coarse_start[-1])
    p = coarse_pairs[:n]
    fine = (p[:, 1] >> shift).to(torch.int64)
    pairs[:n] = p[torch.argsort(fine, stable=True)]
    bin_start[0] = 0
    bin_start[1:] = torch.bincount(fine, minlength=bin_start.shape[0] - 1
                                   ).cumsum(0)
    coarse_count.zero_()
    return pairs


def fp_fine_split(pairs: torch.Tensor, bin_start: torch.Tensor,
                  coarse_count: torch.Tensor, coarse_pairs: torch.Tensor,
                  coarse_start: torch.Tensor, *, shift: int,
                  coarse_shift: int) -> torch.Tensor:
    """Last pass of the bin sort: the pairs of :func:`fp_coarse_scatter`
    (grouped by coarse bin, ``coarse_start`` int32 ``[n_coarse + 1]``) into
    ``pairs`` grouped by fine bin (``bucket >> shift``), with ``bin_start``
    int32 ``[n_bins + 1]`` = the fine bins' starts and the total; zeroes
    ``coarse_count`` int32 ``[n_coarse]`` for the next batch.  One kernel
    block per coarse bin."""
    for t, name in ((pairs, "pairs"), (coarse_pairs, "coarse_pairs")):
        _check(t, name, torch.int32, 2)
    for t, name in ((bin_start, "bin_start"), (coarse_count, "coarse_count"),
                    (coarse_start, "coarse_start")):
        _check(t, name, torch.int32, 1)
    n_coarse, fine_log2 = coarse_count.shape[0], coarse_shift - shift
    if (coarse_start.shape[0] != n_coarse + 1
            or not 0 <= fine_log2 <= MAX_FINE.bit_length() - 1
            or bin_start.shape[0] != (n_coarse << fine_log2) + 1
            or pairs.shape != coarse_pairs.shape or pairs.shape[1] != 2):
        raise ValueError(f"{n_coarse} coarse bins of 2**{fine_log2} fine "
                         f"bins do not fit bin_start "
                         f"{tuple(bin_start.shape)} or the pairs")
    if not _route(pairs, bin_start, coarse_count, coarse_pairs, coarse_start):
        return fp_fine_split_plain(pairs, bin_start, coarse_count,
                                   coarse_pairs, coarse_start, shift=shift)
    _build.check(_build.lib().fp_fine_split_launch(
        pairs.device.index, coarse_pairs.data_ptr(), coarse_start.data_ptr(),
        n_coarse, shift, fine_log2, coarse_count.data_ptr(),
        bin_start.data_ptr(), pairs.data_ptr(), _stream(pairs)),
        "fp_fine_split_kernel launch")
    LAUNCHES["fp_fine_split_kernel"] += 1
    return pairs


def fp_bin_front(counts: torch.Tensor, words: torch.Tensor, buf: FpBuffers,
                 g: FpGeometry, *, length: int, k: int, seed: int,
                 n_buckets: int, canonical: bool = False,
                 vlen: Optional[torch.Tensor] = None,
                 vbytes: Optional[torch.Tensor] = None) -> FpBuffers:
    """The bin sort of :func:`count_fp`: its three passes into ``buf``
    (``buf.pairs`` grouped by fine bin, ``buf.bin_start``), the invalid and
    padding windows into the trash slot ``counts[-1]``."""
    kw = dict(length=length, k=k, seed=seed, n_buckets=n_buckets,
              coarse_shift=g.coarse_shift, rows_per_block=g.rows_per_block,
              canonical=canonical, vlen=vlen, vbytes=vbytes)
    fp_coarse_count(buf.coarse_count, buf.block_base, counts, words, **kw)
    fp_coarse_scatter(buf.coarse_pairs, buf.coarse_start, buf.coarse_count,
                      buf.block_base, words, stage_cap=g.stage_cap, **kw)
    fp_fine_split(buf.pairs, buf.bin_start, buf.coarse_count,
                  buf.coarse_pairs, buf.coarse_start, shift=g.shift,
                  coarse_shift=g.coarse_shift)
    return buf


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

    On a CUDA device: :func:`fp_bin_front` (:func:`fp_coarse_count`,
    :func:`fp_coarse_scatter`, :func:`fp_fine_split`), then
    :func:`fp_bin_probe`.  Returns ``counts``.
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
    g = fp_bin_geometry(n_buckets, bucket, n_rows, length - k + 1,
                        words.device)
    buf = (scratch or FpScratch()).buffers(words.device, g,
                                           n_rows * (length - k + 1))
    fp_bin_front(counts, words, buf, g, length=length, k=k, seed=seed,
                 n_buckets=n_buckets, canonical=canonical, vlen=vlen,
                 vbytes=vbytes)
    return fp_bin_probe(counts, buf.pairs, buf.bin_start, fp_table,
                        shift=g.shift)


def _int_err(a: torch.Tensor, b: torch.Tensor) -> int:
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return int(d.max()) if d.numel() else 0


# the error fp_bin_parity reports for pairs outside their bin's range, or
# block ranges that do not tile a coarse bin
MISPLACED = 1 << 62


def _tiles(block_base: torch.Tensor) -> bool:
    """Whether the blocks' ranges (start, length) tile each coarse bin from
    0 without a gap or an overlap, in whatever order the blocks took
    them."""
    start = block_base[:, 0].T.to(torch.int64)
    length = block_base[:, 1].T.to(torch.int64)
    key, idx = torch.where(length > 0, start, 1 << 40).sort(1)
    length = length.gather(1, idx)
    return bool(((key == length.cumsum(1) - length) | (length == 0)).all())


def _pairs_err(got: torch.Tensor, want: torch.Tensor, starts: torch.Tensor,
               shift: int) -> int:
    """0 when every pair of ``got`` lies in the range of its bin
    (``bucket >> shift``) and the two hold the same multiset of pairs (so
    each bin holds the same multiset); else the largest difference of the
    sorted pairs, or MISPLACED."""
    pos = torch.arange(got.shape[0], device=got.device)
    bins = torch.searchsorted(starts.to(torch.int64), pos, right=True) - 1
    if not bool(((got[:, 1] >> shift).to(torch.int64) == bins).all()):
        return MISPLACED

    def keys(p):
        p = p.to(torch.int64)
        return torch.sort((p[:, 1] << 32) | (p[:, 0] & 0xFFFFFFFF)).values

    return _int_err(keys(got), keys(want))


def fp_bin_parity(words: torch.Tensor, fp_table: torch.Tensor, *,
                  length: int, k: int, seed: int, canonical: bool = False,
                  vlen: Optional[torch.Tensor] = None,
                  vbytes: Optional[torch.Tensor] = None) -> dict:
    """Each binned kernel against its plain twin on the same inputs:
    ``{kernel name: max |kernel - plain|}`` over what it writes.  The
    coarse totals, the blocks' range lengths, the coarse and fine bin
    starts, the trash slot and the probe counts must be equal, and the
    blocks' ranges must tile each coarse bin (their order is the order of
    the kernel's atomics); the pairs, as a multiset within each coarse or
    fine bin (the order inside a bin is the kernels' own).  Each pass runs
    on its predecessor's kernel output, except that the fine split and the
    probe both take the plain twins' input."""
    dev = words.device
    n_buckets, bucket = fp_table.shape
    g = fp_bin_geometry(n_buckets, bucket, words.shape[0], length - k + 1,
                        dev)
    kw = dict(length=length, k=k, seed=seed, n_buckets=n_buckets,
              coarse_shift=g.coarse_shift, rows_per_block=g.rows_per_block,
              canonical=canonical, vlen=vlen, vbytes=vbytes)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    cc, bb, c = (zeros(g.n_coarse), zeros(g.n_blocks, 2, g.n_coarse),
                 zeros(n_buckets * bucket + 1))
    pcc, pbb, pc = cc.clone(), bb.clone(), c.clone()
    fp_coarse_count(cc, bb, c, words, **kw)
    fp_coarse_count_plain(pcc, pbb, pc, words, **kw)
    out = {"fp_coarse_count_kernel": max(
        _int_err(cc, pcc), _int_err(c, pc), _int_err(bb[:, 1], pbb[:, 1]),
        0 if _tiles(bb) else MISPLACED)}
    n = int(pcc.sum())
    cs, pcs = zeros(g.n_coarse + 1), zeros(g.n_coarse + 1)
    cp, pcp = zeros(max(n, 1), 2), zeros(max(n, 1), 2)
    fp_coarse_scatter(cp, cs, cc, bb, words, stage_cap=g.stage_cap, **kw)
    fp_coarse_scatter_plain(pcp, pcs, pcc, pbb, words, **kw)
    out["fp_coarse_scatter_kernel"] = max(
        _int_err(cs, pcs), _pairs_err(cp[:n], pcp[:n], pcs, g.coarse_shift))
    bs, pbs = zeros(g.n_bins + 1), zeros(g.n_bins + 1)
    pairs, ppairs = zeros(max(n, 1), 2), zeros(max(n, 1), 2)
    kcc = pcc.clone()
    fp_fine_split(pairs, bs, kcc, pcp, pcs, shift=g.shift,
                  coarse_shift=g.coarse_shift)
    fp_fine_split_plain(ppairs, pbs, pcc, pcp, pcs, shift=g.shift)
    out["fp_fine_split_kernel"] = max(
        _int_err(bs, pbs), _int_err(kcc, pcc),
        _pairs_err(pairs[:n], ppairs[:n], pbs, g.shift))
    c1, c2 = c.clone(), c.clone()
    fp_bin_probe(c1, ppairs, pbs, fp_table, shift=g.shift)
    fp_bin_probe_plain(c2, ppairs, pbs, fp_table, shift=g.shift)
    out["fp_bin_probe_kernel"] = _int_err(c1, c2)
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

    want = torch.zeros(n_keys + 1, dtype=torch.int32, device=words.device)
    count_exact_plain(want, words, table, **kw)
    got = torch.zeros_like(want)
    hits, n_hits = exact_probe(got, words, table, **kw)
    ids = listed_ids(hits, n_hits)
    stray = (ids < 0) | (ids >= n_keys)   # listed, but not an id
    got[:-1] += torch.bincount(ids[~stray], minlength=n_keys).to(torch.int32)
    out = {"count_exact_kernel": max(_int_err(got, want), int(stray.sum()))}
    a1, a2 = torch.zeros_like(want), torch.zeros_like(want)
    exact_apply(a1, hits, n_hits, slice_ids=slice_ids)
    exact_apply_plain(a2, hits, n_hits)
    out["exact_apply_kernel"] = _int_err(a1, a2)
    return out
