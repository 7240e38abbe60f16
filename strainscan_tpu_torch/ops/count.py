"""Streaming restricted k-mer counting on one device.

Port of ``strainscan_tpu/ops/count.py::CountPipeline``.  Read batches are
prepared on the host (:meth:`CountPipeline.prepare_batch`, in the producer
thread), copied to the device, and counted in place, one count per
batch:

* ``probe_mode="fp"`` (default): the binned count
  (:func:`..ops.probe.count_fp`, four kernels that sort the batch's windows
  by table slice and probe each slice from shared memory, with the
  pipeline's :class:`..ops.probe.FpScratch`) probes the single-row
  fingerprint table into an int32 slot-space accumulator ``[n_slots + 1]``
  (last entry: the trash slot), which :meth:`CountPipeline.finish`
  brings into the table's id space (below).
* ``probe_mode="exact"``: ``count_exact_kernel``
  (:func:`..ops.probe.count_exact`) probes the interleaved exact table into
  an int32 id-space accumulator ``[n_keys + 1]`` (last entry: the trash
  entry); :meth:`CountPipeline.finish` fetches its first ``n_keys`` entries.
  It is the zero-stray escape hatch: a window is counted only when its
  whole key matches.

The stream end is the JAX package's compact fetch (``fetch_counts``): an
8 B read of the counts' max and nonzero count (:func:`count_stats`) picks
the fewest bytes to copy to the host, either the nonzero entries as
(index, value) pairs or the whole vector, with the values narrowed to one
or two bytes where the max allows.  The fp finish takes the sparse route in
slot space and remaps on the host through ``FpTable.val``, so the device
table's ``slot_of_id`` is uploaded only for a sample that takes the dense
route.  Every fetch is recorded in :data:`FETCHES` (the latest 4,096).

With ``packed_transfer`` (default) batches ship as 2-bit words plus
validity (``vlen`` where the fp mode can, else ``vbytes``), without it as
raw uint8 codes: the payload choice of the JAX ``prepare_batch``.

On a CUDA device the payloads come from pinned host buffers and copy on a
side stream; the compute stream waits on that copy before the kernel, so
the copy of batch i + 1 overlaps the kernel of batch i.
"""

from __future__ import annotations

import collections
import time
from typing import Deque, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from strainscan_tpu_torch import timing
from strainscan_tpu_torch.index.hashtable import (FpTable, KmerTable,
                                                  fp_table_of,
                                                  fp_table_to_device,
                                                  kmer_table_to_device)
from strainscan_tpu_torch.kmer import pack
from strainscan_tpu_torch.kmer.device import from_u32
from strainscan_tpu_torch.ops.probe import FpScratch, count_exact, count_fp

Payload = Tuple[str, torch.Tensor, Optional[torch.Tensor]]


def pack_payload(codes: np.ndarray, packed_transfer: bool, allow_vlen: bool,
                 host) -> Payload:
    """One read batch as a payload ``(form, a, b)``: ``("vlen", words,
    vlen)`` when ``allow_vlen`` and every row's valid bases form a prefix,
    else ``("vbytes", words, vbytes)``, or ``("codes", codes, None)``
    without ``packed_transfer``.  ``host`` turns each NumPy array into the
    host tensor to ship (pinned on CUDA).  The path taken (``codes``,
    ``vlen/fused``: the native fused pack, ``vlen/prefix``:
    ``valid_prefix_lens``, or ``vbytes``) is noted on the open span as
    ``pack``."""
    if not packed_transfer:
        timing.note(pack="codes")
        return ("codes", host(codes), None)
    if allow_vlen:
        fused, path = pack.bitpack_codes_vlen(codes), "vlen/fused"
        if fused is None:  # no native lib, or a mid-read N
            vlen, path = pack.valid_prefix_lens(codes), "vlen/prefix"
            if vlen is not None:
                fused = (pack.bitpack_codes(codes, need_vbytes=False)[0],
                         vlen)
        if fused is not None:
            timing.note(pack=path)
            return ("vlen", host(fused[0]), host(fused[1]))
    timing.note(pack="vbytes")
    words, vbytes = pack.bitpack_codes(codes)
    return ("vbytes", host(words), host(vbytes))


def pad_invalid_rows(codes: np.ndarray, multiple: int) -> np.ndarray:
    """Append all-invalid rows (code 4, which count only into the trash
    entry) up to the next multiple of ``multiple`` rows, and to at least
    ``multiple`` rows."""
    n = codes.shape[0]
    extra = max(multiple - n, (-n) % multiple)
    if not extra:
        return codes
    pad = np.full((extra, codes.shape[1]), 4, dtype=codes.dtype)
    return np.concatenate([codes, pad], axis=0)


def shape_batch(codes: np.ndarray, shape: Optional[Tuple[int, int]],
                row_multiple: int = 1):
    """The batch-shape policy of the count pipelines, as the JAX
    ``prepare_batch`` has it: the first batch pins ``shape`` (its row count
    rounded up to ``row_multiple``); every batch is then cut into blocks
    of at most that many rows, each padded to it by
    :func:`pad_invalid_rows`, so the accumulators agree entry for entry
    with the JAX pipeline's.  Returns ``(shape, blocks)``; raises if the
    read length changed."""
    codes = np.asarray(codes)
    if shape is None:
        rows = max(codes.shape[0], 1)
        shape = (rows + (-rows) % row_multiple, codes.shape[1])
    rows, cols = shape
    if codes.shape[1] != cols:
        raise ValueError(f"batch maxlen changed: {codes.shape[1]} != {cols}")
    starts = range(0, codes.shape[0], rows) if codes.shape[0] else [0]
    return shape, [pad_invalid_rows(codes[i:i + rows], rows) for i in starts]


def host_tensor(a: np.ndarray, pin: bool) -> torch.Tensor:
    """NumPy array -> host tensor (uint32 as int32 bits), pinned if asked."""
    t = from_u32(a) if a.dtype == np.uint32 else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.pin_memory() if pin else t


class Fetch(NamedTuple):
    """One stream-end fetch of counts to the host."""

    route: str            # "sparse" (index, value pairs) or "dense"
    space: str            # "slot": slot-space pairs remapped on the host;
                          # "id": the id-space vector
    maxc: int             # the stats that picked the route: max count,
    nnz: int              # nonzero entries,
    n: int                # entries of the result (n_keys),
    cap: int              # and the sparse capacity (sparse_cap)
    vb: int               # bytes per value shipped: 1, 2 or 4
    d2h_bytes: int        # payload bytes, nnz * (4 + vb) or n * vb (the
                          # 8 B of stats not counted)
    soi_uploaded: bool = False  # this finish uploaded a slot_of_id
    s: float = 0.0        # host wall seconds of the fetch, or of the
                          # whole finish that made it


# the latest fetches since the last reset_fetches(), in order (for the
# bench scripts and the smoke; nothing else reads it); bounded, since the
# program's own path appends on every finish
FETCHES: Deque[Fetch] = collections.deque(maxlen=4096)


def reset_fetches() -> None:
    FETCHES.clear()


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` in host memory, as NumPy: on CUDA through a pinned
    buffer on the current stream (so it follows the kernels that wrote
    ``t``), synchronised before it returns.  Never a view of ``t``."""
    if t.device.type != "cuda":
        return t.clone().numpy()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return buf.numpy()


def count_stats(counts: torch.Tensor) -> Tuple[int, int]:
    """``(max, nonzero count)`` of an int32 count vector: one 8 B read
    (``_count_stats``).  ``(0, 0)`` for an empty vector."""
    if counts.numel() == 0:
        return 0, 0
    st = torch.stack([counts.amax(),
                      torch.count_nonzero(counts).to(torch.int32)])
    maxc, nnz = _to_host(st).tolist()
    return maxc, nnz


def sparse_cap(n: int) -> int:
    """The JAX package's sparse-fetch capacity for a vector of ``n``
    entries (``_sparse_cap``): ``n / 8`` rounded up to a power of two, at
    least 1,024.  A sample with more nonzeros takes the dense route."""
    return 1 << max(10, (max(n // 8, 1) - 1).bit_length())


def value_bytes(maxc: int) -> int:
    """Bytes per value that hold every count up to ``maxc``: 1, 2 or 4."""
    return 1 if maxc < (1 << 8) else 2 if maxc < (1 << 16) else 4


def _narrow(x: torch.Tensor, vb: int) -> torch.Tensor:
    """The low ``vb`` bytes of each little-endian int32 of ``x`` as uint8
    ``[n * vb]`` (a byte view, which needs no uint16 ops on the device)."""
    if vb == 4:
        return x.view(torch.uint8)
    return x.view(torch.uint8).reshape(-1, 4)[:, :vb].reshape(-1)


def _widen(b: np.ndarray, vb: int) -> np.ndarray:
    """:func:`_narrow`'s bytes on the host -> int32 values."""
    return b.view({1: "<u1", 2: "<u2", 4: "<i4"}[vb]).astype(np.int32)


def sparse_fetch(counts: torch.Tensor, nnz: int,
                 vb: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host ``(index, value)`` int32 arrays of the ``nnz`` nonzero entries
    of ``counts`` (``_sparse_fetch``), copied as one buffer of
    ``nnz * (4 + vb)`` bytes: the indices narrowed to int32 on the device,
    the values to ``vb`` bytes.

    Exactly ``nnz`` entries cross: the JAX package pads its nonzero to a
    fixed capacity and rounds the copy up to 64 Ki entries only to keep its
    compiled programs few, which eager PyTorch does not need."""
    idx = torch.nonzero(counts).reshape(-1)
    payload = torch.cat([idx.to(torch.int32).view(torch.uint8),
                         _narrow(counts.index_select(0, idx), vb)])
    host = _to_host(payload)
    return host[:4 * nnz].view("<i4"), _widen(host[4 * nnz:], vb)


def _fetch(counts: torch.Tensor, n_keys: int) -> Tuple[np.ndarray, Fetch]:
    """:func:`fetch_counts` and its record."""
    cap = sparse_cap(n_keys)
    if n_keys == 0:
        return (np.zeros(0, dtype=np.int32),
                Fetch("dense", "id", 0, 0, 0, cap, 1, 0))
    maxc, nnz = count_stats(counts)
    vb = value_bytes(maxc)
    sparse_bytes, dense_bytes = nnz * (4 + vb), n_keys * vb
    if sparse_bytes < dense_bytes // 2 and 0 < nnz <= cap < n_keys:
        idx, vals = sparse_fetch(counts, nnz, vb)
        out = np.zeros(n_keys, dtype=np.int32)
        out[idx] = vals
        return out, Fetch("sparse", "id", maxc, nnz, n_keys, cap, vb,
                          sparse_bytes)
    return (_widen(_to_host(_narrow(counts, vb)), vb),
            Fetch("dense", "id", maxc, nnz, n_keys, cap, vb, dense_bytes))


def fetch_counts(dev_counts: torch.Tensor, n_keys: int, *,
                 soi_uploaded: bool = False,
                 since: Optional[float] = None) -> np.ndarray:
    """Device int32 counts ``[n_keys]`` -> host int32 ``[n_keys]`` by the
    JAX package's rule (``ops/count.py::fetch_counts``): with ``vb`` the
    bytes that hold the max, the sparse route (indices and values,
    ``nnz * (4 + vb)`` bytes) when that is under half of the dense
    ``n_keys * vb`` bytes and ``0 < nnz <= sparse_cap(n_keys) < n_keys``,
    else the dense vector at ``vb`` bytes a value.  Bit-exact with a plain
    copy of ``dev_counts``.

    Appends its :class:`Fetch` to :data:`FETCHES`, with ``soi_uploaded``
    and the seconds since ``since`` (a ``time.perf_counter()`` reading;
    default: this call's start), which a finish passes for itself."""
    t0 = time.perf_counter() if since is None else since
    out, rec = _fetch(dev_counts, n_keys)
    FETCHES.append(rec._replace(soi_uploaded=soi_uploaded,
                                s=time.perf_counter() - t0))
    return out


class CountPipeline:
    """Streaming counter over read batches against one table.

    Args:
      table: the host table: an :class:`FpTable`, or a :class:`KmerTable`
        (whose fingerprint table is derived once and cached on it, see
        ``fp_table_of``); ``probe_mode="exact"`` needs a KmerTable.
        Device tables are uploaded once per device and cached on the host
        table.
      device: a resolved ``torch.device``.
      canonical: hash min(fwd, revcomp) of each window.
      packed_transfer: ship 2-bit words + validity (default) or raw codes.
      probe_mode: ``"fp"`` or ``"exact"``.
    """

    def __init__(self, table: Union[FpTable, KmerTable],
                 device: torch.device, canonical: bool = False,
                 packed_transfer: bool = True, probe_mode: str = "fp"):
        self.k = table.k
        self.device = torch.device(device)
        self.canonical = canonical
        self.packed_transfer = packed_transfer
        self.probe_mode = probe_mode
        if probe_mode == "fp":
            self.fpt = (table if isinstance(table, FpTable)
                        else fp_table_of(table))
            self.table = fp_table_to_device(self.fpt, self.device)
            self.scratch = FpScratch()
            n = self.fpt.n_slots + 1
        elif probe_mode == "exact":
            if not isinstance(table, KmerTable):
                raise TypeError("probe_mode='exact' needs a KmerTable")
            self.fpt = None
            self.table = kmer_table_to_device(table, self.device)
            n = table.n_keys + 1
        else:
            raise ValueError(f"probe_mode={probe_mode!r} (use fp or exact)")
        self.counts = torch.zeros(n, dtype=torch.int32, device=self.device)
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        self._shape: Optional[tuple] = None

    def _host(self, a: np.ndarray) -> torch.Tensor:
        return host_tensor(a, self._cuda)

    def prepare_batch(self, codes: np.ndarray) -> List[Payload]:
        """Host half of :meth:`add_batch`: shape pinning and padding
        (:func:`shape_batch`), then packing.  Returns payloads (see
        :func:`pack_payload`) of host tensors.  Only the producer thread
        may call it: it owns the batch shape."""
        self._shape, blocks = shape_batch(codes, self._shape)
        return [pack_payload(b, self.packed_transfer,
                             self.probe_mode == "fp", self._host)
                for b in blocks]

    def _to_device(self, *host: torch.Tensor) -> List[torch.Tensor]:
        if not self._cuda:
            return list(host)
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = [t.to(self.device, non_blocking=True) for t in host]
        cur.wait_stream(self._copy_stream)
        for t in dev:   # freed buffers wait for the kernel, not the copy
            t.record_stream(cur)
        return dev

    def add_prepared(self, payloads: List[Payload]) -> None:
        """Copy payloads from :meth:`prepare_batch` and count them."""
        cols = self._shape[1]
        for form, a, b in payloads:
            if b is None:
                (reads,), valid = self._to_device(a), {}
            else:
                reads, v = self._to_device(a, b)
                valid = {form: v}
            if self.probe_mode == "fp":
                count_fp(self.counts, reads, self.table.fp, length=cols,
                         k=self.k, seed=self.table.seed,
                         canonical=self.canonical, scratch=self.scratch,
                         **valid)
            else:
                count_exact(self.counts, reads, self.table.table,
                            length=cols, k=self.k,
                            max_probe=self.table.max_probe,
                            canonical=self.canonical, **valid)

    def add_batch(self, codes: np.ndarray) -> None:
        """codes: uint8 ``[B, L]`` encoded reads (0..3 bases, >= 4 pad/N)."""
        self.add_prepared(self.prepare_batch(codes))

    def reset(self) -> None:
        """Zero the accumulator without re-uploading the table."""
        self.counts.zero_()

    def finish(self) -> np.ndarray:
        """int32 ``[n_keys]`` hit counts in the table's id space, fetched
        as the JAX ``CountPipeline.finish`` fetches them.

        fp mode: the stats of the occupied slots (the trash slot dropped;
        a window that matched an empty slot's fingerprint 0 is counted
        there) pick the route.  Sparse: the nonzero slots and their counts
        cross, and the host maps them to ids through ``FpTable.val``,
        dropping the empty slots' strays (``val < 0``).  Dense: one device
        gather through the device table's ``slot_of_id`` (uploaded at the
        first such finish), which reads only occupied slots, then
        :func:`fetch_counts`.  Exact mode: :func:`fetch_counts` of the
        accumulator without its trash entry.  Records one :class:`Fetch`."""
        if self.fpt is None:
            return fetch_counts(self.counts[:-1], self.table.n_keys)
        t0 = time.perf_counter()
        fpt = self.fpt
        occ = self.counts[:fpt.n_slots]
        maxc, nnz = count_stats(occ)
        vb, cap = value_bytes(maxc), sparse_cap(fpt.n_slots)
        if 0 < nnz <= cap and nnz * (4 + vb) < (fpt.n_keys * vb) // 2:
            idx, vals = sparse_fetch(occ, nnz, vb)
            ids = fpt.val[idx]
            keep = ids >= 0
            out = np.zeros(fpt.n_keys, dtype=np.int32)
            out[ids[keep]] = vals[keep]
            FETCHES.append(Fetch("sparse", "slot", maxc, nnz, fpt.n_keys,
                                 cap, vb, nnz * (4 + vb),
                                 s=time.perf_counter() - t0))
            return out
        upload = not self.table.has_slot_of_id
        ids = self.counts.index_select(0, self.table.slot_of_id)
        return fetch_counts(ids, fpt.n_keys, soi_uploaded=upload, since=t0)
