"""Streaming restricted k-mer counting on one device.

Port of ``strainscan_tpu/ops/count.py::CountPipeline``.  Read batches are
prepared on the host (:meth:`CountPipeline.prepare_batch`, in the producer
thread), copied to the device, and counted in place by one kernel per
batch:

* ``probe_mode="fp"`` (default): the fused ``count_fp_kernel``
  (:func:`..ops.probe.count_fp`) probes the single-row fingerprint table
  into an int32 slot-space accumulator ``[n_slots + 1]`` (last entry: the
  trash slot); :meth:`CountPipeline.finish` gathers it into the table's id
  space on the device through ``slot_of_id``.
* ``probe_mode="exact"``: ``count_exact_kernel``
  (:func:`..ops.probe.count_exact`) probes the interleaved exact table into
  an int32 id-space accumulator ``[n_keys + 1]`` (last entry: the trash
  entry); :meth:`CountPipeline.finish` returns its first ``n_keys`` entries.
  It is the zero-stray escape hatch: a window is counted only when its
  whole key matches.

With ``packed_transfer`` (default) batches ship as 2-bit words plus
validity (``vlen`` where the fp mode can, else ``vbytes``), without it as
raw uint8 codes: the payload choice of the JAX ``prepare_batch``.

On a CUDA device the payloads come from pinned host buffers and copy on a
side stream; the compute stream waits on that copy before the kernel, so
the copy of batch i + 1 overlaps the kernel of batch i.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from strainscan_tpu.index.hashtable import FpTable, KmerTable
from strainscan_tpu.kmer import pack
from strainscan_tpu_torch.index.hashtable import (fp_table_of,
                                                  fp_table_to_device,
                                                  kmer_table_to_device)
from strainscan_tpu_torch.kmer.device import from_u32
from strainscan_tpu_torch.ops.probe import count_exact, count_fp

Payload = Tuple[str, torch.Tensor, Optional[torch.Tensor]]


def pack_payload(codes: np.ndarray, packed_transfer: bool, allow_vlen: bool,
                 host) -> Payload:
    """One read batch as a payload ``(form, a, b)``: ``("vlen", words,
    vlen)`` when ``allow_vlen`` and every row's valid bases form a prefix,
    else ``("vbytes", words, vbytes)``, or ``("codes", codes, None)``
    without ``packed_transfer``.  ``host`` turns each NumPy array into the
    host tensor to ship (pinned on CUDA)."""
    if not packed_transfer:
        return ("codes", host(codes), None)
    if allow_vlen:
        fused = pack.bitpack_codes_vlen(codes)
        if fused is None:  # no native lib, or a mid-read N
            vlen = pack.valid_prefix_lens(codes)
            if vlen is not None:
                fused = (pack.bitpack_codes(codes, need_vbytes=False)[0],
                         vlen)
        if fused is not None:
            return ("vlen", host(fused[0]), host(fused[1]))
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
            fpt = table if isinstance(table, FpTable) else fp_table_of(table)
            self.table = fp_table_to_device(fpt, self.device)
            n = fpt.n_slots + 1
        elif probe_mode == "exact":
            if not isinstance(table, KmerTable):
                raise TypeError("probe_mode='exact' needs a KmerTable")
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
                         canonical=self.canonical, **valid)
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
        """int32 ``[n_keys]`` hit counts in the table's id space.

        fp mode: one device gather through ``slot_of_id`` reads only
        occupied slots, so a window that matched an empty slot's
        fingerprint 0 is dropped here, as the JAX remap drops it.  Exact
        mode: the accumulator already is in id space."""
        if self.probe_mode == "fp":
            ids = self.counts.index_select(0, self.table.slot_of_id)
        else:
            ids = self.counts[:-1]
        return ids.cpu().numpy()
