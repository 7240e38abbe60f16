"""Streaming restricted k-mer counting on one device, fingerprint mode.

Port of ``strainscan_tpu/ops/count.py::CountPipeline`` (``probe_mode="fp"``):
read batches are 2-bit packed on the host (:meth:`CountPipeline.prepare_batch`,
in the producer thread), copied to the device, and counted by the fused
``count_fp_kernel`` (:func:`..ops.probe.count_fp`) into an int32 slot-space
accumulator ``[n_slots + 1]`` whose last entry is the trash slot.
:meth:`CountPipeline.finish` gathers the slot counts into the table's id
space on the device (through ``slot_of_id``) and copies them back densely.

On a CUDA device the packed batches come from pinned host buffers and copy
on a side stream; the compute stream waits on that copy before the kernel,
so the copy of batch i + 1 overlaps the kernel of batch i.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from strainscan_tpu.index.hashtable import FpTable
from strainscan_tpu.kmer import pack
from strainscan_tpu_torch.index.hashtable import fp_table_to_device
from strainscan_tpu_torch.kmer.device import from_u32
from strainscan_tpu_torch.ops.probe import count_fp

Payload = Tuple[str, torch.Tensor, torch.Tensor]


class CountPipeline:
    """Streaming counter over read batches against one fingerprint table.

    Args:
      fpt: the host fingerprint table (uploaded once per device and cached
        on the object, see ``fp_table_to_device``).
      device: a resolved ``torch.device``.
      canonical: hash min(fwd, revcomp) of each window.
    """

    def __init__(self, fpt: FpTable, device: torch.device,
                 canonical: bool = False):
        self.k = fpt.k
        self.device = torch.device(device)
        self.canonical = canonical
        self.table = fp_table_to_device(fpt, self.device)
        self.counts = torch.zeros(fpt.n_slots + 1, dtype=torch.int32,
                                  device=self.device)
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        self._shape: Optional[tuple] = None

    def _host(self, a: np.ndarray) -> torch.Tensor:
        t = from_u32(a) if a.dtype == np.uint32 else torch.from_numpy(a)
        return t.pin_memory() if self._cuda else t

    def prepare_batch(self, codes: np.ndarray) -> List[Payload]:
        """Host half of :meth:`add_batch`: shape pinning, padding, packing.

        Batches are padded to the first-seen row count with all-invalid
        rows (code 4, which count only into the trash slot), as the JAX
        pipeline does, so both pipelines' slot vectors agree entry for
        entry.  Returns payloads ``("vlen", words, vlen)`` or
        ``("vbytes", words, vbytes)`` of host tensors (pinned on CUDA).
        Only the producer thread may call it: it owns the batch shape."""
        out: List[Payload] = []
        codes = np.asarray(codes)
        if self._shape is None:
            self._shape = codes.shape
        rows, cols = self._shape
        if codes.shape[1] != cols:
            raise ValueError(f"batch maxlen changed: {codes.shape[1]} != {cols}")
        if codes.shape[0] > rows:
            for i in range(0, codes.shape[0], rows):
                out.extend(self.prepare_batch(codes[i:i + rows]))
            return out
        if codes.shape[0] < rows:
            pad = np.full((rows - codes.shape[0], cols), 4, dtype=np.uint8)
            codes = np.concatenate([codes, pad], axis=0)
        fused = pack.bitpack_codes_vlen(codes)
        if fused is None:  # no native lib, or a mid-read N
            vlen = pack.valid_prefix_lens(codes)
            if vlen is not None:
                fused = (pack.bitpack_codes(codes, need_vbytes=False)[0], vlen)
        if fused is not None:
            out.append(("vlen", self._host(fused[0]), self._host(fused[1])))
        else:
            words, vbytes = pack.bitpack_codes(codes)
            out.append(("vbytes", self._host(words), self._host(vbytes)))
        return out

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
            words, valid = self._to_device(a, b)
            count_fp(self.counts, words, self.table.fp, length=cols, k=self.k,
                     seed=self.table.seed, canonical=self.canonical,
                     **{form: valid})

    def add_batch(self, codes: np.ndarray) -> None:
        """codes: uint8 ``[B, L]`` encoded reads (0..3 bases, >= 4 pad/N)."""
        self.add_prepared(self.prepare_batch(codes))

    def reset(self) -> None:
        """Zero the accumulator without re-uploading the table."""
        self.counts.zero_()

    def finish(self) -> np.ndarray:
        """int32 ``[n_keys]`` hit counts in the table's id space.

        One device gather through ``slot_of_id`` reads only occupied
        slots, so a window that matched an empty slot's fingerprint 0 is
        dropped here, as the JAX remap drops it."""
        ids = self.counts.index_select(0, self.table.slot_of_id)
        return ids.cpu().numpy()
