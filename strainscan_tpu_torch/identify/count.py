"""Sample counting: FASTQ -> per-DB-k-mer hit counts on one device.

Port of the single-device branch of ``strainscan_tpu/identify/count.py``
(the jellyfish replacement of reference library/identify.py:73-103).
Parse and pack run in a producer thread (``utils.prefetch``); the main
thread copies each batch to the device and launches the count.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Union

import numpy as np
import torch

from strainscan_tpu.config import IdentifyConfig
from strainscan_tpu.index.hashtable import FpTable
from strainscan_tpu.io import fastx
from strainscan_tpu.utils.prefetch import prefetch_iter
from strainscan_tpu_torch.ops.count import CountPipeline, Payload

PathLike = Union[str, Sequence[str]]


def iter_payloads(pipe: CountPipeline, fq_paths: PathLike,
                  cfg: IdentifyConfig = IdentifyConfig(),
                  use_native: bool = True) -> Iterator[List[Payload]]:
    """Packed batches of the sample, parsed and packed in a producer
    thread (``pipe.prepare_batch``), ready for ``pipe.add_prepared``."""
    batches = fastx.read_batches(
        fq_paths, batch=cfg.read_batch, maxlen=cfg.max_read_len,
        k=pipe.k, use_native=use_native)
    return prefetch_iter(pipe.prepare_batch(b) for b in batches)


def count_sample(
    fpt: FpTable,
    fq_paths: PathLike,
    device: torch.device,
    cfg: IdentifyConfig = IdentifyConfig(),
    canonical: bool = False,
    use_native: bool = True,
) -> np.ndarray:
    """Stream the sample through the count pipeline on ``device``; int32
    counts in the table's id space."""
    pipe = CountPipeline(fpt, device, canonical=canonical)
    for payloads in iter_payloads(pipe, fq_paths, cfg, use_native):
        pipe.add_prepared(payloads)
    return pipe.finish()
