"""Sample counting: FASTQ -> per-DB-k-mer hit counts.

Port of ``strainscan_tpu/identify/count.py`` (the jellyfish replacement of
reference library/identify.py:73-103).  Parse and pack run in a producer
thread (``utils.prefetch``); the main thread copies each batch to the
device(s) and launches the count.

* One device (a 1 x 1 mesh): :class:`..ops.count.CountPipeline`.
* A mesh of several positions, one process, the DB's key array given and a
  table of at least ``cfg.shard_min_kmers`` keys:
  :class:`..parallel.sharded.ShardedCountPipeline`, from a 2-entry cache.
* Several processes (``parallel.distributed``): every process streams
  every Nth read batch on its own single-device pipeline, and the count
  vectors are summed at the end.  The sharded pipeline stays
  single-process, as in the JAX package.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from strainscan_tpu.config import IdentifyConfig
from strainscan_tpu.index.hashtable import FpTable, KmerTable
from strainscan_tpu.io import fastx
from strainscan_tpu.utils.prefetch import prefetch_iter
from strainscan_tpu_torch.ops.count import CountPipeline, Payload
from strainscan_tpu_torch.parallel import distributed as dist
from strainscan_tpu_torch.parallel.sharded import (Mesh, ShardedCountPipeline,
                                                   resolve_mesh)

PathLike = Union[str, Sequence[str]]

# Tiny LRU of ShardedCountPipelines (see count_sample): 2 entries, so the
# big main-table pipeline survives the per-sample L2-union pipeline.  An
# entry holds (keys, (n, k, canonical, mesh devices), pipeline); a lookup
# matches the cheap metadata first and then the keys themselves (never a
# checksum of them), so a rebuilt but equal key array (vote's L2 union of
# the same clusters) hits the cache, and two different key sets never
# share a pipeline.
_SHARDED_CACHE: list = []
_SHARDED_CACHE_MAX = 2


def _sharded_pipeline(keys: np.ndarray, k: int, canonical: bool,
                      mesh: Mesh) -> ShardedCountPipeline:
    """Cached ShardedCountPipeline for this key set on this mesh."""
    meta = (keys.size, k, canonical, mesh.grid)
    for i, (ckeys, cmeta, cpipe) in enumerate(_SHARDED_CACHE):
        if cmeta == meta and (ckeys is keys or np.array_equal(ckeys, keys)):
            _SHARDED_CACHE.insert(0, _SHARDED_CACHE.pop(i))
            cpipe.reset()
            return cpipe
    pipe = ShardedCountPipeline(keys, k=k, mesh=mesh, canonical=canonical)
    _SHARDED_CACHE.insert(0, (keys, meta, pipe))
    for _, _, old in _SHARDED_CACHE[_SHARDED_CACHE_MAX:]:
        old.close()   # free device memory now, not at GC time
    del _SHARDED_CACHE[_SHARDED_CACHE_MAX:]
    return pipe


def iter_payloads(pipe, fq_paths: PathLike,
                  cfg: IdentifyConfig = IdentifyConfig(),
                  use_native: bool = True) -> Iterator[List[Payload]]:
    """Prepared batches of this process's share of the sample (every Nth
    batch of N processes), parsed and packed in a producer thread
    (``pipe.prepare_batch``), ready for ``pipe.add_prepared``."""
    pidx, pcount = dist.process_info()
    batches = fastx.read_batches(
        fq_paths, batch=cfg.read_batch, maxlen=cfg.max_read_len,
        k=pipe.k, use_native=use_native)
    return prefetch_iter(pipe.prepare_batch(b)
                         for bi, b in enumerate(batches)
                         if bi % pcount == pidx)


def count_sample(
    table: Union[FpTable, KmerTable],
    fq_paths: PathLike,
    device,
    cfg: IdentifyConfig = IdentifyConfig(),
    canonical: bool = False,
    use_native: bool = True,
    keys: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Stream the sample through the count pipeline; int32 counts in the
    table's id space.

    ``device``: a device (``"cuda:0"``, ``"cpu"``), a device list or a
    :class:`Mesh` (see ``resolve_mesh``).  ``keys``: the table's key array
    in id order, which the sharded pipeline is built from."""
    mesh = resolve_mesh(device)
    pcount = dist.process_info()[1]
    if (keys is not None and pcount == 1 and mesh.size > 1
            and keys.size >= cfg.shard_min_kmers):
        pipe = _sharded_pipeline(keys, table.k, canonical, mesh)
    else:
        pipe = CountPipeline(table, mesh.first, canonical=canonical)
    for payloads in iter_payloads(pipe, fq_paths, cfg, use_native):
        pipe.add_prepared(payloads)
    counts = pipe.finish()
    if pcount > 1:
        counts = dist.merge_counts(counts)
    return counts
