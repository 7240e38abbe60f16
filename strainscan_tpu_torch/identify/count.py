"""Sample counting: FASTQ -> per-DB-k-mer hit counts.

Port of ``strainscan_tpu/identify/count.py`` (the jellyfish replacement of
reference library/identify.py:73-103).  Parse and pack run in a producer
thread (``utils.prefetch``), and so does the sharded pipeline's copy to its
devices (``ShardedCountPipeline.ship``); the main thread launches the
count (and copies the batch first on the single-device pipeline, which
copies on a side stream of its own).

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

import threading
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from strainscan_tpu_torch.config import IdentifyConfig
from strainscan_tpu_torch.index.hashtable import FpTable, KmerTable
from strainscan_tpu_torch.io import fastx
from strainscan_tpu_torch.ops.count import CountPipeline, Payload
from strainscan_tpu_torch.parallel import distributed as dist
from strainscan_tpu_torch.parallel.sharded import (Mesh, ShardedCountPipeline,
                                                   resolve_mesh)
from strainscan_tpu_torch.utils.prefetch import prefetch_iter

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

# batches the producer thread keeps ready (utils.prefetch's default)
PREFETCH_DEPTH = 2


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
    (``pipe.prepare_batch``) and, where the pipeline has ``ship``, copied
    to its devices in that thread too, as the JAX package's
    ``count_sample`` ships them; ready for ``pipe.add_prepared``."""
    pidx, pcount = dist.process_info()
    batches = fastx.read_batches(
        fq_paths, batch=cfg.read_batch, maxlen=cfg.max_read_len,
        k=pipe.k, use_native=use_native)
    prepared = (pipe.prepare_batch(b) for bi, b in enumerate(batches)
                if bi % pcount == pidx)
    ship = getattr(pipe, "ship", None)
    if ship is None:
        return prefetch_iter(prepared, PREFETCH_DEPTH)
    return _shipped(prepared, ship)


def _shipped(prepared, ship) -> Iterator:
    """``ship`` of each of ``prepared`` in the producer thread, with at
    most ``PREFETCH_DEPTH + 1`` shipped batches alive: the one the caller
    counts and those queued or in the copy.  The producer takes a slot
    before it ships; a slot frees when the caller asks for the next batch,
    having launched the count of the last one."""
    slots = threading.Semaphore(PREFETCH_DEPTH + 1)

    def produce():
        for payloads in prepared:
            slots.acquire()
            yield ship(payloads)

    for shipped in prefetch_iter(produce(), PREFETCH_DEPTH):
        yield shipped
        slots.release()


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
