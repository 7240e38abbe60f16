"""Sample counting: FASTQ -> per-DB-k-mer hit counts.

Port of ``strainscan_tpu/identify/count.py`` (the jellyfish replacement of
reference library/identify.py:73-103).  Parse and pack run in a producer
thread (``utils.prefetch``), and so does the sharded pipeline's copy to its
devices (``ShardedCountPipeline.ship``); the main thread launches the
count (and copies the batch first on the single-device pipeline, which
copies on a side stream of its own).  Spans (``timing``): ``count/sample``
around each count, ``count/parse`` and ``count/pack`` per batch in the
producer, ``count/wait`` per wait of the main thread for a batch.

* One device (a 1 x 1 mesh): :class:`..ops.count.CountPipeline`.
* A mesh of several positions, one process, the DB's key array given and a
  table of at least ``cfg.shard_min_kmers`` keys:
  :class:`..parallel.sharded.ShardedCountPipeline`, from a 2-entry cache.
* Several processes (``parallel.distributed``): every process streams
  every Nth read batch on its own single-device pipeline, and the count
  vectors are summed at the end.  The sharded pipeline stays
  single-process, as in the JAX package.

A second count over the same reads (the L2 union count) can skip the
FASTQ: ``count_sample(..., keep=KeptBatches())`` keeps the device payloads
a single-device count launched, up to :func:`keep_cap` bytes, and
:func:`count_kept` counts them again against another table.
:data:`KEEP_STATS` tells how often that served.
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from strainscan_tpu_torch import timing
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

# most payload bytes a KeptBatches holds (4 GiB: about 60 M reads of 100 bp
# in 65,536 x 256 batches); on a GPU also at most a quarter of its free
# memory when the count starts
KEEP_CAP_BYTES = 4 << 30

# second counts over kept payloads: ``kept`` served from them (``bytes``:
# the payload bytes they counted), ``streamed`` that read the FASTQ again;
# ``over_cap``: counts whose keeping stopped at the cap
KEEP_STATS = {"kept": 0, "streamed": 0, "over_cap": 0, "bytes": 0}


def reset_keep_stats() -> None:
    """Zero :data:`KEEP_STATS`."""
    KEEP_STATS.update(dict.fromkeys(KEEP_STATS, 0))


def keep_cap(device: torch.device) -> int:
    """The most payload bytes a count on ``device`` keeps."""
    if device.type != "cuda":
        return KEEP_CAP_BYTES
    return min(KEEP_CAP_BYTES, torch.cuda.mem_get_info(device)[0] // 4)


class KeptBatches:
    """The device payloads of one count, kept for another count of the
    same reads.  ``count_sample`` opens it for a single-device count
    (:meth:`open`) and its pipeline adds each payload after launching its
    count (:meth:`add`); past the cap it drops them all and is not
    ``usable``.  As a context manager it releases them on leaving.
    ``meta``, set at the count's end (:meth:`seal`), is what the payloads
    depend on: the device, ``k`` (which reads ``read_batches`` drops), the
    probe mode (the vlen form is the fp mode's), ``packed_transfer`` and
    the pinned batch shape."""

    def __init__(self):
        self.payloads: List[Payload] = []
        self.nbytes = self.cap = 0
        self.usable = False
        self.meta = None

    def __enter__(self) -> "KeptBatches":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def open(self, pipe: CountPipeline) -> None:
        """Start keeping for ``pipe``'s count (the holder is empty)."""
        self.cap, self.usable = keep_cap(pipe.device), True

    def add(self, payload: Payload) -> None:
        if not self.usable:
            return
        n = sum(t.element_size() * t.numel() for t in payload[1:]
                if t is not None)
        if self.nbytes + n > self.cap:
            KEEP_STATS["over_cap"] += 1
            self.release()
            return
        self.payloads.append(payload)
        self.nbytes += n

    def seal(self, pipe: CountPipeline) -> None:
        """Record what the kept payloads depend on, at the count's end."""
        self.meta = (pipe.device, pipe.k, pipe.probe_mode,
                     pipe.packed_transfer, pipe.shape)

    def release(self) -> None:
        """Drop the payloads (their device memory frees once the kernels
        that read them are done)."""
        self.payloads, self.nbytes, self.usable = [], 0, False
        self.meta = None


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
    ``count_sample`` ships them; ready for ``pipe.add_prepared``.  Each
    parse and each ``prepare_batch`` is a span (``count/parse``,
    ``count/pack``)."""
    pidx, pcount = dist.process_info()
    batches = timing.timed_iter(fastx.read_batches(
        fq_paths, batch=cfg.read_batch, maxlen=cfg.max_read_len,
        k=pipe.k, use_native=use_native), "count/parse")
    prepared = (_prepare(pipe, b) for bi, b in enumerate(batches)
                if bi % pcount == pidx)
    ship = getattr(pipe, "ship", None)
    if ship is None:
        return prefetch_iter(prepared, PREFETCH_DEPTH)
    return _shipped(prepared, ship)


def _prepare(pipe, codes: np.ndarray) -> List[Payload]:
    """``pipe.prepare_batch(codes)`` in a ``count/pack`` span."""
    with timing.span("count/pack"):
        return pipe.prepare_batch(codes)


def _shipped(prepared, ship) -> Iterator:
    """``ship`` of each of ``prepared`` in the producer thread, with at
    most ``PREFETCH_DEPTH + 1`` shipped batches alive: the one the caller
    counts and those queued or in the copy.  The producer takes a slot
    before it ships; a slot frees when the caller asks for the next batch,
    having launched the count of the last one.  The producer's context is
    this call's (``prefetch_iter``)."""
    slots = threading.Semaphore(PREFETCH_DEPTH + 1)

    def produce():
        for payloads in prepared:
            slots.acquire()
            yield ship(payloads)

    def released(ready):
        for shipped in ready:
            yield shipped
            slots.release()

    return released(prefetch_iter(produce(), PREFETCH_DEPTH))


def _sharded(keys: Optional[np.ndarray], mesh: Mesh,
             cfg: IdentifyConfig) -> bool:
    """Whether a count of ``keys`` on ``mesh`` takes the sharded
    pipeline."""
    return (keys is not None and dist.process_info()[1] == 1
            and mesh.size > 1 and keys.size >= cfg.shard_min_kmers)


def count_sample(
    table: Union[FpTable, KmerTable],
    fq_paths: PathLike,
    device,
    cfg: IdentifyConfig = IdentifyConfig(),
    canonical: bool = False,
    use_native: bool = True,
    keys: Optional[np.ndarray] = None,
    keep: Optional[KeptBatches] = None,
) -> np.ndarray:
    """Stream the sample through the count pipeline; int32 counts in the
    table's id space.

    ``device``: a device (``"cuda:0"``, ``"cpu"``), a device list or a
    :class:`Mesh` (see ``resolve_mesh``).  ``keys``: the table's key array
    in id order, which the sharded pipeline is built from.  ``keep``: a
    holder that a single-device count fills with its device payloads (the
    sharded count leaves it empty), for :func:`count_kept`.

    The count is a span ``count/sample``, each wait for the producer's
    next batch a ``count/wait`` span."""
    with timing.span("count/sample"):
        mesh = resolve_mesh(device)
        if keep is not None:
            keep.release()
        if _sharded(keys, mesh, cfg):
            pipe, keep = _sharded_pipeline(keys, table.k, canonical, mesh), None
        else:
            pipe = CountPipeline(table, mesh.first, canonical=canonical)
            if keep is not None:
                keep.open(pipe)
        extra = {} if keep is None else {"keep": keep}
        for payloads in timing.timed_iter(
                iter_payloads(pipe, fq_paths, cfg, use_native), "count/wait"):
            pipe.add_prepared(payloads, **extra)
        if keep is not None:
            keep.seal(pipe)
        return _finish(pipe)


def _finish(pipe) -> np.ndarray:
    """``pipe.finish()``, summed over the processes."""
    counts = pipe.finish()
    if dist.process_info()[1] > 1:
        counts = dist.merge_counts(counts)
    return counts


def count_kept(
    table: FpTable,
    keep: Optional[KeptBatches],
    device,
    cfg: IdentifyConfig = IdentifyConfig(),
    canonical: bool = False,
    keys: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """``count_sample``'s counts of the reads whose payloads ``keep``
    holds, from those payloads: one count per payload into a fresh
    pipeline of the kept batch shape, in a span ``count/sample``.  None
    (counted in :data:`KEEP_STATS` as ``streamed``) where ``keep`` cannot
    give what streaming would: none given, released or over the cap, a
    sharded count of ``keys`` on ``device``, or payloads of another device,
    ``k``, probe mode or payload form."""
    mesh = resolve_mesh(device)
    if (keep is None or not keep.usable or keep.meta is None
            or _sharded(keys, mesh, cfg)
            or keep.meta[:4] != (mesh.first, table.k, "fp", True)):
        KEEP_STATS["streamed"] += 1
        return None
    with timing.span("count/sample"):
        pipe = CountPipeline(table, mesh.first, canonical=canonical,
                             shape=keep.meta[4])
        for payload in keep.payloads:
            pipe.add_device(payload)
        KEEP_STATS["kept"] += 1
        KEEP_STATS["bytes"] += keep.nbytes
        return _finish(pipe)
