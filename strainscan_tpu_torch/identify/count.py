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

``count_sample`` of FASTQ paths streams the sample once.
:class:`SampleReads` owns one sample's reads and counts them against any
table (``count_sample`` of a ``SampleReads`` is its ``count``): its first
count, where single-device, keeps the device payloads it launched, up to
:func:`keep_cap` bytes, and a later count of the same ``k`` reads them
instead of the FASTQ (the L2 union count, the plasmid count).
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Sequence, Tuple, Union

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

# most payload bytes a SampleReads keeps (4 GiB: about 60 M reads of 100 bp
# in 65,536 x 256 batches); on a GPU also at most a quarter of its free
# memory when the count starts
KEEP_CAP_BYTES = 4 << 30


def keep_cap(device: torch.device) -> int:
    """The most payload bytes a count on ``device`` keeps."""
    if device.type != "cuda":
        return KEEP_CAP_BYTES
    return min(KEEP_CAP_BYTES, torch.cuda.mem_get_info(device)[0] // 4)


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


def _pipeline(table: Union[FpTable, KmerTable], mesh: Mesh,
              cfg: IdentifyConfig, canonical: bool,
              keys: Optional[np.ndarray],
              shape: Optional[Tuple[int, int]] = None):
    """The pipeline of one count: the cached sharded pipeline where
    :func:`_sharded` holds, else a single-device :class:`CountPipeline`
    of batch shape ``shape`` (None: its first batch pins it)."""
    if _sharded(keys, mesh, cfg):
        return _sharded_pipeline(keys, table.k, canonical, mesh)
    return CountPipeline(table, mesh.first, canonical=canonical, shape=shape)


def _stream(pipe, fq_paths: PathLike, cfg: IdentifyConfig,
            use_native: bool, cap: Optional[int] = None
            ) -> Tuple[Optional[List[Payload]], int]:
    """Stream the sample through ``pipe``; each wait for the producer's
    next batch is a ``count/wait`` span.  With a ``cap`` (a single-device
    ``pipe``), returns the device payloads counted and their bytes, or
    None once they pass ``cap`` bytes (noted ``over_cap=True`` on the
    open span); without one, drops each batch's payloads as soon as its
    count is launched and returns None."""
    kept, nbytes = ([] if cap is not None else None), 0
    for payloads in timing.timed_iter(
            iter_payloads(pipe, fq_paths, cfg, use_native), "count/wait"):
        if kept is None:
            pipe.add_prepared(payloads)   # its device payloads free here
            continue
        counted = pipe.add_prepared(payloads)
        nbytes += sum(t.element_size() * t.numel() for p in counted
                      for t in p[1:] if t is not None)
        if nbytes > cap:
            kept = None
            timing.note(over_cap=True)
        else:
            kept += counted
    return kept, nbytes


def count_sample(
    table: Union[FpTable, KmerTable],
    fq_paths: Union[PathLike, "SampleReads"],
    device,
    cfg: IdentifyConfig = IdentifyConfig(),
    canonical: bool = False,
    use_native: bool = True,
    keys: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Int32 counts of the sample's k-mers in the table's id space.

    ``fq_paths``: the FASTQ path(s), streamed once through the count
    pipeline with nothing kept; or the sample's :class:`SampleReads`,
    whose :meth:`SampleReads.count` counts them on its own device, config
    and parser (the identify path counts every table this way).
    ``device``: a device (``"cuda:0"``, ``"cpu"``), a device list or a
    :class:`Mesh` (see ``resolve_mesh``).  ``keys``: the table's key array
    in id order, which the sharded pipeline is built from.

    The count is a span ``count/sample`` noting ``source="stream"``."""
    if isinstance(fq_paths, SampleReads):
        return fq_paths.count(table, canonical=canonical, keys=keys)
    with timing.span("count/sample"):
        timing.note(source="stream")
        pipe = _pipeline(table, resolve_mesh(device), cfg, canonical, keys)
        _stream(pipe, fq_paths, cfg, use_native)
        return _finish(pipe)


def _finish(pipe) -> np.ndarray:
    """``pipe.finish()``, summed over the processes."""
    counts = pipe.finish()
    if dist.process_info()[1] > 1:
        counts = dist.merge_counts(counts)
    return counts


class SampleReads:
    """One sample's reads (``fq_paths``) on ``device`` (resolved to a
    :class:`Mesh`, ``.device``), counted against any table by
    :meth:`count`; a context manager that drops the kept payloads on
    leaving.

    Only the first count may keep: where it is a single-device count, it
    streams the FASTQ and keeps the device payloads it counted, up to
    :func:`keep_cap` bytes (past it, none).  A later single-device count
    of the same ``k`` counts those payloads in a pipeline of their batch
    shape; one of another ``k`` (``read_batches`` drops the reads shorter
    than ``k``), a sharded count, and any count after leaving stream the
    FASTQ and keep nothing.  Each count is a ``count/sample`` span noting
    its ``source`` (``stream`` or ``kept``), ``kept_bytes`` where kept,
    and ``over_cap=True`` where its keeping stopped at the cap."""

    def __init__(self, fq_paths: PathLike, device,
                 cfg: IdentifyConfig = IdentifyConfig(),
                 use_native: bool = True):
        self.fq_paths, self.cfg, self.use_native = fq_paths, cfg, use_native
        self.device = resolve_mesh(device)
        self._first = True        # no count yet: the next one may keep
        self._kept: List[Payload] = []
        self._k = self._shape = None   # of the kept payloads
        self._nbytes = 0

    def __enter__(self) -> "SampleReads":
        return self

    def __exit__(self, *exc) -> None:
        # their device memory frees once the kernels that read them are done
        self._first, self._kept, self._k, self._nbytes = False, [], None, 0

    def count(self, table: Union[FpTable, KmerTable], *,
              canonical: bool = False,
              keys: Optional[np.ndarray] = None) -> np.ndarray:
        """``count_sample``'s int32 counts of these reads against
        ``table`` (``keys``: its key array in id order, for the sharded
        pipeline)."""
        with timing.span("count/sample"):
            kept = self._k == table.k
            pipe = _pipeline(table, self.device, self.cfg, canonical, keys,
                             self._shape if kept else None)
            single = isinstance(pipe, CountPipeline)
            first, self._first = self._first, False
            if kept and single:
                timing.note(source="kept", kept_bytes=self._nbytes)
                for payload in self._kept:
                    pipe.add_device(payload)
            else:
                timing.note(source="stream")
                cap = keep_cap(pipe.device) if first and single else None
                payloads, nbytes = _stream(pipe, self.fq_paths, self.cfg,
                                           self.use_native, cap)
                if payloads is not None:
                    self._kept, self._k, self._shape, self._nbytes = (
                        payloads, pipe.k, pipe.shape, nbytes)
            return _finish(pipe)
