"""Multi-device scale-out: an index-sharded k-mer table, data-parallel read
streams, and the L2 statistics with the k-mer axis split over the devices.

Port of ``strainscan_tpu/parallel/sharded.py``.  JAX's ``Mesh`` becomes
:class:`Mesh`, a plain 2-D grid of ``torch.device`` over the axes
``("data", "index")`` that one process drives, as JAX's single controller
drives its mesh.  A device may stand at several positions (four ``cuda:0``
entries make a 2 x 2 mesh on a card that is alone; eight ``cpu`` entries
are the CPU twin of the JAX tests' 8-virtual-device mesh); every position
owns its own accumulator all the same.

Layout, as in the JAX package:

* the key array is sorted and split into ``index`` contiguous shards, each
  with its own table at one common geometry (:class:`ShardedTable` exact,
  :class:`ShardedFpTable` fingerprint);
* read rows split over ``data``; each position counts its data block
  against its index shard with one kernel launch (``count_exact`` /
  ``count_fp``) on its device's current stream;
* the collectives are explicit integer sums: ``psum`` over ``data`` sums the
  positions' tensors on the first device of each index column, and
  ``all_gather`` over ``index`` is a concatenation.  Integer sums are exact
  in any order, so the result is bit-identical to one device's.

Cross-device copies (``Tensor.to``) order themselves after the source
device's current stream, so each sum waits for the kernels before it.
Read batches reach the devices through :meth:`ShardedCountPipeline.ship`
(from the producer thread, on a copy stream per device), as the JAX
package's ``ship`` moves them there from its producer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from strainscan_tpu_torch.index.hashtable import (BUCKET, KmerTable,
                                                  build_fp_shards)
from strainscan_tpu_torch.device import resolve_device
from strainscan_tpu_torch.kmer.device import from_u32
from strainscan_tpu_torch.ops import l2
from strainscan_tpu_torch.ops.count import (Payload, fetch_counts,
                                            pack_payload, pad_invalid_rows,
                                            shape_batch)
from strainscan_tpu_torch.ops.probe import FpScratch, count_exact, count_fp
from strainscan_tpu_torch.parallel import distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices on a ``[data, index]`` grid; positions may share a device."""

    grid: Tuple[Tuple[torch.device, ...], ...]

    axis_names = ("data", "index")

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "index": len(self.grid[0])}

    @property
    def size(self) -> int:
        return len(self.grid) * len(self.grid[0])

    @property
    def devices(self) -> List[torch.device]:
        """The positions' devices, data-major (JAX's axis order)."""
        return [dev for row in self.grid for dev in row]

    @property
    def first(self) -> torch.device:
        return self.grid[0][0]

    def __str__(self) -> str:
        d, i = self.shape["data"], self.shape["index"]
        return f"mesh {d}x{i} of {[str(x) for x in self.devices]}"


def make_mesh(devices: Optional[Sequence] = None,
              index_shards: Optional[int] = None) -> Mesh:
    """Mesh over ('data', 'index').  ``devices`` default to every visible
    GPU; the index axis defaults to 2 when the device count is even and
    >= 2, else 1 (pure data parallelism)."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device is visible: pass the mesh's "
                               "devices (e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if index_shards is None:
        index_shards = 2 if n % 2 == 0 and n >= 2 else 1
    data_shards = n // index_shards
    if data_shards == 0:
        raise ValueError(f"{n} devices cannot hold {index_shards} shards")
    return Mesh(tuple(tuple(devs[r * index_shards:(r + 1) * index_shards])
                      for r in range(data_shards)))


def resolve_mesh(device) -> Mesh:
    """The mesh a run counts on: a :class:`Mesh` as it is; a list of
    devices -> :func:`make_mesh` of it; a bare ``"cuda"`` -> every visible
    GPU (raises without one), or with several processes this process's
    own GPU (``distributed.local_device_index``); ``"cuda:N"``, ``"cpu"``
    or a ``torch.device`` -> a 1 x 1 mesh.  A 1 x 1 mesh is the
    single-device path."""
    if isinstance(device, Mesh):
        return device
    if isinstance(device, (list, tuple)):
        return make_mesh(device)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)           # raises without a usable GPU
        if dist.process_info()[1] > 1:
            i = dist.local_device_index(torch.cuda.device_count())
            return make_mesh([torch.device("cuda", i)])
        return make_mesh()
    return make_mesh([dev])


def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device (a no-op for the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _sum(parts: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """Sum of ``parts`` on ``dev`` (the psum of one mesh axis)."""
    out = parts[0].to(dev)
    for t in parts[1:]:
        out = out + t.to(dev)
    return out


def _split_sorted(keys: np.ndarray, values: Optional[np.ndarray],
                  n_shards: int):
    """(sorted keys, their caller ids, per-shard capacity)."""
    n = keys.shape[0]
    if values is None:
        values = np.arange(n, dtype=np.int32)
    order = np.argsort(keys, kind="stable")
    cap = -(-max(n, 1) // n_shards)
    return keys[order], values[order].astype(np.int32), cap


@dataclasses.dataclass
class ShardedTable:
    """Rectangular stack of per-shard exact tables + shard id offsets
    (host copy of the JAX package's builder, which imports jax)."""

    table: np.ndarray    # [n_shards, n_buckets, BUCKET*3] interleaved
    n_buckets: int       # per shard (uniform)
    max_probe: int       # max across shards
    shard_sizes: np.ndarray  # [n_shards] number of keys per shard
    shard_cap: int       # padded per-shard key capacity (id space stride)
    n_keys: int
    k: int
    value_map: Optional[np.ndarray] = None  # sharded slot -> caller id

    @classmethod
    def build(cls, keys: np.ndarray, k: int, n_shards: int,
              values: Optional[np.ndarray] = None) -> "ShardedTable":
        """``keys`` in any order; ``values`` (default ``arange``) are the
        caller's global ids for each key.  Keys are sorted and split into
        contiguous shards."""
        keys_sorted, vals_sorted, cap = _split_sorted(keys, values, n_shards)
        chunks = [keys_sorted[s * cap:(s + 1) * cap] for s in range(n_shards)]
        tables = [KmerTable.build(c, k=k) for c in chunks]
        value_map = np.full(n_shards * cap, -1, dtype=np.int32)
        for s, c in enumerate(chunks):
            value_map[s * cap:s * cap + c.size] = \
                vals_sorted[s * cap:(s + 1) * cap]
        n_buckets = max(t.n_buckets for t in tables)
        max_probe = max(t.max_probe for t in tables)
        # rebuild smaller shards at the common bucket count so the stack is
        # rectangular and the hash and probe math is uniform
        for i, t in enumerate(tables):
            if t.n_buckets != n_buckets:
                # force the bucket count by lowering the load factor
                lf = max(len(chunks[i]), 1) / (n_buckets * BUCKET)
                tables[i] = KmerTable.build(chunks[i], k=k, load_factor=lf)
                max_probe = max(max_probe, tables[i].max_probe)
        return cls(table=np.stack([t.interleaved() for t in tables]),
                   n_buckets=n_buckets, max_probe=max_probe,
                   shard_sizes=np.array([c.size for c in chunks]),
                   shard_cap=cap, n_keys=keys.shape[0], k=k,
                   value_map=value_map)


def sharded_count(mesh: Mesh, st: ShardedTable, codes: np.ndarray,
                  canonical: bool = False) -> torch.Tensor:
    """int32 counts ``[n_shards * shard_cap]`` on ``mesh.first`` (global id
    = shard * cap + local id): rows split over ``data`` (padded with
    invalid rows), one ``count_exact`` launch per position on its data
    block and index shard, summed over ``data`` and concatenated over
    ``index``."""
    d, n_index = mesh.shape["data"], mesh.shape["index"]
    if st.table.shape[0] != n_index:
        raise ValueError(f"{st.table.shape[0]} shards on a mesh with "
                         f"{n_index} index positions")
    codes = pad_invalid_rows(np.ascontiguousarray(codes, dtype=np.uint8), d)
    rows, length = codes.shape[0] // d, codes.shape[1]
    cap = st.shard_cap
    on_dev: dict = {}   # one copy per (block, device)

    def upload(name, i, host, dev):
        if (name, i, str(dev)) not in on_dev:
            on_dev[name, i, str(dev)] = torch.from_numpy(host).to(dev)
        return on_dev[name, i, str(dev)]

    columns = []
    for ii in range(n_index):
        parts = []
        for di in range(d):
            dev = mesh.grid[di][ii]
            blk = upload("codes", di, codes[di * rows:(di + 1) * rows], dev)
            tab = upload("table", ii, st.table[ii], dev)
            with _on(dev):
                c = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
                count_exact(c, blk, tab, length=length, k=st.k,
                            max_probe=st.max_probe, canonical=canonical)
            parts.append(c[:cap])
        columns.append(_sum(parts, mesh.grid[0][ii]))
    return torch.cat([c.to(mesh.first) for c in columns])


@dataclasses.dataclass
class ShardedFpTable:
    """Rectangular stack of single-probe fingerprint shards at one common
    (n_buckets, bucket, seed) geometry (``hashtable.build_fp_shards``) plus
    the slot->id remap arrays (host copy of the JAX package's builder)."""

    fp: np.ndarray        # uint32 [n_shards, n_buckets, bucket]
    soi: np.ndarray       # int32  [n_shards, shard_cap] slot of local id
    n_buckets: int
    bucket: int
    seed: int
    shard_cap: int        # padded per-shard key capacity (id space stride)
    n_keys: int
    k: int
    value_map: np.ndarray  # [n_shards*cap] -> caller ids (-1 = padding)

    @property
    def n_slots(self) -> int:
        return self.n_buckets * self.bucket

    @classmethod
    def build(cls, keys: np.ndarray, k: int, n_shards: int,
              values: Optional[np.ndarray] = None) -> "ShardedFpTable":
        keys_sorted, vals_sorted, cap = _split_sorted(keys, values, n_shards)
        chunks = [keys_sorted[s * cap:(s + 1) * cap] for s in range(n_shards)]
        tables = build_fp_shards(chunks, k=k)
        value_map = np.full(n_shards * cap, -1, dtype=np.int32)
        n_slots = tables[0].n_slots
        soi = np.full((n_shards, cap), n_slots, dtype=np.int32)  # pad->trash
        for s, t in enumerate(tables):
            m = chunks[s].size
            value_map[s * cap:s * cap + m] = vals_sorted[s * cap:(s + 1) * cap]
            if m:
                soi[s, :m] = t.slot_of_id()
        return cls(fp=np.stack([t.fp.reshape(t.n_buckets, t.bucket)
                                for t in tables]),
                   soi=soi, n_buckets=tables[0].n_buckets,
                   bucket=tables[0].bucket, seed=tables[0].seed,
                   shard_cap=cap, n_keys=keys.shape[0], k=k,
                   value_map=value_map)


class Shipped(NamedTuple):
    """A payload on the mesh's devices (:meth:`ShardedCountPipeline.ship`):
    for each (data group, device) the group's rows ``(a, b)`` on that
    device and the event that follows their copy (None off CUDA)."""

    form: str
    parts: Dict[Tuple[int, str], Tuple[torch.Tensor,
                                       Optional[torch.Tensor],
                                       Optional[torch.cuda.Event]]]


class ShardedCountPipeline:
    """Multi-device drop-in for :class:`..ops.count.CountPipeline`: the
    fingerprint table is sharded over the mesh's ``index`` axis, read
    batches stream over ``data``, every position keeps its own slot-space
    total, and :meth:`finish` merges them once.

    Host to device (:meth:`ship`): each data group's rows go whole to every
    device of the group, once per device (positions that share a device
    share the copy), so every byte crosses the host link at most once per
    device.  On CUDA the copies run on a copy stream of each device, beside
    its kernels rather than in series with them.

    :meth:`finish` returns counts in the CALLER's k-mer id space (the
    ``values`` passed to ``build``), like the single-device pipeline.
    """

    def __init__(self, keys: np.ndarray, k: int, mesh: Optional[Mesh] = None,
                 values: Optional[np.ndarray] = None,
                 canonical: bool = False, packed_transfer: bool = True):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.st = ShardedFpTable.build(keys, k=k,
                                       n_shards=self.mesh.shape["index"],
                                       values=values)
        self.k = k
        self.canonical = canonical
        self.packed_transfer = packed_transfer
        self._pin = any(dev.type == "cuda" for dev in self.mesh.devices)
        # one copy stream per CUDA device, for the pipeline's life
        self._copy_streams = {str(dev): torch.cuda.Stream(dev)
                              for dev in set(self.mesh.devices)
                              if dev.type == "cuda"}
        self._fp_dev: Optional[dict] = None     # (index, device) -> shard
        self._soi_dev: Optional[list] = None    # per index column
        self._totals: Optional[list] = None     # [data][index] accumulators
        self._shape: Optional[tuple] = None
        self._vm_ident: Optional[bool] = None
        self._scratch = FpScratch()              # per device, reused

    def _ensure_device_state(self) -> None:
        if self._fp_dev is None:
            self._fp_dev = {}
            for row in self.mesh.grid:
                for ii, dev in enumerate(row):
                    if (ii, str(dev)) not in self._fp_dev:
                        self._fp_dev[ii, str(dev)] = from_u32(
                            self.st.fp[ii]).to(dev)
        if self._totals is None:
            n = self.st.n_slots + 1
            self._totals = [[torch.zeros(n, dtype=torch.int32, device=dev)
                             for dev in row] for row in self.mesh.grid]

    def prepare_batch(self, codes: np.ndarray) -> List[Payload]:
        """Host half of :meth:`add_batch`: shape pinning and padding
        (:func:`..ops.count.shape_batch`, rows a multiple of data x index),
        then packing, as ``CountPipeline.prepare_batch``.  Only the
        producer thread may call it: it owns the batch shape."""
        self._shape, blocks = shape_batch(codes, self._shape, self.mesh.size)
        return [pack_payload(b, self.packed_transfer, True, self._pin)
                for b in blocks]

    def _copy(self, host: Sequence[Optional[torch.Tensor]],
              dev: torch.device):
        """``host`` on ``dev``: on CUDA an asynchronous copy on the
        device's copy stream, and the event recorded after it."""
        if dev.type != "cuda":
            return (*(None if t is None else t.to(dev) for t in host), None)
        stream = self._copy_streams[str(dev)]
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            moved = [None if t is None else t.to(dev, non_blocking=True)
                     for t in host]
            done = torch.cuda.Event()
            done.record(stream)
        return (*moved, done)

    def ship(self, payloads: List[Payload]) -> List[Shipped]:
        """h2d half of :meth:`add_prepared`: each data group's rows of each
        payload to each device of the group, once per device.  Called from
        the producer thread (``identify.count.iter_payloads``), so the copy
        runs while the main thread launches the kernels of the last
        batch."""
        d = self.mesh.shape["data"]
        out = []
        for form, a, b in payloads:
            rows = a.shape[0] // d
            parts: dict = {}
            for di, row in enumerate(self.mesh.grid):
                block = [None if t is None else t[di * rows:(di + 1) * rows]
                         for t in (a, b)]
                for dev in row:
                    if (di, str(dev)) not in parts:
                        parts[di, str(dev)] = self._copy(block, dev)
            out.append(Shipped(form, parts))
        return out

    def add_prepared(self, payloads) -> None:
        """Launch one ``count_fp`` per position on its shard, for payloads
        from :meth:`ship` or from :meth:`prepare_batch` (shipped here).
        Each device's current stream first waits for the batch's copy to
        it; the copied tensors are marked used there, so their memory is
        reused only after the kernels that read them."""
        self._ensure_device_state()
        st, cols = self.st, self._shape[1]
        for p in payloads:
            if not isinstance(p, Shipped):
                (p,) = self.ship([p])
            for a, b, done in p.parts.values():
                if done is not None:
                    cur = torch.cuda.current_stream(a.device)
                    cur.wait_event(done)
                    for t in (a, b):
                        if t is not None:
                            t.record_stream(cur)
            for di, row in enumerate(self.mesh.grid):
                for ii, dev in enumerate(row):
                    reads, valid, _ = p.parts[di, str(dev)]
                    with _on(dev):
                        count_fp(self._totals[di][ii], reads,
                                 self._fp_dev[ii, str(dev)], length=cols,
                                 k=st.k, seed=st.seed,
                                 canonical=self.canonical,
                                 scratch=self._scratch,
                                 **({} if valid is None
                                    else {p.form: valid}))

    def add_batch(self, codes: np.ndarray) -> None:
        self.add_prepared(self.prepare_batch(codes))

    def reset(self) -> None:
        """Drop the totals and re-pin the batch shape (a cached pipeline
        first used on a tiny sample must not keep splitting later
        full-size batches); the table shards stay on the devices."""
        self._totals = None
        self._shape = None

    def close(self) -> None:
        """Drop the device buffers (table shards, totals, slot_of_id and
        the count's scratch), so an evicted cache entry frees device
        memory now, not at GC time."""
        self._fp_dev = None
        self._totals = None
        self._soi_dev = None
        self._scratch = FpScratch()

    def finish(self) -> np.ndarray:
        """int32 ``[n_keys]`` counts in the caller's id space: the totals
        summed over ``data``, gathered through each shard's ``soi``,
        concatenated over ``index`` on the first device, fetched by
        :func:`..ops.count.fetch_counts` at its padded length (padding ids
        read the trash slot, as in the JAX finish), then mapped through
        ``value_map``."""
        st = self.st
        if self._totals is None:
            return np.zeros(st.n_keys, dtype=np.int32)
        t0 = time.perf_counter()
        heads = self.mesh.grid[0]
        upload = self._soi_dev is None
        if upload:
            self._soi_dev = [torch.from_numpy(st.soi[ii]).to(dev)
                             for ii, dev in enumerate(heads)]
        columns = []
        for ii, dev in enumerate(heads):
            total = _sum([row[ii] for row in self._totals], dev)
            columns.append(total.index_select(0, self._soi_dev[ii]))
        flat = torch.cat([c.to(self.mesh.first) for c in columns])
        flat = fetch_counts(flat, flat.numel(), soi_uploaded=upload,
                            since=t0)
        vm = st.value_map
        if self._vm_ident is None:
            # default arange values + evenly divided shards make the map
            # the identity: skip the n_keys scatter
            self._vm_ident = bool(vm.size == st.n_keys and np.array_equal(
                vm, np.arange(vm.size, dtype=vm.dtype)))
        if self._vm_ident:
            return flat
        out = np.zeros(st.n_keys, dtype=np.int32)
        valid = vm >= 0
        out[vm[valid]] = flat[valid]
        return out


# ------------------------------------------------------------ L2 on a mesh
def l2_mesh(device, n_rows: int, min_rows: int) -> Optional[Mesh]:
    """The mesh for the sharded L2 statistics, or None when sharding would
    not pay: one position, several processes (the L2 solve is replicated
    per process), or a matrix below the size gate."""
    if n_rows < min_rows:
        return None
    mesh = resolve_mesh(device)
    if mesh.size < 2 or dist.process_info()[1] > 1:
        return None
    return mesh


def pad_rows(mesh: Mesh, n: int) -> int:
    """``n`` rounded up to a multiple of the mesh's position count."""
    return n + (-n) % mesh.size


def shard_rows(mesh: Mesh, a, axis: int = 0) -> List[torch.Tensor]:
    """Split ``a`` (NumPy array or tensor) along ``axis`` over the WHOLE
    mesh, data-major, one equal block per position on its device.  The
    axis must be padded to a multiple of the position count first (see
    :func:`pad_rows`)."""
    t = torch.as_tensor(a)
    if t.shape[axis] % mesh.size:
        raise ValueError(f"{t.shape[axis]} rows do not split over "
                         f"{mesh.size} positions")
    return [blk.contiguous().to(dev) for blk, dev in
            zip(torch.chunk(t, mesh.size, dim=axis), mesh.devices)]


def sharded_colsum(mesh: Mesh, Xs: Sequence[torch.Tensor],
                   masks: Sequence[torch.Tensor]) -> np.ndarray:
    """int32 ``[s]`` = ``X^T m`` with X (int8 0/1) and m (bool) row-sharded:
    per-position int32 partials, summed across positions."""
    parts = []
    for dev, X, m in zip(mesh.devices, Xs, masks):
        with _on(dev):
            parts.append(l2.masked_colsum(X, m))
    return _sum(parts, mesh.first).cpu().numpy()


def sharded_colsum_unused(mesh: Mesh, Xs: Sequence[torch.Tensor],
                          used: Sequence[torch.Tensor],
                          big: Sequence[torch.Tensor]) -> np.ndarray:
    """Fused ``X^T (~used & big)`` variant of :func:`sharded_colsum`."""
    masks = []
    for dev, u, b in zip(mesh.devices, used, big):
        with _on(dev):
            masks.append(~u & b)
    return sharded_colsum(mesh, Xs, masks)


def sharded_or_col(mesh: Mesh, used: Sequence[torch.Tensor],
                   Xs: Sequence[torch.Tensor], c: int) -> List[torch.Tensor]:
    """``used |= X[:, c]`` with both row-sharded (stays on the devices)."""
    out = []
    for dev, u, X in zip(mesh.devices, used, Xs):
        with _on(dev):
            out.append(u | (X[:, c] > 0))
    return out


def sharded_fold_grams(mesh: Mesh, Xs: Sequence[torch.Tensor],
                       Ts: Sequence[torch.Tensor]) -> np.ndarray:
    """float64 ``[F, s, s]`` per-fold Grams ``X^T diag(t_f) X`` with X
    row-sharded and T ``[F, n]`` column-sharded: per-position exact
    float64 partials (integer entries), summed across positions."""
    parts = []
    for dev, X, T in zip(mesh.devices, Xs, Ts):
        with _on(dev):
            parts.append(l2.fold_grams(X, T))
    return _sum(parts, mesh.first).cpu().numpy()


def sharded_l2_stats(mesh: Mesh, X, y) -> Tuple[np.ndarray, np.ndarray]:
    """(X^T y, X^T X) with the k-mer axis sharded over the whole mesh.

    X: ``[n_kmers, s]`` float; y: ``[n_kmers]`` float, ``n_kmers`` a
    multiple of the position count.  Per-position moments, summed."""
    ms, gs = [], []
    for dev, Xb, yb in zip(mesh.devices, shard_rows(mesh, X),
                           shard_rows(mesh, y)):
        with _on(dev):
            ms.append(Xb.T @ yb)
            gs.append(Xb.T @ Xb)
    return (_sum(ms, mesh.first).cpu().numpy(),
            _sum(gs, mesh.first).cpu().numpy())
