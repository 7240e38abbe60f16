"""The row gather of the measurement path, beside its plain twin.

:func:`row_gather_xor` -> ``row_gather_kernel`` (``csrc/row_gather.cu``):
port of the Pallas kernel ``benchmarks/probe_bench3.py::bench_dma_gather``
(body ``dma_gather_kernel``), the study of the count step's fingerprint-row
gather (``bench/probe_study.py``).  The index array is cut into tiles of
``tile`` entries (entries past the last whole tile are ignored), and table
row ``idx[i * tile + t]`` is XOR-folded into output row
``i * nbuf + (t & (nbuf - 1))``.

Tables hold uint32 words as int32 bit patterns (CPU torch has no uint32
shifts; the port carries packed words this way throughout).  An index
outside ``[0, n_rows)`` contributes nothing, in the kernel and the twin.

The kernel walks the table chunk by chunk in the same order on every
block, so that the L2 serves a row's repeated reads; :func:`gather_plan`
works out its numbers (chunk rows, tiles per block and round, grid, shared
memory) from the shapes and the device's :class:`GatherDevice`.

Routing as in :mod:`.probe`: a CPU tensor goes to the plain twin, a CUDA
tensor launches the kernel on ``torch.cuda.current_stream()`` or raises;
launches count in ``probe.LAUNCHES["row_gather_kernel"]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from strainscan_tpu_torch.ops import _build
from strainscan_tpu_torch.ops.probe import LAUNCHES, _check, _route

# rows per chunk of the plain twin's gather: bounds its [rows, roww] copy
# (512 MiB at 512 B rows; a full study call gathers 4 GiB)
PLAIN_CHUNK_ROWS = 1 << 20

MAX_NBUF = 32                      # warps per block
MAX_TILE = 232_448 // 4            # a tile's int32 indices fill a block's
                                   # shared memory on an H100

# the plan: 16 B lane loads a multiprocessor should keep in flight (16
# warps of 512 B rows, kUnroll 8 rows each), the most tiles a block takes per
# round (the kernel keeps a tile's number in a byte), bytes per sorted entry
# (an int32 row and that byte)
LANE_LOADS_SM = 16 * 32 * 8
MAX_K = 128
ENTRY_BYTES = 5


@dataclasses.dataclass(frozen=True)
class GatherDevice:
    """What the plan reads of a device (``cudaDeviceGetAttribute``)."""
    l2_bytes: int
    smem_block: int          # shared memory a block may opt in to
    smem_sm: int             # shared memory per multiprocessor
    smem_reserved: int       # shared memory the runtime keeps per block
    sms: int
    threads_sm: int
    blocks_sm: int


# an NVIDIA H100 SXM (80 GB HBM3), as the runtime reports it
H100 = GatherDevice(l2_bytes=52_428_800, smem_block=232_448, smem_sm=233_472,
                    smem_reserved=1_024, sms=132, threads_sm=2_048,
                    blocks_sm=32)


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """The kernel's numbers for one call: block b walks tiles
    ``[(r * grid + b) * k, ... + k)`` in round r, chunk by chunk; warp s sorts
    and folds slot s's entries ``piece`` at a time, ``win`` 16 B vectors of
    each row at a time."""
    chunk_rows: int
    n_chunks: int
    k: int
    piece: int
    win: int
    grid: int
    smem: int

    def tiles(self, n_tiles: int, block: int, rnd: int) -> range:
        """The tiles block ``block`` folds in round ``rnd``."""
        t0 = (rnd * self.grid + block) * self.k
        return range(min(t0, n_tiles), min(t0 + self.k, n_tiles))

    def rounds(self, n_tiles: int) -> int:
        return -(-n_tiles // (self.grid * self.k))


def chunk_budget(l2_bytes: int) -> int:
    """Bytes of table per chunk: the largest power of two within a third of
    the L2 (16 MiB on an H100)."""
    b = 16
    while b * 2 <= l2_bytes // 3:
        b *= 2
    return b


def target_warps(roww: int) -> int:
    """Warps per multiprocessor for rows of ``roww`` words: a warp of 16 B
    lanes loads ``min(roww // 4, 32)`` lanes of each row, so narrow rows
    need more warps for the same loads in flight; at most 32, which the
    registers hold (the kernel's launch bound keeps it to 64 a thread)."""
    return min(32, LANE_LOADS_SM // (8 * min(roww // 4, 32)))


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def gather_plan(n_rows: int, roww: int, n_tiles: int, tile: int, nbuf: int,
                dev: GatherDevice,
                chunk_rows: Optional[int] = None) -> GatherPlan:
    """The kernel's numbers for a table of ``n_rows`` x ``roww`` words and
    ``n_tiles`` tiles of ``tile`` indices in ``nbuf`` slots, on ``dev``.

    Blocks of nbuf warps, as many per multiprocessor as make about
    :func:`target_warps` warps; each block's share of shared memory holds per
    warp the chunk counts, k tiles' accumulators and the entries it sorts.
    k is as large as the share allows (at most ``MAX_K``, and no larger than
    spreads the tiles over every block); where one tile's entries do not
    fit, k is 1 and the entries go in pieces; where one tile's accumulators
    do not fit, the rows go in column windows.  ``chunk_rows`` (default:
    :func:`chunk_budget` bytes of rows) is raised for a table of so many
    chunks that their counts would take over a quarter of the share.
    """
    row_vecs, per_slot = roww // 4, tile // nbuf
    want = min(dev.blocks_sm, max(1, target_warps(roww) // nbuf))
    share = min(dev.smem_block, dev.smem_sm // want - dev.smem_reserved)
    share -= share % 16
    max_chunks = max(1, share // 4 // (4 * nbuf))
    if chunk_rows is None:
        chunk = max(1, min(n_rows, chunk_budget(dev.l2_bytes) // (roww * 4)))
        chunk = max(chunk, -(-n_rows // max_chunks))
    else:
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows={chunk_rows} is not positive")
        chunk = min(chunk_rows, max(1, n_rows))
        if -(-n_rows // chunk) > max_chunks:
            raise ValueError(f"chunk_rows={chunk_rows} cuts {n_rows} rows "
                             f"into more than {max_chunks} chunks")
    if chunk >= 1 << 31:
        raise ValueError(f"{n_rows} rows are too many for one chunk")
    n_chunks = max(1, -(-n_rows // chunk))
    counts = nbuf * _up16(4 * n_chunks)
    win = row_vecs
    while win > 1 and counts + nbuf * (16 * win + 32 * ENTRY_BYTES) > share:
        win = -(-win // 2)
    acc = nbuf * 16 * win                           # one tile's accumulators
    k = (share - counts) // (acc + nbuf * ENTRY_BYTES * per_slot)
    slots = dev.sms * want
    if k >= 1:
        # as few rounds as k allows, with the tiles spread evenly over them
        rounds = max(1, -(-n_tiles // (slots * min(k, MAX_K))))
        k = max(1, -(-n_tiles // (slots * rounds)))
        piece = k * per_slot
    else:
        k = 1
        piece = (share - counts - acc) // (nbuf * ENTRY_BYTES) // 32 * 32
    smem = k * acc + counts + _up16(nbuf * ENTRY_BYTES * piece)
    per_sm = min(dev.blocks_sm, dev.threads_sm // (32 * nbuf),
                 dev.smem_sm // (smem + dev.smem_reserved))
    grid = max(1, min(dev.sms * per_sm, -(-n_tiles // k)))
    return GatherPlan(chunk_rows=chunk, n_chunks=n_chunks, k=k, piece=piece,
                      win=win, grid=grid, smem=smem)


@functools.lru_cache(maxsize=None)
def device_of(index: int) -> GatherDevice:
    """The plan's numbers of CUDA device ``index``, from the runtime."""
    props = (ctypes.c_longlong * 7)()
    _build.check(_build.lib().row_gather_device(index, props),
                 "row_gather_device")
    return GatherDevice(*(int(v) for v in props))


def _validate(table: torch.Tensor, idx: torch.Tensor, tile: int,
              nbuf: int) -> int:
    """Check the arguments; return the number of whole tiles."""
    _check(table, "table", torch.int32, 2)
    _check(idx, "idx", torch.int32, 1)
    if not 1 <= nbuf <= MAX_NBUF or nbuf & (nbuf - 1):
        raise ValueError(f"nbuf={nbuf} is not a power of two in "
                         f"[1, {MAX_NBUF}]")
    if not nbuf <= tile <= MAX_TILE or tile % nbuf:
        raise ValueError(f"tile={tile} is not a multiple of nbuf={nbuf} "
                         f"in [nbuf, {MAX_TILE}]")
    if table.shape[1] == 0 or table.shape[1] % 4:
        raise ValueError(f"table rows hold {table.shape[1]} words, not a "
                         f"positive multiple of 4 (16 B vectors)")
    return idx.shape[0] // tile


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR over dim 1 of ``[n, g, ...]`` by pairwise halving."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        y = torch.bitwise_xor(x[:, :h], x[:, h:2 * h])
        if x.shape[1] % 2:
            y[:, 0] ^= x[:, 2 * h]
        x = y
    return x[:, 0]


def row_gather_xor_plain(table: torch.Tensor, idx: torch.Tensor, *,
                         tile: int, nbuf: int) -> torch.Tensor:
    """Plain twin of :func:`row_gather_xor`: gathers ``table[idx]`` in
    chunks of whole tiles and folds each tile's ``tile // nbuf`` groups."""
    n_tiles = _validate(table, idx, tile, nbuf)
    n_rows, roww = table.shape
    out = torch.empty((n_tiles * nbuf, roww), dtype=torch.int32,
                      device=table.device)
    per = max(1, PLAIN_CHUNK_ROWS // tile)          # tiles per chunk
    for t0 in range(0, n_tiles, per):
        t1 = min(n_tiles, t0 + per)
        i = idx[t0 * tile:t1 * tile].to(torch.int64)
        ok = (i >= 0) & (i < n_rows)
        rows = table.index_select(0, torch.where(ok, i, 0))
        rows.masked_fill_(~ok[:, None], 0)
        out[t0 * nbuf:t1 * nbuf] = _xor_fold(
            rows.view(t1 - t0, tile // nbuf, nbuf, roww)).reshape(-1, roww)
    return out


def plan_for(table: torch.Tensor, idx: torch.Tensor, *, tile: int,
             nbuf: int, chunk_rows: Optional[int] = None) -> GatherPlan:
    """:func:`gather_plan` for these arguments on the table's CUDA device."""
    n_tiles = _validate(table, idx, tile, nbuf)
    n_rows, roww = table.shape
    return gather_plan(n_rows, roww, n_tiles, tile, nbuf,
                       device_of(table.device.index), chunk_rows)


def row_gather_xor(table: torch.Tensor, idx: torch.Tensor, *, tile: int,
                   nbuf: int, chunk_rows: Optional[int] = None
                   ) -> torch.Tensor:
    """Per-(tile, pipeline slot) XOR folds of gathered table rows.

    Args:
      table: int32 ``[n_rows, roww]`` (uint32 bits), ``roww`` a multiple of
        4 words.
      idx: int32 ``[W]`` row indices.
      tile: indices per tile, a multiple of ``nbuf``; ``W // tile`` tiles.
      nbuf: pipeline slots per tile, a power of two <= 32.
      chunk_rows: table rows per chunk of the kernel's walk (default: the
        plan's); the plain twin ignores it.

    Returns int32 ``[(W // tile) * nbuf, roww]``.
    """
    n_tiles = _validate(table, idx, tile, nbuf)
    if not _route(table, idx):
        return row_gather_xor_plain(table, idx, tile=tile, nbuf=nbuf)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (row vector loads)")
    n_rows, roww = table.shape
    out = torch.empty((n_tiles * nbuf, roww), dtype=torch.int32,
                      device=table.device)
    if n_tiles == 0:
        return out
    plan = plan_for(table, idx, tile=tile, nbuf=nbuf, chunk_rows=chunk_rows)
    _build.check(_build.lib().row_gather_launch(
        table.device.index, table.data_ptr(), n_rows, roww, idx.data_ptr(),
        n_tiles, tile, nbuf, plan.chunk_rows, plan.n_chunks, plan.k,
        plan.piece, plan.win, plan.grid, plan.smem, out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream),
        "row_gather_kernel launch")
    LAUNCHES["row_gather_kernel"] += 1
    return out
