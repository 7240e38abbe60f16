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

Routing as in :mod:`.probe`: a CPU tensor goes to the plain twin, a CUDA
tensor launches the kernel on ``torch.cuda.current_stream()`` or raises;
launches count in ``probe.LAUNCHES["row_gather_kernel"]``.
"""

from __future__ import annotations

import torch

from strainscan_tpu_torch.ops import _build
from strainscan_tpu_torch.ops.probe import LAUNCHES, _check, _route

# rows per chunk of the plain twin's gather: bounds its [rows, roww] copy
# (512 MiB at 512 B rows; a full study call gathers 4 GiB)
PLAIN_CHUNK_ROWS = 1 << 20

MAX_NBUF = 32                      # warps per block
MAX_TILE = 232_448 // 4            # the tile's int32 indices in shared memory


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


def row_gather_xor(table: torch.Tensor, idx: torch.Tensor, *, tile: int,
                   nbuf: int) -> torch.Tensor:
    """Per-(tile, pipeline slot) XOR folds of gathered table rows.

    Args:
      table: int32 ``[n_rows, roww]`` (uint32 bits), ``roww`` a multiple of
        4 words.
      idx: int32 ``[W]`` row indices.
      tile: indices per tile, a multiple of ``nbuf``; ``W // tile`` tiles.
      nbuf: pipeline slots per tile, a power of two <= 32.

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
    _build.check(_build.lib().row_gather_launch(
        table.device.index, table.data_ptr(), n_rows, roww, idx.data_ptr(),
        n_tiles, tile, nbuf, out.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream),
        "row_gather_kernel launch")
    LAUNCHES["row_gather_kernel"] += 1
    return out
