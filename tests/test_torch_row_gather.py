"""The row gather of the measurement path (``ops/gather.py``) on the CPU.

``row_gather_xor`` on a CPU tensor runs its plain twin, which is held here
against the NumPy XOR-fold oracle over every tile and against the Pallas
``dma_gather_kernel`` of ``benchmarks/probe_bench3.py`` itself, run in TPU
interpret mode with the BlockSpecs of its ``pallas_call``.  The CUDA kernel
is held against the twin on the card (``tests/test_torch_cuda.py``).

Tolerance: none; the folds are integer words and must be equal.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from strainscan_tpu_torch.bench.probe_study import xor_fold_oracle
from strainscan_tpu_torch.kmer.device import from_u32
from strainscan_tpu_torch.ops import gather, probe

from _torch_sim import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe_bench3():
    spec = importlib.util.spec_from_file_location(
        "probe_bench3", os.path.join(ROOT, "benchmarks", "probe_bench3.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, n_rows, roww, w, repeat=False):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 1 << 32, size=(n_rows, roww), dtype=np.uint32)
    idx = rng.integers(0, n_rows, size=w, dtype=np.int32)
    if repeat:                       # the same rows over and over
        idx[::3] = idx[0]
        idx[1::7] = n_rows - 1
    return table, idx


def _plain(table, idx, tile, nbuf):
    got = gather.row_gather_xor(from_u32(table), torch.from_numpy(idx),
                                tile=tile, nbuf=nbuf)
    return got.numpy().view(np.uint32)


# (tile, nbuf, W): W with a tail past the last whole tile, tile == nbuf,
# an odd number of groups per slot (tile // nbuf = 3), a single tile
CASES = [(32, 8, 150), (16, 16, 70), (24, 8, 100), (64, 16, 64),
         (8, 1, 41), (64, 32, 200)]


@pytest.mark.parametrize("roww", [64, 128])
@pytest.mark.parametrize("tile,nbuf,w", CASES)
@pytest.mark.parametrize("repeat", [False, True])
def test_plain_equals_numpy_oracle(roww, tile, nbuf, w, repeat):
    table, idx = _inputs(tile + nbuf + w, 50, roww, w, repeat)
    got = _plain(table, idx, tile, nbuf)
    n_tiles = w // tile
    assert got.shape == (n_tiles * nbuf, roww)
    want = np.zeros_like(got)
    for t in range(n_tiles * tile):     # the definition, entry by entry
        want[(t // tile) * nbuf + (t % tile) % nbuf] ^= table[idx[t]]
    assert np.array_equal(got, want)
    assert np.array_equal(xor_fold_oracle(table, idx, tile, nbuf), want)


@pytest.mark.parametrize("roww,tile,nbuf,w", [(128, 32, 8, 128),
                                              (128, 16, 16, 70),
                                              (64, 32, 8, 100)])
def test_plain_equals_pallas_dma_gather_kernel(roww, tile, nbuf, w):
    """The Pallas kernel itself, in TPU interpret mode on the CPU."""
    table, idx = _inputs(7, 64, roww, w, repeat=True)
    n_tiles = w // tile
    kern = functools.partial(_probe_bench3().dma_gather_kernel, tile=tile,
                             nbuf=nbuf)
    out = pl.pallas_call(
        kern,
        grid=(n_tiles,),
        in_specs=[
            pl.BlockSpec((tile,), lambda i: (i,), memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((nbuf, roww), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[
            pltpu.VMEM((nbuf, roww), jnp.uint32),
            pltpu.SemaphoreType.DMA((nbuf,)),
        ],
        out_shape=jax.ShapeDtypeStruct((n_tiles * nbuf, roww), jnp.uint32),
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray(idx), jnp.asarray(table))
    assert np.array_equal(_plain(table, idx, tile, nbuf), np.asarray(out))


def test_out_of_range_rows_contribute_nothing():
    table, idx = _inputs(3, 40, 64, 96)
    idx[5], idx[17], idx[60] = -1, 40, np.iinfo(np.int32).max
    want = np.zeros((3 * 8, 64), dtype=np.uint32)
    for t, b in enumerate(idx):
        if 0 <= b < 40:
            want[(t // 32) * 8 + t % 8] ^= table[b]
    assert np.array_equal(_plain(table, idx, 32, 8), want)


def test_cpu_route_launches_nothing():
    table, idx = _inputs(4, 16, 64, 64)
    probe.reset_launches()
    _plain(table, idx, 16, 4)
    assert probe.LAUNCHES["row_gather_kernel"] == 0


def test_wrapper_rejects_bad_arguments():
    table = torch.zeros((16, 64), dtype=torch.int32)
    idx = torch.zeros(64, dtype=torch.int32)
    for nbuf in (0, 3, 64):
        with pytest.raises(ValueError, match="nbuf"):
            gather.row_gather_xor(table, idx, tile=64, nbuf=nbuf)
    for tile in (4, 36, gather.MAX_TILE + 8):
        with pytest.raises(ValueError, match="tile"):
            gather.row_gather_xor(table, idx, tile=tile, nbuf=8)
    for roww in (6, 0):
        with pytest.raises(ValueError, match="words"):
            gather.row_gather_xor(torch.zeros((16, roww), dtype=torch.int32),
                                  idx, tile=16, nbuf=8)
    with pytest.raises(ValueError):
        gather.row_gather_xor(table.to(torch.int64), idx, tile=16, nbuf=8)
    with pytest.raises(ValueError):
        gather.row_gather_xor(table, idx.to(torch.int64), tile=16, nbuf=8)
    with pytest.raises(ValueError, match="device"):
        gather.row_gather_xor(table.to("meta"), idx.to("meta"), tile=16,
                              nbuf=8)


# ------------------------------------------------------------- the plan
H100 = gather.H100
NBUFS = [1, 2, 4, 8, 16, 32]


def _tiles(nbuf):
    """Accepted tiles of ``nbuf`` slots: the least, odd multiples, the
    study's, and the largest (MAX_TILE or just under it)."""
    top = gather.MAX_TILE // nbuf * nbuf
    return sorted({nbuf, 2 * nbuf, 3 * nbuf, 96 * nbuf, 2048, 8192, 16384,
                   top - nbuf, top} - {0})


def _layout_bytes(plan, nbuf):
    """Shared memory of the kernel's layout: accumulators, chunk counts
    (padded to 16 B), sorted rows and their tile bytes."""
    return nbuf * (plan.k * plan.win * 16 + -(-plan.n_chunks // 4) * 16
                   + plan.piece * gather.ENTRY_BYTES)


@pytest.mark.parametrize("nbuf", NBUFS)
@pytest.mark.parametrize("roww", [24, 64, 128])
def test_plan_fits_and_covers_every_tile(roww, nbuf):
    """Every accepted tile at this width: k >= 1, shared memory within the
    device's limits, chunks of a power-of-two budget within a third of the
    L2, and the rounds cover each tile once."""
    budget = gather.chunk_budget(H100.l2_bytes)
    assert budget == 16 << 20
    for tile in _tiles(nbuf):
        assert tile % nbuf == 0 and tile <= gather.MAX_TILE
        for n_rows, windows in (((256 << 20) // (roww * 4), 1 << 23),
                                (4099, 3 * tile + 77), (1, tile)):
            n_tiles = windows // tile
            plan = gather.gather_plan(n_rows, roww, n_tiles, tile, nbuf, H100)
            per_slot = tile // nbuf
            assert 1 <= plan.k <= gather.MAX_K
            assert plan.win == roww // 4
            assert plan.piece >= min(32, plan.k * per_slot)
            assert plan.piece <= plan.k * per_slot or plan.k == 1
            if plan.piece < plan.k * per_slot:   # entries go in pieces
                assert plan.k == 1
            assert _layout_bytes(plan, nbuf) <= plan.smem <= H100.smem_block
            assert plan.smem + H100.smem_reserved <= H100.smem_sm
            assert budget <= H100.l2_bytes // 3 < 2 * budget
            assert plan.chunk_rows == min(n_rows, budget // (roww * 4))
            assert plan.n_chunks == -(-n_rows // plan.chunk_rows)
            per_sm = min(H100.blocks_sm, H100.threads_sm // (32 * nbuf),
                         H100.smem_sm // (plan.smem + H100.smem_reserved))
            assert 1 <= plan.grid <= H100.sms * per_sm
            covered = [t for r in range(plan.rounds(n_tiles))
                       for b in range(plan.grid)
                       for t in plan.tiles(n_tiles, b, r)]
            assert covered == list(range(n_tiles))


@pytest.mark.parametrize("roww,tile,nbuf,k,rounds", [
    (128, 2048, 16, 11, 3), (128, 2048, 8, 8, 2), (128, 8192, 16, 4, 2),
    (64, 2048, 16, 8, 2), (64, 2048, 8, 4, 2), (64, 8192, 16, 2, 2)])
def test_plan_at_the_study_shape(roww, tile, nbuf, k, rounds):
    """2^23 indices into the study's 256 MiB table: 16 chunks of 16 MiB,
    16 warps per multiprocessor at 512 B rows and 32 at 256 B, every block
    slot busy, and few rounds (each round reads each chunk from device
    memory about once)."""
    n_rows, n_tiles = (256 << 20) // (roww * 4), (1 << 23) // tile
    plan = gather.gather_plan(n_rows, roww, n_tiles, tile, nbuf, H100)
    assert (plan.n_chunks, plan.chunk_rows) == (16, (16 << 20) // (roww * 4))
    warps = {128: 16, 64: 32}[roww]
    assert gather.target_warps(roww) == warps
    assert plan.grid == H100.sms * warps // nbuf
    assert (plan.k, plan.rounds(n_tiles)) == (k, rounds)
    assert plan.piece == k * (tile // nbuf)


def test_plan_wide_rows_and_chunk_rows():
    """Rows whose accumulators do not fit go in column windows; a given
    chunk_rows cuts the table with a ragged last chunk, and one that
    makes too many chunks, or none, is refused."""
    plan = gather.gather_plan(1000, 4096, 40, gather.MAX_TILE // 32 * 32, 32,
                              H100)
    assert plan.win < 1024 and plan.k == 1
    assert _layout_bytes(plan, 32) <= plan.smem <= H100.smem_block
    plan = gather.gather_plan(4099, 64, 24, 2048, 16, H100, chunk_rows=300)
    assert (plan.chunk_rows, plan.n_chunks) == (300, 14)
    assert 4099 - 13 * 300 == 199                  # the ragged last chunk
    with pytest.raises(ValueError, match="chunks"):
        gather.gather_plan(1 << 20, 64, 24, 2048, 16, H100, chunk_rows=1)
    with pytest.raises(ValueError, match="positive"):
        gather.gather_plan(4099, 64, 24, 2048, 16, H100, chunk_rows=0)
    # a table of more chunks than the counts may hold gets larger chunks
    huge = gather.gather_plan((1 << 31) - 1, 4, 24, 2048, 32, H100)
    assert huge.n_chunks * 32 * 4 <= (H100.smem_block // 4)
