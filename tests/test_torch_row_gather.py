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
