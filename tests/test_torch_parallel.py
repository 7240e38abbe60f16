"""The port's scale-out (``strainscan_tpu_torch.parallel``) on an 8-entry
``cpu`` mesh against the JAX package on its 8-virtual-device CPU mesh and
its single-device pipeline (the cases of tests/test_parallel.py), plus the
pipeline cache of ``identify/count.py``.

Tolerance: none for counts and column sums (integers) and Grams (float64
sums of integers far below 2**53); ``sharded_l2_stats`` of float32 inputs
within rtol 1e-5, as the JAX test holds its own.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from strainscan_tpu.config import IdentifyConfig
from strainscan_tpu.identify import count as jcount
from strainscan_tpu.index.hashtable import KmerTable, keys_checksum
from strainscan_tpu.kmer import pack
from strainscan_tpu.ops import enet as jenet
from strainscan_tpu.ops.count import CountPipeline as JaxPipeline
from strainscan_tpu.parallel import sharded as jsh
from strainscan_tpu_torch.identify import count as icount
from strainscan_tpu_torch.parallel import distributed as dist
from strainscan_tpu_torch.parallel import sharded as psh

from _torch_sim import one_torch_thread  # noqa: F401 (autouse fixture)

CPU8 = ["cpu"] * 8
RNG = np.random.default_rng(17)


@pytest.fixture(scope="module")
def problem():
    genome = "".join(RNG.choice(list("ACGT"), size=5000))
    db = pack.seq_kmer_set(genome, 31, both_strands=True)
    codes = np.full((256, 96), 4, dtype=np.uint8)
    for i in range(256):
        s = RNG.integers(0, len(genome) - 90)
        codes[i, :90] = pack.encode_seq(genome[s:s + 90])
    return db, codes


def _single(keys, codes_list):
    """The JAX single-device fp pipeline's id-space counts."""
    pipe = JaxPipeline(KmerTable.build(keys, k=31), pallas=False)
    for codes in codes_list:
        pipe.add_batch(codes)
    return np.asarray(pipe.finish())


def test_mesh_shapes_and_resolution():
    mesh = psh.make_mesh(CPU8)
    assert mesh.size == 8 and mesh.axis_names == ("data", "index")
    assert mesh.shape == {"data": 4, "index": 2}
    assert mesh.devices == [torch.device("cpu")] * 8
    assert psh.make_mesh(CPU8[:3]).shape == {"data": 3, "index": 1}
    assert psh.make_mesh(CPU8, index_shards=1).shape == {"data": 8,
                                                         "index": 1}
    assert psh.resolve_mesh("cpu").size == 1
    assert psh.resolve_mesh(mesh) is mesh
    assert psh.resolve_mesh(CPU8).shape == mesh.shape
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            psh.make_mesh()
        with pytest.raises(RuntimeError):
            psh.resolve_mesh("cuda")


@pytest.mark.parametrize("n_shards", [2, 3])
def test_host_builders_equal_jax(problem, n_shards):
    """The port's copies of ShardedTable.build and ShardedFpTable.build
    give the JAX builders' arrays, an uneven last shard included."""
    db, _ = problem
    keys = RNG.permutation(db)                # any order, uneven shards
    keys = keys[:keys.size - (keys.size % n_shards == 0)]
    values = RNG.permutation(keys.size).astype(np.int32)
    got, want = (psh.ShardedTable.build(keys, 31, n_shards, values),
                 jsh.ShardedTable.build(keys, 31, n_shards, values))
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    got, want = (psh.ShardedFpTable.build(keys, 31, n_shards, values),
                 jsh.ShardedFpTable.build(keys, 31, n_shards, values))
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name), err_msg=f.name)
    assert (got.soi == got.n_slots).any()     # padding points at the trash


@pytest.mark.parametrize("index_shards", [None, 1])
def test_sharded_count_equals_jax(problem, index_shards):
    db, codes = problem
    mesh = psh.make_mesh(CPU8, index_shards=index_shards)
    jmesh = jsh.make_mesh(8, index_shards=index_shards)
    n_index = mesh.shape["index"]
    st = psh.ShardedTable.build(db, k=31, n_shards=n_index)
    out = psh.sharded_count(mesh, st, codes).numpy()
    want = np.asarray(jax.device_get(jsh.sharded_count(
        jmesh, jsh.ShardedTable.build(db, k=31, n_shards=n_index), codes)))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out[:db.size], _single(db, [codes]))
    assert out[db.size:].sum() == 0


def test_sharded_l2_stats(problem):
    mesh = psh.make_mesh(CPU8)
    n, s = 4096, 6
    X = (RNG.random((n, s)) < 0.3).astype(np.float32)
    y = RNG.integers(0, 10, size=n).astype(np.float32)
    m, g = psh.sharded_l2_stats(mesh, X, y)
    assert np.allclose(m, X.T @ y, rtol=1e-5)
    assert np.allclose(g, X.T @ X, rtol=1e-5)


def test_sharded_pipeline_matches_single(problem):
    db, codes = problem
    pipe = psh.ShardedCountPipeline(db, k=31, mesh=psh.make_mesh(CPU8))
    pipe.add_batch(codes[:128])
    pipe.add_batch(codes[128:])
    np.testing.assert_array_equal(
        pipe.finish(), _single(db, [codes[:128], codes[128:]]))
    jpipe = jsh.ShardedCountPipeline(db, k=31, mesh=jsh.make_mesh(8),
                                     pallas=False)
    jpipe.add_batch(codes[:128])
    jpipe.add_batch(codes[128:])
    np.testing.assert_array_equal(pipe.finish(), jpipe.finish())


def test_sharded_pipeline_permuted_values(problem):
    """An arbitrary external id order (converted-DB case) round-trips."""
    db, codes = problem
    perm = RNG.permutation(db.size).astype(np.int32)
    keys_perm = db[np.argsort(perm)]
    pipe = psh.ShardedCountPipeline(keys_perm, k=31,
                                    mesh=psh.make_mesh(CPU8))
    pipe.add_batch(codes)
    idx = np.searchsorted(db, keys_perm)
    np.testing.assert_array_equal(pipe.finish(), _single(db, [codes])[idx])


@pytest.mark.parametrize("packed", [True, False])
def test_sharded_pipeline_odd_batch_and_payloads(problem, packed):
    """37 rows pad to a multiple of the 8 positions; a mid-read N ships
    vbytes, raw codes without packed_transfer."""
    db, codes = problem
    batch = codes[:37].copy()
    batch[::5, 40] = 4
    pipe = psh.ShardedCountPipeline(db, k=31, mesh=psh.make_mesh(CPU8),
                                    packed_transfer=packed)
    payloads = pipe.prepare_batch(batch)
    assert [p[0] for p in payloads] == (["vbytes"] if packed else ["codes"])
    assert payloads[0][1].shape[0] == 40
    pipe.add_prepared(payloads)
    np.testing.assert_array_equal(pipe.finish(), _single(db, [batch]))


def test_sharded_finish_counts_above_uint16(problem):
    """Poly-A reads hammer one k-mer ~16.9k times per batch; four batches
    push it past 2**16 on both pipelines."""
    db, _ = problem
    keys = np.unique(np.concatenate(
        [db, pack.seq_kmer_set("A" * 40, 31, both_strands=True)]))
    codes = np.zeros((256, 96), dtype=np.uint8)
    want = _single(keys, [codes] * 4)
    assert want.max() > 65535
    pipe = psh.ShardedCountPipeline(keys, k=31, mesh=psh.make_mesh(CPU8))
    for _ in range(4):
        pipe.add_batch(codes)
    np.testing.assert_array_equal(pipe.finish(), want)


def test_sharded_pipeline_large_uneven_table():
    """>= 1M keys, an odd count: the last shard is one key short of
    shard_cap, so value_map padding and the remap run off the toy
    regime."""
    rng = np.random.default_rng(99)
    genome = "".join(rng.choice(list("ACGT"), size=5000))
    hit_keys = pack.seq_kmer_set(genome, 31, both_strands=True)
    filler = rng.integers(0, 1 << 62, size=1_100_000, dtype=np.uint64)
    keys = np.unique(np.concatenate([hit_keys, filler]))
    if keys.size % 2 == 0:
        keys = keys[1:]
    codes = np.full((256, 96), 4, dtype=np.uint8)
    for i in range(256):
        s = int(rng.integers(0, len(genome) - 90))
        codes[i, :90] = pack.encode_seq(genome[s:s + 90])
    mesh = psh.make_mesh(CPU8)
    pipe = psh.ShardedCountPipeline(keys, k=31, mesh=mesh)
    assert pipe.st.shard_cap * 2 != keys.size
    pipe.add_batch(codes)
    got = pipe.finish()
    want = _single(keys, [codes])
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_sharded_pipeline_three_device_mesh(problem):
    """3 positions -> data=3, index=1: padding to a non-power-of-two
    multiple stays bit-exact."""
    db, codes = problem
    mesh = psh.make_mesh(CPU8[:3])
    assert mesh.shape == {"data": 3, "index": 1}
    pipe = psh.ShardedCountPipeline(db, k=31, mesh=mesh)
    pipe.add_prepared(pipe.prepare_batch(codes))
    np.testing.assert_array_equal(pipe.finish(), _single(db, [codes]))


def _mesh8():
    return psh.make_mesh(CPU8)


def test_cache_content_keyed(problem):
    db, _ = problem
    keys1 = np.sort(db)
    keys2 = keys1.copy()
    mesh = _mesh8()
    icount._SHARDED_CACHE.clear()
    p1 = icount._sharded_pipeline(keys1, 31, False, mesh)
    assert icount._sharded_pipeline(keys2, 31, False, _mesh8()) is p1
    assert icount._sharded_pipeline(keys2, 31, False, mesh) is p1
    assert icount._sharded_pipeline(keys1[:-1].copy(), 31, False,
                                    mesh) is not p1
    assert icount._sharded_pipeline(keys1, 31, False,
                                    psh.make_mesh(CPU8[:4])) is not p1
    icount._SHARDED_CACHE.clear()


def test_cache_equal_checksum_different_keys_do_not_share(problem):
    """Two key sets with one keys_checksum (XOR fold and count) but other
    contents: the JAX cache key cannot tell them apart; the port compares
    the keys themselves."""
    db, _ = problem
    keys1 = np.sort(db)
    keys2 = keys1.copy()
    x = np.uint64(0b1100)          # flip the same bits in two keys
    keys2[0] ^= x
    keys2[1] ^= x
    keys2 = np.sort(keys2)
    assert np.unique(keys2).size == keys2.size
    assert not np.array_equal(keys1, keys2)
    assert keys_checksum(keys1) == keys_checksum(keys2)
    table = KmerTable.build(keys1, k=31)
    cfg = IdentifyConfig()
    assert jcount._sharded_cache_key(keys1, table, False, cfg) == \
        jcount._sharded_cache_key(keys2, table, False, cfg)
    mesh = _mesh8()
    icount._SHARDED_CACHE.clear()
    p1 = icount._sharded_pipeline(keys1, 31, False, mesh)
    p2 = icount._sharded_pipeline(keys2, 31, False, mesh)
    assert p2 is not p1
    assert not np.array_equal(p1.st.value_map, p2.st.value_map) or \
        not np.array_equal(p1.st.fp, p2.st.fp)
    icount._SHARDED_CACHE.clear()


def test_cache_eviction_closes_and_reset_repins(problem):
    db, codes = problem
    keys = np.sort(db)
    mesh = _mesh8()
    icount._SHARDED_CACHE.clear()
    pipes = []
    for i in range(icount._SHARDED_CACHE_MAX + 1):
        p = icount._sharded_pipeline(keys[:keys.size - i].copy(), 31, False,
                                     mesh)
        p.add_batch(codes)
        pipes.append(p)
    assert len(icount._SHARDED_CACHE) == icount._SHARDED_CACHE_MAX
    evicted = pipes[0]
    assert evicted._fp_dev is None and evicted._totals is None
    assert evicted._soi_dev is None
    kept = pipes[-1]
    assert kept._shape is not None
    kept.reset()
    assert kept._shape is None and kept._totals is None
    icount._SHARDED_CACHE.clear()


def test_cache_identity_respects_canonical(problem):
    db, _ = problem
    keys = np.sort(db)
    mesh = _mesh8()
    icount._SHARDED_CACHE.clear()
    p1 = icount._sharded_pipeline(keys, 31, False, mesh)
    p2 = icount._sharded_pipeline(keys, 31, True, mesh)
    assert p2 is not p1 and p2.canonical and not p1.canonical
    icount._SHARDED_CACHE.clear()


def _l2_problem(n=1003, s=7, F=5):
    rng = np.random.default_rng(23)
    X = (rng.random((n, s)) < 0.35).astype(np.int8)
    T = (rng.random((F, n)) < 0.5).astype(np.int8)
    return X, T


def test_l2_mesh_functions_equal_jax():
    """colsum, colsum_unused and or_col on row-sharded operands (n = 1003
    padded to 1008) equal the JAX mesh functions.  The fold Grams equal
    the JAX single-device ``_fold_grams``: JAX's own mesh Gram function
    does not trace under the installed JAX (its scan carry lacks the
    mesh-varying type), and ``enet._fold_grams`` silently takes its host
    fallback there."""
    X, T = _l2_problem()
    n = X.shape[0]
    rng = np.random.default_rng(24)
    used = rng.random(n) < 0.3
    big = rng.random(n) < 0.6
    mesh, jmesh = _mesh8(), jsh.make_mesh(8)
    npad = psh.pad_rows(mesh, n)
    assert npad == jsh.pad_rows(jmesh, n) == 1008
    pad = npad - n
    Xp = np.pad(X, ((0, pad), (0, 0)))
    Tp = np.pad(T, ((0, 0), (0, pad)))
    up, bp = np.pad(used, (0, pad)), np.pad(big, (0, pad))
    Xs, us, bs = (psh.shard_rows(mesh, a) for a in (Xp, up, bp))
    jX, ju, jb = (jsh.shard_rows(jmesh, a) for a in (Xp, up, bp))

    got = psh.sharded_colsum(mesh, Xs, bs)
    np.testing.assert_array_equal(
        got, np.asarray(jsh.sharded_colsum_fn(jmesh)(jX, jb)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        psh.sharded_colsum_unused(mesh, Xs, us, bs),
        np.asarray(jsh.sharded_colsum_unused_fn(jmesh)(jX, ju, jb)))
    ored = psh.sharded_or_col(mesh, us, Xs, 3)
    np.testing.assert_array_equal(
        torch.cat(ored).numpy(),
        np.asarray(jsh.sharded_or_col_fn(jmesh)(ju, jX, 3)))
    grams = psh.sharded_fold_grams(mesh, Xs, psh.shard_rows(mesh, Tp, axis=1))
    y = np.zeros(n)
    np.testing.assert_array_equal(
        grams, jenet._fold_grams(X.astype(np.float64), y, T)[0])
    full = np.einsum("fn,ns,nt->fst", T.astype(np.float64),
                     X.astype(np.float64), X.astype(np.float64))
    np.testing.assert_array_equal(grams, full)


def test_l2_mesh_gate():
    mesh = _mesh8()
    assert psh.l2_mesh(mesh, 10, 100) is None          # below the gate
    assert psh.l2_mesh(mesh, 100, 100) is mesh
    assert psh.l2_mesh("cpu", 100, 1) is None           # one position
    with pytest.raises(ValueError):
        psh.shard_rows(mesh, np.zeros((9, 2)))          # not padded


def test_distributed_helpers_single_process(monkeypatch):
    assert dist.process_info() == (0, 1)
    assert dist.shard_paths(["a.fq", "b.fq"]) == ["a.fq", "b.fq"]
    assert dist.shard_range(10) == (0, 10)
    c = np.arange(5, dtype=np.int32)
    assert dist.merge_counts(c) is c
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert dist.maybe_initialize() is False
