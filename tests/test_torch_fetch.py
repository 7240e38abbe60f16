"""The port's compact count fetch against the JAX package's, on the same
seeded NumPy inputs: ``ops.count.fetch_counts`` (the cases of
tests/test_kmer_device.py, the sparse capacity's edge and an empty table),
``CountPipeline.finish`` in fp mode (a sparse sample, a dense one, one whose
windows hit empty slots' fingerprints) and exact mode, two samples in a row,
and the sharded finish on an 8-entry ``cpu`` mesh.

Tolerance: none; counts are integers and must be equal entry for entry.
Every fetch must also take the route that the JAX package takes for the same
stats (sparse or dense, read off its ``_count_stats`` and ``_sparse_fetch``
calls), at the bytes per value and the bytes copied of its rule
(``ops/count.py:256-266``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strainscan_tpu.index.hashtable import FpTable as JFpTable
from strainscan_tpu.index.hashtable import KmerTable, fp2_np, mix_seeded_np
from strainscan_tpu.kmer import pack
from strainscan_tpu.ops import count as jcount
from strainscan_tpu.parallel import sharded as jsh
from strainscan_tpu_torch.ops import count as tcount
from strainscan_tpu_torch.ops.count import CountPipeline
from strainscan_tpu_torch.parallel import sharded as psh

from _torch_sim import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_sim import port_fp_table, port_kmer_table

CPU = torch.device("cpu")
K = 31


@pytest.fixture
def jax_calls(monkeypatch):
    """Records the JAX package's stats (``[maxc, nnz]``) and sparse fetches
    in call order."""
    calls = []
    stats, sparse = jcount._count_stats, jcount._sparse_fetch

    def spy_stats(c):
        out = stats(c)
        calls.append(("stats", *(int(x) for x in np.asarray(out))))
        return out

    def spy_sparse(c, size):
        calls.append(("sparse", size))
        return sparse(c, size)

    monkeypatch.setattr(jcount, "_count_stats", spy_stats)
    monkeypatch.setattr(jcount, "_sparse_fetch", spy_sparse)
    tcount.reset_fetches()
    return calls


def jax_route(calls, n: int) -> tuple:
    """``(route, vb, nnz, d2h_bytes)`` of the JAX package's last fetch: the
    stats it last read, whether a sparse fetch followed them, and its rule's
    bytes for them (``vbytes``, ``sparse_bytes``, ``dense_bytes``)."""
    last = max(i for i, c in enumerate(calls) if c[0] == "stats")
    _, maxc, nnz = calls[last]
    vb = 1 if maxc < (1 << 8) else 2 if maxc < (1 << 16) else 4
    if any(c[0] == "sparse" for c in calls[last:]):
        return "sparse", vb, nnz, nnz * (4 + vb)
    return "dense", vb, nnz, n * vb


def port_route(rec: tcount.Fetch) -> tuple:
    return rec.route, rec.vb, rec.nnz, rec.d2h_bytes


# ------------------------------------------------------------ fetch_counts
def _vector(case: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    n = 100_000
    if case.startswith(("b", "cap")):
        if case.startswith("cap"):   # nnz at the capacity and one past it
            nnz = tcount.sparse_cap(n) + (case == "cap_plus_1")
            a = np.zeros(n, np.int32)
            a[1 + rng.choice(n - 1, size=nnz - 1, replace=False)] = 1
            a[0] = 1 << 16           # 4-byte values: sparse pays to n / 4
            return a
        boundary, form = int(case[1:].split("_")[0]), case.split("_")[1]
        if form == "dense":
            return np.full(4096, boundary, np.int32)
        a = np.zeros(4096, np.int32)
        a[0], a[1] = boundary, 1
        return a
    if case == "small_n":     # sparse by its bytes, but the capacity
        a = np.zeros(1000, np.int32)   # (1,024) is not under n: dense
        a[rng.choice(1000, size=10, replace=False)] = 5
        return a
    a = np.zeros(n, np.int32)
    idx = rng.choice(n, size=500, replace=False)
    a[idx] = rng.integers(1, 60000, size=500)
    if case == "sparse_2p20":
        a[idx[0]] = 1 << 20
    if case.startswith("dense"):
        a = rng.integers(0, 65535, size=n).astype(np.int32)
        if case == "dense_i32":
            a[7] = 1 << 30
    if case == "zeros":
        a[:] = 0
    if case == "empty":
        a = a[:0]
    return a


FETCH_CASES = ["sparse_small", "sparse_2p20", "dense_u16", "dense_i32",
               "zeros", "empty", "cap_at", "cap_plus_1", "small_n"] + [
    f"b{b}_{form}" for b in (255, 256, 65535, 65536)
    for form in ("sparse", "dense")]


@pytest.mark.parametrize("case", FETCH_CASES)
def test_fetch_counts_equals_jax(case, jax_calls):
    a = _vector(case)
    want = np.asarray(jcount.fetch_counts(jnp.asarray(a), a.size))
    src = torch.from_numpy(a.copy())
    got = tcount.fetch_counts(src, a.size)
    assert got.dtype == np.int32 and got.shape == a.shape
    np.testing.assert_array_equal(got, a)
    np.testing.assert_array_equal(got, want)
    src.fill_(7)                      # the result is no view of the input
    np.testing.assert_array_equal(got, a)
    (rec,) = tcount.FETCHES
    if a.size == 0:
        assert port_route(rec) == ("dense", 1, 0, 0)
        assert not any(c[0] == "stats" for c in jax_calls)
        return
    assert port_route(rec) == jax_route(jax_calls, a.size)
    expect = {"cap_at": "sparse", "cap_plus_1": "dense", "small_n": "dense",
              "sparse_small": "sparse", "sparse_2p20": "sparse",
              "dense_u16": "dense", "dense_i32": "dense", "zeros": "dense"}
    if case in expect:
        assert rec.route == expect[case]
    if case.startswith("b"):
        boundary = int(case[1:].split("_")[0])
        assert rec.route == case.split("_")[1]
        assert rec.vb == (1 if boundary < 256 else 2 if boundary < 65536
                          else 4)


def test_sparse_cap_equals_jax():
    for n in (0, 1, 8, 4096, 8193, 100_000, 28_588_812, 1 << 26):
        assert tcount.sparse_cap(n) == jcount._sparse_cap(n)


# ------------------------------------------------------------ pipelines
def _genome_table(rng, glen):
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    km, _ = pack.pack_kmers(genome, K)
    keys = np.unique(np.concatenate([km, pack.revcomp_packed(km, K)]))
    return genome, keys, KmerTable.build(keys, k=K)


def _reads(rng, genome, n, length=100, read_len=90):
    codes = np.full((n, length), 4, np.uint8)
    for i in range(n):
        s = int(rng.integers(0, genome.size - read_len))
        r = genome[s:s + read_len]
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        codes[i, :read_len] = r
    return codes


@pytest.fixture(scope="module")
def big():
    """A table of >= 2^17 keys (a 70 kb genome, both strands)."""
    genome, keys, table = _genome_table(np.random.default_rng(21), 70_000)
    assert table.n_keys >= 1 << 17
    return genome, keys, table


def _decode(key: int) -> np.ndarray:
    return np.array([(key >> (2 * (K - 1 - i))) & 3 for i in range(K)],
                    dtype=np.uint8)


def _forge_empty_slot_stray(table, rng):
    """A copy of ``table`` whose fp table holds, in an EMPTY lane of an
    absent k-mer's home bucket, that k-mer's fingerprint; and a read whose
    only window is that k-mer (it counts into the empty slot)."""
    fpt = JFpTable.from_kmer_table(table)
    keys = set(((table.key_hi[table.val >= 0].astype(np.uint64)
                 << np.uint64(32))
                | table.key_lo[table.val >= 0].astype(np.uint64)).tolist())
    rows = fpt.val.reshape(fpt.n_buckets, fpt.bucket)
    while True:
        q = np.uint64(int(rng.integers(0, 1 << 62)))
        hi = np.array([q >> np.uint64(32)], np.uint32)
        lo = np.array([q & np.uint64(0xFFFFFFFF)], np.uint32)
        b = int(mix_seeded_np(hi, lo, fpt.seed)[0]) & (fpt.n_buckets - 1)
        empty = np.nonzero(rows[b] < 0)[0]
        if int(q) not in keys and empty.size:
            break
    fp = fpt.fp.copy()
    fp[b * fpt.bucket + int(empty[0])] = fp2_np(hi, lo)[0]
    forged = JFpTable(fp=fp, val=fpt.val, n_buckets=fpt.n_buckets,
                      bucket=fpt.bucket, seed=fpt.seed, n_keys=fpt.n_keys,
                      k=K)
    jt = dataclasses.replace(table)
    object.__setattr__(jt, "_fp_cache", forged)
    read = np.full((1, 100), 4, np.uint8)
    read[0, :K] = _decode(int(q))
    return jt, forged, read, b * fpt.bucket + int(empty[0])


def _pipelines(table, fpt=None, probe_mode="fp"):
    jp = jcount.CountPipeline(table, probe_mode=probe_mode, pallas=False)
    if probe_mode == "exact":
        tp = CountPipeline(port_kmer_table(table), CPU, probe_mode="exact")
    else:
        fpt = fpt if fpt is not None else JFpTable.from_kmer_table(table)
        tp = CountPipeline(port_fp_table(fpt), CPU)
    return jp, tp


def _finish_both(jp, tp, batches, calls):
    """Count ``batches`` on both pipelines; both finishes, equal; the
    port's record, which takes the JAX finish's route."""
    for b in batches:
        jp.add_batch(b)
        tp.add_batch(b)
    jcounts = np.asarray(jp.counts)   # exact mode: no trash entry
    np.testing.assert_array_equal(tp.counts.numpy()[:jcounts.size], jcounts)
    del calls[:]
    n_before = len(tcount.FETCHES)
    want = np.asarray(jp.finish())
    got = tp.finish()
    np.testing.assert_array_equal(got, want)
    assert len(tcount.FETCHES) == n_before + 1
    rec = tcount.FETCHES[-1]
    assert port_route(rec) == jax_route(calls, want.size)
    return got, rec


@pytest.mark.parametrize("sample", ["sparse", "dense", "strays"])
def test_fp_finish_equals_jax(sample, big, jax_calls):
    rng = np.random.default_rng(22)
    if sample == "dense":
        genome, _, table = _genome_table(rng, 600)
        jp, tp = _pipelines(table)
        batches = [_reads(rng, genome, 1000, 80, 70) for _ in range(2)]
    else:
        genome, _, table = big
        jp, tp = _pipelines(table)
        batches = [_reads(rng, genome, 20)]
        if sample == "strays":
            jt, forged, read, slot = _forge_empty_slot_stray(table, rng)
            jp, tp = _pipelines(jt, forged)
            batches.append(np.repeat(read, 300, axis=0))
    got, rec = _finish_both(jp, tp, batches, jax_calls)
    assert got.sum() > 0
    if sample == "strays":
        # 300 strays in the empty slot: counted in the slot stats (two
        # bytes a value), dropped by the host remap
        assert int(tp.counts[slot]) == 300 and got.max() < 256
        assert (rec.route, rec.space, rec.vb) == ("sparse", "slot", 2)
    if sample == "dense":
        assert (rec.route, rec.space) == ("dense", "id")
        assert rec.soi_uploaded and tp.table.has_slot_of_id
    else:
        assert (rec.route, rec.space) == ("sparse", "slot")
        assert not rec.soi_uploaded and not tp.table.has_slot_of_id


@pytest.mark.parametrize("sample", ["sparse", "dense"])
def test_exact_finish_equals_jax(sample, big, jax_calls):
    rng = np.random.default_rng(23)
    if sample == "dense":
        genome, _, table = _genome_table(rng, 600)
        batches = [_reads(rng, genome, 1000, 80, 70)]
    else:
        genome, _, table = big
        batches = [_reads(rng, genome, 20)]
    jp, tp = _pipelines(table, probe_mode="exact")
    got, rec = _finish_both(jp, tp, batches, jax_calls)
    assert got.sum() > 0 and rec.route == sample


def test_two_samples_in_a_row_and_a_second_table(jax_calls):
    """One pipeline, reset between a sparse sample and a dense one: the
    sparse finish uploads no slot_of_id, the dense one uploads it once.
    Then a fresh pipeline on another table (the L2 union count's case)
    remaps through that table's own ``val``."""
    rng = np.random.default_rng(24)
    genome, _, table = _genome_table(rng, 5_000)
    jp, tp = _pipelines(table)
    recs = []
    for n_reads in (5, 3000, 6):
        jp.reset()
        tp.reset()
        got, rec = _finish_both(jp, tp, [_reads(rng, genome, n_reads, 80,
                                                70)], jax_calls)
        recs.append(rec)
    assert [r.route for r in recs] == ["sparse", "dense", "sparse"]
    assert [r.soi_uploaded for r in recs] == [False, True, False]
    assert tp.table.has_slot_of_id

    genome2, _, table2 = _genome_table(rng, 4_000)
    jp2, tp2 = _pipelines(table2)
    got2, rec2 = _finish_both(jp2, tp2, [_reads(rng, genome2, 5, 80, 70)],
                              jax_calls)
    assert rec2.route == "sparse" and got2.sum() > 0
    assert not tp2.table.has_slot_of_id


@pytest.mark.parametrize("sample", ["sparse", "dense"])
def test_sharded_finish_equals_jax(sample, jax_calls):
    rng = np.random.default_rng(25)
    genome, keys, _ = _genome_table(rng, 20_000 if sample == "sparse"
                                    else 3_000)
    codes = _reads(rng, genome, 8 if sample == "sparse" else 512)
    pipe = psh.ShardedCountPipeline(keys, k=K, mesh=psh.make_mesh(["cpu"] * 8))
    jpipe = jsh.ShardedCountPipeline(keys, k=K, mesh=jsh.make_mesh(8),
                                     pallas=False)
    recs = []
    for _ in range(2):               # the second finish reuses the soi
        pipe.reset()
        jpipe.reset()
        pipe.add_batch(codes)
        jpipe.add_batch(codes)
        del jax_calls[:]
        want = np.asarray(jpipe.finish())
        got = pipe.finish()
        np.testing.assert_array_equal(got, want)
        recs.append(tcount.FETCHES[-1])
        n_padded = pipe.st.shard_cap * pipe.mesh.shape["index"]
        assert port_route(recs[-1]) == jax_route(jax_calls, n_padded)
    assert got.sum() > 0
    assert [r.route for r in recs] == [sample] * 2
    assert [r.soi_uploaded for r in recs] == [True, False]


def test_fetches_stay_at_their_bound():
    """``FETCHES`` is appended on every finish of the program's own path:
    a thousand finishes more than it holds leave it at its bound, the
    newest last, and ``reset_fetches`` empties it."""
    rng = np.random.default_rng(26)
    genome, keys, _ = _genome_table(rng, 2_000)
    pipe = CountPipeline(port_fp_table(JFpTable.build(keys, k=K)), CPU)
    pipe.add_batch(_reads(rng, genome, 4))
    tcount.reset_fetches()
    bound = tcount.FETCHES.maxlen
    for _ in range(bound + 1000):
        want = pipe.finish()
    assert len(tcount.FETCHES) == bound
    assert tcount.FETCHES[-1].nnz == np.count_nonzero(want) > 0
    assert len(list(tcount.FETCHES)) == bound
    tcount.reset_fetches()
    assert len(tcount.FETCHES) == 0
