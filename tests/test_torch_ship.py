"""The sharded pipeline's h2d half (``ShardedCountPipeline.ship``) on an
8-entry ``cpu`` mesh, against the JAX package's ``ShardedCountPipeline``
with its ``ship`` on its 8-virtual-device CPU mesh (as tests/test_parallel.py
runs it), and the producer thread that ships in ``count_sample``.

Tolerance: none; counts are integers and must be equal.
"""

import dataclasses
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from strainscan_tpu.index.hashtable import KmerTable as JKmerTable
from strainscan_tpu.kmer import pack
from strainscan_tpu.ops.count import CountPipeline as JaxPipeline
from strainscan_tpu.parallel import sharded as jsh
from strainscan_tpu_torch.config import IdentifyConfig
from strainscan_tpu_torch.identify import count as icount
from strainscan_tpu_torch.index.hashtable import FpTable
from strainscan_tpu_torch.ops.count import CountPipeline
from strainscan_tpu_torch.ops.probe import fp_bin_geometry
from strainscan_tpu_torch.parallel import sharded as psh

from _torch_sim import one_torch_thread, write_fq  # noqa: F401

CPU8 = ["cpu"] * 8
PRODUCER = "strainscan-prefetch"   # utils.prefetch's thread


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(71)
    genome = "".join(rng.choice(list("ACGT"), size=6000))
    db = pack.seq_kmer_set(genome, 31, both_strands=True)
    codes = np.full((300, 96), 4, dtype=np.uint8)
    for i in range(codes.shape[0]):
        s = rng.integers(0, len(genome) - 90)
        codes[i, :90] = pack.encode_seq(genome[s:s + 90])
    codes[-20:, :90] = rng.integers(0, 4, size=(20, 90))   # misses
    return db, codes, genome


def _single(keys, batches):
    """The JAX single-device fp pipeline's id-space counts."""
    pipe = JaxPipeline(JKmerTable.build(keys, k=31), pallas=False)
    for b in batches:
        pipe.add_batch(b)
    return np.asarray(pipe.finish())


def _batches(codes, form):
    """Two batches of ``form``'s payload: 256 rows (the pinned shape) and
    37 rows (padded to 256 by invalid rows); a mid-read N makes vbytes."""
    b1, b2 = codes[:256].copy(), codes[256:293].copy()
    if form == "vbytes":
        b1[::7, 40] = 4
        b2[::3, 50] = 4
    return [b1, b2]


@pytest.mark.parametrize("form", ["codes", "vlen", "vbytes"])
def test_shipped_counts_equal_jax_ship(problem, form):
    """Shipped, unshipped (add_prepared ships host payloads itself) and the
    JAX package's shipped pipeline give one count vector, padding rows
    and all, equal to the single-device count."""
    db, codes, _ = problem
    batches = _batches(codes, form)
    packed = form != "codes"
    mesh = psh.make_mesh(CPU8)
    shipped, unshipped = (psh.ShardedCountPipeline(
        db, k=31, mesh=mesh, packed_transfer=packed) for _ in range(2))
    jpipe = jsh.ShardedCountPipeline(db, k=31, mesh=jsh.make_mesh(8),
                                     pallas=False, packed_transfer=packed)
    d = mesh.shape["data"]
    for b in batches:
        payloads = shipped.prepare_batch(b)
        assert [p[0] for p in payloads] == [form]
        sent = shipped.ship(payloads)
        (one,) = sent
        assert isinstance(one, psh.Shipped) and one.form == form
        # one copy per (data group, device): 4 groups, all on "cpu"
        assert sorted(one.parts) == [(di, "cpu") for di in range(d)]
        rows = payloads[0][1].shape[0] // d
        for (di, _), (a, _, done) in one.parts.items():
            assert done is None
            assert torch.equal(a, payloads[0][1][di * rows:(di + 1) * rows])
        shipped.add_prepared(sent)
        unshipped.add_prepared(unshipped.prepare_batch(b))
        jpipe.add_prepared(jpipe.ship(jpipe.prepare_batch(b)))
    want = _single(db, batches)
    assert want.sum() > 0
    got = shipped.finish()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(unshipped.finish(), want)
    np.testing.assert_array_equal(got, np.asarray(jpipe.finish()))


@pytest.fixture
def sample(problem, tmp_path):
    """A FASTQ of 300 reads of 90 bp, counted in batches of 40 reads."""
    db, _, genome = problem
    rng = np.random.default_rng(5)
    starts = rng.integers(0, len(genome) - 90, size=300)
    fq = str(tmp_path / "s.fq")
    write_fq(fq, [genome[s:s + 90] for s in starts])
    cfg = IdentifyConfig(shard_min_kmers=1, read_batch=40)
    keys = np.sort(db)
    return FpTable.build(keys, k=31), keys, fq, cfg


@pytest.fixture
def ship_spy(monkeypatch):
    """The thread of every ShardedCountPipeline.ship call."""
    threads = []
    ship = psh.ShardedCountPipeline.ship

    def spy(self, payloads):
        threads.append(threading.current_thread().name)
        return ship(self, payloads)

    monkeypatch.setattr(psh.ShardedCountPipeline, "ship", spy)
    return threads


def test_count_sample_ships_in_the_producer_thread(sample, ship_spy):
    fpt, keys, fq, cfg = sample
    icount._SHARDED_CACHE.clear()
    try:
        got = icount.count_sample(fpt, fq, CPU8, cfg, keys=keys)
    finally:
        icount._SHARDED_CACHE.clear()
    assert ship_spy == [PRODUCER] * 8          # 300 reads / 40 per batch
    single = icount.count_sample(fpt, fq, "cpu", cfg, keys=keys)
    assert ship_spy == [PRODUCER] * 8          # the single pipeline: none
    assert not hasattr(CountPipeline, "ship")
    np.testing.assert_array_equal(got, single)
    assert single.sum() > 0


def test_ship_error_reaches_the_caller(sample, monkeypatch):
    fpt, keys, fq, cfg = sample

    def broken(self, payloads):
        raise RuntimeError("copy failed")

    monkeypatch.setattr(psh.ShardedCountPipeline, "ship", broken)
    icount._SHARDED_CACHE.clear()
    try:
        with pytest.raises(RuntimeError, match="copy failed"):
            icount.count_sample(fpt, fq, CPU8, cfg, keys=keys)
    finally:
        icount._SHARDED_CACHE.clear()


class _SlowPipe:
    """A pipeline whose batches are counted slowly: the producer runs as
    far ahead as it may."""

    k = 31

    def __init__(self):
        self.alive = 0
        self.most = 0
        self.lock = threading.Lock()

    def prepare_batch(self, codes):
        return codes.shape[0]

    def ship(self, payloads):
        with self.lock:
            self.alive += 1
            self.most = max(self.most, self.alive)
        return payloads

    def add_prepared(self, payloads):
        time.sleep(0.01)
        with self.lock:
            self.alive -= 1


def test_shipped_batches_in_flight_bounded(sample):
    """At most PREFETCH_DEPTH + 1 shipped batches alive at once: the one
    being counted and those queued or being copied."""
    _, _, fq, cfg = sample
    pipe = _SlowPipe()
    rows = []
    for payloads in icount.iter_payloads(
            pipe, fq, dataclasses.replace(cfg, read_batch=10)):
        pipe.add_prepared(payloads)
        rows.append(payloads)
    assert sum(rows) == 300 and len(rows) == 30
    assert pipe.most == icount.PREFETCH_DEPTH + 1


def test_close_frees_the_scratch_buffers(problem):
    """close() drops the table shards, totals, slot_of_id and the binned
    count's per-device scratch; the pipeline counts again afterwards."""
    db, codes, _ = problem
    pipe = psh.ShardedCountPipeline(db, k=31, mesh=psh.make_mesh(CPU8))
    pipe.add_batch(codes[:256])
    first = pipe.finish()
    cpu = torch.device("cpu")
    g = fp_bin_geometry(pipe.st.n_buckets, pipe.st.bucket, 64, 66, cpu)
    pipe._scratch.buffers(cpu, g, 64 * 66)   # as a card's count does
    held = [weakref.ref(t) for t in pipe._scratch._bufs["cpu"]]
    assert all(r() is not None for r in held)
    pipe.close()
    assert all(r() is None for r in held)
    assert pipe._fp_dev is None and pipe._totals is None
    assert pipe._soi_dev is None and not pipe._scratch._bufs
    pipe.reset()
    pipe.add_batch(codes[:256])
    np.testing.assert_array_equal(pipe.finish(), first)
