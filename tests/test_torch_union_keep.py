"""A sample's reads counted against several tables through one
``identify.count.SampleReads`` (the main count keeps its device payloads,
the L2 union count, ``vote._count_union``, reads them) against counts that
stream the sample again, on the CPU.

Samples: several batches, one batch, and two files whose first is shorter
than a batch, so that it pins a small batch shape and every later batch is
cut into blocks of it.  Tolerance: none; counts are int32 and must be equal
entry for entry.
"""

import gc
import types
import weakref

import numpy as np
import pytest

from strainscan_tpu.config import IdentifyConfig as JaxConfig
from strainscan_tpu.identify.count import count_sample as count_sample_jax
from strainscan_tpu.index.hashtable import KmerTable
from strainscan_tpu_torch import timing
from strainscan_tpu_torch.config import IdentifyConfig
from strainscan_tpu_torch.identify import count as icount
from strainscan_tpu_torch.identify import vote
from strainscan_tpu_torch.identify.count import SampleReads, count_sample
from strainscan_tpu_torch.index.hashtable import FpTable, fp_table_of
from strainscan_tpu_torch.kmer import pack
from strainscan_tpu_torch.ops.count import CountPipeline

from _torch_sim import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_sim import mutate, port_kmer_table, rand_genome, write_fq

K = 31
CFG = IdentifyConfig(read_batch=256, max_read_len=128)
# sample: (files as (reads, first read), payloads of the main count, rows
# of its batch shape); "blocks": 100 rows, then 256, 256 and 188 cut in 100s
SAMPLES = {"several": ([(700, 0)], 3, 256), "one": ([(200, 0)], 1, 200),
           "blocks": ([(100, 0), (700, 100)], 1 + 3 + 3 + 2, 100)}


def _keys(seq, k=K):
    km, _ = pack.pack_kmers(pack.encode_seq(seq), k)
    return np.unique(np.concatenate([km, pack.revcomp_packed(km, k)]))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Three genomes: the main table holds all three; two clusters of the
    union hold the first's 12-SNP mutant and the second, so the union
    differs from the main table.  Reads of the first two genomes and of
    the mutant, 100 bp."""
    rng = np.random.default_rng(19)
    d = tmp_path_factory.mktemp("union_keep")
    genomes = [rand_genome(rng, 6_000) for _ in range(3)]
    mutant = mutate(rng, genomes[0], 12)
    main_keys = np.unique(np.concatenate([_keys(g) for g in genomes]))
    jax_table = KmerTable.build(main_keys, k=K)
    clusters = [types.SimpleNamespace(cid=c, kmers=_keys(g),
                                      table=types.SimpleNamespace(k=K))
                for c, g in ((1, mutant), (2, genomes[1]))]
    sources = [genomes[0], genomes[1], mutant]
    reads = []
    for i in range(800):
        g = sources[i % 3]
        s = int(rng.integers(0, len(g) - 100))
        reads.append(g[s:s + 100])
    paths = {}
    for name, (files, _, _) in SAMPLES.items():
        paths[name] = []
        for j, (n, first) in enumerate(files):
            path = str(d / f"{name}_{j}.fq")
            write_fq(path, reads[first:first + n])
            paths[name].append(path)
    union = np.unique(np.concatenate([cl.kmers for cl in clusters]))
    return {"jax_table": jax_table, "main_keys": main_keys,
            "main": fp_table_of(port_kmer_table(jax_table)),
            "union": FpTable.build(union, k=K), "union_keys": union,
            "clusters": clusters, "paths": paths}


@pytest.fixture
def copies(monkeypatch):
    """Every host-to-device copy of a CountPipeline's payloads (on the CPU
    ``_to_device`` hands the host tensors on, but is called all the
    same)."""
    calls = []
    to_device = CountPipeline._to_device

    def counted(self, *host):
        calls.append(len(host))
        return to_device(self, *host)

    monkeypatch.setattr(CountPipeline, "_to_device", counted)
    return calls


def _counts(root):
    """The ``count/sample`` spans under ``root`` (closed so far), in
    order."""
    return sorted((s for s in timing.SPANS if s.sample == root.sample
                   and s.name == "count/sample"), key=lambda s: s.t0)


@pytest.mark.parametrize("sample", sorted(SAMPLES))
def test_union_from_kept_payloads_equals_streamed(data, sample, copies):
    files, n_payloads, rows = SAMPLES[sample]
    paths = data["paths"][sample]
    with timing.span("test/sample") as root, \
            SampleReads(paths, "cpu", CFG) as reads:
        main = reads.count(data["main"])
        assert len(copies) == n_payloads
        kept = reads.count(data["union"], keys=data["union_keys"])
        assert len(copies) == n_payloads   # the union copied nothing
        spans = _counts(root)
    streamed = count_sample(data["union"], paths, "cpu", CFG)
    assert streamed.sum() > 0
    np.testing.assert_array_equal(kept, streamed)
    np.testing.assert_array_equal(
        main, count_sample(data["main"], paths, "cpu", CFG))
    # a row of a payload: 4 B a 16 bases and a 2 B length, in the main
    # count's batch shape
    assert [s.attrs for s in spans] == [
        {"source": "stream"},
        {"source": "kept", "kept_bytes":
         n_payloads * rows * (CFG.max_read_len // 4 + 2)}]


@pytest.mark.parametrize("cap", ["zero", "one_byte_short"])
def test_over_the_cap_the_union_count_streams(data, cap, monkeypatch,
                                              copies):
    paths = data["paths"]["several"]
    with timing.span("test/full") as root, \
            SampleReads(paths, "cpu", CFG) as reads:
        reads.count(data["main"])
        reads.count(data["union"])
        full = _counts(root)[1].attrs["kept_bytes"]
    monkeypatch.setattr(icount, "KEEP_CAP_BYTES",
                        0 if cap == "zero" else full - 1)
    del copies[:]
    with timing.span("test/sample") as root, \
            SampleReads(paths, "cpu", CFG) as reads:
        main = reads.count(data["main"])
        union = reads.count(data["union"])
        spans = _counts(root)
    assert [s.attrs for s in spans] == [
        {"source": "stream", "over_cap": True}, {"source": "stream"}]
    assert len(copies) == 2 * 3   # both counts copied every payload
    np.testing.assert_array_equal(
        main, count_sample(data["main"], paths, "cpu", CFG))
    np.testing.assert_array_equal(
        union, count_sample(data["union"], paths, "cpu", CFG))


@pytest.mark.parametrize("route", ["kept", "stream"])
def test_union_count_notes_its_source(data, route, monkeypatch):
    """``_count_union`` over kept payloads and, with the cap at 0 bytes,
    streamed: the same counts per cluster as from fresh reads, and the
    ``source`` and ``kept_bytes`` noted on its ``count/sample`` span, the
    only span under the phase; the phase notes nothing."""
    paths, clusters = data["paths"]["blocks"], data["clusters"]
    with SampleReads(paths, "cpu", CFG) as reads:
        want = vote._count_union(clusters, reads, False)
    if route == "stream":
        monkeypatch.setattr(icount, "KEEP_CAP_BYTES", 0)
    with timing.span("test/sample") as root, \
            SampleReads(paths, "cpu", CFG) as reads:
        reads.count(data["main"])
        got = vote._count_union(clusters, reads, False)
    (phase,) = [s for s in timing.SPANS if s.sample == root.sample
                and s.name == "identify/l2_vote/union_count"]
    assert phase.attrs == {}
    counts = [s for s in timing.SPANS if s.sample == root.sample
              and s.parent == phase.id]
    assert [s.name for s in counts] == ["count/sample"]
    assert counts[0].attrs["source"] == route
    assert (counts[0].attrs.get("kept_bytes", 0) > 0) == (route == "kept")
    assert sorted(got) == sorted(want) == [1, 2]
    for cid in want:
        np.testing.assert_array_equal(got[cid], want[cid])
        assert want[cid].sum() > 0


@pytest.mark.parametrize("why", ["sharded", "other_k", "released", "none"])
def test_payloads_that_cannot_serve_are_not_used(data, why):
    """A sharded first count keeps nothing, and every later count streams
    (only the first count may keep); a
    count of another ``k`` (whose reads ``read_batches`` would drop
    otherwise) streams and keeps nothing; a count after leaving the
    context streams; with none kept yet, the first count streams and
    keeps.  Every count equals ``count_sample``'s."""
    paths = data["paths"]["several"]
    union = data["union"]
    other = FpTable.build(np.unique(data["union_keys"] >> 20), k=21)
    want = {id(t): count_sample(t, paths, "cpu", CFG)
            for t in (data["main"], union, other)}
    if why == "sharded":
        cfg = IdentifyConfig(read_batch=256, max_read_len=128,
                             shard_min_kmers=1)
        reads = SampleReads(paths, ["cpu"] * 4, cfg)
        plan = [(data["main"], data["main_keys"], "stream"),
                (union, None, "stream"), (union, None, "stream")]
    elif why == "other_k":
        reads = SampleReads(paths, "cpu", CFG)
        plan = [(data["main"], None, "stream"), (other, None, "stream"),
                (union, None, "kept"), (other, None, "stream")]
    elif why == "released":
        with SampleReads(paths, "cpu", CFG) as reads:
            reads.count(data["main"])
        plan = [(union, None, "stream"), (union, None, "stream")]
    else:
        reads = SampleReads(paths, "cpu", CFG)
        plan = [(union, None, "stream"), (data["main"], None, "kept")]
    icount._SHARDED_CACHE.clear()
    try:
        with timing.span("test/sample") as root:
            got = [reads.count(t, keys=keys) for t, keys, _ in plan]
    finally:
        icount._SHARDED_CACHE.clear()
        reads.__exit__(None, None, None)
    assert [s.attrs["source"] for s in _counts(root)] == [
        source for _, _, source in plan]
    for (t, _, _), counts in zip(plan, got):
        np.testing.assert_array_equal(counts, want[id(t)])


def test_count_sample_without_a_holder_keeps_nothing(data, monkeypatch):
    """``count_sample`` drops the device payloads each ``add_prepared``
    returns: none is alive once it has returned, and the counts are the
    JAX package's."""
    alive = []
    add = CountPipeline.add_prepared

    def spied(self, payloads):
        counted = add(self, payloads)
        alive.extend(weakref.ref(p[1]) for p in counted)
        return counted

    monkeypatch.setattr(CountPipeline, "add_prepared", spied)
    paths = data["paths"]["blocks"]
    with timing.span("test/sample") as root:
        got = count_sample(data["main"], paths, "cpu", CFG)
    gc.collect()
    assert len(alive) == 1 + 3 + 3 + 2   # a batch, then three cut in 3s
    assert all(ref() is None for ref in alive)
    assert [s.attrs for s in _counts(root)] == [{"source": "stream"}]
    want = count_sample_jax(data["jax_table"], paths,
                            JaxConfig(read_batch=256, max_read_len=128))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.sum() > 0
