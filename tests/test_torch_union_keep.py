"""The L2 union count over the main count's kept device payloads
(``identify.count.KeptBatches``, ``count_kept``, ``vote._count_union``)
against the union count that streams the sample again, on the CPU.

Samples: several batches, one batch, and two files whose first is shorter
than a batch, so that it pins a small batch shape and every later batch is
cut into blocks of it.  Tolerance: none; counts are int32 and must be equal
entry for entry.
"""

import types

import numpy as np
import pytest
import torch

from strainscan_tpu.config import IdentifyConfig as JaxConfig
from strainscan_tpu.identify.count import count_sample as count_sample_jax
from strainscan_tpu.index.hashtable import KmerTable
from strainscan_tpu_torch import timing
from strainscan_tpu_torch.config import IdentifyConfig
from strainscan_tpu_torch.identify import count as icount
from strainscan_tpu_torch.identify import vote
from strainscan_tpu_torch.identify.count import (KEEP_STATS, KeptBatches,
                                                 count_kept, count_sample,
                                                 reset_keep_stats)
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


@pytest.mark.parametrize("sample", sorted(SAMPLES))
def test_union_from_kept_payloads_equals_streamed(data, sample, copies):
    files, n_payloads, rows = SAMPLES[sample]
    paths = data["paths"][sample]
    reset_keep_stats()
    with KeptBatches() as keep:
        main = count_sample(data["main"], paths, "cpu", CFG, keep=keep)
        assert keep.usable and len(keep.payloads) == n_payloads
        assert len(copies) == n_payloads
        assert keep.meta == (torch.device("cpu"), K, "fp", True,
                             (rows, CFG.max_read_len))
        kept_bytes = keep.nbytes
        kept = count_kept(data["union"], keep, "cpu", CFG,
                          keys=data["union_keys"])
        assert len(copies) == n_payloads   # the union copied nothing
    assert not keep.usable and keep.payloads == [] and keep.nbytes == 0
    streamed = count_sample(data["union"], paths, "cpu", CFG)
    assert kept is not None and streamed.sum() > 0
    np.testing.assert_array_equal(kept, streamed)
    np.testing.assert_array_equal(
        main, count_sample(data["main"], paths, "cpu", CFG))
    # a row of a payload: 4 B a 16 bases and a 2 B length
    assert kept_bytes == n_payloads * rows * (CFG.max_read_len // 4 + 2)
    assert KEEP_STATS == {"kept": 1, "streamed": 0, "over_cap": 0,
                          "bytes": kept_bytes}


@pytest.mark.parametrize("cap", ["zero", "one_byte_short"])
def test_over_the_cap_the_union_count_streams(data, cap, monkeypatch):
    paths = data["paths"]["several"]
    with KeptBatches() as keep:
        count_sample(data["main"], paths, "cpu", CFG, keep=keep)
        full = keep.nbytes
    monkeypatch.setattr(icount, "KEEP_CAP_BYTES",
                        0 if cap == "zero" else full - 1)
    reset_keep_stats()
    with KeptBatches() as keep:
        main = count_sample(data["main"], paths, "cpu", CFG, keep=keep)
        assert not keep.usable and keep.payloads == [] and keep.nbytes == 0
        assert count_kept(data["union"], keep, "cpu", CFG) is None
    np.testing.assert_array_equal(
        main, count_sample(data["main"], paths, "cpu", CFG))
    assert KEEP_STATS == {"kept": 0, "streamed": 1, "over_cap": 1,
                          "bytes": 0}


@pytest.mark.parametrize("route", ["kept", "stream"])
def test_union_count_notes_its_source(data, route, monkeypatch):
    """``_count_union`` over kept payloads and, with the cap at 0 bytes,
    streamed: the same counts per cluster as with no holder, and the
    phase span's ``source`` and ``kept_bytes``."""
    paths, clusters = data["paths"]["blocks"], data["clusters"]
    want = vote._count_union(clusters, paths, CFG, "cpu", False, True)
    if route == "stream":
        monkeypatch.setattr(icount, "KEEP_CAP_BYTES", 0)
    reset_keep_stats()
    with timing.span("test/sample") as root, KeptBatches() as keep:
        count_sample(data["main"], paths, "cpu", CFG, keep=keep)
        kept_bytes = keep.nbytes
        got = vote._count_union(clusters, paths, CFG, "cpu", False, True,
                                keep)
    (phase,) = [s for s in timing.SPANS if s.sample == root.sample
                and s.name == "identify/l2_vote/union_count"]
    assert phase.attrs == {"source": route, "kept_bytes": kept_bytes}
    assert (kept_bytes > 0) == (route == "kept")
    counts = [s for s in timing.SPANS if s.sample == root.sample
              and s.name == "count/sample" and s.parent == phase.id]
    assert len(counts) == 1   # the union's count, under the phase
    assert sorted(got) == sorted(want) == [1, 2]
    for cid in want:
        np.testing.assert_array_equal(got[cid], want[cid])
        assert want[cid].sum() > 0
    assert (KEEP_STATS["kept"], KEEP_STATS["streamed"]) == (
        (1, 0) if route == "kept" else (0, 1))


@pytest.mark.parametrize("why", ["sharded", "other_k", "released", "none"])
def test_payloads_that_cannot_serve_are_not_used(data, why):
    """A sharded main count keeps nothing; payloads of another ``k`` (whose
    reads ``read_batches`` would drop otherwise) or a released holder are
    not counted; without a holder nothing is kept."""
    paths = data["paths"]["several"]
    reset_keep_stats()
    keep = KeptBatches()
    if why == "sharded":
        cfg = IdentifyConfig(read_batch=256, max_read_len=128,
                             shard_min_kmers=1)
        mesh = ["cpu"] * 4
        icount._SHARDED_CACHE.clear()
        try:
            count_sample(data["main"], paths, mesh, cfg, keep=keep,
                         keys=data["main_keys"])
        finally:
            icount._SHARDED_CACHE.clear()
        assert not keep.usable and keep.payloads == []
    elif why != "none":
        count_sample(data["main"], paths, "cpu", CFG, keep=keep)
        assert keep.usable
        if why == "released":
            keep.release()
    table = (FpTable.build(np.unique(data["union_keys"] >> 20), k=21)
             if why == "other_k" else data["union"])
    assert count_kept(table, None if why == "none" else keep, "cpu",
                      CFG) is None
    keep.release()
    assert KEEP_STATS == {"kept": 0, "streamed": 1, "over_cap": 0,
                          "bytes": 0}


def test_count_sample_without_a_holder_keeps_nothing(data, monkeypatch):
    """No holder: every batch's ``add_prepared`` gets no ``keep``, and the
    counts are the JAX package's."""
    seen = []
    add = CountPipeline.add_prepared

    def spied(self, payloads, keep=None):
        seen.append(keep)
        return add(self, payloads, keep)

    monkeypatch.setattr(CountPipeline, "add_prepared", spied)
    reset_keep_stats()
    paths = data["paths"]["blocks"]
    got = count_sample(data["main"], paths, "cpu", CFG)
    assert seen == [None] * 4   # a batch, then the second file's three
    want = count_sample_jax(data["jax_table"], paths,
                            JaxConfig(read_batch=256, max_read_len=128))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.sum() > 0
    assert KEEP_STATS == dict.fromkeys(KEEP_STATS, 0)
