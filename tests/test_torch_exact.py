"""The port's exact probe mode (``lookup_exact``, ``count_exact``,
``CountPipeline(probe_mode="exact")``) and the raw-codes payload of the fp
mode, against the JAX package (``lookup_device``, ``CountPipeline`` with
``probe_mode="exact"`` / ``packed_transfer=False``, ``pallas=False`` on the
CPU) and the host NumPy oracle.

Tolerance: none; ids and counts are integers and must be equal entry for
entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strainscan_tpu.index.hashtable import (KmerTable, fp2_np, lookup_device,
                                            mix_seeded_np)
from strainscan_tpu.kmer import pack
from strainscan_tpu.ops.count import CountPipeline as JaxPipeline
from strainscan_tpu_torch.index.hashtable import FpTable as TFpTable
from strainscan_tpu_torch.index.hashtable import KmerTable as TKmerTable
from strainscan_tpu_torch.index.hashtable import (kmer_table_to_device,
                                                  lookup_exact)
from strainscan_tpu_torch.kmer.device import from_u32
from strainscan_tpu_torch.ops import probe
from strainscan_tpu_torch.ops.count import CountPipeline

from _torch_sim import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_sim import port_kmer_table

CPU = torch.device("cpu")
K = 31


def _genome_keys(rng, glen=3000, k=K):
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    km, _ = pack.pack_kmers(genome, k)
    return genome, np.unique(np.concatenate([km, pack.revcomp_packed(km, k)]))


def _reads(rng, genome, n, length, read_len):
    codes = np.full((n, length), 4, np.uint8)
    for i in range(n):
        s = int(rng.integers(0, genome.size - read_len))
        r = genome[s:s + read_len]
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        codes[i, :read_len] = r
    codes[:4, :read_len] = rng.integers(0, 4, size=(4, read_len))  # misses
    return codes


def _halves(keys):
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


@pytest.mark.parametrize("load_factor", [0.25, 0.9])
def test_lookup_exact_equals_jax_and_host(load_factor):
    """Hits, misses and (at load 0.9) overflow probes past the home row."""
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(0, 1 << 62, size=4000, dtype=np.uint64))
    table = TKmerTable.build(keys, k=K, load_factor=load_factor)
    assert table.max_probe >= (3 if load_factor > 0.5 else 1)
    q = np.concatenate([keys[::2], rng.integers(0, 1 << 62, size=2000,
                                                dtype=np.uint64)])
    hi, lo = _halves(q)
    dt = kmer_table_to_device(table, CPU)
    got = lookup_exact(dt.table, dt.n_buckets, dt.max_probe,
                       torch.from_numpy(hi.astype(np.int64)),
                       torch.from_numpy(lo.astype(np.int64))).numpy()
    want = np.asarray(lookup_device(jnp.asarray(table.interleaved()),
                                    table.n_buckets, table.max_probe,
                                    jnp.asarray(hi), jnp.asarray(lo)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, table.lookup_host(q))
    assert (got >= 0).sum() == keys[::2].size


def test_kmer_table_to_device_cached_per_device():
    rng = np.random.default_rng(2)
    _, keys = _genome_keys(rng, glen=500)
    table = TKmerTable.build(keys, k=K)
    a = kmer_table_to_device(table, CPU)
    assert kmer_table_to_device(table, torch.device("cpu")) is a
    assert a.table.dtype == torch.int32
    np.testing.assert_array_equal(a.table.numpy(), table.interleaved())
    assert (a.n_buckets, a.max_probe, a.n_keys) == (
        table.n_buckets, table.max_probe, table.n_keys)


CASES = [(packed, canonical) for packed in (True, False)
         for canonical in (False, True)]


@pytest.mark.parametrize("packed,canonical", CASES)
def test_exact_pipeline_equals_jax(packed, canonical):
    """vbytes (packed) and raw codes payloads, canonical on and off, with a
    mid-read N, a partial last batch and a high-load table."""
    rng = np.random.default_rng(CASES.index((packed, canonical)))
    genome, keys = _genome_keys(rng)
    table = KmerTable.build(keys, k=K, load_factor=0.8)
    batches = [_reads(rng, genome, 64, 90, 80) for _ in range(3)]
    batches[1][::3, 17] = 4
    batches[2] = batches[2][:9]
    jp = JaxPipeline(table, canonical=canonical, packed_transfer=packed,
                     probe_mode="exact", pallas=False)
    tp = CountPipeline(port_kmer_table(table), CPU, canonical=canonical,
                       packed_transfer=packed, probe_mode="exact")
    forms = set()
    for b in batches:
        jp.add_batch(b)
        payloads = tp.prepare_batch(b)
        forms |= {p[0] for p in payloads}
        tp.add_prepared(payloads)
    assert forms == ({"vbytes"} if packed else {"codes"})
    np.testing.assert_array_equal(tp.counts.numpy()[:-1], np.asarray(jp.counts))
    ids = tp.finish()
    np.testing.assert_array_equal(ids, jp.finish())
    assert ids.dtype == np.int32 and ids.shape == (table.n_keys,)
    assert ids.sum() > 1000
    assert int(tp.counts[-1]) > 0      # misses and pad windows: trash


def test_exact_counts_host_oracle_and_vlen_form():
    """Slot-free exact counts equal bincount over KmerTable.lookup_host;
    the vlen, vbytes and codes forms of count_exact agree."""
    rng = np.random.default_rng(7)
    genome, keys = _genome_keys(rng)
    table = TKmerTable.build(keys, k=K)
    codes = _reads(rng, genome, 50, 96, 90)
    hi, lo, valid = (t.numpy() for t in probe.kdev.extract_kmers(
        torch.from_numpy(codes), K))
    q = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    ids = table.lookup_host(q[valid])
    want = np.bincount(ids[ids >= 0], minlength=table.n_keys)
    dt = kmer_table_to_device(table, CPU)
    words, vbytes = pack.bitpack_codes(codes)
    kw = dict(length=96, k=K, max_probe=dt.max_probe)
    forms = {"codes": (torch.from_numpy(codes), {}),
             "vbytes": (from_u32(words), {"vbytes": torch.from_numpy(vbytes)}),
             "vlen": (from_u32(words), {"vlen": torch.from_numpy(
                 pack.valid_prefix_lens(codes))})}
    for name, (reads, valid_kw) in forms.items():
        c = torch.zeros(table.n_keys + 1, dtype=torch.int32)
        probe.count_exact(c, reads, dt.table, **kw, **valid_kw)
        np.testing.assert_array_equal(c.numpy()[:-1], want, err_msg=name)
        assert int(c[-1]) == valid.size - int((ids >= 0).sum())


def test_count_exact_plain_chunks_agree():
    rng = np.random.default_rng(8)
    genome, keys = _genome_keys(rng)
    table = TKmerTable.build(keys, k=K)
    dt = kmer_table_to_device(table, CPU)
    codes = torch.from_numpy(_reads(rng, genome, 50, 96, 90))
    out = []
    for chunk in (7, probe.PLAIN_CHUNK_ROWS):
        old, probe.PLAIN_CHUNK_ROWS = probe.PLAIN_CHUNK_ROWS, chunk
        try:
            c = torch.zeros(table.n_keys + 1, dtype=torch.int32)
            probe.count_exact(c, codes, dt.table, length=96, k=K,
                              max_probe=dt.max_probe)
            out.append(c)
        finally:
            probe.PLAIN_CHUNK_ROWS = old
    assert torch.equal(out[0], out[1])


def _decode(key: int, k: int = K) -> np.ndarray:
    """uint8 codes of a packed k-mer, 5'-first."""
    return np.array([(key >> (2 * (k - 1 - i))) & 3 for i in range(k)],
                    dtype=np.uint8)


def test_forged_fp_stray_is_rejected_by_the_exact_mode():
    """The collision of test_hashtable's stray test, through both count
    pipelines: a read whose only window is an absent k-mer, with its
    fingerprint forged into an occupied slot of its home bucket, credits
    the victim key in fp mode and nothing in exact mode."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 1 << 62, size=2_000, dtype=np.uint64))
    t = TFpTable.build(keys, k=K)
    q = np.uint64(0x1EADBEEF12345678)
    assert q not in set(keys.tolist())
    hi, lo = _halves(np.array([q], np.uint64))
    b = int(mix_seeded_np(hi, lo, t.seed)[0]) & (t.n_buckets - 1)
    occ = t.val.reshape(t.n_buckets, t.bucket)[b] >= 0
    lane = int(np.nonzero(occ)[0][0])
    victim = int(t.val.reshape(t.n_buckets, t.bucket)[b][lane])
    forged = TFpTable(fp=t.fp.copy(), val=t.val, n_buckets=t.n_buckets,
                     bucket=t.bucket, seed=t.seed, n_keys=t.n_keys, k=K)
    forged.fp.reshape(t.n_buckets, t.bucket)[b][lane] = fp2_np(hi, lo)[0]

    read = np.full((1, 40), 4, np.uint8)
    read[0, :K] = _decode(int(q))
    fp_pipe = CountPipeline(forged, CPU)
    fp_pipe.add_batch(read)
    fp_ids = fp_pipe.finish()
    assert fp_ids[victim] == 1 and fp_ids.sum() == 1, "the stray credits"

    kt = KmerTable.build(keys, k=K)
    ex_pipe = CountPipeline(port_kmer_table(kt), CPU, probe_mode="exact")
    ex_pipe.add_batch(read)
    assert ex_pipe.finish().sum() == 0
    assert int(ex_pipe.counts[-1]) == 40 - K + 1   # every window: trash
    jp = JaxPipeline(kt, probe_mode="exact", pallas=False)
    jp.add_batch(read)
    assert np.asarray(jp.finish()).sum() == 0


@pytest.mark.parametrize("canonical", [False, True])
def test_fp_codes_payload_equals_jax(canonical):
    """packed_transfer=False in fp mode: raw codes into count_fp."""
    rng = np.random.default_rng(11)
    genome, keys = _genome_keys(rng)
    table = KmerTable.build(keys, k=K)
    jp = JaxPipeline(table, canonical=canonical, packed_transfer=False,
                     pallas=False)
    tp = CountPipeline(port_kmer_table(table), CPU, canonical=canonical,
                       packed_transfer=False)
    for _ in range(2):
        b = _reads(rng, genome, 64, 90, 80)
        b[::4, 30] = 4
        jp.add_batch(b)
        assert [p[0] for p in tp.prepare_batch(b)] == ["codes"]
        tp.add_batch(b)
    np.testing.assert_array_equal(tp.counts.numpy(), np.asarray(jp.counts))
    np.testing.assert_array_equal(tp.finish(), jp.finish())


def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(12)
    _, keys = _genome_keys(rng, glen=500)
    table = TKmerTable.build(keys, k=K)
    dt = kmer_table_to_device(table, CPU)
    codes = torch.from_numpy(np.zeros((4, 40), np.uint8))
    counts = torch.zeros(table.n_keys + 1, dtype=torch.int32)
    kw = dict(length=40, k=K, max_probe=1)
    with pytest.raises(ValueError):      # table rows are not 24 wide
        probe.count_exact(counts, codes, dt.table[:, :16].contiguous(), **kw)
    with pytest.raises(ValueError):      # codes rows differ from length
        probe.count_exact(counts, codes, dt.table, **dict(kw, length=39))
    with pytest.raises(ValueError):      # both validity forms
        probe.count_exact(counts, codes.to(torch.int32), dt.table, **kw,
                          vlen=torch.zeros(4, dtype=torch.uint16),
                          vbytes=torch.zeros((4, 5), dtype=torch.uint8))
    with pytest.raises(TypeError):
        CountPipeline(TFpTable.from_kmer_table(table), CPU,
                      probe_mode="exact")
    with pytest.raises(ValueError):
        CountPipeline(table, CPU, probe_mode="fast")
