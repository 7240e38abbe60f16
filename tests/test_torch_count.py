"""The port's CountPipeline and count_sample against the JAX CountPipeline
(``pallas=False`` on the CPU) and the host NumPy oracle.

Tolerance: none; slot-space and id-space counts are int32 and must be
equal entry for entry, the trash slot included.
"""

import numpy as np
import pytest
import torch

from strainscan_tpu.config import IdentifyConfig
from strainscan_tpu.identify.count import count_sample as count_sample_jax
from strainscan_tpu.index.hashtable import KmerTable
from strainscan_tpu.kmer import pack
from strainscan_tpu.ops.count import CountPipeline as JaxPipeline
from strainscan_tpu_torch.identify.count import count_sample
from strainscan_tpu_torch.index.hashtable import fp_table_of
from strainscan_tpu_torch.kmer import device as tdev
from strainscan_tpu_torch.ops import probe
from strainscan_tpu_torch.ops.count import CountPipeline, shape_batch

from _torch_sim import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_sim import port_kmer_table

CPU = torch.device("cpu")
K = 31


def _genome_table(rng, glen=3000, k=K):
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    km, _ = pack.pack_kmers(genome, k)
    keys = np.unique(np.concatenate([km, pack.revcomp_packed(km, k)]))
    return genome, KmerTable.build(keys, k=k)


def _reads(rng, genome, n, length, read_len):
    codes = np.full((n, length), 4, np.uint8)
    for i in range(n):
        s = int(rng.integers(0, genome.size - read_len))
        r = genome[s:s + read_len]
        if rng.random() < 0.5:
            r = (3 - r)[::-1]
        codes[i, :read_len] = r
    return codes


def _both(table, batches, k=K, canonical=False):
    jp = JaxPipeline(table, canonical=canonical, pallas=False)
    tp = CountPipeline(fp_table_of(port_kmer_table(table)), CPU,
                       canonical=canonical)
    for b in batches:
        jp.add_batch(b)
        tp.add_batch(b)
    np.testing.assert_array_equal(tp.counts.numpy(), np.asarray(jp.counts))
    return tp.finish(), jp.finish()


CASES = ["clean", "mid_read_n", "partial_last", "short_reads",
         "random_table"]


@pytest.mark.parametrize("case", CASES)
def test_count_pipeline_equals_jax(case):
    rng = np.random.default_rng(CASES.index(case))
    genome, table = _genome_table(rng)
    if case == "random_table":     # half the genome's keys, half random
        occ = table.val >= 0
        keys = ((table.key_hi[occ].astype(np.uint64) << np.uint64(32))
                | table.key_lo[occ].astype(np.uint64))[::2]
        noise = rng.integers(0, 1 << 62, size=keys.size, dtype=np.uint64)
        table = KmerTable.build(np.unique(np.concatenate([keys, noise])), k=K)
    batches = [_reads(rng, genome, 64, 90, 80) for _ in range(3)]
    if case == "mid_read_n":       # vbytes payload form
        batches[1][::3, 17] = 4
    if case == "partial_last":     # padded to the first batch's rows
        batches[2] = batches[2][:9]
    if case == "short_reads":      # reads shorter than k hold no window
        batches[0][:, 20:] = 4
    ids, jids = _both(table, batches)
    np.testing.assert_array_equal(ids, jids)
    assert ids.dtype == np.int32 and ids.shape == (table.n_keys,)
    assert ids.sum() > 1000


def test_vbytes_and_vlen_forms_both_used():
    rng = np.random.default_rng(3)
    genome, table = _genome_table(rng)
    pipe = CountPipeline(fp_table_of(port_kmer_table(table)), CPU)
    clean = _reads(rng, genome, 16, 90, 80)
    dirty = clean.copy()
    dirty[0, 10] = 4
    assert [p[0] for p in pipe.prepare_batch(clean)] == ["vlen"]
    assert [p[0] for p in pipe.prepare_batch(dirty)] == ["vbytes"]


@pytest.mark.parametrize("first, later, multiple, shape, blocks", [
    (10, 10, 1, (10, 7), [10]),
    (10, 4, 1, (10, 7), [10]),           # a short batch is padded
    (10, 23, 1, (10, 7), [10, 10, 10]),  # an oversize batch is split
    (10, 23, 8, (16, 7), [16, 16]),      # rows a multiple of the mesh
    (0, 3, 4, (4, 7), [4]),              # an empty first batch
])
def test_shape_batch(first, later, multiple, shape, blocks):
    """The batch-shape policy both pipelines share: pinned by the first
    batch, padded with code-4 rows, oversize batches split."""
    rng = np.random.default_rng(5)
    got, _ = shape_batch(np.zeros((first, 7), np.uint8), None, multiple)
    assert got == shape
    codes = rng.integers(0, 4, size=(later, 7)).astype(np.uint8)
    _, out = shape_batch(codes, got, multiple)
    assert [b.shape[0] for b in out] == blocks
    flat = np.concatenate(out)
    np.testing.assert_array_equal(flat[:later], codes)
    assert (flat[later:] == 4).all()
    with pytest.raises(ValueError, match="maxlen"):
        shape_batch(codes[:, :6], got, multiple)


def test_counts_above_65535_and_host_oracle():
    """A read repeated 70,000 times pushes counts past uint16; the slot
    counts equal np.bincount over FpTable.lookup_host."""
    rng = np.random.default_rng(4)
    genome, table = _genome_table(rng, glen=500)
    read = _reads(rng, genome, 1, 64, 60)
    codes = np.repeat(read, 70_000, axis=0)
    fpt = fp_table_of(port_kmer_table(table))
    pipe = CountPipeline(fpt, CPU)
    pipe.add_batch(codes)
    ids = pipe.finish()
    assert ids.max() >= 70_000

    hi, lo, valid = (t.numpy() for t in
                     tdev.extract_kmers(torch.from_numpy(read), K))
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    slots = fpt.lookup_host(keys[valid])
    want = np.bincount(slots[slots >= 0], minlength=fpt.n_slots) * 70_000
    np.testing.assert_array_equal(pipe.counts.numpy()[:-1], want)
    jp = JaxPipeline(table, pallas=False)
    jp.add_batch(codes)
    np.testing.assert_array_equal(ids, jp.finish())


def test_count_plain_chunks_agree():
    """The plain count's row chunking does not change the counts."""
    rng = np.random.default_rng(6)
    genome, table = _genome_table(rng)
    fpt = fp_table_of(port_kmer_table(table))
    codes = _reads(rng, genome, 50, 96, 90)
    words, _ = pack.bitpack_codes(codes)
    vlen = torch.from_numpy(pack.valid_prefix_lens(codes))
    dt = CountPipeline(fpt, CPU).table
    out = []
    for chunk in (7, probe.PLAIN_CHUNK_ROWS):
        old, probe.PLAIN_CHUNK_ROWS = probe.PLAIN_CHUNK_ROWS, chunk
        try:
            c = torch.zeros(fpt.n_slots + 1, dtype=torch.int32)
            probe.count_fp(c, torch.from_numpy(words.view(np.int32)), dt.fp,
                           length=96, k=K, seed=fpt.seed, vlen=vlen)
            out.append(c)
        finally:
            probe.PLAIN_CHUNK_ROWS = old
    assert torch.equal(out[0], out[1])
    assert int(out[0][-1]) > 0   # pad windows land in the trash slot


@pytest.mark.parametrize("kind", ["empty", "sub_k", "reads"])
def test_count_sample_equals_jax(tmp_path, kind):
    rng = np.random.default_rng(8)
    genome, table = _genome_table(rng)
    fq = tmp_path / "s.fq"
    with open(fq, "w") as f:
        if kind != "empty":
            read_len = 20 if kind == "sub_k" else 100
            for i in range(300):
                s = int(rng.integers(0, genome.size - read_len))
                seq = "".join("ACGT"[c] for c in genome[s:s + read_len])
                f.write(f"@r{i}\n{seq}\n+\n{'I' * read_len}\n")
    cfg = IdentifyConfig(read_batch=128, max_read_len=128)
    got = count_sample(fp_table_of(port_kmer_table(table)), str(fq), CPU,
                       cfg)
    want = count_sample_jax(table, str(fq), cfg)
    np.testing.assert_array_equal(got, want)
    assert (got.sum() > 0) == (kind == "reads")


def test_fp_table_to_device_cached_per_device():
    rng = np.random.default_rng(9)
    _, table = _genome_table(rng, glen=400)
    fpt = fp_table_of(port_kmer_table(table))
    a = CountPipeline(fpt, CPU).table
    b = CountPipeline(fpt, torch.device("cpu")).table
    assert a is b
    assert a.fp.dtype == torch.int32 and a.fp.shape == (fpt.n_buckets,
                                                        fpt.bucket)
    np.testing.assert_array_equal(a.fp.numpy().view(np.uint32).ravel(),
                                  fpt.fp)
