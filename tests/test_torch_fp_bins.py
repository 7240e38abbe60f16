"""The binned count_fp, stage by stage, on the CPU (each stage's plain twin).

``count_fp`` runs on a card as four kernels (``fp_bin_count``, ``bin_scan``,
``fp_bin_scatter``, ``fp_bin_probe``; ``csrc/count_fp_bins.cu``).  Here the
four stage wrappers run on CPU tensors, so through their plain twins, and
their composition is held against the JAX ``CountPipeline`` (``pallas=False``)
and against ``count_fp_plain`` on the same batches: every payload form,
canonical on and off, bucket widths that are and are not multiples of four,
tables smaller than one bin, all-invalid batches and reads shorter than k.
The bin geometry and the scratch buffers are checked too.

Tolerance: none; counts, bin starts and pairs are integers and must be
equal (the pairs as a multiset within each bin: the kernels' order inside a
bin is the order of their atomics).
"""

import numpy as np
import pytest
import torch

from strainscan_tpu.index.hashtable import FpTable as JaxFpTable
from strainscan_tpu.index.hashtable import KmerTable as JaxKmerTable
from strainscan_tpu.ops.count import CountPipeline as JaxPipeline
from strainscan_tpu_torch.index.hashtable import FpTable, fp_table_to_device
from strainscan_tpu_torch.kmer import pack
from strainscan_tpu_torch.ops import probe
from strainscan_tpu_torch.ops.count import CountPipeline

from _torch_sim import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_sim import port_fp_table

CPU = torch.device("cpu")
K = 31


def _keys(rng, glen):
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    km, _ = pack.pack_kmers(genome, K)
    return genome, np.unique(np.concatenate([km, pack.revcomp_packed(km, K)]))


def _reads(rng, genome, n, length, read_len):
    codes = np.full((n, length), 4, np.uint8)
    starts = rng.integers(0, genome.size - read_len, size=n)
    codes[:, :read_len] = genome[starts[:, None] + np.arange(read_len)]
    codes[n // 4:n // 2, :read_len] = rng.integers(0, 4, size=(
        n // 2 - n // 4, read_len))       # a quarter misses
    return codes


def _staged(counts, words, fp_table, rows_per_block=None, **kw):
    """count_fp as its four stage wrappers (plain twins on the CPU);
    returns the bin starts and the pairs too."""
    n_buckets, bucket = fp_table.shape
    shift = probe.fp_bin_shift(n_buckets, bucket)
    n_blocks, per = probe.fp_bin_blocks(words.shape[0], CPU)
    if rows_per_block is not None:
        per = rows_per_block
        n_blocks = -(-words.shape[0] // per)
    m = kw["length"] - K + 1
    bc, bs, bb, pairs = probe.FpScratch().buffers(
        CPU, n_buckets >> shift, n_blocks, words.shape[0] * m)
    skw = dict(kw, k=K, n_buckets=n_buckets, shift=shift,
               rows_per_block=per)
    probe.fp_bin_count(bc, bb, counts, words, **skw)
    total = int(bc.sum())
    probe.bin_scan(bc, bs)
    assert int(bs[-1]) == total and not bc.any()
    probe.fp_bin_scatter(pairs, bs, bb, words, **skw)
    probe.fp_bin_probe(counts, pairs, bs, fp_table, shift=shift)
    return shift, bs, pairs[:total]


def _payload(codes, form):
    if form == "codes":
        return torch.from_numpy(codes), {}
    words, vbytes = pack.bitpack_codes(codes)
    w = torch.from_numpy(words.view(np.int32))
    if form == "vlen":
        vlen = pack.valid_prefix_lens(codes)
        assert vlen is not None
        return w, {"vlen": torch.from_numpy(vlen)}
    return w, {"vbytes": torch.from_numpy(vbytes)}


@pytest.mark.parametrize("form", ["vlen", "vbytes", "codes"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("bucket", [64, 16, 6])
def test_stages_equal_jax_and_plain(form, canonical, bucket):
    rng = np.random.default_rng(bucket + 3 * canonical)
    genome, keys = _keys(rng, 4000)
    jkt = JaxKmerTable.build(keys, k=K)
    jt = JaxFpTable.from_kmer_table(jkt, bucket=bucket)
    object.__setattr__(jkt, "_fp_cache", jt)    # the JAX pipeline's table
    fpt = port_fp_table(jt)
    table = fp_table_to_device(fpt, CPU).fp
    codes = _reads(rng, genome, 96, 112, 100)
    codes[::7, 100:] = rng.integers(0, 4, size=(codes[::7].shape[0], 12))
    if form != "vlen":
        codes[::5, 40] = 4                 # mid-read N
    words, valid = _payload(codes, form)
    kw = dict(length=112, seed=fpt.seed, canonical=canonical, **valid)
    got = torch.zeros(fpt.n_slots + 1, dtype=torch.int32)
    shift, bin_start, pairs = _staged(got, words, table, rows_per_block=10,
                                      **kw)
    want = probe.count_fp_plain(torch.zeros_like(got), words, table, k=K,
                                **kw)
    assert torch.equal(got, want)
    jp = JaxPipeline(jkt, canonical=canonical, pallas=False,
                     packed_transfer=form != "codes")
    jp.add_batch(codes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.counts))
    assert int(got[:-1].sum()) > 1000 and int(got[-1]) > 1000

    # every pair sits in its bin's range, and the bins hold exactly the
    # valid windows' (fp, bucket) pairs
    bins = (pairs[:, 1] >> shift).to(torch.int64)
    pos = torch.arange(pairs.shape[0])
    assert ((bin_start[bins] <= pos) & (pos < bin_start[bins + 1])).all()
    b, fp = probe.probe_prep_plain(torch.from_numpy(codes), k=K,
                                   n_buckets=fpt.n_buckets, seed=fpt.seed,
                                   canonical=canonical)
    ok = b >= 0
    want_pairs = torch.stack([fp[ok], b[ok]], 1)
    key = (lambda p: (p[:, 1].to(torch.int64) << 32)
           | (p[:, 0].to(torch.int64) & 0xFFFFFFFF))
    assert torch.equal(torch.sort(key(pairs)).values,
                       torch.sort(key(want_pairs)).values)


@pytest.mark.parametrize("case", ["all_invalid", "vlen_zero", "short_reads",
                                  "one_row"])
def test_stages_edge_batches(case):
    rng = np.random.default_rng(7)
    genome, keys = _keys(rng, 2000)
    fpt = FpTable.build(keys, k=K)
    table = fp_table_to_device(fpt, CPU).fp
    codes = _reads(rng, genome, 24, 90, 80)
    if case == "all_invalid":
        codes[:] = 4
    elif case == "vlen_zero":
        codes[::2] = 4
    elif case == "short_reads":
        codes[:, 20:] = 4
    else:
        codes = codes[:1]
    words, valid = _payload(codes, "vlen")
    kw = dict(length=90, seed=fpt.seed, **valid)
    got = torch.zeros(fpt.n_slots + 1, dtype=torch.int32)
    _staged(got, words, table, **kw)
    want = probe.count_fp_plain(torch.zeros_like(got), words, table, k=K,
                                **kw)
    assert torch.equal(got, want)
    assert int(got.sum()) == codes.shape[0] * (90 - K + 1)
    if case in ("all_invalid", "short_reads"):
        assert int(got[-1]) == int(got.sum())


def test_pipeline_holds_one_scratch_across_batches():
    """CountPipeline keeps one FpScratch; bin totals are zero between
    batches; the counts equal the plain count over the stream."""
    rng = np.random.default_rng(9)
    genome, keys = _keys(rng, 3000)
    fpt = FpTable.build(keys, k=K)
    pipe = CountPipeline(fpt, CPU)
    assert isinstance(pipe.scratch, probe.FpScratch)
    table = pipe.table.fp
    want = torch.zeros_like(pipe.counts)
    for i in range(3):
        codes = _reads(rng, genome, 40, 96, 90)
        pipe.add_batch(codes)
        words, valid = _payload(codes, "vlen")
        probe.count_fp_plain(want, words, table, length=96, k=K,
                             seed=fpt.seed, **valid)
    assert torch.equal(pipe.counts, want)
    s = probe.FpScratch()
    bc, bs, bb, pairs = s.buffers(CPU, 8, 3, 100)
    assert (bc.shape, bs.shape, bb.shape, pairs.shape) == (
        (8,), (9,), (3, 8), (100, 2))
    bc += 1
    bc.zero_()
    again = s.buffers(CPU, 4, 2, 50)
    assert again[0].data_ptr() == bc.data_ptr()       # reused, not grown
    grown = s.buffers(CPU, 16, 2, 50)
    assert grown[0].shape == (16,) and not grown[0].any()


@pytest.mark.parametrize("n_buckets, bucket, shift, stride", [
    (1 << 20, 64, 8, 68),      # the E. coli table: 4,096 bins of 64 KiB
    (1 << 3, 64, 3, 68),       # a table smaller than one bin
    (1 << 12, 16, 10, 20),
    (1 << 10, 6, 10, 7),       # 16 B reads need bucket % 4 == 0
    (1 << 24, 64, 9, 0),       # a 4 GiB table: 32,768 bins, not staged
])
def test_bin_geometry(n_buckets, bucket, shift, stride):
    assert probe.fp_bin_shift(n_buckets, bucket) == shift
    assert n_buckets >> shift <= probe.MAX_BINS
    assert probe.fp_bin_stride(bucket, shift, bucket % 4 == 0) == stride
    n_blocks, per = probe.fp_bin_blocks(65_536, CPU)
    assert n_blocks * per >= 65_536 > (n_blocks - 1) * per


def test_stage_wrappers_reject_what_the_kernels_do_not_take():
    bc = torch.zeros(4, dtype=torch.int32)
    bb = torch.zeros((2, 4), dtype=torch.int32)
    counts = torch.zeros(8 * 4 + 1, dtype=torch.int32)
    words = torch.zeros((4, 6), dtype=torch.int32)
    vlen = torch.zeros(4, dtype=torch.uint16)
    kw = dict(length=90, k=K, seed=0, n_buckets=8, shift=1, rows_per_block=2,
              vlen=vlen)
    with pytest.raises(ValueError):          # 8 >> 2 != 4 bins
        probe.fp_bin_count(bc, bb, counts, words, **dict(kw, shift=2))
    with pytest.raises(ValueError):          # 4 rows make 4 blocks of 1
        probe.fp_bin_count(bc, bb, counts, words,
                           **dict(kw, rows_per_block=1))
    with pytest.raises(ValueError):
        probe.bin_scan(bc, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):          # counts of another table
        probe.fp_bin_probe(counts[:-1], torch.zeros((1, 2), dtype=torch.int32),
                           torch.zeros(5, dtype=torch.int32),
                           torch.zeros((8, 4), dtype=torch.int32), shift=1)


def test_fp_bin_parity_of_the_plain_twins_is_zero():
    """The card's per-kernel check (``fp_bin_parity``), run on CPU tensors,
    holds each plain twin against itself: every error is 0."""
    rng = np.random.default_rng(11)
    genome, keys = _keys(rng, 3000)
    fpt = FpTable.build(keys, k=K)
    codes = _reads(rng, genome, 50, 96, 90)
    codes[::4, 30] = 4
    words, valid = _payload(codes, "vbytes")
    errs = probe.fp_bin_parity(words, fp_table_to_device(fpt, CPU).fp,
                               length=96, k=K, seed=fpt.seed, **valid)
    assert errs == dict.fromkeys(("fp_bin_count_kernel", "bin_scan_kernel",
                                  "fp_bin_scatter_kernel",
                                  "fp_bin_probe_kernel"), 0)
