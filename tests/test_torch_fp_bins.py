"""The binned count_fp, stage by stage, on the CPU (each stage's plain twin).

``count_fp`` runs on a card as four kernels: a bin sort of the batch's
windows in three passes (``fp_coarse_count``, ``fp_coarse_scatter``,
``fp_fine_split``) and the probe (``fp_bin_probe``;
``csrc/count_fp_bins.cu``).  Here the four stage wrappers run on CPU
tensors, so through their plain twins, and their composition is held
against the JAX ``CountPipeline`` (``pallas=False``) and against
``count_fp_plain`` on the same batches: every payload form, canonical on and
off, bucket widths that are and are not multiples of four, one bin and many
coarse and fine bins, few bins that are each their own coarse bin (no fine
split), tables smaller than one coarse bin, all-invalid batches and reads
shorter than k.  The bin geometry, the scratch buffers and the probe's work
items (each bin's windows cut into parts) are checked too.

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


# (SLICE_BYTES, coarse bins): the E. coli geometry's rule, which gives these
# small tables one bin (the L2 union count's 256 x 64 table is one); 16 KiB
# smaller fine bins, 16 of them at 256 x 64, each its own coarse bin; and
# 64 KiB / 2**10 smaller fine bins, 8 coarse bins
GEOMETRIES = {"one_bin": (1 << 16, 256), "few_bins": (1 << 12, 256),
              "many_bins": (1 << 10, 8)}
# fine bins of test_stages_equal_jax_and_plain's tables, by bucket width
# (256 x 64, 1,024 x 16, 8,192 x 6), where each is its own coarse bin
OWN_COARSE_BINS = {"one_bin": {64: 1, 16: 1, 6: 4},
                   "few_bins": {64: 16, 16: 16, 6: 64}}


@pytest.fixture(params=sorted(GEOMETRIES))
def geometry(request, monkeypatch):
    """The geometry's name, with the fine bins' size patched in."""
    monkeypatch.setattr(probe, "SLICE_BYTES", GEOMETRIES[request.param][0])
    return request.param


def _staged(counts, words, fp_table, rows_per_block=None, coarse_bins=None,
            **kw):
    """count_fp as it runs its stage wrappers (plain twins on the CPU): the
    bin sort (fp_bin_front: the two coarse passes, and the fine split where
    a coarse bin holds several fine bins), then the probe; returns the
    geometry, the fine bin starts and the pairs too."""
    n_buckets, bucket = fp_table.shape
    m = kw["length"] - K + 1
    g = probe.fp_bin_geometry(n_buckets, bucket, words.shape[0], m, CPU,
                              coarse_bins=coarse_bins,
                              rows_per_block=rows_per_block)
    buf = probe.FpScratch().buffers(CPU, g, words.shape[0] * m)
    trash = int(counts[-1])
    front = probe.fp_bin_front(counts, words, buf, g, k=K,
                               n_buckets=n_buckets, **kw)
    total = int(front.bin_start[-1])
    assert total + int(counts[-1]) - trash == words.shape[0] * m
    assert not buf.coarse_count.any()    # zero for the next batch
    skipped = g.n_coarse == g.n_bins     # each coarse bin is one fine bin
    assert probe.fp_split_needed(g) is not skipped
    assert (front.pairs is buf.coarse_pairs) is skipped
    assert (front.bin_start is buf.coarse_start) is skipped
    probe.fp_bin_probe(counts, front.pairs, front.bin_start, fp_table,
                       shift=g.shift)
    return g, front.bin_start, front.pairs[:total]


def _pair_keys(p):
    return torch.sort((p[:, 1].to(torch.int64) << 32)
                      | (p[:, 0].to(torch.int64) & 0xFFFFFFFF)).values


def _assert_fine_bins_hold_their_windows(g, bin_start, pairs, codes, *,
                                         n_buckets, seed, canonical=False):
    """bin_start is the plain scan of the valid windows' fine bins, and each
    fine bin's range holds exactly the multiset of its windows' pairs."""
    b, fp = probe.probe_prep_plain(torch.from_numpy(codes), k=K,
                                   n_buckets=n_buckets, seed=seed,
                                   canonical=canonical)
    ok = b >= 0
    want = torch.stack([fp[ok], b[ok]], 1)
    fine = (want[:, 1] >> g.shift).to(torch.int64)
    starts = torch.zeros(g.n_bins + 1, dtype=torch.int64)
    starts[1:] = torch.bincount(fine, minlength=g.n_bins).cumsum(0)
    assert torch.equal(bin_start.to(torch.int64), starts)
    order = torch.argsort(fine, stable=True)
    want, fine = want[order], fine[order]
    for i in torch.unique(fine).tolist():
        lo, hi = int(starts[i]), int(starts[i + 1])
        assert torch.equal(_pair_keys(pairs[lo:hi]),
                           _pair_keys(want[lo:hi])), i


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
def test_stages_equal_jax_and_plain(form, canonical, bucket, geometry):
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
    g, bin_start, pairs = _staged(got, words, table, rows_per_block=10,
                                  coarse_bins=GEOMETRIES[geometry][1], **kw)
    if geometry == "many_bins":
        assert g.n_coarse > 1 and g.n_bins > g.n_coarse
    else:    # the fine split is not run
        assert g.n_coarse == g.n_bins == OWN_COARSE_BINS[geometry][bucket]
    want = probe.count_fp_plain(torch.zeros_like(got), words, table, k=K,
                                **kw)
    assert torch.equal(got, want)
    jp = JaxPipeline(jkt, canonical=canonical, pallas=False,
                     packed_transfer=form != "codes")
    jp.add_batch(codes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jp.counts))
    assert int(got[:-1].sum()) > 1000 and int(got[-1]) > 1000
    _assert_fine_bins_hold_their_windows(g, bin_start, pairs, codes,
                                         n_buckets=fpt.n_buckets,
                                         seed=fpt.seed, canonical=canonical)


@pytest.mark.parametrize("form", ["vlen", "vbytes", "codes"])
def test_coarse_bins_hold_their_windows(form, geometry):
    """After the coarse scatter each coarse bin's range holds exactly the
    multiset of its valid windows, each block's run in its range in
    row-major order, and the coarse starts are the plain scan; after the
    fine split every fine bin holds its windows."""
    rng = np.random.default_rng(21)
    genome, keys = _keys(rng, 6000)
    fpt = FpTable.build(keys, k=K)
    table = fp_table_to_device(fpt, CPU).fp
    codes = _reads(rng, genome, 57, 130, 120)
    if form != "vlen":
        codes[::3, 50] = 4
    words, valid = _payload(codes, form)
    m = 130 - K + 1
    g = probe.fp_bin_geometry(fpt.n_buckets, fpt.bucket, 57, m, CPU,
                              coarse_bins=GEOMETRIES[geometry][1],
                              rows_per_block=7)
    buf = probe.FpScratch().buffers(CPU, g, 57 * m)
    kw = dict(length=130, k=K, seed=fpt.seed, n_buckets=fpt.n_buckets,
              coarse_shift=g.coarse_shift, rows_per_block=7, **valid)
    counts = torch.zeros(fpt.n_slots + 1, dtype=torch.int32)
    probe.fp_coarse_count(buf.coarse_count, buf.block_base, counts, words,
                          **kw)
    probe.fp_coarse_scatter(buf.coarse_pairs, buf.coarse_start,
                            buf.coarse_count, buf.block_base, words,
                            stage_cap=g.stage_cap, **kw)
    b, fp = probe.probe_prep_plain(torch.from_numpy(codes), k=K,
                                   n_buckets=fpt.n_buckets, seed=fpt.seed)
    ok = b >= 0
    assert int(counts[-1]) == int((~ok).sum())
    rows = torch.arange(57)[:, None].expand_as(b)[ok]
    want = torch.stack([fp[ok], b[ok]], 1)
    coarse = (want[:, 1] >> g.coarse_shift).to(torch.int64)
    starts = torch.zeros(g.n_coarse + 1, dtype=torch.int64)
    starts[1:] = torch.bincount(coarse, minlength=g.n_coarse).cumsum(0)
    assert torch.equal(buf.coarse_start.to(torch.int64), starts)
    for c in range(g.n_coarse):
        lo, hi = int(starts[c]), int(starts[c + 1])
        mine = coarse == c
        assert torch.equal(_pair_keys(buf.coarse_pairs[lo:hi]),
                           _pair_keys(want[mine]))
        for blk in torch.unique(rows[mine] // 7).tolist():
            start, n = buf.block_base[blk, :, c].tolist()
            assert torch.equal(buf.coarse_pairs[lo + start:lo + start + n],
                               want[mine & (rows // 7 == blk)])
    probe.fp_fine_split(buf.pairs, buf.bin_start, buf.coarse_count,
                        buf.coarse_pairs, buf.coarse_start, shift=g.shift,
                        coarse_shift=g.coarse_shift)
    n = int(starts[-1])
    _assert_fine_bins_hold_their_windows(g, buf.bin_start, buf.pairs[:n],
                                         codes, n_buckets=fpt.n_buckets,
                                         seed=fpt.seed)


@pytest.mark.parametrize("case", ["all_invalid", "vlen_zero", "short_reads",
                                  "one_row", "small_table"])
def test_stages_edge_batches(case):
    rng = np.random.default_rng(7)
    genome, keys = _keys(rng, 300 if case == "small_table" else 2000)
    fpt = FpTable.build(keys, k=K)
    table = fp_table_to_device(fpt, CPU).fp
    codes = _reads(rng, genome, 24, 90, 80)
    if case == "all_invalid":
        codes[:] = 4
    elif case == "vlen_zero":
        codes[::2] = 4
    elif case == "short_reads":
        codes[:, 20:] = 4
    elif case == "one_row":
        codes = codes[:1]
    words, valid = _payload(codes, "vlen")
    kw = dict(length=90, seed=fpt.seed, **valid)
    got = torch.zeros(fpt.n_slots + 1, dtype=torch.int32)
    g, bin_start, pairs = _staged(got, words, table, **kw)
    if case == "small_table":    # smaller than one coarse bin, one fine bin
        assert fpt.n_buckets < 1 << probe.fp_bin_geometry(
            1 << 20, 64, 24, 60, CPU).coarse_shift
        assert g.n_coarse == g.n_bins == 1
    want = probe.count_fp_plain(torch.zeros_like(got), words, table, k=K,
                                **kw)
    assert torch.equal(got, want)
    assert int(got.sum()) == codes.shape[0] * (90 - K + 1)
    if case in ("all_invalid", "short_reads"):
        assert int(got[-1]) == int(got.sum()) and pairs.shape[0] == 0
    _assert_fine_bins_hold_their_windows(g, bin_start, pairs, codes,
                                         n_buckets=fpt.n_buckets,
                                         seed=fpt.seed)


def test_pipeline_holds_one_scratch_across_batches():
    """CountPipeline keeps one FpScratch; coarse totals are zero between
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
    g = probe.FpGeometry(shift=2, coarse_shift=3, n_bins=8, n_coarse=4,
                         n_blocks=3, rows_per_block=2, stage_cap=100)
    buf = s.buffers(CPU, g, 100)
    assert [tuple(t.shape) for t in buf] == [
        (4,), (5,), (3, 2, 4), (100, 2), (9,), (100, 2)]
    buf.coarse_count.add_(1).zero_()
    again = s.buffers(CPU, g._replace(n_bins=4, n_coarse=2, n_blocks=2), 50)
    assert again.coarse_count.data_ptr() == buf.coarse_count.data_ptr()
    grown = s.buffers(CPU, g._replace(n_bins=32, n_coarse=16), 50)
    assert grown.coarse_count.shape == (16,) and not grown.coarse_count.any()


@pytest.mark.parametrize("n_buckets, bucket, shift, stride, n_coarse, cshift", [
    (1 << 20, 64, 8, 68, 256, 12),   # E. coli: 4,096 fine bins of 64 KiB
    (1 << 3, 64, 3, 68, 1, 3),       # a table smaller than one fine bin
    (1 << 12, 16, 10, 20, 4, 10),
    (1 << 10, 6, 10, 7, 1, 10),      # 16 B reads need bucket % 4 == 0
    (1 << 24, 64, 9, 0, 256, 16),    # 4 GiB: 32,768 bins, not staged
])
def test_bin_geometry(n_buckets, bucket, shift, stride, n_coarse, cshift):
    assert probe.fp_bin_shift(n_buckets, bucket) == shift
    assert n_buckets >> shift <= probe.MAX_BINS
    assert probe.fp_bin_stride(bucket, shift, bucket % 4 == 0) == stride
    g = probe.fp_bin_geometry(n_buckets, bucket, 65_536, 226, CPU)
    assert (g.shift, g.n_bins, g.n_coarse, g.coarse_shift) == (
        shift, n_buckets >> shift, n_coarse, cshift)
    assert g.n_coarse << (g.coarse_shift - g.shift) == g.n_bins
    per = g.rows_per_block
    assert g.n_blocks * per >= 65_536 > (g.n_blocks - 1) * per
    assert g.stage_cap == per * 226 <= probe.STAGE_PAIRS
    # reads too long for one row's windows to fit the staging buffer
    long = probe.fp_bin_geometry(n_buckets, bucket, 100, 20_000, CPU)
    assert long.rows_per_block == 1 and long.stage_cap == probe.STAGE_PAIRS


def test_stage_wrappers_reject_what_the_kernels_do_not_take():
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32)

    cc, bb, counts = zeros(4), zeros(2, 2, 4), zeros(8 * 4 + 1)
    words = zeros(4, 6)
    vlen = torch.zeros(4, dtype=torch.uint16)
    kw = dict(length=90, k=K, seed=0, n_buckets=8, coarse_shift=1,
              rows_per_block=2, vlen=vlen)
    with pytest.raises(ValueError):          # 8 >> 2 != 4 coarse bins
        probe.fp_coarse_count(cc, bb, counts, words, **dict(kw, coarse_shift=2))
    with pytest.raises(ValueError):          # 4 rows make 4 blocks of 1
        probe.fp_coarse_count(cc, bb, counts, words,
                              **dict(kw, rows_per_block=1))
    with pytest.raises(ValueError):          # coarse_start needs 5 entries
        probe.fp_coarse_scatter(zeros(10, 2), zeros(4), cc, bb, words,
                                stage_cap=8, **kw)
    with pytest.raises(ValueError):          # 4 coarse bins of 2 fine: 9
        probe.fp_fine_split(zeros(10, 2), zeros(8), cc, zeros(10, 2),
                            zeros(5), shift=0, coarse_shift=1)
    with pytest.raises(ValueError):          # counts of another table
        probe.fp_bin_probe(counts[:-1], zeros(1, 2), zeros(5), zeros(8, 4),
                           shift=1)
    with pytest.raises(ValueError):          # one coarse bin per thread
        probe.fp_bin_geometry(1 << 20, 64, 10, 60, CPU, coarse_bins=512)


def test_fp_bin_parity_of_the_plain_twins_is_zero(geometry, monkeypatch):
    """The card's per-kernel check (``fp_bin_parity``), run on CPU tensors,
    holds each plain twin against itself: every error is 0."""
    monkeypatch.setattr(probe, "COARSE_BINS", GEOMETRIES[geometry][1])
    rng = np.random.default_rng(11)
    genome, keys = _keys(rng, 3000)
    fpt = FpTable.build(keys, k=K)
    codes = _reads(rng, genome, 50, 96, 90)
    codes[::4, 30] = 4
    words, valid = _payload(codes, "vbytes")
    table = fp_table_to_device(fpt, CPU).fp
    g = probe.fp_bin_geometry(fpt.n_buckets, fpt.bucket, 50, 96 - K + 1, CPU)
    assert g.n_coarse == min(GEOMETRIES[geometry][1], g.n_bins)
    errs = probe.fp_bin_parity(words, table, length=96, k=K, seed=fpt.seed,
                               **valid)
    assert errs == dict.fromkeys(("fp_coarse_count_kernel",
                                  "fp_coarse_scatter_kernel",
                                  "fp_fine_split_kernel",
                                  "fp_bin_probe_kernel"), 0)


# the H100's block slots for fp_bin_probe_kernel: 132 multiprocessors x 3
# blocks at 69.6 KB of staged rows
SLOTS = 396


@pytest.mark.parametrize("n_bins", [1, 3, 16, 396, 4096])
def test_probe_parts_tile_each_bin(n_bins):
    """fp_bin_probe_kernel's work items, as its launcher cuts them
    (fp_probe_parts, fp_probe_slice): enough parts a bin that the items fill
    the card's block slots (one part where the bins alone fill them, the
    E. coli table's 4,096), and each bin's parts tile its window range in
    order with no gap or overlap, the slices within one window of each
    other in length, for ranges of 0, 1 and odd lengths."""
    parts = probe.fp_probe_parts(n_bins, SLOTS)
    assert parts == {1: 396, 3: 132, 16: 25, 396: 1, 4096: 1}[n_bins]
    assert n_bins * parts >= SLOTS and (parts == 1 or
                                        n_bins * (parts - 1) < SLOTS)
    lengths = [[0, 1, 7, 395, 70_001][i % 5] for i in range(n_bins)]
    if n_bins == 1:      # the union count's batch; int32's last range
        lengths = [4_587_520, 4_587_519, 2**31 - 1]
    for length in lengths:
        begin = 123_457
        lo_hi = [probe.fp_probe_slice(begin, begin + length, p, parts)
                 for p in range(parts)]
        assert lo_hi[0][0] == begin and lo_hi[-1][1] == begin + length
        assert all(a[1] == b[0] for a, b in zip(lo_hi, lo_hi[1:]))
        sizes = [hi - lo for lo, hi in lo_hi]
        assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
        assert sum(sizes) == length
