"""The CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere
(the CUDA kernels have no CPU mode).  Run them on a GPU host with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (tests/conftest.py
imports jax, which a GPU host need not have); they import only the port.

Tolerance: none; buckets, fingerprints and counts are integers and must
be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from strainscan_tpu_torch.bench import fetch_study
from strainscan_tpu_torch.bench.count import host_window_keys
from strainscan_tpu_torch.build.pipeline import build_database
from strainscan_tpu_torch.config import BuildConfig, IdentifyConfig
from strainscan_tpu_torch.identify.pipeline import run_identify
from strainscan_tpu_torch.index.hashtable import (FpTable, KmerTable,
                                                  fp_table_to_device,
                                                  kmer_table_to_device)
from strainscan_tpu_torch.kmer import pack
from strainscan_tpu_torch.kmer.device import from_u32
from strainscan_tpu_torch.ops.count import CountPipeline
from strainscan_tpu_torch.ops import count as ops_count
from strainscan_tpu_torch.ops import gather, probe
from strainscan_tpu_torch.parallel import (ShardedCountPipeline, ShardedTable,
                                           make_mesh, sharded_count)

from _torch_sim import (EXACT_EDGES, assert_reports_identical,  # noqa: F401
                        exact_edge, exact_forms, mutate, one_torch_thread,
                        rand_genome, sim_reads, write_fa, write_fq)

pytestmark = pytest.mark.cuda

EXACT_KERNELS = ("count_exact_kernel", "exact_apply_kernel")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture
def gpus():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices (a multi-GPU mesh)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.parametrize("k", [31, 21, 16, 15])
@pytest.mark.parametrize("canonical", [False, True])
def test_probe_prep_kernel_equals_plain(dev, k, canonical):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(1027, 150)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.05] = 4
    cd = torch.from_numpy(codes).to(dev)
    before = probe.LAUNCHES["probe_prep_kernel"]
    got = probe.probe_prep(cd, k=k, n_buckets=1 << 16, seed=5,
                           canonical=canonical)
    want = probe.probe_prep_plain(cd, k=k, n_buckets=1 << 16, seed=5,
                                  canonical=canonical)
    torch.cuda.synchronize()
    assert probe.LAUNCHES["probe_prep_kernel"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


PREP_CASES = ["padded", "tail", "few_rows", "unaligned_view", "long_reads"]


@pytest.mark.parametrize("k", [31, 15])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("case", PREP_CASES)
def test_probe_prep_kernel_edges_equal_plain(dev, case, k, canonical):
    """Reads of 150 bp padded to L = 256; a B x M that is not a multiple
    of 4 (the 16 B stores' scalar tail); fewer rows than a block; a view
    whose first row does not start on 16 B; reads long enough that a block
    takes fewer rows."""
    rng = np.random.default_rng(PREP_CASES.index(case) + k)
    rows, length = {"padded": (1027, 256), "tail": (5, 256),
                    "few_rows": (3, 150), "unaligned_view": (1028, 150),
                    "long_reads": (37, 3000)}[case]
    codes = np.full((rows, length), 4, np.uint8)
    n = min(length, 150) if case != "long_reads" else length
    codes[:, :n] = rng.integers(0, 4, size=(rows, n))
    codes[rng.random(codes.shape) < 0.02] = 4
    cd = torch.from_numpy(codes).to(dev)
    if case == "unaligned_view":
        cd = cd[1:]
        assert cd.is_contiguous() and cd.data_ptr() % 16
    kw = dict(k=k, n_buckets=1 << 16, seed=5, canonical=canonical)
    got = probe.probe_prep(cd, **kw)
    want = probe.probe_prep_plain(cd, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("case", EXACT_EDGES)
def test_count_exact_kernel_edges_equal_plain(dev, case, canonical):
    """The exact count's edge batches (tests/_torch_sim.py::exact_edge), in
    every payload form, against count_exact_plain, also with the add stage
    over slices of 256 ids, and each of its two kernels against what it
    must compute (exact_parity); the "unaligned" batch also as views whose
    payload spans start and end off 16 B, "long_reads" at L = 5,000."""
    table, codes = exact_edge(case)
    tab = kmer_table_to_device(table, dev).table
    length = codes.shape[1]
    for name, (reads, valid) in exact_forms(codes).items():
        reads = reads.to(dev)
        valid = {f: v.to(dev) for f, v in valid.items()}
        views = [(reads, valid)]
        if case == "unaligned":
            views.append((reads[3:], {f: v[3:] for f, v in valid.items()}))
            assert reads[3:].data_ptr() % 16
        for rd, vd in views:
            kw = dict(length=length, k=31, max_probe=table.max_probe,
                      canonical=canonical, **vd)
            want = torch.zeros(table.n_keys + 1, dtype=torch.int32,
                               device=dev)
            probe.count_exact_plain(want, rd, tab, **kw)
            got = torch.zeros_like(want)
            before = {n: probe.LAUNCHES[n] for n in EXACT_KERNELS}
            probe.count_exact(got, rd, tab, **kw)
            torch.cuda.synchronize()
            assert {n: probe.LAUNCHES[n] - before[n]
                    for n in EXACT_KERNELS} == dict.fromkeys(EXACT_KERNELS, 1)
            assert torch.equal(got, want), (name, rd.shape)
            assert int(want.sum()) == rd.shape[0] * (length - 30)
            # the add stage over many slices of the id space
            sliced = torch.zeros_like(want)
            probe.exact_apply(sliced, *probe.exact_probe(sliced, rd, tab, **kw),
                              slice_ids=256)
            assert torch.equal(sliced, want), (name, rd.shape)
            stage = probe.exact_parity(rd, tab, table.n_keys, slice_ids=256,
                                       **kw)
            assert not any(stage.values()), (name, stage)


def test_exact_counts_repeat_at_smoke_scale(dev):
    """The exact count's hit list is in an order that varies from run to
    run; its counts may not.  At chip_smoke.py's size (a seeded 14.3 Mb
    genome's 28.6 M keys; 1.2 M reads of 150 bp, 5 % random, 5 % with a
    mid-read N) the sharded count (raw codes on a 2 x 2 mesh of this card,
    two shards at max_probe 2) and the single-device count_exact (raw
    codes in one launch, and vbytes batches of 65,536 reads padded to
    L = 256, as the exact stream ships them) are each run REPEAT times and
    held against count_exact_plain."""
    from strainscan_tpu_torch.kmer import device as kdev

    repeat = 4
    rng = np.random.default_rng(0)
    glen, n_reads, rlen = 14_300_000, 1_200_000, 150
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    hi, lo, _ = kdev.extract_kmers(torch.from_numpy(genome[None]).to(dev), 31)
    rhi, rlo = kdev.revcomp(hi, lo, 31)
    keys = torch.unique(torch.cat([(hi << 32 | lo).ravel(),
                                   (rhi << 32 | rlo).ravel()]))
    keys = keys.cpu().numpy().view(np.uint64)
    starts = rng.integers(0, glen - rlen, size=n_reads)
    reads = genome[starts[:, None] + np.arange(rlen)[None, :]]
    flips = rng.random(n_reads) < 0.5
    reads[flips] = (3 - reads[flips])[:, ::-1]
    reads[: n_reads // 20] = rng.integers(0, 4, size=(n_reads // 20, rlen))
    reads[-n_reads // 20:, 70] = 4
    kt = KmerTable.build(keys, k=31)
    tab = kmer_table_to_device(kt, dev).table
    codes = torch.from_numpy(reads).to(dev)
    kw = dict(k=31, max_probe=kt.max_probe)
    want = torch.zeros(kt.n_keys + 1, dtype=torch.int32, device=dev)
    probe.count_exact_plain(want, codes, tab, length=rlen, **kw)
    assert int(want[:-1].sum()) > 0.8 * n_reads * (rlen - 30)
    batches = []
    for i in range(0, n_reads, 65_536):
        padded = np.full((min(65_536, n_reads - i), 256), 4, np.uint8)
        padded[:, :rlen] = reads[i:i + 65_536]
        words, vbytes = pack.bitpack_codes(padded)
        batches.append((from_u32(words).to(dev),
                        torch.from_numpy(vbytes).to(dev)))
    st = ShardedTable.build(keys, k=31, n_shards=2)
    assert st.max_probe == 2
    mesh = make_mesh([dev] * 4)

    def check(got, what):
        diff = torch.nonzero(got[:kt.n_keys] != want[:-1]).ravel().cpu()
        assert diff.numel() == 0, (
            f"{what}: {diff.numel()} ids differ (per shard "
            f"{np.bincount(diff.numpy() // st.shard_cap).tolist()}, first "
            f"{diff[:8].tolist()})")

    for rep in range(repeat):
        check(sharded_count(mesh, st, reads), f"sharded_count run {rep}")
        one = torch.zeros_like(want)
        probe.count_exact(one, codes, tab, length=rlen, **kw)
        check(one, f"count_exact (codes) run {rep}")
        assert int(one[-1]) == int(want[-1])
        one.zero_()
        for words, vbytes in batches:
            probe.count_exact(one, words, tab, length=256, vbytes=vbytes, **kw)
        check(one, f"count_exact (vbytes, L = 256) run {rep}")


def _genome_keys(rng, glen=20_000):
    genome = rng.integers(0, 4, size=glen).astype(np.uint8)
    km, _ = pack.pack_kmers(genome, 31)
    return genome, np.unique(np.concatenate([km, pack.revcomp_packed(km, 31)]))


def _batch(rng, genome, form, rows=3001, length=160):
    """A read batch as device tensors (reads, {form: validity})."""
    codes = np.full((rows, length), 4, np.uint8)
    for i in range(rows):
        s = int(rng.integers(0, genome.size - 150))
        codes[i, :150] = genome[s:s + 150]
    codes[:50] = codes[0]          # repeated reads: contended atomics
    codes[-40:, :150] = rng.integers(0, 4, size=(40, 150))   # misses
    if form == "codes":
        return codes, torch.from_numpy(codes), {}
    if form == "vbytes":
        codes[::5, 77] = 4
        words, valid = pack.bitpack_codes(codes)
    else:
        words, _ = pack.bitpack_codes(codes)
        valid = pack.valid_prefix_lens(codes)
    return codes, from_u32(words), {form: torch.from_numpy(valid)}


FP_KERNELS = ("fp_coarse_count_kernel", "fp_coarse_scatter_kernel",
              "fp_fine_split_kernel", "fp_bin_probe_kernel")


def _host_oracle(fpt, codes, canonical=False):
    """Slot counts of a batch by FpTable.lookup_host + bincount, the trash
    slot holding every window that is invalid or misses."""
    keys, valid = host_window_keys(codes, 31)
    q = keys[valid]
    if canonical:
        q = pack.canonical_packed(q, 31)
    slots = fpt.lookup_host(q)
    want = np.bincount(slots[slots >= 0], minlength=fpt.n_slots + 1)
    want[-1] = keys.size - int((slots >= 0).sum())
    return want


@pytest.mark.parametrize("form", ["vlen", "vbytes", "codes"])
def test_count_fp_kernel_equals_plain(dev, form):
    """The binned count_fp: its kernels once each (the passes of the bin
    sort and the probe; the fine split only where a coarse bin holds
    several fine bins, which this 8-bin table's do not), the counts equal
    to count_fp_plain and to the host oracle, trash slot included."""
    rng = np.random.default_rng(1)
    genome, keys = _genome_keys(rng)
    fpt = FpTable.build(keys, k=31)
    table = fp_table_to_device(fpt, dev)
    codes, reads, valid = _batch(rng, genome, form)
    reads = reads.to(dev)
    valid = {f: v.to(dev) for f, v in valid.items()}
    c1 = torch.zeros(fpt.n_slots + 1, dtype=torch.int32, device=dev)
    c2 = c1.clone()
    before = {n: probe.LAUNCHES[n] for n in FP_KERNELS}
    probe.count_fp(c1, reads, table.fp, length=160, k=31, seed=fpt.seed,
                   **valid)
    probe.count_fp_plain(c2, reads, table.fp, length=160, k=31,
                         seed=fpt.seed, **valid)
    torch.cuda.synchronize()
    g = probe.fp_bin_geometry(fpt.n_buckets, fpt.bucket, reads.shape[0],
                              130, dev)
    assert g.n_bins == 8 and not probe.fp_split_needed(g)
    assert {n: probe.LAUNCHES[n] - before[n] for n in FP_KERNELS} == {
        **dict.fromkeys(FP_KERNELS, 1), "fp_fine_split_kernel": 0}
    assert torch.equal(c1, c2)
    assert np.array_equal(c1.cpu().numpy(), _host_oracle(fpt, codes))
    assert int(c1[:-1].sum()) > 100_000


FP_CASES = ["small_table", "bucket16", "bucket6", "canonical",
            "all_invalid", "vlen_zero", "mid_read_n", "codes", "unstaged",
            "bucket32", "one_row", "coarse8", "unstaged_blocks",
            "rows_per_block", "union_one_bin", "few_bins", "parts_unstaged"]


def _union_batch(rng, rows, n_keys=7_400):
    """The L2 union count's shape: a table of n_keys of a 200 kb genome's
    keys (7,400: 256 buckets x 64, one bin) and rows reads of 100 bp of it,
    half reverse-complemented, padded to L = 256, as vlen; the codes, the
    table, the reads and their validity."""
    genome, keys = _genome_keys(rng, glen=200_000)
    fpt = FpTable.build(np.sort(rng.choice(keys, n_keys, replace=False)),
                        k=31)
    starts = rng.integers(0, genome.size - 100, size=rows)
    codes = np.full((rows, 256), 4, np.uint8)
    codes[:, :100] = genome[starts[:, None] + np.arange(100)]
    flips = rng.random(rows) < 0.5
    codes[flips, :100] = (3 - codes[flips, :100])[:, ::-1]
    words, _ = pack.bitpack_codes(codes)
    return codes, fpt, from_u32(words), {
        "vlen": torch.from_numpy(pack.valid_prefix_lens(codes))}


@pytest.mark.parametrize("case", FP_CASES)
def test_count_fp_binned_kernels_equal_plain(dev, case, monkeypatch):
    """Each binned kernel against its plain twin (fp_bin_parity) and
    count_fp against count_fp_plain and the host oracle, on the edge cases
    of the design: a table smaller than one bin (and one coarse bin),
    bucket widths that are and are not multiples of four, canonical
    windows, all-invalid batches, rows of valid length 0, mid-read Ns, raw
    codes, bins too large for shared memory, a one-row batch, 8 coarse bins
    of many fine bins, blocks with more windows than their staging buffer
    (each pair written on its own), one row per block; the L2 union count's
    shape (one bin of 256 x 64 and 65,536 reads of 100 bp at L = 256: no
    fine split, the bin's windows cut into as many parts as the card has
    block slots), 16 bins each its own coarse bin (no fine split), and
    parts too short to stage their bin's rows."""
    rng = np.random.default_rng(FP_CASES.index(case))
    length, windows = 160, 130
    union = case in ("union_one_bin", "parts_unstaged")
    if union:
        rows = 65_536 if case == "union_one_bin" else 100
        codes, fpt, reads, valid = _union_batch(rng, rows)
        length, windows = 256, 226
        bucket = fpt.bucket
        assert (fpt.n_buckets, bucket) == (256, 64)
        if case == "parts_unstaged":   # < 128 windows a part, however many
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            assert rows * 70 // probe.fp_probe_parts(1, sms) < 128
    else:
        genome, keys = _genome_keys(rng, glen={
            "small_table": 1500, "few_bins": 50_000}.get(case, 20_000))
        bucket = {"bucket16": 16, "bucket6": 6, "bucket32": 32}.get(case, 64)
        fpt = FpTable.build(keys, k=31, bucket=bucket)
    if case == "small_table":
        assert fpt.n_buckets < 1 << probe.fp_bin_shift(1 << 20, 64)
    if case == "unstaged":          # 2 bins of 64 buckets x 256 B: 16 KiB
        monkeypatch.setattr(probe, "MAX_BINS", 2)
        monkeypatch.setattr(probe, "SLICE_BYTES", 1 << 12)
    if case == "coarse8":           # 128 fine bins of 4 KiB, 8 coarse bins
        monkeypatch.setattr(probe, "COARSE_BINS", 8)
        monkeypatch.setattr(probe, "SLICE_BYTES", 1 << 12)
    if case == "unstaged_blocks":   # a block stages 64 of its ~121 pairs
        monkeypatch.setattr(probe, "STAGE_PAIRS", 64)
    if case == "rows_per_block":    # one row per block: 3,001 blocks
        monkeypatch.setattr(probe, "STAGE_PAIRS", 130)
    form = {"mid_read_n": "vbytes", "codes": "codes"}.get(case, "vlen")
    if not union:
        codes, reads, valid = _batch(rng, genome, form)
    if case in ("all_invalid", "vlen_zero", "one_row"):
        if case == "one_row":
            codes = codes[:1]
        else:
            codes[::1 if case == "all_invalid" else 3] = 4
        words, _ = pack.bitpack_codes(codes)
        reads = from_u32(words)
        valid = {"vlen": torch.from_numpy(pack.valid_prefix_lens(codes))}
    reads = reads.to(dev)
    valid = {f: v.to(dev) for f, v in valid.items()}
    canonical = case == "canonical"
    table = fp_table_to_device(fpt, dev)
    if case == "unstaged":
        assert probe.fp_bin_stride(bucket, probe.fp_bin_shift(
            fpt.n_buckets, bucket), True) == 0
    g = probe.fp_bin_geometry(fpt.n_buckets, bucket, reads.shape[0],
                              windows, dev)
    if case == "coarse8":
        assert (g.n_coarse, g.n_bins) == (8, 128)
    if case == "unstaged_blocks":
        assert (g.rows_per_block, g.stage_cap) == (1, 64)
    if case == "rows_per_block":
        assert (g.rows_per_block, g.stage_cap) == (1, 130)
    if case in ("union_one_bin", "few_bins", "parts_unstaged"):
        assert g.n_bins == g.n_coarse == (16 if case == "few_bins" else 1)
    kw = dict(length=length, k=31, seed=fpt.seed, canonical=canonical,
              **valid)
    errs = probe.fp_bin_parity(reads, table.fp, **kw)
    assert errs == dict.fromkeys(FP_KERNELS, 0)
    c1 = torch.zeros(fpt.n_slots + 1, dtype=torch.int32, device=dev)
    c2 = c1.clone()
    before = {n: probe.LAUNCHES[n] for n in FP_KERNELS}
    probe.count_fp(c1, reads, table.fp, **kw)
    launched = {n: probe.LAUNCHES[n] - before[n] for n in FP_KERNELS}
    probe.count_fp_plain(c2, reads, table.fp, **kw)
    torch.cuda.synchronize()
    # the fine split only where a coarse bin holds several fine bins
    assert launched == {**dict.fromkeys(FP_KERNELS, 1),
                        "fp_fine_split_kernel": int(probe.fp_split_needed(g))}
    assert torch.equal(c1, c2)
    assert np.array_equal(c1.cpu().numpy(),
                          _host_oracle(fpt, codes, canonical))
    if case == "all_invalid":
        assert int(c1[-1]) == int(c1.sum()) == 3001 * (160 - 31 + 1)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("form", ["vlen", "vbytes", "codes"])
def test_count_exact_kernel_equals_plain(dev, form, canonical):
    rng = np.random.default_rng(2)
    genome, keys = _genome_keys(rng)
    # load factor 0.9: overflowing buckets make max_probe > 1
    kt = KmerTable.build(keys[::2] if canonical else keys, k=31,
                         load_factor=0.9)
    assert kt.max_probe > 1
    table = kmer_table_to_device(kt, dev)
    codes, reads, valid = _batch(rng, genome, form)
    reads = reads.to(dev)
    valid = {f: v.to(dev) for f, v in valid.items()}
    c1 = torch.zeros(kt.n_keys + 1, dtype=torch.int32, device=dev)
    c2 = c1.clone()
    before = {n: probe.LAUNCHES[n] for n in EXACT_KERNELS}
    kw = dict(length=160, k=31, max_probe=kt.max_probe, canonical=canonical)
    probe.count_exact(c1, reads, table.table, **kw, **valid)
    probe.count_exact_plain(c2, reads, table.table, **kw, **valid)
    torch.cuda.synchronize()
    assert all(probe.LAUNCHES[n] == before[n] + 1 for n in EXACT_KERNELS)
    assert torch.equal(c1, c2)
    assert int(c1[:-1].sum()) > 100_000


# (roww, tile, nbuf, chunk_rows): the study's configurations and odd ones
# at the plan's chunks; many chunks with a ragged last one; the exact
# study's 96 B rows; tiles at and near MAX_TILE (entries in pieces)
GATHER_CASES = [(roww, tile, nbuf, None) for roww in (64, 128)
                for tile, nbuf in ((2048, 8), (2048, 16), (8192, 16), (32, 32),
                                   (16384, 1))] + [
    (128, 2048, 16, 300), (64, 8192, 16, 1000), (128, 16384, 1, 300),
    (24, 2048, 16, None), (24, 8192, 16, None), (24, 2048, 8, 300),
    (128, gather.MAX_TILE, 32, None), (64, 57344, 1, 500)]


@pytest.mark.parametrize("roww,tile,nbuf,chunk_rows", GATHER_CASES)
def test_row_gather_kernel_equals_plain(dev, roww, tile, nbuf, chunk_rows):
    """One launch per call; shared memory above the default 48 KiB; a tail
    of indices past the last whole tile; repeated and out-of-range rows."""
    rng = np.random.default_rng(tile + nbuf + roww)
    table = torch.from_numpy(rng.integers(0, 1 << 32, size=(4099, roww),
                                          dtype=np.uint32).view(np.int32))
    idx = rng.integers(0, 4099, size=max(3 * 16384, 2 * tile) + 77,
                       dtype=np.int32)
    idx[::5] = idx[0]
    idx[1::997] = -3
    idx[2::991] = 4099
    table, idx = table.to(dev), torch.from_numpy(idx).to(dev)
    plan = gather.plan_for(table, idx, tile=tile, nbuf=nbuf,
                           chunk_rows=chunk_rows)
    if chunk_rows is not None:
        assert plan.n_chunks == -(-4099 // chunk_rows) > 1
    before = probe.LAUNCHES["row_gather_kernel"]
    got = gather.row_gather_xor(table, idx, tile=tile, nbuf=nbuf,
                                chunk_rows=chunk_rows)
    want = gather.row_gather_xor_plain(table, idx, tile=tile, nbuf=nbuf)
    torch.cuda.synchronize()
    assert probe.LAUNCHES["row_gather_kernel"] == before + 1
    assert got.shape == ((idx.shape[0] // tile) * nbuf, roww)
    assert torch.equal(got, want)


def test_entry_cuda_equals_cpu(dev):
    from strainscan_tpu_torch import entry

    fn, args = entry.entry(dev)
    got = fn(*args)
    want_fn, want_args = entry.entry("cpu")
    want = want_fn(*want_args)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def _mesh_counts_equal_single_device(dev, mesh):
    """The sharded exact count and the sharded fp pipeline on ``mesh``
    equal the single-device counts on ``dev``."""
    rng = np.random.default_rng(3)
    genome, keys = _genome_keys(rng)
    codes, _, _ = _batch(rng, genome, "codes", rows=1001)
    kt = KmerTable.build(keys, k=31)
    single = torch.zeros(kt.n_keys + 1, dtype=torch.int32, device=dev)
    probe.count_exact(single, torch.from_numpy(codes).to(dev),
                      kmer_table_to_device(kt, dev).table, length=160, k=31,
                      max_probe=kt.max_probe)
    st = ShardedTable.build(keys, k=31, n_shards=mesh.shape["index"])
    got = sharded_count(mesh, st, codes)
    torch.cuda.synchronize()
    assert got.device == mesh.first
    assert torch.equal(got[:kt.n_keys].to(dev), single[:-1])
    before = probe.LAUNCHES["fp_bin_probe_kernel"]
    pipe = ShardedCountPipeline(keys, k=31, mesh=mesh)
    pipe.add_batch(codes)
    pipe.add_batch(codes[:77])
    assert probe.LAUNCHES["fp_bin_probe_kernel"] == before + 2 * mesh.size
    assert np.array_equal(pipe.finish(), 2 * single[:-1].cpu().numpy()
                          - _count_rows(kt, dev, codes[77:]))


def _count_rows(kt, dev, codes):
    c = torch.zeros(kt.n_keys + 1, dtype=torch.int32, device=dev)
    probe.count_exact(c, torch.from_numpy(np.ascontiguousarray(codes)).to(dev),
                      kmer_table_to_device(kt, dev).table, length=160, k=31,
                      max_probe=kt.max_probe)
    return c[:-1].cpu().numpy()


def test_single_gpu_2x2_mesh_counts_equal_single_device(dev):
    """Four positions on one card."""
    mesh = make_mesh([dev] * 4)
    assert mesh.shape == {"data": 2, "index": 2}
    _mesh_counts_equal_single_device(dev, mesh)


@pytest.mark.parametrize("index_shards", [None, 1])
def test_multi_gpu_mesh_counts_equal_single_device(gpus, index_shards):
    """Every visible GPU: the sums and gathers cross devices."""
    mesh = make_mesh(gpus, index_shards=index_shards)
    assert len(set(mesh.devices)) == len(gpus) > 1
    _mesh_counts_equal_single_device(gpus[0], mesh)


def test_multi_gpu_identify_equals_single_device(gpus, tmp_path):
    """A 2-strain cluster identified on every visible GPU, the sharded count
    and the L2 mesh route both on, byte-identical to one GPU."""
    rng = np.random.default_rng(34)
    gdir = tmp_path / "genomes"
    gdir.mkdir()
    base = rand_genome(rng, 30_000)
    strains = {"A1": base, "A2": mutate(rng, base, 15),
               "B1": rand_genome(rng, 30_000)}
    for name, seq in strains.items():
        write_fa(gdir / f"{name}.fa", name, seq)
    db = str(tmp_path / "DB")
    build_database(str(gdir), db, BuildConfig())
    fq = str(tmp_path / "mix.fq")
    write_fq(fq, sim_reads(rng, strains["A1"], 6.0)
             + sim_reads(rng, strains["A2"], 6.0))
    cfg = IdentifyConfig(min_snv_num=10)
    out1, outn = str(tmp_path / "one"), str(tmp_path / "mesh")
    assert run_identify(fq, "", db, out1, gpus[0], cfg)
    mesh = make_mesh(gpus)
    before = probe.LAUNCHES["fp_bin_probe_kernel"]
    assert run_identify(fq, "", db, outn, mesh, dataclasses.replace(
        cfg, shard_min_kmers=1, shard_min_l2_rows=1))
    launched = probe.LAUNCHES["fp_bin_probe_kernel"] - before
    assert launched > 0 and launched % mesh.size == 0
    got = assert_reports_identical(outn, out1)
    assert any(n.endswith("StrainVote.report") for n in got)


@pytest.mark.parametrize("route,vb", fetch_study.ROUTES)
def test_fetch_counts_route_on_the_card(dev, route, vb):
    """Each route of fetch_counts at identify-ecoli's 28,588,812 ids,
    bit-exact against .cpu() of the same tensor."""
    t = torch.from_numpy(fetch_study.route_vector(
        route, vb, fetch_study.N_IDS)).to(dev)
    ops_count.reset_fetches()
    got = ops_count.fetch_counts(t, t.numel())
    assert np.array_equal(got, t.cpu().numpy())
    (rec,) = ops_count.FETCHES
    assert (rec.route, rec.vb) == (("dense", 1) if route == "zeros"
                                   else (route, vb))


@pytest.mark.parametrize("rows", [20, 3001])
def test_fp_finish_on_the_card_equals_cpu(dev, rows):
    """The fp finish on the card, sparse (20 reads) and dense (3,001),
    equal to the CPU pipeline's on the same batch and by the same route;
    slot_of_id is uploaded only by the dense finish."""
    rng = np.random.default_rng(41)
    genome, keys = _genome_keys(rng)
    starts = rng.integers(0, genome.size - 150, size=rows)
    codes = np.full((rows, 160), 4, np.uint8)
    codes[:, :150] = genome[starts[:, None] + np.arange(150)]
    fpt = FpTable.build(keys, k=31)
    ops_count.reset_fetches()
    got = []
    for d in (dev, torch.device("cpu")):
        pipe = CountPipeline(fpt, d)
        pipe.add_batch(codes)
        got.append(pipe.finish())
        assert pipe.table.has_slot_of_id == (rows > 20)
    assert np.array_equal(got[0], got[1]) and got[0].sum() > 0
    card, cpu = ops_count.FETCHES
    assert card.soi_uploaded == (rows > 20)
    assert card._replace(s=0, soi_uploaded=0) == cpu._replace(
        s=0, soi_uploaded=0)
    assert card.route == ("sparse" if rows == 20 else "dense")
