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

from strainscan_tpu_torch.bench.count import host_window_keys
from strainscan_tpu_torch.build.pipeline import build_database
from strainscan_tpu_torch.config import BuildConfig, IdentifyConfig
from strainscan_tpu_torch.identify.pipeline import run_identify
from strainscan_tpu_torch.index.hashtable import (FpTable, KmerTable,
                                                  fp_table_to_device,
                                                  kmer_table_to_device)
from strainscan_tpu_torch.kmer import pack
from strainscan_tpu_torch.kmer.device import from_u32
from strainscan_tpu_torch.ops import gather, probe
from strainscan_tpu_torch.parallel import (ShardedCountPipeline, ShardedTable,
                                           make_mesh, sharded_count)

from _torch_sim import (assert_reports_identical, mutate,  # noqa: F401
                        one_torch_thread, rand_genome, sim_reads, write_fa,
                        write_fq)

pytestmark = pytest.mark.cuda


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


FP_KERNELS = ("fp_bin_count_kernel", "bin_scan_kernel",
              "fp_bin_scatter_kernel", "fp_bin_probe_kernel")


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
    """The binned count_fp: its four kernels once each, the counts equal to
    count_fp_plain and to the host oracle, trash slot included."""
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
    assert {n: probe.LAUNCHES[n] - before[n] for n in FP_KERNELS} == \
        dict.fromkeys(FP_KERNELS, 1)
    assert torch.equal(c1, c2)
    assert np.array_equal(c1.cpu().numpy(), _host_oracle(fpt, codes))
    assert int(c1[:-1].sum()) > 100_000


FP_CASES = ["small_table", "bucket16", "bucket6", "canonical",
            "all_invalid", "vlen_zero", "mid_read_n", "codes", "unstaged",
            "bucket32", "one_row"]


@pytest.mark.parametrize("case", FP_CASES)
def test_count_fp_binned_kernels_equal_plain(dev, case, monkeypatch):
    """Each binned kernel against its plain twin (fp_bin_parity) and
    count_fp against count_fp_plain and the host oracle, on the edge cases
    of the design: a table smaller than one bin, bucket widths that are
    and are not multiples of four, canonical windows, all-invalid batches,
    rows of valid length 0, mid-read Ns, raw codes, bins too large for
    shared memory, a one-row batch."""
    rng = np.random.default_rng(FP_CASES.index(case))
    genome, keys = _genome_keys(rng, glen=1500 if case == "small_table"
                                else 20_000)
    bucket = {"bucket16": 16, "bucket6": 6, "bucket32": 32}.get(case, 64)
    fpt = FpTable.build(keys, k=31, bucket=bucket)
    if case == "small_table":
        assert fpt.n_buckets < 1 << probe.fp_bin_shift(1 << 20, 64)
    if case == "unstaged":          # 2 bins of 64 buckets x 256 B: 16 KiB
        monkeypatch.setattr(probe, "MAX_BINS", 2)
        monkeypatch.setattr(probe, "SLICE_BYTES", 1 << 12)
    form = {"mid_read_n": "vbytes", "codes": "codes"}.get(case, "vlen")
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
    kw = dict(length=160, k=31, seed=fpt.seed, canonical=canonical, **valid)
    errs = probe.fp_bin_parity(reads, table.fp, **kw)
    assert errs == dict.fromkeys(FP_KERNELS, 0)
    c1 = torch.zeros(fpt.n_slots + 1, dtype=torch.int32, device=dev)
    c2 = c1.clone()
    probe.count_fp(c1, reads, table.fp, **kw)
    probe.count_fp_plain(c2, reads, table.fp, **kw)
    torch.cuda.synchronize()
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
    before = probe.LAUNCHES["count_exact_kernel"]
    kw = dict(length=160, k=31, max_probe=kt.max_probe, canonical=canonical)
    probe.count_exact(c1, reads, table.table, **kw, **valid)
    probe.count_exact_plain(c2, reads, table.table, **kw, **valid)
    torch.cuda.synchronize()
    assert probe.LAUNCHES["count_exact_kernel"] == before + 1
    assert torch.equal(c1, c2)
    assert int(c1[:-1].sum()) > 100_000


@pytest.mark.parametrize("roww", [64, 128])
@pytest.mark.parametrize("tile,nbuf", [(2048, 8), (2048, 16), (8192, 16),
                                       (32, 32), (16384, 1)])
def test_row_gather_kernel_equals_plain(dev, roww, tile, nbuf):
    """Shared memory above the default 48 KiB at tile 16384; a tail of
    indices past the last whole tile; repeated and out-of-range rows."""
    rng = np.random.default_rng(tile + nbuf + roww)
    table = torch.from_numpy(rng.integers(0, 1 << 32, size=(4099, roww),
                                          dtype=np.uint32).view(np.int32))
    idx = rng.integers(0, 4099, size=3 * 16384 + 77, dtype=np.int32)
    idx[::5] = idx[0]
    idx[1::997] = -3
    idx[2::991] = 4099
    table, idx = table.to(dev), torch.from_numpy(idx).to(dev)
    before = probe.LAUNCHES["row_gather_kernel"]
    got = gather.row_gather_xor(table, idx, tile=tile, nbuf=nbuf)
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
