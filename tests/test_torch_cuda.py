"""The CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere
(the CUDA kernels have no CPU mode).  Run them on a GPU host with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (tests/conftest.py
imports jax, which a GPU host need not have).

Tolerance: none; buckets, fingerprints and counts are integers and must
be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from strainscan_tpu.build.pipeline import build_database
from strainscan_tpu.config import BuildConfig, IdentifyConfig
from strainscan_tpu.index.hashtable import FpTable, KmerTable
from strainscan_tpu.kmer import pack
from strainscan_tpu_torch.index.hashtable import (fp_table_to_device,
                                                  kmer_table_to_device)
from strainscan_tpu_torch.kmer.device import from_u32
from strainscan_tpu_torch.ops import probe
from strainscan_tpu_torch.identify.pipeline import run_identify
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


@pytest.mark.parametrize("form", ["vlen", "vbytes", "codes"])
def test_count_fp_kernel_equals_plain(dev, form):
    rng = np.random.default_rng(1)
    genome, keys = _genome_keys(rng)
    fpt = FpTable.build(keys, k=31)
    table = fp_table_to_device(fpt, dev)
    _, reads, valid = _batch(rng, genome, form)
    reads = reads.to(dev)
    valid = {f: v.to(dev) for f, v in valid.items()}
    c1 = torch.zeros(fpt.n_slots + 1, dtype=torch.int32, device=dev)
    c2 = c1.clone()
    probe.count_fp(c1, reads, table.fp, length=160, k=31, seed=fpt.seed,
                   **valid)
    probe.count_fp_plain(c2, reads, table.fp, length=160, k=31,
                         seed=fpt.seed, **valid)
    torch.cuda.synchronize()
    assert torch.equal(c1, c2)
    assert int(c1[:-1].sum()) > 100_000


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
    before = probe.LAUNCHES["count_fp_kernel"]
    pipe = ShardedCountPipeline(keys, k=31, mesh=mesh)
    pipe.add_batch(codes)
    pipe.add_batch(codes[:77])
    assert probe.LAUNCHES["count_fp_kernel"] == before + 2 * mesh.size
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
    before = probe.LAUNCHES["count_fp_kernel"]
    assert run_identify(fq, "", db, outn, mesh, dataclasses.replace(
        cfg, shard_min_kmers=1, shard_min_l2_rows=1))
    launched = probe.LAUNCHES["count_fp_kernel"] - before
    assert launched > 0 and launched % mesh.size == 0
    got = assert_reports_identical(outn, out1)
    assert any(n.endswith("StrainVote.report") for n in got)
