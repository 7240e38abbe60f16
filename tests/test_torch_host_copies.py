"""The port's own host modules against the JAX package's originals.

The port owns copies of ``config``, ``kmer.pack``, ``native``, ``io.fastx``,
``utils``, the host half of ``index.hashtable``, ``build.*``,
``identify.cst_search`` and ``identify.low_depth``.  Here:

* a DB built by the port is byte-identical, file by file, to the JAX
  package's DB of the same genomes (standard and memory-efficient), and so
  is its reference-layout export;
* ``fastx``, ``pack``, the ``KmerTable``/``FpTable`` builders (native and
  NumPy) and ``build_fp_shards`` give equal arrays on seeded inputs, and
  the tables save to byte-identical files;
* ``cst_search`` and ``low_depth`` give equal results on one DB.

Tolerance: none; every output is integers, strings or bytes, and the
floats of the CST search are computed by the same code in the same order.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from strainscan_tpu import native as jnative
from strainscan_tpu.build import convert as jconvert
from strainscan_tpu.build import db as jdb
from strainscan_tpu.build.pipeline import build_database as jbuild
from strainscan_tpu.config import BuildConfig as JBuildConfig
from strainscan_tpu.config import IdentifyConfig as JIdentifyConfig
from strainscan_tpu.identify import cst_search as jcst
from strainscan_tpu.identify import low_depth as jlow
from strainscan_tpu.index import hashtable as jht
from strainscan_tpu.io import fastx as jfastx
from strainscan_tpu.kmer import pack as jpack
from strainscan_tpu_torch import native as tnative
from strainscan_tpu_torch.build import convert as tconvert
from strainscan_tpu_torch.build import db as tdb
from strainscan_tpu_torch.build.pipeline import build_database as tbuild
from strainscan_tpu_torch.config import BuildConfig, IdentifyConfig
from strainscan_tpu_torch.identify import cst_search as tcst
from strainscan_tpu_torch.identify import low_depth as tlow
from strainscan_tpu_torch.index import hashtable as tht
from strainscan_tpu_torch.io import fastx as tfastx
from strainscan_tpu_torch.kmer import pack as tpack
from strainscan_tpu_torch.ops.count import pack_payload

from _torch_sim import e2e_fixture, report_tree, write_fq

K = 31


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_copies")
    return (d, *e2e_fixture(d))   # the DB is the port's build


def _assert_trees_identical(got_dir, want_dir):
    got, want = report_tree(got_dir), report_tree(want_dir)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    return got


def test_configs_are_equal():
    assert BuildConfig() == BuildConfig(**vars(JBuildConfig()))
    assert IdentifyConfig() == IdentifyConfig(**vars(JIdentifyConfig()))
    assert IdentifyConfig(low_dep=2).ladder() == \
        JIdentifyConfig(low_dep=2).ladder()


@pytest.mark.parametrize("memory_efficient", [False, True])
def test_port_build_is_byte_identical_to_jax(fixture, tmp_path,
                                             memory_efficient):
    d, db_dir, _ = fixture
    gdir = str(d / "genomes")
    want = str(tmp_path / "jax")
    jbuild(gdir, want, JBuildConfig(memory_efficient=memory_efficient))
    if memory_efficient:
        got = str(tmp_path / "port")
        tbuild(gdir, got, BuildConfig(memory_efficient=True))
    else:
        got = db_dir
    files = _assert_trees_identical(got, want)
    assert {"manifest.json", "tree/table.npz", "tree/fptable.npz",
            "l2/C1/data.npz"} <= set(files)
    assert (tdb.load_manifest(got)["builder_version"]
            == jdb.load_manifest(want)["builder_version"] == "0.1.0")


def test_export_reference_db_is_byte_identical(fixture, tmp_path):
    _, db_dir, _ = fixture
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    tconvert.export_reference_db(db_dir, got)
    jconvert.export_reference_db(db_dir, want)
    files = _assert_trees_identical(got, want)
    assert "Tree_database/tree.pkl" in files


def _fastq(tmp_path, rng):
    """A gzipped FASTQ of reads of 5-300 bases with Ns and lower case."""
    reads = []
    for n in rng.integers(5, 300, size=700):
        r = np.array(list("ACGTacgt"))[rng.integers(0, 8, size=n)]
        r[rng.random(n) < 0.02] = "N"
        reads.append("".join(r))
    path = str(tmp_path / "r.fq.gz")
    write_fq(path, reads, opener=gzip.open)
    return path


@pytest.mark.parametrize("use_native", [True, False])
def test_fastx_equals_jax(fixture, tmp_path, use_native):
    d, _, paths = fixture
    fq = _fastq(tmp_path, np.random.default_rng(1))
    for src in ([fq], [paths["cross"], fq]):
        got = list(tfastx.read_batches(src, batch=256, maxlen=160, k=K,
                                       use_native=use_native))
        want = list(jfastx.read_batches(src, batch=256, maxlen=160, k=K,
                                        use_native=use_native))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    genome = str(d / "genomes" / "A1.fa")
    assert list(tfastx.read_fasta(genome)) == list(jfastx.read_fasta(genome))
    for mode in ("fwd", "both", "canonical"):
        for drop_last in (False, True):
            np.testing.assert_array_equal(
                tfastx.genome_kmers(genome, K, mode, use_native=use_native,
                                    drop_last=drop_last),
                jfastx.genome_kmers(genome, K, mode, use_native=use_native,
                                    drop_last=drop_last))
    gdir = str(d / "genomes")
    assert tfastx.list_genomes(gdir) == jfastx.list_genomes(gdir)
    assert tfastx.genome_prefix(fq) == jfastx.genome_prefix(fq)


def test_native_library_builds_beside_the_port():
    lib = tnative.get_lib()
    assert lib is not None and jnative.get_lib() is not None
    here = os.path.dirname(os.path.abspath(tnative.__file__))
    assert os.path.dirname(lib._name) == os.path.join(here, "_build")


@pytest.mark.parametrize("k", [31, 21, 16, 15])
def test_pack_equals_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=3000).astype(np.uint8)
    codes[rng.random(codes.size) < 0.01] = 4
    seq = jpack.decode_seq(codes)
    np.testing.assert_array_equal(tpack.encode_seq(seq), jpack.encode_seq(seq))
    assert tpack.decode_seq(codes) == seq
    km, ok = tpack.pack_kmers(codes, k)
    jkm, jok = jpack.pack_kmers(codes, k)
    np.testing.assert_array_equal(km, jkm)
    np.testing.assert_array_equal(ok, jok)
    for fn in ("revcomp_packed", "canonical_packed", "decode_kmers"):
        np.testing.assert_array_equal(getattr(tpack, fn)(km[ok], k),
                                      getattr(jpack, fn)(jkm[jok], k))
    a = tpack.sort_unique_u64(km[ok])
    np.testing.assert_array_equal(a, jpack.sort_unique_u64(jkm[jok]))
    b = tpack.sort_unique_u64(rng.integers(0, 1 << 40, 2000, np.uint64)
                              | a[:2000])
    for fn in ("sorted_intersect", "sorted_diff"):
        np.testing.assert_array_equal(getattr(tpack, fn)(a, b),
                                      getattr(jpack, fn)(a, b))
    ab = tpack.merge_unique_sorted_u64([a, b])
    np.testing.assert_array_equal(ab, jpack.merge_unique_sorted_u64([a, b]))
    np.testing.assert_array_equal(tpack.lookup_sorted_u64(ab, b),
                                  jpack.lookup_sorted_u64(ab, b))
    assert tpack.seq_kmer_set(seq, k, both_strands=True).tolist() == \
        jpack.seq_kmer_set(seq, k, both_strands=True).tolist()
    rows = rng.integers(0, 4, size=(64, 150)).astype(np.uint8)
    rows[:, 120:] = 4
    for t, j in zip(tpack.bitpack_codes(rows), jpack.bitpack_codes(rows)):
        np.testing.assert_array_equal(t, j)
    for t, j in zip(tpack.bitpack_codes_vlen(rows),
                    jpack.bitpack_codes_vlen(rows)):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tpack.valid_prefix_lens(rows),
                                  jpack.valid_prefix_lens(rows))
    rows[3, 10] = 4                     # a mid-read N: no prefix form
    assert tpack.valid_prefix_lens(rows) is None
    assert jpack.valid_prefix_lens(rows) is None


PACK_LENGTHS = [1, 15, 16, 17, 31, 32, 33, 80, 100, 150, 160, 256]
PACK_PATTERNS = ["no_n", "pad_only", "n_at_base_0", "n_mid_read",
                 "n_at_last_base", "all_invalid_row", "codes_4_and_200",
                 "no_rows"]


def _pack_batch(length, pattern):
    """9 reads of ``length`` codes (0 for ``no_rows``) with the pattern's
    invalid codes: full reads for ``no_n`` and ``n_at_last_base``, else
    reads of every length up to ``length`` padded with code 4."""
    rng = np.random.default_rng(length * 16 + PACK_PATTERNS.index(pattern))
    rows = 0 if pattern == "no_rows" else 9
    codes = rng.integers(0, 4, size=(rows, length)).astype(np.uint8)
    if pattern == "n_at_last_base":
        codes[2, -1] = 4
    if pattern in ("no_n", "n_at_last_base", "no_rows"):
        return codes
    ends = rng.integers(0, length + 1, size=rows)
    ends[:2] = length                       # two full reads
    pad = 200 if pattern == "codes_4_and_200" else 4
    for r, end in enumerate(ends):
        codes[r, end:] = pad if r % 2 else 4
    if pattern == "n_at_base_0":
        codes[0, 0] = 4
    elif pattern == "n_mid_read":
        codes[1, length // 2] = 4
    elif pattern == "all_invalid_row":
        codes[3] = 4
    elif pattern == "codes_4_and_200":
        codes[0, length // 3] = 200
        codes[1, (2 * length) // 3] = 4
    return codes


def _same(got, want):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
        got = got.view(np.uint32) if got.dtype == np.int32 else got
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("pattern", PACK_PATTERNS)
@pytest.mark.parametrize("length", PACK_LENGTHS)
def test_batch_pack_equals_jax(monkeypatch, length, pattern):
    """The port's one-pass pack (the SIMD groups of 32 codes and the
    portable tail) and its NumPy fallback give the JAX package's
    ``bitpack_codes``, ``bitpack_codes_vlen`` and ``valid_prefix_lens``
    byte for byte, and ``pack_payload`` ships them in the form they
    allow."""
    codes = _pack_batch(length, pattern)
    words, vbytes = jpack.bitpack_codes(codes)
    fused, vlen = jpack.bitpack_codes_vlen(codes), jpack.valid_prefix_lens(codes)
    assert (fused is None) == (vlen is None)
    for use_native in (True, False):
        if not use_native:
            monkeypatch.setattr(tnative, "get_lib", lambda: None)
        for got, want in zip(tpack.bitpack_codes(codes), (words, vbytes)):
            _same(got, want)
        got = tpack.bitpack_codes_vlen(codes)
        if use_native and fused is not None:
            _same(got[0], fused[0])
            _same(got[1], fused[1])
        else:
            assert got is None
        got = tpack.valid_prefix_lens(codes)
        assert (got is None) == (vlen is None)
        if vlen is not None:
            _same(got, vlen)
        for allow_vlen in (True, False):
            form, a, b = pack_payload(codes, True, allow_vlen, False)
            assert form == ("vlen" if allow_vlen and vlen is not None
                            else "vbytes")
            _same(a, words)
            _same(b, vlen if form == "vlen" else vbytes)


def _same_arrays(a, b, names):
    for n in names:
        got, want = getattr(a, n), getattr(b, n)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want, err_msg=n)
            assert got.dtype == want.dtype, n
        else:
            assert got == want, n


KT_FIELDS = ("key_hi", "key_lo", "val", "n_buckets", "max_probe", "n_keys",
             "k")
FP_FIELDS = ("fp", "val", "n_buckets", "bucket", "seed", "n_keys", "k")


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("bucket", [16, 64])
def test_table_builders_equal_jax(tmp_path, monkeypatch, use_native, bucket):
    if not use_native:              # the NumPy placement of both packages
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    rng = np.random.default_rng(bucket + use_native)
    keys = np.unique(rng.integers(0, 1 << 62, size=5000, dtype=np.uint64))
    values = rng.permutation(keys.size).astype(np.int32)
    kt = tht.KmerTable.build(keys, k=K, values=values, load_factor=0.8)
    jkt = jht.KmerTable.build(keys, k=K, values=values, load_factor=0.8)
    _same_arrays(kt, jkt, KT_FIELDS)
    assert kt.max_probe > 1
    np.testing.assert_array_equal(kt.interleaved(), jkt.interleaved())
    fpt = tht.FpTable.from_kmer_table(kt, bucket=bucket)
    jfpt = jht.FpTable.from_kmer_table(jkt, bucket=bucket)
    _same_arrays(fpt, jfpt, FP_FIELDS)
    np.testing.assert_array_equal(fpt.slot_of_id(), jfpt.slot_of_id())
    q = np.concatenate([keys[::3], rng.integers(0, 1 << 62, size=500,
                                                dtype=np.uint64)])
    np.testing.assert_array_equal(kt.lookup_host(q), jkt.lookup_host(q))
    np.testing.assert_array_equal(fpt.lookup_host(q), jfpt.lookup_host(q))
    counts = rng.integers(0, 9, size=fpt.n_slots).astype(np.int32)
    np.testing.assert_array_equal(fpt.remap_counts(counts),
                                  jfpt.remap_counts(counts))
    csum = tht.keys_checksum(keys)
    assert csum == jht.keys_checksum(keys)
    for name, t, j, kw in (("kt", kt, jkt, {}),
                           ("fp", fpt, jfpt, {"content_csum": csum})):
        t.save(str(tmp_path / f"{name}_t.npz"), **kw)
        j.save(str(tmp_path / f"{name}_j.npz"), **kw)
        with open(tmp_path / f"{name}_t.npz", "rb") as a, \
                open(tmp_path / f"{name}_j.npz", "rb") as b:
            assert a.read() == b.read(), name
    lazy = tht.KmerTable.load(str(tmp_path / "kt_j.npz"), lazy=True)
    _same_arrays(lazy, jkt, KT_FIELDS)
    _same_arrays(tht.FpTable.load(str(tmp_path / "fp_j.npz")), jfpt,
                 FP_FIELDS)
    shards = [keys[i::3] for i in range(3)]
    for t, j in zip(tht.build_fp_shards(shards, K, bucket=bucket),
                    jht.build_fp_shards(shards, K, bucket=bucket)):
        _same_arrays(t, j, FP_FIELDS)
    hi, lo = (keys >> np.uint64(32)).astype(np.uint32), keys.astype(np.uint32)
    np.testing.assert_array_equal(tht.mix_np(hi, lo), jht.mix_np(hi, lo))
    np.testing.assert_array_equal(tht.mix_seeded_np(hi, lo, 7),
                                  jht.mix_seeded_np(hi, lo, 7))
    np.testing.assert_array_equal(tht.fp2_np(hi, lo), jht.fp2_np(hi, lo))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cst_search_and_low_depth_equal_jax(fixture, seed):
    """Random count vectors (sparse, deep and shallow) through both
    packages' searches on their own loads of one DB."""
    _, db_dir, _ = fixture
    tree, jtree = tdb.load_tree_db(db_dir), jdb.load_tree_db(db_dir)
    rng = np.random.default_rng(seed)
    n = tree.all_kmers.size
    depth = [0.5, 5, 40][seed]
    counts = rng.poisson(depth, size=n).astype(np.int32)
    counts[rng.random(n) < 0.3] = 0
    cfg, jcfg = IdentifyConfig(), JIdentifyConfig()
    for cutoff in list(cfg.ladder()) + [cfg.cutoff_ldep2]:
        got = tcst.identify_cluster(tree, counts, list(cutoff), cfg)
        want = jcst.identify_cluster(jtree, counts, list(cutoff), jcfg)
        assert got == want
    assert tlow.identify_ranks(tree, counts, cfg) == \
        jlow.identify_ranks(jtree, counts, jcfg)
