"""The port's probe_prep and fingerprint lookup against the Pallas kernel
(interpret mode) and the host oracles, on the shapes of test_pallas_probe.

Tolerance: none; buckets, fingerprints and slot ids must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from strainscan_tpu.index.hashtable import FpTable, lookup_fp_device
from strainscan_tpu.kmer import device as jdev
from strainscan_tpu.kmer import pack
from strainscan_tpu.ops.pallas_probe import lookup_fp_from_prep as jlookup
from strainscan_tpu.ops.pallas_probe import probe_prep as jprobe_prep
from strainscan_tpu_torch.index.hashtable import (fp_table_to_device,
                                                  lookup_fp,
                                                  lookup_fp_from_prep)
from strainscan_tpu_torch.kmer import device as tdev
from strainscan_tpu_torch.ops import probe

from _torch_sim import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_sim import port_fp_table


def _random_codes(rng, b, length, n_frac=0.05):
    codes = rng.integers(0, 4, size=(b, length)).astype(np.uint8)
    codes[rng.random((b, length)) < n_frac] = 4
    return codes


@pytest.mark.parametrize("k,canonical,n_buckets,seed", [
    (31, False, 1 << 12, 3), (21, False, 1 << 12, 3), (15, False, 1 << 12, 3),
    (16, False, 1 << 12, 3), (31, True, 1 << 10, 0), (21, True, 1 << 10, 0),
    (16, True, 1 << 10, 0), (15, True, 1 << 10, 0)])
def test_probe_prep_equals_pallas_interpret(k, canonical, n_buckets, seed):
    rng = np.random.default_rng(k + 100 * canonical)
    codes = _random_codes(rng, 16, 64)
    jb, jf = jprobe_prep(jnp.asarray(codes), k=k, n_buckets=n_buckets,
                         seed=seed, canonical=canonical, interpret=True)
    b, f = probe.probe_prep(torch.from_numpy(codes), k=k, n_buckets=n_buckets,
                            seed=seed, canonical=canonical)
    assert b.dtype == torch.int32 and f.dtype == torch.int32
    assert b.shape == (16, 64 - k + 1)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    # every window's fingerprint, invalid ones included, is bit-identical
    np.testing.assert_array_equal(f.numpy().view(np.uint32), np.asarray(jf))


@pytest.mark.parametrize("k,canonical", [(31, False), (31, True),
                                         (16, False), (15, True)])
@pytest.mark.parametrize("rows,length", [(16, 256), (5, 256), (7, 150)])
def test_probe_prep_padded_equals_pallas_interpret(rows, length, k,
                                                   canonical):
    """Reads of 150 bp (with Ns) padded with code 4 to L = 256, as identify
    pads them, and batches whose B x M is not a multiple of 4 (5 x 226,
    7 x 120 at k = 31): every bucket and fingerprint bit-identical."""
    rng = np.random.default_rng(rows + length + k + canonical)
    codes = np.full((rows, length), 4, np.uint8)
    codes[:, :150] = _random_codes(rng, rows, 150)
    codes[1, 100:] = 4                     # a shorter read
    jb, jf = jprobe_prep(jnp.asarray(codes), k=k, n_buckets=1 << 12, seed=9,
                         canonical=canonical, interpret=True)
    b, f = probe.probe_prep(torch.from_numpy(codes), k=k, n_buckets=1 << 12,
                            seed=9, canonical=canonical)
    assert b.shape == (rows, length - k + 1)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(f.numpy().view(np.uint32), np.asarray(jf))
    assert (b.numpy()[:, 150:] == -1).all()   # windows over the padding


def test_probe_prep_plus_lookup_matches_host_oracle():
    k = 31
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, size=4000).astype(np.uint8)
    km, _ = pack.pack_kmers(genome, k)
    table = FpTable.build(np.unique(km), k=k)
    codes = np.full((8, 80), 4, np.uint8)
    for i in range(8):
        st = int(rng.integers(0, genome.size - 72))
        codes[i, :72] = genome[st:st + 72]
    codes[3, 20] = 4

    dt = fp_table_to_device(port_fp_table(table), torch.device("cpu"))
    b, f = probe.probe_prep(torch.from_numpy(codes), k=k,
                            n_buckets=table.n_buckets, seed=table.seed)
    slots = lookup_fp_from_prep(dt.fp, b, f, table.bucket).numpy()

    hi, lo, valid = (np.asarray(x) for x in jdev.extract_kmers(codes, k))
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    exp = table.lookup_host(keys.reshape(-1)).reshape(hi.shape)
    exp[~valid] = -1
    np.testing.assert_array_equal(slots, exp)
    assert (slots >= 0).sum() > 300

    jb, jf = jprobe_prep(jnp.asarray(codes), k=k, n_buckets=table.n_buckets,
                         seed=table.seed, interpret=True)
    np.testing.assert_array_equal(
        slots, np.asarray(jlookup(table.device_arrays(), jb, jf,
                                  table.bucket)))
    # the (hi, lo) lookup agrees with the JAX one on every window
    thi, tlo, _ = tdev.extract_kmers(torch.from_numpy(codes), k)
    got = lookup_fp(dt.fp, table.n_buckets, table.bucket, table.seed, thi,
                    tlo).numpy()
    ref = np.asarray(lookup_fp_device(
        table.device_arrays(), table.n_buckets, table.bucket, table.seed,
        jnp.asarray(hi), jnp.asarray(lo)))
    np.testing.assert_array_equal(got, ref)


def test_lookup_takes_lowest_matching_lane():
    """A fingerprint that sits in several lanes (fp 0 of empty slots)
    resolves to the lowest lane, as argmax(hit) does."""
    fp_table = torch.zeros((2, 64), dtype=torch.int32)
    fp_table[1, 5] = 77
    fp_table[1, 40] = 77
    b = torch.tensor([1, 1, 0, -1], dtype=torch.int32)
    f = torch.tensor([77, 0, 9, 77], dtype=torch.int32)
    got = lookup_fp_from_prep(fp_table, b, f, 64)
    assert got.tolist() == [64 + 5, 64 + 0, -1, -1]


def test_cpu_tensor_routes_to_plain_twin():
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(_random_codes(rng, 4, 40))
    probe.reset_launches()
    got = probe.probe_prep(codes, k=21, n_buckets=1 << 8, seed=1)
    want = probe.probe_prep_plain(codes, k=21, n_buckets=1 << 8, seed=1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert probe.LAUNCHES == dict.fromkeys((
        "probe_prep_kernel", "fp_coarse_count_kernel",
        "fp_coarse_scatter_kernel", "fp_fine_split_kernel",
        "fp_bin_probe_kernel", "count_exact_kernel", "exact_apply_kernel",
        "row_gather_kernel"), 0)
    with pytest.raises(ValueError):
        probe.probe_prep(codes.to(torch.int32), k=21, n_buckets=1 << 8,
                         seed=1)
    with pytest.raises(ValueError):
        probe.probe_prep(codes, k=21, n_buckets=100, seed=1)
