"""The port's k-mer tensor functions against ``strainscan_tpu.kmer.device``.

Tolerance: none; all outputs are integers and must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from strainscan_tpu.kmer import device as jdev
from strainscan_tpu.kmer import pack
from strainscan_tpu_torch.kmer import device as tdev

from _torch_sim import one_torch_thread  # noqa: F401 (autouse fixture)

KS = [31, 21, 16, 15]


def _codes(seed, b=12, length=70, n_frac=0.05):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(b, length)).astype(np.uint8)
    codes[rng.random((b, length)) < n_frac] = 4
    return codes


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("k", KS)
def test_extract_kmers_equal(k):
    codes = _codes(k)
    hi, lo, valid = tdev.extract_kmers(torch.from_numpy(codes), k)
    jhi, jlo, jvalid = (np.asarray(x) for x in jdev.extract_kmers(codes, k))
    np.testing.assert_array_equal(_u32(hi), jhi)
    np.testing.assert_array_equal(_u32(lo), jlo)
    np.testing.assert_array_equal(valid.numpy(), jvalid)


@pytest.mark.parametrize("k", KS)
def test_revcomp_and_canonical_equal(k):
    hi, lo, _ = tdev.extract_kmers(torch.from_numpy(_codes(100 + k)), k)
    jhi, jlo = jnp.asarray(_u32(hi)), jnp.asarray(_u32(lo))
    for tfn, jfn in ((tdev.revcomp, jdev.revcomp),
                     (tdev.canonical, jdev.canonical)):
        a, b = tfn(hi, lo, k)
        ja, jb = jfn(jhi, jlo, k)
        np.testing.assert_array_equal(_u32(a), np.asarray(ja))
        np.testing.assert_array_equal(_u32(b), np.asarray(jb))
    # revcomp is an involution
    rhi, rlo = tdev.revcomp(*tdev.revcomp(hi, lo, k), k)
    assert torch.equal(rhi, hi) and torch.equal(rlo, lo)


@pytest.mark.parametrize("length", [70, 16, 33])
def test_unpack_codes_both_forms_equal(length):
    codes = _codes(7, length=length)
    words, vbytes = pack.bitpack_codes(codes)
    tw = tdev.from_u32(words)
    got = tdev.unpack_codes(tw, torch.from_numpy(vbytes), length)
    want = np.asarray(jdev.unpack_codes(words, vbytes, length))
    np.testing.assert_array_equal(got.numpy(), want)
    # vlen form on prefix-valid rows
    codes = _codes(8, length=length, n_frac=0.0)
    codes[:, length // 2:] = 4
    vlen = pack.valid_prefix_lens(codes)
    words, _ = pack.bitpack_codes(codes)
    got = tdev.unpack_codes_vlen(tdev.from_u32(words), torch.from_numpy(vlen),
                                 length)
    want = np.asarray(jdev.unpack_codes_vlen(words, vlen, length))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.minimum(codes, 4))


def test_u32_bit_views_round_trip():
    x = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = tdev.from_u32(x)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), x)
    wide = torch.from_numpy(x.astype(np.int64))
    assert torch.equal(tdev.u32_to_i32(wide), t)
