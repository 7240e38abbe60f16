"""The CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere
(the CUDA kernels have no CPU mode).  Run them on a GPU host with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (tests/conftest.py
imports jax, which a GPU host need not have).

Tolerance: none; buckets, fingerprints and counts are integers and must
be equal.
"""

import numpy as np
import pytest
import torch

from strainscan_tpu.index.hashtable import FpTable
from strainscan_tpu.kmer import pack
from strainscan_tpu_torch.index.hashtable import fp_table_to_device
from strainscan_tpu_torch.kmer.device import from_u32
from strainscan_tpu_torch.ops import probe

from _torch_sim import one_torch_thread  # noqa: F401 (autouse fixture)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


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


@pytest.mark.parametrize("form", ["vlen", "vbytes"])
def test_count_fp_kernel_equals_plain(dev, form):
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, size=20_000).astype(np.uint8)
    km, _ = pack.pack_kmers(genome, 31)
    fpt = FpTable.build(np.unique(np.concatenate(
        [km, pack.revcomp_packed(km, 31)])), k=31)
    table = fp_table_to_device(fpt, dev)
    codes = np.full((3001, 160), 4, np.uint8)
    for i in range(codes.shape[0]):
        s = int(rng.integers(0, genome.size - 150))
        codes[i, :150] = genome[s:s + 150]
    codes[:50] = codes[0]          # repeated reads: contended atomics
    if form == "vbytes":
        codes[::5, 77] = 4
        words, valid = pack.bitpack_codes(codes)
    else:
        words, _ = pack.bitpack_codes(codes)
        valid = pack.valid_prefix_lens(codes)
    wd = from_u32(words).to(dev)
    vd = torch.from_numpy(valid).to(dev)
    c1 = torch.zeros(fpt.n_slots + 1, dtype=torch.int32, device=dev)
    c2 = c1.clone()
    probe.count_fp(c1, wd, table.fp, length=160, k=31, seed=fpt.seed,
                   **{form: vd})
    probe.count_fp_plain(c2, wd, table.fp, length=160, k=31, seed=fpt.seed,
                         **{form: vd})
    torch.cuda.synchronize()
    assert torch.equal(c1, c2)
    assert int(c1[:-1].sum()) > 100_000
