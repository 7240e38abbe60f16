"""The plain reference: its table, its count, and the control."""

import numpy as np
import pytest
import torch

from portbench import control, synth
from portbench.drivers import count as count_driver
from portbench.reference import exact, fptable


def brute_force(keys: np.ndarray, reads: np.ndarray, k: int) -> np.ndarray:
    index = {int(x): i for i, x in enumerate(keys)}
    out = np.zeros(keys.size, dtype=np.int32)
    for r in reads:
        for s in range(r.size - k + 1):
            w = r[s:s + k]
            if (w >= 4).any():
                continue
            key = 0
            for c in w:
                key = key << 2 | int(c)
            if key in index:
                out[index[key]] += 1
    return out


def test_count_equals_a_brute_force_count():
    rng = np.random.default_rng(11)
    genome = synth.random_genome(rng, 3000)
    keys = fptable.genome_keys(genome, "cpu", 31)
    assert keys.size > 5900 and np.all(np.diff(keys.view(np.int64)) > 0)
    reads = np.concatenate([synth.genome_reads(rng, genome, 60, 80),
                            synth.random_reads(rng, 20, 80)])
    reads[::7, 40] = synth.N_CODE
    table = fptable.build(fptable.keys_tensor(keys, "cpu"))
    got = fptable.count(table, reads, "cpu", batch=32)
    assert np.array_equal(got, brute_force(keys.view(np.int64), reads, 31))
    assert got.sum() > 1000


def test_exact_count_equals_a_brute_force_count():
    rng = np.random.default_rng(12)
    genome = synth.random_genome(rng, 3000)
    keys = fptable.genome_keys(genome, "cpu", 31)
    reads = np.concatenate([synth.genome_reads(rng, genome, 60, 80),
                            synth.random_reads(rng, 20, 80)])
    reads[::5, 30] = synth.N_CODE
    got = exact.count(fptable.keys_tensor(keys, "cpu"), reads, "cpu",
                      batch=16)
    assert np.array_equal(got, brute_force(keys.view(np.int64), reads, 31))
    assert got.sum() > 1000
    with pytest.raises(ValueError):
        exact.count(fptable.keys_tensor(keys[::-1], "cpu"), reads, "cpu")


def test_the_count_comparison_allows_strays_and_no_count_under():
    want = [np.array([3, 0, 5]), np.array([1, 1, 1])]
    checks = {c.name: c for c in count_driver.compare(
        [(0, np.array([3, 2, 5])), (1, np.array([1, 1, 2])),
         (0, np.array([3, 2, 5]))], want)}
    assert (checks["ids_under"].value, checks["stray_windows"].value) == (0, 2)
    assert all(c.ok for c in checks.values())
    checks = {c.name: c for c in count_driver.compare(
        [(0, np.array([3, 0, 4])), (1, np.array([1, 1]))], want)}
    assert checks["ids_under"].value == 1 + 3
    assert not checks["ids_under"].ok
    over = np.array([3, count_driver.STRAY_WINDOWS_LIMIT + 1, 5])
    (_, stray) = count_driver.compare([(0, over)], want)
    assert not stray.ok


def test_table_equals_the_programs_bit_for_bit():
    from strainscan_tpu_torch.index.hashtable import FpTable

    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 2**62, size=50000)).view(np.uint64)
    ours = fptable.build(fptable.keys_tensor(keys, "cpu"))
    theirs = FpTable.build(keys, k=31)
    assert (ours.seed, ours.n_buckets) == (theirs.seed, theirs.n_buckets)
    assert np.array_equal(ours.fp.view(-1).clamp(min=0).numpy()
                          .astype(np.uint32), theirs.fp)
    assert np.array_equal(ours.ids.view(-1).numpy().astype(np.int32),
                          theirs.val)


def test_hashes_on_the_uint32_range():
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x9E3779B9], dtype=torch.int64)
    assert fptable.mul32(x, 0xFFFFFFFF).tolist() == [
        (int(v) * 0xFFFFFFFF) % 2**32 for v in x]
    h = fptable.fmix32(x)
    assert int(h.min()) >= 0 and int(h.max()) < 2**32


def test_narrow_fingerprints_make_strays():
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 2**62, size=20000)).view(np.uint64)
    t = fptable.build(fptable.keys_tensor(keys, "cpu"))
    reads = synth.random_reads(rng, 2000, 100)
    assert fptable.count(t, reads, "cpu").sum() == 0
    assert fptable.count(fptable.narrowed(t, 16), reads, "cpu").sum() > 0


@pytest.mark.parametrize("cell", ["tiny-count", "tiny-deep", "tiny-small"])
def test_control_fails_every_cell(tiny, cell):
    reg, cache = tiny
    for seed in (101, 2**31 + 7):
        r = control.readings(reg, cell, seed, ["cpu"], cache)
        assert any(c["fails"] for c in r["checks"].values()), r
