"""The seeded inputs: the copied genome generator and the samples."""

import hashlib
import os

import numpy as np

from portbench import synth
from portbench.drivers import count as count_driver
from portbench.drivers import identify as identify_driver


def _digest(d):
    h = hashlib.sha256()
    for n in sorted(os.listdir(d)):
        with open(os.path.join(d, n), "rb") as f:
            h.update(n.encode() + f.read())
    return h.hexdigest()


def test_genomes_equal_the_fixture_at_four_families(tmp_path):
    from strainscan_tpu_torch.bench import scale_fixture

    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    ours.mkdir()
    theirs.mkdir()
    a = synth.synth(str(ours), 4, 3, 2000, np.random.default_rng(5))
    b = scale_fixture.synth(str(theirs), 4, 3, 2000,
                            np.random.default_rng(5))
    assert a == b == ["F000V0", "F000V1", "F000V2", "F001V0", "F002V0",
                      "F002V1", "F002V2", "F003V0"]
    assert _digest(ours) == _digest(theirs)
    codes = synth.genome_codes(str(ours / "F000V1.fa"))
    assert codes.shape == (2000,) and codes.max() < 4


def _count_samples(seed):
    mix = {"reads": 500, "read_len": 150, "distinct": 2, "miss_share": 0.05,
           "n_share": 0.05}
    rng = np.random.default_rng(seed)
    genome = synth.random_genome(rng, 5000)
    return count_driver.make_samples(rng, genome, mix)


def test_count_samples_repeat_per_seed_and_differ_across_seeds():
    big = 2**31 + 12345
    a, b, c = _count_samples(big), _count_samples(big), _count_samples(big + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0], a[1])
    assert a[0].shape == (500, 150)
    n_rows = (a[0] == synth.N_CODE).any(axis=1).sum()
    assert n_rows == 25


def test_identify_samples_repeat_per_seed_and_differ_across_seeds(tmp_path):
    names = synth.synth(str(tmp_path), 4, 3, 3000, np.random.default_rng(5))
    mix = {"read_len": 100, "reads": 2000, "distinct": 3,
           "kinds": ["single", "crossmix", "intramix"],
           "depth": {"single": [8, 12], "crossmix": [6, 10],
                     "intramix": [5, 8]}}

    def make(seed):
        return identify_driver.make_samples(np.random.default_rng(seed),
                                            str(tmp_path), names, mix, 3000)

    a, b, c = make(7), make(7), make(8)
    assert [x[:2] for x in a] == [x[:2] for x in b]
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(a, b))
    assert [x[1] for x in a] != [x[1] for x in c]
    assert [x[0] for x in a] == ["single", "crossmix", "intramix"]
    assert all(x[2].shape == (2000, 100) for x in a)
    fam = {s[:4] for s, _ in a[1][1]}
    assert len(fam) == 2                      # crossmix: two families
    assert len({s[:4] for s, _ in a[2][1]}) == 1   # intramix: one family


def test_fastq_rows(tmp_path):
    reads = np.array([[0, 1, 2, 3, 4]], dtype=np.uint8)
    p = tmp_path / "x.fq"
    synth.write_fastq(str(p), reads)
    assert p.read_bytes() == b"@r\nACGTN\n+\nIIIII\n"
