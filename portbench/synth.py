"""Seeded inputs: the E. coli-scale genomes, sample reads and FASTQ files.

``synth`` is a copy of ``strainscan_tpu_torch/bench/scale_fixture.py``'s
generator (itself a copy of ``benchmarks/scale.py::synth``): the same NumPy
RNG calls in the same order, so the genomes, and the DB the port builds from
them, are byte-identical to the fixture's.  Reads are drawn with vectorised
NumPy; a FASTQ is written as fixed-width rows in one call.
"""

from __future__ import annotations

import os

import numpy as np

ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)
N_CODE = 4


def synth(gdir: str, families: int, variants: int, glen: int, rng) -> list:
    """Write the fixture's genomes under ``gdir``; return their names."""
    bases = np.array(list("ACGT"))
    names = []
    for f in range(families):
        base = rng.choice(bases, size=glen)
        for v in range(variants if f % 2 == 0 else 1):
            s = base.copy()
            n_snps = 30 * (v + 1)
            if v:
                for p in rng.choice(glen, size=n_snps, replace=False):
                    s[p] = rng.choice([b for b in bases if b != s[p]])
            name = f"F{f:03d}V{v}"
            with open(os.path.join(gdir, name + ".fa"), "wb") as fh:
                fh.write(b">%s\n%s\n" % (
                    name.encode(),
                    s.view(np.uint32).astype(np.uint8).tobytes()))
            names.append(name)
    return names


def genome_codes(path: str) -> np.ndarray:
    """uint8 codes (A0 C1 G2 T3) of a one-record FASTA written by synth."""
    with open(path, "rb") as f:
        f.readline()
        seq = np.frombuffer(f.read().replace(b"\n", b""), dtype=np.uint8)
    lut = np.full(256, N_CODE, dtype=np.uint8)
    lut[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)
    return lut[seq]


def random_genome(rng, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.uint8)


def genome_reads(rng, genome: np.ndarray, n: int,
                 read_len: int) -> np.ndarray:
    """``n`` reads drawn uniformly from ``genome``, half reverse-complemented
    (uint8 codes ``[n, read_len]``)."""
    starts = rng.integers(0, genome.size - read_len, size=n)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    flips = rng.random(n) < 0.5
    reads[flips] = (3 - reads[flips])[:, ::-1]
    return reads


def random_reads(rng, n: int, read_len: int) -> np.ndarray:
    """Reads of uniform random bases: they miss any DB of real size."""
    return rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)


def depth_reads(depth: float, glen: int, read_len: int) -> int:
    """Reads for ``depth``-fold coverage of a ``glen`` genome."""
    return int(glen * depth / read_len)


def write_fastq(path: str, reads: np.ndarray) -> int:
    """Fixed-width FASTQ of code rows (4 = N); returns the bytes written."""
    n, length = reads.shape
    head = np.frombuffer(b"@r\n", dtype=np.uint8)
    mid = np.frombuffer(b"\n+\n", dtype=np.uint8)
    row = head.size + length + mid.size + length + 1
    out = np.empty((n, row), dtype=np.uint8)
    out[:, :head.size] = head
    out[:, head.size:head.size + length] = ASCII[reads]
    out[:, head.size + length:head.size + length + mid.size] = mid
    out[:, head.size + length + mid.size:-1] = ord("I")
    out[:, -1] = ord("\n")
    out.tofile(path)
    return out.nbytes
