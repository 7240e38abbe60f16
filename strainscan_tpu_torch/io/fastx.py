"""FASTA/FASTQ input: gz-transparent readers, read batching, genome k-mers.

The device consumes fixed-shape uint8 code batches ``[B, L]`` (0..3 bases,
4 = N/padding).  The fast path is the native C parser
(:mod:`strainscan_tpu_torch.native`); a pure-Python implementation provides the
same semantics everywhere (identical chunking of over-long reads with a
(k-1)-base overlap so no k-mer window is lost).

``genome_kmers`` replaces the reference's repeated pure-Python genome scans
(Build_tree.py:93-130, Build_kmer_sets...sp.py:518-543) — one pass in C (or
vectorized NumPy) returning packed uint64 k-mers.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import re
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from strainscan_tpu_torch import native
from strainscan_tpu_torch.kmer import pack

FASTA_EXT = (".fa", ".fna", ".fasta", ".fa.gz", ".fna.gz", ".fasta.gz")


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def genome_prefix(path: str) -> str:
    """Strain name from a genome filename — everything before the first dot
    (reference ``get_pre``, Unique_kmer_detect_direct.py:30-33)."""
    return os.path.basename(path).split(".")[0]


def list_genomes(directory: str) -> List[str]:
    """FASTA files in a directory, sorted by strain prefix."""
    out = []
    for fn in sorted(os.listdir(directory)):
        if re.search(r"\.(fa|fna|fasta)(\.gz)?$", fn):
            out.append(os.path.join(directory, fn))
    return sorted(out, key=genome_prefix)


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) records, gz-transparent."""
    name = None
    chunks: List[str] = []
    with _open_text(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)


def _read_seqs(path: str) -> Iterator[str]:
    """Sequences of a FASTA or FASTQ file (gz ok)."""
    with _open_text(path) as f:
        first = f.read(1)
    if not first:
        return
    if first == "@":
        with _open_text(path) as f:
            for i, line in enumerate(f):
                if i % 4 == 1:
                    yield line.strip()
    else:
        for _, seq in read_fasta(path):
            yield seq


def _py_batches(paths: Sequence[str], batch: int, maxlen: int, k: int):
    buf = np.full((batch, maxlen), 4, dtype=np.uint8)
    row = 0
    for path in paths:
        for seq in _read_seqs(path):
            enc = pack.encode_seq(seq)
            start = 0
            while True:
                piece = enc[start : start + maxlen]
                if piece.size < k and start > 0:
                    break
                buf[row, : piece.size] = piece
                buf[row, piece.size :] = 4
                row += 1
                if row == batch:
                    yield buf
                    buf = np.full((batch, maxlen), 4, dtype=np.uint8)
                    row = 0
                if start + maxlen >= enc.size:
                    break
                start += maxlen - (k - 1)
    if row:
        yield buf[:row]


def _native_batches(paths: Sequence[str], batch: int, maxlen: int, k: int,
                    lib) -> Iterator[np.ndarray]:
    for path in paths:
        h = lib.fastx_open(path.encode())
        if not h:
            raise IOError(f"cannot open {path}")
        try:
            while True:
                buf = np.empty((batch, maxlen), dtype=np.uint8)
                n = lib.fastx_next_batch(
                    h, buf.ctypes.data_as(ctypes.c_void_p), batch, maxlen, k)
                if n == 0:
                    break
                yield buf[:n]
                if n < batch:
                    break
        finally:
            lib.fastx_close(h)


def read_batches(
    paths,
    batch: int = 65536,
    maxlen: int = 256,
    k: int = 31,
    use_native: bool = True,
) -> Iterator[np.ndarray]:
    """Stream encoded read batches ``[<=batch, maxlen]`` from FASTQ/FASTA.

    ``paths`` may be one path or a (SE, PE) sequence; paired files are
    simply concatenated — counting is order-independent, matching the
    reference feeding both mates to one jellyfish call
    (Vote_Strain_L2_Lasso_new_sp.py:366-372).
    """
    if isinstance(paths, (str, os.PathLike)):
        paths = [str(paths)]
    paths = [str(p) for p in paths if p]
    lib = native.get_lib() if use_native else None
    if lib is not None:
        yield from _native_batches(paths, batch, maxlen, k, lib)
    else:
        yield from _py_batches(paths, batch, maxlen, k)


def genome_kmers(
    path: str,
    k: int,
    mode: str = "both",
    unique: bool = True,
    use_native: bool = True,
    drop_last: bool = False,
) -> np.ndarray:
    """All packed k-mers of a genome file.

    mode: 'fwd' | 'both' (fwd + revcomp as separate values — default DB
    semantics, Build_tree.py:101-109) | 'canonical' (memory-efficient DB).
    drop_last: skip each contig's LAST window — bug-compatibility with
    the reference's default tree build (Build_tree.py:100,113 iterates
    ``range(len-ksize)``; Build_tree_mem fixed it to ``len-ksize+1``, so
    the memory-efficient path keeps every window).
    """
    mode_id = {"fwd": 0, "both": 1, "canonical": 2}[mode]
    lib = native.get_lib() if use_native else None
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_uint64)()
        n = lib.fastx_kmers(path.encode(), k, mode_id, int(drop_last),
                            ctypes.byref(out))
        if n < 0:
            raise IOError(f"cannot open {path}")
        if n == 0:   # no windows: the native vec never allocated (NULL)
            return np.empty(0, dtype=np.uint64)
        try:
            arr = np.ctypeslib.as_array(out, shape=(n,)).astype(np.uint64, copy=True)
        finally:
            lib.fastx_free_u64(out)
    else:
        parts = []
        for _, seq in read_fasta(path):
            codes = pack.encode_seq(seq)
            if drop_last and codes.size:
                codes = codes[:-1]
            km, valid = pack.pack_kmers(codes, k)
            km = km[valid]
            if mode == "both":
                km = np.concatenate([km, pack.revcomp_packed(km, k)])
            elif mode == "canonical":
                km = pack.canonical_packed(km, k)
            parts.append(km)
        arr = (np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64))
    if unique:
        arr = np.unique(arr)
    return arr
