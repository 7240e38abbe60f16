"""2-bit k-mer packing on the host (NumPy).

Replaces the reference's string k-mers + C ``seqpy.revcomp``
(library/seqpy.c:5-36) and the pure-Python per-genome k-mer scans
(library/Build_tree.py:93-130, library/Build_kmer_sets...sp.py:518-543)
with vectorized packed-integer arithmetic.

Encoding: A=0, C=1, G=2, T=3, anything else (N, IUPAC codes) = 4
(invalid).  A k-mer is packed MSB-first into the low ``2k`` bits of a
``uint64`` — base ``i`` (0-indexed from the 5' end) occupies bits
``[2*(k-1-i), 2*(k-1-i)+1]``.  With this encoding the reverse complement
is ``(~x)`` with the 2-bit groups reversed, and lexicographic order of
k-mer strings equals numeric order of packed values.

Device code carries packed k-mers as (hi, lo) ``uint32`` pairs because
TPUs have no native 64-bit integer lanes; :func:`split_u64` /
:func:`join_u32` convert.
"""

from __future__ import annotations

import numpy as np

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _CODE[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _CODE[_b] = _i

_BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)


def encode_seq(seq) -> np.ndarray:
    """Encode a DNA string/bytes into uint8 codes (0..3; 4 = invalid)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _CODE[raw]


def decode_seq(codes: np.ndarray) -> str:
    return _BASES[np.minimum(codes, 4)].tobytes().decode("ascii")


def pack_kmers(codes: np.ndarray, k: int):
    """All k-mer windows of a code array.

    Returns ``(kmers, valid)`` where ``kmers`` is ``uint64[n-k+1]`` (MSB-first
    packed) and ``valid`` marks windows free of invalid bases.  Matches the
    reference's per-position scan (Build_tree.py:99-109) but vectorized:
    ``k`` shift-or passes over the array.
    """
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    m = n - k + 1
    if m <= 0:
        return (np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool))
    out = np.zeros(m, dtype=np.uint64)
    for j in range(k):
        out <<= np.uint64(2)
        out |= (codes[j : j + m] & np.uint8(3)).astype(np.uint64)
    bad = np.cumsum(np.concatenate([[0], (codes >= 4).astype(np.int64)]))
    valid = (bad[k:] - bad[:-k]) == 0
    return out, valid


def revcomp_packed(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers (vectorized bit tricks).

    Equivalent of seqpy.revcomp (library/seqpy.c:24-36) on packed values:
    complement = bitwise NOT (A<->T, C<->G under the 0..3 code), order
    reversal = 2-bit-group reversal of the 64-bit word, then realign.
    """
    x = np.asarray(kmers, dtype=np.uint64)
    x = ~x
    x = ((x >> np.uint64(2)) & _M2) | ((x & _M2) << np.uint64(2))
    x = ((x >> np.uint64(4)) & _M4) | ((x & _M4) << np.uint64(4))
    x = x.byteswap()
    x >>= np.uint64(64 - 2 * k)
    return x


def canonical_packed(kmers: np.ndarray, k: int) -> np.ndarray:
    """min(forward, reverse-complement) — the memory-efficient DB's canonical
    rule (Build_tree_mem.py canonicalization, min of the two strings).

    String-lexicographic min equals numeric min under MSB-first packing.
    """
    rc = revcomp_packed(kmers, k)
    return np.minimum(np.asarray(kmers, dtype=np.uint64), rc)


def decode_kmer(kmer: int, k: int) -> str:
    """Unpack a single packed k-mer back to its string (debug/IO)."""
    out = bytearray(k)
    x = int(kmer)
    for i in range(k - 1, -1, -1):
        out[i] = b"ACGT"[x & 3]
        x >>= 2
    return out.decode("ascii")


def decode_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """Vectorized batch decode: packed uint64 [N] -> ASCII uint8 [N, k].

    View the result as ``S{k}`` (``.view(f'S{k}')``) for string rows.  The
    batch counterpart of :func:`decode_kmer` — writing the reference
    layout's kmer.fa at E. coli scale (28.6M entries) needs this: k
    vectorised shift passes in place of a scalar loop per k-mer.
    """
    x = np.asarray(kmers, dtype=np.uint64)
    out = np.empty((x.size, k), dtype=np.uint8)
    for i in range(k):
        out[:, k - 1 - i] = _BASES[(x >> np.uint64(2 * i)) & np.uint64(3)]
    return out


def write_kmer_fa(path: str, kmers: np.ndarray, k: int,
                  header: bytes = b">1") -> None:
    """Write a reference-format k-mer FASTA (``>1\\n<kmer>\\n`` rows,
    build/convert.py export + jellyfish ``--if`` input) in one vectorized
    pass: rows are assembled as a [N, len(header)+k+2] byte matrix and
    dumped with ``tofile``."""
    km = np.asarray(kmers, dtype=np.uint64)
    h = np.frombuffer(header + b"\n", dtype=np.uint8)
    row = h.size + k + 1
    out = np.empty((km.size, row), dtype=np.uint8)
    out[:, :h.size] = h
    out[:, h.size:h.size + k] = decode_kmers(km, k)
    out[:, -1] = ord("\n")
    out.tofile(path)


def sort_unique_u64(arr: np.ndarray) -> np.ndarray:
    """``np.unique`` for flat uint64 arrays, faster at the CST
    builder's id_space scale: ``np.sort`` dispatches to the vectorized
    (AVX) integer sort while ``np.unique``'s flatten+``.sort()`` path
    does not, and the dedup mask is two vector ops.  (A native LSD radix
    sort was tried and LOST to the AVX sort 3x — see round-3 notes.)"""
    arr = np.asarray(arr, dtype=np.uint64)
    if arr.size == 0:
        return np.unique(arr)
    s = np.sort(arr, kind="quicksort")
    mask = np.empty(s.shape, dtype=bool)
    mask[0] = True
    np.not_equal(s[1:], s[:-1], out=mask[1:])
    return s[mask]


def lookup_sorted_u64(universe: np.ndarray, arr: np.ndarray) -> np.ndarray:
    """int32 indices of ``arr``'s elements in ascending-sorted
    ``universe`` — ``np.searchsorted`` with a closed-universe check.
    ``arr`` must be ascending (np.unique output).  Raises if any element
    is absent (a searchsorted miss would silently alias another id)."""
    universe = np.ascontiguousarray(universe, dtype=np.uint64)
    arr = np.ascontiguousarray(arr, dtype=np.uint64)
    from strainscan_tpu_torch import native

    lib = native.get_lib()
    if lib is not None and hasattr(lib, "u64_lookup_sorted"):
        import ctypes

        ids = np.empty(arr.size, dtype=np.int32)
        miss = lib.u64_lookup_sorted(
            universe.ctypes.data_as(ctypes.c_void_p), universe.size,
            arr.ctypes.data_as(ctypes.c_void_p), arr.size,
            ids.ctypes.data_as(ctypes.c_void_p))
        if miss:
            raise AssertionError(
                "k-mer outside the global id universe (closed-universe "
                "invariant violated)")
        return ids
    ids = np.searchsorted(universe, arr)
    if arr.size and not bool(
            (universe[np.minimum(ids, universe.size - 1)] == arr).all()):
        raise AssertionError(
            "k-mer outside the global id universe (closed-universe "
            "invariant violated)")
    return ids.astype(np.int32)


def merge_unique_sorted_u64(arrays) -> np.ndarray:
    """Union of many ascending-unique uint64 arrays via one native k-way
    heap merge — no 2.4 GB concat + re-sort (the CST id_space builder's
    input is ~3300 per-leaf np.unique outputs totaling ~300M entries).
    Falls back to :func:`sort_unique_u64` of the concatenation."""
    arrays = [np.ascontiguousarray(a, dtype=np.uint64) for a in arrays
              if a is not None and a.size]
    if not arrays:
        return np.empty(0, dtype=np.uint64)
    if len(arrays) == 1:
        return arrays[0].copy()
    from strainscan_tpu_torch import native

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "u64_kway_merge_unique"):
        return sort_unique_u64(np.concatenate(arrays))
    import ctypes

    k = len(arrays)
    ptrs = (ctypes.c_void_p * k)(*[a.ctypes.data for a in arrays])
    lens = np.array([a.size for a in arrays], dtype=np.int64)
    total = int(lens.sum())
    out = np.empty(total, dtype=np.uint64)   # only the prefix is touched
    m = lib.u64_kway_merge_unique(
        ptrs, lens.ctypes.data_as(ctypes.c_void_p), k,
        out.ctypes.data_as(ctypes.c_void_p))
    if m < 0:
        return sort_unique_u64(np.concatenate(arrays))
    return out[:m].copy()


_SORTED_OPS = {}


def _sorted_op(kind: str, a: np.ndarray, b: np.ndarray,
               out_cap: int) -> "np.ndarray | None":
    """Dispatch a native sorted-set op; None -> caller falls back."""
    if a.dtype != b.dtype or a.dtype.type not in (np.int32, np.uint64):
        return None
    from strainscan_tpu_torch import native

    lib = native.get_lib()
    if lib is None:
        return None
    key = ("i32" if a.dtype.type is np.int32 else "u64") + kind
    fn = _SORTED_OPS.get(key)
    if fn is None:
        fn = getattr(lib, key, None)
        if fn is None:
            return None
        _SORTED_OPS[key] = fn
    import ctypes

    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    out = np.empty(out_cap, dtype=a.dtype)
    m = fn(a.ctypes.data_as(ctypes.c_void_p), a.size,
           b.ctypes.data_as(ctypes.c_void_p), b.size,
           out.ctypes.data_as(ctypes.c_void_p))
    return out[:m]


def sorted_intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``np.intersect1d(a, b, assume_unique=True)`` for ascending unique
    int32/uint64 arrays via one native linear merge (np re-sorts the
    concatenation) — the CST builder's hot set op."""
    got = _sorted_op("_sorted_intersect", a, b, min(a.size, b.size))
    if got is not None:
        return got
    return np.intersect1d(a, b, assume_unique=True)


def sorted_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``np.setdiff1d(a, b, assume_unique=True)`` for ascending unique
    int32/uint64 arrays via one native linear merge."""
    got = _sorted_op("_sorted_diff", a, b, a.size)
    if got is not None:
        return got
    return np.setdiff1d(a, b, assume_unique=True)


def split_u64(x: np.ndarray):
    """uint64 -> (hi uint32, lo uint32) for device transport."""
    x = np.asarray(x, dtype=np.uint64)
    return (x >> np.uint64(32)).astype(np.uint32), (x & np.uint64(0xFFFFFFFF)).astype(
        np.uint32
    )


def join_u32(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def pack_batch(codes: np.ndarray, words: np.ndarray,
               vbytes: "np.ndarray | None" = None,
               vlen: "np.ndarray | None" = None) -> bool:
    """Pack a read batch in one native pass into the caller's arrays.

    ``codes`` [B, L] uint8 (0..3 bases, >=4 invalid/pad) fills ``words``
    uint32 [B, ceil(L/16)] and, where given, ``vbytes`` uint8
    [B, ceil(L/8)], the layouts of :func:`bitpack_codes`, and ``vlen``
    uint16 [B], each row's valid count.  Returns True when every row's
    valid bases form a prefix run, so that ``vlen`` is what
    :func:`valid_prefix_lens` gives.  Needs the native library."""
    import ctypes

    from strainscan_tpu_torch import native

    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    b, length = codes.shape
    w, vb = -(-length // 16), -(-length // 8)
    for a, dtype, shape in ((words, np.uint32, (b, w)),
                            (vbytes, np.uint8, (b, vb)),
                            (vlen, np.uint16, (b,))):
        if a is not None and not (a.dtype == dtype and a.shape == shape
                                  and a.flags.c_contiguous):
            raise ValueError(f"pack_batch: want {np.dtype(dtype)} {shape}, "
                             f"got {a.dtype} {a.shape}")

    def ptr(a):
        return None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    return bool(native.get_lib().pack_batch(
        ptr(codes), b, length, ptr(words), w, ptr(vbytes), vb, ptr(vlen)))


def bitpack_codes(codes: np.ndarray, need_vbytes: bool = True):
    """Pack encoded reads for transfer: 2 bits/base + 1 validity bit.

    ``codes`` [B, L] uint8 (0..3 bases, >=4 invalid/pad) becomes
    ``(words, vbytes)``: ``words`` uint32 [B, ceil(L/16)] with base p in
    bits [2*(p%16), 2*(p%16)+1] of word p//16, and ``vbytes`` uint8
    [B, ceil(L/8)] with validity bit p%8 of byte p//8.  Cuts host->device
    bytes by more than three (2 bits + 1 bit per base, against 8).
    """
    b, length = codes.shape
    w = -(-length // 16)
    vb = -(-length // 8)
    from strainscan_tpu_torch import native

    if native.get_lib() is not None:
        words = np.empty((b, w), dtype=np.uint32)
        vbytes = np.empty((b, vb), dtype=np.uint8)
        pack_batch(codes, words, vbytes)
        return words, vbytes
    cp = np.zeros((b, w * 16), dtype=np.uint32)
    cp[:, :length] = np.where(codes < 4, codes, 0).astype(np.uint32)
    words = np.zeros((b, w), dtype=np.uint32)
    for j in range(16):
        words |= cp[:, j::16] << np.uint32(2 * j)
    if not need_vbytes:
        return words, None
    vp = np.zeros((b, vb * 8), dtype=np.uint8)
    vp[:, :length] = (codes < 4).astype(np.uint8)
    vbytes = np.zeros((b, vb), dtype=np.uint8)
    for j in range(8):
        vbytes |= vp[:, j::8] << np.uint8(j)
    return words, vbytes


def bitpack_codes_vlen(codes: np.ndarray):
    """Single-pass (words, vlen) packing via the native library.

    Returns ``(words uint32 [B, ceil(L/16)], vlen uint16 [B])`` — the
    payload of the vlen transfer form — or ``None`` when a row's validity
    is not a contiguous prefix (mid-read N; the batch needs vbytes) or
    the native library is unavailable."""
    from strainscan_tpu_torch import native

    if native.get_lib() is None:
        return None
    b, length = codes.shape
    words = np.empty((b, -(-length // 16)), dtype=np.uint32)
    vlen = np.empty((b,), dtype=np.uint16)
    return (words, vlen) if pack_batch(codes, words, vlen=vlen) else None


def valid_prefix_lens(codes: np.ndarray):
    """uint16 [B] valid-prefix lengths, or None if any row's validity is
    not a contiguous prefix (an N mid-read).

    Reads are padded to the batch maxlen with invalid code 4 and rarely
    contain Ns, so validity is almost always a prefix run — describable
    in 2 bytes/row instead of ceil(L/8) vbytes."""
    valid = codes < 4
    lens = valid.sum(axis=1).astype(np.uint16)
    length = codes.shape[1]
    if not np.array_equal(
            valid, np.arange(length, dtype=np.int64)[None, :]
            < lens[:, None].astype(np.int64)):
        return None
    return lens


def seq_kmer_set(
    seqs,
    k: int,
    *,
    both_strands: bool = True,
    canonical: bool = False,
    unique: bool = True,
) -> np.ndarray:
    """Packed k-mers of one or more sequences.

    ``both_strands=True`` emits forward and reverse-complement k-mers as
    separate values — this mirrors the reference DB inserting both
    orientations (Build_tree.py:101-109), which is what makes
    orientation-free read matching work without canonicalizing queries.
    ``canonical=True`` instead emits min(fwd, rc) (memory-efficient mode).
    """
    if isinstance(seqs, (str, bytes)):
        seqs = [seqs]
    parts = []
    for s in seqs:
        codes = s if isinstance(s, np.ndarray) else encode_seq(s)
        km, valid = pack_kmers(codes, k)
        km = km[valid]
        if canonical:
            km = canonical_packed(km, k)
        elif both_strands:
            km = np.concatenate([km, revcomp_packed(km, k)])
        parts.append(km)
    if not parts:
        return np.empty(0, dtype=np.uint64)
    out = np.concatenate(parts)
    if unique:
        out = np.unique(out)
    return out
