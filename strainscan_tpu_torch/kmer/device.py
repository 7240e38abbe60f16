"""K-mer extraction on tensors (port of ``strainscan_tpu/kmer/device.py``).

Packed k-mers keep the JAX package's ``(hi, lo)`` layout: ``hi`` holds the
top ``2k - 32`` bits (the 5'-most bases), ``lo`` the bottom 32 bits, so
host-built tables and device-extracted windows agree bit for bit.

PyTorch on the CPU implements neither ``>>``, ``<<`` nor ``<`` for
``torch.uint32``.  So a uint32 value lives here in an int64 tensor, in
``[0, 2**32)``: every left shift and multiply is masked with ``M32``.  A
wrapped int64 product keeps its low 32 bits exact, so the hashes stay
bit-exact.  Packed words and fingerprints cross the host boundary as int32
tensors holding the uint32 bit pattern (:func:`from_u32`, :func:`u32_to_i32`).
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def from_u32(a: np.ndarray) -> torch.Tensor:
    """uint32 NumPy array -> int32 tensor with the same bits (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 tensor with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def extract_kmers(codes: torch.Tensor, k: int):
    """All k-mer windows of encoded reads.

    Args:
      codes: integer tensor ``[B, L]`` with values 0..3 (bases) or >= 4
        (invalid / padding).
      k: k-mer size (<= 31).

    Returns:
      ``(hi, lo, valid)`` each ``[B, L-k+1]``: ``hi``/``lo`` are uint32
      values in int64, ``valid`` is bool (the window holds no invalid code).
    """
    if k > 31:
        raise ValueError("k must be <= 31")
    b, length = codes.shape
    m = length - k + 1
    if m <= 0:
        raise ValueError(f"reads of length {length} cannot hold {k}-mers")
    c = codes.to(torch.int64)
    c3 = c & 3
    # 2k <= 62 bits: the whole window rolls in one int64, then splits
    key = torch.zeros((b, m), dtype=torch.int64, device=codes.device)
    for j in range(k):
        key = (key << 2) | c3[:, j:j + m]
    invalid = (c >= 4).to(torch.int32)
    csum = torch.nn.functional.pad(torch.cumsum(invalid, dim=1), (1, 0))
    valid = (csum[:, k:] - csum[:, :-k]) == 0
    return key >> 32, key & M32, valid


def _unpack_words(words: torch.Tensor, length: int) -> torch.Tensor:
    b, w = words.shape
    parts = [(words >> (2 * j)) & 3 for j in range(16)]
    return torch.stack(parts, dim=-1).reshape(b, w * 16)[:, :length]


def unpack_codes(words: torch.Tensor, vbytes: torch.Tensor,
                 length: int) -> torch.Tensor:
    """Inverse of ``pack.bitpack_codes``: int32 words (uint32 bits)
    ``[B, W]`` + uint8 validity bytes ``[B, ceil(L/8)]`` -> uint8 codes
    ``[B, length]`` (0..3, 4 = invalid)."""
    codes = _unpack_words(words.to(torch.int32), length)
    b = vbytes.shape[0]
    v = vbytes.to(torch.int32)
    valid = torch.stack([(v >> j) & 1 for j in range(8)],
                        dim=-1).reshape(b, -1)[:, :length]
    return torch.where(valid > 0, codes, 4).to(torch.uint8)


def unpack_codes_vlen(words: torch.Tensor, vlen: torch.Tensor,
                      length: int) -> torch.Tensor:
    """:func:`unpack_codes` for prefix-run validity: ``vlen`` uint16 ``[B]``
    valid prefix lengths (``pack.valid_prefix_lens``)."""
    codes = _unpack_words(words.to(torch.int32), length)
    pos = torch.arange(length, dtype=torch.int32, device=words.device)
    valid = pos[None, :] < vlen.to(torch.int32)[:, None]
    return torch.where(valid, codes, 4).to(torch.uint8)


def _rev2(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups of each uint32 value."""
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & M32


def revcomp(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """Reverse complement of packed (hi, lo) k-mers."""
    s = 64 - 2 * k
    r_hi = _rev2(lo ^ M32)
    r_lo = _rev2(hi ^ M32)
    if s == 0:
        new_hi, new_lo = r_hi, r_lo
    elif s < 32:
        new_lo = (r_lo >> s) | ((r_hi << (32 - s)) & M32)
        new_hi = r_hi >> s
    elif s == 32:
        new_lo, new_hi = r_hi, torch.zeros_like(r_hi)
    else:
        new_lo = r_hi >> (s - 32)
        new_hi = torch.zeros_like(r_hi)
    mask_hi = (1 << max(2 * k - 32, 0)) - 1
    mask_lo = M32 if 2 * k >= 32 else (1 << (2 * k)) - 1
    return new_hi & mask_hi, new_lo & mask_lo


def canonical(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """min(fwd, rc) under 64-bit numeric order (memory-efficient DB rule)."""
    rhi, rlo = revcomp(hi, lo, k)
    fwd_less = (hi < rhi) | ((hi == rhi) & (lo <= rlo))
    return torch.where(fwd_less, hi, rhi), torch.where(fwd_less, lo, rlo)
