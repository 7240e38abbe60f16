// Device helpers shared by the count kernels (probe_count.cu, count_exact.cu):
// the 32-bit finalizer of the JAX package's hashes, the reverse complement of
// a packed k-mer, the packing of one read window, and the staging of a
// block's read rows into shared memory from any payload form.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 4;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// Reverse complement of a k-mer packed 2 bits/base in the low 2k bits.
__device__ __forceinline__ uint64_t revcomp64(uint64_t x, int k) {
  x = ~x;
  x = ((x >> 2) & 0x3333333333333333ull) | ((x & 0x3333333333333333ull) << 2);
  x = ((x >> 4) & 0x0F0F0F0F0F0F0F0Full) | ((x & 0x0F0F0F0F0F0F0F0Full) << 4);
  x = ((x >> 8) & 0x00FF00FF00FF00FFull) | ((x & 0x00FF00FF00FF00FFull) << 8);
  x = ((x >> 16) & 0x0000FFFF0000FFFFull) |
      ((x & 0x0000FFFF0000FFFFull) << 16);
  x = (x >> 32) | (x << 32);
  return x >> (64 - 2 * k);
}

// The k-mer of the window that starts at row[j], packed 5'-first, and
// min(fwd, revcomp) with canonical.  *bad is non-zero when the window holds
// a code >= 4: a code c contributes c & 3 to the key and c >> 2 to the flag,
// as kmer/device.py::extract_kmers does.
__device__ __forceinline__ uint64_t window_key(const uint8_t* row, int j,
                                               int k, bool canonical,
                                               uint32_t* bad) {
  uint64_t key = 0;
  uint32_t b = 0;
  for (int i = 0; i < k; ++i) {
    const uint32_t c = row[j + i];
    b |= c >> 2;
    key = (key << 2) | (c & 3u);
  }
  if (canonical) {
    const uint64_t rc = revcomp64(key, k);
    key = rc < key ? rc : key;
  }
  *bad = b;
  return key;
}

// Copy rows [row0, row0 + rows) of a read batch into shared memory as uint8
// codes [rows, L], then __syncthreads().  Exactly one payload form is given:
// raw codes uint8 [n_rows, L] (copied as they are), or 2-bit words uint32
// [n_rows, W] (base p in bits 2(p%16).. of word p/16) with vlen uint16
// [n_rows] (valid prefix lengths) or vbytes uint8 [n_rows, VB] (LSB-first
// validity bits); an invalid position becomes code 4.
__device__ __forceinline__ void stage_rows(uint8_t* s_codes,
                                           const uint8_t* codes,
                                           const uint32_t* words,
                                           const uint16_t* vlen,
                                           const uint8_t* vbytes, int64_t row0,
                                           int rows, int W, int VB, int L) {
  for (int i = threadIdx.x; i < rows * L; i += blockDim.x) {
    const int r = i / L;
    const int p = i - r * L;
    const int64_t row = row0 + r;
    uint8_t c;
    if (codes != nullptr) {
      c = codes[row * L + p];
    } else {
      const uint32_t base = (words[row * W + (p >> 4)] >> (2 * (p & 15))) & 3u;
      const bool ok =
          vlen != nullptr
              ? p < static_cast<int>(vlen[row])
              : ((vbytes[row * VB + (p >> 3)] >> (p & 7)) & 1u) != 0;
      c = ok ? static_cast<uint8_t>(base) : static_cast<uint8_t>(4);
    }
    s_codes[i] = c;
  }
  __syncthreads();
}

__host__ __device__ inline int rows_in_block(int64_t n_rows, int64_t row0) {
  return static_cast<int>(n_rows - row0 < kRowsPerBlock ? n_rows - row0
                                                        : kRowsPerBlock);
}

inline int grid_for(int64_t n_rows) {
  return static_cast<int>((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace
