// Device helpers shared by the kernels of probe_count.cu, count_exact.cu and
// count_fp_bins.cu: the 32-bit finalizer of the JAX package's hashes, one
// rolling-key walker over a read row's windows in every payload form, and
// the staging of a span of device memory into shared memory with 16 B
// loads.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xFFFFFFFFu;

// Payload forms of a read batch: raw codes uint8 [n_rows, L]; 2-bit words
// uint32 [n_rows, W] (base p in bits 2(p%16).. of word p/16) with vlen
// uint16 [n_rows] (valid prefix lengths) or vbytes uint8 [n_rows, VB]
// (LSB-first validity bits).
enum Form { kCodes = 0, kVlen = 1, kVbytes = 2 };

// One read batch in one payload form (the pointers of the other forms are
// null) and its window geometry.
struct Reads {
  const uint8_t* codes;    // [n_rows, L] (kCodes)
  const uint32_t* words;   // [n_rows, W] (kVlen, kVbytes)
  const uint16_t* vlen;    // [n_rows] (kVlen)
  const uint8_t* vbytes;   // [n_rows, VB] (kVbytes)
  int64_t n_rows;
  int W, VB, L, M, k;      // M = L - k + 1 windows per row
  bool canonical;
};

inline Reads make_reads(const void* codes, const void* words,
                        const void* vlen, const void* vbytes,
                        long long n_rows, int W, int VB, int L, int k,
                        int canonical) {
  Reads r;
  r.codes = static_cast<const uint8_t*>(codes);
  r.words = static_cast<const uint32_t*>(words);
  r.vlen = static_cast<const uint16_t*>(vlen);
  r.vbytes = static_cast<const uint8_t*>(vbytes);
  r.n_rows = n_rows;
  r.W = W;
  r.VB = VB;
  r.L = L;
  r.M = L - k + 1;
  r.k = k;
  r.canonical = canonical != 0;
  return r;
}

inline int form_of(const void* codes, const void* vlen) {
  return codes != nullptr ? kCodes : (vlen != nullptr ? kVlen : kVbytes);
}

// One row of a batch, in device or shared memory: codes for kCodes, words
// (and vbytes for kVbytes) otherwise.
struct RowSrc {
  const uint8_t* codes;
  const uint32_t* words;
  const uint8_t* vbytes;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The rolling-key walker.  Walks `steps` windows j = j0, j0 + 1, ... of a
// row and calls f(j, hi, lo, ok) for each, where (hi, lo) is the window's
// key packed 5'-first (min(fwd, revcomp) in 64-bit order with canonical)
// and ok says the window is one of the first n and holds no invalid base.
// Only the n windows' bases are read (none when n <= 0).  An invalid base
// (code >= 4, or a clear validity bit) puts c & 3 in the key and clears ok
// for the k windows that hold it, as kmer/device.py::extract_kmers does;
// with kVlen every position walked is valid (the caller stops n at the
// valid length).  Keys and ok are bit-identical to the plain twins'.  A
// caller whose callback is warp-collective passes the same `steps` on every
// lane, so every lane calls f the same number of times.
template <int kForm, class F>
__device__ __forceinline__ void walk_windows(const RowSrc& src, int j0, int n,
                                             int steps, int k, bool canonical,
                                             F f) {
  const uint64_t kmask = (1ull << (2 * k)) - 1;
  const int rc_shift = 2 * (k - 1);
  const int p_end = n > 0 ? j0 + n + k - 1 : j0;   // bases of the n windows
  uint64_t fwd = 0, rc = 0;
  uint32_t word = 0;
  int last_bad = -1;   // the last invalid (or unread) position seen
  const int s_end = steps + k - 1;
  for (int s = 0; s < s_end; ++s) {
    const int p = j0 + s;
    uint32_t c = 0;
    if (p < p_end) {
      if (kForm == kCodes) {
        c = src.codes[p];
        if (c >= 4) last_bad = p;
        c &= 3u;
      } else {
        if ((p & 15) == 0 || s == 0) word = src.words[p >> 4];
        c = (word >> (2 * (p & 15))) & 3u;
        if (kForm == kVbytes && !((src.vbytes[p >> 3] >> (p & 7)) & 1u))
          last_bad = p;
      }
    } else {
      last_bad = p;
    }
    fwd = ((fwd << 2) | c) & kmask;
    rc = (rc >> 2) | (static_cast<uint64_t>(3u - c) << rc_shift);
    if (s >= k - 1) {
      const int j = p - k + 1;
      const uint64_t key = (canonical && rc < fwd) ? rc : fwd;
      f(j, static_cast<uint32_t>(key >> 32), static_cast<uint32_t>(key),
        last_bad < j);
    }
  }
}

// Bytes of shared memory that stage_span needs for a span of n bytes.
__host__ __device__ inline int64_t staged_bytes(int64_t n) {
  return ((n + 15) / 16 + 1) * 16;
}

// Copies the span [src, src + n) of device memory into shared memory at dst
// (16 B aligned, staged_bytes(n) long) with one 16 B load per aligned
// 16 B chunk that the span touches, spread over the block's threads, and
// returns where src's first byte landed (dst + src % 16).  The first and
// last chunk may hold up to 15 bytes outside the span; they are read, never
// used, and lie in the same 16 B chunk as a byte of the span (device
// allocations are 256 B aligned).  The caller runs __syncthreads() before
// reading the copy.
__device__ __forceinline__ const uint8_t* stage_span(uint8_t* dst,
                                                     const uint8_t* src,
                                                     int64_t n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int head = static_cast<int>(a & 15);
  if (n > 0) {
    const int4* s4 = reinterpret_cast<const int4*>(a - head);
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int64_t n4 = (head + n + 15) >> 4;
    for (int64_t i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = __ldg(s4 + i);
  }
  return dst + head;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.  Without asking,
// a block has 48 KiB in all, its static shared memory included.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (smem + attr.sharedSizeBytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
