// Hand-written Hopper (sm_90a) kernel of the measurement path: the row gather.
//
// What it replaces
// ----------------
// row_gather_kernel ports the Pallas kernel benchmarks/probe_bench3.py
// ::bench_dma_gather (body dma_gather_kernel), the study of the count step's
// fingerprint-row gather.  The index array is cut into tiles of `tile`
// entries (grid = W / tile: entries past the last whole tile are ignored).
// For entry t of tile i (t local to the tile), table row idx[i * tile + t] is
// XOR-folded into output row i * nbuf + (t & (nbuf - 1)).  The Pallas kernel
// streams the rows through an nbuf-deep ring of VMEM buffers, one DMA per
// row issued from the scalar core, with the tile's indices in SMEM; the fold
// is what it computes, and this kernel computes the same fold.
//
// What bounds it on the card
// --------------------------
// Every row is read once from device memory.  At the study's size (a 256 MiB
// table, 2^23 indices, 512 B rows) one call reads 4.3 GB of random rows from
// a table several times the 50 MB L2, so the kernel is bound by device-memory
// bandwidth for random whole rows, provided enough row reads are in flight.
// The fold is one integer XOR per 4 bytes read.
//
// What the design does about it
// -----------------------------
// * One block per tile and nbuf warps (nbuf <= 32): warp s owns pipeline
//   slot s and walks t = s, s + nbuf, ... < tile.
// * The block first stages its tile's indices in shared memory with coalesced
//   loads (the Pallas kernel's SMEM BlockSpec): 8 KiB at tile 2048.
// * Lane c reads 16 B of a row (a uint4), so a 512 B row is one coalesced
//   warp read and a 256 B row is read by 16 lanes; a wider row takes more
//   passes of 512 B columns.
// * Each warp issues kUnroll row reads before it folds them, so it keeps
//   kUnroll reads in flight; many resident warps hide the latency.
// * Each lane folds in registers and stores its 16 B of the output row once:
//   no atomics, so the result is deterministic.
// * An index outside [0, n_rows) contributes nothing and reads nothing; the
//   plain twin does the same.
// cp.async or TMA staging of the rows is left for a later change.
//
// The entry point launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 8;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ void xor_into(uint4& acc, const uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// 16 B column c of table row b, or zeros for a row outside the table.
__device__ __forceinline__ uint4 row_vec(const uint4* __restrict__ table,
                                         int64_t n_rows, int row_vecs,
                                         int32_t b, int c) {
  if (b < 0 || b >= n_rows) return make_uint4(0u, 0u, 0u, 0u);
  return __ldg(table + static_cast<int64_t>(b) * row_vecs + c);
}

__global__ void row_gather_kernel(const uint4* __restrict__ table,
                                  int64_t n_rows, int row_vecs,
                                  const int32_t* __restrict__ idx, int tile,
                                  int nbuf, uint4* __restrict__ out) {
  extern __shared__ int32_t s_idx[];  // [tile]
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tile;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) s_idx[i] = idx[first + i];
  __syncthreads();

  const int slot = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per_slot = tile / nbuf;
  uint4* dst = out + (static_cast<int64_t>(blockIdx.x) * nbuf + slot) * row_vecs;
  for (int c = lane; c < row_vecs; c += 32) {
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    int j = 0;
    for (; j + kUnroll <= per_slot; j += kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = row_vec(table, n_rows, row_vecs, s_idx[slot + (j + u) * nbuf], c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) xor_into(acc, v[u]);
    }
    for (; j < per_slot; ++j)
      xor_into(acc, row_vec(table, n_rows, row_vecs, s_idx[slot + j * nbuf], c));
    dst[c] = acc;
  }
}

}  // namespace

extern "C" {

// table int32 [n_rows, row_words] (row_words % 4 == 0, 16 B aligned); idx
// int32 [>= n_tiles * tile]; out int32 [n_tiles * nbuf, row_words].
// nbuf is a power of two <= 32 that divides tile; the wrapper checks.
int row_gather_launch(int device, const void* table, long long n_rows,
                      int row_words, const void* idx, long long n_tiles,
                      int tile, int nbuf, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = tile * static_cast<int>(sizeof(int32_t));
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(row_gather_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_tiles > 0) {
    row_gather_kernel<<<static_cast<unsigned>(n_tiles), nbuf * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(table), n_rows, row_words / 4,
        static_cast<const int32_t*>(idx), tile, nbuf,
        static_cast<uint4*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
