// Hand-written Hopper (sm_90a) kernel of the exact probe mode.
//
// What it replaces
// ----------------
// count_exact_kernel is the exact-mode count of the JAX package, which is
// plain XLA there, not Pallas: strainscan_tpu/ops/count.py::_count_core
// (count_batch on raw uint8 codes, count_batch_packed on 2-bit words +
// validity bits) around strainscan_tpu/index/hashtable.py::lookup_device.
// A plain PyTorch version materialises a [windows, 24] row gather for every
// probe; the kernel keeps the rows in registers.  Per window:
//   * the same unpack and window packing as count_fp_kernel (kmer_window.cuh),
//     min(fwd, revcomp) with canonical;
//   * the UNSEEDED bucket hash b = fmix(fmix(hi ^ 0x9E3779B9) ^ lo) & mask;
//   * for p < max_probe, row (b + p) & mask of the interleaved table
//     (KmerTable.interleaved: 8 slots x (hi, lo, val) int32 = 96 B); a slot
//     hits when hi and lo match and val >= 0, a row yields the largest hit
//     val, and the first probe that hits wins (no later row is read);
//   * atomicAdd of one into the id-space accumulator counts[id]; a window
//     that is invalid or misses (or whose id is not in [0, n_keys)) counts
//     into the trash entry counts[n_keys], which the JAX scatter slices away.
//
// What bounds it on the card
// --------------------------
// At 28.6 M keys the table is 2^24 buckets x 96 B = 1.6 GB, far outside the
// 50 MB L2, so every probe is a device-memory read of one 96 B row (a miss
// reads max_probe rows), plus one int32 atomic per hit.  Hashing is a few
// dozen integer operations.  The kernel is bound by memory latency and the
// number of row reads in flight, not by arithmetic.
//
// What the design does about it
// -----------------------------
// * The block stages its read rows in shared memory once, as count_fp_kernel.
// * One thread per window: each thread reads its whole 96 B row as six 16 B
//   vector loads (rows are 16 B aligned: 96 = 6 x 16), so a warp has 32
//   independent row reads in flight and many resident warps hide the latency.
//   A warp-cooperative probe, as in count_fp_kernel, is left for a later
//   change if the kernel's time ever matters end to end.
// * The misses of 32 windows go to the trash entry in one atomic.
//
// The entry point launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include "kmer_window.cuh"

namespace {

constexpr int kRowVecs = 6;  // 24 int32 = 6 x int4

__global__ void __launch_bounds__(kThreads)
count_exact_kernel(const uint8_t* __restrict__ codes,
                   const uint32_t* __restrict__ words,
                   const uint16_t* __restrict__ vlen,
                   const uint8_t* __restrict__ vbytes, int64_t n_rows, int W,
                   int VB, int L, int M, int k, bool canonical,
                   const int4* __restrict__ table, uint32_t nb_mask,
                   int max_probe, int32_t* __restrict__ counts,
                   int64_t n_keys) {
  extern __shared__ uint8_t s_codes[];  // [kRowsPerBlock, L]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int rows = rows_in_block(n_rows, row0);
  stage_rows(s_codes, codes, words, vlen, vbytes, row0, rows, W, VB, L);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_win = rows * M;
  for (int base = warp * 32; base < n_win; base += n_warps * 32) {
    const int w = base + lane;
    int32_t id = -1;
    if (w < n_win) {
      const int r = w / M;
      uint32_t bad;
      const uint64_t key =
          window_key(s_codes + r * L, w - r * M, k, canonical, &bad);
      if (!bad) {
        const uint32_t hi = static_cast<uint32_t>(key >> 32);
        const uint32_t lo = static_cast<uint32_t>(key);
        const uint32_t b = fmix32(fmix32(hi ^ 0x9E3779B9u) ^ lo) & nb_mask;
        for (int p = 0; p < max_probe && id < 0; ++p) {
          const int4* row =
              table + static_cast<int64_t>((b + p) & nb_mask) * kRowVecs;
          int32_t e[4 * kRowVecs];
#pragma unroll
          for (int q = 0; q < kRowVecs; ++q) {
            const int4 v = __ldg(row + q);
            e[4 * q] = v.x;
            e[4 * q + 1] = v.y;
            e[4 * q + 2] = v.z;
            e[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            const int32_t val = e[3 * s + 2];
            if (static_cast<uint32_t>(e[3 * s]) == hi &&
                static_cast<uint32_t>(e[3 * s + 1]) == lo && val > id)
              id = val;  // val >= 0 since id starts at -1
          }
        }
      }
    }
    const bool hit = id >= 0 && id < n_keys;
    if (hit) atomicAdd(counts + id, 1);
    const unsigned miss = __ballot_sync(kFullMask, w < n_win && !hit);
    if (lane == 0 && miss != 0) atomicAdd(counts + n_keys, __popc(miss));
  }
}

}  // namespace

extern "C" {

// Exactly one payload form: raw codes uint8 [n_rows, L], or words uint32
// [n_rows, W] with vlen uint16 [n_rows] or vbytes uint8 [n_rows, VB].
// table int32 [n_buckets, 24] (16 B aligned); adds into counts int32
// [n_keys + 1].
int count_exact_launch(int device, const void* codes, const void* words,
                       const void* vlen, const void* vbytes, long long n_rows,
                       int W, int VB, int L, int k, int canonical,
                       const void* table, unsigned n_buckets, int max_probe,
                       long long n_keys, void* counts, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = L - k + 1;
  if (n_rows > 0 && M > 0) {
    count_exact_kernel<<<grid_for(n_rows), kThreads, kRowsPerBlock * L,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const uint32_t*>(words),
        static_cast<const uint16_t*>(vlen),
        static_cast<const uint8_t*>(vbytes), n_rows, W, VB, L, M, k,
        canonical != 0, static_cast<const int4*>(table), n_buckets - 1u,
        max_probe, static_cast<int32_t*>(counts), n_keys);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
