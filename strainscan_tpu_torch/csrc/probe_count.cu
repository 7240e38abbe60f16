// Hand-written Hopper (sm_90a) kernels of the k-mer count hot path.
//
// What each function replaces
// ---------------------------
// * probe_prep_kernel: the Pallas kernel strainscan_tpu/ops/pallas_probe.py
//   ::probe_prep (body _probe_prep_kernel, helpers _fmix/_rev2/_canonicalize).
//   For every window j < M = L - k + 1 of a uint8 code row it packs k bases
//   5'-first, optionally takes min(fwd, revcomp), and writes
//   bucket = fmix(fmix(hi ^ (0x9E3779B9 ^ seed)) ^ lo) & (n_buckets - 1)
//   (-1 when any code >= 4) and fp = fmix(fmix(lo ^ 0x85EBCA6B) ^ hi).
//   It is the standalone parity seam: tests hold it against the Pallas
//   kernel's plain twin.
// * count_fp_kernel: the same window hash fused with what XLA did around the
//   Pallas kernel in strainscan_tpu/ops/count.py::_count_core_fp: the device
//   unpack of the 2-bit words (kmer/device.py::unpack_codes[_vlen]; or raw
//   uint8 codes, count_batch_fp with packed_transfer=False), the
//   fingerprint-row probe (pallas_probe.py::lookup_fp_from_prep) and the
//   scatter-add into slot-space counts.  Windows that do not hit (invalid or
//   miss) are added to the trash slot counts[n_slots], as the JAX scatter does.
//
// The exact-mode count (count_exact_kernel) is in count_exact.cu; the
// helpers both files share are in kmer_window.cuh.
//
// What bounds it on the card
// --------------------------
// Hashing is a few dozen integer operations per window.  The probe is one
// 256 B fingerprint row (bucket = 64 uint32) read from a table that is far
// larger than the 50 MB L2 at real scale (256 MiB at 28.6 M keys), plus one
// int32 atomic per hit.  So the kernel is bound by device-memory latency and
// the atomic rate, not by arithmetic.
//
// What the design does about it
// -----------------------------
// * A block stages kRowsPerBlock code rows in shared memory once (unpacking
//   the words there, or copying raw codes), so the k reads per window hit
//   shared memory.
// * Each lane hashes one window; the warp then probes its 32 windows one at a
//   time, cooperatively: lane i reads slots i and 32 + i of the row, so the
//   256 B read is two coalesced 128 B transactions and the second is skipped
//   when the first half hits.  __ballot_sync + __ffs give the LOWEST matching
//   lane, as argmax(hit) does in the JAX lookup (an empty slot holds fp 0,
//   so a window whose fp is 0 may "hit" an empty slot; the stream-end remap
//   drops it, exactly as in the JAX pipeline).
// * Invalid windows are warp-uniform after the shuffle, so they skip the row
//   read without divergence; the misses of 32 windows go to the trash slot
//   in one atomic.
// * Many resident warps keep many row reads in flight; cp.async/TMA
//   prefetch of the rows is left for a later change.
//
// Every entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include "kmer_window.cuh"

namespace {

// Bucket (-1 if the window holds a code >= 4) and fingerprint of the window
// that starts at row[j].  Bit-identical to pallas_probe._probe_prep_kernel.
__device__ __forceinline__ int32_t window_hash(const uint8_t* row, int j,
                                               int k, bool canonical,
                                               uint32_t nb_mask, uint32_t seed,
                                               uint32_t* fp) {
  uint32_t bad;
  const uint64_t key = window_key(row, j, k, canonical, &bad);
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const uint32_t lo = static_cast<uint32_t>(key);
  *fp = fmix32(fmix32(lo ^ 0x85EBCA6Bu) ^ hi);
  if (bad) return -1;
  return static_cast<int32_t>(fmix32(fmix32(hi ^ (0x9E3779B9u ^ seed)) ^ lo) &
                              nb_mask);
}

__global__ void __launch_bounds__(kThreads)
probe_prep_kernel(const uint8_t* __restrict__ codes, int64_t n_rows, int L,
                  int M, int k, bool canonical, uint32_t nb_mask,
                  uint32_t seed, int32_t* __restrict__ bucket_out,
                  uint32_t* __restrict__ fp_out) {
  extern __shared__ uint8_t s_codes[];  // [kRowsPerBlock, L]
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int rows = rows_in_block(n_rows, row0);
  stage_rows(s_codes, codes, nullptr, nullptr, nullptr, row0, rows, 0, 0, L);
  for (int w = threadIdx.x; w < rows * M; w += blockDim.x) {
    const int r = w / M;
    const int j = w - r * M;
    uint32_t fp;
    const int32_t b =
        window_hash(s_codes + r * L, j, k, canonical, nb_mask, seed, &fp);
    const int64_t o = (row0 + r) * M + j;
    bucket_out[o] = b;
    fp_out[o] = fp;
  }
}

__global__ void __launch_bounds__(kThreads)
count_fp_kernel(const uint8_t* __restrict__ codes,
                const uint32_t* __restrict__ words,
                const uint16_t* __restrict__ vlen,
                const uint8_t* __restrict__ vbytes, int64_t n_rows, int W,
                int VB, int L, int M, int k, bool canonical,
                const uint32_t* __restrict__ fp_table, uint32_t nb_mask,
                int bucket, uint32_t seed, int32_t* __restrict__ counts,
                int64_t trash) {
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
    int32_t b = -1;
    uint32_t f = 0;
    if (w < n_win) {
      const int r = w / M;
      b = window_hash(s_codes + r * L, w - r * M, k, canonical, nb_mask, seed,
                      &f);
    }
    int64_t my_slot = -1;
    for (int src = 0; src < 32; ++src) {
      const int32_t bb = __shfl_sync(kFullMask, b, src);
      const uint32_t ff = __shfl_sync(kFullMask, f, src);
      if (bb < 0) continue;  // warp-uniform
      const uint32_t* row = fp_table + static_cast<int64_t>(bb) * bucket;
      int hit_lane = -1;
      for (int c0 = 0; c0 < bucket; c0 += 32) {
        const int s = c0 + lane;
        const unsigned m = __ballot_sync(kFullMask, s < bucket && row[s] == ff);
        if (m != 0) {  // warp-uniform
          hit_lane = c0 + __ffs(m) - 1;
          break;
        }
      }
      if (lane == src && hit_lane >= 0)
        my_slot = static_cast<int64_t>(bb) * bucket + hit_lane;
    }
    if (my_slot >= 0) atomicAdd(counts + my_slot, 1);
    const unsigned miss = __ballot_sync(kFullMask, w < n_win && my_slot < 0);
    if (lane == 0 && miss != 0) atomicAdd(counts + trash, __popc(miss));
  }
}

}  // namespace

extern "C" {

// codes uint8 [n_rows, L] -> bucket_out int32 [n_rows, M], fp_out uint32
// [n_rows, M], M = L - k + 1.
int probe_prep_launch(int device, const void* codes, long long n_rows, int L,
                      int k, int canonical, unsigned n_buckets, unsigned seed,
                      void* bucket_out, void* fp_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = L - k + 1;
  if (n_rows > 0 && M > 0) {
    probe_prep_kernel<<<grid_for(n_rows), kThreads, kRowsPerBlock * L,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), n_rows, L, M, k, canonical != 0,
        n_buckets - 1u, seed, static_cast<int32_t*>(bucket_out),
        static_cast<uint32_t*>(fp_out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Exactly one payload form: raw codes uint8 [n_rows, L], or words uint32
// [n_rows, W] with vlen uint16 [n_rows] (valid prefix lengths) or vbytes
// uint8 [n_rows, VB] (LSB-first bitmask).  Adds into counts int32
// [n_buckets * bucket + 1].
int count_fp_launch(int device, const void* codes, const void* words,
                    const void* vlen, const void* vbytes, long long n_rows,
                    int W, int VB, int L,
                    int k, int canonical, const void* fp_table,
                    unsigned n_buckets, int bucket, unsigned seed,
                    void* counts, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = L - k + 1;
  if (n_rows > 0 && M > 0) {
    count_fp_kernel<<<grid_for(n_rows), kThreads, kRowsPerBlock * L,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), static_cast<const uint32_t*>(words),
        static_cast<const uint16_t*>(vlen),
        static_cast<const uint8_t*>(vbytes), n_rows, W, VB, L, M, k,
        canonical != 0, static_cast<const uint32_t*>(fp_table),
        n_buckets - 1u, bucket, seed, static_cast<int32_t*>(counts),
        static_cast<int64_t>(n_buckets) * bucket);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
