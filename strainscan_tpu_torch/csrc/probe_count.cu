// Hand-written Hopper (sm_90a) kernel: probe_prep_kernel, the port of the
// Pallas kernel strainscan_tpu/ops/pallas_probe.py::probe_prep (body
// _probe_prep_kernel, helpers _fmix/_rev2/_canonicalize).
//
// For every window j < M = L - k + 1 of a uint8 code row it packs k bases
// 5'-first, optionally takes min(fwd, revcomp), and writes
// bucket = fmix(fmix(hi ^ (0x9E3779B9 ^ seed)) ^ lo) & (n_buckets - 1)
// (-1 when any code >= 4) and fp = fmix(fmix(lo ^ 0x85EBCA6B) ^ hi).
// It is the standalone parity seam: tests hold it against the Pallas
// kernel's plain twin.  The main-path count (the same hash fused with the
// probe and the scatter-add) is count_fp_bins.cu; the exact-mode count is
// count_exact.cu; the helpers they share are in kmer_window.cuh.
//
// What bounds it on the card: the B x L code bytes in and the 8 B per
// window out, a few dozen integer operations per window.  A block stages
// kRowsPerBlock code rows in shared memory once, so the k reads per window
// hit shared memory, and each thread hashes windows of those rows.
//
// The entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() so the wrapper can raise on a refused
// launch.

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

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
