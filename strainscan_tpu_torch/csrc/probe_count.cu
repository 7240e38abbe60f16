// Hand-written Hopper (sm_90a) kernel: probe_prep_kernel, the port of the
// Pallas kernel strainscan_tpu/ops/pallas_probe.py::probe_prep (body
// _probe_prep_kernel, helpers _fmix/_rev2/_canonicalize).
//
// For every window j < M = L - k + 1 of a uint8 code row it packs k bases
// 5'-first, optionally takes min(fwd, revcomp), and writes
// bucket = fmix(fmix(hi ^ (0x9E3779B9 ^ seed)) ^ lo) & (n_buckets - 1)
// (-1 when any code >= 4) and fp = fmix(fmix(lo ^ 0x85EBCA6B) ^ hi) for
// every window, invalid ones included (their key takes c & 3 of a bad
// code).  It is the standalone parity seam: tests hold it against the
// Pallas kernel's plain twin.  The main-path count (the same hash fused with
// the probe and the scatter-add) is count_fp_bins.cu; the exact-mode count
// is count_exact.cu; the walker they share is in kmer_window.cuh.
//
// What bounds it on the card: the B x L code bytes in and the 8 B per
// window out, a few dozen integer operations per window.
//
// What the design does about it: a block takes `rows` code rows (a
// multiple of 16 where shared memory allows, so its input span row0 x L and
// its output span row0 x M start 16 B aligned) and stages them in shared
// memory with 16 B loads.  Each thread walks a run of kRun consecutive
// windows with the rolling-key walker (one shift per base, not k) and
// writes bucket and fp into shared copies of the block's flat [rows, M]
// output spans; kRun is odd, so the lanes of a warp, on consecutive runs of
// a row, write to different banks.  The block then copies both spans out
// with 16 B stores, with a scalar head and tail where a span does not start
// or end on 16 B.
//
// The entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() so the wrapper can raise on a refused
// launch.

#include "kmer_window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 31;   // windows per work item
// shared memory a block may take before its rows are halved: three blocks
// on one SM
constexpr int64_t kSmemGoal = 72 * 1024;
constexpr int64_t kSmemMax = 232448;   // the most a block can have on sm_90

// 32-bit words of a block's shared output span: rows * M windows after a
// head of up to 3 words (the shared span is aligned like the global one),
// rounded up to 16 B.
__host__ __device__ inline int64_t out_words(int rows, int M) {
  return (int64_t{rows} * M + 3 + 3) / 4 * 4;
}

inline int64_t prep_smem(int rows, int L, int M) {
  return 2 * 4 * out_words(rows, M) + staged_bytes(int64_t{rows} * L);
}

// out[w] = s[w + h] for w < n, with 16 B stores where out + w is 16 B
// aligned (out - h is, so s + w + h is then too).
__device__ __forceinline__ void store_span(int32_t* out, const int32_t* s,
                                           int n, int h) {
  const int hd = min(n, (4 - h) & 3);
  const int n4 = (n - hd) >> 2;
  for (int i = threadIdx.x; i < hd; i += blockDim.x) out[i] = s[i + h];
  const int4* s4 = reinterpret_cast<const int4*>(s + hd + h);
  int4* o4 = reinterpret_cast<int4*>(out + hd);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) o4[i] = s4[i];
  for (int i = hd + 4 * n4 + threadIdx.x; i < n; i += blockDim.x)
    out[i] = s[i + h];
}

__global__ void __launch_bounds__(kThreads)
probe_prep_kernel(const uint8_t* __restrict__ codes, int64_t n_rows, int L,
                  int M, int k, bool canonical, uint32_t nb_mask,
                  uint32_t seed, int rows_per_block,
                  int32_t* __restrict__ bucket_out,
                  int32_t* __restrict__ fp_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = n_rows - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;
  const int64_t o0 = row0 * M;
  const int h = static_cast<int>(o0 & 3);
  const int64_t cap = out_words(rows_per_block, M);
  int32_t* s_b = reinterpret_cast<int32_t*>(smem);
  int32_t* s_f = s_b + cap;
  const uint8_t* s_c = stage_span(smem + 2 * 4 * cap, codes + row0 * L,
                                  int64_t{rows} * L);
  __syncthreads();

  const int runs = (M + kRun - 1) / kRun;
  for (int it = threadIdx.x; it < rows * runs; it += blockDim.x) {
    const int r = it / runs;
    const int j0 = (it - r * runs) * kRun;
    const int n = min(kRun, M - j0);
    int32_t* b_row = s_b + r * M + h;
    int32_t* f_row = s_f + r * M + h;
    walk_windows<kCodes>(
        RowSrc{s_c + r * L, nullptr, nullptr}, j0, n, n, k, canonical,
        [&](int j, uint32_t hi, uint32_t lo, bool ok) {
          f_row[j] = static_cast<int32_t>(fmix32(fmix32(lo ^ 0x85EBCA6Bu) ^ hi));
          b_row[j] = ok ? static_cast<int32_t>(
                              fmix32(fmix32(hi ^ (0x9E3779B9u ^ seed)) ^ lo) &
                              nb_mask)
                        : -1;
        });
  }
  __syncthreads();
  store_span(bucket_out + o0, s_b, rows * M, h);
  store_span(fp_out + o0, s_f, rows * M, h);
}

}  // namespace

extern "C" {

// codes uint8 [n_rows, L] -> bucket_out int32 [n_rows, M], fp_out uint32
// [n_rows, M], M = L - k + 1; both outputs 16 B aligned.
int probe_prep_launch(int device, const void* codes, long long n_rows, int L,
                      int k, int canonical, unsigned n_buckets, unsigned seed,
                      void* bucket_out, void* fp_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = L - k + 1;
  if (n_rows <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  // one work item per thread, in a multiple of 16 rows; halved while the
  // block's shared memory is above its goal
  const int runs = (M + kRun - 1) / kRun;
  int rows = ((kThreads + runs - 1) / runs + 15) / 16 * 16;
  while (rows > 1 && prep_smem(rows, L, M) > kSmemGoal) rows /= 2;
  const int64_t smem = prep_smem(rows, L, M);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  err = allow_smem(probe_prep_kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = (n_rows + rows - 1) / rows;
  probe_prep_kernel<<<static_cast<unsigned>(grid), kThreads,
                      static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n_rows, L, M, k, canonical != 0,
      n_buckets - 1u, seed, rows, static_cast<int32_t*>(bucket_out),
      static_cast<int32_t*>(fp_out));
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
