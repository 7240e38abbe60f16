// Hand-written Hopper (sm_90a) kernels of the main-path count: the
// fingerprint-mode count of one read batch as a bucket-binned probe.
//
// What they replace
// -----------------
// The Pallas kernel strainscan_tpu/ops/pallas_probe.py::probe_prep (bucket
// and fingerprint of every read window) fused with what XLA did around it in
// strainscan_tpu/ops/count.py::_count_core_fp: the device unpack of the
// 2-bit words (kmer/device.py::unpack_codes[_vlen]; or raw uint8 codes), the
// fingerprint-row probe (pallas_probe.py::lookup_fp_from_prep: the slot is
// bucket * bucket_width + the LOWEST lane whose fingerprint matches; an empty
// slot holds fp 0, so a window whose fp is 0 may "hit" one, and the stream-end
// remap drops it) and the scatter-add into slot-space int32 counts, where
// every window that is invalid or misses adds one to the trash slot
// counts[n_slots].  The counts are bit-identical to the plain twins.
//
// What bounds it on the card
// --------------------------
// Bytes: the fingerprint rows the batch's windows hit (every row of the
// 256 MiB E. coli table for a 65,536-read batch), the 32 B count sectors the
// hits touch (read and written), the packed payload.  Probing row by row in
// read order reads each row about 7.5 times from a table five times the size
// of the 50 MB L2, and leaves one dependent row read in flight per warp; the
// hashing is a few dozen integer operations per window and is not the bound.
//
// What the design does about it
// -----------------------------
// A bin is a slice of 2^shift consecutive buckets (64 KiB of table at most).
// 1. fp_bin_count_kernel: each thread walks a run of kRun consecutive
//    windows of one read with a rolling 2-bit key (and a rolling reverse
//    complement), stopping at the read's valid length with vlen; with vbytes
//    or raw codes it tracks the last invalid position instead.  A shared
//    histogram counts the block's valid windows per bin; the block then
//    reserves its range inside each bin with one global atomicAdd per bin
//    (the returned old value is its offset, kept in block_base), and adds
//    its invalid and padding windows to the trash slot in one atomic.
// 2. bin_scan_kernel: one block turns the bin totals into bin starts and
//    zeroes the totals for the next batch.
// 3. fp_bin_scatter_kernel: the same walk again (hashing is cheaper than a
//    round trip of the windows' keys), writing each valid window's 8 B
//    (fp, bucket) pair to bin_start[bin] + block_base[block][bin] + its rank
//    from a shared cursor.
// 4. fp_bin_probe_kernel: a persistent grid walks the bins.  A block copies
//    its bin's contiguous rows into shared memory with cp.async, padded so
//    that 16 B reads at one lane offset of different rows spread over the
//    banks (a 256 B row stride would put every row start on one bank), then
//    resolves each of the bin's windows against shared memory and adds its
//    hit with a global atomic that stays inside the bin's slice of counts,
//    which the L2 holds.  Each row is read from device memory once per
//    batch.  A bin with fewer windows than half its rows, or a bin too large
//    for shared memory (tables above 2 GiB), reads its rows from global
//    memory instead.  (A shared-memory copy of the slice's counts, flushed
//    once per bin, measured slower on an H100: its 64 KiB more shared memory
//    per block cut the blocks per SM from three to one.)
//
// Every entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include "kmer_window.cuh"

namespace {

constexpr int kRun = 64;              // windows per (row, run) work item
constexpr int kBinThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kProbeThreads = 256;

enum Form { kCodes = 0, kVlen = 1, kVbytes = 2 };

// One read batch in one payload form, and the table geometry its windows
// hash into.
struct Batch {
  const uint8_t* codes;    // [n_rows, L] raw codes (kCodes)
  const uint32_t* words;   // [n_rows, W] 2-bit words (kVlen, kVbytes)
  const uint16_t* vlen;    // [n_rows] valid prefix lengths (kVlen)
  const uint8_t* vbytes;   // [n_rows, VB] LSB-first validity bits (kVbytes)
  int64_t n_rows;
  int W, VB, L, M, k;
  bool canonical;
  uint32_t nb_mask, seed;
  int shift;               // bin = bucket >> shift
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Calls f(bucket, fp) for every valid window j in [j0, j0 + kRun) of row
// `row`; returns how many there were.  Bit-identical to probe_prep on the
// unpacked codes: the key packs k bases 5'-first (a code c >= 4 puts c & 3
// in the key and invalidates the window), canonical takes min(fwd, rc).
template <int kForm, class F>
__device__ __forceinline__ int walk_run(const Batch& b, int64_t row, int j0,
                                        F f) {
  int jend = b.M;
  if (kForm == kVlen) {
    const int v = min(static_cast<int>(b.vlen[row]), b.L);
    jend = v - b.k + 1;
  }
  jend = min(jend, j0 + kRun);
  if (j0 >= jend) return 0;
  const uint64_t kmask = (1ull << (2 * b.k)) - 1;
  const int rc_shift = 2 * (b.k - 1);
  const uint8_t* crow = b.codes + row * b.L;
  const uint32_t* wrow = b.words + row * b.W;
  const uint8_t* vrow = b.vbytes + row * b.VB;
  uint64_t fwd = 0, rc = 0;
  uint32_t word = 0;
  int last_bad = -1;   // the last invalid position seen
  int n = 0;
  const int p_end = jend + b.k - 1;
  for (int p = j0; p < p_end; ++p) {
    uint32_t c;
    if (kForm == kCodes) {
      c = crow[p];
      if (c >= 4) last_bad = p;
      c &= 3u;
    } else {
      if ((p & 15) == 0 || p == j0) word = wrow[p >> 4];
      c = (word >> (2 * (p & 15))) & 3u;
      if (kForm == kVbytes && !((vrow[p >> 3] >> (p & 7)) & 1u)) last_bad = p;
    }
    fwd = ((fwd << 2) | c) & kmask;
    rc = (rc >> 2) | (static_cast<uint64_t>(3u - c) << rc_shift);
    const int j = p - b.k + 1;
    if (j >= j0 && last_bad < j) {
      const uint64_t key = (b.canonical && rc < fwd) ? rc : fwd;
      const uint32_t hi = static_cast<uint32_t>(key >> 32);
      const uint32_t lo = static_cast<uint32_t>(key);
      f(fmix32(fmix32(hi ^ (0x9E3779B9u ^ b.seed)) ^ lo) & b.nb_mask,
        fmix32(fmix32(lo ^ 0x85EBCA6Bu) ^ hi));
      ++n;
    }
  }
  return n;
}

// The (row, run) items of block blockIdx.x: rows [row0, row0 + rows).
template <int kForm, class F>
__device__ __forceinline__ int walk_block(const Batch& b, int rows_per_block,
                                          int* rows_out, F f) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = b.n_rows - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;
  const int runs = (b.M + kRun - 1) / kRun;
  int valid = 0;
  for (int it = threadIdx.x; it < rows * runs; it += blockDim.x) {
    const int r = it / runs;
    valid += walk_run<kForm>(b, row0 + r, (it - r * runs) * kRun, f);
  }
  *rows_out = rows;
  return valid;
}

template <int kForm>
__global__ void __launch_bounds__(kBinThreads)
fp_bin_count_kernel(Batch b, int n_bins, int rows_per_block,
                    int32_t* __restrict__ bin_count,
                    int32_t* __restrict__ block_base,
                    int32_t* __restrict__ counts, int64_t trash) {
  extern __shared__ int32_t s_hist[];   // [n_bins]
  __shared__ int s_valid;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) s_hist[i] = 0;
  if (threadIdx.x == 0) s_valid = 0;
  __syncthreads();
  const int shift = b.shift;
  int rows;
  int valid = walk_block<kForm>(b, rows_per_block, &rows,
                                [&](uint32_t bucket, uint32_t) {
                                  atomicAdd(&s_hist[bucket >> shift], 1);
                                });
  valid = warp_sum(valid);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_valid, valid);
  __syncthreads();
  int32_t* base = block_base + static_cast<int64_t>(blockIdx.x) * n_bins;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
    const int c = s_hist[i];
    base[i] = c ? atomicAdd(bin_count + i, c) : 0;
  }
  if (threadIdx.x == 0) {
    const int non_hit = rows * b.M - s_valid;   // invalid and padding
    if (non_hit) atomicAdd(counts + trash, non_hit);
  }
}

// One block: bin_start[i] = sum of bin_count[:i] (i <= n_bins), then
// bin_count = 0.
__global__ void __launch_bounds__(kScanThreads)
bin_scan_kernel(int32_t* __restrict__ bin_count, int n_bins,
                int32_t* __restrict__ bin_start) {
  __shared__ int s_warp[kScanThreads / 32];
  const int per = (n_bins + blockDim.x - 1) / blockDim.x;
  const int i0 = min(n_bins, static_cast<int>(threadIdx.x) * per);
  const int i1 = min(n_bins, i0 + per);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += bin_count[i];
  // inclusive scan of the per-thread sums across the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < static_cast<int>(blockDim.x >> 5) ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFullMask, w, o);
      if (lane >= o) w += v;
    }
    s_warp[lane] = w;   // inclusive warp totals
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    bin_start[i] = run;
    run += bin_count[i];
    bin_count[i] = 0;
  }
  if (threadIdx.x == blockDim.x - 1) bin_start[n_bins] = run;
}

template <int kForm>
__global__ void __launch_bounds__(kBinThreads)
fp_bin_scatter_kernel(Batch b, int n_bins, int rows_per_block,
                      const int32_t* __restrict__ bin_start,
                      const int32_t* __restrict__ block_base,
                      uint2* __restrict__ pairs) {
  extern __shared__ int32_t s_cur[];   // [n_bins]
  const int32_t* base = block_base + static_cast<int64_t>(blockIdx.x) * n_bins;
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x)
    s_cur[i] = bin_start[i] + base[i];
  __syncthreads();
  const int shift = b.shift;
  int rows;
  walk_block<kForm>(b, rows_per_block, &rows,
                    [&](uint32_t bucket, uint32_t fp) {
                      const int pos = atomicAdd(&s_cur[bucket >> shift], 1);
                      pairs[pos] = make_uint2(fp, bucket);
                    });
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The lowest lane of a row holding fp, or -1.  kVec: 16 B reads (bucket % 4
// == 0, rows 16 B aligned).
template <bool kVec>
__device__ __forceinline__ int find_lane(const uint32_t* row, int bucket,
                                         uint32_t fp) {
  if (kVec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int c = 0; c < (bucket >> 2); ++c) {
      const uint4 v = r4[c];
      if (v.x == fp) return 4 * c;
      if (v.y == fp) return 4 * c + 1;
      if (v.z == fp) return 4 * c + 2;
      if (v.w == fp) return 4 * c + 3;
    }
  } else {
    for (int l = 0; l < bucket; ++l)
      if (row[l] == fp) return l;
  }
  return -1;
}

// Staged (stride > 0): a bin's rows fit shared memory at `stride` words a
// row; a bin is staged when it holds at least half as many windows as rows.
template <bool kVec>
__global__ void __launch_bounds__(kProbeThreads)
fp_bin_probe_kernel(const uint2* __restrict__ pairs,
                    const int32_t* __restrict__ bin_start, int n_bins,
                    const uint32_t* __restrict__ fp_table, int bucket,
                    int shift, int stride, int32_t* __restrict__ counts,
                    int64_t trash) {
  extern __shared__ __align__(16) uint32_t s_rows[];   // [slice_rows, stride]
  __shared__ int s_miss;
  const int slice_rows = 1 << shift;
  if (threadIdx.x == 0) s_miss = 0;
  int miss = 0;
  for (int bin = blockIdx.x; bin < n_bins; bin += gridDim.x) {
    const int begin = bin_start[bin], end = bin_start[bin + 1];
    if (begin == end) continue;   // block-uniform
    const int64_t row0 = static_cast<int64_t>(bin) << shift;
    const uint32_t* src = fp_table + row0 * bucket;
    const bool staged = stride > 0 && 2 * (end - begin) >= slice_rows;
    __syncthreads();   // the previous bin is done with shared memory
    if (staged) {
      if (kVec) {
        const int cpr = bucket >> 2;
        for (int i = threadIdx.x; i < slice_rows * cpr; i += blockDim.x) {
          const int r = i / cpr, c = i - r * cpr;
          cp_async16(s_rows + r * stride + 4 * c, src + r * bucket + 4 * c);
        }
      } else {
        for (int i = threadIdx.x; i < slice_rows * bucket; i += blockDim.x) {
          const int r = i / bucket, l = i - r * bucket;
          cp_async4(s_rows + r * stride + l, src + i);
        }
      }
      cp_async_wait_all();
    }
    __syncthreads();
    for (int i = begin + threadIdx.x; i < end; i += blockDim.x) {
      const uint2 p = pairs[i];
      const int r = static_cast<int>(p.y - row0);
      const uint32_t* row = staged ? s_rows + r * stride
                                   : src + static_cast<int64_t>(r) * bucket;
      const int lane = find_lane<kVec>(row, bucket, p.x);
      if (lane < 0)
        ++miss;
      else
        atomicAdd(counts + static_cast<int64_t>(p.y) * bucket + lane, 1);
    }
  }
  miss = warp_sum(miss);
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && miss) atomicAdd(&s_miss, miss);
  __syncthreads();
  if (threadIdx.x == 0 && s_miss) atomicAdd(counts + trash, s_miss);
}

Batch make_batch(const void* codes, const void* words, const void* vlen,
                 const void* vbytes, long long n_rows, int W, int VB, int L,
                 int k, int canonical, unsigned n_buckets, unsigned seed,
                 int shift) {
  Batch b;
  b.codes = static_cast<const uint8_t*>(codes);
  b.words = static_cast<const uint32_t*>(words);
  b.vlen = static_cast<const uint16_t*>(vlen);
  b.vbytes = static_cast<const uint8_t*>(vbytes);
  b.n_rows = n_rows;
  b.W = W;
  b.VB = VB;
  b.L = L;
  b.M = L - k + 1;
  b.k = k;
  b.canonical = canonical != 0;
  b.nb_mask = n_buckets - 1u;
  b.seed = seed;
  b.shift = shift;
  return b;
}

int form_of(const void* codes, const void* vlen) {
  return codes != nullptr ? kCodes : (vlen != nullptr ? kVlen : kVbytes);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int kForm>
cudaError_t launch_count(const Batch& b, int n_bins, int n_blocks,
                         int rows_per_block, int32_t* bin_count,
                         int32_t* block_base, int32_t* counts, int64_t trash,
                         cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_bins) * sizeof(int32_t);
  cudaError_t err = allow_smem(fp_bin_count_kernel<kForm>, smem);
  if (err != cudaSuccess) return err;
  fp_bin_count_kernel<kForm><<<n_blocks, kBinThreads, smem, stream>>>(
      b, n_bins, rows_per_block, bin_count, block_base, counts, trash);
  return cudaGetLastError();
}

template <int kForm>
cudaError_t launch_scatter(const Batch& b, int n_bins, int n_blocks,
                           int rows_per_block, const int32_t* bin_start,
                           const int32_t* block_base, uint2* pairs,
                           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_bins) * sizeof(int32_t);
  cudaError_t err = allow_smem(fp_bin_scatter_kernel<kForm>, smem);
  if (err != cudaSuccess) return err;
  fp_bin_scatter_kernel<kForm><<<n_blocks, kBinThreads, smem, stream>>>(
      b, n_bins, rows_per_block, bin_start, block_base, pairs);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_probe(const uint2* pairs, const int32_t* bin_start,
                         int n_bins, const uint32_t* fp_table, int bucket,
                         int shift, int stride, int32_t* counts,
                         int64_t trash, int device, cudaStream_t stream) {
  auto kernel = fp_bin_probe_kernel<kVec>;
  const size_t smem = (static_cast<size_t>(stride) << shift) * 4;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kProbeThreads, smem);
  if (err != cudaSuccess) return err;
  const int grid = min(n_bins, max(1, sms * per_sm));
  kernel<<<grid, kProbeThreads, smem, stream>>>(
      pairs, bin_start, n_bins, fp_table, bucket, shift, stride, counts,
      trash);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Exactly one payload form: raw codes uint8 [n_rows, L], or words uint32
// [n_rows, W] with vlen uint16 [n_rows] or vbytes uint8 [n_rows, VB].  Adds
// the batch's valid windows per bin into bin_count int32 [n_bins] (zero on
// entry), writes block_base int32 [n_blocks, n_bins] and adds the invalid
// and padding windows to counts[trash].  Block i walks rows
// [i * rows_per_block, (i + 1) * rows_per_block).
int fp_bin_count_launch(int device, const void* codes, const void* words,
                        const void* vlen, const void* vbytes,
                        long long n_rows, int W, int VB, int L, int k,
                        int canonical, unsigned n_buckets, unsigned seed,
                        int shift, int n_bins, int n_blocks,
                        int rows_per_block, void* bin_count, void* block_base,
                        void* counts, long long trash, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Batch b = make_batch(codes, words, vlen, vbytes, n_rows, W, VB, L, k,
                             canonical, n_buckets, seed, shift);
  auto* bc = static_cast<int32_t*>(bin_count);
  auto* bb = static_cast<int32_t*>(block_base);
  auto* cn = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  switch (form_of(codes, vlen)) {
    case kCodes:
      err = launch_count<kCodes>(b, n_bins, n_blocks, rows_per_block, bc, bb,
                                 cn, trash, s);
      break;
    case kVlen:
      err = launch_count<kVlen>(b, n_bins, n_blocks, rows_per_block, bc, bb,
                                cn, trash, s);
      break;
    default:
      err = launch_count<kVbytes>(b, n_bins, n_blocks, rows_per_block, bc,
                                  bb, cn, trash, s);
  }
  return static_cast<int>(err);
}

// bin_start int32 [n_bins + 1] = exclusive prefix sums of bin_count int32
// [n_bins] (and their total); bin_count is zeroed.
int bin_scan_launch(int device, void* bin_count, int n_bins, void* bin_start,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_scan_kernel<<<1, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(bin_count), n_bins,
      static_cast<int32_t*>(bin_start));
  return static_cast<int>(cudaGetLastError());
}

// The same batch and blocks as fp_bin_count_launch: writes every valid
// window's (fp, bucket) pair into pairs uint32 [bin_start[n_bins], 2] in bin
// order.
int fp_bin_scatter_launch(int device, const void* codes, const void* words,
                          const void* vlen, const void* vbytes,
                          long long n_rows, int W, int VB, int L, int k,
                          int canonical, unsigned n_buckets, unsigned seed,
                          int shift, int n_bins, int n_blocks,
                          int rows_per_block, const void* bin_start,
                          const void* block_base, void* pairs, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Batch b = make_batch(codes, words, vlen, vbytes, n_rows, W, VB, L, k,
                             canonical, n_buckets, seed, shift);
  auto* bs = static_cast<const int32_t*>(bin_start);
  auto* bb = static_cast<const int32_t*>(block_base);
  auto* pr = static_cast<uint2*>(pairs);
  auto s = static_cast<cudaStream_t>(stream);
  switch (form_of(codes, vlen)) {
    case kCodes:
      err = launch_scatter<kCodes>(b, n_bins, n_blocks, rows_per_block, bs,
                                   bb, pr, s);
      break;
    case kVlen:
      err = launch_scatter<kVlen>(b, n_bins, n_blocks, rows_per_block, bs,
                                  bb, pr, s);
      break;
    default:
      err = launch_scatter<kVbytes>(b, n_bins, n_blocks, rows_per_block, bs,
                                    bb, pr, s);
  }
  return static_cast<int>(err);
}

// Probes the pairs of every bin against fp_table uint32 [n_buckets, bucket]
// (bin i holds rows [i << shift, (i + 1) << shift)): counts[slot] += 1 per
// hit, counts[trash] += 1 per miss.  stride > 0: a bin's rows may be staged
// in shared memory at `stride` words a row; 0: rows are read from global
// memory.  vec: 16 B row reads (bucket % 4 == 0, fp_table 16 B aligned).
int fp_bin_probe_launch(int device, const void* pairs, const void* bin_start,
                        int n_bins, const void* fp_table, int bucket,
                        int shift, int stride, int vec, void* counts,
                        long long trash, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* pr = static_cast<const uint2*>(pairs);
  auto* bs = static_cast<const int32_t*>(bin_start);
  auto* ft = static_cast<const uint32_t*>(fp_table);
  auto* cn = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    err = launch_probe<true>(pr, bs, n_bins, ft, bucket, shift, stride, cn,
                             trash, device, s);
  else
    err = launch_probe<false>(pr, bs, n_bins, ft, bucket, shift, stride, cn,
                              trash, device, s);
  return static_cast<int>(err);
}

}  // extern "C"
