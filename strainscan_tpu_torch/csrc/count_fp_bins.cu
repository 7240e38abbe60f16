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
// Sorting the windows by table slice first costs the bytes of their 8 B
// (fp, bucket) pairs (63 MB a batch, more than the L2), written and read.
//
// What the design does about it
// -----------------------------
// A fine bin is a slice of 2^shift consecutive buckets (64 KiB of table at
// most), the unit the probe stages; a coarse bin is a run of consecutive
// fine bins, 2^coarse_shift buckets, at most kBinThreads of them.  The
// windows reach the probe grouped by fine bin through a two-digit bin sort,
// coarse digit first, whose stores land in runs rather than one 8 B pair at
// a time in any of 4,096 bins:
// 1. fp_coarse_count_kernel: each thread walks a run of kCountRun
//    consecutive windows of one read with the rolling-key walker of
//    kmer_window.cuh (shared with count_exact.cu and probe_count.cu),
//    stopping at the read's valid length with vlen; with vbytes or raw codes
//    it tracks the last invalid position instead.  Runs are handed out
//    run-major (thread i takes run i / rows of row i % rows), so with reads
//    of 150 bases padded to 256 the runs past the valid length fall to whole
//    warps that have nothing to do, not to every other lane of a warp.
//    A shared histogram counts the block's valid windows per coarse bin; the
//    block reserves its range inside each non-empty coarse bin with one
//    global atomicAdd, keeps the range's start and length in block_base, and
//    adds its invalid and padding windows to the trash slot in one atomic.
// 2. fp_coarse_scatter_kernel: every block scans the coarse totals in
//    shared memory (block 0 also writes them out as coarse_start), walks its
//    rows again (hashing is cheaper than a round trip of the windows' keys;
//    in runs of kScatterRun, shorter than the count's, so that more of its
//    threads walk: its staging buffer lets fewer blocks share an SM),
//    stages its pairs in shared memory grouped by coarse bin, and then
//    copies each coarse bin's run to its range with consecutive threads on
//    consecutive pairs.  A block with more valid windows than its staging
//    buffer holds (reads of more than ~8,000 bases) writes each pair to its
//    range directly.
// 3. fp_fine_split_kernel: one block per coarse bin counts its pairs per
//    fine bin in shared memory, writes those fine bins' starts into
//    bin_start, and then reads the bin again one chunk of 4,096 pairs at a
//    time: it groups the chunk by fine bin in shared memory and copies each
//    fine bin's run of it out with consecutive threads on consecutive pairs.
//    The block zeroes its coarse total for the next batch.  (Slower on an
//    H100: writing each pair to its fine bin's cursor directly; no faster: a
//    warp-aggregated cursor update, the bin kept in shared memory between
//    the two reads, two to eight blocks per coarse bin in a thread-block
//    cluster.)  A table of at most 256 fine bins (16 MiB at 64 lanes) has
//    one fine bin per coarse bin: the coarse scatter already leaves its
//    pairs in fine-bin order, so ops/probe.py::fp_bin_front launches no
//    split for it (the split would give the whole batch to one block per
//    bin: one SM of 132 for the one-bin table of the L2 union count).
// 4. fp_bin_probe_kernel: a persistent grid walks work items, each a slice
//    of one fine bin's windows: `parts` slices per bin, enough that the
//    items fill the card's block slots when the table has fewer bins than
//    that (parts == 1 for the E. coli table's 4,096 bins: one item per
//    bin).  A block copies its bin's contiguous rows into shared memory
//    with cp.async, padded so that 16 B reads at one lane offset of
//    different rows spread over the banks (a 256 B row stride would put
//    every row start on one bank), then resolves each of the slice's
//    windows against shared memory and adds its hit with a global atomic
//    that stays inside the bin's slice of counts, which the L2 holds.
//    With one part each row is read from device memory once per batch;
//    with several, every part stages the same rows, which the L2 then
//    serves.  A slice with fewer windows than half its bin's rows, or a
//    bin too large for shared memory (tables above 2 GiB), reads its rows
//    from global memory instead.  (A shared-memory copy of the slice's
//    counts, flushed once per bin, measured slower on an H100 with one part
//    a bin: its 64 KiB more shared memory per block cut the blocks per SM
//    from three to one.)
//
// Every entry point launches on the caller's stream, does not synchronise,
// and returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <type_traits>

#include "kmer_window.cuh"

namespace {

constexpr int kCountRun = 32;         // windows per work item (a run of
constexpr int kScatterRun = 16;       // one read) of the count, the scatter
constexpr int kBinThreads = 256;      // threads of the coarse passes, and
                                      // the most coarse bins
constexpr int kSplitThreads = 1024;   // threads of the fine split, and the
                                      // most fine bins per coarse bin
constexpr int kSplitUnroll = 4;       // pairs in flight per split thread
constexpr int kProbeThreads = 256;

// One read batch and the table geometry its windows hash into.
struct Batch {
  Reads r;
  uint32_t nb_mask, seed;
  int shift;               // coarse bin = bucket >> shift
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Exclusive prefix sum over the block of one value per thread (blockDim.x a
// multiple of 32); *total gets the sum.  s_warp holds 32 ints of shared
// memory.  Every thread of the block calls it; it synchronises the block.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += u;
  }
  __syncthreads();   // an earlier call is done reading s_warp
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFullMask, w, o);
      if (lane >= o) w += u;
    }
    s_warp[lane] = w;   // inclusive sums of the warp totals
  }
  __syncthreads();
  *total = s_warp[n_warps - 1];
  return incl - v + (warp > 0 ? s_warp[warp - 1] : 0);
}

// Calls f(bucket, fp) for every valid window j in [j0, j0 + kLen) of row
// `row` (the shared walker of kmer_window.cuh, reading the payload from
// device memory); returns how many there were.  With vlen the walk stops
// at the row's valid length.
template <int kForm, int kLen, class F>
__device__ __forceinline__ int walk_run(const Batch& b, int64_t row, int j0,
                                        F f) {
  const Reads& r = b.r;
  int jend = r.M;
  if (kForm == kVlen) {
    const int v = min(static_cast<int>(r.vlen[row]), r.L);
    jend = v - r.k + 1;
  }
  const int n = min(jend, j0 + kLen) - j0;
  if (n <= 0) return 0;
  const RowSrc src{r.codes + row * r.L, r.words + row * r.W,
                   r.vbytes + row * r.VB};
  int valid = 0;
  walk_windows<kForm>(src, j0, n, n, r.k, r.canonical,
                      [&](int, uint32_t hi, uint32_t lo, bool ok) {
                        if (!ok) return;
                        f(fmix32(fmix32(hi ^ (0x9E3779B9u ^ b.seed)) ^ lo) &
                              b.nb_mask,
                          fmix32(fmix32(lo ^ 0x85EBCA6Bu) ^ hi));
                        ++valid;
                      });
  return valid;
}

// The (row, run) items of block blockIdx.x: rows [row0, row0 + rows),
// run-major.
template <int kForm, int kLen, class F>
__device__ __forceinline__ int walk_block(const Batch& b, int rows_per_block,
                                          int* rows_out, F f) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = b.r.n_rows - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;
  const int runs = (b.r.M + kLen - 1) / kLen;
  int valid = 0;
  for (int it = threadIdx.x; it < rows * runs; it += blockDim.x) {
    const int run = it / rows;   // run-major: see the note at the top
    valid += walk_run<kForm, kLen>(b, row0 + (it - run * rows), run * kLen,
                                   f);
  }
  *rows_out = rows;
  return valid;
}

// block_base[block] = [the start of the block's range inside each coarse
// bin (n_coarse), the range's length (n_coarse)].
template <int kForm>
__global__ void __launch_bounds__(kBinThreads)
fp_coarse_count_kernel(Batch b, int n_coarse, int rows_per_block,
                       int32_t* __restrict__ coarse_count,
                       int32_t* __restrict__ block_base,
                       int32_t* __restrict__ counts, int64_t trash) {
  __shared__ int32_t s_hist[kBinThreads];
  __shared__ int s_valid;
  for (int i = threadIdx.x; i < n_coarse; i += blockDim.x) s_hist[i] = 0;
  if (threadIdx.x == 0) s_valid = 0;
  __syncthreads();
  const int shift = b.shift;
  int rows;
  int valid = walk_block<kForm, kCountRun>(b, rows_per_block, &rows,
                                [&](uint32_t bucket, uint32_t) {
                                  atomicAdd(&s_hist[bucket >> shift], 1);
                                });
  valid = warp_sum(valid);
  if ((threadIdx.x & 31) == 0) atomicAdd(&s_valid, valid);
  __syncthreads();
  int32_t* base = block_base + static_cast<int64_t>(blockIdx.x) * 2 * n_coarse;
  for (int i = threadIdx.x; i < n_coarse; i += blockDim.x) {
    const int c = s_hist[i];
    base[i] = c ? atomicAdd(coarse_count + i, c) : 0;
    base[n_coarse + i] = c;
  }
  if (threadIdx.x == 0) {
    const int non_hit = rows * b.r.M - s_valid;   // invalid and padding
    if (non_hit) atomicAdd(counts + trash, non_hit);
  }
}

template <int kForm>
__global__ void __launch_bounds__(kBinThreads)
fp_coarse_scatter_kernel(Batch b, int n_coarse, int rows_per_block,
                         int stage_cap, const int32_t* __restrict__ coarse_count,
                         const int32_t* __restrict__ block_base,
                         int32_t* __restrict__ coarse_start,
                         uint2* __restrict__ out) {
  extern __shared__ uint2 s_stage[];       // [stage_cap]
  __shared__ int32_t s_out[kBinThreads];   // the run's start in out
  __shared__ int32_t s_loc[kBinThreads];   // the run's start in s_stage
  __shared__ int32_t s_cur[kBinThreads];   // the run's next free place
  __shared__ int s_warp[32];
  const int t = threadIdx.x;
  const int32_t* base = block_base + static_cast<int64_t>(blockIdx.x) * 2 * n_coarse;
  const bool mine = t < n_coarse;
  int n_pairs, n_block;
  const int start = block_scan(mine ? coarse_count[t] : 0, s_warp, &n_pairs);
  const int loc = block_scan(mine ? base[n_coarse + t] : 0, s_warp, &n_block);
  const bool staged = n_block <= stage_cap;   // block-uniform
  if (mine) {
    s_out[t] = start + base[t];
    s_loc[t] = loc;
    s_cur[t] = staged ? loc : start + base[t];
    if (blockIdx.x == 0) coarse_start[t] = start;
  }
  if (blockIdx.x == 0 && t == 0) coarse_start[n_coarse] = n_pairs;
  __syncthreads();
  const int shift = b.shift;
  int rows;
  walk_block<kForm, kScatterRun>(b, rows_per_block, &rows,
                    [&](uint32_t bucket, uint32_t fp) {
                      const int pos = atomicAdd(&s_cur[bucket >> shift], 1);
                      if (staged)
                        s_stage[pos] = make_uint2(fp, bucket);
                      else
                        out[pos] = make_uint2(fp, bucket);
                    });
  if (!staged) return;
  __syncthreads();
  for (int i = t; i < n_block; i += blockDim.x) {
    const uint2 p = s_stage[i];
    const int c = static_cast<int>(p.y >> shift);
    out[s_out[c] + (i - s_loc[c])] = p;
  }
}

// Block c: the pairs of coarse bin c, in[coarse_start[c], coarse_start[c+1]),
// into fine-bin order (fine bin = bucket >> shift; 2^fine_log2 of them per
// coarse bin) at the same places of pairs, and their fine bins' starts.
// Each thread takes kSplitUnroll pairs of a chunk of step pairs.
__global__ void __launch_bounds__(kSplitThreads)
fp_fine_split_kernel(const uint2* __restrict__ in,
                     const int32_t* __restrict__ coarse_start, int n_coarse,
                     int shift, int fine_log2,
                     int32_t* __restrict__ coarse_count,
                     int32_t* __restrict__ bin_start,
                     uint2* __restrict__ pairs) {
  __shared__ int32_t s_fine[kSplitThreads];   // counts, then cursors
  __shared__ int32_t s_chunk[kSplitThreads];  // a chunk's counts, then
                                              // their starts in s_run
  __shared__ int32_t s_out[kSplitThreads];    // pairs - s_chunk
  __shared__ uint2 s_run[kSplitUnroll * kSplitThreads];
  __shared__ int s_warp[32];
  const int c = blockIdx.x, t = threadIdx.x;
  const int n_fine = 1 << fine_log2, f0 = c << fine_log2;
  const int begin = coarse_start[c], end = coarse_start[c + 1];
  for (int i = t; i < n_fine; i += blockDim.x) s_fine[i] = 0;
  if (t == 0) coarse_count[c] = 0;   // zero again for the next batch
  __syncthreads();
  const int step = kSplitUnroll * blockDim.x;
  for (int i0 = begin + t; i0 < end; i0 += step) {
    uint32_t bk[kSplitUnroll];
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      bk[u] = i < end ? in[i].y : 0u;
    }
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u)
      if (i0 + u * static_cast<int>(blockDim.x) < end)
        atomicAdd(&s_fine[static_cast<int>(bk[u] >> shift) - f0], 1);
  }
  __syncthreads();
  int total;
  const int at = begin + block_scan(t < n_fine ? s_fine[t] : 0, s_warp,
                                    &total);
  if (t < n_fine) {
    s_fine[t] = at;
    bin_start[f0 + t] = at;
  }
  if (c == n_coarse - 1 && t == 0) bin_start[n_coarse << fine_log2] = end;
  __syncthreads();
  // the second read, one chunk of step pairs at a time: the chunk is
  // grouped by fine bin in shared memory, then each fine bin's run of it is
  // copied out with consecutive threads on consecutive pairs
  for (int c0 = begin; c0 < end; c0 += step) {
    const int n = min(step, end - c0);
    for (int i = t; i < n_fine; i += blockDim.x) s_chunk[i] = 0;
    __syncthreads();
    uint2 p[kSplitUnroll];
    int f[kSplitUnroll], r[kSplitUnroll];
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      const int i = u * static_cast<int>(blockDim.x) + t;
      f[u] = -1;
      if (i < n) {
        p[u] = in[c0 + i];
        f[u] = static_cast<int>(p[u].y >> shift) - f0;
        r[u] = atomicAdd(&s_chunk[f[u]], 1);
      }
    }
    __syncthreads();
    int n_chunk;
    const int cnt = t < n_fine ? s_chunk[t] : 0;
    const int loc = block_scan(cnt, s_warp, &n_chunk);
    if (t < n_fine) {
      s_chunk[t] = loc;
      s_out[t] = s_fine[t] - loc;   // where the chunk's run of bin t goes
      s_fine[t] += cnt;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u)
      if (f[u] >= 0) s_run[s_chunk[f[u]] + r[u]] = p[u];
    __syncthreads();
    for (int i = t; i < n; i += blockDim.x) {
      const uint2 q = s_run[i];
      pairs[s_out[static_cast<int>(q.y >> shift) - f0] + i] = q;
    }
    __syncthreads();
  }
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
// row; an item is staged when its slice holds at least half as many
// windows as the bin has rows.  Item i is slice i % parts of bin i / parts:
// windows [begin + n * p / parts, begin + n * (p + 1) / parts) of the bin's
// n (ops/probe.py::fp_probe_slice).  (No faster for the one-bin table of
// the L2 union count on an H100: one global atomic per distinct slot of a
// warp's hits; 2.2 times slower: a shared-memory copy of the bin's counts,
// flushed at the item's end, at one block per SM instead of three.)
template <bool kVec>
__global__ void __launch_bounds__(kProbeThreads)
fp_bin_probe_kernel(const uint2* __restrict__ pairs,
                    const int32_t* __restrict__ bin_start, int n_bins,
                    int parts, const uint32_t* __restrict__ fp_table,
                    int bucket, int shift, int stride,
                    int32_t* __restrict__ counts, int64_t trash) {
  extern __shared__ __align__(16) uint32_t s_rows[];   // [slice_rows, stride]
  __shared__ int s_miss;
  const int slice_rows = 1 << shift;
  if (threadIdx.x == 0) s_miss = 0;
  int miss = 0;
  const int64_t n_items = static_cast<int64_t>(n_bins) * parts;
  for (int64_t item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int bin = static_cast<int>(item / parts);
    const int64_t part = item - static_cast<int64_t>(bin) * parts;
    const int64_t b0 = bin_start[bin], n = bin_start[bin + 1] - b0;
    const int begin = static_cast<int>(b0 + n * part / parts);
    const int end = static_cast<int>(b0 + n * (part + 1) / parts);
    if (begin == end) continue;   // block-uniform
    const int64_t row0 = static_cast<int64_t>(bin) << shift;
    const uint32_t* src = fp_table + row0 * bucket;
    const bool staged = stride > 0 && 2 * (end - begin) >= slice_rows;
    __syncthreads();   // the previous item is done with shared memory
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
  b.r = make_reads(codes, words, vlen, vbytes, n_rows, W, VB, L, k,
                   canonical);
  b.nb_mask = n_buckets - 1u;
  b.seed = seed;
  b.shift = shift;
  return b;
}

// Returns f(std::integral_constant<int, form>()) for the batch's payload
// form.
template <class F>
cudaError_t by_form(const void* codes, const void* vlen, F f) {
  switch (form_of(codes, vlen)) {
    case kCodes:
      return f(std::integral_constant<int, kCodes>());
    case kVlen:
      return f(std::integral_constant<int, kVlen>());
    default:
      return f(std::integral_constant<int, kVbytes>());
  }
}

// parts = ceil(block slots / n_bins) (ops/probe.py::fp_probe_parts): 1
// where the bins fill the card's block slots, as on the E. coli table.
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
  const int slots = max(1, sms * per_sm);
  const int parts = (slots + n_bins - 1) / n_bins;
  const int64_t items = static_cast<int64_t>(n_bins) * parts;
  const int grid = items < slots ? static_cast<int>(items) : slots;
  kernel<<<grid, kProbeThreads, smem, stream>>>(
      pairs, bin_start, n_bins, parts, fp_table, bucket, shift, stride,
      counts, trash);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Exactly one payload form: raw codes uint8 [n_rows, L], or words uint32
// [n_rows, W] with vlen uint16 [n_rows] or vbytes uint8 [n_rows, VB].  Adds
// the batch's valid windows per coarse bin (bucket >> coarse_shift) into
// coarse_count int32 [n_coarse] (zero on entry), writes block_base int32
// [n_blocks, 2, n_coarse] (each block's range in each coarse bin: start,
// length) and adds the invalid and padding windows to counts[trash].
// Block i walks rows [i * rows_per_block, (i + 1) * rows_per_block).
int fp_coarse_count_launch(int device, const void* codes, const void* words,
                           const void* vlen, const void* vbytes,
                           long long n_rows, int W, int VB, int L, int k,
                           int canonical, unsigned n_buckets, unsigned seed,
                           int coarse_shift, int n_coarse, int n_blocks,
                           int rows_per_block, void* coarse_count,
                           void* block_base, void* counts, long long trash,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Batch b = make_batch(codes, words, vlen, vbytes, n_rows, W, VB, L, k,
                             canonical, n_buckets, seed, coarse_shift);
  auto* cc = static_cast<int32_t*>(coarse_count);
  auto* bb = static_cast<int32_t*>(block_base);
  auto* cn = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  err = by_form(codes, vlen, [&](auto form) {
    fp_coarse_count_kernel<decltype(form)::value>
        <<<n_blocks, kBinThreads, 0, s>>>(b, n_coarse, rows_per_block, cc, bb,
                                          cn, trash);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// The same batch and blocks as fp_coarse_count_launch: writes coarse_start
// int32 [n_coarse + 1] (the exclusive prefix sums of coarse_count and their
// total) and every valid window's (fp, bucket) pair into out uint32
// [coarse_start[n_coarse], 2] in coarse-bin order.  A block stages up to
// stage_cap pairs in shared memory (8 B each).
int fp_coarse_scatter_launch(int device, const void* codes, const void* words,
                             const void* vlen, const void* vbytes,
                             long long n_rows, int W, int VB, int L, int k,
                             int canonical, unsigned n_buckets, unsigned seed,
                             int coarse_shift, int n_coarse, int n_blocks,
                             int rows_per_block, int stage_cap,
                             const void* coarse_count, const void* block_base,
                             void* coarse_start, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Batch b = make_batch(codes, words, vlen, vbytes, n_rows, W, VB, L, k,
                             canonical, n_buckets, seed, coarse_shift);
  auto* cc = static_cast<const int32_t*>(coarse_count);
  auto* bb = static_cast<const int32_t*>(block_base);
  auto* cs = static_cast<int32_t*>(coarse_start);
  auto* o = static_cast<uint2*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(stage_cap) * sizeof(uint2);
  err = by_form(codes, vlen, [&](auto form) {
    auto kernel = fp_coarse_scatter_kernel<decltype(form)::value>;
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<n_blocks, kBinThreads, smem, s>>>(b, n_coarse, rows_per_block,
                                               stage_cap, cc, bb, cs, o);
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// One block per coarse bin: the pairs in uint32 [coarse_start[n_coarse], 2]
// (grouped by coarse bin) into pairs in fine-bin order (fine bin = bucket >>
// shift, 2^fine_log2 fine bins per coarse bin), bin_start int32
// [(n_coarse << fine_log2) + 1] = the fine bins' starts and the total;
// coarse_count int32 [n_coarse] is zeroed for the next batch.
int fp_fine_split_launch(int device, const void* in, const void* coarse_start,
                         int n_coarse, int shift, int fine_log2,
                         void* coarse_count, void* bin_start, void* pairs,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  fp_fine_split_kernel<<<n_coarse, kSplitThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(in), static_cast<const int32_t*>(coarse_start),
      n_coarse, shift, fine_log2, static_cast<int32_t*>(coarse_count),
      static_cast<int32_t*>(bin_start), static_cast<uint2*>(pairs));
  return static_cast<int>(cudaGetLastError());
}

// Probes the pairs of every bin against fp_table uint32 [n_buckets, bucket]
// (bin i holds rows [i << shift, (i + 1) << shift)): counts[slot] += 1 per
// hit, counts[trash] += 1 per miss.  stride > 0: a bin's rows may be staged
// in shared memory at `stride` words a row; 0: rows are read from global
// memory.  vec: 16 B row reads (bucket % 4 == 0, fp_table 16 B aligned).
// With fewer bins than the card has block slots, each bin's windows are
// cut into parts (ops/probe.py::fp_probe_parts), one work item each.
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
