// Hand-written Hopper (sm_90a) kernels of the exact probe mode.
//
// What they replace
// -----------------
// count_exact_kernel and exact_apply_kernel are, together, the exact-mode
// count of the JAX package, which is plain XLA there, not Pallas:
// strainscan_tpu/ops/count.py::_count_core (count_batch on raw uint8 codes,
// count_batch_packed on 2-bit words + validity bits) around
// strainscan_tpu/index/hashtable.py::lookup_device.  Per window:
//   * the key of the window packed 5'-first, min(fwd, revcomp) with
//     canonical (the rolling-key walker of kmer_window.cuh);
//   * the UNSEEDED home row b = fmix(fmix(hi ^ 0x9E3779B9) ^ lo) & mask;
//   * for p < max_probe, row (b + p) & mask of the interleaved table
//     (KmerTable.interleaved: 8 slots x (hi, lo, val) int32 = 96 B); a slot
//     hits when hi and lo match and val >= 0, a row yields the largest hit
//     val, and the first row that hits wins (no later row is read).  A
//     window reads every row up to max_probe before it misses: a loaded
//     DB's table need not keep a probing invariant, so an empty slot stops
//     nothing;
//   * one added to the id-space accumulator counts[id]; a window that is
//     invalid, padding or a miss (or whose id is not in [0, n_keys)) counts
//     into the trash entry counts[n_keys], which the JAX scatter slices away.
//
// What bounds them on the card
// ----------------------------
// At 28.6 M keys the table is 2^24 rows x 96 B = 1.6 GB, far outside the
// 50 MB L2.  A batch of 65,536 reads of 150 bp has about 7.9 M windows, 0.47
// per row, so each probe is a device-memory read of a row no other window
// of the batch reads (binning the windows by table slice, as
// count_fp_bins.cu does for the 256 MiB fingerprint table, would stage
// slices that are mostly unused).  Each hit then adds into a 114 MB counts
// array, also larger than the L2.  Hashing is a few dozen integer
// operations per window.  Both are random accesses to device memory, and
// on an H100 they add up: the rows alone and the adds alone each took about
// half of a kernel that did both (chip_smoke.py times the parts).
//
// What the design does about it
// -----------------------------
// count_exact_kernel (the probe):
// * A block takes up to 64 reads, halved while their payload would take
//   more than kSmemGoal of shared memory (long reads), and stages the
//   payload in shared memory with 16 B loads (stage_span).  For each read
//   it finds where the valid windows end (vlen, or the last set validity
//   bit), so padding windows are neither walked nor hashed: they only
//   count, arithmetically.
// * The lanes of a warp walk 32 runs of kRun consecutive windows with the
//   shared walker, in step, and append every valid window's (hi, lo, row,
//   probes left) to the warp's queue in shared memory (a ballot gives each
//   lane its place; no atomics).
// * Whenever the queue holds 32 x kUnroll windows the warp drains it: each
//   lane takes kUnroll windows and issues all kUnroll x six 16 B row loads
//   back to back before it resolves any.  A window that does not hit in its
//   row goes back on the queue with the next row, for a later drain, until
//   its max_probe rows are read.
// * A hit does not touch counts: its id goes into the block's region of a
//   hit list (one id per window of its reads, so it cannot overflow),
//   coalesced per warp.  count_exact_list_shape gives the list's size.
//   The block adds its trash (windows minus hits) with one atomic and
//   writes its region's length.
// exact_apply_kernel (the adds): the grid walks the id space one slice at a
// time (the largest power of two of bytes of counts within a third of the
// L2: 16 MiB on an H100, whose 50 MB L2 also holds the streamed list and
// the probe's rows); each block
// prefetches its share of the slice into the L2 with bulk prefetches, then
// reads its regions of the list with streaming loads, eight ids in flight
// per thread, and adds one for every id inside the slice with a
// fire-and-forget reduction (red) marked evict-last.  The list is read
// once per slice, and every add lands in the L2.
//
// The entry points launch on the caller's stream, do not synchronise, and
// return cudaGetLastError() so the wrapper can raise on a refused launch.

#include "kmer_window.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;    // reads per block at most (two per lane of
                                // warp 0)
// staged payload a block may take before its reads are halved: two blocks
// and their queues on one SM
constexpr int64_t kSmemGoal = 64 * 1024;
constexpr int kRun = 32;        // windows per work item
constexpr int kRowVecs = 6;     // 24 int32 = 6 x int4 per table row
constexpr int kUnroll = 2;      // table rows each lane has in flight
constexpr int kApplyThreads = 256;
constexpr int kApplyBatch = 8;  // ids each thread of the add stage loads
constexpr int kPrefetchChunk = 1 << 16;   // bytes per prefetch instruction

// An L2 policy that keeps the lines it touches longer than others.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// *p += 1 without a return value, the line kept under `policy`.
__device__ __forceinline__ void add_one(int32_t* p, uint64_t policy) {
  asm volatile("red.global.add.L2::cache_hint.s32 [%0], 1, %1;" ::"l"(p),
               "l"(policy)
               : "memory");
}

// Prefetches the bytes [p, p + n) into the L2 (p 16 B aligned, n a multiple
// of 16).
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t n) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p), "r"(n)
               : "memory");
}

// A window of a warp's queue that still has a row to probe (16 B, so a lane
// reads it in one shared-memory load).
struct __align__(16) Queue {
  uint32_t hi, lo, row;
  int left;   // rows left to probe, this one included
};

struct Probe {
  Queue* q;                 // this warp's queue, 32 * (kUnroll + 1) entries
  int n;                    // entries queued (the same on every lane)
  const int4* table;
  uint32_t mask;
  int64_t n_keys;
  int32_t* list;            // the block's region of the hit list
  int* s_n;                 // ids in it so far (shared)

  // Take the last min(n, 32 kUnroll) entries, kUnroll per lane; load their
  // rows, resolve them, list the hits, and queue each window that misses
  // and has rows left.
  __device__ __forceinline__ void drain(int lane) {
    const int take = min(n, 32 * kUnroll);
    const int first = n - take;
    __syncwarp();   // the entries other lanes wrote are visible
    Queue e[kUnroll];
    bool has[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      has[u] = u * 32 + lane < take;
      if (has[u]) e[u] = q[first + u * 32 + lane];
    }
    n = first;
    __syncwarp();   // every lane has its entries before the requeue writes
    int4 v[kUnroll][kRowVecs];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (has[u]) {
        const int4* row = table + static_cast<int64_t>(e[u].row) * kRowVecs;
#pragma unroll
        for (int c = 0; c < kRowVecs; ++c) v[u][c] = __ldg(row + c);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int32_t id = -1;
      if (has[u]) {
        int32_t s[4 * kRowVecs];
#pragma unroll
        for (int c = 0; c < kRowVecs; ++c) {
          s[4 * c] = v[u][c].x;
          s[4 * c + 1] = v[u][c].y;
          s[4 * c + 2] = v[u][c].z;
          s[4 * c + 3] = v[u][c].w;
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int32_t val = s[3 * t + 2];
          if (static_cast<uint32_t>(s[3 * t]) == e[u].hi &&
              static_cast<uint32_t>(s[3 * t + 1]) == e[u].lo && val > id)
            id = val;   // val >= 0 since id starts at -1
        }
      }
      const bool hit = id >= 0 && id < n_keys;
      const unsigned hm = __ballot_sync(kFullMask, hit);
      if (hm) {
        int at = 0;
        if (lane == 0) at = atomicAdd(s_n, __popc(hm));
        at = __shfl_sync(kFullMask, at, 0);
        if (hit) list[at + __popc(hm & ((1u << lane) - 1u))] = id;
      }
      const bool again = has[u] && id < 0 && e[u].left > 1;
      const unsigned m = __ballot_sync(kFullMask, again);
      if (again) {
        const int pos = n + __popc(m & ((1u << lane) - 1u));
        q[pos] = Queue{e[u].hi, e[u].lo, (e[u].row + 1u) & mask,
                       e[u].left - 1};
      }
      n += __popc(m);
    }
  }
};

// Where the valid windows of a staged row end: the valid length (vlen), one
// past the last set validity bit (vbytes), or L (codes), less k - 1, in
// [0, M].
template <int kForm>
__device__ __forceinline__ int valid_end(const Reads& b, int64_t row,
                                         const uint8_t* vb) {
  int end = b.L;
  if (kForm == kVlen) {
    end = min(static_cast<int>(b.vlen[row]), b.L);
  } else if (kForm == kVbytes) {
    end = 0;
    for (int i = b.VB - 1; i >= 0; --i) {
      if (vb[i]) {
        end = min(8 * i + 32 - __clz(static_cast<unsigned>(vb[i])), b.L);
        break;
      }
    }
  }
  return max(0, min(end - b.k + 1, b.M));
}

template <int kForm>
__global__ void __launch_bounds__(kThreads, 2)
count_exact_kernel(Reads b, const int4* __restrict__ table, uint32_t mask,
                   int max_probe, int rows_per_block,
                   int32_t* __restrict__ counts, int64_t n_keys,
                   int32_t* __restrict__ list, int32_t* __restrict__ n_list) {
  extern __shared__ __align__(16) uint8_t s_pay[];   // staged payload
  __shared__ Queue s_q[kWarps][32 * (kUnroll + 1)];
  __shared__ int s_jend[kMaxRows];
  __shared__ int s_start[kMaxRows + 1];   // first item of each row
  __shared__ int s_hits;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = b.n_rows - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;

  // stage the block's payload: codes, or words (+ validity bits)
  const int64_t n_main = kForm == kCodes ? int64_t{rows} * b.L
                                         : int64_t{rows} * b.W * 4;
  const uint8_t* s_main = stage_span(
      s_pay,
      kForm == kCodes ? b.codes + row0 * b.L
                      : reinterpret_cast<const uint8_t*>(b.words + row0 * b.W),
      n_main);
  const uint8_t* s_vb = nullptr;
  if (kForm == kVbytes)
    s_vb = stage_span(s_pay + staged_bytes(n_main), b.vbytes + row0 * b.VB,
                      int64_t{rows} * b.VB);
  if (threadIdx.x == 0) s_hits = 0;
  __syncthreads();

  // each row's valid windows [0, jend) in runs of kRun: the item table
  // (rows past the block's have none)
  if (warp == 0) {
    int runs[2], jend[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * lane + h;
      jend[h] = r < rows ? valid_end<kForm>(b, row0 + r, s_vb + r * b.VB) : 0;
      runs[h] = (jend[h] + kRun - 1) / kRun;
      s_jend[r] = jend[h];
    }
    const int sum = runs[0] + runs[1];
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFullMask, incl, o);
      if (lane >= o) incl += v;
    }
    s_start[2 * lane] = incl - sum;
    s_start[2 * lane + 1] = incl - sum + runs[0];
    if (lane == 31) s_start[kMaxRows] = incl;
  }
  __syncthreads();

  const int items = s_start[kMaxRows];
  Probe pr{s_q[warp], 0,      table, mask, n_keys,
           list + int64_t{blockIdx.x} * rows_per_block * b.M, &s_hits};
  const bool canonical = b.canonical;
  const int k = b.k;
  for (int base = warp * 32; base < items; base += kThreads) {
    const int it = base + lane;
    int r = 0, j0 = 0, n = 0;
    if (it < items) {
      int lo = 0, hi = kMaxRows;   // s_start[lo] <= it < s_start[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_start[mid] <= it) lo = mid; else hi = mid;
      }
      r = lo;
      j0 = (it - s_start[r]) * kRun;
      n = min(kRun, s_jend[r] - j0);
    }
    int steps = n;
    for (int o = 16; o > 0; o >>= 1)
      steps = max(steps, __shfl_xor_sync(kFullMask, steps, o));
    const RowSrc src{
        s_main + r * b.L,
        reinterpret_cast<const uint32_t*>(s_main) + r * b.W,
        s_vb + r * b.VB};
    walk_windows<kForm>(
        src, j0, n, steps, k, canonical,
        [&](int, uint32_t khi, uint32_t klo, bool ok) {
          const unsigned m = __ballot_sync(kFullMask, ok);
          if (ok) {
            const uint32_t home =
                fmix32(fmix32(khi ^ 0x9E3779B9u) ^ klo) & mask;
            pr.q[pr.n + __popc(m & ((1u << lane) - 1u))] =
                Queue{khi, klo, home, max_probe};
          }
          pr.n += __popc(m);
          while (pr.n >= 32 * kUnroll) pr.drain(lane);
        });
  }
  while (pr.n > 0) pr.drain(lane);

  __syncthreads();
  if (threadIdx.x == 0) {
    const int trash = rows * b.M - s_hits;
    if (trash) atomicAdd(counts + n_keys, trash);
    n_list[blockIdx.x] = s_hits;
  }
}

// The add stage: counts[id] += 1 for every id of the hit list.  Block
// (g, s) takes the ids of slice s, [s * slice, (s + 1) * slice), from the
// regions g, g + G, ... of the list (G = gridDim.x), after prefetching its
// 1/G share of the slice's counts into the L2.  The grid runs slice after
// slice (blockIdx.y is the slow index), so each slice's counts sit in the
// L2 while its adds land, and the list is read once per slice.
__global__ void __launch_bounds__(kApplyThreads)
exact_apply_kernel(const int32_t* __restrict__ list,
                   const int32_t* __restrict__ n_list, int64_t region,
                   int n_regions, int32_t* __restrict__ counts,
                   int64_t n_keys, int64_t slice) {
  const int64_t lo = int64_t{blockIdx.y} * slice;
  const int64_t hi = lo + slice < n_keys ? lo + slice : n_keys;
  // this block's share of the slice's whole 16 B chunks
  const uintptr_t a0 =
      (reinterpret_cast<uintptr_t>(counts + lo) + 15) & ~uintptr_t{15};
  const uintptr_t a1 = reinterpret_cast<uintptr_t>(counts + hi) &
                       ~uintptr_t{15};
  if (a1 > a0) {
    const uintptr_t share =
        ((a1 - a0 + gridDim.x - 1) / gridDim.x + 15) & ~uintptr_t{15};
    const uintptr_t s0 = a0 + share * blockIdx.x;
    const uintptr_t s1 = a1 < s0 + share ? a1 : s0 + share;
    for (uintptr_t o = s0 + uintptr_t{threadIdx.x} * kPrefetchChunk; o < s1;
         o += uintptr_t{kApplyThreads} * kPrefetchChunk) {
      const uintptr_t n = s1 - o < kPrefetchChunk ? s1 - o : kPrefetchChunk;
      prefetch_l2(reinterpret_cast<const void*>(o), static_cast<uint32_t>(n));
    }
  }
  const uint64_t policy = evict_last_policy();
  for (int r = blockIdx.x; r < n_regions; r += gridDim.x) {
    const int32_t* ids = list + r * region;
    const int n = n_list[r];
    for (int i = threadIdx.x; i < n; i += kApplyThreads * kApplyBatch) {
      int32_t id[kApplyBatch];
#pragma unroll
      for (int u = 0; u < kApplyBatch; ++u) {
        const int j = i + u * kApplyThreads;
        id[u] = j < n ? __ldcs(ids + j) : -1;
      }
#pragma unroll
      for (int u = 0; u < kApplyBatch; ++u)
        if (id[u] >= lo && id[u] < hi) add_one(counts + id[u], policy);
    }
  }
}

// Dynamic shared memory of a block of `rows` reads: the staged payload.
int64_t exact_smem(const Reads& b, int form, int rows) {
  if (form == kCodes) return staged_bytes(int64_t{rows} * b.L);
  int64_t s = staged_bytes(int64_t{rows} * b.W * 4);
  if (form == kVbytes) s += staged_bytes(int64_t{rows} * b.VB);
  return s;
}

// Reads per block: kMaxRows, halved while their payload is above the goal.
int exact_rows(const Reads& b, int form) {
  int rows = kMaxRows;
  while (rows > 1 && exact_smem(b, form, rows) > kSmemGoal) rows /= 2;
  return rows;
}

template <int kForm>
cudaError_t launch(const Reads& b, int rows, const int4* table, uint32_t mask,
                   int max_probe, int32_t* counts, int64_t n_keys,
                   int32_t* list, int32_t* n_list, cudaStream_t stream) {
  auto kernel = count_exact_kernel<kForm>;
  const size_t smem = static_cast<size_t>(exact_smem(b, kForm, rows));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t grid = (b.n_rows + rows - 1) / rows;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      b, table, mask, max_probe, rows, counts, n_keys, list, n_list);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The hit list of count_exact_launch for a batch (the arguments of its
// batch): shape[0] regions of shape[1] ids, and shape[0] lengths.
void count_exact_list_shape(int device, const void* codes, const void* words,
                            const void* vlen, const void* vbytes,
                            long long n_rows, int W, int VB, int L, int k,
                            int canonical, long long* shape) {
  (void)device;
  const Reads b = make_reads(codes, words, vlen, vbytes, n_rows, W, VB, L, k,
                             canonical);
  const int rows = exact_rows(b, form_of(codes, vlen));
  shape[0] = n_rows > 0 ? (n_rows + rows - 1) / rows : 0;
  shape[1] = int64_t{rows} * (b.M > 0 ? b.M : 0);
}

// Exactly one payload form: raw codes uint8 [n_rows, L], or words uint32
// [n_rows, W] with vlen uint16 [n_rows] or vbytes uint8 [n_rows, VB].
// table int32 [n_buckets, 24] (16 B aligned); adds the trash into counts
// int32 [n_keys + 1]; lists the hit ids in list int32 [regions, region]
// and each region's length in n_list int32 [regions], the shape that
// count_exact_list_shape gives (a region of another size is refused).
int count_exact_launch(int device, const void* codes, const void* words,
                       const void* vlen, const void* vbytes, long long n_rows,
                       int W, int VB, int L, int k, int canonical,
                       const void* table, unsigned n_buckets, int max_probe,
                       long long n_keys, void* counts, void* list,
                       long long region, void* n_list, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Reads b = make_reads(codes, words, vlen, vbytes, n_rows, W, VB, L, k,
                             canonical);
  if (n_rows <= 0 || b.M <= 0) return static_cast<int>(cudaGetLastError());
  const int form = form_of(codes, vlen);
  const int rows = exact_rows(b, form);
  if (region != int64_t{rows} * b.M)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* t = static_cast<const int4*>(table);
  auto* c = static_cast<int32_t*>(counts);
  auto* l = static_cast<int32_t*>(list);
  auto* nl = static_cast<int32_t*>(n_list);
  auto s = static_cast<cudaStream_t>(stream);
  const uint32_t mask = n_buckets - 1u;
  switch (form) {
    case kCodes:
      err = launch<kCodes>(b, rows, t, mask, max_probe, c, n_keys, l, nl, s);
      break;
    case kVlen:
      err = launch<kVlen>(b, rows, t, mask, max_probe, c, n_keys, l, nl, s);
      break;
    default:
      err = launch<kVbytes>(b, rows, t, mask, max_probe, c, n_keys, l, nl, s);
  }
  return static_cast<int>(err);
}

// counts[id] += 1 for the first n_list[r] ids of each region r of list
// int32 [n_regions, region], slice ids at a time; slice <= 0 takes the
// largest power of two of bytes of counts within a third of the L2.
int exact_apply_launch(int device, const void* list, const void* n_list,
                       long long region, int n_regions, void* counts,
                       long long n_keys, long long slice, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_regions <= 0 || n_keys <= 0) return static_cast<int>(cudaGetLastError());
  int sms = 0, l2 = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slice <= 0) {
    int64_t bytes = 16;
    while (bytes * 2 <= l2 / 3) bytes *= 2;
    slice = bytes / 4;
  }
  const int64_t n_slices = (n_keys + slice - 1) / slice;
  if (n_slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // one wave of blocks per slice, so the slices run one after another
  const int per_slice = n_regions < 8 * sms ? n_regions : 8 * sms;
  exact_apply_kernel<<<dim3(per_slice, static_cast<unsigned>(n_slices)),
                       kApplyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(list), static_cast<const int32_t*>(n_list),
      region, n_regions, static_cast<int32_t*>(counts), n_keys, slice);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
