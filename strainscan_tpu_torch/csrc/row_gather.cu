// Hand-written Hopper (sm_90a) kernel of the measurement path: the row gather.
//
// What it replaces
// ----------------
// row_gather_kernel ports the Pallas kernel benchmarks/probe_bench3.py
// ::bench_dma_gather (body dma_gather_kernel), the study of the count step's
// fingerprint-row gather.  The index array is cut into tiles of `tile`
// entries (entries past the last whole tile are ignored).  For entry t of
// tile i (t local to the tile), table row idx[i * tile + t] is XOR-folded
// into output row i * nbuf + (t & (nbuf - 1)).  The Pallas kernel streams
// the rows through an nbuf-deep ring of VMEM buffers, one DMA per row issued
// from the scalar core, with the tile's indices in SMEM; the fold is what it
// computes, and this kernel computes the same fold.
//
// What bounds it on the card
// --------------------------
// The least work reads each distinct row once: at the study's size (2^23
// indices into a 256 MiB table of 512 B rows, each row named about 16
// times) that is 0.1 ms of device memory.  Reaching it would mean folding
// each row, once read, into the ~16 outputs that name it: about 1 G 4-byte
// atomic XORs a call (there is no vector XOR reduction), far slower than
// reading the rows again.  So the kernel reads a row once per index, 4.3 GB
// a call, and what bounds it is where those reads are served from.  In
// index order they are random over a table five times the 50 MB L2, so
// nearly every one comes from device memory (3.35 TB/s).  The same kernel
// on a table that fits the L2 ran at 7.5 TB/s of row bytes: that is the
// floor of a design that keeps the reads and keeps atomics off the output.
//
// What the design does about it
// -----------------------------
// It reads the table in the same order everywhere at once, so that the L2
// serves the repeated reads.  The table is cut into chunks of chunk_rows
// rows (the wrapper's plan: the largest power of two of bytes within a
// third of the L2, 16 MiB on an H100).
// * A persistent grid (the card's resident block slots) walks the tiles in
//   rounds: block b takes tiles [(r * grid + b) * k, ... + k) in round r.
//   Every block walks chunk 0, then chunk 1, and so on within a round, so
//   while a chunk is walked its rows come from device memory about once and
//   the L2 serves their other reads.
// * Warp s alone owns pipeline slot s of the round's k tiles: it buckets the
//   slot's in-range entries by chunk with a counting sort in its own shared
//   memory (two passes over the indices, which stay in the L2), keeps the k
//   (tile, slot) accumulators in shared memory, walks the chunks in order
//   and stores each accumulator once.  No atomics touch the output, and XOR
//   does not depend on order, so the result is deterministic.
// * Lane c reads 16 B of a row (a uint4) and each warp keeps kUnroll row
//   reads in flight before it folds them.
// * Where a round's entries do not fit beside the accumulators (tiles near
//   the wrapper's MAX_TILE), the slot's entries are sorted and walked in
//   pieces, each piece a sweep over the chunks; where one tile's
//   accumulators do not fit (very wide rows), the rows are folded in column
//   windows.  The wrapper's plan picks k, the piece and the window.
// * An index outside [0, n_rows) contributes nothing and reads nothing; the
//   plain twin does the same.
// * Nothing holds the blocks in step but their like work per chunk: a grid
//   barrier at the end of each chunk (a cooperative launch) was 11-23 %
//   slower on an H100 (PERF.md, PR 9).
//
// The entry point launches on the caller's stream, does not synchronise, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 8;
constexpr int kDefaultSmem = 48 * 1024;

struct Plan {
  int64_t n_rows;
  int row_vecs;      // 16 B vectors per row
  int64_t n_tiles;
  int tile;
  int nbuf;
  int chunk_rows;
  int n_chunks;
  int k;             // tiles per block per round
  int piece;         // entries a warp sorts and walks at a time
  int win;           // 16 B vectors per column window
};

__device__ __forceinline__ void xor_into(uint4& acc, const uint4 v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// Position of entry p (p < k * per_slot) of slot s in the index array, for
// the round's first tile t0: entry m of the slot in tile j of the round.
__device__ __forceinline__ int64_t entry_at(const Plan& P, int64_t t0, int s,
                                            int per_slot, int p, int& j) {
  j = p / per_slot;
  const int m = p - j * per_slot;
  return (t0 + j) * P.tile + s + static_cast<int64_t>(m) * P.nbuf;
}

// Warp-private counting sort of entries [p0, p1) of slot s by chunk.  On
// return cur[c] is the end of chunk c's segment of rows/js (its start is
// cur[c - 1], or 0).
__device__ void sort_piece(const Plan& P, const int32_t* __restrict__ idx,
                           int64_t t0, int s, int per_slot, int p0, int p1,
                           int lane, int* cur, int32_t* rows, uint8_t* js) {
  __syncwarp();
  for (int c = lane; c < P.n_chunks; c += 32) cur[c] = 0;
  __syncwarp();
  const unsigned cr = static_cast<unsigned>(P.chunk_rows);
  for (int p = p0 + lane; p < p1; p += 32) {
    int j;
    const int32_t b = __ldg(idx + entry_at(P, t0, s, per_slot, p, j));
    if (b >= 0 && b < P.n_rows)
      atomicAdd(cur + static_cast<unsigned>(b) / cr, 1);
  }
  __syncwarp();
  // exclusive scan of the counts, 32 chunks at a time
  int carry = 0;
  for (int c0 = 0; c0 < P.n_chunks; c0 += 32) {
    const int c = c0 + lane;
    const int n = c < P.n_chunks ? cur[c] : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (c < P.n_chunks) cur[c] = carry + incl - n;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  __syncwarp();
  for (int p = p0 + lane; p < p1; p += 32) {
    int j;
    const int32_t b = __ldg(idx + entry_at(P, t0, s, per_slot, p, j));
    if (b >= 0 && b < P.n_rows) {
      const int at = atomicAdd(cur + static_cast<unsigned>(b) / cr, 1);
      rows[at] = b;
      js[at] = static_cast<uint8_t>(j);
    }
  }
  __syncwarp();
}

// Folds the segment [lo, hi) of one chunk into the warp's accumulators acc
// [k][win] for the column window starting at vector w0 (width wn).
__device__ __forceinline__ void fold_segment(
    const uint4* __restrict__ table, int row_vecs, int w0, int wn, int win,
    const int32_t* rows, const uint8_t* js, int lo, int hi, int lane,
    uint4* acc) {
  for (int vb = 0; vb < wn; vb += 32) {
    const int v = vb + lane;
    if (v >= wn) break;
    const uint4* col = table + w0 + v;
    int e = lo;
    for (; e + kUnroll <= hi; e += kUnroll) {
      uint4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = __ldg(col + static_cast<int64_t>(rows[e + u]) * row_vecs);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        xor_into(acc[js[e + u] * win + v], x[u]);
    }
    for (; e < hi; ++e)
      xor_into(acc[js[e] * win + v],
               __ldg(col + static_cast<int64_t>(rows[e]) * row_vecs));
  }
}

__global__ void __launch_bounds__(1024)
    row_gather_kernel(const uint4* __restrict__ table,
                      const int32_t* __restrict__ idx, const Plan P,
                      uint4* __restrict__ out) {
  // shared memory: acc uint4 [nbuf][k][win], cur int [nbuf][n_chunks]
  // (rounded to 16 B), rows int32 [nbuf][piece], js uint8 [nbuf][piece]
  extern __shared__ uint4 smem[];
  const int s = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cur_stride = (P.n_chunks + 3) & ~3;
  uint4* acc = smem + static_cast<int64_t>(s) * P.k * P.win;
  int* cur_base = reinterpret_cast<int*>(
      smem + static_cast<int64_t>(P.nbuf) * P.k * P.win);
  int* cur = cur_base + s * cur_stride;
  int32_t* rows = cur_base + P.nbuf * cur_stride + s * P.piece;
  uint8_t* js = reinterpret_cast<uint8_t*>(cur_base + P.nbuf * cur_stride +
                                           P.nbuf * P.piece) + s * P.piece;

  const int per_slot = P.tile / P.nbuf;
  const int64_t per_round = static_cast<int64_t>(gridDim.x) * P.k;
  const int64_t rounds = (P.n_tiles + per_round - 1) / per_round;
  const int n_pieces = (P.k * per_slot + P.piece - 1) / P.piece;
  const int n_wins = (P.row_vecs + P.win - 1) / P.win;
  for (int64_t r = 0; r < rounds; ++r) {
    const int64_t t0 = r * per_round + static_cast<int64_t>(blockIdx.x) * P.k;
    const int64_t left = P.n_tiles - t0;
    if (left <= 0) break;   // this block's later rounds are empty too
    const int kk = left < P.k ? static_cast<int>(left) : P.k;
    const int n_ent = kk * per_slot;
    for (int w = 0; w < n_wins; ++w) {
      const int w0 = w * P.win;
      const int wn = min(P.win, P.row_vecs - w0);
      // lane v % 32 alone zeroes, folds and stores vector v
      for (int j = 0; j < kk; ++j)
        for (int v = lane; v < wn; v += 32)
          acc[j * P.win + v] = make_uint4(0u, 0u, 0u, 0u);
      for (int pc = 0; pc < n_pieces; ++pc) {
        const int p0 = pc * P.piece;
        const int p1 = min(n_ent, p0 + P.piece);
        if (n_pieces > 1 || w == 0)   // one piece: sorted once per round
          sort_piece(P, idx, t0, s, per_slot, p0, max(p0, p1), lane, cur,
                     rows, js);
        for (int c = 0; c < P.n_chunks; ++c) {
          fold_segment(table, P.row_vecs, w0, wn, P.win, rows, js,
                       c ? cur[c - 1] : 0, cur[c], lane, acc);
        }
      }
      for (int j = 0; j < kk; ++j) {
        uint4* dst = out + ((t0 + j) * P.nbuf + s) * P.row_vecs + w0;
        for (int v = lane; v < wn; v += 32) dst[v] = acc[j * P.win + v];
      }
    }
  }
}

}  // namespace

extern "C" {

// The device's numbers the wrapper's plan is made from: L2 bytes, shared
// memory a block may opt in to, shared memory per multiprocessor, shared
// memory the runtime reserves per block, multiprocessors, threads and
// blocks per multiprocessor.
int row_gather_device(int device, long long* props) {
  const cudaDeviceAttr attrs[] = {
      cudaDevAttrL2CacheSize, cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock, cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrMaxBlocksPerMultiprocessor};
  for (int i = 0; i < 7; ++i) {
    int v = 0;
    const cudaError_t err = cudaDeviceGetAttribute(&v, attrs[i], device);
    if (err != cudaSuccess) return static_cast<int>(err);
    props[i] = v;
  }
  return 0;
}

// table int32 [n_rows, row_words] (row_words % 4 == 0, 16 B aligned); idx
// int32 [>= n_tiles * tile]; out int32 [n_tiles * nbuf, row_words].  nbuf
// is a power of two <= 32 that divides tile, and the plan's numbers
// (chunk_rows, n_chunks, k <= 255, piece, win, grid, smem) fit the device;
// the wrapper checks and plans.
int row_gather_launch(int device, const void* table, long long n_rows,
                      int row_words, const void* idx, long long n_tiles,
                      int tile, int nbuf, int chunk_rows, int n_chunks, int k,
                      int piece, int win, int grid, int smem, void* out,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(row_gather_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = nbuf * 32;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, row_gather_kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the plan's grid, unless fewer blocks are resident (the tiles are walked
  // with the grid's own stride, so any grid covers them)
  if (per_sm > 0 && grid > sms * per_sm) grid = sms * per_sm;
  const Plan P{n_rows, row_words / 4, n_tiles, tile, nbuf, chunk_rows,
               n_chunks, k, piece, win};
  row_gather_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), static_cast<const int32_t*>(idx), P,
      static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
