// Deterministic segmented reduction (sum, count, min, max) by segment
// ids in any order: the aggregation kernel of the engine's hash_agg.
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce.py
// (_segment_reduce_kernel), which expanded every row block against a
// (block, segments) one-hot matrix and accumulated into one output block
// across a sequential grid, so it took ids in any order. Here the fold
// runs over contiguous segments, given by their row offsets: the caller
// (engine.compile._run_hash_agg) lexsorts the group keys first and passes
// the offsets; ids that come sorted give their offsets in one pass; ids in
// any other order are first sorted by a stable radix sort on the card.
//
// What bounds it on Hopper: memory bandwidth. Each value is read once and
// added once (C * n flops against 4 * C * n bytes), far below the card's
// ratio of operations to bytes. At the engine's shapes (a few columns,
// a few segments, millions of rows) the kernel takes tens of microseconds,
// so what the design cuts is launches and host synchronisations. The
// sort route reads and writes the keys and row indices once a pass and
// the values once more, and waits for the card once more (its offsets).
//
// Design:
// - One block of 256 threads per (segment, chunk of <= 1024 rows). The
//   block folds its chunk with a power-of-two pairwise tree (slot i +=
//   slot i + m for m = 512, 256, ..., 1) whose empty slots hold the
//   identity, and writes one partial per column. A full chunk whose rows
//   start on a 16-byte boundary is read as float4s and regrouped through
//   shared memory into the tree's slot order; other chunks read floats.
// - Two passes of that tree in one launch: the block that finishes last
//   among the (at most 1024) chunks of a segment folds their partials,
//   in slot order, with the same tree. It learns it is last from an int
//   atomicAdd on a per-group counter, after a __threadfence that
//   publishes its partials, and reads the others' partials through L2
//   (ld.global.cg). A segment of more than 1024 chunks (over 1,048,576
//   rows) has several such groups and takes a further launch, as the
//   pass plan (kernels/segment_reduce.py::reduction_passes) says.
// - No float atomics: the association is fixed by the row layout alone,
//   so sums are bit-reproducible run to run and equal to the plain
//   version's, and the error of a sum over k rows grows with log2(k), not
//   k -- the basis of the engine's rtol = 1e-6 aggregate contract against
//   the float64 reference. Splitting segments into chunks keeps the card
//   busy when there are few groups (TPC-H Q1 has four groups over
//   millions of rows). Min and max are exact in any order.
// - repro_segment_offsets derives the offsets from sorted segment ids in
//   one pass, for callers that hold ids rather than offsets: the thread of
//   row i writes the start of every segment in (id[i-1], id[i]]. A row
//   whose id lies outside [-1, S) sets one error word, a row out of order
//   (a descending id, a -1 before a valid id) another.
// - repro_segment_sort takes ids that are not sorted: a stable LSD radix
//   sort by the key id (-1 read as S), 8 bits a pass, as many passes as
//   S + 1 needs (one up to S = 255, two to 65,535, three beyond). A pass
//   is three kernels: a 256-bin histogram per tile of 4096 rows (shared
//   int counts, warp-aggregated), an exclusive scan of the histograms in
//   digit-major order (one block a digit; the digits' totals, summed by
//   int atomics, give each digit's base), and a stable scatter, in which
//   a row's rank among the equal digits of its tile comes from its
//   position: __match_any_sync and a popcount within its warp, the
//   counts of the warps before it in the round, and the rounds before.
//   No rank comes from an atomic. The last pass writes the sorted ids
//   (-1 again for key S) and gathers the value columns into id order;
//   repro_segment_offsets then derives the offsets from the sorted ids,
//   and the fold runs on the gathered values as on pre-sorted ones. So a
//   sum associates exactly as for the same rows stably pre-sorted by id:
//   the same bits, and the same O(log2 k * eps) error.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4 * kThreads;   // rows per block: 1024

enum Mode { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };

// Makes `device` current for a launch, and puts the caller's device back
// when it goes out of scope. The common case, `device` already current,
// costs one cudaGetDevice.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ != cudaSuccess || prev_ == device) {
      prev_ = -1;                   // nothing to put back
    } else {
      err_ = cudaSetDevice(device);
    }
  }
  ~DeviceScope() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_;
};

template <int M>
__device__ __forceinline__ float identity() {
  if (M == kMin) return CUDART_INF_F;
  if (M == kMax) return -CUDART_INF_F;
  return 0.0f;
}

// NaN-propagating like the reference's jnp.minimum / jnp.maximum, and
// like them ordering -0.0 below +0.0: on a tie min takes the operand with
// the sign bit, max the one without.
template <int M>
__device__ __forceinline__ float combine(float a, float b) {
  if (M == kMin) return (a < b || a != a || (a == b && signbit(a))) ? a : b;
  if (M == kMax) return (a > b || a != a || (a == b && !signbit(a))) ? a : b;
  return __fadd_rn(a, b);   // no contraction: the tree order is the contract
}

// Row t of a chunk of `len` rows at v. kFresh: v was written by other
// blocks of this launch, so it is read from L2, never through the
// read-only cache.
template <int M, bool kFresh>
__device__ __forceinline__ float load(const float* v, int t, int len) {
  if (t >= len) return identity<M>();
  if (M == kCount) return 1.0f;
  return kFresh ? __ldcg(v + t) : __ldg(v + t);
}

// Folds the chunk of `len` <= kChunk rows at v with the pairwise tree;
// thread 0 returns the result. Ends with the block synchronised, so sh
// may be reused at once.
template <int M, bool kFresh>
__device__ float fold_chunk(const float* v, int len, float* sh) {
  const int t = threadIdx.x;
  float x0, x1, x2, x3;
  if (!kFresh && M != kCount && len == kChunk &&
      (reinterpret_cast<uintptr_t>(v) & 15) == 0) {
    // Rows 4t..4t+3 arrive as one float4; the tree wants rows t, t + 256,
    // t + 512, t + 768 in thread t.
    reinterpret_cast<float4*>(sh)[t] =
        __ldg(reinterpret_cast<const float4*>(v) + t);
    __syncthreads();
    x0 = sh[t];
    x1 = sh[t + kThreads];
    x2 = sh[t + 2 * kThreads];
    x3 = sh[t + 3 * kThreads];
  } else {
    x0 = load<M, kFresh>(v, t, len);
    x1 = load<M, kFresh>(v, t + kThreads, len);
    x2 = load<M, kFresh>(v, t + 2 * kThreads, len);
    x3 = load<M, kFresh>(v, t + 3 * kThreads, len);
  }
  // m = 512: slots t and t + 256 absorb t + 512 and t + 768;
  // m = 256: slot t absorbs slot t + 256. Thread t alone reads and writes
  // sh[t] here, so the float4 staging above needs no second barrier.
  sh[t] = combine<M>(combine<M>(x0, x2), combine<M>(x1, x3));
  __syncthreads();
  for (int m = kThreads / 2; m >= 32; m >>= 1) {
    if (t < m) sh[t] = combine<M>(sh[t], sh[t + m]);
    __syncthreads();
  }
  float r = 0.f;
  if (t < 32) {
    r = sh[t];
    for (int m = 16; m >= 1; m >>= 1) {
      r = combine<M>(r, __shfl_down_sync(0xffffffffu, r, m));
    }
  }
  __syncthreads();   // sh is reused by the caller
  return r;
}

// Block b reduces chunk k = b - chunk_offsets[seg] of segment seg, where
// chunk_offsets[seg] <= b < chunk_offsets[seg + 1]; its rows are
// [offsets[seg] + 1024 k, min(offsets[seg + 1], ... + 1024)), and it
// writes partial[c, b]. With chunk_offsets2 (the next pass's chunk
// offsets), the last block of the group of chunks [1024 g, 1024 g + 1024)
// of segment seg, g = k / 1024, also folds the group's partials into
// out[c, chunk_offsets2[seg] + g] (counts as sums of the chunk counts);
// counters (one per output column, zero on entry) count the group's
// finished blocks.
template <int M>
__global__ void __launch_bounds__(kThreads)
segment_reduce_fold(const float* __restrict__ vals, int64_t ld_in,
                    const int32_t* __restrict__ offsets,
                    const int32_t* __restrict__ chunk_offsets,
                    const int32_t* __restrict__ chunk_offsets2,
                    int32_t num_segments, int32_t columns,
                    float* partial, int64_t ld_part,
                    float* __restrict__ out, int64_t ld_out,
                    int32_t* __restrict__ counters) {
  __shared__ __align__(16) float sh[kChunk];
  __shared__ int32_t seg_sh;
  __shared__ bool last_sh;
  const int t = threadIdx.x;
  const int32_t b = static_cast<int32_t>(blockIdx.x);
  if (t == 0) {
    int32_t lo = 0, hi = num_segments;   // chunk_offsets[lo] <= b
    while (hi - lo > 1) {
      int32_t mid = lo + ((hi - lo) >> 1);
      if (chunk_offsets[mid] <= b) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    seg_sh = lo;
  }
  __syncthreads();
  const int32_t seg = seg_sh;
  const int32_t k = b - chunk_offsets[seg];
  const int64_t row0 = static_cast<int64_t>(offsets[seg]) +
                       static_cast<int64_t>(k) * kChunk;
  const int64_t end = offsets[seg + 1];
  const int len = static_cast<int>(end - row0 < kChunk ? end - row0 : kChunk);
  for (int32_t c = 0; c < columns; ++c) {
    const float r = fold_chunk<M, false>(vals + c * ld_in + row0, len, sh);
    if (t == 0) partial[c * ld_part + b] = r;
  }
  if (chunk_offsets2 == nullptr) return;

  const int32_t nchunks = chunk_offsets[seg + 1] - chunk_offsets[seg];
  const int32_t g = k / kChunk;
  const int group = min(kChunk, nchunks - g * kChunk);
  const int32_t slot = chunk_offsets2[seg] + g;
  if (t == 0) {
    __threadfence();   // this block's partials before its count
    last_sh = atomicAdd(counters + slot, 1) == group - 1;
  }
  __syncthreads();
  if (!last_sh) return;
  __threadfence();     // every count seen: the group's partials are visible
  const int64_t p0 = static_cast<int64_t>(chunk_offsets[seg]) +
                     static_cast<int64_t>(g) * kChunk;
  for (int32_t c = 0; c < columns; ++c) {
    constexpr int M2 = M == kCount ? kSum : M;
    const float r = fold_chunk<M2, true>(partial + c * ld_part + p0, group,
                                         sh);
    if (t == 0) out[c * ld_out + slot] = r;
  }
}

template <int M>
void launch_fold(const float* v, int64_t ld_in, const int32_t* o,
                 const int32_t* co, const int32_t* co2, int32_t num_segments,
                 int32_t columns, float* partial, int64_t ld_part, float* y,
                 int64_t ld_out, int32_t* counters, int32_t blocks,
                 cudaStream_t st) {
  segment_reduce_fold<M><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      v, ld_in, o, co, co2, num_segments, columns, partial, ld_part, y,
      ld_out, counters);
}

// Thread i of [0, n] writes offsets[s] = i for every s in (key(i - 1),
// key(i)], where key(i) is ids[i], S for a -1 and for i = n, and
// key(-1) = -1. Sets err[0] on an id out of [-1, S) and err[1] on a row
// out of order (a descending id, or a -1 before a valid id); the offsets
// are then meaningless, and a block holding such a row writes none, so
// unsorted ids cost no more than sorted ones (an ascending pair of them
// would write up to S offsets).
__global__ void __launch_bounds__(kThreads)
segment_offsets_kernel(const int32_t* __restrict__ ids, int64_t n,
                       int32_t num_segments, int32_t* __restrict__ offsets,
                       int32_t* __restrict__ err) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int32_t id = i < n ? __ldg(ids + i) : -1;
  const int32_t prev = i > 0 && i <= n ? __ldg(ids + i - 1) : -1;
  const bool row = i < n;
  const bool disorder = row && id >= 0 && i > 0 && (prev == -1 || id < prev);
  if (row && (id < -1 || id >= num_segments)) err[0] = 1;
  if (disorder) err[1] = 1;
  if (__syncthreads_or(disorder) || i > n) return;
  const int32_t key = id == -1 ? num_segments : id;
  const int32_t pkey = i == 0 ? -1 : (prev == -1 ? num_segments : prev);
  const int32_t lo = max(pkey, -1) + 1, hi = min(key, num_segments);
  for (int32_t s = lo; s <= hi; ++s) offsets[s] = static_cast<int32_t>(i);
}

// ---- The radix sort of unsorted ids -------------------------------------

constexpr int kBins = 256;                       // 8 bits a pass
constexpr int kSortItems = 16;                   // rounds of rows a tile
constexpr int kTile = kThreads * kSortItems;     // rows a block: 4096
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kBins, "one thread a bin");

// The sort key of an id or of an earlier pass's key: -1 reads as S.
__device__ __forceinline__ int32_t sort_key(int32_t id, int32_t s) {
  return id < 0 ? s : id;
}

// Block b counts the digits (key >> shift) & 255 of rows [4096 b,
// 4096 b + 4096) into hist[digit * blocks + b] (digit-major), and adds
// its counts to totals[digit]. Counts only: a warp's equal digits are
// added once, by their lowest lane.
__global__ void __launch_bounds__(kThreads)
radix_histogram_kernel(const int32_t* __restrict__ keys, int64_t n,
                       int32_t num_segments, int shift,
                       int32_t* __restrict__ hist,
                       int32_t* __restrict__ totals) {
  __shared__ int32_t cnt[kBins];
  const int t = threadIdx.x, lane = t & 31;
  cnt[t] = 0;
  __syncthreads();
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int r = 0; r < kSortItems; ++r) {
    const int64_t row = tile0 + r * kThreads + t;
    const int digit = row < n
        ? (sort_key(__ldg(keys + row), num_segments) >> shift) & (kBins - 1)
        : kBins;
    const unsigned same = __match_any_sync(kFull, digit);
    if (digit < kBins && (same & ((1u << lane) - 1)) == 0) {
      atomicAdd(cnt + digit, __popc(same));
    }
  }
  __syncthreads();
  hist[static_cast<int64_t>(t) * gridDim.x + blockIdx.x] = cnt[t];
  if (cnt[t] != 0) atomicAdd(totals + t, cnt[t]);
}

// Block d turns row d of the digit-major histogram (one count a tile)
// into each tile's first output position for digit d: the counts of the
// lower digits (totals) plus those of digit d in the tiles before.
__global__ void __launch_bounds__(kThreads)
radix_scan_kernel(int32_t* __restrict__ hist,
                  const int32_t* __restrict__ totals, int32_t blocks) {
  __shared__ int32_t warp_sum[kWarps];
  __shared__ int32_t base_sh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int d = blockIdx.x;
  if (t == 0) {
    int32_t base = 0;
    for (int i = 0; i < d; ++i) base += totals[i];
    base_sh = base;
  }
  __syncthreads();
  int32_t carry = base_sh;
  int32_t* row = hist + static_cast<int64_t>(d) * blocks;
  for (int32_t at = 0; at < blocks; at += 4 * kThreads) {
    int32_t x[4], local = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int32_t i = at + 4 * t + j;
      x[j] = i < blocks ? row[i] : 0;
      local += x[j];
    }
    int32_t inc = local;   // inclusive scan of the threads' sums
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    if (lane == 31) warp_sum[warp] = inc;
    __syncthreads();
    int32_t before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_sum[w] : 0;
      all += warp_sum[w];
    }
    int32_t run = carry + before + inc - local;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int32_t i = at + 4 * t + j;
      if (i < blocks) row[i] = run;
      run += x[j];
    }
    carry += all;
    __syncthreads();   // warp_sum is rewritten next round
  }
}

// Block b moves rows [4096 b, 4096 b + 4096) to their places in the order
// of digit (key >> shift) & 255, stably: round r takes rows 256 r + t in
// thread t, so a row's rank among its tile's equal digits is the count of
// those in earlier rounds (base), in earlier warps of its round (wcnt)
// and in lower lanes of its warp (a popcount of __match_any_sync's mask).
// An inner pass writes keys and source rows (idx_in null: the row
// itself); the last pass (ids_out set) writes the ids, -1 for key S, and
// gathers the `columns` value columns into vals_out.
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const int32_t* __restrict__ keys_in,
                     const int32_t* __restrict__ idx_in, int64_t n,
                     int32_t num_segments, int shift,
                     const int32_t* __restrict__ scanned,
                     int32_t* __restrict__ keys_out,
                     int32_t* __restrict__ idx_out,
                     int32_t* __restrict__ ids_out,
                     const float* __restrict__ vals, int64_t ld_in,
                     int32_t columns, float* __restrict__ vals_out,
                     int64_t ld_out) {
  __shared__ int32_t base[kBins];
  __shared__ int32_t wcnt[kWarps][kBins];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  base[t] = scanned[static_cast<int64_t>(t) * gridDim.x + blockIdx.x];
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int r = 0; r < kSortItems; ++r) {
    // Thread t alone reads column t of wcnt after the round, so it may
    // clear it now without a barrier.
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wcnt[w][t] = 0;
    __syncthreads();
    const int64_t row = tile0 + r * kThreads + t;
    const bool valid = row < n;
    const int32_t key =
        valid ? sort_key(__ldg(keys_in + row), num_segments) : 0;
    const int digit = valid ? (key >> shift) & (kBins - 1) : kBins;
    const unsigned same = __match_any_sync(kFull, digit);
    const int below = __popc(same & ((1u << lane) - 1));
    if (valid && below == 0) wcnt[warp][digit] = __popc(same);
    __syncthreads();
    if (valid) {
      int32_t pos = base[digit] + below;
      for (int w = 0; w < warp; ++w) pos += wcnt[w][digit];
      const int32_t src = idx_in != nullptr ? __ldg(idx_in + row)
                                            : static_cast<int32_t>(row);
      if (ids_out == nullptr) {
        keys_out[pos] = key;
        idx_out[pos] = src;
      } else {
        ids_out[pos] = key == num_segments ? -1 : key;
        for (int32_t c = 0; c < columns; ++c) {
          vals_out[c * ld_out + pos] = __ldg(vals + c * ld_in + src);
        }
      }
    }
    __syncthreads();   // every position read before base moves on
    int32_t added = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) added += wcnt[w][t];
    base[t] += added;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream` of
// CUDA device `device`, never synchronises, and returns
// cudaGetLastError().
//
// One launch of one or two reduction passes over `blocks` chunks (see
// segment_reduce_fold); chunk_offsets2 null runs the first pass alone and
// writes its partials to `partial`. `mode` is the first pass's. The
// caller guarantees blocks > 0, a valid mode and zeroed counters.
extern "C" int repro_segment_reduce_fold(
    const void* vals, int64_t ld_in, const void* offsets,
    const void* chunk_offsets, const void* chunk_offsets2,
    int32_t num_segments, int32_t columns, int32_t mode, void* partial,
    int64_t ld_part, void* out, int64_t ld_out, void* counters,
    int32_t blocks, int32_t device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const float* v = static_cast<const float*>(vals);
  const int32_t* o = static_cast<const int32_t*>(offsets);
  const int32_t* co = static_cast<const int32_t*>(chunk_offsets);
  const int32_t* co2 = static_cast<const int32_t*>(chunk_offsets2);
  float* p = static_cast<float*>(partial);
  float* y = static_cast<float*>(out);
  int32_t* cnt = static_cast<int32_t*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSum:
      launch_fold<kSum>(v, ld_in, o, co, co2, num_segments, columns, p,
                        ld_part, y, ld_out, cnt, blocks, st);
      break;
    case kCount:
      launch_fold<kCount>(v, ld_in, o, co, co2, num_segments, columns, p,
                          ld_part, y, ld_out, cnt, blocks, st);
      break;
    case kMin:
      launch_fold<kMin>(v, ld_in, o, co, co2, num_segments, columns, p,
                        ld_part, y, ld_out, cnt, blocks, st);
      break;
    case kMax:
      launch_fold<kMax>(v, ld_in, o, co, co2, num_segments, columns, p,
                        ld_part, y, ld_out, cnt, blocks, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The (S + 1,) int32 row offsets of sorted segment ids (n,) into `out`,
// and two error words that the caller zeroes first: out[S + 1] (an id
// out of [-1, S)) and out[S + 2] (ids out of order). The caller
// guarantees n < 2^31 - 1.
extern "C" int repro_segment_offsets(const void* ids, int64_t n,
                                     int32_t num_segments, void* out,
                                     int32_t device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  int32_t* o = static_cast<int32_t*>(out);
  const unsigned blocks = static_cast<unsigned>((n + kThreads) / kThreads);
  segment_offsets_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), n, num_segments, o,
      o + num_segments + 1);
  return static_cast<int>(cudaGetLastError());
}

// Sorts ids (n,) stably by key (-1 read as S) in `passes` radix passes
// (8 bits each; the caller gives ceil(bit_length(S) / 8)), writing the
// sorted ids to ids_out and, for `columns` > 0, the value columns vals
// (row stride ld_in) gathered into the same order to vals_out (row
// stride ld_out). Scratch, from the caller: keys and idx of 2 n int32
// each, hist of 256 * ceil(n / 4096) int32, and totals of 256 * passes
// int32, zeroed. The caller guarantees 0 < n < 2^31 - 1 and passes > 0.
extern "C" int repro_segment_sort(const void* ids, int64_t n,
                                  int32_t num_segments, int32_t passes,
                                  const void* vals, int64_t ld_in,
                                  int32_t columns, void* vals_out,
                                  int64_t ld_out, void* ids_out, void* keys,
                                  void* idx, void* hist, void* totals,
                                  int32_t device, void* stream) {
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  int32_t* key_buf = static_cast<int32_t*>(keys);
  int32_t* idx_buf = static_cast<int32_t*>(idx);
  int32_t* h = static_cast<int32_t*>(hist);
  const int32_t* in_keys = static_cast<const int32_t*>(ids);
  const int32_t* in_idx = nullptr;
  for (int32_t p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    int32_t* tot = static_cast<int32_t*>(totals) + kBins * p;
    int32_t* out_keys = key_buf + (p % 2) * n;
    int32_t* out_idx = idx_buf + (p % 2) * n;
    radix_histogram_kernel<<<blocks, kThreads, 0, st>>>(
        in_keys, n, num_segments, 8 * p, h, tot);
    radix_scan_kernel<<<kBins, kThreads, 0, st>>>(
        h, tot, static_cast<int32_t>(blocks));
    radix_scatter_kernel<<<blocks, kThreads, 0, st>>>(
        in_keys, in_idx, n, num_segments, 8 * p, h, out_keys, out_idx,
        last ? static_cast<int32_t*>(ids_out) : nullptr,
        static_cast<const float*>(vals), ld_in, columns,
        static_cast<float*>(vals_out), ld_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    in_keys = out_keys;
    in_idx = out_idx;
  }
  return 0;
}
