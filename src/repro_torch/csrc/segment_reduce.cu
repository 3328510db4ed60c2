// Deterministic segmented reduction (sum, count, min, max) over sorted,
// contiguous segments: the aggregation kernel of the engine's hash_agg.
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce.py
// (_segment_reduce_kernel), which expanded every row block against a
// (block, segments) one-hot matrix and accumulated into one output block
// across a sequential grid. The caller (engine.compile._run_hash_agg)
// lexsorts the group keys first, so every segment is one contiguous run
// of rows and no one-hot layout is needed.
//
// What bounds it on Hopper: memory bandwidth. Each value is read once and
// added once (C * n flops against 4 * C * n bytes), far below the card's
// ratio of operations to bytes.
//
// Design: one block of 256 threads per (segment, chunk of <= 1024 rows).
// Each thread loads four rows of a column (coalesced), the block folds the
// chunk with a power-of-two pairwise tree (slot i += slot i + m for
// m = 512, 256, ..., 1) whose empty slots hold the identity, and thread 0
// writes one partial per column. The wrapper repeats the same pass over
// the chunk partials until each segment has one value. No float atomics:
// the association is fixed by the row layout alone, so sums are
// bit-reproducible run to run, and the error of a sum over k rows grows
// with log2(k), not k -- the basis of the engine's rtol = 1e-6 aggregate
// contract against the float64 reference. Splitting segments into chunks
// keeps the card busy when there are few groups (TPC-H Q1 has four groups
// over millions of rows). Min and max are exact in any order.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4 * kThreads;   // rows per block: 1024

enum Mode { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };

template <int M>
__device__ __forceinline__ float identity() {
  if (M == kMin) return CUDART_INF_F;
  if (M == kMax) return -CUDART_INF_F;
  return 0.0f;
}

// NaN-propagating like the reference's jnp.minimum / jnp.maximum.
template <int M>
__device__ __forceinline__ float combine(float a, float b) {
  if (M == kMin) return (a < b || a != a) ? a : b;
  if (M == kMax) return (a > b || a != a) ? a : b;
  return __fadd_rn(a, b);   // no contraction: the tree order is the contract
}

template <int M>
__device__ __forceinline__ float load(const float* __restrict__ v, int t,
                                      int len) {
  if (t >= len) return identity<M>();
  return M == kCount ? 1.0f : __ldg(v + t);
}

// Block b reduces chunk (b - chunk_offsets[seg]) of segment seg, where
// chunk_offsets[seg] <= b < chunk_offsets[seg + 1]; its rows are
// [offsets[seg] + 1024 * k, min(offsets[seg + 1], ... + 1024)).
template <int M>
__global__ void segment_reduce_pass(const float* __restrict__ vals,
                                    int64_t ld_in,
                                    const int32_t* __restrict__ offsets,
                                    const int32_t* __restrict__ chunk_offsets,
                                    int32_t num_segments, int32_t columns,
                                    float* __restrict__ out, int64_t ld_out) {
  __shared__ float sh[kThreads];
  __shared__ int32_t seg_sh;
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
  const int64_t row0 = static_cast<int64_t>(offsets[seg]) +
                       static_cast<int64_t>(b - chunk_offsets[seg]) * kChunk;
  const int64_t end = offsets[seg + 1];
  const int len = static_cast<int>(end - row0 < kChunk ? end - row0 : kChunk);
  for (int32_t c = 0; c < columns; ++c) {
    const float* v = vals + c * ld_in + row0;
    float x0 = load<M>(v, t, len);
    float x1 = load<M>(v, t + kThreads, len);
    float x2 = load<M>(v, t + 2 * kThreads, len);
    float x3 = load<M>(v, t + 3 * kThreads, len);
    // m = 512: slots t and t + 256 absorb t + 512 and t + 768;
    // m = 256: slot t absorbs slot t + 256.
    sh[t] = combine<M>(combine<M>(x0, x2), combine<M>(x1, x3));
    __syncthreads();
    for (int m = kThreads / 2; m >= 32; m >>= 1) {
      if (t < m) sh[t] = combine<M>(sh[t], sh[t + m]);
      __syncthreads();
    }
    if (t < 32) {
      float r = sh[t];
      for (int m = 16; m >= 1; m >>= 1) {
        r = combine<M>(r, __shfl_down_sync(0xffffffffu, r, m));
      }
      if (t == 0) out[c * ld_out + b] = r;
    }
    __syncthreads();   // sh is reused by the next column
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): one pass over `blocks` chunks.
// Launches on `stream`, never synchronises, returns cudaGetLastError().
// The caller guarantees blocks > 0 and a valid mode.
extern "C" int repro_segment_reduce_pass(const void* vals, int64_t ld_in,
                                         const void* offsets,
                                         const void* chunk_offsets,
                                         int32_t num_segments, int32_t columns,
                                         int32_t mode, void* out,
                                         int64_t ld_out, int32_t blocks,
                                         void* stream) {
  const float* v = static_cast<const float*>(vals);
  const int32_t* o = static_cast<const int32_t*>(offsets);
  const int32_t* co = static_cast<const int32_t*>(chunk_offsets);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(blocks));
  switch (mode) {
    case kSum:
      segment_reduce_pass<kSum><<<grid, kThreads, 0, st>>>(
          v, ld_in, o, co, num_segments, columns, y, ld_out);
      break;
    case kCount:
      segment_reduce_pass<kCount><<<grid, kThreads, 0, st>>>(
          v, ld_in, o, co, num_segments, columns, y, ld_out);
      break;
    case kMin:
      segment_reduce_pass<kMin><<<grid, kThreads, 0, st>>>(
          v, ld_in, o, co, num_segments, columns, y, ld_out);
      break;
    case kMax:
      segment_reduce_pass<kMax><<<grid, kThreads, 0, st>>>(
          v, ld_in, o, co, num_segments, columns, y, ld_out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
