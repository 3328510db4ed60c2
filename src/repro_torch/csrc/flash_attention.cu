// Causal / sliding-window GQA attention with an online softmax in float32:
// the prefill attention of the model's `attn` and `local` layers.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_attn_kernel, called through flash_attention_hmajor), whose grid ran
// (B, H, Sq/bq, Skv/bk) with the KV axis sequential and the running
// (max, denominator, numerator) kept in VMEM scratch across it. Here one
// block owns one (batch, head, 32-row query tile) and walks the KV tiles in
// a loop, with the running sums in registers.
//
// What bounds it on Hopper: operations. At the main path's shape
// (B=4, S=4096, H=10, Hkv=1, D=256, window 2048) the band holds about
// 4*10*6.3M (q, k) pairs, 4*D flops each, against a few hundred MB of
// q/k/v/o; the work sits far above the card's operations-per-byte line.
// This first kernel runs the products on CUDA cores in float32, not on
// the tensor cores (wgmma), so it stays well above that bound; a tensor-
// core version is later work.
//
// Design:
// - 256 threads = 8 warps; warp w owns query rows w, w+8, w+16, w+24 of
//   the tile, and lane j owns key j of each 32-key tile. A row's scores
//   therefore live in one warp, and its max and sum are warp shuffles.
// - Q (the block's 32 rows), K and V tiles are converted to float32 in
//   dynamic shared memory (99 KB at D=256, 198 KB at D=512, above the
//   48 KB static limit). Rows are held D rounded up to 4 floats wide, the
//   tail zero-filled; Q and K rows are padded by 4 more floats, so each
//   lane's float4 read of its own K row hits its own banks while the Q
//   reads broadcast. A head dim that is a multiple of 4 is read as
//   4-element vectors, any other one element at a time.
// - P@V: lane j's probability reaches the warp by __shfl_sync; each lane
//   accumulates columns lane, lane+32, ... of its warp's four rows.
// - Masks come from absolute positions (causal k <= q, window
//   k > q - window, and k < Skv for the ragged edge); KV tiles wholly
//   outside the band are skipped, since they add exactly nothing to the
//   online sums. Masked scores take the finite NEG_INF of the reference,
//   with its `safe` guard and its 1e-20 denominator floor, so a fully
//   masked row gives 0 as the TPU kernel does.
// - Any Sq and Skv; any D up to 512 (kMaxD: 16 output columns a lane;
//   the tiles take 198 KB of the 227 KB a block may hold at D = 512);
//   float32 or bfloat16 in, output in q's dtype. Tensors are addressed
//   through their batch, row and head strides (the last dimension
//   contiguous), so the model's (B, S, H, D) layout needs no transposes.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;                 // query rows per block
constexpr int kBK = 32;                 // keys per tile: one per lane
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBQ / kWarps;     // query rows per warp
constexpr float kNegInf = -2.3819763e38f;
constexpr int kMaxD = 512;              // largest head dim
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, s, h;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Elements c .. c + 3 of the row at p, zero from d on: one vector read
// when `vec` (d a multiple of 4, rows 16-byte aligned), else one element
// at a time.
template <typename T>
__device__ __forceinline__ float4 load_row4(const T* p, int c, int d,
                                            bool vec) {
  if (vec) return load4(p + c);
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = c + j < d ? to_float(p[c + j]) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as astype(bf16)
}

__device__ __forceinline__ float warp_max(float x) {
  for (int m = 16; m >= 1; m >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, m));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int m = 16; m >= 1; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

// NC = ceil(D / 32): the output columns a lane accumulates.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int sq, int skv, int group, int d, int causal,
                       int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d4 = (d + 3) / 4;
  const int dp = 4 * d4;                // D rounded up to 4
  const int ld = dp + 4;                // padded Q / K row, in floats
  const bool vec = d % 4 == 0;
  float* q_sh = smem;                   // [kBQ][ld]
  float* k_sh = q_sh + kBQ * ld;        // [kBK][ld]
  float* v_sh = k_sh + kBK * ld;        // [kBK][dp]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;             // GQA: the head's kv head
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * d4; i += kThreads) {
    const int r = i / d4, c = (i - r * d4) * 4;
    const float4 x = q0 + r < sq ? load_row4(qb + (q0 + r) * qs.s, c, d, vec)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(q_sh + r * ld + c) = x;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  // The KV range the tile's rows can see.
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();                    // the last tile's reads are done
    for (int i = tid; i < kBK * d4; i += kThreads) {
      const int r = i / d4, c = (i - r * d4) * 4;
      const bool ok = k0 + r < skv;     // zeros past the ragged edge
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(k_sh + r * ld + c) =
          ok ? load_row4(kb + (k0 + r) * ks.s, c, d, vec) : zero;
      *reinterpret_cast<float4*>(v_sh + r * dp + c) =
          ok ? load_row4(vb + (k0 + r) * vs.s, c, d, vec) : zero;
    }
    __syncthreads();

    // Scores of the warp's rows against the lane's key.
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(k_sh + lane * ld);
    for (int c4 = 0; c4 < d4; ++c4) {
      const float4 kv = krow[c4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* qrow = q_sh + (warp + kWarps * r) * ld;
        const float4 qv = reinterpret_cast<const float4*>(qrow)[c4];
        s[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }

    // Online softmax, one row per r, its 32 scores across the warp.
    const int kpos = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp + kWarps * r;
      const bool ok = kpos < skv && (!causal || kpos <= qpos) &&
                      (window <= 0 || kpos > qpos - window);
      const float sv = ok ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const bool safe = m_new > kNegInf * 0.5f;
      const float alpha = safe ? expf(m[r] - m_new) : 0.f;
      p[r] = safe ? expf(sv - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }

    // acc += P @ V over the tile's keys.
    for (int j = 0; j < kBK; ++j) {
      float pj[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pj[r] = __shfl_sync(kFull, p[r], j);
      const float* vrow = v_sh + j * dp;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        const float vv = col < d ? vrow[col] : 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] += pj[r] * vv;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp + kWarps * r;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l[r], 1e-20f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(ob + qpos * os.s + col, acc[r][c] / denom);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* st, int batch, int sq, int skv, int heads,
           int group, int d, int causal, int window, float scale,
           cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const int dp = 4 * ((d + 3) / 4);
  const int ld = dp + 4;
  const size_t bytes = sizeof(float) * (2 * kBQ * ld + kBK * dp);
  auto kernel = flash_attention_kernel<T, NC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, sq, skv,
      group, d, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const int64_t* st, int batch, int sq, int skv, int heads,
             int group, int d, int causal, int window, float scale,
             cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 1>(q, k, v, o, st, batch, sq, skv, heads, group, d,
                        causal, window, scale, stream);
  if (d <= 64)
    return launch<T, 2>(q, k, v, o, st, batch, sq, skv, heads, group, d,
                        causal, window, scale, stream);
  if (d <= 128)
    return launch<T, 4>(q, k, v, o, st, batch, sq, skv, heads, group, d,
                        causal, window, scale, stream);
  if (d <= 256)
    return launch<T, 8>(q, k, v, o, st, batch, sq, skv, heads, group, d,
                        causal, window, scale, stream);
  return launch<T, 16>(q, k, v, o, st, batch, sq, skv, heads, group, d,
                       causal, window, scale, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). `strides` holds the batch, row
// and head strides, in elements, of q, k, v and o (12 values); the last
// dimension of each is contiguous. dtype: 0 float32, 1 bfloat16. The
// caller guarantees 0 < d <= 512, 16-byte aligned rows where d % 4 == 0,
// heads % group == 0 and sq > 0. Launches on `stream`, never
// synchronises, returns the CUDA error of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const int64_t* strides, int batch,
                                     int sq, int skv, int heads, int group,
                                     int d, int causal, int window,
                                     float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, strides, batch, sq, skv, heads, group,
                           d, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, strides, batch, sq, skv,
                                   heads, group, d, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
