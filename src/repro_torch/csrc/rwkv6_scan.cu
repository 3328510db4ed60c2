// The RWKV-6 WKV recurrence in float32: the time-mix scan of the model's
// `rwkv` layers in prefill. Per (batch, head), with a (K, V) state S:
//
//   o_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
//   w_t = exp(log_w_t).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py (_rwkv_kernel,
// called through rwkv6_scan_hmajor), whose grid ran (B, H, S/chunk) with
// the chunk axis sequential and the state in VMEM scratch, each chunk in
// the factorized form q' = r exp(excl), k' = k exp(-incl) as two MXU
// products. That form overflows float32 once a chunk's decay mass passes
// about 88 (exp(-incl)), so the reference limits it to moderate decays.
// Here the recurrence is stepped exactly as written, one token at a time,
// so any decay is exact (log_w = -6 over a 64-step chunk, a mass of 384,
// is fine), and any S is taken without padding.
//
// What bounds it on Hopper: at the main path's shape (B=4, S=4096, H=32,
// K=V=64) it moves about 407 MB (r, k, v, o in bf16, log_w in f32) and
// does about 5*K*V float32 operations per step and head (10.7 GFLOP), so
// the float32 operations (CUDA cores, 67 TFLOP/s) and the bytes
// (3.35 TB/s) bound it about equally, near 0.13-0.16 ms. This first
// kernel is sequential in time within a block: its floor is the latency
// of 4,096 dependent steps, not either bound.
//
// Design:
// - One block per (batch, head, tile of 64 state columns), 256 threads:
//   the state's V columns are independent in the recurrence, so V is
//   tiled over the grid's second dimension and has no limit. Thread t
//   owns column t / 4 of the tile and rows KR*(t % 4) .. +KR-1 of the
//   state, KR = 16, 32 or 64 (K up to 64, 128 or 256): KR floats in
//   registers. The four threads of a column are neighbouring lanes, so
//   o_t[v] is their partial sums joined by two warp shuffles.
// - A chunk of r, k and w = exp(log_w) (float32) is staged in dynamic
//   shared memory, each step's row laid out as four groups of KR floats
//   padded by 4, so a lane's float4 reads of its rows hit distinct banks;
//   the tile's v columns and the chunk's outputs sit beside them. The
//   chunk is 64 steps, 32 at KR = 64, where 64 would pass the 227 KB a
//   block may hold (K = 256: 123 KB at 32 steps).
// - The u bonus r_t . (u * k_t) does not depend on v: it is computed for
//   the whole chunk in parallel before the sequential loop (256 / chunk
//   lanes a step), which then only adds v_t[v] times it.
// - Inputs are addressed through their batch, step and head strides (the
//   last dimension contiguous), so the model's (B, S, H, K) layout needs
//   no transposes. r, k, v in float32 or bf16; log_w, u, s0 float32;
//   o in r's dtype, s_final float32. K at most 256 (kMaxK: a thread's
//   KR = K / 4 state rows in registers and the staged rows in shared
//   memory); any V. At K, V <= 64 the arithmetic is that of the kernel
//   before V was tiled, the same bits.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 256;                  // largest K
constexpr int kTileV = 64;                  // state columns a block
constexpr int kThreads = 256;
constexpr int kGroups = 4;                  // threads sharing one column
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTileV * kGroups == kThreads, "four threads a column");

// KR state rows a thread (K up to 4 * KR); the layout of the staged chunk.
template <int KR>
struct Plan {
  static constexpr int kK = kGroups * KR;          // K the block holds
  static constexpr int kPadRows = KR + 4;          // a group's rows, padded
  static constexpr int kStepStride = kGroups * kPadRows;  // floats a step
  static constexpr int kChunk = KR <= 32 ? 64 : 32;       // steps staged
  static constexpr int kLanes = kThreads / kChunk;  // bonus lanes a step
  static constexpr size_t kSmemBytes =
      sizeof(float) * (3 * kChunk * kStepStride + 2 * kChunk * kTileV
                       + kChunk + kK);
};

struct Strides {
  int64_t b, s, h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as astype(bf16)
}

template <typename T, int KR>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ log_w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ o, float* __restrict__ s_final,
                  Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
                  int heads, int seq, int kd, int vd) {
  using P = Plan<KR>;
  constexpr int kChunk = P::kChunk, kStepStride = P::kStepStride;
  constexpr int kPadRows = P::kPadRows, kK = P::kK;
  extern __shared__ float4 smem4[];
  float* r_s = reinterpret_cast<float*>(smem4);   // [kChunk][kStepStride]
  float* k_s = r_s + kChunk * kStepStride;
  float* w_s = k_s + kChunk * kStepStride;
  float* v_s = w_s + kChunk * kStepStride;        // [kChunk][kTileV]
  float* o_s = v_s + kChunk * kTileV;             // [kChunk][kTileV]
  float* bonus_s = o_s + kChunk * kTileV;         // [kChunk]
  float* u_s = bonus_s + kChunk;                  // [kK]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int v0 = blockIdx.y * kTileV;             // the tile's first column
  const int tid = threadIdx.x;
  const int col = tid / kGroups;
  const int grp = tid % kGroups;
  const int row0 = grp * KR;
  const int vcol = v0 + col;

  const T* rp = r + b * sr.b + h * sr.h;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h + v0;
  const float* wp = log_w + b * sw.b + h * sw.h;
  T* op = o + b * so.b + h * so.h + v0;
  const int64_t state_base = static_cast<int64_t>(bh) * kd * vd;
  const int tile_v = min(kTileV, vd - v0);

  float st[KR];
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int row = row0 + j;
    st[j] = (row < kd && col < tile_v)
                ? s0[state_base + static_cast<int64_t>(row) * vd + vcol]
                : 0.f;
  }
  for (int i = tid; i < kK; i += kThreads) {
    u_s[i] = i < kd ? u[h * kd + i] : 0.f;
  }

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int n = min(kChunk, seq - t0);
    __syncthreads();   // the previous chunk is consumed
    for (int i = tid; i < kChunk * kK; i += kThreads) {
      const int t = i / kK, c = i % kK;
      const int64_t step = t0 + t;
      const bool in_k = t < n && c < kd;
      const int si = t * kStepStride + (c / KR) * kPadRows + c % KR;
      r_s[si] = in_k ? to_float(rp[step * sr.s + c]) : 0.f;
      k_s[si] = in_k ? to_float(kp[step * sk.s + c]) : 0.f;
      w_s[si] = in_k ? expf(wp[step * sw.s + c]) : 0.f;
    }
    for (int i = tid; i < kChunk * kTileV; i += kThreads) {
      const int t = i / kTileV, c = i % kTileV;
      const int64_t step = t0 + t;
      v_s[i] = (t < n && c < tile_v) ? to_float(vp[step * sv.s + c]) : 0.f;
    }
    __syncthreads();
    {
      // bonus_t = sum_k r_t[k] u[k] k_t[k]: kLanes lanes a step, lane j
      // over rows [j kK / kLanes, (j + 1) kK / kLanes), in group order.
      constexpr int kLanes = P::kLanes, kPer = kK / kLanes;
      const int t = tid / kLanes, j = tid % kLanes;
      const int c0 = j * kPer;
      const int at = t * kStepStride + (c0 / KR) * kPadRows + c0 % KR;
      const float* rr = r_s + at;
      const float* kk = k_s + at;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        acc = fmaf(rr[q] * u_s[c0 + q], kk[q], acc);
      }
#pragma unroll
      for (int m = 1; m < kLanes; m <<= 1) {
        acc += __shfl_xor_sync(kFull, acc, m);
      }
      if (j == 0) bonus_s[t] = acc;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float4* rr =
          reinterpret_cast<const float4*>(r_s + t * kStepStride + grp * kPadRows);
      const float4* kk =
          reinterpret_cast<const float4*>(k_s + t * kStepStride + grp * kPadRows);
      const float4* ww =
          reinterpret_cast<const float4*>(w_s + t * kStepStride + grp * kPadRows);
      const float vv = v_s[t * kTileV + col];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < KR / 4; ++q) {
        const float4 r4 = rr[q], k4 = kk[q], w4 = ww[q];
        // o reads the state before this step's update.
        acc[0] = fmaf(r4.x, st[4 * q + 0], acc[0]);
        acc[1] = fmaf(r4.y, st[4 * q + 1], acc[1]);
        acc[2] = fmaf(r4.z, st[4 * q + 2], acc[2]);
        acc[3] = fmaf(r4.w, st[4 * q + 3], acc[3]);
        st[4 * q + 0] = fmaf(st[4 * q + 0], w4.x, k4.x * vv);
        st[4 * q + 1] = fmaf(st[4 * q + 1], w4.y, k4.y * vv);
        st[4 * q + 2] = fmaf(st[4 * q + 2], w4.z, k4.z * vv);
        st[4 * q + 3] = fmaf(st[4 * q + 3], w4.w, k4.w * vv);
      }
      float part = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      part += __shfl_xor_sync(kFull, part, 1);
      part += __shfl_xor_sync(kFull, part, 2);
      if (grp == 0) o_s[t * kTileV + col] = fmaf(vv, bonus_s[t], part);
    }
    __syncthreads();
    for (int i = tid; i < n * kTileV; i += kThreads) {
      const int t = i / kTileV, c = i % kTileV;
      if (c < tile_v) store(op + (t0 + t) * so.s + c, o_s[i]);
    }
  }
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int row = row0 + j;
    if (row < kd && col < tile_v)
      s_final[state_base + static_cast<int64_t>(row) * vd + vcol] = st[j];
  }
}

template <typename T, int KR>
int launch(const void* r, const void* k, const void* v, const void* log_w,
           const void* u, const void* s0, void* o, void* s_final,
           const int64_t* strides, int batch, int heads, int seq, int kd,
           int vd, cudaStream_t stream) {
  constexpr size_t bytes = Plan<KR>::kSmemBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<T, KR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const Strides sr{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides sw{strides[9], strides[10], strides[11]};
  const Strides so{strides[12], strides[13], strides[14]};
  const dim3 grid(batch * heads, (vd + kTileV - 1) / kTileV);
  rwkv6_scan_kernel<T, KR><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(o), static_cast<float*>(s_final), sr, sk, sv, sw, so,
      heads, seq, kd, vd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* log_w,
             const void* u, const void* s0, void* o, void* s_final,
             const int64_t* strides, int batch, int heads, int seq, int kd,
             int vd, cudaStream_t stream) {
  if (kd <= 64)
    return launch<T, 16>(r, k, v, log_w, u, s0, o, s_final, strides, batch,
                         heads, seq, kd, vd, stream);
  if (kd <= 128)
    return launch<T, 32>(r, k, v, log_w, u, s0, o, s_final, strides, batch,
                         heads, seq, kd, vd, stream);
  return launch<T, 64>(r, k, v, log_w, u, s0, o, s_final, strides, batch,
                       heads, seq, kd, vd, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). r, k, v, log_w: (B, S, H, K|V)
// addressed through `strides` (batch, step and head strides of r, k, v,
// log_w and o, in elements; the last dimension contiguous); u: (H, K),
// s0 and s_final: (B, H, K, V), contiguous; o: (B, S, H, V). dtype 0 is
// float32, 1 bfloat16 (r, k, v and o). The caller guarantees B, H > 0,
// S >= 0, 0 < K <= 256 and V > 0. Launches on `stream`, never
// synchronises, returns the CUDA error of the launch (0 on success).
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* log_w, const void* u,
                                const void* s0, void* o, void* s_final,
                                const int64_t* strides, int batch, int heads,
                                int seq, int kd, int vd, int dtype,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kd <= 0 || kd > kMaxK || vd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, log_w, u, s0, o, s_final,
                                   strides, batch, heads, seq, kd, vd, st);
  return dispatch<float>(r, k, v, log_w, u, s0, o, s_final, strides, batch,
                         heads, seq, kd, vd, st);
}
