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
// - One block per (batch, head), 256 threads. Thread t owns column
//   v = t / 4 of the state and rows 16*(t % 4) .. +15: 16 floats in
//   registers. The four threads of a column are neighbouring lanes, so
//   o_t[v] is their partial sums joined by two warp shuffles.
// - A 64-step chunk of r, k and w = exp(log_w) (float32) is staged in
//   dynamic shared memory, each step's row laid out as four groups of 16
//   floats padded to 20, so a lane's four float4 reads of its rows hit
//   distinct banks; v and the chunk's outputs sit beside them.
// - The u bonus r_t . (u * k_t) does not depend on v: it is computed for
//   the whole chunk in parallel before the sequential loop, which then
//   only adds v_t[v] times it.
// - Inputs are addressed through their batch, step and head strides (the
//   last dimension contiguous), so the model's (B, S, H, K) layout needs
//   no transposes. r, k, v in float32 or bf16; log_w, u, s0 float32;
//   o in r's dtype, s_final float32. K and V at most 64.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 64;                 // largest K and V
constexpr int kThreads = 256;
constexpr int kGroups = 4;                  // threads sharing one column
constexpr int kRows = kMaxDim / kGroups;    // state rows per thread: 16
constexpr int kPadRows = kRows + 4;         // a group's rows, padded
constexpr int kStepStride = kGroups * kPadRows;   // floats per staged step
constexpr int kChunk = 64;                  // steps staged at once
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk * kGroups == kThreads, "one bonus lane group per step");
constexpr size_t kSmemBytes =
    sizeof(float) * (3 * kChunk * kStepStride + 2 * kChunk * kMaxDim
                     + kChunk + kMaxDim);

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ log_w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ o, float* __restrict__ s_final,
                  Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
                  int heads, int seq, int kd, int vd) {
  extern __shared__ float4 smem4[];
  float* r_s = reinterpret_cast<float*>(smem4);   // [kChunk][kStepStride]
  float* k_s = r_s + kChunk * kStepStride;
  float* w_s = k_s + kChunk * kStepStride;
  float* v_s = w_s + kChunk * kStepStride;        // [kChunk][kMaxDim]
  float* o_s = v_s + kChunk * kMaxDim;            // [kChunk][kMaxDim]
  float* bonus_s = o_s + kChunk * kMaxDim;        // [kChunk]
  float* u_s = bonus_s + kChunk;                  // [kMaxDim]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x;
  const int col = tid / kGroups;
  const int grp = tid % kGroups;
  const int row0 = grp * kRows;

  const T* rp = r + b * sr.b + h * sr.h;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  const float* wp = log_w + b * sw.b + h * sw.h;
  T* op = o + b * so.b + h * so.h;
  const int64_t state_base = static_cast<int64_t>(bh) * kd * vd;

  float st[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int row = row0 + j;
    st[j] = (row < kd && col < vd)
                ? s0[state_base + static_cast<int64_t>(row) * vd + col]
                : 0.f;
  }
  if (tid < kMaxDim) u_s[tid] = tid < kd ? u[h * kd + tid] : 0.f;

  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    const int n = min(kChunk, seq - t0);
    __syncthreads();   // the previous chunk is consumed
    for (int i = tid; i < kChunk * kMaxDim; i += kThreads) {
      const int t = i / kMaxDim, c = i % kMaxDim;
      const int64_t step = t0 + t;
      const bool in_k = t < n && c < kd;
      const int si = t * kStepStride + (c / kRows) * kPadRows + c % kRows;
      r_s[si] = in_k ? to_float(rp[step * sr.s + c]) : 0.f;
      k_s[si] = in_k ? to_float(kp[step * sk.s + c]) : 0.f;
      w_s[si] = in_k ? expf(wp[step * sw.s + c]) : 0.f;
      v_s[i] = (t < n && c < vd) ? to_float(vp[step * sv.s + c]) : 0.f;
    }
    __syncthreads();
    {
      // bonus_t = sum_k r_t[k] u[k] k_t[k]: four lanes per step.
      const int t = tid / kGroups;
      const float* rr = r_s + t * kStepStride + grp * kPadRows;
      const float* kk = k_s + t * kStepStride + grp * kPadRows;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc = fmaf(rr[j] * u_s[row0 + j], kk[j], acc);
      acc += __shfl_xor_sync(kFull, acc, 1);
      acc += __shfl_xor_sync(kFull, acc, 2);
      if (grp == 0) bonus_s[t] = acc;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float4* rr =
          reinterpret_cast<const float4*>(r_s + t * kStepStride + grp * kPadRows);
      const float4* kk =
          reinterpret_cast<const float4*>(k_s + t * kStepStride + grp * kPadRows);
      const float4* ww =
          reinterpret_cast<const float4*>(w_s + t * kStepStride + grp * kPadRows);
      const float vv = v_s[t * kMaxDim + col];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
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
      if (grp == 0) o_s[t * kMaxDim + col] = fmaf(vv, bonus_s[t], part);
    }
    __syncthreads();
    for (int i = tid; i < n * kMaxDim; i += kThreads) {
      const int t = i / kMaxDim, c = i % kMaxDim;
      if (c < vd) store(op + (t0 + t) * so.s + c, o_s[i]);
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int row = row0 + j;
    if (row < kd && col < vd)
      s_final[state_base + static_cast<int64_t>(row) * vd + col] = st[j];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* log_w,
           const void* u, const void* s0, void* o, void* s_final,
           const int64_t* strides, int batch, int heads, int seq, int kd,
           int vd, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const Strides sr{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides sw{strides[9], strides[10], strides[11]};
  const Strides so{strides[12], strides[13], strides[14]};
  rwkv6_scan_kernel<T><<<batch * heads, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(o), static_cast<float*>(s_final), sr, sk, sv, sw, so,
      heads, seq, kd, vd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). r, k, v, log_w: (B, S, H, K|V)
// addressed through `strides` (batch, step and head strides of r, k, v,
// log_w and o, in elements; the last dimension contiguous); u: (H, K),
// s0 and s_final: (B, H, K, V), contiguous; o: (B, S, H, V). dtype 0 is
// float32, 1 bfloat16 (r, k, v and o). The caller guarantees B, H > 0,
// S >= 0 and 0 < K, V <= 64. Launches on `stream`, never synchronises,
// returns the CUDA error of the launch (0 on success).
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* log_w, const void* u,
                                const void* s0, void* o, void* s_final,
                                const int64_t* strides, int batch, int heads,
                                int seq, int kd, int vd, int dtype,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, log_w, u, s0, o, s_final, strides,
                                 batch, heads, seq, kd, vd, st);
  return launch<float>(r, k, v, log_w, u, s0, o, s_final, strides, batch,
                       heads, seq, kd, vd, st);
}
