// The RWKV-6 WKV recurrence, chunk-parallel on the tensor cores, for
// K = V = 64 (every served shape). Per (batch, head), with a (K, V)
// float32 state S:
//
//   o_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
//   w_t = exp(log_w_t).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py (_rwkv_kernel),
// whose grid ran (B, H, S/chunk) with the chunk axis sequential and the
// state in VMEM scratch, each chunk in the factorized form
// q' = r exp(excl), k' = k exp(-incl) as two MXU products. That form
// overflows float32 once a chunk's decay mass passes about 88 (the
// positive exponent of exp(-incl)). csrc/rwkv6_scan.cu (the "seq" route)
// steps the recurrence one token at a time instead: exact, but a chain of
// 4,096 dependent steps a block.
//
// What bounds it on Hopper: bytes. At the main path's shape (B=4, S=4096,
// H=32, K=V=64, bf16) it moves about 407 MB (0.121 ms at 3.35 TB/s); the
// chunk form's products, split for float32 accuracy (below), take about
// 32 GFLOP of TF32 or bf16 (0.06 ms at 495 TFLOP/s). This kernel runs them
// on mma.sync with one block an SM, and is bound in practice by the
// latency of its phases and the rate of mma.sync.
//
// Design: chunks of L = 64 steps, in sub-chunks of 16, each in two
// halves of 8. Every decay factor is a product of per-step decays
// w = exp(log_w) <= 1 over a range of steps -- the exponent of every
// reference point is <= 0 -- so nothing overflows at any decay, and a
// product underflows only where its true value lies below float32's
// range. Products of w, not differences of a float32 cumulative sum:
// after a step with log_w = -60 the cumulative sum is near -3,840 and
// rounds each later -1e-3 step to its ulp (2.4e-4). Within a chunk, for
// sub-chunk q with steps [16q, 16q + 16):
//   e_t = prod of w over [16q, t)      (t in q; reference: start of q),
//   f_s = prod of w over (s, 16q + 15] (s in q; reference: end of q),
//   T_q = prod of w over all of q,
//   R_t = r_t e_t,  K_s = k_s f_s,
// and e8, f8, R8, K8 the same for the halves of q, from the boundary
// between them.
// - Pairs s < t in different sub-chunks j < i: the decay over (s, t) is
//   f_s (T_{j+1} ... T_{i-1}) e_t, so A_ts = R_t . (K_s T_{j+1..i-1}):
//   six 16x16x64 products on the tensor cores (warps 0-5).
// - Pairs in the two halves of one sub-chunk: A_ts = R8_t . K8_s, four
//   8x8x64 products on the tensor cores (warps 6, 7).
// - Pairs within one half: the decay prod w over (s, t) per channel, by a
//   running product from s = t - 1 down, on the CUDA cores (every warp,
//   a row pair and 8 channels a thread); the diagonal A_tt = r_t . u . k_t
//   (the bonus).
// - Across chunks: o_t = (R_t T_0..T_{i-1}) S + (A V)_t, and
//   S <- diag(T_0..T_3) S + (K_s T_{j+1..3})^T V: 64x64x64 products on
//   the tensor cores, the state's first so that its chain drains under
//   the output's.
// - Precision: a single TF32 (10 mantissa bits) or bf16 (7) rounding of
//   an operand costs 2^-11 or 2^-8 of it, above the checks' 2e-4 of the
//   terms' size. So every float32 operand splits into hi + lo parts and
//   each product runs as hi.hi + hi.lo + lo.hi, the small products into an
//   accumulator of their own: for bf16 inputs in bf16 parts (16 mantissa
//   bits, mma.sync m16n8k16: half the instructions of TF32 for the same
//   K), whose v is exact in bf16 and takes two products; for float32
//   inputs in TF32 parts (mma.sync m16n8k8, about float32's accuracy).
// - mma.sync, not wgmma: the products are 8 to 64 wide and fed from
//   operands that the block scales and splits as it loads them. A version
//   whose state and output products ran on wgmma (A from registers, the
//   state and v as swizzled B tiles) was no faster within the spread of
//   its timings across calls: the phases' latency, not the product
//   rate, bounds them.
// - One block of 256 threads per (batch, head), walking its chunks in
//   order with S in registers (each warp a 16 x 32 tile) and in shared
//   memory for the o product; r, k, v and log_w of the next chunk arrive
//   by cp.async in a 2-stage ring while the current chunk computes. A
//   ragged last chunk is zero-filled (log_w = 0: w = 1), which is exact.
// - Inputs are addressed through their batch, step and head strides with
//   the last dimension contiguous and every row 16-byte aligned (the
//   wrapper ensures it), so the model's (B, S, H, K) layout needs no
//   transposes. r, k, v float32 or bf16; log_w, u, s0 float32; o in r's
//   dtype, s_final float32.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kL = 64;          // steps in a chunk
constexpr int kQ = 16;          // steps in a sub-chunk
constexpr int kH = 8;           // steps in a half sub-chunk
constexpr int kD = 64;          // K = V
constexpr int kThreads = 256;   // 8 warps
constexpr int kFS = kD + 4;     // float row stride in shared memory

template <typename T>
struct Layout {
  // Staged r, k, v rows: padded so each row starts on 16 bytes and the
  // mma fragments' rows fall in distinct banks.
  static constexpr int kRS = sizeof(T) == 2 ? kD + 8 : kD + 4;
  static constexpr size_t kTile = sizeof(T) * kL * kRS;
  static constexpr size_t kFloatTile = sizeof(float) * kL * kFS;
  static constexpr size_t kStage = 3 * kTile + kFloatTile;   // r, k, v, log_w
  // Two stages; R, K, A and S; R8 and K8 (32 rows each); T_q, the
  // sub-chunks' prefix and suffix products (4 x 64 each), their product
  // and u (64 each).
  static constexpr size_t kBytes = 2 * kStage + 4 * kFloatTile +
                                   kFloatTile + sizeof(float) * 14 * kD;
};

struct Strides {
  int64_t b, s, h;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  // round to nearest even, as astype(bf16)
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo, both TF32 (10 mantissa bits, rounded to nearest).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  uint32_t h;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  h &= 0xffffe000u;
  hi = h;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(h)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a_hi b_hi and dc += a_lo b_hi + a_hi b_lo: a b in three TF32
// products, the small ones into an accumulator of their own.
__device__ __forceinline__ void mma3(float (&d)[4], float (&dc)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const float b0,
                                     const float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(dc, al, bh0, bh1);
  mma(dc, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

// The A fragment of rows r0, r0 + 8 and columns c, c + 4 of a float tile
// with row stride kFS, each scaled, split into TF32 hi and lo.
__device__ __forceinline__ void a_frag(const float* m, int r0, int c,
                                       float s0, float s1, float s2,
                                       float s3, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split(m[r0 * kFS + c] * s0, ah[0], al[0]);
  split(m[(r0 + 8) * kFS + c] * s1, ah[1], al[1]);
  split(m[r0 * kFS + c + 4] * s2, ah[2], al[2]);
  split(m[(r0 + 8) * kFS + c + 4] * s3, ah[3], al[3]);
}

// bf16 inputs take bf16 products (m16n8k16, twice the K of a TF32
// m16n8k8 in one instruction): a float32 operand splits into bf16 hi + lo
// (16 mantissa bits, a rounding of 2^-17), and a product runs as hi.hi +
// hi.lo + lo.hi, where a TF32 one would take three instructions a k8.
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) = hi + lo, each a bf16 pair (x in the low half).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - f.x, y - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// d += a_hi b_hi and dc += a_lo b_hi + a_hi b_lo.
__device__ __forceinline__ void mma16x3(float (&d)[4], float (&dc)[4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4], uint32_t bh0,
                                        uint32_t bh1, uint32_t bl0,
                                        uint32_t bl1) {
  mma16(dc, al, bh0, bh1);
  mma16(dc, ah, bl0, bl1);
  mma16(d, ah, bh0, bh1);
}

// The m16k16 A fragment of rows r0, r0 + 8 and columns c, c + 1, c + 8,
// c + 9 (c even) of a float tile with row stride kFS, columns scaled by
// s01 and s89, split into bf16 hi and lo.
__device__ __forceinline__ void a_frag16(const float* m, int r0, int c,
                                         float2 s01, float2 s89,
                                         uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(m + r0 * kFS + c);
  const float2 x1 = *reinterpret_cast<const float2*>(m + (r0 + 8) * kFS + c);
  const float2 x2 = *reinterpret_cast<const float2*>(m + r0 * kFS + c + 8);
  const float2 x3 =
      *reinterpret_cast<const float2*>(m + (r0 + 8) * kFS + c + 8);
  split2(x0.x * s01.x, x0.y * s01.y, ah[0], al[0]);
  split2(x1.x * s01.x, x1.y * s01.y, ah[1], al[1]);
  split2(x2.x * s89.x, x2.y * s89.y, ah[2], al[2]);
  split2(x3.x * s89.x, x3.y * s89.y, ah[3], al[3]);
}

// Rows s and s + 1 of column vc of a staged bf16 tile as a B pair: v is
// bf16, so its bits go to the product as they are.
__device__ __forceinline__ uint32_t v_pair(const __nv_bfloat16* vs, int rs,
                                           int s, int vc) {
  const uint16_t* p = reinterpret_cast<const uint16_t*>(vs);
  return static_cast<uint32_t>(p[s * rs + vc]) |
         (static_cast<uint32_t>(p[(s + 1) * rs + vc]) << 16);
}

// Eight consecutive values (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Loads chunk rows [t0, t0 + n) of r, k, v and log_w into one stage;
// rows past n are zero-filled.
template <typename T>
__device__ void load_chunk(unsigned char* stage, const T* rp, const T* kp,
                           const T* vp, const float* wp, const Strides& sr,
                           const Strides& sk, const Strides& sv,
                           const Strides& sw, int64_t t0, int n) {
  using Ly = Layout<T>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPieces = kD / kVec;   // 16-byte pieces of a row
  T* rs = reinterpret_cast<T*>(stage);
  T* ks = rs + kL * Ly::kRS;
  T* vs = ks + kL * Ly::kRS;
  float* ls = reinterpret_cast<float*>(vs + kL * Ly::kRS);
  for (int i = threadIdx.x; i < kL * kPieces; i += kThreads) {
    const int t = i / kPieces, c = (i % kPieces) * kVec;
    const bool ok = t < n;
    const int64_t step = t0 + (ok ? t : 0);
    cp_async16(rs + t * Ly::kRS + c, rp + step * sr.s + c, ok);
    cp_async16(ks + t * Ly::kRS + c, kp + step * sk.s + c, ok);
    cp_async16(vs + t * Ly::kRS + c, vp + step * sv.s + c, ok);
  }
  for (int i = threadIdx.x; i < kL * (kD / 4); i += kThreads) {
    const int t = i / (kD / 4), c = (i % (kD / 4)) * 4;
    const bool ok = t < n;
    const int64_t step = t0 + (ok ? t : 0);
    cp_async16(ls + t * kFS + c, wp + step * sw.s + c, ok);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_scan_tc_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ log_w,
                     const float* __restrict__ u,
                     const float* __restrict__ s0, T* __restrict__ o,
                     float* __restrict__ s_final, Strides sr, Strides sk,
                     Strides sv, Strides sw, Strides so, int heads, int seq) {
  using Ly = Layout<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Rt = reinterpret_cast<float*>(smem + 2 * Ly::kStage);  // [L][kFS]
  float* Kt = Rt + kL * kFS;
  float* Am = Kt + kL * kFS;     // scores A_ts, s <= t within the chunk
  float* Sm = Am + kL * kFS;     // the state at the chunk's start [K][kFS]
  float* R8 = Sm + kD * kFS;     // [4 sub-chunks][8 upper-half rows][kFS]
  float* K8 = R8 + kL / 2 * kFS; // [4 sub-chunks][8 lower-half rows][kFS]
  float* Tq = K8 + kL / 2 * kFS; // [4][kD] T_q
  float* Pt = Tq + 4 * kD;       // [4][kD] T_0 .. T_{q-1}
  float* Ft = Pt + 4 * kD;       // [4][kD] T_{q+1} .. T_3
  float* All = Ft + 4 * kD;      // [kD] T_0 .. T_3
  float* u_s = All + kD;         // [kD]

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = warp >> 1;          // P3: row tile (sub-chunk / K rows)
  const int v0 = 32 * (warp & 1);    // P3: the warp's 32 V columns

  const T* rp = r + b * sr.b + h * sr.h;
  const T* kp = k + b * sk.b + h * sk.h;
  const T* vp = v + b * sv.b + h * sv.h;
  const float* wp = log_w + b * sw.b + h * sw.h;
  T* op = o + b * so.b + h * so.h;
  const float* s0p = s0 + static_cast<int64_t>(bh) * kD * kD;
  float* sfp = s_final + static_cast<int64_t>(bh) * kD * kD;

  // The warp's state tile: rows 16 mi + g (+ 8), columns v0 + 8 nt + 2 t4
  // (+ 1), in the mma accumulator's layout.
  float st[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = v0 + 8 * nt + 2 * t4;
    const int r0 = 16 * mi + g;
    st[nt][0] = s0p[r0 * kD + c];
    st[nt][1] = s0p[r0 * kD + c + 1];
    st[nt][2] = s0p[(r0 + 8) * kD + c];
    st[nt][3] = s0p[(r0 + 8) * kD + c + 1];
    Sm[r0 * kFS + c] = st[nt][0];
    Sm[r0 * kFS + c + 1] = st[nt][1];
    Sm[(r0 + 8) * kFS + c] = st[nt][2];
    Sm[(r0 + 8) * kFS + c + 1] = st[nt][3];
  }
  if (tid < kD) u_s[tid] = u[h * kD + tid];

  const int chunks = (seq + kL - 1) / kL;
  if (chunks > 0) {
    load_chunk<T>(smem, rp, kp, vp, wp, sr, sk, sv, sw, 0, min(kL, seq));
  }
  cp_async_commit();

  for (int ci = 0; ci < chunks; ++ci) {
    const int n = min(kL, seq - ci * kL);
    const int64_t t0 = static_cast<int64_t>(ci) * kL;
    if (ci + 1 < chunks) {
      load_chunk<T>(smem + ((ci + 1) & 1) * Ly::kStage, rp, kp, vp, wp, sr,
                    sk, sv, sw, t0 + kL, min(kL, seq - (ci + 1) * kL));
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    unsigned char* stage = smem + (ci & 1) * Ly::kStage;
    const T* rs = reinterpret_cast<const T*>(stage);
    const T* ks = rs + kL * Ly::kRS;
    const T* vs = ks + kL * Ly::kRS;
    float* ws = reinterpret_cast<float*>(stage + 3 * Ly::kTile);

    // P1: thread (sub-chunk q, channel c): w = exp(log_w) in place; R, K,
    // T_q, and R8, K8 of the halves, by running products.
    {
      const int q = tid >> 6, c = tid & 63;
      float w[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        float* p = ws + (q * kQ + j) * kFS + c;
        w[j] = expf(*p);
        *p = w[j];
      }
      float e = 1.f, e8 = 1.f;
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int t = q * kQ + j;
        const float x = to_float(rs[t * Ly::kRS + c]);
        Rt[t * kFS + c] = x * e;
        e *= w[j];
        if (j >= kH) {
          R8[(q * kH + j - kH) * kFS + c] = x * e8;
          e8 *= w[j];
        }
      }
      Tq[q * kD + c] = e;
      float f = 1.f, f8 = 1.f;
#pragma unroll
      for (int j = kQ - 1; j >= 0; --j) {
        const int t = q * kQ + j;
        const float x = to_float(ks[t * Ly::kRS + c]);
        Kt[t * kFS + c] = x * f;
        f *= w[j];
        if (j < kH) {
          K8[(q * kH + j) * kFS + c] = x * f8;
          f8 *= w[j];
        }
      }
    }
    __syncthreads();

    // P2a: within each half sub-chunk, A_ts for s < t by the exact decay
    // per channel (CUDA cores), A_tt the bonus, zeros above the diagonal.
    // Thread (row pair p, channel octet oc): rows ta = 8 hb + jj (jj
    // pairs) and tb = 8 hb + 7 - jj (7 - jj pairs), 7 pairs in all, summed
    // over the octet's 8 lanes at the end.
    {
      const int p = tid >> 3, oc = tid & 7, c0 = 8 * oc;
      const int base = (p >> 2) * kH, jj = p & 3;
      const int ta = base + jj, tb = base + kH - 1 - jj;
      float ra[8], rb[8], kv[8], wv[8], dd[8], a[kH + 1];
      load8(rs + ta * Ly::kRS + c0, ra);
      load8(rs + tb * Ly::kRS + c0, rb);
      load8(ks + ta * Ly::kRS + c0, kv);
      a[kH - 1] = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) a[kH - 1] = fmaf(ra[c] * u_s[c0 + c], kv[c], a[kH - 1]);
      load8(ks + tb * Ly::kRS + c0, kv);
      a[kH] = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        a[kH] = fmaf(rb[c] * u_s[c0 + c], kv[c], a[kH]);
        dd[c] = 1.f;
      }
#pragma unroll
      for (int i = 0; i < kH - 1; ++i) {
        if (i == jj) {   // row ta is done: row tb from here on
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            ra[c] = rb[c];
            dd[c] = 1.f;
          }
        }
        const int s = i < jj ? ta - 1 - i : tb - 1 - (i - jj);
        load8(ks + s * Ly::kRS + c0, kv);
        load8(ws + s * kFS + c0, wv);
        float x0 = 0.f, x1 = 0.f;
#pragma unroll
        for (int c = 0; c < 8; c += 2) {
          x0 = fmaf(ra[c] * kv[c], dd[c], x0);
          x1 = fmaf(ra[c + 1] * kv[c + 1], dd[c + 1], x1);
          dd[c] *= wv[c];
          dd[c + 1] *= wv[c + 1];
        }
        a[i] = x0 + x1;
      }
#pragma unroll
      for (int m = 1; m < 8; m <<= 1) {
#pragma unroll
        for (int i = 0; i <= kH; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], m);
      }
      // Lane oc stores sum oc (pair oc, or at 7 the bonus of ta) and a
      // zero above the diagonal; lane 0 also the bonus of tb.
      float mine = a[0];
#pragma unroll
      for (int i = 1; i < kH; ++i) mine = oc == i ? a[i] : mine;
      if (oc < kH - 1) {
        const int t = oc < jj ? ta : tb;
        const int s = oc < jj ? ta - 1 - oc : tb - 1 - (oc - jj);
        Am[t * kFS + s] = mine;
        const bool up_a = oc < kH - 1 - jj;
        const int zt = up_a ? ta : tb;
        const int zs = up_a ? ta + 1 + oc : tb + 1 + (oc - (kH - 1 - jj));
        Am[zt * kFS + zs] = 0.f;
      } else {
        Am[ta * kFS + ta] = mine;
        Am[tb * kFS + tb] = a[kH];
      }
    }
    if (warp < 6) {
      // P2b: warps 0-5, sub-chunk pairs (i, j), j < i: A_ij = R_i (K_j
      // T_{j+1..i-1})^T on the tensor cores.
      const int i = warp < 1 ? 1 : (warp < 3 ? 2 : 3);
      const int j = warp - i * (i - 1) / 2;
      float acc[2][4] = {}, accc[2][4] = {};
      if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const int c = 16 * kk + 2 * t4;
          float2 g01 = make_float2(1.f, 1.f), g89 = g01;
          for (int m = j + 1; m < i; ++m) {
            const float2 x = *reinterpret_cast<const float2*>(Tq + m * kD + c);
            const float2 y =
                *reinterpret_cast<const float2*>(Tq + m * kD + c + 8);
            g01 = make_float2(g01.x * x.x, g01.y * x.y);
            g89 = make_float2(g89.x * y.x, g89.y * y.y);
          }
          uint32_t ah[4], al[4];
          a_frag16(Rt, kQ * i + g, c, make_float2(1.f, 1.f),
                   make_float2(1.f, 1.f), ah, al);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float* kr = Kt + (kQ * j + 8 * nt + g) * kFS + c;
            const float2 x = *reinterpret_cast<const float2*>(kr);
            const float2 y = *reinterpret_cast<const float2*>(kr + 8);
            uint32_t bh0, bl0, bh1, bl1;
            split2(x.x * g01.x, x.y * g01.y, bh0, bl0);
            split2(y.x * g89.x, y.y * g89.y, bh1, bl1);
            mma16x3(acc[nt], accc[nt], ah, al, bh0, bh1, bl0, bl1);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kD / 8; ++kk) {
          const int c = 8 * kk + t4;
          float g0 = 1.f, g1 = 1.f;
          for (int m = j + 1; m < i; ++m) {
            g0 *= Tq[m * kD + c];
            g1 *= Tq[m * kD + c + 4];
          }
          uint32_t ah[4], al[4];
          a_frag(Rt, kQ * i + g, c, 1.f, 1.f, 1.f, 1.f, ah, al);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int s = kQ * j + 8 * nt + g;
            mma3(acc[nt], accc[nt], ah, al, Kt[s * kFS + c] * g0,
                 Kt[s * kFS + c + 4] * g1);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int row = kQ * i + g, s = kQ * j + 8 * nt + 2 * t4;
        Am[row * kFS + s] = acc[nt][0] + accc[nt][0];
        Am[row * kFS + s + 1] = acc[nt][1] + accc[nt][1];
        Am[(row + 8) * kFS + s] = acc[nt][2] + accc[nt][2];
        Am[(row + 8) * kFS + s + 1] = acc[nt][3] + accc[nt][3];
      }
    } else {
      // P2c: warps 6, 7, sub-chunks q0, q0 + 1: the upper half's rows
      // against the lower half's columns, A = R8 K8^T (rows 8 q0.. of R8
      // against K8 of q0, rows 8 (q0 + 1).. against K8 of q0 + 1), and
      // zeros for the lower half's rows against the upper half's columns.
      const int q0 = 2 * (warp - 6);
      {   // the products of T_q that P3 takes, per channel
        const int c = tid - 6 * 32;
        const float x0 = Tq[c], x1 = Tq[kD + c], x2 = Tq[2 * kD + c];
        const float x3 = Tq[3 * kD + c];
        Pt[c] = 1.f;
        Pt[kD + c] = x0;
        Pt[2 * kD + c] = x0 * x1;
        Pt[3 * kD + c] = x0 * x1 * x2;
        Ft[3 * kD + c] = 1.f;
        Ft[2 * kD + c] = x3;
        Ft[kD + c] = x3 * x2;
        Ft[c] = x3 * x2 * x1;
        All[c] = x3 * x2 * x1 * x0;
      }
      float acc[2][4] = {}, accc[2][4] = {};
      if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          const int c = 16 * kk + 2 * t4;
          uint32_t ah[4], al[4];
          a_frag16(R8, kH * q0 + g, c, make_float2(1.f, 1.f),
                   make_float2(1.f, 1.f), ah, al);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const float* kr = K8 + (kH * (q0 + nt) + g) * kFS + c;
            const float2 x = *reinterpret_cast<const float2*>(kr);
            const float2 y = *reinterpret_cast<const float2*>(kr + 8);
            uint32_t bh0, bl0, bh1, bl1;
            split2(x.x, x.y, bh0, bl0);
            split2(y.x, y.y, bh1, bl1);
            mma16x3(acc[nt], accc[nt], ah, al, bh0, bh1, bl0, bl1);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kD / 8; ++kk) {
          const int c = 8 * kk + t4;
          uint32_t ah[4], al[4];
          a_frag(R8, kH * q0 + g, c, 1.f, 1.f, 1.f, 1.f, ah, al);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int s = kH * (q0 + nt) + g;
            mma3(acc[nt], accc[nt], ah, al, K8[s * kFS + c],
                 K8[s * kFS + c + 4]);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int q = q0 + nt, t = kQ * q + kH + g, s = kQ * q + 2 * t4;
        const int x = 2 * nt;   // rows g of nt 0, rows g + 8 of nt 1
        Am[t * kFS + s] = acc[nt][x] + accc[nt][x];
        Am[t * kFS + s + 1] = acc[nt][x + 1] + accc[nt][x + 1];
      }
#pragma unroll
      for (int e = lane; e < 2 * kH * kH; e += 32) {
        const int q = q0 + e / (kH * kH), i = (e / kH) % kH, jz = e % kH;
        Am[(kQ * q + i) * kFS + kQ * q + kH + jz] = 0.f;
      }
    }
    __syncthreads();

    // P3: warp (mi, v0), one pass over k-steps kk: the state rows 16 mi..
    // of K, S <- diag(T_all) S + (K T_{j+1..3})^T V, and the o rows of
    // sub-chunk mi, (R T_0..T_{mi-1}) S + A V, sharing each step's v.
    {
      const int row = kQ * mi + g;
      const float all0 = All[row], all1 = All[row + 8];
      float sc[4][4] = {}, oc[4][4] = {}, occ[4][4] = {};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        st[nt][0] *= all0;
        st[nt][1] *= all0;
        st[nt][2] *= all1;
        st[nt][3] *= all1;
      }
      if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < kL / 16; ++kk) {
          // Columns s, s + 1, s + 8, s + 9: steps of sub-chunk kk (S, A V)
          // or channels (R S).
          const int s = 16 * kk + 2 * t4;
          const float fa = Ft[kk * kD + row], fb = Ft[kk * kD + row + 8];
          uint32_t kh[4], kl[4], rh[4], rl[4], ah[4], al[4];
          split2(Kt[s * kFS + row] * fa, Kt[(s + 1) * kFS + row] * fa, kh[0],
                 kl[0]);
          split2(Kt[s * kFS + row + 8] * fb, Kt[(s + 1) * kFS + row + 8] * fb,
                 kh[1], kl[1]);
          split2(Kt[(s + 8) * kFS + row] * fa, Kt[(s + 9) * kFS + row] * fa,
                 kh[2], kl[2]);
          split2(Kt[(s + 8) * kFS + row + 8] * fb,
                 Kt[(s + 9) * kFS + row + 8] * fb, kh[3], kl[3]);
          const float* pt = Pt + mi * kD + s;
          a_frag16(Rt, row, s, *reinterpret_cast<const float2*>(pt),
                   *reinterpret_cast<const float2*>(pt + 8), rh, rl);
          const bool intra = kk <= mi;
          if (intra) {
            a_frag16(Am, row, s, make_float2(1.f, 1.f), make_float2(1.f, 1.f),
                     ah, al);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int vc = v0 + 8 * nt + g;
            const uint32_t vb0 = v_pair(vs, Ly::kRS, s, vc);
            const uint32_t vb1 = v_pair(vs, Ly::kRS, s + 8, vc);
            mma16(sc[nt], kl, vb0, vb1);
            mma16(st[nt], kh, vb0, vb1);
            uint32_t sh0, sl0, sh1, sl1;
            split2(Sm[s * kFS + vc], Sm[(s + 1) * kFS + vc], sh0, sl0);
            split2(Sm[(s + 8) * kFS + vc], Sm[(s + 9) * kFS + vc], sh1, sl1);
            mma16x3(oc[nt], occ[nt], rh, rl, sh0, sh1, sl0, sl1);
            if (intra) {
              mma16(occ[nt], al, vb0, vb1);
              mma16(oc[nt], ah, vb0, vb1);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kL / 8; ++kk) {
          const int s = 8 * kk + t4;   // a step (S, A V) or a channel (R S)
          const float* f = Ft + (kk >> 1) * kD;
          uint32_t kh[4], kl[4], rh[4], rl[4], ah[4], al[4];
          split(Kt[s * kFS + row] * f[row], kh[0], kl[0]);
          split(Kt[s * kFS + row + 8] * f[row + 8], kh[1], kl[1]);
          split(Kt[(s + 4) * kFS + row] * f[row], kh[2], kl[2]);
          split(Kt[(s + 4) * kFS + row + 8] * f[row + 8], kh[3], kl[3]);
          const float p0 = Pt[mi * kD + s], p1 = Pt[mi * kD + s + 4];
          a_frag(Rt, row, s, p0, p0, p1, p1, rh, rl);
          const bool intra = kk < 2 * (mi + 1);
          if (intra) a_frag(Am, row, s, 1.f, 1.f, 1.f, 1.f, ah, al);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int vc = v0 + 8 * nt + g;
            const float vb0 = to_float(vs[s * Ly::kRS + vc]);
            const float vb1 = to_float(vs[(s + 4) * Ly::kRS + vc]);
            mma3(st[nt], sc[nt], kh, kl, vb0, vb1);
            mma3(oc[nt], occ[nt], rh, rl, Sm[s * kFS + vc],
                 Sm[(s + 4) * kFS + vc]);
            if (intra) mma3(oc[nt], occ[nt], ah, al, vb0, vb1);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int vc = v0 + 8 * nt + 2 * t4;
        if (row < n) {
          store2(op + (t0 + row) * so.s + vc, oc[nt][0] + occ[nt][0],
                 oc[nt][1] + occ[nt][1]);
        }
        if (row + 8 < n) {
          store2(op + (t0 + row + 8) * so.s + vc, oc[nt][2] + occ[nt][2],
                 oc[nt][3] + occ[nt][3]);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) st[nt][x] += sc[nt][x];
      }
    }
    __syncthreads();   // every read of Sm, R, K, A and this stage is done
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = v0 + 8 * nt + 2 * t4, r0 = kQ * mi + g;
      Sm[r0 * kFS + c] = st[nt][0];
      Sm[r0 * kFS + c + 1] = st[nt][1];
      Sm[(r0 + 8) * kFS + c] = st[nt][2];
      Sm[(r0 + 8) * kFS + c + 1] = st[nt][3];
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = v0 + 8 * nt + 2 * t4, r0 = kQ * mi + g;
    sfp[r0 * kD + c] = st[nt][0];
    sfp[r0 * kD + c + 1] = st[nt][1];
    sfp[(r0 + 8) * kD + c] = st[nt][2];
    sfp[(r0 + 8) * kD + c + 1] = st[nt][3];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* log_w,
           const void* u, const void* s0, void* o, void* s_final,
           const int64_t* strides, int batch, int heads, int seq,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_tc_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Layout<T>::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const Strides sr{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides sw{strides[9], strides[10], strides[11]};
  const Strides so{strides[12], strides[13], strides[14]};
  rwkv6_scan_tc_kernel<T><<<batch * heads, kThreads, Layout<T>::kBytes,
                            stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(o), static_cast<float*>(s_final), sr, sk, sv, sw, so,
      heads, seq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). r, k, v, log_w: (B, S, H, 64)
// addressed through `strides` (batch, step and head strides of r, k, v,
// log_w and o, in elements; the last dimension contiguous, every row
// 16-byte aligned); u: (H, 64), s0 and s_final: (B, H, 64, 64),
// contiguous; o: (B, S, H, 64). dtype 0 is float32, 1 bfloat16 (r, k, v
// and o). The caller guarantees B, H > 0 and S >= 0. Launches on `stream`,
// never synchronises, returns the CUDA error of the launch (0 on success).
extern "C" int repro_rwkv6_scan_tc(const void* r, const void* k, const void* v,
                                   const void* log_w, const void* u,
                                   const void* s0, void* o, void* s_final,
                                   const int64_t* strides, int batch,
                                   int heads, int seq, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, log_w, u, s0, o, s_final, strides,
                                 batch, heads, seq, st);
  return launch<float>(r, k, v, log_w, u, s0, o, s_final, strides, batch,
                       heads, seq, st);
}
