// Causal / sliding-window GQA flash attention in bfloat16 on the tensor
// cores (mma.sync) for every head dim up to 256 that the wgmma kernel does
// not take: the prefill attention of StableLM-3B's `attn` layers (D = 80)
// and of any other bf16 head dim outside 64, 128 and 256.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_attn_kernel, called through flash_attention_hmajor), whose grid ran
// (B, H, Sq/bq, Skv/bk) with the KV axis sequential and the running
// (max, denominator, numerator) in VMEM scratch across it. Here one block
// owns one (batch, head, 64-row query tile) and walks the KV tiles of its
// band in a loop, the running sums in registers. bf16 at D = 64, 128 and
// 256 takes csrc/flash_attention_wgmma.cu, float32 and bf16 over 256 take
// the CUDA-core kernel of csrc/flash_attention.cu (kernels/
// flash_attention.py `_route` picks by dtype and D alone).
//
// What bounds it on Hopper: operations. At StableLM-3B's prefill (q, k, v
// (4, 4096, 32, 80), causal) the band holds 8,390,656 (q, k) pairs per
// (batch, head), 4 * 80 flops each: 3.44e11 flops, 0.348 ms at the 989
// TFLOP/s bf16 peak, against 168 MB of q/k/v/o (0.05 ms at 3.35 TB/s).
// The CUDA-core kernel ran both products as float32 FMAs (about 10
// TFLOP/s). Here:
// - Both products run on mma.sync.m16n8k16 (bf16 in, float32 sums), fed
//   by ldmatrix: S = Q K^T with Q (A) and K (B, "col": K's rows are
//   keys, D contiguous) read as they lie; O += P V with P from registers
//   (the S accumulator's layout is the A fragment's) and V through
//   ldmatrix.trans. bf16 x bf16 products are exact in float32, so S
//   differs from the float32 reference's only in the order of its sums.
//   wgmma's 64-column, 128-byte-swizzled TMA boxes do not fit D = 80;
//   mma.sync takes any multiple of 16.
// - The head dim is zero-filled in shared memory to DP, the next multiple
//   of 16 (of 32 above 128). Zero columns add nothing to Q K^T and their
//   output columns are dropped, so this is exact; it puts D = 6 and 36 on
//   the tensor cores too.
// - P kept precise, as in the wgmma kernel: p in [0, 1] splits into bf16
//   hi = bf16(p) and lo = bf16(p - hi), and both halves go through P V;
//   one rounding of P leaves the output about 2e-3 beyond one bf16
//   rounding of float32 attention, where the checks allow 1e-4. The row
//   sum l is taken from the unrounded float32 p. The split makes the
//   tensor work 1.5 times the bound's count.
// - K and V tiles of 64 keys (16 above DP = 192, where O's accumulators
//   and more keys' scores spill) stay bf16 in shared memory, rows padded
//   by 8 bf16 so each ldmatrix phase's eight 16-byte rows hit distinct
//   banks, and arrive by cp.async in a 2-stage ring: the next tile loads
//   while the block computes on this one. Each copy moves 16 bytes where the
//   rows' alignment allows, else 8 or 4, else (an odd D) one element at a
//   time; rows past Skv are zero-filled.
// - A block is 4 warps of 16 query rows: each K/V tile is read from
//   device memory once for 64 rows. Q stays in registers up to DP = 128
//   (in shared memory above, where O's DP / 2 float32 registers a thread
//   leave too little room). Blocks with the longest bands start first.
// - KV tiles wholly outside the block's band are neither loaded nor
//   multiplied, and a warp skips a tile wholly outside its own 16 rows'
//   band. Masks (causal k <= q, window k > q - window, k < Skv, from
//   absolute positions) apply only on tiles that cross a band edge.
//   Masked scores take the finite NEG_INF of the reference, with its
//   `safe` guard and its 1e-20 denominator floor, so a fully masked row
//   gives 0. The softmax runs in float32 in base 2, the scale
//   log2(e)/sqrt(D) folded into each exponent's FFMA; output is rounded
//   once to bf16.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;           // query rows per block: 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kMaxD = 256;
constexpr float kNegInf = -2.3819763e38f;
constexpr unsigned kFull = 0xffffffffu;

template <int DP>
struct Cfg {
  // Keys per KV tile: 16 above DP = 192, where O's DP / 2 registers a
  // thread and the scores of more keys spill (32 did at DP = 256).
  static constexpr int kBK = DP > 192 ? 16 : 64;
  static constexpr int kLd = DP + 8;              // padded smem row (bf16)
  static constexpr int kTile = kBK * kLd;         // one K or V tile
  static constexpr int kSmem = (kBQ * kLd + 2 * kStages * kTile) * 2;
  static constexpr int kKSteps = DP / 16;         // k-steps of Q K^T
  static constexpr int kOBlocks = DP / 8;         // 8-column blocks of O
  static constexpr bool kQRegs = DP <= 128;
};

struct Strides {
  int64_t b, s, h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// G bytes from src to shared dst by cp.async, or G zero bytes when !ok
// (src-size 0: nothing is read).
template <int G>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool ok) {
  const int n = ok ? G : 0;
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(G), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest has landed (this thread's copies).
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [r0, r0 + rows) of one head of a (B, S, H, D) tensor (`base` at the
// head's row 0, `rs` elements between rows) into shared rows of LD bf16;
// rows at or past `limit` are zero-filled. Copies of G bytes (G = 2: one
// element at a time, synchronously).
template <int LD, int G>
__device__ __forceinline__ void load_rows(bf16* sh, const bf16* base,
                                          int64_t rs, int r0, int rows,
                                          int limit, int d) {
  constexpr int kEl = G / 2;
  const int per_row = d / kEl;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i - r * per_row) * kEl;
    const bool ok = r0 + r < limit;
    const bf16* src = ok ? base + (r0 + r) * rs + c : base;
    bf16* dst = sh + r * LD + c;
    if constexpr (G == 2)
      *dst = ok ? *src : __float2bfloat16(0.f);
    else
      cp_async<G>(smem_addr(dst), src, ok);
  }
}

template <int LD>
__device__ __forceinline__ void load_tile(int g, bf16* sh, const bf16* base,
                                          int64_t rs, int r0, int rows,
                                          int limit, int d) {
  if (g == 16)
    load_rows<LD, 16>(sh, base, rs, r0, rows, limit, d);
  else if (g == 8)
    load_rows<LD, 8>(sh, base, rs, r0, rows, limit, d);
  else if (g == 4)
    load_rows<LD, 4>(sh, base, rs, r0, rows, limit, d);
  else
    load_rows<LD, 2>(sh, base, rs, r0, rows, limit, d);
}

// 2^x (the hardware's approximation, relative error about 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// A fragments of the hi and lo halves of two floats' bf16 split.
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(p0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(p1 - __bfloat162float(h1)));
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           Strides qs, Strides ks, Strides vs, Strides os,
                           int sq, int skv, int group, int d, int causal,
                           int window, float scale_log2, int g) {
  using C = Cfg<DP>;
  constexpr int LD = C::kLd, kBK = C::kBK;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* q_sh = reinterpret_cast<bf16*>(smem_raw);     // [kBQ][LD]
  bf16* k_sh = q_sh + kBQ * LD;                       // [stage][kBK][LD]
  bf16* v_sh = k_sh + kStages * C::kTile;

  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;               // GQA: the head's kv head
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  // The KV tiles the block's rows can see.
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_first = (window > 0 ? max(0, q0 - window + 1) : 0) / kBK * kBK;
  const int n_tiles = k_end > k_first ? (k_end - k_first + kBK - 1) / kBK : 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qa = q0 + 16 * warp;                 // the warp's rows
  const int row0 = qa + lane / 4;                // this thread's: row0, +8

  // The zero tail of the head dim: columns [d, DP) of every row, never
  // written by the loads.
  if (d < DP) {
    const int tail = DP - d;
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < (kBQ + 2 * kStages * kBK) * tail; i += kThreads)
      q_sh[(i / tail) * LD + d + i % tail] = zero;
  }
  if (n_tiles > 0) {
    load_tile<LD>(g, q_sh, qb, qs.s, q0, kBQ, sq, d);
    load_tile<LD>(g, k_sh, kb, ks.s, k_first, kBK, skv, d);
    load_tile<LD>(g, v_sh, vb, vs.s, k_first, kBK, skv, d);
  }
  cp_async_commit();

  float acc[C::kOBlocks][4];
#pragma unroll
  for (int j = 0; j < C::kOBlocks; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // Running row max (of unscaled scores) and row sum of rows row0, +8.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qf[C::kQRegs ? C::kKSteps : 1][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = k_first + it * kBK;
    if (it + 1 < n_tiles) {
      const int ns = (it + 1) % kStages;
      load_tile<LD>(g, k_sh + ns * C::kTile, kb, ks.s, k0 + kBK, kBK, skv, d);
      load_tile<LD>(g, v_sh + ns * C::kTile, vb, vs.s, k0 + kBK, kBK, skv, d);
    }
    cp_async_commit();
    cp_async_wait_1();                  // tile `it` (and Q) have landed
    __syncthreads();
    const bf16* kt = k_sh + s * C::kTile;
    const bf16* vt = v_sh + s * C::kTile;
    if constexpr (C::kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < C::kKSteps; ++kk)
          ldmatrix_x4(qf[kk], q_sh + (16 * warp + (lane & 15)) * LD +
                                  16 * kk + (lane >> 4) * 8);
      }
    }
    // Wholly outside the warp's band (or past Sq), or crossing its edges.
    const bool skip = qa >= sq || (causal && k0 > qa + 15) ||
                      (window > 0 && k0 + kBK - 1 <= qa - window);
    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > qa) ||
                      (window > 0 && k0 <= qa + 15 - window);
    if (!skip) {
      // S = Q K^T, this warp's 16 rows x 64 keys: sc[j] holds keys
      // 8j + 2 (lane & 3) + {0, 1} of rows row0 (e = 0, 1) and row0 + 8
      // (e = 2, 3).
      float sc[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < C::kKSteps; ++kk) {
        uint32_t a[4];
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldmatrix_x4(a, q_sh + (16 * warp + (lane & 15)) * LD + 16 * kk +
                             (lane >> 4) * 8);
        }
#pragma unroll
        for (int n2 = 0; n2 < kBK / 16; ++n2) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kt + (16 * n2 + (lane & 7) + ((lane >> 4) << 3)) *
                                   LD +
                              16 * kk + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * n2], a, bk[0], bk[1]);
          mma_bf16(sc[2 * n2 + 1], a, bk[2], bk[3]);
        }
      }

      if (edge) {       // a real branch: most tiles need no mask
        const int key0 = k0 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * j + (e & 1);
            const int row = row0 + 8 * (e >> 1);
            if (!(key < skv && (!causal || key <= row) &&
                  (window <= 0 || key > row - window)))
              sc[j][e] = kNegInf;
          }
      }
      // Online softmax in base 2; each row lies on the four lanes of a
      // quad. The reference's guard: a row with no key in the band so far
      // (max <= NEG_INF / 2) gives p = 0 and alpha = 0; subtracting
      // -NEG_INF instead of the max drives every exponent to -inf, which
      // ex2 takes to 0 with no select per element.
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        mu[r] = mx > kNegInf * 0.5f ? mx * scale_log2 : -kNegInf;
        const float alpha = ex2(fmaf(m[r], scale_log2, -mu[r]));
        m[r] = mx;
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < C::kOBlocks; ++j) {
          acc[j][2 * r] *= alpha;
          acc[j][2 * r + 1] *= alpha;
        }
      }
      // O += P V, 16 keys a step: P's A fragments (hi and lo) from the S
      // accumulators of key blocks 2 kk and 2 kk + 1.
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        float p[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[half][e] = ex2(fmaf(sc[2 * kk + half][e], scale_log2,
                                  -mu[e >> 1]));
            l[e >> 1] += p[half][e];
          }
        uint32_t phi[4], plo[4];
        split2(p[0][0], p[0][1], phi[0], plo[0]);
        split2(p[0][2], p[0][3], phi[1], plo[1]);
        split2(p[1][0], p[1][1], phi[2], plo[2]);
        split2(p[1][2], p[1][3], phi[3], plo[3]);
#pragma unroll
        for (int n2 = 0; n2 < C::kOBlocks / 2; ++n2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (16 * kk + (lane & 15)) * LD + 16 * n2 +
                                    (lane >> 4) * 8);
          mma_bf16(acc[2 * n2], phi, bv[0], bv[1]);
          mma_bf16(acc[2 * n2], plo, bv[0], bv[1]);
          mma_bf16(acc[2 * n2 + 1], phi, bv[2], bv[3]);
          mma_bf16(acc[2 * n2 + 1], plo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                    // stage `s` is free for tile it + 2
  }

  // The row sums over the quad, the denominator floor, bf16 out.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    l[r] = fmaxf(l[r], 1e-20f);
  }
  bf16* ob = o + b * os.b + h * os.h;
  const bool pairs = d % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    bf16* orow = ob + row * os.s;
#pragma unroll
    for (int j = 0; j < C::kOBlocks; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const float x0 = acc[j][2 * r] / l[r], x1 = acc[j][2 * r + 1] / l[r];
      if (pairs) {
        if (col < d) {
          __nv_bfloat162 pair;
          pair.x = __float2bfloat16_rn(x0);
          pair.y = __float2bfloat16_rn(x1);
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = pair;
        }
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* st, int batch, int sq, int skv, int heads,
           int group, int d, int causal, int window, float scale, int g,
           cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  auto kernel = flash_attention_mma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<DP>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  kernel<<<grid, kThreads, Cfg<DP>::kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), qs, ks, vs, os, sq,
      skv, group, d, causal, window, scale * 1.4426950408889634f, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). bf16 q (B, Sq, H, D), k and v
// (B, Skv, Hkv, D), o (B, Sq, H, D); `strides` holds the batch, row and
// head strides, in elements, of q, k, v and o (12 values), the last
// dimension of each contiguous. `g` is the bytes of one copy, 16, 8, 4 or
// 2: the caller guarantees that 2 d, every stride of q, k and v times 2
// and their base addresses are multiples of it, that o's strides are even
// where d is, 0 < d <= 256, heads % group == 0 and sq > 0. Launches on
// `stream`, never synchronises, returns the CUDA error of the launch (0
// on success).
extern "C" int repro_flash_attention_mma(const void* q, const void* k,
                                         const void* v, void* o,
                                         const int64_t* strides, int batch,
                                         int sq, int skv, int heads,
                                         int group, int d, int causal,
                                         int window, float scale, int g,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > kMaxD || !(g == 16 || g == 8 || g == 4 || g == 2))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_MMA(DP)                                                 \
  if (d <= DP)                                                              \
    return launch<DP>(q, k, v, o, strides, batch, sq, skv, heads, group, d, \
                      causal, window, scale, g, st);
  REPRO_FLASH_MMA(16)
  REPRO_FLASH_MMA(32)
  REPRO_FLASH_MMA(48)
  REPRO_FLASH_MMA(64)
  REPRO_FLASH_MMA(80)
  REPRO_FLASH_MMA(96)
  REPRO_FLASH_MMA(112)
  REPRO_FLASH_MMA(128)
  REPRO_FLASH_MMA(160)
  REPRO_FLASH_MMA(192)
  REPRO_FLASH_MMA(224)
  REPRO_FLASH_MMA(256)
#undef REPRO_FLASH_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}
