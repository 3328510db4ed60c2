// Causal / sliding-window GQA flash attention in bfloat16 on Hopper's
// tensor cores: the prefill attention of the model's `attn` and `local`
// layers for bf16 q, k, v with a head dim D of 64, 128 or 256.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_attn_kernel, called through flash_attention_hmajor), whose grid ran
// (B, H, Sq/bq, Skv/bk) with the KV axis sequential and the running
// (max, denominator, numerator) in VMEM scratch across it. Here one block
// owns one (batch, head, 128-row query tile) and walks the KV tiles of its
// band in a loop, the running sums in registers. float32 inputs and other
// head dims take the CUDA-core kernel of csrc/flash_attention.cu
// (kernels/flash_attention.py `_route` picks by dtype and D alone).
//
// What bounds it on Hopper: operations. At the main path's shape (q (4,
// 4096, 10, 256), k/v (4, 4096, 1, 256), causal, window 2048) the band
// holds 6,292,480 (q, k) pairs per (batch, head), 4*D flops each: 2.58e11
// flops, 0.2606 ms at the 989 TFLOP/s bf16 peak, against 16.8 MB of
// q/k/v/o in device memory (5 us). So both products run on the tensor
// cores, as wgmma.mma_async with float32 accumulators:
// - S = Q K^T: m64n64k16, Q and K tiles in shared memory, 128-byte
//   swizzled, both K-major (D contiguous). bf16 x bf16 products are exact
//   in float32, so S differs from the float32 reference's only in the
//   order of its sums.
// - O += P V: m64n64k16 per 64-column chunk of D, P from registers as the
//   A operand (the S accumulator's layout is the A fragment's), V from
//   shared memory in the transposed-B (MN-major) layout.
//
// P kept precise. P in [0, 1] is split into bf16 halves, hi = bf16(p) and
// lo = bf16(p - hi), and both halves go through P V (two wgmma per step):
// hi + lo holds p to about 2^-16 of its size. Rounding P once to bf16, as
// FlashAttention-2/3 do, leaves the output about 2e-3 beyond one bf16
// rounding of float32 attention where chip_smoke.py's check allows 1e-4;
// with the split it stays within about 2e-6 (tests/test_torch_flash_tc.py
// emulates this kernel's arithmetic both ways). The row sum l is taken
// from the unrounded float32 p. The split makes the tensor work 1.5 times
// the bound's count (S once, P V twice).
//
// Loads: K and V tiles of 64 keys come in through a ring of shared-memory
// stages (2 at D = 256, 3 below), filled by TMA (cp.async.bulk.tensor over
// the strided (B, S, H, D) layout: the model's layout needs no transposes)
// and completed on mbarriers, issued by one thread of a producer warpgroup.
// bf16 goes to shared memory as it is, in the 128-byte swizzle that wgmma
// reads. The tensor maps are encoded on the host through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// Block: 384 threads = a producer warpgroup and two consumer warpgroups
// of 64 query rows each; setmaxnreg moves registers from the producer (24)
// to the consumers (240), which hold O (64 x D float32: 128 registers a
// thread at D = 256), S and the two halves of P. Shared memory at D = 256:
// Q 64 KB + 2 stages x (K 32 KB + V 32 KB) = 192 KB of the 227 KB, one
// block an SM; blocks with the longest bands start first. KV tiles wholly
// outside the band are neither loaded nor multiplied; masks (causal
// k <= q, window k > q - window, k < Skv) apply only on tiles that cross
// the band's edges, and a consumer skips a tile that lies wholly outside
// its own 64 rows' band. Masked scores take the finite NEG_INF of the
// reference, with its `safe` guard and its 1e-20 denominator floor, so a
// fully masked row gives 0. The softmax runs in float32 in base 2, the
// scale log2(e)/sqrt(D) folded into each exponent's FFMA; output is
// rounded once to bf16.
//
// L2 traffic: each 128-row block reads about 2,176 keys x 256 x 2 B x 2
// (K and V) = 2.2 MB, about 2.8 GB from L2 per call at the serving shape
// against 16.8 MB in HBM. TMA multicast across a cluster of blocks that
// share a KV head is the lever if that traffic limits the kernel; the
// timings so far point at the consumers' serial chain instead (PERF.md).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;          // query rows per block: two warpgroups
constexpr int kBK = 64;           // keys per KV tile
constexpr int kChunk = 64;        // D columns per 128-byte swizzled chunk
constexpr int kRowBytes = 128;    // one chunk row in shared memory
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr float kNegInf = -2.3819763e38f;

template <int D>
struct Cfg {
  static constexpr int kNch = D / kChunk;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;      // one K or V tile
  // + 1 KB: the swizzled tiles need 1024-byte aligned bases.
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;
};

struct Strides {
  int64_t b, s, h;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA ----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed. (A trap on a
// time limit here would cost the consumers their register budget: ptxas
// then spills the D = 256 accumulators and serialises the wgmma.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One box of a 4-D tensor map (D, S, H, B) into shared memory at `dst`,
// its bytes completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte swizzled operand whose
// 8-row groups lie 1024 bytes apart; `lbo` is the leading byte offset
// (unused by K-major swizzled operands).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define REGS32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B, A (64x16) and B (16x64) both from shared memory, K-major.
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (64x16) from registers, B (16x64) from shared memory,
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             bf16* __restrict__ o, Strides os, int sq,
                             int skv, int group, int causal, int window,
                             float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * C::kStages];
  const uint32_t q_full = smem_u32(bars);
  const uint32_t k_full = q_full + 8;                   // + 8 * stage
  const uint32_t v_full = k_full + 8 * C::kStages;
  const uint32_t empty = v_full + 8 * C::kStages;
  const uint32_t q_sh = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_sh = q_sh + C::kQBytes;              // + stage * tile
  const uint32_t v_sh = k_sh + C::kStages * C::kTileBytes;

  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  // The KV tiles the block's rows can see.
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(skv, q_last + 1) : skv;
  const int k_first = (window > 0 ? max(0, q0 - window + 1) : 0) / kBK * kBK;
  const int n_tiles = k_end > k_first ? (k_end - k_first + kBK - 1) / kBK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);    // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kNch; ++c)
        tma_load(q_sh + c * kBQ * kRowBytes, &tq, q_full, c * kChunk, q0, h,
                 b);
      const int hk = h / group;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages;
        mbar_wait(empty + 8 * s, ((it / C::kStages) & 1) ^ 1);
        const int k0 = k_first + it * kBK;
        const uint32_t kd = k_sh + s * C::kTileBytes;
        const uint32_t vd = v_sh + s * C::kTileBytes;
        mbar_expect_tx(k_full + 8 * s, C::kTileBytes);
        for (int c = 0; c < C::kNch; ++c)
          tma_load(kd + c * kBK * kRowBytes, &tk, k_full + 8 * s,
                   c * kChunk, k0, hk, b);
        mbar_expect_tx(v_full + 8 * s, C::kTileBytes);
        for (int c = 0; c < C::kNch; ++c)
          tma_load(vd + c * kBK * kRowBytes, &tv, v_full + 8 * s,
                   c * kChunk, k0, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = tid / 128 - 1;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int qa = q0 + 64 * cw;                 // the warpgroup's rows
    const int row0 = qa + 16 * warp + lane / 4;  // this thread's: row0, +8
    const uint32_t q_wg = q_sh + 64 * cw * kRowBytes;

    float acc[C::kNch][32];
#pragma unroll
    for (int c = 0; c < C::kNch; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    // Running row max (of unscaled scores) and row sum.
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::kStages;
      const int parity = (it / C::kStages) & 1;
      const int k0 = k_first + it * kBK;
      // Wholly outside the warpgroup's band, or crossing its edges.
      const bool skip = (causal && k0 > qa + 63) ||
                        (window > 0 && k0 + kBK - 1 <= qa - window);
      const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > qa) ||
                        (window > 0 && k0 <= qa + 63 - window);
      const uint32_t kt = k_sh + s * C::kTileBytes;
      const uint32_t vt = v_sh + s * C::kTileBytes;
      uint32_t phi[4][4], plo[4][4];

      mbar_wait(k_full + 8 * s, parity);
      if (!skip) {
        // The descriptors of each step are the tile's plus an offset in
        // 16-byte units. The Q descriptor is made opaque in every tile, so
        // the compiler does not keep all sixteen steps' copies alive in
        // registers across the loop.
        uint64_t dq = sw128_desc(q_wg, 16);
        asm volatile("" : "+l"(dq));
        const uint64_t dk = sw128_desc(kt, 16);
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < C::kNch; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(sc, dq + ((c * kBQ * kRowBytes + 32 * kk) >> 4),
                     dk + ((c * kBK * kRowBytes + 32 * kk) >> 4), c + kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(sc);

        // Online softmax in base 2; this thread's rows are row0 (r = 0)
        // and row0 + 8 (r = 1), each spread over the four lanes of a quad.
        // Element i lies at key k0 + key0 + kc and row row0 + 8r, with
        // kc = 8 (i >> 2) + (i & 1) and r = (i >> 1) & 1 known at compile
        // time, so each mask is one compare of kc or kc - 8r with a bound
        // of the tile: key < Skv, key - row <= 0, key - row > -window.
        const int key0 = 2 * (lane & 3);
        const int lim_k = skv - k0 - key0;
        const int lim_c = causal ? row0 - k0 - key0 : (1 << 30);
        const int lim_w = window > 0 ? row0 - k0 - key0 - window : -(1 << 30);
        // Scores stay unscaled until the exponent: max commutes with the
        // positive scale, and s * scale - max * scale is one FFMA.
        if (edge) {     // a real branch: most tiles need no mask
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1, kc = 8 * (i >> 2) + (i & 1);
            if (!(kc < lim_k && kc - 8 * r <= lim_c && kc - 8 * r > lim_w))
              sc[i] = kNegInf;
          }
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 32; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        // The reference's guard: a row with no key in the band so far
        // (max <= NEG_INF / 2) gives p = 0 and alpha = 0. Subtracting
        // -NEG_INF instead of the max there drives every exponent to
        // -inf, which ex2 takes to 0 with no select per element.
        float mu[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          mu[r] = mx[r] > kNegInf * 0.5f ? mx[r] * scale_log2 : -kNegInf;
          const float alpha = ex2(fmaf(m[r], scale_log2, -mu[r]));
          m[r] = mx[r];
          l[r] *= alpha;
#pragma unroll
          for (int c = 0; c < C::kNch; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc[c][4 * j + 2 * r] *= alpha;
              acc[c][4 * j + 2 * r + 1] *= alpha;
            }
        }
        // P as the A fragments of four 16-key steps, split into bf16 hi
        // and lo halves; register e of step kk holds row r = e & 1.
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * kk + 2 * e, r = e & 1;
            const float p0 = ex2(fmaf(sc[i], scale_log2, -mu[r]));
            const float p1 = ex2(fmaf(sc[i + 1], scale_log2, -mu[r]));
            l[r] += p0 + p1;
            const bf16 h0 = __float2bfloat16_rn(p0);
            const bf16 h1 = __float2bfloat16_rn(p1);
            phi[kk][e] = pack_bf16(h0, h1);
            plo[kk][e] = pack_bf16(__float2bfloat16_rn(p0 - __bfloat162float(h0)),
                                   __float2bfloat16_rn(p1 - __bfloat162float(h1)));
          }
      }

      mbar_wait(v_full + 8 * s, parity);
      if (!skip) {
#pragma unroll
        for (int c = 0; c < C::kNch; ++c) fence_acc(acc[c]);
        wgmma_fence();
        const uint64_t dv = sw128_desc(vt, kBK * kRowBytes);
#pragma unroll
        for (int c = 0; c < C::kNch; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dvk =
                dv + ((c * kBK * kRowBytes + 16 * kk * kRowBytes) >> 4);
            wgmma_rs(acc[c], phi[kk], dvk);
            wgmma_rs(acc[c], plo[kk], dvk);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < C::kNch; ++c) fence_acc(acc[c]);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);   // this warp is done
    }

    // The row sums over the quad, the denominator floor, bf16 out.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-20f);
    }
    bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      bf16* orow = ob + row * os.s + 2 * (lane & 3);
#pragma unroll
      for (int c = 0; c < C::kNch; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          __nv_bfloat162 pair;
          pair.x = __float2bfloat16_rn(acc[c][4 * j + 2 * r] / l[r]);
          pair.y = __float2bfloat16_rn(acc[c][4 * j + 2 * r + 1] / l[r]);
          *reinterpret_cast<__nv_bfloat162*>(orow + c * kChunk + 8 * j) =
              pair;
        }
    }
  }
}

// ---- host side ------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 (B, S, H, D) tensor with element strides `st`
// (batch, row, head), read in boxes of 64 columns x `rows` rows.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int s, int h,
              int d, const int64_t* st, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kChunk, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* st, int batch, int sq, int skv, int heads,
           int kv_heads, int causal, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, batch, sq, heads, D, st, kBQ) ||
      !make_map(&tk, k, batch, skv, kv_heads, D, st + 3, kBK) ||
      !make_map(&tv, v, batch, skv, kv_heads, D, st + 6, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides os{st[9], st[10], st[11]};
  auto kernel = flash_attention_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, heads, batch);
  kernel<<<grid, kThreads, Cfg<D>::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), os, sq, skv, heads / kv_heads,
      causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). bf16 q (B, Sq, H, D), k and v
// (B, Skv, Hkv, D), o (B, Sq, H, D); `strides` holds the batch, row and
// head strides, in elements, of q, k, v and o (12 values), the last
// dimension of each contiguous. The caller guarantees d in {64, 128, 256},
// 16-byte aligned bases and strides, heads % kv_heads == 0, sq > 0 and
// skv > 0. Launches on `stream`, never synchronises, returns the CUDA
// error of the launch (0 on success; cudaErrorInvalidValue when a tensor
// map cannot be encoded).
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o,
                                           const int64_t* strides, int batch,
                                           int sq, int skv, int heads,
                                           int kv_heads, int d, int causal,
                                           int window, float scale,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, o, strides, batch, sq, skv, heads, kv_heads,
                      causal, window, scale, st);
  if (d == 128)
    return launch<128>(q, k, v, o, strides, batch, sq, skv, heads, kv_heads,
                       causal, window, scale, st);
  if (d == 256)
    return launch<256>(q, k, v, o, strides, batch, sq, skv, heads, kv_heads,
                       causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
