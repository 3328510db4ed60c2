// Causal / sliding-window GQA flash attention in bfloat16 on Hopper's
// tensor cores: the prefill attention of the model's `attn` and `local`
// layers for bf16 q, k, v with a head dim D that is a multiple of 16, up
// to 256 (RecurrentGemma-2B's 256, StableLM-3B's 80, InternLM2's 128,
// MusicGen's 64).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_attn_kernel, called through flash_attention_hmajor), whose grid ran
// (B, H, Sq/bq, Skv/bk) with the KV axis sequential and the running
// (max, denominator, numerator) in VMEM scratch across it. Here one block
// owns one (batch, head, query tile of 64 rows a consumer warpgroup) and
// walks the KV tiles of its band in a loop, the running sums in registers. Other bf16 head dims up
// to 256 take the mma.sync kernel of csrc/flash_attention_mma.cu, float32
// and wider ones the CUDA-core kernel of csrc/flash_attention.cu
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
// Head dims that are no multiple of 64: D = 64 * kNch + kTail with a tail
// of 16, 32 or 48 columns. Q and K read the tail as one more 64-column
// box; the tensor map's out-of-bounds fill writes zeros past D (as it
// does for key rows past Skv), so their tiles keep the 128-byte swizzle,
// and S runs only the kTail / 16 k-steps that hold real columns: exact
// work. V's tail comes through a second tensor map in 16-column boxes
// with the 32-byte swizzle, whose atom (8 rows x 16 columns) the tail's
// width is a multiple of, and its product is one m64n{kTail}k16 per
// 16-key step: exact work too, where a 64-wide product on a zero-filled
// chunk would do 64 / kTail times the tail's (at D = 80 P V's work 1.6
// times). The bytes each stage's mbarrier waits for are the boxes' whole
// size, out-of-bounds zeros included.
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
// stages (2 where D pads to 256, 3 below), filled by TMA
// (cp.async.bulk.tensor over the strided (B, S, H, D) layout: the model's
// layout needs no transposes) and completed on mbarriers, issued by one
// thread of a producer warpgroup.
// bf16 goes to shared memory as it is, in the 128-byte swizzle that wgmma
// reads. The tensor maps are encoded on the host through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
//
// Block: a producer warpgroup and consumer warpgroups of 64 query rows
// each, three (512 threads) up to D = 128, two (384) above; setmaxnreg
// moves registers from the producer (24) to the consumers (160 of three,
// 240 of two), which hold O (64 x D float32: 128 registers a thread at
// D = 256), S and the two halves of P. Up to D = 128 a consumer also runs
// a tile's softmax while the previous tile's P V is on the tensor cores
// (kPipe, FlashAttention-3's in-warpgroup overlap), which takes a second
// set of S registers. Together the two levers cut the StableLM-3B
// shape's time by a sixth (scripts/flash_tc_check.py, PERF.md); at
// D = 256 O leaves no registers for them. Shared memory at D = 256:
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

constexpr int kBK = 64;           // keys per KV tile
constexpr int kChunk = 64;        // D columns per 128-byte swizzled chunk
constexpr int kRowBytes = 128;    // one chunk row in shared memory
constexpr int kTailCols = 16;     // D columns per 32-byte swizzled V box
constexpr int kTailRowBytes = 32; // one V tail box row in shared memory
constexpr float kNegInf = -2.3819763e38f;

template <int D>
struct Cfg {
  static constexpr int kNch = D / kChunk;             // full chunks
  static constexpr int kTail = D % kChunk;            // 0, 16, 32 or 48
  static constexpr int kNchP = kNch + (kTail > 0);    // chunks of Q and K
  static constexpr int kDP = kNchP * kChunk;          // D padded to 64
  // The tail's O accumulator (m64n{kTail}: kTail / 2 registers).
  static constexpr int kTailRegs = kTail > 0 ? kTail / 2 : 1;
  static constexpr int kStages = kDP == 256 ? 2 : 3;
  // Softmax beside the previous tile's P V (a second set of S registers)
  // and a third consumer warpgroup, where O leaves the registers for
  // them: up to D = 128.
  static constexpr bool kPipe = D <= 128;
  static constexpr int kWG = kPipe ? 3 : 2;           // consumer warpgroups
  static constexpr int kBQ = 64 * kWG;                // query rows a block
  static constexpr int kThreads = 128 * (kWG + 1);    // + the producer
  // Registers a consumer thread holds (setmaxnreg; the producer keeps 24).
  static constexpr int kRegs = kWG == 3 ? 160 : 240;
  static constexpr int kQBytes = kBQ * kDP * 2;
  static constexpr int kTileBytes = kBK * kDP * 2;    // one K or V stage
  static constexpr int kVBytes = kBK * D * 2;         // V's boxes
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

// The same for a 32-byte swizzled operand (8-row groups 256 bytes apart),
// MN-major: `lbo` is the byte offset from one 16-column atom to the next.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns once at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// S copied into fresh registers once its product has completed: the
// softmax masks the copy in place while a later product is pending. (A
// mask written into the accumulator's own registers there makes ptxas
// serialise every wgmma of the kernel, C7513.)
__device__ __forceinline__ void copy_acc(const float (&s)[32],
                                         float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    asm volatile("mov.b32 %0, %1;\n" : "=f"(d[i]) : "f"(s[i]));
}

// The same for A fragments in registers that a pending product reads:
// they stay live, and unchanged, until after the wait.
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

#define ACC8(d, o)                                                         \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),               \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define ACC16(d) ACC8(d, 0), ACC8(d, 8)
#define ACC24(d) ACC8(d, 0), ACC8(d, 8), ACC8(d, 16)
#define ACC32(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define REGS16                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define REGS24                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23}"
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

// The same for the head dim's tail: d += A B with B 16 x N, N = 16, 32 or
// 48 (d holds N / 2 registers), B MN-major in 32-byte swizzled atoms.
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " REGS8
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[24],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 " REGS24
      ", {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : ACC24(d)
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
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tvt,
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

  constexpr int kBQ = C::kBQ;
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
      mbar_init(empty + 8 * s, 4 * C::kWG);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kNchP; ++c)
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
        for (int c = 0; c < C::kNchP; ++c)
          tma_load(kd + c * kBK * kRowBytes, &tk, k_full + 8 * s,
                   c * kChunk, k0, hk, b);
        mbar_expect_tx(v_full + 8 * s, C::kVBytes);
        for (int c = 0; c < C::kNch; ++c)
          tma_load(vd + c * kBK * kRowBytes, &tv, v_full + 8 * s,
                   c * kChunk, k0, hk, b);
        for (int j = 0; j < C::kTail / kTailCols; ++j)
          tma_load(vd + C::kNch * kBK * kRowBytes + j * kBK * kTailRowBytes,
                   &tvt, v_full + 8 * s, C::kNch * kChunk + j * kTailCols,
                   k0, hk, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kRegs)
                 : "memory");
    const int cw = tid / 128 - 1;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int qa = q0 + 64 * cw;                 // the warpgroup's rows
    const int row0 = qa + 16 * warp + lane / 4;  // this thread's: row0, +8
    const uint32_t q_wg = q_sh + 64 * cw * kRowBytes;

    // O: 64 columns a full chunk, and the tail's kTail (acc_t).
    float acc[C::kNch > 0 ? C::kNch : 1][32], acc_t[C::kTailRegs];
#pragma unroll
    for (int c = 0; c < C::kNch; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::kTailRegs; ++i) acc_t[i] = 0.f;
    // Running row max (of unscaled scores) and row sum.
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    // P of a tile, as split_p leaves it.
    uint32_t phi[4][4], plo[4][4];

    // S = Q K^T for the tile in shared memory at `kt` (issued, committed,
    // not waited for). The descriptors of each step are the tile's plus an
    // offset in 16-byte units. The Q descriptor is made opaque in every
    // tile, so the compiler does not keep all sixteen steps' copies alive
    // in registers across the loop. The tail chunk runs only its k-steps
    // of real columns.
    auto issue_s = [&](float (&sc)[32], uint32_t kt) {
      uint64_t dq = sw128_desc(q_wg, 16);
      asm volatile("" : "+l"(dq));
      const uint64_t dk = sw128_desc(kt, 16);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < C::kNchP; ++c)
#pragma unroll
        for (int kk = 0; kk < (c < C::kNch ? 4 : C::kTail / 16); ++kk)
          wgmma_ss(sc, dq + ((c * kBQ * kRowBytes + 32 * kk) >> 4),
                   dk + ((c * kBK * kRowBytes + 32 * kk) >> 4), c + kk > 0);
      wgmma_commit();
    };

    // O += P V for the tile whose V lies at `vt`, P in (phi, plo)
    // (issued, committed, not waited for).
    auto issue_pv = [&](uint32_t vt) {
#pragma unroll
      for (int c = 0; c < C::kNch; ++c) fence_acc(acc[c]);
      if constexpr (C::kTail > 0) fence_acc(acc_t);
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
      if constexpr (C::kTail > 0) {
        // The tail's boxes lie kBK * 32 bytes apart, after the chunks.
        const uint64_t dvt = sw32_desc(vt + C::kNch * kBK * kRowBytes,
                                       kBK * kTailRowBytes);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dvk = dvt + ((16 * kk * kTailRowBytes) >> 4);
          wgmma_rs(acc_t, phi[kk], dvk);
          wgmma_rs(acc_t, plo[kk], dvk);
        }
      }
      wgmma_commit();
    };

    // After a wait for the P V products: O may be read again.
    auto o_done = [&]() {
#pragma unroll
      for (int c = 0; c < C::kNch; ++c) fence_acc(acc[c]);
      if constexpr (C::kTail > 0) fence_acc(acc_t);
    };

    // The online softmax of the tile at key k0 on its scores sc: m and l
    // updated, p in float32 into sc, and O's scale for the tile into
    // alpha.
    auto softmax_p = [&](float (&sc)[32], int k0, bool edge,
                         float (&alpha)[2]) {
      // Base 2; this thread's rows are row0 (r = 0) and row0 + 8 (r = 1),
      // each spread over the four lanes of a quad. Element i lies at key
      // k0 + key0 + kc and row row0 + 8r, with kc = 8 (i >> 2) + (i & 1)
      // and r = (i >> 1) & 1 known at compile time, so each mask is one
      // compare of kc or kc - 8r with a bound of the tile: key < Skv,
      // key - row <= 0, key - row > -window.
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
      // -NEG_INF instead of the max there drives every exponent to -inf,
      // which ex2 takes to 0 with no select per element.
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mu[r] = mx[r] > kNegInf * 0.5f ? mx[r] * scale_log2 : -kNegInf;
        alpha[r] = ex2(fmaf(m[r], scale_log2, -mu[r]));
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e, r = e & 1;
          sc[i] = ex2(fmaf(sc[i], scale_log2, -mu[r]));
          sc[i + 1] = ex2(fmaf(sc[i + 1], scale_log2, -mu[r]));
          l[r] += sc[i] + sc[i + 1];
        }
    };

    // P as the A fragments of four 16-key steps, split into bf16 hi and
    // lo halves; register e of step kk holds row r = e & 1.
    auto split_p = [&](const float (&p)[32]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * kk + 2 * e;
          const bf16 h0 = __float2bfloat16_rn(p[i]);
          const bf16 h1 = __float2bfloat16_rn(p[i + 1]);
          phi[kk][e] = pack_bf16(h0, h1);
          plo[kk][e] = pack_bf16(
              __float2bfloat16_rn(p[i] - __bfloat162float(h0)),
              __float2bfloat16_rn(p[i + 1] - __bfloat162float(h1)));
        }
    };

    // O scaled for a new tile.
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < C::kNch; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[c][4 * j + 2 * r] *= alpha[r];
            acc[c][4 * j + 2 * r + 1] *= alpha[r];
          }
#pragma unroll
        for (int j = 0; j < C::kTail / 8; ++j) {
          acc_t[4 * j + 2 * r] *= alpha[r];
          acc_t[4 * j + 2 * r + 1] *= alpha[r];
        }
      }
    };

    // Wholly outside the warpgroup's band, or crossing its edges.
    auto skips = [&](int k0) {
      return (causal && k0 > qa + 63) ||
             (window > 0 && k0 + kBK - 1 <= qa - window);
    };
    auto crosses = [&](int k0) {
      return k0 + kBK > skv || (causal && k0 + kBK - 1 > qa) ||
             (window > 0 && k0 <= qa + 63 - window);
    };

    if (n_tiles > 0) mbar_wait(q_full, 0);
    if constexpr (C::kPipe) {
      // Tile it's S runs beside tile it - 1's P V, and tile it's softmax
      // while that P V is still on the tensor cores (FlashAttention-3's
      // in-warpgroup overlap). O is rescaled for tile it, and tile it's p
      // split into (phi, plo), only after P V of tile it - 1 has
      // completed: O takes the same sequence of products and scalings as
      // one tile at a time, and no register a pending product reads is
      // written (else ptxas serialises every wgmma, C7513).
      // The warpgroup's tiles [lo, hi) are those it does not skip (the
      // skipped ones lie before them, outside a window, or after them,
      // past the diagonal); the first and the last are peeled, so no
      // product is issued or waited for under a condition.
      auto pass = [&](int it) {     // a skipped tile: its stage released
        const int s = it % C::kStages, parity = (it / C::kStages) & 1;
        mbar_wait(k_full + 8 * s, parity);
        mbar_wait(v_full + 8 * s, parity);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      };
      int lo = 0;
      while (lo < n_tiles && skips(k_first + lo * kBK)) pass(lo++);
      int hi = lo;
      while (hi < n_tiles && !skips(k_first + hi * kBK)) ++hi;
      if (lo < hi) {
        int prev = lo % C::kStages, prev_parity = (lo / C::kStages) & 1;
        {
          const int k0 = k_first + lo * kBK;
          mbar_wait(k_full + 8 * prev, prev_parity);
          float sc[32];
          issue_s(sc, k_sh + prev * C::kTileBytes);
          wgmma_wait<0>();
          fence_acc(sc);
          float alpha[2];
          softmax_p(sc, k0, crosses(k0), alpha);
          rescale(alpha);
          split_p(sc);
        }
        for (int it = lo + 1; it < hi; ++it) {
          const int s = it % C::kStages;
          const int parity = (it / C::kStages) & 1;
          const int k0 = k_first + it * kBK;
          mbar_wait(k_full + 8 * s, parity);
          float sc[32];
          issue_s(sc, k_sh + s * C::kTileBytes);
          mbar_wait(v_full + 8 * prev, prev_parity);
          issue_pv(v_sh + prev * C::kTileBytes);
          wgmma_wait<1>();       // S of tile it; P V of tile it - 1 runs on
          fence_acc(sc);
          float sm[32];
          copy_acc(sc, sm);
          float alpha[2];
          softmax_p(sm, k0, crosses(k0), alpha);
          wgmma_wait<0>();
          o_done();
          fence_regs(phi);
          fence_regs(plo);
          fence_acc(sm);         // p is split only after the wait
          if (lane == 0) mbar_arrive(empty + 8 * prev);
          rescale(alpha);
          split_p(sm);
          prev = s;
          prev_parity = parity;
        }
        mbar_wait(v_full + 8 * prev, prev_parity);
        issue_pv(v_sh + prev * C::kTileBytes);
        wgmma_wait<0>();
        o_done();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      for (int it = hi; it < n_tiles; ++it) pass(it);
    } else {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages;
        const int parity = (it / C::kStages) & 1;
        const int k0 = k_first + it * kBK;
        const bool skip = skips(k0);
        mbar_wait(k_full + 8 * s, parity);
        if (!skip) {
          float sc[32];
          issue_s(sc, k_sh + s * C::kTileBytes);
          wgmma_wait<0>();
          fence_acc(sc);
          float alpha[2];
          softmax_p(sc, k0, crosses(k0), alpha);
          rescale(alpha);
          split_p(sc);
        }
        mbar_wait(v_full + 8 * s, parity);
        if (!skip) {
          issue_pv(v_sh + s * C::kTileBytes);
          wgmma_wait<0>();
          o_done();
        }
        if (lane == 0) mbar_arrive(empty + 8 * s);   // this warp is done
      }
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
#pragma unroll
      for (int j = 0; j < C::kTail / 8; ++j) {
        __nv_bfloat162 pair;
        pair.x = __float2bfloat16_rn(acc_t[4 * j + 2 * r] / l[r]);
        pair.y = __float2bfloat16_rn(acc_t[4 * j + 2 * r + 1] / l[r]);
        *reinterpret_cast<__nv_bfloat162*>(orow + C::kNch * kChunk + 8 * j) =
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
// (batch, row, head), read in boxes of `cols` columns x `rows` rows
// (64 columns in the 128-byte swizzle, or 16 in the 32-byte one); columns
// past D read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int s, int h,
              int d, const int64_t* st, int rows, int cols = kChunk) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == kChunk ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* st, int batch, int sq, int skv, int heads,
           int kv_heads, int causal, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tvt;
  if (!make_map(&tq, q, batch, sq, heads, D, st, Cfg<D>::kBQ) ||
      !make_map(&tk, k, batch, skv, kv_heads, D, st + 3, kBK) ||
      !make_map(&tv, v, batch, skv, kv_heads, D, st + 6, kBK) ||
      !make_map(&tvt, v, batch, skv, kv_heads, D, st + 6, kBK, kTailCols))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides os{st[9], st[10], st[11]};
  auto kernel = flash_attention_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + Cfg<D>::kBQ - 1) / Cfg<D>::kBQ, heads, batch);
  kernel<<<grid, Cfg<D>::kThreads, Cfg<D>::kSmem, stream>>>(
      tq, tk, tv, tvt, static_cast<bf16*>(o), os, sq, skv, heads / kv_heads,
      causal, window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). bf16 q (B, Sq, H, D), k and v
// (B, Skv, Hkv, D), o (B, Sq, H, D); `strides` holds the batch, row and
// head strides, in elements, of q, k, v and o (12 values), the last
// dimension of each contiguous. The caller guarantees 16-byte aligned
// bases and strides, heads % kv_heads == 0, sq > 0 and skv > 0. d is a
// multiple of 16 up to 256, one template each. Launches on `stream`,
// never synchronises, returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for another d or when a tensor map cannot be
// encoded).
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o,
                                           const int64_t* strides, int batch,
                                           int sq, int skv, int heads,
                                           int kv_heads, int d, int causal,
                                           int window, float scale,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_WGMMA(n)                                                \
  if (d == n)                                                               \
    return launch<n>(q, k, v, o, strides, batch, sq, skv, heads, kv_heads,  \
                     causal, window, scale, st);
  REPRO_FLASH_WGMMA(16) REPRO_FLASH_WGMMA(32) REPRO_FLASH_WGMMA(48)
  REPRO_FLASH_WGMMA(64) REPRO_FLASH_WGMMA(80) REPRO_FLASH_WGMMA(96)
  REPRO_FLASH_WGMMA(112) REPRO_FLASH_WGMMA(128) REPRO_FLASH_WGMMA(144)
  REPRO_FLASH_WGMMA(160) REPRO_FLASH_WGMMA(176) REPRO_FLASH_WGMMA(192)
  REPRO_FLASH_WGMMA(208) REPRO_FLASH_WGMMA(224) REPRO_FLASH_WGMMA(240)
  REPRO_FLASH_WGMMA(256)
#undef REPRO_FLASH_WGMMA
  return static_cast<int>(cudaErrorInvalidValue);
}
