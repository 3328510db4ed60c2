// Grouped matmul for the MoE expert FFNs in bfloat16 on Hopper's tensor
// cores: y[e] = x[e] @ w[e] for bf16 x (E, C, D) and w (E, D, F), float32
// accumulation, one rounding to bf16 (nearest even) at the store. Each MoE
// layer's prefill runs it three times (gate, up, down).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py (_gmm_kernel,
// called through gmm), whose grid ran (E, C/bc, F/bf, D/bd) with the
// contraction axis sequential and a float32 accumulator in VMEM scratch
// across it. Here a block walks output tiles of 128 rows x BN columns of
// one expert, the contraction in 64-wide slabs, the accumulator in
// registers. kernels/moe_gmm.py `_route` sends bf16 with D and F multiples
// of 8 here (TMA needs 16-byte global strides); other bf16 shapes take the
// mma.sync kernel of csrc/moe_gmm.cu, float32 its CUDA-core kernel.
//
// What bounds it on Hopper: operations. At the main path's shape (E = 64,
// C = 1,920, D/F = 2,048/1,408) one call is 2*E*C*D*F = 708.7 GFLOP
// against 1.2 GB of operands: 0.717 ms at the bf16 tensor-core rate
// (989 TFLOP/s), 0.364 ms of bytes. So the products run as
// wgmma.mma_async m64nBNk16 (bf16 in, float32 accumulate), both operands
// from shared memory:
// - x (A) is K-major (D contiguous): a box of 64 columns x 128 rows per
//   slab, in the 128-byte swizzle, through a 3-D tensor map over (E, C, D);
//   each consumer warpgroup reads its own 64 rows of it.
// - w (B) is MN-major (F contiguous): BN / 64 boxes of 64 F-columns x 64
//   K-rows per slab through a 3-D map over (E, D, F), read with the
//   transposed-B bit. A B tile spans BN / 64 swizzle atoms; the
//   descriptor's leading byte offset (8 KB, one box) steps from atom to
//   atom.
// bf16 x bf16 products are exact in float32, and every output sums its
// 16-wide steps in order into one float32 accumulator.
//
// Tiles: BN = 256 (m64n256k16, 128 accumulators a consumer thread) where
// the 256-wide tiles leave at most an eighth of their columns empty, as at
// both serving shapes; 128 otherwise. A 256-wide tile reads a third fewer
// bytes from L2 per product, and beat the 128-wide one at the down shape
// in every run (PERF.md).
//
// Pipeline: a ring of 4 shared-memory stages (A 16 KB + B BN / 64 x 8 KB
// each) with full and empty mbarriers. One thread of a producer warpgroup
// issues the TMA loads; two consumer warpgroups of 64 rows each issue the
// wgmma of a slab, then wait until at most one group is in flight
// (wgmma.wait_group 1), so the products of slab k overlap the issue of
// slab k + 1, and release slab k - 1's stage once the group that read it
// has retired: one thread per warpgroup arrives on each barrier that
// must hear of it. setmaxnreg moves registers from the producer (40) to
// the consumers (232).
//
// Clusters: where the row tiles pair up with at most an eighth of them
// empty (as C = 1,920's 15 do), two CTAs of a cluster take neighbouring
// row tiles of one column tile; each loads half of the B boxes and
// multicasts them to both, so B crosses from L2 once per pair. A stage
// is then free only when both CTAs' consumers have released it.
//
// Persistence: one block per SM walks the tiles (expert-major, columns
// fastest), so the producer fills the ring for the next tile while the
// consumers store the last one. The consumers store bf16 pairs straight
// from the accumulators' registers; rows past C and columns past F are
// masked. Ragged C, D and F, and the empty row tile of an odd pair, load
// through TMA's zero fill of out-of-bounds boxes. The mbarrier wait is a
// plain spin, and the kernel has no trap or exit on the consumers' path:
// ptxas then keeps the setmaxnreg budget (a trap made it spill the flash
// kernel's accumulators).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;          // output rows per tile: two warpgroups
constexpr int kBK = 64;           // contraction slab: one 128-byte row
constexpr int kAtom = 64;         // bf16 columns of a 128-byte swizzle atom
constexpr int kStages = 4;
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kABytes = kBM * kBK * 2;            // 16 KB
constexpr int kBBox = kBK * kAtom * 2;            // 8 KB: one B box

// A tile of 128 rows x BN columns (128 or 256): BN / 64 B boxes a slab,
// BN / 2 float32 accumulators a consumer thread.
template <int BN>
struct Tile {
  static constexpr int kBoxes = BN / kAtom;
  static constexpr int kAcc = BN / 2;
  static constexpr int kStageBytes = kABytes + kBoxes * kBBox;  // 32/48 KB
  // + 1 KB: the swizzled tiles need 1024-byte aligned bases.
  static constexpr int kSmem = kStages * kStageBytes + 1024;
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

// Arrives on the mbarrier at shared address `bar` of CTA `cta` of the
// cluster (this CTA's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, int cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      ::"r"(bar), "r"(cta)
      : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every CTA of the cluster (divergent threads allowed).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One box of a 3-D tensor map into shared memory at `dst`, its bytes
// completing on `bar`; c0 is the innermost (contiguous) coordinate.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// The same box into shared memory at `dst` of every CTA of the cluster in
// `mask`, completing on the mbarrier at `bar` of each.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, int c2,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(bar), "h"(mask)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte swizzled operand whose
// 8-row groups lie 1024 bytes apart (the stride byte offset). `lbo`, the
// leading byte offset, is the step from one 64-column atom to the next of
// an MN-major operand; K-major operands within one atom do not read it.
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC64(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),        \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),        \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),        \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),        \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),        \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),        \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define REGS64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"

#define ACC128(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
    "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
    "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
    "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
    "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
    "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
    "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
    "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
    "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
    "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
    "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
    "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
    "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
    "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
    "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
    "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
    "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
    "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
    "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define REGS128 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, \
    %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, \
    %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, \
    %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, \
    %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, \
    %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, \
    %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, \
    %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, \
    %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, \
    %121, %122, %123, %124, %125, %126, %127}"

// d (+)= A B for A (64x16) K-major and B (16xN) MN-major (transposed),
// both from shared memory, N = 128 or 256 (d holds N / 2 values a
// thread). `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_n(float (&d)[64], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : ACC64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n(float (&d)[128], uint64_t da,
                                        uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REGS128
      ", %128, %129, p, 1, 1, 0, 1;\n}\n"
      : ACC128(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// MC CTAs a cluster (1 or 2): a cluster's CTAs take neighbouring row
// tiles of one column tile, and each loads 1 / MC of the B boxes and
// multicasts them to all, so B crosses from L2 once per cluster.
template <int BN, int MC>
__global__ void __launch_bounds__(kThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 bf16* __restrict__ y, int experts, int c, int d, int f) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t full = smem_u32(bars);                 // + 8 * stage
  const uint32_t empty = full + 8 * kStages;
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;

  using T = Tile<BN>;
  // A step of the cluster covers MC row tiles (the last step's may
  // reach past C: zero loads, no stores) of one column tile.
  const int m_steps = (c + MC * kBM - 1) / (MC * kBM);
  const int n_tiles = (f + BN - 1) / BN;
  const int per_expert = m_steps * n_tiles;
  const int steps = experts * per_expert;
  const int slabs = (d + kBK - 1) / kBK;
  const int rank = MC == 1 ? 0 : cluster_rank();
  const int first = blockIdx.x / MC, stride = gridDim.x / MC;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      // One arrival per consumer warpgroup of every CTA that reads it.
      mbar_init(empty + 8 * s, 2 * MC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (MC == 1)
    __syncthreads();
  else
    cluster_sync();   // the peers' barriers are initialised

  if (tid < 128) {
    // ---- producer: one thread keeps the ring full, across tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int s = 0, phase = 0;
      for (int step = first; step < steps; step += stride) {
        const int e = step / per_expert, r = step % per_expert;
        const int m0 = (MC * (r / n_tiles) + rank) * kBM;
        const int n0 = (r % n_tiles) * BN;
        for (int k = 0; k < slabs; ++k) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t a = ring + s * T::kStageBytes, b = a + kABytes;
          const uint32_t bar = full + 8 * s;
          // A from this CTA, B from all of the cluster's.
          mbar_expect_tx(bar, T::kStageBytes);
          tma_load(a, &tx, bar, k * kBK, m0, e);
#pragma unroll
          for (int q = rank; q < T::kBoxes; q += MC) {
            if (MC == 1)
              tma_load(b + q * kBBox, &tw, bar, n0 + q * kAtom, k * kBK, e);
            else
              tma_load_multicast(b + q * kBBox, &tw, bar, n0 + q * kAtom,
                                 k * kBK, e, (1u << MC) - 1);
          }
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of the tile per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = tid / 128 - 1;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    int s = 0, phase = 0;
    // Frees stage `st` in every CTA that writes it: once the warpgroup's
    // products that read it have retired, lane 0 of its warp w arrives on
    // CTA w's barrier.
    auto release = [&](int st) {
      if (lane != 0 || warp >= MC) return;
      if (MC == 1)
        mbar_arrive(empty + 8 * st);
      else
        mbar_arrive_cluster(empty + 8 * st, warp);
    };
    for (int step = first; step < steps; step += stride) {
      const int e = step / per_expert, r = step % per_expert;
      const int m0 = (MC * (r / n_tiles) + rank) * kBM;
      const int n0 = (r % n_tiles) * BN;
      float acc[T::kAcc];
      int prev = 0;
      for (int k = 0; k < slabs; ++k) {
        mbar_wait(full + 8 * s, phase);
        const uint32_t a = ring + s * T::kStageBytes;
        // The warpgroup's 64 rows start 64 x 128 bytes into the A box; a
        // 16-wide step moves 32 bytes along A's swizzled rows and 16
        // rows (2 KB) down B's.
        const uint64_t da = sw128_desc(a + cw * 64 * 128, 16);
        const uint64_t db = sw128_desc(a + kABytes, kBBox);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_n(acc, da + ((32 * kk) >> 4), db + ((2048 * kk) >> 4),
                  k + kk > 0);
        wgmma_commit();
        wgmma_wait<1>();            // the previous slab's products retired
        fence_acc(acc);
        if (k > 0) release(prev);
        prev = s;
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release(prev);

      // Accumulator layout of m64nBN: element 4j + 2h + q of this thread
      // is row 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + q.
      bf16* ye = y + static_cast<int64_t>(e) * c * f;
      const int col0 = n0 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 64 * cw + 16 * warp + lane / 4 + 8 * h;
        if (row >= c) continue;
        bf16* yrow = ye + static_cast<int64_t>(row) * f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = col0 + 8 * j;
          if (col < f)              // f is even: col + 1 < f too
            *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                      acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
  // No CTA leaves while a peer may still arrive on its barriers.
  if (MC > 1) cluster_sync();
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

// The tensor map of a contiguous bf16 (n2, n1, n0) tensor, read in boxes
// of 64 x `rows` (innermost first), 128-byte swizzled; out-of-bounds
// elements of a box read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int n2, int n1, int n0,
              int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n0),
                              static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(n0) * 2,
                                 static_cast<cuuint64_t>(n0) * n1 * 2};
  const cuuint32_t box[3] = {kAtom, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int MC>
int launch(const CUtensorMap& tx, const CUtensorMap& tw, void* y,
           int experts, int c, int d, int f, cudaStream_t stream) {
  auto kernel = gmm_wgmma_kernel<BN, MC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t steps = static_cast<int64_t>(experts) *
                        ((c + MC * kBM - 1) / (MC * kBM)) *
                        ((f + BN - 1) / BN);
  int dev = 0, blocks = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&blocks, cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t clusters = steps < blocks / MC ? steps : blocks / MC;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = MC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((clusters > 0 ? clusters : 1) *
                                           MC));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Tile<BN>::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = MC > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, static_cast<bf16*>(y),
                           experts, c, d, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The tile width for F output columns: 256 (one m64n256 wgmma per
// 16-wide step, a third fewer bytes from L2 per product than 128) where
// the 256-wide tiles leave at most an eighth of their columns empty.
bool wide_tiles(int f) {
  const int covered = (f + 255) / 256 * 256;
  return 8 * (covered - f) <= covered;
}

// Pairs of row tiles share their B boxes (clusters of two CTAs) where the
// pairs leave at most an eighth of their row tiles empty.
bool paired_rows(int c) {
  const int tiles = (c + kBM - 1) / kBM;
  return tiles >= 2 && 8 * (tiles % 2) <= tiles + 1;
}

}  // namespace

// Plain C entry point (bound with ctypes). bf16 x (E, C, D), w (E, D, F),
// y (E, C, F), all contiguous with 16-byte aligned bases; the caller
// guarantees E, C, D, F > 0 and D, F multiples of 8. One block per SM
// (one cluster per pair of SMs where row tiles pair up), each walking the
// tiles. Launches on `stream`, never synchronises, returns the CUDA error
// of the launch (0 on success; cudaErrorInvalidValue when a tensor map
// cannot be encoded).
extern "C" int repro_gmm_wgmma(const void* x, const void* w, void* y,
                               int experts, int c, int d, int f,
                               void* stream) {
  CUtensorMap tx, tw;
  if (!make_map(&tx, x, experts, c, d, kBM) ||
      !make_map(&tw, w, experts, d, f, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = wide_tiles(f), pair = paired_rows(c);
  if (wide && pair) return launch<256, 2>(tx, tw, y, experts, c, d, f, st);
  if (wide) return launch<256, 1>(tx, tw, y, experts, c, d, f, st);
  if (pair) return launch<128, 2>(tx, tw, y, experts, c, d, f, st);
  return launch<128, 1>(tx, tw, y, experts, c, d, f, st);
}
