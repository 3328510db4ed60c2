// The RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t in
// float32, fed by TMA: the scan of the model's `rec` (RG-LRU) layers in
// prefill, at every shape whose rows TMA can address (W * 4 a multiple of
// 16 bytes: kernels/rglru_scan.py `_route`; the other shapes take the
// one-thread-a-lane kernel of csrc/rglru_scan.cu, the "seq" route).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py:21
// (_rglru_kernel, called through rglru_scan_blocked), whose grid ran
// (B, W/block_w, S/chunk) with the chunk axis sequential and the state
// carried in VMEM scratch between chunks. Here a block owns a tile of
// `L` channels of one batch row and walks all S steps itself, h in a
// register, so nothing is carried between blocks.
//
// What bounds it on Hopper: bytes. Each step reads log_a and b and writes
// h: (3*B*S*W + 2*B*W) * 4 bytes, 503,398,400 B at the serving shape
// (4, 4096, 2560), 0.150 ms at 3.35 TB/s. The dependent chain is short:
// the exp does not depend on h, which leaves one multiply and one add a
// step. So the design keeps time sequential in each lane (no log-space or
// cumulative-sum form: strong decays, log_a = -40, stay exact, as in the
// reference) and only feeds it: the earlier kernel had each thread wait
// on its own loads, about 1 MB in flight on the card where 3.35 TB/s
// needs several. A step still costs a warp 13 instructions (the exp
// alone 8), so where few warps carry all the lanes (one batch row: 40
// warps) that issue rate, not the bytes, sets the pace.
//
// Design:
// - A ring of `stages` shared-memory stages, each 64 steps x L channels
//   of log_a and of b (64 KB at L = 128), filled by one producer thread
//   with TMA: two boxes of 3-D tensor maps over (B, S, W), completed on
//   the stage's `full` mbarrier. Boxes reaching past S or W are filled
//   with zeros by TMA. A step's row of a box is L * 4 contiguous bytes,
//   and wide rows are read faster: at the serving shape on an H100 the
//   kernel took 0.179 ms at L = 128 against 0.201 at L = 32 (PERF.md).
// - One consumer warp per 32 channels folds a stage, one lane a channel,
//   in time order: the product and the sum rounded separately
//   (__fmul_rn, __fadd_rn), as the reference's two operations are, so the
//   kernel computes what the plain version computes. A warp reads its
//   lanes' 64 steps out of the stage, then arrives on the stage's `empty`
//   mbarrier. ptxas orders the two by tile: at 128 and 64 channels (90
//   registers) it interleaves the reads with the exps and the chain, so
//   the warp releases the stage after its fold; at 32 channels (166
//   registers) it reads all 128 values first and folds after the release.
//   A release forced ahead of the fold at 128 and 64 channels (h made to
//   depend on the arrive: scripts/rglru_variants.py `early_release`, 156
//   registers) was no faster at the serving shape and 9% slower at one
//   batch row on an H100 (PERF.md), so the kernel leaves ptxas its order:
//   the producer fills the ring's other stages meanwhile.
// - h goes out by TMA too: the fold writes a stage's h into one of two
//   staging tiles in shared memory, and one consumer thread stores the
//   tile as a box of a third tensor map over h_all, which leaves out the
//   steps past S and the lanes past W. Direct stores from the warps (one
//   line a step and warp, each 10 KB from the last) made the kernel 2.7
//   times slower at one batch row on an H100 (PERF.md).
// - The zeros past S are identity steps (exp(0) * h + 0 = h), so a ragged
//   last stage is folded whole and h_last needs no special case.
// - The wrapper's `_plan` takes the widest tile (128, 64 or 32 channels)
//   that still gives a quarter of the SMs a block, and a ring as deep as
//   fits with every block resident at once: at the serving shape 80
//   blocks of 128 channels, one an SM, 2 stages: up to 128 KB of loads in
//   flight an SM, 10 MB on the card.
// Tensor maps are encoded on the host through cudaGetDriverEntryPoint, so
// the library needs no -lcuda.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSteps = 64;       // time steps in a stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of shared memory at `src` out to a 3-D tensor map (W, S, B),
// in the thread's bulk group; TMA leaves out what lies past S or W.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The consumer warps of a block of L channels meet (named barrier 1).
template <int L>
__device__ __forceinline__ void consumers_sync() {
  if constexpr (L <= 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;\n" ::"n"(L) : "memory");
  }
}

// One box of a 3-D tensor map (W, S, B) into shared memory at `dst`, its
// bytes completing on `bar`.
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

// Shared memory: `stages` x {log_a box, b box} of kSteps x L floats, two
// staging tiles of h (kSteps x L), then the `full` and the `empty`
// mbarrier of each stage.
template <int L>
constexpr int smem_bytes(int stages) {
  return stages * (2 * kSteps * L * 4 + 16) + 2 * kSteps * L * 4;
}

template <int L>
__global__ void __launch_bounds__(32 + L, 1)
rglru_scan_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const __grid_constant__ CUtensorMap map_h,
                      const float* __restrict__ h0,
                      float* __restrict__ h_last, int s, int w, int stages) {
  constexpr int kTile = kSteps * L;          // floats of one box
  extern __shared__ __align__(128) float ring[];
  float* stg = ring + 2 * stages * kTile;    // + (i & 1) * kTile
  uint64_t* bars = reinterpret_cast<uint64_t*>(stg + 2 * kTile);
  const uint32_t full = smem_u32(bars);      // + 8 * slot
  const uint32_t empty = full + 8 * stages;  // + 8 * slot
  const int c0 = blockIdx.x * L;
  const int bi = blockIdx.y;
  const int chunks = (s + kSteps - 1) / kSteps;

  if (threadIdx.x == 0) {
    for (int slot = 0; slot < stages; ++slot) {
      mbar_init(full + 8 * slot, 1);
      mbar_init(empty + 8 * slot, L / 32);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    // ---- producer: one thread keeps the ring full ----
    if (threadIdx.x == 0) {
      for (int i = 0; i < chunks; ++i) {
        const int slot = i % stages;
        if (i >= stages) mbar_wait(empty + 8 * slot, (i / stages - 1) & 1);
        mbar_expect_tx(full + 8 * slot, 2 * kTile * 4);
        const uint32_t dst = smem_u32(ring + 2 * slot * kTile);
        tma_load(dst, &map_a, full + 8 * slot, c0, i * kSteps, bi);
        tma_load(dst + kTile * 4, &map_b, full + 8 * slot, c0, i * kSteps,
                 bi);
      }
    }
    return;
  }

  // ---- consumers: one lane a channel ----
  const int l = threadIdx.x - 32;
  const int c = c0 + l;
  const bool live = c < w;
  const int64_t row = static_cast<int64_t>(bi) * w + c;
  float h = live ? h0[row] : 0.f;
  const float* mine = ring + l;
  for (int i = 0; i < chunks; ++i) {
    const int slot = i % stages;
    mbar_wait(full + 8 * slot, (i / stages) & 1);
    // The lane's 64 steps, then the stage back to the producer (ptxas may
    // fold while it reads: see the header). No global store is pending
    // here: the release of this arrive would wait for every one.
    float a[kSteps], x[kSteps];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      a[t] = mine[2 * slot * kTile + t * L];
      x[t] = mine[(2 * slot + 1) * kTile + t * L];
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * slot);
    // Steps past S hold zeros (exp(0) * h + 0 = h): fold them; the store
    // leaves them out, and the lanes past W.
    float* tile = stg + (i & 1) * kTile;
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      h = __fadd_rn(__fmul_rn(expf(a[t]), h), x[t]);
      tile[t * L + l] = h;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync<L>();
    if (threadIdx.x == 32) {
      tma_store(&map_h, smem_u32(tile), c0, i * kSteps, bi);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // The store two stages back has read the other tile.
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
    consumers_sync<L>();
  }
  if (live) h_last[row] = h;
  if (threadIdx.x == 32)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// The tensor map of a contiguous float32 (B, S, W) tensor in boxes of
// `lanes` channels x kSteps steps of one batch row; out-of-bounds elements
// load as zeros and are left out of stores.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int s, int w,
              int lanes) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(w) * 4,
                                 static_cast<cuuint64_t>(s) * w * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(lanes), kSteps, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int L>
int launch(const void* log_a, const void* b_in, const void* h0, void* h_all,
           void* h_last, int batch, int s, int w, int stages,
           cudaStream_t stream) {
  const int smem = smem_bytes<L>(stages);
  CUtensorMap ma, mb, mh;
  if (!make_map(&ma, log_a, batch, s, w, L) ||
      !make_map(&mb, b_in, batch, s, w, L) ||
      !make_map(&mh, h_all, batch, s, w, L))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rglru_scan_tma_kernel<L>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((w + L - 1) / L, batch);
  kernel<<<grid, 32 + L, smem, stream>>>(
      ma, mb, mh, static_cast<const float*>(h0),
      static_cast<float*>(h_last), s, w, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes). log_a, b_in, h_all: (B, S, W)
// contiguous float32, log_a and b_in on 16-byte aligned bases; h0, h_last:
// (B, W). The launch plan comes from kernels/rglru_scan.py `_plan`: `lanes`
// channels a block (32, 64 or 128) and `stages` in the ring; the kernel
// takes smem_bytes<lanes>(stages) of dynamic shared memory. The caller
// guarantees B, S, W > 0 and W a multiple of 4. Launches on `stream`, never
// synchronises, returns the CUDA error of the launch (0 on success;
// cudaErrorInvalidValue for a tile this kernel does not take, no stage or
// a tensor map that cannot be encoded; the attribute's error for a ring
// too deep for shared memory).
extern "C" int repro_rglru_scan_tma(const void* log_a, const void* b_in,
                                    const void* h0, void* h_all,
                                    void* h_last, int batch, int s, int w,
                                    int lanes, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 32)
    return launch<32>(log_a, b_in, h0, h_all, h_last, batch, s, w, stages,
                      st);
  if (lanes == 64)
    return launch<64>(log_a, b_in, h0, h_all, h_last, batch, s, w, stages,
                      st);
  if (lanes == 128)
    return launch<128>(log_a, b_in, h0, h_all, h_last, batch, s, w, stages,
                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}
