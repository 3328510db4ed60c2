// Grouped matmul for the MoE expert FFNs: y[e] = x[e] @ w[e] for
// x (E, C, D), w (E, D, F), float32 accumulation, output in x's dtype.
// Each MoE layer's prefill runs it three times (gate, up, down).
//
// Replaces the TPU kernel src/repro/kernels/moe_gmm.py (_gmm_kernel,
// called through gmm), whose grid ran (E, C/bc, F/bf, D/bd) with the
// contraction axis sequential and a float32 accumulator in VMEM scratch
// across it, on 128-aligned MXU tiles (it asserted divisibility). Here
// one block owns one (expert, 128x128 output tile) and loops over D in
// 32-wide slabs, the accumulator in registers; any C, D and F, the ragged
// edge tiles masked.
//
// What bounds it on Hopper: operations. At the main path's shape
// (E=64, C=1,920, D/F = 2,048/1,408) one call is 2*E*C*D*F = 708.7 GFLOP
// against 1.2 GB of operands: 0.717 ms at the bf16 tensor-core rate
// (989 TFLOP/s), 0.364 ms of bytes. So the products must run on the
// tensor cores. This first kernel uses warp-level mma.sync (m16n8k16,
// bf16 in, float32 accumulate) fed by ldmatrix from shared memory, with
// the next slab's global loads in flight in registers during the
// products; wgmma, TMA and a deeper pipeline are later work.
//
// Design (bfloat16):
// - 256 threads = 8 warps as 2 (rows) x 4 (columns); a warp owns a 64x32
//   piece of the tile: 4x4 mma tiles, 64 float32 accumulators a thread.
// - The x slab (128x32) and w slab (32x128) sit in shared memory row-
//   major, rows padded by 8 bf16 so each ldmatrix phase's eight 16-byte
//   rows hit distinct banks. A fragments come from ldmatrix.x4, B
//   fragments from ldmatrix.x4.trans (w is K-major).
// - Global loads are 16-byte vectors where a row's eight elements lie
//   inside the matrix and the row length is a multiple of 8, scalar with
//   zero fill at the edges otherwise.
// - The float32 sums are rounded once to bf16 (nearest even) on store.
// Design (float32, for the f32 checks): the same tiling idea on CUDA cores,
// 64x64 tiles over 16-wide slabs, each thread a 4x4 block of outputs in
// float32 FMAs: the products stay in full float32 (no TF32).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kALd = kBK + 8;     // padded smem row of the x slab (bf16)
constexpr int kBLd = kBN + 8;     // padded smem row of the w slab (bf16)

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

// Eight bf16 of row `row` (of `rows`) from column `col` (of `cols`), zero
// outside the matrix.
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ base,
                                       int row, int rows, int col, int cols,
                                       bool vec) {
  union {
    uint4 u;
    bf16 h[8];
  } out;
  out.u = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return out.u;
  const bf16* p = base + static_cast<int64_t>(row) * cols + col;
  if (vec && col + 8 <= cols) return *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (col + q < cols) out.h[q] = p[q];
  return out.u;
}

__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ y, int c, int d, int f) {
  __shared__ __align__(16) bf16 a_s[kBM * kALd];
  __shared__ __align__(16) bf16 b_s[kBK * kBLd];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bf16* xe = x + static_cast<int64_t>(e) * c * d;
  const bf16* we = w + static_cast<int64_t>(e) * d * f;
  bf16* ye = y + static_cast<int64_t>(e) * c * f;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const bool vec_x = d % 8 == 0, vec_w = f % 8 == 0;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  // Slab loads: x 128 rows x 4 vectors, w 32 rows x 16 vectors; two of
  // each a thread.
  uint4 ra[2], rb[2];
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * kThreads;
      ra[j] = load8(xe, m0 + i / 4, c, k0 + (i % 4) * 8, d, vec_x);
      rb[j] = load8(we, k0 + i / 16, d, n0 + (i % 16) * 8, f, vec_w);
    }
  };
  const int slabs = (d + kBK - 1) / kBK;
  load_slab(0);
  for (int s = 0; s < slabs; ++s) {
    __syncthreads();   // the previous slab's fragments are read
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * kThreads;
      *reinterpret_cast<uint4*>(a_s + (i / 4) * kALd + (i % 4) * 8) = ra[j];
      *reinterpret_cast<uint4*>(b_s + (i / 16) * kBLd + (i % 16) * 8) = rb[j];
    }
    __syncthreads();
    if (s + 1 < slabs) load_slab((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], a_s + (wm + mt * 16 + lane % 16) * kALd + kk
                                + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, b_s + (kk + lane % 16) * kBLd + wn + np * 16
                                 + (lane / 16) * 8);
        bfr[2 * np][0] = t[0];
        bfr[2 * np][1] = t[1];
        bfr[2 * np + 1][0] = t[2];
        bfr[2 * np + 1][1] = t[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }

  // Accumulator layout of m16n8: c0, c1 at (lane/4, 2*(lane%4) + {0,1}),
  // c2, c3 eight rows below.
  const bool pairs = f % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + lane / 4 + half * 8;
        const int col = n0 + wn + nt * 8 + (lane % 4) * 2;
        if (row >= c) continue;
        bf16* p = ye + static_cast<int64_t>(row) * f + col;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (pairs && col + 1 < f) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < f) p[0] = __float2bfloat16(v0);
          if (col + 1 < f) p[1] = __float2bfloat16(v1);
        }
      }
}

constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ y, int c, int d, int f) {
  __shared__ __align__(16) float a_s[kFK][kFM + 4];   // x slab, transposed
  __shared__ __align__(16) float b_s[kFK][kFN + 4];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const float* xe = x + static_cast<int64_t>(e) * c * d;
  const float* we = w + static_cast<int64_t>(e) * d * f;
  float* ye = y + static_cast<int64_t>(e) * c * f;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += kFK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * kThreads;
      const int am = i / kFK, ak = i % kFK;
      a_s[ak][am] = (m0 + am < c && k0 + ak < d)
                        ? xe[static_cast<int64_t>(m0 + am) * d + k0 + ak]
                        : 0.f;
      const int bk = i / kFN, bn = i % kFN;
      b_s[bk][bn] = (k0 + bk < d && n0 + bn < f)
                        ? we[static_cast<int64_t>(k0 + bk) * f + n0 + bn]
                        : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < f) ye[static_cast<int64_t>(row) * f + col] = acc[i][j];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). x: (E, C, D), w: (E, D, F),
// y: (E, C, F), all contiguous and 16-byte aligned, one dtype: 0 float32,
// 1 bfloat16. The caller guarantees E, C, F > 0 (D = 0 gives zeros).
// Launches on `stream`, never synchronises, returns the CUDA error of the
// launch (0 on success).
extern "C" int repro_gmm(const void* x, const void* w, void* y, int experts,
                         int c, int d, int f, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((f + kBN - 1) / kBN, (c + kBM - 1) / kBM, experts);
    gmm_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(y), c, d, f);
  } else {
    const dim3 grid((f + kFN - 1) / kFN, (c + kFM - 1) / kFM, experts);
    gmm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), c, d, f);
  }
  return static_cast<int>(cudaGetLastError());
}
