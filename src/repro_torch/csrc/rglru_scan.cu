// The RG-LRU linear recurrence h_t = exp(log_a_t) * h_{t-1} + b_t in
// float32: the scan of the model's `rec` (RG-LRU) layers in prefill, on
// the "seq" route (kernels/rglru_scan.py `_route`): the shapes whose rows
// TMA cannot address (W * 4 not a multiple of 16 bytes). Every served
// shape takes csrc/rglru_scan_tma.cu instead.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py (_rglru_kernel,
// called through rglru_scan_blocked), whose grid ran
// (B, W/block_w, S/chunk) with the chunk axis sequential and the state
// carried in VMEM scratch between chunks, lanes across W. Here one thread
// owns one (batch, channel) lane and runs the whole time loop with h in a
// register, so nothing is carried between blocks.
//
// What bounds it on Hopper: bytes. Each step reads log_a and b and writes
// h (12 bytes for 2 flops and an exp), far below the card's operations-
// per-byte line; the bound is (2*B*S*W + B*S*W + 2*B*W) * 4 bytes at the
// memory rate. The recurrence is sequential in time and stays so: no
// log-space or cumulative-sum form, so strong decays (log_a = -40) stay
// exact, as in the reference.
//
// Design: neighbouring threads take neighbouring channels, so every load
// and store of a step is coalesced. Each thread loads kUnroll steps of
// log_a and b before it folds them, so the loads of a thread do not wait
// on the recurrence and many are in flight at once. The product and the
// sum are rounded separately (__fmul_rn, __fadd_rn), as the reference's
// two operations are. At the main path's shape there are only
// B*W = 10,240 lanes (160 blocks of 64 on 132 SMs): too few threads to
// keep enough loads in flight to reach the memory rate (0.632 ms against
// a 0.150 ms bound on an H100). The TMA kernel feeds the same sequential
// fold from a ring of shared-memory stages instead.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ b_in,
                  const float* __restrict__ h0, float* __restrict__ h_all,
                  float* __restrict__ h_last, int s, int w) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= w) return;
  const int64_t base = static_cast<int64_t>(b) * s * w + c;
  float h = h0[static_cast<int64_t>(b) * w + c];
  int t = 0;
  for (; t + kUnroll <= s; t += kUnroll) {
    float a[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(t + u) * w;
      a[u] = __ldg(log_a + i);
      x[u] = __ldg(b_in + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(expf(a[u]), h), x[u]);
      h_all[base + static_cast<int64_t>(t + u) * w] = h;
    }
  }
  for (; t < s; ++t) {
    const int64_t i = base + static_cast<int64_t>(t) * w;
    h = __fadd_rn(__fmul_rn(expf(__ldg(log_a + i)), h), __ldg(b_in + i));
    h_all[i] = h;
  }
  h_last[static_cast<int64_t>(b) * w + c] = h;
}

}  // namespace

// Plain C entry point (bound with ctypes). log_a, b_in, h_all: (B, S, W)
// contiguous float32; h0, h_last: (B, W). The caller guarantees
// B, S, W > 0. Launches on `stream`, never synchronises, returns the CUDA
// error of the launch (0 on success).
extern "C" int repro_rglru_scan(const void* log_a, const void* b_in,
                                const void* h0, void* h_all, void* h_last,
                                int batch, int s, int w, void* stream) {
  dim3 grid((w + kThreads - 1) / kThreads, batch);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b_in),
      static_cast<const float*>(h0), static_cast<float*>(h_all),
      static_cast<float*>(h_last), s, w);
  return static_cast<int>(cudaGetLastError());
}
