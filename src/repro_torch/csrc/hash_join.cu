// Bucketed sorted-probe kernels for the query engine's equi-join.
//
// Replaces the TPU kernels in src/repro/kernels/hash_join.py:
//   repro_probe        <- _probe_kernel        (lower bound + match flag)
//   repro_probe_range  <- _probe_range_kernel  (duplicate run [lo, hi))
//
// What bounds it on Hopper: each probe is a short chain of dependent
// gathers (starts[bucket], starts[bucket + 1], then ~log2(bucket
// population) build keys), so the kernel is latency-bound, not
// bandwidth-bound. The 64K-entry bucket table (256 KiB) is larger than
// the shared memory one block may use (227 KB), so it is read through the
// read-only path and L2, like the build keys; both stay L2-resident for
// the build sizes the engine probes (a 50 MB L2 holds a 12M-key build).
//
// Design: one thread per probe key, adjacent threads on adjacent keys (the
// key read and the output writes coalesce). The TPU kernel ran a static
// search depth so a vector of keys could step in lockstep; here each
// thread's `while (lo < hi)` loop stops as soon as its bucket slice is
// exhausted, which returns the same bounds. Many resident warps hide the
// gather latency; no shared memory, no synchronisation, no atomics.
//
// The bucket of a key is (uint32)(key - bias) >> shift, clipped to
// NB - 1: the build-key span may exceed int31, so the wrapped int32
// difference is reinterpreted as uint32 (two's complement), and keys below
// bias wrap to huge offsets that land in the last bucket, where no build
// key can equal them. `match` is written as uint8 into a bool tensor
// (one byte, 0 or 1).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kNB = 1u << 16;
constexpr int kThreads = 256;

__device__ __forceinline__ void bucket_slice(const int32_t* __restrict__ starts,
                                             int32_t key, int32_t bias,
                                             unsigned shift, int32_t* lo,
                                             int32_t* hi) {
  unsigned diff = static_cast<unsigned>(key) - static_cast<unsigned>(bias);
  unsigned b = diff >> shift;
  if (b > kNB - 1) b = kNB - 1;
  *lo = __ldg(starts + b);
  *hi = __ldg(starts + b + 1);
}

// First position in [lo, hi) whose build key is not below `key` (upper ==
// false) or above `key` (upper == true); hi when there is none.
template <bool kUpper>
__device__ __forceinline__ int32_t search(const int32_t* __restrict__ build,
                                          int32_t key, int32_t lo,
                                          int32_t hi) {
  while (lo < hi) {
    int32_t mid = lo + ((hi - lo) >> 1);
    int32_t v = __ldg(build + mid);
    bool go = kUpper ? (v <= key) : (v < key);
    if (go) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void probe_kernel(const int32_t* __restrict__ starts,
                             const int32_t* __restrict__ build,
                             const int32_t* __restrict__ keys,
                             int32_t* __restrict__ pos,
                             uint8_t* __restrict__ match, int64_t n,
                             int32_t s, int32_t bias, unsigned shift) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t key = keys[i];
  int32_t lo, hi;
  bucket_slice(starts, key, bias, shift, &lo, &hi);
  lo = search<false>(build, key, lo, hi);
  int32_t p = lo < s ? lo : s - 1;
  pos[i] = p;
  match[i] = (lo < s) && (__ldg(build + p) == key);
}

__global__ void probe_range_kernel(const int32_t* __restrict__ starts,
                                   const int32_t* __restrict__ build,
                                   const int32_t* __restrict__ keys,
                                   int32_t* __restrict__ lo_out,
                                   int32_t* __restrict__ hi_out,
                                   uint8_t* __restrict__ match, int64_t n,
                                   int32_t s, int32_t bias, unsigned shift) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t key = keys[i];
  int32_t b_lo, b_hi;
  bucket_slice(starts, key, bias, shift, &b_lo, &b_hi);
  int32_t lo = search<false>(build, key, b_lo, b_hi);
  // The upper bound cannot lie below the lower bound: start from it.
  int32_t hi = search<true>(build, key, lo, b_hi);
  int32_t p = lo < s ? lo : s - 1;
  lo_out[i] = lo;
  hi_out[i] = hi;
  match[i] = (lo < s) && (__ldg(build + p) == key);
}

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// Makes `device` current for a launch, and puts the caller's device back
// when it goes out of scope. The common case, `device` already current,
// costs one cudaGetDevice.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ != cudaSuccess || prev_ == device) {
      prev_ = -1;                   // nothing to put back
    } else {
      err_ = cudaSetDevice(device);
    }
  }
  ~DeviceScope() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_;
};

}  // namespace

// Plain C entry points (bound with ctypes). Each launches on `stream` of
// CUDA device `device`, never synchronises, and returns the CUDA error of
// selecting the device or of the launch (0 on success). The caller
// guarantees n > 0 and s > 0: a grid of 0 blocks is a launch error.
extern "C" int repro_probe(const void* starts, const void* build,
                           const void* keys, void* pos, void* match,
                           int64_t n, int32_t s, int32_t bias, int32_t shift,
                           int32_t device, void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  probe_kernel<<<grid_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(build),
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(pos),
      static_cast<uint8_t*>(match), n, s, bias, static_cast<unsigned>(shift));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_probe_range(const void* starts, const void* build,
                                 const void* keys, void* lo, void* hi,
                                 void* match, int64_t n, int32_t s,
                                 int32_t bias, int32_t shift, int32_t device,
                                 void* stream) {
  DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  probe_range_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(build),
      static_cast<const int32_t*>(keys), static_cast<int32_t*>(lo),
      static_cast<int32_t*>(hi), static_cast<uint8_t*>(match), n, s, bias,
      static_cast<unsigned>(shift));
  return static_cast<int>(cudaGetLastError());
}
