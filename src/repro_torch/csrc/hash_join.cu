// Bucketed sorted-probe kernels for the query engine's equi-join.
//
// Replaces the TPU kernels in src/repro/kernels/hash_join.py:
//   probe_kernel        <- _probe_kernel        (lower bound + match flag)
//   probe_range_kernel  <- _probe_range_kernel  (duplicate run [lo, hi)
//                                                + match flag)
//
// What bounds it on Hopper: each probe key is a short chain of dependent
// reads (its bucket's two starts, then a binary search over the bucket's
// slice of the sorted build keys, then the match read). The bytes a call
// must move (keys in, positions and flags out) take under a microsecond
// at the main path's sizes, so a launch's time is its own latency plus the
// chain's, not bandwidth. The 64K-bucket starts (256 KiB, over the 227 KB
// a block may hold) and the build keys stay in L2 and are read through the
// read-only path; a build side of a few thousand keys also sits in L1.
// Many resident warps with one chain each hide the latency best: on the
// H100 at the main path's shapes, four keys a thread stepped together ran
// slower, and so did staging the build keys and a coarse directory into
// each block's shared memory by bulk copy, whose staging alone outlasted
// this kernel's whole launch (PERF.md, Findings). So one key a thread, in
// blocks of 32 threads while n is under 256 keys an SM (so a few thousand
// keys spread over most of the 132 SMs), else 256.
//
// The outputs are written coalesced, positions and flags of adjacent keys
// from adjacent threads. The bucket of a key is (uint32)(key - bias) >>
// shift, clipped to NB - 1: the build-key span may exceed int31, so the
// wrapped int32 difference is reinterpreted as uint32, and keys below bias
// wrap to offsets at or past the span, where no build key can equal them.
// `match` is written as uint8 into a bool tensor (one byte, 0 or 1).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kNB = 1u << 16;
constexpr int kThreads = 256;
constexpr int kSmallThreads = 32;

// What a launch needs of one build side, made once per build side by
// kernels/hash_join.py `probe_table` (its ctypes twin is `_TableArgs`).
struct TableArgs {
  const int32_t* starts;     // kNB + 1 bucket starts
  const int32_t* build;      // s sorted build keys
  int32_t s;
  int32_t bias;
  int32_t shift;
  int32_t device;
  int32_t sms;
};

// One launch: the table's fields and the call's keys and outputs (lo is
// pos for the probe, which has no hi).
struct Launch {
  const int32_t* starts;
  const int32_t* build;
  const int32_t* keys;
  int32_t* lo;
  int32_t* hi;
  uint8_t* match;
  int32_t n;
  int32_t s;
  int32_t bias;
  unsigned shift;
};

// First position in [lo, hi) whose build key is not below `key` (kUpper
// false) or above `key` (kUpper true); hi when there is none.
template <bool kUpper>
__device__ __forceinline__ int32_t search(const int32_t* __restrict__ build,
                                          int32_t key, int32_t lo,
                                          int32_t hi) {
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    const int32_t v = __ldg(build + mid);
    if (kUpper ? (v <= key) : (v < key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool kRange>
__device__ __forceinline__ void probe(const Launch& p) {
  const int64_t i = int64_t{blockIdx.x} * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const int32_t key = __ldg(p.keys + i);
  unsigned b = (static_cast<unsigned>(key) - static_cast<unsigned>(p.bias)) >>
               p.shift;
  if (b > kNB - 1) b = kNB - 1;
  const int32_t slice_lo = __ldg(p.starts + b);
  const int32_t slice_hi = __ldg(p.starts + b + 1);
  const int32_t lo = search<false>(p.build, key, slice_lo, slice_hi);
  const int32_t pos = lo < p.s ? lo : p.s - 1;
  // A key whose slice is empty is not in the build: no read.
  p.match[i] = slice_lo < slice_hi && lo < p.s && __ldg(p.build + pos) == key;
  if constexpr (kRange) {
    // The upper bound cannot lie below the lower bound: start from it.
    p.lo[i] = lo;
    p.hi[i] = search<true>(p.build, key, lo, slice_hi);
  } else {
    p.lo[i] = pos;
  }
}

// One __global__ name per kind, so a profile tells them apart.
__global__ void probe_kernel(const Launch p) { probe<false>(p); }

__global__ void probe_range_kernel(const Launch p) { probe<true>(p); }

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

template <bool kRange>
int launch(const void* table, const void* keys, void* lo, void* hi,
           void* match, int32_t n, void* stream) {
  const TableArgs* t = static_cast<const TableArgs*>(table);
  DeviceScope scope(t->device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  Launch p;
  p.starts = t->starts;
  p.build = t->build;
  p.keys = static_cast<const int32_t*>(keys);
  p.lo = static_cast<int32_t*>(lo);
  p.hi = static_cast<int32_t*>(hi);
  p.match = static_cast<uint8_t*>(match);
  p.n = n;
  p.s = t->s;
  p.bias = t->bias;
  p.shift = static_cast<unsigned>(t->shift);
  const int64_t sms = t->sms > 0 ? t->sms : 1;
  const int threads = n < kThreads * sms ? kSmallThreads : kThreads;
  const unsigned blocks =
      static_cast<unsigned>((int64_t{n} + threads - 1) / threads);
  void (*kernel)(const Launch) = kRange ? probe_range_kernel : probe_kernel;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes), one per kind. Each takes the
// build side's TableArgs, n int32 keys and the outputs (pos or lo and hi,
// n int32 each, and n match bytes), launches on `stream` of the table's
// device, never synchronises, and returns the CUDA error of selecting the
// device or of the launch (0 on success). The caller guarantees n > 0 and
// s > 0: a grid of 0 blocks is a launch error.
extern "C" int repro_probe(const void* table, const void* keys, void* pos,
                           void* match, int32_t n, void* stream) {
  return launch<false>(table, keys, pos, nullptr, match, n, stream);
}

extern "C" int repro_probe_range(const void* table, const void* keys,
                                 void* lo, void* hi, void* match, int32_t n,
                                 void* stream) {
  return launch<true>(table, keys, lo, hi, match, n, stream);
}
