// Per-channel float32 sum and sum of squares of an NCHW tensor, for Hopper (sm_90a), loaded from
// Python with ctypes: the two reductions of train-mode BatchNorm's batch statistics, in one pass.
//
// Replaces the Pallas TPU kernel tools/bn_stat_probe.py: make_pallas_stats, which reads a bf16 NHWC
// tensor once over a sequential grid of (image, row band) blocks and accumulates (2, C) float32 sums
// in its resident output block. Blocks here run in parallel and in no order, so the accumulator is
// not carried over; its result is:
//
//   pass 1 (bn_stats_partial): grid (C, N * P). Block (c, n * P + p) reads part p of the H*W plane
//       of channel c in image n (a contiguous run of memory in NCHW) with 16-byte vector loads
//       (8 bf16 or 4 float32 values; a misaligned head and a ragged tail element by element),
//       accumulates x and x*x in float32 per thread, reduces across its warps, and writes the
//       two partials to a (N * P, 2, C) float32 workspace.
//   pass 2 (bn_stats_finish): one thread per channel sums its N * P partials in a fixed order.
//
// No atomics: the result is bitwise repeatable. Inputs are bfloat16 or float32, contiguous.
//
// What bounds it on this card: bytes. Each element is read once (2 bytes in bf16) for two adds and
// a multiply, far below the H100's ~20 float32 operations per byte of HBM; P is chosen (in the
// Python wrapper) so that every site launches enough blocks to keep the 132 SMs reading.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ void accumulate_vec(const uint4& raw, float& s, float& q) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < static_cast<int>(sizeof(uint4) / sizeof(T)); ++e) {
    const float x = to_f32(v[e]);
    s += x;
    q = fmaf(x, x, q);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bn_stats_partial(const T* __restrict__ x, float* __restrict__ ws,
                                                             int c_total, long long hw, int parts, long long chunk) {
  constexpr int kVec = sizeof(uint4) / sizeof(T);
  const int c = blockIdx.x;
  const int n = blockIdx.y / parts;
  const int p = blockIdx.y % parts;
  const long long lo = p * chunk;
  const long long hi = lo + chunk < hw ? lo + chunk : hw;
  const T* plane = x + (static_cast<long long>(n) * c_total + c) * hw;

  float s = 0.0f, q = 0.0f;
  if (lo < hi) {
    const T* start = plane + lo;
    const long long len = hi - lo;
    // elements before the first 16-byte boundary, then whole vectors, then the tail
    long long head = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(start) & 15)) & 15) / sizeof(T);
    if (head > len) head = len;
    const long long n_vec = (len - head) / kVec;
    const uint4* vec = reinterpret_cast<const uint4*>(start + head);
    for (long long i = threadIdx.x; i < n_vec; i += kThreads) accumulate_vec<T>(__ldg(vec + i), s, q);
    for (long long i = threadIdx.x; i < head; i += kThreads) {
      const float v = to_f32(start[i]);
      s += v;
      q = fmaf(v, v, q);
    }
    for (long long i = head + n_vec * kVec + threadIdx.x; i < len; i += kThreads) {
      const float v = to_f32(start[i]);
      s += v;
      q = fmaf(v, v, q);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    q += __shfl_down_sync(0xffffffffu, q, off);
  }
  __shared__ float ss[kWarps], sq[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ss[warp] = s;
    sq[warp] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.0f, tq = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      ts += ss[w];
      tq += sq[w];
    }
    float* out = ws + static_cast<size_t>(blockIdx.y) * 2 * c_total;
    out[c] = ts;
    out[c_total + c] = tq;
  }
}

__global__ void __launch_bounds__(kThreads) bn_stats_finish(const float* __restrict__ ws, float* __restrict__ out,
                                                            int c_total, int splits) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= c_total) return;
  float s = 0.0f, q = 0.0f;
  for (int i = 0; i < splits; ++i) {
    s += ws[static_cast<size_t>(i) * 2 * c_total + c];
    q += ws[static_cast<size_t>(i) * 2 * c_total + c_total + c];
  }
  out[c] = s;
  out[c_total + c] = q;
}

}  // namespace

extern "C" {

// x: (N, C, H*W) contiguous, dtype 0 = float32, 1 = bfloat16. ws: (N * parts, 2, C) float32 scratch;
// out: (2, C) float32, row 0 the sums, row 1 the sums of squares. Each plane is cut into `parts`
// runs of `chunk` elements. Two launches on `stream`, no synchronisation; returns the first error.
int bn_stats_launch(const void* x, void* ws, void* out, int dtype, int n, int c, long long hw, int parts,
                    long long chunk, void* stream) {
  if (n < 1 || c < 1 || hw < 1 || parts < 1 || chunk < 1 || parts * chunk < hw || n * parts > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(c, n * parts);
  if (dtype == 0) {
    bn_stats_partial<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(ws), c, hw,
                                                      parts, chunk);
  } else if (dtype == 1) {
    bn_stats_partial<__nv_bfloat16><<<grid, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                              static_cast<float*>(ws), c, hw, parts, chunk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_stats_finish<<<(c + kThreads - 1) / kThreads, kThreads, 0, s>>>(static_cast<const float*>(ws),
                                                                       static_cast<float*>(out), c, n * parts);
  return static_cast<int>(cudaGetLastError());
}

const char* bn_stats_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
