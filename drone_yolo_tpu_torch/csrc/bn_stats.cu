// Per-channel float32 sum and sum of squares of an NCHW tensor, for Hopper (sm_90a), loaded from
// Python with ctypes: the two reductions of train-mode BatchNorm's batch statistics, in one pass.
//
// Replaces the Pallas TPU kernel tools/bn_stat_probe.py: make_pallas_stats, which reads a bf16 NHWC
// tensor once over a sequential grid of (image, row band) blocks and accumulates (2, C) float32 sums
// in its resident output block. Blocks here run in parallel and in no order, so the accumulator is
// not carried over. One launch, grid C * P:
//
//   Block c * P + p reads part p of channel c: the channel's N * H * W values, taken image after image
//   (its N planes lie C * H * W apart in NCHW), cut into P runs of `chunk` values, so that a run may
//   span several planes. A run is about 16 K values (32 KB of bf16), planned from N * H * W
//   (ops/cuda_bnstats.py): at a 20x20 or 40x40 site one block reads a whole channel of all 8 images.
//   Where every plane starts on a 16-byte boundary, the block reads its run as 16-byte vectors (8 bf16
//   or 4 float32 values) numbered across the planes; otherwise plane by plane, a misaligned head and a
//   ragged tail element by element.
//   Each thread accumulates x and x*x in float32 (up to 8 vectors in flight), the block reduces across
//   its warps and writes its two partials to a (C, P, 2) float32 workspace. Then __threadfence() and
//   a ticket on the channel's counter: the channel's block that draws the last ticket sums its P
//   partials in index order into the (2, C) output and sets the counter back to 0 for the next call
//   (no memset launch). With P = 1 a block writes its channel's two sums to the output itself. One
//   counter a channel: the tickets of different channels do not queue on one address, and no block
//   waits for the whole grid.
//
// No result depends on the order in which blocks finish: the result is bitwise repeatable. Inputs are
// bfloat16 or float32, contiguous. Calls that share a workspace and counter must be ordered (one stream).
//
// What bounds it on this card: bytes. Each element is read once (2 bytes in bf16) for two adds and
// a multiply, far below the H100's ~20 float32 operations per byte of HBM.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // vectors in flight per thread

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
__device__ __forceinline__ void accumulate(const T v, float& s, float& q) {
  const float x = to_f32(v);
  s += x;
  q = fmaf(x, x, q);
}

// kAligned: every plane starts on a 16-byte boundary and holds whole vectors, and the channel's vectors
// number below 2^31; the run [lo, hi) then starts and ends on whole vectors.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads) bn_stats_kernel(const T* __restrict__ x, float* __restrict__ ws,
                                                            float* __restrict__ out, unsigned* __restrict__ counter,
                                                            int c_total, long long hw, long long total, int parts,
                                                            long long chunk) {
  constexpr int kVec = sizeof(uint4) / sizeof(T);
  const int c = blockIdx.x / parts;
  const int p = blockIdx.x % parts;
  const long long lo = p * chunk;
  const long long hi = lo + chunk < total ? lo + chunk : total;
  const long long stride = static_cast<long long>(c_total) * hw;  // from one image's plane of c to the next
  const T* chan = x + static_cast<long long>(c) * hw;

  float s = 0.0f, q = 0.0f;
  if constexpr (kAligned) {
    const unsigned vpp = static_cast<unsigned>(hw / kVec);  // vectors per plane
    const unsigned end = static_cast<unsigned>(hi / kVec);
    unsigned u = static_cast<unsigned>(lo / kVec) + threadIdx.x;
    auto vec_at = [&](unsigned v) {
      const unsigned n = v / vpp;
      return __ldg(reinterpret_cast<const uint4*>(chan + n * stride) + (v - n * vpp));
    };
    for (; u < end; u += kUnroll * kThreads) {  // all loads first; a vector past the run reads as zeros (adds 0)
      uint4 raw[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) raw[r] = u + r * kThreads < end ? vec_at(u + r * kThreads) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) accumulate_vec<T>(raw[r], s, q);
    }
  } else {
    for (long long n = lo / hw; n * hw < hi; ++n) {  // the planes the run touches, each a contiguous segment
      const long long a = lo > n * hw ? lo - n * hw : 0;
      const long long b = hi < (n + 1) * hw ? hi - n * hw : hw;
      const T* start = chan + n * stride + a;
      const long long len = b - a;
      // elements before the first 16-byte boundary, then whole vectors, then the tail
      long long head = static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(start) & 15)) & 15) / sizeof(T);
      if (head > len) head = len;
      const long long n_vec = (len - head) / kVec;
      const uint4* vec = reinterpret_cast<const uint4*>(start + head);
      for (long long i = threadIdx.x; i < n_vec; i += kThreads) accumulate_vec<T>(__ldg(vec + i), s, q);
      for (long long i = threadIdx.x; i < head; i += kThreads) accumulate(start[i], s, q);
      for (long long i = head + n_vec * kVec + threadIdx.x; i < len; i += kThreads) accumulate(start[i], s, q);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    q += __shfl_down_sync(0xffffffffu, q, off);
  }
  __shared__ float ss[kWarps], sq[kWarps];
  __shared__ bool last;
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
    if (parts == 1) {  // the block read the whole channel: no partials, no ticket
      out[c] = ts;
      out[c_total + c] = tq;
      return;
    }
    float2* part = reinterpret_cast<float2*>(ws) + static_cast<size_t>(c) * parts;
    part[p] = make_float2(ts, tq);
    __threadfence();  // the partial reaches device memory before the ticket is drawn
    last = atomicAdd(counter + c, 1u) == static_cast<unsigned>(parts) - 1;
  }
  if (parts == 1) return;
  __syncthreads();
  if (!last) return;

  // the channel's last block: its P partials are visible; read them from L2 (__ldcg), not this SM's L1, a tile at a
  // time into shared memory, and add them in index order
  __shared__ float2 tile[kThreads];
  const float2* part = reinterpret_cast<const float2*>(ws) + static_cast<size_t>(c) * parts;
  float ts = 0.0f, tq = 0.0f;
  for (int i0 = 0; i0 < parts; i0 += kThreads) {
    if (i0 + threadIdx.x < parts) tile[threadIdx.x] = __ldcg(part + i0 + threadIdx.x);
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < min(kThreads, parts - i0); ++i) {
        ts += tile[i].x;
        tq += tile[i].y;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[c] = ts;
    out[c_total + c] = tq;
    counter[c] = 0;
  }
}

template <typename T>
int launch(const void* x, void* ws, void* out, void* counter, int n, int c, long long hw, int parts, long long chunk,
           cudaStream_t s) {
  constexpr int kVec = sizeof(uint4) / sizeof(T);
  const long long total = static_cast<long long>(n) * hw;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && hw % kVec == 0 && chunk % kVec == 0 &&
                       total / kVec < (1LL << 31);
  const auto* xt = static_cast<const T*>(x);
  auto* w = static_cast<float*>(ws);
  auto* o = static_cast<float*>(out);
  auto* cnt = static_cast<unsigned*>(counter);
  const unsigned grid = static_cast<unsigned>(c) * parts;
  if (aligned) {
    bn_stats_kernel<T, true><<<grid, kThreads, 0, s>>>(xt, w, o, cnt, c, hw, total, parts, chunk);
  } else {
    bn_stats_kernel<T, false><<<grid, kThreads, 0, s>>>(xt, w, o, cnt, c, hw, total, parts, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (N, C, H*W) contiguous, dtype 0 = float32, 1 = bfloat16. ws: (C, parts, 2) float32 scratch; out: (2, C)
// float32, row 0 the sums, row 1 the sums of squares; counter: C unsigned ints, 0 between calls. Each channel's
// N * H*W values are cut into `parts` runs of `chunk` values. One launch on `stream`, no synchronisation;
// returns the launch's cudaError_t.
int bn_stats_launch(const void* x, void* ws, void* out, void* counter, int dtype, int n, int c, long long hw,
                    int parts, long long chunk, void* stream) {
  if (n < 1 || c < 1 || hw < 1 || parts < 1 || chunk < 1 || parts * chunk < n * hw ||
      static_cast<long long>(c) * parts > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, ws, out, counter, n, c, hw, parts, chunk, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, ws, out, counter, n, c, hw, parts, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* bn_stats_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
