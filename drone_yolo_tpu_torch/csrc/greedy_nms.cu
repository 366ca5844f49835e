// Greedy-NMS keep mask for Hopper (sm_90a), loaded from Python with ctypes.
//
// Replaces the Pallas TPU kernel drone_yolo_tpu/ops/pallas_nms.py:
// pallas_greedy_keep / _nms_kernel. That kernel builds the K x K IoU matrix
// of one image in VMEM and iterates keep = valid & !(keep . adj > 0) to its
// fixed point with matrix-vector products. Here the same fixed point, which is
// sequential greedy NMS, is reached by the sequential sweep itself: one CTA
// per image walks the candidates in score order; each row i still kept clears
// keep[j] for every j > i with iou(i, j) > thr, the block's threads splitting
// the j's, with one __syncthreads() per kept row.
//
// Where the data lives, by K:
// - staged (21 * K bytes fit the block's opt-in shared memory: K <= 11,068 on
//   an H100's 232,448 bytes): the boxes (16 B), their areas (4 B) and the
//   mask (1 B) go to dynamic shared memory; K = 4096, validation's default
//   (pre_nms_topk), takes 84 KiB.
// - global (larger K): the boxes are read from global memory (L2 holds them),
//   each area is recomputed from its box with the same operations, and the
//   mask lives in the output itself; __syncthreads() orders the block's
//   global writes as it does its shared ones. No K is refused.
//
// What bounds it: not bytes (20 B in and 1 B out per candidate) and not
// arithmetic (at most K^2/2 IoUs per image), but the chain of barriers, one
// per kept row, in a single CTA per image: the kernel is latency-bound.
//
// The keep mask equals the plain version (ops/nms.py: iou_matrix and the
// fixed point) bit for bit: the IoU follows inter / (area_i + area_j - inter
// + 1e-7) operation by operation with round-to-nearest intrinsics, and the
// file is built with --fmad=false, never with --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStagedBytesPerBox = 16 + 4 + 1;  // float4 box, float area, uint8 mask
constexpr int kStaticSmemLimit = 48 * 1024;     // above it, dynamic shared memory needs the opt-in

__device__ __forceinline__ float box_area(const float4 v) {
  return __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
}

__device__ __forceinline__ bool suppresses(const float4 bi, float ai, const float4 bj, float aj, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(ai, aj), inter), 1e-7f);
  return __fdiv_rn(inter, denom) > thr;
}

__device__ __forceinline__ float4 load_box(const float* bx, int j) {
  return make_float4(bx[4 * j], bx[4 * j + 1], bx[4 * j + 2], bx[4 * j + 3]);
}

// kStaged: boxes, areas and mask in dynamic shared memory; otherwise boxes from global memory and the
// mask in `keep`.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads) greedy_nms_kernel(const float* __restrict__ boxes,
                                                              const uint8_t* __restrict__ valid,
                                                              uint8_t* __restrict__ keep, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(smem + 16 * static_cast<size_t>(k));
  const size_t row = static_cast<size_t>(blockIdx.x) * k;
  const float* bx = boxes + row * 4;
  uint8_t* mask = kStaged ? smem + 20 * static_cast<size_t>(k) : keep + row;

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    if constexpr (kStaged) {
      const float4 v = load_box(bx, j);
      sbox[j] = v;
      sarea[j] = box_area(v);
    }
    mask[j] = valid[row + j] != 0;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    // mask[i] is final here: only rows < i write it, each followed by a barrier,
    // so every thread reads the same value and takes the same branch.
    if (!mask[i]) continue;
    const float4 bi = kStaged ? sbox[i] : load_box(bx, i);
    const float ai = kStaged ? sarea[i] : box_area(bi);
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
      if (!mask[j]) continue;
      const float4 bj = kStaged ? sbox[j] : load_box(bx, j);
      if (suppresses(bi, ai, bj, kStaged ? sarea[j] : box_area(bj), thr)) mask[j] = 0;
    }
    __syncthreads();
  }

  if constexpr (kStaged) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) keep[row + j] = mask[j];
  }
}

}  // namespace

extern "C" {

// The largest K whose boxes, areas and mask fit the current device's opt-in shared memory per block;
// above it the kernel reads the boxes from global memory. Returns -1 if the device cannot be queried.
int greedy_nms_max_staged_k() {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) return -1;
  return optin / kStagedBytesPerBox;
}

// boxes: (B, K, 4) float32 xyxy, score-sorted and class-offset; valid, keep: (B, K) bytes 0/1.
// Launches on `stream`, does not synchronise; returns the launch's cudaError_t.
int greedy_nms_launch(const void* boxes, const void* valid, void* keep, int batch, int k, float thr, void* stream) {
  if (k < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int max_staged = greedy_nms_max_staged_k();
  if (max_staged < 0) return static_cast<int>(cudaGetLastError());
  const auto* b = static_cast<const float*>(boxes);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* out = static_cast<uint8_t*>(keep);
  const auto s = static_cast<cudaStream_t>(stream);
  if (k <= max_staged) {
    const int smem = kStagedBytesPerBox * k;
    if (smem > kStaticSmemLimit) {
      const cudaError_t err =
          cudaFuncSetAttribute(greedy_nms_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    greedy_nms_kernel<true><<<batch, kThreads, smem, s>>>(b, v, out, k, thr);
  } else {
    greedy_nms_kernel<false><<<batch, kThreads, 0, s>>>(b, v, out, k, thr);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* greedy_nms_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
