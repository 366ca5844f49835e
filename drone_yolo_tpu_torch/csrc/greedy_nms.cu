// Greedy-NMS keep mask for Hopper (sm_90a), loaded from Python with ctypes.
//
// Replaces the Pallas TPU kernel drone_yolo_tpu/ops/pallas_nms.py:
// pallas_greedy_keep / _nms_kernel. That kernel builds the K x K IoU matrix
// of one image in VMEM and iterates keep = valid & !(keep . adj > 0) to its
// fixed point with matrix-vector products. Here the same fixed point, which is
// sequential greedy NMS, is reached by the sequential sweep itself: one CTA
// per image stages the K boxes in shared memory (K <= 1024: 21 KiB with the
// areas and the mask), then walks the candidates in score order; each row i
// still kept clears keep[j] for every j > i with iou(i, j) > thr, the block's
// threads splitting the j's, with one __syncthreads() per kept row.
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

constexpr int kMaxK = 1024;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) greedy_nms_kernel(const float* __restrict__ boxes,
                                                              const uint8_t* __restrict__ valid,
                                                              uint8_t* __restrict__ keep, int k, float thr) {
  __shared__ float4 sbox[kMaxK];
  __shared__ float sarea[kMaxK];
  __shared__ uint8_t skeep[kMaxK];

  const int b = blockIdx.x;
  const float* bx = boxes + static_cast<size_t>(b) * k * 4;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float4 v = make_float4(bx[4 * j], bx[4 * j + 1], bx[4 * j + 2], bx[4 * j + 3]);
    sbox[j] = v;
    sarea[j] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
    skeep[j] = valid[static_cast<size_t>(b) * k + j] != 0;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    // skeep[i] is final here: only rows < i write it, each followed by a barrier,
    // so every thread reads the same value and takes the same branch.
    if (!skeep[i]) continue;
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
      if (!skeep[j]) continue;
      const float4 bj = sbox[j];
      const float iw = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.0f);
      const float ih = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float denom = __fadd_rn(__fsub_rn(__fadd_rn(ai, sarea[j]), inter), 1e-7f);
      if (__fdiv_rn(inter, denom) > thr) skeep[j] = 0;
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < k; j += blockDim.x) keep[static_cast<size_t>(b) * k + j] = skeep[j];
}

}  // namespace

extern "C" {

// boxes: (B, K, 4) float32 xyxy, score-sorted and class-offset; valid, keep: (B, K) bytes 0/1.
// Launches on `stream`, does not synchronise; returns the launch's cudaError_t.
int greedy_nms_launch(const void* boxes, const void* valid, void* keep, int batch, int k, float thr, void* stream) {
  if (k < 1 || k > kMaxK || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  greedy_nms_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k, thr);
  return static_cast<int>(cudaGetLastError());
}

const char* greedy_nms_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
