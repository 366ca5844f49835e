// Greedy-NMS keep mask for Hopper (sm_90a), loaded from Python with ctypes.
//
// Replaces the Pallas TPU kernel drone_yolo_tpu/ops/pallas_nms.py:
// pallas_greedy_keep / _nms_kernel. That kernel builds the K x K IoU matrix
// of one image in VMEM and iterates keep = valid & !(keep . adj > 0) to its
// fixed point with matrix-vector products. Here the same fixed point, which is
// sequential greedy NMS, is reached in two launches:
//
// 1. nms_mask, many CTAs: the suppression bitmask. For image b, row i and
//    column block cb (columns 64 cb .. 64 cb + 63), one 64-bit word whose bit t
//    says that row i suppresses column j = 64 cb + t: valid[i], j > i, j < K
//    and iou(i, j) > thr. Words are stored column-block major, words[b][cb][i],
//    so that the sweep reads the rows of one column block contiguously. A CTA
//    covers one column block and 256 rows (8 warps of 32 rows); a warp forms a
//    row's word from two __ballot_sync's over its lanes' columns (each lane
//    holds columns 64 cb + lane and + 32 in registers), and its 32 words leave
//    in one coalesced store. Blocks below the diagonal (all j <= i) and rows
//    that are not valid are written as 0 without a test. Where inter == 0 and
//    thr >= 0 the IoU is 0 (or NaN) and cannot exceed thr, so the division is
//    skipped; for thr < 0 it is always taken.
// 2. nms_sweep, one CTA per image: the column blocks in score order. For block
//    cb, removed[cb] (shared memory, one word per column block) already holds
//    the OR of the words of every row kept in blocks < cb. Warp 0 settles the
//    block's 64 candidates in registers, without barriers: from kept = valid &
//    ~removed[cb], it iterates kept = valid & ~removed[cb] & ~(OR of the kept
//    rows' diagonal words, their words of their own block), the Pallas
//    kernel's fixed point restricted to the block, one warp-wide OR a round,
//    until nothing changes: (the block's longest chain of suppressions) + 1
//    rounds, 1 where nothing in the block overlaps. Meanwhile warps 1..31 load
//    the block's rows' words of the later column blocks; after a barrier each
//    folds the kept rows' words into removed[cb'] of its later blocks (two
//    __reduce_or_sync's a block), and a second barrier ends the round: two
//    barriers per 64 candidates. Warp 0 loads the next block's diagonal words
//    and valid bits before the first.
//
// Workspace: B x ceil(K/64) x K words (16.8 MB at B = 8, K = 4096), allocated
// by the caller; the sweep's shared memory is 8 bytes per column block.
//
// What bounds it: not bytes (20 B in and 1 B out per candidate, plus the
// workspace, which the card's 50 MB L2 holds at validation's K). The mask is
// bound by instruction issue: K^2/2 pair tests per image, most of them ending
// at inter == 0 across class offsets, at a few dozen instructions per row and
// column block. The sweep is bound by latency: 2 * ceil(K/64) barrier-
// separated rounds in one CTA per image.
//
// The keep mask equals the plain version (ops/nms.py: iou_matrix and the
// fixed point) bit for bit, and the words equal suppression_words_reference:
// the IoU follows inter / (area_i + area_j - inter + 1e-7) operation by
// operation with round-to-nearest intrinsics, and the file is built with
// --fmad=false, never with --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaskThreads = 256;
constexpr int kMaskRows = kMaskThreads;  // rows per mask CTA: one 32-row group per warp
constexpr int kSweepThreads = 1024;
constexpr int kFoldWarps = kSweepThreads / 32 - 1;  // the sweep's warps 1..31 fold kept rows into later blocks
constexpr int kFoldBatch = 4;                        // later blocks whose words a fold warp loads before the barrier
constexpr int kStaticSmemLimit = 48 * 1024;  // above it, dynamic shared memory needs the opt-in
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(const float4 v) {
  return __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
}

__device__ __forceinline__ bool suppresses(const float4 bi, float ai, const float4 bj, float aj, float thr,
                                           bool skip_disjoint) {
  const float iw = fmaxf(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  if (skip_disjoint && inter == 0.0f) return false;  // 0 / denom is 0, -0 or NaN: never > thr >= 0
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(ai, aj), inter), 1e-7f);
  return __fdiv_rn(inter, denom) > thr;
}

__device__ __forceinline__ float4 load_box(const float* bx, int j) {
  return make_float4(bx[4 * j], bx[4 * j + 1], bx[4 * j + 2], bx[4 * j + 3]);
}

// One CTA per (image, 256-row chunk, column block): grid.x = (batch * chunks + chunk) * nb + cb.
__global__ void __launch_bounds__(kMaskThreads) nms_mask(const float* __restrict__ boxes,
                                                         const uint8_t* __restrict__ valid,
                                                         unsigned long long* __restrict__ words, int k, int nb,
                                                         int chunks, float thr) {
  const long long cta = blockIdx.x;
  const int cb = static_cast<int>(cta % nb);
  const int chunk = static_cast<int>((cta / nb) % chunks);
  const int b = static_cast<int>(cta / (static_cast<long long>(nb) * chunks));
  const int lane = threadIdx.x % 32;
  const int r0 = chunk * kMaskRows + (threadIdx.x / 32) * 32;  // this warp's first row
  if (r0 >= k) return;
  const float* bx = boxes + static_cast<size_t>(b) * k * 4;
  const int row = r0 + lane;
  unsigned long long word = 0;
  // a row suppresses only later columns: a group whose rows all lie after the block's last column writes zeros
  if (r0 < (cb + 1) * 64) {
    const bool skip_disjoint = thr >= 0.0f;
    const int j0 = cb * 64 + lane, j1 = j0 + 32;
    const float4 c0 = j0 < k ? load_box(bx, j0) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 c1 = j1 < k ? load_box(bx, j1) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float a0 = box_area(c0), a1 = box_area(c1);
    const float4 mine = row < k ? load_box(bx, row) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float mine_area = box_area(mine);
    const unsigned live = __ballot_sync(kFull, row < k && valid[static_cast<size_t>(b) * k + row] != 0);
    const int rows = min(32, min(k, cb * 64 + 63) - r0);  // rows from the block's last column on: no later column
    for (int r = 0; r < rows; ++r) {
      if (!((live >> r) & 1u)) continue;  // uniform: a row that is not valid suppresses nothing
      const int i = r0 + r;
      const float4 bi = make_float4(__shfl_sync(kFull, mine.x, r), __shfl_sync(kFull, mine.y, r),
                                    __shfl_sync(kFull, mine.z, r), __shfl_sync(kFull, mine.w, r));
      const float ai = __shfl_sync(kFull, mine_area, r);
      const unsigned lo = __ballot_sync(kFull, j0 > i && j0 < k && suppresses(bi, ai, c0, a0, thr, skip_disjoint));
      const unsigned hi = __ballot_sync(kFull, j1 > i && j1 < k && suppresses(bi, ai, c1, a1, thr, skip_disjoint));
      if (lane == r) word = (static_cast<unsigned long long>(hi) << 32) | lo;
    }
  }
  if (row < k) words[(static_cast<size_t>(b) * nb + cb) * k + row] = word;
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
  const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(v));
  const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(v >> 32));
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// One CTA per image; dynamic shared memory: removed[nb]. Warp 0 settles, warps 1..31 fold.
__global__ void __launch_bounds__(kSweepThreads) nms_sweep(const unsigned long long* __restrict__ words,
                                                           const uint8_t* __restrict__ valid,
                                                           uint8_t* __restrict__ keep, int k, int nb) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned long long kept_block;
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned long long* wb = words + static_cast<size_t>(b) * nb * k;  // column block cb, row i: wb[cb * k + i]
  const uint8_t* vb = valid + static_cast<size_t>(b) * k;
  uint8_t* kb = keep + static_cast<size_t>(b) * k;
  for (int cb = threadIdx.x; cb < nb; cb += kSweepThreads) removed[cb] = 0;

  // warp 0: the diagonal words and the valid bits of the block it settles next
  unsigned long long d0 = 0, d1 = 0;
  unsigned long long live = 0;
  auto load_block = [&](int cb) {
    const int i0 = cb * 64 + lane, i1 = i0 + 32;
    const size_t base = static_cast<size_t>(cb) * k;
    d0 = i0 < k ? wb[base + i0] : 0;
    d1 = i1 < k ? wb[base + i1] : 0;
    live = __ballot_sync(kFull, i0 < k && vb[i0] != 0) |
           (static_cast<unsigned long long>(__ballot_sync(kFull, i1 < k && vb[i1] != 0)) << 32);
  };
  if (warp == 0) load_block(0);
  __syncthreads();

  for (int cb = 0; cb < nb; ++cb) {
    const int i0 = cb * 64 + lane, i1 = i0 + 32;
    // fold warps: the words of this block's rows in their first later blocks, loaded while warp 0 settles
    unsigned long long pre0[kFoldBatch], pre1[kFoldBatch];
    if (warp > 0) {
#pragma unroll
      for (int j = 0; j < kFoldBatch; ++j) {
        const int cn = cb + warp + j * kFoldWarps;
        const unsigned long long* col = wb + static_cast<size_t>(cn) * k;
        pre0[j] = cn < nb && i0 < k ? col[i0] : 0;
        pre1[j] = cn < nb && i1 < k ? col[i1] : 0;
      }
    } else {
      // The block's fixed point: kept = base & ~(OR of the kept rows' diagonal words), from kept = base. The
      // words are strictly upper triangular, so after n rounds the first n candidates are final: it ends after
      // (the longest chain of suppressions in the block) + 1 rounds, at greedy NMS's mask.
      const unsigned long long base = live & ~removed[cb];
      unsigned long long kept = base, prev;
      do {  // uniform across the warp
        prev = kept;
        kept = base & ~warp_or(((kept >> lane) & 1 ? d0 : 0) | ((kept >> (lane + 32)) & 1 ? d1 : 0));
      } while (kept != prev);
      if (i0 < k) kb[i0] = (kept >> lane) & 1;
      if (i1 < k) kb[i1] = (kept >> (lane + 32)) & 1;
      if (lane == 0) kept_block = kept;
      if (cb + 1 < nb) load_block(cb + 1);
    }
    __syncthreads();
    // fold the block's kept rows into every later column block: one warp per later block
    const unsigned long long kept = kept_block;
    if (warp > 0 && kept) {
      const bool k0 = (kept >> lane) & 1, k1 = (kept >> (lane + 32)) & 1;
#pragma unroll
      for (int j = 0; j < kFoldBatch; ++j) {
        const int cn = cb + warp + j * kFoldWarps;
        if (cn >= nb) break;  // uniform across the warp
        const unsigned long long r = warp_or((k0 ? pre0[j] : 0) | (k1 ? pre1[j] : 0));
        if (lane == 0) removed[cn] |= r;
      }
      for (int cn = cb + warp + kFoldBatch * kFoldWarps; cn < nb; cn += kFoldWarps) {  // K > 64 * 125 or so
        const unsigned long long* col = wb + static_cast<size_t>(cn) * k;
        const unsigned long long r = warp_or((k0 ? col[i0] : 0) | (k1 ? col[i1] : 0));
        if (lane == 0) removed[cn] |= r;
      }
    }
    __syncthreads();
  }
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= kStaticSmemLimit) return cudaSuccess;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

// boxes: (B, K, 4) float32 xyxy, score-sorted and class-offset; valid: (B, K) bytes 0/1;
// words: (B, ceil(K/64), K) 64-bit words, written whole. Launches on `stream`, does not synchronise;
// returns the launch's cudaError_t.
int nms_mask_launch(const void* boxes, const void* valid, void* words, int batch, int k, float thr, void* stream) {
  if (k < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (k + 63) / 64;
  const int chunks = (k + kMaskRows - 1) / kMaskRows;
  const long long grid = static_cast<long long>(batch) * chunks * nb;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  nms_mask<<<static_cast<unsigned>(grid), kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid), static_cast<unsigned long long*>(words), k,
      nb, chunks, thr);
  return static_cast<int>(cudaGetLastError());
}

// words: nms_mask's output; valid, keep: (B, K) bytes 0/1. Launches on `stream`, does not synchronise;
// returns the launch's cudaError_t (cudaErrorInvalidValue where 8 * ceil(K/64) bytes of shared memory exceed
// the device's opt-in, K > 1.8 M, whose workspace no card holds).
int nms_sweep_launch(const void* words, const void* valid, void* keep, int batch, int k, void* stream) {
  if (k < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (k + 63) / 64;
  const size_t smem = sizeof(unsigned long long) * nb;
  const int err = set_smem(reinterpret_cast<const void*>(nms_sweep), smem);
  if (err != cudaSuccess) return err;
  nms_sweep<<<batch, kSweepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(words), static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep),
      k, nb);
  return static_cast<int>(cudaGetLastError());
}

const char* greedy_nms_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
