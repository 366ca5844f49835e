// Backward (dx, dw) of a dense stride-2 convolution for Hopper (sm_90a), loaded from Python with ctypes.
//
// Replaces the Pallas TPU kernels drone_yolo_tpu/ops/pallas_s2bwd.py: s2_bwd / _k3_kernel (k=3, p=1)
// and _k1_kernel (k=1, p=0). Layouts are the port's: x (B, Ci, H, W) and dy (B, Co, H/2, W/2) in
// float32 or bfloat16, w (Co, Ci, k, k) in x's type; dx like x, dw (Co, Ci, k, k) float32.
//
// The TPU kernel walks a sequential grid over (image, row band) and keeps dw resident in VMEM
// across it; its halo side-channels and column-parity-split output exist for Mosaic's layout
// rules. Here the two gradients are two implicit GEMMs on CUDA cores, each tile staged in shared
// memory and accumulated in float32:
//
//   dw: M = Co, N = Ci*k*k, K = B*Ho*Wo. dw[co, ci, ky, kx] = sum_{b,i,j} dy[b, co, i, j] *
//       x[b, ci, 2i+ky-p, 2j+kx-p]. The long K (204,800 at the flagship's 320x320 layer, batch 8)
//       is split across CTAs into a float32 workspace (s2_dw_kernel), which a second kernel sums
//       in a fixed order (s2_dw_reduce): dw is deterministic, with no atomics.
//   dx: per output-parity class (y%2, x%2), one CTA grid each (blockIdx.z): M = Ci, N = B*Ho*Wo
//       pixels of the class, K = Co * taps. A class gets 1/2/2/4 taps for k=3 and 1/0/0/0 for k=1
//       (the derivation of conv_s2.py:_parity_taps); a class with no taps is written as zeros.
//       dx is summed in float32 and cast once to x's type.
//
// What bounds it on this card: operations. At the flagship's sites the work is 2*B*Ho*Wo*Co*Ci*k*k
// multiply-adds per gradient over a few hundred MB, far above the H100's ~295 operations per byte
// in bf16; this first version runs them as float32 FMAs on CUDA cores (64x64 tiles, 4x4 per thread),
// not on the tensor cores (wgmma, TMA), so it is far from the bound and from cuDNN's backward.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTM = 64;  // tile rows (dw: co; dx: ci)
constexpr int kTN = 64;  // tile columns (dw: ci*k*k; dx: pixels of one parity class)
constexpr int kTK = 16;  // reduction step staged in shared memory
constexpr int kPad = 4;  // row padding of the shared tiles: fewer bank conflicts, rows stay 16-byte aligned
constexpr int kThreads = 256;

struct Shape {
  int b, ci, h, w, co, ho, wo, k, p;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) { *dst = __float2bfloat16_rn(v); }

// acc[i][j] += sum_kk a[kk][row0 + i] * b[kk][col0 + j] over one staged step.
__device__ __forceinline__ void mma_step(float (*sa)[kTM + kPad], float (*sb)[kTN + kPad], int row0,
                                         int col0, float (&acc)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < kTK; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(&sa[kk][row0]);
    const float4 bv = *reinterpret_cast<const float4*>(&sb[kk][col0]);
    const float a[4] = {av.x, av.y, av.z, av.w};
    const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Partial dw of one K range (blockIdx.z) into ws[z][co][n], n = (ci*k + ky)*k + kx.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    s2_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ ws, Shape s, int chunk) {
  __shared__ __align__(16) float sa[kTK][kTM + kPad];  // dy tile: [k][co]
  __shared__ __align__(16) float sb[kTK][kTN + kPad];  // strided x taps: [k][ci, ky, kx]
  const int kk2 = s.k * s.k;
  const int m_total = s.co, n_total = s.ci * kk2;
  const int hw_o = s.ho * s.wo;
  const int k_total = s.b * hw_o;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(k_total, k_begin + chunk);
  const int tid = threadIdx.x;

  // Loading: one reduction index per thread (consecutive threads, consecutive pixels), four rows and
  // four columns of the tile, whose decodes are fixed for the CTA.
  const int l_kk = tid % kTK, l_g = tid / kTK;
  int n_ci[4], n_ky[4], n_kx[4];
  bool n_ok[4], m_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = n0 + l_g * 4 + r;
    n_ok[r] = n < n_total;
    n_ci[r] = n / kk2;
    n_ky[r] = (n % kk2) / s.k;
    n_kx[r] = n % s.k;
    m_ok[r] = m0 + l_g * 4 + r < m_total;
  }
  const int c_m = (tid / 16) * 4, c_n = (tid % 16) * 4;  // this thread's 4x4 of the output tile
  float acc[4][4] = {};

  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    const int kidx = k0 + l_kk;
    float a[4] = {0.f, 0.f, 0.f, 0.f}, bv[4] = {0.f, 0.f, 0.f, 0.f};
    if (kidx < k_end) {
      const int b = kidx / hw_o, rem = kidx - b * hw_o;
      const int i = rem / s.wo, j = rem - i * s.wo;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (m_ok[r]) a[r] = to_f32(dy[(static_cast<size_t>(b) * s.co + m0 + l_g * 4 + r) * hw_o + rem]);
        const int yy = 2 * i + n_ky[r] - s.p, xx = 2 * j + n_kx[r] - s.p;
        if (n_ok[r] && yy >= 0 && yy < s.h && xx >= 0 && xx < s.w)
          bv[r] = to_f32(x[((static_cast<size_t>(b) * s.ci + n_ci[r]) * s.h + yy) * s.w + xx]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      sa[l_kk][l_g * 4 + r] = a[r];
      sb[l_kk][l_g * 4 + r] = bv[r];
    }
    __syncthreads();
    mma_step(sa, sb, c_m, c_n, acc);
    __syncthreads();
  }

  float* out = ws + static_cast<size_t>(blockIdx.z) * m_total * n_total;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + c_m + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + c_n + j;
      if (m < m_total && n < n_total) out[static_cast<size_t>(m) * n_total + n] = acc[i][j];
    }
  }
}

// dw[e] = sum over splits of ws[split][e], in split order.
__global__ void s2_dw_reduce(const float* __restrict__ ws, float* __restrict__ dw, int splits, int mn) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= mn) return;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z) sum += ws[static_cast<size_t>(z) * mn + e];
  dw[e] = sum;
}

// dx of the parity class (py, px) = (blockIdx.z / 2, blockIdx.z % 2): rows ci, columns the class's
// pixels (b, r, c) at dx[b, ci, 2r+py, 2c+px], reduction index t*Co + co over its taps t.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    s2_dx_kernel(const T* __restrict__ w, const T* __restrict__ dy, T* __restrict__ dx, Shape s) {
  __shared__ __align__(16) float sa[kTK][kTM + kPad];  // w transposed: [t, co][ci]
  __shared__ __align__(16) float sb[kTK][kTN + kPad];  // shifted dy: [t, co][pixel]
  const int py = blockIdx.z >> 1, px = blockIdx.z & 1;
  // Taps of the class: y = 2i + ky - p = 2r + py needs (ky - p) % 2 == py, reading dy row
  // i = r + (py + p - ky) / 2; the same along columns.
  int ty_k[2], ty_o[2], tx_k[2], tx_o[2], nty = 0, ntx = 0;
  for (int kq = 0; kq < s.k; ++kq) {
    const int par = ((kq - s.p) % 2 + 2) % 2;
    if (par == py) { ty_k[nty] = kq; ty_o[nty] = (py + s.p - kq) / 2; ++nty; }
    if (par == px) { tx_k[ntx] = kq; tx_o[ntx] = (px + s.p - kq) / 2; ++ntx; }
  }
  const int k_total = nty * ntx * s.co;
  const int hw_o = s.ho * s.wo;
  const int n_total = s.b * hw_o;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;

  // Loading w: one reduction index per thread, four ci. Loading dy: one pixel per thread
  // (consecutive threads, consecutive columns of dy), four reduction indices.
  const int l_kk = tid % kTK, l_g = tid / kTK;
  const int l_n = tid % kTN, l_q = tid / kTN;
  const int pn = n0 + l_n;
  const bool pn_ok = pn < n_total;
  const int pb = pn / hw_o, pr = (pn % hw_o) / s.wo, pc = pn % s.wo;
  const int c_m = (tid / 16) * 4, c_n = (tid % 16) * 4;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < k_total; k0 += kTK) {
    {
      const int kidx = k0 + l_kk;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (kidx < k_total) {
        const int t = kidx / s.co, co = kidx - t * s.co;
        const int ky = ty_k[t / ntx], kx = tx_k[t % ntx];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ci = m0 + l_g * 4 + r;
          if (ci < s.ci) a[r] = to_f32(w[((static_cast<size_t>(co) * s.ci + ci) * s.k + ky) * s.k + kx]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) sa[l_kk][l_g * 4 + r] = a[r];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = l_q * 4 + q, kidx = k0 + kk;
      float v = 0.f;
      if (pn_ok && kidx < k_total) {
        const int t = kidx / s.co, co = kidx - t * s.co;
        const int i = pr + ty_o[t / ntx], j = pc + tx_o[t % ntx];
        if (i >= 0 && i < s.ho && j >= 0 && j < s.wo)
          v = to_f32(dy[((static_cast<size_t>(pb) * s.co + co) * s.ho + i) * s.wo + j]);
      }
      sb[kk][l_n] = v;
    }
    __syncthreads();
    mma_step(sa, sb, c_m, c_n, acc);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + c_n + j;
    if (n >= n_total) continue;
    const int b = n / hw_o, r = (n % hw_o) / s.wo, c = n % s.wo;
    const int y = 2 * r + py, xcol = 2 * c + px;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = m0 + c_m + i;
      if (ci < s.ci) store(&dx[((static_cast<size_t>(b) * s.ci + ci) * s.h + y) * s.w + xcol], acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* dy, void* dx, void* dw, void* ws, const Shape& s, int splits,
           int chunk, cudaStream_t stream) {
  const int n_total = s.ci * s.k * s.k;
  const dim3 dw_grid((n_total + kTN - 1) / kTN, (s.co + kTM - 1) / kTM, splits);
  s2_dw_kernel<T><<<dw_grid, kThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                                    static_cast<float*>(ws), s, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mn = s.co * n_total;
  s2_dw_reduce<<<(mn + kThreads - 1) / kThreads, kThreads, 0, stream>>>(static_cast<const float*>(ws),
                                                                        static_cast<float*>(dw), splits, mn);
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return static_cast<int>(err);
  const dim3 dx_grid((s.b * s.ho * s.wo + kTN - 1) / kTN, (s.ci + kTM - 1) / kTM, 4);
  s2_dx_kernel<T><<<dx_grid, kThreads, 0, stream>>>(static_cast<const T*>(w), static_cast<const T*>(dy),
                                                    static_cast<T*>(dx), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (B, Ci, H, W), w (Co, Ci, k, k), dy (B, Co, H/2, W/2): contiguous, all float32 (dtype 0) or bfloat16
// (dtype 1). dx like x, or null when it is not needed; dw (Co, Ci, k, k) float32; ws a float32
// workspace of splits * Co * Ci * k * k. Reduction index ranges of `chunk` (a multiple of 16) per split.
// Launches on `stream`, does not synchronise; returns the first launch's error, or 0.
int s2_bwd_launch(const void* x, const void* w, const void* dy, void* dx, void* dw, void* ws, int dtype, int batch,
                  int ci, int h, int wd, int co, int k, int p, int splits, int chunk, void* stream) {
  if (batch < 1 || ci < 1 || co < 1 || h < 2 || wd < 2 || h % 2 || wd % 2 || splits < 1 || chunk < 1 ||
      chunk % kTK || !((k == 3 && p == 1) || (k == 1 && p == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{batch, ci, h, wd, co, h / 2, wd / 2, k, p};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, dy, dx, dw, ws, s, splits, chunk, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, dy, dx, dw, ws, s, splits, chunk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* s2_bwd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
