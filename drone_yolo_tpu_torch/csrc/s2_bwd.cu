// Backward (dx, dw) of a dense stride-2 convolution for Hopper (sm_90a), loaded from Python with ctypes.
//
// Replaces the Pallas TPU kernels drone_yolo_tpu/ops/pallas_s2bwd.py: s2_bwd / _k3_kernel (k=3, p=1)
// and _k1_kernel (k=1, p=0). Layouts are the port's: x (B, Ci, H, W) and dy (B, Co, H/2, W/2), NCHW;
// dx like x; dw (Co, Ci, k, k) float32, summed over split-K partials in a fixed order (no atomics, so
// dw is bitwise repeatable).
//
// bfloat16 (the train step under autocast) runs on the tensor cores: mma.sync.m16n8k16 (bf16 operands,
// float32 accumulators) fed from shared memory by ldmatrix, with the tiles copied by cp.async into a ring
// of three stages, so that the copies of the next two tiles overlap the math of this one.
//
//   dw (s2_dw_mma): M = Co, N = Ci*k*k, K = B*Ho*Wo pixels in tiles of 64 (rows x cols of one image's dy).
//       dy's rows are copied as they lie (the K-major A operand). x is copied as a band, once per tile: the
//       2*rows+1 input rows (k=3; the rows even rows for k=1) of 2*cols (+8 halo) columns of each channel,
//       zeros for the padding. The k*k tap operands are formed on chip, as the Pallas kernel forms its
//       im2col band in VMEM: a thread reads 8 bytes of a band row and one halo element and permutes them
//       into the B fragments of the three column taps (x at stride 2). Split along K over CTAs into a
//       float32 workspace, which s2_dw_reduce sums in split order.
//   dx (s2_dx_mma): a CTA owns Ci x (rows x cols dy pixels) and computes all four output-parity classes:
//       class (py, px) is a GEMM with M = Ci, N = the tile's pixels, K = Co * its taps (1, 2, 2, 4 for
//       k=3; 1 for k=1). A is w transposed per tap, (k*k, Ci, Co), packed by the wrapper. B is dy shifted by
//       the tap's offset (0 or +1 row and column, zero past the end): the dy tile, with one halo row and
//       column, is transposed in shared memory (ldmatrix.trans, stmatrix), so that a shifted pixel is just
//       another row of B. The classes are interleaved in shared memory into whole dx rows 2r and 2r+1 and
//       stored with 16-byte writes; for k=1 the three classes with no tap are the zeros of those rows, with
//       no K loop.
//
// float32 (amp off) keeps the first version: two implicit GEMMs of float32 FMAs on CUDA cores (64x64
// tiles, 4x4 per thread), which meet the plain version's float32 tolerance; TF32 tensor cores would not.
// The dispatch is by dtype, in s2_bwd_launch.
//
// What bounds it on this card: at the flagship's k=3 sites, operations (2*B*Ho*Wo*Co*Ci*9 per gradient);
// at the k=1 sites, bytes (dx, the largest tensor, is written once, three quarters of it zeros). Measured,
// it beats cuDNN's total at the flagship's sites but reaches about a tenth of the bf16 peak at its best site
// (PERF.md). This version uses the warp-level mma.sync, not Hopper's warpgroup wgmma with TMA: the
// stride-2 tap views of x and the one-pixel shifts of dy are formed with per-thread fragment loads, which
// wgmma's shared-memory descriptors cannot express without one more staging copy.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Shape {
  int b, ci, h, w, co, ho, wo, k, p;
};

// ---------------------------------------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kTM = 64;  // tile rows (dw: co; dx: ci)
constexpr int kTN = 64;  // tile columns (dw: ci*k*k; dx: pixels of one parity class)
constexpr int kTK = 16;  // reduction step staged in shared memory
constexpr int kPad = 4;  // row padding of the shared tiles: fewer bank conflicts, rows stay 16-byte aligned
constexpr int kThreads = 256;

// acc[i][j] += sum_kk a[kk][row0 + i] * b[kk][col0 + j] over one staged step.
__device__ __forceinline__ void fma_step(float (*sa)[kTM + kPad], float (*sb)[kTN + kPad], int row0, int col0,
                                         float (&acc)[4][4]) {
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
__global__ void __launch_bounds__(kThreads)
    s2_dw_kernel(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ ws, Shape s, int chunk) {
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
        if (m_ok[r]) a[r] = dy[(static_cast<size_t>(b) * s.co + m0 + l_g * 4 + r) * hw_o + rem];
        const int yy = 2 * i + n_ky[r] - s.p, xx = 2 * j + n_kx[r] - s.p;
        if (n_ok[r] && yy >= 0 && yy < s.h && xx >= 0 && xx < s.w)
          bv[r] = x[((static_cast<size_t>(b) * s.ci + n_ci[r]) * s.h + yy) * s.w + xx];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      sa[l_kk][l_g * 4 + r] = a[r];
      sb[l_kk][l_g * 4 + r] = bv[r];
    }
    __syncthreads();
    fma_step(sa, sb, c_m, c_n, acc);
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

// dx of the parity class (py, px) = (blockIdx.z / 2, blockIdx.z % 2): rows ci, columns the class's
// pixels (b, r, c) at dx[b, ci, 2r+py, 2c+px], reduction index t*Co + co over its taps t.
__global__ void __launch_bounds__(kThreads)
    s2_dx_kernel(const float* __restrict__ w, const float* __restrict__ dy, float* __restrict__ dx, Shape s) {
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
          if (ci < s.ci) a[r] = w[((static_cast<size_t>(co) * s.ci + ci) * s.k + ky) * s.k + kx];
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
        if (i >= 0 && i < s.ho && j >= 0 && j < s.wo) v = dy[((static_cast<size_t>(pb) * s.co + co) * s.ho + i) * s.wo + j];
      }
      sb[kk][l_n] = v;
    }
    __syncthreads();
    fma_step(sa, sb, c_m, c_n, acc);
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
      if (ci < s.ci) dx[((static_cast<size_t>(b) * s.ci + ci) * s.h + y) * s.w + xcol] = acc[i][j];
    }
  }
}

// dw[e] = sum over splits of ws[split][e], in split order (both dtypes).
__global__ void s2_dw_reduce(const float* __restrict__ ws, float* __restrict__ dw, int splits, int mn) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= mn) return;
  float sum = 0.f;
  for (int z = 0; z < splits; ++z) sum += ws[static_cast<size_t>(z) * mn + e];
  dw[e] = sum;
}

// ---------------------------------------------------------------------------------------------------------
// bfloat16: tensor cores

using bf16 = __nv_bfloat16;

constexpr int kStages = 3;      // cp.async ring: the copies of two tiles in flight while one is computed
constexpr int kDwPix = 64;      // dw: pixels per K tile
constexpr int kDwRow = 64 + 8;  // dw: a channel's dy row in shared memory, 144 bytes (odd in 16-byte units:
                                // ldmatrix without bank conflicts)
constexpr int kDxCo = 32;       // dx: Co per stage, two k16 steps
constexpr int kDxRow = 32 + 8;  // dx: 32 channels of a w or transposed-dy row, 80 bytes (conflict-free)

// n / d for 0 <= n < 2^31 by a multiply and a shift (round-up reciprocal, as CUTLASS's FastDivmod): the copy
// loops decode every piece's row and column with it.
struct FastDiv {
  int d;
  uint32_t mul, shr;
};

FastDiv fast_div(int d) {
  FastDiv f{d, 0, 0};
  if (d != 1) {
    int l = 0;
    while ((1 << l) < d) ++l;
    f.mul = static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d);
    f.shr = l - 1;
  }
  return f;
}

__device__ __forceinline__ int operator/(int n, const FastDiv& f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), f.mul) >> f.shr);
}

// The tile of dy pixels a CTA (dx) or a K step (dw) covers: rows x cols of one image, cols a power of 2 or the
// image's width; a pixel p of the tile is (p / cols, p % cols), those from rows * cols on are idle.
struct Tile {
  int rows, cols, tiles_w, tiles_img;
  FastDiv col;
};

// dw: the x band of a tile (k=3: 2*rows+1 input rows and an 8-element halo on the left; k=1: the rows even
// rows), and its channel stride, = 16 mod 64 elements so that the 8-byte loads of 8 channels fall on
// distinct bank pairs.
__host__ __device__ inline int dw_x_rows(int k, int rows) { return k == 3 ? 2 * rows + 1 : rows; }
__host__ __device__ inline int dw_x_seg(int k, int cols) { return 2 * cols + (k == 3 ? 8 : 0); }
__host__ __device__ inline int dw_x_stride(int k, int rows, int cols) {
  const int n = dw_x_rows(k, rows) * dw_x_seg(k, cols);
  return n + ((16 - n % 64) + 64) % 64;
}
// dx: the dy tile (k=3 with one halo row and a halo column, in rows padded to 8 elements), its channel
// stride odd in 16-byte units (ldmatrix.trans without bank conflicts), and the pixels of a CTA (32 per warp
// along pixels).
__host__ __device__ inline int dx_seg(int k, int cols) { return (cols + (k == 3 ? 1 : 0) + 7) / 8 * 8; }
__host__ __device__ inline int dx_dy_stride(int k, int rows, int cols) {
  const int n = (rows + (k == 3 ? 1 : 0)) * dx_seg(k, cols);
  return (n / 8) % 2 ? n : n + 8;
}
__host__ __device__ constexpr int dx_pixels(int wm) { return 32 * (8 / wm); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// vec bf16 (1, 2, 4 or 8) from global to shared memory, or zeros where !ok: asynchronously (cp.async of 4, 8
// or 16 bytes) for vec >= 2, else a plain load and store.
__device__ __forceinline__ void copy_piece(bf16* dst, const bf16* src, int vec, bool ok) {
  if (vec == 1) {
    *dst = ok ? *src : __ushort_as_bfloat16(0);
    return;
  }
  const uint32_t d = smem_addr(dst);
  const int n = ok ? 2 * vec : 0;
  if (vec == 8)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
  else if (vec == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void stsm_x4(bf16* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_addr(p)), "r"(r[0]),
               "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// d += a (16x16, row) * b (16x8, col): bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<const uint32_t*>(&lo);
  v.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

// The divisors of the dw copy loops: pieces per dy row, dy rows per channel, pieces per x band row, band rows.
struct DwDivs {
  FastDiv dy_row, rows, x_row, x_rows;
};

// Partial dw of the K tiles [blockIdx.z * chunk, ...) into ws[z][co][ci*k*k + tap], for 32*MI co (blockIdx.y) x
// 8*WN ci (blockIdx.x). 2 x WN warps, each 16*MI co x 8 ci x k*k taps: MI m16 tiles times k*k n8 blocks.
template <int K, int WN, int MI>
__global__ void __launch_bounds__(64 * WN)
    s2_dw_mma(const bf16* __restrict__ x, const bf16* __restrict__ dy, float* __restrict__ ws, Shape s, Tile t,
              DwDivs dv, int xv, int dyv, int chunk) {
  constexpr int kTaps = K * K, kHalo = K == 3 ? 1 : 0, kCiT = 8 * WN, kCoT = 32 * MI, kThr = 64 * WN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const stages = reinterpret_cast<bf16*>(smem);
  const int xrows = dw_x_rows(K, t.rows), xseg = dw_x_seg(K, t.cols), xstride = dw_x_stride(K, t.rows, t.cols);
  const int stage_elems = kCoT * kDwRow + kCiT * xstride;
  const int ci0 = blockIdx.x * kCiT, co0 = blockIdx.y * kCoT;
  const int kt_begin = blockIdx.z * chunk;
  const int n_kt = max(0, min(s.b * t.tiles_img, kt_begin + chunk) - kt_begin);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto load_tile = [&](int slot, int kt) {
    bf16* dys = stages + slot * stage_elems;
    bf16* xs = dys + kCoT * kDwRow;
    const int b = kt / t.tiles_img, tile = kt - b * t.tiles_img;
    const int i0 = tile / t.tiles_w * t.rows, j0 = tile % t.tiles_w * t.cols;
    const int dy_n = kCoT * t.rows * dv.dy_row.d;
    for (int q = tid; q < dy_n; q += kThr) {
      const int rr = q / dv.dy_row, c = (q - rr * dv.dy_row.d) * dyv, co = rr / dv.rows, r = rr - co * t.rows;
      const bool ok = co0 + co < s.co && i0 + r < s.ho && j0 + c < s.wo;
      const bf16* src = ok ? dy + ((static_cast<size_t>(b) * s.co + co0 + co) * s.ho + i0 + r) * s.wo + j0 + c : dy;
      copy_piece(dys + co * kDwRow + r * t.cols + c, src, dyv, ok);
    }
    const int y0 = K == 3 ? 2 * i0 - 1 : 2 * i0, ystep = K == 3 ? 1 : 2, col0 = 2 * j0 - 8 * kHalo;
    const int x_n = kCiT * xrows * dv.x_row.d;
    for (int q = tid; q < x_n; q += kThr) {
      const int rr = q / dv.x_row, e = (q - rr * dv.x_row.d) * xv, ci = rr / dv.x_rows, xr = rr - ci * xrows;
      const int yy = y0 + xr * ystep, xx = col0 + e;
      const bool ok = ci0 + ci < s.ci && yy >= 0 && yy < s.h && xx >= 0 && xx < s.w;
      const bf16* src = ok ? x + ((static_cast<size_t>(b) * s.ci + ci0 + ci) * s.h + yy) * s.w + xx : x;
      copy_piece(xs + ci * xstride + xr * xseg + e, src, xv, ok);
    }
  };

  // A tile narrower than kDwPix pixels (cols = the image's width) leaves the tail of each dy row idle: zeros,
  // written once (the copies never touch them); the idle pixels' B columns read a valid pixel's x.
  const int pix_used = t.rows * t.cols, tail = kDwPix - pix_used;
  for (int e = tid; e < kStages * kCoT * tail; e += kThr)
    stages[e / (kCoT * tail) * stage_elems + e % (kCoT * tail) / tail * kDwRow + pix_used + e % tail] =
        __ushort_as_bfloat16(0);
  float acc[MI][kTaps][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][tap][e] = 0.f;
  const int warp_m = warp / WN, warp_n = warp % WN;
  const int g = lane >> 2, tq = lane & 3;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);  // ldmatrix.x4 of A (16 x 16)

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt) load_tile(st, kt_begin + st);
    cp_async_commit();
  }
  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` is in; every warp is done with the slot the next copy overwrites
    if (it + kStages - 1 < n_kt) load_tile((it + kStages - 1) % kStages, kt_begin + it + kStages - 1);
    cp_async_commit();
    const bf16* dys = stages + (it % kStages) * stage_elems;
    const bf16* xs = dys + kCoT * kDwRow + (warp_n * 8 + g) * xstride;  // this lane's B column: channel g
#pragma unroll
    for (int ks = 0; ks < kDwPix / 16; ++ks) {
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(a[mi], dys + (warp_m * 16 * MI + mi * 16 + a_row) * kDwRow + ks * 16 + a_col);
      // B[k][n]: k = pixel (r, c) of the step, n = channel; a register holds pixels c and c + 1 (c even).
      // Tap (ky, kx) reads x[2(i0+r) + ky - p][2(j0+c) + kx - p]: band row 2r + ky (k=1: r), columns
      // 2c - 1, 2c, 2c + 1 (k=1: 2c) for c and two more for c + 1.
      uint32_t bfr[kTaps][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = min(ks * 16 + h * 8 + 2 * tq, pix_used - 2);
        const int r = pix / t.col, c = pix - r * t.cols;
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          const bf16* row = xs + (K == 3 ? 2 * r + ky : r) * xseg + 2 * c + 8 * kHalo;
          const uint2 v = *reinterpret_cast<const uint2*>(row);  // columns 2c .. 2c + 3
          if constexpr (K == 3) {
            const uint32_t left = *reinterpret_cast<const unsigned short*>(row - 1);  // column 2c - 1
            bfr[ky * 3 + 0][h] = __byte_perm(left, v.x, 0x7610);                      // (2c - 1, 2c + 1)
            bfr[ky * 3 + 1][h] = __byte_perm(v.x, v.y, 0x5410);                       // (2c, 2c + 2)
            bfr[ky * 3 + 2][h] = __byte_perm(v.x, v.y, 0x7632);                       // (2c + 1, 2c + 3)
          } else {
            bfr[0][h] = __byte_perm(v.x, v.y, 0x5410);
          }
        }
      }
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][tap], a[mi], bfr[tap][0], bfr[tap][1]);
    }
  }

  // Epilogue: the tile in OIHW order through shared memory, then whole rows of ws.
  cp_async_wait<0>();
  __syncthreads();
  constexpr int kN = kCiT * kTaps;
  float* es = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int co = warp_m * 16 * MI + mi * 16 + g + 8 * hh, ci = warp_n * 8 + 2 * tq;
        es[co * kN + ci * kTaps + tap] = acc[mi][tap][2 * hh];
        es[co * kN + (ci + 1) * kTaps + tap] = acc[mi][tap][2 * hh + 1];
      }
  __syncthreads();
  const int n_total = s.ci * kTaps, n0 = ci0 * kTaps, n_valid = min(kN, n_total - n0);
  float* out = ws + static_cast<size_t>(blockIdx.z) * s.co * n_total;
  for (int e = tid; e < kCoT * kN; e += kThr) {
    const int co = e / kN, n = e - co * kN;
    if (co0 + co < s.co && n < n_valid) out[static_cast<size_t>(co0 + co) * n_total + n0 + n] = es[e];
  }
}

// dx of one tile: 32*WM ci (blockIdx.y) x rows x cols dy pixels of one image (blockIdx.x), all parity classes.
// WM x (8/WM) warps, each 32 ci x 32 pixels: two m16 tiles times four n8 blocks per class.
template <int K, int WM>
__global__ void __launch_bounds__(256, 1)
    s2_dx_mma(const bf16* __restrict__ wt, const bf16* __restrict__ dy, bf16* __restrict__ dx, Shape s, Tile t,
              FastDiv d_row, FastDiv d_rows, int dyv, int wv, int xv) {
  constexpr int kTaps = K * K, kHalo = K == 3 ? 1 : 0, kCls = K == 3 ? 4 : 1, kShifts = K == 3 ? 4 : 1;
  constexpr int kWN = 8 / WM, kCiT = 32 * WM, kPix = dx_pixels(WM);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const stages = reinterpret_cast<bf16*>(smem);
  const int seg = dx_seg(K, t.cols), dstride = dx_dy_stride(K, t.rows, t.cols), drows = t.rows + kHalo;
  const int w_elems = kTaps * kCiT * kDxRow, stage_elems = w_elems + kDxCo * dstride;
  bf16* const dyt = stages + kStages * stage_elems;  // the stage's dy tile transposed: [pixel][co]
  const int b = blockIdx.x / t.tiles_img, tile = blockIdx.x - b * t.tiles_img;
  const int r0 = tile / t.tiles_w * t.rows, c0 = tile % t.tiles_w * t.cols;
  const int ci0 = blockIdx.y * kCiT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_k = (s.co + kDxCo - 1) / kDxCo;

  auto load_stage = [&](int slot, int kstep) {
    bf16* wsl = stages + slot * stage_elems;
    bf16* dyr = wsl + w_elems;
    const int co0 = kstep * kDxCo;
    const int w_row = kDxCo / wv, w_n = kTaps * kCiT * w_row;
    for (int q = tid; q < w_n; q += 256) {
      const int e = q % w_row * wv, rr = q / w_row, ci = rr % kCiT, tap = rr / kCiT;
      const bool ok = ci0 + ci < s.ci && co0 + e < s.co;
      const bf16* src = ok ? wt + (static_cast<size_t>(tap) * s.ci + ci0 + ci) * s.co + co0 + e : wt;
      copy_piece(wsl + rr * kDxRow + e, src, wv, ok);
    }
    const int d_n = kDxCo * drows * d_row.d;
    for (int q = tid; q < d_n; q += 256) {
      const int rr = q / d_row, e = (q - rr * d_row.d) * dyv, co = rr / d_rows, r = rr - co * drows;
      const bool ok = co0 + co < s.co && r0 + r < s.ho && c0 + e < s.wo;
      const bf16* src = ok ? dy + ((static_cast<size_t>(b) * s.co + co0 + co) * s.ho + r0 + r) * s.wo + c0 + e : dy;
      copy_piece(dyr + co * dstride + r * seg + e, src, dyv, ok);
    }
  };

  float acc[kCls][2][4][4];
#pragma unroll
  for (int cl = 0; cl < kCls; ++cl)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[cl][mi][ni][e] = 0.f;
  const int warp_m = warp / kWN, warp_n = warp % kWN;
  const int g = lane >> 2, tq = lane & 3;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  // B through ldmatrix.x4 j: n8 blocks 2j and 2j + 1 of the warp, k halves 0 and 1; this lane's pixel row
  // of dyt before the shift.
  int b_row[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int p = warp_n * 32 + (2 * j + (lane >> 4)) * 8 + (lane & 7);
    p = p < t.rows * t.cols ? p : 0;  // an idle pixel reads pixel 0; its results are not stored
    b_row[j] = p / t.col * seg + p % t.cols;
  }
  const int b_col = 8 * ((lane >> 3) & 1);

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_k) load_stage(st, st);
    cp_async_commit();
  }
  for (int ks = 0; ks < n_k; ++ks) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `ks` is in; every warp is done with dyt and with the slot the next copy overwrites
    if (ks + kStages - 1 < n_k) load_stage((ks + kStages - 1) % kStages, ks + kStages - 1);
    cp_async_commit();
    const bf16* wsl = stages + (ks % kStages) * stage_elems;
    const bf16* dyr = wsl + w_elems;
    // Transpose dy [co][pixel] -> dyt [pixel][co] in 8 x 8 blocks, the four 8-channel blocks of a pixel block
    // at once.
    const int cbs = seg / 8;
    for (int blk = warp; blk < drows * cbs; blk += 8) {
      const int r = blk / cbs, cb = blk - r * cbs;
      uint32_t v[4];
      ldsm_x4_trans(v, dyr + lane * dstride + r * seg + cb * 8);
      stsm_x4(dyt + (r * seg + cb * 8 + (lane & 7)) * kDxRow + 8 * (lane >> 3), v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDxCo / 16; ++kk) {
      // B fragments of the shifts (oy, ox): pixel (r + oy, c + ox) of dyt, channels 16*kk ...
      uint32_t bfr[kShifts][4][2];
#pragma unroll
      for (int sh = 0; sh < kShifts; ++sh) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t v[4];
          ldsm_x4(v, dyt + (b_row[j] + (sh >> 1) * seg + (sh & 1)) * kDxRow + b_col + 16 * kk);
          bfr[sh][2 * j][0] = v[0];
          bfr[sh][2 * j][1] = v[1];
          bfr[sh][2 * j + 1][0] = v[2];
          bfr[sh][2 * j + 1][1] = v[3];
        }
      }
      // Tap kq along one axis: parity class (kq - p) % 2 and dy offset (class + p - kq) / 2; for k=3 that is
      // kq 0 -> (1, +1), 1 -> (0, 0), 2 -> (1, 0).
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const int cls = K == 3 ? (ky != 1) * 2 + (kx != 1) : 0;
          const int sh = K == 3 ? (ky == 0) * 2 + (kx == 0) : 0;
          const bf16* wtap = wsl + ((ky * K + kx) * kCiT + warp_m * 32 + a_row) * kDxRow + a_col + 16 * kk;
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            uint32_t a[4];
            ldsm_x4(a, wtap + mi * 16 * kDxRow);
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[cls][mi][ni], a, bfr[sh][ni][0], bfr[sh][ni][1]);
          }
        }
      }
    }
  }

  // Epilogue: interleave the classes into the tile's dx rows 2r, 2r + 1 in shared memory, then 16-byte rows.
  cp_async_wait<0>();
  __syncthreads();
  bf16* const out = stages;
  const int orow = 2 * t.cols, ostride = 4 * kPix + 16;  // +16 elements spread the channels over the banks
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int ci = warp_m * 32 + mi * 16 + g + 8 * hh, p = warp_n * 32 + ni * 8 + 2 * tq;
        if (p >= t.rows * t.cols) continue;
        const int r = p / t.col, c = p - r * t.cols;
        bf16* o = out + ci * ostride + 2 * r * orow + 2 * c;  // pixels c, c + 1: dx columns 2c .. 2c + 3
        if constexpr (K == 3) {  // class (py, px) = acc[2 * py + px]
          store4(o, acc[0][mi][ni][2 * hh], acc[1][mi][ni][2 * hh], acc[0][mi][ni][2 * hh + 1],
                 acc[1][mi][ni][2 * hh + 1]);
          store4(o + orow, acc[2][mi][ni][2 * hh], acc[3][mi][ni][2 * hh], acc[2][mi][ni][2 * hh + 1],
                 acc[3][mi][ni][2 * hh + 1]);
        } else {
          store4(o, acc[0][mi][ni][2 * hh], 0.f, acc[0][mi][ni][2 * hh + 1], 0.f);
          store4(o + orow, 0.f, 0.f, 0.f, 0.f);
        }
      }
  __syncthreads();
  const int chunks = orow / 8, n_chunks = kCiT * 2 * t.rows * chunks;
  for (int q = tid; q < n_chunks; q += 256) {
    const int e = q % chunks * 8, rr = q / chunks, y = rr % (2 * t.rows), ci = rr / (2 * t.rows);
    const int gy = 2 * r0 + y, gx = 2 * c0 + e;
    if (ci0 + ci >= s.ci || gy >= s.h || gx >= s.w) continue;
    const bf16* src = out + ci * ostride + y * orow + e;
    bf16* dst = dx + ((static_cast<size_t>(b) * s.ci + ci0 + ci) * s.h + gy) * s.w + gx;
    if (xv == 8) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && gx + i < s.w; ++i) dst[i] = src[i];
    }
  }
}

// ---------------------------------------------------------------------------------------------------------
// host

int vec_of(int n) { return n % 8 == 0 ? 8 : n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1; }

Tile make_tile(const Shape& s, int pixels, int cols) {
  Tile t{pixels / cols, cols, (s.wo + cols - 1) / cols, 0, fast_div(cols)};
  t.tiles_img = (s.ho + t.rows - 1) / t.rows * t.tiles_w;
  return t;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return bytes > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
                           : cudaSuccess;
}

// One instance of the dw kernel: its shared memory, its CTAs per SM, its launch.
template <int K, int WN, int MI>
struct Dw {
  static constexpr int kCoT = 32 * MI, kThr = 64 * WN;
  static int smem(const Tile& t) {
    const int stage = kCoT * kDwRow + 8 * WN * dw_x_stride(K, t.rows, t.cols);
    return std::max(kStages * stage * 2, kCoT * 8 * WN * K * K * 4);
  }
  static int ctas_per_sm(const Tile& t) {
    int n = 0;
    if (allow_smem(s2_dw_mma<K, WN, MI>, smem(t)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, s2_dw_mma<K, WN, MI>, kThr, smem(t)) != cudaSuccess)
      return -1;
    return n;
  }
  static cudaError_t launch(const bf16* x, const bf16* dy, float* ws, const Shape& s, const Tile& t, int splits,
                            int chunk, cudaStream_t st) {
    const int bytes = smem(t);
    cudaError_t err = allow_smem(s2_dw_mma<K, WN, MI>, bytes);
    if (err != cudaSuccess) return err;
    const int xv = vec_of(s.w), dyv = vec_of(s.wo);
    const DwDivs dv{fast_div(t.cols / dyv), fast_div(t.rows), fast_div(dw_x_seg(K, t.cols) / xv),
                    fast_div(dw_x_rows(K, t.rows))};
    const dim3 grid((s.ci + 8 * WN - 1) / (8 * WN), (s.co + kCoT - 1) / kCoT, splits);
    s2_dw_mma<K, WN, MI><<<grid, kThr, bytes, st>>>(x, dy, ws, s, t, dv, xv, dyv, chunk);
    return cudaGetLastError();
  }
};

// Calls op with the dw instance of a shape: CTA tiles of 64 co x 8 ci for Ci <= 8 (the image layer, Ci = 3), else
// 128 co x 32 ci for Co >= 128, 64 x 32 below.
template <typename Op>
auto with_dw(const Shape& s, Op op) {
  const int shape = s.ci <= 8 ? 0 : s.co >= 128 ? 2 : 1;
  if (s.k == 3) return shape == 0 ? op(Dw<3, 1, 2>{}) : shape == 1 ? op(Dw<3, 4, 2>{}) : op(Dw<3, 4, 4>{});
  return shape == 0 ? op(Dw<1, 1, 2>{}) : shape == 1 ? op(Dw<1, 4, 2>{}) : op(Dw<1, 4, 4>{});
}

template <int K, int WM>
cudaError_t launch_dx(const bf16* wt, const bf16* dy, bf16* dx, const Shape& s, int cols, cudaStream_t st) {
  const Tile t = make_tile(s, dx_pixels(WM), cols);
  const int stage = K * K * 32 * WM * kDxRow + kDxCo * dx_dy_stride(K, t.rows, t.cols);
  const int dyt = (t.rows + (K == 3 ? 1 : 0)) * dx_seg(K, t.cols) * kDxRow;
  const int bytes = std::max((kStages * stage + dyt) * 2, 32 * WM * (4 * dx_pixels(WM) + 16) * 2);
  cudaError_t err = allow_smem(s2_dx_mma<K, WM>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.b * t.tiles_img, (s.ci + 32 * WM - 1) / (32 * WM));
  const int dyv = vec_of(s.wo);
  s2_dx_mma<K, WM><<<grid, 256, bytes, st>>>(wt, dy, dx, s, t, fast_div(dx_seg(K, t.cols) / dyv),
                                             fast_div(t.rows + (K == 3 ? 1 : 0)), dyv, vec_of(s.co), vec_of(s.w));
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* ws, float* dw, int splits, int mn, cudaStream_t st) {
  s2_dw_reduce<<<(mn + kThreads - 1) / kThreads, kThreads, 0, st>>>(ws, dw, splits, mn);
  return cudaGetLastError();
}

cudaError_t launch_f32(const float* x, const float* w, const float* dy, float* dx, float* dw, float* ws,
                       const Shape& s, int splits, int chunk, cudaStream_t st) {
  const int n_total = s.ci * s.k * s.k;
  const dim3 dw_grid((n_total + kTN - 1) / kTN, (s.co + kTM - 1) / kTM, splits);
  s2_dw_kernel<<<dw_grid, kThreads, 0, st>>>(x, dy, ws, s, chunk);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_reduce(ws, dw, splits, s.co * n_total, st);
  if (err != cudaSuccess || dx == nullptr) return err;
  const dim3 dx_grid((s.b * s.ho * s.wo + kTN - 1) / kTN, (s.ci + kTM - 1) / kTM, 4);
  s2_dx_kernel<<<dx_grid, kThreads, 0, st>>>(w, dy, dx, s);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const bf16* x, const bf16* wt, const bf16* dy, bf16* dx, float* dw, float* ws, const Shape& s,
                        int splits, int chunk, int dw_cols, int dx_cols, cudaStream_t st) {
  const Tile t = make_tile(s, kDwPix, dw_cols);
  cudaError_t err = with_dw(s, [&](auto dw) { return decltype(dw)::launch(x, dy, ws, s, t, splits, chunk, st); });
  if (err == cudaSuccess) err = launch_reduce(ws, dw, splits, s.co * s.ci * s.k * s.k, st);
  if (err != cudaSuccess || dx == nullptr) return err;
  const bool one_m = s.ci <= 32;  // 32 ci x 256 pixels per CTA, else 64 ci x 128 pixels
  return s.k == 3 ? (one_m ? launch_dx<3, 1>(wt, dy, dx, s, dx_cols, st) : launch_dx<3, 2>(wt, dy, dx, s, dx_cols, st))
                  : (one_m ? launch_dx<1, 1>(wt, dy, dx, s, dx_cols, st) : launch_dx<1, 2>(wt, dy, dx, s, dx_cols, st));
}

// A tile is 8, 16, 32 or 64 columns wide, or as wide as the image when that is a multiple of 4 below 64.
bool tile_width_ok(int cols, int wo) {
  return cols == 8 || cols == 16 || cols == 32 || cols == 64 || (cols == wo && wo % 4 == 0 && wo < 64);
}

}  // namespace

extern "C" {

// x (B, Ci, H, W), w (Co, Ci, k, k), dy (B, Co, H/2, W/2): contiguous, all float32 (dtype 0) or bfloat16
// (dtype 1). dx like x, or null when it is not needed; dw (Co, Ci, k, k) float32; ws a float32 workspace of
// splits * Co * Ci * k * k.
// float32: w is read; wt, dw_cols and dx_cols are ignored; `chunk` pixels (a multiple of 16) per split.
// bfloat16: w is not read; wt is w packed as (k*k, Ci, Co) (needed with dx); `chunk` tiles of 64 pixels
// (dw_cols columns wide) per split; dx tiles are dx_cols columns wide; a width is 8, 16, 32 or 64, or W/2 when
// that is a multiple of 4 below 64. x, dy, wt and dx 16-byte aligned.
// Launches on `stream`, does not synchronise; returns the first launch's error, or 0.
int s2_bwd_launch(const void* x, const void* w, const void* wt, const void* dy, void* dx, void* dw, void* ws, int dtype,
                  int batch, int ci, int h, int wd, int co, int k, int p, int splits, int chunk, int dw_cols,
                  int dx_cols, void* stream) {
  if (batch < 1 || ci < 1 || co < 1 || h < 2 || wd < 2 || h % 2 || wd % 2 || splits < 1 || splits > 65535 ||
      chunk < 1 || !((k == 3 && p == 1) || (k == 1 && p == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{batch, ci, h, wd, co, h / 2, wd / 2, k, p};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (chunk % kTK) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_f32(static_cast<const float*>(x), static_cast<const float*>(w),
                                       static_cast<const float*>(dy), static_cast<float*>(dx), static_cast<float*>(dw),
                                       static_cast<float*>(ws), s, splits, chunk, st));
  }
  if (dtype == 1) {
    if (!tile_width_ok(dw_cols, s.wo) || !tile_width_ok(dx_cols, s.wo) || (dx != nullptr && wt == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(wt),
                                        static_cast<const bf16*>(dy), static_cast<bf16*>(dx), static_cast<float*>(dw),
                                        static_cast<float*>(ws), s, splits, chunk, dw_cols, dx_cols, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// CTAs of the bfloat16 dw kernel that one SM of the current device holds at once, for this shape and tile width
// (the split plan fills the card with them); -1 if the query fails.
int s2_bwd_dw_ctas_per_sm(int batch, int ci, int h, int wd, int co, int k, int dw_cols) {
  if (ci < 1 || co < 1 || h < 2 || wd < 2 || !(k == 3 || k == 1) || !tile_width_ok(dw_cols, wd / 2)) return -1;
  const Shape s{batch, ci, h, wd, co, h / 2, wd / 2, k, k == 3 ? 1 : 0};
  const Tile t = make_tile(s, kDwPix, dw_cols);
  return with_dw(s, [&](auto dw) { return decltype(dw)::ctas_per_sm(t); });
}

const char* s2_bwd_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
