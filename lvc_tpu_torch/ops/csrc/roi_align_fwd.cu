// Multi-level RoIAlign forward for Hopper (sm_90a): the two serving pools.
//
// Replaces the TPU Pallas kernels of lvc_tpu/ops/roi_align.py:
//   K1 roi_align_band_fwd   <- _pallas_roi_kernel_patch_ml (:1753, pallas_call :2150),
//                              _pallas_roi_kernel_band (:1367, :1505) and
//                              _pallas_roi_kernel_patch (:1539, :1718): the
//                              band-semantics serving pool (POOLER_IMPL
//                              pallas_fast / pallas_band);
//   K2 roi_align_paired_fwd <- _pallas_roi_kernel_paired (:974, :1133): the
//                              paired pool (POOLER_IMPL auto / pallas).
// Both compute, per box n and output cell (py, px), in f32:
//   out[n,py,px,c] = inv[n] * sum_t wx[n,px,t] *
//                    sum_r wy[n,py,r] * F_lvl(n)[rows[n,py,r], xs[n] + tcol[n,px,t], c]
// and write the feature dtype. The rows, columns and weights come from the
// torch prep (lvc_tpu_torch/ops/roi_align.py), which computes them as the JAX
// prep does; this file does the gather and the weighted sum. K1's rows are the
// 4-row band of each output row, K2's the two corner rows of each grid row.
//
// What bounds it: bytes. Per box it reads the feature rows and columns its
// samples touch and writes P*P*C outputs, with 2 flops per byte read at most,
// far below the ~295 flop/byte where the tensor cores would become the limit.
// So the design moves the fewest bytes simply, and does not use the tensor
// cores (the TPU kernel's dense 32-wide x-dot is replaced by the <= 2G
// nonzero taps per output column):
//   - one block per box; threads across C with 16-byte loads (8 bf16 or 4
//     f32 per thread), so a warp reads one 512-byte feature row of C=256 bf16;
//     threadIdx.y is the output row py;
//   - the box's rows, taps and weights are staged in shared memory once;
//   - reads with zero weight are skipped, so a box reads only the rows and
//     columns its samples touch; rows shared by neighbouring bands and taps
//     are served from L1/L2;
//   - no patch staging in shared memory (the TPU kernel's DMA choreography).
// A row index of -1, or a column at or past the level's width, stands for the
// JAX package's zero padding and contributes exactly zero.
//
// Summation order follows the JAX kernels: y-combine before x-combine; K1
// sums the band rows in order ((t0 + t1) + t2) + t3, K2 sums the grid rows'
// (corner0 + corner1) pairs in order; then the taps in order; then * inv.
// __fmul_rn/__fadd_rn forbid FMA contraction, so the result equals the plain
// torch version (roi_align_taps_plain) bit for bit on finite inputs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libroi_align_fwd.so roi_align_fwd.cu
// (lvc_tpu_torch/ops/_build.py does this on first use.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxP = 16;
constexpr int kMaxTaps = 8;

struct Levels {
  const void* ptr[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
};

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = a;
  }
};

// acc += w * F[row, col, c0 : c0 + V], or nothing when the weight is zero or
// the row stands for padding.
template <typename T>
__device__ __forceinline__ void add_row(float* acc, const T* F, int row, int col, int C,
                                        int c0, float w, int W) {
  constexpr int V = Vec<T>::N;
  if (w == 0.f || row < 0) return;
  float v[V];
  Vec<T>::load(F + ((size_t)row * W + col) * C + c0, v);
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(w, v[k]));
}

template <typename T, bool kPaired>
__global__ void roi_align_rows_kernel(Levels lv, int C, int P, int NR, int NT,
                                      const int* __restrict__ lvl, const int* __restrict__ xs,
                                      const float* __restrict__ inv,
                                      const int* __restrict__ rows,
                                      const float* __restrict__ wy,
                                      const int* __restrict__ tcol,
                                      const float* __restrict__ wx, T* __restrict__ out) {
  constexpr int V = Vec<T>::N;
  __shared__ int s_rows[kMaxP * kMaxTaps];
  __shared__ float s_wy[kMaxP * kMaxTaps];
  __shared__ int s_tcol[kMaxP * kMaxTaps];
  __shared__ float s_wx[kMaxP * kMaxTaps];

  const int n = blockIdx.x;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  for (int i = tid; i < P * NR; i += nthr) {
    s_rows[i] = rows[(size_t)n * P * NR + i];
    s_wy[i] = wy[(size_t)n * P * NR + i];
  }
  for (int i = tid; i < P * NT; i += nthr) {
    s_tcol[i] = tcol[(size_t)n * P * NT + i];
    s_wx[i] = wx[(size_t)n * P * NT + i];
  }
  __syncthreads();

  const int l = lvl[n];
  const T* F = static_cast<const T*>(lv.ptr[l]);
  const int W = lv.W[l];
  const int x0 = xs[n];
  const float scale = inv[n];
  const int py = threadIdx.y;
  const int* my_rows = s_rows + py * NR;
  const float* my_wy = s_wy + py * NR;

  for (int cv = threadIdx.x; cv * V < C; cv += blockDim.x) {
    const int c0 = cv * V;
    for (int px = 0; px < P; ++px) {
      float acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = 0.f;
      for (int t = 0; t < NT; ++t) {
        const float w = s_wx[px * NT + t];
        const int col = x0 + s_tcol[px * NT + t];
        if (w == 0.f || col >= W) continue;
        float y[V];
#pragma unroll
        for (int k = 0; k < V; ++k) y[k] = 0.f;
        if (kPaired) {
          for (int r = 0; r < NR; r += 2) {
            float a[V], b[V];
#pragma unroll
            for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
            add_row<T>(a, F, my_rows[r], col, C, c0, my_wy[r], W);
            add_row<T>(b, F, my_rows[r + 1], col, C, c0, my_wy[r + 1], W);
#pragma unroll
            for (int k = 0; k < V; ++k) y[k] = __fadd_rn(y[k], __fadd_rn(a[k], b[k]));
          }
        } else {
          for (int r = 0; r < NR; ++r) add_row<T>(y, F, my_rows[r], col, C, c0, my_wy[r], W);
        }
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(w, y[k]));
      }
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = __fmul_rn(acc[k], scale);
      Vec<T>::store(out + (((size_t)n * P + py) * P + px) * C + c0, acc);
    }
  }
}

template <bool kPaired>
int launch(const void* const* level_ptrs, const int* heights, const int* widths, int L, int B,
           int C, int P, int NR, int NT, int n, const int* lvl, const int* xs, const float* inv,
           const int* rows, const float* wy, const int* tcol, const float* wx, void* out,
           int is_bf16, void* stream) {
  (void)B;
  if (L < 1 || L > kMaxLevels || P < 1 || P > kMaxP || NR < 1 || NR > kMaxTaps || NT < 1 ||
      NT > kMaxTaps || (kPaired && NR % 2) || n < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = i < L ? level_ptrs[i] : nullptr;
    lv.H[i] = i < L ? heights[i] : 0;
    lv.W[i] = i < L ? widths[i] : 0;
  }
  const int V = is_bf16 ? Vec<__nv_bfloat16>::N : Vec<float>::N;
  if (C % V) return (int)cudaErrorInvalidValue;
  const int lanes = C / V < 32 ? C / V : 32;
  const dim3 block(lanes, P);
  const dim3 grid(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_rows_kernel<__nv_bfloat16, kPaired><<<grid, block, 0, s>>>(
        lv, C, P, NR, NT, lvl, xs, inv, rows, wy, tcol, wx, static_cast<__nv_bfloat16*>(out));
  } else {
    roi_align_rows_kernel<float, kPaired><<<grid, block, 0, s>>>(
        lv, C, P, NR, NT, lvl, xs, inv, rows, wy, tcol, wx, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int roi_align_band_fwd(const void* const* level_ptrs, const int* heights, const int* widths,
                       int L, int B, int C, int P, int NR, int NT, int n, const int* lvl,
                       const int* xs, const float* inv, const int* rows, const float* wy,
                       const int* tcol, const float* wx, void* out, int is_bf16, void* stream) {
  return launch<false>(level_ptrs, heights, widths, L, B, C, P, NR, NT, n, lvl, xs, inv, rows,
                       wy, tcol, wx, out, is_bf16, stream);
}

int roi_align_paired_fwd(const void* const* level_ptrs, const int* heights, const int* widths,
                         int L, int B, int C, int P, int NR, int NT, int n, const int* lvl,
                         const int* xs, const float* inv, const int* rows, const float* wy,
                         const int* tcol, const float* wx, void* out, int is_bf16,
                         void* stream) {
  return launch<true>(level_ptrs, heights, widths, L, B, C, P, NR, NT, n, lvl, xs, inv, rows,
                      wy, tcol, wx, out, is_bf16, stream);
}

}  // extern "C"
