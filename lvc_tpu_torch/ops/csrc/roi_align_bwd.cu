// Multi-level RoIAlign backward for Hopper (sm_90a): d pooled -> d features.
//
// Replaces the TPU Pallas kernels of lvc_tpu/ops/roi_align.py:
//   K3 roi_align_paired_bwd <- _pallas_roi_backward_kernel_ml (:2841, pallas_call :3174),
//                              the pallas_train backward (_roi_align_ml_bwd_impl :3035),
//                              and _pallas_roi_backward_kernel (:2196, :2340), the
//                              pallas_train_flat backward and the single-level
//                              fallback (_roi_align_paired_bwd_impl :2275).
// It is the transpose of K2 (roi_align_paired_fwd in roi_align_fwd.cu) over the
// same taps: for every box n, output cell (py, px), row tap r, column tap t and
// channel c,
//   acc_lvl(n)[rows[n,py,r], xs[n] + tcol[n,px,t], c]
//       += (wy[n,py,r] * wx[n,px,t]) * (inv[n] * gout[n,py,px,c])
// into per-level float32 accumulators (B*H_l, W_l, C) that the wrapper zeroes
// and afterwards casts to the feature dtype. It skips exactly the taps K2
// skips: a row of -1, a column at or past the level's width, a zero weight.
//
// What bounds it: bytes. Per box it reads P*P*C output grads and read-modify-
// writes the accumulator elements its taps touch, with 2 flops per 4-byte
// accumulator element moved; far below the ~295 flop/byte where arithmetic
// would become the limit. The TPU kernel gets race-freedom from its sequential
// grid (a strictly serial patch read-modify-write, or conflict bits between
// pipelined windows, 16x24 chunking); Hopper's blocks run in parallel in no
// order, so this kernel adds with float32 atomics into device memory instead,
// as detectron2's ROIAlign_cuda.cu backward does:
//   - one block per box; threads across C (16-byte gout loads: 8 bf16 or 4 f32
//     per thread); threadIdx.y is the output row py;
//   - the box's rows, taps and weights are staged in shared memory once;
//   - each contribution is a 16-byte vector atomicAdd (float4, sm_90 global
//     memory), so a warp updates one 512-byte (bf16 C=256) run of channels.
// The sum order is whatever order the atomics land in, so the result is not
// bit-reproducible; the products themselves are the plain version's
// (roi_align_taps_plain_backward), term for term.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libroi_align_bwd.so roi_align_bwd.cu
// (lvc_tpu_torch/ops/_build.py does this on first use.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxP = 16;
constexpr int kMaxTaps = 8;

struct Accs {
  float* ptr[kMaxLevels];
  int rows[kMaxLevels];  // B * H_l
  int W[kMaxLevels];
};

template <typename T>
struct GVec;

template <>
struct GVec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};

template <>
struct GVec<__nv_bfloat16> {
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
};

template <typename T>
__global__ void roi_align_paired_bwd_kernel(Accs acc, int C, int P, int NR, int NT,
                                            const int* __restrict__ lvl,
                                            const int* __restrict__ xs,
                                            const float* __restrict__ inv,
                                            const int* __restrict__ rows,
                                            const float* __restrict__ wy,
                                            const int* __restrict__ tcol,
                                            const float* __restrict__ wx,
                                            const T* __restrict__ gout) {
  constexpr int V = GVec<T>::N;
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
  float* A = acc.ptr[l];
  const int W = acc.W[l];
  const int nrows = acc.rows[l];
  const int x0 = xs[n];
  const float scale = inv[n];
  const int py = threadIdx.y;
  const int* my_rows = s_rows + py * NR;
  const float* my_wy = s_wy + py * NR;

  for (int cv = threadIdx.x; cv * V < C; cv += blockDim.x) {
    const int c0 = cv * V;
    for (int px = 0; px < P; ++px) {
      float g[V];
      GVec<T>::load(gout + (((size_t)n * P + py) * P + px) * C + c0, g);
#pragma unroll
      for (int k = 0; k < V; ++k) g[k] = __fmul_rn(scale, g[k]);
      for (int t = 0; t < NT; ++t) {
        const float w = s_wx[px * NT + t];
        const int col = x0 + s_tcol[px * NT + t];
        if (w == 0.f || col >= W) continue;
        for (int r = 0; r < NR; ++r) {
          const int row = my_rows[r];
          const float wr = my_wy[r];
          if (wr == 0.f || row < 0 || row >= nrows) continue;
          const float f = __fmul_rn(wr, w);
          float* dst = A + ((size_t)row * W + col) * C + c0;
#pragma unroll
          for (int k = 0; k < V; k += 4) {
            atomicAdd(reinterpret_cast<float4*>(dst + k),
                      make_float4(__fmul_rn(f, g[k]), __fmul_rn(f, g[k + 1]),
                                  __fmul_rn(f, g[k + 2]), __fmul_rn(f, g[k + 3])));
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// acc_ptrs[l]: float32 (B*H_l, W_l, C), zeroed; gout (n, P, P, C) in the
// feature dtype (bf16 if is_bf16, else f32). Returns the launch's cudaError_t.
int roi_align_paired_bwd(void* const* acc_ptrs, const int* acc_rows, const int* widths, int L,
                         int C, int P, int NR, int NT, int n, const int* lvl, const int* xs,
                         const float* inv, const int* rows, const float* wy, const int* tcol,
                         const float* wx, const void* gout, int is_bf16, void* stream) {
  if (L < 1 || L > kMaxLevels || P < 1 || P > kMaxP || NR < 1 || NR > kMaxTaps || NT < 1 ||
      NT > kMaxTaps || n < 1)
    return (int)cudaErrorInvalidValue;
  Accs acc;
  for (int i = 0; i < kMaxLevels; ++i) {
    acc.ptr[i] = i < L ? static_cast<float*>(acc_ptrs[i]) : nullptr;
    acc.rows[i] = i < L ? acc_rows[i] : 0;
    acc.W[i] = i < L ? widths[i] : 0;
  }
  const int V = is_bf16 ? GVec<__nv_bfloat16>::N : GVec<float>::N;
  if (C % V) return (int)cudaErrorInvalidValue;
  const int lanes = C / V < 32 ? C / V : 32;
  const dim3 block(lanes, P);
  const dim3 grid(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    roi_align_paired_bwd_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        acc, C, P, NR, NT, lvl, xs, inv, rows, wy, tcol, wx,
        static_cast<const __nv_bfloat16*>(gout));
  } else {
    roi_align_paired_bwd_kernel<float><<<grid, block, 0, s>>>(
        acc, C, P, NR, NT, lvl, xs, inv, rows, wy, tcol, wx, static_cast<const float*>(gout));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
