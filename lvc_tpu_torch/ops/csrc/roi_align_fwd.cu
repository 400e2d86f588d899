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
// What bounds it: bytes. Per box it reads the feature pixels its samples touch
// and writes P*P*C outputs, with 2 flops per byte read at most, far below the
// ~295 flop/byte where the tensor cores would become the limit. So the design
// moves the fewest bytes and keeps many of them in flight, and does not use the
// tensor cores (the TPU kernel's dense 32-wide x-dot is replaced by the <= 2G
// nonzero taps per output column):
//   - one block of 256 threads per (box, group of 32 channel vectors: 256
//     bf16 or 128 f32 channels), 4 blocks per SM (48 KB of dynamic shared
//     memory a block by default);
//   - the box's distinct valid rows and distinct valid columns are listed once
//     (duplicates folded in shared memory); a row with zero weight, of -1 or
//     outside the level, and a column with zero weight or outside the level, are
//     not read: they stand for the JAX package's zero padding and contribute
//     exactly zero;
//   - per channel slice (as many of the group's channels as the window fits
//     in the shared memory, all of them for a small box), every (distinct row, distinct column)
//     feature vector of the window is copied into shared memory with 16-byte
//     cp.async, all in flight together, so each is read from L2 once per box;
//   - the y-combine is computed once per (py, distinct column) from shared
//     memory, since it does not depend on px, and kept there in float32;
//   - the x-combine reads those values for each output cell, scales by inv and
//     writes the feature dtype with 16-byte stores.
//
// Summation order follows the JAX kernels: y-combine before x-combine; K1
// sums the band rows in order ((t0 + t1) + t2) + t3, K2 sums the grid rows'
// (corner0 + corner1) pairs in order; then the taps in order; then * inv.
// __fmul_rn/__fadd_rn forbid FMA contraction, so the result equals the plain
// torch version (roi_align_taps_plain) bit for bit on finite inputs.
//
// Limits (the launcher refuses the rest with cudaErrorInvalidValue, and the
// wrapper raises): P <= 16, NR <= 8, NT <= 8, and the largest window a box may
// have, (P*NR) rows x (P*NT) columns of one 16-byte vector plus its
// P x (P*NT) y-combines, within 216 KB of shared memory.
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
constexpr int kMaxTapsPerBox = kMaxP * kMaxTaps;  // 128
constexpr int kThreads = 256;                     // >= one row tap and one column tap each
constexpr int kGroupVecs = 32;                    // 16-byte channel vectors of a block
constexpr int kSmemBytes = 48 * 1024;             // dynamic shared memory of a block
constexpr int kMaxSmemBytes = 216 * 1024;         // beside the 5 KB of static arrays

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
    const float4 a = *reinterpret_cast<const float4*>(p);
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
    const uint4 a = *reinterpret_cast<const uint4*>(p);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// q / d for 0 <= q < 2^24 / d, from rcp = ceil(2^24 / d).
__device__ __forceinline__ int div_by(int q, unsigned rcp) {
  return (int)(((unsigned long long)(unsigned)q * rcp) >> 24);
}

// The keys[0..K) that are >= 0 folded into a list of distinct values, in order
// of first occurrence: map[k] = the index of keys[k] in list, or -1.
struct Distinct {
  int key[kMaxTapsPerBox];
  int lead[kMaxTapsPerBox];
  int map[kMaxTapsPerBox];
  int list[kMaxTapsPerBox];

  // thread k < K, after key[] is written: the first k' with key[k'] == key[k]
  __device__ bool find_lead(int k, int K) {
    if (k >= K) return false;
    const int v = key[k];
    int j = 0;
    if (v >= 0)
      while (key[j] != v) ++j;
    lead[k] = v >= 0 ? j : -1;
    return v >= 0 && j == k;
  }
  // thread k < K, after every lead[] is written
  __device__ void place(int k, int K, bool first) {
    if (k >= K) return;
    const int j = lead[k];
    int idx = -1;
    if (j >= 0) {
      idx = 0;
      for (int i = 0; i < j; ++i) idx += lead[i] == i;
    }
    map[k] = idx;
    if (first) list[idx] = key[k];
  }
};

// acc += w * x for the window's vector at (ri, ci), or nothing when the row tap
// is not read (ri < 0).
template <typename T>
__device__ __forceinline__ void add_px(float* acc, const T* win, int ri, int ci, int nc, int CS,
                                       int v0, float w) {
  constexpr int V = Vec<T>::N;
  if (ri < 0) return;
  float x[V];
  Vec<T>::load(win + ((size_t)ri * nc + ci) * CS + v0, x);
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(w, x[k]));
}

template <typename T, bool kPaired>
__global__ void __launch_bounds__(kThreads) roi_align_rows_kernel(
    Levels lv, int B, int C, int P, int NR, int NT, const int* __restrict__ lvl,
    const int* __restrict__ xs, const float* __restrict__ inv, const int* __restrict__ rows,
    const float* __restrict__ wy, const int* __restrict__ tcol, const float* __restrict__ wx,
    T* __restrict__ out, int smem_bytes) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Distinct s_rows, s_cols;
  __shared__ float s_wy[kMaxTapsPerBox], s_wx[kMaxTapsPerBox];

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int l = lvl[n];
  const T* F = static_cast<const T*>(lv.ptr[l]);
  const int W = lv.W[l];
  const int nrows = B * lv.H[l];
  const int PNR = P * NR, PNT = P * NT;

  // thread k folds row tap k and column tap k
  if (tid < PNR) {
    const int r = rows[(size_t)n * PNR + tid];
    const float w = wy[(size_t)n * PNR + tid];
    s_wy[tid] = w;
    s_rows.key[tid] = w != 0.f && r >= 0 && r < nrows ? r : -1;
  }
  if (tid < PNT) {
    const int c = xs[n] + tcol[(size_t)n * PNT + tid];
    const float w = wx[(size_t)n * PNT + tid];
    s_wx[tid] = w;
    s_cols.key[tid] = w != 0.f && c >= 0 && c < W ? c : -1;
  }
  __syncthreads();
  const bool first_r = s_rows.find_lead(tid, PNR);
  const bool first_c = s_cols.find_lead(tid, PNT);
  const int nr = __syncthreads_count(first_r);
  const int nc = __syncthreads_count(first_c);
  s_rows.place(tid, PNR, first_r);
  s_cols.place(tid, PNT, first_c);
  __syncthreads();

  // this block's channels, in slices: the window (nr x nc vectors) and its
  // y-combines (P x nc float32) within smem_bytes; the host made room for one
  // vector
  const int c_begin = blockIdx.y * kGroupVecs * V;
  const int c_end = c_begin + kGroupVecs * V < C ? c_begin + kGroupVecs * V : C;
  // a power of two of vectors a slice, so that index math is shifts
  const int per_ch = nr * nc * (int)sizeof(T) + P * nc * 4;
  int lg = 0;
  while ((2 << lg) <= kGroupVecs && (per_ch == 0 || (2 << lg) * V * per_ch <= smem_bytes)) ++lg;
  const int CS = V << lg;
  T* win = reinterpret_cast<T*>(smem);
  float* Y = reinterpret_cast<float*>(smem + (size_t)nr * nc * CS * sizeof(T));
  const float scale = inv[n];
  const unsigned rcp_nc = nc ? ((1u << 24) + nc - 1) / nc : 0u, rcp_p = ((1u << 24) + P - 1) / P;

  for (int c0 = c_begin; c0 < c_end; c0 += CS) {
    const int nv = (c_end - c0 < CS ? c_end - c0 : CS) / V;
    for (int i = tid; i < (nr * nc) << lg; i += kThreads) {
      const int v = i & ((1 << lg) - 1), pix = i >> lg;
      const int ri = div_by(pix, rcp_nc), ci = pix - ri * nc;
      if (v < nv)
        cp_async16(win + (size_t)pix * CS + v * V,
                   F + ((size_t)s_rows.list[ri] * W + s_cols.list[ci]) * C + c0 + v * V);
    }
    cp_async_wait_all();
    __syncthreads();
    // y-combine per (py, distinct column)
    for (int i = tid; i < (P * nc) << lg; i += kThreads) {
      const int v = i & ((1 << lg) - 1), q = i >> lg;
      const int py = div_by(q, rcp_nc), ci = q - py * nc;
      if (v >= nv) continue;
      const int* rmap = s_rows.map + py * NR;
      const float* w = s_wy + py * NR;
      float y[V];
#pragma unroll
      for (int e = 0; e < V; ++e) y[e] = 0.f;
      if (kPaired) {
        for (int r = 0; r < NR; r += 2) {
          float a[V], b[V];
#pragma unroll
          for (int e = 0; e < V; ++e) a[e] = b[e] = 0.f;
          add_px<T>(a, win, rmap[r], ci, nc, CS, v * V, w[r]);
          add_px<T>(b, win, rmap[r + 1], ci, nc, CS, v * V, w[r + 1]);
#pragma unroll
          for (int e = 0; e < V; ++e) y[e] = __fadd_rn(y[e], __fadd_rn(a[e], b[e]));
        }
      } else {
        for (int r = 0; r < NR; ++r) add_px<T>(y, win, rmap[r], ci, nc, CS, v * V, w[r]);
      }
      Vec<float>::store(Y + ((size_t)py * nc + ci) * CS + v * V, y);
      if (V == 8) Vec<float>::store(Y + ((size_t)py * nc + ci) * CS + v * V + 4, y + 4);
    }
    __syncthreads();
    // x-combine per output cell
    for (int i = tid; i < (P * P) << lg; i += kThreads) {
      const int v = i & ((1 << lg) - 1), q = i >> lg;
      const int py = div_by(q, rcp_p), px = q - py * P;
      if (v >= nv) continue;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int t = 0; t < NT; ++t) {
        const int ci = s_cols.map[px * NT + t];
        if (ci < 0) continue;
        const float w = s_wx[px * NT + t];
        const float* yv = Y + ((size_t)py * nc + ci) * CS + v * V;
        float y[V];
        Vec<float>::load(yv, y);
        if (V == 8) Vec<float>::load(yv + 4, y + 4);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(w, y[e]));
      }
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fmul_rn(acc[e], scale);
      Vec<T>::store(out + (((size_t)n * P + py) * P + px) * C + c0 + v * V, acc);
    }
    __syncthreads();
  }
}

// Shared memory a block needs for the largest window the shapes allow, at one
// 16-byte vector per pixel: (P*NR) x (P*NT) vectors and P x (P*NT) x V floats.
int window_bytes(int P, int NR, int NT, int V) {
  return P * NR * P * NT * 16 + P * P * NT * V * 4;
}

template <typename T, bool kPaired>
int launch_kernel(const Levels& lv, int B, int C, int P, int NR, int NT, int n, const int* lvl,
                  const int* xs, const float* inv, const int* rows, const float* wy,
                  const int* tcol, const float* wx, void* out, cudaStream_t s) {
  const int need = window_bytes(P, NR, NT, Vec<T>::N);
  if (need > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int bytes = need > kSmemBytes ? need : kSmemBytes;
  // with the static arrays a block is over 48 KB, which needs the opt-in
  const cudaError_t e = cudaFuncSetAttribute(roi_align_rows_kernel<T, kPaired>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n, (C / Vec<T>::N + kGroupVecs - 1) / kGroupVecs);
  roi_align_rows_kernel<T, kPaired><<<grid, kThreads, bytes, s>>>(
      lv, B, C, P, NR, NT, lvl, xs, inv, rows, wy, tcol, wx, static_cast<T*>(out), bytes);
  return (int)cudaGetLastError();
}

template <bool kPaired>
int launch(const void* const* level_ptrs, const int* heights, const int* widths, int L, int B,
           int C, int P, int NR, int NT, int n, const int* lvl, const int* xs, const float* inv,
           const int* rows, const float* wy, const int* tcol, const float* wx, void* out,
           int is_bf16, void* stream) {
  if (L < 1 || L > kMaxLevels || B < 1 || P < 1 || P > kMaxP || NR < 1 || NR > kMaxTaps ||
      NT < 1 || NT > kMaxTaps || (kPaired && NR % 2) || n < 1)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = i < L ? level_ptrs[i] : nullptr;
    lv.H[i] = i < L ? heights[i] : 0;
    lv.W[i] = i < L ? widths[i] : 0;
  }
  const int V = is_bf16 ? Vec<__nv_bfloat16>::N : Vec<float>::N;
  if (C < 1 || C % V) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_kernel<__nv_bfloat16, kPaired>(lv, B, C, P, NR, NT, n, lvl, xs, inv, rows, wy,
                                                 tcol, wx, out, s);
  return launch_kernel<float, kPaired>(lv, B, C, P, NR, NT, n, lvl, xs, inv, rows, wy, tcol, wx,
                                       out, s);
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
