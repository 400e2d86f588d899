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
//   grad_lvl(n)[rows[n,py,r], xs[n] + tcol[n,px,t], c]
//       += (wy[n,py,r] * wx[n,px,t]) * (inv[n] * gout[n,py,px,c])
// summed in float32 and written once in gout's dtype (the features' dtype) into
// per-level gradients (B*H_l, W_l, C). It skips exactly the taps K2 skips: a row
// outside the level, a column outside the level, a zero weight.
//
// What bounds it: bytes. Every gradient element is written once (untouched
// ones as zeros) and gout is read once; per element there are 2 flops for each
// term that reaches it, far below the ~295 flop/byte where arithmetic would
// become the limit. The TPU kernel gets race-freedom from its sequential grid;
// Hopper's blocks run in parallel in no order. So this kernel is the gather
// form: the owner of each gradient element computes it, with no float atomics,
// no zero-filled accumulators and no separate cast pass.
//   - box_ranges_kernel, one warp per box: the box's touched rectangle in its
//     level (rows of the level's B*H, columns) from its valid taps, and for each
//     (level, image) the range [lo, hi) of box indices whose rectangles reach
//     it (int atomicMax, whose result does not depend on order; the wrapper's
//     taps are image-major, so a range is one image's boxes);
//   - roi_align_paired_bwd_kernel, one block per tile of 4 rows x 32 columns
//     of one image of one level, across a slice of 32 x 16-byte channel
//     vectors. The block compacts the boxes of its (level, image) range whose
//     rectangle meets the tile into a shared list, in ascending box order
//     (warp ballots and prefix counts). Each warp owns one row of the tile,
//     8 columns at a time, with float32 sums in registers (8 pixels x 8 bf16 or
//     4 f32 channels per lane). For each listed box it ballots the box's row
//     taps that hit its row and the column taps that hit each of its columns
//     (with each tap's gout offset computed once per box, not per term), adds
//     their terms, and finally writes its pixels once in gout's dtype.
//
// Sum order, fixed: each element sums its terms in the order of the plain
// version on the CPU (roi_align_taps_plain_backward, index_add_ over boxes
// ascending, then (py, r, px, t) ascending), starting from +0, each term
// __fmul_rn(__fmul_rn(wy, wx), __fmul_rn(inv, g)) added with __fadd_rn. Skipped
// terms are those whose weight the plain version zeroes; they add a signed zero
// there, which changes no sum that starts at +0. So on finite inputs the float32
// sums equal the plain version's on the CPU bit for bit, two calls give the
// same bits, and the output is their round-to-nearest cast.
//
// Limits (the wrapper checks them): P <= 16, NR <= 8, NT <= 8, so a box has at
// most 128 row taps and 128 column taps (4 ballot words each).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libroi_align_bwd.so roi_align_bwd.cu
// (lvc_tpu_torch/ops/_build.py does this on first use.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxP = 16;
constexpr int kMaxTaps = 8;
constexpr int kMaxTapsPerBox = kMaxP * kMaxTaps;  // 128
constexpr int kWords = kMaxTapsPerBox / 32;
constexpr int kWarps = 4;                         // rows of a tile
constexpr int kThreads = kWarps * 32;
constexpr int kSeg = 8;                           // columns a warp sums at once
constexpr int kTileCols = 32;                     // 4 segments per warp
constexpr int kCap = 512;                         // boxes listed per scan

struct Levels {
  void* ptr[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  int tile_start[kMaxLevels + 1];  // first block of each level
};

template <typename T>
struct GVec;

template <>
struct GVec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw load_raw(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& a, float* v) {
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
struct GVec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load_raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const Raw& a, float* v) {
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

// acc += f * (scale * g) for the V channels of one gout vector, as the plain
// version multiplies: (wy * wx) * (inv * gout).
template <typename T>
__device__ __forceinline__ void add_term(float* acc, float f, float scale,
                                         const typename GVec<T>::Raw& raw) {
  float g[GVec<T>::N];
  GVec<T>::unpack(raw, g);
#pragma unroll
  for (int k = 0; k < GVec<T>::N; ++k)
    acc[k] = __fadd_rn(acc[k], __fmul_rn(f, __fmul_rn(scale, g[k])));
}

// One warp per box: its rectangle {r0, r1, c0, c1} of valid taps in its level
// (r0 = INT_MAX when it has none), and the (level, image) ranges it reaches:
// hi[l*B + b] = max(n + 1), lo_neg[l*B + b] = max(n_total - n), both zeroed first.
__global__ void box_ranges_kernel(Levels lv, int B, int P, int NR, int NT, int n_total,
                                  const int* __restrict__ lvl, const int* __restrict__ xs,
                                  const int* __restrict__ rows, const float* __restrict__ wy,
                                  const int* __restrict__ tcol, const float* __restrict__ wx,
                                  int4* __restrict__ rects, int* __restrict__ ranges) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= n_total) return;
  const int l = lvl[n];
  const bool lok = l >= 0 && l < kMaxLevels && lv.H[l] > 0;
  const int H = lok ? lv.H[l] : 1;
  const int W = lok ? lv.W[l] : 0;
  const int nrows = B * H;
  int r0 = INT_MAX, r1 = -1, c0 = INT_MAX, c1 = -1;
  for (int k = lane; k < P * NR; k += 32) {
    const int r = rows[(size_t)n * P * NR + k];
    if (wy[(size_t)n * P * NR + k] != 0.f && r >= 0 && r < nrows) {
      r0 = min(r0, r);
      r1 = max(r1, r);
    }
  }
  const int x0 = xs[n];
  for (int k = lane; k < P * NT; k += 32) {
    const int c = x0 + tcol[(size_t)n * P * NT + k];
    if (wx[(size_t)n * P * NT + k] != 0.f && c >= 0 && c < W) {
      c0 = min(c0, c);
      c1 = max(c1, c);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    r0 = min(r0, __shfl_xor_sync(0xffffffffu, r0, o));
    r1 = max(r1, __shfl_xor_sync(0xffffffffu, r1, o));
    c0 = min(c0, __shfl_xor_sync(0xffffffffu, c0, o));
    c1 = max(c1, __shfl_xor_sync(0xffffffffu, c1, o));
  }
  const bool empty = !lok || r1 < 0 || c1 < 0;
  if (lane == 0) rects[n] = empty ? make_int4(INT_MAX, -1, INT_MAX, -1) : make_int4(r0, r1, c0, c1);
  if (empty) return;
  for (int b = r0 / H + lane; b <= r1 / H; b += 32) {
    atomicMax(ranges + 2 * (l * B + b), n_total - n);
    atomicMax(ranges + 2 * (l * B + b) + 1, n + 1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) roi_align_paired_bwd_kernel(
    Levels lv, int B, int C, int P, int NR, int NT, int n_total, const int* __restrict__ lvl,
    const int* __restrict__ xs, const float* __restrict__ inv, const int* __restrict__ rows,
    const float* __restrict__ wy, const int* __restrict__ tcol, const float* __restrict__ wx,
    const T* __restrict__ gout, const int4* __restrict__ rects, const int* __restrict__ ranges) {
  constexpr int V = GVec<T>::N;
  __shared__ int s_ids[kCap];
  __shared__ int4 s_rects[kCap];
  __shared__ int s_wcount[kWarps];
  __shared__ float s_wy[kWarps][kMaxTapsPerBox];
  __shared__ float s_wx[kWarps][kMaxTapsPerBox];
  // gout offsets: py * P * C of each row tap, then px * C of each column tap
  __shared__ int s_goff[kWarps][2 * kMaxTapsPerBox];
  __shared__ unsigned s_rm[kWarps][kWords];
  __shared__ unsigned s_cm[kWarps][kWords];

  // block -> (level, image, tile row, tile column)
  int l = 0;
  while (l + 1 < kMaxLevels && (int)blockIdx.x >= lv.tile_start[l + 1]) ++l;
  const int H = lv.H[l], W = lv.W[l];
  const int tiles_y = (H + kWarps - 1) / kWarps, tiles_x = (W + kTileCols - 1) / kTileCols;
  int t = blockIdx.x - lv.tile_start[l];
  const int b = t / (tiles_y * tiles_x);
  t -= b * tiles_y * tiles_x;
  const int ty = t / tiles_x, tx = t - (t / tiles_x) * tiles_x;
  const int tile_r0 = b * H + ty * kWarps;
  const int tile_r1 = min(tile_r0 + kWarps, (b + 1) * H) - 1;
  const int tile_c0 = tx * kTileCols;
  const int tile_c1 = min(tile_c0 + kTileCols, W) - 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = tile_r0 + warp;
  const bool row_ok = row <= tile_r1;
  const int c = (blockIdx.y * 32 + lane) * V;
  const bool c_ok = c < C;
  T* G = static_cast<T*>(lv.ptr[l]);
  const int PNR = P * NR, PNT = P * NT;
  const int rwords = (PNR + 31) / 32, cwords = (PNT + 31) / 32;

  const int lo = n_total - ranges[2 * (l * B + b)];
  const int hi = ranges[2 * (l * B + b) + 1];

  // list the boxes of [start, end) (end - start <= kCap) whose rectangle
  // meets the tile, in ascending order; returns their count
  auto scan = [&](int start, int end) -> int {
    int total = 0;
    for (int base = start; base < end; base += kThreads) {
      const int i = base + tid;
      bool hit = false;
      int4 rc = make_int4(0, 0, 0, 0);
      if (i < end && lvl[i] == l) {
        rc = rects[i];
        hit = rc.x <= tile_r1 && rc.y >= tile_r0 && rc.z <= tile_c1 && rc.w >= tile_c0;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_wcount[warp] = __popc(m);
      __syncthreads();
      int off = total;
      for (int w = 0; w < warp; ++w) off += s_wcount[w];
      if (hit) {
        const int at = off + __popc(m & ((1u << lane) - 1u));
        s_ids[at] = i;
        s_rects[at] = rc;
      }
      for (int w = 0; w < kWarps; ++w) total += s_wcount[w];
      __syncthreads();
    }
    return total;
  };

  // add the terms of the listed boxes to this warp's pixels (row, x0 .. x0+7)
  auto gather = [&](int count, int x0, float (&acc)[kSeg][V]) {
    if (!row_ok) return;
    for (int i = 0; i < count; ++i) {
      const int4 rc = s_rects[i];
      if (row < rc.x || row > rc.y || x0 + kSeg - 1 < rc.z || x0 > rc.w) continue;
      const int n = s_ids[i];
      int cv[kWords];
      bool cvalid[kWords];
      bool any_r = false, any_c = false;
      const int xb = xs[n];
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const int k = w * 32 + lane;
        cvalid[w] = false;
        cv[w] = -1;
        if (w < rwords) {
          const float y = k < PNR ? wy[(size_t)n * PNR + k] : 0.f;
          const int r = k < PNR ? rows[(size_t)n * PNR + k] : -1;
          const unsigned m = __ballot_sync(0xffffffffu, y != 0.f && r == row);
          if (lane == 0) s_rm[warp][w] = m;
          s_wy[warp][k] = y;
          s_goff[warp][k] = (k / NR) * P * C;
          any_r |= m != 0u;
        }
        if (w < cwords) {
          const float x = k < PNT ? wx[(size_t)n * PNT + k] : 0.f;
          cv[w] = k < PNT ? xb + tcol[(size_t)n * PNT + k] : -1;
          cvalid[w] = x != 0.f && cv[w] >= x0 && cv[w] < x0 + kSeg && cv[w] < W;
          s_wx[warp][k] = x;
          s_goff[warp][kMaxTapsPerBox + k] = (k / NT) * C;
          any_c |= __ballot_sync(0xffffffffu, cvalid[w]) != 0u;
        }
      }
      __syncwarp();
      if (!any_r || !any_c) continue;
      const float scale = inv[n];
      const T* g_box = gout + (size_t)n * P * P * C + c;
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        bool any_j = false;
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          const unsigned m =
              w < cwords ? __ballot_sync(0xffffffffu, cvalid[w] && cv[w] == x0 + j) : 0u;
          if (lane == 0) s_cm[warp][w] = m;
          any_j |= m != 0u;
        }
        __syncwarp();
        if (!any_j) continue;
        // terms of pixel j: row taps (py, r) ascending, then column taps (px, t)
        for (int wr = 0; wr < rwords; ++wr) {
          for (unsigned mr = s_rm[warp][wr]; mr; mr &= mr - 1u) {
            const int kr = wr * 32 + __ffs(mr) - 1;
            const float fy = s_wy[warp][kr];
            const T* g_row = g_box + s_goff[warp][kr];
            for (int wc = 0; wc < cwords; ++wc) {
              for (unsigned mc = s_cm[warp][wc]; mc; mc &= mc - 1u) {
                const int kc = wc * 32 + __ffs(mc) - 1;
                if (c_ok)
                  add_term<T>(acc[j], __fmul_rn(fy, s_wx[warp][kc]), scale,
                              GVec<T>::load_raw(g_row + s_goff[warp][kMaxTapsPerBox + kc]));
              }
            }
          }
        }
        __syncwarp();
      }
    }
  };

  const bool single = hi - lo <= kCap;
  int count = 0;
  if (single && lo < hi) count = scan(lo, hi);
  for (int s = 0; s < kTileCols / kSeg; ++s) {
    const int x0 = tile_c0 + s * kSeg;
    float acc[kSeg][V];
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[j][k] = 0.f;
    if (x0 <= tile_c1) {
      if (single) {
        gather(count, x0, acc);
      } else {
        for (int start = lo; start < hi; start += kCap) {
          const int got = scan(start, min(start + kCap, hi));
          gather(got, x0, acc);
          __syncthreads();  // the list is rewritten by the next scan
        }
      }
    }
    if (row_ok && c_ok) {
#pragma unroll
      for (int j = 0; j < kSeg; ++j)
        if (x0 + j <= tile_c1) GVec<T>::store(G + ((size_t)row * W + x0 + j) * C + c, acc[j]);
    }
  }
}

}  // namespace

extern "C" {

// grad_ptrs[l]: (B*H_l, W_l, C) in gout's dtype, every element written;
// gout (n, P, P, C) bf16 if is_bf16, else f32; rects: n int4 of scratch;
// ranges: 2*L*B ints of scratch. Returns the first launch error (cudaError_t).
int roi_align_paired_bwd(void* const* grad_ptrs, const int* heights, const int* widths, int L,
                         int B, int C, int P, int NR, int NT, int n, const int* lvl, const int* xs,
                         const float* inv, const int* rows, const float* wy, const int* tcol,
                         const float* wx, const void* gout, int is_bf16, void* rects,
                         void* ranges, void* stream) {
  if (L < 1 || L > kMaxLevels || B < 1 || P < 1 || P > kMaxP || NR < 1 || NR > kMaxTaps ||
      NT < 1 || NT > kMaxTaps || n < 1)
    return (int)cudaErrorInvalidValue;
  const int V = is_bf16 ? GVec<__nv_bfloat16>::N : GVec<float>::N;
  if (C < 1 || C % V) return (int)cudaErrorInvalidValue;
  Levels lv;
  int tiles = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = i < L ? grad_ptrs[i] : nullptr;
    lv.H[i] = i < L ? heights[i] : 0;
    lv.W[i] = i < L ? widths[i] : 0;
    lv.tile_start[i] = tiles;
    if (i < L) {
      if (lv.H[i] < 1 || lv.W[i] < 1) return (int)cudaErrorInvalidValue;
      tiles += B * ((lv.H[i] + kWarps - 1) / kWarps) * ((lv.W[i] + kTileCols - 1) / kTileCols);
    }
  }
  lv.tile_start[kMaxLevels] = tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = (int)cudaMemsetAsync(ranges, 0, sizeof(int) * 2 * L * B, s);
  if (err) return err;
  box_ranges_kernel<<<(n + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      lv, B, P, NR, NT, n, lvl, xs, rows, wy, tcol, wx, static_cast<int4*>(rects),
      static_cast<int*>(ranges));
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid(tiles, (C / V + 31) / 32);
  if (is_bf16) {
    roi_align_paired_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        lv, B, C, P, NR, NT, n, lvl, xs, inv, rows, wy, tcol, wx,
        static_cast<const __nv_bfloat16*>(gout), static_cast<const int4*>(rects),
        static_cast<const int*>(ranges));
  } else {
    roi_align_paired_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        lv, B, C, P, NR, NT, n, lvl, xs, inv, rows, wy, tcol, wx, static_cast<const float*>(gout),
        static_cast<const int4*>(rects), static_cast<const int*>(ranges));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
