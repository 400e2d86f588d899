// Fused 1x1-conv GEMM for Hopper (sm_90a): out = relu((x @ w) * scale + shift
// + residual), the backbone's bottleneck tail (conv3 + folded FrozenBN +
// shortcut + ReLU) and the FPN lateral with its top-down add (scale 1, shift
// the conv bias, no ReLU).
//
// Replaces the TPU Pallas kernel lvc_tpu/ops/fused_matmul.py:76 (pallas_call of
// _kernel, :37, in matmul_affine_residual, :46). Semantics as _kernel's body:
// bf16 x (M, K) and w, the product accumulated in float32 on the tensor cores,
// the epilogue in float32 (a product by scale and two adds, each rounded as in
// the plain version: no FMA contraction), one cast to bf16. The weight is read
// as (N, K) with K contiguous, the layout of the port's conv weight
// (N, K, 1, 1), which is the column-major B operand that mma takes as it is.
//
// What bounds it: bytes. At the backbone's shapes (M = B*H*W from 8,736 to
// 559,104 rows, K from 64 to 1,024, N from 256 to 2,048) the function does 28
// to 222 flop per byte of x, w, residual and out, under the card's 295 in
// bf16, so the least time is those bytes over 3.35 TB/s. The point of the
// kernel is that the (M, N) product never goes to device memory before its
// epilogue: the unfused tail (conv, then FrozenBN's multiply and add, the
// residual add and the ReLU as separate passes) writes and reads it again
// four times. Its design, a simple right one:
//   - one block of 256 threads (8 warps, 2 x 4, each 64 x 32 outputs) per
//     128 x 128 output tile, on a 1-D grid with the N tiles of one M tile
//     adjacent, so the blocks that share an x tile run together and read it
//     from L2;
//   - K in steps of 32 through double-buffered cp.async (16-byte chunks) into
//     shared memory, rows padded to 80 bytes so ldmatrix is free of bank
//     conflicts; the ragged edge of M (and any K or N tail) is zero-filled;
//   - mma.sync m16n8k16 bf16 with float32 accumulators in registers;
//   - the epilogue on the whole tile: the float32 accumulators staged in the
//     freed shared memory, then each thread takes 8 consecutive columns of a
//     row, reads the residual's 16 bytes once, applies scale, shift, residual
//     and ReLU in float32 and stores 16 bytes of bf16; rows past M are masked.
// wgmma, TMA and a persistent grid that overlaps one tile's epilogue with the
// next tile's loads are later work. CUDA rather than Triton: the port's kernels
// are all CUDA built by lvc_tpu_torch/ops/_build.py.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_matmul.so fused_matmul.cu
// (lvc_tpu_torch/ops/_build.py does this on first use.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;                 // output rows per block
constexpr int kBN = 128;                 // output columns per block
constexpr int kBK = 32;                  // K per pipeline stage
constexpr int kThreads = 256;            // 8 warps: 2 along M x 4 along N
constexpr int kLds = kBK + 8;            // shared row stride in bf16: 80 bytes
constexpr int kStage = (kBM + kBN) * kLds;
constexpr int kMainBytes = 2 * kStage * (int)sizeof(bf16);
constexpr int kLdc = kBN + 8;            // staged float32 row stride
constexpr int kEpiBytes = kBM * kLdc * (int)sizeof(float);
constexpr int kSmemBytes = kMainBytes > kEpiBytes ? kMainBytes : kEpiBytes;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One stage: the 128 x 32 slices of x (rows m0..) and of w (rows n0.. of the
// (N, K) weight) at k0, 16 bytes per cp.async, two chunks per thread each.
__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB, const bf16* __restrict__ x,
                                           const bf16* __restrict__ w, int M, int N, int K,
                                           int m0, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;  // 128 rows x 4 chunks of 8
    const int r = c >> 2, kc = (c & 3) * 8;
    const int gk = k0 + kc;
    const bool in_k = gk < K;
    const bool ok_a = in_k && m0 + r < M;
    cp_async16(sA + r * kLds + kc, ok_a ? x + (long long)(m0 + r) * K + gk : x, ok_a);
    const bool ok_b = in_k && n0 + r < N;
    cp_async16(sB + r * kLds + kc, ok_b ? w + (long long)(n0 + r) * K + gk : w, ok_b);
  }
}

__global__ void __launch_bounds__(kThreads)
matmul_affine_residual_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                              const float* __restrict__ scale, const float* __restrict__ shift,
                              const bf16* __restrict__ res, bf16* __restrict__ out,
                              int M, int N, int K, int tiles_n, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_scale[kBN], s_shift[kBN];
  bf16* buf = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = (blockIdx.x % tiles_n) * kBN;
  const int m0 = (blockIdx.x / tiles_n) * kBM;
  if (tid < kBN) {
    const int gn = n0 + tid;
    s_scale[tid] = gn < N ? scale[gn] : 0.f;
    s_shift[tid] = gn < N ? shift[gn] : 0.f;
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int steps = (K + kBK - 1) / kBK;
  load_stage(buf, buf + kBM * kLds, x, w, M, N, K, m0, n0, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < steps; ++kt) {
    const bf16* sA = buf + (kt & 1) * kStage;
    const bf16* sB = sA + kBM * kLds;
    if (kt + 1 < steps) {
      bf16* nA = buf + ((kt + 1) & 1) * kStage;
      load_stage(nA, nA + kBM * kLds, x, w, M, N, K, m0, n0, (kt + 1) * kBK, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // matrices: rows 0-7 / 8-15 of the m16 tile at k 0-7, then at k 8-15
        const int r = wm * 64 + mi * 16 + (lane & 15);
        ldmatrix_x4(a[mi], sA + r * kLds + ks + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: n 0-7 at k 0-7, n 0-7 at k 8-15, n 8-15 at k 0-7, n 8-15 at k 8-15
        const int r = wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t t[4];
        ldmatrix_x4(t, sB + r * kLds + ks + ((lane >> 3) & 1) * 8);
        b[2 * nj][0] = t[0];
        b[2 * nj][1] = t[1];
        b[2 * nj + 1][0] = t[2];
        b[2 * nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();  // the stage is free for the load two steps on
  }

  // stage the float32 product tile in the freed shared memory
  float* sC = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm * 64 + mi * 16 + g, c = wn * 32 + ni * 8 + q * 2;
      *reinterpret_cast<float2*>(sC + r * kLdc + c) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(sC + (r + 8) * kLdc + c) = make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();

  // epilogue: 8 consecutive columns of one row per step, 16-byte accesses
#pragma unroll 2
  for (int i = 0; i < kBM * kBN / 8 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 4, cc = (c & 15) * 8;
    const int gm = m0 + r, gn = n0 + cc;
    if (gm >= M || gn >= N) continue;
    const long long off = (long long)gm * N + gn;
    const uint4 rv = __ldcs(reinterpret_cast<const uint4*>(res + off));
    const bf16* rh = reinterpret_cast<const bf16*>(&rv);
    const float4 p0 = *reinterpret_cast<const float4*>(sC + r * kLdc + cc);
    const float4 p1 = *reinterpret_cast<const float4*>(sC + r * kLdc + cc + 4);
    const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    uint4 ov;
    bf16* oh = reinterpret_cast<bf16*>(&ov);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float y = __fadd_rn(__fadd_rn(__fmul_rn(p[e], s_scale[cc + e]), s_shift[cc + e]),
                          __bfloat162float(rh[e]));
      if (relu) y = fmaxf(y, 0.f);
      oh[e] = __float2bfloat16_rn(y);
    }
    *reinterpret_cast<uint4*>(out + off) = ov;
  }
}

}  // namespace

// x: (M, K) bf16, w: (N, K) bf16 (the weight transposed, K contiguous),
// scale, shift: (N,) float32, res, out: (M, N) bf16; all contiguous and
// 16-byte aligned, K and N multiples of 8. Launches on `stream`, allocates
// nothing, and returns the launch's cudaError_t (cudaErrorInvalidValue for
// shapes the kernel does not take).
extern "C" int matmul_affine_residual(const void* x, const void* w, const void* scale,
                                      const void* shift, const void* res, void* out, int M,
                                      int N, int K, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8) return (int)cudaErrorInvalidValue;
  const long long tiles_n = (N + kBN - 1) / kBN;
  const long long tiles = tiles_n * ((M + kBM - 1) / kBM);
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory needs the opt-in, once per process
  // (a race between two first callers sets the same value twice)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_affine_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  matmul_affine_residual_kernel<<<(unsigned)tiles, kThreads, kSmemBytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const bf16*>(res), static_cast<bf16*>(out), M,
      N, K, (int)tiles_n, relu);
  return (int)cudaGetLastError();
}
