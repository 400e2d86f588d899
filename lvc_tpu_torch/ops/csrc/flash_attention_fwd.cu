// Flash attention forward for Hopper (sm_90a): softmax(q k^T * scale) v for
// every (batch, head), the DINO verifier's attention.
//
// Replaces the TPU Pallas kernel that lvc_tpu/modeling/backbone/vit.py:80 calls
// through _flash_mha (:33): jax.experimental.pallas.ops.tpu.flash_attention,
// run there as one full-sequence block per (batch, head) on q, k, v padded from
// N to a multiple of 128, with the pad keys masked by SegmentIds. Here nothing
// is padded or relaid: the kernel reads q, k and v in place from the qkv
// Linear's output viewed as (B, N, 3, H, d) through its strides, masks keys at
// index >= N by length, computes no query row >= N, and writes (B, N, H*d)
// directly (the transpose, pad and slice around the TPU kernel, vit.py:58-88).
//
// Semantics, per query row, as the TPU kernel's body: s = (q . k in float32) *
// scale; online softmax with a float32 running max m, sum l and accumulator;
// p = exp(s - m) summed into l unrounded and cast to the input dtype before it
// multiplies v (the TPU kernel's p.astype(v.dtype)); out = acc / l cast to the
// input dtype. Inputs and output are float32 or bf16; all arithmetic is float32.
//
// What bounds it: operations. At (B, N, H, d) = (64, 785, 6, 64) the function
// needs 4*B*H*N^2*d = 60.6 GFLOP against 154 MB (bf16) of q, k, v and out,
// about 390 flop/byte. This first kernel does them as float32 FMAs outside the
// tensor cores (67 TFLOP/s peak), so it cannot come near the bf16 tensor-core
// bound; mma/wgmma are the next step. Its design:
//   - one block of 128 threads per (64-row query tile, batch * head); two
//     threads per query row, each holding half the row's q and accumulator in
//     registers (interleaved 16-byte chunks, so the pair reads neighbouring
//     banks) and joining the two halves of each dot product with one shuffle;
//   - K and V staged in shared memory as float32, 64 keys per tile; every
//     thread of a warp reads the same key row, so the reads are broadcasts;
//   - the running max is updated once per 16 keys, which bounds the registers
//     for s to 16 and rescales the accumulator once per 16 keys.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu
// (lvc_tpu_torch/ops/_build.py does this on first use.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;              // head dim
constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per shared-memory tile
constexpr int kChunk = 16;          // keys per online-softmax update
constexpr int kThreads = 2 * kBQ;   // two threads per query row
constexpr int kMine = kD / 4 / 2;   // 16-byte chunks of a row that one thread owns

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load4(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  static __device__ __forceinline__ void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
    const float2 f0 = __bfloat1622float2(h[0]);
    const float2 f1 = __bfloat1622float2(h[1]);
    v[0] = f0.x;
    v[1] = f0.y;
    v[2] = f1.x;
    v[3] = f1.y;
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
    uint2 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = a;
  }
  // p cast to the input dtype before P.V, as the TPU kernel does
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, long long sb, long long sn,
                           long long sh, int N, int H, float scale,
                           T* __restrict__ out) {
  __shared__ __align__(16) float ks[kBK][kD];
  __shared__ __align__(16) float vs[kBK][kD];

  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int qi = blockIdx.x * kBQ + row;
  const bool valid = qi < N;
  const long long head = (long long)b * sb + (long long)h * sh;

  // this thread's chunks of the row: chunk c = 2 * i + half holds d in [4c, 4c + 4)
  float qr[4 * kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    if (valid) {
      Io<T>::load4(q + head + (long long)qi * sn + 4 * (2 * i + half), &qr[4 * i]);
    } else {
      qr[4 * i] = qr[4 * i + 1] = qr[4 * i + 2] = qr[4 * i + 3] = 0.f;
    }
  }
  float acc[4 * kMine];
#pragma unroll
  for (int i = 0; i < 4 * kMine; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBK) {
    const int nk = min(kBK, N - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * kD / 4; idx += kThreads) {
      const int j = idx / (kD / 4);
      const int c = 4 * (idx % (kD / 4));
      float kv[4] = {0.f, 0.f, 0.f, 0.f};
      float vv[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nk) {
        const long long off = head + (long long)(k0 + j) * sn + c;
        Io<T>::load4(k + off, kv);
        Io<T>::load4(v + off, vv);
      }
      *reinterpret_cast<float4*>(&ks[j][c]) = make_float4(kv[0], kv[1], kv[2], kv[3]);
      *reinterpret_cast<float4*>(&vs[j][c]) = make_float4(vv[0], vv[1], vv[2], vv[3]);
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = ks[j0 + jj];
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + 4 * (2 * i + half));
          part = fmaf(qr[4 * i], kk.x, part);
          part = fmaf(qr[4 * i + 1], kk.y, part);
          part = fmaf(qr[4 * i + 2], kk.z, part);
          part = fmaf(qr[4 * i + 3], kk.w, part);
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        // keys at index >= N are masked by length (their staged rows are 0)
        s[jj] = (j0 + jj < nk) ? part * scale : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      // key j0 < nk is real, so m_new is finite; alpha is 0 on the first update
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < 4 * kMine; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float pr = Io<T>::round(p);
        const float* vr = vs[j0 + jj];
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * (2 * i + half));
          acc[4 * i] = fmaf(pr, vv.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(pr, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(pr, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(pr, vv.w, acc[4 * i + 3]);
        }
      }
      m = m_new;
    }
  }

  if (valid) {
    T* o = out + ((long long)b * N + qi) * (long long)(H * kD) + h * kD;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = acc[4 * i + e] / l;
      Io<T>::store4(o + 4 * (2 * i + half), r);
    }
  }
}

}  // namespace

// q, k, v: element pointers of the (B, N, H, d) slices of one (B, N, 3, H, d)
// tensor, sharing the element strides sb (batch), sn (token) and sh (head); d
// is contiguous. out: contiguous (B, N, H * d). Returns the launch's
// cudaError_t; cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   long long sb, long long sn, long long sh,
                                   int B, int N, int H, int d, float scale,
                                   void* out, int is_bf16, void* stream) {
  if (d != kD || N <= 0 || B <= 0 || H <= 0 || (long long)B * H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kBQ - 1) / kBQ, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    flash_attention_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), sb, sn, sh, N, H, scale,
        static_cast<__nv_bfloat16*>(out));
  } else {
    flash_attention_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), sb, sn, sh, N, H, scale,
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
