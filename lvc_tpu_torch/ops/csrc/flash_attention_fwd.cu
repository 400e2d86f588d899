// Flash attention forward for Hopper (sm_90a): softmax(q k^T * scale) v for
// every (batch, head), the DINO verifier's attention.
//
// Replaces the TPU Pallas kernel that lvc_tpu/modeling/backbone/vit.py:80 calls
// through _flash_mha (:33): jax.experimental.pallas.ops.tpu.flash_attention,
// run there as one full-sequence block per (batch, head) on q, k, v padded from
// N to a multiple of 128, with the pad keys masked by SegmentIds. Here nothing
// is padded or relaid: the kernel reads q, k and v in place from the qkv
// Linear's output viewed as (B, N, 3, H, d) through its strides, masks keys at
// index >= N by length, writes no query row >= N, and writes (B, N, H*d)
// directly (the transpose, pad and slice around the TPU kernel, vit.py:58-88).
//
// Semantics, per query row, as the TPU kernel's body: s = (q . k in float32) *
// scale; online softmax with a float32 running max m, sum l and accumulator;
// p = exp(s - m) summed into l unrounded and cast to the input dtype before it
// multiplies v (the TPU kernel's p.astype(v.dtype)); out = acc / l cast to the
// input dtype. Inputs and output are float32 or bf16; the softmax is float32.
//
// What bounds it: operations. At (B, N, H, d) = (64, 785, 6, 64) the function
// needs 4*B*H*N^2*d = 60.6 GFLOP against 154 MB (bf16) of q, k, v and out,
// about 390 flop/byte, above the card's balance point. So both products run on
// the tensor cores, in the FlashAttention-2 layout:
//   - one block of 4 warps per (64-query tile, batch * head); each warp owns 16
//     query rows and keeps their q fragments in registers for the whole row
//     (8 warps on 128-query tiles measured slower on the H100 in both dtypes:
//     at N = 785 the ragged last tile wastes 47 rows, not 111);
//   - K and V tiles of 64 keys go through cp.async (16-byte chunks, zero-filled
//     past N) into double-buffered shared memory, so the next tile loads while
//     this one is computed (waiting for V apart from K measured slower);
//   - S = Q K^T and O += P V are mma.sync products into float32 registers; the
//     row max and row sum are reduced across the four threads of a row with
//     shuffles; exp(m_old - m_new) rescales O (0 on the first tile, where m_old
//     is -inf); log2(e) is folded into the scale, so p = exp2(s - m).
// bf16: mma.sync m16n8k16. K and V rows are 128 bytes, stored with the 16-byte
// chunks XOR-swizzled by row, so ldmatrix (K) and ldmatrix.trans (V) are free
// of bank conflicts. The m16n8 float32 accumulator of S is, element for
// element, the m16k16 A fragment of P, so P is rounded to bf16 in registers.
// float32: a single TF32 pass keeps 11 bits of each operand, and logits of up
// to 33 (the peaked test input) would then miss the 1e-5 tolerance by orders
// of magnitude. So each operand is split as big = tf32(a) plus small =
// tf32(a - big), and each product is big.big + big.small + small.big on
// mma.sync m16n8k8 tf32 (the "3xTF32" split; the dropped small.small is below
// 2^-22 of the product). P is split too: in float32 it is not rounded. The
// tensor cores truncate their float32 sums, so S is summed one 8-deep step at a
// time into a fresh accumulator and added to s in IEEE float32, and each key
// tile's P V goes into a fresh accumulator merged as O = O * alpha + tile. The
// k index of the m16n8k8 fragments is permuted (a sum does not care about its
// order) so that a thread's two K values are adjacent (one 8-byte load) and its
// P fragment is its own S accumulator. K rows are padded to 72 floats and V
// rows to 68, which makes those fragment loads free of bank conflicts. The
// other route, register-tiled float32 FMAs, is bounded by 67 TFLOP/s; three
// TF32 passes at 495 are bounded by 165.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu
// (lvc_tpu_torch/ops/_build.py does this on first use.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 64;                // head dim
constexpr int kWarps = 4;             // 16 query rows each
constexpr int kBQ = 16 * kWarps;      // query rows per block
constexpr int kBK = 64;               // keys per shared-memory tile
constexpr int kThreads = 32 * kWarps;
constexpr int kLdK = kD + 8;          // float32 K row stride (floats)
constexpr int kLdV = kD + 4;          // float32 V row stride (floats)
constexpr int kF32Smem = 2 * kBK * (kLdK + kLdV) * (int)sizeof(float);
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- bf16 ----

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// element offset of (row, 16-byte chunk) in a 64-wide bf16 tile whose chunks
// are XOR-swizzled by row
__device__ __forceinline__ int swz(int row, int chunk) { return row * kD + ((chunk ^ (row & 7)) << 3); }

// rows [r0, r0 + kRows) of one (batch, head) slice into a swizzled tile; rows
// >= N are zero-filled
template <int kRows>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src, long long sn,
                                               int r0, int N, int tid) {
#pragma unroll
  for (int i = 0; i < kRows * kD / 8 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3, ch = c & 7;
    const bool ok = r0 + r < N;
    cp_async16(dst + swz(r, ch), ok ? src + (long long)(r0 + r) * sn + ch * 8 : src, ok);
  }
}

// The online-softmax step shared by both dtypes: s (16 x 64 per warp, m16n8
// accumulator layout: s[j][0..1] row g, s[j][2..3] row g + 8, keys 8j + 2t,
// 8j + 2t + 1) in the log2 domain -> p in place; returns alpha for both rows.
__device__ __forceinline__ void softmax_step(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // every key tile holds a key < N, so m_new is finite; alpha is 0 on the
    // first tile, where m is -inf
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][2 * r] = exp2f(s[j][2 * r] - m_new);
      s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_new);
      sum += s[j][2 * r] + s[j][2 * r + 1];
    }
    l[r] = l[r] * alpha[r] + sum;  // this thread's share; the quad is summed at the end
  }
}

// scale, and mask keys >= N to -inf before the max (only the last tile has any)
__device__ __forceinline__ void scale_mask(float (&s)[8][4], int k0, int N, float scale_log2, int t) {
  if (k0 + kBK <= N) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        s[j][e] = key < N ? s[j][e] * scale_log2 : -INFINITY;
      }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, long long sb, long long sn,
                                long long sh, int N, int H, float scale_log2,
                                bf16* __restrict__ out) {
  __shared__ __align__(128) bf16 sq[kBQ * kD];
  __shared__ __align__(128) bf16 sk[2][kBK * kD];
  __shared__ __align__(128) bf16 sv[2][kBK * kD];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const long long head = (long long)b * sb + (long long)h * sh;
  const bf16* qh = q + head;
  const bf16* kh = k + head;
  const bf16* vh = v + head;

  load_tile_bf16<kBQ>(sq, qh, sn, q0, N, tid);
  load_tile_bf16<kBK>(sk[0], kh, sn, 0, N, tid);
  load_tile_bf16<kBK>(sv[0], vh, sn, 0, N, tid);
  cp_async_commit();

  uint32_t qf[4][4];  // the warp's 16 x 64 q as four m16k16 A fragments
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int tiles = (N + kBK - 1) / kBK;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed, and every warp is done with tile it - 1
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int r = warp * 16 + (lane & 15);
        ldmatrix_x4(qf[kk], sq + swz(r, 2 * kk + (lane >> 4)));
      }
    }
    if (it + 1 < tiles) {
      load_tile_bf16<kBK>(sk[(it + 1) & 1], kh, sn, (it + 1) * kBK, N, tid);
      load_tile_bf16<kBK>(sv[(it + 1) & 1], vh, sn, (it + 1) * kBK, N, tid);
      cp_async_commit();
    }
    const bf16* ks = sk[it & 1];
    const bf16* vs = sv[it & 1];

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // matrices: keys 0-7 at d 0-7, keys 0-7 at d 8-15, keys 8-15 at d 0-7, keys 8-15 at d 8-15
        uint32_t kb[4];
        const int r = nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(kb, ks + swz(r, 2 * kk + ((lane >> 3) & 1)));
        mma_bf16(s[2 * nj], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * nj + 1], qf[kk], kb[2], kb[3]);
      }
    scale_mask(s, it * kBK, N, scale_log2, t);
    float alpha[2];
    softmax_step(s, m, l, alpha);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // P's m16k16 A fragment is S's accumulator, cast to bf16 (the TPU
      // kernel's p.astype(v.dtype))
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        // matrices: keys 0-7 at d 0-7, keys 8-15 at d 0-7, keys 0-7 at d 8-15, keys 8-15 at d 8-15
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + swz(kk * 16 + (lane & 15), 2 * nn + (lane >> 4)));
        mma_bf16(o[2 * nn], pa, vb[0], vb[1]);
        mma_bf16(o[2 * nn + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= N) continue;
    bf16* orow = out + ((long long)b * N + qi) * (long long)(H * kD) + h * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
          pack_bf16(o[j][2 * r] / l[r], o[j][2 * r + 1] / l[r]);
    }
  }
}

// ------------------------------------------------------------- float32 ----

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in three TF32 passes, the small terms first
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* ab, const uint32_t* as,
                                           uint32_t bb0, uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* __restrict__ src,
                                              long long sn, int r0, int N, int tid) {
#pragma unroll
  for (int i = 0; i < kBK * kD / 4 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 4, ch = c & 15;
    const bool ok = r0 + r < N;
    cp_async16(dst + r * ld + ch * 4, ok ? src + (long long)(r0 + r) * sn + ch * 4 : src, ok);
  }
}

// The m16n8k8 fragments with their k index permuted within each 8-deep step:
// fragment k = t stands for element 2t, k = t + 4 for element 2t + 1. So for
// S a thread's A values (q) and B values (K) are adjacent pairs, and for P V
// its A values are its own S accumulator (keys 8j + 2t, 8j + 2t + 1) and its
// B values are V at those two keys.
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, long long sb, long long sn,
                               long long sh, int N, int H, float scale_log2,
                               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;                   // [2][kBK][kLdK]
  float* sv = smem + 2 * kBK * kLdK;  // [2][kBK][kLdV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * kBQ;
  const long long head = (long long)b * sb + (long long)h * sh;
  const float* kh = k + head;
  const float* vh = v + head;

  load_tile_f32(sk, kLdK, kh, sn, 0, N, tid);
  load_tile_f32(sv, kLdV, vh, sn, 0, N, tid);
  cp_async_commit();

  // q as eight m16k8 A fragments, split: a0 row g, a1 row g + 8 (elements
  // 8kk + 2t), a2 row g, a3 row g + 8 (elements 8kk + 2t + 1); rows >= N are 0
  uint32_t qb[8][4], qs[8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    const float* qrow = q + head + (long long)qi * sn;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float2 x = qi < N ? __ldg(reinterpret_cast<const float2*>(qrow + 8 * kk + 2 * t))
                              : make_float2(0.f, 0.f);
      split(x.x, qb[kk][r], qs[kk][r]);
      split(x.y, qb[kk][2 + r], qs[kk][2 + r]);
    }
  }
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int tiles = (N + kBK - 1) / kBK;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile it has landed, and every warp is done with tile it - 1
    if (it + 1 < tiles) {
      load_tile_f32(sk + ((it + 1) & 1) * kBK * kLdK, kLdK, kh, sn, (it + 1) * kBK, N, tid);
      load_tile_f32(sv + ((it + 1) & 1) * kBK * kLdV, kLdV, vh, sn, (it + 1) * kBK, N, tid);
      cp_async_commit();
    }
    const float* ks = sk + (it & 1) * kBK * kLdK;
    const float* vs = sv + (it & 1) * kBK * kLdV;

    // S: each 8-deep step into a fresh accumulator, added to s in float32
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const float* krow = ks + (8 * j + g) * kLdK + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float2 kv = *reinterpret_cast<const float2*>(krow + 8 * kk);
        uint32_t bb0, bb1, bs0, bs1;
        split(kv.x, bb0, bs0);
        split(kv.y, bb1, bs1);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(acc, qb[kk], qs[kk], bb0, bb1, bs0, bs1);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += acc[e];
      }
    }
    scale_mask(s, it * kBK, N, scale_log2, t);
    float alpha[2];
    softmax_step(s, m, l, alpha);

    // this tile's P V into a fresh accumulator, merged as O = O * alpha + tile
    float pv[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t pb[4], ps[4];
      split(s[kk][0], pb[0], ps[0]);  // row g, key 8kk + 2t
      split(s[kk][2], pb[1], ps[1]);  // row g + 8, key 8kk + 2t
      split(s[kk][1], pb[2], ps[2]);  // row g, key 8kk + 2t + 1
      split(s[kk][3], pb[3], ps[3]);  // row g + 8, key 8kk + 2t + 1
      const float* v0 = vs + (8 * kk + 2 * t) * kLdV + g;
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        uint32_t bb0, bb1, bs0, bs1;
        split(v0[8 * nn], bb0, bs0);
        split(v0[kLdV + 8 * nn], bb1, bs1);
        mma_3xtf32(pv[nn], pb, ps, bb0, bb1, bs0, bs1);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[j][0] = fmaf(o[j][0], alpha[0], pv[j][0]);
      o[j][1] = fmaf(o[j][1], alpha[0], pv[j][1]);
      o[j][2] = fmaf(o[j][2], alpha[1], pv[j][2]);
      o[j][3] = fmaf(o[j][3], alpha[1], pv[j][3]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= N) continue;
    float* orow = out + ((long long)b * N + qi) * (long long)(H * kD) + h * kD;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
          make_float2(o[j][2 * r] / l[r], o[j][2 * r + 1] / l[r]);
    }
  }
}

}  // namespace

// q, k, v: element pointers of the (B, N, H, d) slices of one (B, N, 3, H, d)
// tensor, sharing the element strides sb (batch), sn (token) and sh (head); d
// is contiguous; every stride and pointer a multiple of 16 bytes. out:
// contiguous (B, N, H * d). Launches on `stream`, allocates nothing, and
// returns the launch's cudaError_t; cudaErrorInvalidValue for shapes the
// kernel does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   long long sb, long long sn, long long sh,
                                   int B, int N, int H, int d, float scale,
                                   void* out, int is_bf16, void* stream) {
  if (d != kD || N <= 0 || B <= 0 || H <= 0 || (long long)B * H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kBQ - 1) / kBQ, B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  if (is_bf16) {
    flash_attention_fwd_kernel_bf16<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), sb,
        sn, sh, N, H, scale_log2, static_cast<bf16*>(out));
  } else {
    // above 48 KB of dynamic shared memory needs the opt-in, once per process
    // (a race between two first callers sets the same value twice)
    static bool opted_in = false;
    if (!opted_in) {
      const cudaError_t e = cudaFuncSetAttribute(
          flash_attention_fwd_kernel_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
      if (e != cudaSuccess) return (int)e;
      opted_in = true;
    }
    flash_attention_fwd_kernel_f32<<<grid, kThreads, kF32Smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        sb, sn, sh, N, H, scale_log2, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
