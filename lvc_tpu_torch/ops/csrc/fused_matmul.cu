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
// (N, K, 1, 1), which is the K-major B operand that wgmma takes as it is.
//
// What bounds it: bytes. At the backbone's shapes (M = B*H*W from 8,736 to
// 559,104 rows, K from 64 to 1,024, N from 256 to 2,048) the function does 28
// to 222 flop per byte of x, w, residual and out, under the card's 295 in
// bf16, so the least time is those bytes over 3.35 TB/s, and the kernel's job
// is to keep device memory busy: the (M, N) product never goes to device
// memory before its epilogue, and loads are in flight at every moment. Where
// K is large, the x and w tiles that every output tile reads again from L2
// weigh more than device memory: at res4, res5 and the p4 lateral the bytes
// moved from L2 into the SMs are 2-3 times the function's bytes. Its design:
//   - a persistent grid, one block per SM, walks 128 x 256 output tiles with
//     the N tiles of one M tile adjacent, so the blocks that share an x tile
//     run together and read it from L2; the 256-wide N tile reads x half as
//     often as a 128-wide one;
//   - warp specialization: one producer thread issues TMA loads of 128 x 64 x
//     and 256 x 64 w tiles (128-byte swizzle, zero-filled past M, N and K) into
//     a ring of 3 stages completed through mbarriers, and runs ahead across
//     tiles; two consumer warpgroups, 64 rows each, run wgmma m64n256k16 bf16
//     -> float32 from the ring;
//   - the residual tile is loaded by TMA once the tile's first stages are in
//     flight, so it lands while the main loop runs; the epilogue reads it from
//     shared memory (swizzled, so free of bank conflicts), applies scale,
//     shift, residual and ReLU to the accumulator registers, writes bf16 back
//     over the residual, and one thread stores the tile by TMA (clipped at M
//     and N), while the producer already loads the next tile's stages.
// One producer warp and 232 registers for each consumer thread (setmaxnreg);
// 3 stages of 48 KB and 64 KB of residual take 208 KB of shared memory. Two
// variants measured slower on the H100 at all seven shapes: two stages with a
// double-buffered residual (224 KB), and clusters of two blocks on adjacent M
// tiles that each load half of the common w tile and multicast it to both
// (half the w traffic from L2, but each stage waits for both blocks). The
// four tensor maps are encoded on the host at every call, through the driver
// entry point that the runtime hands out (no -lcuda).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_matmul.so fused_matmul.cu
// (lvc_tpu_torch/ops/_build.py does this on first use.)

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;                        // output rows per tile
constexpr int kBN = 256;                        // output columns per tile
constexpr int kBK = 64;                         // K per stage: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kConsumers = 2;                   // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kBK * 2;          // 16 KB
constexpr int kBBytes = kBN * kBK * 2;          // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBox = 64;                        // residual and out boxes: 64 x 64
constexpr int kBoxBytes = kBox * kBox * 2;      // 8 KB
constexpr int kResBytes = 64 * kBN * 2;         // one consumer's 64 x 256 residual
constexpr int kBarOffset = kStages * kStageBytes + kConsumers * kResBytes;
constexpr int kSmemBytes = kBarOffset + 8 * (2 * kStages + 2 * kConsumers) + 1024;  // + alignment

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows in the
// 128-byte swizzle (8-row groups 1,024 bytes apart; the tile 1,024-aligned)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (+)= a . b, a 64 x 16 and b 256 x 16 (both K-major) from shared memory
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kThreads, 1)
matmul_affine_residual_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                              const __grid_constant__ CUtensorMap tres, const __grid_constant__ CUtensorMap tout,
                              const float* __restrict__ scale, const float* __restrict__ shift, int N, int K,
                              int tiles_n, int tiles, int relu) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the tiles to it
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t bars = base + kBarOffset;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  // consumer c's residual buffer, and its barriers
  auto res_buf = [&](int c) { return base + kStages * kStageBytes + c * kResBytes; };
  auto res_full = [&](int c) { return bars + 8 * (2 * kStages + c); };
  auto res_empty = [&](int c) { return bars + 8 * (2 * kStages + kConsumers + c); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    for (int c = 0; c < kConsumers; ++c) {
      mbar_init(res_full(c), 1);
      mbar_init(res_empty(c), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = (K + kBK - 1) / kBK;
  if (tid >= 128 * kConsumers) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * kConsumers) {
      int stage = 0;
      uint32_t phase = 0, res_phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), kStageBytes);
          const uint32_t a = base + stage * kStageBytes;
          tma_load(a, &tx, full(stage), kb * kBK, m0);
          tma_load(a + kABytes, &tw, full(stage), kb * kBK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
          // the residual once the tile's first stages are in flight (it waits
          // for the previous tile's epilogue to free its buffer)
          if (kb == (nk < kStages ? nk : kStages) - 1) {
            for (int c = 0; c < kConsumers; ++c) {
              mbar_wait(res_empty(c), res_phase ^ 1);
              mbar_expect_tx(res_full(c), kResBytes);
              for (int box = 0; box < kBN / kBox; ++box) {
                tma_load(res_buf(c) + box * kBoxBytes, &tres, res_full(c), n0 + box * kBox, m0 + 64 * c);
              }
            }
            res_phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows of the tile each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = tid >> 7;
    const int wl = (tid & 127) >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t res = res_buf(c);
    unsigned char* res_ptr = smem + (res - base);
    int stage = 0;
    uint32_t phase = 0, res_phase = 0;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;  // each tile's first wgmma overwrites it
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full(stage), phase);
        const uint32_t a = base + stage * kStageBytes + c * (64 * kBK * 2);
        const uint32_t b = base + stage * kStageBytes + kABytes;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int k16 = 0; k16 < kBK / 16; ++k16) {
          // a 16-deep step is 32 bytes along the swizzled row
          wgmma_m64n256k16(acc, wgmma_desc(a + 32 * k16), wgmma_desc(b + 32 * k16), kb > 0 || k16 > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        mbar_arrive(empty(stage));
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // epilogue: acc[4j + e] is row 16 wl + g (+ 8 for e >= 2), column 8j +
      // 2t (+ 1 for odd e) of this consumer's 64 x 256; the residual's 64 x 64
      // boxes hold row r's 16-byte chunk q at chunk q ^ (r & 7)
      mbar_wait(res_full(c), res_phase);
      res_phase ^= 1;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        float2 sc = make_float2(0.f, 0.f), sh = make_float2(0.f, 0.f);
        if (n0 + 8 * j < N) {
          sc = __ldg(reinterpret_cast<const float2*>(scale + col));
          sh = __ldg(reinterpret_cast<const float2*>(shift + col));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wl + g + 8 * h;
          __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
              res_ptr + (j >> 3) * kBoxBytes + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * t);
          const float2 rv = __bfloat1622float2(*p);
          float y0 = __fadd_rn(__fadd_rn(__fmul_rn(acc[4 * j + 2 * h], sc.x), sh.x), rv.x);
          float y1 = __fadd_rn(__fadd_rn(__fmul_rn(acc[4 * j + 2 * h + 1], sc.y), sh.y), rv.y);
          if (relu) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
          *p = __floats2bfloat162_rn(y0, y1);
        }
      }
      // the bf16 tile is in shared memory: make it visible to the TMA store
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      if ((tid & 127) == 0) {
        for (int box = 0; box < kBN / kBox; ++box) {
          tma_store(&tout, res + box * kBoxBytes, n0 + box * kBox, m0 + 64 * c);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the buffer is free once the store has read it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(res_empty(c));
      }
      __syncwarp();  // the warp is converged again before the next wgmma
    }
    if ((tid & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---- host: tensor maps through the driver entry point ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// looked up once per process (two first callers store the same pointer)
EncodeTiled encode_fn = nullptr;

cudaError_t encoder(EncodeTiled* fn) {
  if (encode_fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    encode_fn = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = encode_fn;
  return cudaSuccess;
}

// a bf16 row-major (rows, cols) matrix, loaded or stored in (box_rows,
// box_cols) boxes with the 128-byte swizzle; zero-filled past its edges
cudaError_t tensor_map(const void* ptr, long long rows, long long cols, int box_rows, int box_cols,
                       CUtensorMap* out) {
  EncodeTiled fn;
  const cudaError_t e = encoder(&fn);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
  CUtensorMap tx, tw, tres, tout;
  cudaError_t e;
  if ((e = tensor_map(x, M, K, kBM, kBK, &tx)) != cudaSuccess) return (int)e;
  if ((e = tensor_map(w, N, K, kBN, kBK, &tw)) != cudaSuccess) return (int)e;
  if ((e = tensor_map(res, M, N, kBox, kBox, &tres)) != cudaSuccess) return (int)e;
  if ((e = tensor_map(out, M, N, kBox, kBox, &tout)) != cudaSuccess) return (int)e;
  // the opt-in above 48 KB of dynamic shared memory and the SM count, once per
  // process (a race between two first callers sets the same values twice)
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
    if ((e = cudaFuncSetAttribute(matmul_affine_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kSmemBytes)) != cudaSuccess) {
      return (int)e;
    }
    sms = n;
  }
  const int grid = (int)(tiles < sms ? tiles : sms);
  matmul_affine_residual_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tx, tw, tres, tout, static_cast<const float*>(scale), static_cast<const float*>(shift), N, K,
      (int)tiles_n, (int)tiles, relu);
  return (int)cudaGetLastError();
}
