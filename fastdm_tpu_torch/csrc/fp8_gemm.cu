// fp8 W8A8 GEMM with the fused dequantization epilogue: e4m3 x e4m3 -> f32
// on the tensor cores through wgmma, then
//   out = bf16( f32(a @ b) * (scale_a[m] * scale_b[n]) + f32(bias[n]) )
// (bias optional).
//
// Replaces: fastdm_tpu/kernels/pallas/matmul.py fp8_matmul_pallas (:182),
// which runs _w8a8_matmul_pallas (:89) and its body _mm_kernel (:52). The
// epilogue follows the jnp oracle's order (fastdm_tpu/kernels/jnp_backend/
// impl.py:232-240) with __fmul_rn / __fadd_rn, as the int8 GEMM's
// (w8a8_gemm.cu), so no FMA contraction moves a rounding.
//
// What bounds it on the H100: operations. At the FLUX single-block qkv_mlp
// shape (8704 x 3072 @ 3072 x 21504) it does 2*M*N*K = 1.15e12 fp8
// operations on 457 MB, ~2500 per byte, far above the ~590 op/byte ridge of
// the 1979 TFLOP/s fp8 rate: the floor is 0.58 ms. The warp-level MMA cannot
// reach that rate on Hopper; only wgmma can.
//
// Design (w8a8_sm90.cuh, sm90.cuh): a persistent grid, one block per SM, each
// block walking output tiles of 192 x 128 in grouped order (kGroupM M-tiles
// share each sweep over N, so the A panels of a group stay in L2 while B
// streams past). Warpgroup 0 is the producer: after setmaxnreg gives most of
// its registers away, one thread walks K in 128-byte steps and has the TMA
// bring the A and B slabs (rows x 128 bytes, 128-byte swizzle, one swizzle atom
// per row) into a ring of kStages shared-memory stages, each with a "full"
// mbarrier (TMA bytes landed) and an "empty" one (every consumer done); it
// runs on into the next tile while the consumers store this one. That
// skeleton is the int8 GEMM's too (w8a8_gemm.cu). Warpgroups 1-3 are the
// consumers, 64 output rows each: per stage four wgmma.m64n128k32.e4m3 (A and
// B both K-major, which is the layout A and the (N, K) weight buffer already
// have), each into a partial that it overwrites, waited for and added in f32
// into the main accumulator. So no tensor-core sum holds more than 32
// products. Hopper's fp8 wgmma accumulates in reduced precision (measured on
// an H100 against the fp8 tolerance, 1 bf16 ulp + 2^-16 sa*sb*(|a|@|b|):
// partials of 128 products fail it at the FLUX qkv_mlp shape, of 64 at SDXL's
// K = 640, of 32 nowhere). That wait per 32 products is what the int8 GEMM,
// whose s32 sums are exact, does without. Registers: 64 f32 for the
// accumulator and 64 for the partial per consumer thread, which is what three
// consumers can have (setmaxnreg 160); a 128 x 256 tile with two consumers
// ran slower, and overlapping a warpgroup's adds with its next wgmma makes
// ptxas serialise the wgmmas (warning C7514), so the consumers overlap each
// other instead. The launcher queries the SM count and allows the kernel's
// shared memory once per device, not on every call.
#include "w8a8_sm90.cuh"

namespace {

using namespace fdm_w8a8;

using T = Tile<3, 128>;  // 192 x 128: three consumers

__device__ __forceinline__ void promote(float (&acc)[T::kAcc], float (&part)[T::kAcc]) {
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// Out: __nv_bfloat16 (the layer's output) or float (a row-parallel layer's
// partial sum, no bias).
template <class Out>
__global__ void __launch_bounds__(T::kThreads, 1)
fp8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const float* __restrict__ scale_a,
                const float* __restrict__ scale_b, const __nv_bfloat16* __restrict__ bias,
                Out* __restrict__ out, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  const Ring<T> ring(smem_raw);
  const int tiles_m = (m + T::kBM - 1) / T::kBM, tiles_n = (n + T::kBN - 1) / T::kBN;
  const int tiles = tiles_m * tiles_n;
  const int n_kt = (k + kBK - 1) / kBK;
  ring.init();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    produce(ring, &map_a, &map_b, tiles_m, tiles_n, n_kt);
    return;
  }

  // consumers: rows (wg - 1) * 64 .. + 63 of each tile. Each stage's K is
  // kBK / 32 steps of 32 products: one wgmma into the partial, wait, add it
  // into acc. (Overlapping one step's adds with the next step's wgmma in the
  // same warpgroup makes ptxas serialise the wgmmas; the other consumer
  // warpgroups' wgmmas run during a warpgroup's adds.)
  setmaxnreg_inc<T::kConsumerRegs>();
  const int row_off = (wg - 1) * 64;
  float acc[T::kAcc], part[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) part[i] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin<T>(tile, tiles_m, tiles_n, m0, n0);
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt, ++it) {
      const int s = it % T::kStages;
      mbar_wait(&ring.full[s], (it / T::kStages) & 1);
      const uint32_t a_addr = smem_u32(ring.smem + s * T::kStageBytes) + row_off * kBK;
      const uint32_t b_addr = smem_u32(ring.smem + s * T::kStageBytes + T::kATileBytes);
#pragma unroll
      for (int k0 = 0; k0 < kBK; k0 += 32) {
        wgmma_fence();
        wgmma_m64n128k32_e4m3(part, desc_sw128(a_addr + k0, 0), desc_sw128(b_addr + k0, 0), 0);
        wgmma_commit();
        wgmma_wait<0>();
        if (k0 + 32 == kBK && (threadIdx.x & 31) == 0)
          mbar_arrive(&ring.empty[s]);  // the stage is read
        promote(acc, part);
      }
    }
    store_tile<T, Out>([&](int i, int, int) { return acc[i]; }, m0 + row_off, n0, m, n,
                       scale_a, scale_b, bias, out);
  }
}

}  // namespace

// a: (m, k) e4m3 bytes, row pitch lda; b: (n, k) e4m3 bytes, row pitch ldb
// (the (K, N) operand stored K-contiguous); both 16-byte aligned with lda,
// ldb and k multiples of 16. scale_a f32 (m,), scale_b f32 (n,), bias bf16
// (n,) or NULL; out: contiguous bf16 (m, n).
FDM_EXPORT int fdm_fp8_gemm(const void* a, const void* b, const void* scale_a,
                            const void* scale_b, const void* bias, void* out, int m, int n, int k,
                            long long lda, long long ldb, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  static std::atomic<int> setup[kMaxDevices];
  return launch<T>(fp8_gemm_kernel<__nv_bfloat16>, setup, a, b, m, n, k, lda, ldb,
                   static_cast<cudaStream_t>(stream), static_cast<const float*>(scale_a),
                   static_cast<const float*>(scale_b), static_cast<const __nv_bfloat16*>(bias),
                   static_cast<__nv_bfloat16*>(out));
}

// The row-parallel partial: out = (a.b) * (scale_a[m] * scale_b[n]) in f32,
// unrounded and without a bias (the sum over the tp group takes the bias
// once); out: contiguous f32 (m, n), the rest as fdm_fp8_gemm.
FDM_EXPORT int fdm_fp8_gemm_f32(const void* a, const void* b, const void* scale_a,
                                const void* scale_b, void* out, int m, int n, int k,
                                long long lda, long long ldb, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  static std::atomic<int> setup[kMaxDevices];
  return launch<T>(fp8_gemm_kernel<float>, setup, a, b, m, n, k, lda, ldb,
                   static_cast<cudaStream_t>(stream), static_cast<const float*>(scale_a),
                   static_cast<const float*>(scale_b),
                   static_cast<const __nv_bfloat16*>(nullptr), static_cast<float*>(out));
}

// Dynamic shared memory of one block, bytes.
FDM_EXPORT int fdm_fp8_gemm_smem_bytes() { return T::kSmemBytes; }

// Registers per thread after setmaxnreg: a consumer's (consumer != 0) or the
// producer's.
FDM_EXPORT int fdm_fp8_gemm_setmaxnreg(int consumer) {
  return consumer ? T::kConsumerRegs : kProducerRegs;
}

FDM_DEFINE_SM90_ERROR_STRING(fdm_fp8_gemm)
