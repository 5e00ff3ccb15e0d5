// int8 W8A8 GEMM with the fused dequantization epilogue: int8 x int8 -> s32
// on the tensor cores through wgmma, then
//   out = bf16( f32(acc - azp[m] * colsum[n]) * (scale_a[m] * scale_b[n]) + f32(bias[n]) )
// (azp and bias optional). The W4A4 int4 GEMM is the same kernel without the
// zero point (fdm_w4a4_gemm, below).
//
// Replaces: fastdm_tpu/kernels/pallas/matmul.py int8_matmul_pallas (:158),
// which runs _w8a8_matmul_pallas (:89) and its body _mm_kernel (:52); its fp8
// twin fp8_matmul_pallas (:182) is fp8_gemm.cu. The epilogue follows the jnp
// oracle's order (fastdm_tpu/kernels/jnp_backend/impl.py:232-240): the
// zero-point term with two's-complement wrap, __int2float_rn, then
// __fmul_rn / __fadd_rn (w8a8_sm90.cuh store_tile), so no FMA contraction
// moves a rounding: the kernel is bit-exact with its plain version
// (fastdm_tpu_torch/kernels/torch_backend.py int8_matmul_torch), whose s32
// accumulate is exact too.
//
// What bounds it on the H100: operations. At the FLUX shapes (M = 512 to 8704,
// K = 3072 to 15360, N = 3072 to 21504) and Wan2.2-A14B's (M = 32760, K =
// 5120 or 13824) it does 2*M*N*K int8 operations on M*K + K*N + 2*M*N bytes,
// 800 to 3000 operations per byte, far above the ~590 op/byte ridge of the
// 1979 TOP/s tensor-core rate: the floor of the single-block qkv_mlp product
// (8704 x 3072 -> 21504) is 0.58 ms. Only wgmma fed from shared memory by the
// TMA reaches that rate on Hopper (the warp-level MMA through registers does
// not).
//
// Design (w8a8_sm90.cuh, sm90.cuh; the fp8 GEMM's skeleton): a persistent
// grid, one block per SM, walking output tiles in grouped order; warpgroup 0
// is the producer (setmaxnreg 24), one thread of which keeps TMA loads of the
// 128-byte-swizzled A and B slabs in flight through the full / empty mbarrier
// ring; the consumer warpgroups, 64 output rows each, issue
// wgmma.mma_async...s32.s8.s8 (k32) with A and B both K-major from shared
// memory, the layout A and the (N, K) weight buffer already have. Unlike the
// fp8 kernel, nothing waits per wgmma: s32 sums are exact, so each consumer
// accumulates the whole K loop in one s32 register set, issues a stage's four
// k32 wgmmas back to back and keeps one stage in flight (wgmma_wait<1>)
// before it releases the previous stage to the producer. The tile is 192 x
// 128 with three consumers (the fp8 kernel's shape: 64 s32 registers each,
// setmaxnreg 160; 5 stages of 40 KB). 128 x 256 with two consumers of 64 x 256
// (128 s32 registers each, setmaxnreg 240) was measured beside it on an H100
// and lost at the FLUX qkv_mlp and Wan FFN shapes (PERF.md). The TMA
// zero-fills bytes past K (s8 0 adds nothing: a K tail such as SDXL's 640 or
// K = 80 stays exact) and rows past M and N; the stores are masked. The
// launcher queries the SM count and allows the kernel's shared memory once per
// device, not on every call (SDXL's int8 forward makes 529 GEMM calls).
#include "w8a8_sm90.cuh"

namespace {

using namespace fdm_w8a8;

using T = Tile<3, 128>;  // 192 x 128: three consumers

// Out: __nv_bfloat16 (the layer's output) or float (a row-parallel layer's
// partial sum, no bias).
template <class Out>
__global__ void __launch_bounds__(T::kThreads, 1)
w8a8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const float* __restrict__ scale_a,
                 const float* __restrict__ scale_b, const int32_t* __restrict__ azp,
                 const int32_t* __restrict__ colsum, const __nv_bfloat16* __restrict__ bias,
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

  // consumers: rows (wg - 1) * 64 .. + 63 of each tile, accumulated over the
  // whole K loop in s32 (the first wgmma of a tile overwrites: scale_d 0)
  setmaxnreg_inc<T::kConsumerRegs>();
  const int row_off = (wg - 1) * 64;
  const bool lead = (threadIdx.x & 31) == 0;  // arrives for its warp
  int32_t acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin<T>(tile, tiles_m, tiles_n, m0, n0);
    for (int kt = 0; kt < n_kt; ++kt, ++it) {
      const int s = it % T::kStages;
      mbar_wait(&ring.full[s], (it / T::kStages) & 1);
      const uint32_t a_addr = smem_u32(ring.smem + s * T::kStageBytes) + row_off * kBK;
      const uint32_t b_addr = smem_u32(ring.smem + s * T::kStageBytes + T::kATileBytes);
      wgmma_fence();
#pragma unroll
      for (int k0 = 0; k0 < kBK; k0 += 32)
        wgmma_m64n128k32_s8(acc, desc_sw128(a_addr + k0, 0), desc_sw128(b_addr + k0, 0),
                            static_cast<uint32_t>(kt > 0 || k0 > 0));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas are done: release it
      if (kt > 0 && lead) mbar_arrive(&ring.empty[(it - 1) % T::kStages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lead) mbar_arrive(&ring.empty[(it - 1) % T::kStages]);
    store_tile<T, Out>(
        [&](int i, int row, int c) {
          int32_t x = acc[i];
          if (azp != nullptr)  // two's-complement wrap, as the s32 oracle
            x = static_cast<int32_t>(static_cast<uint32_t>(x) -
                                     static_cast<uint32_t>(azp[row]) *
                                         static_cast<uint32_t>(colsum[c]));
          return __int2float_rn(x);
        },
        m0 + row_off, n0, m, n, scale_a, scale_b, bias, out);
  }
}

}  // namespace

// a: (m, k) int8, row pitch lda; b: (n, k) int8, row pitch ldb (the (K, N)
// operand stored K-contiguous); both 16-byte aligned with lda, ldb and k
// multiples of 16. scale_a f32 (m,), scale_b f32 (n,), azp int32 (m,) or NULL,
// colsum int32 (n,) (read only with azp), bias bf16 (n,) or NULL; out:
// contiguous bf16 (m, n).
FDM_EXPORT int fdm_w8a8_gemm(const void* a, const void* b, const void* scale_a,
                             const void* scale_b, const void* azp, const void* colsum,
                             const void* bias, void* out, int m, int n, int k, long long lda,
                             long long ldb, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  static std::atomic<int> setup[kMaxDevices];
  return launch<T>(w8a8_gemm_kernel<__nv_bfloat16>, setup, a, b, m, n, k, lda, ldb,
                   static_cast<cudaStream_t>(stream), static_cast<const float*>(scale_a),
                   static_cast<const float*>(scale_b), static_cast<const int32_t*>(azp),
                   static_cast<const int32_t*>(colsum), static_cast<const __nv_bfloat16*>(bias),
                   static_cast<__nv_bfloat16*>(out));
}

// The row-parallel partial: out = f32(acc - azp[m] * colsum[n]) * (scale_a[m]
// * scale_b[n]), stored in f32 without rounding and without a bias (the
// sum over the tp group takes the bias once); out: contiguous f32 (m, n), the
// rest as fdm_w8a8_gemm. colsum is the column sum of this rank's K rows of b.
FDM_EXPORT int fdm_w8a8_gemm_f32(const void* a, const void* b, const void* scale_a,
                                 const void* scale_b, const void* azp, const void* colsum,
                                 void* out, int m, int n, int k, long long lda, long long ldb,
                                 void* stream) {
  if (m <= 0 || n <= 0) return 0;
  static std::atomic<int> setup[kMaxDevices];
  return launch<T>(w8a8_gemm_kernel<float>, setup, a, b, m, n, k, lda, ldb,
                   static_cast<cudaStream_t>(stream), static_cast<const float*>(scale_a),
                   static_cast<const float*>(scale_b), static_cast<const int32_t*>(azp),
                   static_cast<const int32_t*>(colsum),
                   static_cast<const __nv_bfloat16*>(nullptr), static_cast<float*>(out));
}

// The W4A4 int4 GEMM: out = bf16(f32(a.b) * (scale_a[m] * scale_b[n]) +
// f32(bias[n])), a and b int4-range values in int8 carriers, laid out as for
// fdm_w8a8_gemm. Replaces the jnp-only int4_matmul_jnp
// (fastdm_tpu/kernels/jnp_backend/impl.py:163-188), which has no Pallas
// kernel: the TPU ran s4 x s4 on its matrix unit faster than s8, but Hopper's
// wgmma takes 8-bit integers at the least, so a carrier of an int4 value is an
// exact s8 operand and the product runs at the s8 rate on this kernel's ring.
// Symmetric on both sides (no zero point), the epilogue above is already the
// int4 oracle's order, so the result is bit-exact with int4_matmul_torch
// (|acc| <= 64 K < 2^24 at FLUX widths: __int2float_rn is exact there). An
// entry of its own, so that the launch counts tell int8 from int4.
FDM_EXPORT int fdm_w4a4_gemm(const void* a, const void* b, const void* scale_a,
                             const void* scale_b, const void* bias, void* out, int m, int n,
                             int k, long long lda, long long ldb, void* stream) {
  return fdm_w8a8_gemm(a, b, scale_a, scale_b, nullptr, nullptr, bias, out, m, n, k, lda, ldb,
                       stream);
}

// The W4A4 row-parallel partial: fdm_w8a8_gemm_f32 without the zero point.
FDM_EXPORT int fdm_w4a4_gemm_f32(const void* a, const void* b, const void* scale_a,
                                 const void* scale_b, void* out, int m, int n, int k,
                                 long long lda, long long ldb, void* stream) {
  return fdm_w8a8_gemm_f32(a, b, scale_a, scale_b, nullptr, nullptr, out, m, n, k, lda, ldb,
                           stream);
}

// Dynamic shared memory of one block, bytes.
FDM_EXPORT int fdm_w8a8_gemm_smem_bytes() { return T::kSmemBytes; }

// Registers per thread after setmaxnreg: a consumer's (consumer != 0) or the
// producer's.
FDM_EXPORT int fdm_w8a8_gemm_setmaxnreg(int consumer) {
  return consumer ? T::kConsumerRegs : kProducerRegs;
}

FDM_DEFINE_SM90_ERROR_STRING(fdm_w8a8_gemm)
