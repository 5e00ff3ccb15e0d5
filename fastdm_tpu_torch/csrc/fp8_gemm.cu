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
// the 1979 TFLOP/s fp8 rate: the floor is 0.58 ms. mma.sync cannot reach
// that rate on Hopper; only wgmma can.
//
// Design (sm90.cuh): a persistent grid, one block per SM, each block walking
// output tiles of 192 x 128 in grouped order (kGroupM M-tiles share each
// sweep over N, so the A panels of a group stay in L2 while B streams past).
// Warpgroup 0 is the producer: after setmaxnreg gives most of its registers
// away, one thread walks K in 128-byte steps and has the TMA bring the A and B
// slabs (rows x 128 bytes, 128-byte swizzle, one swizzle atom per row) into a
// ring of kStages shared-memory stages, each with a "full" mbarrier (TMA bytes
// landed) and an "empty" one (every consumer done); it runs on into the next
// tile while the consumers store this one. Warpgroups 1-3 are the consumers,
// 64 output rows each: per stage four wgmma.m64n128k32.e4m3 (A and B both
// K-major, which is the layout A and the (N, K) weight buffer already have),
// each into a partial that it overwrites, waited for and added in f32 into
// the main accumulator. So no tensor-core sum holds more than 32 products.
// Hopper's fp8 wgmma accumulates in reduced precision (measured on an H100
// against the fp8 tolerance, 1 bf16 ulp + 2^-16 sa*sb*(|a|@|b|): partials of
// 128 products fail it at the FLUX qkv_mlp shape, of 64 at SDXL's K = 640,
// of 32 nowhere). Registers: 64 f32 for the accumulator and 64 for the
// partial per consumer thread, which is what three consumers can have
// (setmaxnreg 160); a 128 x 256 tile with two consumers ran slower, and
// overlapping a warpgroup's adds with its next wgmma makes ptxas serialise
// the wgmmas (warning C7514), so the consumers overlap each other instead.
// The TMA zero-fills rows past M and N and bytes past K (e4m3 0x00 is +0);
// the epilogue masks its stores.
//
// The producer, the ring and the descriptors move bytes and do not know the
// element type: the int8 GEMM moves onto this design by swapping the MMA for
// wgmma.m64n128k32.s32.s8.s8 (s32 sums are exact, so without the promotion)
// and adding its zero-point term to the epilogue.
#include "sm90.cuh"

namespace {

using namespace fdm_sm90;

constexpr int kConsumers = 3;                   // consumer warpgroups, 64 output rows each
constexpr int kBM = 64 * kConsumers, kBN = 128, kBK = 128;  // block tile; kBK bytes = elements
constexpr int kThreads = 128 * (1 + kConsumers);  // a producer warpgroup and the consumers
constexpr int kATileBytes = kBM * kBK, kBTileBytes = kBN * kBK;
constexpr int kStageBytes = kATileBytes + kBTileBytes;
constexpr int kStages = 200 * 1024 / kStageBytes;  // as deep as shared memory allows
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;  // slack, ring, barriers
// setmaxnreg: the producer gives up registers, the consumers take them (at
// launch each thread has 65536 / kThreads = 128)
constexpr int kProducerRegs = 24, kConsumerRegs = 160;
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536,
              "the register file holds the setmaxnreg split");
constexpr int kAcc = kBN / 2;                   // f32 accumulators per consumer thread
constexpr int kGroupM = 8;

// Output tile `tile` of the grouped rasterisation: kGroupM M-tiles share each
// sweep over N, so the A panels of a group stay in L2 while B streams past.
__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int tiles_n, int& m0,
                                            int& n0) {
  const int per_group = kGroupM * tiles_n;
  const int first_m = (tile / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  m0 = (first_m + (tile % per_group) % group_m) * kBM;
  n0 = ((tile % per_group) / group_m) * kBN;
}

// The epilogue in the oracle's order; accumulator 4j + 2h + e sits at row
// 16*warp + g + 8h, column 8j + 2t + e of the warpgroup's 64 x kBN tile.
__device__ __forceinline__ void store_tile(const float (&acc)[kAcc], int row0, int n0, int m,
                                           int n, const float* __restrict__ scale_a,
                                           const float* __restrict__ scale_b,
                                           const __nv_bfloat16* __restrict__ bias,
                                           __nv_bfloat16* __restrict__ out) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool pair_store = (n % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + g + h * 8;
    if (row >= m) continue;
    const float sa = scale_a[row];
    __nv_bfloat16* orow = out + static_cast<int64_t>(row) * n;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = min(col + e, n - 1);  // clamped reads; stores are masked
        float f = __fmul_rn(acc[4 * j + 2 * h + e], __fmul_rn(sa, scale_b[c]));
        if (bias != nullptr) f = __fadd_rn(f, __bfloat162float(bias[c]));
        v[e] = f;
      }
      if (col >= n) continue;
      if (pair_store) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v[0], v[1]);
      } else {
        orow[col] = __float2bfloat16_rn(v[0]);
        if (col + 1 < n) orow[col + 1] = __float2bfloat16_rn(v[1]);
      }
    }
  }
}

__device__ __forceinline__ void promote(float (&acc)[kAcc], float (&part)[kAcc]) {
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

__global__ void __launch_bounds__(kThreads, 1)
fp8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const float* __restrict__ scale_a,
                const float* __restrict__ scale_b, const __nv_bfloat16* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tiles_m = (m + kBM - 1) / kBM, tiles_n = (n + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n;
  const int n_kt = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Persistent: block b takes tiles b, b + gridDim.x, ...; the ring's K steps
  // are counted across tiles (it), so the producer runs on into the next tile
  // while the consumers store this one.
  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, tiles_m, tiles_n, m0, n0);
        for (int kt = 0; kt < n_kt; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          uint8_t* st = smem + s * kStageBytes;
          mbar_arrive_expect_tx(&full[s], kStageBytes);
          tma_load_2d(st, &map_a, &full[s], kt * kBK, m0);
          tma_load_2d(st + kATileBytes, &map_b, &full[s], kt * kBK, n0);
        }
      }
    }
    return;
  }

  // consumers: rows (wg - 1) * 64 .. + 63 of each tile. Each stage's K is
  // kBK / 32 steps of 32 products: one wgmma into the partial, wait, add it
  // into acc. (Overlapping one step's adds with the next step's wgmma in the
  // same warpgroup makes ptxas serialise the wgmmas; the other consumer
  // warpgroups' wgmmas run during a warpgroup's adds.)
  setmaxnreg_inc<kConsumerRegs>();
  const int row_off = (wg - 1) * 64;
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) part[i] = 0.f;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin(tile, tiles_m, tiles_n, m0, n0);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t a_addr = smem_u32(smem + s * kStageBytes) + row_off * kBK;
      const uint32_t b_addr = smem_u32(smem + s * kStageBytes + kATileBytes);
#pragma unroll
      for (int k0 = 0; k0 < kBK; k0 += 32) {
        wgmma_fence();
        wgmma_m64n128k32_e4m3(part, desc_sw128(a_addr + k0, 0), desc_sw128(b_addr + k0, 0), 0);
        wgmma_commit();
        wgmma_wait<0>();
        if (k0 + 32 == kBK && (threadIdx.x & 31) == 0)
          mbar_arrive(&empty[s]);  // the stage is read
        promote(acc, part);
      }
    }
    store_tile(acc, m0 + row_off, n0, m, n, scale_a, scale_b, bias, out);
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
  if (k <= 0 || k % 16 != 0 || lda % 16 != 0 || ldb % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  // 2-D maps (K, rows) over the K-contiguous operands, boxes of kBK bytes by
  // the tile's rows
  CUtensorMap map_a, map_b;
  const long long box_a[2] = {kBK, kBM}, box_b[2] = {kBK, kBN};
  const long long dims_a[2] = {k, m}, dims_b[2] = {k, n};
  int r = encode_tiled(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a, dims_a, &lda, box_a);
  if (r == 0) r = encode_tiled(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, b, dims_b, &ldb, box_b);
  if (r != 0) return r;
  // above 48 KB, dynamic shared memory has to be allowed per kernel
  const cudaError_t attr = cudaFuncSetAttribute(
      fp8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);  // one block per SM
  fp8_gemm_kernel<<<grid, kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<const float*>(scale_a), static_cast<const float*>(scale_b),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block, bytes.
FDM_EXPORT int fdm_fp8_gemm_smem_bytes() { return kSmemBytes; }

// Registers per thread after setmaxnreg: a consumer's (consumer != 0) or the
// producer's.
FDM_EXPORT int fdm_fp8_gemm_setmaxnreg(int consumer) {
  return consumer ? kConsumerRegs : kProducerRegs;
}

FDM_DEFINE_SM90_ERROR_STRING(fdm_fp8_gemm)
