// int8 W8A8 GEMM with the fused dequantization epilogue: int8 x int8 -> s32
// on the tensor cores, then
//   out = bf16( f32(acc - azp[m] * colsum[n]) * (scale_a[m] * scale_b[n]) + f32(bias[n]) )
// (azp and bias optional).
//
// Replaces: fastdm_tpu/kernels/pallas/matmul.py int8_matmul_pallas (:158),
// which runs _w8a8_matmul_pallas (:89) and its body _mm_kernel (:52); its fp8
// twin fp8_matmul_pallas (:182) is fp8_gemm.cu. The epilogue follows the jnp oracle's order
// (fastdm_tpu/kernels/jnp_backend/impl.py:232-240) with __fmul_rn/__fadd_rn,
// so no FMA contraction moves a rounding: the int8 GEMM is bit-exact with its
// plain version (fastdm_tpu_torch/kernels/torch_backend.py int8_matmul_torch),
// whose s32 accumulate is exact too.
//
// What bounds it on the H100: operations. At the FLUX shapes (M = 512 to 8704,
// K = 3072 to 15360, N = 3072 to 21504) it does 2*M*N*K int8 operations
// on M*K + K*N + 2*M*N bytes, 800 to 2000 operations per byte, far above the
// ~590 op/byte ridge of the 1979 TOP/s tensor-core rate: the floor of the
// single-block qkv_mlp product (8704 x 3072 -> 21504) is 0.58 ms.
//
// Design (mma.sync m16n8k32, the Ampere-style form; the wgmma + TMA design of
// fp8_gemm.cu is this kernel's next step). Each block
// computes a 128x128 output tile with 8 warps (2 x 4, each 64x32) and walks K
// in 128-byte steps through a 3-stage cp.async ring in shared memory; the
// loop inside the block takes the place of the Pallas grid's sequential K
// axis and its VMEM accumulator (matmul.py:52-81), the accumulators stay in
// registers. B is read K-contiguous, as an (N, K) buffer — the checkpoint's
// own (out, in) layout — because the m16n8k32 B fragment holds 4 consecutive
// k of one column and ldmatrix only transposes 16-bit elements: with A and B
// both K-contiguous, plain (non-.trans) ldmatrix.x4 yields both fragments. A
// row pitch of 144 bytes makes those reads bank-conflict free.
// M and N edges are zero-filled by the async copy and masked at the store;
// K must be a multiple of 16 (whole 16-byte chunks), its tail is zero-filled.
// Blocks are rasterised in groups of 8 M-tiles so the A panels of a group
// stay in L2 while the B panels stream past.
#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 128;  // block tile; kBK in bytes = elements
constexpr int kWarpsN = 4;                      // warps: 2 along M x 4 along N
constexpr int kThreads = 256;
constexpr int kWM = 64, kWN = 32;               // warp tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;    // m16 and n8 tiles per warp
constexpr int kStages = 3;
constexpr int kLds = kBK + 16;                  // smem row pitch, bytes
constexpr int kStageBytes = (kBM + kBN) * kLds;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kGroupM = 8;
static_assert(kBM == kBN, "load_slab copies kBM rows of either operand");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Asynchronous 16-byte copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_k32(int32_t (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Start copying a (rows x kBK) slab at (row0, k0) of a K-contiguous operand
// with row pitch `ld` bytes into shared memory; rows past n_rows and 16-byte
// chunks past k are zero-filled.
__device__ __forceinline__ void load_slab(uint8_t* dst, const uint8_t* __restrict__ src,
                                          int64_t ld, int row0, int n_rows, int k0, int k) {
  constexpr int kChunks = kBK / 16;
#pragma unroll
  for (int i = threadIdx.x; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 16;
    const bool valid = row0 + r < n_rows && k0 + c < k;
    cp_async_16(smem_addr(dst + r * kLds + c), valid ? src + (row0 + r) * ld + k0 + c : src,
                valid ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
w8a8_gemm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 const float* __restrict__ scale_a, const float* __restrict__ scale_b,
                 const int32_t* __restrict__ azp, const int32_t* __restrict__ colsum,
                 const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                 int m, int n, int k, int64_t lda, int64_t ldb) {
  extern __shared__ __align__(16) uint8_t smem[];

  // grouped rasterisation: kGroupM M-tiles share each sweep over N
  const int tiles_m = (m + kBM - 1) / kBM, tiles_n = (n + kBN - 1) / kBN;
  const int per_group = kGroupM * tiles_n;
  const int first_m = (blockIdx.x / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int m0 = (first_m + (blockIdx.x % per_group) % group_m) * kBM;
  const int n0 = ((blockIdx.x % per_group) / group_m) * kBN;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair

  int32_t acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int n_kt = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) {
      uint8_t* st = smem + s * kStageBytes;
      load_slab(st, a, lda, m0, m, s * kBK, k);
      load_slab(st + kBM * kLds, b, ldb, n0, n, s * kBK, k);
    }
    cp_async_commit();
  }

  // ldmatrix lane roles. A (16 rows x 32 bytes): matrices (rows 0-7 | 8-15) x
  // (bytes 0-15 | 16-31) in the a0..a3 order of the m16n8k32 fragment. B (two
  // n8 tiles x 32 bytes): (n 0-7: bytes 0-15, 16-31), (n 8-15: the same).
  const int a_row = lane & 15, a_col = (lane >> 4) * 16;
  const int b_row = (lane >> 4) * 8 + (lane & 7), b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies) ...
    __syncthreads();               // ... for every thread; tile kt-1's stage is free
    const int next = kt + kStages - 1;
    if (next < n_kt) {
      uint8_t* st = smem + (next % kStages) * kStageBytes;
      load_slab(st, a, lda, m0, m, next * kBK, k);
      load_slab(st + kBM * kLds, b, ldb, n0, n, next * kBK, k);
    }
    cp_async_commit();

    const uint8_t* as = smem + (kt % kStages) * kStageBytes + (wm * kWM) * kLds;
    const uint8_t* bs = smem + (kt % kStages) * kStageBytes + (kBM + wn * kWN) * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kMT][4], bf[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(af[i], smem_addr(as + (i * 16 + a_row) * kLds + kk + a_col));
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_addr(bs + (j * 8 + b_row) * kLds + kk + b_col));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_k32(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue in the oracle's order; accumulator element e of an m16n8 tile
  // sits at row g + 8*(e/2), column 2t + e%2
  const bool pair_store = (n % 2) == 0;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * kWM + i * 16 + g + h * 8;
      if (row >= m) continue;
      const float sa = scale_a[row];
      const int32_t zr = azp != nullptr ? azp[row] : 0;
      __nv_bfloat16* orow = out + static_cast<int64_t>(row) * n;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int col = n0 + wn * kWN + j * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = min(col + e, n - 1);  // clamped reads; stores are masked
          int32_t x = acc[i][j][2 * h + e];
          if (azp != nullptr)  // two's-complement wrap, as the s32 oracle
            x = static_cast<int32_t>(static_cast<uint32_t>(x) -
                                     static_cast<uint32_t>(zr) * static_cast<uint32_t>(colsum[c]));
          float f = __int2float_rn(x);
          f = __fmul_rn(f, __fmul_rn(sa, scale_b[c]));
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
}

}  // namespace

// a: (m, k) int8, row pitch lda; b: (n, k) int8, row pitch ldb (the (K, N)
// operand stored K-contiguous); both 16-byte aligned with lda, ldb and k
// multiples of 16. scale_a f32 (m,), scale_b f32 (n,), azp int32 (m,) or NULL,
// colsum int32 (n,) (read only with azp), bias bf16 (n,) or NULL; out: contiguous
// bf16 (m, n).
FDM_EXPORT int fdm_w8a8_gemm(const void* a, const void* b, const void* scale_a,
                             const void* scale_b, const void* azp, const void* colsum,
                             const void* bias, void* out, int m, int n, int k, long long lda,
                             long long ldb, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || k % 16 != 0 || lda % 16 != 0 || ldb % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB, dynamic shared memory has to be allowed per kernel
  const cudaError_t attr = cudaFuncSetAttribute(
      w8a8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  w8a8_gemm_kernel<<<static_cast<unsigned>(tiles), kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<const float*>(scale_a), static_cast<const float*>(scale_b),
      static_cast<const int32_t*>(azp), static_cast<const int32_t*>(colsum),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), m, n, k, lda,
      ldb);
  return static_cast<int>(cudaGetLastError());
}

FDM_DEFINE_ERROR_STRING(fdm_w8a8_gemm)
