// Per-token (row) activation quantizers: bf16 -> int8 (symmetric or
// asymmetric), bf16 -> float8_e4m3fn and bf16 -> int4 (in int8 carriers),
// with one f32 scale (and one int32 zero point) per row.
//
// Replaces: fastdm_tpu/kernels/pallas/elementwise.py quantize_to_int8_pallas
// (:162, kernel body _quant_int8_kernel :144) and quantize_to_fp8_pallas
// (:208, body _quant_fp8_kernel :199), and the jnp-only int4 quantizer of the
// W4A4 path, quantize_to_int4_jnp (impl.py:143-162), which has no Pallas
// kernel. The math is the jnp oracle's
// (fastdm_tpu/kernels/jnp_backend/impl.py:123-162, :191-197), which the plain
// versions in fastdm_tpu_torch/kernels/torch_backend.py copy: scale floor
// 1e-12 (the Pallas kernels use 1e-8, which differs only on all-zero rows),
//   int8 sym:  scale = max(amax, 1e-12) / 127,  q = clip(rint(x / scale))
//   int8 asym: scale = max(max - min, 1e-12) / 255,
//              zp = int32(-128 - rint(min / scale))   (saturating, as XLA),
//              q = clip(rint(x / scale) + float(zp), -128, 127)
//   fp8:       scale = max(amax, 1e-12) / 448,
//              q = e4m3_rne(clip(x / scale, -448, 448))
//   int4:      scale = max(amax, 1e-12) / 7,  q = clip(rint(x / scale), -8, 7),
//              one value per int8 carrier byte (the W4A4 GEMM's s8 operand).
// Every division is __fdiv_rn (correctly rounded) and rint rounds half to
// even, as jnp.round does; the build uses no --use_fast_math. So q, scale and
// zp are bit-exact with the plain versions.
//
// What bounds it on the H100: memory bytes. Each element is read once (2
// bytes) and written once (1 byte) for a handful of f32 operations, far below
// the ~295 flop/byte ridge: the floor is 3*M*K bytes / 3.35 TB/s (24 us for the
// FLUX single-block input, 8704 x 3072; the same for int4, whose carriers are
// bytes).
//
// Design: one block of 128 threads per row (rows on the FLUX path hold 3072
// to 15360 bf16, at most 30 KB). Pass 1 reads the row in 16-byte vectors and
// reduces min/max (or absmax) with warp shuffles and one shared-memory step;
// pass 2 reads the row again — from L2, it was just read — and writes 8
// quantized bytes per vector in one 8-byte store. The Pallas version tiled
// rows in VMEM by a budget (_row_grid); here a row never leaves its block.
#include "common.cuh"

#include <cuda_fp8.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEpsScale = 1e-12f;
constexpr float kFp8Max = 448.f;

enum Mode { kInt8Sym = 0, kInt8Asym = 1, kFp8 = 2, kInt4 = 3 };

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// Block-wide min and max of this thread's (lo, hi); every thread gets the result.
__device__ __forceinline__ void block_minmax(float& lo, float& hi) {
  __shared__ float s_lo[kThreads / 32], s_hi[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) {
    lo = fminf(lo, s_lo[w]);
    hi = fmaxf(hi, s_hi[w]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int64_t x_stride, int k,
                     uint8_t* __restrict__ q, float* __restrict__ scale_out,
                     int32_t* __restrict__ zp_out) {
  const int64_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * x_stride);
  const int n_vec = k / 8;

  // pass 1: min and max of the row (absmax for the symmetric forms)
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    float f[8];
    unpack8(xr[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      lo = fminf(lo, f[j]);
      hi = fmaxf(hi, f[j]);
    }
  }
  block_minmax(lo, hi);

  float scale;
  float zpf = 0.f;
  if (MODE == kInt8Asym) {
    scale = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), kEpsScale), 255.f);
    const int zp = __float2int_rn(__fsub_rn(-128.f, rintf(__fdiv_rn(lo, scale))));
    zpf = __int2float_rn(zp);
    if (threadIdx.x == 0) zp_out[row] = zp;
  } else {
    const float amax = fmaxf(fabsf(lo), fabsf(hi));
    scale = __fdiv_rn(fmaxf(amax, kEpsScale),
                      MODE == kFp8 ? kFp8Max : MODE == kInt4 ? 7.f : 127.f);
  }
  if (threadIdx.x == 0) scale_out[row] = scale;

  // pass 2: quantize; 8 output bytes per 16-byte input vector
  uint2* qr = reinterpret_cast<uint2*>(q + row * static_cast<int64_t>(k));
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    float f[8];
    unpack8(xr[i], f);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t byte;
      if (MODE == kFp8) {
        const float v = fminf(fmaxf(__fdiv_rn(f[j], scale), -kFp8Max), kFp8Max);
        byte = static_cast<uint32_t>(__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3));
      } else {
        constexpr float kMin = MODE == kInt4 ? -8.f : -128.f, kMax = MODE == kInt4 ? 7.f : 127.f;
        float v = __fadd_rn(rintf(__fdiv_rn(f[j], scale)), zpf);
        v = fminf(fmaxf(v, kMin), kMax);
        byte = static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(v))));
      }
      packed[j / 4] |= byte << (8 * (j % 4));
    }
    qr[i] = make_uint2(packed[0], packed[1]);
  }
}

}  // namespace

// x: bf16 (m, k) rows with row stride x_stride elements, 16-byte aligned rows,
// k a multiple of 8. q: contiguous (m, k) bytes (int8, e4m3 or int4 carriers);
// scale: f32 (m,); zp: int32 (m,), written only by the asymmetric int8 form
// (mode 1). mode: 0 int8 symmetric, 1 int8 asymmetric, 2 fp8 e4m3, 3 int4.
FDM_EXPORT int fdm_quantize_rows(const void* x, long long x_stride, long long m, int k,
                                 void* q, void* scale, void* zp, int mode, void* stream) {
  if (m <= 0) return 0;
  if (k <= 0 || k % 8 != 0 || m > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* qp = static_cast<uint8_t*>(q);
  auto* sp = static_cast<float*>(scale);
  auto* zpp = static_cast<int32_t*>(zp);
  const dim3 grid(static_cast<unsigned>(m));
  switch (mode) {
    case kInt8Sym:
      quantize_rows_kernel<kInt8Sym><<<grid, kThreads, 0, st>>>(xp, x_stride, k, qp, sp, zpp);
      break;
    case kInt8Asym:
      quantize_rows_kernel<kInt8Asym><<<grid, kThreads, 0, st>>>(xp, x_stride, k, qp, sp, zpp);
      break;
    case kFp8:
      quantize_rows_kernel<kFp8><<<grid, kThreads, 0, st>>>(xp, x_stride, k, qp, sp, zpp);
      break;
    case kInt4:
      quantize_rows_kernel<kInt4><<<grid, kThreads, 0, st>>>(xp, x_stride, k, qp, sp, zpp);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

FDM_DEFINE_ERROR_STRING(fdm_quantize)
