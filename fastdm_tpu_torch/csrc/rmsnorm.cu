// RMSNorm over the last dimension, bf16 in and out, f32 math.
//
// Replaces: fastdm_tpu/kernels/pallas/elementwise.py rms_norm_pallas (:66),
// kernel body _rms_kernel (:56). Computes y = x * rsqrt(mean(x^2) + eps) * w per
// row in f32 and rounds once to bf16, as the plain version
// (fastdm_tpu_torch/kernels/torch_backend.py rms_norm_torch) does.
//
// What bounds it on the H100: memory bytes. A row of the FLUX per-head q/k norm
// is 128 bf16 (256 bytes) and carries ~4 flops per element, far below the
// ~295 flop/byte ridge, so the floor is (read x + write y) / 3.35 TB/s.
//
// Design: one warp per row, each lane loads bf16 pairs (4-byte accesses, 128
// contiguous bytes per warp instruction), the sum of squares is a warp
// shuffle reduction, so a row is read from device memory exactly once and no
// shared memory or block barrier is needed. The input is addressed as
// (tokens, heads, dim) with an arbitrary token stride, so the per-head view of
// a fused QKV projection (q = qkv[..., :H*D]) is normalised in place of a copy:
// the Pallas version needed the rows materialised in VMEM-tiled order.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rms_norm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ w,
                     __nv_bfloat16* __restrict__ out,
                     int64_t n_rows, int heads, int64_t token_stride, int dim,
                     float eps) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // whole warp leaves together
  const __nv_bfloat16* xr = x + (row / heads) * token_stride + (row % heads) * static_cast<int64_t>(dim);
  __nv_bfloat16* yr = out + row * dim;

  float ss = 0.f;
  for (int c = lane * 2; c < dim; c += 64) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c));
    ss += f.x * f.x + f.y * f.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  // IEEE sqrt and division (no fast-math): the plain version's rsqrt is
  // matched to within one bf16 rounding step.
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(dim) + eps);

  for (int c = lane * 2; c < dim; c += 64) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c));
    float y0 = f.x * inv, y1 = f.y * inv;
    if (w != nullptr) {
      y0 *= w[c];
      y1 *= w[c + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(yr + c) = __floats2bfloat162_rn(y0, y1);
  }
}

}  // namespace

// x: bf16 rows addressed as (n_rows / heads) tokens x heads x dim, token
// stride `token_stride` elements, heads contiguous; w: f32 (dim,) or NULL;
// out: contiguous bf16 (n_rows, dim). dim must be even, pointers 4-byte aligned.
FDM_EXPORT int fdm_rms_norm_bf16(const void* x, const void* w, void* out,
                                 long long n_rows, int heads, long long token_stride,
                                 int dim, float eps, void* stream) {
  if (n_rows <= 0) return 0;
  const long long blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rms_norm_bf16_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(out), n_rows, heads, token_stride, dim, eps);
  return static_cast<int>(cudaGetLastError());
}

FDM_DEFINE_ERROR_STRING(fdm_rms_norm)
