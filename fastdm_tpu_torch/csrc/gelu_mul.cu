// GEGLU: out = x[..., :d] * GELU(x[..., d:]) with exact (erf) GELU, bf16 or
// f32 in and out, f32 math, one rounding to the output type.
//
// Replaces: fastdm_tpu/kernels/pallas/elementwise.py gelu_and_mul_pallas
// (:123), kernel body _gelu_mul_kernel (:114). Computes
// h * (0.5 * g * (1 + erf(g * sqrt(1/2)))) per element in f32, as the Pallas
// body does, with CUDA's erff in place of its Abramowitz & Stegun
// approximation (:102-111: Mosaic has no erf), and rounds once, as the plain
// version (fastdm_tpu_torch/kernels/torch_backend.py gelu_and_mul_torch) does.
// Note the gate is the SECOND half of each row (the reference's layout).
//
// What bounds it on the H100: memory bytes. Each output element reads two
// input elements and writes one (6 bytes in bf16) for ~25 f32 operations
// (erff's polynomial included), below the ~20 op/byte that f32 outside the
// tensor cores can sustain at 3.35 TB/s: the floor of the SDXL feed-forward
// at 1024x2048 with CFG, (2, 8192, 5120) -> (2, 8192, 2560), is
// 251.7 MB / 3.35 TB/s = 0.075 ms.
//
// Design: one pass, one 128-thread block per row; each thread loads 16 bytes
// of the row's first half and the matching 16 bytes of its second half
// (8 bf16 or 4 f32 of each), so every input byte is read once with full-width
// coalesced accesses and the output is written with 16-byte stores. Rows are
// addressed with a row stride, so a strided view (a column slice of a wider
// projection output) is read in place. A row whose half-width, stride or base
// is not 16-byte aligned takes the same kernel with one element per access.
// The Pallas version padded the row count to its VMEM tile; here a block per
// row needs no tail handling across rows.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float gelu_mul(float h, float g) {
  return h * (0.5f * g * (1.0f + erff(g * 0.70710678118654752f)));
}

template <typename T>
struct Vec;  // VEC elements of T moved as one access

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  __device__ static void to_float(const Raw& r, float (&f)[kN]) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const float2 t = __bfloat1622float2(p[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static Raw from_float(const float (&f)[kN]) {
    Raw r;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return r;
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  __device__ static void to_float(const Raw& r, float (&f)[kN]) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
  __device__ static Raw from_float(const float (&f)[kN]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

__device__ __forceinline__ float load_scalar(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_scalar(const float* p) { return *p; }
__device__ __forceinline__ void store_scalar(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_scalar(float* p, float v) { *p = v; }

// One block per row; kVec: 16-byte accesses (the row is 16-byte aligned in
// both halves and d is a multiple of the vector width) or one element each.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
gelu_mul_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t row_stride, int d) {
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * row_stride;
  T* yr = out + static_cast<int64_t>(blockIdx.x) * d;
  if constexpr (kVec) {
    using V = Vec<T>;
    constexpr int kN = V::kN;
    const int nv = d / kN;
    const typename V::Raw* hv = reinterpret_cast<const typename V::Raw*>(xr);
    const typename V::Raw* gv = reinterpret_cast<const typename V::Raw*>(xr + d);
    typename V::Raw* ov = reinterpret_cast<typename V::Raw*>(yr);
    for (int c = threadIdx.x; c < nv; c += kThreads) {
      float h[kN], g[kN];
      V::to_float(__ldg(hv + c), h);
      V::to_float(__ldg(gv + c), g);
#pragma unroll
      for (int i = 0; i < kN; ++i) h[i] = gelu_mul(h[i], g[i]);
      ov[c] = V::from_float(h);
    }
  } else {
    for (int c = threadIdx.x; c < d; c += kThreads)
      store_scalar(yr + c, gelu_mul(load_scalar(xr + c), load_scalar(xr + d + c)));
  }
}

template <typename T>
int launch(const void* x, void* out, long long n_rows, long long row_stride, int d,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  constexpr int kN = Vec<T>::kN;
  const bool vec = d % kN == 0 && row_stride % kN == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(n_rows));
  if (vec)
    gelu_mul_kernel<T, true><<<grid, kThreads, 0, stream>>>(xp, op, row_stride, d);
  else
    gelu_mul_kernel<T, false><<<grid, kThreads, 0, stream>>>(xp, op, row_stride, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: rows of 2d elements, row stride `row_stride` elements (>= 2d), element
// type bf16 (is_f32 = 0) or f32 (is_f32 = 1); out: contiguous (n_rows, d) of
// the same type. n_rows must be below 2^31.
FDM_EXPORT int fdm_gelu_and_mul(const void* x, void* out, long long n_rows,
                                long long row_stride, int d, int is_f32, void* stream) {
  if (n_rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f32 ? launch<float>(x, out, n_rows, row_stride, d, s)
                : launch<__nv_bfloat16>(x, out, n_rows, row_stride, d, s);
}

FDM_DEFINE_ERROR_STRING(fdm_gelu_and_mul)
