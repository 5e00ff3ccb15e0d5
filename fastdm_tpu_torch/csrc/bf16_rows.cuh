// Helpers of the row kernels that move bf16 rows with 16-byte accesses and
// compute in f32 (csrc/rmsnorm.cu, csrc/rope.cu, csrc/qk_norm_rope.cu): bf16
// unpacking and packing, streaming (evict-first) loads and stores, the
// rotation of one pair without contraction, the RoPE tables of a column group
// and its half-split rotation, and for the norms the weight
// (gamma) in the dtype it has, the sum of squares of one 8-column vector, the
// IEEE inverse root and the normalised vector packed for one 16-byte store.
#pragma once

#include "common.cuh"

namespace bf16_rows {

constexpr int kVec = 8;  // bf16 columns of one 16-byte access

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// gamma_kind of the C launchers: no weight, bf16 or f32 weights
enum GammaKind { kNoGamma = 0, kGammaBf16 = 1, kGammaF32 = 2 };

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint4 load_stream(const __nv_bfloat16* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store_stream(__nv_bfloat16* p, const uint4& v) {
  __stcs(reinterpret_cast<uint4*>(p), v);
}

// The pair (x1, x2) rotated by (c, s): (x1*c - x2*s, x2*c + x1*s) in f32
// without contraction (the _rn intrinsics), as the plain version rounds.
__device__ __forceinline__ float rot1(float x1, float x2, float c, float s) {
  return __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
}
__device__ __forceinline__ float rot2(float x1, float x2, float c, float s) {
  return __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

// The RoPE table entries of one column group of a head, loaded once per
// token with 16-byte loads: 4 pairs interleaved (one float4 of cos, one of
// sin), 8 half-split (two of each). Shared by rope.cu and qk_norm_rope.cu.
template <bool kNeox>
struct GroupTables {
  static constexpr int kPairs = kNeox ? 8 : 4;
  float c[kPairs], s[kPairs];

  __device__ __forceinline__ void load(const float* cos_row, const float* sin_row) {
#pragma unroll
    for (int i = 0; i < kPairs / 4; ++i) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(cos_row) + i);
      const float4 b = __ldg(reinterpret_cast<const float4*>(sin_row) + i);
      c[4 * i] = a.x, c[4 * i + 1] = a.y, c[4 * i + 2] = a.z, c[4 * i + 3] = a.w;
      s[4 * i] = b.x, s[4 * i + 1] = b.y, s[4 * i + 2] = b.z, s[4 * i + 3] = b.w;
    }
  }
};

// Half-split pairs p and p + 1: wa holds their x1 (2 bf16 of a head's first
// half), wb their x2 (the same columns of its second half); rotated in place,
// each result rounded once.
__device__ __forceinline__ void rotate_half_split_word(uint32_t& wa, uint32_t& wb,
                                                       const GroupTables<true>& t, int p) {
  const float a0 = bf16_lo(wa), a1 = bf16_hi(wa), b0 = bf16_lo(wb), b1 = bf16_hi(wb);
  wa = pack_bf16x2(rot1(a0, b0, t.c[p], t.s[p]), rot1(a1, b1, t.c[p + 1], t.s[p + 1]));
  wb = pack_bf16x2(rot2(a0, b0, t.c[p], t.s[p]), rot2(a1, b1, t.c[p + 1], t.s[p + 1]));
}

// Half-split: a holds x1 of pairs 0..7 (8 bf16 of a head's first half), b
// their x2; rotated in place.
__device__ __forceinline__ void rotate_half_split(uint4& a, uint4& b, const GroupTables<true>& t) {
  uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) rotate_half_split_word(wa[j], wb[j], t, 2 * j);
  a = make_uint4(wa[0], wa[1], wa[2], wa[3]);
  b = make_uint4(wb[0], wb[1], wb[2], wb[3]);
}

// y * gamma[col] in f32 (y unchanged without gamma): the scalar form
template <int G>
__device__ __forceinline__ float times_gamma(float y, const void* g, int col) {
  if constexpr (G == kGammaBf16)
    return y * __bfloat162float(static_cast<const __nv_bfloat16*>(g)[col]);
  else if constexpr (G == kGammaF32)
    return y * static_cast<const float*>(g)[col];
  else
    return y;
}

// The gamma of one 8-column vector, held in registers as loaded: 8 bf16
// (4 words) or 8 f32, widened when applied (bf16 -> f32 is exact).
template <int G>
struct GammaVec {  // kNoGamma
  __device__ __forceinline__ void load(const void*, int) {}
  __device__ __forceinline__ float apply(float y, int) const { return y; }
};

template <>
struct GammaVec<kGammaBf16> {
  uint4 v;
  __device__ __forceinline__ void load(const void* g, int col) {
    v = __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(g) + col));
  }
  __device__ __forceinline__ float apply(float y, int e) const {
    const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
    return y * (e % 2 ? bf16_hi(w) : bf16_lo(w));
  }
};

template <>
struct GammaVec<kGammaF32> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const void* g, int col) {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(g) + col);
    lo = __ldg(p);
    hi = __ldg(p + 1);
  }
  __device__ __forceinline__ float apply(float y, int e) const {
    const float4& f = e < 4 ? lo : hi;
    const int i = e % 4;
    return y * (i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w);
  }
};

__device__ __forceinline__ float sum_sq(const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float a = bf16_lo(w[j]), b = bf16_hi(w[j]);
    s += a * a + b * b;
  }
  return s;
}

// IEEE sqrt and division (no fast-math): the plain version's rsqrt is matched
// to within one bf16 rounding step of the output.
__device__ __forceinline__ float rms_inverse(float sum_sq, int dim, float eps) {
  return 1.0f / sqrtf(sum_sq / static_cast<float>(dim) + eps);
}

// x * inv * gamma of one vector in f32, rounded once to bf16 and packed for
// one 16-byte store.
template <int G>
__device__ __forceinline__ uint4 norm_vec(const uint4& x, const GammaVec<G>& g, float inv) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = pack_bf16x2(g.apply(bf16_lo(w[j]) * inv, 2 * j),
                       g.apply(bf16_hi(w[j]) * inv, 2 * j + 1));
  return make_uint4(o[0], o[1], o[2], o[3]);
}

}  // namespace bf16_rows
