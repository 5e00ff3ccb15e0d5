// Fused RMSNorm(q) + RMSNorm(k) over the full width D, each rounded to bf16,
// then rotary embedding of both in either pair layout (interleaved, as Wan
// runs it, or half-split), bf16 in and out, f32 math.
//
// Replaces: fastdm_tpu/kernels/pallas/elementwise.py qk_norm_rope_pallas
// (:341, pallas_call :398) and qk_norm_rope2_pallas (:416, pallas_call :465),
// kernel bodies _qk_norm_rope_kernel (:277), _qk_norm_rope2_kernel (:299) and
// their shared _norm_rope_both (:311). Both entry points below go through one
// launcher on one device function per path, so the split-QKV form computes
// exactly what the fused form computes.
//
// Per token row: the sum of squares runs over all D = heads * head_dim
// elements (Wan's rms_norm_across_heads, not per head); y = x * (1 /
// sqrt(mean + eps)) * gamma in f32, rounded to bf16 (the Pallas kernel's
// rounding point, elementwise.py:318, and the plain version's); then each
// pair (y1, y2) of a head -- columns (2p, 2p + 1) interleaved, (p, p +
// head_dim/2) half-split (the Pallas kernel's is_neox branch,
// elementwise.py:328-331) -- becomes (y1*cos - y2*sin, y2*cos + y1*sin) with
// the f32 (S, head_dim/2) tables, computed without contraction
// (__fmul_rn / __fsub_rn, as csrc/rope.cu) and rounded once. Against the plain
// version (fastdm_tpu_torch/kernels/torch_backend.py qk_norm_rope2_torch) the
// rotation is bit-exact on equal inputs; the normalized value may sit one bf16
// ulp away (f32 sum order, 1/sqrt vs rsqrt), as in csrc/rmsnorm.cu. gamma is
// read in the dtype it has (bf16 or f32; bf16 -> f32 is exact) or is absent.
// The row helpers are csrc/bf16_rows.cuh's, shared with rmsnorm.cu and rope.cu
// (the half-split rotation of a column group and its tables included).
// Every kernel is a template on the layout; the interleaved instantiations
// compute exactly what they computed before the half-split one existed.
//
// What bounds it on the H100: memory bytes. A Wan2.2-A14B row reads 2 x 5120
// bf16 and writes 2 x 5120 bf16 (40 KB) for ~10 flops per element; at
// 32760 tokens that is 1.34 GB, 0.40 ms at 3.35 TB/s.
//
// Design: q and k are read straight from the model's strided rows (the q and
// k columns of the fused (B, S, 3D) QKV output, or two separate (B, S, D)
// tensors), so neither the q|k slice copy nor the (B*S, head_dim) expanded
// cos/sin tables of the Pallas wrapper exist. One block per token.
//   Fast path (D a multiple of 8 up to 8192, head_dim a multiple of 8
//   interleaved or of 16 half-split, rows, gamma and tables 16-byte aligned;
//   Wan2.2-A14B's 5120, Wan2.2-5B's 3072 and Wan2.1-1.3B's 1536 with 320, 192
//   and 96 threads): a thread owns kVecs fixed 8-column vectors of q and of k
//   and moves them with 16-byte accesses: interleaved, vectors blockDim.x * 8
//   columns apart; half-split, one 8-column group of a head's first half and
//   the same columns of its second half, which share 8 table entries. It
//   issues every load of the row at once (q, k, their cos/sin and gamma
//   vectors, gamma in the dtype it has), so the row is read once (single
//   pass); reduces both sums of squares (warp shuffles, then one
//   shared-memory step and the block's one barrier); then normalizes,
//   rotates and stores from registers. At 64 registers three 320-thread
//   blocks fit on an SM, so one block's loads are in flight while another
//   computes. The half-split form loads its table entries after the
//   reduction (L1 hits: every head of the token reads them) and rotates a
//   word as soon as both halves of it are normalized; with the entries live
//   across the reduction, ptxas spilled 88-96 B at 64 registers.
//   Built and measured slower on the H100 (PERF.md §6): a persistent grid
//   holding gamma in registers with the next token's row in a second
//   register buffer (174-216 registers, one or two blocks of 5 warps per SM),
//   with or without an L2 prefetch of later rows, and a persistent
//   cp.async.bulk ring of rows in shared memory.
//   Tail path (any other width or alignment the wrapper accepts: even
//   head_dim, 4-byte aligned rows): 256 threads, 4-byte pairs, pass 1
//   reducing both sums and pass 2 re-reading the row (half-split: one pair of
//   two scalar elements half a head apart per thread and step).
#include "bf16_rows.cuh"

namespace {

using namespace bf16_rows;

constexpr int kVecs = 2;       // vectors of q (and of k) per thread, fast path
constexpr int kMaxThreads = 512;
constexpr int kMaxFastDim = kMaxThreads * kVecs * kVec;  // 8192
constexpr int kRowThreads = 256;  // tail path
constexpr int kRowWarps = kRowThreads / 32;

// The normalized pair (y0, y1) rounded to bf16, rotated by (c, sn) without
// contraction, rounded once.
__device__ __forceinline__ __nv_bfloat162 rope_pair(float y0, float y1, float c, float sn) {
  const float2 r = __bfloat1622float2(__floats2bfloat162_rn(y0, y1));
  return __floats2bfloat162_rn(rot1(r.x, r.y, c, sn), rot2(r.x, r.y, c, sn));
}

// ----------------------------------------------------------------- fast path

// The q and k rows of token t = b * seq + s.
struct Rows {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  int64_t q_sb, q_ss, k_sb, k_ss;
  int seq, dim;

  __device__ __forceinline__ const __nv_bfloat16* q_row(int t) const {
    const int b = t / seq;
    return q + b * q_sb + static_cast<int64_t>(t - b * seq) * q_ss;
  }
  __device__ __forceinline__ const __nv_bfloat16* k_row(int t) const {
    const int b = t / seq;
    return k + b * k_sb + static_cast<int64_t>(t - b * seq) * k_ss;
  }
};

// Normalize, scale, rotate and round one vector (its 4 pairs' table entries
// in c4, s4), packed for one 16-byte store.
template <int G>
__device__ __forceinline__ uint4 norm_rope_vec(const uint4& x, const GammaVec<G>& g, float inv,
                                               const float4& c4, const float4& s4) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  const float c[4] = {c4.x, c4.y, c4.z, c4.w}, sn[4] = {s4.x, s4.y, s4.z, s4.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float y0 = g.apply(bf16_lo(w[j]) * inv, 2 * j);
    const float y1 = g.apply(bf16_hi(w[j]) * inv, 2 * j + 1);
    const __nv_bfloat162 r = rope_pair(y0, y1, c[j], sn[j]);
    o[j] = *reinterpret_cast<const uint32_t*>(&r);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Column of this thread's vector i: interleaved, vectors blockDim.x * 8
// columns apart; half-split, column group threadIdx.x of a head's first half
// (i = 0) and the same columns of its second half (i = 1). At or past dim:
// no vector.
template <bool kNeox>
__device__ __forceinline__ int vec_col(int i, int head_dim) {
  if constexpr (kNeox) {
    const int groups = head_dim / (2 * kVec);  // column groups of a head's half
    const int h = threadIdx.x / groups;
    return h * head_dim + (threadIdx.x - h * groups) * kVec + i * (head_dim / 2);
  } else {
    return (i * blockDim.x + threadIdx.x) * kVec;
  }
}

// Half-split: vectors x1 (8 columns of a head's first half) and x2 (the same
// columns of its second half) normalized, scaled and rounded to bf16 a word at
// a time, each word rotated against its partner as soon as both exist (as
// norm_rope_vec does for a pair), so that few values are live at once;
// results in x1, x2.
template <int G>
__device__ __forceinline__ void norm_rope_half_split(uint4& x1, uint4& x2, const GammaVec<G>& g1,
                                                     const GammaVec<G>& g2, float inv,
                                                     const GroupTables<true>& t) {
  uint32_t w1[4] = {x1.x, x1.y, x1.z, x1.w}, w2[4] = {x2.x, x2.y, x2.z, x2.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w1[j] = pack_bf16x2(g1.apply(bf16_lo(w1[j]) * inv, 2 * j),
                        g1.apply(bf16_hi(w1[j]) * inv, 2 * j + 1));
    w2[j] = pack_bf16x2(g2.apply(bf16_lo(w2[j]) * inv, 2 * j),
                        g2.apply(bf16_hi(w2[j]) * inv, 2 * j + 1));
    rotate_half_split_word(w1[j], w2[j], t, 2 * j);
  }
  x1 = make_uint4(w1[0], w1[1], w1[2], w1[3]);
  x2 = make_uint4(w2[0], w2[1], w2[2], w2[3]);
}

// At least two blocks of kMaxThreads per SM: 64 registers, which ptxas meets
// without spills unless gamma is f32 (81 registers then, one block).
template <int G, bool kNeox>
__global__ void __launch_bounds__(kMaxThreads, G == kGammaF32 ? 1 : 2)
qk_norm_rope_vec_kernel(const Rows rows, const void* __restrict__ gq, const void* __restrict__ gk,
                        const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                        __nv_bfloat16* __restrict__ qo, __nv_bfloat16* __restrict__ ko,
                        int head_dim, float eps) {
  __shared__ float red[2][kMaxThreads / 32];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dim = rows.dim, half = head_dim / 2, t = blockIdx.x, s = t % rows.seq;
  const __nv_bfloat16* qr = rows.q_row(t);
  const __nv_bfloat16* kr = rows.k_row(t);
  // vector i of this thread starts at column vec_col<kNeox>(i, head_dim)
  uint4 xq[kVecs], xk[kVecs];
  float4 cv[kVecs], sv[kVecs];  // interleaved: each vector's 4 pairs
  GammaVec<G> gqv[kVecs], gkv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = vec_col<kNeox>(i, head_dim);
    xq[i] = xk[i] = make_uint4(0u, 0u, 0u, 0u);
    if (c < dim) {
      xq[i] = __ldg(reinterpret_cast<const uint4*>(qr + c));
      xk[i] = __ldg(reinterpret_cast<const uint4*>(kr + c));
      if constexpr (!kNeox) {
        const int64_t at = static_cast<int64_t>(s) * half + (c % head_dim) / 2;
        cv[i] = __ldg(reinterpret_cast<const float4*>(cos_t + at));
        sv[i] = __ldg(reinterpret_cast<const float4*>(sin_t + at));
      }
      gqv[i].load(gq, c);
      gkv[i].load(gk, c);
    }
  }
  float sq = 0.f, sk = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    sq += sum_sq(xq[i]);
    sk += sum_sq(xk[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
    sk += __shfl_xor_sync(0xffffffffu, sk, o);
  }
  if (lane == 0) {
    red[0][warp] = sq;
    red[1][warp] = sk;
  }
  __syncthreads();
  sq = 0.f;
  sk = 0.f;
  for (int w = 0; w < warps; ++w) {
    sq += red[0][w];
    sk += red[1][w];
  }
  const float inv_q = rms_inverse(sq, dim, eps), inv_k = rms_inverse(sk, dim, eps);
  __nv_bfloat16* qd = qo + static_cast<int64_t>(t) * dim;
  __nv_bfloat16* kd = ko + static_cast<int64_t>(t) * dim;
  if constexpr (kNeox) {
    // the group's 8 table entries are loaded after the reduction (from L1:
    // every head of the token reads them), so that they are not live across
    // it; loaded with the row, they made ptxas spill at 64 registers
    const int c = vec_col<true>(0, head_dim), c2 = c + half;
    if (c < dim) {
      GroupTables<true> tab;
      const int64_t at = static_cast<int64_t>(s) * half + c % head_dim;
      tab.load(cos_t + at, sin_t + at);
      norm_rope_half_split<G>(xq[0], xq[1], gqv[0], gqv[1], inv_q, tab);
      *reinterpret_cast<uint4*>(qd + c) = xq[0];
      *reinterpret_cast<uint4*>(qd + c2) = xq[1];
      norm_rope_half_split<G>(xk[0], xk[1], gkv[0], gkv[1], inv_k, tab);
      *reinterpret_cast<uint4*>(kd + c) = xk[0];
      *reinterpret_cast<uint4*>(kd + c2) = xk[1];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int c = (i * blockDim.x + threadIdx.x) * kVec;
      if (c < dim) {
        *reinterpret_cast<uint4*>(qd + c) = norm_rope_vec<G>(xq[i], gqv[i], inv_q, cv[i], sv[i]);
        *reinterpret_cast<uint4*>(kd + c) = norm_rope_vec<G>(xk[i], gkv[i], inv_k, cv[i], sv[i]);
      }
    }
  }
}

// ----------------------------------------------------------------- tail path

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One row of q or k: normalize the pair at column col, scale by gamma, round
// to bf16, rotate with (c, sn), round and store.
template <int G>
__device__ __forceinline__ void norm_rope_pair(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                               const void* gamma, float inv, float c, float sn,
                                               int col) {
  const float2 x = load_pair(src + col);
  const float y0 = times_gamma<G>(x.x * inv, gamma, col);
  const float y1 = times_gamma<G>(x.y * inv, gamma, col + 1);
  *reinterpret_cast<__nv_bfloat162*>(dst + col) = rope_pair(y0, y1, c, sn);
}

// The half-split pair (c1, c2 = c1 + head_dim/2) of one row: both normalized,
// scaled by gamma and rounded to bf16, then rotated, rounded and stored.
template <int G>
__device__ __forceinline__ void norm_rope_split(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                                const void* gamma, float inv, float c, float sn,
                                                int c1, int c2) {
  const float y1 = times_gamma<G>(__bfloat162float(src[c1]) * inv, gamma, c1);
  const float y2 = times_gamma<G>(__bfloat162float(src[c2]) * inv, gamma, c2);
  const float r1 = __bfloat162float(__float2bfloat16_rn(y1));
  const float r2 = __bfloat162float(__float2bfloat16_rn(y2));
  dst[c1] = __float2bfloat16_rn(rot1(r1, r2, c, sn));
  dst[c2] = __float2bfloat16_rn(rot2(r1, r2, c, sn));
}

template <int G, bool kNeox>
__global__ void __launch_bounds__(kRowThreads)
qk_norm_rope_row_kernel(const Rows rows, const void* __restrict__ gq, const void* __restrict__ gk,
                        const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                        __nv_bfloat16* __restrict__ qo, __nv_bfloat16* __restrict__ ko,
                        int head_dim, float eps) {
  __shared__ float red[2][kRowWarps];
  const int token = blockIdx.x;  // b * seq + s
  const int s = token % rows.seq, dim = rows.dim;
  const __nv_bfloat16* qr = rows.q_row(token);
  const __nv_bfloat16* kr = rows.k_row(token);

  float sq = 0.f, sk = 0.f;
  for (int c = threadIdx.x * 2; c < dim; c += kRowThreads * 2) {
    const float2 a = load_pair(qr + c), e = load_pair(kr + c);
    sq += a.x * a.x + a.y * a.y;
    sk += e.x * e.x + e.y * e.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
    sk += __shfl_xor_sync(0xffffffffu, sk, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = sq;
    red[1][warp] = sk;
  }
  __syncthreads();
  sq = 0.f;
  sk = 0.f;
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) {
    sq += red[0][w];
    sk += red[1][w];
  }
  const float inv_q = rms_inverse(sq, dim, eps), inv_k = rms_inverse(sk, dim, eps);

  const int half = head_dim / 2;
  const float* cs = cos_t + static_cast<int64_t>(s) * half;
  const float* sn = sin_t + static_cast<int64_t>(s) * half;
  __nv_bfloat16* qd = qo + static_cast<int64_t>(token) * dim;
  __nv_bfloat16* kd = ko + static_cast<int64_t>(token) * dim;
  if constexpr (kNeox) {
    for (int j = threadIdx.x; j < dim / 2; j += kRowThreads) {  // pair j of the row
      const int h = j / half, p = j - h * half, c1 = h * head_dim + p;
      norm_rope_split<G>(qr, qd, gq, inv_q, cs[p], sn[p], c1, c1 + half);
      norm_rope_split<G>(kr, kd, gk, inv_k, cs[p], sn[p], c1, c1 + half);
    }
  } else {
    for (int c = threadIdx.x * 2; c < dim; c += kRowThreads * 2) {
      const int p = (c % head_dim) / 2;
      const float cv = cs[p], sv = sn[p];
      norm_rope_pair<G>(qr, qd, gq, inv_q, cv, sv, c);
      norm_rope_pair<G>(kr, kd, gk, inv_k, cv, sv, c);
    }
  }
}

// --------------------------------------------------------------------- launch

bool fast_path(const Rows& r, const void* gq, const void* gk, const void* cos_t,
               const void* sin_t, const void* qo, const void* ko, int head_dim, bool neox) {
  return r.dim % kVec == 0 && r.dim <= kMaxFastDim && head_dim % (neox ? 2 * kVec : kVec) == 0 &&
         r.q_sb % kVec == 0 && r.q_ss % kVec == 0 && r.k_sb % kVec == 0 && r.k_ss % kVec == 0 &&
         aligned(r.q, 16) && aligned(r.k, 16) && aligned(gq, 16) && aligned(gk, 16) &&
         aligned(cos_t, 16) && aligned(sin_t, 16) && aligned(qo, 16) && aligned(ko, 16);
}

template <int G, bool kNeox>
int launch_kind(const Rows& r, const void* gq, const void* gk, const float* cos_t,
                const float* sin_t, __nv_bfloat16* qo, __nv_bfloat16* ko, int tokens,
                int head_dim, float eps, cudaStream_t stream) {
  if (fast_path(r, gq, gk, cos_t, sin_t, qo, ko, head_dim, kNeox)) {
    // whole warps covering dim / 8 vectors, kVecs per thread
    const int threads = 32 * ((r.dim + 32 * kVecs * kVec - 1) / (32 * kVecs * kVec));
    qk_norm_rope_vec_kernel<G, kNeox><<<static_cast<unsigned>(tokens), threads, 0, stream>>>(
        r, gq, gk, cos_t, sin_t, qo, ko, head_dim, eps);
  } else {
    qk_norm_rope_row_kernel<G, kNeox><<<static_cast<unsigned>(tokens), kRowThreads, 0, stream>>>(
        r, gq, gk, cos_t, sin_t, qo, ko, head_dim, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kNeox>
int launch_layout(const Rows& r, const void* gq, const void* gk, int gamma_kind,
                  const float* cos_t, const float* sin_t, __nv_bfloat16* qo, __nv_bfloat16* ko,
                  int tokens, int head_dim, float eps, cudaStream_t st) {
  if (gamma_kind == kGammaBf16)
    return launch_kind<kGammaBf16, kNeox>(r, gq, gk, cos_t, sin_t, qo, ko, tokens, head_dim,
                                          eps, st);
  if (gamma_kind == kGammaF32)
    return launch_kind<kGammaF32, kNeox>(r, gq, gk, cos_t, sin_t, qo, ko, tokens, head_dim, eps,
                                         st);
  return launch_kind<kNoGamma, kNeox>(r, gq, gk, cos_t, sin_t, qo, ko, tokens, head_dim, eps,
                                      st);
}

int launch(const void* q, const void* k, long long q_sb, long long q_ss, long long k_sb,
           long long k_ss, const void* gq, const void* gk, int gamma_kind, const void* cos_t,
           const void* sin_t, void* qo, void* ko, int batch, int seq, int dim, int head_dim,
           int neox, float eps, void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  if (dim <= 0 || head_dim <= 0 || head_dim % 2 != 0 || dim % head_dim != 0 ||
      (gamma_kind != kNoGamma) != (gq != nullptr && gk != nullptr) ||
      gamma_kind < kNoGamma || gamma_kind > kGammaF32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows r{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
               q_sb, q_ss, k_sb, k_ss, seq, dim};
  const float* cs = static_cast<const float*>(cos_t);
  const float* sn = static_cast<const float*>(sin_t);
  __nv_bfloat16* qd = static_cast<__nv_bfloat16*>(qo);
  __nv_bfloat16* kd = static_cast<__nv_bfloat16*>(ko);
  const int tokens = batch * seq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (neox)
    return launch_layout<true>(r, gq, gk, gamma_kind, cs, sn, qd, kd, tokens, head_dim, eps, st);
  return launch_layout<false>(r, gq, gk, gamma_kind, cs, sn, qd, kd, tokens, head_dim, eps, st);
}

}  // namespace

// Fused form: qkv (B, S, W) bf16 with batch/seq strides qkv_sb/qkv_ss
// (elements), last dim contiguous; q = columns [0, dim), k = [dim, 2 dim).
// gq/gk: (dim,) contiguous, both bf16 (gamma_kind 1) or both f32 (2), or both
// NULL (0); cos/sin: contiguous f32 (S, head_dim/2); qo/ko: contiguous bf16
// (B, S, dim). dim a multiple of head_dim, head_dim even, pointers and strides
// 4-byte aligned. neox: 0 interleaved pairs, 1 half-split.
FDM_EXPORT int fdm_qk_norm_rope_bf16(const void* qkv, long long qkv_sb, long long qkv_ss,
                                     const void* gq, const void* gk, int gamma_kind,
                                     const void* cos_t, const void* sin_t, void* qo, void* ko,
                                     int batch, int seq, int dim, int head_dim, int neox,
                                     float eps, void* stream) {
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  return launch(base, base + dim, qkv_sb, qkv_ss, qkv_sb, qkv_ss, gq, gk, gamma_kind, cos_t,
                sin_t, qo, ko, batch, seq, dim, head_dim, neox, eps, stream);
}

// Two-operand form: q and k (B, S, dim) bf16, each with its own batch/seq
// strides; otherwise as above.
FDM_EXPORT int fdm_qk_norm_rope2_bf16(const void* q, const void* k, long long q_sb,
                                      long long q_ss, long long k_sb, long long k_ss,
                                      const void* gq, const void* gk, int gamma_kind,
                                      const void* cos_t, const void* sin_t, void* qo, void* ko,
                                      int batch, int seq, int dim, int head_dim, int neox,
                                      float eps, void* stream) {
  return launch(q, k, q_sb, q_ss, k_sb, k_ss, gq, gk, gamma_kind, cos_t, sin_t, qo, ko, batch,
                seq, dim, head_dim, neox, eps, stream);
}

FDM_DEFINE_ERROR_STRING(fdm_qk_norm_rope)
