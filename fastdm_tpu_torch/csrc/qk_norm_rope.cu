// Fused RMSNorm(q) + RMSNorm(k) over the full width D, each rounded to bf16,
// then interleaved rotary embedding of both, bf16 in and out, f32 math.
//
// Replaces: fastdm_tpu/kernels/pallas/elementwise.py qk_norm_rope_pallas
// (:341, pallas_call :398) and qk_norm_rope2_pallas (:416, pallas_call :465),
// kernel bodies _qk_norm_rope_kernel (:277), _qk_norm_rope2_kernel (:299) and
// their shared _norm_rope_both (:311). Both entry points below launch one
// kernel on one device function, so the split-QKV form computes exactly what
// the fused form computes.
//
// Per token row: the sum of squares runs over all D = heads * head_dim
// elements (Wan's rms_norm_across_heads, not per head); y = x * (1 /
// sqrt(mean + eps)) * gamma in f32, rounded to bf16 (the Pallas kernel's
// rounding point, elementwise.py:318, and the plain version's); then each
// interleaved pair (y1, y2) of a head becomes (y1*cos - y2*sin, y2*cos +
// y1*sin) with the f32 (S, head_dim/2) tables, computed without contraction
// (__fmul_rn / __fsub_rn, as csrc/rope.cu) and rounded once. Against the plain
// version (fastdm_tpu_torch/kernels/torch_backend.py qk_norm_rope2_torch) the
// rotation is bit-exact on equal inputs; the normalized value may sit one bf16
// ulp away (f32 sum order, 1/sqrt vs rsqrt), as in csrc/rmsnorm.cu.
//
// What bounds it on the H100: memory bytes. A Wan2.2-A14B row reads 2 x 5120
// bf16 and writes 2 x 5120 bf16 (40 KB) for ~10 flops per element; at
// 32760 tokens that is 1.34 GB, 0.40 ms at 3.35 TB/s.
//
// Design: one block per token; q and k are read straight from the model's
// strided rows (the q and k columns of the fused (B, S, 3D) QKV output, or two
// separate (B, S, D) tensors), so neither the q|k slice copy nor the
// (B*S, head_dim) expanded cos/sin tables of the Pallas wrapper exist. Pass 1
// reduces both sums of squares at once (warp shuffles, then one shared-memory
// step); pass 2 re-reads the 20 KB row (an L1/L2 hit) and writes both outputs.
// Each thread moves 4-byte bf16 pairs, so a warp covers 128 contiguous bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One row of q or k: normalize the pair at column 2p, round to bf16, rotate
// with table entry (s, p mod half), round and store.
__device__ __forceinline__ void norm_rope_pair(const __nv_bfloat16* src, __nv_bfloat16* dst,
                                               const float* gamma, float inv, float c,
                                               float sn, int col) {
  const float2 x = load_pair(src + col);
  float y0 = x.x * inv, y1 = x.y * inv;
  if (gamma != nullptr) {
    y0 *= gamma[col];
    y1 *= gamma[col + 1];
  }
  const float2 r = __bfloat1622float2(__floats2bfloat162_rn(y0, y1));
  const float o1 = __fsub_rn(__fmul_rn(r.x, c), __fmul_rn(r.y, sn));
  const float o2 = __fadd_rn(__fmul_rn(r.y, c), __fmul_rn(r.x, sn));
  *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(o1, o2);
}

__global__ void __launch_bounds__(kThreads)
qk_norm_rope_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                    const float* __restrict__ gq, const float* __restrict__ gk,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                    __nv_bfloat16* __restrict__ qo, __nv_bfloat16* __restrict__ ko,
                    int seq, int dim, int head_dim, float eps) {
  __shared__ float red[2][kWarps];
  const int token = blockIdx.x;  // b * seq + s
  const int b = token / seq, s = token - b * seq;
  const __nv_bfloat16* qr = q + b * q_sb + s * q_ss;
  const __nv_bfloat16* kr = k + b * k_sb + s * k_ss;

  float sq = 0.f, sk = 0.f;
  for (int c = threadIdx.x * 2; c < dim; c += kThreads * 2) {
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
  for (int w = 0; w < kWarps; ++w) {
    sq += red[0][w];
    sk += red[1][w];
  }
  // IEEE sqrt and division (no fast-math), as csrc/rmsnorm.cu
  const float inv_q = 1.0f / sqrtf(sq / static_cast<float>(dim) + eps);
  const float inv_k = 1.0f / sqrtf(sk / static_cast<float>(dim) + eps);

  const int half = head_dim / 2;
  const float* cs = cos_t + static_cast<int64_t>(s) * half;
  const float* sn = sin_t + static_cast<int64_t>(s) * half;
  __nv_bfloat16* qd = qo + static_cast<int64_t>(token) * dim;
  __nv_bfloat16* kd = ko + static_cast<int64_t>(token) * dim;
  for (int c = threadIdx.x * 2; c < dim; c += kThreads * 2) {
    const int p = (c % head_dim) / 2;
    const float cv = cs[p], sv = sn[p];
    norm_rope_pair(qr, qd, gq, inv_q, cv, sv, c);
    norm_rope_pair(kr, kd, gk, inv_k, cv, sv, c);
  }
}

int launch(const void* q, const void* k, long long q_sb, long long q_ss, long long k_sb,
           long long k_ss, const void* gq, const void* gk, const void* cos_t,
           const void* sin_t, void* qo, void* ko, int batch, int seq, int dim, int head_dim,
           float eps, void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  qk_norm_rope_kernel<<<static_cast<unsigned>(batch * seq), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k), q_sb, q_ss,
      k_sb, k_ss, static_cast<const float*>(gq), static_cast<const float*>(gk),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(qo), static_cast<__nv_bfloat16*>(ko), seq, dim, head_dim,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Fused form: qkv (B, S, W) bf16 with batch/seq strides qkv_sb/qkv_ss
// (elements), last dim contiguous; q = columns [0, dim), k = [dim, 2 dim).
// gq/gk: f32 (dim,) or both NULL; cos/sin: contiguous f32 (S, head_dim/2);
// qo/ko: contiguous bf16 (B, S, dim). dim a multiple of head_dim, head_dim
// even, pointers and strides 4-byte aligned.
FDM_EXPORT int fdm_qk_norm_rope_bf16(const void* qkv, long long qkv_sb, long long qkv_ss,
                                     const void* gq, const void* gk, const void* cos_t,
                                     const void* sin_t, void* qo, void* ko, int batch, int seq,
                                     int dim, int head_dim, float eps, void* stream) {
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  return launch(base, base + dim, qkv_sb, qkv_ss, qkv_sb, qkv_ss, gq, gk, cos_t, sin_t, qo, ko,
                batch, seq, dim, head_dim, eps, stream);
}

// Two-operand form: q and k (B, S, dim) bf16, each with its own batch/seq
// strides; otherwise as above.
FDM_EXPORT int fdm_qk_norm_rope2_bf16(const void* q, const void* k, long long q_sb,
                                      long long q_ss, long long k_sb, long long k_ss,
                                      const void* gq, const void* gk, const void* cos_t,
                                      const void* sin_t, void* qo, void* ko, int batch,
                                      int seq, int dim, int head_dim, float eps,
                                      void* stream) {
  return launch(q, k, q_sb, q_ss, k_sb, k_ss, gq, gk, cos_t, sin_t, qo, ko, batch, seq, dim,
                head_dim, eps, stream);
}

FDM_DEFINE_ERROR_STRING(fdm_qk_norm_rope)
