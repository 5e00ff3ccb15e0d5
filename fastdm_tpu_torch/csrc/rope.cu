// Rotary position embedding of q and k in one launch, bf16 in and out,
// interleaved pairs (FLUX). The half-split (neox) layout has only its plain
// version so far; the wrapper raises for it on the card.
//
// Replaces: fastdm_tpu/kernels/pallas/elementwise.py rotary_pos_embedding_pallas
// (:483), kernel bodies _rope_one (:254) / _rope_kernel (:236). Each rotation
// pair (x1, x2) becomes (x1*cos - x2*sin, x2*cos + x1*sin), computed in f32 with
// no fused multiply-add (the _rn intrinsics stop the compiler from contracting)
// and rounded once to bf16, exactly as the plain version
// (fastdm_tpu_torch/kernels/torch_backend.py _rotate) rounds.
//
// What bounds it on the H100: memory bytes (6 flops per 4 bytes of q/k moved).
// Design: cos/sin are read per (position, pair) from the (S, D/2) f32 tables.
// The Pallas version expanded them to full-width (S, H*D) tables in HBM
// because Mosaic has no strided gather (elementwise.py:237-240, :490-503); here
// a table entry is one load that every head of the position shares through the
// L1/L2 caches. Interleaved pairs are adjacent, so each thread moves one
// 4-byte bf16 pair and a warp covers 128 contiguous bytes. Grid: x = token
// (b, s), y = chunks of the q and k pairs of that token, so one launch
// rotates both tensors and the index math is 32-bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rope_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 __nv_bfloat16* __restrict__ qo, __nv_bfloat16* __restrict__ ko,
                 const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                 int seq, int hq, int hkv, int dim,
                 int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss) {
  const int token = blockIdx.x;  // b * seq + s
  const int b = token / seq, s = token - b * seq;
  const int half = dim / 2;
  const int nq = hq * half;
  int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= nq + hkv * half) return;

  const __nv_bfloat16* src;
  __nv_bfloat16* dst;
  if (j < nq) {
    src = q + b * q_sb + s * q_ss;
    dst = qo + static_cast<int64_t>(token) * hq * dim;
  } else {
    j -= nq;
    src = k + b * k_sb + s * k_ss;
    dst = ko + static_cast<int64_t>(token) * hkv * dim;
  }
  const int h = j / half, p = j - h * half;
  src += h * dim;
  dst += h * dim;
  const float c = cos_t[s * half + p], sn = sin_t[s * half + p];

  const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + 2 * p));
  const float o1 = __fsub_rn(__fmul_rn(x.x, c), __fmul_rn(x.y, sn));
  const float o2 = __fadd_rn(__fmul_rn(x.y, c), __fmul_rn(x.x, sn));
  *reinterpret_cast<__nv_bfloat162*>(dst + 2 * p) = __floats2bfloat162_rn(o1, o2);
}

}  // namespace

// q: (B, S, hq*dim) bf16 with batch/seq strides q_sb/q_ss (elements), last dim
// contiguous; k likewise with hkv heads; qo/ko: contiguous outputs of the same
// shapes; cos/sin: contiguous f32 (S, dim/2). dim even; pointers 4-byte aligned.
FDM_EXPORT int fdm_rope_bf16(const void* q, const void* k, void* qo, void* ko,
                             const void* cos_t, const void* sin_t,
                             int batch, int seq, int hq, int hkv, int dim,
                             long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                             void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  const int pairs = (hq + hkv) * (dim / 2);
  const dim3 grid(static_cast<unsigned>(batch * seq), static_cast<unsigned>((pairs + kThreads - 1) / kThreads));
  rope_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<__nv_bfloat16*>(qo), static_cast<__nv_bfloat16*>(ko),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      seq, hq, hkv, dim, q_sb, q_ss, k_sb, k_ss);
  return static_cast<int>(cudaGetLastError());
}

FDM_DEFINE_ERROR_STRING(fdm_rope)
