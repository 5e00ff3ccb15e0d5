// Rotary position embedding of q and k in one launch, bf16 in and out, in
// both pair layouts: interleaved (FLUX) and half-split (neox).
//
// Replaces: fastdm_tpu/kernels/pallas/elementwise.py rotary_pos_embedding_pallas
// (:483), kernel bodies _rope_one (:254) / _rope_kernel (:236). Each rotation
// pair (x1, x2) becomes (x1*cos - x2*sin, x2*cos + x1*sin), computed in f32 with
// no fused multiply-add (the _rn intrinsics stop the compiler from contracting)
// and rounded once to bf16, exactly as the plain version
// (fastdm_tpu_torch/kernels/torch_backend.py _rotate) rounds. Pair p of a head
// is columns (2p, 2p + 1) interleaved, (p, p + D/2) half-split; both use the
// table entry (s, p).
//
// What bounds it on the H100: memory bytes (6 flops per 4 bytes of q/k moved).
// The Pallas version expanded cos/sin to full-width (S, H*D) tables in HBM
// because Mosaic has no strided gather (elementwise.py:237-240, :490-503);
// here the (S, D/2) f32 tables are read once per token.
//
// Vector path (head_dim a multiple of 8, interleaved, or of 16, half-split;
// rows, strides and tables 16-byte aligned): a thread owns one column group
// of a head: 8 columns (4 pairs) interleaved, or 8 columns of each half (8
// pairs) half-split. It loads that group's cos and sin once per token with
// 16-byte loads, then applies them to the same group of every q and k head of
// the token that its head slot owns (heads slot, slot + head_slots, ...),
// kUnroll heads' 16-byte loads issued before their stores, with streaming
// (evict-first) accesses so the tables stay cached. A block covers
// tokens_per_block tokens and does its index arithmetic once per thread. The
// wrapper (kernels/cuda_backend.py rope_plan) picks the path, head_slots and
// tokens_per_block; the launcher checks that the path takes the operands.
// Tail path (any even head_dim, 4-byte aligned rows): one thread per pair,
// two scalar table loads each; grid x = token, y = chunks of the q and k pairs.
#include "bf16_rows.cuh"

namespace {

using namespace bf16_rows;

constexpr int kUnroll = 4;       // heads in flight per thread, vector path
constexpr int kMaxThreads = 256;  // vector path, a block (the wrapper's ROPE_THREADS)
constexpr int kTailThreads = 256;

enum Path { kVector = 0, kTail = 1 };

// The q and k operands: row of token t = b * seq + s at q + b * q_sb + s *
// q_ss (k alike); outputs contiguous (tokens, hq * dim) and (tokens, hkv * dim).
struct Operands {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  __nv_bfloat16* qo;
  __nv_bfloat16* ko;
  const float* cos_t;
  const float* sin_t;
  int64_t q_sb, q_ss, k_sb, k_ss;
  int seq, hq, hkv, dim;
};

// ---------------------------------------------------------------- vector path

// One head's column group: interleaved, x holds pairs (lo, hi) of 4 words.
__device__ __forceinline__ uint4 rotate_interleaved(const uint4& x, const GroupTables<false>& t) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float x1 = bf16_lo(w[j]), x2 = bf16_hi(w[j]);
    o[j] = pack_bf16x2(rot1(x1, x2, t.c[j], t.s[j]), rot2(x1, x2, t.c[j], t.s[j]));
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Thread layout of a block: token slot (threadIdx.x / per_token), then head
// slot and column group within the token (per_token = groups * head_slots).
template <bool kNeox>
__global__ void __launch_bounds__(kMaxThreads)
rope_vec_kernel(const Operands op, int tokens, int head_slots, int tokens_per_block) {
  const int groups = op.dim / (kNeox ? 2 * kVec : kVec);  // column groups per head
  const int per_token = groups * head_slots;
  const int lt = threadIdx.x / per_token;
  const int t = blockIdx.x * tokens_per_block + lt;
  if (lt >= tokens_per_block || t >= tokens) return;  // no barrier or shuffle below
  const int j = threadIdx.x - lt * per_token;
  const int slot = j / groups, grp = j - slot * groups;
  const int b = t / op.seq, s = t - b * op.seq;
  const int half = op.dim / 2;
  const int col = grp * kVec;  // of the head; half-split: of each half
  GroupTables<kNeox> tab;
  const int64_t at = static_cast<int64_t>(s) * half + (kNeox ? col : col / 2);
  tab.load(op.cos_t + at, op.sin_t + at);
  const __nv_bfloat16* qr = op.q + b * op.q_sb + s * op.q_ss + col;
  const __nv_bfloat16* kr = op.k + b * op.k_sb + s * op.k_ss + col;
  __nv_bfloat16* qd = op.qo + static_cast<int64_t>(t) * op.hq * op.dim + col;
  __nv_bfloat16* kd = op.ko + static_cast<int64_t>(t) * op.hkv * op.dim + col;
  const int heads = op.hq + op.hkv;
  for (int h0 = slot; h0 < heads; h0 += kUnroll * head_slots) {
    uint4 v[kUnroll], v2[kUnroll];  // v2: the second half's columns (half-split)
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int h = h0 + u * head_slots;
      if (h < heads) {
        const __nv_bfloat16* src = h < op.hq ? qr + h * op.dim : kr + (h - op.hq) * op.dim;
        v[u] = load_stream(src);
        if constexpr (kNeox) v2[u] = load_stream(src + half);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int h = h0 + u * head_slots;
      if (h < heads) {
        __nv_bfloat16* dst = h < op.hq ? qd + h * op.dim : kd + (h - op.hq) * op.dim;
        if constexpr (kNeox) {
          rotate_half_split(v[u], v2[u], tab);
          store_stream(dst, v[u]);
          store_stream(dst + half, v2[u]);
        } else {
          store_stream(dst, rotate_interleaved(v[u], tab));
        }
      }
    }
  }
}

// ------------------------------------------------------------------ tail path

template <bool kNeox>
__global__ void __launch_bounds__(kTailThreads)
rope_pair_kernel(const Operands op) {
  const int token = blockIdx.x;  // b * seq + s
  const int b = token / op.seq, s = token - b * op.seq;
  const int half = op.dim / 2;
  const int nq = op.hq * half;
  int j = blockIdx.y * kTailThreads + threadIdx.x;
  if (j >= nq + op.hkv * half) return;

  const __nv_bfloat16* src;
  __nv_bfloat16* dst;
  if (j < nq) {
    src = op.q + b * op.q_sb + s * op.q_ss;
    dst = op.qo + static_cast<int64_t>(token) * op.hq * op.dim;
  } else {
    j -= nq;
    src = op.k + b * op.k_sb + s * op.k_ss;
    dst = op.ko + static_cast<int64_t>(token) * op.hkv * op.dim;
  }
  const int h = j / half, p = j - h * half;
  src += h * op.dim;
  dst += h * op.dim;
  const float c = op.cos_t[s * half + p], sn = op.sin_t[s * half + p];
  if constexpr (kNeox) {
    const float x1 = __bfloat162float(src[p]), x2 = __bfloat162float(src[p + half]);
    dst[p] = __float2bfloat16_rn(rot1(x1, x2, c, sn));
    dst[p + half] = __float2bfloat16_rn(rot2(x1, x2, c, sn));
  } else {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + 2 * p));
    *reinterpret_cast<__nv_bfloat162*>(dst + 2 * p) =
        __floats2bfloat162_rn(rot1(x.x, x.y, c, sn), rot2(x.x, x.y, c, sn));
  }
}

// --------------------------------------------------------------------- launch

// Whether the vector path with this block shape takes the operands (the
// wrapper's rope_plan chooses it only then).
bool vector_takes(const Operands& op, bool neox, int head_slots, int tokens_per_block) {
  const int per = neox ? 2 * kVec : kVec;
  if (op.dim % per != 0 || head_slots <= 0 || tokens_per_block <= 0) return false;
  const long long threads = static_cast<long long>(op.dim / per) * head_slots * tokens_per_block;
  return threads <= kMaxThreads && op.q_sb % kVec == 0 && op.q_ss % kVec == 0 &&
         op.k_sb % kVec == 0 && op.k_ss % kVec == 0 && aligned(op.q, 16) && aligned(op.k, 16) &&
         aligned(op.qo, 16) && aligned(op.ko, 16) && aligned(op.cos_t, 16) &&
         aligned(op.sin_t, 16);
}

template <bool kNeox>
void launch_layout(const Operands& op, int tokens, int path, int head_slots,
                   int tokens_per_block, cudaStream_t st) {
  if (path == kVector) {
    const int threads = op.dim / (kNeox ? 2 * kVec : kVec) * head_slots * tokens_per_block;
    const int blocks = (tokens + tokens_per_block - 1) / tokens_per_block;
    rope_vec_kernel<kNeox><<<blocks, threads, 0, st>>>(op, tokens, head_slots, tokens_per_block);
  } else {
    const int pairs = (op.hq + op.hkv) * (op.dim / 2);
    const dim3 grid(static_cast<unsigned>(tokens),
                    static_cast<unsigned>((pairs + kTailThreads - 1) / kTailThreads));
    rope_pair_kernel<kNeox><<<grid, kTailThreads, 0, st>>>(op);
  }
}

}  // namespace

// q: (B, S, hq*dim) bf16 with batch/seq strides q_sb/q_ss (elements), last dim
// contiguous; k likewise with hkv heads; qo/ko: contiguous outputs of the same
// shapes; cos/sin: contiguous f32 (S, dim/2). dim even; pointers 4-byte
// aligned. neox: 0 interleaved pairs, 1 half-split. path: 0 vector (with
// head_slots and tokens_per_block), 1 tail; a vector path that does not take
// the operands returns cudaErrorInvalidValue.
FDM_EXPORT int fdm_rope_bf16(const void* q, const void* k, void* qo, void* ko,
                             const void* cos_t, const void* sin_t,
                             int batch, int seq, int hq, int hkv, int dim,
                             long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                             int neox, int path, int head_slots, int tokens_per_block,
                             void* stream) {
  if (batch <= 0 || seq <= 0) return 0;
  const Operands op{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                    static_cast<__nv_bfloat16*>(qo), static_cast<__nv_bfloat16*>(ko),
                    static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
                    q_sb, q_ss, k_sb, k_ss, seq, hq, hkv, dim};
  if (dim <= 0 || dim % 2 != 0 || hq < 0 || hkv < 0 || (path != kVector && path != kTail) ||
      (path == kVector && !vector_takes(op, neox != 0, head_slots, tokens_per_block)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (neox)
    launch_layout<true>(op, batch * seq, path, head_slots, tokens_per_block, st);
  else
    launch_layout<false>(op, batch * seq, path, head_slots, tokens_per_block, st);
  return static_cast<int>(cudaGetLastError());
}

FDM_DEFINE_ERROR_STRING(fdm_rope)
