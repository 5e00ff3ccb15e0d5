// Block-sparse flash attention, bf16 q/k/v/out, f32 softmax state, tensor
// cores: one kernel, one table walk (the mask mode of the Wan engine) and the
// dense walk that is its bit-for-bit reference. The other three radial sparse
// modes -- coarse (sdpa_gather_pallas, attention.py:1069), super
// (sdpa_gather_super_pallas, :1002) and fine (sdpa_gather_fine_pallas, :759)
// -- run on the wgmma + TMA kernel of flash_attn.cu.
//
// Replaces, in fastdm_tpu/kernels/pallas/attention.py:
//   mask   -- sdpa_sparse_pallas (:1122; _flash_attention :338, pallas_call
//             :390, kernel _sparse_flash_kernel :155): a (B, H, nq, nk) block
//             mask, per batch entry and head (block_mask).
// Query rows [i*block_q, (i+1)*block_q) attend only to the keys row i of the
// mask allows. Keys past skv do not exist, and a row that sees no key returns
// 0, as the plain version (fastdm_tpu_torch/kernels/torch_backend.py) and the
// jnp oracle do.
//
// What bounds it on the H100: operations, counted on the allowed keys only
// (allowed (query, key) pairs x 4 x head_dim, per head). At the A14B shape
// the radial mask allows 0.326 of dense attention's work (128x128 tiles).
//
// Design: the tile machinery of attn_tile.cuh (64-query blocks of 4 warps,
// mma.sync, 64-key tiles through two cp.async buffers) with a walk over the
// table in place of a dense KV loop. Each block takes one
// (64-query tile, head, batch) and reads its own mask row i = q0 / block_q
// (block_q a multiple of 64, so several blocks walk one row). The walk yields,
// in order, the first key of every 64-key tile the row allows together with
// that tile's column limit; a tile the mask does not allow is skipped, which
// is exact (a fully masked tile leaves m, l and O unchanged), and only a tile
// crossing its limit is masked per column:
//   mask   -- the block_k/64 tiles of every set bit of mask row q0/block_q of
//             mask[b, h] (per head: no row is shared); limit skv;
//   dense  -- no table: every tile in order; limit skv. It is the loop of the
//             dense sdpa kernel before that kernel moved to wgmma and TMA
//             (flash_attn.cu), kept for checks only: the mask walk on a mask
//             that allows every key equals it bit for bit (same tiles, same
//             order, same tile code), and it is the yardstick of the walks'
//             redesign. No model path launches it.
// Tiles are loaded straight from the model's (B, S, H*D) tensors (no
// transposed, padded K/V copy as the Pallas wrappers' DMAs needed), the next
// allowed tile streaming in while the current one is computed. The softmax
// scale multiplies the f32 logits, as in the plain versions (the Pallas
// kernels round q*scale*log2(e) to bf16 first). Every tile size is a multiple
// of 64, so a 64-key tile never straddles two mask blocks. The walk clamps its
// row to the mask, so a malformed mask gives a wrong answer, never an
// out-of-bounds access; the strict value checks run on the host where the
// mask is built (kernels/contracts.py, strict=True).
#include "attn_tile.cuh"

namespace {

using namespace fdm_attn;

// Each walk: next(e, t, limit) returns, from block e and tile t of the block
// on, the first key of the next allowed tile and sets `limit` (keys at or past
// it are masked), or returns -1 when the row is exhausted. Every thread of the
// block runs it alike (uniform control flow).

struct MaskWalk {
  const int* mrow;  // mask[b, h, row, :]
  int nj, tiles_per_block, block_k, skv;

  __device__ __forceinline__ int next(int& e, int& t, int& limit) const {
    limit = skv;
    for (; e < nj; ++e, t = 0) {
      if (mrow[e] == 0) continue;
      for (; t < tiles_per_block; ++t) {
        const long long key0 = static_cast<long long>(e) * block_k + t * kBK;
        if (key0 < skv) return static_cast<int>(key0);
      }
    }
    return -1;
  }
};

struct MaskTables {  // mask: (batch, heads, ni, nj)
  const int* mask;
  int heads, ni, nj, block_q, block_k;

  __device__ __forceinline__ MaskWalk walk(int q0, int h, int b, int skv) const {
    const int row = min(q0 / block_q, ni - 1);
    const int* mrow = mask + ((static_cast<long long>(b) * heads + h) * ni + row) * nj;
    return MaskWalk{mrow, nj, block_k / kBK, block_k, skv};
  }
};

struct DenseWalk {
  int skv;

  __device__ __forceinline__ int next(int&, int& t, int& limit) const {
    limit = skv;
    const long long key0 = static_cast<long long>(t) * kBK;
    return key0 < skv ? static_cast<int>(key0) : -1;
  }
};

struct DenseTables {  // no table
  __device__ __forceinline__ DenseWalk walk(int, int, int, int skv) const {
    return DenseWalk{skv};
  }
};

template <int D, class Tables>
__global__ void __launch_bounds__(kThreads)
sparse_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       const Tables tables, int sq, int skv, int hq, int hkv,
                       int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                       int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                       float scale_log2) {
  constexpr int LD = D + 8;
  constexpr int kTile = kBK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kTile]
  __nv_bfloat16* v_s = k_s + 2 * kTile;                              // [2][kTile]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const __nv_bfloat16* qb = q + b * q_sb + static_cast<int64_t>(h) * D;
  const __nv_bfloat16* kb = k + b * k_sb + static_cast<int64_t>(hk) * D;
  const __nv_bfloat16* vb = v + b * v_sb + static_cast<int64_t>(hk) * D;

  const auto walk = tables.walk(q0, h, b, skv);
  int e = 0, t = 0, limit = skv;
  int key0 = walk.next(e, t, limit);

  // Q tile (staged in V's second buffer) and the first allowed KV tile
  load_tile_async<D, LD>(v_s + kTile, qb, q_ss, q0, sq);
  if (key0 >= 0) {
    load_tile_async<D, LD>(k_s, kb, k_ss, key0, skv);
    load_tile_async<D, LD>(v_s, vb, v_ss, key0, skv);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[D / 16][4];
  load_q_fragments<D, LD>(qf, v_s + kTile);
  __syncthreads();  // the staging buffer is overwritten by the first prefetch

  RowState<D> st;
  st.init();
  for (int buf = 0; key0 >= 0; buf ^= 1) {
    ++t;
    int next_limit = skv;
    const int next0 = walk.next(e, t, next_limit);
    if (next0 >= 0) {  // prefetch the next allowed tile into the other buffer
      load_tile_async<D, LD>(k_s + (buf ^ 1) * kTile, kb, k_ss, next0, skv);
      load_tile_async<D, LD>(v_s + (buf ^ 1) * kTile, vb, v_ss, next0, skv);
    }
    cp_async_commit();
    attend_tile<D, LD>(st, qf, k_s + buf * kTile, v_s + buf * kTile, scale_log2,
                       key0 + kBK > limit, key0, limit, false, q0, 0);
    cp_async_wait_all();  // the next tile has landed (this thread's copies) ...
    __syncthreads();      // ... for every thread, and this tile's buffer is free
    key0 = next0;
    limit = next_limit;
  }
  store_rows<D>(st, out + b * o_sb + static_cast<int64_t>(h) * D, o_ss, q0, sq);
}

// The operands every entry shares: q: (B, sq, hq*D), k/v: (B, skv, hkv*D),
// out: (B, sq, hq*D), bf16 with the given batch/sequence strides in elements
// and a contiguous last dim; strides multiples of 8 and pointers 16-byte
// aligned. scale_log2 = softmax scale * log2(e). D is 64 or 128.
struct Operands {
  const void *q, *k, *v;
  void* out;
  int batch, sq, skv, hq, hkv, head_dim;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  float scale_log2;
  cudaStream_t stream;
};

template <int D, class Tables>
int launch(const Tables& tables, const Operands& a) {
  const cudaError_t attr = cudaFuncSetAttribute(
      sparse_attn_fwd_kernel<D, Tables>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((a.sq + kBQ - 1) / kBQ), static_cast<unsigned>(a.hq),
                  static_cast<unsigned>(a.batch));
  sparse_attn_fwd_kernel<D, Tables><<<grid, kThreads, smem_bytes<D>(), a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.out), tables, a.sq,
      a.skv, a.hq, a.hkv, a.q_sb, a.q_ss, a.k_sb, a.k_ss, a.v_sb, a.v_ss, a.o_sb, a.o_ss,
      a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <class Tables>
int run(const Tables& tables, const Operands& a) {
  if (a.batch <= 0 || a.sq <= 0) return 0;
  if (a.hkv <= 0 || a.hq % a.hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.head_dim == 128) return launch<128>(tables, a);
  if (a.head_dim == 64) return launch<64>(tables, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define FDM_OPERANDS_PARAMS                                                                   \
  const void *q, const void *k, const void *v, void *out, int batch, int sq, int skv, int hq, \
      int hkv, int head_dim, long long q_sb, long long q_ss, long long k_sb, long long k_ss,  \
      long long v_sb, long long v_ss, long long o_sb, long long o_ss, float scale_log2,       \
      void *stream
#define FDM_OPERANDS                                                                          \
  Operands {                                                                                  \
    q, k, v, out, batch, sq, skv, hq, hkv, head_dim, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, \
        o_ss, scale_log2, static_cast<cudaStream_t>(stream)                                   \
  }

// mask: int32 (batch, hq, ni, nj) block mask, ni = ceil(sq/block_q), nj =
// ceil(skv/block_k); nonzero computes a tile. block_q and block_k multiples of 64.
FDM_EXPORT int fdm_sparse_mask_fwd(const void* mask, int ni, int nj, int block_q, int block_k,
                                   FDM_OPERANDS_PARAMS) {
  if (block_q % kBQ != 0 || block_k % kBK != 0 || ni < 1 || nj < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const MaskTables t{static_cast<const int*>(mask), hq, ni, nj, block_q, block_k};
  return run(t, FDM_OPERANDS);
}

// Dense attention on this kernel's tile: every 64-key tile of each row, in
// order (no table, no causal mask).
FDM_EXPORT int fdm_gather_dense(FDM_OPERANDS_PARAMS) { return run(DenseTables{}, FDM_OPERANDS); }

FDM_DEFINE_ERROR_STRING(fdm_gather_attn)
