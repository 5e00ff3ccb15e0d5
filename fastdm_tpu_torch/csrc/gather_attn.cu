// Superblock gather-sparse flash attention, bf16 q/k/v/out, f32 softmax
// state, tensor cores.
//
// Replaces: fastdm_tpu/kernels/pallas/attention.py sdpa_gather_super_pallas
// (:1002), which runs _gather_super_attention (:934, pallas_call :989) ->
// _gather_super_kernel (:806). Query rows [i*block_q, (i+1)*block_q) attend
// only to the keys that row i of the CSR tables allows
// (sparse/xsparse.py block_lists_super):
// rows[i] = [start, count] names the entries idx[start .. start+count), each
// an aligned superblock of `superblock` fine blocks of `fine` tokens, and
// valbits[e] says which of its fine sub-blocks are active. Keys past skv do
// not exist (the global tail fine block is partial: 120 of 128 tokens at the
// Wan2.2-A14B 480x832x81 shape), and a row that sees no key returns 0, as the
// plain version (fastdm_tpu_torch/kernels/torch_backend.py
// sdpa_gather_super_torch) and the jnp oracle do.
//
// What bounds it on the H100: operations, counted on the allowed keys only
// (per table row: allowed tokens x query rows x 4 x head_dim, per head). The
// radial tables of the A14B shape allow 0.40 of dense attention's work at
// 128-token granularity; whole superblocks hold 0.61 of it.
//
// Design: the dense kernel's machinery (attn_tile.cuh: 64-query blocks of 4
// warps, mma.sync, 64-key tiles through two cp.async buffers) with a
// different walk. Each block takes one (64-query tile, head, batch) and reads
// its own table row i = q0 / block_q (block_q a multiple of 64, so several
// blocks walk one row). It visits, in table order (full superblocks first,
// as block_lists_super sorts them), every 64-key tile of every entry whose fine
// sub-block bit is set and that starts before skv; a cleared sub-block is
// skipped, which is exact (a fully masked tile leaves m, l and O unchanged).
// Tiles are loaded straight from the model's (B, S, H*D) tensors (no
// transposed, padded K/V copy as the Pallas wrapper's DMAs needed,
// attention.py:956-957), the next active tile streaming in while the current
// one is computed; only a tile crossing skv is masked per column. The softmax
// scale multiplies the f32 logits, as in the plain version (the Pallas kernel
// rounds q*scale*log2(e) to bf16 first, attention.py:838). fine must be
// a multiple of 64, so a tile never straddles two fine blocks. The walk
// clamps every table read to the table, so a malformed table gives a wrong
// answer, never an out-of-bounds access; the strict value checks run on the
// host where the tables are built (contracts.check_gather_super).
#include "attn_tile.cuh"

namespace {

using namespace fdm_attn;

// The walk over one table row: entry e of the row, tile t of the entry.
struct TileWalk {
  const int* idx;
  const int* val;
  int start, count, tiles_per_entry, tiles_per_fine, superblock_tokens, skv;

  // From (e, t) on, the first allowed tile: its first key, or -1 when the row
  // is exhausted. Every thread runs it alike (uniform control flow).
  __device__ __forceinline__ int next(int& e, int& t) const {
    for (; e < count; ++e, t = 0) {
      const int sid = idx[start + e], bits = val[start + e];
      for (; t < tiles_per_entry; ++t) {
        const long long key0 = static_cast<long long>(sid) * superblock_tokens + t * kBK;
        if (((bits >> (t / tiles_per_fine)) & 1) && key0 >= 0 && key0 < skv)
          return static_cast<int>(key0);
      }
    }
    return -1;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
gather_super_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                        const int* __restrict__ idx, const int* __restrict__ val,
                        const int* __restrict__ rows, int n_slots, int block_q, int fine,
                        int superblock, int sq, int skv, int hq, int hkv,
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

  const int row = q0 / block_q;
  const int start = min(max(rows[2 * row], 0), n_slots);
  const int count = min(max(rows[2 * row + 1], 0), n_slots - start);
  const TileWalk walk{idx, val, start, count, superblock * fine / kBK, fine / kBK,
                      superblock * fine, skv};
  int e = 0, t = 0;
  int key0 = walk.next(e, t);

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
    const int next0 = walk.next(e, t);
    if (next0 >= 0) {  // prefetch the next allowed tile into the other buffer
      load_tile_async<D, LD>(k_s + (buf ^ 1) * kTile, kb, k_ss, next0, skv);
      load_tile_async<D, LD>(v_s + (buf ^ 1) * kTile, vb, v_ss, next0, skv);
    }
    cp_async_commit();
    attend_tile<D, LD>(st, qf, k_s + buf * kTile, v_s + buf * kTile, scale_log2,
                       key0 + kBK > skv, key0, skv, false, q0, 0);
    cp_async_wait_all();  // the next tile has landed (this thread's copies) ...
    __syncthreads();      // ... for every thread, and this tile's buffer is free
    key0 = next0;
  }
  store_rows<D>(st, out + b * o_sb + static_cast<int64_t>(h) * D, o_ss, q0, sq);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, const void* idx,
           const void* val, const void* rows, int n_slots, int block_q, int fine,
           int superblock, int batch, int sq, int skv, int hq, int hkv, long long q_sb,
           long long q_ss, long long k_sb, long long k_ss, long long v_sb, long long v_ss,
           long long o_sb, long long o_ss, float scale_log2, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      gather_super_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ), static_cast<unsigned>(hq),
                  static_cast<unsigned>(batch));
  gather_super_fwd_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(idx), static_cast<const int*>(val), static_cast<const int*>(rows),
      n_slots, block_q, fine, superblock, sq, skv, hq, hkv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
      o_sb, o_ss, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, sq, hq*D), k/v: (B, skv, hkv*D), out: (B, sq, hq*D), bf16 with the
// given batch/sequence strides in elements and a contiguous last dim; strides
// multiples of 8 and pointers 16-byte aligned. idx/val: int32 (n_slots,)
// superblock ids and sub-block bitmasks; rows: int32 (ceil(sq/block_q), 2)
// [start, count]. block_q and fine multiples of 64. D is 64 or 128.
FDM_EXPORT int fdm_gather_super_fwd(const void* q, const void* k, const void* v, void* out,
                                    const void* idx, const void* val, const void* rows,
                                    int n_slots, int block_q, int fine, int superblock,
                                    int batch, int sq, int skv, int hq, int hkv, int head_dim,
                                    long long q_sb, long long q_ss, long long k_sb,
                                    long long k_ss, long long v_sb, long long v_ss,
                                    long long o_sb, long long o_ss, float scale_log2,
                                    void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || block_q % kBQ != 0 || fine % kBK != 0 || superblock < 1 ||
      superblock > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return launch<128>(q, k, v, out, idx, val, rows, n_slots, block_q, fine, superblock, batch,
                       sq, skv, hq, hkv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss,
                       scale_log2, st);
  if (head_dim == 64)
    return launch<64>(q, k, v, out, idx, val, rows, n_slots, block_q, fine, superblock, batch,
                      sq, skv, hq, hkv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss,
                      scale_log2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

FDM_DEFINE_ERROR_STRING(fdm_gather_super)
