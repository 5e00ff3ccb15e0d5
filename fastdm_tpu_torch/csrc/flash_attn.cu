// Flash-attention forward, bf16 q/k/v/out, f32 softmax state, tensor cores.
//
// Replaces: fastdm_tpu/kernels/pallas/attention.py sdpa_pallas (:429), which
// runs _flash_attention (:338) -> _flash_kernel (:69) / _attn_body (:43) /
// _softmax_update (:130), and the native-layout twin _flash_attention_nq
// (:267) / _flash_kernel_nq (:198). One kernel covers both TPU variants: it reads
// q, k and v straight from the (B, S, H*D) tensors through their strides, so
// neither the head transposes nor the sequence padding the Pallas wrapper built
// for Mosaic (attention.py:349-355, :423-425) exist here. The tile machinery
// (loads, fragments, online softmax) lives in attn_tile.cuh, shared with the
// superblock gather kernel (gather_attn.cu).
//
// Kept from the TPU kernel: the online softmax in base 2 with scale*log2(e)
// folded into the logits, the f32 running max / sum / accumulator, p rounded
// to bf16 only as the operand of the P.V product (its row sum stays f32),
// masking of the KV tail at any sequence length (8704 at the FLUX 1024x2048
// shape is not a multiple of the 64-key tile), an optional causal mask, GQA
// (query head h reads kv head h / (Hq/Hkv)), and the l == 0 guard of :126
// (a row that sees no key returns 0).
//
// What bounds it on the H100: operations. At the FLUX shape (S=8704, 24 heads,
// D=128) it does 4*S^2*D*H = 9.3e11 flops on 214 MB of q/k/v/out, about 4350
// flops per byte, so the floor is 0.94 ms at 989 bf16 TFLOP/s.
//
// Design (mma.sync, the Ampere-style form; wgmma and TMA come later): one
// block of 4 warps per (64-query tile, head, batch); each warp owns 16 query
// rows and keeps their Q fragments, S tile and O accumulator in registers.
// The block walks the KV sequence in 64-key tiles through two shared-memory
// buffers: cp.async brings tile j+1 in while the warps compute on tile j, so
// the copy hides behind the tensor cores. Fragments come out of shared memory
// with ldmatrix (.trans for V, which is stored key-major as in the tensor);
// the padded row pitch (D+8 bf16) makes those reads bank-conflict free. The S
// accumulator fragments are re-packed in registers as the A operand of P.V,
// so P never touches shared memory.
#include "attn_tile.cuh"

namespace {

using namespace fdm_attn;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      int sq, int skv, int hq, int hkv,
                      int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
                      int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss,
                      float scale_log2, int causal) {
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

  // causal: query row i sees keys j <= i + (skv - sq) (bottom-right aligned,
  // as the plain version's tril(k=skv-sq); identical to top-left when sq == skv)
  const int diag = skv - sq;
  int kv_end = skv;
  if (causal) kv_end = min(skv, min(q0 + kBQ, sq) + diag);
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  // Q tile (staged in V's second buffer) and the first KV tile
  load_tile_async<D, LD>(v_s + kTile, qb, q_ss, q0, sq);
  if (n_tiles > 0) {
    load_tile_async<D, LD>(k_s, kb, k_ss, 0, skv);
    load_tile_async<D, LD>(v_s, vb, v_ss, 0, skv);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[D / 16][4];
  load_q_fragments<D, LD>(qf, v_s + kTile);
  __syncthreads();  // the staging buffer is overwritten by the first prefetch

  RowState<D> st;
  st.init();
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    if (j + 1 < n_tiles) {  // prefetch the next tile into the other buffer
      load_tile_async<D, LD>(k_s + ((j + 1) & 1) * kTile, kb, k_ss, k0 + kBK, skv);
      load_tile_async<D, LD>(v_s + ((j + 1) & 1) * kTile, vb, v_ss, k0 + kBK, skv);
    }
    cp_async_commit();
    attend_tile<D, LD>(st, qf, k_s + (j & 1) * kTile, v_s + (j & 1) * kTile, scale_log2,
                       (k0 + kBK > skv) || causal, k0, skv, causal, q0, diag);
    cp_async_wait_all();  // the next tile has landed (this thread's copies) ...
    __syncthreads();      // ... for every thread, and this tile's buffer is free
  }
  store_rows<D>(st, out + b * o_sb + static_cast<int64_t>(h) * D, o_ss, q0, sq);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch, int sq, int skv,
           int hq, int hkv, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
           long long v_sb, long long v_ss, long long o_sb, long long o_ss, float scale_log2,
           int causal, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory has to be allowed per kernel
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ), static_cast<unsigned>(hq),
                  static_cast<unsigned>(batch));
  flash_attn_fwd_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, skv, hq, hkv,
      q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, sq, hq*D), k/v: (B, skv, hkv*D), out: (B, sq, hq*D), all bf16 with the
// given batch/sequence strides in elements and a contiguous last dim; strides
// multiples of 8 and pointers 16-byte aligned (16-byte async copies).
// scale_log2 = softmax scale * log2(e). D is 64 or 128.
FDM_EXPORT int fdm_flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                                  int batch, int sq, int skv, int hq, int hkv, int head_dim,
                                  long long q_sb, long long q_ss, long long k_sb, long long k_ss,
                                  long long v_sb, long long v_ss, long long o_sb, long long o_ss,
                                  float scale_log2, int causal, void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return launch<128>(q, k, v, out, batch, sq, skv, hq, hkv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                       o_sb, o_ss, scale_log2, causal, st);
  if (head_dim == 64)
    return launch<64>(q, k, v, out, batch, sq, skv, hq, hkv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                      o_sb, o_ss, scale_log2, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

FDM_DEFINE_ERROR_STRING(fdm_flash_attn)
