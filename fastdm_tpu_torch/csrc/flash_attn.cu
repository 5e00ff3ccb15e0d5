// Flash-attention forward, bf16 q/k/v/out, f32 softmax state, tensor cores.
//
// Replaces: fastdm_tpu/kernels/pallas/attention.py sdpa_pallas (:429), which
// runs _flash_attention (:338) -> _flash_kernel (:69) / _attn_body (:43) /
// _softmax_update (:130), and the native-layout twin _flash_attention_nq
// (:267) / _flash_kernel_nq (:198). One kernel covers both TPU variants: it reads
// q, k and v straight from the (B, S, H*D) tensors through their strides, so
// neither the head transposes nor the sequence padding the Pallas wrapper built
// for Mosaic (attention.py:349-355, :423-425) exist here.
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
#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block, 16 per warp
constexpr int kBK = 64;       // keys per KV tile
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane i gives the row address of matrix i/8, row i%8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Asynchronous 16-byte copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows [row0, row0 + 64) of a (rows, D) slab with row pitch
// `stride` (elements) into shared memory of pitch LD; rows at or past
// `n_rows` are zero-filled so no load leaves the tensor.
template <int D, int LD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ src,
                                                int64_t stride, int row0, int n_rows) {
  constexpr int kVecPerRow = D / 8;  // 16-byte vectors
#pragma unroll
  for (int i = threadIdx.x; i < kBK * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * 8;
    const bool valid = row0 + r < n_rows;
    cp_async_16(smem_addr(dst + r * LD + c), valid ? src + (row0 + r) * stride + c : src,
                valid ? 16 : 0);
  }
}

template <int D>
constexpr int smem_bytes() {
  return 4 * kBK * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));  // K and V, two buffers each
}

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

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
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

  // ldmatrix lane roles: matrix m = lane / 8, row r = lane % 8
  const int lm = lane >> 3, lr = lane & 7;
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int row = warp * 16 + lr + (lm & 1) * 8, col = kc * 16 + (lm >> 1) * 8;
    ldmatrix_x4(qf[kc], smem_addr(v_s + kTile + row * LD + col));
  }
  __syncthreads();  // the staging buffer is overwritten by the first prefetch

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    const __nv_bfloat16* ks = k_s + (j & 1) * kTile;
    const __nv_bfloat16* vs = v_s + (j & 1) * kTile;
    if (j + 1 < n_tiles) {  // prefetch the next tile into the other buffer
      load_tile_async<D, LD>(k_s + ((j + 1) & 1) * kTile, kb, k_ss, k0 + kBK, skv);
      load_tile_async<D, LD>(v_s + ((j + 1) & 1) * kTile, vb, v_ss, k0 + kBK, skv);
    }
    cp_async_commit();

    // S = Q K^T for this warp's 16 rows x 64 keys; one ldmatrix.x4 feeds the
    // B fragments of two 8-key n-tiles
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bf[4];
        const int key = (2 * np + (lm >> 1)) * 8 + lr, col = kc * 16 + (lm & 1) * 8;
        ldmatrix_x4(bf, smem_addr(ks + key * LD + col));
        mma_16816(s[2 * np], qf[kc], bf[0], bf[1]);
        mma_16816(s[2 * np + 1], qf[kc], bf[2], bf[3]);
      }
    }

    // base-2 logits; mask the KV tail and the causal upper triangle
    const bool masked = (k0 + kBK > skv) || causal;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const int row = q0 + r0 + (e >> 1) * 8;
          if (col >= skv || (causal && col > row + diag)) x = -INFINITY;
        }
        s[n][e] = x;
      }
    }

    // online softmax update, rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3); the 4
    // threads of a quad hold one row's 64 columns between them
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = m_run[hr];
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with no visible key yet keeps m = -inf; subtract 0 instead so
      // its masked entries give p = 0 rather than exp2(-inf + inf) = NaN
      const float base = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m_run[hr] - base);
      m_run[hr] = mx;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const float p0 = exp2f(s[n][2 * hr] - base);
        const float p1 = exp2f(s[n][2 * hr + 1] - base);
        s[n][2 * hr] = p0;
        s[n][2 * hr + 1] = p1;
        rs += p0 + p1;
      }
      l_run[hr] = l_run[hr] * alpha + rs;  // per-thread partial; quad-summed at the end
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][2 * hr] *= alpha;
        o[dn][2 * hr + 1] *= alpha;
      }
    }

    // O += P V: the S accumulator layout of key tiles 2kc, 2kc+1 is exactly
    // the A fragment of a 16-key slice; ldmatrix.trans turns key-major V into
    // the B fragments of two 8-wide d-tiles
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const uint32_t pa[4] = {pack_f32x2(s[2 * kc][0], s[2 * kc][1]),
                              pack_f32x2(s[2 * kc][2], s[2 * kc][3]),
                              pack_f32x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_f32x2(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        const int key = kc * 16 + (lm & 1) * 8 + lr, col = (2 * dp + (lm >> 1)) * 8;
        ldmatrix_x4_trans(bf, smem_addr(vs + key * LD + col));
        mma_16816(o[2 * dp], pa, bf[0], bf[1]);
        mma_16816(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    cp_async_wait_all();  // the next tile has landed (this thread's copies) ...
    __syncthreads();      // ... for every thread, and this tile's buffer is free
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = l == 0.f ? 1.f : l;
    const int row = q0 + r0 + hr * 8;
    if (row < sq) {
      __nv_bfloat16* orow = out + b * o_sb + row * o_ss + static_cast<int64_t>(h) * D + 2 * t;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8) =
            __floats2bfloat162_rn(o[dn][2 * hr] / denom, o[dn][2 * hr + 1] / denom);
      }
    }
  }
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
