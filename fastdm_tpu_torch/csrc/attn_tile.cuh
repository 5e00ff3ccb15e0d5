// The flash-attention machinery of the walks of gather_attn.cu (the sparse
// mode mask and the table-free dense walk): mma.sync and ldmatrix wrappers,
// cp.async tile loads, and the per-tile online-softmax step. The walks differ
// only in which 64-key tiles a block visits. (The dense sdpa kernel and the
// coarse, superblock and fine walks, flash_attn.cu, ran on this tile until
// their wgmma + TMA redesign.)
//
// Layout (mma.sync m16n8k16, bf16 operands, f32 accumulators): a block of 4
// warps owns 64 query rows, 16 per warp, with their Q fragments, S tile and O
// accumulator in registers. K/V tiles of 64 keys sit in shared memory at a
// padded row pitch of D+8 bf16 (bank-conflict free ldmatrix). The softmax
// runs in base 2 with scale*log2(e) folded into the logits; the running max,
// sum and accumulator are f32; p is rounded to bf16 only as the operand of
// the P.V product. A row that sees no key yet keeps m = -inf and adds nothing.
#pragma once

#include "common.cuh"

namespace fdm_attn {

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

// This warp's Q fragments (16 rows x D) from a staged (64, D) tile of pitch LD.
template <int D, int LD>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[D / 16][4],
                                                 const __nv_bfloat16* qs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix lane roles: matrix, row
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int row = warp * 16 + lr + (lm & 1) * 8, col = kc * 16 + (lm >> 1) * 8;
    ldmatrix_x4(qf[kc], smem_addr(qs + row * LD + col));
  }
}

// Softmax state of this thread's two query rows (r0 = warp*16 + lane/4 and
// r0 + 8 of the block's tile); each quad of threads shares a row.
template <int D>
struct RowState {
  float o[D / 8][4];
  float m[2];
  float l[2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
};

// One 64-key tile (K at ks, V at vs, keys k0..k0+63) into the row state.
// When `masked`, key columns >= skv, and with `causal` columns past row +
// diag, get -inf; row_base is the block's first query row.
template <int D, int LD>
__device__ __forceinline__ void attend_tile(RowState<D>& st, const uint32_t (&qf)[D / 16][4],
                                            const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                            float scale_log2, bool masked, int k0, int skv,
                                            bool causal, int row_base, int diag) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int lm = lane >> 3, lr = lane & 7;
  const int r0 = warp * 16 + g;

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
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * scale_log2;
      if (masked) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = row_base + r0 + (e >> 1) * 8;
        if (col >= skv || (causal && col > row + diag)) x = -INFINITY;
      }
      s[n][e] = x;
    }
  }

  // online softmax update, rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3); the 4
  // threads of a quad hold one row's 64 columns between them
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = st.m[hr];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row with no visible key yet keeps m = -inf; subtract 0 instead so
    // its masked entries give p = 0 rather than exp2(-inf + inf) = NaN
    const float base = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(st.m[hr] - base);
    st.m[hr] = mx;
    float rs = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float p0 = exp2f(s[n][2 * hr] - base);
      const float p1 = exp2f(s[n][2 * hr + 1] - base);
      s[n][2 * hr] = p0;
      s[n][2 * hr + 1] = p1;
      rs += p0 + p1;
    }
    st.l[hr] = st.l[hr] * alpha + rs;  // per-thread partial; quad-summed at the end
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      st.o[dn][2 * hr] *= alpha;
      st.o[dn][2 * hr + 1] *= alpha;
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
      mma_16816(st.o[2 * dp], pa, bf[0], bf[1]);
      mma_16816(st.o[2 * dp + 1], pa, bf[2], bf[3]);
    }
  }
}

// O / l for this thread's rows, bf16, rows past sq skipped; a row whose l is
// 0 (it saw no key) stores 0. out points at (batch b, head h, column 0).
template <int D>
__device__ __forceinline__ void store_rows(RowState<D>& st, __nv_bfloat16* out, int64_t o_ss,
                                           int row_base, int sq) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = st.l[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = l == 0.f ? 1.f : l;
    const int row = row_base + r0 + hr * 8;
    if (row < sq) {
      __nv_bfloat16* orow = out + row * o_ss + 2 * t;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8) =
            __floats2bfloat162_rn(st.o[dn][2 * hr] / denom, st.o[dn][2 * hr + 1] / denom);
      }
    }
  }
}

}  // namespace fdm_attn
