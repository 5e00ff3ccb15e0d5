// Flash-attention forward, bf16 q/k/v/out, f32 softmax state, warpgroup MMA
// fed by the Tensor Memory Accelerator.
//
// Replaces: fastdm_tpu/kernels/pallas/attention.py sdpa_pallas (:429), which
// runs _flash_attention (:338) -> _flash_kernel (:69) / _attn_body (:43) /
// _softmax_update (:130), and the native-layout twin _flash_attention_nq
// (:267) / _flash_kernel_nq (:198). One kernel covers both TPU variants: it reads
// q, k and v straight from the (B, S, H*D) tensors through 3-D tensor maps
// over (H*D, S, B) with the views' own strides (q|k|v slices of one fused
// projection included), so neither the head transposes nor the sequence
// padding the Pallas wrapper built for Mosaic (attention.py:349-355, :423-425)
// exist here.
//
// Kept from the TPU kernel: the online softmax in base 2 with scale*log2(e)
// folded into the f32 logits (p = 2^(s*scale*log2(e) - max) by one FFMA and
// the special-function unit's ex2), any softmax scale (one <= 0 scales the
// logits before their max, as the plain version does), the f32 running max /
// sum / accumulator, p rounded to bf16 only as the operand of the P.V product
// (its row sum stays f32), masking of the KV tail at any sequence length (8704
// at the FLUX 1024x2048 shape, 32760 at Wan's 480x832x81 and 77 at SDXL's
// text are not multiples of the tile), an optional bottom-right causal mask,
// GQA (query head h reads kv head h / (Hq/Hkv)), and the l == 0 guard of :126
// (a row that sees no key returns 0).
//
// What bounds it on the H100: operations. At the FLUX shape (S=8704, 24 heads,
// D=128) it does 4*S^2*D*H = 9.3e11 flops on 214 MB of q/k/v/out, about 4350
// flops per byte, so the floor is 0.94 ms at 989 bf16 TFLOP/s.
//
// Design (sm90.cuh): each block takes 128 query rows of one (head, batch)
// with three warpgroups. Warpgroup 0 is the producer: one thread loads the Q
// tile once and then the K and V tiles of 128 keys through a ring of kStages
// shared-memory stages, K and V each with a "full" mbarrier (bytes landed) and
// an "empty" one (both consumers done), so a K slot is refilled as soon as
// its S is computed; setmaxnreg gives the producer's registers to warpgroups
// 1 and 2, the consumers, 64 query rows each. Per KV tile j a consumer issues
// S = Q.K^T with wgmma.m64n128k16 (Q and K both D-contiguous, which is
// K-major for this product) together with tile j-1's O += P.V, whose A
// operand is P in registers (the S accumulator re-packed to bf16 in place)
// and whose B operand is V as it lies in shared memory, key-major (the
// MN-major form bf16 wgmma allows): no V transpose, and P never touches
// shared memory. The masking and online softmax of tile j run while P.V is
// still on the tensor cores; only the rescale of O waits for it. The two
// consumers take turns issuing their MMAs (two named barriers), so one
// warpgroup's softmax overlaps the other's MMAs. With 128-query blocks every
// head's K and V pass through L2 half as often as with the 64-query blocks of
// the design this replaced (the mma.sync tile of attn_tile.cuh, which the
// sparse walks of gather_attn.cu keep). Tiles lie in shared memory as the TMA writes them with
// the 128-byte swizzle: a row of D = 128 bf16 is 256 bytes, so it loads as two
// 64-column boxes and the descriptors step across them. The tensor maps' S
// extent is the view's own length, so the tile past the last key is zero-filled
// (never the next batch entry's rows, whose 0*Inf could give NaN) and masked.
#include "sm90.cuh"

namespace {

using namespace fdm_sm90;

constexpr int kBQ = 128;       // query rows per block, 64 per consumer warpgroup
constexpr int kBK = 128;       // keys per KV tile
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kAtomCols = 64;  // bf16 columns of one 128-byte swizzle atom (one TMA box)
// setmaxnreg: the producer gives up registers, the consumers take them (at
// launch the 384 threads share the 65536 equally)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(128 * (kProducerRegs + 2 * kConsumerRegs) <= 65536,
              "the register file holds the setmaxnreg split");

template <int D>
struct Cfg {
  static constexpr int kAtoms = D / kAtomCols;      // 128-byte column atoms per row
  static constexpr int kStages = D == 128 ? 2 : 3;  // as shared memory allows
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;      // one K or V tile
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + (1 + 4 * kStages) * 8;
};

// Named barriers 1 and 2 order the two consumer warpgroups' MMA issue: a
// warpgroup waits for its turn (its own barrier, completed by the other
// warpgroup's arrival), issues, and passes the turn (arrives on the other's).
__device__ __forceinline__ void turn_wait(int cw) { named_barrier_sync(1 + cw, 256); }

__device__ __forceinline__ void turn_pass(int cw) { named_barrier_arrive(2 - cw, 256); }

// 2^x by the special-function unit (ex2.approx: 2^-22 relative error; results
// below 2^-126 flush to 0, as 2^-inf does).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// O += P.V for one 16-key slice: B is V, MN-major, its two 64-column atoms
// (D = 128) kBK rows of 128 bytes apart.
__device__ __forceinline__ void mma_pv(float (&o)[64], const uint32_t (&p)[4], uint32_t v_addr) {
  wgmma_m64n128k16_bf16_rs_tb(o, p, desc_sw128(v_addr, kBK * 128), 1);
}

__device__ __forceinline__ void mma_pv(float (&o)[32], const uint32_t (&p)[4], uint32_t v_addr) {
  wgmma_m64n64k16_bf16_rs_tb(o, p, desc_sw128(v_addr, kBK * 128), 1);
}

// The logits of the KV tile at key k0 (this thread's rows r0, r0 + 8): the
// KV tail and the causal upper triangle masked, the running max updated in
// base-2 units (scale_log2 times the raw row max: the same number as the max
// of the scaled logits when the scale is positive), and each logit turned into
// p = 2^(s * scale_log2 - max) by one FFMA and ex2; returns each row's rescale
// factor alpha and its p sum (a per-thread partial, quad-summed at the end).
// A scale <= 0 would turn the raw max into the scaled minimum (and 0 * -inf
// into NaN), so then the logits are scaled first and the rest runs at scale 1.
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2], float (&m_run)[2],
                                             float (&alpha)[2], float (&rs)[2], int k0, int skv,
                                             int causal, int wrow, int r0, int diag, int t,
                                             float scale_log2) {
  if (scale_log2 <= 0.f) {  // uniform over the grid: a branch no warp diverges on
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] *= scale_log2;
    scale_log2 = 1.f;
  }
  if (k0 + kBK > skv || (causal && k0 + kBK - 1 > wrow + diag)) {
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = r0 + (e >> 1) * 8;
        if (col >= skv || (causal && col > row + diag)) sc[4 * n + e] = -INFINITY;
      }
    }
  }
  // rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3); the 4 threads of a quad hold
  // one row's 128 columns between them
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
      mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * hr], sc[4 * n + 2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m_run[hr], mx * scale_log2);
    // a row with no visible key yet keeps m = -inf; subtract 0 instead so
    // its masked entries give p = 0 rather than exp2(-inf + inf) = NaN
    const float base = mx == -INFINITY ? 0.f : mx;
    alpha[hr] = ex2_approx(m_run[hr] - base);
    m_run[hr] = mx;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float p0 = ex2_approx(fmaf(sc[4 * n + 2 * hr], scale_log2, -base));
      const float p1 = ex2_approx(fmaf(sc[4 * n + 2 * hr + 1], scale_log2, -base));
      sc[4 * n + 2 * hr] = p0;
      sc[4 * n + 2 * hr + 1] = p1;
      sum += p0 + p1;
    }
    rs[hr] = sum;
  }
}

// O and l rescaled by alpha, l += the tile's p sums, and P in bf16 as the A
// fragments of the 16-key slices: the accumulators of key columns 16kc ..
// 16kc+15 are the m16n8k16 A layout of that slice.
template <int D>
__device__ __forceinline__ void rescale_and_pack(float (&o)[D / 2], float (&l_run)[2],
                                                 const float (&alpha)[2], const float (&rs)[2],
                                                 const float (&sc)[kBK / 2],
                                                 uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_run[hr] = l_run[hr] * alpha[hr] + rs[hr];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n + 2 * hr] *= alpha[hr];
      o[4 * n + 2 * hr + 1] *= alpha[hr];
    }
  }
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) {
    pa[kc][0] = pack_bf16(sc[8 * kc + 0], sc[8 * kc + 1]);
    pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
    pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
    pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
  }
}

// S = Q K^T for one KV tile: D/16 k-steps; step kk reads bytes 32*(kk%4) of
// column atom kk/4 of both tiles. Issued and committed, not waited for.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2], uint32_t q_addr, uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_m64n128k16_bf16_ss(sc, desc_sw128(q_addr + (kk / 4) * kBQ * 128 + off, 0),
                             desc_sw128(k_addr + (kk / 4) * kBK * 128 + off, 0), kk > 0);
  }
  wgmma_commit();
}

// O += P V for one KV tile: slice kc is keys 16kc .. 16kc+15, two 8-row
// groups of V. Issued and committed, not waited for.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t v_addr) {
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < kBK / 16; ++kc) mma_pv(o, pa[kc], v_addr + kc * 16 * 128);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
                      int sq, int skv, int hq, int hkv, int64_t o_sb, int64_t o_ss,
                      float scale_log2, int causal) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw));
  uint8_t* q_s = smem;                                  // [atom][kBQ rows][128 B]
  uint8_t* k_s = q_s + C::kQBytes;                      // [stage][atom][kBK rows][128 B]
  uint8_t* v_s = k_s + C::kStages * C::kKVBytes;        // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + C::kStages * C::kKVBytes);
  uint64_t* k_full = q_full + 1;                        // [stage]: K bytes landed
  uint64_t* v_full = k_full + C::kStages;               // [stage]: V bytes landed
  uint64_t* k_empty = v_full + C::kStages;              // [stage]: both consumers read K
  uint64_t* v_empty = k_empty + C::kStages;             // [stage]: both consumers read V

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  // causal: query row i sees keys j <= i + (skv - sq) (bottom-right aligned,
  // as the plain version's tril(k=skv-sq); identical to top-left when sq == skv)
  const int diag = skv - sq;
  int kv_end = skv;
  if (causal) kv_end = min(skv, min(q0 + kBQ, sq) + diag);
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // lane 0 of each consumer warp
      mbar_init(&v_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
        tma_load_3d(q_s + a * kBQ * 128, &map_q, q_full, h * D + a * kAtomCols, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % C::kStages;
        const uint32_t parity = ((j / C::kStages) & 1) ^ 1;
        uint8_t* ks = k_s + s * C::kKVBytes;
        uint8_t* vs = v_s + s * C::kKVBytes;
        mbar_wait(&k_empty[s], parity);
        mbar_arrive_expect_tx(&k_full[s], C::kKVBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load_3d(ks + a * kBK * 128, &map_k, &k_full[s], hk * D + a * kAtomCols, j * kBK, b);
        mbar_wait(&v_empty[s], parity);
        mbar_arrive_expect_tx(&v_full[s], C::kKVBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load_3d(vs + a * kBK * 128, &map_v, &v_full[s], hk * D + a * kAtomCols, j * kBK, b);
      }
    }
    return;
  }

  // consumers: query rows q0 + (wg - 1) * 64 .. + 63. Tile j's S = Q K^T is
  // issued together with tile j-1's O += P V; the softmax of tile j runs while
  // P V is still on the tensor cores, and only the rescale of O waits for it.
  setmaxnreg_inc<kConsumerRegs>();
  const int wrow = q0 + (wg - 1) * 64;  // this warpgroup's first query row
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair
  const int r0 = wrow + warp * 16 + g;    // this thread's rows r0 and r0 + 8
  const uint32_t q_addr = smem_u32(q_s) + (wg - 1) * 64 * 128;
  const uint32_t k_base = smem_u32(k_s), v_base = smem_u32(v_s);

  float o[D / 2];  // 64 x D: accumulator 4j + e at row r0 + 8(e/2), column 8j + 2t + e%2
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float alpha[2], rs[2];
  float sc[kBK / 2];
  uint32_t pa[kBK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // the two warpgroups take turns issuing their MMAs, warpgroup 1 first: one
  // warpgroup's softmax runs while the other's MMAs hold the tensor cores.
  // Each issues n_tiles + 1 times; the last turn of warpgroup 2 passes none.
  const int cw = wg - 1;
  if (n_tiles > 0) {
    if (cw == 1) turn_pass(cw);  // warpgroup 1's first turn
    mbar_wait(q_full, 0);
    turn_wait(cw);
    mbar_wait(&k_full[0], 0);
    issue_qk<D>(sc, q_addr, k_base);
    turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(&k_empty[0]);
    softmax_tile(sc, m_run, alpha, rs, 0, skv, causal, wrow, r0, diag, t, scale_log2);
    rescale_and_pack<D>(o, l_run, alpha, rs, sc, pa);
  }
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % C::kStages, sp = (j - 1) % C::kStages;
    turn_wait(cw);
    mbar_wait(&k_full[s], (j / C::kStages) & 1);
    issue_qk<D>(sc, q_addr, k_base + s * C::kKVBytes);
    mbar_wait(&v_full[sp], ((j - 1) / C::kStages) & 1);
    issue_pv<D>(o, pa, v_base + sp * C::kKVBytes);
    turn_pass(cw);
    wgmma_wait<1>();  // S of tile j
    fence_regs(sc);
    if (lane == 0) mbar_arrive(&k_empty[s]);
    softmax_tile(sc, m_run, alpha, rs, j * kBK, skv, causal, wrow, r0, diag, t, scale_log2);
    wgmma_wait<0>();  // P V of tile j-1
    fence_regs(o);
    if (lane == 0) mbar_arrive(&v_empty[sp]);
    rescale_and_pack<D>(o, l_run, alpha, rs, sc, pa);
  }
  if (n_tiles > 0) {
    const int sp = (n_tiles - 1) % C::kStages;
    turn_wait(cw);
    mbar_wait(&v_full[sp], ((n_tiles - 1) / C::kStages) & 1);
    issue_pv<D>(o, pa, v_base + sp * C::kKVBytes);
    if (cw == 0) turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&v_empty[sp]);
  }

  // O / l, bf16, rows past sq skipped; a row whose l is 0 (it saw no key)
  // stores 0
  __nv_bfloat16* ob = out + b * o_sb + static_cast<int64_t>(h) * D + 2 * t;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = l == 0.f ? 1.f : l;
    const int row = r0 + hr * 8;
    if (row < sq) {
      __nv_bfloat16* orow = ob + row * o_ss;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[4 * n + 2 * hr] / denom, o[4 * n + 2 * hr + 1] / denom);
      }
    }
  }
}

template <int D>
int launch(const void* const* ptrs, const long long* geom, int batch, int sq, int skv, int hq,
           int hkv, long long o_sb, long long o_ss, float scale_log2, int causal,
           cudaStream_t stream) {
  using C = Cfg<D>;
  // geom: q, k, v, 8 values each (kernels/tma.py attention_geometry): dims
  // (H*D, S, B) in elements, byte strides of S and B, box (64, rows, 1). The
  // box and extents must be the ones this kernel tiles by.
  const long long want[3][4] = {{static_cast<long long>(hq) * D, sq, batch, kBQ},
                                {static_cast<long long>(hkv) * D, skv, batch, kBK},
                                {static_cast<long long>(hkv) * D, skv, batch, kBK}};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const long long* gm = geom + 8 * i;
    if (gm[0] != want[i][0] || gm[1] != want[i][1] || gm[2] != want[i][2] ||
        gm[5] != kAtomCols || gm[6] != want[i][3] || gm[7] != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const int r = encode_tiled(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, ptrs[i], gm, gm + 3,
                               gm + 5);
    if (r != 0) return r;
  }
  // above 48 KB, dynamic shared memory has to be allowed per kernel
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ), static_cast<unsigned>(hq),
                  static_cast<unsigned>(batch));
  flash_attn_fwd_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[3])), sq,
      skv, hq, hkv, o_sb, o_ss, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, sq, hq*D), k/v: (B, skv, hkv*D), out: (B, sq, hq*D), all bf16 with a
// contiguous last dim, 16-byte aligned, strides multiples of 8 elements; geom
// holds the tensor-map geometry of q, k and v (8 values each, see launch); out
// is written through its batch / sequence strides in elements.
// scale_log2 = softmax scale * log2(e). D is 64 or 128.
FDM_EXPORT int fdm_flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                                  const long long* geom, int batch, int sq, int skv, int hq,
                                  int hkv, int head_dim, long long o_sb, long long o_ss,
                                  float scale_log2, int causal, void* stream) {
  if (batch <= 0 || sq <= 0) return 0;
  if (skv <= 0 || hkv <= 0 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[4] = {q, k, v, out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 128)
    return launch<128>(ptrs, geom, batch, sq, skv, hq, hkv, o_sb, o_ss, scale_log2, causal, st);
  if (head_dim == 64)
    return launch<64>(ptrs, geom, batch, sq, skv, hq, hkv, o_sb, o_ss, scale_log2, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block at head dim D, bytes (0 for another D).
FDM_EXPORT int fdm_flash_attn_smem_bytes(int head_dim) {
  return head_dim == 128 ? Cfg<128>::kSmem : head_dim == 64 ? Cfg<64>::kSmem : 0;
}

// Registers per thread after setmaxnreg: a consumer's (consumer != 0) or the
// producer's.
FDM_EXPORT int fdm_flash_attn_setmaxnreg(int consumer) {
  return consumer ? kConsumerRegs : kProducerRegs;
}

FDM_DEFINE_SM90_ERROR_STRING(fdm_flash_attn)
