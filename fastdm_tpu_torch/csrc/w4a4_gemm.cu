// The W4A4 linear of an int4 / int4p QLinear in one launch: the int4 GEMM,
// its dequantization epilogue and the SVDQuant low-rank branch,
//   out  = bf16( f32(bf16(main)) + f32(bf16(xu . lora_v)) )
//   main = f32(xq . w) * (xs[m] * scale[n]) + f32(bias[n])
// with xq (M, K) the per-token int4 activations, w the int4 weights, xu =
// bf16(x . lora_u) the (M, r) activations of the rank-r branch (r <= 32, a
// plain product left to torch.matmul) and lora_v (r, N) bf16: the roundings
// of the port's composition (unpack_int4, int4_matmul, the bf16 low-rank
// product and the bf16 add), each with __fmul_rn / __fadd_rn so that no FMA
// contraction moves one. Two entries:
//
// fdm_w4a4_linear (large M) replaces int4_matmul's kernel
// (fastdm_tpu/kernels/jnp_backend/impl.py:163 int4_matmul_jnp, the W8A8
// ring's W4A4 entry in w8a8_gemm.cu) and the low-rank lines of the W4A4
// branch (fastdm_tpu/layers/qlinear.py:286-290), which ran as two cuBLAS
// calls and an elementwise add writing and reading three M x N bf16 tensors.
// What bounds it on the H100: operations, 2*M*N*K int8 operations at 800 to
// 3000 per byte at FLUX's shapes, above the ~590 op/byte ridge of the 1979
// TOP/s tensor cores; the low-rank branch adds 2*M*N*r bf16 operations (~2%
// of the main product's time at r = 32, K = 3072) and no device-memory pass.
// Design: the int8 kernel's persistent warp-specialised skeleton
// (w8a8_sm90.cuh: grouped tiles, one producer thread keeping TMA loads of
// 128-byte-swizzled A and B slabs in flight, s8 wgmma k32 with exact s32 sums
// over the whole K loop) with two consumer warpgroups in ping-pong: each
// takes whole 128 x 128 tiles (two m64n128 wgmma per k32 step) and the two
// take the block's tiles in turn. The producer walks the tiles in order
// through one ring of four 32 KB stages, so one warpgroup's K loop follows
// the other's on the tensor cores and each epilogue runs under the other's
// K loop. Per tile the producer also brings the tile's lora_v columns (32 x
// 128 bf16, two 64-column atoms) into its consumer's own buffer, once per
// tile, behind their own full / empty barriers. The epilogue first turns the
// s32 accumulators into the main term (the tile's scale and bias read from
// shared memory, loaded once per tile) rounded to bf16, two columns a
// register (64 registers where the accumulators took 128: with the 384
// threads' 168-register cap, the low-rank product fits beside it only so),
// then works in four 64 x 64 pieces: the piece's low-rank block on the
// tensor cores (two bf16 wgmma k16 steps with xu's fragments in registers,
// loaded from device memory, and lora_v MN-major from shared memory, the
// form the attention's P.V uses), rounded to bf16 and added to the main term
// into a per-warpgroup shared-memory slot laid out as the TMA's four
// 128-byte-swizzled 64 x 64 boxes (conflict-free); one thread stores them
// with four TMA stores left in flight while its warpgroup waits for its next
// tile (an N that is not a multiple of 8 is stored element by element). The
// 192 x 128 tile over three consumers that this replaced left the tensor
// cores with all three warpgroups for the epilogue (PERF.md: both schedules
// timed by kernel_ab.py on one card). int4p's
// packed weights are unpacked ahead of this entry by unpack_int4
// (int4_pack.cu): reading them packed would need a shared-memory transform
// or the weights as a register-A operand.
//
// fdm_w4a4_linear_small (small M) replaces int4_matmul and the int4p unpack
// (fastdm_tpu/layers/qlinear.py unpack_int4, :75-83) where the rows are few:
// the AdaLN modulations (M = 1) and short text streams. What bounds it on the
// H100: memory bytes, the packed weights' K*N/2 (0.5 byte per value) against
// 2*M*N*K operations; the unpack + GEMM composition moved 2.5 bytes per
// weight value at M = 1 (the unpack read 0.5 and wrote 1, the GEMM read the
// 1 again) on a grid of 192-row tiles that held one row.
// Design: the product transposed, D^T = W . X^T, on the warp-level s8 MMA
// of shape m16n8k32: each warp takes 16 weight rows (output columns) as
// the A operand and the activation rows eight at a time as B, so one row of
// activations wastes 7/8 of an MMA and nothing of the weight stream. A
// thread loads its weight rows' packed bytes 16 at a time and sign-extends
// the nibbles in registers (as int4_pack.cu's sext_nibbles), low nibbles to
// the MMA's first 16 K columns and high nibbles to its last 16: byte [n, j]
// holds k = j and k = j + K/2 (the halves layout), and since an integer sum
// does not depend on the order of its terms the activation fragments are
// gathered to the same pairing (x[m, j..] and x[m, K/2 + j..]). Every SM gets
// work: 64 output columns a block and K split 2, 4 or 8 ways (small_split,
// by the tiles) across a cluster of as many blocks, whose s32
// partial sums meet through distributed shared memory; each block of the
// cluster then reduces its share of the 64 columns (exact in any order),
// applies the epilogue (the low-rank term as r f32 FMAs per output, its
// operands and the scales loaded before the K loop so that their latency
// hides behind the weight stream) and stores. The MMAs of a step go to
// separate accumulators where there are few activation blocks, so that
// consecutive MMAs do not wait for each other. One launch, no workspace, no
// unpack and no int8 carrier buffer.
//
// Both entries are bit-exact with the plain composition wherever lora_v = 0
// (the s32 sums are exact, |acc| <= 64 K < 2^24 at FLUX widths, so
// __int2float_rn is too); otherwise the low-rank term is summed in another
// order than cuBLAS's and may differ from it by one bf16 ulp of that term.
#include "w8a8_sm90.cuh"

namespace {

using namespace fdm_w8a8;

constexpr int kMaxRank = 32;  // the low-rank branch's rank at most (SVDQuant's r)

// ------------------------------------------------------------ large M (wgmma)

struct LT {
  static constexpr int kConsumers = 2;  // ping-pong: each warpgroup takes whole tiles in turn
  static constexpr int kBM = 128, kBN = 128;  // a consumer's tile: two m64 halves
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kATileBytes = kBM * kBK, kBTileBytes = kBN * kBK;
  static constexpr int kStageBytes = kATileBytes + kBTileBytes;  // 32 KB
  static constexpr int kStages = 4;
  static constexpr int kVAtomBytes = kMaxRank * 128;  // 32 rows x 64 bf16 columns
  static constexpr int kVBytes = 2 * kVAtomBytes;     // lora_v's 128 columns of a tile
  static constexpr int kBoxBytes = 64 * 64 * 2;       // one TMA store box: 64 rows x 64 bf16
  static constexpr int kSlotBoxes = 4;  // boxes a consumer's output slot holds (of a tile's 4)
  static constexpr int kOutBytes = kSlotBoxes * kBoxBytes;
  static constexpr int kColBytes = kBN * 4 + kBN * 2;  // a tile's scale (f32) and bias (bf16)
  static constexpr int kVOff = kStages * kStageBytes;
  static constexpr int kOutOff = kVOff + kConsumers * kVBytes;
  static constexpr int kColOff = kOutOff + kConsumers * kOutBytes;
  static constexpr int kBarOff = kColOff + kConsumers * kColBytes;
  static constexpr int kSmemBytes = 1024 + kBarOff + (2 * kStages + 3 * kConsumers) * 8;
  static constexpr int kConsumerRegs = (65536 / 128 - kProducerRegs) / kConsumers / 8 * 8;
  static constexpr int kAcc = kBN / 2;  // s32 accumulators of one m64 half, per thread
  static_assert(kSmemBytes <= 232448 && kVOff % 1024 == 0 && kOutOff % 1024 == 0 &&
                kBarOff % 8 == 0 && 4 % kSlotBoxes == 0, "smem layout");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(f32(bf16(main)) + f32(lr)): the composition's last two roundings.
__device__ __forceinline__ float add_lowrank(float main, float lr) {
  return __fadd_rn(__bfloat162float(__float2bfloat16_rn(main)), lr);
}

// The TMA store of a shared-memory box (the async proxy reads it): the
// writers' fence, the copy issued by one thread, its commit, and the wait
// until the copies of this thread have read their boxes (`read`) or
// finished.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// xu's bf16 A fragments (the m16n8k16 layout) of rows r0 and r0 + 8 for the
// two k16 steps of a rank of at most 32; rows past m and columns past the
// rank are zero.
__device__ __forceinline__ void load_xu(const __nv_bfloat16* __restrict__ xu, long long ldxu,
                                        int rank, int m, int r0, int t, uint32_t (&xa)[2][4]) {
#pragma unroll
  for (int kc = 0; kc < 2; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 8 * (i & 1), col = 16 * kc + 8 * (i >> 1) + 2 * t;
      const __nv_bfloat16* p = xu + static_cast<long long>(row) * ldxu + col;
      xa[kc][i] = row < m && col < rank ? *reinterpret_cast<const uint32_t*>(p) : 0u;
    }
}

// Tiles blockIdx.x, + gridDim.x, ... of the block, counted by ti: the
// producer walks them all; consumer c takes those with ti % 2 == c.
__global__ void __launch_bounds__(LT::kThreads, 1)
w4a4_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_out, const float* __restrict__ scale_a,
                 const float* __restrict__ scale_b, const __nv_bfloat16* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ xu, long long ldxu, int rank,
                 __nv_bfloat16* __restrict__ out, int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + LT::kBarOff);
  uint64_t* empty = full + LT::kStages;
  uint64_t* v_full = empty + LT::kStages;      // [consumer]
  uint64_t* v_empty = v_full + LT::kConsumers;  // [consumer]
  uint64_t* k_done = v_empty + LT::kConsumers;  // [consumer]: a tile's K loop issued
  const int tiles_m = (m + LT::kBM - 1) / LT::kBM, tiles_n = (n + LT::kBN - 1) / LT::kBN;
  const int tiles = tiles_m * tiles_n;
  const int n_kt = (k + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < LT::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of the stage's consumer
    }
    for (int c = 0; c < LT::kConsumers; ++c) {
      mbar_init(&v_full[c], 1);
      mbar_init(&v_empty[c], 4);
      mbar_init(&k_done[c], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // the producer: per tile its lora_v columns into its consumer's buffer,
    // then its K stages, counted across tiles so that the ring runs from one
    // consumer's tile straight into the other's
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 0) return;
    int it = 0, ti = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++ti) {
      int m0, n0;
      tile_origin<LT>(tile, tiles_m, tiles_n, m0, n0);
      const int c = ti & 1;
      uint8_t* v = base + LT::kVOff + c * LT::kVBytes;
      mbar_wait(&v_empty[c], ((ti >> 1) & 1) ^ 1);
      mbar_arrive_expect_tx(&v_full[c], LT::kVBytes);
      tma_load_2d(v, &map_v, &v_full[c], n0, 0);
      tma_load_2d(v + LT::kVAtomBytes, &map_v, &v_full[c], n0 + 64, 0);
      for (int kt = 0; kt < n_kt; ++kt, ++it) {
        const int s = it % LT::kStages;
        mbar_wait(&empty[s], ((it / LT::kStages) & 1) ^ 1);
        uint8_t* st = base + s * LT::kStageBytes;
        mbar_arrive_expect_tx(&full[s], LT::kStageBytes);
        tma_load_2d(st, &map_a, &full[s], kt * kBK, m0);
        tma_load_2d(st + LT::kATileBytes, &map_b, &full[s], kt * kBK, n0);
      }
    }
    return;
  }

  setmaxnreg_inc<LT::kConsumerRegs>();
  const int c = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool lead = lane == 0;  // arrives for its warp
  uint8_t* slot = base + LT::kOutOff + c * LT::kOutBytes;
  float* col_scale = reinterpret_cast<float*>(base + LT::kColOff + c * LT::kColBytes);
  __nv_bfloat16* col_bias = reinterpret_cast<__nv_bfloat16*>(col_scale + LT::kBN);
  const uint32_t v_addr = smem_u32(base + LT::kVOff + c * LT::kVBytes);
  const int bar = 1 + c;  // this warpgroup's named barrier
  const bool tma_store = (n % 8) == 0;  // whole 16-byte rows: map_out is valid
  int ti = c;
  for (int tile = blockIdx.x + c * gridDim.x; tile < tiles; tile += 2 * gridDim.x, ti += 2) {
    int m0, n0;
    tile_origin<LT>(tile, tiles_m, tiles_n, m0, n0);
    const int r0 = m0 + warp * 16 + g;  // this thread's rows r0 (+ 8) (+ 64)
    const int my_col = n0 + tid;
    const float my_scale = my_col < n ? scale_b[my_col] : 0.f;
    const __nv_bfloat16 my_bias =
        bias != nullptr && my_col < n ? bias[my_col] : __float2bfloat16_rn(0.f);
    // read by the epilogue after its first barrier (the previous epilogue's
    // reads ended at its second one)
    col_scale[tid] = my_scale;
    col_bias[tid] = my_bias;

    // the main product over the whole K loop in s32, the two m64 halves of
    // the tile from each stage; the first wgmma of the tile overwrites
    // (scale_d 0). The stages of tile ti are the ring's ti * n_kt, ..; the
    // loop starts once the other consumer has issued its K loop of tile
    // ti - 1, so the two K loops follow each other on the tensor cores, each
    // one's epilogue runs under the other's K loop, and no stage barrier is
    // waited on more than one phase ahead of it (a parity wait could not tell).
    if (ti > 0) mbar_wait(&k_done[c ^ 1], ((ti - 1) >> 1) & 1);
    int32_t acc[2][LT::kAcc];
    int it = ti * n_kt;
    for (int kt = 0; kt < n_kt; ++kt, ++it) {
      const int s = it % LT::kStages;
      mbar_wait(&full[s], (it / LT::kStages) & 1);
      const uint32_t a_addr = smem_u32(base + s * LT::kStageBytes);
      const uint32_t b_addr = a_addr + LT::kATileBytes;
      wgmma_fence();
#pragma unroll
      for (int k0 = 0; k0 < kBK; k0 += 32) {
        const uint32_t sd = static_cast<uint32_t>(kt > 0 || k0 > 0);
        wgmma_m64n128k32_s8(acc[0], desc_sw128(a_addr + k0, 0), desc_sw128(b_addr + k0, 0), sd);
        wgmma_m64n128k32_s8(acc[1], desc_sw128(a_addr + 64 * kBK + k0, 0),
                            desc_sw128(b_addr + k0, 0), sd);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas are done: release it
      if (kt > 0 && lead) mbar_arrive(&empty[(it - 1) % LT::kStages]);
    }
    if (lead) mbar_arrive(&k_done[c]);
    float sa[2][2];  // scale_a of rows r0 + 64 mh + 8 h
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 64 * (i >> 1) + 8 * (i & 1);
      sa[i >> 1][i & 1] = row < m ? scale_a[row] : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (lead) mbar_arrive(&empty[(it - 1) % LT::kStages]);

    // the epilogue. First the main term in the composition's order, rounded
    // to bf16 and packed two columns a register (64 registers for the tile,
    // where the s32 accumulators took 128): accumulator 4j + 2h + e of
    // acc[mh] is row 64 mh + 16 warp + g + 8h, column 8j + 2t + e of the
    // tile, and mt[mh][2j + h] holds its pair e = 0, 1.
    if (tma_store && tid == 0) bulk_wait_read();  // the previous tile's store read the slot
    named_barrier_sync(bar, 128);
    uint32_t mt[2][LT::kAcc / 2];
#pragma unroll
    for (int mh = 0; mh < 2; ++mh)
#pragma unroll
      for (int j = 0; j < LT::kBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            float f = __fmul_rn(__int2float_rn(acc[mh][4 * j + 2 * h + e]),
                                __fmul_rn(sa[mh][h], col_scale[col]));
            if (bias != nullptr) f = __fadd_rn(f, __bfloat162float(col_bias[col]));
            v[e] = f;
          }
          mt[mh][2 * j + h] = pack_bf16(v[0], v[1]);
        }
    // then, by 64-column piece a and m64 half mh, the low-rank block on the
    // tensor cores (two bf16 wgmma k16 steps, xu's fragments from registers,
    // lora_v MN-major from shared memory, the form the attention's P.V
    // uses; d[4 jj + 2h + e] is column 64 a + 8 jj + 2t + e), rounded to
    // bf16 and added to the main term, into the slot: the TMA's four 64 x 64
    // boxes (box 2 mh + a; rows of 128 bytes, 16-byte chunk q of row rr at
    // chunk q ^ (rr % 8), the 128-byte swizzle), column chunk jj of a box at
    // chunk jj ^ g.
    uint32_t xa[2][2][4];  // [m64 half][k16 step]
    load_xu(xu, ldxu, rank, m, r0, t, xa[0]);
    load_xu(xu, ldxu, rank, m, r0 + 64, t, xa[1]);
    mbar_wait(&v_full[c], (ti >> 1) & 1);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int mh = p >> 1, a = p & 1;
      uint8_t* box = slot + (p % LT::kSlotBoxes) * LT::kBoxBytes;
      if (p > 0 && p % LT::kSlotBoxes == 0) {
        // the slot's previous boxes have been read by their stores
        if (tma_store && tid == 0) bulk_wait_read();
        named_barrier_sync(bar, 128);
      }
      float d[32];
      const uint32_t atom = v_addr + a * LT::kVAtomBytes;
      wgmma_fence();
      wgmma_m64n64k16_bf16_rs_tb(d, xa[mh][0], desc_sw128(atom, LT::kVAtomBytes), 0);
      wgmma_m64n64k16_bf16_rs_tb(d, xa[mh][1], desc_sw128(atom + 16 * 128, LT::kVAtomBytes), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
      if (p == 3 && lead) mbar_arrive(&v_empty[c]);  // lora_v read
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t mw = mt[mh][2 * (8 * a + jj) + h];
          const __nv_bfloat162 mp = *reinterpret_cast<__nv_bfloat162*>(&mw);
          const float lr0 = __bfloat162float(__float2bfloat16_rn(d[4 * jj + 2 * h]));
          const float lr1 = __bfloat162float(__float2bfloat16_rn(d[4 * jj + 2 * h + 1]));
          const int rr = 16 * warp + g + 8 * h;  // the box's row
          *reinterpret_cast<uint32_t*>(box + rr * 128 + ((jj ^ g) << 4) + 4 * t) =
              pack_bf16(__fadd_rn(__low2float(mp), lr0), __fadd_rn(__high2float(mp), lr1));
        }
      if ((p + 1) % LT::kSlotBoxes != 0) continue;
      // the slot's boxes (pieces p0 .. p) to device memory
      const int p0 = p + 1 - LT::kSlotBoxes;
      if (tma_store) {
        // by TMA stores (rows past m and columns past n clipped), left in
        // flight while this warpgroup goes on
        fence_async_shared();
        named_barrier_sync(bar, 128);
        if (tid == 0) {
#pragma unroll
          for (int q = p0; q <= p; ++q)
            tma_store_2d(&map_out, slot + (q - p0) * LT::kBoxBytes, n0 + 64 * (q & 1),
                         m0 + 64 * (q >> 1));
          bulk_commit();
        }
      } else {
        // an N that is not a multiple of 8: element stores, masked
        named_barrier_sync(bar, 128);
#pragma unroll 4
        for (int e = tid; e < LT::kSlotBoxes * 512; e += 128) {
          const int q = p0 + e / 512, rr = (e % 512) / 8, cc = e % 8;
          const int row = m0 + 64 * (q >> 1) + rr, col = n0 + 64 * (q & 1) + 8 * cc;
          if (row >= m || col >= n) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(
              slot + (q - p0) * LT::kBoxBytes + rr * 128 + ((cc ^ (rr & 7)) << 4));
          const __nv_bfloat16* el = reinterpret_cast<const __nv_bfloat16*>(&v);
          __nv_bfloat16* dst = out + static_cast<long long>(row) * n + col;
          for (int i = 0; i < 8 && col + i < n; ++i) dst[i] = el[i];
        }
      }
    }
  }
  if (tma_store && tid == 0) bulk_wait();  // the slot stays until its stores are done
}

// ------------------------------------------- small M (warp-level MMA, packed)

constexpr int kSmallWarps = 4;        // 16 output columns a warp
constexpr int kSmallN = 16 * kSmallWarps;
constexpr int kSmallThreads = 32 * kSmallWarps;
constexpr int kUnroll = 4;            // 16-byte weight loads in flight per row and thread

// Four nibbles, one in the low half of each byte of w, sign-extended into four
// bytes (int4_pack.cu's sext_nibbles).
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t w) {
  return __vsub4((w & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}

// Not volatile: the compiler may interleave independent MMAs (a volatile
// asm keeps program order, and each MMA would wait for the one before).
__device__ __forceinline__ void mma_s8_m16n8k32(int32_t (&d)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives; shared-memory writes
// before it are visible to the other blocks' reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

__device__ __forceinline__ int32_t ld_cluster(const int32_t* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  int32_t v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ uint4 ld_or_zero(const void* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// MB activation blocks of 8 rows a block (rows blockIdx.y * 8 * MB ..), K
// split Split ways across a cluster: blockIdx.x = 64-column tile * Split +
// the block's rank in its cluster.
template <int MB, int Split>
__global__ void __cluster_dims__(Split, 1, 1) __launch_bounds__(kSmallThreads)
w4a4_small_kernel(const uint8_t* __restrict__ wp, long long ldw, const int8_t* __restrict__ xq,
                  long long ldx, const float* __restrict__ scale_a,
                  const float* __restrict__ scale_b, const __nv_bfloat16* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ xu, long long ldxu, int rank,
                  const __nv_bfloat16* __restrict__ lora_v, long long ldv,
                  __nv_bfloat16* __restrict__ out, int m, int n, int k) {
  // consecutive MMAs into one accumulator wait for each other, so with few
  // activation blocks the four K-column groups of a step go to separate sums
  // (exact s32, added at the end)
  constexpr int kSets = MB >= 8 ? 1 : MB >= 4 ? 2 : 4;
  constexpr int kCols = kSmallN / Split;  // the columns whose epilogue this block runs
  constexpr int kRows = 8 * MB;
  constexpr int kXuPer = kRows * kMaxRank / kSmallThreads;  // xu values a thread stages
  constexpr int kLvPer = kMaxRank * kCols / kSmallThreads;  // lora_v values a thread stages
  static_assert(kXuPer >= 1 && kLvPer >= 1 && kCols <= kSmallThreads && kRows <= kSmallThreads,
                "staging shapes");
  __shared__ int32_t part[kRows][kSmallN];  // this block's K share: (row, column) s32
  __shared__ float lv_s[kMaxRank][kCols];   // lora_v of the block's epilogue columns
  __shared__ float xu_s[kRows][kMaxRank];   // xu of the block's rows
  __shared__ float sa_s[kRows], sb_s[kCols], bias_s[kCols];
  const uint32_t split = cluster_rank();
  const int n0 = (blockIdx.x / Split) * kSmallN, mb0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int w_row0 = n0 + 16 * warp + g, w_row1 = w_row0 + 8;  // weight rows (output columns)
  const uint8_t* w0 = wp + static_cast<long long>(w_row0) * ldw;
  const uint8_t* w1 = wp + static_cast<long long>(w_row1) * ldw;
  const int half = k / 2, chunks = half / 16;  // 16-byte chunks of a packed row
  const int c_begin = static_cast<int>(split) * chunks / Split;
  const int c_end = (static_cast<int>(split) + 1) * chunks / Split;
  const int ecol = n0 + kCols * static_cast<int>(split);  // the block's epilogue columns

  // the epilogue's operands, loaded now and parked in shared memory after the
  // K loop, so their latency hides behind the weight stream
  __nv_bfloat16 lv_r[kLvPer], xu_r[kXuPer];
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int i = 0; i < kLvPer; ++i) {
    const int e = tid + kSmallThreads * i, j = e / kCols, col = ecol + e % kCols;
    lv_r[i] = j < rank && col < n ? lora_v[static_cast<long long>(j) * ldv + col] : zero;
  }
#pragma unroll
  for (int i = 0; i < kXuPer; ++i) {
    const int e = tid + kSmallThreads * i, row = mb0 + e / kMaxRank, j = e % kMaxRank;
    xu_r[i] = j < rank && row < m ? xu[static_cast<long long>(row) * ldxu + j] : zero;
  }
  const float sa_r = tid < kRows && mb0 + tid < m ? scale_a[mb0 + tid] : 0.f;
  const bool col_ok = tid < kCols && ecol + tid < n;
  const float sb_r = col_ok ? scale_b[ecol + tid] : 0.f;
  const float bias_r = col_ok && bias != nullptr ? __bfloat162float(bias[ecol + tid]) : 0.f;

  int32_t acc[kSets][MB][4];
#pragma unroll
  for (int c = 0; c < kSets; ++c)
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][b][i] = 0;

  // lane t takes chunk cb + t of each step of four: packed bytes 16c .. 16c+15
  // of its two weight rows hold k = 16c .. 16c+15 (low nibbles) and K/2 + 16c
  // .. (high nibbles); word q of them feeds MMA q's K columns 4t .. 4t+3 and
  // 16 + 4t .., and the activations' words q of x[m, 16c ..] and x[m, K/2 +
  // 16c ..] the same columns of B
  for (int cb = c_begin; cb < c_end; cb += 4 * kUnroll) {
    uint4 wv[kUnroll][2];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ch = cb + 4 * u + t;
      const bool ok = ch < c_end;
      wv[u][0] = ld_or_zero(w0 + 16 * ch, ok && w_row0 < n);
      wv[u][1] = ld_or_zero(w1 + 16 * ch, ok && w_row1 < n);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cb + 4 * u >= c_end) break;  // warp-uniform
      const int ch = cb + 4 * u + t;
      const bool ok = ch < c_end;
      uint4 lo[MB], hi[MB];
#pragma unroll
      for (int b = 0; b < MB; ++b) {
        const int xr = mb0 + 8 * b + g;
        const int8_t* xrow = xq + static_cast<long long>(xr) * ldx + 16 * ch;
        lo[b] = ld_or_zero(xrow, ok && xr < m);
        hi[b] = ld_or_zero(xrow + half, ok && xr < m);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t p0 = word(wv[u][0], q), p1 = word(wv[u][1], q);
        const uint32_t a[4] = {sext_nibbles(p0), sext_nibbles(p1), sext_nibbles(p0 >> 4),
                               sext_nibbles(p1 >> 4)};
#pragma unroll
        for (int b = 0; b < MB; ++b)
          mma_s8_m16n8k32(acc[q % kSets][b], a, word(lo[b], q), word(hi[b], q));
      }
    }
  }
  // acc[.][b]: (column 16 warp + g (+8 for i >= 2), row 8b + 2t + (i & 1))
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int32_t v = acc[0][b][i];
#pragma unroll
      for (int c = 1; c < kSets; ++c) v += acc[c][b][i];
      part[8 * b + 2 * t + (i & 1)][16 * warp + g + 8 * (i >> 1)] = v;
    }
#pragma unroll
  for (int i = 0; i < kLvPer; ++i) {
    const int e = tid + kSmallThreads * i;
    lv_s[e / kCols][e % kCols] = __bfloat162float(lv_r[i]);
  }
#pragma unroll
  for (int i = 0; i < kXuPer; ++i) {
    const int e = tid + kSmallThreads * i;
    xu_s[e / kMaxRank][e % kMaxRank] = __bfloat162float(xu_r[i]);
  }
  if (tid < kRows) sa_s[tid] = sa_r;
  if (tid < kCols) {
    sb_s[tid] = sb_r;
    bias_s[tid] = bias_r;
  }
  cluster_sync();  // every block's partials (and this block's staged operands) in place

  // this block's kCols columns of the tile, every row: the sum of the Split
  // partials in rank order, then the epilogue
  for (int e = tid; e < kRows * kCols; e += kSmallThreads) {
    const int rl = e / kCols, ce = e % kCols, cl = kCols * static_cast<int>(split) + ce;
    const int row = mb0 + rl, col = n0 + cl;
    if (row >= m || col >= n) continue;
    int32_t s = 0;
#pragma unroll
    for (int r = 0; r < Split; ++r) s += ld_cluster(&part[rl][cl], r);
    float f = __fmul_rn(__int2float_rn(s), __fmul_rn(sa_s[rl], sb_s[ce]));
    if (bias != nullptr) f = __fadd_rn(f, bias_s[ce]);
    float lr = 0.f;
#pragma unroll 8
    for (int j = 0; j < rank; ++j) lr = __fmaf_rn(xu_s[rl][j], lv_s[j][ce], lr);
    out[static_cast<long long>(row) * n + col] =
        __float2bfloat16_rn(add_lowrank(f, __bfloat162float(__float2bfloat16_rn(lr))));
  }
  cluster_sync();  // no block leaves while another reads its partials
}

// The K split of a launch by its 64-column tiles and 8-row activation blocks
// mb, as timed on an H100 at FLUX's and Qwen-Image's (K, N) and M = 1 .. 64
// (chip_smoke.py --w4a4-grid times 2, 4 and 8 shares): fewer, longer blocks
// win from N = 12288 (192 tiles) up and at N = 9216 with 2-4 activation
// blocks; eight shares at N = 3072 up to 16 rows; four elsewhere.
inline int small_split(long long tiles, int mb) {
  if (tiles >= 160) return 2;
  if (tiles >= 64) return mb == 2 || mb == 4 ? 2 : 4;
  return mb <= 2 ? 8 : 4;
}

template <int MB, int Split>
int launch_small(const void* wp, long long ldw, const void* xq, long long ldx, const void* scale_a,
                 const void* scale_b, const void* bias, const void* xu, long long ldxu, int rank,
                 const void* lora_v, long long ldv, void* out, int m, int n, int k,
                 cudaStream_t stream) {
  const long long tiles = (n + kSmallN - 1) / kSmallN;
  const long long rows = (m + 8 * MB - 1) / (8 * MB);
  if (tiles * Split > 0x7fffffffLL || rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  w4a4_small_kernel<MB, Split>
      <<<dim3(static_cast<unsigned>(tiles * Split), static_cast<unsigned>(rows)), kSmallThreads,
         0, stream>>>(
          static_cast<const uint8_t*>(wp), ldw, static_cast<const int8_t*>(xq), ldx,
          static_cast<const float*>(scale_a), static_cast<const float*>(scale_b),
          static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(xu), ldxu,
          rank, static_cast<const __nv_bfloat16*>(lora_v), ldv, static_cast<__nv_bfloat16*>(out),
          m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int MB, class... Args>
int launch_small_split(int split, long long tiles, Args... args) {
  switch (split != 0 ? split : small_split(tiles, MB)) {
    case 2: return launch_small<MB, 2>(args...);
    case 4: return launch_small<MB, 4>(args...);
    default: return launch_small<MB, 8>(args...);
  }
}

}  // namespace

// The large-M entry. a: (m, k) int8, row pitch lda; b: (n, k) int8 int4-range
// values, row pitch ldb (the (K, N) weight stored K-contiguous); both 16-byte
// aligned, lda, ldb and k multiples of 16. scale_a f32 (m,), scale_b f32 (n,),
// bias bf16 (n,) or NULL; xu: (m, rank) bf16, row pitch ldxu (even), 4-byte
// aligned; lora_v: (rank, n) bf16, row pitch ldv (a multiple of 8), 16-byte
// aligned; 1 <= rank <= 32, even. out: contiguous bf16 (m, n).
// Returns 0 or a cudaError_t (a refused tensor map: kTensorMapError + CUresult).
FDM_EXPORT int fdm_w4a4_linear(const void* a, const void* b, const void* scale_a,
                               const void* scale_b, const void* bias, const void* xu,
                               const void* lora_v, void* out, int m, int n, int k,
                               long long lda, long long ldb, long long ldxu, long long ldv,
                               int rank, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (rank < 1 || rank > kMaxRank || rank % 2 != 0 || ldxu < rank || ldxu % 2 != 0 ||
      ldv < n || ldv % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  long long tiles = 0;
  int r = check_shape<LT>(m, n, k, lda, ldb, &tiles);
  static std::atomic<int> setup[kMaxDevices];
  int sms = 0;
  if (r == 0) r = device_setup(w4a4_gemm_kernel, LT::kSmemBytes, setup, &sms);
  CUtensorMap map_a, map_b, map_v, map_out = {};
  if (r == 0) r = encode_operands<LT>(&map_a, &map_b, a, b, m, n, k, lda, ldb);
  if (r == 0) {
    const long long dims[2] = {n, rank}, pitch[1] = {2 * ldv}, box[2] = {64, kMaxRank};
    r = encode_tiled(&map_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, lora_v, dims, pitch, box);
  }
  if (r == 0 && n % 8 == 0) {  // else the kernel stores by elements and reads no map_out
    const long long dims[2] = {n, m}, pitch[1] = {2LL * n}, box[2] = {64, 64};
    r = encode_tiled(&map_out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, dims, pitch, box);
  }
  if (r != 0) return r;
  w4a4_gemm_kernel<<<persistent_grid(tiles, sms), LT::kThreads, LT::kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, map_v, map_out, static_cast<const float*>(scale_a),
      static_cast<const float*>(scale_b), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(xu), ldxu, rank, static_cast<__nv_bfloat16*>(out), m, n,
      k);
  return static_cast<int>(cudaGetLastError());
}

// The small-M entry on the packed weights. wp: (n, k/2) bytes, row pitch ldw,
// byte [n, j] = q[n, j] (low nibble) | q[n, j + k/2] << 4; xq: (m, k) int8, row
// pitch ldx; wp, xq 16-byte aligned, ldw, ldx multiples of 16, k a multiple of
// 32. xu: (m, rank) bf16, pitch ldxu; lora_v: (rank, n) bf16, pitch ldv;
// rank <= 32; the rest as fdm_w4a4_linear. One launch of 64-column tiles by
// clusters of 2, 4 or 8 K shares (split; 0: small_split's choice), 8 * MB rows
// a block (MB = 1, 2, 4 or 8 by m).
FDM_EXPORT int fdm_w4a4_linear_small(const void* wp, const void* xq, const void* scale_a,
                                     const void* scale_b, const void* bias, const void* xu,
                                     const void* lora_v, void* out, int m, int n, int k,
                                     long long ldx, long long ldw, long long ldxu, long long ldv,
                                     int rank, int split, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || k % 32 != 0 || ldx % 16 != 0 || ldw % 16 != 0 || ldw < k / 2 || ldx < k ||
      rank < 0 || rank > kMaxRank || ldxu < rank || ldv < n ||
      (split != 0 && split != 2 && split != 4 && split != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = (n + kSmallN - 1) / kSmallN;
  if (m <= 8)
    return launch_small_split<1>(split, tiles, wp, ldw, xq, ldx, scale_a, scale_b, bias, xu,
                                 ldxu, rank, lora_v, ldv, out, m, n, k, st);
  if (m <= 16)
    return launch_small_split<2>(split, tiles, wp, ldw, xq, ldx, scale_a, scale_b, bias, xu,
                                 ldxu, rank, lora_v, ldv, out, m, n, k, st);
  if (m <= 32)
    return launch_small_split<4>(split, tiles, wp, ldw, xq, ldx, scale_a, scale_b, bias, xu,
                                 ldxu, rank, lora_v, ldv, out, m, n, k, st);
  return launch_small_split<8>(split, tiles, wp, ldw, xq, ldx, scale_a, scale_b, bias, xu,
                               ldxu, rank, lora_v, ldv, out, m, n, k, st);
}

// Dynamic shared memory of one large-M block, bytes.
FDM_EXPORT int fdm_w4a4_linear_smem_bytes() { return LT::kSmemBytes; }

// Registers per thread after setmaxnreg in the large-M kernel: a consumer's
// (consumer != 0) or the producer's.
FDM_EXPORT int fdm_w4a4_linear_setmaxnreg(int consumer) {
  return consumer ? LT::kConsumerRegs : kProducerRegs;
}

FDM_DEFINE_SM90_ERROR_STRING(fdm_w4a4_linear)
