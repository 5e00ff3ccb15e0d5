// The persistent, warp-specialised skeleton the two W8A8 GEMMs share
// (fp8_gemm.cu, w8a8_gemm.cu): the block tile and its ring of shared-memory
// stages, the grouped rasterisation, the producer warpgroup that streams the
// A and B slabs through the TMA, the epilogue store, and the launcher (shape
// checks, tensor maps, persistent grid). The producer, the ring and the
// descriptors move bytes and do not know the element type; each kernel brings
// its consumers' MMA loop and the step that turns its accumulator into f32
// (fp8: the promoted f32 sum; int8: the zero-point term, then __int2float_rn).
//
// Layout: a and b are K-contiguous ((m, k) activations and the (n, k) weight
// buffer, the (K, N) operand stored K-contiguous). A stage holds the A slab
// (kBM rows x 128 bytes) and the B slab (kBN rows x 128 bytes) of one
// 128-byte K step, as the TMA writes them with the 128-byte swizzle; the TMA
// zero-fills rows past M and N and bytes past K (int8 0 and e4m3 0x00 add
// nothing), and the epilogue masks its stores.
#pragma once

#include "sm90.cuh"

namespace fdm_w8a8 {

using namespace fdm_sm90;

constexpr int kBK = 128;          // K bytes (= elements) of a stage: one swizzle atom per row
constexpr int kGroupM = 8;        // M-tiles that share each sweep over N
constexpr int kProducerRegs = 24;  // the producer warpgroup's registers after setmaxnreg

// A block tile of `Consumers` consumer warpgroups, 64 output rows each, by BN
// columns; its ring as deep as 200 KB of shared memory allows; the consumers
// take the registers the producer gives away (at launch each thread has
// 65536 / kThreads).
template <int Consumers, int BN>
struct Tile {
  static constexpr int kConsumers = Consumers;
  static constexpr int kBM = 64 * Consumers, kBN = BN;
  static constexpr int kThreads = 128 * (1 + Consumers);
  static constexpr int kATileBytes = kBM * kBK, kBTileBytes = BN * kBK;
  static constexpr int kStageBytes = kATileBytes + kBTileBytes;
  static constexpr int kStages = 200 * 1024 / kStageBytes;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;  // slack, ring, barriers
  static constexpr int kConsumerRegs = (65536 / 128 - kProducerRegs) / Consumers / 8 * 8;
  static constexpr int kAcc = BN / 2;  // accumulators per consumer thread
  static_assert(kConsumerRegs <= 256 && kStages >= 2, "tile too large for one block");
};

// The 1024-byte aligned start of dynamic shared memory (the swizzle atoms'
// alignment), with the ring's full and empty barriers after its stages.
template <class T>
struct Ring {
  uint8_t* smem;
  uint64_t* full;   // [stage]: the stage's TMA bytes have landed
  uint64_t* empty;  // [stage]: every consumer warp has read the stage

  __device__ __forceinline__ explicit Ring(uint8_t* raw)
      : smem(raw + (((smem_u32(raw) + 1023) & ~1023u) - smem_u32(raw))),
        full(reinterpret_cast<uint64_t*>(smem + T::kStages * T::kStageBytes)),
        empty(full + T::kStages) {}

  // Thread 0 initialises the barriers; every thread returns after they are
  // visible.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < T::kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 4 * T::kConsumers);  // lane 0 of each consumer warp
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
};

// Output tile `tile` of the grouped rasterisation: kGroupM M-tiles share each
// sweep over N, so the A panels of a group stay in L2 while B streams past.
template <class T>
__device__ __forceinline__ void tile_origin(int tile, int tiles_m, int tiles_n, int& m0,
                                            int& n0) {
  const int per_group = kGroupM * tiles_n;
  const int first_m = (tile / per_group) * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  m0 = (first_m + (tile % per_group) % group_m) * T::kBM;
  n0 = ((tile % per_group) / group_m) * T::kBN;
}

// Warpgroup 0 of a persistent block (which takes tiles blockIdx.x,
// + gridDim.x, ...): it gives its registers away, and one thread walks the
// block's tiles and their K steps, counted across tiles (it), so that it runs
// on into the next tile while the consumers store this one; each step waits
// until every consumer warp has released its stage and has the TMA bring the
// A and B slabs there.
template <class T>
__device__ __forceinline__ void produce(const Ring<T>& ring, const CUtensorMap* map_a,
                                        const CUtensorMap* map_b, int tiles_m, int tiles_n,
                                        int n_kt) {
  setmaxnreg_dec<kProducerRegs>();
  if (threadIdx.x != 0) return;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles_m * tiles_n; tile += gridDim.x) {
    int m0, n0;
    tile_origin<T>(tile, tiles_m, tiles_n, m0, n0);
    for (int kt = 0; kt < n_kt; ++kt, ++it) {
      const int s = it % T::kStages;
      mbar_wait(&ring.empty[s], ((it / T::kStages) & 1) ^ 1);
      uint8_t* st = ring.smem + s * T::kStageBytes;
      mbar_arrive_expect_tx(&ring.full[s], T::kStageBytes);
      tma_load_2d(st, map_a, &ring.full[s], kt * kBK, m0);
      tma_load_2d(st + T::kATileBytes, map_b, &ring.full[s], kt * kBK, n0);
    }
  }
}

// The epilogue in the jnp oracle's order (fastdm_tpu/kernels/jnp_backend/
// impl.py:232-240) with __fmul_rn / __fadd_rn, so no FMA contraction moves a
// rounding: value(i, row, col) is accumulator i as f32, then
// * (scale_a[row] * scale_b[col]), + f32(bias[col]), one rounding to bf16.
// Accumulator 4j + 2h + e sits at row 16*warp + g + 8h, column 8j + 2t + e of
// the warpgroup's 64 x kBN tile at (row0, n0).
template <class T, class Value>
__device__ __forceinline__ void store_tile(const Value& value, int row0, int n0, int m, int n,
                                           const float* __restrict__ scale_a,
                                           const float* __restrict__ scale_b,
                                           const __nv_bfloat16* __restrict__ bias,
                                           __nv_bfloat16* __restrict__ out) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool pair_store = (n % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + g + h * 8;
    if (row >= m) continue;
    const float sa = scale_a[row];
    __nv_bfloat16* orow = out + static_cast<int64_t>(row) * n;
#pragma unroll
    for (int j = 0; j < T::kBN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = min(col + e, n - 1);  // clamped reads; stores are masked
        float f = __fmul_rn(value(4 * j + 2 * h + e, row, c), __fmul_rn(sa, scale_b[c]));
        if (bias != nullptr) f = __fadd_rn(f, __bfloat162float(bias[c]));
        v[e] = f;
      }
      if (col >= n) continue;
      if (pair_store) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v[0], v[1]);
      } else {
        orow[col] = __float2bfloat16_rn(v[0]);
        if (col + 1 < n) orow[col + 1] = __float2bfloat16_rn(v[1]);
      }
    }
  }
}

// ---------------------------------------------------------------- host side

// The launchers' contract: K and both row pitches multiples of 16 (whole
// 16-byte TMA chunks; the tail past K is zero-filled), the tile count an int.
// Returns 0 and the tile count, or a cudaError_t.
template <class T>
inline int check_shape(int m, int n, int k, long long lda, long long ldb, long long* tiles) {
  if (k <= 0 || k % 16 != 0 || lda % 16 != 0 || ldb % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  *tiles = static_cast<long long>((m + T::kBM - 1) / T::kBM) * ((n + T::kBN - 1) / T::kBN);
  return *tiles > 0x7fffffffLL ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// 2-D maps (K, rows) over the K-contiguous operands a (m, k), pitch lda, and
// b (n, k), pitch ldb: boxes of kBK bytes by the tile's rows.
template <class T>
inline int encode_operands(CUtensorMap* map_a, CUtensorMap* map_b, const void* a, const void* b,
                           int m, int n, int k, long long lda, long long ldb) {
  const long long box_a[2] = {kBK, T::kBM}, box_b[2] = {kBK, T::kBN};
  const long long dims_a[2] = {k, m}, dims_b[2] = {k, n};
  const int r = encode_tiled(map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a, dims_a, &lda, box_a);
  return r != 0 ? r : encode_tiled(map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, b, dims_b, &ldb, box_b);
}

// One block per SM, or one per tile when there are fewer.
inline unsigned persistent_grid(long long tiles, int sms) {
  return static_cast<unsigned>(tiles < sms ? tiles : sms);
}

// One launch of a GEMM kernel of tile shape T on the persistent grid: the
// shape checks, the SM count and the kernel's shared-memory allowance (once
// per device, cached in the launcher's `setup`), the operands' tensor maps,
// then kernel(map_a, map_b, epilogue..., m, n, k) on `stream`. Returns 0 or a
// cudaError_t.
template <class T, class... Params, class... Epilogue>
inline int launch(void (*kernel)(Params...), std::atomic<int> (&setup)[kMaxDevices],
                  const void* a, const void* b, int m, int n, int k, long long lda,
                  long long ldb, cudaStream_t stream, Epilogue... epilogue) {
  long long tiles = 0;
  int r = check_shape<T>(m, n, k, lda, ldb, &tiles);
  int sms = 0;
  if (r == 0) r = device_setup(kernel, T::kSmemBytes, setup, &sms);
  CUtensorMap map_a, map_b;
  if (r == 0) r = encode_operands<T>(&map_a, &map_b, a, b, m, n, k, lda, ldb);
  if (r != 0) return r;
  kernel<<<persistent_grid(tiles, sms), T::kThreads, T::kSmemBytes, stream>>>(
      map_a, map_b, epilogue..., m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fdm_w8a8
