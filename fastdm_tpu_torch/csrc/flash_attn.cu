// Flash-attention forward, bf16 q/k/v/out, f32 softmax state, warpgroup MMA
// fed by the Tensor Memory Accelerator; one kernel, five walks over the KV
// tiles: dense (sdpa) and four radial-sparse table walks of the Wan engine
// (mask, coarse, superblock and fine).
//
// Replaces, in fastdm_tpu/kernels/pallas/attention.py:
//   dense  -- sdpa_pallas (:429), which runs _flash_attention (:338) ->
//             _flash_kernel (:69) / _attn_body (:43) / _softmax_update (:130),
//             and the native-layout twin _flash_attention_nq (:267) /
//             _flash_kernel_nq (:198);
//   mask   -- sdpa_sparse_pallas (:1122; _flash_attention :338, pallas_call
//             :390, kernel _sparse_flash_kernel :155): a (B, Hq, ni, nj) block
//             mask, one row per query block and query head (block_mask);
//   coarse -- sdpa_gather_pallas (:1069; _gather_sparse_attention :515,
//             pallas_call :561, kernel :473): per-q-tile lists of block_k-token
//             KV tiles and their counts (sparse/xsparse.py block_lists);
//   super  -- sdpa_gather_super_pallas (:1002; _gather_super_attention :934,
//             pallas_call :989, kernel :806): CSR rows [start, count] of
//             superblock ids, each an aligned run of `superblock` fine blocks
//             of `fine` tokens, with a bitmask of the active fine sub-blocks
//             (block_lists_super);
//   fine   -- sdpa_gather_fine_pallas (:759; _gather_fine_attention :696,
//             pallas_call :746, kernel :570): CSR rows of fine block ids with
//             the valid tokens of each entry (block_lists_fine). This kernel
//             honours every entry's valid count, as the jnp oracle does
//             (impl.py:343-348); the Pallas kernel derives validity from the
//             global tail alone (attention.py:654-681).
// It reads q, k and v straight from the (B, S, H*D) tensors through 3-D
// tensor maps over (H*D, S, B) with the views' own strides (q|k|v slices of
// one fused projection included), so neither the head transposes nor the
// sequence padding the Pallas wrappers built for Mosaic (attention.py:349-355,
// :423-425) nor the gathered K/V copies of the gather kernels exist here.
//
// Kept from the TPU kernels: the online softmax in base 2 with
// scale*log2(e) folded into the f32 logits (p = 2^(s*scale*log2(e) - max) by
// one FFMA and the special-function unit's ex2), any softmax scale (one <= 0
// scales the logits before their max, as the plain version does), the f32
// running max / sum / accumulator, p rounded to bf16 only as the operand of
// the P.V product (its row sum stays f32), masking of keys at or past skv at
// any sequence length (8704 at the FLUX 1024x2048 shape, 32760 at Wan's
// 480x832x81 and 77 at SDXL's text are not multiples of the tile), an optional
// bottom-right causal mask (dense only), GQA (query head h reads kv head h /
// (Hq/Hkv)), and the l == 0 guard of :126 / :506 (a row that sees no key
// returns 0).
//
// What bounds it on the H100: operations. At the FLUX shape (S=8704, 24 heads,
// D=128) it does 4*S^2*D*H = 9.3e11 flops on 214 MB of q/k/v/out, about 4350
// flops per byte, so the floor is 0.94 ms at 989 bf16 TFLOP/s; a walk counts
// the keys its table allows (of dense attention at Wan's 480x832x81 tables:
// coarse 0.982, super 0.400, fine 0.544).
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
// head's K and V pass through L2 half as often as with 64-query blocks.
// Tiles lie in shared memory as the TMA writes them with
// the 128-byte swizzle: a row of D = 128 bf16 is 256 bytes, so it loads as two
// 64-column boxes and the descriptors step across them. The tensor maps' S
// extent is the view's own length, so keys past the last are zero-filled
// (never the next batch entry's rows, whose 0*Inf could give NaN) and masked.
//
// The walk is a template parameter. Dense is the walk with no table: the
// consumers count the tiles, tile j holds keys j*128 .., and the code is the
// sdpa kernel's as before. A table walk reads its table in the producer, off
// the consumers' path: for the block at q0 (query head h, batch entry b) it
// takes row q0 / block_q, counts the 64-key halves the row allows below skv,
// and publishes the tile count with a second arrival on the Q barrier; then
// each stage is two 64-key boxes per column atom, the next two halves in
// table order, so halves of two entries (or two fine sub-blocks) may share a
// tile. The walks differ only in how a row lists its halves:
//   mask   -- the set entries of row q0 / block_q of mask[b, h], in key order,
//             each block_k / 64 halves. The row is dense (nj entries, most of
//             them 0 at Wan's 256), so warp 0 of the producer loads it 32
//             entries at a time and packs it with __ballot_sync into a bitmask
//             in shared memory before lane 0 walks its set bits with __ffs /
//             __popc; the other lanes then exit;
//   coarse -- the first counts[row] entries of the row, each block_k / 64
//             halves (ids clamped to the KV tiles that exist);
//   super  -- entries [start, start+count) of the CSR row, each a superblock
//             whose set bits name its active fine sub-blocks, each of
//             fine / 64 halves; the set bits are stepped with __ffs / __popc;
//   fine   -- entries [start, start+count), each a fine block whose keys end
//             at fid*fine + valid: the end of each of its halves.
// Keys outside [0, skv) are skipped and padding entries never visited, so a
// malformed table gives a wrong answer, never an out-of-bounds access. The
// producer writes each stage's two first keys and ends into a per-stage
// shared-memory slot before the stage's K arrival; the consumers read it
// before they release the stage and mask each column at or past its half's
// end (skv for coarse and super; a lone last half is loaded twice and its copy
// masked). On a table that allows every key in order a walk runs the same
// tiles, in the same order, through the same code as dense sdpa, so it gives
// the same bits. A block_q that is not a multiple of 128 would let a
// 128-query block straddle two table rows, so such tables run blocks of one
// consumer and 64 query rows (the third warpgroup idles), at about half the
// rate.
#include "sm90.cuh"

namespace {

using namespace fdm_sm90;

constexpr int kBK = 128;       // keys per KV tile
constexpr int kHalf = 64;      // keys of half a KV tile: a table walk's unit
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kAtomCols = 64;  // bf16 columns of one 128-byte swizzle atom (one TMA box)
// setmaxnreg: the producer gives up registers, the consumers take them (at
// launch the 384 threads share the 65536 equally)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(128 * (kProducerRegs + 2 * kConsumerRegs) <= 65536,
              "the register file holds the setmaxnreg split");

// A block of `Consumers` consumer warpgroups (64 query rows each) at head
// dim D; a table walk loads K and V in 64-key boxes and keeps its tile count,
// each stage's keys and ends and (mask walk) its packed table row of RowWords
// words in shared memory.
template <int D, int Consumers, bool Table, int RowWords = 0>
struct Cfg {
  static constexpr int kBQ = 64 * Consumers;       // query rows per block
  static constexpr int kAtoms = D / kAtomCols;      // 128-byte column atoms per row
  static constexpr int kStages = D == 128 ? 2 : 3;  // as shared memory allows
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;      // one K or V tile
  static constexpr int kKVRows = Table ? kHalf : kBK;  // rows of one K / V box
  static constexpr int kBarBytes = (1 + 4 * kStages) * 8;  // the mbarriers
  // a table walk's per-stage slots (int4, 16-byte aligned), then the tile
  // count (16 bytes), then the packed table row
  static constexpr int kSlotsAt = (kBarBytes + 15) & ~15;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes +
                               (Table ? kSlotsAt + 16 * kStages + 16 + 4 * RowWords : kBarBytes);
};

// Dense attention: every 128-key tile in order, up to the causal limit; the
// consumers count the tiles themselves.
struct DenseTables {
  static constexpr bool kTable = false;
  static constexpr int kRowWords = 0;
};

// A table walk is the producer's walk over one row of its table, in 64-key
// halves: tiles() counts the tiles of 128 keys the row's halves fill, two
// halves a tile; next(end) returns the first key of the next half the row
// allows, in table order, and sets `end` (keys at or past it are masked), or
// returns -1 when the row is exhausted. walk(q0, h, b, skv, row_bits) starts
// the walk of the block at query row q0 of query head h and batch entry b;
// only the mask walk reads h, b and row_bits (its row, packed by pack_row).

// Mask: the set bits of a packed mask row in key order, each entry's halves
// below skv in order (only entries whose first key lies below skv are packed).
struct MaskWalk {
  const uint32_t* bits;  // the packed row (shared memory): bit e of word e / 32 is entry e
  int words, halves_per_entry, block_k, skv;
  int w;          // the next word
  uint32_t cur;   // the current word's set bits not yet visited
  int key, left;  // the next half's key and the halves left in its entry

  __device__ __forceinline__ int entry_halves(int k0) const {
    return min(halves_per_entry, (skv - k0 + kHalf - 1) / kHalf);
  }

  __device__ __forceinline__ int tiles() const {
    int set = 0;
    for (int i = 0; i < words; ++i) set += __popc(bits[i]);
    int halves = set * halves_per_entry;
    // only the last entry below skv may end before its last half
    const int last = (skv - 1) / block_k;
    if (last < 32 * words && ((bits[last / 32] >> (last % 32)) & 1u))
      halves -= halves_per_entry - entry_halves(last * block_k);
    return (halves + 1) / 2;
  }

  __device__ __forceinline__ int next(int& end) {
    end = skv;
    while (left == 0) {
      while (cur == 0) {
        if (w >= words) return -1;
        cur = bits[w++];
      }
      key = (32 * (w - 1) + __ffs(static_cast<int>(cur)) - 1) * block_k;
      cur &= cur - 1;
      left = entry_halves(key);
    }
    --left;
    key += kHalf;
    return key - kHalf;
  }
};

// The block masks of sdpa_sparse (RadialAttn.block_mask): mask (batch, heads,
// ni, nj), nonzero where query rows [i*block_q, (i+1)*block_q) of query head h
// attend to keys [j*block_k, (j+1)*block_k); a row holds at most
// 32 * kRowWords entries (4096: 524288 keys at Wan's 128-key tiles).
struct MaskTables {
  static constexpr bool kTable = true;
  static constexpr int kRowWords = 128;
  const int* mask;
  int heads, ni, nj, block_q, block_k;

  // entries whose first key lies below skv
  __device__ __forceinline__ int entries(int skv) const {
    return min(nj, (skv + block_k - 1) / block_k);
  }

  // Warp 0: row min(q0 / block_q, ni - 1) of mask[b, h] into bits, one
  // coalesced load of 32 entries and one ballot per word, stored by lane 0.
  __device__ __forceinline__ void pack_row(uint32_t* bits, int q0, int h, int b, int skv) const {
    const int lane = threadIdx.x & 31;
    const int row = min(q0 / block_q, ni - 1);
    const int* mrow = mask + ((static_cast<long long>(b) * heads + h) * ni + row) * nj;
    const int n = entries(skv);
#pragma unroll 4
    for (int w = 0; 32 * w < n; ++w) {
      const int e = 32 * w + lane;
      const uint32_t word = __ballot_sync(0xffffffffu, e < n && mrow[e] != 0);
      if (lane == 0) bits[w] = word;
    }
  }

  __device__ __forceinline__ MaskWalk walk(int, int, int, int skv, const uint32_t* bits) const {
    return MaskWalk{bits, (entries(skv) + 31) / 32, block_k / kHalf, block_k, skv, 0, 0u, 0, 0};
  }
};

// Coarse: entries in table order, each entry's halves below skv in order.
// Entry ids are clamped to the KV tiles that exist.
struct CoarseWalk {
  const int* idx;  // this row's entries
  int count, last_tile, halves_per_entry, block_k, skv;
  int e, t;        // the next entry and half

  __device__ __forceinline__ int key(int entry, int half) const {
    return min(max(idx[entry], 0), last_tile) * block_k + half * kHalf;
  }

  __device__ __forceinline__ int tiles() const {
    int halves = 0;
    for (int j = 0; j < count; ++j)
      halves += min(halves_per_entry, (skv - key(j, 0) + kHalf - 1) / kHalf);
    return (halves + 1) / 2;
  }

  __device__ __forceinline__ int next(int& end) {
    end = skv;
    for (; e < count; ++e, t = 0) {
      if (t < halves_per_entry) {
        const int k0 = key(e, t);
        if (k0 < skv) {
          ++t;
          return k0;
        }
      }
    }
    return -1;
  }
};

// The coarse gather lists of sdpa_gather (RadialAttn.block_lists): row i of
// idx (nq, max_nb) lists the KV tiles of block_k keys that query rows
// [i*block_q, (i+1)*block_q) attend to; its first counts[i] entries are
// visited, padding entries never.
struct CoarseTables {
  static constexpr bool kTable = true;
  static constexpr int kRowWords = 0;
  const int* idx;
  const int* counts;
  int nq, max_nb, block_q, block_k;

  __device__ __forceinline__ CoarseWalk walk(int q0, int, int, int skv, const uint32_t*) const {
    const int row = min(q0 / block_q, nq - 1);
    return CoarseWalk{idx + static_cast<long long>(row) * max_nb,
                      min(max(counts[row], 0), max_nb), (skv + block_k - 1) / block_k - 1,
                      block_k / kHalf, block_k, skv, 0, 0};
  }
};

// The first entry and the entry count of CSR row `row` ([start, count]),
// clamped to the n_slots entries of the table.
__device__ __forceinline__ int2 csr_row(const int* rows, int row, int n_slots) {
  const int start = min(max(rows[2 * row], 0), n_slots);
  return make_int2(start, min(max(rows[2 * row + 1], 0), n_slots - start));
}

// Superblock: entries in table order; entry e is superblock idx[e] of
// `super_keys` keys, whose set bits in val[e] (below `superblock`) name its
// active fine sub-blocks of `fine` keys, each fine / 64 halves below skv, in
// key order. An id whose keys all lie outside [0, skv) is skipped.
struct SuperWalk {
  const int* idx;  // this row's entries
  const int* val;
  int count, last_super, fine, super_keys, bits_mask, skv;
  int e, bits, base, key, left;  // the next entry; the current entry's bits not
                                 // yet visited and first key; the next half's
                                 // key and the halves left in its sub-block

  __device__ __forceinline__ bool exists(int sid) const { return sid >= 0 && sid <= last_super; }

  // halves of the fine sub-block at key k0 that lie below skv
  __device__ __forceinline__ int sub_halves(int k0) const {
    return min(fine / kHalf, max((skv - k0 + kHalf - 1) / kHalf, 0));
  }

  __device__ __forceinline__ int tiles() const {
    int halves = 0;
    for (int j = 0; j < count; ++j) {
      const int sid = idx[j];
      if (!exists(sid)) continue;
      const int k0 = sid * super_keys;
      int b = val[j] & bits_mask;
      if (k0 + super_keys <= skv) {  // every sub-block lies below skv
        halves += __popc(b) * (fine / kHalf);
        continue;
      }
      for (; b != 0; b &= b - 1) halves += sub_halves(k0 + (__ffs(b) - 1) * fine);
    }
    return (halves + 1) / 2;
  }

  __device__ __forceinline__ int next(int& end) {
    end = skv;
    while (left == 0) {
      while (bits == 0) {
        if (e >= count) return -1;
        const int sid = idx[e];
        if (exists(sid)) {
          bits = val[e] & bits_mask;
          base = sid * super_keys;
        }
        ++e;
      }
      key = base + (__ffs(bits) - 1) * fine;
      bits &= bits - 1;
      left = sub_halves(key);
    }
    --left;
    key += kHalf;
    return key - kHalf;
  }
};

// The superblock CSR tables of sdpa_gather_super (RadialAttn.block_lists_super):
// idx, val (n_slots,) superblock ids and sub-block bitmasks; rows (nq, 2)
// [start, count] of each q tile of block_q rows. Slots past a row's count are
// padding (valbits 0) and never visited.
struct SuperTables {
  static constexpr bool kTable = true;
  static constexpr int kRowWords = 0;
  const int* idx;
  const int* val;
  const int* rows;
  int n_slots, block_q, fine, superblock;

  __device__ __forceinline__ SuperWalk walk(int q0, int, int, int skv, const uint32_t*) const {
    const int2 r = csr_row(rows, q0 / block_q, n_slots);
    const int super_keys = superblock * fine;
    return SuperWalk{idx + r.x, val + r.x, r.y, (skv - 1) / super_keys, fine, super_keys,
                     (1 << superblock) - 1, skv, 0, 0, 0, 0, 0};
  }
};

// Fine: entries in table order; entry e is fine block idx[e], whose keys run
// from fid*fine up to its end min(fid*fine + clamp(valid[e], 0, fine), skv),
// which is also the end of each of its halves. An id whose keys all lie
// outside [0, skv) is skipped.
struct FineWalk {
  const int* idx;  // this row's entries
  const int* valid;
  int count, last_fine, fine, skv;
  int e, key, end;  // the next entry; the next half's key and its entry's end

  __device__ __forceinline__ bool exists(int fid) const { return fid >= 0 && fid <= last_fine; }

  __device__ __forceinline__ int entry_end(int j, int k0) const {
    return min(k0 + min(max(valid[j], 0), fine), skv);
  }

  __device__ __forceinline__ int tiles() const {
    int halves = 0;
    for (int j = 0; j < count; ++j) {
      const int fid = idx[j];
      if (exists(fid)) halves += (entry_end(j, fid * fine) - fid * fine + kHalf - 1) / kHalf;
    }
    return (halves + 1) / 2;
  }

  __device__ __forceinline__ int next(int& half_end) {
    while (key >= end) {
      if (e >= count) return -1;
      const int fid = idx[e];
      if (exists(fid)) {
        key = fid * fine;
        end = entry_end(e, key);
      }
      ++e;
    }
    half_end = end;
    key += kHalf;
    return key - kHalf;
  }
};

// The fine CSR tables of sdpa_gather_fine (RadialAttn.block_lists_fine): idx,
// valid (n_slots,) fine block ids and their valid tokens; rows (nq, 2)
// [start, count] of each q tile of block_q rows.
struct FineTables {
  static constexpr bool kTable = true;
  static constexpr int kRowWords = 0;
  const int* idx;
  const int* valid;
  const int* rows;
  int n_slots, block_q, fine;

  __device__ __forceinline__ FineWalk walk(int q0, int, int, int skv, const uint32_t*) const {
    const int2 r = csr_row(rows, q0 / block_q, n_slots);
    return FineWalk{idx + r.x, valid + r.x, r.y, (skv - 1) / fine, fine, skv, 0, 0, 0};
  }
};

// Named barriers 1 and 2 order the two consumer warpgroups' MMA issue: a
// warpgroup waits for its turn (its own barrier, completed by the other
// warpgroup's arrival), issues, and passes the turn (arrives on the other's).
// A block with one consumer takes no turns.
template <int Consumers>
__device__ __forceinline__ void turn_wait(int cw) {
  if constexpr (Consumers == 2) named_barrier_sync(1 + cw, 256);
}

template <int Consumers>
__device__ __forceinline__ void turn_pass(int cw) {
  if constexpr (Consumers == 2) named_barrier_arrive(2 - cw, 256);
}

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

// The logits of the KV tile whose halves start at keys key.x and key.y and
// end at key.z and key.w (this thread's rows r0, r0 + 8; the dense walk's
// halves are adjacent, key.y = key.x + 64, both ending at skv; a table walk's
// need not be, and a fine walk's end inside a half): keys at or past their
// half's end and the causal upper triangle masked, the running max updated in
// base-2 units (scale_log2 times the raw row max: the same number as the max
// of the scaled logits when the scale is positive), and each logit turned into
// p = 2^(s * scale_log2 - max) by one FFMA and ex2; returns each row's rescale
// factor alpha and its p sum (a per-thread partial, quad-summed at the end).
// A scale <= 0 would turn the raw max into the scaled minimum (and 0 * -inf
// into NaN), so then the logits are scaled first and the rest runs at scale 1.
template <bool kHalves>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBK / 2], float (&m_run)[2],
                                             float (&alpha)[2], float (&rs)[2], int4 key,
                                             int causal, int wrow, int r0, int diag, int t,
                                             float scale_log2) {
  if (scale_log2 <= 0.f) {  // uniform over the grid: a branch no warp diverges on
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] *= scale_log2;
    scale_log2 = 1.f;
  }
  // accumulator column 8n + c is key key.x + 8n + c in the first half and
  // hi0 + 8n + c in the second
  const int hi0 = kHalves ? key.y - kHalf : key.x;
  const bool cut = kHalves ? key.x + kHalf > key.z || key.y + kHalf > key.w : key.x + kBK > key.z;
  if (cut || (causal && key.x + kBK - 1 > wrow + diag)) {
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (n < kHalf / 8 ? key.x : hi0) + n * 8 + 2 * t + (e & 1);
        const int end = n < kHalf / 8 ? key.z : key.w;
        const int row = r0 + (e >> 1) * 8;
        if (col >= end || (causal && col > row + diag)) sc[4 * n + e] = -INFINITY;
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
template <int D, int BQ>
__device__ __forceinline__ void issue_qk(float (&sc)[kBK / 2], uint32_t q_addr, uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_m64n128k16_bf16_ss(sc, desc_sw128(q_addr + (kk / 4) * BQ * 128 + off, 0),
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

// The first keys of tile j's two 64-key halves and their ends: a table
// walk's are in its stage's slot, written by the producer before the stage's
// K arrival (read before the stage is released); the dense walk's are j*kBK
// and j*kBK + 64, both ending at skv.
template <class Tables>
__device__ __forceinline__ int4 tile_keys(const int4* keys_s, int s, int j, int skv) {
  if constexpr (Tables::kTable) return keys_s[s];
  else return make_int4(j * kBK, j * kBK + kHalf, skv, skv);
}

// K or V of one tile as two 64-key halves, at keys lo and hi, each box one
// column atom by 64 rows (the halves of a 128-row tile, as a 128-row box
// would lay them out: the swizzle follows the 1024-byte aligned address).
template <int D>
__device__ __forceinline__ void load_halves(uint8_t* dst, const CUtensorMap* map, uint64_t* full,
                                            int col0, int lo, int hi, int b, int bytes) {
  mbar_arrive_expect_tx(full, bytes);
#pragma unroll
  for (int a = 0; a < D / kAtomCols; ++a) {
    tma_load_3d(dst + a * kBK * 128, map, full, col0 + a * kAtomCols, lo, b);
    tma_load_3d(dst + a * kBK * 128 + kHalf * 128, map, full, col0 + a * kAtomCols, hi, b);
  }
}

template <int D, int Consumers, class Tables>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
                      const Tables tables, int sq, int skv, int hq, int hkv, int64_t o_sb,
                      int64_t o_ss, float scale_log2, int causal) {
  using C = Cfg<D, Consumers, Tables::kTable, Tables::kRowWords>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw));
  uint8_t* q_s = smem;                                  // [atom][kBQ rows][128 B]
  uint8_t* k_s = q_s + C::kQBytes;                      // [stage][atom][kBK rows][128 B]
  uint8_t* v_s = k_s + C::kStages * C::kKVBytes;        // the same
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + C::kStages * C::kKVBytes);
  uint64_t* k_full = q_full + 1;                        // [stage]: K bytes landed
  uint64_t* v_full = k_full + C::kStages;               // [stage]: V bytes landed
  uint64_t* k_empty = v_full + C::kStages;              // [stage]: every consumer read K
  uint64_t* v_empty = k_empty + C::kStages;             // [stage]: every consumer read V
  // table walks: [stage] the halves' first keys and ends, then the tile
  // count, then (mask walk) the packed table row
  int4* keys_s = reinterpret_cast<int4*>(reinterpret_cast<uint8_t*>(q_full) + C::kSlotsAt);
  int* n_tiles_s = reinterpret_cast<int*>(keys_s + C::kStages);
  uint32_t* row_bits_s = reinterpret_cast<uint32_t*>(n_tiles_s + 4);

  const int q0 = blockIdx.x * C::kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  // causal: query row i sees keys j <= i + (skv - sq) (bottom-right aligned,
  // as the plain version's tril(k=skv-sq); identical to top-left when sq == skv)
  const int diag = skv - sq;
  int kv_end = skv;
  if (causal) kv_end = min(skv, min(q0 + C::kBQ, sq) + diag);
  // the dense walk's tiles; a table walk's producer counts its row's and
  // publishes the count with its second arrival on q_full
  int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, Tables::kTable ? 2 : 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * Consumers);  // lane 0 of each consumer warp
      mbar_init(&v_empty[s], 4 * Consumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // the producer, and the idle third warpgroup of a one-consumer block
  if (wg == 0 || (Consumers == 1 && wg == 2)) {
    setmaxnreg_dec<kProducerRegs>();
    if constexpr (Tables::kRowWords > 0) {
      // warp 0 packs the block's table row; lane 0, which stores every
      // word, walks it
      if (threadIdx.x >= 32) return;
      tables.pack_row(row_bits_s, q0, h, b, skv);
    }
    if (threadIdx.x != 0) return;
    if (Tables::kTable || n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
        tma_load_3d(q_s + a * C::kBQ * 128, &map_q, q_full, h * D + a * kAtomCols, q0, b);
    }
    if constexpr (Tables::kTable) {
      // the row's table read here, off the consumers' path: its tile count,
      // then each tile's two halves in the walk's order (a lone last half is
      // loaded again as the second one, which the consumers mask: its key and
      // end are skv)
      auto walk = tables.walk(q0, h, b, skv, row_bits_s);
      n_tiles = walk.tiles();
      *n_tiles_s = n_tiles;
      mbar_arrive(q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % C::kStages;
        const uint32_t parity = ((j / C::kStages) & 1) ^ 1;
        int lo_end, hi_end;
        const int lo = walk.next(lo_end);
        int hi = walk.next(hi_end);
        mbar_wait(&k_empty[s], parity);
        keys_s[s] = hi < 0 ? make_int4(lo, skv, lo_end, skv) : make_int4(lo, hi, lo_end, hi_end);
        if (hi < 0) hi = lo;
        load_halves<D>(k_s + s * C::kKVBytes, &map_k, &k_full[s], hk * D, lo, hi, b,
                       C::kKVBytes);
        mbar_wait(&v_empty[s], parity);
        load_halves<D>(v_s + s * C::kKVBytes, &map_v, &v_full[s], hk * D, lo, hi, b,
                       C::kKVBytes);
      }
    } else {
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
  if constexpr (Tables::kTable) {
    mbar_wait(q_full, 0);
    n_tiles = *n_tiles_s;
  }

  float o[D / 2];  // 64 x D: accumulator 4j + e at row r0 + 8(e/2), column 8j + 2t + e%2
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float alpha[2], rs[2];
  float sc[kBK / 2];
  uint32_t pa[kBK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // two consumers take turns issuing their MMAs, warpgroup 1 first: one
  // warpgroup's softmax runs while the other's MMAs hold the tensor cores.
  // Each issues n_tiles + 1 times; the last turn of warpgroup 2 passes none.
  const int cw = wg - 1;
  if (n_tiles > 0) {
    if (cw == 1) turn_pass<Consumers>(cw);  // warpgroup 1's first turn
    mbar_wait(q_full, 0);
    turn_wait<Consumers>(cw);
    mbar_wait(&k_full[0], 0);
    const int4 key = tile_keys<Tables>(keys_s, 0, 0, skv);
    issue_qk<D, C::kBQ>(sc, q_addr, k_base);
    turn_pass<Consumers>(cw);
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(&k_empty[0]);
    softmax_tile<Tables::kTable>(sc, m_run, alpha, rs, key, causal, wrow, r0, diag, t,
                                 scale_log2);
    rescale_and_pack<D>(o, l_run, alpha, rs, sc, pa);
  }
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % C::kStages, sp = (j - 1) % C::kStages;
    turn_wait<Consumers>(cw);
    mbar_wait(&k_full[s], (j / C::kStages) & 1);
    const int4 key = tile_keys<Tables>(keys_s, s, j, skv);
    issue_qk<D, C::kBQ>(sc, q_addr, k_base + s * C::kKVBytes);
    mbar_wait(&v_full[sp], ((j - 1) / C::kStages) & 1);
    issue_pv<D>(o, pa, v_base + sp * C::kKVBytes);
    turn_pass<Consumers>(cw);
    wgmma_wait<1>();  // S of tile j
    fence_regs(sc);
    if (lane == 0) mbar_arrive(&k_empty[s]);
    softmax_tile<Tables::kTable>(sc, m_run, alpha, rs, key, causal, wrow, r0, diag, t,
                                 scale_log2);
    wgmma_wait<0>();  // P V of tile j-1
    fence_regs(o);
    if (lane == 0) mbar_arrive(&v_empty[sp]);
    rescale_and_pack<D>(o, l_run, alpha, rs, sc, pa);
  }
  if (n_tiles > 0) {
    const int sp = (n_tiles - 1) % C::kStages;
    turn_wait<Consumers>(cw);
    mbar_wait(&v_full[sp], ((n_tiles - 1) / C::kStages) & 1);
    issue_pv<D>(o, pa, v_base + sp * C::kKVBytes);
    if (cw == 0) turn_pass<Consumers>(cw);
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

// The operands both entries share: q: (B, sq, hq*D), k/v: (B, skv, hkv*D),
// out: (B, sq, hq*D), all bf16 with a contiguous last dim, 16-byte aligned,
// strides multiples of 8 elements; geom holds the tensor-map geometry of q, k
// and v (8 values each, see launch); out is written through its batch /
// sequence strides in elements. scale_log2 = softmax scale * log2(e). D is 64
// or 128.
struct Operands {
  const void* ptrs[4];  // q, k, v, out
  const long long* geom;
  int batch, sq, skv, hq, hkv, head_dim;
  long long o_sb, o_ss;
  float scale_log2;
  int causal;
  cudaStream_t stream;
};

template <int D, int Consumers, class Tables>
int launch(const Tables& tables, const Operands& a) {
  using C = Cfg<D, Consumers, Tables::kTable, Tables::kRowWords>;
  // geom: q, k, v, 8 values each (kernels/tma.py attention_geometry): dims
  // (H*D, S, B) in elements, byte strides of S and B, box (64, rows, 1). The
  // box and extents must be the ones this kernel tiles by.
  const long long want[3][4] = {
      {static_cast<long long>(a.hq) * D, a.sq, a.batch, C::kBQ},
      {static_cast<long long>(a.hkv) * D, a.skv, a.batch, C::kKVRows},
      {static_cast<long long>(a.hkv) * D, a.skv, a.batch, C::kKVRows}};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const long long* gm = a.geom + 8 * i;
    if (gm[0] != want[i][0] || gm[1] != want[i][1] || gm[2] != want[i][2] ||
        gm[5] != kAtomCols || gm[6] != want[i][3] || gm[7] != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const int r = encode_tiled(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a.ptrs[i], gm,
                               gm + 3, gm + 5);
    if (r != 0) return r;
  }
  static std::atomic<int> setup[kMaxDevices];
  int sms = 0;
  const int r = device_setup(flash_attn_fwd_kernel<D, Consumers, Tables>, C::kSmem, setup, &sms);
  if (r != 0) return r;
  const dim3 grid(static_cast<unsigned>((a.sq + C::kBQ - 1) / C::kBQ),
                  static_cast<unsigned>(a.hq), static_cast<unsigned>(a.batch));
  flash_attn_fwd_kernel<D, Consumers, Tables><<<grid, kThreads, C::kSmem, a.stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(const_cast<void*>(a.ptrs[3])),
      tables, a.sq, a.skv, a.hq, a.hkv, a.o_sb, a.o_ss, a.scale_log2, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int Consumers, class Tables>
int run(const Tables& tables, const Operands& a) {
  if (a.batch <= 0 || a.sq <= 0) return 0;
  if (a.skv <= 0 || a.hkv <= 0 || a.hq % a.hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (a.head_dim == 128) return launch<128, Consumers>(tables, a);
  if (a.head_dim == 64) return launch<64, Consumers>(tables, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A table walk (non-causal): blocks of two consumers when block_q is a
// multiple of 128 (q's box 128 rows), else blocks of one consumer, so that no
// block straddles two table rows (q's box 64 rows); k's and v's boxes are 64
// rows.
template <class Tables>
int run_walk(const Tables& tables, int block_q, const Operands& a) {
  if (a.causal != 0) return static_cast<int>(cudaErrorInvalidValue);
  return block_q % (2 * kHalf) == 0 ? run<2>(tables, a) : run<1>(tables, a);
}

}  // namespace

#define FDM_ATTN_PARAMS                                                                    \
  const void *q, const void *k, const void *v, void *out, const long long *geom, int batch, \
      int sq, int skv, int hq, int hkv, int head_dim, long long o_sb, long long o_ss,       \
      float scale_log2, int causal, void *stream
#define FDM_ATTN_OPERANDS                                                                  \
  Operands {                                                                               \
    {q, k, v, out}, geom, batch, sq, skv, hq, hkv, head_dim, o_sb, o_ss, scale_log2, causal, \
        static_cast<cudaStream_t>(stream)                                                  \
  }

// Dense attention, with an optional bottom-right causal mask. q, k and v's
// maps have boxes of 128 rows.
FDM_EXPORT int fdm_flash_attn_fwd(FDM_ATTN_PARAMS) {
  return run<2>(DenseTables{}, FDM_ATTN_OPERANDS);
}

// The table walks below are non-causal (causal must be 0) and take block_q
// and their tile sizes as multiples of 64; nq = ceil(sq/block_q).

// The mask walk. mask: int32 (batch, hq, ni, nj) block mask of block_q x
// block_k tiles, nonzero where a tile is computed; nj at most
// 32 * MaskTables::kRowWords.
FDM_EXPORT int fdm_flash_attn_mask_fwd(const void* mask, int ni, int nj, int block_q, int block_k,
                                       FDM_ATTN_PARAMS) {
  if (block_q < kHalf || block_q % kHalf != 0 || block_k < kHalf || block_k % kHalf != 0 ||
      ni < 1 || nj < 1 || nj > 32 * MaskTables::kRowWords)
    return static_cast<int>(cudaErrorInvalidValue);
  const MaskTables t{static_cast<const int*>(mask), hq, ni, nj, block_q, block_k};
  return run_walk(t, block_q, FDM_ATTN_OPERANDS);
}

// The coarse gather walk. idx: int32 (nq, max_nb) KV tile ids of block_k
// tokens; counts: int32 (nq, 1).
FDM_EXPORT int fdm_flash_attn_coarse_fwd(const void* idx, const void* counts, int nq, int max_nb,
                                         int block_q, int block_k, FDM_ATTN_PARAMS) {
  if (block_q < kHalf || block_q % kHalf != 0 || block_k < kHalf || block_k % kHalf != 0 ||
      nq < 1 || max_nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const CoarseTables t{static_cast<const int*>(idx), static_cast<const int*>(counts), nq, max_nb,
                       block_q, block_k};
  return run_walk(t, block_q, FDM_ATTN_OPERANDS);
}

// The superblock walk. idx / val: int32 (n_slots,) superblock ids and
// sub-block bitmasks; rows: int32 (nq, 2) [start, count]; superblock in [1, 30].
FDM_EXPORT int fdm_flash_attn_super_fwd(const void* idx, const void* val, const void* rows,
                                        int n_slots, int block_q, int fine, int superblock,
                                        FDM_ATTN_PARAMS) {
  if (block_q < kHalf || block_q % kHalf != 0 || fine < kHalf || fine % kHalf != 0 ||
      superblock < 1 || superblock > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const SuperTables t{static_cast<const int*>(idx), static_cast<const int*>(val),
                      static_cast<const int*>(rows), n_slots, block_q, fine, superblock};
  return run_walk(t, block_q, FDM_ATTN_OPERANDS);
}

// The fine walk. idx / valid: int32 (n_slots,) fine block ids and their valid
// tokens; rows: int32 (nq, 2) [start, count].
FDM_EXPORT int fdm_flash_attn_fine_fwd(const void* idx, const void* valid, const void* rows,
                                       int n_slots, int block_q, int fine, FDM_ATTN_PARAMS) {
  if (block_q < kHalf || block_q % kHalf != 0 || fine < kHalf || fine % kHalf != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FineTables t{static_cast<const int*>(idx), static_cast<const int*>(valid),
                     static_cast<const int*>(rows), n_slots, block_q, fine};
  return run_walk(t, block_q, FDM_ATTN_OPERANDS);
}

namespace {

template <bool Table, int RowWords>
int smem_bytes(bool d128, int consumers) {
  if (consumers == 2)
    return d128 ? Cfg<128, 2, Table, RowWords>::kSmem : Cfg<64, 2, Table, RowWords>::kSmem;
  if (consumers == 1 && Table)
    return d128 ? Cfg<128, 1, Table, RowWords>::kSmem : Cfg<64, 1, Table, RowWords>::kSmem;
  return 0;
}

}  // namespace

// Dynamic shared memory of one block, bytes: dense (table 0, two consumers),
// a coarse, superblock or fine walk (table 1) or the mask walk (table 2), one
// or two consumers, at head dim D (0 for another shape).
FDM_EXPORT int fdm_flash_attn_smem_bytes(int head_dim, int consumers, int table) {
  const bool d128 = head_dim == 128;
  if (!d128 && head_dim != 64) return 0;
  if (table == 0) return smem_bytes<false, 0>(d128, consumers);
  if (table == 1) return smem_bytes<true, 0>(d128, consumers);
  if (table == 2) return smem_bytes<true, MaskTables::kRowWords>(d128, consumers);
  return 0;
}

// Registers per thread after setmaxnreg: a consumer's (consumer != 0) or the
// producer's.
FDM_EXPORT int fdm_flash_attn_setmaxnreg(int consumer) {
  return consumer ? kConsumerRegs : kProducerRegs;
}

FDM_DEFINE_SM90_ERROR_STRING(fdm_flash_attn)
