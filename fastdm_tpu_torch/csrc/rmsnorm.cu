// RMSNorm over the last dimension, bf16 in and out, f32 math.
//
// Replaces: fastdm_tpu/kernels/pallas/elementwise.py rms_norm_pallas (:66),
// kernel body _rms_kernel (:56). Computes y = x * (1 / sqrt(mean(x^2) + eps))
// * w per row in f32 and rounds once to bf16, as the plain version
// (fastdm_tpu_torch/kernels/torch_backend.py rms_norm_torch) does, to within
// one bf16 ulp (IEEE 1/sqrt against rsqrt, f32 sums in another order). The
// weight w is read in the dtype it has (bf16 or f32) or is absent.
//
// What bounds it on the H100: memory bytes. A row of the FLUX per-head q/k norm
// is 128 bf16 (256 bytes) and carries ~4 flops per element, far below the
// ~295 flop/byte ridge, so the floor is (read x + write y) / 3.35 TB/s.
//
// Rows are addressed as row r = t * heads + h at x + t * token_stride + h *
// head_stride, so the per-head view of a fused QKV projection (FLUX: q =
// qkv[..., :H*D] as (B, S, H, D), token stride 3*H*D) and a column slice of a
// wider row (Wan's k = kv[..., :D]) are normalised in place of a copy; the
// Pallas version needed the rows materialised in VMEM-tiled order. The
// output is contiguous (n_rows, dim). Every path is single pass where it can
// be: all loads of a row are issued before its reduction, the row is kept in
// registers and written from them with streaming (evict-first) accesses, so
// the weight stays cached. The wrapper (kernels/cuda_backend.py
// rms_norm_plan) picks the path and the block shape; the launcher checks that
// the path takes the operands.
//   Head rows (dim a multiple of 8 up to 256; FLUX's 128, later 64): a group
//   of `lanes` threads (dim / 8 rounded up to a power of two) owns a row, one
//   16-byte vector per thread, its weight vector loaded once for the thread's
//   kRowsPerThread rows; the sum of squares is a shuffle within the group. A
//   block covers whole tokens (all heads of rows_per_block / heads tokens), so
//   each token's contiguous slice of a strided QKV row is read in one sweep.
//   Wide rows (dim a multiple of 8 up to 8192; Wan2.2-A14B's 5120): one
//   block per row, kWideVecs vectors per thread, warp shuffles, one
//   shared-memory step and the block's one barrier, as csrc/qk_norm_rope.cu's
//   fast path (helpers in bf16_rows.cuh). Measured on the H100 (PERF.md §6):
//   4 vectors a thread, and head-row blocks of 24 or 96 rows, time the same
//   as these.
//   Tail (any other even dim, 4-byte aligned rows): one warp per row, 4-byte
//   pairs, the row read twice (sum of squares, then output).
#include "bf16_rows.cuh"

namespace {

using namespace bf16_rows;

enum Path { kHeadRows = 0, kWideRows = 1, kTail = 2 };

constexpr int kMaxHeadDim = 32 * kVec;    // 256: one row per group of at most a warp
constexpr int kRowsPerThread = 2;         // head rows: vectors in flight per thread
constexpr int kWideVecs = 2;              // wide rows: vectors per thread
constexpr int kMaxWideThreads = 512;
constexpr int kMaxWideDim = kMaxWideThreads * kWideVecs * kVec;  // 8192
constexpr int kTailWarps = 8;

struct RowsIn {
  const __nv_bfloat16* x;
  int64_t token_stride, head_stride;
  int heads;

  __device__ __forceinline__ const __nv_bfloat16* row(int64_t r) const {
    // 32-bit division wherever the row index fits (a 64-bit one is emulated)
    int64_t t;
    if (r <= 0x7fffffff)
      t = static_cast<uint32_t>(r) / static_cast<uint32_t>(heads);
    else
      t = r / heads;
    return x + t * token_stride + (r - t * heads) * head_stride;
  }
};

// ---------------------------------------------------------------- head rows

// Block: blockDim.x / lanes groups; group g holds local rows g + i * groups
// (i < kRowsPerThread) of the block's rows_per_block rows. Every thread takes
// part in the shuffles (lanes past dim / 8 and rows past the end add 0).
template <int G>
__global__ void __launch_bounds__(1024)
rms_norm_head_rows_kernel(const RowsIn in, const void* __restrict__ w,
                          __nv_bfloat16* __restrict__ out, int64_t n_rows, int rows_per_block,
                          int dim, int lanes_log2, float eps) {
  const int lanes = 1 << lanes_log2;
  const int groups = blockDim.x >> lanes_log2;
  const int g = threadIdx.x >> lanes_log2;
  const int col = (threadIdx.x & (lanes - 1)) * kVec;
  const bool has_col = col < dim;
  GammaVec<G> gv;
  if (has_col) gv.load(w, col);
  uint4 x[kRowsPerThread];
  int64_t row[kRowsPerThread];
  bool live[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int local = g + i * groups;
    row[i] = static_cast<int64_t>(blockIdx.x) * rows_per_block + local;
    live[i] = has_col && local < rows_per_block && row[i] < n_rows;
    x[i] = live[i] ? load_stream(in.row(row[i]) + col) : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) ss[i] = sum_sq(x[i]);
  for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], o);
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    if (live[i])
      store_stream(out + row[i] * dim + col, norm_vec<G>(x[i], gv, rms_inverse(ss[i], dim, eps)));
}

// ---------------------------------------------------------------- wide rows

// One block per row; vector i of a thread starts at column (i * blockDim.x +
// threadIdx.x) * 8.
template <int G>
__global__ void __launch_bounds__(kMaxWideThreads)
rms_norm_wide_kernel(const RowsIn in, const void* __restrict__ w, __nv_bfloat16* __restrict__ out,
                     int dim, float eps) {
  __shared__ float red[kMaxWideThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* xr = in.row(blockIdx.x);
  uint4 x[kWideVecs];
  GammaVec<G> gv[kWideVecs];
#pragma unroll
  for (int i = 0; i < kWideVecs; ++i) {
    const int c = (i * blockDim.x + threadIdx.x) * kVec;
    x[i] = make_uint4(0u, 0u, 0u, 0u);
    if (c < dim) {
      x[i] = load_stream(xr + c);
      gv[i].load(w, c);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kWideVecs; ++i) ss += sum_sq(x[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  ss = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x / 32); ++i) ss += red[i];
  const float inv = rms_inverse(ss, dim, eps);
  __nv_bfloat16* yr = out + static_cast<int64_t>(blockIdx.x) * dim;
#pragma unroll
  for (int i = 0; i < kWideVecs; ++i) {
    const int c = (i * blockDim.x + threadIdx.x) * kVec;
    if (c < dim) store_stream(yr + c, norm_vec<G>(x[i], gv[i], inv));
  }
}

// --------------------------------------------------------------------- tail

template <int G>
__global__ void __launch_bounds__(kTailWarps * 32)
rms_norm_tail_kernel(const RowsIn in, const void* __restrict__ w, __nv_bfloat16* __restrict__ out,
                     int64_t n_rows, int dim, float eps) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kTailWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // whole warp leaves together
  const __nv_bfloat16* xr = in.row(row);
  __nv_bfloat16* yr = out + row * dim;
  float ss = 0.f;
  for (int c = lane * 2; c < dim; c += 64) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c));
    ss += f.x * f.x + f.y * f.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rms_inverse(ss, dim, eps);
  for (int c = lane * 2; c < dim; c += 64) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + c));
    *reinterpret_cast<__nv_bfloat162*>(yr + c) =
        __floats2bfloat162_rn(times_gamma<G>(f.x * inv, w, c), times_gamma<G>(f.y * inv, w, c + 1));
  }
}

// ------------------------------------------------------------------- launch

int log2_ceil(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

template <int G>
int launch_kind(const RowsIn& in, const void* w, __nv_bfloat16* out, long long n_rows, int dim,
                float eps, int path, int threads, int rows_per_block, cudaStream_t st) {
  if (path == kHeadRows) {
    const int lanes_log2 = log2_ceil(dim / kVec);
    const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
    rms_norm_head_rows_kernel<G><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        in, w, out, n_rows, rows_per_block, dim, lanes_log2, eps);
  } else if (path == kWideRows) {
    rms_norm_wide_kernel<G><<<static_cast<unsigned>(n_rows), threads, 0, st>>>(in, w, out, dim,
                                                                              eps);
  } else {
    const long long blocks = (n_rows + kTailWarps - 1) / kTailWarps;
    rms_norm_tail_kernel<G><<<static_cast<unsigned>(blocks), kTailWarps * 32, 0, st>>>(
        in, w, out, n_rows, dim, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Whether `path` with this block shape takes the operands (the wrapper's
// rms_norm_plan chooses only such paths).
bool path_takes(int path, const void* x, const void* w, int gamma_kind, const void* out,
                long long token_stride, long long head_stride, int dim, int threads,
                int rows_per_block) {
  if (path == kTail) return dim % 2 == 0 && aligned(x, 4) && token_stride % 2 == 0 &&
                            head_stride % 2 == 0;
  const bool vec = dim % kVec == 0 && aligned(x, 16) && aligned(out, 16) &&
                   token_stride % kVec == 0 && head_stride % kVec == 0 &&
                   (gamma_kind == kNoGamma || aligned(w, 16)) && threads % 32 == 0;
  if (!vec) return false;
  if (path == kHeadRows) {
    const int lanes = 1 << log2_ceil(dim / kVec);
    return dim <= kMaxHeadDim && threads <= 1024 && rows_per_block > 0 &&
           rows_per_block <= kRowsPerThread * (threads / lanes);
  }
  return path == kWideRows && dim <= kMaxWideDim && threads <= kMaxWideThreads &&
         dim <= threads * kWideVecs * kVec;
}

}  // namespace

// x: bf16 rows r = t * heads + h at x + t * token_stride + h * head_stride
// (elements), each row's dim elements contiguous; w: (dim,) contiguous, bf16
// (gamma_kind 1) or f32 (2), or NULL (0); out: contiguous bf16 (n_rows, dim).
// path: 0 head rows (threads per block, rows_per_block rows a block), 1 wide
// rows (one row a block of `threads`), 2 tail; a path that does not take the
// operands returns cudaErrorInvalidValue.
FDM_EXPORT int fdm_rms_norm_bf16(const void* x, const void* w, int gamma_kind, void* out,
                                 long long n_rows, int heads, long long token_stride,
                                 long long head_stride, int dim, float eps, int path, int threads,
                                 int rows_per_block, void* stream) {
  if (n_rows <= 0) return 0;
  if (dim <= 0 || heads <= 0 || gamma_kind < kNoGamma || gamma_kind > kGammaF32 ||
      (gamma_kind != kNoGamma) != (w != nullptr) || path < kHeadRows || path > kTail ||
      !path_takes(path, x, w, gamma_kind, out, token_stride, head_stride, dim, threads,
                  rows_per_block))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowsIn in{static_cast<const __nv_bfloat16*>(x), token_stride, head_stride, heads};
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gamma_kind == kGammaBf16)
    return launch_kind<kGammaBf16>(in, w, y, n_rows, dim, eps, path, threads, rows_per_block, st);
  if (gamma_kind == kGammaF32)
    return launch_kind<kGammaF32>(in, w, y, n_rows, dim, eps, path, threads, rows_per_block, st);
  return launch_kind<kNoGamma>(in, w, y, n_rows, dim, eps, path, threads, rows_per_block, st);
}

FDM_DEFINE_ERROR_STRING(fdm_rms_norm)
