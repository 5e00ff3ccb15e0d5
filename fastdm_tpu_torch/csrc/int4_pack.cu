// Unpack of the W4A4 weights' packed "halves" layout (quant="int4p", two int4
// values per byte) into the int8 carriers the s8 GEMM (w8a8_gemm.cu,
// fdm_w4a4_gemm) reads as its B operand.
//
// Replaces: the in-graph unpack of fastdm_tpu/layers/qlinear.py unpack_int4
// (:75-83), which qlinear_apply runs on every int4p linear call (:283); jnp
// code, not a Pallas kernel. JAX's w4p is (K/2, N): byte [j, n] holds q[j, n]
// in its low nibble and q[j + K/2, n] in its high nibble. The port stores it
// K-contiguous, as the (N, K/2) byte buffer `packed` (byte [n, j], the same
// pairing per output column), and unpacks it into the K-contiguous (N, K)
// int8 buffer `out`:
//   out[n, j] = sext(packed[n, j] & 0xf),  out[n, j + K/2] = sext(packed[n, j] >> 4),
// each nibble sign-extended from its 4 bits, as jnp's arithmetic shifts
// (p << 4) >> 4 and p >> 4 do: bit-exact.
//
// What bounds it on the H100: memory bytes. K/2 * N bytes read and K * N
// written, no arithmetic to speak of: 1.5 K N bytes / 3.35 TB/s, 0.030 ms for
// FLUX's single-block qkv_mlp weight (K 3072, N 21504).
//
// Design: one thread per 16 packed bytes: one 16-byte streaming load, the
// sign extension four bytes at a time (__vsub4 of the nibble xor 8, minus 8,
// per byte with no borrow between bytes), and two 16-byte streaming stores,
// the low nibbles to the row's first half and the high nibbles to its second.
// That needs K/2 to be a multiple of 16 (FLUX's K of 3072, 12288 and 15360
// are) and both buffers 16-byte aligned; any other even K takes a path of one
// thread per packed byte. The output is a fresh contiguous buffer (the
// wrapper's torch.empty), so the GEMM's 16-byte row pitch holds whenever K is
// a multiple of 16.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Four nibbles, one in the low half of each byte of w, sign-extended into four
// bytes.
__device__ __forceinline__ uint32_t sext_nibbles(uint32_t w) {
  return __vsub4((w & 0x0f0f0f0fu) ^ 0x08080808u, 0x08080808u);
}

// Vector path: thread i unpacks packed vector i, vector j of row n (vecs
// vectors of 16 bytes per packed row).
__global__ void __launch_bounds__(kThreads)
unpack_int4_vec_kernel(const uint4* __restrict__ packed, uint4* __restrict__ out,
                       long long vecs, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long n = i / vecs, j = i - n * vecs;
  const uint4 p = __ldcs(packed + i);
  const uint4 lo = make_uint4(sext_nibbles(p.x), sext_nibbles(p.y), sext_nibbles(p.z),
                              sext_nibbles(p.w));
  const uint4 hi = make_uint4(sext_nibbles(p.x >> 4), sext_nibbles(p.y >> 4),
                              sext_nibbles(p.z >> 4), sext_nibbles(p.w >> 4));
  uint4* row = out + 2 * vecs * n;  // an output row holds 2 * vecs vectors
  __stcs(row + j, lo);
  __stcs(row + vecs + j, hi);
}

// Byte path: thread i unpacks packed byte i, byte j of row n (half bytes per
// packed row); the shifts sign-extend by hand on a signed byte.
__global__ void __launch_bounds__(kThreads)
unpack_int4_byte_kernel(const uint8_t* __restrict__ packed, int8_t* __restrict__ out,
                        long long half, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long n = i / half, j = i - n * half;
  const int p = packed[i];  // 0..255
  out[2 * half * n + j] = static_cast<int8_t>(static_cast<int8_t>(p << 4) >> 4);
  out[2 * half * n + half + j] = static_cast<int8_t>(static_cast<int8_t>(p) >> 4);
}

}  // namespace

// packed: contiguous (n, half) bytes; out: contiguous (n, 2 * half) int8.
// Returns 0 or a cudaError_t.
FDM_EXPORT int fdm_unpack_int4(const void* packed, void* out, long long n, long long half,
                               void* stream) {
  if (n < 0 || half < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || half == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (half % 16 == 0 && aligned16(packed) && aligned16(out)) {
    const long long total = n * (half / 16);
    const long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    unpack_int4_vec_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const uint4*>(packed), static_cast<uint4*>(out), half / 16, total);
  } else {
    const long long total = n * half;
    const long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    unpack_int4_byte_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const uint8_t*>(packed), static_cast<int8_t*>(out), half, total);
  }
  return static_cast<int>(cudaGetLastError());
}

FDM_DEFINE_ERROR_STRING(fdm_unpack_int4)
