// The JAX package's random stream on the card: threefry2x32 splits,
// uniforms and normals.  CUDA C++ for sm_90a (H100).
//
// Replaces the XLA threefry2x32 that jax.random lowers to wherever the JAX
// package draws (vpic_tpu/engine/step.py:364-371, the boundary rounds;
// vpic_tpu/particles/boundary.py:89; vpic_tpu/boundary/models.py:71-77;
// vpic_tpu/emit/models.py:133-167; decks/collisions.py:40-78).  No Pallas
// kernel draws there: this kernel keeps the port's draws on the device, so
// that a CUDA graph can capture them.  It computes what the plain version
// vpic_tpu_torch/core/random.py computes on the CPU:
//   split    out[i] = threefry2x32(key, (0, i))          (n, 2) int64 words
//   uniform  jax/_src/random.py:_uniform of x0 ^ x1, float32 in [lo, hi)
//   normal   sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1)), float32
// for i in [0, n), the counter's high word 0 (n < 2^32): the
// partitionable threefry of JAX 0.9 (jax_threefry_partitionable on).
//
// Design: one thread per counter (one output word pair of the hash), a
// grid-stride loop.  The key is read from a device pointer inside the
// kernel, never passed by value: a captured graph reads the key's buffer
// at every replay, where a value would freeze the capture's key into the
// graph and every replay would draw the same numbers.  A split stores its
// key pair as one 16-byte store; the launcher refuses an output that is
// not 16-byte aligned.
//
// Floating point: the library is built with -fmad=false, and every
// operation here names its rounding.  XLA on the CPU contracts the
// uniform's f * (hi - lo) + lo and each Horner step of erf_inv into a
// fused multiply-add, so they are __fmaf_rn here (and rounded once in the
// plain version); the rest is one rounding per operation.  Denormals are
// kept (no -ftz), as torch keeps them on the CPU.  log1pf is CUDA's, so a
// normal may differ from the plain version's by a few ulps; splits and
// uniforms are bitwise the plain version's.
//
// What bounds it on the H100: the words written (16 B per split key, 4 B
// per float) at 3.35 TB/s, or the hash's integer work: 20 rounds of an
// add, a rotate (one funnel shift) and a xor, and 6 key injections of two
// adds, at least 72 int32 operations per counter (chip_smoke.py's
// threefry_bound counts them at 128 lanes per SM and clock).  ptxas
// (sm_90a): 14-18 registers, no spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 0, kUniform = 1, kNormal = 2;
constexpr int kBlock = 256;
constexpr unsigned long long kMaxDraw = 0xFFFFFFFFull;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// jax/_src/prng.py:_threefry2x32_lowering, unrolled.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__device__ __forceinline__ float uniform_of(uint32_t b, float lo, float hi) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fmaf_rn(f, __fsub_rn(hi, lo), lo));
}

// XLA's ErfInv32: Giles' polynomials over w = -log1p(-x^2).
__device__ __forceinline__ float erf_inv(float x) {
  const float lt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                        -0.00417768164f,  0.246640727f,    1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                        0.00943887047f,   1.00167406f,     2.83297682f};
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, lt ? lt5[i] : ge5[i]);
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000))
                          : __fmul_rn(p, x);
}

template <int kMode>
__global__ void __launch_bounds__(kBlock)
    threefry_kernel(const long long* __restrict__ key, void* __restrict__ out,
                    unsigned long long n, float lo, float hi) {
  const uint32_t k0 = (uint32_t)__ldg(key), k1 = (uint32_t)__ldg(key + 1);
  const unsigned long long stride = (unsigned long long)gridDim.x * kBlock;
  for (unsigned long long i = (unsigned long long)blockIdx.x * kBlock +
                              threadIdx.x;
       i < n; i += stride) {
    uint32_t x0 = 0, x1 = (uint32_t)i;
    threefry2x32(k0, k1, x0, x1);
    if (kMode == kSplit) {
      reinterpret_cast<longlong2*>(out)[i] =
          make_longlong2((long long)x0, (long long)x1);
    } else if (kMode == kUniform) {
      reinterpret_cast<float*>(out)[i] = uniform_of(x0 ^ x1, lo, hi);
    } else {
      // jax/_src/random.py:_normal_real: lo = nextafter(-1, 0), hi = 1
      const float u = uniform_of(x0 ^ x1, __int_as_float(0xBF7FFFFF), 1.0f);
      reinterpret_cast<float*>(out)[i] =
          __fmul_rn(1.41421354f, erf_inv(u));
    }
  }
}

}  // namespace

extern "C" {

// Launches `mode` (0 split, 1 uniform, 2 normal) of n counters
// under the (2,) int64 key at `key` on `stream`.  Returns
// cudaErrorInvalidValue for an unknown mode, n >= 2^32, a key that is not
// 8-byte aligned or a split output that is not 16-byte aligned; else the
// launch's cudaError_t (0 for n = 0, which launches nothing).
int vpic_threefry(const void* key, void* out, unsigned long long n, int mode,
                  float lo, float hi, void* stream) {
  if (mode < kSplit || mode > kNormal || n > kMaxDraw ||
      (reinterpret_cast<uintptr_t>(key) & 7) != 0 ||
      (mode == kSplit && (reinterpret_cast<uintptr_t>(out) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const unsigned long long want = (n + kBlock - 1) / kBlock;
  const int blocks = (int)(want < 132ull * 16 ? want : 132ull * 16);
  cudaStream_t st = (cudaStream_t)stream;
  const long long* k = static_cast<const long long*>(key);
  switch (mode) {
    case kSplit:
      threefry_kernel<kSplit><<<blocks, kBlock, 0, st>>>(k, out, n, lo, hi);
      break;
    case kUniform:
      threefry_kernel<kUniform><<<blocks, kBlock, 0, st>>>(k, out, n, lo, hi);
      break;
    default:
      threefry_kernel<kNormal><<<blocks, kBlock, 0, st>>>(k, out, n, lo, hi);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
