// The probe kernels of tools/: the TPU layout and feasibility probes
// (tools/vpu_layout_probe.py, tools/probe_batched.py) as hand-written
// kernels.  CUDA C++ for sm_90a (H100).
//
// Each kernel computes what its plain PyTorch version in
// vpic_tpu_torch/tools/ computes, at any shape its wrapper accepts.  Six
// kernels, each behind a plain C function that takes pointers, sizes and
// the stream, allocates nothing and returns cudaGetLastError():
//
// vpic_probe_vpu_chain   replaces tools/vpu_layout_probe.py:_kernel.  On
//   the (rows, n) window of an (out_rows, n) block: acc = x, then reps x
//   { acc = acc*1.0000001f + 1; acc = acc > 2 ? acc - 1 : acc }; rows
//   rows..out_rows-1 are written as zeros.  Bound: operations, five float32
//   instructions per element and rep (multiply, add, compare, subtract,
//   select); 2^17 elements x 1024 reps x 5 = 6.7e8, 0.0100 ms at the
//   published 67 TFLOP/s.  Design: one thread per element, neighbouring
//   threads on neighbouring columns; each step is rounded as the source
//   writes it (__fmul_rn, __fadd_rn, __fsub_rn, and -fmad=false), so
//   no multiply and add are contracted into an FMA.  The TPU's question,
//   whether a (1, n) row wastes 7 of 8 sublanes, has no counterpart: a
//   warp takes 32 consecutive elements of any row.
//
// vpic_probe_gather3d    replaces tools/probe_batched.py:probe_gather3d,
//   out[a,r,l] = sum_w bf16(win[a,w]) * bf16(oh[r,w,l]) in float32;
// vpic_probe_deposit2d   replaces tools/probe_batched.py:probe_deposit2d,
//   out[k,w] = sum_{r,l} bf16(c[k,r,l]) * bf16(oh[r,w,l]) in float32.
//   Both are one product C = A B on the tensor cores, which is what the
//   probes ask of the TPU's matrix unit: gather3d A = win (M = A, K = W),
//   B[w, r*L + l] = oh[r,w,l]; deposit2d A = c (M = K_c, K = R*L),
//   B[r*L + l, w] = oh[r,w,l]; oh is read through its (R, W, L) strides.
//   Bound: bytes (oh's 2 MB in float32 dominates; the tool's shapes move
//   2.29 and 2.17 MB, 0.68 and 0.65 us at 3.35 TB/s; 33.5 MFLOP of bf16
//   products is 0.03 us at 989 TFLOP/s).  Design: nvcuda::wmma bf16
//   16x16x16 fragments with float32 accumulation, a 16 x 64 tile of C per
//   block of four warps (one 16x16 tile each), K staged 64 at a time in
//   shared memory, where each operand is rounded to bf16 with
//   __float2bfloat16_rn (round to nearest even, as JAX's astype and
//   torch's .to(torch.bfloat16)).  Rows, columns and depth past the
//   operands are zeros in shared memory only (deposit2d's M = 12 becomes
//   16 there).  K is summed in increasing order, 16 at a time.
//
// vpic_probe_stack8      replaces tools/probe_batched.py:probe_stack8,
//   out[a,s,l] = bf16(win[a, loc[s,l]]) in float32, 0 where loc lies
//   outside [0, W).  The TPU builds eight one-hot matrices and multiplies,
//   because it lacks a gather; here it is a gather, one thread per output.
//   Bound: bytes (win, loc and out: 0.20 MB at the tool's shape, 0.06 us).
//
// vpic_probe_onehot3d    replaces tools/probe_batched.py:probe_onehot3d,
//   out[r,w,l] = float(loc[r,l] == w).  Bound: bytes, the 2 MB it writes
//   (0.63 us).  Design: one thread per four consecutive l, a 16-byte load
//   of loc and a 16-byte store.
//
// vpic_probe_io4d        replaces tools/probe_batched.py:probe_io4d, per
//   block i: a = 2*ps[i,0] + ps[i,1]; out[i,0] = a > 0 ? a : ps[i,2];
//   out[i,1:8] = ps[i,0:7]; out[i,8:16] = 0.  Bound: bytes (0.38 MB,
//   0.11 us).  Design: one block per i, threads along the (R*L) plane.
//   2*x is exact, so the result does not depend on contraction.
//
// All six are launch-bound at the tools' shapes: each moves at most
// 2.3 MB, under a microsecond of the card's memory rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void vpu_chain_kernel(const float* __restrict__ x,
                                 float* __restrict__ o, int rows, int n,
                                 long long total, int reps) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float acc = 0.0f;
  if (idx / n < rows) {
    acc = x[idx];
    const float c = 1.0000001f, one = 1.0f, two = 2.0f;
    for (int k = 0; k < reps; ++k) {
      acc = __fadd_rn(__fmul_rn(acc, c), one);
      acc = acc > two ? __fsub_rn(acc, one) : acc;
    }
  }
  o[idx] = acc;
}

// C (M x N, row-major) = A (M x K, row-major) B (K x N); B[k, n] read from
// oh (R, W, L): gather3d B[w, r*L + l] (K = W, N = R*L), deposit2d
// B[r*L + l, w] (K = R*L, N = W).
constexpr int kBM = 16, kBN = 64, kBK = 64, kThreads = 128;
constexpr int kLdA = kBK + 8, kLdB = kBN + 8, kLdC = kBN + 4;

template <bool kDeposit>
__global__ void __launch_bounds__(kThreads)
    probe_mma_kernel(const float* __restrict__ a,
                     const float* __restrict__ oh, float* __restrict__ out,
                     int M, int N, int K, int W, int L) {
  __shared__ __align__(32) __nv_bfloat16 As[kBM * kLdA];
  __shared__ __align__(32) __nv_bfloat16 Bs[kBK * kLdB];
  __shared__ __align__(32) float Cs[kBM * kLdC];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32;
  const long long plane = (long long)W * L;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int t = threadIdx.x; t < kBM * kBK; t += kThreads) {
      const int i = t / kBK, kk = t % kBK;
      const int m = m0 + i, k = k0 + kk;
      const float v = (m < M && k < K) ? a[(long long)m * K + k] : 0.0f;
      As[i * kLdA + kk] = __float2bfloat16_rn(v);
    }
    for (int t = threadIdx.x; t < kBK * kBN; t += kThreads) {
      // neighbouring threads on neighbouring l: coalesced reads of oh
      const int kk = kDeposit ? t % kBK : t / kBN;
      const int j = kDeposit ? t / kBK : t % kBN;
      const int k = k0 + kk, n = n0 + j;
      float v = 0.0f;
      if (k < K && n < N) {
        v = kDeposit ? oh[(k / L) * plane + (long long)n * L + k % L]
                     : oh[(n / L) * plane + (long long)k * L + n % L];
      }
      Bs[kk * kLdB + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fa, As + kk, kLdA);
      wmma::load_matrix_sync(fb, Bs + kk * kLdB + warp * 16, kLdB);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(Cs + warp * 16, acc, kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int t = threadIdx.x; t < kBM * kBN; t += kThreads) {
    const int i = t / kBN, j = t % kBN;
    if (m0 + i < M && n0 + j < N)
      out[(long long)(m0 + i) * N + n0 + j] = Cs[i * kLdC + j];
  }
}

__global__ void stack8_kernel(const float* __restrict__ win,
                              const int* __restrict__ loc,
                              float* __restrict__ out, int W, int SL,
                              long long total) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long row = idx / SL;
  const int w = loc[idx % SL];
  out[idx] = (w >= 0 && w < W) ? bf16_round(win[row * W + w]) : 0.0f;
}

__global__ void onehot3d_kernel(const int4* __restrict__ loc,
                                float4* __restrict__ out, int W, int L4,
                                long long total) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int l4 = (int)(idx % L4);
  const long long rw = idx / L4;
  const int w = (int)(rw % W);
  const long long r = rw / W;
  const int4 v = loc[r * L4 + l4];
  out[idx] = make_float4(v.x == w ? 1.0f : 0.0f, v.y == w ? 1.0f : 0.0f,
                         v.z == w ? 1.0f : 0.0f, v.w == w ? 1.0f : 0.0f);
}

constexpr int kIoIn = 7, kIoOut = 16;

__global__ void io4d_kernel(const float* __restrict__ ps,
                            float* __restrict__ out, int P) {
  const float* src = ps + (long long)blockIdx.x * kIoIn * P;
  float* dst = out + (long long)blockIdx.x * kIoOut * P;
  for (int t = threadIdx.x; t < P; t += blockDim.x) {
    float p[kIoIn];
#pragma unroll
    for (int j = 0; j < kIoIn; ++j) p[j] = src[j * P + t];
    const float s = __fadd_rn(__fmul_rn(p[0], 2.0f), p[1]);
    dst[t] = s > 0.0f ? s : p[2];
#pragma unroll
    for (int j = 0; j < kIoIn; ++j) dst[(1 + j) * P + t] = p[j];
#pragma unroll
    for (int j = kIoIn + 1; j < kIoOut; ++j) dst[j * P + t] = 0.0f;
  }
}

constexpr int kBlock = 256;

unsigned blocks_for(long long total) {
  return (unsigned)((total + kBlock - 1) / kBlock);
}

}  // namespace

extern "C" {

// x, o: (out_rows, n) float32; the chain on rows [0, rows).
int vpic_probe_vpu_chain(const float* x, float* o, int rows, int n,
                         int out_rows, int reps, void* stream) {
  const long long total = (long long)out_rows * n;
  vpu_chain_kernel<<<blocks_for(total), kBlock, 0, (cudaStream_t)stream>>>(
      x, o, rows, n, total, reps);
  return (int)cudaGetLastError();
}

// win (A, W), oh (R, W, L), out (A, R, L), all float32.
int vpic_probe_gather3d(const float* win, const float* oh, float* out, int A,
                        int R, int W, int L, void* stream) {
  const int N = R * L;
  dim3 grid((N + kBN - 1) / kBN, (A + kBM - 1) / kBM);
  probe_mma_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      win, oh, out, A, N, W, W, L);
  return (int)cudaGetLastError();
}

// c (Kc, R, L), oh (R, W, L), out (Kc, W), all float32.
int vpic_probe_deposit2d(const float* c, const float* oh, float* out, int Kc,
                         int R, int W, int L, void* stream) {
  dim3 grid((W + kBN - 1) / kBN, (Kc + kBM - 1) / kBM);
  probe_mma_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      c, oh, out, Kc, W, R * L, W, L);
  return (int)cudaGetLastError();
}

// win (A, W) float32, loc (S, L) int32, out (A, S, L) float32.
int vpic_probe_stack8(const float* win, const int* loc, float* out, int A,
                      int W, int S, int L, void* stream) {
  const long long total = (long long)A * S * L;
  stack8_kernel<<<blocks_for(total), kBlock, 0, (cudaStream_t)stream>>>(
      win, loc, out, W, S * L, total);
  return (int)cudaGetLastError();
}

// loc (R, L) int32, out (R, W, L) float32; L a multiple of 4.
int vpic_probe_onehot3d(const int* loc, float* out, int R, int W, int L,
                        void* stream) {
  const long long total = (long long)R * W * (L / 4);
  onehot3d_kernel<<<blocks_for(total), kBlock, 0, (cudaStream_t)stream>>>(
      (const int4*)loc, (float4*)out, W, L / 4, total);
  return (int)cudaGetLastError();
}

// ps (B, 7, P), out (B, 16, P), float32.
int vpic_probe_io4d(const float* ps, float* out, int B, int P,
                    void* stream) {
  io4d_kernel<<<B, kBlock, 0, (cudaStream_t)stream>>>(ps, out, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
