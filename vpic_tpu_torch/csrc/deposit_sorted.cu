// Deterministic current deposit of per-lane contributions at voxels.
// CUDA C++ for sm_90a (H100).
//
// Replaces vpic_tpu/particles/deposit_pallas.py:_kernel (launched there by
// deposit_sorted_t).  It computes what the plain version
// vpic_tpu_torch/particles/deposit.py:deposit_sorted_into computes:
//   acc_out = acc_in + sum over valid lanes s of contrib[:, s] at vox[s]
// for lanes in any order.  Voxel-sorted input is the fast case, not a
// precondition: the TPU kernel's 512-voxel block windows and its overflow
// scatter have no counterpart here, and no lane is dropped.
//
// Design: three passes over the lanes, one thread per lane.  The first
// takes max|contribution| over the valid lanes; a one-thread pass writes
// the fixed-point scale 2^S as a device double, with max|c| * n < 2^(62-S)
// so that no voxel's sum overflows an int64; the third rounds each lane's
// 12 contributions to integers at 2^S and adds them into a fixed-point
// (nv, 12) scratch through warp_deposit.cuh: the lanes of a warp with the
// same voxel sum their words and one 64-bit integer atomic per (warp,
// voxel) group and word adds the sum.  Integer addition is associative, so
// the result depends neither on lane order nor on block order: two runs
// are bitwise equal.  push_walk.cu's vpic_acc_unfix then adds the scratch
// to acc: the push kernel's fixed-point scheme, with one lane per segment.
//
// What bounds it on the H100: 48 B of contributions, 4 B of voxel and 1 B
// of valid flag per lane, and the float32 accumulator in and out: about
// 118 MB at the bench shape (2 125 824 lanes, nv = 50 700), 0.035 ms at
// 3.35 TB/s.  The max pass reads the contributions once more (about
// 102 MB, twice the 50 MB L2).  The first version summed
// each run of equal voxels serially in its head lane, a chain of up to 256
// dependent float additions per column; on an H100 80GB HBM3 at 700 W its
// three passes took 0.2044 ms at the bench shape, behind one PyTorch
// index_add_ of the same contributions (0.1856 ms; chip_smoke.py).  The
// warp deposit replaces that chain: 0.1225 ms, 0.29 of the bound.  ptxas
// (sm_90a): the warp pass 40 registers and 25 344 B of shared memory per
// 256-thread block, no spills.
//
// Floating point: built with -fmad=false; each contribution is rounded to
// its integer word once (__double2ll_rn), and the words are summed exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_deposit.cuh"

// Mirrored field for field by particles/deposit_cuda.py:_DepositArgs.
struct DepositArgs {
  const float* c[12];           // contribution columns, (n,) each
  const int* vox;               // (n,)
  const uint8_t* valid;         // (n,) lanes to deposit
  unsigned long long* fix;      // nv*12 fixed-point words, then max|c|
                                // (float bits), then out-of-range lanes
  double* scale;                // 2^S (device scalar)
  int n;
  int nv;
};

namespace {

constexpr int kChunk = 256;

__device__ __forceinline__ bool lane_voxel(const DepositArgs& a, int s,
                                           int* v) {
  *v = a.vox[s];
  return a.valid[s] != 0 && *v >= 0 && *v < a.nv;
}

__global__ void deposit_amax_kernel(DepositArgs a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  float m = 0.0f;
  int bad = 0;
  if (s < a.n) {
    int v;
    if (lane_voxel(a, s, &v)) {
#pragma unroll
      for (int k = 0; k < 12; ++k) m = fmaxf(m, fabsf(a.c[k][s]));
    } else if (a.valid[s] != 0) {
      bad = 1;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    bad += __shfl_xor_sync(0xffffffffu, bad, off);
  }
  if ((threadIdx.x & 31) == 0) {
    unsigned long long* tail = a.fix + 12 * (size_t)a.nv;
    if (m > 0.0f) atomicMax(tail, (unsigned long long)__float_as_uint(m));
    if (bad) atomicAdd(tail + 1, (unsigned long long)bad);
  }
}

// 2^S with max|c| * n < 2^(62 - S): every voxel's fixed-point sum fits an
// int64.
__global__ void deposit_scale_kernel(DepositArgs a) {
  const float m = __uint_as_float((unsigned)a.fix[12 * (size_t)a.nv]);
  const double b = (double)m * (double)a.n;
  double s = 1.0;
  if (b > 0.0 && !isinf(b)) {
    int e;
    frexp(b, &e);  // b < 2^e
    s = ldexp(1.0, 62 - e);
  }
  *a.scale = s;
}

// Blocks in reverse order: the first to run read the lanes that the max
// pass read last, some of which the L2 still holds.
__global__ void __launch_bounds__(kChunk)
deposit_warp_kernel(DepositArgs a) {
  __shared__ vpic::WarpStage stage[kChunk / 32];
  const int s = (gridDim.x - 1 - blockIdx.x) * kChunk + threadIdx.x;
  int key = -1;
  float c[12] = {};
  int v;
  if (s < a.n && lane_voxel(a, s, &v)) {
    key = v;
#pragma unroll
    for (int j = 0; j < 12; ++j) c[j] = a.c[j][s];
  }
  vpic::warp_deposit(a.fix, key, c, *a.scale, stage[threadIdx.x / 32]);
}

}  // namespace

extern "C" {

int vpic_deposit_args_size() { return (int)sizeof(DepositArgs); }

// Zeroes the scratch and launches the max, scale and deposit passes on
// `stream`, leaving the fixed-point sums in fix and 2^S in *scale for
// vpic_acc_unfix; returns the first failing cudaError_t, or 0.
int vpic_deposit_sorted(const DepositArgs* args, void* stream) {
  const DepositArgs a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      a.fix, 0, (12 * (size_t)a.nv + 2) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const int lane_blocks = (a.n + kChunk - 1) / kChunk;
  if (lane_blocks > 0) {
    deposit_amax_kernel<<<lane_blocks, kChunk, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  deposit_scale_kernel<<<1, 1, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (lane_blocks > 0) {
    deposit_warp_kernel<<<lane_blocks, kChunk, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
