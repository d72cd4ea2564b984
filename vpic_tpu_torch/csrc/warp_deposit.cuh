// The warp-aggregated fixed-point deposit shared by push_walk.cu and
// deposit_sorted.cu.  CUDA C++ for sm_90a (H100).
//
// Each lane of a warp holds 12 contributions c at voxel key (key < 0: none).
// Each lane rounds its words to integers at scale 2^S
// (__double2ll_rn(c * 2^S), zero contributions skipped); the lanes with
// equal keys (__match_any_sync) sum their words through the warp's stage in
// shared memory, and one lane per word adds the group's sum to
// acc_fix[12 * key + word] with one 64-bit integer atomic.  Integer sums do
// not depend on order or grouping (modulo 2^64, and the scale keeps every
// voxel's sum below 2^62), so acc_fix ends bit for bit as with one atomic
// per lane and word, whatever the lane order: on voxel-sorted input, where
// the lanes of a warp nearly always share a voxel, 12 atomics per warp in
// place of 12 per lane.

#pragma once

#include <cuda_runtime.h>

namespace vpic {

// One warp's stage: 12 words x 32 lanes, each row padded to 33 words so
// that the 12 summing lanes of a group read 12 different bank pairs.
typedef unsigned long long WarpStage[12][33];

// Every lane of the warp must call it (it synchronises the warp twice).
__device__ __forceinline__ void warp_deposit(unsigned long long* acc_fix,
                                             int key, const float c[12],
                                             double scale, WarpStage& stage) {
  const unsigned lane = threadIdx.x & 31u;
  const unsigned grp = __match_any_sync(0xffffffffu, key);
  const int g = __popc(grp);
  unsigned long long w[12];
#pragma unroll
  for (int k = 0; k < 12; ++k)
    w[k] = key >= 0 && c[k] != 0.0f
               ? (unsigned long long)__double2ll_rn((double)c[k] * scale)
               : 0ull;
  unsigned long long* row = acc_fix + 12 * (size_t)(key >= 0 ? key : 0);
  if (key >= 0 && g == 1) {
#pragma unroll
    for (int k = 0; k < 12; ++k)
      if (w[k]) atomicAdd(row + k, w[k]);
  } else if (key >= 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) stage[k][lane] = w[k];
  }
  __syncwarp();
  if (key >= 0 && g > 1) {
    // the group's r-th lane sums words r, r + g, r + 2g, ... of the group
    for (int k = __popc(grp & ((1u << lane) - 1u)); k < 12; k += g) {
      unsigned long long sum = 0;
      for (unsigned m = grp; m; m &= m - 1u)
        sum += stage[k][__ffs((int)m) - 1];
      if (sum) atomicAdd(row + k, sum);
    }
  }
  __syncwarp();
}

}  // namespace vpic
