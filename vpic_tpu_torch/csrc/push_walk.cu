// Particle push + streak walk + charge-conserving current deposit for one
// species, one thread per particle slot.  CUDA C++ for sm_90a (H100).
//
// Replaces vpic_tpu/particles/push_pallas.py:_kernel (launched there by
// fused_push_walk).  It computes what the plain version
// vpic_tpu_torch/particles/push.py:advance_p computes (the XLA path of the
// JAX package, advance_p.cxx:68-183 + move_p.c:20-136):
//   gather interp[vox, 0:18] -> half-E kick -> 6th-order Boris rotation ->
//   half-E kick -> relativistic half-displacement -> streak walk, each
//   segment depositing its 12 quadrant currents (with the q*sdx*sdy*sdz/3
//   correction, advance_p.cxx:137-163) at the pre-crossing voxel.
// Every crossing, periodic wraps included, resolves through
// neighbor[6*vox + face]; nothing is exported.  The walk stops at a
// segment cap equal to the XLA path's (segment 1 + 4*(n_walk-1)+8); a lane
// still moving there gets pcode PC_EXHAUSTED and is counted.  A lane
// stopped by a negative non-reflect neighbor code keeps that code.
//
// The walk_only entry skips the push and continues mid-walk lanes from a
// given remaining displacement (rx, ry, rz): the streak_walk counterpart,
// and what the TPU kernel's RESUME mode did.
//
// Floating point: built with -fmad=false and without --use_fast_math, so
// every operation is one IEEE-rounded float operation in the plain
// version's order (CUDA's default '/' and sqrtf are correctly rounded, and
// no multiply-add is contracted).  The particle state therefore equals the
// plain PyTorch version on the card bit for bit.
//
// Deterministic deposit: each contribution is rounded to a fixed-point
// integer at scale 2^S (fixed_scale_kernel, so that 5*max|q| * segment cap
// * slots < 2^62) and added by 64-bit integer atomics into an int64
// (nv, 12) scratch.  Integer addition is associative, so the sum does not
// depend on thread order; acc_unfix converts it back to float32 once and
// clears the scratch for the next call.
//
// What bounds it on the H100: per slot 32 B read (x, y, z, vox, ux, uy,
// uz, q) and 44 B written (the same seven, rx, ry, rz, pcode), plus the
// (nv, 18) interpolator, the (nv, 6) neighbor table and the float32
// accumulator in and out: about 171 MB at the bench shape (2 125 824 slots,
// nv = 50 700), 0.051 ms at 3.35 TB/s.  About 120 float operations per
// push and 110 per segment are far below the card's rate: bytes bound it.
//
// The design, against what held the first version back:
// - Contended atomics.  On voxel-sorted input (about 122 particles per
//   cell at the bench shape) the 32 lanes of a warp nearly always deposit
//   into the same 12 words, and the L2 serialises those atomics.  Here each
//   segment's deposit goes through warp_deposit.cuh: the lanes of a warp
//   with the same deposit voxel sum their integer words first, and one
//   atomic per (warp, voxel) group and word adds the sum.  Integer sums do
//   not depend on grouping, so acc is bit for bit that of one atomic per
//   lane, whatever the lane order.  On an H100 80GB HBM3 at 700 W this
//   took the kernel alone from 0.5699 to 0.1620 ms at the bench shape
//   (kernel_ab.py; PERF.md).
// - Divergent walk.  About 18 % of the lanes cross a face in a step, so
//   nearly every warp holds one and pays for a second segment.  A block
//   queue of the lanes still moving after segment 1, walked densely by the
//   block's first warps, was tried and measured slower (0.1833 ms: its
//   13 KB of shared memory and two block barriers cost more than the idle
//   lanes of the second segment), so the segment loop stays per warp.
// - Local memory.  The crossing selects its axis in an unrolled loop: a
//   run-time index into the lane's arrays put them in a 64-byte stack
//   frame (0.1613 -> 0.1547 ms alone).
// Tensor cores and TMA do not fit this kernel: it has no matrix product,
// and its streams are per-thread coalesced loads and stores of
// structure-of-arrays columns.
//
// ptxas (sm_90a, printed by chip_smoke.py): push_walk_kernel 58 registers,
// 25 344 B of shared memory per 256-thread block (the eight warps'
// stages), no stack, no spills; about 0.155 ms alone at the bench shape,
// 0.33 of the bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "warp_deposit.cuh"

namespace {

constexpr float kOneThird = (float)(1.0 / 3.0);
constexpr float kTwoFifteenths = (float)(2.0 / 15.0);
constexpr float kBig = 3.4e38f;
constexpr int kNeighborReflect = -1;
constexpr int kExhausted = 1;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// Mirrored field for field by particles/push_cuda.py:_PushArgs.
struct PushArgs {
  // inputs
  const float* x;
  const float* y;
  const float* z;
  const int* vox;
  const float* ux;
  const float* uy;
  const float* uz;
  const float* q;
  const float* rx;          // walk_only: remaining half-displacement
  const float* ry;
  const float* rz;
  const int* pcode;         // walk_only: status of each lane
  const uint8_t* active;    // walk_only: lanes to walk
  const int* np;            // push: live count (device scalar)
  const float* interp;      // (nv, 18)
  const int* neighbor;      // (nv, 6)
  const double* scale;      // fixed-point scale 2^S (device scalar)
  // outputs
  float* x_out;
  float* y_out;
  float* z_out;
  int* vox_out;
  float* ux_out;
  float* uy_out;
  float* uz_out;
  float* rx_out;            // push: pending displacement (0 if settled)
  float* ry_out;
  float* rz_out;
  int* pcode_out;
  long long* acc_fix;       // (nv, 12) fixed-point accumulator
  int* counters;            // [exhausted lanes, stopped lanes]
  // scalars
  int n;                    // slots
  int walk_only;
  int seg_cap;              // segments per lane
  float qdt_2mc;
  float cdt_dx;
  float cdt_dy;
  float cdt_dz;
};

struct Lane {
  float p[3];
  float r[3];
  float u[3];
  float q;
  int vox;
  int pcode;
  bool active;
};

// ACCUMULATE_J for the three axis permutations (advance_p.cxx:140-158).
__device__ __forceinline__ void deposit12(float q, const float sd[3],
                                          const float sm[3], float c[12]) {
  const float v5 = q * sd[0] * sd[1] * sd[2] * kOneThird;
  const int perm[3][3] = {{0, 1, 2}, {1, 2, 0}, {2, 0, 1}};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float vX = q * sd[perm[k][0]];
    const float my = sm[perm[k][1]];
    const float mz = sm[perm[k][2]];
    c[4 * k + 0] = vX * (1.0f - my) * (1.0f - mz) + v5;
    c[4 * k + 1] = vX * (1.0f + my) * (1.0f - mz) - v5;
    c[4 * k + 2] = vX * (1.0f - my) * (1.0f + mz) - v5;
    c[4 * k + 3] = vX * (1.0f + my) * (1.0f + mz) + v5;
  }
}

// One streak segment (walk_segment + resolve_crossing, move_p.c:34-134):
// its 12 contributions c, deposited at the pre-crossing voxel *dep.
__device__ __forceinline__ void segment(Lane& L, const int* neighbor,
                                        float c[12], int* dep) {
  float sdir[3], frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    sdir[a] = L.r[a] > 0.0f ? 1.0f : -1.0f;
    frac[a] = L.r[a] == 0.0f ? kBig : fmaxf((sdir[a] - L.p[a]) / L.r[a], 0.0f);
  }
  // sequential min with later-axis tie priority (move_p.c:59-62)
  float v3 = 2.0f;
  int stype = 3;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (frac[a] < v3) {
      v3 = frac[a];
      stype = a;
    }
  }
  v3 = v3 * 0.5f;

  float sd[3], sm[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    sd[a] = L.r[a] * v3;
    sm[a] = L.p[a] + sd[a];
  }
  deposit12(L.q, sd, sm, c);
  *dep = L.vox;

#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float rem_new = L.r[a] - sd[a];
    L.p[a] = L.p[a] + 2.0f * sd[a];
    L.r[a] = rem_new;
  }
  if (stype == 3) {  // the streak ends inside the voxel
    L.active = false;
    return;
  }
  // the hit axis is selected in an unrolled loop, not indexed: a
  // run-time index into L.p, L.r or L.u would put the lane in local memory
  float dir_hit = sdir[0];
#pragma unroll
  for (int a = 1; a < 3; ++a)
    if (stype == a) dir_hit = sdir[a];
  const int face = stype + (dir_hit > 0.0f ? 3 : 0);  // move_p.c:123
  const int nb = neighbor[6 * (size_t)L.vox + face];
  // crossing (nb >= 0): the coordinate flips to the opposite face; a
  // reflecting face flips displacement and momentum; any other boundary
  // code stops the lane on the face
  const bool cross = nb >= 0, reflect = nb == kNeighborReflect;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (stype != a) continue;
    L.p[a] = cross ? -dir_hit : dir_hit;
    if (reflect) {
      L.r[a] = -L.r[a];
      L.u[a] = -L.u[a];
    }
  }
  if (cross) {
    L.vox = nb;
  } else if (!reflect) {
    L.pcode = nb;
    L.active = false;
  }
}

// Boris push and normalized half-displacement (advance_p.cxx:74-116).
__device__ __forceinline__ void push(Lane& L, const float* ip,
                                     const PushArgs& a) {
  const float dx = L.p[0], dy = L.p[1], dz = L.p[2];
  const float ex = (ip[0] + dy * ip[1]) + dz * (ip[2] + dy * ip[3]);
  const float ey = (ip[4] + dz * ip[5]) + dx * (ip[6] + dz * ip[7]);
  const float ez = (ip[8] + dx * ip[9]) + dy * (ip[10] + dx * ip[11]);
  const float cbx = ip[12] + dx * ip[13];
  const float cby = ip[14] + dy * ip[15];
  const float cbz = ip[16] + dz * ip[17];
  const float hax = a.qdt_2mc * ex, hay = a.qdt_2mc * ey,
              haz = a.qdt_2mc * ez;
  float ux = L.u[0] + hax;
  float uy = L.u[1] + hay;
  float uz = L.u[2] + haz;
  float v0 = a.qdt_2mc / sqrtf(1.0f + (ux * ux + (uy * uy + uz * uz)));
  const float v1 = cbx * cbx + (cby * cby + cbz * cbz);
  const float v2 = (v0 * v0) * v1;
  const float v3 = v0 * (1.0f + v2 * (kOneThird + v2 * kTwoFifteenths));
  float v4 = v3 / (1.0f + v1 * (v3 * v3));
  v4 = v4 + v4;
  const float w0 = ux + v3 * (uy * cbz - uz * cby);
  const float w1 = uy + v3 * (uz * cbx - ux * cbz);
  const float w2 = uz + v3 * (ux * cby - uy * cbx);
  ux = ux + v4 * (w1 * cbz - w2 * cby);
  uy = uy + v4 * (w2 * cbx - w0 * cbz);
  uz = uz + v4 * (w0 * cby - w1 * cbx);
  ux = ux + hax;
  uy = uy + hay;
  uz = uz + haz;
  v0 = 1.0f / sqrtf(1.0f + (ux * ux + (uy * uy + uz * uz)));
  L.u[0] = ux;
  L.u[1] = uy;
  L.u[2] = uz;
  L.r[0] = (ux * a.cdt_dx) * v0;
  L.r[1] = (uy * a.cdt_dy) * v0;
  L.r[2] = (uz * a.cdt_dz) * v0;
}

namespace {

__device__ __forceinline__ void write_lane(const PushArgs& a, int s,
                                           const Lane& L) {
  a.x_out[s] = L.p[0];
  a.y_out[s] = L.p[1];
  a.z_out[s] = L.p[2];
  a.vox_out[s] = L.vox;
  a.ux_out[s] = L.u[0];
  a.uy_out[s] = L.u[1];
  a.uz_out[s] = L.u[2];
  a.pcode_out[s] = L.pcode;
  // push: pending displacement of unfinished movers, 0 otherwise;
  // walk_only: the remaining displacement as it stands
  const bool keep_rem = a.walk_only || L.pcode != 0;
  a.rx_out[s] = keep_rem ? L.r[0] : 0.0f;
  a.ry_out[s] = keep_rem ? L.r[1] : 0.0f;
  a.rz_out[s] = keep_rem ? L.r[2] : 0.0f;
}

// Counts a walked lane that ends still moving (exhausted) or stopped by a
// boundary code, one atomic per warp and counter.
__device__ __forceinline__ void count_pending(Lane& L, bool walked,
                                             int* counters) {
  const bool exhausted = walked && L.active;
  if (exhausted) L.pcode = kExhausted;
  const unsigned ex = __ballot_sync(kFull, exhausted);
  const unsigned st = __ballot_sync(kFull, walked && !exhausted &&
                                               L.pcode < 0);
  if ((threadIdx.x & 31u) == 0) {
    if (ex) atomicAdd(counters, __popc(ex));
    if (st) atomicAdd(counters + 1, __popc(st));
  }
}

// One thread per slot: load, push (unless walk_only), then walk segment by
// segment while any lane of the warp still moves; every lane takes part in
// each segment's warp deposit.
__global__ void __launch_bounds__(kThreads)
push_walk_kernel(PushArgs a) {
  __shared__ vpic::WarpStage stage[kThreads / 32];
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const bool in = s < a.n;

  Lane L;
  bool live = false;
  if (in) {
    L.p[0] = a.x[s];
    L.p[1] = a.y[s];
    L.p[2] = a.z[s];
    L.u[0] = a.ux[s];
    L.u[1] = a.uy[s];
    L.u[2] = a.uz[s];
    L.q = a.q[s];
    L.vox = a.vox[s];
    if (a.walk_only) {
      live = a.active[s] != 0;
      L.r[0] = a.rx[s];
      L.r[1] = a.ry[s];
      L.r[2] = a.rz[s];
      L.pcode = a.pcode[s];
    } else {
      live = s < *a.np && L.vox >= 0;
      L.r[0] = L.r[1] = L.r[2] = 0.0f;
      L.pcode = 0;
      if (live) push(L, a.interp + 18 * (size_t)L.vox, a);
    }
  }
  const double scale = *a.scale;
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(a.acc_fix);
  L.active = live;
  for (int k = 0; k < a.seg_cap; ++k) {
    if (!__any_sync(kFull, L.active)) break;
    float c[12] = {};
    int dep = -1;
    if (L.active) segment(L, a.neighbor, c, &dep);
    vpic::warp_deposit(acc, dep, c, scale, stage[threadIdx.x / 32]);
  }
  count_pending(L, live, a.counters);
  if (in) write_lane(a, s, L);
}

// 2^S as a device double, S = floor(62 - log2(5 * max|q| * seg_cap * n))
// clamped to [-200, 200]: the double operations of the plain version
// particles/deposit.py:fixed_scale, so S is the same.  Each block reduces
// max|q| over its strided slots into work[0] (float bits order
// non-negative floats); the last block to finish (ticket work[1]) writes
// 2^S and clears work[0..3], the lane counters work[2..3] included, for
// the push that follows on the stream.
__global__ void __launch_bounds__(kThreads)
fixed_scale_kernel(const float* q, int n, double cap_n, unsigned* work,
                   double* scale) {
  __shared__ float warp_max[kThreads / 32];
  float m = 0.0f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    m = fmaxf(m, fabsf(q[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if ((threadIdx.x & 31u) == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
  atomicMax(work, __float_as_uint(m));
  __threadfence();
  if (atomicAdd(work + 1, 1u) != gridDim.x - 1) return;
  const float qmax = __uint_as_float(atomicExch(work, 0u));
  work[1] = work[2] = work[3] = 0u;
  const double s = floor(62.0 - log2(5.0 * (double)qmax * cap_n));
  *scale = exp2(fmin(fmax(s, -200.0), 200.0));
}

// acc_out = acc_in + fix / scale; each fix word is cleared once read.
__global__ void acc_unfix_kernel(long long* fix, const double* scale,
                                 const float* acc_in, float* acc_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  acc_out[i] = acc_in[i] + __double2float_rn(__ll2double_rn(fix[i]) / *scale);
  fix[i] = 0;
}

}  // namespace

extern "C" {

int vpic_push_args_size() { return (int)sizeof(PushArgs); }

// Writes 2^S for the push of n slots of charge q with seg_cap segments
// each to *scale and clears the lane counters work[2..3]; work[0..3] must
// be zero at the call, and are again after it.  Returns the cudaError_t of
// the launch.
int vpic_fixed_scale(const float* q, int n, int seg_cap, unsigned* work,
                     double* scale, void* stream) {
  const int blocks =
      std::max(std::min((n + kThreads - 1) / kThreads, 1024), 1);
  cudaStream_t st = (cudaStream_t)stream;
  fixed_scale_kernel<<<blocks, kThreads, 0, st>>>(
      q, n, (double)seg_cap * (double)n, work, scale);
  return (int)cudaGetLastError();
}

// Launches the push (or walk_only) kernel on `stream`; returns the
// cudaError_t of the launch.
int vpic_push_walk(const PushArgs* args, void* stream) {
  const int blocks = (args->n + kThreads - 1) / kThreads;
  push_walk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// acc_out = acc_in + fix / scale, elementwise over n words, leaving fix
// zero.
int vpic_acc_unfix(long long* fix, const double* scale, const float* acc_in,
                   float* acc_out, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t st = (cudaStream_t)stream;
  acc_unfix_kernel<<<blocks, kThreads, 0, st>>>(fix, scale, acc_in, acc_out,
                                                 n);
  return (int)cudaGetLastError();
}

}  // extern "C"
