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
// integer at scale 2^S (chosen by the wrapper so that 5*max|q| * segment
// cap * slots < 2^62) and added by 64-bit integer atomics into an
// int64 (nv, 12) scratch.  Integer addition is associative, so the sum does
// not depend on thread order; acc_unfix converts it back to float32 once.
//
// What bounds it on the H100: per particle about 36 B of state read and
// written (x, y, z, vox, ux, uy, uz, q in; the same plus mover state out),
// 72 B of interpolator gathered from L2 (the whole (nv, 18) table of a
// 128^2 2D deck is 3.7 MB and stays in the 50 MB L2), and 12 x 8 B of
// deposit atomics per segment.  On voxel-sorted input neighbouring threads
// hit the same 12 accumulator words, so the atomics are the expected hot
// spot; aggregating them within a warp before the atomic is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kOneThird = (float)(1.0 / 3.0);
constexpr float kTwoFifteenths = (float)(2.0 / 15.0);
constexpr float kBig = 3.4e38f;
constexpr int kNeighborReflect = -1;
constexpr int kExhausted = 1;

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

__device__ __forceinline__ void deposit(long long* acc_fix, int vox,
                                        const float c[12], double scale) {
  unsigned long long* a =
      reinterpret_cast<unsigned long long*>(acc_fix + 12 * (size_t)vox);
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    if (c[k] != 0.0f) {
      long long v = __double2ll_rn((double)c[k] * scale);
      atomicAdd(a + k, (unsigned long long)v);
    }
  }
}

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

// One streak segment (walk_segment + resolve_crossing, move_p.c:34-134).
__device__ __forceinline__ void segment(Lane& L, const int* neighbor,
                                        long long* acc_fix, double scale) {
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

  float sd[3], sm[3], c[12];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    sd[a] = L.r[a] * v3;
    sm[a] = L.p[a] + sd[a];
  }
  deposit12(L.q, sd, sm, c);
  deposit(acc_fix, L.vox, c, scale);

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
  const float dir_hit = sdir[stype];
  const int face = stype + (dir_hit > 0.0f ? 3 : 0);  // move_p.c:123
  const int nb = neighbor[6 * (size_t)L.vox + face];
  if (nb >= 0) {  // crossing: the coordinate flips to the opposite face
    L.p[stype] = -dir_hit;
    L.vox = nb;
  } else if (nb == kNeighborReflect) {
    L.p[stype] = dir_hit;
    L.r[stype] = -L.r[stype];
    L.u[stype] = -L.u[stype];
  } else {  // any other boundary code stops the lane on the face
    L.p[stype] = dir_hit;
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

__global__ void push_walk_kernel(PushArgs a) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= a.n) return;

  Lane L;
  L.p[0] = a.x[s];
  L.p[1] = a.y[s];
  L.p[2] = a.z[s];
  L.u[0] = a.ux[s];
  L.u[1] = a.uy[s];
  L.u[2] = a.uz[s];
  L.q = a.q[s];
  L.vox = a.vox[s];
  bool live;
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

  if (live) {
    const double scale = *a.scale;
    L.active = true;
    for (int k = 0; k < a.seg_cap && L.active; ++k)
      segment(L, a.neighbor, a.acc_fix, scale);
    if (L.active) {
      L.pcode = kExhausted;
      atomicAdd(a.counters, 1);
    } else if (L.pcode < 0) {
      atomicAdd(a.counters + 1, 1);
    }
  }

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

__global__ void acc_unfix_kernel(const long long* fix, const double* scale,
                                 const float* acc_in, float* acc_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  acc_out[i] = acc_in[i] + __double2float_rn(__ll2double_rn(fix[i]) / *scale);
}

extern "C" {

int vpic_push_args_size() { return (int)sizeof(PushArgs); }

// Launches the push (or walk_only) kernel on `stream`; returns the
// cudaError_t of the launch.
int vpic_push_walk(const PushArgs* args, void* stream) {
  const int threads = 256;
  const int blocks = (args->n + threads - 1) / threads;
  push_walk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// acc_out = acc_in + fix / scale, elementwise over n words.
int vpic_acc_unfix(const long long* fix, const double* scale,
                   const float* acc_in, float* acc_out, int n, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  acc_unfix_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      fix, scale, acc_in, acc_out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
