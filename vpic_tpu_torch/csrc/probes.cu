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
//   operations per element and rep (multiply, add, compare, subtract,
//   select); 2^17 elements x 1024 reps x 5 = 6.7e8, 0.0100 ms at the
//   published 67 TFLOP/s, which counts an FFMA as two.  Each step is
//   rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, -fmad=false), so
//   the chain has no FFMA and is bound by issue: 128 lane-instructions per
//   SM and clock, 3.35e13 per second on 132 SMs at 1.98 GHz.  Design: the
//   instructions per rep are the lever.  The conditional subtract is
//   acc - set.gt(acc, 2), set.gt giving 1.0f or 0.0f (acc - 0 is acc, -0
//   included), so a rep is a multiply, an add, a compare and an add (the
//   compare and a predicated add measured slower at the same count); the
//   rep loop is unrolled kChainUnroll times, with a remainder loop for any
//   reps.  What is left is latency: each rep is four dependent
//   instructions, so a thread runs two independent chains, on floats g
//   and g + ceil(window/2) of the window, the block's first rows*n floats
//   (row-major): 256 blocks of 256 at the tool's shapes.  The zero floats
//   after the window are written by the same threads before their chains,
//   16 bytes per store with a scalar head and tail: blocks of their own
//   for the zeros, in the same grid, left the chain's blocks unevenly
//   spread over the SMs (rows 1 took 1.39x its window alone on an H100
//   80GB HBM3 at 700 W, kernel_ab.py --probes).
//   The plan, vpu_layout_probe.py:chain_plan, is tested on the CPU and
//   checked by the launcher.  The TPU's question, whether a (1, n) row
//   wastes 7 of 8 sublanes, has no counterpart: a warp takes 32
//   consecutive elements of any row.
//
// vpic_probe_gather3d    replaces tools/probe_batched.py:probe_gather3d
//   (its pallas_call at :60), out[a,r,l] = sum_w bf16(win[a,w]) *
//   bf16(oh[r,w,l]) in float32;
// vpic_probe_deposit2d   replaces tools/probe_batched.py:probe_deposit2d
//   (its pallas_call at :80), out[k,w] = sum_{r,l} bf16(c[k,r,l]) *
//   bf16(oh[r,w,l]) in float32.
//   Both are one product C = A B on the tensor cores, which is what the
//   probes ask of the TPU's matrix unit: gather3d A = win (M = A, K = W),
//   B[w, r*L + l] = oh[r,w,l]; deposit2d A = c (M = K_c, K = R*L),
//   B[r*L + l, w] = oh[r,w,l]. Each operand is rounded to bf16 with
//   __float2bfloat16_rn (round to nearest even, as JAX's astype and
//   torch's .to(torch.bfloat16)).
//   Bound: bytes (oh's 2 MB in float32 dominates; the tools' shapes move
//   2.29 and 2.17 MB, 0.68 and 0.65 us at 3.35 TB/s; 33.5 MFLOP of bf16
//   products is 0.03 us at 989 TFLOP/s). At these sizes what holds a
//   kernel back is latency and too few blocks, not the card's rates.
//   Design (the plan, tools/mma_plan.py, is tested on the CPU; the
//   launchers refuse a plan off this file's constants): a block
//   computes all rows of C for a tile of columns over one split of the
//   depth, so oh is read once, by 128 blocks at the tools' shapes
//   (gather3d: l tile x r x w split = 2 x 8 x 8; deposit2d: w tile x r =
//   16 x 8). Its slabs of A and oh come in asynchronous bulk copies
//   (cp.async.bulk) on one mbarrier, which expects their bytes before the
//   first is issued; the block's threads issue one copy each, so all are
//   in flight before any thread waits: deposit2d's oh[r, w0:w0+32, :] is
//   one contiguous 16 KB run, gather3d's 64 runs of 256 B (issued from
//   one warp, or as 16-byte cp.async, gather3d measured slower). One
//   round trip of device memory per block, where the wmma kernels before
//   made one per 64-deep step. mma.sync m16n8k16 bf16 reads the float32
//   slabs and rounds each operand to bf16 in registers; the depth is
//   summed 16 at a time in order.
//   The splits of one column tile are one thread block cluster (at most
//   8, the portable size): each block keeps its float32 partial in its
//   shared memory, and after the cluster barrier block q reads its eighth
//   of the tile from the partials of blocks 0..7 through distributed
//   shared memory (all eight reads in flight), sums them in that order
//   and writes C. No float atomics, no scratch in device memory, one
//   launch, and the same sum order on every run. Rows, columns and depth
//   past the operands are zeros in shared memory only.
//   Not wgmma: it takes 64-row tiles, and C has 12 or 32 rows, so it
//   would need the operands swapped, and it buys nothing on 0.03 us of
//   products.
//
// vpic_probe_stack8      replaces tools/probe_batched.py:probe_stack8,
//   out[a,s,l] = bf16(win[a, loc[s,l]]) in float32, 0 where loc lies
//   outside [0, W).  The TPU builds eight one-hot matrices and multiplies,
//   because it lacks a gather; here it is a gather.  Bound: bytes (win, loc
//   and out: 0.20 MB at the tool's shape, 0.06 us), far under a launch and
//   one round trip of device memory, so the design counts round trips: a
//   block of 64 threads takes 256 consecutive (s, l) of one row a (128
//   blocks at the tool's shape), and its first thread copies the row
//   win[a, :] into shared memory in one bulk copy on an mbarrier before
//   the threads load their four loc entries, so that the two reads
//   overlap; after the wait each thread gathers from shared memory and
//   makes one 16-byte store.  Where the row is off 16 bytes, W is not a
//   multiple of 4 or the row passes 48 KB, the threads read win directly
//   (a second round trip); where S*L is not a multiple of 4 or loc is off
//   16 bytes, each thread takes four single floats, 64 apart (the plan,
//   probe_batched.py:stack8_plan, checked by the launcher).  All index
//   arithmetic in 32 bits: the plan refuses 2^31 elements.
//
// vpic_probe_onehot3d    replaces tools/probe_batched.py:probe_onehot3d,
//   out[r,w,l] = float(loc[r,l] == w).  Bound: bytes, the 2 MB it writes
//   (0.63 us).  Design: thread (r, phase, c) loads loc[r, 4c:4c+4] once
//   into registers and writes rows w = phase, phase + P, ... (P = ceil(W /
//   4): four rows a thread) of its column with 16-byte stores (plain
//   stores measured 1 % faster than streaming ones, __stcs);
//   consecutive threads take consecutive c, then phases, so that a warp
//   stores a contiguous 512-byte row segment and a block of 256 threads
//   eight consecutive rows (128 blocks at the tool's shape).  Where L is
//   not a multiple of 4 or loc or out is off 16 bytes, a column is one l
//   and the accesses 4 bytes (the plan, probe_batched.py:onehot3d_plan,
//   checked by the launcher: no input makes a misaligned access).  All
//   index arithmetic in 32 bits: the plan refuses 2^31 elements.
//
// vpic_probe_io4d        replaces tools/probe_batched.py:probe_io4d, per
//   block i: a = 2*ps[i,0] + ps[i,1]; out[i,0] = a > 0 ? a : ps[i,2];
//   out[i,1:8] = ps[i,0:7]; out[i,8:16] = 0.  Bound: bytes (0.38 MB,
//   0.11 us).  Design: one thread per 16 bytes of one output plane (i, j,
//   4 columns), 128 blocks of 128 at the tool's shape, so that every
//   thread makes one round trip of device memory: plane 0 reads three
//   float4 of ps[i, 0..2] and stores the head, planes 1-7 copy one
//   float4, planes 8-15 store a zero float4.  Where R*L is not a multiple
//   of 4 or ps does not start on 16 bytes, the same kernel moves one float
//   per thread (the plan, probe_batched.py:io4d_plan, checked by the
//   launcher).  2*x is exact, so the result does not depend on
//   contraction.  A launch and one round trip cost more than the 0.11 us
//   bound whatever the design.
//
// All six are launch-bound at the tools' shapes: each moves at most
// 2.3 MB, under a microsecond of the card's memory rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The chain: kChainBlock threads a block, kChainUnroll reps a turn.
constexpr int kChainBlock = 256, kChainUnroll = 16;

// vpu_layout_probe.py:chain_plan: blocks of kChainBlock threads; thread g
// takes floats g and g + pairs of the window (its first window floats,
// pairs = ceil(window / 2)) through the chain.  Before that every thread
// of the grid writes its share of the zeros after the window: float g
// (g < head), float4 g, g + T, ... (< vec4) from the first 16-byte
// boundary after those, T the grid's threads, and float g (g < tail)
// after the float4.
struct ChainPlan {
  int window, pairs, blocks, head, vec4, tail;
};

// One rep, each operation rounded on its own.
__device__ __forceinline__ float chain_rep(float acc) {
  acc = __fadd_rn(__fmul_rn(acc, 1.0000001f), 1.0f);
  float over;   // 1.0f where acc > 2, else 0.0f
  asm("set.gt.f32.f32 %0, %1, %2;" : "=f"(over) : "f"(acc), "f"(2.0f));
  return __fsub_rn(acc, over);
}

__global__ void __launch_bounds__(kChainBlock)
    vpu_chain_kernel(const float* __restrict__ x, float* __restrict__ o,
                     ChainPlan p, int reps) {
  const int g = blockIdx.x * kChainBlock + threadIdx.x;
  float* z = o + p.window;
  float4* z4 = reinterpret_cast<float4*>(z + p.head);
  for (int t = g; t < p.vec4; t += p.blocks * kChainBlock)
    z4[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g < p.head) z[g] = 0.0f;
  if (g < p.tail) z[p.head + 4 * p.vec4 + g] = 0.0f;
  if (g >= p.pairs) return;
  const int j = g + p.pairs;
  const bool second = j < p.window;
  float a = x[g], b = second ? x[j] : 0.0f;
  int k = 0;
  for (; k + kChainUnroll <= reps; k += kChainUnroll) {
#pragma unroll
    for (int u = 0; u < kChainUnroll; ++u) {
      a = chain_rep(a);
      b = chain_rep(b);
    }
  }
  for (; k < reps; ++k) {
    a = chain_rep(a);
    b = chain_rep(b);
  }
  o[g] = a;
  if (second) o[j] = b;
}

// gather3d and deposit2d: the plan's integers (tools/mma_plan.py,
// MmaPlan.args, checked by check_plan at launch), a block of four warps,
// 16-row tiles of C, mma.sync m16n8k16 bf16 with float32 accumulation.
constexpr int kMmaThreads = 128;
constexpr int kGatherBN = 64, kDepositBN = 32;
constexpr int kMaxCluster = 8;   // the portable cluster size

struct MmaPlan {
  int M, R, W, L;            // rows of C, and oh's (R, W, L)
  int mt, depth, lda, ldb;   // 16-row tiles, a split's depth, slab strides
  int a_off, b_off, p_off;   // bytes into the block's shared memory
  int chunk;                 // tile elements one rank of a cluster sums
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One mbarrier per block takes every copy of the block: one arrival (the
// thread that sets the expected bytes) and the copies' bytes.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect_bytes(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)) : "memory");
  }
}

// floats * 4 bytes from global to shared memory, reported to bar
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int floats, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(floats * 4),
                  "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// The block's partial P (mt*16 x kBN) = A B over the split's depth, each
// operand rounded to bf16 as it leaves shared memory.  A[m][k] at
// As[m*lda + k]; B[k][n] at Bs[n*ldb + k] for deposit2d (oh's l is
// contiguous) and at Bs[k*ldb + n] for gather3d.  Warp w takes the
// m16n8 tiles w, w + 4, ...; each sums the depth 16 at a time in order.
template <bool kDeposit>
__device__ __forceinline__ void block_products(const MmaPlan& p,
                                               const float* As,
                                               const float* Bs, float* Ps) {
  constexpr int kBN = kDeposit ? kDepositBN : kGatherBN, kNT = kBN / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int tile = threadIdx.x / 32; tile < p.mt * kNT;
       tile += kMmaThreads / 32) {
    const int m0 = tile / kNT * 16, n0 = tile % kNT * 8;
    const float* a_lo = As + (m0 + g) * p.lda + 2 * t;
    const float* a_hi = a_lo + 8 * p.lda;
    const float* b = kDeposit ? Bs + (n0 + g) * p.ldb + 2 * t
                              : Bs + 2 * t * p.ldb + n0 + g;
    const int bk = kDeposit ? 1 : p.ldb;   // B's stride along the depth
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < p.depth; k0 += 16) {
      const uint32_t a[4] = {bf16x2(a_lo[k0], a_lo[k0 + 1]),
                             bf16x2(a_hi[k0], a_hi[k0 + 1]),
                             bf16x2(a_lo[k0 + 8], a_lo[k0 + 9]),
                             bf16x2(a_hi[k0 + 8], a_hi[k0 + 9])};
      const float* bb = b + k0 * bk;
      mma_bf16(d, a, bf16x2(bb[0], bb[bk]), bf16x2(bb[8 * bk], bb[9 * bk]));
    }
    float* c = Ps + (m0 + g) * kBN + n0 + 2 * t;
    c[0] = d[0];
    c[1] = d[1];
    c[8 * kBN] = d[2];
    c[8 * kBN + 1] = d[3];
  }
}

// The split-K sum: after the cluster barrier, the block of rank q sums
// its share [q*chunk, (q+1)*chunk) of the tile over the partials of ranks
// 0, 1, ..., S-1 in that order (distributed shared memory) and stores
// rows < M, columns < ncols at out[i*ld_row + j]; the second barrier
// keeps every partial alive until the last rank has read it.
template <int kBN>
__device__ __forceinline__ void cluster_sum(const MmaPlan& p, float* Ps,
                                            float* out, long long ld_row,
                                            int ncols) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int splits = (int)cluster.num_blocks(), rank = cluster.block_rank();
  const int end = min(p.mt * 16 * kBN, (rank + 1) * p.chunk);
  for (int e = rank * p.chunk + threadIdx.x; e < end; e += kMmaThreads) {
    float v[kMaxCluster];   // every read in flight before the first add
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      v[q] = q < splits ? *cluster.map_shared_rank(Ps + e, q) : 0.0f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < splits) s += v[q];
    const int i = e / kBN, j = e % kBN;
    if (i < p.M && j < ncols) out[i * ld_row + j] = s;
  }
  cluster.sync();
}

struct MmaSmem {
  uint64_t* bar;
  float *As, *Bs, *Ps;
};

// The block's shared memory; its mbarrier expects ``bytes`` before any
// copy is issued.
__device__ __forceinline__ MmaSmem mma_smem(const MmaPlan& p,
                                            uint32_t bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  MmaSmem s;
  s.bar = reinterpret_cast<uint64_t*>(smem);
  s.As = reinterpret_cast<float*>(smem + p.a_off);
  s.Bs = reinterpret_cast<float*>(smem + p.b_off);
  s.Ps = reinterpret_cast<float*>(smem + p.p_off);
  if (threadIdx.x == 0) {
    bar_init(s.bar);
    bar_expect_bytes(s.bar, bytes);
  }
  __syncthreads();
  return s;
}

// Rows [m, mt*16) of the A slab, over the depth, are zero.
__device__ __forceinline__ void clear_rows_past_m(const MmaPlan& p,
                                                  float* As) {
  for (int i = p.M + threadIdx.x / 32; i < p.mt * 16; i += kMmaThreads / 32)
    for (int k = threadIdx.x % 32; k < p.depth; k += 32)
      As[i * p.lda + k] = 0.0f;
}

// Block (l tile, r, w split): C[a, r*L + l0 + j] over w in [w0, w0 + dw).
__global__ void __launch_bounds__(kMmaThreads)
    gather3d_kernel(const float* __restrict__ win,
                    const float* __restrict__ oh, float* __restrict__ out,
                    MmaPlan p) {
  const int l0 = blockIdx.x * kGatherBN, r = blockIdx.y;
  const int w0 = blockIdx.z * p.depth;
  const int nl = min(kGatherBN, p.L - l0), dw = min(p.depth, p.W - w0);
  const MmaSmem s = mma_smem(p, (uint32_t)((p.M + nl) * dw * 4));
  // every copy of the block is issued before any thread waits
  const float* ohr = oh + ((long long)r * p.W + w0) * p.L + l0;
  for (int i = threadIdx.x; i < p.M + dw; i += kMmaThreads) {
    if (i < p.M)
      bulk_copy(s.As + i * p.lda, win + (long long)i * p.W + w0, dw, s.bar);
    else
      bulk_copy(s.Bs + (i - p.M) * p.ldb, ohr + (long long)(i - p.M) * p.L,
                nl, s.bar);
  }
  // what the products read and no copy writes: zeros
  for (int i = threadIdx.x / 32; i < p.M; i += kMmaThreads / 32)
    for (int k = dw + threadIdx.x % 32; k < p.depth; k += 32)
      s.As[i * p.lda + k] = 0.0f;
  clear_rows_past_m(p, s.As);
  for (int k = threadIdx.x / 32; k < p.depth; k += kMmaThreads / 32)
    for (int j = (k < dw ? nl : 0) + threadIdx.x % 32; j < kGatherBN; j += 32)
      s.Bs[k * p.ldb + j] = 0.0f;
  __syncthreads();
  bar_wait(s.bar);
  block_products<false>(p, s.As, s.Bs, s.Ps);
  cluster_sum<kGatherBN>(p, s.Ps, out + (long long)r * p.L + l0,
                         (long long)p.R * p.L, nl);
}

// Block (w tile, 0, r): C[k, w0 + j] over (r, l), l in [0, L).
__global__ void __launch_bounds__(kMmaThreads)
    deposit2d_kernel(const float* __restrict__ c,
                     const float* __restrict__ oh, float* __restrict__ out,
                     MmaPlan p) {
  const int w0 = blockIdx.x * kDepositBN, r = blockIdx.z;
  const int nw = min(kDepositBN, p.W - w0);
  const MmaSmem s = mma_smem(p, (uint32_t)((nw + p.M) * p.L * 4));
  // oh[r, w0:w0+nw, :] is one contiguous run, copied by the last thread
  if (threadIdx.x == kMmaThreads - 1)
    bulk_copy(s.Bs, oh + ((long long)r * p.W + w0) * p.L, nw * p.L, s.bar);
  if (threadIdx.x < p.M)
    bulk_copy(s.As + threadIdx.x * p.lda,
              c + ((long long)threadIdx.x * p.R + r) * p.L, p.L, s.bar);
  clear_rows_past_m(p, s.As);
  for (int j = nw + threadIdx.x / 32; j < kDepositBN; j += kMmaThreads / 32)
    for (int k = threadIdx.x % 32; k < p.L; k += 32) s.Bs[j * p.ldb + k] = 0.0f;
  __syncthreads();
  bar_wait(s.bar);
  block_products<true>(p, s.As, s.Bs, s.Ps);
  cluster_sum<kDepositBN>(p, s.Ps, out + w0, p.W, nw);
}

// The plan's integers against what the kernels were built for: a plan
// that drifts from this file's constants is refused at launch.
bool check_plan(const MmaPlan& p, bool deposit, int gx, int gy, int gz,
                int bn, int smem) {
  const int tile = p.mt * 16 * bn;
  bool ok = bn == (deposit ? kDepositBN : kGatherBN) && gz >= 1 &&
            gz <= kMaxCluster && p.mt == (p.M + 15) / 16 && p.mt <= 2 &&
            p.chunk == (tile + gz - 1) / gz && p.depth % 16 == 0 &&
            p.lda >= p.depth && p.a_off >= 16 &&
            p.b_off >= p.a_off + p.mt * 16 * p.lda * 4 &&
            p.p_off + tile * 4 <= smem && gx == (deposit ? (p.W + bn - 1) / bn
                                                         : (p.L + bn - 1) / bn);
  if (deposit)
    ok = ok && gy == 1 && gz == p.R && p.depth == p.L && p.ldb >= p.L &&
         p.p_off >= p.b_off + bn * p.ldb * 4;
  else
    ok = ok && gy == p.R && (long long)gz * p.depth >= p.W &&
         p.ldb >= bn && p.p_off >= p.b_off + p.depth * p.ldb * 4;
  return ok;
}

// One launch of a cluster of grid.z blocks along z.
template <typename Kernel>
int launch_clusters(Kernel kernel, const float* a, const float* oh,
                    float* out, const MmaPlan& p, int gx, int gy, int gz,
                    int smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, gz);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = gz;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a, oh, out, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// stack8: blocks of kStackThreads threads, kStackPerThread outputs each;
// the row staged in shared memory after a 16-byte slot for the mbarrier.
constexpr int kStackThreads = 64, kStackPerThread = 4;
constexpr int kStackPerBlock = kStackThreads * kStackPerThread;
constexpr int kStackSmemMax = 48 * 1024, kStackRowOff = 16;

__device__ __forceinline__ float stack8_value(const float* row, int W,
                                              int w) {
  return (unsigned)w < (unsigned)W ? bf16_round(row[w]) : 0.0f;
}

// probe_batched.py:stack8_plan: block b takes outputs [c*kStackPerBlock,
// (c+1)*kStackPerBlock) of row a = b / chunks of out (A, S*L), c = b %
// chunks; thread t the four at 4t (kWidth 4) or t + 64k (kWidth 1) of
// them.  kStage: the row comes through shared memory.
template <bool kStage, int kWidth>
__global__ void __launch_bounds__(kStackThreads)
    stack8_kernel(const float* __restrict__ win, const int* __restrict__ loc,
                  float* __restrict__ out, int W, int SL, int chunks) {
  extern __shared__ __align__(16) unsigned char stack_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(stack_smem);
  float* staged = reinterpret_cast<float*>(stack_smem + kStackRowOff);
  const int a = blockIdx.x / chunks;
  const int j0 = (blockIdx.x - a * chunks) * kStackPerBlock;
  const float* row = win + a * W;
  if (kStage && threadIdx.x == 0) {
    bar_init(bar);
    bar_expect_bytes(bar, (uint32_t)W * 4);
    bulk_copy(staged, row, W, bar);
  }
  // the loc entries are read while the row is in flight
  int w[kStackPerThread];
  int j[kStackPerThread];
#pragma unroll
  for (int k = 0; k < kStackPerThread; ++k)
    j[k] = kWidth == 4 ? j0 + 4 * threadIdx.x + k
                       : j0 + threadIdx.x + k * kStackThreads;
  if (kWidth == 4) {
    if (j[0] < SL) {
      const int4 v = *reinterpret_cast<const int4*>(loc + j[0]);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kStackPerThread; ++k)
      if (j[k] < SL) w[k] = loc[j[k]];
  }
  if (kStage) {
    __syncthreads();   // the mbarrier is initialised
    bar_wait(bar);
    row = staged;
  }
  float* o = out + a * SL;
  if (kWidth == 4) {
    if (j[0] < SL)
      *reinterpret_cast<float4*>(o + j[0]) = make_float4(
          stack8_value(row, W, w[0]), stack8_value(row, W, w[1]),
          stack8_value(row, W, w[2]), stack8_value(row, W, w[3]));
  } else {
#pragma unroll
    for (int k = 0; k < kStackPerThread; ++k)
      if (j[k] < SL) o[j[k]] = stack8_value(row, W, w[k]);
  }
}

// onehot3d: blocks of kOnehotBlock threads, kOnehotRows rows a thread.
constexpr int kOnehotBlock = 256, kOnehotRows = 4;

__device__ __forceinline__ float one_hot(int v, int w) {
  return v == w ? 1.0f : 0.0f;
}

__device__ __forceinline__ float4 one_hot(int4 v, int w) {
  return make_float4(one_hot(v.x, w), one_hot(v.y, w), one_hot(v.z, w),
                     one_hot(v.w, w));
}

// probe_batched.py:onehot3d_plan: thread g is column c = g % cols (l in
// [c*kWidth, (c+1)*kWidth)), phase g / cols % phases of row r = g / cols /
// phases; it writes out[r, w, column] for w = phase + k*phases < W, k <
// kOnehotRows.  I and V are int4 and float4 (kWidth 4) or int and float.
template <typename I, typename V>
__global__ void __launch_bounds__(kOnehotBlock)
    onehot3d_kernel(const I* __restrict__ loc, V* __restrict__ out, int W,
                    int cols, int phases, int total) {
  const int g = blockIdx.x * kOnehotBlock + threadIdx.x;
  if (g >= total) return;
  const int q = g / cols, c = g - q * cols;
  const int r = q / phases, phase = q - r * phases;
  const I v = loc[r * cols + c];
  V* o = out + (r * W + phase) * cols + c;
  const int step = phases * cols;
#pragma unroll
  for (int k = 0, w = phase; k < kOnehotRows; ++k, w += phases, o += step)
    if (w < W) *o = one_hot(v, w);
}

constexpr int kIoIn = 7, kIoOut = 16, kIoBlock = 128;

__device__ __forceinline__ float io_head(float p0, float p1, float p2) {
  const float a = __fadd_rn(__fmul_rn(p0, 2.0f), p1);
  return a > 0.0f ? a : p2;
}

__device__ __forceinline__ float4 io_head(float4 p0, float4 p1, float4 p2) {
  return make_float4(io_head(p0.x, p1.x, p2.x), io_head(p0.y, p1.y, p2.y),
                     io_head(p0.z, p1.z, p2.z), io_head(p0.w, p1.w, p2.w));
}

// One thread per V (float4 or float) of one output plane: thread t is
// column t % cols of plane j = t / cols % 16 of block i = t / cols / 16,
// cols = P / (floats in V).
template <typename V>
__global__ void __launch_bounds__(kIoBlock)
    io4d_kernel(const V* __restrict__ ps, V* __restrict__ out, int B,
                int cols) {
  const int t = blockIdx.x * kIoBlock + threadIdx.x;
  if (t >= B * kIoOut * cols) return;
  const int col = t % cols, ij = t / cols, j = ij % kIoOut, i = ij / kIoOut;
  const V* src = ps + (long long)i * kIoIn * cols + col;
  V* dst = out + (long long)ij * cols + col;
  if (j == 0)
    *dst = io_head(src[0], src[cols], src[2 * cols]);
  else if (j <= kIoIn)
    *dst = src[(j - 1) * cols];
  else
    *dst = V{};
}

}  // namespace

extern "C" {

// x, o: (out_rows, n) float32, o on a 16-byte boundary; the chain on rows
// [0, rows); the plan of tools/vpu_layout_probe.py:chain_plan, refused
// (cudaErrorInvalidValue) unless it covers the block exactly once.
int vpic_probe_vpu_chain(const float* x, float* o, int rows, int n,
                         int out_rows, int reps, int window, int pairs,
                         int blocks, int head, int vec4, int tail,
                         void* stream) {
  const ChainPlan p = {window, pairs, blocks, head, vec4, tail};
  const long long zeros = (long long)(out_rows - rows) * n;
  const bool ok =
      rows >= 1 && rows <= out_rows && reps >= 0 &&
      (long long)window == (long long)rows * n &&
      pairs == window / 2 + window % 2 &&
      blocks == (pairs + kChainBlock - 1) / kChainBlock && head >= 0 &&
      head < 4 && tail >= 0 && tail < 4 && vec4 >= 0 &&
      head + 4LL * vec4 + tail == zeros &&
      (vec4 == 0 || (reinterpret_cast<uintptr_t>(o + window + head) & 15) ==
                        0);
  if (!ok) return (int)cudaErrorInvalidValue;
  vpu_chain_kernel<<<blocks, kChainBlock, 0, (cudaStream_t)stream>>>(
      x, o, p, reps);
  return (int)cudaGetLastError();
}

// win (A, W), oh (R, W, L), out (A, R, L), all float32, 16-byte aligned;
// the plan of tools/mma_plan.py:gather3d_plan.
int vpic_probe_gather3d(const float* win, const float* oh, float* out, int A,
                        int R, int W, int L, int gx, int gy, int gz, int bn,
                        int mt, int depth, int lda, int ldb, int a_off,
                        int b_off, int p_off, int chunk, int smem,
                        void* stream) {
  const MmaPlan p = {A, R, W, L, mt, depth, lda, ldb, a_off, b_off, p_off,
                     chunk};
  if (!check_plan(p, false, gx, gy, gz, bn, smem))
    return (int)cudaErrorInvalidValue;
  return launch_clusters(gather3d_kernel, win, oh, out, p, gx, gy, gz, smem,
                         stream);
}

// c (Kc, R, L), oh (R, W, L), out (Kc, W), all float32, 16-byte aligned;
// the plan of tools/mma_plan.py:deposit2d_plan.
int vpic_probe_deposit2d(const float* c, const float* oh, float* out, int Kc,
                         int R, int W, int L, int gx, int gy, int gz, int bn,
                         int mt, int depth, int lda, int ldb, int a_off,
                         int b_off, int p_off, int chunk, int smem,
                         void* stream) {
  const MmaPlan p = {Kc, R, W, L, mt, depth, lda, ldb, a_off, b_off, p_off,
                     chunk};
  if (!check_plan(p, true, gx, gy, gz, bn, smem))
    return (int)cudaErrorInvalidValue;
  return launch_clusters(deposit2d_kernel, c, oh, out, p, gx, gy, gz, smem,
                         stream);
}

// win (A, W) float32, loc (S, L) int32, out (A, S, L) float32; the plan
// of tools/probe_batched.py:stack8_plan: stage 1 (the row through shared
// memory: W a multiple of 4, win on a 16-byte boundary, smem bytes of the
// row and its mbarrier within 48 KB) or 0 (smem 0), width 4 (16-byte
// accesses: S*L a multiple of 4, loc and out on 16-byte boundaries) or 1,
// chunks of kStackPerBlock outputs a row and A * chunks blocks.
int vpic_probe_stack8(const float* win, const int* loc, float* out, int A,
                      int W, int S, int L, int stage, int width, int chunks,
                      int blocks, int smem, void* stream) {
  const long long SL = (long long)S * L;
  const bool vec = width == 4;
  const bool ok =
      A >= 1 && W >= 1 && SL >= 1 && (long long)A * SL < (1LL << 31) &&
      (long long)A * W < (1LL << 31) && (vec || width == 1) &&
      SL % width == 0 &&
      (!vec || ((reinterpret_cast<uintptr_t>(loc) |
                 reinterpret_cast<uintptr_t>(out)) & 15) == 0) &&
      (stage == 0 || stage == 1) &&
      (stage ? W % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(win) & 15) == 0 &&
                   smem == kStackRowOff + 4 * W && smem <= kStackSmemMax
             : smem == 0) &&
      chunks == (SL + kStackPerBlock - 1) / kStackPerBlock &&
      blocks == (long long)A * chunks;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int sl = (int)SL;
  if (stage && vec)
    stack8_kernel<true, 4><<<blocks, kStackThreads, smem, s>>>(
        win, loc, out, W, sl, chunks);
  else if (stage)
    stack8_kernel<true, 1><<<blocks, kStackThreads, smem, s>>>(
        win, loc, out, W, sl, chunks);
  else if (vec)
    stack8_kernel<false, 4><<<blocks, kStackThreads, 0, s>>>(
        win, loc, out, W, sl, chunks);
  else
    stack8_kernel<false, 1><<<blocks, kStackThreads, 0, s>>>(
        win, loc, out, W, sl, chunks);
  return (int)cudaGetLastError();
}

// loc (R, L) int32, out (R, W, L) float32; the plan of
// tools/probe_batched.py:onehot3d_plan: width 4 (16-byte accesses; L a
// multiple of 4, loc and out on 16-byte boundaries) or 1, ceil(W /
// kOnehotRows) phases and the blocks that give one thread per (r, phase,
// column).
int vpic_probe_onehot3d(const int* loc, float* out, int R, int W, int L,
                        int width, int phases, int blocks, void* stream) {
  const bool vec = width == 4;
  const long long total =
      width >= 1 ? (long long)R * (L / width) * phases : 0;
  const bool ok =
      R >= 1 && W >= 1 && L >= 1 && (long long)R * W * L < (1LL << 31) &&
      (vec || width == 1) && L % width == 0 &&
      (!vec || ((reinterpret_cast<uintptr_t>(loc) |
                 reinterpret_cast<uintptr_t>(out)) & 15) == 0) &&
      phases == (W + kOnehotRows - 1) / kOnehotRows &&
      blocks == (total + kOnehotBlock - 1) / kOnehotBlock;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    onehot3d_kernel<int4, float4><<<blocks, kOnehotBlock, 0, s>>>(
        reinterpret_cast<const int4*>(loc), reinterpret_cast<float4*>(out),
        W, L / 4, phases, (int)total);
  else
    onehot3d_kernel<int, float><<<blocks, kOnehotBlock, 0, s>>>(
        loc, out, W, L, phases, (int)total);
  return (int)cudaGetLastError();
}

// ps (B, 7, P), out (B, 16, P), float32; the plan of
// tools/probe_batched.py:io4d_plan: width 4 (16-byte accesses; P a
// multiple of 4, both pointers on 16-byte boundaries) or 1, and the
// blocks that give one thread per width floats of out.
int vpic_probe_io4d(const float* ps, float* out, int B, int P, int width,
                    int blocks, void* stream) {
  const bool vec = width == 4;
  const bool ok =
      (vec || width == 1) && P % width == 0 &&
      (!vec || ((reinterpret_cast<uintptr_t>(ps) |
                 reinterpret_cast<uintptr_t>(out)) & 15) == 0) &&
      blocks == ((long long)B * kIoOut * (P / width) + kIoBlock - 1) /
                    kIoBlock;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    io4d_kernel<float4><<<blocks, kIoBlock, 0, s>>>(
        reinterpret_cast<const float4*>(ps), reinterpret_cast<float4*>(out),
        B, P / 4);
  else
    io4d_kernel<float><<<blocks, kIoBlock, 0, s>>>(ps, out, B, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
