// The merge re-sort of a packed species: the mark pass, the per-key
// tables and the assembly.  CUDA C++ for sm_90a (H100).
//
// Replaces vpic_tpu/particles/sort_pallas.py:_assemble_kernel (launched
// there by merge_sort_packed) together with the XLA glue around it
// (sort_pallas.py:209-287: keys, movers, residual ranks, mover
// extraction, tables).  The plain versions are vpic_tpu_torch/particles/
// sort.py:mark, sort.py:tables and sort.py:assemble; each kernel equals
// its plain version bit for bit (integer tables only, plain stores of a
// permutation, no float arithmetic on the data, no float atomics).
//
// The mark pass and the assembly cut the block into tiles of kTile = 4096
// lanes, one block of 256 threads each.  A thread takes one float4 of row
// 7 and one int4 of key0 from each of the tile's 4 chunks of 1024 lanes,
// so every load is a 16-byte vector load and a warp's loads are
// contiguous.  A lane's rank among the tile's flagged lanes is one block
// scan of a 64-bit word that packs the thread's four per-chunk counts in
// 16-bit fields.
//
// Nothing is read back to the host and no size depends on the data, so a
// sort records into a CUDA graph: the mover count and the fast-or-full
// decision (the JAX package's lax.cond, sort_pallas.py:347) stay in the
// mark pass's `info` words on the device, which the tables and assembly
// kernels read; every launch has the same grid whatever they hold.  In a
// graph the tables and the assembly are nodes of the merge's conditional
// body, which runs where the decision is fast.
//
// merge_mark_kernel reads row 7 and key0 once (8 B per lane).  It counts
// the tile's movers (key != key0) and turns the counts into tile prefixes
// in one pass by decoupled look-back: a tile takes a ticket (so that every
// tile it waits for is running), publishes its count, and warp 0 reads 32
// predecessors' words at a time until one holds an inclusive prefix.  The
// words carry the launch's epoch, so they need no clearing between calls;
// the epoch is a word of the scratch that the last block to finish moves
// on, so a replayed graph takes a new one at every launch.  The kernel
// writes each tile's residual prefix and the key of its first residual
// lane, the first m_cap movers' lanes and old and new keys in lane order
// (overflow is counted, not written; the wrapper fills the slots with
// the sentinel first, so the slots past the movers hold it), and, from the
// last tile, info = [n_m, keys out of [0, nvk], key0[0] >= 0,
// ctot[nvk + 2] == n].  Bound at the bench shape (2 125 824 lanes, 5 %
// movers): 8 B per lane read and 12 B per mover written, about 18 MB,
// 5.5 us at 3.35 TB/s.
//
// merge_tables_kernel: one thread per key, two binary searches over the
// m_cap mover slots' sorted new and old keys (in L2; the sentinels past
// the movers lie above every key, so the counts are the movers'); latency,
// not bytes, bounds it.
//
// merge_assemble_kernel, where info says fast: block b re-derives its
// tile's keys, mover flags
// and residual ranks (block scan plus the tile prefix), so it reads no
// per-lane array of the glue.  A residual lane of rank r and key v goes to
// r + cum_mov[v], the mover of sorted rank m and key v to
// m + cum_res[v + 1].  The block owns one contiguous range of output
// slots: its residual lanes and the movers that sort between its first
// residual lane and the next tile's (their ranks start at cum_mov of the
// first residual key, from the mark pass).  It stages that range in
// shared memory one row at a time, the residual rows from its own 16-byte
// loads and the movers' gathered by lane, starts the next row's loads,
// and writes the range out with consecutive threads on consecutive slots:
// every sector of the output is written whole, by one block.  Row 7 and
// the next key0 come from the key (0 and nvk past np), so nothing
// re-zeroes them afterwards.  64 registers a thread keep 4 blocks on an
// SM, so the bench shape's 519 tiles run in one wave.  No pre-zeroed
// output: a lane whose key or destination is out of range, or outside its
// block's slots, is not written and is counted; the last block to finish
// writes the anomaly (count + 1 if any) and clears the counters.  Bound:
// 36 B per lane read (8 rows and key0) and 36 B written, 16 B per mover of
// plan, the two (nvk + 3) tables: about 155 MB, 46 us at 3.35 TB/s; bytes,
// not operations, bound it.  Where info says slow it writes only the
// anomaly (0).
//
// The same kernel in its gather mode (vpic_merge_gather) is the full
// sort's branch (sort.py:gather): where info says slow, lane i of the
// output is lane full_order[i] of the input, row 7 and key0 from the
// sorted key full_key[i], and the anomaly is 0; where fast it writes only
// the anomaly.  The two modes write one output buffer set, each only
// where the decision is its own, so run both (eagerly) or the taken one
// (as the bodies of a CUDA graph's conditional nodes, engine/cond.py),
// the block is the same, and nothing is copied between branches.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrored field for field by particles/sort_cuda.py:_MarkArgs.
struct MarkArgs {
  const float* pk;              // (8, n) rows
  const int* np;                // device scalar
  const int* key0;              // (n,)
  const int* ctot;              // (nvk + 3,)
  int* res_base;                // (tiles,)
  int* res_key;                 // (tiles,) key of the first residual, or -1
  int* mov_lane;                // (m_cap,)
  int* mov_key;                 // (m_cap,)
  int* mov_old;                 // (m_cap,)
  int* info;                    // (4,)
  unsigned long long* status;   // (>= tiles,) look-back words
  // [ticket, keys out of range, epoch, done blocks]: the ticket, the count
  // and the done blocks are left zero; the epoch is that of the last
  // launch (0 .. 2^30 - 2), so this one's is one more
  unsigned int* work;
  int n;
  int nvk;
  int m_cap;
  int vec;                      // rows and key0 16-byte aligned, n % 4 == 0
};

// Mirrored field for field by particles/sort_cuda.py:_AssembleArgs.
struct AssembleArgs {
  const float* pk;              // (8, n)
  const int* np;
  const int* key0;              // (n,)
  const int* res_base;          // (tiles,)
  const int* res_key;           // (tiles,)
  const int* cum_res;           // (nvk + 3,)
  const int* cum_mov;           // (nvk + 3,)
  const int* key_ms;            // (m_cap,) sorted mover slot keys
  const long long* order;       // (m_cap,) their mark slots
  const int* mov_lane;          // (m_cap,)
  const int* info;              // (4,) the mark pass's
  const long long* full_order;  // (n,) the full sort's lane order (gather)
  const int* full_key;          // (n,) its sorted keys (gather)
  float* out;                   // (8, n)
  int* key0_out;                // (n,)
  int* anomaly;                 // device scalar
  unsigned int* work;           // [done blocks, bad lanes], left zero
  int n;
  int nvk;
  int m_cap;
  int vec;
  int mode;                     // 0 (the merge) or kGather
};

// Mirrored field for field by particles/sort_cuda.py:_TablesArgs.
struct TablesArgs {
  const int* key_ms;            // (slots,) sorted
  const int* mov_old;           // (slots,) sorted
  const int* ctot;              // (keys,)
  int* cum_res;                 // (keys,)
  int* cum_mov;                 // (keys,)
  int* cum_tot;                 // (keys,)
  int slots;                    // m_cap
  int keys;                     // nvk + 3
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = 4;
constexpr int kChunk = kThreads * 4;      // lanes of a chunk: a float4 each
constexpr int kTile = kChunks * kChunk;   // 4096 lanes
// AssembleArgs::mode: 0, the merge, written where the decision is fast;
// kGather, the full sort's gather, written where it is slow
constexpr int kGather = 1;

__device__ __forceinline__ void load4(const float* p, int i, int n,
                                      int vec, float v[4]) {
  if (vec && i + 3 < n) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = i + e < n ? __ldg(p + i + e) : 0.f;
  }
}

__device__ __forceinline__ void load4(const int* p, int i, int n,
                                      int vec, int v[4]) {
  if (vec && i + 3 < n) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p + i));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = i + e < n ? __ldg(p + i + e) : 0;
  }
}

// sort.py:lane_keys: row 7 rounded (float32 add, truncation) for live lanes
__device__ __forceinline__ int lane_key(float row7, int lane, int np,
                                        int nvk) {
  return lane < np ? __float2int_rz(row7 + 0.5f) : nvk;
}

__device__ __forceinline__ int field(unsigned long long packed, int k) {
  return (int)((packed >> (16 * k)) & 0xffffu);
}

// Exclusive block scan of x; `total` gets the block's sum.  Ends with a
// barrier, so `sh` may be reused.
__device__ __forceinline__ unsigned long long block_scan(
    unsigned long long x, unsigned long long* sh, unsigned long long& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned long long inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sh[w] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long run = 0;
    for (int i = 0; i < kWarps; ++i) sh[i] = run += sh[i];
  }
  __syncthreads();
  total = sh[kWarps - 1];
  const unsigned long long excl = (w ? sh[w - 1] : 0ull) + inc - x;
  __syncthreads();
  return excl;
}

constexpr unsigned long long kInclusive = 1ull << 32;
constexpr unsigned kEpochs = 1u << 30;  // the epoch field of a status word

// sort.py:fast_path: a snapshot, consistent tables, every key in range and
// at most m_cap movers
__device__ __forceinline__ bool fast_path(const int* info, int m_cap) {
  return info[2] != 0 && info[3] != 0 && info[1] == 0 && info[0] <= m_cap;
}

__global__ void __launch_bounds__(kThreads) merge_mark_kernel(MarkArgs a) {
  __shared__ unsigned long long sh[kWarps];
  __shared__ int s_tile, s_prefix;
  __shared__ unsigned s_first, s_epoch;
  const int tiles = (a.n + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    s_first = kTile;
    // read before this block counts itself done, so before the last block
    // to finish moves the epoch on
    s_epoch = *(volatile unsigned*)&a.work[2] + 1;
    const int t = (int)atomicAdd(&a.work[0], 1u);
    if (t == tiles - 1) a.work[0] = 0;  // the last ticket of this launch
    s_tile = t;
  }
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kTile;
  const int np = *a.np;

  int key[kChunks][4], old[kChunks][4];
  unsigned mov = 0;  // bit 4k + e: lane e of chunk k moved
  unsigned long long counts = 0;
  unsigned out_of_range = 0;
  unsigned first = kTile;  // this thread's first residual lane in the tile
  int first_key = -1;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int i = base + k * kChunk + 4 * threadIdx.x;
    float r7[4];
    load4(a.pk + (size_t)7 * a.n, i, a.n, a.vec, r7);
    load4(a.key0, i, a.n, a.vec, old[k]);
    int c = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      key[k][e] = lane_key(r7[e], i + e, np, a.nvk);
      if (i + e < a.n) {
        if (key[k][e] != old[k][e]) {
          mov |= 1u << (4 * k + e);
          ++c;
        } else if (first == kTile) {
          first = k * kChunk + 4 * threadIdx.x + e;
          first_key = key[k][e];
        }
        out_of_range += key[k][e] < 0 || key[k][e] > a.nvk ||
                        old[k][e] < 0 || old[k][e] > a.nvk;
      }
    }
    counts |= (unsigned long long)c << (16 * k);
  }
  out_of_range = __reduce_add_sync(0xffffffffu, out_of_range);
  if ((threadIdx.x & 31) == 0 && out_of_range)
    atomicAdd(&a.work[1], out_of_range);
  const unsigned warp_first = __reduce_min_sync(0xffffffffu, first);
  if ((threadIdx.x & 31) == 0 && warp_first < kTile)
    atomicMin(&s_first, warp_first);

  unsigned long long tot;
  const unsigned long long excl = block_scan(counts, sh, tot);
  const int tile_movers = field(tot, 0) + field(tot, 1) + field(tot, 2) +
                          field(tot, 3);

  if (threadIdx.x < 32) {
    volatile unsigned long long* st = a.status;
    const unsigned long long epoch = (unsigned long long)s_epoch;
    const int lane = threadIdx.x;
    if (lane == 0 && tile > 0) {
      __threadfence();
      st[tile] = (epoch << 33) | (unsigned)tile_movers;
    }
    int prefix = 0;
    for (int p = tile - 1; p >= 0; p -= 32) {
      const int q = p - lane;
      unsigned long long s = kInclusive;  // before tile 0: inclusive 0
      if (q >= 0) {
        do {
          s = st[q];
        } while ((s >> 33) != epoch);
      }
      const unsigned incl = __ballot_sync(0xffffffffu, (s & kInclusive) != 0);
      const int stop = incl ? __ffs(incl) - 1 : 31;
      prefix += (int)__reduce_add_sync(
          0xffffffffu, lane <= stop ? (unsigned)s : 0u);
      if (incl) break;
    }
    if (lane == 0) {
      __threadfence();
      st[tile] = (epoch << 33) | kInclusive | (unsigned)(prefix + tile_movers);
      s_prefix = prefix;
      if (tile == tiles - 1) {
        __threadfence();
        a.info[0] = prefix + tile_movers;
        a.info[1] = (int)atomicExch(&a.work[1], 0u);
        a.info[2] = a.key0[0] >= 0;
        a.info[3] = a.ctot[a.nvk + 2] == a.n;
      }
    }
  }
  __syncthreads();

  const int prefix = s_prefix;
  int before = 0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int i = base + k * kChunk + 4 * threadIdx.x;
    int g = prefix + before + field(excl, k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (mov >> (4 * k + e) & 1u) {
        if (g < a.m_cap) {
          a.mov_lane[g] = i + e;
          a.mov_key[g] = key[k][e];
          a.mov_old[g] = old[k][e];
        }
        ++g;
      }
    }
    before += field(tot, k);
  }
  if (threadIdx.x == 0) a.res_base[tile] = (int)(base - prefix);
  if (s_first == kTile ? threadIdx.x == 0 : first == s_first)
    a.res_key[tile] = first_key;
  __syncthreads();
  if (threadIdx.x == 0) __threadfence();
  if (threadIdx.x == 0 && atomicAdd(&a.work[3], 1u) == (unsigned)tiles - 1) {
    a.work[3] = 0;
    a.work[2] = s_epoch == kEpochs - 1 ? 0u : s_epoch;
  }
}

// sort.py:tables: per key v, the movers' new and old keys below v: two
// binary searches over sorted arrays that stay in L2, run in step so that
// their loads overlap.
__global__ void __launch_bounds__(kThreads) merge_tables_kernel(TablesArgs a) {
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= a.keys) return;
  int lo_new = 0, hi_new = a.slots, lo_old = 0, hi_old = a.slots;
  while (lo_new < hi_new || lo_old < hi_old) {
    const int mid_new = (lo_new + hi_new) >> 1;
    const int mid_old = (lo_old + hi_old) >> 1;
    if (lo_new < hi_new) {
      if (a.key_ms[mid_new] < v) lo_new = mid_new + 1; else hi_new = mid_new;
    }
    if (lo_old < hi_old) {
      if (a.mov_old[mid_old] < v) lo_old = mid_old + 1; else hi_old = mid_old;
    }
  }
  const int cum_res = a.ctot[v] - lo_old;
  a.cum_mov[v] = lo_new;
  a.cum_res[v] = cum_res;
  a.cum_tot[v] = cum_res + lo_new;
}

constexpr int kWindow = 6144;  // output slots staged per pass of a block

// The first mover rank of tile t's output range: the movers that sort
// before the first residual lane at or after tile t (0 for tile 0, n_m
// past the last tile).  Nondecreasing in t, so the ranges partition the
// movers.
__device__ int mover_start(const AssembleArgs& a, int t, int tiles,
                           int n_m) {
  if (t == 0) return 0;
  for (; t < tiles; ++t) {
    const int v = a.res_key[t];
    if (v >= 0) return v <= a.nvk ? min(max(a.cum_mov[v], 0), n_m) : n_m;
  }
  return n_m;
}

// Sorted mover m: its destination (-1 if its key or lane is out of range)
// and its lane.
__device__ __forceinline__ void mover(const AssembleArgs& a, int m, int n_m,
                                      int& d, int& lane, int& v) {
  v = a.key_ms[m];
  const long long o = a.order[m];
  lane = o >= 0 && o < n_m ? a.mov_lane[o] : -1;
  d = v >= 0 && v <= a.nvk && lane >= 0 && lane < a.n ? m + a.cum_res[v + 1]
                                                      : -1;
}

// sort.py:gather, the tile's lanes: lane i of the output is lane
// full_order[i] of the input; row 7 the sorted key for live lanes below
// nvk, else 0; key0 that row rounded for live lanes, else nvk.
__device__ void full_gather(const AssembleArgs& a, int base, int np) {
  const int end = min(base + kTile, a.n);
  for (int i = base + threadIdx.x; i < end; i += kThreads) {
    const long long o = a.full_order[i];
    if (o >= 0 && o < a.n) {
#pragma unroll
      for (int r = 0; r < 7; ++r)
        a.out[(size_t)r * a.n + i] = __ldg(a.pk + (size_t)r * a.n + o);
    }
    const int k = a.full_key[i];
    const float r7 = i < np && k < a.nvk ? (float)k : 0.f;
    a.out[(size_t)7 * a.n + i] = r7;
    a.key0_out[i] = i < np ? __float2int_rz(r7 + 0.5f) : a.nvk;
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    merge_assemble_kernel(AssembleArgs a) {
  __shared__ __align__(16) float s_val[kWindow];
  __shared__ unsigned long long sh[kWarps];
  __shared__ int s_m0, s_m1;
  const int tiles = (a.n + kTile - 1) / kTile;
  const int tile = blockIdx.x;
  const int base = tile * kTile;
  const int np = *a.np;
  const bool fast = fast_path(a.info, a.m_cap);
  if (a.mode == kGather || !fast) {
    // each mode writes the block only where the decision is its own
    if (a.mode == kGather && !fast) full_gather(a, base, np);
    if (tile == 0 && threadIdx.x == 0) *a.anomaly = 0;
    return;
  }
  // the fast path holds: n_m <= m_cap
  const int n_m = a.info[0];
  if (threadIdx.x == 0) {
    s_m0 = mover_start(a, tile, tiles, n_m);
    s_m1 = max(s_m0, mover_start(a, tile + 1, tiles, n_m));
  }

  // the tile's residual lanes: ranks, then destinations (their keys wait
  // in shared memory and are read again from row 7 in pass 0, to keep the
  // registers for 4 blocks an SM)
  int dest[kChunks][4];
  unsigned long long counts = 0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int i = base + k * kChunk + 4 * threadIdx.x;
    float r7[4];
    int k0[4];
    load4(a.pk + (size_t)7 * a.n, i, a.n, a.vec, r7);
    load4(a.key0, i, a.n, a.vec, k0);
    int c = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = lane_key(r7[e], i + e, np, a.nvk);
      // residual: its rank among the thread's lanes of the chunk, then
      // its destination; -1 for movers, lanes past n and anomalies
      dest[k][e] = i + e < a.n && v == k0[e] ? c++ : -1;
    }
    counts |= (unsigned long long)c << (16 * k);
    // a residual lane's key is its key0
    reinterpret_cast<int4*>(s_val)[k * kThreads + threadIdx.x] =
        make_int4(k0[0], k0[1], k0[2], k0[3]);
  }
  unsigned long long tot;
  const unsigned long long excl = block_scan(counts, sh, tot);
  const int m0 = s_m0, m1 = s_m1;
  const int r0 = a.res_base[tile];
  const int r1 = tile + 1 < tiles ? a.res_base[tile + 1] : a.n - n_m;
  // the block writes the output slots [o0, o1): its residual lanes and the
  // movers [m0, m1) that sort between them and the next tile's
  const int o0 = max(r0 + m0, 0);
  const int o1 = max(min(r1 + m1, a.n), o0);
  unsigned bad = 0;
  int before = 0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int off = before + field(excl, k);
    const int4 kv =
        reinterpret_cast<const int4*>(s_val)[k * kThreads + threadIdx.x];
    const int keys[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (dest[k][e] < 0) continue;
      const int v = keys[e];
      const int d = v >= 0 && v <= a.nvk ? r0 + off + dest[k][e] + a.cum_mov[v]
                                         : -1;
      const bool ok = d >= o0 && d < o1;
      bad += !ok;
      dest[k][e] = ok ? d : -1;
    }
    before += field(tot, k);
  }
  // this thread's first mover, kept for every pass; the rest (a block
  // with more than kThreads movers) are looked up again in each pass
  int md = -1, ml = 0, mv = 0;
  for (int j = threadIdx.x; j < m1 - m0; j += kThreads) {
    int d, lane, v;
    mover(a, m0 + j, n_m, d, lane, v);
    const bool ok = d >= o0 && d < o1;
    bad += !ok;
    if (j == threadIdx.x && ok) {
      md = d;
      ml = lane;
      mv = v;
    }
  }

  // Passes over rows 7, 0, 1, ..., 6 of each window of kWindow output
  // slots: stage the window's slots in shared memory, start the next
  // pass's loads, write the window out.
  float x[kChunks][4], mx = 0.f;
  const auto load_row = [&](int r) {
    const float* row = a.pk + (size_t)r * a.n;
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
      load4(row, base + k * kChunk + 4 * threadIdx.x, a.n, a.vec, x[k]);
    if (r != 7 && md >= 0) mx = __ldg(row + ml);
  };
  load_row(7);
  for (int w0 = o0; w0 < o1; w0 += kWindow) {
    const int len = min(kWindow, o1 - w0);
    const auto in_window = [&](int d) { return d >= w0 && d < w0 + len; };
    for (int p = 0; p < 8; ++p) {
      const int r = (p + 7) & 7;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!in_window(dest[k][e])) continue;
          const int lane = base + k * kChunk + 4 * threadIdx.x + e;
          s_val[dest[k][e] - w0] =
              r == 7 ? __int_as_float(lane_key(x[k][e], lane, np, a.nvk))
                     : x[k][e];
        }
      }
      if (in_window(md)) s_val[md - w0] = r == 7 ? __int_as_float(mv) : mx;
      for (int j = threadIdx.x + kThreads; j < m1 - m0; j += kThreads) {
        int d, lane, v;
        mover(a, m0 + j, n_m, d, lane, v);
        if (in_window(d))
          s_val[d - w0] = r == 7 ? __int_as_float(v)
                                 : __ldg(a.pk + (size_t)r * a.n + lane);
      }
      __syncthreads();
      if (p < 7 || w0 + kWindow < o1) load_row(p < 7 ? p : 7);
      if (r == 7) {
        for (int q = threadIdx.x; q < len; q += kThreads) {
          const int d = w0 + q;
          const int v = __float_as_int(s_val[q]);
          a.out[(size_t)7 * a.n + d] = d < np ? (float)v : 0.f;
          a.key0_out[d] = d < np ? v : a.nvk;
        }
      } else {
        float* row = a.out + (size_t)r * a.n;
        for (int q = threadIdx.x; q < len; q += kThreads)
          row[w0 + q] = s_val[q];
      }
    }
  }

  // anomaly (sort_pallas.py:155-167): the lanes not written, plus 1 if any
  bad = __reduce_add_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0 && bad) atomicAdd(&a.work[1], bad);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&a.work[0], 1u) == gridDim.x - 1) {
      __threadfence();
      const unsigned total = atomicExch(&a.work[1], 0u);
      a.work[0] = 0;
      *a.anomaly = (int)total + (total > 0);
    }
  }
}

}  // namespace

extern "C" {

int vpic_merge_mark_args_size() { return (int)sizeof(MarkArgs); }
int vpic_merge_tables_args_size() { return (int)sizeof(TablesArgs); }
int vpic_merge_assemble_args_size() { return (int)sizeof(AssembleArgs); }
int vpic_merge_tile() { return kTile; }

// Each entry launches on `stream` and returns cudaGetLastError() (0 =
// launched).
int vpic_merge_mark(const MarkArgs* args, void* stream) {
  const MarkArgs a = *args;
  const int tiles = (a.n + kTile - 1) / kTile;
  if (tiles > 0)
    merge_mark_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The assembly kernel alone, in the mode its arguments name, on `stream`.
int vpic_merge_gather(const AssembleArgs* args, void* stream) {
  const AssembleArgs a = *args;
  const int tiles = (a.n + kTile - 1) / kTile;
  if (tiles > 0)
    merge_assemble_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The tables, then the assembly that reads them, on `stream`.
int vpic_merge_assemble(const TablesArgs* targs, const AssembleArgs* args,
                        void* stream) {
  const TablesArgs t = *targs;
  const AssembleArgs a = *args;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (t.keys + kThreads - 1) / kThreads;
  if (blocks > 0) merge_tables_kernel<<<blocks, kThreads, 0, st>>>(t);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.n + kTile - 1) / kTile;
  if (tiles > 0) merge_assemble_kernel<<<tiles, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
