// The sharded engine's wave body (kernel K10).
//
// Replaces distributed_tpu/ops/leveled.py::_sharded_run_fn.local (its
// per-wave body run_wave, leveled.py:1168-1285), the shard_map program the
// TPU engine runs on every shard of a (tasks, workers) mesh.  The plain
// version beside it is ops/sharded.py::shard_tentative_reference and
// shard_contend_reference.
//
// A wave's window of F = D * Fl sorted rows is split contiguously over the
// D shards: shard d owns rows [d*Fl, (d+1)*Fl) and a row's rank is
// d*Fl + j (leveled.py:1159-1166); ranks >= f (the wave's true size) are
// padding.  Each shard computes K1's wave body on its own rows against the
// replicated assignment and load, and the shards combine through two
// psums and an all_gather a wave.  One launch holds every shard of the
// process that lives on this device (gridDim.y = S shards, gridDim.x =
// blocks per shard).  Two modes:
//
// Run mode (place_shard_run_kernel), when every shard lives in this
// process on this one device: every wave of a fused run in one
// cooperative launch, as the reference runs a fused run as one program (a
// fori_loop over the run's K waves with psum, all_gather and
// dynamic_update_slice inside).  The collectives become work inside the
// launch: the psums are adds in shard order, acc = part[0]; acc = acc +
// part[1]; ..., as LocalShards.psum adds them, and the all_gather plus the
// slice update are each row's writes into the replicated assignment at
// offset + rank.  A wave k reads its offset, size and span slot from a
// small int32 table [offs | fs | widxs] shipped with the run's tiles, and a
// padding wave (fs = 0) is skipped, as the reference's lax.cond skips it.
// Eight grid barriers a wave, K1's:
//
//   rank + tentative + counts | chunk offsets | scatter | sums, psum ->
//   tl | contend (the slice writes) + counts | chunk offsets | scatter |
//   sums, psum, load += wave load, the span
//
// A warp a worker adds that worker's bucket of every shard in shard order
// and then the shards' sums in shard order, so the psum needs no barrier
// of its own.  The next wave's rank reads the load only after the last
// barrier of the wave before.
//
// Step mode (place_shard_kernel), for shards that a process group or
// several devices hold: two launches a wave, the collectives issued by the
// host between them (ops/sharded.py):
//
//   launch A (CONTEND = false): the worker order by load / threads, the
//     three candidates per row, the first argmin, and each shard's
//     tentative load partial [W];
//   psum of the partials;
//   launch B (CONTEND = true): the contention round against the summed
//     tentative load, the final choice, the shard's assignment slice and
//     its wave-load partial [W];
//   psum of the partials, load += wave load, the span and the all_gather
//     of the slices (torch ops on the host's side).
//
// The order rules are K1's (csrc/place_wave.cu), and its device functions
// are copied here, adapted to a shard index, so that K1 stays as it is.  A
// shard's partial per worker is summed in task order, as CPU index_add_ and
// the reference's segment_sum do: each valid row's (worker, work) pair is
// bucketed by worker with a stable counting sort (per-chunk counts,
// per-worker offsets over the chunks in order, a warp-serial scatter that
// keeps row order), and one warp per (shard, worker) -- in run mode per
// worker, over its shards in order -- then adds its bucket front to back.
// Products that feed a sum are written with __fmul_rn/__fadd_rn so nvcc
// makes no FMA, and no sum uses a float atomic.  A padding row writes
// assign = -1 and would add +0.0; the kernel skips its adds.  Every block
// sorts the W workers itself (a bitonic sort of (key, index) pairs, so ties
// go by index as a stable argsort), and the tentative pass keeps each row's
// spread candidate for the contention pass.  Data that a launch writes and
// reads again (the assignment, the load, tl) is read through L2 (__ldcg),
// never through the non-coherent read-only path.
//
// Bound on an H100: bytes, as K1's (each row's 16 B of wire read once, its
// assignment and choice written once, the [S][W] partials); the waves form
// a chain of grid barriers, which is what the run mode's single launch
// shortens against the step mode's ~20 host-issued ops a wave.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kPiece = 2 * kThreads;  // rows a scatter stages in shared memory at once

__device__ __forceinline__ int argmin3(float c0, float c1, float c2) {
  // first minimum on ties, as jnp.argmin
  const int m01 = (c0 <= c1) ? 0 : 1;
  const float v01 = fminf(c0, c1);
  return (v01 <= c2) ? m01 : 2;
}

template <typename T>
__device__ __forceinline__ T sel3(int ch, T a0, T a1, T a2) {
  return ch == 0 ? a0 : (ch == 1 ? a1 : a2);
}

struct ShardArgs {
  // this device's tiles, [S][K][Fl] each (f16 wire)
  const __half* dur16;
  const int* heavy;
  const int* heavy2;
  const __half* xp16;
  const __half* xp2_16;
  const __half* xa16;
  const int* shard_ids;  // [S] global shard index of each tile row
  int* assign;           // [Tp] the replicated assignment (earlier waves final; run mode writes)
  int* choices;          // [Tp] the replicated choices (run mode writes)
  float* load;           // [W] the replicated cumulative load (run mode adds the wave load)
  float* spans;          // [Lp] per-wave span (run mode writes)
  const float* inv_t;    // [W] 1 / max(nthreads, 1)
  const uint8_t* running;
  const float* ovt0;     // [W] occ0 / threads, +inf where not running
  float* tl;             // [W] the summed tentative load (step: launch B's input; run: its psum)
  int* tgt;              // [S][Fl] the worker a row's work is summed on, -1 padding
  float* wt;             // [S][Fl] ... and that work
  int* spread;           // [S][Fl] launch A's spread candidate, for launch B
  float* sorted;         // [S][Fl] work bucketed by worker, row order kept
  int* cnt;              // [S][W][gridDim.x] per-chunk counts, then offsets
  int* start;            // [S][W] bucket starts
  int* tot;              // [S][W] bucket sizes
  float* part;           // [S][W] out: the shard's partial per worker
  int* aslice;           // [S][Fl] out (launch B): assignment, -1 on padding rows
  int* cslice;           // [S][Fl] out (launch B): choice
  int W, K, Fl, w_run;
  float ovt_c, inv_c;
};

// the wave a pass works on: its tile slot k and its true size f
struct Wave {
  int k, f;
};

struct Task {
  float dur, xp, xp2, xa;
  int p, p2, rank;
  bool ok1, ok2, valid;
};

__device__ __forceinline__ Task load_task(const ShardArgs& a, Wave wv, int s, int j) {
  const size_t g = (static_cast<size_t>(s) * a.K + wv.k) * a.Fl + j;
  Task t;
  t.dur = __half2float(a.dur16[g]);
  t.xp = __half2float(a.xp16[g]);
  t.xp2 = __half2float(a.xp2_16[g]);
  t.xa = __half2float(a.xa16[g]);
  const int h = a.heavy[g];
  const int h2 = a.heavy2[g];
  t.rank = a.shard_ids[s] * a.Fl + j;
  t.valid = t.rank < wv.f;
  // heavy deps sit in earlier waves: their assignment is final
  const int pref = (t.valid && h >= 0) ? __ldcg(a.assign + h) : -1;
  const int pref2 = (t.valid && h2 >= 0) ? __ldcg(a.assign + h2) : -1;
  t.p = max(pref, 0);
  t.p2 = max(pref2, 0);
  t.ok1 = pref >= 0;
  t.ok2 = pref2 >= 0 && pref2 != pref;
  return t;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 32;
  while (p < n) p *= 2;
  return p;
}

// K1's stable worker order (csrc/place_wave.cu: rank_entry, block_rank):
// ascending load / threads, stopped workers last, ties by index
__device__ __forceinline__ unsigned long long rank_entry(const ShardArgs& a, int w) {
  if (w >= a.W) return ~0ull;
  const float key = a.running[w] ? __fmul_rn(__ldcg(a.load + w), a.inv_t[w]) + 0.f : INFINITY;
  const unsigned u = __float_as_uint(key);
  const unsigned code = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(code) << 32) | static_cast<unsigned>(w);
}

__device__ void block_rank(const ShardArgs& a, unsigned long long* s_sort, int* s_order) {
  const int W = a.W;
  const int P = pow2_at_least(W);
  const int t = threadIdx.x;
  if (P <= kThreads) {
    const bool active = t < P;  // whole warps, as P is a multiple of 32
    unsigned long long x = active ? rank_entry(a, t) : 0ull;
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        unsigned long long y;
        if (j >= 32) {
          if (active) s_sort[t] = x;
          __syncthreads();
          y = active ? s_sort[t ^ j] : 0ull;
          __syncthreads();
        } else {
          y = active ? __shfl_xor_sync(0xffffffffu, x, j) : 0ull;
        }
        const bool keep_min = ((t & j) == 0) == ((t & k) == 0);
        x = keep_min ? min(x, y) : max(x, y);
      }
    }
    if (t < W) s_order[t] = static_cast<int>(x & 0xffffffffu);
    __syncthreads();
    return;
  }
  for (int w = t; w < P; w += kThreads) s_sort[w] = rank_entry(a, w);
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = t; i < P; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long x = s_sort[i], y = s_sort[ixj];
          if ((x > y) == ((i & k) == 0)) {
            s_sort[i] = y;
            s_sort[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int r = t; r < W; r += kThreads) s_order[r] = static_cast<int>(s_sort[r] & 0xffffffffu);
  __syncthreads();
}

// launch A for row j of shard s: the first choice, as the reference's c0/c1/c2
template <bool UNIFORM>
__device__ __forceinline__ void tentative(const ShardArgs& a, Wave wv, const int* s_order, int s,
                                          int j, int block) {
  const Task t = load_task(a, wv, s, j);
  const int sp = s_order[min(t.rank / block, a.W - 1)];
  float c0, c1, c2;
  if (UNIFORM) {
    c0 = t.ok1 ? t.xp + a.ovt_c : INFINITY;
    c1 = t.ok2 ? t.xp2 + a.ovt_c : INFINITY;
    c2 = t.xa + a.ovt_c;
  } else {
    c0 = t.ok1 ? a.ovt0[t.p] + t.xp : INFINITY;
    c1 = t.ok2 ? a.ovt0[t.p2] + t.xp2 : INFINITY;
    c2 = a.ovt0[sp] + t.xa;
  }
  const int ch = argmin3(c0, c1, c2);
  const size_t r = static_cast<size_t>(s) * a.Fl + j;
  a.tgt[r] = t.valid ? sel3(ch, t.p, t.p2, sp) : -1;
  a.wt[r] = t.valid ? t.dur + sel3(ch, t.xp, t.xp2, t.xa) : 0.f;
  a.spread[r] = sp;
}

// launch B for row j of shard s: the contention round, the final choice;
// the step mode writes it into the shard's slices, the run mode straight
// into the replicated assignment at offset + rank (the gather and the
// slice update), padding rows' -1 included
template <bool UNIFORM, bool RUN>
__device__ __forceinline__ void contend(const ShardArgs& a, Wave wv, int s, int j, int offset) {
  const Task t = load_task(a, wv, s, j);
  const size_t r = static_cast<size_t>(s) * a.Fl + j;
  const int sp = a.spread[r];
  const int tent = a.tgt[r];
  const float tw = a.wt[r];  // 0 on a padding row, so its own share is 0
  const float tl_p = __ldcg(a.tl + t.p);
  const float tl_p2 = __ldcg(a.tl + t.p2);
  const float tl_s = __ldcg(a.tl + sp);
  float d0, d1, d2;
  if (UNIFORM) {
    const float corr = __fmul_rn(tw, a.inv_c);
    const float q0 = __fmul_rn(tl_p, a.inv_c);
    const float q1 = __fmul_rn(tl_p2, a.inv_c);
    const float q2 = __fmul_rn(tl_s, a.inv_c);
    d0 = t.ok1 ? ((q0 - (t.p == tent ? corr : 0.f)) + t.xp) + a.ovt_c : INFINITY;
    d1 = t.ok2 ? ((q1 - (t.p2 == tent ? corr : 0.f)) + t.xp2) + a.ovt_c : INFINITY;
    d2 = ((q2 - (sp == tent ? corr : 0.f)) + t.xa) + a.ovt_c;
  } else {
    const float corr = t.valid ? __fmul_rn(tw, a.inv_t[tent]) : 0.f;
    const float s0 = __fadd_rn(a.ovt0[t.p], __fmul_rn(tl_p, a.inv_t[t.p]));
    const float s1 = __fadd_rn(a.ovt0[t.p2], __fmul_rn(tl_p2, a.inv_t[t.p2]));
    const float s2 = __fadd_rn(a.ovt0[sp], __fmul_rn(tl_s, a.inv_t[sp]));
    d0 = t.ok1 ? (s0 - (t.p == tent ? corr : 0.f)) + t.xp : INFINITY;
    d1 = t.ok2 ? (s1 - (t.p2 == tent ? corr : 0.f)) + t.xp2 : INFINITY;
    d2 = (s2 - (sp == tent ? corr : 0.f)) + t.xa;
  }
  const int ch = argmin3(d0, d1, d2);
  const int w = t.valid ? sel3(ch, t.p, t.p2, sp) : -1;
  if (RUN) {
    const size_t g = static_cast<size_t>(offset) + t.rank;
    a.assign[g] = w;
    a.choices[g] = ch;
  } else {
    a.aslice[r] = w;
    a.cslice[r] = ch;
  }
  a.tgt[r] = w;
  a.wt[r] = t.valid ? t.dur + sel3(ch, t.xp, t.xp2, t.xa) : 0.f;
}

// this block's chunk [lo, hi) of shard s: how many valid rows go to each
// worker -> cnt[s][w][chunk]
__device__ void count_chunk(const ShardArgs& a, int* s_cnt, int s, int lo, int hi) {
  const int W = a.W;
  for (int w = threadIdx.x; w < W; w += kThreads) s_cnt[w] = 0;
  __syncthreads();
  const int* tgt = a.tgt + static_cast<size_t>(s) * a.Fl;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int w = __ldcg(tgt + i);
    if (w >= 0) atomicAdd(&s_cnt[w], 1);
  }
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += kThreads) {
    a.cnt[(static_cast<size_t>(s) * W + w) * gridDim.x + blockIdx.x] = s_cnt[w];
  }
}

// one warp per (shard, worker): cnt[s][w][c] becomes the offset of chunk c
// inside the bucket, tot[s][w] the bucket's size
__device__ void chunk_offsets(const ShardArgs& a, int nb) {
  const int lane = threadIdx.x & 31;
  const int nblocks = gridDim.x * gridDim.y;
  const int block_id = blockIdx.y * gridDim.x + blockIdx.x;
  const int warps = nblocks * kThreads / 32;
  const int per = (nb + 31) / 32;
  const int pairs = gridDim.y * a.W;
  for (int q = (block_id * kThreads + threadIdx.x) / 32; q < pairs; q += warps) {
    int* row = a.cnt + static_cast<size_t>(q) * gridDim.x;
    const int lo = min(lane * per, nb);
    const int hi = min(lo + per, nb);
    int sum = 0;
    for (int c = lo; c < hi; ++c) sum += __ldcg(row + c);
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    int run = inc - sum;
    for (int c = lo; c < hi; ++c) {
      const int x = __ldcg(row + c);
      row[c] = run;
      run += x;
    }
    if (lane == 31) a.tot[q] = inc;
  }
}

// s_out[w] = sum of tot[0..w), by the whole block
__device__ void block_exclusive_scan(const int* tot, int W, int* s_out, int* s_part) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int per = (W + kThreads - 1) / kThreads;
  const int lo = min(tid * per, W);
  const int hi = min(lo + per, W);
  int sum = 0;
  for (int w = lo; w < hi; ++w) sum += __ldcg(tot + w);
  int inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) s_part[tid / 32] = inc;
  __syncthreads();
  if (tid < 32) {
    const int t = tid < kThreads / 32 ? s_part[tid] : 0;
    int x = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += v;
    }
    if (tid < kThreads / 32) s_part[tid] = x - t;  // exclusive over warps
  }
  __syncthreads();
  int run = s_part[tid / 32] + inc - sum;
  for (int w = lo; w < hi; ++w) {
    s_out[w] = run;
    run += __ldcg(tot + w);
  }
  __syncthreads();
}

// bucket starts of shard s, then the chunk in pieces: warp 0 scatters the
// valid rows 32 at a time in order, each row's work to the next free slot of
// its worker's bucket, so a bucket keeps row order
__device__ void scatter_chunk(const ShardArgs& a, int* s_next, int* s_part, int* s_tgt,
                              float* s_wt, int s, int lo, int hi) {
  const int W = a.W;
  const size_t sw = static_cast<size_t>(s) * W;
  block_exclusive_scan(a.tot + sw, W, s_next, s_part);
  if (blockIdx.x == 0) {
    for (int w = threadIdx.x; w < W; w += kThreads) a.start[sw + w] = s_next[w];
  }
  if (lo >= hi) return;  // uniform across the block
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += kThreads) {
    s_next[w] += __ldcg(a.cnt + (sw + w) * gridDim.x + blockIdx.x);
  }
  const size_t base_row = static_cast<size_t>(s) * a.Fl;
  float* sorted = a.sorted + base_row;
  const unsigned lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  for (int p0 = lo; p0 < hi; p0 += kPiece) {
    const int n = min(kPiece, hi - p0);
    __syncthreads();  // cursors ready, or the previous piece scattered
    for (int k = threadIdx.x; k < n; k += kThreads) {
      s_tgt[k] = __ldcg(a.tgt + base_row + p0 + k);
      s_wt[k] = __ldcg(a.wt + base_row + p0 + k);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int base = 0; base < n; base += 32) {
        const int k = base + static_cast<int>(lane);
        const int w0 = k < n ? s_tgt[k] : -1;
        const bool valid = w0 >= 0;
        // padding rows and lanes past the end get keys no row has
        const int w = valid ? w0 : -1 - static_cast<int>(lane);
        const unsigned peers = __match_any_sync(0xffffffffu, w);
        const int pos = valid ? s_next[w] + __popc(peers & below) : 0;
        __syncwarp();
        if (valid) {
          sorted[pos] = s_wt[k];
          if ((peers & below) == 0) s_next[w] += __popc(peers);
        }
        __syncwarp();
      }
    }
  }
}

// a bucket of n values added front to back by one warp (K1's serial chain
// through shuffles): the lanes load 256 values at a time and every lane
// runs the same chain over them, so the order is the bucket's
__device__ __forceinline__ float bucket_sum(const float* p, int n, int lane) {
  float sum = 0.f;
  for (int base = 0; base < n; base += 256) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int j = base + 32 * k + lane;
      v[k] = j < n ? __ldcg(p + j) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int left = n - base - 32 * k;  // the same in every lane
      if (left <= 0) break;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const float x = __shfl_sync(0xffffffffu, v[k], t);
        if (t < left) sum = __fadd_rn(sum, x);
      }
    }
  }
  return sum;
}

// one warp per (shard, worker) adds its bucket into part[s][w]
__device__ void bucket_sums(const ShardArgs& a) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int nblocks = gridDim.x * gridDim.y;
  const int block_id = blockIdx.y * gridDim.x + blockIdx.x;
  const int pairs = gridDim.y * a.W;
  for (int q = (threadIdx.x / 32) * nblocks + block_id; q < pairs; q += nblocks * kWarps) {
    const int s = q / a.W;
    const float* p = a.sorted + static_cast<size_t>(s) * a.Fl + __ldcg(a.start + q);
    const float sum = bucket_sum(p, __ldcg(a.tot + q), lane);
    if (lane == 0) a.part[q] = sum;
  }
}

// run mode: one warp per worker adds its bucket of every shard, then the
// shards' sums in shard order (the psum, acc = part[0]; acc = acc +
// part[1]; ...).  The tentative pass leaves the psum in tl; the wave-load
// pass (FINISH) adds it to the load and puts the wave's span, the largest
// wave load / threads over running workers (0 where not running), into
// spans[wi]: a max is exact in any order, and non-negative floats order as
// their bit patterns, so an integer atomicMax takes it across the blocks
template <bool FINISH>
__device__ void shard_order_sums(const ShardArgs& a, int wi, float* s_max) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int nblocks = gridDim.x * gridDim.y;
  const int block_id = blockIdx.y * gridDim.x + blockIdx.x;
  const int S = gridDim.y;
  float m = 0.f;  // every span term is >= 0
  for (int w = (threadIdx.x / 32) * nblocks + block_id; w < a.W; w += nblocks * kWarps) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t q = static_cast<size_t>(s) * a.W + w;
      const float* p = a.sorted + static_cast<size_t>(s) * a.Fl + __ldcg(a.start + q);
      const float sum = bucket_sum(p, __ldcg(a.tot + q), lane);
      acc = s == 0 ? sum : __fadd_rn(acc, sum);
    }
    if (lane == 0) {
      if (FINISH) {
        a.load[w] = __fadd_rn(__ldcg(a.load + w), acc);
        m = fmaxf(m, a.running[w] ? __fmul_rn(acc, a.inv_t[w]) : 0.f);
      } else {
        a.tl[w] = acc;
      }
    }
  }
  if (FINISH) {
    if (lane == 0) s_max[threadIdx.x / 32] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 1; k < kWarps; ++k) m = fmaxf(m, s_max[k]);
      atomicMax(reinterpret_cast<int*>(a.spans + wi), __float_as_int(m));
    }
  }
}

template <bool UNIFORM, bool CONTEND>
__global__ void __launch_bounds__(kThreads, 1) place_shard_kernel(ShardArgs a, Wave wv) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned long long smem[];
  // [P] the sort buffer, then (as [W] i32) counts and bucket cursors
  unsigned long long* s_sort = smem;
  int* s_work = reinterpret_cast<int*>(smem);
  int* s_order = reinterpret_cast<int*>(smem + pow2_at_least(a.W));  // [W] spread order
  __shared__ int s_part[kThreads / 32];
  __shared__ int s_tgt[kPiece];
  __shared__ float s_wt[kPiece];
  const int s = blockIdx.y;
  const int G = gridDim.x;
  const int chunk = max(((a.Fl + G - 1) / G + 31) / 32 * 32, 32);
  const int nb = (a.Fl + chunk - 1) / chunk;
  const int lo = min(static_cast<int>(blockIdx.x) * chunk, a.Fl);
  const int hi = min(lo + chunk, a.Fl);

  if (CONTEND) {
    for (int j = lo + threadIdx.x; j < hi; j += kThreads) contend<UNIFORM, false>(a, wv, s, j, 0);
  } else {
    block_rank(a, s_sort, s_order);
    const int block = max((wv.f + a.w_run - 1) / a.w_run, 1);
    for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
      tentative<UNIFORM>(a, wv, s_order, s, j, block);
    }
  }
  __syncthreads();  // s_order is read above; s_work overlays the sort buffer only
  count_chunk(a, s_work, s, lo, hi);
  grid.sync();
  chunk_offsets(a, nb);
  grid.sync();
  scatter_chunk(a, s_work, s_part, s_tgt, s_wt, s, lo, hi);
  grid.sync();
  bucket_sums(a);
}

// run mode: the K waves of a fused run; table = [offs | fs | widxs], K each
template <bool UNIFORM>
__global__ void __launch_bounds__(kThreads, 1) place_shard_run_kernel(ShardArgs a,
                                                                      const int* table) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_sort = smem;
  int* s_work = reinterpret_cast<int*>(smem);
  int* s_order = reinterpret_cast<int*>(smem + pow2_at_least(a.W));
  __shared__ int s_part[kThreads / 32];
  __shared__ float s_max[kThreads / 32];
  __shared__ int s_tgt[kPiece];
  __shared__ float s_wt[kPiece];
  const int s = blockIdx.y;
  const int G = gridDim.x;
  const int chunk = max(((a.Fl + G - 1) / G + 31) / 32 * 32, 32);
  const int nb = (a.Fl + chunk - 1) / chunk;
  const int lo = min(static_cast<int>(blockIdx.x) * chunk, a.Fl);
  const int hi = min(lo + chunk, a.Fl);

  for (int k = 0; k < a.K; ++k) {
    const Wave wv{k, __ldg(table + a.K + k)};
    if (wv.f == 0) continue;  // a padding wave: the same in every block
    const int offset = __ldg(table + k);
    const int wi = __ldg(table + 2 * a.K + k);
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) a.spans[wi] = 0.f;
    block_rank(a, s_sort, s_order);
    const int block = max((wv.f + a.w_run - 1) / a.w_run, 1);
    for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
      tentative<UNIFORM>(a, wv, s_order, s, j, block);
    }
    __syncthreads();
    count_chunk(a, s_work, s, lo, hi);
    grid.sync();
    chunk_offsets(a, nb);
    grid.sync();
    scatter_chunk(a, s_work, s_part, s_tgt, s_wt, s, lo, hi);
    grid.sync();
    shard_order_sums<false>(a, wi, s_max);
    grid.sync();
    for (int j = lo + threadIdx.x; j < hi; j += kThreads) {
      contend<UNIFORM, true>(a, wv, s, j, offset);
    }
    __syncthreads();
    count_chunk(a, s_work, s, lo, hi);
    grid.sync();
    chunk_offsets(a, nb);
    grid.sync();
    scatter_chunk(a, s_work, s_part, s_tgt, s_wt, s, lo, hi);
    grid.sync();
    shard_order_sums<true>(a, wi, s_max);
    grid.sync();
  }
}

size_t smem_bytes(int W) {
  return sizeof(unsigned long long) * pow2_at_least(W) + sizeof(int) * static_cast<size_t>(W);
}

constexpr int kMaxWorkers = 8192;  // ops/leveled.py MAX_WORKERS_CUDA
constexpr int kVariants = 6;       // step A/B and run, each uniform or not

const void* variant(int i) {
  switch (i) {
    case 0: return reinterpret_cast<const void*>(place_shard_kernel<false, false>);
    case 1: return reinterpret_cast<const void*>(place_shard_kernel<false, true>);
    case 2: return reinterpret_cast<const void*>(place_shard_kernel<true, false>);
    case 3: return reinterpret_cast<const void*>(place_shard_kernel<true, true>);
    case 4: return reinterpret_cast<const void*>(place_shard_run_kernel<false>);
    default: return reinterpret_cast<const void*>(place_shard_run_kernel<true>);
  }
}

ShardArgs shard_args(const void* dur16, const void* heavy, const void* heavy2, const void* xp16,
                     const void* xp2_16, const void* xa16, const void* shard_ids, void* assign,
                     void* load, const void* inv_t, const void* running, const void* ovt0,
                     void* tl, void* tgt, void* wt, void* spread, void* sorted, void* cnt,
                     void* start, void* tot, int W, int K, int Fl, int w_run, float ovt_c,
                     float inv_c) {
  ShardArgs a = {};
  a.dur16 = static_cast<const __half*>(dur16);
  a.heavy = static_cast<const int*>(heavy);
  a.heavy2 = static_cast<const int*>(heavy2);
  a.xp16 = static_cast<const __half*>(xp16);
  a.xp2_16 = static_cast<const __half*>(xp2_16);
  a.xa16 = static_cast<const __half*>(xa16);
  a.shard_ids = static_cast<const int*>(shard_ids);
  a.assign = static_cast<int*>(assign);
  a.load = static_cast<float*>(load);
  a.inv_t = static_cast<const float*>(inv_t);
  a.running = static_cast<const uint8_t*>(running);
  a.ovt0 = static_cast<const float*>(ovt0);
  a.tl = static_cast<float*>(tl);
  a.tgt = static_cast<int*>(tgt);
  a.wt = static_cast<float*>(wt);
  a.spread = static_cast<int*>(spread);
  a.sorted = static_cast<float*>(sorted);
  a.cnt = static_cast<int*>(cnt);
  a.start = static_cast<int*>(start);
  a.tot = static_cast<int*>(tot);
  a.W = W;
  a.K = K;
  a.Fl = Fl;
  a.w_run = w_run;
  a.ovt_c = ovt_c;
  a.inv_c = inv_c;
  return a;
}

cudaError_t launch(const void* kernel, ShardArgs* a, void* extra, int bx, int S, int W,
                   void* stream_ptr) {
  void* args[] = {a, extra};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(bx, S), dim3(kThreads), args,
                                                smem_bytes(W),
                                                static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// the setup of every launch on the current device: each variant's dynamic
// shared memory limit (set once here, for the most workers a launch takes,
// not at each launch) and the blocks per shard of a launch holding S shards
// of W workers: the grid (bx, S) must be resident at once for its grid
// barriers, so bx * S never exceeds one block per SM of the smallest
// occupancy of the six variants
extern "C" int dtpu_place_shard_grid(int W, int S, int* bx) {
  if (W <= 0 || W > kMaxWorkers || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const size_t smem = smem_bytes(W);
  int occ = 1;
  for (int i = 0; i < kVariants; ++i) {
    const void* kernel = variant(i);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(kMaxWorkers)));
    int o = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o, kernel, kThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    occ = min(occ, o);
  }
  if (occ < 1 || S > sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *bx = sms / S;
  return static_cast<int>(cudaSuccess);
}

// step mode: one launch (A: contend = 0, B: contend = 1) of wave slot k of
// a fused run for the S shards of this device.  Tiles are [S][K][Fl] in the
// f16 wire; shard_ids i32[S]; assign i32[Tp]; load, inv_t, ovt0, tl f32[W];
// running u8[W]; scratch tgt/wt/spread/sorted [S][Fl], cnt [S][W][bx],
// start/tot [S][W]; out part f32[S][W], aslice/cslice i32[S][Fl] (launch
// B).  W <= 8192; bx from dtpu_place_shard_grid, called first.
extern "C" int dtpu_place_shard(
    const void* dur16, const void* heavy, const void* heavy2, const void* xp16,
    const void* xp2_16, const void* xa16, const void* shard_ids, const void* assign,
    const void* load, const void* inv_t, const void* running, const void* ovt0, const void* tl,
    void* tgt, void* wt, void* spread, void* sorted, void* cnt, void* start, void* tot,
    void* part, void* aslice, void* cslice, int W, int S, int K, int Fl, int k, int f,
    int w_run, int uniform, int contend, int bx, float ovt_c, float inv_c, void* stream_ptr) {
  if (W <= 0 || W > kMaxWorkers || S <= 0 || K <= 0 || Fl <= 0 || k < 0 || k >= K || f < 0 ||
      w_run <= 0 || bx <= 0 || (contend && tl == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // launch A only reads the assignment and the load; tl is launch B's input
  ShardArgs a = shard_args(dur16, heavy, heavy2, xp16, xp2_16, xa16, shard_ids,
                           const_cast<void*>(assign), const_cast<void*>(load), inv_t, running,
                           ovt0, const_cast<void*>(tl), tgt, wt, spread, sorted, cnt, start, tot,
                           W, K, Fl, w_run, ovt_c, inv_c);
  a.part = static_cast<float*>(part);
  a.aslice = static_cast<int*>(aslice);
  a.cslice = static_cast<int*>(cslice);
  Wave wv{k, f};
  return static_cast<int>(launch(variant(2 * (uniform != 0) + (contend != 0)), &a, &wv, bx, S,
                                 W, stream_ptr));
}

// run mode: every wave of a fused run in one launch, for the S shards of
// this device, which must be every shard of the mesh in shard order
// (shard_ids[s] = s), so that the psums and the slice writes cover them
// all.  table i32[3][K]: each wave slot's offset, true size (0: a padding
// wave, skipped) and span slot.  assign, choices i32[Tp], load f32[W] and
// spans f32[Lp] are the replicated carry, updated in place; tl f32[W] is
// scratch; the rest as dtpu_place_shard.
extern "C" int dtpu_place_shard_run(
    const void* dur16, const void* heavy, const void* heavy2, const void* xp16,
    const void* xp2_16, const void* xa16, const void* shard_ids, const void* table,
    void* assign, void* choices, void* load, void* spans, const void* inv_t,
    const void* running, const void* ovt0, void* tl, void* tgt, void* wt, void* spread,
    void* sorted, void* cnt, void* start, void* tot, int W, int S, int K, int Fl, int w_run,
    int uniform, int bx, float ovt_c, float inv_c, void* stream_ptr) {
  if (W <= 0 || W > kMaxWorkers || S <= 0 || K <= 0 || Fl <= 0 || w_run <= 0 || bx <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ShardArgs a = shard_args(dur16, heavy, heavy2, xp16, xp2_16, xa16, shard_ids, assign, load,
                           inv_t, running, ovt0, tl, tgt, wt, spread, sorted, cnt, start, tot,
                           W, K, Fl, w_run, ovt_c, inv_c);
  a.choices = static_cast<int*>(choices);
  a.spans = static_cast<float*>(spans);
  const int* tab = static_cast<const int*>(table);
  return static_cast<int>(launch(variant(4 + (uniform != 0)), &a, &tab, bx, S, W, stream_ptr));
}
