// The waves of the level-synchronous placement engine (kernel K1).
//
// Replaces distributed_tpu/ops/leveled.py::_place_run (its per-wave body
// run_wave, leveled.py:376-506), the XLA program the TPU engine runs for
// every fused group of waves.  The plain version beside it is
// ops/leveled.py::place_wave_reference.
//
// What a wave computes, for the f tasks [offset, offset+f) of one
// topological level, against W workers:
//   1. a stable ascending order of the workers by load / threads (stopped
//      workers last), so task i's spread candidate is
//      order[min(i / block, W-1)] with block = ceil(f / running workers);
//   2. three candidates per task (holder of the heaviest dep, of the
//      second heaviest, the spread slot), the cheapest by queue + transfer
//      cost, and that choice's work summed per worker (tentative load);
//   3. one Jacobi contention round: the costs again with the tentative
//      load folded in (minus the task's own share), the final choice, and
//      its work summed per worker;
//   4. load += wave load, and the wave's span max(wave_load / threads).
//
// The wire comes in the reference's two formats (its _place_run fmt):
// "f16", 16 B/task (i32 heavy pair, f16 duration and three f16 transfer
// costs), and "packed", 11 B/task (leveled.py:379-393): the heavy pair
// bit-packed into an i32 (heavy+1 in the low 21 bits, the low 11 bits of
// heavy2+1 above) and a u16 (the high 10 bits of heavy2+1), the duration
// in f16 and the three costs as u8 log codes.  load_task is the one place
// that reads the wire; it decodes the codes through a 256-entry f32 table
// that the host computes once and the plain version reads too, so the
// kernel still equals the plain version on the CPU bit for bit.
//
// Bound on an H100: bytes.  A task reads its 16 B (or 11 B) of wire and
// writes 8 B; at 1M tasks that is about 24 MB, ~7 us at 3.35 TB/s, while the
// arithmetic is a few dozen flops a task.  But the waves form a chain:
// each needs the load the previous one left, and inside a wave the sums
// of step 2 feed step 3.  A launch per step (12 a wave) made the chain
// of launches the cost, so one cooperative launch runs all waves of a
// graph, one block per SM, and grid-wide barriers separate the phases
// that depend on each other (8 a wave):
//
//   rank + tentative + counts | chunk offsets | scatter | sums (tentative
//   load) | contend + counts | chunk offsets | scatter | sums, load, span
//
// Every block sorts the W worker keys itself in shared memory (W <= 8192,
// a bitonic sort of (key, index) pairs, so ties go by index as in a
// stable argsort), so the spread lookup needs no barrier and no global
// order.  A block's tasks
// are its bucketing chunk, so it counts them per worker while choosing.
//
// The per-worker sums of steps 2 and 3 are the one place where a parallel
// order would change the result: a float sum rounds differently in
// another order, and a near-tie in a later wave's worker order then
// flips a whole spread block.  So they are computed in task order, as a
// sequential index_add_ on the CPU and the reference's segment_sum do:
// each task's (worker, work) pair is bucketed by worker with a stable
// counting sort (per-chunk counts, per-worker offsets over the chunks in
// order, a warp-serial scatter that keeps task order inside each bucket),
// and one warp per worker then adds its bucket front to back.  Every
// other product that feeds a sum is written with __fmul_rn/__fadd_rn so
// that nvcc does not contract it into an FMA.  With both, the kernel
// reproduces the plain version on the CPU bit for bit, and every run
// gives the same result.  Data written inside the launch is read with
// __ldcg (L2), never through the non-coherent read-only path.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 1;  // fewer blocks make a cheaper grid barrier
constexpr int kPiece = 2 * kThreads;  // tasks a scatter stages in shared memory at once
constexpr int kStamps = 9;            // timeline entries a wave: its start and 8 barriers

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

struct Task {
  float dur, xp, xp2, xa;
  int p, p2, spread;
  bool ok1, ok2;
};

struct WavesArgs {
  const __half* dur16;
  const int* heavy;        // f16 wire: the heaviest dep; packed: the pair's low word
  const int* heavy2;       // f16 wire only
  const uint16_t* heavy2_hi;  // packed wire only: the pair's high bits
  const __half* xp16;      // f16 wire only, as the next two
  const __half* xp2_16;
  const __half* xa16;
  const uint8_t* xp8;      // packed wire only: u8 log codes, as the next two
  const uint8_t* xp2_8;
  const uint8_t* xa8;
  const float* cost_table;  // packed wire: f32[256] decode of the codes; null: f16 wire
  int* assign;
  int* choices;
  float* load;
  float* spans;
  const float* inv_t;
  const uint8_t* running;
  const float* ovt0;
  const int* offsets;  // [n_levels + 1] wave w = sorted rows [offsets[w], offsets[w+1])
  float* tl;           // [W] tentative wave load
  float* wave_load;    // [W]
  int* tgt;            // [F] per task of the wave: the worker its work is summed on
  float* wt;           // [F] ... and that work
  float* sorted;       // [F] work bucketed by worker, task order kept
  int* cnt;            // [W][grid] per-chunk counts, then offsets inside the bucket
  int* start;          // [W] bucket starts
  int* tot;            // [W] bucket sizes
  // optional timeline, [last - first][kStamps] of %globaltimer (ns) taken
  // by block 0 at the start of each wave and after each grid barrier
  unsigned long long* stamps;
  int W, first, last, w_run;
  float ovt_c, inv_c;
};

__device__ __forceinline__ Task load_task(const WavesArgs& a, const int* s_order,
                                          int offset, int i, int block) {
  const int g = offset + i;
  Task t;
  t.dur = __half2float(a.dur16[g]);
  int h, h2;
  if (a.cost_table == nullptr) {
    t.xp = __half2float(a.xp16[g]);
    t.xp2 = __half2float(a.xp2_16[g]);
    t.xa = __half2float(a.xa16[g]);
    h = a.heavy[g];
    h2 = a.heavy2[g];
  } else {
    const unsigned v = static_cast<unsigned>(a.heavy[g]);
    const unsigned hi = a.heavy2_hi[g];
    h = static_cast<int>(v & 0x1FFFFFu) - 1;
    h2 = static_cast<int>(((v >> 21) & 0x7FFu) | (hi << 11)) - 1;
    t.xp = __ldg(a.cost_table + a.xp8[g]);
    t.xp2 = __ldg(a.cost_table + a.xp2_8[g]);
    t.xa = __ldg(a.cost_table + a.xa8[g]);
  }
  // heavy deps sit in earlier levels: their assignment is final
  const int pref = h >= 0 ? __ldcg(a.assign + h) : -1;
  const int pref2 = h2 >= 0 ? __ldcg(a.assign + h2) : -1;
  t.p = max(pref, 0);
  t.p2 = max(pref2, 0);
  t.ok1 = pref >= 0;
  t.ok2 = pref2 >= 0 && pref2 != pref;
  t.spread = s_order[min(i / block, a.W - 1)];
  return t;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 32;
  while (p < n) p *= 2;
  return p;
}

// stable ascending order of the W keys, ties by index, into s_order: a
// bitonic sort of (key, index) pairs packed into one u64 each, so every
// pair is distinct and the sort order is the stable one.  The key is
// made non-negative-zero first and mapped to an unsigned order-preserving
// code; the sort runs over pow2_at_least(W) entries, padded with the
// largest.  Up to kThreads entries each thread holds one in a register
// and exchanges through shuffles inside a warp and through s_sort across
// warps; beyond that every exchange goes through s_sort.
__device__ __forceinline__ unsigned long long rank_entry(const WavesArgs& a, int w) {
  if (w >= a.W) return ~0ull;
  const float key = a.running[w] ? __fmul_rn(__ldcg(a.load + w), a.inv_t[w]) + 0.f : INFINITY;
  const unsigned u = __float_as_uint(key);
  const unsigned code = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(code) << 32) | static_cast<unsigned>(w);
}

__device__ void block_rank(const WavesArgs& a, unsigned long long* s_sort, int* s_order) {
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
        // the lower index of a pair keeps the min in an ascending run
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

// step 2 for task i: the first choice, as the reference's c0/c1/c2
template <bool UNIFORM>
__device__ __forceinline__ void tentative(const WavesArgs& a, const Task& t, int i) {
  float c0, c1, c2;
  if (UNIFORM) {
    c0 = t.ok1 ? t.xp + a.ovt_c : INFINITY;
    c1 = t.ok2 ? t.xp2 + a.ovt_c : INFINITY;
    c2 = t.xa + a.ovt_c;
  } else {
    c0 = t.ok1 ? a.ovt0[t.p] + t.xp : INFINITY;
    c1 = t.ok2 ? a.ovt0[t.p2] + t.xp2 : INFINITY;
    c2 = a.ovt0[t.spread] + t.xa;
  }
  const int ch = argmin3(c0, c1, c2);
  a.tgt[i] = sel3(ch, t.p, t.p2, t.spread);
  a.wt[i] = t.dur + sel3(ch, t.xp, t.xp2, t.xa);
}

// step 3 for task i: contention round against the tentative load, final choice
template <bool UNIFORM>
__device__ __forceinline__ void contend(const WavesArgs& a, const Task& t, int offset, int i) {
  const int tent = __ldcg(a.tgt + i);
  const float tw = __ldcg(a.wt + i);
  const float tl_p = __ldcg(a.tl + t.p);
  const float tl_p2 = __ldcg(a.tl + t.p2);
  const float tl_s = __ldcg(a.tl + t.spread);
  float d0, d1, d2;
  if (UNIFORM) {
    const float corr = __fmul_rn(tw, a.inv_c);
    const float q0 = __fmul_rn(tl_p, a.inv_c);
    const float q1 = __fmul_rn(tl_p2, a.inv_c);
    const float q2 = __fmul_rn(tl_s, a.inv_c);
    d0 = t.ok1 ? ((q0 - (t.p == tent ? corr : 0.f)) + t.xp) + a.ovt_c : INFINITY;
    d1 = t.ok2 ? ((q1 - (t.p2 == tent ? corr : 0.f)) + t.xp2) + a.ovt_c : INFINITY;
    d2 = ((q2 - (t.spread == tent ? corr : 0.f)) + t.xa) + a.ovt_c;
  } else {
    const float corr = __fmul_rn(tw, a.inv_t[tent]);
    const float s0 = __fadd_rn(a.ovt0[t.p], __fmul_rn(tl_p, a.inv_t[t.p]));
    const float s1 = __fadd_rn(a.ovt0[t.p2], __fmul_rn(tl_p2, a.inv_t[t.p2]));
    const float s2 = __fadd_rn(a.ovt0[t.spread], __fmul_rn(tl_s, a.inv_t[t.spread]));
    d0 = t.ok1 ? (s0 - (t.p == tent ? corr : 0.f)) + t.xp : INFINITY;
    d1 = t.ok2 ? (s1 - (t.p2 == tent ? corr : 0.f)) + t.xp2 : INFINITY;
    d2 = (s2 - (t.spread == tent ? corr : 0.f)) + t.xa;
  }
  const int ch = argmin3(d0, d1, d2);
  const int w = sel3(ch, t.p, t.p2, t.spread);
  a.assign[offset + i] = w;
  a.choices[offset + i] = ch;
  a.tgt[i] = w;
  a.wt[i] = t.dur + sel3(ch, t.xp, t.xp2, t.xa);
}

// this block's chunk [lo, hi): how many of its tasks go to each worker
// -> cnt[w][chunk]
__device__ void count_chunk(const WavesArgs& a, int* s_cnt, int lo, int hi) {
  const int W = a.W;
  for (int w = threadIdx.x; w < W; w += kThreads) s_cnt[w] = 0;
  __syncthreads();
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) atomicAdd(&s_cnt[__ldcg(a.tgt + i)], 1);
  __syncthreads();
  if (lo < hi) {
    for (int w = threadIdx.x; w < W; w += kThreads) {
      a.cnt[static_cast<size_t>(w) * gridDim.x + blockIdx.x] = s_cnt[w];
    }
  }
}

// one warp per worker: cnt[w][c] becomes the offset of chunk c inside
// worker w's bucket, tot[w] the bucket's size
__device__ void chunk_offsets(const WavesArgs& a, int nb) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kThreads / 32;
  const int per = (nb + 31) / 32;
  for (int w = (blockIdx.x * kThreads + threadIdx.x) / 32; w < a.W; w += warps) {
    int* row = a.cnt + static_cast<size_t>(w) * gridDim.x;
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
    if (lane == 31) a.tot[w] = inc;
  }
}

// s_out[w] = sum of tot[0..w), by the whole block: a contiguous run of
// workers per thread, a shuffle scan inside each warp, then over the warps
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

// bucket starts, then the chunk in pieces: the block stages a piece's
// (worker, work) pairs in shared memory, and warp 0 scatters them 32 at a
// time in order, each task's work to the next free slot of its worker's
// bucket, so a bucket holds its tasks in task order
__device__ void scatter_chunk(const WavesArgs& a, int* s_next, int* s_part, int* s_tgt,
                              float* s_wt, int lo, int hi) {
  const int W = a.W;
  block_exclusive_scan(a.tot, W, s_next, s_part);
  if (blockIdx.x == 0) {
    for (int w = threadIdx.x; w < W; w += kThreads) a.start[w] = s_next[w];
  }
  if (lo >= hi) return;  // uniform across the block
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += kThreads) {
    s_next[w] += __ldcg(a.cnt + static_cast<size_t>(w) * gridDim.x + blockIdx.x);
  }
  const unsigned lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  for (int p0 = lo; p0 < hi; p0 += kPiece) {
    const int n = min(kPiece, hi - p0);
    __syncthreads();  // cursors ready, or the previous piece scattered
    for (int k = threadIdx.x; k < n; k += kThreads) {
      s_tgt[k] = __ldcg(a.tgt + p0 + k);
      s_wt[k] = __ldcg(a.wt + p0 + k);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int base = 0; base < n; base += 32) {
        const int k = base + static_cast<int>(lane);
        const bool valid = k < n;
        // lanes past the end get keys no task has, so they match no one
        const int w = valid ? s_tgt[k] : -1 - static_cast<int>(lane);
        const unsigned peers = __match_any_sync(0xffffffffu, w);
        const int pos = valid ? s_next[w] + __popc(peers & below) : 0;
        __syncwarp();
        if (valid) {
          a.sorted[pos] = s_wt[k];
          if ((peers & below) == 0) s_next[w] += __popc(peers);
        }
        __syncwarp();
      }
    }
  }
}

// one warp per worker (spread over the blocks) adds its bucket front to
// back: the lanes load 256 values at a time, and every lane runs the
// same serial chain of adds over them through shuffles, so the order is
// the bucket's.  The last round also does load += wave_load and the
// wave's span.
template <bool FINISH>
__device__ void bucket_sums(const WavesArgs& a, float* out, int wave, float* s_max) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  float m = 0.f;  // every span term is >= 0
  for (int w = (threadIdx.x / 32) * gridDim.x + blockIdx.x; w < a.W; w += gridDim.x * kWarps) {
    const float* p = a.sorted + __ldcg(a.start + w);
    const int n = __ldcg(a.tot + w);
    float s = 0.f;
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
          if (t < left) s = __fadd_rn(s, x);
        }
      }
    }
    if (lane == 0) {
      out[w] = s;
      if (FINISH) {
        a.load[w] = __fadd_rn(__ldcg(a.load + w), s);
        m = fmaxf(m, a.running[w] ? __fmul_rn(s, a.inv_t[w]) : 0.f);
      }
    }
  }
  if (FINISH) {
    if (lane == 0) s_max[threadIdx.x / 32] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 1; k < kThreads / 32; ++k) m = fmaxf(m, s_max[k]);
      // non-negative floats order as their bit patterns
      atomicMax(reinterpret_cast<int*>(a.spans + wave), __float_as_int(m));
    }
  }
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

template <bool UNIFORM>
__global__ void __launch_bounds__(kThreads, 1) place_waves_kernel(WavesArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ unsigned long long smem[];
  // [P] the rank's sort buffer, then (as [W] i32) counts and bucket cursors
  unsigned long long* s_sort = smem;
  int* s_work = reinterpret_cast<int*>(smem);
  int* s_order = reinterpret_cast<int*>(smem + pow2_at_least(a.W));  // [W] spread order
  __shared__ int s_part[kThreads / 32];
  __shared__ float s_max[kThreads / 32];
  __shared__ int s_tgt[kPiece];
  __shared__ float s_wt[kPiece];
  const int G = gridDim.x;
  unsigned long long* stamp = nullptr;
  auto sync = [&](int k) {
    grid.sync();
    if (stamp != nullptr) stamp[k] = globaltimer();
  };

  for (int wave = a.first; wave < a.last; ++wave) {
    const int offset = a.offsets[wave];
    const int f = a.offsets[wave + 1] - offset;
    const int block = max((f + a.w_run - 1) / a.w_run, 1);
    const int chunk = max(((f + G - 1) / G + 31) / 32 * 32, 32);
    const int nb = (f + chunk - 1) / chunk;
    const int lo = min(static_cast<int>(blockIdx.x) * chunk, f);
    const int hi = min(lo + chunk, f);
    if (a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      stamp = a.stamps + static_cast<size_t>(wave - a.first) * kStamps;
      stamp[0] = globaltimer();
    }

    block_rank(a, s_sort, s_order);
    if (blockIdx.x == 0 && threadIdx.x == 0) a.spans[wave] = 0.f;
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      tentative<UNIFORM>(a, load_task(a, s_order, offset, i, block), i);
    }
    count_chunk(a, s_work, lo, hi);
    sync(1);
    chunk_offsets(a, nb);
    sync(2);
    scatter_chunk(a, s_work, s_part, s_tgt, s_wt, lo, hi);
    sync(3);
    bucket_sums<false>(a, a.tl, wave, s_max);
    sync(4);
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      contend<UNIFORM>(a, load_task(a, s_order, offset, i, block), offset, i);
    }
    count_chunk(a, s_work, lo, hi);
    sync(5);
    chunk_offsets(a, nb);
    sync(6);
    scatter_chunk(a, s_work, s_part, s_tgt, s_wt, lo, hi);
    sync(7);
    bucket_sums<true>(a, a.wave_load, wave, s_max);
    sync(8);
  }
}

size_t smem_bytes(int W) {
  return sizeof(unsigned long long) * pow2_at_least(W) + sizeof(int) * static_cast<size_t>(W);
}

template <bool UNIFORM>
cudaError_t max_blocks(int W, int* blocks) {
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  auto kernel = place_waves_kernel<UNIFORM>;
  const size_t smem = smem_bytes(W);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * (occ < kBlocksPerSm ? occ : kBlocksPerSm);
  return cudaSuccess;
}

}  // namespace

// the grid of the cooperative launch for W workers: one block per SM,
// never more than can be resident at once (or grid.sync() would hang)
extern "C" int dtpu_place_waves_grid(int W, int uniform, int* blocks) {
  if (W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(uniform ? max_blocks<true>(W, blocks) : max_blocks<false>(W, blocks));
}

// waves [first, last) of a graph in one cooperative launch of `blocks`
// blocks (from dtpu_place_waves_grid).  The wire format: cost_table null
// means the f16 wire (dur16 heavy heavy2 xp16 xp2_16 xa16 as named);
// otherwise the packed wire, read as dur16, the pair's i32 low word in
// heavy, its u16 high bits in heavy2, u8 codes in xp16/xp2_16/xa16, and
// cost_table the f32[256] decode of the codes.  W <= 8192 (a u64 and an i32 per
// worker in shared memory); offsets i32 [n_levels + 1] on the device; scratch:
// tl/wave_load/start/tot [W], tgt/wt/sorted [widest wave], cnt [W * blocks];
// stamps: null, or u64 [(last - first) * 9] for the phase timeline
extern "C" int dtpu_place_waves(
    const void* dur16, const void* heavy, const void* heavy2, const void* xp16,
    const void* xp2_16, const void* xa16, const void* cost_table, void* assign,
    void* choices, void* load, void* spans, const void* inv_t, const void* running,
    const void* ovt0,
    const void* offsets, void* tl, void* wave_load, void* tgt, void* wt, void* sorted,
    void* cnt, void* start, void* tot, void* stamps, int W, int first, int last,
    int w_run, int uniform, int blocks, float ovt_c, float inv_c, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (W <= 0 || first < 0 || last < first || w_run <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (first == last) return static_cast<int>(cudaSuccess);
  WavesArgs a;
  a.dur16 = static_cast<const __half*>(dur16);
  a.heavy = static_cast<const int*>(heavy);
  a.cost_table = static_cast<const float*>(cost_table);
  const bool packed = cost_table != nullptr;
  a.heavy2 = packed ? nullptr : static_cast<const int*>(heavy2);
  a.heavy2_hi = packed ? static_cast<const uint16_t*>(heavy2) : nullptr;
  a.xp16 = packed ? nullptr : static_cast<const __half*>(xp16);
  a.xp2_16 = packed ? nullptr : static_cast<const __half*>(xp2_16);
  a.xa16 = packed ? nullptr : static_cast<const __half*>(xa16);
  a.xp8 = packed ? static_cast<const uint8_t*>(xp16) : nullptr;
  a.xp2_8 = packed ? static_cast<const uint8_t*>(xp2_16) : nullptr;
  a.xa8 = packed ? static_cast<const uint8_t*>(xa16) : nullptr;
  a.assign = static_cast<int*>(assign);
  a.choices = static_cast<int*>(choices);
  a.load = static_cast<float*>(load);
  a.spans = static_cast<float*>(spans);
  a.inv_t = static_cast<const float*>(inv_t);
  a.running = static_cast<const uint8_t*>(running);
  a.ovt0 = static_cast<const float*>(ovt0);
  a.offsets = static_cast<const int*>(offsets);
  a.tl = static_cast<float*>(tl);
  a.wave_load = static_cast<float*>(wave_load);
  a.tgt = static_cast<int*>(tgt);
  a.wt = static_cast<float*>(wt);
  a.sorted = static_cast<float*>(sorted);
  a.cnt = static_cast<int*>(cnt);
  a.start = static_cast<int*>(start);
  a.tot = static_cast<int*>(tot);
  a.stamps = static_cast<unsigned long long*>(stamps);
  a.W = W;
  a.first = first;
  a.last = last;
  a.w_run = w_run;
  a.ovt_c = ovt_c;
  a.inv_c = inv_c;
  const void* kernel = uniform ? reinterpret_cast<const void*>(place_waves_kernel<true>)
                               : reinterpret_cast<const void*>(place_waves_kernel<false>);
  const size_t smem = smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
