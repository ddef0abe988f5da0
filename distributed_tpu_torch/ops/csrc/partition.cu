// Label propagation of the graph partitioner (kernel K4).
//
// Replaces distributed_tpu/ops/partition.py::partition_jax's jitted `run`
// (partition.py:271-289), the XLA program the scheduler's plan path runs
// for every batch whose dense [T, W] score matrix fits.  The plain version
// beside it is ops/partition.py::partition_reference.
//
// What a round computes, for T tasks and W lanes, from the round's old
// labels:
//   1. load[w] = the durations of the tasks on lane w, added in task order,
//      and blocked[w] = load[w] >= cap * avg_load;
//   2. for every task i of the round's parity ((i + round) % 2 == 0) its
//      score row: for each in-edge e (dst[e] == i) in edge order, w[e] on
//      the producer's lane, then for each out-edge in edge order, w[e] on
//      the consumer's lane -- the two scatters of the reference restricted
//      to row i; blocked lanes become -inf; the current lane becomes
//      max(its score, 0) + sticky * mean_w; the new label is the first
//      maximum of the row.  The other tasks keep their label.
//
// Why not float atomics: the reference adds each score cell and each lane
// load in a fixed order, and a sum in another order rounds differently, so
// near-ties in the argmax would flip from run to run.  Every sum here runs
// in the reference's order, one chain at a time, and nvcc cannot contract
// a chain of __fadd_rn, so the kernel equals the plain version on the CPU
// bit for bit, repeats itself, and does not depend on its grid.
//
// One cooperative launch runs all rounds; the rounds are Jacobi, so round
// r reads one label buffer and writes the other.  A round:
//   - Load phase, two ways by W.
//     * Up to 64 lanes (the few-lane fleets, where the router sends up to
//       2^20 tasks): a stable counting sort across the grid.  Block b
//       counts its slice of the tasks per lane (per warp, in shared
//       memory); a grid barrier; every block sums the blocks' counts into
//       bucket starts and its own offsets (a [blocks][W] matrix, at most
//       1,056 x 64) and hands each of its tasks the next slot of its
//       lane's bucket in task order; a grid barrier; then a warp a lane
//       adds its bucket front to back, 512 values a load in flight with
//       the next 512 behind them, every lane adding the same chain from
//       shuffles.  Each task is looked at once a round and the chain is
//       the only serial part.  (A block a lane scanning all T labels left
//       16 SMs issue-bound on 16-fold redundant work: 3.7 ms a plan
//       against a 1.1 ms chain.)
//     * More lanes: a warp a lane (grid stride over the lanes) scans the
//       block's shared tile of labels and adds its matches in task order.
//     A grid barrier ends the phase.
//   - Rows phase.  A grid-stride walk over the round's tasks, the unit
//     sized to W: a thread a task up to 32 lanes (its row strided through
//     shared memory, its edges loaded 8 at a time), a warp a task up to
//     1,024 (the warp's share of shared memory), else the block a task (up
//     to the 31,250 lanes the router sends, 125 KB).  One thread adds the
//     edges in edge order; the unit masks, adds the bonus and takes the
//     first maximum (ties to the lowest lane), zeroing the row as it reads
//     it for the next task.  A grid barrier ends every phase but the last.
//
// Bound on an H100: bytes, and tiny (12 B a task and an edge).  The floor
// no design removes is the load sum: a chain of dependent f32 adds as long
// as the fullest lane, every round.  At 16 lanes and 1M tasks that is
// ~65,000 adds a round, ~1.1 ms a plan at 4 cycles an add.  At 1,024
// lanes the phases are short and the 15 grid barriers are a good part of
// the time.
//
// The launch uses the stream it is given, allocates nothing and returns
// cudaGetLastError(); a row too wide for shared memory, or a grid that
// cannot be resident at once, is refused.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;       // enough warps for the rows, a cheap barrier
// load phase: the counting sort up to kBucketLanes lanes, a warp adding
// its lane's bucket kChainBlock values at a time
constexpr int kBucketLanes = 64;
constexpr int kChainBlock = 512;
// load phase, a warp a lane: the block's tile of labels and durations
// (the counting sort's counts use the same shared memory)
constexpr int kTile = kThreads * 16;
constexpr size_t kLoadBytes = 2 * sizeof(int) * kTile;
// rows phase: a thread a task up to kThreadRowLanes, a warp up to kWarpRowLanes
constexpr int kThreadRowLanes = 32;
constexpr int kWarpRowLanes = 1024;
static_assert(sizeof(int) * (kWarps * kBucketLanes + 2 * kThreads + 2 * kBucketLanes) <=
                  kLoadBytes, "the counting sort's shared memory fits the tile's");

struct Args {
  const int* init;       // [T] labels before the first round
  int* lab0;             // [T] rounds 0, 2, ... write here
  int* lab1;             // [T] rounds 1, 3, ...
  const float* durations;  // [T]
  const int* in_off;     // [T+1] in-edges of task i: [in_off[i], in_off[i+1])
  const int* in_nbr;     // [E] their producers, edge order kept
  const float* in_w;     // [E]
  const int* out_off;    // [T+1]
  const int* out_nbr;    // [E] the out-edges' consumers, edge order kept
  const float* out_w;    // [E]
  uint8_t* blocked;      // [W] the lane's load >= thresh, this round
  int* cnt;              // [blocks][W] the counting sort's block counts (W <= kBucketLanes)
  float* sorted;         // [T] durations bucketed by lane, task order kept (W <= kBucketLanes)
  // optional timeline, [2 * iters + 1] of %globaltimer (ns) taken by
  // block 0 at the start and after each phase's grid barrier, or null
  unsigned long long* stamps;
  int T, W, iters;
  float thresh;          // cap * avg_load
  float bonus;           // sticky * mean_w
};

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// shared memory of the rows phase for W lanes
__host__ __device__ constexpr size_t row_bytes(int W) {
  return align16(sizeof(float) * static_cast<size_t>(W) *
                 (W <= kThreadRowLanes ? kThreads : W <= kWarpRowLanes ? kWarps : 1));
}

__host__ __device__ constexpr size_t smem_bytes(int W) {
  return kLoadBytes + row_bytes(W) + align16(static_cast<size_t>(W));
}

// 0 plus src[0..n) in order, by a whole warp: the lanes load kChainBlock
// values at a time, the next kChainBlock in flight behind them, and every
// lane adds all of them in order from shuffles.  Values past n are loaded
// as +0, which leaves the sum unchanged: it starts at +0, so it is never -0
__device__ __forceinline__ float add_bucket(const float* src, int n) {
  constexpr int kV = kChainBlock / 32;
  const int lane = threadIdx.x & 31;
  float v[kV], next[kV];
  auto fetch = [&](float (&x)[kV], int base) {
#pragma unroll
    for (int c = 0; c < kV; ++c) {
      const int k = base + 32 * c + lane;
      x[c] = k < n ? src[k] : 0.f;
    }
  };
  fetch(v, 0);
  float s = 0.f;
  for (int base = 0; base < n; base += kChainBlock) {
    fetch(next, base + kChainBlock);
#pragma unroll
    for (int c = 0; c < kV; ++c) {
#pragma unroll
      for (int t = 0; t < 32; ++t) s = __fadd_rn(s, __shfl_sync(kFull, v[c], t));
    }
#pragma unroll
    for (int c = 0; c < kV; ++c) v[c] = next[c];
  }
  return s;
}

// every lane's load by a stable counting sort across the grid (W <= kBucketLanes)
__device__ void load_by_buckets(const Args& a, const int* cur, unsigned char* smem,
                                cg::grid_group& grid) {
  const int T = a.T, W = a.W, G = gridDim.x, b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* s_cur = reinterpret_cast<int*>(smem);  // [kWarps][W] warp counts, then cursors
  int* s_part = s_cur + kWarps * W;           // [2][kThreads] partial column sums
  int* s_start = s_part + 2 * kThreads;       // [W] bucket starts
  int* s_tot = s_start + W;                   // [W] bucket sizes
  // the block's slice of the tasks, and its warp's part of that
  const int per_block = (T + G - 1) / G;
  const int lo = min(b * per_block, T), hi = min(lo + per_block, T);
  const int per_warp = (hi - lo + kWarps - 1) / kWarps;
  const int wlo = min(lo + warp * per_warp, hi), whi = min(wlo + per_warp, hi);
  int* row = s_cur + warp * W;
  const unsigned below = (1u << lane) - 1u;
  for (int k = threadIdx.x; k < kWarps * W; k += kThreads) s_cur[k] = 0;
  __syncthreads();
  for (int base = wlo; base < whi; base += 32) {
    const int i = base + lane;
    const int l = i < whi ? cur[i] : -1 - lane;  // past the end: keys no task has
    const unsigned peers = __match_any_sync(kFull, l);
    if (i < whi && (peers & below) == 0) atomicAdd(row + l, __popc(peers));
  }
  __syncthreads();
  for (int l = threadIdx.x; l < W; l += kThreads) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += s_cur[w * W + l];
    a.cnt[b * W + l] = c;
  }
  grid.sync();
  // each lane's bucket size, and the tasks of earlier blocks on it:
  // kThreads / W threads a lane sum strided columns of the counts
  const int parts = kThreads / W;
  {
    const int l = threadIdx.x % W, p = threadIdx.x / W;
    int tot = 0, before = 0;
    for (int bb = p; p < parts && bb < G; bb += parts) {
      const int c = a.cnt[bb * W + l];
      tot += c;
      before += bb < b ? c : 0;
    }
    s_part[threadIdx.x] = tot;
    s_part[kThreads + threadIdx.x] = before;
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < W) {
    const int l = threadIdx.x;
    int tot = 0, before = 0;
    for (int p = 0; p < parts; ++p) {
      tot += s_part[p * W + l];
      before += s_part[kThreads + p * W + l];
    }
    s_tot[l] = tot;
    s_part[kThreads + l] = before;  // no other thread reads this cell
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int l = 0; l < W; ++l) {
      s_start[l] = run;
      run += s_tot[l];
    }
  }
  __syncthreads();
  // each warp's first slot in each bucket: after the earlier blocks' tasks
  // and the earlier warps' of this block
  for (int l = threadIdx.x; l < W; l += kThreads) {
    int run = s_start[l] + s_part[kThreads + l];
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_cur[w * W + l];
      s_cur[w * W + l] = run;
      run += c;
    }
  }
  __syncthreads();
  // each warp hands its tasks, 32 at a time in task order, the next slots
  // of their lanes' buckets
  for (int base = wlo; base < whi; base += 32) {
    const int i = base + lane;
    const bool valid = i < whi;
    const int l = valid ? cur[i] : -1 - lane;
    const unsigned peers = __match_any_sync(kFull, l);
    if (valid) a.sorted[row[l] + __popc(peers & below)] = a.durations[i];
    __syncwarp();
    if (valid && (peers & below) == 0) row[l] += __popc(peers);
    __syncwarp();
  }
  grid.sync();
  // a warp a lane adds its bucket front to back
  for (int l = b + G * warp; l < W; l += G * kWarps) {
    const float s = add_bucket(a.sorted + s_start[l], s_tot[l]);
    if (lane == 0) a.blocked[l] = s >= a.thresh;
  }
}

// every lane's load, a warp a lane over the block's shared tiles
__device__ void load_by_warp(const Args& a, const int* cur, unsigned char* smem) {
  if (static_cast<int>(blockIdx.x) * kWarps >= a.W) return;  // no lane here: the whole block
  int* s_lab = reinterpret_cast<int*>(smem);
  float* s_dur = reinterpret_cast<float*>(smem + sizeof(int) * kTile);
  const int T = a.T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const int rounds = (a.W + n_warps - 1) / n_warps;  // the same in every block
  const int tiles = (T + kTile - 1) / kTile;
  for (int j = 0; j < rounds; ++j) {
    const int l = blockIdx.x * kWarps + warp + j * n_warps;
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) {
      if (tiles > 1 || j == 0) {
        __syncthreads();  // the previous tile is read
#pragma unroll
        for (int k = 0; k < kTile / kThreads; ++k) {
          const int c = k * kThreads + threadIdx.x;
          const int i = t * kTile + c;
          s_lab[c] = i < T ? cur[i] : -1;
          s_dur[c] = i < T ? a.durations[i] : 0.f;
        }
        __syncthreads();
      }
      if (l < a.W) {
        const int n = min(kTile, T - t * kTile);
#pragma unroll 4
        for (int c = 0; c < n; c += 32) {
          const unsigned m = __ballot_sync(kFull, s_lab[c + lane] == l);
          for (unsigned b = m; b; b &= b - 1) s = __fadd_rn(s, s_dur[c + __ffs(b) - 1]);
        }
      }
    }
    if (l < a.W && lane == 0) a.blocked[l] = s >= a.thresh;
  }
}

// (value, lane) pairs: the larger value wins, the lower lane on a tie
__device__ __forceinline__ void take_max(float& best, int& bi, float v, int w) {
  if (v > best || (v == best && w < bi)) {
    best = v;
    bi = w;
  }
}

__device__ __forceinline__ void warp_max(float& best, int& bi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_down_sync(kFull, best, o);
    const int w = __shfl_down_sync(kFull, bi, o);
    take_max(best, bi, v, w);
  }
}

// a row's cell as the argmax reads it: blocked lanes -inf, the own lane
// max(score, 0) + bonus
__device__ __forceinline__ float cell(float v, bool blocked, bool own, float bonus) {
  v = blocked ? -INFINITY : v;
  return own ? __fadd_rn(fmaxf(v, 0.f), bonus) : v;
}

// a warp adds edges [lo, hi) into the row in order: the lanes load 32
// edges' (neighbour's lane, weight) at once, and lane 0 adds them one by
// one, so the chain of adds into each cell is the edges' order
__device__ __forceinline__ void add_edges(float* row, const int* cur, const int* nbr,
                                          const float* wts, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  for (int base = lo; base < hi; base += 32) {
    const int k = base + lane;
    int l = 0;
    float x = 0.f;
    if (k < hi) {
      l = cur[nbr[k]];
      x = wts[k];
    }
    const int n = min(32, hi - base);
    for (int t = 0; t < n; ++t) {
      const int lt = __shfl_sync(kFull, l, t);
      const float xt = __shfl_sync(kFull, x, t);
      if (lane == 0) row[lt] = __fadd_rn(row[lt], xt);
    }
  }
}

// a thread adds edges [lo, hi) into its row (stride kThreads) in order,
// loading 8 edges' neighbours and weights, then their lanes, before the adds
__device__ __forceinline__ void add_edges_thread(float* row, const int* cur, const int* nbr,
                                                 const float* wts, int lo, int hi) {
  constexpr int kBatch = 8;
  for (int base = lo; base < hi; base += kBatch) {
    int l[kBatch];
    float x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      l[j] = base + j < hi ? nbr[base + j] : -1;
      x[j] = base + j < hi ? wts[base + j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) l[j] = l[j] >= 0 ? cur[l[j]] : -1;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (l[j] >= 0) row[l[j] * kThreads] = __fadd_rn(row[l[j] * kThreads], x[j]);
    }
  }
}

// W <= kThreadRowLanes: a thread a task, its row at stride kThreads
__device__ void rows_by_thread(const Args& a, const int* cur, int* nxt, int parity, int rows,
                               float* smem_rows, const uint8_t* s_blk) {
  float* row = smem_rows + threadIdx.x;
  const int W = a.W;
  const int stride = gridDim.x * kThreads;
  for (int u = blockIdx.x * kThreads + threadIdx.x; u < rows; u += stride) {
    const int i = parity + 2 * u;
    const int in_lo = a.in_off[i], in_hi = a.in_off[i + 1];
    const int out_lo = a.out_off[i], out_hi = a.out_off[i + 1];
    add_edges_thread(row, cur, a.in_nbr, a.in_w, in_lo, in_hi);
    add_edges_thread(row, cur, a.out_nbr, a.out_w, out_lo, out_hi);
    const int own = cur[i];
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int w = 0; w < W; ++w) {
      take_max(best, bi, cell(row[w * kThreads], s_blk[w], w == own, a.bonus), w);
      row[w * kThreads] = 0.f;
    }
    nxt[i] = bi;
  }
}

// W <= kWarpRowLanes: a warp a task, its row in the warp's share
__device__ void rows_by_warp(const Args& a, const int* cur, int* nxt, int parity, int rows,
                             float* smem_rows, const uint8_t* s_blk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = a.W;
  float* row = smem_rows + warp * W;
  const int stride = gridDim.x * kWarps;
  for (int u = blockIdx.x * kWarps + warp; u < rows; u += stride) {
    const int i = parity + 2 * u;
    add_edges(row, cur, a.in_nbr, a.in_w, a.in_off[i], a.in_off[i + 1]);
    add_edges(row, cur, a.out_nbr, a.out_w, a.out_off[i], a.out_off[i + 1]);
    __syncwarp();
    const int own = cur[i];
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int w = lane; w < W; w += 32) {
      take_max(best, bi, cell(row[w], s_blk[w], w == own, a.bonus), w);
      row[w] = 0.f;
    }
    warp_max(best, bi);
    if (lane == 0) nxt[i] = bi;
    __syncwarp();  // the row is clean before the next task's adds
  }
}

// wider rows: the block a task
__device__ void rows_by_block(const Args& a, const int* cur, int* nxt, int parity, int rows,
                              float* row, const uint8_t* s_blk) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = a.W;
  for (int u = blockIdx.x; u < rows; u += gridDim.x) {
    const int i = parity + 2 * u;
    if (warp == 0) {
      add_edges(row, cur, a.in_nbr, a.in_w, a.in_off[i], a.in_off[i + 1]);
      add_edges(row, cur, a.out_nbr, a.out_w, a.out_off[i], a.out_off[i + 1]);
    }
    __syncthreads();
    const int own = cur[i];
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int w = threadIdx.x; w < W; w += kThreads) {
      take_max(best, bi, cell(row[w], s_blk[w], w == own, a.bonus), w);
      row[w] = 0.f;
    }
    warp_max(best, bi);
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 1; k < kWarps; ++k) take_max(best, bi, s_val[k], s_idx[k]);
      nxt[i] = bi;
    }
  }
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) partition_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int T = a.T, W = a.W;
  float* rows_smem = reinterpret_cast<float*>(smem + kLoadBytes);
  uint8_t* s_blk = smem + kLoadBytes + row_bytes(W);
  const bool stamp = a.stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  if (stamp) a.stamps[0] = globaltimer();
  // the rows start clean and every unit leaves its row clean
  for (size_t k = threadIdx.x; k < row_bytes(W) / sizeof(float); k += kThreads) rows_smem[k] = 0.f;
  for (int r = 0; r < a.iters; ++r) {
    const int* cur = r == 0 ? a.init : (r & 1) ? a.lab0 : a.lab1;
    int* nxt = (r & 1) ? a.lab1 : a.lab0;
    const int parity = r & 1;  // tasks i with (i + r) % 2 == 0 move
    if (W <= kBucketLanes) {
      load_by_buckets(a, cur, smem, grid);
    } else {
      load_by_warp(a, cur, smem);
    }
    grid.sync();
    if (stamp) a.stamps[2 * r + 1] = globaltimer();
    for (int w = threadIdx.x; w < W; w += kThreads) s_blk[w] = a.blocked[w];
    const int stride = 2 * gridDim.x * kThreads;
    for (int i = 1 - parity + 2 * (blockIdx.x * kThreads + threadIdx.x); i < T; i += stride) {
      nxt[i] = cur[i];
    }
    __syncthreads();
    const int rows = (T - parity + 1) / 2;
    if (W <= kThreadRowLanes) {
      rows_by_thread(a, cur, nxt, parity, rows, rows_smem, s_blk);
    } else if (W <= kWarpRowLanes) {
      rows_by_warp(a, cur, nxt, parity, rows, rows_smem, s_blk);
    } else {
      rows_by_block(a, cur, nxt, parity, rows, rows_smem, s_blk);
    }
    if (r + 1 < a.iters || a.stamps != nullptr) grid.sync();  // a last one only to time
    if (stamp) a.stamps[2 * r + 2] = globaltimer();
  }
}

cudaError_t refuse(cudaError_t err) {
  cudaGetLastError();  // not left behind for the next launch's check
  return err;
}

}  // namespace

// all `iters` rounds in one cooperative launch of `blocks` blocks (0: two
// a multiprocessor, or as many as can be resident); the labels after round
// r are in lab0 for even r, lab1 for odd r.  Needs 1 <= T, 2 <= W,
// 1 <= iters; up to 64 lanes also cnt [cnt_blocks][W] (cnt_blocks >= the
// grid) and sorted [T], else they may be null.  Shared memory grows with W
// and the launch is refused past the device's limit (about 40,000 lanes on
// an H100).  stamps: null, or u64 [2 * iters + 1] for the phase timeline
extern "C" int dtpu_partition(const void* init, void* lab0, void* lab1, const void* durations,
                              const void* in_off, const void* in_nbr, const void* in_w,
                              const void* out_off, const void* out_nbr, const void* out_w,
                              void* blocked, void* cnt, void* sorted, void* stamps, int T, int W,
                              int iters, float thresh, float bonus, int blocks, int cnt_blocks,
                              void* stream_ptr) {
  if (T <= 0 || W < 2 || iters <= 0 || blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(refuse(err));
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const size_t smem = smem_bytes(W);
  err = cudaFuncSetAttribute(partition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, partition_kernel, kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(refuse(err));
  if (occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (blocks == 0) blocks = sms * (occ < kBlocksPerSm ? occ : kBlocksPerSm);
  if (blocks > sms * occ) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (W <= kBucketLanes && (cnt == nullptr || sorted == nullptr || blocks > cnt_blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.init = static_cast<const int*>(init);
  a.lab0 = static_cast<int*>(lab0);
  a.lab1 = static_cast<int*>(lab1);
  a.durations = static_cast<const float*>(durations);
  a.in_off = static_cast<const int*>(in_off);
  a.in_nbr = static_cast<const int*>(in_nbr);
  a.in_w = static_cast<const float*>(in_w);
  a.out_off = static_cast<const int*>(out_off);
  a.out_nbr = static_cast<const int*>(out_nbr);
  a.out_w = static_cast<const float*>(out_w);
  a.blocked = static_cast<uint8_t*>(blocked);
  a.cnt = static_cast<int*>(cnt);
  a.sorted = static_cast<float*>(sorted);
  a.stamps = static_cast<unsigned long long*>(stamps);
  a.T = T;
  a.W = W;
  a.iters = iters;
  a.thresh = thresh;
  a.bonus = bonus;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(partition_kernel), dim3(blocks),
                                    dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(refuse(err));
  return static_cast<int>(cudaGetLastError());
}
