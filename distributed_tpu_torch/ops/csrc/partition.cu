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
// near-ties in the argmax would flip from run to run (K1's first version
// lost a third of its agreement that way).  Here every sum runs in the
// reference's order, one thread a chain, and nvcc cannot contract a
// chain of adds, so the kernel equals the plain version on the CPU bit for
// bit and repeats itself.
//
// Two launches a round:
//   - partition_load_kernel, one block of 32 warps: a stable counting sort
//     of the tasks by lane (warp k takes the k-th slice of the tasks,
//     counts it per lane, then hands each task the next slot of its lane's
//     bucket, 32 tasks at a time, so a bucket holds its tasks in task
//     order -- K1's bucketing, place_wave.cu), then one thread per lane
//     adds its bucket front to back.  It also copies the old labels into
//     the round's output buffer, which the second launch overwrites for the
//     tasks that move (the rounds are Jacobi: every task reads the old
//     labels, so the new ones go to another buffer).
//   - partition_rows_kernel, one block per task of the round's parity:
//     the task's score row lives in dynamic shared memory (4 B a lane; the
//     router sends at most DENSE_LIMIT / 1024 = 31,250 lanes, 125 KB, under
//     the 227 KB a block may opt into), warp 0 loads its edges 32 at a
//     time and one lane adds them in edge order, then the block masks,
//     adds the bonus and takes the first maximum (ties to the lowest lane).
//
// Bound on an H100: bytes, and tiny.  The inputs are 12 B a task and 12 B
// an edge (under 1 MB at 16k tasks), and the work they need is a few
// operations an edge and a task a round: a row is nonzero only on its
// neighbours' lanes, and its best lane elsewhere is the first unblocked
// one.  This kernel does more -- it writes and scans all W lanes of every
// moving row -- and what its launches cost is mostly latency: the load
// launch is one block whose slot hand-out runs 32 tasks at a time per
// warp.  One cooperative launch for all rounds, and rows that never
// materialise W zeros, are the next steps.
//
// Both launches use the stream they are given, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLoadThreads = 1024;
constexpr int kLoadWarps = kLoadThreads / 32;
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;

struct LoadArgs {
  const int* labels;    // [T] the round's old labels
  int* next;            // [T] the round's output buffer, seeded with the old labels
  const float* durations;  // [T]
  int* cnt;             // [kLoadWarps][W] per-warp counts, then bucket cursors
  int* tot;             // [W] tasks on each lane
  int* start;           // [W] bucket starts
  float* sorted;        // [T] durations bucketed by lane, task order kept
  uint8_t* blocked;     // [W] the lane's load >= thresh
  int T, W;
  float thresh;         // cap * avg_load
};

// start[w] = sum of tot[0..w): a contiguous run of lanes per thread, a
// shuffle scan in each warp, then over the warps
__device__ void exclusive_scan(const int* tot, int W, int* start, int* s_part) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int per = (W + kLoadThreads - 1) / kLoadThreads;
  const int lo = min(tid * per, W);
  const int hi = min(lo + per, W);
  int sum = 0;
  for (int w = lo; w < hi; ++w) sum += tot[w];
  int inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) s_part[tid / 32] = inc;
  __syncthreads();
  if (tid < 32) {
    const int t = s_part[tid];
    int x = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += v;
    }
    s_part[tid] = x - t;  // exclusive over the warps
  }
  __syncthreads();
  int run = s_part[tid / 32] + inc - sum;
  for (int w = lo; w < hi; ++w) {
    start[w] = run;
    run += tot[w];
  }
}

__global__ void __launch_bounds__(kLoadThreads, 1) partition_load_kernel(LoadArgs a) {
  __shared__ int s_part[kLoadWarps];
  const int T = a.T, W = a.W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const size_t cells = static_cast<size_t>(kLoadWarps) * W;
  for (size_t k = tid; k < cells; k += kLoadThreads) a.cnt[k] = 0;
  __syncthreads();

  // warp k's slice of the tasks, counted per lane
  const int per = (T + kLoadWarps - 1) / kLoadWarps;
  const int lo = min(warp * per, T);
  const int hi = min(lo + per, T);
  int* row = a.cnt + static_cast<size_t>(warp) * W;
  for (int i = lo + lane; i < hi; i += 32) {
    const int l = a.labels[i];
    a.next[i] = l;
    atomicAdd(row + l, 1);
  }
  __syncthreads();

  // per lane: where each warp's tasks start inside the lane's bucket
  for (int w = tid; w < W; w += kLoadThreads) {
    int run = 0;
    for (int k0 = 0; k0 < kLoadWarps; k0 += 8) {
      int c[8];  // eight loads in flight at once
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = a.cnt[static_cast<size_t>(k0 + k) * W + w];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        a.cnt[static_cast<size_t>(k0 + k) * W + w] = run;
        run += c[k];
      }
    }
    a.tot[w] = run;
  }
  __syncthreads();
  exclusive_scan(a.tot, W, a.start, s_part);
  __syncthreads();

  // each warp hands its tasks, 32 at a time in task order, the next slots
  // of their lanes' buckets; lanes past the end get keys no task has
  const unsigned below = (1u << lane) - 1u;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const bool valid = i < hi;
    const int l = valid ? a.labels[i] : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, l);
    if (valid) a.sorted[a.start[l] + row[l] + __popc(peers & below)] = a.durations[i];
    __syncwarp();
    if (valid && (peers & below) == 0) row[l] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // one thread per lane adds its bucket front to back
  for (int w = tid; w < W; w += kLoadThreads) {
    const float* p = a.sorted + a.start[w];
    const int n = a.tot[w];
    float s = 0.f;
    int j = 0;
    for (; j + 8 <= n; j += 8) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = p[j + k];
#pragma unroll
      for (int k = 0; k < 8; ++k) s = __fadd_rn(s, v[k]);
    }
    for (; j < n; ++j) s = __fadd_rn(s, p[j]);
    a.blocked[w] = s >= a.thresh;
  }
}

struct RowsArgs {
  const int* labels;    // [T] the round's old labels
  int* next;            // [T] the round's new labels
  const int* in_off;    // [T+1] in-edges of task i: [in_off[i], in_off[i+1])
  const int* in_nbr;    // [E] their producers, edge order kept
  const float* in_w;    // [E]
  const int* out_off;   // [T+1]
  const int* out_nbr;   // [E] the out-edges' consumers, edge order kept
  const float* out_w;   // [E]
  const uint8_t* blocked;  // [W]
  int T, W, parity;
  float bonus;          // sticky * mean_w
};

// (value, lane) pairs: the larger value wins, the lower lane on a tie
__device__ __forceinline__ void take_max(float& best, int& bi, float v, int w) {
  if (v > best || (v == best && w < bi)) {
    best = v;
    bi = w;
  }
}

// warp 0 adds edges [lo, hi) into the row in order: the lanes load 32
// edges' (neighbour's lane, weight) at once, and lane 0 adds them one by
// one, so the chain of adds into each cell is the edges' order
__device__ __forceinline__ void add_edges(float* s_row, const int* labels, const int* nbr,
                                          const float* wts, int lo, int hi) {
  const int lane = threadIdx.x;
  for (int base = lo; base < hi; base += 32) {
    const int k = base + lane;
    int l = 0;
    float x = 0.f;
    if (k < hi) {
      l = labels[nbr[k]];
      x = wts[k];
    }
    const int n = min(32, hi - base);
    for (int t = 0; t < n; ++t) {
      const int lt = __shfl_sync(0xffffffffu, l, t);
      const float xt = __shfl_sync(0xffffffffu, x, t);
      if (lane == 0) s_row[lt] = __fadd_rn(s_row[lt], xt);
    }
  }
}

__global__ void __launch_bounds__(kRowThreads) partition_rows_kernel(RowsArgs a) {
  extern __shared__ float s_row[];  // [W] the task's scores
  __shared__ float s_val[kRowWarps];
  __shared__ int s_idx[kRowWarps];
  const int i = a.parity + 2 * static_cast<int>(blockIdx.x);
  if (i >= a.T) return;  // the same for the whole block
  const int W = a.W;
  for (int w = threadIdx.x; w < W; w += kRowThreads) s_row[w] = 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    // the reference's first scatter (dst == i), then its second (src == i)
    add_edges(s_row, a.labels, a.in_nbr, a.in_w, a.in_off[i], a.in_off[i + 1]);
    add_edges(s_row, a.labels, a.out_nbr, a.out_w, a.out_off[i], a.out_off[i + 1]);
  }
  __syncthreads();
  const int own = a.labels[i];
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int w = threadIdx.x; w < W; w += kRowThreads) {
    float v = a.blocked[w] ? -INFINITY : s_row[w];
    if (w == own) v = __fadd_rn(fmaxf(v, 0.f), a.bonus);
    take_max(best, bi, v, w);
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, best, o);
    const int w = __shfl_down_sync(0xffffffffu, bi, o);
    take_max(best, bi, v, w);
  }
  if (lane == 0) {
    s_val[threadIdx.x / 32] = best;
    s_idx[threadIdx.x / 32] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kRowWarps; ++k) take_max(best, bi, s_val[k], s_idx[k]);
    a.next[i] = bi;
  }
}

}  // namespace

// round step 1: lane loads in task order, blocked flags, next = labels.
// scratch: cnt [32 * W], tot/start [W], sorted [T]; output blocked [W] u8
extern "C" int dtpu_partition_load(const void* labels, void* next, const void* durations,
                                   void* cnt, void* tot, void* start, void* sorted,
                                   void* blocked, int T, int W, float thresh, void* stream_ptr) {
  if (T <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  LoadArgs a;
  a.labels = static_cast<const int*>(labels);
  a.next = static_cast<int*>(next);
  a.durations = static_cast<const float*>(durations);
  a.cnt = static_cast<int*>(cnt);
  a.tot = static_cast<int*>(tot);
  a.start = static_cast<int*>(start);
  a.sorted = static_cast<float*>(sorted);
  a.blocked = static_cast<uint8_t*>(blocked);
  a.T = T;
  a.W = W;
  a.thresh = thresh;
  partition_load_kernel<<<1, kLoadThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// round step 2: new labels of the tasks i with i % 2 == parity, one block
// each, the score row in 4 * W bytes of dynamic shared memory (the launch
// opts in above 48 KB and fails past the device's limit)
extern "C" int dtpu_partition_rows(const void* labels, void* next, const void* in_off,
                                   const void* in_nbr, const void* in_w, const void* out_off,
                                   const void* out_nbr, const void* out_w, const void* blocked,
                                   int T, int W, int parity, float bonus, void* stream_ptr) {
  if (T <= 0 || W <= 0 || parity < 0 || parity > 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (T - parity + 1) / 2;
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  RowsArgs a;
  a.labels = static_cast<const int*>(labels);
  a.next = static_cast<int*>(next);
  a.in_off = static_cast<const int*>(in_off);
  a.in_nbr = static_cast<const int*>(in_nbr);
  a.in_w = static_cast<const float*>(in_w);
  a.out_off = static_cast<const int*>(out_off);
  a.out_nbr = static_cast<const int*>(out_nbr);
  a.out_w = static_cast<const float*>(out_w);
  a.blocked = static_cast<const uint8_t*>(blocked);
  a.T = T;
  a.W = W;
  a.parity = parity;
  a.bonus = bonus;
  const size_t smem = sizeof(float) * static_cast<size_t>(W);
  cudaError_t err = cudaFuncSetAttribute(partition_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left behind for the next launch's check
    return static_cast<int>(err);
  }
  partition_rows_kernel<<<rows, kRowThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
