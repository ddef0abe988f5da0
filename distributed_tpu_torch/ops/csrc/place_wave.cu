// One wave of the level-synchronous placement engine (kernel K1).
//
// Replaces distributed_tpu/ops/leveled.py::_place_run (its per-wave body
// run_wave, leveled.py:376-506), the XLA program the TPU engine runs for
// every fused group of waves.  The plain version beside it is
// ops/leveled.py::place_wave_reference.
//
// What the wave computes, for the f tasks [offset, offset+f) of one
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
// Bound on an H100: bytes.  A task reads its 16 B of wire and writes 8 B;
// at 1M tasks that is about 24 MB, ~7 us at 3.35 TB/s, while the
// arithmetic is a few dozen flops a task.  In practice a wave is a dozen
// short launches, so a whole 1M-task graph (28 levels) is bound by launch
// latency, not by either roofline.
//
// The per-worker sums of steps 2 and 3 are the one place where a parallel
// order would change the result: a float sum rounds differently in
// another order, and a near-tie in a later wave's worker order then
// flips a whole spread block.  So they are computed in task order, as a
// sequential index_add_ on the CPU and the reference's segment_sum do:
// each task's (worker, work) pair is bucketed by worker with a stable
// counting sort (per-chunk counts, per-worker offsets, a warp-serial
// scatter that keeps task order inside each bucket), and one thread per
// worker then adds its bucket front to back.  Every other product that
// feeds a sum is written with __fmul_rn/__fadd_rn so that nvcc does not
// contract it into an FMA.  With both, the kernel reproduces the plain
// version on the CPU bit for bit, and every run gives the same result.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRankThreads = 1024;
constexpr int kTaskThreads = 256;
constexpr int kCountThreads = 256;
constexpr int kSumThreads = 128;

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

struct WaveArgs {
  const __half* dur16;
  const int* heavy;
  const int* heavy2;
  const __half* xp16;
  const __half* xp2_16;
  const __half* xa16;
  int* assign;
  int* choices;
  const float* inv_t;
  const float* ovt0;
  const int* order;
  const float* tl;
  int* tgt;    // per task of the wave: the worker its work is summed on
  float* wt;   // ... and that work
  int W, offset, f, block;
  float ovt_c, inv_c;
};

__device__ __forceinline__ Task load_task(const WaveArgs& a, int i) {
  const int g = a.offset + i;
  Task t;
  t.dur = __half2float(a.dur16[g]);
  t.xp = __half2float(a.xp16[g]);
  t.xp2 = __half2float(a.xp2_16[g]);
  t.xa = __half2float(a.xa16[g]);
  const int h = a.heavy[g];
  const int h2 = a.heavy2[g];
  // heavy deps sit in earlier levels: their assignment is final
  const int pref = h >= 0 ? a.assign[h] : -1;
  const int pref2 = h2 >= 0 ? a.assign[h2] : -1;
  t.p = max(pref, 0);
  t.p2 = max(pref2, 0);
  t.ok1 = pref >= 0;
  t.ok2 = pref2 >= 0 && pref2 != pref;
  t.spread = a.order[min(i / a.block, a.W - 1)];
  return t;
}

// step 1: stable ascending rank of the W keys, ties by index (one block)
__global__ void rank_kernel(const float* __restrict__ load,
                            const float* __restrict__ inv_t,
                            const uint8_t* __restrict__ running, int W,
                            int* __restrict__ order) {
  extern __shared__ float key[];
  for (int w = threadIdx.x; w < W; w += blockDim.x)
    key[w] = running[w] ? __fmul_rn(load[w], inv_t[w]) : INFINITY;
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const float kw = key[w];
    int r = 0;
    for (int j = 0; j < W; ++j) {
      const float kj = key[j];
      r += (kj < kw) || (kj == kw && j < w);
    }
    order[r] = w;
  }
}

// step 2: the first choice, as the reference's c0/c1/c2
template <bool UNIFORM>
__global__ void tentative_kernel(WaveArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.f) return;
  const Task t = load_task(a, i);
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

// step 3: contention round against the tentative load a.tl, final choice
template <bool UNIFORM>
__global__ void contend_kernel(WaveArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.f) return;
  const Task t = load_task(a, i);
  const int tent = a.tgt[i];
  const float tw = a.wt[i];
  float d0, d1, d2;
  if (UNIFORM) {
    const float corr = __fmul_rn(tw, a.inv_c);
    const float q0 = __fmul_rn(a.tl[t.p], a.inv_c);
    const float q1 = __fmul_rn(a.tl[t.p2], a.inv_c);
    const float q2 = __fmul_rn(a.tl[t.spread], a.inv_c);
    d0 = t.ok1 ? ((q0 - (t.p == tent ? corr : 0.f)) + t.xp) + a.ovt_c
               : INFINITY;
    d1 = t.ok2 ? ((q1 - (t.p2 == tent ? corr : 0.f)) + t.xp2) + a.ovt_c
               : INFINITY;
    d2 = ((q2 - (t.spread == tent ? corr : 0.f)) + t.xa) + a.ovt_c;
  } else {
    const float corr = __fmul_rn(tw, a.inv_t[tent]);
    const float s0 = __fadd_rn(a.ovt0[t.p], __fmul_rn(a.tl[t.p], a.inv_t[t.p]));
    const float s1 =
        __fadd_rn(a.ovt0[t.p2], __fmul_rn(a.tl[t.p2], a.inv_t[t.p2]));
    const float s2 = __fadd_rn(a.ovt0[t.spread],
                               __fmul_rn(a.tl[t.spread], a.inv_t[t.spread]));
    d0 = t.ok1 ? (s0 - (t.p == tent ? corr : 0.f)) + t.xp : INFINITY;
    d1 = t.ok2 ? (s1 - (t.p2 == tent ? corr : 0.f)) + t.xp2 : INFINITY;
    d2 = (s2 - (t.spread == tent ? corr : 0.f)) + t.xa;
  }
  const int ch = argmin3(d0, d1, d2);
  const int w = sel3(ch, t.p, t.p2, t.spread);
  const int g = a.offset + i;
  a.assign[g] = w;
  a.choices[g] = ch;
  a.tgt[i] = w;
  a.wt[i] = t.dur + sel3(ch, t.xp, t.xp2, t.xa);
}

// ---- out[w] = sum of wt[i] over tasks i with tgt[i] == w, in task order

// per chunk of `chunk` tasks: how many go to each worker -> cnt[chunk][W]
__global__ void count_kernel(const int* __restrict__ tgt, int f, int W,
                             int chunk, int* __restrict__ cnt) {
  extern __shared__ int s_cnt[];
  for (int w = threadIdx.x; w < W; w += blockDim.x) s_cnt[w] = 0;
  __syncthreads();
  const int lo = blockIdx.x * chunk;
  const int hi = min(lo + chunk, f);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) atomicAdd(&s_cnt[tgt[i]], 1);
  __syncthreads();
  int* row = cnt + static_cast<size_t>(blockIdx.x) * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) row[w] = s_cnt[w];
}

// one block: cnt becomes each chunk's offset inside its worker's bucket,
// tot[w] the bucket sizes and start[w] where each bucket begins
__global__ void offsets_kernel(int* __restrict__ cnt, int nb, int W,
                               int* __restrict__ start, int* __restrict__ tot) {
  extern __shared__ int s_tot[];
  __shared__ int part[kRankThreads];
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    int run = 0;
#pragma unroll 8
    for (int b = 0; b < nb; ++b) {
      const size_t k = static_cast<size_t>(b) * W + w;
      const int c = cnt[k];
      cnt[k] = run;
      run += c;
    }
    s_tot[w] = run;
    tot[w] = run;
  }
  __syncthreads();
  // exclusive scan of s_tot: a contiguous run of workers per thread
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int per = (W + nt - 1) / nt;
  const int lo = min(tid * per, W);
  const int hi = min(lo + per, W);
  int sum = 0;
  for (int w = lo; w < hi; ++w) sum += s_tot[w];
  part[tid] = sum;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    const int v = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - sum;
  for (int w = lo; w < hi; ++w) {
    start[w] = run;
    run += s_tot[w];
  }
}

// one warp per chunk, 32 tasks at a time in order: each task's work goes
// to the next free slot of its worker's bucket, so a bucket holds its
// tasks in task order
__global__ void scatter_kernel(const int* __restrict__ tgt,
                               const float* __restrict__ wt, int f, int W,
                               int chunk, const int* __restrict__ cnt,
                               const int* __restrict__ start,
                               float* __restrict__ sorted) {
  extern __shared__ int s_next[];
  const int* row = cnt + static_cast<size_t>(blockIdx.x) * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) s_next[w] = start[w] + row[w];
  __syncwarp();
  const unsigned lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const int lo = blockIdx.x * chunk;
  const int hi = min(lo + chunk, f);
  for (int base = lo; base < hi; base += 32) {
    const int i = base + static_cast<int>(lane);
    const bool valid = i < hi;
    // lanes past the end get keys no task has, so they match no one
    const int w = valid ? tgt[i] : -1 - static_cast<int>(lane);
    const unsigned peers = __match_any_sync(0xffffffffu, w);
    const int pos = valid ? s_next[w] + __popc(peers & below) : 0;
    __syncwarp();
    if (valid) {
      sorted[pos] = wt[i];
      if ((peers & below) == 0) s_next[w] += __popc(peers);
    }
    __syncwarp();
  }
}

__global__ void sum_kernel(const float* __restrict__ sorted,
                           const int* __restrict__ start,
                           const int* __restrict__ tot, int W,
                           float* __restrict__ out) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const float* p = sorted + start[w];
  const int n = tot[w];
  float s = 0.f;
  for (int j = 0; j < n; ++j) s = __fadd_rn(s, p[j]);
  out[w] = s;
}

struct SumScratch {
  float* sorted;
  int* cnt;
  int* start;
  int* tot;
};

void segment_sum(const int* tgt, const float* wt, int f, int W, int chunk,
                 const SumScratch& s, float* out, cudaStream_t stream) {
  const size_t smem = sizeof(int) * static_cast<size_t>(W);
  const int nb = (f + chunk - 1) / chunk;
  if (nb > 0) {
    count_kernel<<<nb, kCountThreads, smem, stream>>>(tgt, f, W, chunk, s.cnt);
  }
  offsets_kernel<<<1, kRankThreads, smem, stream>>>(s.cnt, nb, W, s.start, s.tot);
  if (nb > 0) {
    scatter_kernel<<<nb, 32, smem, stream>>>(tgt, wt, f, W, chunk, s.cnt, s.start,
                                             s.sorted);
  }
  sum_kernel<<<(W + kSumThreads - 1) / kSumThreads, kSumThreads, 0, stream>>>(
      s.sorted, s.start, s.tot, W, out);
}

// step 4: load += wave_load; span = max(where(running, wave_load/threads, 0))
__global__ void finish_kernel(float* __restrict__ load,
                              const float* __restrict__ wave_load,
                              const float* __restrict__ inv_t,
                              const uint8_t* __restrict__ running, int W,
                              float* __restrict__ spans, int wave) {
  __shared__ float red[kRankThreads];
  float m = -INFINITY;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const float wl = wave_load[w];
    load[w] = __fadd_rn(load[w], wl);
    m = fmaxf(m, running[w] ? __fmul_rn(wl, inv_t[w]) : 0.f);
  }
  red[threadIdx.x] = m;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) spans[wave] = red[0];
}

}  // namespace

// W <= 8192 (one f32 or i32 per worker in shared memory, below the 48 KB
// a launch gets without opting in);
// scratch: order/tl/wave_load/start/tot [W], tgt/wt/sorted [f],
// cnt [ceil(f / chunk) * W]
extern "C" int dtpu_place_wave(
    const void* dur16, const void* heavy, const void* heavy2, const void* xp16,
    const void* xp2_16, const void* xa16, void* assign, void* choices,
    void* load, void* spans, const void* inv_t, const void* running,
    const void* ovt0, void* order, void* tl, void* wave_load, void* tgt,
    void* wt, void* sorted, void* cnt, void* start, void* tot, int W,
    int offset, int f, int block, int wave, int uniform, int chunk,
    float ovt_c, float inv_c, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (W <= 0 || f < 0 || chunk <= 0 || block <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(W);
  const uint8_t* run = static_cast<const uint8_t*>(running);
  const float* inv = static_cast<const float*>(inv_t);
  const SumScratch sums{static_cast<float*>(sorted), static_cast<int*>(cnt),
                        static_cast<int*>(start), static_cast<int*>(tot)};

  rank_kernel<<<1, kRankThreads, smem, stream>>>(
      static_cast<const float*>(load), inv, run, W, static_cast<int*>(order));

  WaveArgs a;
  a.dur16 = static_cast<const __half*>(dur16);
  a.heavy = static_cast<const int*>(heavy);
  a.heavy2 = static_cast<const int*>(heavy2);
  a.xp16 = static_cast<const __half*>(xp16);
  a.xp2_16 = static_cast<const __half*>(xp2_16);
  a.xa16 = static_cast<const __half*>(xa16);
  a.assign = static_cast<int*>(assign);
  a.choices = static_cast<int*>(choices);
  a.inv_t = inv;
  a.ovt0 = static_cast<const float*>(ovt0);
  a.order = static_cast<const int*>(order);
  a.tl = static_cast<const float*>(tl);
  a.tgt = static_cast<int*>(tgt);
  a.wt = static_cast<float*>(wt);
  a.W = W;
  a.offset = offset;
  a.f = f;
  a.block = block;
  a.ovt_c = ovt_c;
  a.inv_c = inv_c;
  const int blocks = std::max((f + kTaskThreads - 1) / kTaskThreads, 1);
  if (uniform) {
    tentative_kernel<true><<<blocks, kTaskThreads, 0, stream>>>(a);
  } else {
    tentative_kernel<false><<<blocks, kTaskThreads, 0, stream>>>(a);
  }
  segment_sum(a.tgt, a.wt, f, W, chunk, sums, static_cast<float*>(tl), stream);
  if (uniform) {
    contend_kernel<true><<<blocks, kTaskThreads, 0, stream>>>(a);
  } else {
    contend_kernel<false><<<blocks, kTaskThreads, 0, stream>>>(a);
  }
  segment_sum(a.tgt, a.wt, f, W, chunk, sums, static_cast<float*>(wave_load),
              stream);
  finish_kernel<<<1, kRankThreads, 0, stream>>>(
      static_cast<float*>(load), static_cast<const float*>(wave_load), inv, run,
      W, static_cast<float*>(spans), wave);
  return static_cast<int>(cudaGetLastError());
}
