// Work stealing's balance rounds (kernel K7).
//
// Replaces distributed_tpu/ops/stealing.py::_steal_rounds
// (stealing.py:77-161), the XLA program the scheduler's WorkStealing runs
// for a balance cycle.  The plain version beside it is
// ops/stealing.py::steal_rounds_reference.
//
// One cycle is K Jacobi rounds.  In each round:
//   1. the unstolen tasks are ordered by (-vload[victim], key, index),
//      vload = occ / threads, unusable tasks (stolen or padding) last: a
//      bitonic sort of (u64 composite, index) pairs, the float mapped to
//      order-preserving bits (-0 as +0, as the reference's sort compares
//      them equal);
//   2. the idle running thieves are ordered by (vload, index), a bitonic
//      sort of u64 (code << 32 | worker); slot r pairs the r-th task with
//      the r-th thief while r is below both counts;
//   3. the candidate slots are sorted by (victim, slot), so each victim's
//      candidates are one run in slot order, and one thread a victim sums
//      their compute: the reference sums a [W, W] masked row, which XLA
//      adds in windows of 32 (ops/partition.py::xla_row_sum), so the
//      thread adds in those windows too, skipping the zeros, whose adds
//      change nothing;
//   4. each candidate evaluates the criterion
//      vload[th] + tc + cp <= vload[vic] - others_cp / threads[vic] - cp/2
//      in the reference's order, with __fadd_rn etc. so that nothing is
//      contracted;
//   5. the same thread a victim subtracts its accepted moves' compute from
//      the victim in slot order (the reference's first scatter), then each
//      accepted slot adds compute + transfer to its thief (the second; the
//      thieves are distinct), and thieves past LATENCY retire.
// So the kernel reproduces the plain version on the CPU bit for bit.
//
// Bound on an H100: neither bytes nor operations.  A cycle reads at most
// 8,192 tasks (16 B each) and the fleet (10 B a worker), ~0.1 MB, a few
// tens of ns at 3.35 TB/s; the work is a few sorts of 8K entries a round.
// What costs is the chain: 8 rounds, each a handful of sorts whose stages
// depend on each other.  So the whole cycle is one launch of one
// 1,024-thread block, which keeps every sort stage a __syncthreads apart
// and its arrays in shared memory while they fit (8,192 tasks and 1,024
// workers take ~150 KB); beyond that the same code runs on global scratch
// that the wrapper allocates.  The scheduler sends at most 8,192 tasks a
// cycle, so one block is enough.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;
constexpr int kImax = 0x7fffffff;
constexpr int kWindow = 32;   // XLA's CPU row-reduction window
constexpr int kMaxLevels = 8;
constexpr float kLatency = 0.1f;
constexpr u64 kNone = ~0ull;

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// byte offsets of the work space, on the host and the device alike
struct Layout {
  int tp, wp;  // sorted entries: tasks, workers (and candidate slots)
  size_t tkey, wkey, skey, tidx, vload, thr, s_t, s_th, s_vic, s_cp, s_tc, s_sum, s_acc, total;
};

__host__ __device__ inline Layout layout(int T, int W) {
  Layout L;
  L.tp = pow2_at_least(T);
  L.wp = pow2_at_least(W);
  size_t o = 0;
  L.tkey = o; o += align16(8 * static_cast<size_t>(L.tp));
  L.wkey = o; o += align16(8 * static_cast<size_t>(L.wp));
  L.skey = o; o += align16(8 * static_cast<size_t>(L.wp));
  L.tidx = o; o += align16(4 * static_cast<size_t>(L.tp));
  const size_t w4 = align16(4 * static_cast<size_t>(W));
  L.vload = o; o += w4;
  L.thr = o; o += w4;
  L.s_t = o; o += w4;
  L.s_th = o; o += w4;
  L.s_vic = o; o += w4;
  L.s_cp = o; o += w4;
  L.s_tc = o; o += w4;
  L.s_sum = o; o += w4;
  L.s_acc = o; o += align16(W);
  L.total = o;
  return L;
}

struct Args {
  const int* victim;      // [T]
  const int* key;         // [T]
  const float* cost;      // [T]
  const float* compute;   // [T]
  const int* nthreads;    // [W]
  const uint8_t* running; // [W]
  float* occ;             // [W] in/out
  uint8_t* idle;          // [W] in/out
  int* thief_of;          // [T] out, preset -1
  uint8_t* taken;         // [T] scratch
  unsigned char* scratch; // the work space in global memory, or null: shared
  int T, W, rounds;
};

// an order-preserving unsigned code of a float: -0 as +0, NaN after +inf
__device__ __forceinline__ unsigned sort_code(float x) {
  x = __fadd_rn(x, 0.f);
  if (x != x) return 0xffffffffu;
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// ascending bitonic sort of n (a power of two) entries, by (k, v) when v
// is given, else by k; all threads of the block take part
__device__ void bitonic(u64* k, int* v, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int q = threadIdx.x; q < n / 2; q += kThreads) {
        const int i = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
        const int j = i + stride;
        const u64 a = k[i], b = k[j];
        const bool gt = v ? (a > b || (a == b && v[i] > v[j])) : a > b;
        if (gt == ((i & size) == 0)) {
          k[i] = b;
          k[j] = a;
          if (v) {
            const int t = v[i];
            v[i] = v[j];
            v[j] = t;
          }
        }
      }
      __syncthreads();
    }
  }
}

// the sum of one victim's candidates' compute, as XLA sums the victim's
// [W]-long masked row: the run of skey from p holds the victim's slots in
// ascending order; a slot s sits in window (s + f0) / 32 of the first
// level, that window in window (. + f1) / 32 of the next, and so on while
// a level has more than 32 entries (f = half the level's zero padding)
__device__ float victim_sum(const u64* skey, int p, int end, const float* s_cp, int W) {
  int f[kMaxLevels];
  int L = 0;
  for (long long n = W; n > kWindow && L < kMaxLevels;) {
    const int pad = static_cast<int>((kWindow - n % kWindow) % kWindow);
    f[L++] = pad / 2;
    n = (n + pad) / kWindow;
  }
  float acc[kMaxLevels];
  long long cur[kMaxLevels];
  for (int l = 0; l < L; ++l) {
    acc[l] = 0.f;
    cur[l] = -1;
  }
  float total = 0.f;
  const unsigned v = static_cast<unsigned>(skey[p] >> 32);
  for (int q = p; q < end && skey[q] != kNone && static_cast<unsigned>(skey[q] >> 32) == v; ++q) {
    const int slot = static_cast<int>(skey[q] & 0xffffffffu);
    long long idx[kMaxLevels + 1];
    idx[0] = slot;
    for (int l = 0; l < L; ++l) idx[l + 1] = (idx[l] + f[l]) / kWindow;
    // close the windows this slot leaves, innermost first
    for (int l = 0; l < L && cur[l] >= 0 && cur[l] != idx[l + 1]; ++l) {
      if (l + 1 < L) acc[l + 1] = __fadd_rn(acc[l + 1], acc[l]);
      else total = __fadd_rn(total, acc[l]);
      acc[l] = 0.f;
      cur[l] = -1;
    }
    if (L == 0) total = __fadd_rn(total, s_cp[slot]);
    else acc[0] = __fadd_rn(acc[0], s_cp[slot]);
    for (int l = 0; l < L; ++l) cur[l] = idx[l + 1];
  }
  for (int l = 0; l < L; ++l) {
    if (cur[l] < 0) continue;
    if (l + 1 < L) acc[l + 1] = __fadd_rn(acc[l + 1], acc[l]);
    else total = __fadd_rn(total, acc[l]);
  }
  return total;
}

__device__ __forceinline__ bool group_head(const u64* skey, int p) {
  return skey[p] != kNone && (p == 0 || (skey[p - 1] >> 32) != (skey[p] >> 32));
}

__global__ void __launch_bounds__(kThreads, 1) steal_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_count[2];  // idle running thieves, usable tasks
  unsigned char* base = a.scratch ? a.scratch : smem;
  const int T = a.T, W = a.W, tid = threadIdx.x;
  const Layout L = layout(T, W);
  u64* tkey = reinterpret_cast<u64*>(base + L.tkey);
  u64* wkey = reinterpret_cast<u64*>(base + L.wkey);
  u64* skey = reinterpret_cast<u64*>(base + L.skey);
  int* tidx = reinterpret_cast<int*>(base + L.tidx);
  float* vload = reinterpret_cast<float*>(base + L.vload);
  float* thr = reinterpret_cast<float*>(base + L.thr);
  int* s_t = reinterpret_cast<int*>(base + L.s_t);
  int* s_th = reinterpret_cast<int*>(base + L.s_th);
  int* s_vic = reinterpret_cast<int*>(base + L.s_vic);
  float* s_cp = reinterpret_cast<float*>(base + L.s_cp);
  float* s_tc = reinterpret_cast<float*>(base + L.s_tc);
  float* s_sum = reinterpret_cast<float*>(base + L.s_sum);
  uint8_t* s_acc = reinterpret_cast<uint8_t*>(base + L.s_acc);

  for (int i = tid; i < T; i += kThreads) a.taken[i] = 0;
  for (int w = tid; w < W; w += kThreads) thr[w] = static_cast<float>(max(a.nthreads[w], 1));
  __syncthreads();

  for (int round = 0; round < a.rounds; ++round) {
    if (tid < 2) s_count[tid] = 0;
    __syncthreads();
    // 1-2. loads and the two sort keys
    int n_th = 0, n_us = 0;
    for (int w = tid; w < L.wp; w += kThreads) {
      u64 e = kNone;
      if (w < W) {
        const float vl = __fdiv_rn(a.occ[w], thr[w]);
        vload[w] = vl;
        const bool thief = a.idle[w] && a.running[w];
        n_th += thief;
        e = (static_cast<u64>(sort_code(thief ? vl : INFINITY)) << 32) | static_cast<unsigned>(w);
      }
      wkey[w] = e;
    }
    __syncthreads();
    for (int i = tid; i < L.tp; i += kThreads) {
      u64 e = kNone;
      if (i < T) {
        const int key = a.taken[i] ? kImax : a.key[i];
        const bool usable = key != kImax;
        n_us += usable;
        const float primary = usable ? -vload[a.victim[i]] : INFINITY;
        e = (static_cast<u64>(sort_code(primary)) << 32) | static_cast<unsigned>(key);
      }
      tkey[i] = e;
      tidx[i] = i;
    }
    if (n_th) atomicAdd(&s_count[0], n_th);
    if (n_us) atomicAdd(&s_count[1], n_us);
    __syncthreads();
    bitonic(tkey, tidx, L.tp);
    bitonic(wkey, nullptr, L.wp);
    const int nc = min(min(s_count[0], s_count[1]), W);  // slots that may hold a candidate

    // the candidate slots, then their order by (victim, slot)
    for (int r = tid; r < L.wp; r += kThreads) {
      u64 e = kNone;
      if (r < nc) {
        const int task = tidx[r];
        const bool ok = !a.taken[task] && a.key[task] != kImax;
        const int v = a.victim[task];
        s_t[r] = task;
        s_th[r] = static_cast<int>(wkey[r] & 0xffffffffu);
        s_vic[r] = v;
        s_cp[r] = ok ? a.compute[task] : 0.f;
        s_tc[r] = ok ? a.cost[task] : 0.f;
        s_acc[r] = ok;
        if (ok) e = (static_cast<u64>(v) << 32) | static_cast<unsigned>(r);
      }
      skey[r] = e;
    }
    __syncthreads();
    const int np = pow2_at_least(nc);
    bitonic(skey, nullptr, np);

    // 3. others_cp: a thread a victim
    for (int p = tid; p < np; p += kThreads) {
      if (!group_head(skey, p)) continue;
      const float s = victim_sum(skey, p, np, s_cp, W);
      for (int q = p; q < np && skey[q] != kNone && (skey[q] >> 32) == (skey[p] >> 32); ++q) {
        s_sum[skey[q] & 0xffffffffu] = s;
      }
    }
    __syncthreads();
    // 4. the criterion
    for (int r = tid; r < nc; r += kThreads) {
      if (!s_acc[r]) continue;
      const int v = s_vic[r], th = s_th[r];
      const float cp = s_cp[r], tc = s_tc[r];
      const float others = __fsub_rn(s_sum[r], cp);
      const float lhs = __fadd_rn(__fadd_rn(vload[th], tc), cp);
      const float rhs = __fsub_rn(__fsub_rn(vload[v], __fdiv_rn(others, thr[v])), __fdiv_rn(cp, 2.f));
      s_acc[r] = (lhs <= rhs) && (v != th);
    }
    __syncthreads();
    // 5. victims in slot order, then thieves, then retire loaded thieves
    for (int p = tid; p < np; p += kThreads) {
      if (!group_head(skey, p)) continue;
      const int v = static_cast<int>(skey[p] >> 32);
      float o = a.occ[v];
      for (int q = p; q < np && skey[q] != kNone && (skey[q] >> 32) == (skey[p] >> 32); ++q) {
        const int r = static_cast<int>(skey[q] & 0xffffffffu);
        if (s_acc[r]) o = __fadd_rn(o, -s_cp[r]);
      }
      a.occ[v] = o;
    }
    __syncthreads();
    for (int r = tid; r < nc; r += kThreads) {
      if (!s_acc[r]) continue;
      const int th = s_th[r];
      a.occ[th] = __fadd_rn(a.occ[th], __fadd_rn(s_cp[r], s_tc[r]));
      a.taken[s_t[r]] = 1;
      a.thief_of[s_t[r]] = th;
    }
    __syncthreads();
    for (int w = tid; w < W; w += kThreads) {
      if (a.idle[w] && __fdiv_rn(a.occ[w], thr[w]) > kLatency) a.idle[w] = 0;
    }
    __syncthreads();
  }
}

cudaError_t refuse(cudaError_t err) {
  cudaGetLastError();  // not left behind for the next launch's check
  return err;
}

size_t smem_limit() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return static_cast<size_t>(optin) - 2 * sizeof(int);  // the static counts
}

}  // namespace

// bytes of the work space for T tasks and W workers, and whether they fit
// in the block's shared memory (else the caller passes global scratch)
extern "C" int dtpu_steal_layout(int T, int W, long long* bytes, int* shared) {
  if (T < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = layout(T, W).total;
  *bytes = static_cast<long long>(total);
  *shared = total <= smem_limit();
  return 0;
}

// all `rounds` rounds in one launch of one block; scratch: null to work in
// shared memory, else dtpu_steal_layout's bytes of device memory
extern "C" int dtpu_steal(const void* victim, const void* key, const void* cost,
                          const void* compute, const void* nthreads, const void* running,
                          void* occ, void* idle, void* thief_of, void* taken, void* scratch,
                          int T, int W, int rounds, void* stream_ptr) {
  if (T < 1 || W < 1 || rounds < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = layout(T, W).total;
  size_t smem = 0;
  if (scratch == nullptr) {
    if (total > smem_limit()) return static_cast<int>(cudaErrorInvalidValue);
    smem = total;
    const cudaError_t err = cudaFuncSetAttribute(
        steal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(refuse(err));
  }
  Args a;
  a.victim = static_cast<const int*>(victim);
  a.key = static_cast<const int*>(key);
  a.cost = static_cast<const float*>(cost);
  a.compute = static_cast<const float*>(compute);
  a.nthreads = static_cast<const int*>(nthreads);
  a.running = static_cast<const uint8_t*>(running);
  a.occ = static_cast<float*>(occ);
  a.idle = static_cast<uint8_t*>(idle);
  a.thief_of = static_cast<int*>(thief_of);
  a.taken = static_cast<uint8_t*>(taken);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.T = T;
  a.W = W;
  a.rounds = rounds;
  steal_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
