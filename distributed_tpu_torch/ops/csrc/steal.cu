// Work stealing's balance rounds (kernel K7).
//
// Replaces distributed_tpu/ops/stealing.py::_steal_rounds
// (stealing.py:77-161), the XLA program the scheduler's WorkStealing runs
// for a balance cycle.  The plain version beside it is
// ops/stealing.py::steal_rounds_reference.
//
// One cycle is K Jacobi rounds.  In each round:
//   1. the unstolen tasks are ordered by (-vload[victim], key, index),
//      vload = occ / threads, unusable tasks (stolen or padding) last, on
//      a u64 composite (the float mapped to order-preserving bits, -0 as
//      +0, as the reference's sort compares them equal, << 32 | key).  A
//      round reads only the first nc = min(idle running thieves, usable
//      tasks, W) entries of that order, so only those are found: a radix
//      select, most significant byte first, finds the nc-th smallest
//      composite (a 256-bin histogram a pass of the entries still in the
//      running, ending early once a bin holds exactly the entries still
//      needed); the entries below it, then those equal to it in ascending
//      task index until nc are taken, are compacted by one block scan and
//      bitonic-sorted by (composite, index).  Slot r then holds what the
//      full stable sort holds at r, usable or not;
//   2. the idle running thieves are ordered by (vload, index), a bitonic
//      sort of u64 (code << 32 | worker); slot r pairs the r-th task with
//      the r-th thief while r is below both counts;
//   3. the candidate slots are sorted by (victim, slot), so each victim's
//      candidates are one run in slot order, and one thread a victim sums
//      their compute: the reference sums a [W, W] masked row, which XLA
//      adds in windows of 32 (ops/partition.py::xla_row_sum), so the
//      thread adds in those windows too, skipping the zeros, whose adds
//      change nothing.  The levels of windows are a template argument, the
//      most W reaches, so the running sums stay in registers;
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
// tens of ns at 3.35 TB/s.  What costs is the chain: 8 rounds, each a
// handful of passes whose steps depend on each other.  So the whole cycle
// is one launch of one 1,024-thread block, which keeps every step a
// __syncthreads apart and its arrays in shared memory while they fit
// (8,192 tasks and 1,024 workers take ~130 KB); beyond that the same code
// runs on global scratch that the wrapper allocates.  The scheduler sends
// at most 8,192 tasks a cycle, so one block is enough.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kImax = 0x7fffffff;
constexpr int kWindow = 32;   // XLA's CPU row-reduction window
constexpr int kMaxLevels = 4;  // levels of windows up to W = 32^5
constexpr int kBins = 256;    // the radix select's digit
constexpr float kLatency = 0.1f;
constexpr u64 kNone = ~0ull;
constexpr unsigned kFull = 0xffffffffu;
// a round's phases in the timeline: keys and counts, task order, thief
// sort, slot fill and sort, group sums, criterion, apply and retire
constexpr int kPhases = 7;

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// the levels of XLA's windows of 32 over a W-long row
__host__ __device__ inline int window_levels(int W) {
  int L = 0;
  for (long long n = W; n > kWindow; ++L) n = (n + kWindow - 1) / kWindow;
  return L;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// byte offsets of the work space, on the host and the device alike
struct Layout {
  int wp;  // sorted entries: workers, candidate slots and selected tasks
  size_t tkey, wkey, skey, sel, sidx, vload, thr, s_t, s_th, s_vic, s_cp, s_tc, s_sum, s_acc, total;
};

__host__ __device__ inline Layout layout(int T, int W) {
  Layout L;
  L.wp = pow2_at_least(W);
  size_t o = 0;
  L.tkey = o; o += align16(8 * static_cast<size_t>(T));
  L.wkey = o; o += align16(8 * static_cast<size_t>(L.wp));
  L.skey = o; o += align16(8 * static_cast<size_t>(L.wp));
  L.sel = o; o += align16(8 * static_cast<size_t>(L.wp));
  L.sidx = o; o += align16(4 * static_cast<size_t>(L.wp));
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
  // optional timeline, [1 + rounds * kPhases] of %globaltimer (ns): the
  // start, then the end of each phase of each round; null: none
  unsigned long long* stamps;
  int T, W, rounds;
};

// the work space's arrays
struct Arrays {
  u64 *tkey, *wkey, *skey, *sel;
  int* sidx;
  float *vload, *thr;
  int *s_t, *s_th, *s_vic;
  float *s_cp, *s_tc, *s_sum;
  uint8_t* s_acc;
  int wp;
};

__device__ inline Arrays arrays(unsigned char* base, int T, int W) {
  const Layout L = layout(T, W);
  Arrays A;
  A.tkey = reinterpret_cast<u64*>(base + L.tkey);
  A.wkey = reinterpret_cast<u64*>(base + L.wkey);
  A.skey = reinterpret_cast<u64*>(base + L.skey);
  A.sel = reinterpret_cast<u64*>(base + L.sel);
  A.sidx = reinterpret_cast<int*>(base + L.sidx);
  A.vload = reinterpret_cast<float*>(base + L.vload);
  A.thr = reinterpret_cast<float*>(base + L.thr);
  A.s_t = reinterpret_cast<int*>(base + L.s_t);
  A.s_th = reinterpret_cast<int*>(base + L.s_th);
  A.s_vic = reinterpret_cast<int*>(base + L.s_vic);
  A.s_cp = reinterpret_cast<float*>(base + L.s_cp);
  A.s_tc = reinterpret_cast<float*>(base + L.s_tc);
  A.s_sum = reinterpret_cast<float*>(base + L.s_sum);
  A.s_acc = reinterpret_cast<uint8_t*>(base + L.s_acc);
  A.wp = L.wp;
  return A;
}

// the block's shared scalars
struct Shared {
  Arrays ar;
  int count[2];      // idle running thieves, usable tasks
  int hist[kBins];   // the select's digit counts, zero between passes
  int digit, below, dcount;  // the select pass's digit, the entries under it, in it
  int scan[2][kWarps];
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

// exclusive block-wide prefix of two counts a thread, in thread order;
// returns the block's totals through tot
__device__ void block_scan2(Shared& sh, int& a, int& b, int* tot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int ia = a, ib = b;
  for (int off = 1; off < 32; off <<= 1) {
    const int na = __shfl_up_sync(kFull, ia, off), nb = __shfl_up_sync(kFull, ib, off);
    if (lane >= off) {
      ia += na;
      ib += nb;
    }
  }
  if (lane == 31) {
    sh.scan[0][warp] = ia;
    sh.scan[1][warp] = ib;
  }
  __syncthreads();
  int ra = 0, rb = 0, ta = 0, tb = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      ra += sh.scan[0][w];
      rb += sh.scan[1][w];
    }
    ta += sh.scan[0][w];
    tb += sh.scan[1][w];
  }
  a = ra + ia - a;
  b = rb + ib - b;
  tot[0] = ta;
  tot[1] = tb;
  __syncthreads();  // sh.scan is free again
}

// the nc smallest (composite, index) entries of tkey[0, T) into sel /
// sidx[0, nc), ascending; sh.hist is zero on entry and on exit
__device__ void select_tasks(const u64* tkey, int T, int nc, u64* sel, int* sidx, int np, Shared& sh) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // 1. the radix select: (c >> shift) == prefix are the entries still in
  //    the running, of which the need smallest are taken
  u64 prefix = 0;
  int shift = 64, need = nc;
  while (shift > 0) {
    const bool first = shift == 64;
    shift -= 8;
    for (int base = 0; base < T; base += kThreads) {
      const int i = base + tid;
      const u64 c = i < T ? tkey[i] : 0;
      const bool in = i < T && (first || (c >> (shift + 8)) == prefix);
      const unsigned act = __ballot_sync(kFull, in);
      if (in) {
        const int d = static_cast<int>((c >> shift) & (kBins - 1));
        const unsigned peers = __match_any_sync(act, d);
        if (lane == __ffs(peers) - 1) atomicAdd(&sh.hist[d], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 8l..8l+7; the digit is where the count reaches need
      int h[kBins / 32], s = 0;
#pragma unroll
      for (int j = 0; j < kBins / 32; ++j) {
        h[j] = sh.hist[lane * (kBins / 32) + j];
        sh.hist[lane * (kBins / 32) + j] = 0;
        s += h[j];
      }
      int incl = s;
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += n;
      }
      int run = incl - s;
      if (run < need && need <= incl) {
#pragma unroll
        for (int j = 0; j < kBins / 32; ++j) {
          if (run + h[j] >= need) {
            sh.digit = lane * (kBins / 32) + j;
            sh.below = run;
            sh.dcount = h[j];
            break;
          }
          run += h[j];
        }
      }
    }
    __syncthreads();
    prefix = (prefix << 8) | static_cast<u64>(sh.digit);
    need -= sh.below;
    // (the next pass rewrites sh.digit etc. only after its first barrier)
    if (sh.dcount == need) break;  // every entry of the digit is taken
  }
  // 2. compaction: the entries under the prefix, then the first need of
  //    those equal to it by task index, each thread a contiguous chunk
  const int per = (T + kThreads - 1) / kThreads;
  const int i0 = min(T, tid * per), i1 = min(T, i0 + per);
  int nb = 0, ne = 0;
  for (int i = i0; i < i1; ++i) {
    const u64 top = tkey[i] >> shift;
    nb += top < prefix;
    ne += top == prefix;
  }
  int tot[2];
  block_scan2(sh, nb, ne, tot);
  const int n_below = tot[0];  // == nc - need
  for (int i = i0; i < i1; ++i) {
    const u64 c = tkey[i], top = c >> shift;
    int pos = -1;
    if (top < prefix) {
      pos = nb++;
    } else if (top == prefix) {
      if (ne < need) pos = n_below + ne;
      ++ne;
    }
    if (pos >= 0) {
      sel[pos] = c;
      sidx[pos] = i;
    }
  }
  for (int p = nc + tid; p < np; p += kThreads) {
    sel[p] = kNone;
    sidx[p] = kImax;
  }
  __syncthreads();
  // 3. the nc entries in (composite, index) order
  bitonic(sel, sidx, np);
}

// the sum of one victim's candidates' compute, as XLA sums the victim's
// [W]-long masked row: the run of skey from p holds the victim's slots in
// ascending order; a slot s sits in window (s + f0) / 32 of the first
// level, that window in window (. + f1) / 32 of the next, and so on while
// a level has more than 32 entries (f = half the level's zero padding)
template <int L>
__device__ float victim_sum(const u64* skey, int p, int end, const float* s_cp, int W) {
  int f[L > 0 ? L : 1];
  float acc[L > 0 ? L : 1];
  int cur[L > 0 ? L : 1];
  int n = W;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int pad = (kWindow - n % kWindow) % kWindow;
    f[l] = pad / 2;
    n = (n + pad) / kWindow;
    acc[l] = 0.f;
    cur[l] = -1;
  }
  float total = 0.f;
  const unsigned v = static_cast<unsigned>(skey[p] >> 32);
  for (int q = p; q < end && skey[q] != kNone && static_cast<unsigned>(skey[q] >> 32) == v; ++q) {
    const int slot = static_cast<int>(skey[q] & 0xffffffffu);
    int idx[L + 1];
    idx[0] = slot;
#pragma unroll
    for (int l = 0; l < L; ++l) idx[l + 1] = (idx[l] + f[l]) / kWindow;
    // close the windows this slot leaves, innermost first
    bool open = true;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      open = open && cur[l] >= 0 && cur[l] != idx[l + 1];
      if (open) {
        if (l + 1 < L) acc[l + 1 < L ? l + 1 : 0] = __fadd_rn(acc[l + 1 < L ? l + 1 : 0], acc[l]);
        else total = __fadd_rn(total, acc[l]);
        acc[l] = 0.f;
        cur[l] = -1;
      }
    }
    if (L == 0) total = __fadd_rn(total, s_cp[slot]);
    else acc[0] = __fadd_rn(acc[0], s_cp[slot]);
#pragma unroll
    for (int l = 0; l < L; ++l) cur[l] = idx[l + 1];
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (cur[l] < 0) continue;
    if (l + 1 < L) acc[l + 1 < L ? l + 1 : 0] = __fadd_rn(acc[l + 1 < L ? l + 1 : 0], acc[l]);
    else total = __fadd_rn(total, acc[l]);
  }
  return total;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool group_head(const u64* skey, int p) {
  return skey[p] != kNone && (p == 0 || (skey[p - 1] >> 32) != (skey[p] >> 32));
}

// LEVELS: window_levels(W)
template <int LEVELS>
__global__ void __launch_bounds__(kThreads, 1) steal_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int T = a.T, W = a.W, tid = threadIdx.x;
  // the work space's arrays, in shared memory: reloaded after each
  // barrier rather than held in registers through the round
  const Arrays& A = sh.ar;
  if (tid == 0) sh.ar = arrays(a.scratch ? a.scratch : smem, T, W);
  __syncthreads();
  unsigned long long* const stamp = tid == 0 ? a.stamps : nullptr;
  if (stamp) stamp[0] = globaltimer();
  for (int i = tid; i < T; i += kThreads) a.taken[i] = 0;
  for (int w = tid; w < W; w += kThreads) A.thr[w] = static_cast<float>(max(a.nthreads[w], 1));
  for (int b = tid; b < kBins; b += kThreads) sh.hist[b] = 0;
  __syncthreads();

  for (int round = 0; round < a.rounds; ++round) {
    unsigned long long* const st = stamp ? stamp + 1 + round * kPhases : nullptr;
    if (tid < 2) sh.count[tid] = 0;
    __syncthreads();
    // 1-2. loads and the two sort keys
    int n_th = 0, n_us = 0;
    for (int w = tid; w < A.wp; w += kThreads) {
      u64 e = kNone;
      if (w < W) {
        const float vl = __fdiv_rn(a.occ[w], A.thr[w]);
        A.vload[w] = vl;
        const bool thief = a.idle[w] && a.running[w];
        n_th += thief;
        e = (static_cast<u64>(sort_code(thief ? vl : INFINITY)) << 32) | static_cast<unsigned>(w);
      }
      A.wkey[w] = e;
    }
    __syncthreads();
    for (int i = tid; i < T; i += kThreads) {
      const int key = a.taken[i] ? kImax : a.key[i];
      const bool usable = key != kImax;
      n_us += usable;
      const float primary = usable ? -A.vload[a.victim[i]] : INFINITY;
      A.tkey[i] = (static_cast<u64>(sort_code(primary)) << 32) | static_cast<unsigned>(key);
    }
    if (n_th) atomicAdd(&sh.count[0], n_th);
    if (n_us) atomicAdd(&sh.count[1], n_us);
    __syncthreads();
    const int nc = min(min(sh.count[0], sh.count[1]), W);  // slots that may hold a candidate
    const int np = pow2_at_least(nc);
    if (st) st[0] = globaltimer();
    if (nc > 0) select_tasks(A.tkey, T, nc, A.sel, A.sidx, np, sh);
    if (st) st[1] = globaltimer();
    bitonic(A.wkey, nullptr, A.wp);
    if (st) st[2] = globaltimer();

    // the candidate slots, then their order by (victim, slot)
    for (int r = tid; r < A.wp; r += kThreads) {
      u64 e = kNone;
      if (r < nc) {
        const int task = A.sidx[r];
        const bool ok = !a.taken[task] && a.key[task] != kImax;
        const int v = a.victim[task];
        A.s_t[r] = task;
        A.s_th[r] = static_cast<int>(A.wkey[r] & 0xffffffffu);
        A.s_vic[r] = v;
        A.s_cp[r] = ok ? a.compute[task] : 0.f;
        A.s_tc[r] = ok ? a.cost[task] : 0.f;
        A.s_acc[r] = ok;
        if (ok) e = (static_cast<u64>(v) << 32) | static_cast<unsigned>(r);
      }
      A.skey[r] = e;
    }
    __syncthreads();
    bitonic(A.skey, nullptr, np);
    if (st) st[3] = globaltimer();

    // 3. others_cp: a thread a victim
    for (int p = tid; p < np; p += kThreads) {
      if (!group_head(A.skey, p)) continue;
      const float s = victim_sum<LEVELS>(A.skey, p, np, A.s_cp, W);
      for (int q = p; q < np && A.skey[q] != kNone && (A.skey[q] >> 32) == (A.skey[p] >> 32); ++q) {
        A.s_sum[A.skey[q] & 0xffffffffu] = s;
      }
    }
    __syncthreads();
    if (st) st[4] = globaltimer();
    // 4. the criterion
    for (int r = tid; r < nc; r += kThreads) {
      if (!A.s_acc[r]) continue;
      const int v = A.s_vic[r], th = A.s_th[r];
      const float cp = A.s_cp[r], tc = A.s_tc[r];
      const float others = __fsub_rn(A.s_sum[r], cp);
      const float lhs = __fadd_rn(__fadd_rn(A.vload[th], tc), cp);
      const float rhs = __fsub_rn(__fsub_rn(A.vload[v], __fdiv_rn(others, A.thr[v])), __fdiv_rn(cp, 2.f));
      A.s_acc[r] = (lhs <= rhs) && (v != th);
    }
    __syncthreads();
    if (st) st[5] = globaltimer();
    // 5. victims in slot order, then thieves, then retire loaded thieves
    for (int p = tid; p < np; p += kThreads) {
      if (!group_head(A.skey, p)) continue;
      const int v = static_cast<int>(A.skey[p] >> 32);
      float o = a.occ[v];
      for (int q = p; q < np && A.skey[q] != kNone && (A.skey[q] >> 32) == (A.skey[p] >> 32); ++q) {
        const int r = static_cast<int>(A.skey[q] & 0xffffffffu);
        if (A.s_acc[r]) o = __fadd_rn(o, -A.s_cp[r]);
      }
      a.occ[v] = o;
    }
    __syncthreads();
    for (int r = tid; r < nc; r += kThreads) {
      if (!A.s_acc[r]) continue;
      const int th = A.s_th[r];
      a.occ[th] = __fadd_rn(a.occ[th], __fadd_rn(A.s_cp[r], A.s_tc[r]));
      a.taken[A.s_t[r]] = 1;
      a.thief_of[A.s_t[r]] = th;
    }
    __syncthreads();
    for (int w = tid; w < W; w += kThreads) {
      if (a.idle[w] && __fdiv_rn(a.occ[w], A.thr[w]) > kLatency) a.idle[w] = 0;
    }
    __syncthreads();
    if (st) st[6] = globaltimer();
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
  return static_cast<size_t>(optin) - sizeof(Shared);  // the static scalars
}

template <int LEVELS>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        steal_kernel<LEVELS>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(refuse(err));
  }
  steal_kernel<LEVELS><<<1, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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
// shared memory, else dtpu_steal_layout's bytes of device memory; stamps:
// null, or u64 [1 + rounds * 7] for the phase timeline
extern "C" int dtpu_steal(const void* victim, const void* key, const void* cost,
                          const void* compute, const void* nthreads, const void* running,
                          void* occ, void* idle, void* thief_of, void* taken, void* scratch,
                          void* stamps, int T, int W, int rounds, void* stream_ptr) {
  if (T < 1 || W < 1 || rounds < 1 || window_levels(W) > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t total = layout(T, W).total;
  size_t smem = 0;
  if (scratch == nullptr) {
    if (total > smem_limit()) return static_cast<int>(cudaErrorInvalidValue);
    smem = total;
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
  a.stamps = static_cast<unsigned long long*>(stamps);
  a.T = T;
  a.W = W;
  a.rounds = rounds;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (window_levels(W)) {
    case 0: return launch<0>(a, smem, stream);
    case 1: return launch<1>(a, smem, stream);
    case 2: return launch<2>(a, smem, stream);
    case 3: return launch<3>(a, smem, stream);
    default: return launch<4>(a, smem, stream);
  }
}
