// The rebalance rounds (kernel K9).
//
// Replaces distributed_tpu/ops/rebalance.py::_rebalance_rounds
// (rebalance.py:43-105), the XLA program behind the scheduler's
// Scheduler.rebalance: a lax.fori_loop of K Jacobi rounds.  The plain
// version beside it is ops/rebalance.py::rebalance_rounds_reference.
//
// In each round the workers above hi = mean * 1.05 that still hold an
// eligible key (the senders) are ranked fullest first, those below
// lo = mean * 0.95 (the recipients) emptiest first, ties to the lower
// worker index as a stable argsort breaks them; slot i pairs the i-th
// sender with the i-th recipient while i is below both counts, and moves
// the sender's largest remaining eligible key there unless that would
// push the recipient past hi.  The moved key stops being eligible and the
// two memories change by its size.
//
// What the design does with that:
//   - the wrapper (ops/rebalance.py::owner_lists, torch ops, as the
//     reference takes its size order outside the rounds) buckets the
//     eligible keys by owner, stably in the order argsort(-nbytes), into
//     one list a worker with offsets, and the keys' sizes in list order;
//   - a sender's largest remaining candidate is then the head of its list:
//     a round clears only the keys it moves, each the head of its
//     sender's list, so one pointer a worker, advanced on each move,
//     replaces the reference's per-round segment_min over all N keys.
//     Each worker's head size sits in shared memory; a move copies the
//     next one in (cp.async) and the moved key's index into a slot's
//     staging word, both waited for only at the next round's first
//     barrier: no global load is on a round's chain;
//   - the rounds run in one block.  A round ranks only the candidates:
//     senders (from the front of a buffer) and recipients (from its back)
//     are compacted by a warp's ballot and one atomic a warp, each as a
//     u64 code, the key (-mem for a sender, mem for a recipient) mapped
//     to order-preserving bits above the worker's index, so that sorting
//     the codes is the stable sort.  Each warp sorts 32 codes in registers
//     (bitonic, by shuffles, no barrier); runs are then merged pairwise,
//     each code finding its place by a binary search in the other run
//     (log2 L + 1 compares at run length L), a barrier a level, until a
//     kind has at most kFinalRuns runs; a last step places each code by
//     its place in its run plus the count below it in every other run,
//     one binary search a run, all in lockstep.  At 512 workers that is
//     one merge and the last step, about 15 + 6 + 7 * 7 compares a code
//     instead of a count over every candidate of its kind.  Each kind's
//     region is padded to a multiple of 32 with codes above every
//     candidate's (the high word all ones), distinct by position;
//   - each worker is one sender or one recipient at most (hi >= lo for a
//     mean >= 0, which the wrapper checks), so each memory changes once a
//     round and the reference's segment sums add one value to 0: the
//     update is (mem - delta) + gain with __fsub_rn / __fadd_rn, and the
//     guard mem[r] + size <= hi with __fadd_rn, nothing contracted;
//   - only the moves are written, in application order (round, then
//     slot): a warp's ballot of its live slots goes to shared memory, and
//     after the round's last barrier one warp adds the warps' counts up and
//     each move goes to its place (the next round's second phase, or
//     after the last round, so that the staged loads and the count stay
//     off the round's chain: written at the round's end behind one more
//     barrier, the round's last phase took 0.7 us more at 512 workers on
//     an H100, the call 0.05 ms more than its 0.65); a count a round, and
//     the total;
//   - a round that moves nothing changes nothing, so every later round
//     would move nothing too: the run stops there, its later counts 0.
// So the kernel reproduces the plain version on the CPU bit for bit.
//
// Bound on an H100: neither bytes nor operations.  The moves (8 B each)
// are written once and only the moved keys are read.  What costs is the
// chain of rounds, each depending on the last: every step of a round is a
// __syncthreads apart in one 1,024-thread block, with the rounds' arrays
// (about 36 B a worker, layout()) in shared memory where they fit beside
// the kernel's own (to some 6,400 workers), else in the caller's global
// scratch: one instance of the kernel for each (in global memory the
// staged copies are plain loads and stores).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr u64 kPad = 0xffffffff00000000ull;  // | position: above every candidate's code
constexpr int kPhases = 5;  // a round's phases in the timeline (REBALANCE_PHASES)
constexpr int kFinalRuns = 8;  // runs a kind may have left for the last ranking step

struct Args {
  const int* list;        // [N]: each worker's eligible keys, largest first
  const float* size;      // [N]: their sizes, in list order
  const int* off;         // [W + 1]: where each worker's list starts; off[W] its end
  float hi, lo;           // mean * 1.05, mean * 0.95
  float* mem;             // [W] in / out
  int* moves;             // [cap][2] out: (key, recipient) of each move, in application order
  int* counts;            // [K] out: the moves of each round
  int* total;             // [1] out: all moves
  unsigned char* work;    // layout(W).total bytes of scratch, or null: shared memory
  // optional timeline, [1 + K * kPhases] of %globaltimer (ns): the start,
  // then the end of each phase of each round that ran; null: none
  unsigned long long* stamps;
  int W, K, cap;
};

struct Shared {
  int ns, nr;   // the round's senders and recipients
  int base;     // the moves before the round being written out
  int total;    // the moves of the rounds counted so far
};

// the rounds' arrays in the work space, byte offsets
struct Layout {
  size_t codes0, codes1;  // u64 [C] each: senders from the front, recipients from the back
  size_t mem, head, endp;  // f32 / i32 [W]: memory, each list's head and end
  size_t hsz;             // f32 [W]: the size of each worker's head key
  size_t mkey, mrcp;      // i32 [slots]: a slot's moved key (staged) and recipient
  size_t wmask, wpre;     // u32 / i32 [chunks]: a warp's live slots, the moves before it
  size_t total;
  int C, slots, chunks;
};

__host__ __device__ inline Layout layout(int W) {
  Layout l;
  l.C = (W + 31) / 32 * 32 + 64;  // both kinds, each padded to a multiple of 32
  l.slots = W / 2 > 0 ? W / 2 : 1;  // a round pairs at most min(senders, recipients)
  l.chunks = (l.slots + 31) / 32;
  const size_t w = static_cast<size_t>(W), c = static_cast<size_t>(l.C);
  const size_t s = static_cast<size_t>(l.slots), ch = static_cast<size_t>(l.chunks);
  l.codes0 = 0;
  l.codes1 = 8 * c;
  l.mem = 16 * c;
  l.head = l.mem + 4 * w;
  l.endp = l.head + 4 * w;
  l.hsz = l.endp + 4 * w;
  l.mkey = l.hsz + 4 * w;
  l.mrcp = l.mkey + 4 * s;
  l.wmask = l.mrcp + 4 * s;
  l.wpre = l.wmask + 4 * ch;
  l.total = l.wpre + 4 * ch;
  return l;
}

// a float's order as an unsigned int (-0 and +0 the same), above an index
__device__ __forceinline__ u64 code(float key, int idx) {
  unsigned u = __float_as_uint(__fadd_rn(key, 0.0f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | static_cast<unsigned>(idx);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// a 4-byte word from global memory into the work space: asynchronous
// (cp.async, waited for by cp_wait) when the work space is shared memory
template <bool kShared>
__device__ __forceinline__ void stage(void* dst, const void* src) {
  if (kShared) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    *static_cast<int*>(dst) = *static_cast<const int*>(src);
  }
}

__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// 32 codes sorted ascending across a warp's lanes (bitonic, by shuffles)
__device__ __forceinline__ u64 warp_sort(u64 v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, v, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
    }
  }
  return v;
}

// how many of the sorted b[0, n) lie below c, for n <= L (a power of two)
__device__ __forceinline__ int below(const u64* b, int n, int L, u64 c) {
  int r = 0;
  for (int step = L; step > 0; step >>= 1) {
    const int m = r + step;
    if (m <= n && b[m - 1] < c) r = m;
  }
  return r;
}

// one warp: the moves of the round whose `np` slots left their live masks
// in wmask, counted; wpre[c] the moves of the chunks before chunk c,
// counts[k] and the running total
__device__ __forceinline__ void count_moves(const Args& a, const unsigned* wmask, int* wpre,
                                            Shared& sh, int k, int np, int lane) {
  const int chunks = (np + 31) / 32;
  int carry = 0;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lane;
    const int n = c < chunks ? __popc(wmask[c]) : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (c < chunks) wpre[c] = carry + incl - n;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) {
    a.counts[k] = carry;
    sh.base = sh.total;
    sh.total += carry;
  }
}

// each live slot's move to its place: after count_moves and a barrier
__device__ __forceinline__ void write_moves(const Args& a, const unsigned* wmask, const int* wpre,
                                            const int* mkey, const int* mrcp, int base, int np,
                                            int t) {
  for (int i = t; i < np; i += kThreads) {
    const unsigned m = wmask[i >> 5];
    if ((m >> (i & 31)) & 1u) {
      const int at = base + wpre[i >> 5] + __popc(m & ((1u << (i & 31)) - 1u));
      if (at < a.cap) {
        a.moves[2 * at] = mkey[i];
        a.moves[2 * at + 1] = mrcp[i];
      }
    }
  }
}

// kShared: the work space is the block's shared memory (then the
// compiler addresses it as such), else the caller's global scratch
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1) rebalance_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int W = a.W, K = a.K;
  const Layout L = layout(W);
  unsigned char* const wbase = kShared ? smem : a.work;
  u64* const codes0 = reinterpret_cast<u64*>(wbase + L.codes0);
  u64* const codes1 = reinterpret_cast<u64*>(wbase + L.codes1);
  float* const mem = reinterpret_cast<float*>(wbase + L.mem);
  int* const head = reinterpret_cast<int*>(wbase + L.head);
  int* const endp = reinterpret_cast<int*>(wbase + L.endp);
  float* const hsz = reinterpret_cast<float*>(wbase + L.hsz);
  int* const mkey = reinterpret_cast<int*>(wbase + L.mkey);
  int* const mrcp = reinterpret_cast<int*>(wbase + L.mrcp);
  unsigned* const wmask = reinterpret_cast<unsigned*>(wbase + L.wmask);
  int* const wpre = reinterpret_cast<int*>(wbase + L.wpre);
  const int C = L.C;
  if (t == 0) sh.ns = sh.nr = sh.base = sh.total = 0;
  for (int w = t; w < W; w += kThreads) {
    const int h = a.off[w], e = a.off[w + 1];
    head[w] = h;
    endp[w] = e;
    hsz[w] = h < e ? a.size[h] : 0.0f;
    // the reference's (mem - 0) + 0 of a worker that never moves: -0 becomes +0
    mem[w] = __fadd_rn(__fsub_rn(a.mem[w], 0.0f), 0.0f);
  }
  __syncthreads();
  unsigned long long* const stamp = t == 0 ? a.stamps : nullptr;
  if (stamp) stamp[0] = globaltimer();
  const float hi = a.hi, lo = a.lo;
  int k = 0, np_last = 0;  // the rounds run; the last one's slots
  bool pending = false;    // the last round's moves not yet written out
  while (k < K) {
    unsigned long long* const st = stamp ? stamp + 1 + k * kPhases : nullptr;
    // compaction: the last round's moves counted (by the last warp, idle
    // here below 993 workers); each kind's candidates as codes, in no
    // particular order, senders at the front of codes0 and recipients at
    // its back; the staged copies landed
    if (pending && warp == kWarps - 1) count_moves(a, wmask, wpre, sh, k - 1, np_last, lane);
    const unsigned lanes_below = (1u << lane) - 1u;
    for (int base = 0; base < W; base += kThreads) {
      const int w = base + t;
      bool snd = false, rcp = false;
      float m = 0.0f;
      if (w < W) {
        m = mem[w];
        snd = m > hi && head[w] < endp[w];
        rcp = m < lo;
      }
      const unsigned bs = __ballot_sync(kFull, snd), br = __ballot_sync(kFull, rcp);
      int at_s = 0, at_r = 0;
      if (lane == 0) {
        if (bs) at_s = atomicAdd(&sh.ns, __popc(bs));
        if (br) at_r = atomicAdd(&sh.nr, __popc(br));
      }
      at_s = __shfl_sync(kFull, at_s, 0) + __popc(bs & lanes_below);
      at_r = __shfl_sync(kFull, at_r, 0) + __popc(br & lanes_below);
      if (snd) codes0[at_s] = code(-m, w);
      if (rcp) codes0[C - 1 - at_r] = code(m, w);
    }
    if (kShared) cp_wait();
    __syncthreads();
    if (st) st[0] = globaltimer();
    // sort: the last round's moves written out; each warp sorts runs of 32
    const int ns = sh.ns, nr = sh.nr, np = min(ns, nr);
    if (pending) write_moves(a, wmask, wpre, mkey, mrcp, sh.base, np_last, t);
    pending = false;
    const int ps = (ns + 31) / 32 * 32, pr = (nr + 31) / 32 * 32, r0 = C - pr;
    const int wide = max(ps, pr);
    if (np > 0) {
      for (int run = warp; run < (ps + pr) / 32; run += kWarps) {
        const int e = run * 32 + lane;
        const bool snd = e < ps;
        const int q = snd ? e : e - ps;  // the code's place in its kind's region
        const bool real = snd ? q < ns : q >= pr - nr;
        u64* const at = codes0 + (snd ? q : r0 + q);
        const u64 v = warp_sort(real ? *at : kPad | static_cast<unsigned>(q), lane);
        // the run's sorted codes back to its place, lane i the i-th
        at[0] = v;
      }
    }
    __syncthreads();
    if (st) st[1] = globaltimer();
    // merge: runs of 1 << lg merged pairwise, a barrier a level, while a
    // kind has more than kFinalRuns runs; then each code placed among the
    // runs left, the count below it in each other run summed
    u64* src = codes0;
    u64* dst = codes1;
    if (np > 0) {
      int lg = 5;
      for (; ((wide - 1) >> lg) + 1 > kFinalRuns; ++lg) {
        const int Lr = 1 << lg;
        for (int e = t; e < ps + pr; e += kThreads) {
          const bool snd = e < ps;
          const int q = snd ? e : e - ps, n = snd ? ps : pr, s0 = snd ? 0 : r0;
          const u64 c = src[s0 + q];
          const int run = q >> lg, other = (run ^ 1) << lg;
          int p = q;
          if (other < n) {
            p = ((run & ~1) << lg) + (q & (Lr - 1)) + below(src + s0 + other, min(Lr, n - other), Lr, c);
          }
          dst[s0 + p] = c;
        }
        u64* const tmp = src;
        src = dst;
        dst = tmp;
        __syncthreads();
      }
      const int Lr = 1 << lg;
      for (int e = t; e < ps + pr; e += kThreads) {
        const bool snd = e < ps;
        const int q = snd ? e : e - ps, n = snd ? ps : pr;
        const u64* const b = src + (snd ? 0 : r0);
        const u64 c = b[q];
        const int run = q >> lg;
        int nj[kFinalRuns], r[kFinalRuns];
#pragma unroll
        for (int j = 0; j < kFinalRuns; ++j) {
          nj[j] = j == run ? 0 : min(Lr, n - (j << lg));  // <= 0: no such run
          r[j] = 0;
        }
        for (int step = Lr; step > 0; step >>= 1) {
#pragma unroll
          for (int j = 0; j < kFinalRuns; ++j) {
            const int m = r[j] + step;
            if (m <= nj[j] && b[(j << lg) + m - 1] < c) r[j] = m;
          }
        }
        int p = q & (Lr - 1);
#pragma unroll
        for (int j = 0; j < kFinalRuns; ++j) p += r[j];
        dst[(snd ? 0 : r0) + p] = c;
      }
      u64* const tmp = src;
      src = dst;
      dst = tmp;
      __syncthreads();
    }
    if (st) st[2] = globaltimer();
    // moves: slot i pairs the i-th sender with the i-th recipient
    bool moved = false;
    for (int i = t; i < ((np + 31) & ~31); i += kThreads) {
      bool live = false;
      if (i < np) {
        const int s = static_cast<int>(src[i] & 0xffffffffu);
        const int r = static_cast<int>(src[r0 + i] & 0xffffffffu);
        const float size = hsz[s], mr = mem[r];
        if (__fadd_rn(mr, size) <= hi) {
          const float d = __fadd_rn(0.0f, size);  // the segment sum of one value
          mem[s] = __fadd_rn(__fsub_rn(mem[s], d), 0.0f);
          mem[r] = __fadd_rn(__fsub_rn(mr, 0.0f), d);
          const int h = head[s];
          head[s] = h + 1;
          stage<kShared>(mkey + i, a.list + h);
          if (h + 1 < endp[s]) stage<kShared>(hsz + s, a.size + h + 1);
          mrcp[i] = r;
          live = true;
        }
      }
      const unsigned m = __ballot_sync(kFull, live);
      if (lane == 0) wmask[i >> 5] = m;
      moved |= live;
    }
    if (st) st[3] = globaltimer();
    if (t == 0) sh.ns = sh.nr = 0;
    ++k;
    np_last = np;
    pending = true;
    const bool any = __syncthreads_or(moved);
    if (st) st[4] = globaltimer();
    if (!any) break;
  }
  // the last round's moves (none if it moved nothing); the rounds not run
  if (pending) {
    if (warp == 0) count_moves(a, wmask, wpre, sh, k - 1, np_last, lane);
    if (kShared) cp_wait();
    __syncthreads();
    write_moves(a, wmask, wpre, mkey, mrcp, sh.base, np_last, t);
  }
  for (int r = k + t; r < K; r += kThreads) a.counts[r] = 0;
  if (t == 0) *a.total = sh.total;
  for (int w = t; w < W; w += kThreads) a.mem[w] = mem[w];
}

}  // namespace

// the work space of W workers: its bytes, and whether it fits in the
// block's shared memory beside the kernel's own static shared memory (then
// the launch takes a null scratch)
extern "C" int dtpu_rebalance_layout(int W, long long* bytes, int* shared) {
  if (W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = layout(W).total;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, rebalance_kernel<true>);
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left behind for the next launch's check
    return static_cast<int>(err);
  }
  *bytes = static_cast<long long>(need);
  *shared = need + fa.sharedSizeBytes <= static_cast<size_t>(optin);
  return 0;
}

// all K rounds of W workers in one launch of one block: list, size and off
// from owner_lists; work, null to work in shared memory (where
// dtpu_rebalance_layout says it fits), else its bytes of device memory;
// moves [cap][2], counts [K] and total [1] out; mem updated in place;
// stamps: null, or u64 [1 + K * 5] for the phase timeline
extern "C" int dtpu_rebalance(const void* list, const void* size, const void* off, float hi,
                              float lo, void* mem, void* moves,
                              void* counts, void* total, void* work, void* stamps, int W, int K,
                              int cap, void* stream_ptr) {
  if (W < 1 || K < 1 || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (work == nullptr) {  // dtpu_rebalance_layout said it fits; the card refuses it if not
    smem = layout(W).total;
    const cudaError_t err = cudaFuncSetAttribute(
        rebalance_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  Args a;
  a.list = static_cast<const int*>(list);
  a.size = static_cast<const float*>(size);
  a.off = static_cast<const int*>(off);
  a.hi = hi;
  a.lo = lo;
  a.mem = static_cast<float*>(mem);
  a.moves = static_cast<int*>(moves);
  a.counts = static_cast<int*>(counts);
  a.total = static_cast<int*>(total);
  a.work = static_cast<unsigned char*>(work);
  a.stamps = static_cast<unsigned long long*>(stamps);
  a.W = W;
  a.K = K;
  a.cap = cap;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (work == nullptr) {
    rebalance_kernel<true><<<1, kThreads, smem, stream>>>(a);
  } else {
    rebalance_kernel<false><<<1, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
