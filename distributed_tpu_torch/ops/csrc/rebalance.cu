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
//     one list a worker with offsets;
//   - a sender's largest remaining candidate is then the head of its list:
//     a round clears only the keys it moves, each the head of its
//     sender's list, so one pointer a worker, advanced on each move,
//     replaces the reference's per-round segment_min over all N keys;
//   - the rounds run in one block.  A round ranks only the candidates:
//     senders and recipients are compacted (a warp's ballot, one atomic a
//     warp; their order there does not matter) with a u64 code each, the
//     key (-mem for a sender, mem for a recipient) mapped to
//     order-preserving bits above the worker's index, and each ranks
//     itself by counting the codes of its kind below its own, which is
//     what the stable sort gives.  The count is quadratic in the
//     candidates: at 512 workers a round costs a few microseconds; past
//     some thousands of candidates a block sort would be cheaper;
//   - each worker is one sender or one recipient at most (hi >= lo for a
//     mean >= 0, which the wrapper checks), so each memory changes once a
//     round and the reference's segment sums add one value to 0: the
//     update is (mem - delta) + gain with __fsub_rn / __fadd_rn, and the
//     guard mem[r] + size <= hi with __fadd_rn, nothing contracted;
//   - a round that moves nothing changes nothing, so every later round
//     would move nothing too: the run stops there and fills the rows it
//     did not run with -1.
// So the kernel reproduces the plain version on the CPU bit for bit.
//
// Bound on an H100: neither bytes nor operations.  The moves (8 B a slot a
// round) are written once and only the moved keys are read.  What costs is
// the chain of rounds, each depending on the last: every step of a round is
// a __syncthreads apart in one 1,024-thread block, with the rounds' arrays
// (36 B a worker) in shared memory where they fit beside the kernel's own
// (to ~6,450 workers), else in the caller's global scratch, through the
// same generic pointers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kWorkBytes = 36;  // the rounds' arrays, bytes a worker

struct Args {
  const int* list;          // [N]: each worker's eligible keys, largest first
  const float* nbytes;      // [N]
  const int* off;           // [W + 1]: where each worker's list starts; off[W] its end
  const float* hi;          // [1]: mean * 1.05
  const float* lo;          // [1]: mean * 0.95
  float* mem;               // [W] in / out
  int* mk;                  // [K][W] out: the key moved in a round's slot, or -1
  int* md;                  // [K][W] out: its recipient, or -1
  unsigned char* work;      // [kWorkBytes * W] scratch, unless in shared memory
  int W, K;
  int work_shared;
};

struct Shared {
  int ns, nr;  // the round's senders and recipients
};

// a float's order as an unsigned int (-0 and +0 the same), above an index
__device__ __forceinline__ u64 code(float key, int idx) {
  unsigned u = __float_as_uint(__fadd_rn(key, 0.0f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<u64>(u) << 32) | static_cast<unsigned>(idx);
}

// a lane's code onto the senders' or the recipients' compacted list, the
// warp's lanes at once (one atomic a list a warp); every lane calls it
__device__ __forceinline__ void push(bool to_s, bool to_r, u64 c, u64* scand, u64* rcand,
                                     Shared& sh, int lane) {
  const unsigned below = (1u << lane) - 1u;
  const unsigned bs = __ballot_sync(kFull, to_s), br = __ballot_sync(kFull, to_r);
  int base_s = 0, base_r = 0;
  if (lane == 0) {
    if (bs) base_s = atomicAdd(&sh.ns, __popc(bs));
    if (br) base_r = atomicAdd(&sh.nr, __popc(br));
  }
  base_s = __shfl_sync(kFull, base_s, 0);
  base_r = __shfl_sync(kFull, base_r, 0);
  if (to_s) scand[base_s + __popc(bs & below)] = c;
  if (to_r) rcand[base_r + __popc(br & below)] = c;
}

__global__ void __launch_bounds__(kThreads, 1) rebalance_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared sh;
  const int t = threadIdx.x, lane = t & 31;
  const int W = a.W, K = a.K;
  const size_t w_sz = static_cast<size_t>(W);

  unsigned char* wbase = a.work_shared ? smem : a.work;
  u64* scand = reinterpret_cast<u64*>(wbase);
  u64* rcand = scand + W;
  float* mem = reinterpret_cast<float*>(rcand + W);
  int* head = reinterpret_cast<int*>(mem + W);
  int* endp = head + W;
  int* sslot = endp + W;   // slot -> sender
  int* rslot = sslot + W;  // slot -> recipient
  if (t == 0) sh.ns = sh.nr = 0;
  for (int w = t; w < W; w += kThreads) {
    head[w] = a.off[w];
    endp[w] = a.off[w + 1];
    // the reference's (mem - 0) + 0 of a worker that never moves: -0 becomes +0
    mem[w] = __fadd_rn(__fsub_rn(a.mem[w], 0.0f), 0.0f);
  }
  __syncthreads();
  const float hi = *a.hi, lo = *a.lo;
  int k = 0;
  while (k < K) {
    // the candidates of each kind, compacted in no particular order
    for (int base = 0; base < W; base += kThreads) {
      const int w = base + t;
      bool snd = false, rcp = false;
      float m = 0.0f;
      if (w < W) {
        m = mem[w];
        snd = m > hi && head[w] < endp[w];
        rcp = m < lo;
      }
      push(snd, rcp, code(snd ? -m : m, w), scand, rcand, sh, lane);
    }
    __syncthreads();
    const int ns = sh.ns, nr = sh.nr, np = min(ns, nr);
    // each candidate's rank among its kind: its slot
    for (int i = t; i < ns + nr; i += kThreads) {
      const bool snd = i < ns;
      const u64* c = snd ? scand : rcand;
      const int n = snd ? ns : nr;
      const u64 me = c[snd ? i : i - ns];
      int r = 0;
#pragma unroll 4
      for (int j = 0; j < n; ++j) r += c[j] < me;
      if (r < np) (snd ? sslot : rslot)[r] = static_cast<int>(me & 0xffffffffu);
    }
    __syncthreads();
    // each slot's move, the row, and the two memories
    bool moved = false;
    int* mkrow = a.mk + static_cast<size_t>(k) * w_sz;
    int* mdrow = a.md + static_cast<size_t>(k) * w_sz;
    for (int i = t; i < W; i += kThreads) {
      int key = -1, to = -1;
      if (i < np) {
        const int s = sslot[i], r = rslot[i];
        const int h = head[s];
        const int kk = a.list[h];
        const float size = a.nbytes[kk];
        const float mr = mem[r];
        if (__fadd_rn(mr, size) <= hi) {
          const float d = __fadd_rn(0.0f, size);  // the segment sum of one value
          mem[s] = __fadd_rn(__fsub_rn(mem[s], d), 0.0f);
          mem[r] = __fadd_rn(__fsub_rn(mr, 0.0f), d);
          head[s] = h + 1;
          key = kk;
          to = r;
          moved = true;
        }
      }
      mkrow[i] = key;
      mdrow[i] = to;
    }
    if (t == 0) sh.ns = sh.nr = 0;
    ++k;
    if (!__syncthreads_or(moved)) break;
  }
  // the rounds after one that moved nothing: nothing moves
  for (size_t i = static_cast<size_t>(k) * w_sz + t; i < static_cast<size_t>(K) * w_sz; i += kThreads) {
    a.mk[i] = -1;
    a.md[i] = -1;
  }
  for (int w = t; w < W; w += kThreads) a.mem[w] = mem[w];
}

}  // namespace

// all K rounds of W workers in one launch of one block: list and off from
// owner_lists; work, kWorkBytes * W bytes of device memory (ops/rebalance.py's
// WORK_BYTES), used where the rounds' arrays do not fit the block's shared
// memory beside the kernel's own static shared memory; mem is updated in place
extern "C" int dtpu_rebalance(const void* list, const void* nbytes, const void* off,
                              const void* hi, const void* lo, void* mem, void* mk, void* md,
                              void* work, int W, int K, void* stream_ptr) {
  if (W < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, rebalance_kernel);
  const size_t need = kWorkBytes * static_cast<size_t>(W);
  const bool shared = err == cudaSuccess && need + fa.sharedSizeBytes <= static_cast<size_t>(optin);
  const size_t smem = shared ? need : 0;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(rebalance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // not left behind for the next launch's check
    return static_cast<int>(err);
  }
  Args a;
  a.list = static_cast<const int*>(list);
  a.nbytes = static_cast<const float*>(nbytes);
  a.off = static_cast<const int*>(off);
  a.hi = static_cast<const float*>(hi);
  a.lo = static_cast<const float*>(lo);
  a.mem = static_cast<float*>(mem);
  a.mk = static_cast<int*>(mk);
  a.md = static_cast<int*>(md);
  a.work = static_cast<unsigned char*>(work);
  a.W = W;
  a.K = K;
  a.work_shared = shared;
  rebalance_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

