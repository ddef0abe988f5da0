// The Active Memory Manager's replica-drop rounds (kernel K8).
//
// Replaces distributed_tpu/ops/amm.py::_drop_rounds (amm.py:43-74), the XLA
// program the scheduler's ReduceReplicas policy runs every AMM round.  The
// plain version beside it is ops/amm.py::drop_rounds_reference.
//
// Each of the K rounds:
//   1. every row (a replicated task) still asked to drop and holding more
//      than one replica picks the first maximum of its score row, which is
//      the worker's projected memory on the row's eligible holders (held,
//      not excluded) and -inf elsewhere; the pick drops only if it is
//      eligible (a row without one keeps its replicas: the argmax of an
//      all -inf row is worker 0, which is not eligible);
//   2. each worker's memory shrinks by the bytes its rows dropped, summed
//      in row order as the reference's segment_sum adds them on the CPU,
//      then is floored at 0.
//
// Bound on an H100: bytes.  The replica and exclusion matrices, one byte
// a (row, worker), are read once (16 MB at 16,384 rows x 512 workers,
// ~5 us at 3.35 TB/s); the drops are written once.  The sums of step 2
// must keep row order, and the rounds depend on each other, so all rounds
// run in one cooperative launch.  Each block owns a contiguous range of
// rows and one of workers.  A prologue, a warp a row, counts the row's
// replicas and writes its eligible holders as a list of worker indices
// (int16 while W fits, else int32) into the row's own slot of an [R, W]
// scratch, with their count: a row is read densely once, and a round
// reads only its list, one coalesced load a lane for up to 32 holders
// (AMM rows hold a few replicas of W).  A round is four phases, each
// ending at a grid barrier:
//
//   picks: a warp a row that still drops: the first maximum of mem over
//     the row's list, ties to the lowest worker; the dropped holder leaves
//     the list (the last entry takes its place: ties break by index, so
//     the list's order does not matter); each drop counted for its
//     (block, worker)
//   | a warp a worker of the block's range: each block's offset in the
//     worker's bucket (block order is row order) and the worker's total;
//     the block's workers' bucket starts within its range
//   | every block: where each block's range of buckets starts; the
//     block's drops placed in their workers' buckets in row order (one
//     warp, 32 rows a step, equal workers ranked by lane)
//   | a warp a worker of the block's range: its bucket added in order,
//     then the floor; its counts cleared for the next round
//
// This is a stable bucketing of the round's drops by worker, so each
// worker adds only its own drops.  The run of rounds stops early after a
// round that dropped nothing: the rounds after it would drop nothing
// either.  With in-order sums the kernel reproduces the plain version on
// the CPU bit for bit, whatever its grid.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxBlocks = 1024;  // the block prefix lives in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunks = 4;  // the prologue's loads a lane in flight

struct Args {
  uint8_t* holders;         // [R][W], cleared as replicas drop
  void* list;               // [R][W] scratch of Idx: a row's eligible holders
  int* count;               // [R] scratch: the length of a row's list
  const uint8_t* excluded;  // [R][W]
  const float* nbytes;      // [R]
  int* ndrop;               // [R], counted down
  float* mem;               // [W] in/out
  int* drops;               // [R][K] out, preset -1
  int* pick;                // [R] scratch: the round's dropper, or -1
  int* nrep;                // [R] scratch: replicas left
  float* bucket;            // [R] scratch: the round's dropped bytes by worker, in row order
  int* total;               // [W] scratch: the round's drops a worker
  int* lstart;              // [W] scratch: a worker's bucket start within its block's range
  int* btot;                // [blocks] scratch: the round's drops to a block's workers
  int* bcnt;                // [blocks][W] scratch: a block's drops a worker, then offsets
  // optional timeline, [2 + K * 4] of %globaltimer (ns) taken by block 0
  // after each grid barrier: the start, the prologue's end, then the end
  // of each phase of each round that ran; null: none
  unsigned long long* stamps;
  int R, W, K;
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// s_pre[i] = btot[0] + ... + btot[i - 1] for i = 0..nb, by the whole block
__device__ void block_prefix(const int* btot, int nb, int* s_pre, int* s_warp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (nb + kThreads - 1) / kThreads;
  const int i0 = min(nb, static_cast<int>(threadIdx.x) * per), i1 = min(nb, i0 + per);
  int sum = 0;
  for (int i = i0; i < i1; ++i) sum += __ldcg(btot + i);
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int run = incl - sum, all = 0;
  for (int j = 0; j < kWarps; ++j) {
    if (j < warp) run += s_warp[j];
    all += s_warp[j];
  }
  for (int i = i0; i < i1; ++i) {
    s_pre[i] = run;
    run += __ldcg(btot + i);
  }
  if (threadIdx.x == 0) s_pre[nb] = all;
  __syncthreads();
}

// Idx: the list's entry, int16_t while W <= 32,767, else int
template <typename Idx>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) amm_drop_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_pre[kMaxBlocks + 1];
  __shared__ int s_warp[kWarps];
  const int R = a.R, W = a.W;
  const int nb = gridDim.x, b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpb = (R + nb - 1) / nb, wpb = (W + nb - 1) / nb;
  const int r0 = min(R, b * rpb), r1 = min(R, r0 + rpb);
  const int w0 = min(W, b * wpb), w1 = min(W, w0 + wpb);
  int* my_cnt = a.bcnt + static_cast<size_t>(b) * W;
  unsigned long long* const stamp = b == 0 && threadIdx.x == 0 ? a.stamps : nullptr;
  if (stamp) stamp[0] = globaltimer();

  Idx* const list = static_cast<Idx*>(a.list);
  const unsigned below_lane = (1u << lane) - 1;
  for (int r = r0 + warp; r < r1; r += kWarps) {
    const size_t row = static_cast<size_t>(r) * W;
    int c = 0, n = 0;
    for (int base = 0; base < W; base += 32 * kChunks) {
      // kChunks loads a lane in flight before the list's stores
      uint8_t held[kChunks], out[kChunks];
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int w = base + 32 * j + lane;
        held[j] = w < W ? a.holders[row + w] : 0;
        out[j] = w < W ? a.excluded[row + w] : 1;
      }
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const bool can = held[j] && !out[j];
        c += held[j] != 0;
        const unsigned m = __ballot_sync(kFull, can);
        if (can) list[row + n + __popc(m & below_lane)] = static_cast<Idx>(base + 32 * j + lane);
        n += __popc(m);
      }
    }
    c = __reduce_add_sync(kFull, c);
    if (lane == 0) {
      a.nrep[r] = c;
      a.count[r] = n;
    }
  }
  for (int w = threadIdx.x; w < W; w += kThreads) my_cnt[w] = 0;
  grid.sync();
  if (stamp) stamp[1] = globaltimer();

  for (int k = 0; k < a.K; ++k) {
    unsigned long long* const st = stamp ? stamp + 2 + 4 * k : nullptr;
    // 1. a warp a row: the first maximum of mem over the row's list; the
    //    dense row's argmax is worker 0 where every score is -inf, which
    //    drops only if worker 0 is eligible.  A warp's rows are r0 + warp
    //    + q * kWarps; a lane loads the state of one of 32 of them at once
    //    (only this warp writes a row's state, so what it loaded is what
    //    it updates), and the warp walks the rows that still drop
    for (int q0 = 0; r0 + warp + q0 * kWarps < r1; q0 += 32) {
      const int rl = r0 + warp + (q0 + lane) * kWarps;
      int nl = 0, left = 0, reps = 0;
      bool live = false;
      if (rl < r1) {
        nl = __ldcg(a.count + rl);
        left = __ldcg(a.ndrop + rl);
        reps = __ldcg(a.nrep + rl);
        live = nl > 0 && left > 0 && reps > 1;
        if (!live) a.pick[rl] = -1;
      }
      for (unsigned todo = __ballot_sync(kFull, live); todo; todo &= todo - 1) {
        const int src = __ffs(todo) - 1;
        const int r = r0 + warp + (q0 + src) * kWarps;
        const int n = __shfl_sync(kFull, nl, src);
        const int row_left = __shfl_sync(kFull, left, src), row_reps = __shfl_sync(kFull, reps, src);
        const size_t row = static_cast<size_t>(r) * W;
        float best = -INFINITY;
        int bi = 0x7fffffff, at = -1, mine = 0;  // mine: the lane's last entry read
        for (int j = lane; j < n; j += 32) {
          const int w = __ldcg(list + row + j);
          mine = w;
          const float s = __ldcg(a.mem + w);
          if (s > best || (s == best && w < bi)) {
            best = s;
            bi = w;
            at = j;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ob = __shfl_xor_sync(kFull, best, off);
          const int oi = __shfl_xor_sync(kFull, bi, off);
          const int oa = __shfl_xor_sync(kFull, at, off);
          if (ob > best || (ob == best && oi < bi)) {
            best = ob;
            bi = oi;
            at = oa;
          }
        }
        const int p = best == -INFINITY && bi != 0 ? -1 : bi;
        const int tail = __shfl_sync(kFull, mine, (n - 1) & 31);  // the list's last entry
        if (lane == 0) {
          a.pick[r] = p;
          if (p >= 0) {
            a.holders[row + p] = 0;
            a.ndrop[r] = row_left - 1;
            a.nrep[r] = row_reps - 1;
            a.drops[static_cast<size_t>(r) * a.K + k] = p;
            atomicAdd(my_cnt + p, 1);
            list[row + at] = static_cast<Idx>(tail);
            a.count[r] = n - 1;
          }
        }
      }
    }
    grid.sync();
    if (st) st[0] = globaltimer();

    // 2. a warp a worker of the block's range: the blocks' offsets in its
    //    bucket and its total; then the range's bucket starts
    for (int w = w0 + warp; w < w1; w += kWarps) {
      int carry = 0;
      for (int base = 0; base < nb; base += 32) {
        const int i = base + lane;
        int* at = a.bcnt + static_cast<size_t>(i) * W + w;
        const int c = i < nb ? __ldcg(at) : 0;
        int incl = c;
        for (int off = 1; off < 32; off <<= 1) {
          const int n = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += n;
        }
        if (i < nb) *at = carry + incl - c;
        carry += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) a.total[w] = carry;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
      for (int w = w0; w < w1; ++w) {
        a.lstart[w] = run;
        run += __ldcg(a.total + w);
      }
      a.btot[b] = run;
    }
    grid.sync();
    if (st) st[1] = globaltimer();

    // 3. the block's drops into their workers' buckets, in row order
    block_prefix(a.btot, nb, s_pre, s_warp);
    const int n_drops = s_pre[nb];
    if (warp == 0) {
      for (int base = r0; base < r1; base += 32) {
        const int r = base + lane;
        const int p = r < r1 ? __ldcg(a.pick + r) : -1;
        const unsigned act = __ballot_sync(kFull, p >= 0);
        if (p >= 0) {
          const unsigned peers = __match_any_sync(act, p);
          const int first = __ldcg(my_cnt + p);
          const int pos = first + __popc(peers & ((1u << lane) - 1));
          __syncwarp(act);
          if (lane == __ffs(peers) - 1) __stcg(my_cnt + p, first + __popc(peers));
          a.bucket[s_pre[p / wpb] + __ldcg(a.lstart + p) + pos] = a.nbytes[r];
        }
        __syncwarp();
      }
    }
    grid.sync();
    if (st) st[2] = globaltimer();

    // 4. a warp a worker of the block's range: its bytes in row order,
    //    then the floor; its counts cleared for the next round
    for (int w = w0 + warp; w < w1; w += kWarps) {
      const int n = __ldcg(a.total + w);
      const float* mine = a.bucket + s_pre[b] + __ldcg(a.lstart + w);
      float shed = 0.f;
      for (int base = 0; base < n; base += 32) {
        const float x = base + lane < n ? __ldcg(mine + base + lane) : 0.f;
        const int m = min(32, n - base);
        for (int j = 0; j < m; ++j) shed = __fadd_rn(shed, __shfl_sync(kFull, x, j));
      }
      if (lane == 0) a.mem[w] = fmaxf(__fsub_rn(__ldcg(a.mem + w), shed), 0.f);
      for (int i = lane; i < nb; i += 32) a.bcnt[static_cast<size_t>(i) * W + w] = 0;
    }
    grid.sync();
    if (st) st[3] = globaltimer();
    if (n_drops == 0) break;
  }
}

cudaError_t refuse(cudaError_t err) {
  cudaGetLastError();  // not left behind for the next launch's check
  return err;
}

// the multiprocessors and the blocks of the kernel each can hold
template <typename Idx>
int grid_limits(int* sms, int* occ) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, amm_drop_kernel<Idx>, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(refuse(err));
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (*occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return 0;
}

constexpr int kShortList = 32767;  // the most workers int16 lists hold

int limits(int W, int* sms, int* occ) {
  return W <= kShortList ? grid_limits<int16_t>(sms, occ) : grid_limits<int>(sms, occ);
}

}  // namespace

// the default grid for W workers: two blocks a multiprocessor, or as many
// as can be resident, at most 1,024
extern "C" int dtpu_amm_drop_grid(int W, int* blocks) {
  int sms = 0, occ = 0;
  const int err = limits(W, &sms, &occ);
  if (err != 0) return err;
  *blocks = sms * (occ < kBlocksPerSm ? occ : kBlocksPerSm);
  if (*blocks > kMaxBlocks) *blocks = kMaxBlocks;
  return 0;
}

// all K rounds in one cooperative launch of `blocks` blocks (at most as
// many as can be resident, and 1,024); scratch: 4 * R + 2 * W + blocks *
// (W + 1) ints; list: R * W entries of int16 while W <= 32,767, else of
// int32.  holders and ndrop are changed in place.  stamps: null, or u64
// [2 + 4 * K] for the phase timeline
extern "C" int dtpu_amm_drop(void* holders, const void* excluded, const void* nbytes, void* ndrop,
                             void* mem, void* drops, void* scratch, void* list, void* stamps,
                             int R, int W, int K, int blocks, void* stream_ptr) {
  if (R < 1 || W < 1 || K < 1 || blocks < 1 || blocks > kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0, occ = 0;
  const int lim = limits(W, &sms, &occ);
  if (lim != 0) return lim;
  if (blocks > sms * occ) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int* s = static_cast<int*>(scratch);
  const size_t r = static_cast<size_t>(R), w = static_cast<size_t>(W);
  Args a;
  a.holders = static_cast<uint8_t*>(holders);
  a.list = list;
  a.count = s + 3 * r + 2 * w + blocks + static_cast<size_t>(blocks) * w;
  a.excluded = static_cast<const uint8_t*>(excluded);
  a.nbytes = static_cast<const float*>(nbytes);
  a.ndrop = static_cast<int*>(ndrop);
  a.mem = static_cast<float*>(mem);
  a.drops = static_cast<int*>(drops);
  a.pick = s;
  a.nrep = s + r;
  a.bucket = reinterpret_cast<float*>(s + 2 * r);
  a.total = s + 3 * r;
  a.lstart = s + 3 * r + w;
  a.btot = s + 3 * r + 2 * w;
  a.bcnt = s + 3 * r + 2 * w + blocks;
  a.stamps = static_cast<unsigned long long*>(stamps);
  a.R = R;
  a.W = W;
  a.K = K;
  void* args[] = {&a};
  const void* kernel = W <= kShortList ? reinterpret_cast<const void*>(amm_drop_kernel<int16_t>)
                                        : reinterpret_cast<const void*>(amm_drop_kernel<int>);
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, 0,
                                                      static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(refuse(err));
  return static_cast<int>(cudaGetLastError());
}
