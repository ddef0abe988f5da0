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
// ~5 us at 3.35 TB/s); the drops are written once.  A row that has
// nothing left to drop is skipped without reading its row again.  The
// sums of step 2 must keep row order, and the rounds depend on each
// other, so all rounds run in one cooperative launch.  Each block owns a
// contiguous range of rows and one of workers; a round is four phases,
// each ending at a grid barrier:
//
//   picks: a warp a row; each drop counted for its (block, worker)
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

struct Args {
  uint8_t* holders;         // [R][W], cleared as replicas drop
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
  int R, W, K;
};

__device__ __forceinline__ float score(const Args& a, size_t row, int w) {
  const bool can = __ldcg(a.holders + row + w) && !a.excluded[row + w];
  return can ? __ldcg(a.mem + w) : -INFINITY;
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

  for (int r = r0 + warp; r < r1; r += kWarps) {
    const size_t row = static_cast<size_t>(r) * W;
    int c = 0;
    for (int w = lane; w < W; w += 32) c += a.holders[row + w] != 0;
    c = __reduce_add_sync(kFull, c);
    if (lane == 0) a.nrep[r] = c;
  }
  for (int w = threadIdx.x; w < W; w += kThreads) my_cnt[w] = 0;
  grid.sync();

  for (int k = 0; k < a.K; ++k) {
    // 1. a warp a row: the first maximum of the score row
    for (int r = r0 + warp; r < r1; r += kWarps) {
      int p = -1;
      if (__ldcg(a.ndrop + r) > 0 && __ldcg(a.nrep + r) > 1) {
        const size_t row = static_cast<size_t>(r) * W;
        float best = lane < W ? score(a, row, lane) : -INFINITY;
        int bi = lane < W ? lane : 0x7fffffff;
        for (int w = lane + 32; w < W; w += 32) {
          const float s = score(a, row, w);
          if (s > best) {
            best = s;
            bi = w;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ob = __shfl_xor_sync(kFull, best, off);
          const int oi = __shfl_xor_sync(kFull, bi, off);
          if (ob > best || (ob == best && oi < bi)) {
            best = ob;
            bi = oi;
          }
        }
        if (__ldcg(a.holders + row + bi) && !a.excluded[row + bi]) p = bi;
        if (lane == 0 && p >= 0) {
          a.holders[row + p] = 0;
          a.ndrop[r] -= 1;
          a.nrep[r] -= 1;
          a.drops[static_cast<size_t>(r) * a.K + k] = p;
          atomicAdd(my_cnt + p, 1);
        }
      }
      if (lane == 0) a.pick[r] = p;
    }
    grid.sync();

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
    if (n_drops == 0) break;
  }
}

cudaError_t refuse(cudaError_t err) {
  cudaGetLastError();  // not left behind for the next launch's check
  return err;
}

// the multiprocessors and the blocks of the kernel each can hold
int grid_limits(int* sms, int* occ) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, amm_drop_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(refuse(err));
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (*occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return 0;
}

}  // namespace

// the default grid: two blocks a multiprocessor, or as many as can be
// resident, at most 1,024
extern "C" int dtpu_amm_drop_grid(int* blocks) {
  int sms = 0, occ = 0;
  const int err = grid_limits(&sms, &occ);
  if (err != 0) return err;
  *blocks = sms * (occ < kBlocksPerSm ? occ : kBlocksPerSm);
  if (*blocks > kMaxBlocks) *blocks = kMaxBlocks;
  return 0;
}

// all K rounds in one cooperative launch of `blocks` blocks (at most as
// many as can be resident, and 1,024); scratch: 3 * R + 2 * W + blocks *
// (W + 1) ints.  holders and ndrop are changed in place.
extern "C" int dtpu_amm_drop(void* holders, const void* excluded, const void* nbytes, void* ndrop,
                             void* mem, void* drops, void* scratch, int R, int W, int K,
                             int blocks, void* stream_ptr) {
  if (R < 1 || W < 1 || K < 1 || blocks < 1 || blocks > kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0, occ = 0;
  const int lim = grid_limits(&sms, &occ);
  if (lim != 0) return lim;
  if (blocks > sms * occ) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int* s = static_cast<int*>(scratch);
  const size_t r = static_cast<size_t>(R), w = static_cast<size_t>(W);
  Args a;
  a.holders = static_cast<uint8_t*>(holders);
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
  a.R = R;
  a.W = W;
  a.K = K;
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(amm_drop_kernel), dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(refuse(err));
  return static_cast<int>(cudaGetLastError());
}
