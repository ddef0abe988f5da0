// Flash-attention backward (kernel K3).
//
// Replaces distributed_tpu/ops/flash.py::_flash_diff_bwd, the backward of
// the Pallas kernel's custom_vjp: a lax.scan over q-chunks that recomputes
// P = exp(s - lse) from the saved logsumexp and accumulates dV = P^T dO,
// dS = P (dO V^T - delta), dQ = dS K scale and dK = dS^T Q scale in f32.
// The plain version beside it is ops/flash.py::flash_backward_reference.
//
// The reference's order is kept: s = (q.k^T) * scale (the scale after the
// product, unlike the forward), the -1e30 causal mask with no offset for
// cross-length (p is then exactly 0), delta = rowsum(dO * O) from O as
// stored in the input dtype, dQ and dK scaled after their products.
//
// The standard split into three launches, with no atomics, so two calls
// on the same inputs give the same bits:
//
// a. delta[h, i] = sum_d dO * O in f32, one warp a row; for the
//    tensor-core body also lse in log2 units, both into [H, Np] f32
//    scratch padded to Np = the rows rounded up to kPadRows, with delta 0
//    and lse +inf on the padding, so exp2(s - lse) is exactly 0 on a row
//    past N with no branch, and every row block is 16-byte aligned for a
//    bulk copy;
// b. dK / dV: one block per (head, k-tile), which keeps its K and V tile
//    and walks the q-tiles in order (under causal from the one holding
//    its first key: earlier tiles are fully masked), recomputing S^T and
//    P^T, then dP^T = V dO^T and dS^T, and accumulating dV += P^T dO and
//    dK += dS^T Q in f32 registers.  Each tile is written once;
// c. dQ: one block per (head, q-tile), walking the k-tiles up to its
//    diagonal and accumulating dQ += dS K.
//
// Bound on an H100 at the smoke shapes (bf16, seq 8192, 16 heads, head
// dim 128): operations.  Five products of 2*D flop per (query, key) pair,
// 10*H*D*pairs = 1.37e12 flop non-causal (half causal), against ~0.27 GB
// of q, k, v, o, dO, dq, dk, dv and lse: ~1.39 ms at the 989 TFLOP/s
// tensor-core peak against ~0.08 ms of bytes (chip_smoke.py's
// _bwd_bound_ms).  K3 does 7 products, not 5: S and dP are computed in
// both b and c, since a fused pass would need dQ summed across the
// k-tile blocks without float atomics (11 at DP = 256, where both
// warpgroups of a block compute S and dP: see Head dims below).
//
// Two bodies, as the forward's:
//
// - bf16 / f16: Hopper's tensor cores through wgmma, on tiles that TMA
//   loads into 128-byte-swizzled shared memory (hopper.cuh, shared with
//   K2).  256 threads a block, two warpgroups, each owning 64 of the
//   block's kResRows = 128 resident rows (keys in b, queries in c); the
//   resident pair (K, V in b; Q, dO in c) loads once, and the streamed
//   pairs of kStreamRows = 64 rows (Q, dO and their lse and delta in b;
//   K, V in c) go through a ring of kStages full barriers, refilled by
//   the second warpgroup done with a stage.  Every product reads its
//   tiles where they landed, with no transposed copy: S^T = K Q^T and
//   dP^T = V dO^T (b), S = Q K^T and dP = dO V^T (c) are m64n64k16 from
//   shared memory with both operands K-major; dV += P^T dO, dK += dS^T Q
//   (b) and dQ += dS K (c) take P^T or dS from registers (the previous
//   product's accumulator, rounded once to the input type and packed
//   whole before the issue) and read the streamed tile MN-major.  That
//   rounding of P and dS is the body's one numeric difference from the
//   plain version; flash.bwd_rounding_terms states the bound it implies.
//   So the tensor cores read their shared operands themselves (no
//   fragment loads through registers), no thread waits on a load it
//   issued (TMA fills the next stages while a stage is multiplied), and
//   256 threads with launch bounds (256, 1), so nvcc may give each 255
//   registers: b holds dK and dV (D/2 f32 each a thread), S^T and dP^T
//   (32 each) and the packed P^T and dS^T (16 each) without spilling.
//   What it leaves: 7 products; no producer warpgroup (at 384 threads
//   nvcc budgets 168 registers a thread and serialises every wgmma,
//   C7512); a wait after each group of products, so the elementwise work
//   of a tile does not overlap its own products.  Grids are (H, tiles):
//   under causal the longest blocks come first, b's first k-tiles and c's
//   last q-tiles;
// - f32: CUDA cores in f32 (tensor cores would run it as TF32), 256
//   threads a block, each holding a TMxTM block of S and dP and a
//   TMx(DP/16) slice of its accumulators (TM = 4, tiles of 64 rows; 2 and
//   32 at DP = 256); every tile is stored row-major with an odd row stride
//   (DP + 1 floats), so the broadcast reads and the strided reads of the
//   inner loops are conflict-free.
//
// Ragged N and Nk are masked inside the kernels: rows past the end load
// as zeros (the 3-D tensor maps zero-fill a box inside its head), their p
// is 0, and they are never written.
//
// Head dims: every D from 1 to 256, on three instances DP = 64, 128 and
// 256 (a D runs on the smallest that holds it), as the forward: the maps
// carry the true D and zero-fill the columns past it, which add nothing
// to S, dP or delta and give gradient columns that are never stored; in
// bf16 / f16 the wrapper pads a D that is not a multiple of 8 (TMA's
// 16-byte row stride).  The f32 body zero-fills in its own loads.  The
// tile sizes follow the instance (BwdTiles): up to 128 the layout above;
// at 256 the dK and dV accumulators of a row's 256 columns would need 256
// registers a thread on their own, so a block keeps 64 resident rows, both
// warpgroups compute S and dP for all of them, and each owns half of the
// gradient's columns (128: the registers of the DP = 128 instance), with a
// ring of 2 stages so that the resident pair and the ring fit shared
// memory.  The f32 body's tiles go from 64 to 32 rows at 256 for the same
// reason (four [64][257] f32 tiles would not fit).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// rows of every q- and k-tile of the f32 body: 64, or 32 at DP = 256,
// where four [64][DP + 1] f32 tiles would not fit shared memory
template <int DP> __host__ __device__ constexpr int simt_tile() { return DP > 128 ? 32 : 64; }

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// a. delta = rowsum(dO * O)

// one warp a row of [H, Np]: delta (0 past N) and, with lse2 given, lse
// in log2 units (+inf past N).  The f32 body passes Np = N and no lse2.
template <typename T, int DP>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 float* __restrict__ lse2, int N, int Np, int rows, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = row % Np;
  const size_t src = static_cast<size_t>(row / Np) * N + i;
  float acc = 0.f;
  if (i < N) {
    const T* orow = o + src * D;
    const T* drow = dout + src * D;
#pragma unroll
    for (int d = lane; d < DP; d += 32) {
      if (d < D) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    delta[row] = acc;
    if (lse2 != nullptr) lse2[row] = i < N ? lse[src] * kLog2e : INFINITY;
  }
}

// ---------------------------------------------------------------------------
// CUDA-core body (f32)

constexpr int kSimtThreads = 256;

template <int DP>
__host__ __device__ constexpr size_t simt_smem_bytes() {
  // four [T][DP+1] row tiles, two [T][T+1] score tiles, lse and delta (T
  // rows a tile): 162 KB at DP = 128, 137 KB at 256
  constexpr int kT = simt_tile<DP>();
  return sizeof(float) * (4 * kT * (DP + 1) + 2 * kT * (kT + 1) + 2 * kT);
}

// rows [r0, r0 + kT) of a [rows, D] matrix into a [kT][DP+1] f32 tile,
// zeros past `rows` and in the columns past D
template <typename T, int DP>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src, int r0, int rows, int D) {
  constexpr int kT = simt_tile<DP>();
  for (int idx = threadIdx.x; idx < kT * DP; idx += blockDim.x) {
    const int r = idx / DP, d = idx % DP;
    dst[r * (DP + 1) + d] =
        r0 + r < rows && d < D ? to_f(src[static_cast<size_t>(r0 + r) * D + d]) : 0.f;
  }
}

// thread (tx, ty) of 16x16: rows ty + 16 i of the resident tile, rows
// tx + 16 j of the streamed one (i, j < TM), head-dim columns tx + 16 jd
template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kSimtThreads)
bwd_dkdv_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int N, int Nk, int D, float scale) {
  constexpr int kTile = simt_tile<DP>();
  constexpr int TM = kTile / 16;
  constexpr int DS = DP + 1;
  constexpr int PS = kTile + 1;
  constexpr int NJD = DP / 16;
  extern __shared__ __align__(16) float smem_f[];
  float* sK = smem_f;
  float* sV = sK + kTile * DS;
  float* sQ = sV + kTile * DS;
  float* sdO = sQ + kTile * DS;
  float* sP = sdO + kTile * DS;   // P^T  [key][query]
  float* sdS = sP + kTile * PS;   // dS^T [key][query]
  float* sL = sdS + kTile * PS;
  float* sDl = sL + kTile;

  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qoff = static_cast<size_t>(h) * N * D, koff = static_cast<size_t>(h) * Nk * D;

  load_rows_f32<T, DP>(sK, k + koff, k0, Nk, D);
  load_rows_f32<T, DP>(sV, v + koff, k0, Nk, D);

  float acc_k[TM][NJD], acc_v[TM][NJD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd) acc_k[i][jd] = acc_v[i][jd] = 0.f;

  const int n_qt = (N + kTile - 1) / kTile;
  for (int qt = CAUSAL ? blockIdx.x : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous step's reads of sQ, sdO, sP, sdS are done
    load_rows_f32<T, DP>(sQ, q + qoff, q0, N, D);
    load_rows_f32<T, DP>(sdO, dout + qoff, q0, N, D);
    if (threadIdx.x < kTile) {
      const bool in = q0 + static_cast<int>(threadIdx.x) < N;
      sL[threadIdx.x] = in ? lse[static_cast<size_t>(h) * N + q0 + threadIdx.x] : 0.f;
      sDl[threadIdx.x] = in ? delta[static_cast<size_t>(h) * N + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    float s[TM][TM], dp[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float ak[TM], av[TM], bq[TM], bo[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ak[i] = sK[(ty + 16 * i) * DS + d];
        av[i] = sV[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        bq[j] = sQ[(tx + 16 * j) * DS + d];
        bo[j] = sdO[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          s[i][j] = fmaf(ak[i], bq[j], s[i][j]);
          dp[i][j] = fmaf(av[i], bo[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int key = k0 + ty + 16 * i, c = tx + 16 * j, qrow = q0 + c;
        const bool live = qrow < N && (!CAUSAL || qrow >= key);
        const float p = live ? expf(s[i][j] * scale - sL[c]) : 0.f;
        sP[(ty + 16 * i) * PS + c] = p;
        sdS[(ty + 16 * i) * PS + c] = p * (dp[i][j] - sDl[c]);
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[TM], dsv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pv[i] = sP[(ty + 16 * i) * PS + c];
        dsv[i] = sdS[(ty + 16 * i) * PS + c];
      }
#pragma unroll
      for (int jd = 0; jd < NJD; ++jd) {
        const float o = sdO[c * DS + tx + 16 * jd];
        const float qq = sQ[c * DS + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc_v[i][jd] = fmaf(pv[i], o, acc_v[i][jd]);
          acc_k[i][jd] = fmaf(dsv[i], qq, acc_k[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Nk) continue;
    const size_t row = koff + static_cast<size_t>(key) * D;
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd) {
      if (tx + 16 * jd >= D) continue;
      dk[row + tx + 16 * jd] = from_f<T>(acc_k[i][jd] * scale);
      dv[row + tx + 16 * jd] = from_f<T>(acc_v[i][jd]);
    }
  }
}

template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kSimtThreads)
bwd_dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int N, int Nk, int D,
                   float scale) {
  constexpr int kTile = simt_tile<DP>();
  constexpr int TM = kTile / 16;
  constexpr int DS = DP + 1;
  constexpr int PS = kTile + 1;
  constexpr int NJD = DP / 16;
  extern __shared__ __align__(16) float smem_f[];
  float* sQ = smem_f;
  float* sdO = sQ + kTile * DS;
  float* sK = sdO + kTile * DS;
  float* sV = sK + kTile * DS;
  float* sdS = sV + kTile * DS;  // dS [query][key]

  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest causal tiles first
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qoff = static_cast<size_t>(h) * N * D, koff = static_cast<size_t>(h) * Nk * D;

  load_rows_f32<T, DP>(sQ, q + qoff, q0, N, D);
  load_rows_f32<T, DP>(sdO, dout + qoff, q0, N, D);
  float lse_r[TM], del_r[TM], acc[TM][NJD];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < N ? lse[static_cast<size_t>(h) * N + r] : 0.f;
    del_r[i] = r < N ? delta[static_cast<size_t>(h) * N + r] : 0.f;
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd) acc[i][jd] = 0.f;
  }

  int n_kt = (Nk + kTile - 1) / kTile;
  if (CAUSAL) n_kt = min(n_kt, (min(q0 + kTile, N) + kTile - 1) / kTile);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous step's reads of sK, sV, sdS are done
    load_rows_f32<T, DP>(sK, k + koff, k0, Nk, D);
    load_rows_f32<T, DP>(sV, v + koff, k0, Nk, D);
    __syncthreads();

    float s[TM][TM], dp[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float aq[TM], ao[TM], bk[TM], bv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        aq[i] = sQ[(ty + 16 * i) * DS + d];
        ao[i] = sdO[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        bk[j] = sK[(tx + 16 * j) * DS + d];
        bv[j] = sV[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(ao[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int row = q0 + ty + 16 * i, key = k0 + tx + 16 * j;
        const bool live = row < N && key < Nk && (!CAUSAL || row >= key);
        const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sdS[(ty + 16 * i) * PS + tx + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) dsv[i] = sdS[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jd = 0; jd < NJD; ++jd) {
        const float kk = sK[c * DS + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][jd] = fmaf(dsv[i], kk, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= N) continue;
    const size_t row = qoff + static_cast<size_t>(r) * D;
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd) {
      if (tx + 16 * jd < D) dq[row + tx + 16 * jd] = from_f<T>(acc[i][jd] * scale);
    }
  }
}
// ---------------------------------------------------------------------------
// Tensor-core body (bf16 / f16): wgmma on TMA-fed tiles, two warpgroups

constexpr int kPadRows = 128;    // the lse / delta scratch's rows a head, rounded up to this
constexpr int kStreamRows = 64;  // rows of each streamed tile
constexpr int kTcThreads = 256;  // two warpgroups; their first threads also issue the loads
constexpr uint32_t kChunkBytes = 64 * 128;  // one 64-column chunk of a 64-row tile
constexpr uint32_t kRowBytes = kStreamRows * sizeof(float);  // lse or delta of a q-tile

// tiles of the instance DP: the resident rows a block owns (128: 64 a
// warpgroup, each with all DP columns; 64: both warpgroups on the same
// rows, each with DP / 2 columns) and the depth of the streamed ring
template <int DP> struct BwdTiles;
template <> struct BwdTiles<64> { static constexpr int kResRows = 128, kStages = 3; };
template <> struct BwdTiles<128> { static constexpr int kResRows = 128, kStages = 3; };
template <> struct BwdTiles<256> { static constexpr int kResRows = 64, kStages = 2; };

// rows of the padded lse / delta scratch of a head (a multiple of every
// instance's kResRows)
__host__ __device__ constexpr int padded_rows(int n) {
  return (n + kPadRows - 1) / kPadRows * kPadRows;
}

template <int DP>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  // the resident pair, the ring of streamed pairs (2-byte elements), the
  // ring's lse and delta rows, + slack to align to 1024 (at DP = 128:
  // 64 + 3 * 32 KB + 1.5 KB + 1 KB; at 256: 64 + 2 * 64 KB + 1 KB + 1 KB;
  // both under the 227 KB a block may use)
  constexpr int kStages = BwdTiles<DP>::kStages;
  return static_cast<size_t>(2 * BwdTiles<DP>::kResRows + 2 * kStages * kStreamRows) * DP * 2 +
         kStages * 2 * kRowBytes + 1024;
}

// a contiguous global range into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// descriptors of a 64-row tile at `tile` (DP/64 chunks of [64][64]) for
// k-step j: read K-major (the head dim is K: S, S^T, dP, dP^T) or
// MN-major (the rows are K: the B of dV, dK and dQ)
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int j) {
  return smem_desc(tile + (j / 4) * kChunkBytes + (j % 4) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int j) {
  return smem_desc(tile + j * 16 * 128, kChunkBytes, 1024);
}

// rows [r0, r0 + 64) of a 3-D map into the 64-row tile at dst
template <int DP>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int r0, int h) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c) tma_load_3d(dst + c * kChunkBytes, map, bar, 64 * c, r0, h);
}

// the resident pair of kResRows rows from r0: each 64-row tile, except a
// second one that starts past the end (never stored; its rows stay as
// they are and reach only its own, unwritten, output rows)
template <int DP>
__device__ __forceinline__ void load_resident(uint32_t dst_a, const CUtensorMap* map_a,
                                              uint32_t dst_b, const CUtensorMap* map_b,
                                              uint32_t bar, int r0, int rows, int h) {
  constexpr uint32_t kSub = 64 * DP * 2;
  const int halves = BwdTiles<DP>::kResRows == 128 && r0 + 64 < rows ? 2 : 1;
  mbar_expect_tx(bar, 2 * halves * kSub);
  for (int w = 0; w < halves; ++w) {
    load_rows<DP>(dst_a + w * kSub, map_a, bar, r0 + 64 * w, h);
    load_rows<DP>(dst_b + w * kSub, map_b, bar, r0 + 64 * w, h);
  }
}

// S^T (or S) and dP^T (or dP) of one warpgroup's 64 rows against a
// streamed tile, over all DP columns: four operands K-major, one group,
// waited on
template <typename T, int DP>
__device__ __forceinline__ void scores(float (&s)[32], float (&dp)[32], uint32_t a_s,
                                       uint32_t b_s, uint32_t a_dp, uint32_t b_dp) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < DP / 16; ++j) Mma<T>::qk(s, desc_k_major(a_s, j), desc_k_major(b_s, j), j > 0);
#pragma unroll
  for (int j = 0; j < DP / 16; ++j)
    Mma<T>::qk(dp, desc_k_major(a_dp, j), desc_k_major(b_dp, j), j > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  fence_regs(dp);
}

// acc += X M over DW columns: X the 64 x 64 register fragment `x`
// (packed), M the streamed 64-row tile read MN-major from the 64-column
// chunk at `tile` on; issued, not waited on
template <typename T, int DW>
__device__ __forceinline__ void accumulate(float (&acc)[DW / 2], const uint32_t (&x)[16],
                                           uint32_t tile) {
#pragma unroll
  for (int j = 0; j < kStreamRows / 16; ++j) {
    const uint32_t a[4] = {x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]};
    Mma<T>::pv(acc, a, desc_mn_major(tile, j));
  }
}

// rows row0 and row0 + 8 of a 64-row accumulator fragment of DW columns
// from col0, times `mul`, rounded once, where below `rows` and D (a
// multiple of 8, so a pair of columns is stored whole or not at all)
template <typename T, int DW>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[DW / 2], int row0,
                                           int rows, float mul, int lane, int D, int col0) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= rows) continue;
    T* orow = out + static_cast<size_t>(row) * D;
#pragma unroll
    for (int i = 0; i < DW / 2; i += 2) {
      if (((i / 2) & 1) != hh) continue;
      const int col = col0 + 8 * (i / 4) + 2 * (lane & 3);
      if (col >= D) continue;
      *reinterpret_cast<uint32_t*>(orow + col) = Mma<T>::pack(acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

// b. One block per (head, kResRows keys): its K and V stay, the q-tiles
// stream in with their lse and delta.  Warpgroup w owns keys k0 + 64 w ...
// (kResRows 128), or columns w DP/2 ... of keys k0 ... (kResRows 64)
template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ delta, const float* __restrict__ lse2,
                   T* __restrict__ dk, T* __restrict__ dv, int N, int Nk, int Np, int D,
                   float scale, float scale_log2) {
  constexpr int kResRows = BwdTiles<DP>::kResRows;
  constexpr int kStages = BwdTiles<DP>::kStages;
  constexpr int kSplit = 128 / kResRows;               // warpgroups sharing a resident row
  constexpr int DW = DP / kSplit;                      // gradient columns a warpgroup owns
  constexpr uint32_t kSub = 64 * DP * 2;               // 64 resident rows
  constexpr uint32_t kStream = kStreamRows * DP * 2;   // one streamed tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  __shared__ int released[kStages];  // warpgroups done with each stage, ever

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = sK + (kResRows / 64) * kSub;
  const uint32_t sQ = sV + (kResRows / 64) * kSub;    // stage s at + 2 s kStream, its dO at + kStream
  const uint32_t sRows = sQ + kStages * 2 * kStream;  // stage s: lse2 at + 2 s kRowBytes, delta after
  const float* rows_f = reinterpret_cast<const float*>(smem_raw + (sRows - raw));
  const uint32_t bar_res = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);  // stage s at + 8 s

  const int h = blockIdx.x;
  const int k0 = blockIdx.y * kResRows;  // causal: the first k-tiles walk the most q-tiles
  const int n_qt = (N + kStreamRows - 1) / kStreamRows;
  // under causal the first q-tile with a query at or past the first key
  const int t0 = CAUSAL ? k0 / kStreamRows : 0;
  const int n_it = max(n_qt - t0, 0);
  const size_t row_off = static_cast<size_t>(h) * Np;

  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_stage = [&](int s, int t) {
    const uint32_t bar = bar_full + 8 * s;
    mbar_expect_tx(bar, 2 * kStream + 2 * kRowBytes);
    load_rows<DP>(sQ + 2 * s * kStream, &tq, bar, t * kStreamRows, h);
    load_rows<DP>(sQ + 2 * s * kStream + kStream, &tdo, bar, t * kStreamRows, h);
    bulk_load(sRows + 2 * s * kRowBytes, lse2 + row_off + t * kStreamRows, kRowBytes, bar);
    bulk_load(sRows + (2 * s + 1) * kRowBytes, delta + row_off + t * kStreamRows, kRowBytes, bar);
  };
  if (threadIdx.x == 0) {
    load_resident<DP>(sK, &tk, sV, &tv, bar_res, k0, Nk, h);
    for (int it = 0; it < kStages && it < n_it; ++it) load_stage(it, t0 + it);
  }

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rw = kSplit == 1 ? wg : 0;            // this warpgroup's 64 resident rows
  const uint32_t cw = (kSplit == 1 ? 0 : wg) * (DW / 64) * kChunkBytes;  // its columns' chunk
  const int kw0 = k0 + 64 * rw;                   // this warpgroup's first key
  const int key0 = kw0 + 16 * warp + lane / 4;    // keys key0 and key0 + 8
  const uint32_t my_k = sK + rw * kSub, my_v = sV + rw * kSub;
  float acc_k[DW / 2], acc_v[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  // the second warpgroup done with a stage refills it, kStages tiles on
  auto release = [&](int s, int it) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0 && (atomicAdd(&released[s], 1) & 1)) {
      if (it + kStages < n_it) load_stage(s, t0 + it + kStages);
    }
  };

  mbar_wait(bar_res, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q0 = (t0 + it) * kStreamRows;
    const uint32_t q_s = sQ + 2 * s * kStream, do_s = q_s + kStream;
    mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
    float st[32], dpt[32];
    scores<T, DP>(st, dpt, my_k, q_s, my_v, do_s);  // S^T = K Q^T, dP^T = V dO^T

    // P^T = exp(S^T scale - lse) by column (query), 0 where the query
    // comes before the key (a padded query's lse is +inf); dS^T =
    // P^T (dP^T - delta); both rounded once, packed whole
    const float* l2 = rows_f + 2 * s * kStreamRows;
    const float* dl = l2 + kStreamRows;
    const bool masked = CAUSAL && q0 < kw0 + 63;
    uint32_t pp[16], pd[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * i + e;
        const int col = 8 * (r / 4) + 2 * (lane & 3) + e;
        p[e] = ex2(st[r] * scale_log2 - l2[col]);
        if (masked && q0 + col < key0 + 8 * ((r / 2) & 1)) p[e] = 0.f;
        ds[e] = p[e] * (dpt[r] - dl[col]);
      }
      pp[i] = Mma<T>::pack(p[0], p[1]);
      pd[i] = Mma<T>::pack(ds[0], ds[1]);
    }
    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
    accumulate<T, DW>(acc_v, pp, do_s + cw);  // dV += P^T dO
    accumulate<T, DW>(acc_k, pd, q_s + cw);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
    release(s, it);
  }

  const int col0 = (kSplit == 1 ? 0 : wg) * DW;
  store_rows<T, DW>(dk + static_cast<size_t>(h) * Nk * D, acc_k, key0, Nk, scale, lane, D, col0);
  store_rows<T, DW>(dv + static_cast<size_t>(h) * Nk * D, acc_v, key0, Nk, 1.f, lane, D, col0);
}

// c. One block per (head, kResRows queries): its Q and dO stay, the
// k-tiles stream in.  Warpgroup w owns queries q0 + 64 w ... (kResRows
// 128), or columns w DP/2 ... of queries q0 ... (kResRows 64)
template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ delta, const float* __restrict__ lse2,
                 T* __restrict__ dq, int N, int Nk, int Np, int D, float scale,
                 float scale_log2) {
  constexpr int kResRows = BwdTiles<DP>::kResRows;
  constexpr int kStages = BwdTiles<DP>::kStages;
  constexpr int kSplit = 128 / kResRows;
  constexpr int DW = DP / kSplit;
  constexpr uint32_t kSub = 64 * DP * 2;
  constexpr uint32_t kStream = kStreamRows * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  __shared__ int released[kStages];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sdO = sQ + (kResRows / 64) * kSub;
  const uint32_t sK = sdO + (kResRows / 64) * kSub;  // stage s at + 2 s kStream, its V at + kStream
  const uint32_t bar_res = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kResRows;  // longest causal tiles first
  int n_kt = (Nk + kStreamRows - 1) / kStreamRows;
  // under causal the k-tiles that start before the block's last query
  if (CAUSAL) n_kt = min(n_kt, (min(q0 + kResRows, N) + kStreamRows - 1) / kStreamRows);

  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_stage = [&](int s, int t) {
    const uint32_t bar = bar_full + 8 * s;
    mbar_expect_tx(bar, 2 * kStream);
    load_rows<DP>(sK + 2 * s * kStream, &tk, bar, t * kStreamRows, h);
    load_rows<DP>(sK + 2 * s * kStream + kStream, &tv, bar, t * kStreamRows, h);
  };
  if (threadIdx.x == 0) {
    load_resident<DP>(sQ, &tq, sdO, &tdo, bar_res, q0, N, h);
    for (int t = 0; t < kStages && t < n_kt; ++t) load_stage(t, t);
  }

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rw = kSplit == 1 ? wg : 0;          // this warpgroup's 64 resident rows
  const uint32_t cw = (kSplit == 1 ? 0 : wg) * (DW / 64) * kChunkBytes;  // its columns' chunk
  const int wq0 = q0 + 64 * rw;                 // this warpgroup's first query
  const int row0 = wq0 + 16 * warp + lane / 4;  // queries row0 and row0 + 8
  const uint32_t my_q = sQ + rw * kSub, my_do = sdO + rw * kSub;
  float lse_r[2], del_r[2];  // padded: row0 + 8 < q0 + kResRows <= Np
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const size_t r = static_cast<size_t>(h) * Np + row0 + 8 * hh;
    lse_r[hh] = lse2[r];
    del_r[hh] = delta[r];
  }
  float acc[DW / 2];
#pragma unroll
  for (int i = 0; i < DW / 2; ++i) acc[i] = 0.f;

  auto release = [&](int s, int t) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0 && (atomicAdd(&released[s], 1) & 1)) {
      if (t + kStages < n_kt) load_stage(s, t + kStages);
    }
  };

  mbar_wait(bar_res, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int s = t % kStages;
    const int k0 = t * kStreamRows;
    const uint32_t k_s = sK + 2 * s * kStream, v_s = k_s + kStream;
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
    float sc[32], dp[32];
    scores<T, DP>(sc, dp, my_q, k_s, my_do, v_s);  // S = Q K^T, dP = dO V^T

    // P = exp(S scale - lse) by row, 0 past Nk and where the query comes
    // before the key; dS = P (dP - delta), rounded once, packed whole
    const bool masked = k0 + kStreamRows > Nk || (CAUSAL && k0 + kStreamRows - 1 > wq0);
    uint32_t pd[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * i + e;
        const int hh = (r / 2) & 1;
        float p = ex2(sc[r] * scale_log2 - lse_r[hh]);
        if (masked) {
          const int key = k0 + 8 * (r / 4) + 2 * (lane & 3) + e;
          if (key >= Nk || (CAUSAL && row0 + 8 * hh < key)) p = 0.f;
        }
        ds[e] = p * (dp[r] - del_r[hh]);
      }
      pd[i] = Mma<T>::pack(ds[0], ds[1]);
    }
    fence_regs(acc);
    wgmma_fence();
    accumulate<T, DW>(acc, pd, k_s + cw);  // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    release(s, t);
  }

  store_rows<T, DW>(dq + static_cast<size_t>(h) * N * D, acc, row0, N, scale, lane, D,
                    (kSplit == 1 ? 0 : wg) * DW);
}

// ---------------------------------------------------------------------------
// launches

template <typename Kern>
cudaError_t opt_in_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* o,
                      const void* lse, const void* dout, void* dq, void* dk, void* dv,
                      void* scratch, int H, int N, int Nk, int D, int dtype, float scale,
                      cudaStream_t stream) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_3d(&tq, fn, q, dtype, H, N, D, kStreamRows) ||
      !encode_3d(&tk, fn, k, dtype, H, Nk, D, kStreamRows) ||
      !encode_3d(&tv, fn, v, dtype, H, Nk, D, kStreamRows) ||
      !encode_3d(&tdo, fn, dout, dtype, H, N, D, kStreamRows)) {
    return cudaErrorInvalidValue;
  }
  const int Np = padded_rows(N);
  float* delta = static_cast<float*>(scratch);
  float* lse2 = delta + static_cast<size_t>(H) * Np;
  const int rows = H * Np;
  bwd_delta_kernel<T, DP><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
      delta, lse2, N, Np, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = tc_smem_bytes<DP>();
  constexpr int kRes = BwdTiles<DP>::kResRows;
  auto kdkdv = bwd_dkdv_tc_kernel<T, DP, CAUSAL>;
  auto kdq = bwd_dq_tc_kernel<T, DP, CAUSAL>;
  if ((err = opt_in_smem(kdkdv, smem)) != cudaSuccess) return err;
  if ((err = opt_in_smem(kdq, smem)) != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  const dim3 grid_k(H, (Nk + kRes - 1) / kRes), grid_q(H, (N + kRes - 1) / kRes);
  kdkdv<<<grid_k, kTcThreads, smem, stream>>>(tq, tk, tv, tdo, delta, lse2, static_cast<T*>(dk),
                                              static_cast<T*>(dv), N, Nk, Np, D, scale,
                                              scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kdq<<<grid_q, kTcThreads, smem, stream>>>(tq, tk, tv, tdo, delta, lse2, static_cast<T*>(dq), N,
                                            Nk, Np, D, scale, scale_log2);
  return cudaGetLastError();
}

template <int DP, bool CAUSAL>
cudaError_t launch_simt(const void* q, const void* k, const void* v, const void* o,
                        const void* lse, const void* dout, void* dq, void* dk, void* dv,
                        void* scratch, int H, int N, int Nk, int D, float scale,
                        cudaStream_t stream) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta = static_cast<float*>(scratch);
  const int rows = H * N;
  bwd_delta_kernel<float, DP><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const float*>(o), do_, lse_, delta, nullptr, N, N, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = simt_smem_bytes<DP>();
  constexpr int kTile = simt_tile<DP>();
  auto kdkdv = bwd_dkdv_simt_kernel<float, DP, CAUSAL>;
  auto kdq = bwd_dq_simt_kernel<float, DP, CAUSAL>;
  if ((err = opt_in_smem(kdkdv, smem)) != cudaSuccess) return err;
  if ((err = opt_in_smem(kdq, smem)) != cudaSuccess) return err;
  const dim3 grid_k((Nk + kTile - 1) / kTile, H), grid_q((N + kTile - 1) / kTile, H);
  kdkdv<<<grid_k, kSimtThreads, smem, stream>>>(q_, k_, v_, do_, lse_, delta,
                                                static_cast<float*>(dk), static_cast<float*>(dv),
                                                N, Nk, D, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kdq<<<grid_q, kSimtThreads, smem, stream>>>(q_, k_, v_, do_, lse_, delta,
                                              static_cast<float*>(dq), N, Nk, D, scale);
  return cudaGetLastError();
}

template <int DP, bool CAUSAL>
cudaError_t launch_typed(int dtype, const void* q, const void* k, const void* v, const void* o,
                         const void* lse, const void* dout, void* dq, void* dk, void* dv,
                         void* scratch, int H, int N, int Nk, int D, float scale,
                         cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_simt<DP, CAUSAL>(q, k, v, o, lse, dout, dq, dk, dv, scratch, H, N, Nk, D,
                                     scale, stream);
    case 1:
      return launch_tc<__half, DP, CAUSAL>(q, k, v, o, lse, dout, dq, dk, dv, scratch, H, N, Nk,
                                           D, dtype, scale, stream);
    case 2:
      return launch_tc<__nv_bfloat16, DP, CAUSAL>(q, k, v, o, lse, dout, dq, dk, dv, scratch, H,
                                                  N, Nk, D, dtype, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int DP>
cudaError_t launch_causal(int causal, int dtype, const void* q, const void* k, const void* v,
                          const void* o, const void* lse, const void* dout, void* dq, void* dk,
                          void* dv, void* scratch, int H, int N, int Nk, int D, float scale,
                          cudaStream_t stream) {
  return causal ? launch_typed<DP, true>(dtype, q, k, v, o, lse, dout, dq, dk, dv, scratch, H, N,
                                         Nk, D, scale, stream)
                : launch_typed<DP, false>(dtype, q, k, v, o, lse, dout, dq, dk, dv, scratch, H, N,
                                          Nk, D, scale, stream);
}

}  // namespace

// dtype: 0 float32 (CUDA-core body), 1 float16, 2 bfloat16 (tensor-core
// body); q/o/dout/dq [H, N, D], k/v/dk/dv [H, Nk, D], lse [H, N] f32, all
// contiguous and 16-byte aligned; D from 1 to 256 (a multiple of 8 in
// bf16 / f16), run on the instance 64, 128 or 256 that holds it.
// scratch: f32 the caller allocates, 2 * H * Np floats with Np = N
// rounded up to kPadRows (delta, then the tensor-core body's padded lse),
// 16-byte aligned
extern "C" int dtpu_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* lse, const void* dout, void* dq, void* dk, void* dv,
                              void* scratch, int H, int N, int Nk, int D, int dtype, int causal,
                              float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (H <= 0 || N <= 0 || Nk <= 0 || D <= 0 || D > 256 || (dtype != 0 && D % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk), static_cast<const void*>(dv),
                        static_cast<const void*>(scratch)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  cudaError_t err;
  if (D <= 64) {
    err = launch_causal<64>(causal, dtype, q, k, v, o, lse, dout, dq, dk, dv, scratch, H, N, Nk,
                            D, scale, stream);
  } else if (D <= 128) {
    err = launch_causal<128>(causal, dtype, q, k, v, o, lse, dout, dq, dk, dv, scratch, H, N,
                             Nk, D, scale, stream);
  } else {
    err = launch_causal<256>(causal, dtype, q, k, v, o, lse, dout, dq, dk, dv, scratch, H, N,
                             Nk, D, scale, stream);
  }
  return static_cast<int>(err);
}
