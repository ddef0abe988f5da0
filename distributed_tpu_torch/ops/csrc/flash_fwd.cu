// Flash-attention forward (kernel K2).
//
// Replaces distributed_tpu/ops/flash.py::_flash_kernel, the Pallas TPU
// kernel launched by _flash_call (grid heads x q-tiles x k-tiles, k-tiles
// innermost, running max / sum / accumulator carried in VMEM scratch).
// The plain version beside it is ops/flash.py::flash_forward_reference.
//
// Both bodies keep the reference's contract: O in q's dtype, lse f32
// [H, N, 1], the finite -1e30 causal mask (keys past a ragged end are
// -inf), no offset for causal cross-length, l clamped at 1e-30, and
// k-tiles strictly above the causal diagonal never loaded or multiplied
// (the loop bound stops before them).  The TPU's sequential innermost
// k-tile axis becomes a loop inside one block; m, l and the accumulator
// stay in registers.
//
// Head dims: every D from 1 to 256.  Three instances are compiled, DP =
// 64, 128 and 256, and a D runs on the smallest that holds it: the
// tensor maps are encoded with the true D, so TMA zero-fills the columns
// past D in the last 64-column box, zeros add nothing to Q K^T or to
// P V, and the O columns past D are never stored.  TMA wants a row stride
// that is a multiple of 16 bytes, D a multiple of 8 in bf16 / f16: for
// any other D the wrapper (ops/flash.py) hands the kernel one zero-padded
// copy.  The CUDA-core body loads element by element and takes any D.
// Past 256 wgmma's N (the head dim in P V) runs out and the accumulators
// no longer fit: the entry point refuses such a D.
//
// Bound on an H100 at the smoke shapes (bf16, seq 8192, 16 heads, head
// dim 128): operations.  4*N*Nk*D*H = 5.5e11 flop non-causal (about half
// causal) against ~134 MB of q/k/v/o: ~0.56 ms at the 989 TFLOP/s bf16
// tensor-core peak versus ~0.04 ms of bytes.  So the tensor cores are the
// whole game, and the bf16 / f16 body is built around them:
//
// - one block per (head, q-tile of 128 rows), two warpgroups of 64 q rows
//   each; q-tiles are issued longest first so a causal grid ends on
//   short blocks;
// - TMA loads Q once and K and V tiles of kBK keys into a kStages ring
//   (FwdTiles: 128 keys and 3 stages up to DP = 128; at DP = 256 64 keys,
//   so that the S tile and the 128-register O accumulator fit a thread
//   together, and 2 stages, so that the ring fits shared memory);
//   a stage's full mbarrier says its tile has landed, and the second
//   warpgroup done with a stage (a shared counter) refills it with the
//   tile three on.  The tensor maps are 3-D (D, rows, heads), so a
//   ragged tile is zero-filled inside its own head.  No producer
//   warpgroup: with 384 threads nvcc budgets every thread at 168
//   registers (65536 / 384) whatever setmaxnreg later grants, and at
//   head dim 128 it then serialises every wgmma (a wait after each, C7512)
//   and spills; at 256 threads it has 255, issues each product's wgmma
//   back to back and does not spill;
// - in each warpgroup: S = Q K^T with
//   wgmma m64n{kBK}k16 from shared memory (f32 accumulate), the scale
//   applied to S in f32 after the product (q is not rounded pre-scaled),
//   the online softmax on the accumulator fragment in registers, and
//   O += P V with P converted in place to the input type as wgmma's
//   register A operand and V read MN-major (transposed) from shared
//   memory;
// - 128-byte swizzle on both sides: the tensor maps write it and the
//   wgmma descriptors read it.
//
// Rounding P once to bf16 / f16 before P V is the one numeric difference
// from the plain version, which keeps P in f32; chip_smoke.py derives
// the tolerance from it.
//
// f32 inputs keep the CUDA-core body (tensor cores would run them as
// TF32, about three decimal digits): 64x64 tiles, 256 threads each
// holding a 4x4 score block and a 4x(DP/16) slice of the accumulator, q
// scaled in f32 before the product, Q and the K tile transposed and
// padded in shared memory so inner-loop reads are broadcasts or
// conflict-free.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// CUDA-core body (f32)

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// K tile row stride (elements): an odd number of 32-bit words, so the
// transposing store spreads over the banks
template <typename T> __host__ __device__ constexpr int k_stride() {
  return sizeof(T) == 4 ? BK + 1 : BK + 2;
}

template <typename T, int DP>
__host__ __device__ constexpr size_t simt_smem_bytes() {
  // at DP = 256: 65 + 65 + 64 + 16.25 KB, under the 227 KB a block may use
  return sizeof(float) * DP * (BQ + 1)         // sQ  [DP][BQ+1]
       + sizeof(T) * DP * k_stride<T>()        // sK  [DP][BK+pad]
       + sizeof(T) * BK * DP                   // sV  [BK][DP]
       + sizeof(float) * BQ * (BK + 1);        // sP  [BQ][BK+1]
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DP: the instance's head dim, D <= DP the inputs' (O's columns past D
// are never stored).  EXACT: D == DP, taken at compile time, so that the
// loads' index arithmetic and the Q K^T loop's trip count are constants
// at the instance's own head dim
template <typename T, int DP, bool CAUSAL, bool EXACT>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int N, int Nk, int d_in, float scale) {
  const int D = EXACT ? DP : d_in;
  constexpr int KS = k_stride<T>();
  constexpr int NJD = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  T* sK = reinterpret_cast<T*>(sQ + DP * (BQ + 1));
  T* sV = sK + DP * KS;
  float* sP = reinterpret_cast<float*>(sV + BK * DP);

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const T* qh = q + static_cast<size_t>(h) * N * D;
  const T* kh = k + static_cast<size_t>(h) * Nk * D;
  const T* vh = v + static_cast<size_t>(h) * Nk * D;

  // Q tile, scaled in f32 as the reference does, stored transposed
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    sQ[d * (BQ + 1) + r] =
        q0 + r < N ? to_f(qh[static_cast<size_t>(q0 + r) * D + d]) * scale : 0.f;
  }
  // V's columns past D are read by the P V loop: zeros there (the Q K^T
  // loop runs to D; with it running to DP, ptxas spilled the causal body)
  for (int idx = tid; idx < BK * (DP - D); idx += kThreads) {
    const int r = idx / (DP - D), d = D + idx % (DP - D);
    sV[r * DP + d] = from_f<T>(0.f);
  }

  float m[4], l[4], acc[4][NJD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd) acc[i][jd] = 0.f;
  }

  int n_kt = (Nk + BK - 1) / BK;
  if (CAUSAL) {
    // a k-tile is live iff it starts before the end of the q-tile
    const int q_end = min(q0 + BQ, N);
    n_kt = min(n_kt, (q_end + BK - 1) / BK);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < Nk;
      const size_t g = static_cast<size_t>(k0 + r) * D + d;
      sK[d * KS + r] = in ? kh[g] : from_f<T>(0.f);
      sV[r * DP + d] = in ? vh[g] : from_f<T>(0.f);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[d * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = to_f(sK[d * KS + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= Nk) {
          s[i][j] = -INFINITY;
        } else if (CAUSAL && qp < kp) {
          s[i][j] = kNeg;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < NJD; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int jd = 0; jd < NJD; ++jd) {
        const float vv = to_f(sV[c * DP + tx + 16 * jd]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= N) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(h) * N + r) * D;
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd) {
      if (tx + 16 * jd < D) orow[tx + 16 * jd] = from_f<T>(acc[i][jd] / lc);
    }
    if (tx == 0) lse[static_cast<size_t>(h) * N + r] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core body (bf16 / f16): TMA ring + wgmma, warp-specialised.

constexpr int kTcBQ = 128;       // q rows per block, 64 per consumer warpgroup
constexpr int kTcThreads = 256;  // two warpgroups; their first threads also issue the loads
constexpr float kLn2 = 0.6931471805599453f;

// tiles of the instance DP: keys per K/V tile and the ring's depth
template <int DP> struct FwdTiles;
template <> struct FwdTiles<64> { static constexpr int kBK = 128, kStages = 3; };
template <> struct FwdTiles<128> { static constexpr int kBK = 128, kStages = 3; };
template <> struct FwdTiles<256> { static constexpr int kBK = 64, kStages = 2; };

template <int DP>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  // Q tile + the K and V ring, 2-byte elements, + slack to align to 1024
  // (at DP = 128: 32 + 3 * 64 KB + 1 KB; at 256: 64 + 2 * 64 KB + 1 KB;
  // both under the 227 KB a block may use)
  return static_cast<size_t>(kTcBQ + 2 * FwdTiles<DP>::kStages * FwdTiles<DP>::kBK) * DP * 2 +
         1024;
}

// O += P V over the DP columns of the accumulator, P's k-step as the A
// fragment `a`, V's rows of that step at `v_at` (64-column chunks `chunk`
// bytes apart): one m64nDP product up to DP = 128, one m64n128 product
// per 128 columns above.  Registers 64 g ... 64 g + 63 of an m64nDP
// fragment are the m64n128 fragment of columns 128 g ... 128 g + 127
// (hopper.cuh's layout).
template <typename T, int DP>
__device__ __forceinline__ void pv_columns(float (&acc)[DP / 2], const uint32_t (&a)[4],
                                           uint32_t v_at, uint32_t chunk) {
  if constexpr (DP <= 128) {
    Mma<T>::pv(acc, a, smem_desc(v_at, chunk, 1024));
  } else {
#pragma unroll
    for (int g = 0; g < DP / 128; ++g) {
      Mma<T>::pv(*reinterpret_cast<float(*)[64]>(&acc[64 * g]), a,
                 smem_desc(v_at + 2 * g * chunk, chunk, 1024));
    }
  }
}

// One block per (head, q-tile of 128 rows).  Tiles and accumulator
// fragments are laid out as hopper.cuh describes.  DP: the instance's
// head dim; D <= DP the inputs' (the maps zero-fill the columns past it,
// and O stores only those below it)
template <typename T, int DP, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                    float* __restrict__ lse, int N, int Nk, int D, float scale_log2) {
  constexpr int kTcBK = FwdTiles<DP>::kBK;
  constexpr int kStages = FwdTiles<DP>::kStages;
  constexpr int NCH = DP / 64;
  constexpr uint32_t kQBytes = kTcBQ * DP * 2;
  constexpr uint32_t kTileBytes = kTcBK * DP * 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  __shared__ int released[kStages];  // warpgroups done with the tile in each stage

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kQBytes;                 // stage s at + s * kTileBytes
  const uint32_t sV = sK + kStages * kTileBytes;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);     // stage s at + 8 * s

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBQ;  // longest q-tiles first
  int n_kt = (Nk + kTcBK - 1) / kTcBK;
  if (CAUSAL) n_kt = min(n_kt, (min(q0 + kTcBQ, N) + kTcBK - 1) / kTcBK);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_tile = [&](int s, int kt) {
    mbar_expect_tx(bar_full + 8 * s, 2 * kTileBytes);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      tma_load_3d(sK + s * kTileBytes + c * kTcBK * 128, &tk, bar_full + 8 * s, 64 * c,
                  kt * kTcBK, h);
      tma_load_3d(sV + s * kTileBytes + c * kTcBK * 128, &tv, bar_full + 8 * s, 64 * c,
                  kt * kTcBK, h);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, kQBytes);
#pragma unroll
    for (int c = 0; c < NCH; ++c) tma_load_3d(sQ + c * kTcBQ * 128, &tq, bar_q, 64 * c, q0, h);
    for (int kt = 0; kt < kStages && kt < n_kt; ++kt) load_tile(kt, kt);
  }

  const int wg = threadIdx.x / 128;
  constexpr int NS = kTcBK / 2;  // S (and P) accumulator registers a thread
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wq0 = q0 + 64 * wg;               // this warpgroup's first q row
  const int row0 = wq0 + 16 * warp + lane / 4;  // rows row0 and row0 + 8
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  const uint32_t q_rows = sQ + 64 * wg * 128;

  // S = Q K^T for the tile in stage s, both operands K-major
  auto issue_qk = [&](float (&sc)[NS], int s) {
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const uint32_t qoff = (j / 4) * (kTcBQ * 128) + (j % 4) * 32;
      const uint32_t koff = (j / 4) * (kTcBK * 128) + (j % 4) * 32;
      Mma<T>::qk(sc, smem_desc(q_rows + qoff, 16, 1024),
                 smem_desc(sK + s * kTileBytes + koff, 16, 1024), j > 0);
    }
  };
  // O += P V for the tile in stage s: P in registers as the A fragment,
  // V [keys][D] MN-major, so B is transposed
  auto issue_pv = [&](const uint32_t (&pk)[NS / 2], int s) {
#pragma unroll
    for (int j = 0; j < kTcBK / 16; ++j) {
      const uint32_t a[4] = {pk[4 * j], pk[4 * j + 1], pk[4 * j + 2], pk[4 * j + 3]};
      pv_columns<T, DP>(acc, a, sV + s * kTileBytes + j * 16 * 128, kTcBK * 128);
    }
  };
  // scale in f32 after the product (log2 units), mask the diagonal tile
  // and keys past the end, then the online softmax of each of the
  // thread's two rows (a quad shares a row): sc becomes P, m and l move
  // on, alpha is the factor the accumulator's rows still owe
  auto softmax = [&](float (&sc)[NS], int kt, float (&alpha)[2]) {
    const int k0 = kt * kTcBK;
    const bool masked = k0 + kTcBK > Nk || (CAUSAL && k0 + kTcBK - 1 > wq0);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x = sc[i] * scale_log2;
      if (masked) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        const int row = row0 + 8 * ((i / 2) & 1);
        if (col >= Nk) {
          x = -INFINITY;
        } else if (CAUSAL && row < col) {
          x = kNeg;
        }
      }
      sc[i] = x;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (((i / 2) & 1) == hh) mx = fmaxf(mx, sc[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      alpha[hh] = ex2(m[hh] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (((i / 2) & 1) == hh) {
          sc[i] = ex2(sc[i] - m_new);
          ps += sc[i];
        }
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[hh] = l[hh] * alpha[hh] + ps;
      m[hh] = m_new;
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i / 2) & 1];
  };
  // P rounded once to the input type, all of it before the products
  // are issued, so no register they read is written while in flight
  auto pack = [&](uint32_t (&pk)[NS / 2], const float (&sc)[NS]) {
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) pk[i] = Mma<T>::pack(sc[2 * i], sc[2 * i + 1]);
  };
  // the second warpgroup done with a stage refills it, kStages tiles on
  auto release = [&](int s, int kt) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0 && atomicAdd(&released[s], 1) == 1) {
      released[s] = 0;
      if (kt + kStages < n_kt) load_tile(s, kt + kStages);
    }
  };

  mbar_wait(bar_q, 0);
  float sc[NS];
  uint32_t pk[NS / 2];
  float alpha[2];
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    mbar_wait(bar_full + 8 * s, (kt / kStages) & 1);
    wgmma_fence();
    issue_qk(sc, s);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    softmax(sc, kt, alpha);
    rescale(alpha);
    pack(pk, sc);
    fence_regs(acc);
    wgmma_fence();
    issue_pv(pk, s);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    release(s, kt);
  }

  // O = acc / max(l, 1e-30), rounded once; lse = m + log(l)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= N) continue;
    const float lc = fmaxf(l[hh], 1e-30f);
    T* orow = o + (static_cast<size_t>(h) * N + row) * D;
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      if (((i / 2) & 1) != hh) continue;
      const int col = 8 * (i / 4) + 2 * (lane & 3);  // even, and D is a multiple of 8
      if (col >= D) continue;
      const uint32_t v = Mma<T>::pack(acc[i] / lc, acc[i + 1] / lc);
      *reinterpret_cast<uint32_t*>(orow + col) = v;
    }
    if ((lane & 3) == 0) lse[static_cast<size_t>(h) * N + row] = m[hh] * kLn2 + logf(lc);
  }
}

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                      int H, int N, int Nk, int D, int dtype, float scale, cudaStream_t stream) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_3d(&tq, fn, q, dtype, H, N, D, kTcBQ) ||
      !encode_3d(&tk, fn, k, dtype, H, Nk, D, FwdTiles<DP>::kBK) ||
      !encode_3d(&tv, fn, v, dtype, H, Nk, D, FwdTiles<DP>::kBK)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_tc_kernel<T, DP, CAUSAL>;
  constexpr size_t smem = tc_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(H, (N + kTcBQ - 1) / kTcBQ);
  kernel<<<grid, kTcThreads, smem, stream>>>(tq, tk, tv, static_cast<T*>(o),
                                              static_cast<float*>(lse), N, Nk, D, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T, int DP, bool CAUSAL>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, void* lse,
                        int H, int N, int Nk, int D, float scale, cudaStream_t stream) {
  auto kernel = D == DP ? flash_fwd_simt_kernel<T, DP, CAUSAL, true>
                        : flash_fwd_simt_kernel<T, DP, CAUSAL, false>;
  constexpr size_t smem = simt_smem_bytes<T, DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), N, Nk, D, scale);
  return cudaGetLastError();
}

template <int DP, bool CAUSAL>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o, void* lse,
                         int H, int N, int Nk, int D, int dtype, float scale,
                         cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_simt<float, DP, CAUSAL>(q, k, v, o, lse, H, N, Nk, D, scale, stream);
    case 1:
      return launch_tc<__half, DP, CAUSAL>(q, k, v, o, lse, H, N, Nk, D, dtype, scale, stream);
    case 2:
      return launch_tc<__nv_bfloat16, DP, CAUSAL>(q, k, v, o, lse, H, N, Nk, D, dtype, scale,
                                                  stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int DP>
cudaError_t launch_causal(int causal, const void* q, const void* k, const void* v, void* o,
                          void* lse, int H, int N, int Nk, int D, int dtype, float scale,
                          cudaStream_t stream) {
  return causal ? launch_typed<DP, true>(q, k, v, o, lse, H, N, Nk, D, dtype, scale, stream)
                : launch_typed<DP, false>(q, k, v, o, lse, H, N, Nk, D, dtype, scale, stream);
}

}  // namespace

// dtype: 0 float32 (CUDA-core body), 1 float16, 2 bfloat16 (tensor-core
// body); q/o [H, N, D], k/v [H, Nk, D], lse [H, N] f32, all contiguous
// and 16-byte aligned; D from 1 to 256 (a multiple of 8 in bf16 / f16),
// run on the instance 64, 128 or 256 that holds it
extern "C" int dtpu_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int H, int N, int Nk, int D,
                              int dtype, int causal, float scale,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (H <= 0 || N <= 0 || Nk <= 0 || D <= 0 || D > 256 || (dtype != 0 && D % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (const void* p : {q, k, v, static_cast<const void*>(o)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  cudaError_t err;
  if (D <= 64) {
    err = launch_causal<64>(causal, q, k, v, o, lse, H, N, Nk, D, dtype, scale, stream);
  } else if (D <= 128) {
    err = launch_causal<128>(causal, q, k, v, o, lse, H, N, Nk, D, dtype, scale, stream);
  } else {
    err = launch_causal<256>(causal, q, k, v, o, lse, H, N, Nk, D, dtype, scale, stream);
  }
  return static_cast<int>(err);
}
