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
// a. delta[h, i] = sum_d dO * O in f32, one warp a row;
// b. dK / dV: one block per (head, 64-key tile).  The block keeps its K
//    and V tile in shared memory and walks the q-tiles in order (under
//    causal from the one holding its first key: earlier tiles are fully
//    masked), recomputing S^T and P^T, then dP^T = V dO^T and dS^T, and
//    accumulating dV += P^T dO and dK += dS^T Q in f32 registers.  Each
//    tile is written once;
// c. dQ: one block per (head, 64-query tile), longest causal tiles first,
//    walking the k-tiles up to its diagonal and accumulating dQ += dS K.
//
// Bound on an H100 at the smoke shapes (bf16, seq 8192, 16 heads, head
// dim 128): operations.  Five products of 2*D flop per (query, key) pair,
// 10*H*D*pairs = 1.37e12 flop non-causal (half causal), against ~0.27 GB
// of q, k, v, o, dO, dq, dk, dv and lse: ~1.39 ms at the 989 TFLOP/s
// tensor-core peak against ~0.08 ms of bytes.
//
// Two bodies, as the forward's:
//
// - bf16 / f16: tensor cores through mma.sync m16n8k16 with f32
//   accumulation, four warps a block, each owning 16 rows of the resident
//   tile; operands come from padded shared-memory tiles through ldmatrix
//   (row stride D + 8 elements, so the eight rows of a matrix fall in
//   eight different bank groups).  The accumulators of S^T (or S) become
//   the A operand of the next product in registers: P is rounded once to
//   the input type before P^T dO, and dS once before dS^T Q and dS K.
//   That rounding is the body's one numeric difference from the plain
//   version; flash.bwd_rounding_terms states the bound it implies.  Tiles
//   are loaded synchronously, one q- or k-tile per step: wgmma, TMA and
//   warp specialisation are later work;
// - f32: CUDA cores in f32 (tensor cores would run it as TF32), 256
//   threads a block, each holding a 4x4 block of S and dP and a 4x(D/16)
//   slice of its accumulators; every tile is stored row-major with an odd
//   row stride (D + 1 floats), so the broadcast reads and the strided
//   reads of the inner loops are conflict-free.
//
// Ragged N and Nk are masked inside the kernel: rows past the end load as
// zeros, their p is 0, and they are never written.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // rows of every q- and k-tile, both bodies

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

template <typename T, int D>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* orow = o + static_cast<size_t>(row) * D;
  const T* drow = dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// CUDA-core body (f32)

constexpr int kSimtThreads = 256;

template <int D>
__host__ __device__ constexpr size_t simt_smem_bytes() {
  // four [64][D+1] row tiles, two [64][65] score tiles, lse and delta
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * (kTile + 1) + 2 * kTile);
}

// rows [r0, r0 + 64) of a [rows, D] matrix into a [64][D+1] f32 tile,
// zeros past `rows`
template <typename T, int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src, int r0, int rows) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    dst[r * (D + 1) + d] = r0 + r < rows ? to_f(src[static_cast<size_t>(r0 + r) * D + d]) : 0.f;
  }
}

// thread (tx, ty) of 16x16: rows ty + 16 i of the resident tile, rows
// tx + 16 j of the streamed one, head-dim columns tx + 16 jd
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kSimtThreads)
bwd_dkdv_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int N, int Nk, float scale) {
  constexpr int DS = D + 1;
  constexpr int PS = kTile + 1;
  constexpr int NJD = D / 16;
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

  load_rows_f32<T, D>(sK, k + koff, k0, Nk);
  load_rows_f32<T, D>(sV, v + koff, k0, Nk);

  float acc_k[4][NJD], acc_v[4][NJD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd) acc_k[i][jd] = acc_v[i][jd] = 0.f;

  const int n_qt = (N + kTile - 1) / kTile;
  for (int qt = CAUSAL ? blockIdx.x : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous step's reads of sQ, sdO, sP, sdS are done
    load_rows_f32<T, D>(sQ, q + qoff, q0, N);
    load_rows_f32<T, D>(sdO, dout + qoff, q0, N);
    if (threadIdx.x < kTile) {
      const bool in = q0 + static_cast<int>(threadIdx.x) < N;
      sL[threadIdx.x] = in ? lse[static_cast<size_t>(h) * N + q0 + threadIdx.x] : 0.f;
      sDl[threadIdx.x] = in ? delta[static_cast<size_t>(h) * N + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float ak[4], av[4], bq[4], bo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ak[i] = sK[(ty + 16 * i) * DS + d];
        av[i] = sV[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bq[j] = sQ[(tx + 16 * j) * DS + d];
        bo[j] = sdO[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(ak[i], bq[j], s[i][j]);
          dp[i][j] = fmaf(av[i], bo[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + ty + 16 * i, c = tx + 16 * j, qrow = q0 + c;
        const bool live = qrow < N && (!CAUSAL || qrow >= key);
        const float p = live ? expf(s[i][j] * scale - sL[c]) : 0.f;
        sP[(ty + 16 * i) * PS + c] = p;
        sdS[(ty + 16 * i) * PS + c] = p * (dp[i][j] - sDl[c]);
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(ty + 16 * i) * PS + c];
        dsv[i] = sdS[(ty + 16 * i) * PS + c];
      }
#pragma unroll
      for (int jd = 0; jd < NJD; ++jd) {
        const float o = sdO[c * DS + tx + 16 * jd];
        const float qq = sQ[c * DS + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][jd] = fmaf(pv[i], o, acc_v[i][jd]);
          acc_k[i][jd] = fmaf(dsv[i], qq, acc_k[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Nk) continue;
    const size_t row = koff + static_cast<size_t>(key) * D;
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd) {
      dk[row + tx + 16 * jd] = from_f<T>(acc_k[i][jd] * scale);
      dv[row + tx + 16 * jd] = from_f<T>(acc_v[i][jd]);
    }
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kSimtThreads)
bwd_dq_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int N, int Nk,
                   float scale) {
  constexpr int DS = D + 1;
  constexpr int PS = kTile + 1;
  constexpr int NJD = D / 16;
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

  load_rows_f32<T, D>(sQ, q + qoff, q0, N);
  load_rows_f32<T, D>(sdO, dout + qoff, q0, N);
  float lse_r[4], del_r[4], acc[4][NJD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
    load_rows_f32<T, D>(sK, k + koff, k0, Nk);
    load_rows_f32<T, D>(sV, v + koff, k0, Nk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float aq[4], ao[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        aq[i] = sQ[(ty + 16 * i) * DS + d];
        ao[i] = sdO[(ty + 16 * i) * DS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = sK[(tx + 16 * j) * DS + d];
        bv[j] = sV[(tx + 16 * j) * DS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(aq[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(ao[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * i, key = k0 + tx + 16 * j;
        const bool live = row < N && key < Nk && (!CAUSAL || row >= key);
        const float p = live ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sdS[(ty + 16 * i) * PS + tx + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sdS[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int jd = 0; jd < NJD; ++jd) {
        const float kk = sK[c * DS + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(dsv[i], kk, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= N) continue;
    const size_t row = qoff + static_cast<size_t>(r) * D;
#pragma unroll
    for (int jd = 0; jd < NJD; ++jd) dq[row + tx + 16 * jd] = from_f<T>(acc[i][jd] * scale);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core body (bf16 / f16): mma.sync m16n8k16, ldmatrix from padded tiles

constexpr int kTcThreads = 128;  // four warps, 16 rows of the resident tile each

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <int D>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  // four [64][D+8] 2-byte tiles, lse and delta of a q-tile
  return static_cast<size_t>(4 * kTile * (D + 8)) * 2 + 2 * kTile * sizeof(float);
}

// rows [r0, r0 + 64) of a [rows, D] matrix into a [64][D+8] tile in
// 16-byte pieces, zeros past `rows`
template <typename T, int D>
__device__ __forceinline__ void load_rows_tc(T* dst, const T* src, int r0, int rows) {
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < kTile * VPR; idx += blockDim.x) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

// ldmatrix addresses in a [64][D+8] tile (byte address `tile`).  An A
// operand (16 rows m0.., 16 columns k0..) and a B operand stored [k][n]
// (16 k rows k0.., 16 n columns n0.., read transposed) take the same
// pattern: lanes 0-15 rows 0-15 at column 0, lanes 16-31 at column 8.
template <int D>
__device__ __forceinline__ uint32_t addr_rows16(uint32_t tile, int r0, int c0, int lane) {
  return tile + ((r0 + (lane & 15)) * (D + 8) + c0 + (lane >> 4) * 8) * 2;
}
// a B operand stored [n][k] (16 n rows n0.., 16 k columns k0..): regs 0-1
// are n-tile n0..n0+7, regs 2-3 n-tile n0+8..n0+15
template <int D>
__device__ __forceinline__ uint32_t addr_b_nk(uint32_t tile, int n0, int k0, int lane) {
  return tile + ((n0 + (lane & 7) + ((lane >> 4) << 3)) * (D + 8) + k0 + ((lane >> 3) & 1) * 8) * 2;
}

// C[16 x 64] += A[16 x D] B^T, A rows `a_r0` of tile `ta`, B the 64 rows of
// tile `tb` (both [rows][D]): S, S^T, dP and dP^T
template <typename T, int D>
__device__ __forceinline__ void mma_rows_x_rows(float (&c)[8][4], uint32_t ta, int a_r0,
                                                uint32_t tb, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, addr_rows16<D>(ta, a_r0, 16 * kk, lane));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, addr_b_nk<D>(tb, 16 * np, 16 * kk, lane));
      Mma<T>::run(c[2 * np], a, b[0], b[1]);
      Mma<T>::run(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[16 x D] += X[16 x 64] M, X in registers as an accumulator fragment
// (rounded once to T here), M the 64 rows of tile `tm` ([rows][D]):
// dV += P^T dO, dK += dS^T Q, dQ += dS K
template <typename T, int D>
__device__ __forceinline__ void mma_regs_x_tile(float (&acc)[D / 8][4], const float (&x)[8][4],
                                                uint32_t tm, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {Mma<T>::pack(x[2 * kk][0], x[2 * kk][1]),
                           Mma<T>::pack(x[2 * kk][2], x[2 * kk][3]),
                           Mma<T>::pack(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           Mma<T>::pack(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, addr_rows16<D>(tm, 16 * kk, 16 * np, lane));
      Mma<T>::run(acc[2 * np], a, b[0], b[1]);
      Mma<T>::run(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Accumulator fragment of m16n8, register r of n-tile j of a lane: row
// lane/4 + 8*(r/2), column 8*j + 2*(lane%4) + (r%2).
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 8][4], int r_lo, int rows,
                                           float mul, int lane) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r_lo + 8 * hh;
    if (r >= rows) continue;
    T* orow = out + static_cast<size_t>(r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * (lane & 3)) =
          Mma<T>::pack(acc[j][2 * hh] * mul, acc[j][2 * hh + 1] * mul);
    }
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads)
bwd_dkdv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                   int N, int Nk, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kTile * LD;
  T* sQ = sV + kTile * LD;
  T* sdO = sQ + kTile * LD;
  float* sL = reinterpret_cast<float*>(sdO + kTile * LD);
  float* sDl = sL + kTile;
  const uint32_t uK = smem_u32(sK), uV = smem_u32(sV), uQ = smem_u32(sQ), udO = smem_u32(sdO);

  const int h = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qoff = static_cast<size_t>(h) * N * D, koff = static_cast<size_t>(h) * Nk * D;
  const int key_lo = k0 + 16 * warp + lane / 4;  // this lane's keys: key_lo, key_lo + 8

  load_rows_tc<T, D>(sK, k + koff, k0, Nk);
  load_rows_tc<T, D>(sV, v + koff, k0, Nk);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_k[j][r] = acc_v[j][r] = 0.f;

  const int n_qt = (N + kTile - 1) / kTile;
  for (int qt = CAUSAL ? blockIdx.x : 0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous step's reads of sQ, sdO, sL, sDl are done
    load_rows_tc<T, D>(sQ, q + qoff, q0, N);
    load_rows_tc<T, D>(sdO, dout + qoff, q0, N);
    if (threadIdx.x < kTile) {
      const bool in = q0 + static_cast<int>(threadIdx.x) < N;
      sL[threadIdx.x] = in ? lse[static_cast<size_t>(h) * N + q0 + threadIdx.x] : 0.f;
      sDl[threadIdx.x] = in ? delta[static_cast<size_t>(h) * N + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T (rows: this warp's 16 keys; columns: the tile's 64 queries)
    float p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[j][r] = 0.f;
    mma_rows_x_rows<T, D>(p, uK, 16 * warp, uQ, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = key_lo + 8 * (r >> 1), c = 8 * j + 2 * (lane & 3) + (r & 1);
        const bool live = q0 + c < N && (!CAUSAL || q0 + c >= key);
        p[j][r] = live ? expf(p[j][r] * scale - sL[c]) : 0.f;
      }
    mma_regs_x_tile<T, D>(acc_v, p, udO, lane);  // dV += P^T dO

    // dS^T = P^T (V dO^T - delta)
    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[j][r] = 0.f;
    mma_rows_x_rows<T, D>(ds, uV, 16 * warp, udO, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int c = 8 * j + 2 * (lane & 3) + (r & 1);
        ds[j][r] = p[j][r] * (ds[j][r] - sDl[c]);
      }
    mma_regs_x_tile<T, D>(acc_k, ds, uQ, lane);  // dK += dS^T Q
  }

  store_rows<T, D>(dk + koff, acc_k, key_lo, Nk, scale, lane);
  store_rows<T, D>(dv + koff, acc_v, key_lo, Nk, 1.f, lane);
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads)
bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int N, int Nk,
                 float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + kTile * LD;
  T* sK = sdO + kTile * LD;
  T* sV = sK + kTile * LD;
  const uint32_t uK = smem_u32(sK), uV = smem_u32(sV), uQ = smem_u32(sQ), udO = smem_u32(sdO);

  const int h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest causal tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qoff = static_cast<size_t>(h) * N * D, koff = static_cast<size_t>(h) * Nk * D;
  const int row_lo = q0 + 16 * warp + lane / 4;  // this lane's rows: row_lo, row_lo + 8

  load_rows_tc<T, D>(sQ, q + qoff, q0, N);
  load_rows_tc<T, D>(sdO, dout + qoff, q0, N);
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row_lo + 8 * hh;
    lse_r[hh] = r < N ? lse[static_cast<size_t>(h) * N + r] : 0.f;
    del_r[hh] = r < N ? delta[static_cast<size_t>(h) * N + r] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  int n_kt = (Nk + kTile - 1) / kTile;
  if (CAUSAL) n_kt = min(n_kt, (min(q0 + kTile, N) + kTile - 1) / kTile);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous step's reads of sK, sV are done
    load_rows_tc<T, D>(sK, k + koff, k0, Nk);
    load_rows_tc<T, D>(sV, v + koff, k0, Nk);
    __syncthreads();

    // S = Q K^T (rows: this warp's 16 queries; columns: the tile's 64 keys)
    float p[8][4], ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[j][r] = ds[j][r] = 0.f;
    mma_rows_x_rows<T, D>(p, uQ, 16 * warp, uK, lane);
    mma_rows_x_rows<T, D>(ds, udO, 16 * warp, uV, lane);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int hh = r >> 1, row = row_lo + 8 * hh;
        const int key = k0 + 8 * j + 2 * (lane & 3) + (r & 1);
        const bool live = row < N && key < Nk && (!CAUSAL || row >= key);
        const float pr = live ? expf(p[j][r] * scale - lse_r[hh]) : 0.f;
        ds[j][r] = pr * (ds[j][r] - del_r[hh]);
      }
    mma_regs_x_tile<T, D>(acc, ds, uK, lane);  // dQ += dS K
  }

  store_rows<T, D>(dq + qoff, acc, row_lo, N, scale, lane);
}

// ---------------------------------------------------------------------------
// launches

template <typename Kern>
cudaError_t opt_in_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, bool CAUSAL, bool TC>
cudaError_t launch_all(const void* q, const void* k, const void* v, const void* o,
                       const void* lse, const void* dout, void* dq, void* dk, void* dv,
                       void* delta, int H, int N, int Nk, float scale, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  const int rows = H * N;
  bwd_delta_kernel<T, D><<<(rows + 7) / 8, 256, 0, stream>>>(static_cast<const T*>(o), do_, delta_,
                                                             rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((Nk + kTile - 1) / kTile, H), grid_q((N + kTile - 1) / kTile, H);
  if constexpr (TC) {
    constexpr size_t smem = tc_smem_bytes<D>();
    auto kdkdv = bwd_dkdv_tc_kernel<T, D, CAUSAL>;
    auto kdq = bwd_dq_tc_kernel<T, D, CAUSAL>;
    if ((err = opt_in_smem(kdkdv, smem)) != cudaSuccess) return err;
    if ((err = opt_in_smem(kdq, smem)) != cudaSuccess) return err;
    kdkdv<<<grid_k, kTcThreads, smem, stream>>>(q_, k_, v_, do_, lse_, delta_, static_cast<T*>(dk),
                                                static_cast<T*>(dv), N, Nk, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    kdq<<<grid_q, kTcThreads, smem, stream>>>(q_, k_, v_, do_, lse_, delta_, static_cast<T*>(dq),
                                              N, Nk, scale);
  } else {
    constexpr size_t smem = simt_smem_bytes<D>();
    auto kdkdv = bwd_dkdv_simt_kernel<T, D, CAUSAL>;
    auto kdq = bwd_dq_simt_kernel<T, D, CAUSAL>;
    if ((err = opt_in_smem(kdkdv, smem)) != cudaSuccess) return err;
    if ((err = opt_in_smem(kdq, smem)) != cudaSuccess) return err;
    kdkdv<<<grid_k, kSimtThreads, smem, stream>>>(q_, k_, v_, do_, lse_, delta_,
                                                  static_cast<T*>(dk), static_cast<T*>(dv), N, Nk,
                                                  scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    kdq<<<grid_q, kSimtThreads, smem, stream>>>(q_, k_, v_, do_, lse_, delta_,
                                                static_cast<T*>(dq), N, Nk, scale);
  }
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_typed(int dtype, const void* q, const void* k, const void* v, const void* o,
                         const void* lse, const void* dout, void* dq, void* dk, void* dv,
                         void* delta, int H, int N, int Nk, float scale, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_all<float, D, CAUSAL, false>(q, k, v, o, lse, dout, dq, dk, dv, delta, H, N,
                                                 Nk, scale, stream);
    case 1:
      return launch_all<__half, D, CAUSAL, true>(q, k, v, o, lse, dout, dq, dk, dv, delta, H, N,
                                                 Nk, scale, stream);
    case 2:
      return launch_all<__nv_bfloat16, D, CAUSAL, true>(q, k, v, o, lse, dout, dq, dk, dv, delta,
                                                        H, N, Nk, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_causal(int causal, int dtype, const void* q, const void* k, const void* v,
                          const void* o, const void* lse, const void* dout, void* dq, void* dk,
                          void* dv, void* delta, int H, int N, int Nk, float scale,
                          cudaStream_t stream) {
  return causal ? launch_typed<D, true>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, H, N, Nk,
                                        scale, stream)
                : launch_typed<D, false>(dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, H, N,
                                         Nk, scale, stream);
}

}  // namespace

// dtype: 0 float32 (CUDA-core body), 1 float16, 2 bfloat16 (tensor-core
// body); q/o/dout/dq [H, N, D], k/v/dk/dv [H, Nk, D], lse and delta (f32
// scratch the caller allocates) [H, N], all contiguous and 16-byte
// aligned; D 64 or 128
extern "C" int dtpu_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* lse, const void* dout, void* dq, void* dk, void* dv,
                              void* delta, int H, int N, int Nk, int D, int dtype, int causal,
                              float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (H <= 0 || N <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {q, k, v, o, dout, static_cast<const void*>(dq),
                        static_cast<const void*>(dk), static_cast<const void*>(dv)}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  cudaError_t err;
  switch (D) {
    case 64:
      err = launch_causal<64>(causal, dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, H, N, Nk,
                              scale, stream);
      break;
    case 128:
      err = launch_causal<128>(causal, dtype, q, k, v, o, lse, dout, dq, dk, dv, delta, H, N, Nk,
                               scale, stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
