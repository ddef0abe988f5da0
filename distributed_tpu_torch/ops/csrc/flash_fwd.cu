// Flash-attention forward (kernel K2).
//
// Replaces distributed_tpu/ops/flash.py::_flash_kernel, the Pallas TPU
// kernel launched by _flash_call (grid heads x q-tiles x k-tiles, k-tiles
// innermost, running max / sum / accumulator carried in VMEM scratch).
// The plain version beside it is ops/flash.py::flash_forward_reference.
//
// Translation: blocks run in parallel and in no order on Hopper, so the
// TPU's sequential innermost k-tile grid axis becomes a loop inside one
// block per (q-tile, head).  The running max m, sum l and the unnormalised
// accumulator live in registers; each K/V tile is staged through shared
// memory.  Causal k-tiles strictly above the diagonal are skipped by the
// loop bound.  Masking uses the reference's finite -1e30; keys past a
// ragged end are -inf, their K/V rows zero-filled.  Compute is f32 for
// f32, f16 and bf16 inputs, q is scaled before the product, O is written
// in the input dtype and the logsumexp as f32 [H, N, 1].
//
// Bound on an H100 at the smoke shapes (bf16, seq 8192, 16 heads, head
// dim 128): operations.  4*N*Nk*D*H = 5.5e11 flop non-causal (about half
// causal) against ~134 MB of q/k/v/o: ~0.56 ms at the 989 TFLOP/s bf16
// tensor-core peak versus ~0.04 ms of bytes.  This first kernel stays on
// the CUDA cores in f32 (no tensor cores, ~67 TFLOP/s peak), so it cannot
// come near that bound; what its design does is keep the f32 work fed:
// 64x64 tiles, 256 threads each holding a 4x4 score block and a
// 4x(D/16) slice of the accumulator, Q (pre-scaled, transposed) and the
// K tile (transposed) padded in shared memory so every inner-loop read is
// a broadcast or conflict-free, K/V kept in their input dtype to fit two
// blocks per SM at head dim 128.  wgmma, TMA and warp specialisation are
// the next step.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// K tile row stride (elements): an odd number of 32-bit words, so the
// transposing store spreads over the banks
template <typename T> __host__ __device__ constexpr int k_stride() {
  return sizeof(T) == 4 ? BK + 1 : BK + 2;
}

template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * D * (BQ + 1)          // sQ  [D][BQ+1]
       + sizeof(T) * D * k_stride<T>()         // sK  [D][BK+pad]
       + sizeof(T) * BK * D                    // sV  [BK][D]
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

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int N, int Nk, float scale) {
  constexpr int KS = k_stride<T>();
  constexpr int NJD = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  T* sK = reinterpret_cast<T*>(sQ + D * (BQ + 1));
  T* sV = sK + D * KS;
  float* sP = reinterpret_cast<float*>(sV + BK * D);

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
      sV[r * D + d] = in ? vh[g] : from_f<T>(0.f);
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
        const float vv = to_f(sV[c * D + tx + 16 * jd]);
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
    for (int jd = 0; jd < NJD; ++jd) orow[tx + 16 * jd] = from_f<T>(acc[i][jd] / lc);
    if (tx == 0) lse[static_cast<size_t>(h) * N + r] = m[i] + logf(lc);
  }
}

template <typename T, int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int H, int N, int Nk, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D, CAUSAL>;
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), N, Nk, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_causal(int causal, const void* q, const void* k, const void* v,
                          void* o, void* lse, int H, int N, int Nk, float scale,
                          cudaStream_t stream) {
  return causal ? launch<T, D, true>(q, k, v, o, lse, H, N, Nk, scale, stream)
                : launch<T, D, false>(q, k, v, o, lse, H, N, Nk, scale, stream);
}

template <typename T>
cudaError_t launch_dim(int D, int causal, const void* q, const void* k,
                       const void* v, void* o, void* lse, int H, int N, int Nk,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_causal<T, 64>(causal, q, k, v, o, lse, H, N, Nk, scale, stream);
    case 128:
      return launch_causal<T, 128>(causal, q, k, v, o, lse, H, N, Nk, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16; q/o [H, N, D], k/v [H, Nk, D],
// lse [H, N] f32, all contiguous
extern "C" int dtpu_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int H, int N, int Nk, int D,
                              int dtype, int causal, float scale,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (H <= 0 || N <= 0 || Nk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_dim<float>(D, causal, q, k, v, o, lse, H, N, Nk, scale, stream);
      break;
    case 1:
      err = launch_dim<__half>(D, causal, q, k, v, o, lse, H, N, Nk, scale, stream);
      break;
    case 2:
      err = launch_dim<__nv_bfloat16>(D, causal, q, k, v, o, lse, H, N, Nk, scale,
                                      stream);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
