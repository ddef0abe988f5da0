// The bucket pass of the mesh hash shuffle (kernel K12).
//
// Replaces the per-shard body of distributed_tpu/ops/ici.py's
// _shuffle_program.local (ici.py:57-80): each shard's rows go to
// destination mix32(key) % n_dev, each (src -> dst) block padded to the
// capacity.  The plain version beside it is
// ops/ici.py::shuffle_bucket_reference.
//
// What it computes, for every shard s of one device (blockIdx.y = s):
//   - dest[i] = mix32(key[i]) % n_dev for a valid row; a masked row goes
//     nowhere and counts nowhere;
//   - sent[s][d] = the number of valid rows with destination d (the TRUE
//     count, never clamped);
//   - each row's rank among the rows of its destination in source order
//     (the reference sorts stably by destination), and the key and value
//     row written to send[d][rank] when rank < capacity; a row past the
//     capacity is dropped but counted;
//   - zeros in every block from min(sent, capacity) to the capacity.
//
// The output must equal the plain version bit for bit, so no atomic
// decides an order.  Four launches:
//   1. a histogram a tile of kTile rows (per warp: __match_any_sync groups
//      the lanes of one destination and its leader adds the group's size
//      to the block's shared counts; the counts do not depend on order);
//   2. for each (shard, destination) a block scans the tiles' counts in
//      tile order into each tile's first rank (exclusive), and writes the
//      total to sent;
//   3. the scatter: a block walks its tile 256 rows a pass in source
//      order; a row's rank is its tile's first rank, plus the rows of its
//      destination in the warps before it this pass, plus the lanes before
//      it in its warp's group; the value row is copied in vectors of
//      `vec` bytes (16 where the row width and addresses allow);
//   4. the tail: each block of each shard's send buffers is zeroed from
//      its count to the capacity, so every output byte is written once.
//
// Bound on an H100: bytes.  Keys are read twice (histogram, scatter),
// values once; the send buffers are written once, padding included.
//
// Every array is reached through a device table of per-shard pointers, so
// a call takes the shards where they lie (views of one global tensor or
// separate tensors).  The launches use the stream they are given, allocate
// nothing and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;            // rows a block of launches 1 and 3 (ops/ici.py SHUFFLE_TILE)
constexpr int kPasses = kTile / kThreads;
constexpr int kScanThreads = 1024;
constexpr int kMaxDests = 1024;        // ops/ici.py MAX_DESTS_CUDA

__device__ __forceinline__ uint32_t mix32(uint32_t z) {
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

// destination of row i of shard s: -1 masked, -2 past the end
__device__ __forceinline__ int dest_of(const int32_t* keys, const uint8_t* valid, int i, int n,
                                       int n_dev) {
  if (i >= n) return -2;
  if (valid != nullptr && !valid[i]) return -1;
  return (int)(mix32((uint32_t)keys[i]) % (uint32_t)n_dev);
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int32_t* const* keys, const uint8_t* const* valid, int* hist, int n, int n_dev,
            int tiles) {
  extern __shared__ int cnt[];  // [n_dev]
  const int s = blockIdx.y, t = blockIdx.x;
  for (int d = threadIdx.x; d < n_dev; d += kThreads) cnt[d] = 0;
  __syncthreads();
  const int32_t* k = keys[s];
  const uint8_t* m = valid != nullptr ? valid[s] : nullptr;
  const int lane = threadIdx.x & 31;
  for (int p = 0; p < kPasses; ++p) {
    const int i = t * kTile + p * kThreads + threadIdx.x;
    const int d = dest_of(k, m, i, n, n_dev);
    const unsigned grp = __match_any_sync(kFull, d);
    if (d >= 0 && lane == __ffs(grp) - 1) atomicAdd(&cnt[d], __popc(grp));
  }
  __syncthreads();
  int* out = hist + ((long long)s * tiles + t) * n_dev;
  for (int d = threadIdx.x; d < n_dev; d += kThreads) out[d] = cnt[d];
}

// each tile's count of destination d -> the tile's first rank (exclusive
// scan in tile order); the total is sent[s][d]
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* hist, int* sent, int n_dev, int tiles) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry;
  const int d = blockIdx.x, s = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* col = hist + (long long)s * tiles * n_dev + d;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < tiles; base += kScanThreads) {
    const int t = base + threadIdx.x;
    const int v = t < tiles ? col[(long long)t * n_dev] : 0;
    int x = v;  // inclusive scan in the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_sum[warp - 1] : 0);
    if (t < tiles) col[(long long)t * n_dev] = before + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) sent[s * n_dev + d] = carry;
}

template <typename V>
__device__ __forceinline__ void copy_row(char* dst, const char* src, int units) {
  V* o = reinterpret_cast<V*>(dst);
  const V* in = reinterpret_cast<const V*>(src);
  for (int u = 0; u < units; ++u) o[u] = in[u];
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int32_t* const* keys, const char* const* vals, const uint8_t* const* valid,
               int32_t* const* send_k, char* const* send_v, const int* hist, int n, int n_dev,
               int cap, int row_bytes, int tiles) {
  extern __shared__ int smem[];
  int* run = smem;                   // [n_dev] next rank of each destination in this tile
  int* wcnt = smem + n_dev;          // [kWarps][n_dev] this pass's rows by warp
  const int s = blockIdx.y, t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t* k = keys[s];
  const char* v = vals[s];
  const uint8_t* m = valid != nullptr ? valid[s] : nullptr;
  int32_t* ok = send_k[s];
  char* ov = send_v[s];
  const int units = row_bytes / (int)sizeof(V);
  const int* first = hist + ((long long)s * tiles + t) * n_dev;
  for (int d = threadIdx.x; d < n_dev; d += kThreads) run[d] = first[d];
  for (int p = 0; p < kPasses; ++p) {
    for (int j = threadIdx.x; j < kWarps * n_dev; j += kThreads) wcnt[j] = 0;
    __syncthreads();
    const int i = t * kTile + p * kThreads + threadIdx.x;
    const int d = dest_of(k, m, i, n, n_dev);
    const unsigned grp = __match_any_sync(kFull, d);
    const int in_warp = __popc(grp & ((1u << lane) - 1u));
    if (d >= 0 && in_warp == 0) wcnt[warp * n_dev + d] = __popc(grp);
    __syncthreads();
    if (d >= 0) {
      int r = run[d] + in_warp;
      for (int w = 0; w < warp; ++w) r += wcnt[w * n_dev + d];
      if (r < cap) {
        const long long slot = (long long)d * cap + r;
        ok[slot] = k[i];
        copy_row<V>(ov + slot * row_bytes, v + (long long)i * row_bytes, units);
      }
    }
    __syncthreads();
    for (int dd = threadIdx.x; dd < n_dev; dd += kThreads) {
      int add = 0;
      for (int w = 0; w < kWarps; ++w) add += wcnt[w * n_dev + dd];
      run[dd] += add;
    }
    __syncthreads();  // wcnt is zeroed again at the top of the next pass
  }
}

// zero block (s, d) of the send buffers from min(sent, cap) to cap
template <typename V>
__global__ void __launch_bounds__(kThreads)
tail_kernel(int32_t* const* send_k, char* const* send_v, const int* sent, int n_dev, int cap,
            int row_bytes) {
  const int s = blockIdx.y / n_dev, d = blockIdx.y % n_dev;
  const int from = min(sent[s * n_dev + d], cap);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  int32_t* ok = send_k[s] + (long long)d * cap;
  for (long long r = from + first; r < cap; r += stride) ok[r] = 0;
  const int units = row_bytes / (int)sizeof(V);
  V* ov = reinterpret_cast<V*>(send_v[s] + (long long)d * cap * row_bytes);
  const V zero{};
  for (long long u = (long long)from * units + first; u < (long long)cap * units; u += stride)
    ov[u] = zero;
}

template <typename V>
cudaError_t launch(const void* keys, const void* vals, const void* valid, void* send_k,
                   void* send_v, int* sent, int* hist, int S, int n, int n_dev, int cap,
                   int row_bytes, cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  auto K = static_cast<const int32_t* const*>(keys);
  auto M = static_cast<const uint8_t* const*>(valid);
  auto SK = static_cast<int32_t* const*>(send_k);
  auto SV = static_cast<char* const*>(send_v);
  if (tiles > 0) {
    hist_kernel<<<dim3(tiles, S), kThreads, n_dev * sizeof(int), stream>>>(K, M, hist, n, n_dev,
                                                                           tiles);
  }
  scan_kernel<<<dim3(n_dev, S), kScanThreads, 0, stream>>>(hist, sent, n_dev, tiles);
  if (tiles > 0) {
    const size_t smem = (size_t)(kWarps + 1) * n_dev * sizeof(int);
    scatter_kernel<V><<<dim3(tiles, S), kThreads, smem, stream>>>(
        K, static_cast<const char* const*>(vals), M, SK, SV, hist, n, n_dev, cap, row_bytes,
        tiles);
  }
  const long long units = (long long)cap * (row_bytes / (int)sizeof(V));
  const long long per = units > cap ? units : cap;
  const int bx = (int)min((per + kThreads - 1) / kThreads, 512LL);
  tail_kernel<V><<<dim3(bx, S * n_dev), kThreads, 0, stream>>>(SK, SV, sent, n_dev, cap,
                                                               row_bytes);
  return cudaGetLastError();
}

struct alignas(2) U2 { uint16_t x; };

}  // namespace

extern "C" int dtpu_shuffle_bucket(const void* keys, const void* vals, const void* valid,
                                   void* send_k, void* send_v, int* sent, int* hist, int S, int n,
                                   int n_dev, int cap, int row_bytes, int vec,
                                   cudaStream_t stream) {
  if (S < 1 || S > 65535 || n < 0 || n_dev < 1 || n_dev > kMaxDests || cap < 1 ||
      row_bytes < 0 || (vec > 0 && row_bytes % vec) || (long long)S * n_dev > 65535)
    return (int)cudaErrorInvalidValue;
  switch (vec) {
    case 16: return (int)launch<int4>(keys, vals, valid, send_k, send_v, sent, hist, S, n, n_dev,
                                      cap, row_bytes, stream);
    case 8: return (int)launch<int2>(keys, vals, valid, send_k, send_v, sent, hist, S, n, n_dev,
                                     cap, row_bytes, stream);
    case 4: return (int)launch<int>(keys, vals, valid, send_k, send_v, sent, hist, S, n, n_dev,
                                    cap, row_bytes, stream);
    case 2: return (int)launch<U2>(keys, vals, valid, send_k, send_v, sent, hist, S, n, n_dev,
                                   cap, row_bytes, stream);
    case 1: return (int)launch<char>(keys, vals, valid, send_k, send_v, sent, hist, S, n, n_dev,
                                     cap, row_bytes, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
