// The fleet mirror's two device views (kernels K6 and K11), one launch a
// view on each device.
//
// Replaces the XLA programs behind the reference mirror's views:
//   - K6, distributed_tpu/scheduler/mirror.py:356 _device_view: the dirty
//     rows of each cached field written into its capacity-sized array
//     (the reference's .at[rows].set);
//   - K11, distributed_tpu/scheduler/mirror.py:428 _sharded_device_view:
//     the dirty rows of each (workers-axis shard, field) written into a new
//     copy of that shard's block; a block handed out is never written.
// The plain version beside it is ops/fleet.py::scatter_rows_reference (the
// port's torch ops before this kernel: index_copy_, and a clone first for
// K11).
//
// What a launch reads: one record buffer in pinned host memory, laid out
// once a plan by ops/fleet.py::ScatterPlan and read by the kernel through
// its device address (taken once, at the buffer's allocation):
//   - a table of jobs, 40 B each (ops/fleet.py JOB): the destination, the
//     source block (null: write the destination in place), the byte
//     offsets of the job's rows (int32, indices into the destination) and
//     values (the destination's dtype, one a row), the row count, the
//     block's length and the element size (1 or 4 B: bool, int8, int32,
//     float32, copied as bytes, so the result is the host's bits);
//   - the rows and values, each section 16-byte aligned: one rows section
//     for every field of a K6 view, one a shard for K11.
// `n` >= 0 gives every job that row count (K6: the table is written once a
// buffer, and only the count changes from view to view); -1 reads each
// job's own.  A job is one block: it copies the source block into the
// destination if it has one, __syncthreads (the copy is then visible to
// the block), and writes its rows.  The dirty set is a set, so no two rows
// of a job name one element and the writes need no order.
//
// Completion: the host reuses a record buffer only after the launch that
// read it has run.  Each block, done with its job, adds one to the
// buffer's block count in device memory; the block that brings it to
// `target` (every block of every launch of this buffer so far) stores the
// launch's number `seq` into `done`, a word of mapped host memory, with a
// system-scope release.  The host reads the word from its own memory, with
// no call into the driver, and waits (for the card) only when the
// ring comes round to a buffer whose launch has not run.  (A CUDA event a
// buffer, recorded after the launch and queried through the runtime, cost
// the host 3-6 µs more a view on an NVIDIA H100 80GB HBM3 at 700 W:
// PERF.md.)
//
// Bound on an H100: bytes, and at the mirror's sizes the launch.  The
// records' rows and values (4 B a row, 1-4 B a value) cross PCIe once (64
// GB/s a direction, PCIe 5.0 x16) and each value is written once to device
// memory; a K11 job also reads and writes its block once.  At 37 dirty
// rows and four fields the rows and values are 518 B, ~8 ns over PCIe: the
// floor is the launch itself, which chip_smoke.py times as an empty launch
// of this kernel (no job).  What the design does about it: one launch a
// view on a device, whatever the fields and shards, and a host side that
// only writes the rows and values into a buffer laid out in advance and
// launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Job {            // ops/fleet.py JOB, 40 bytes
  uint64_t dst;         // device address of the destination
  uint64_t src;         // device address of the source block, or 0
  int32_t rows;         // byte offset of the rows (int32) in the records
  int32_t vals;         // byte offset of the values
  int32_t n;            // rows
  int32_t n_block;      // elements of the source block (0 without one)
  int32_t elem;         // element size in bytes: 1 or 4
  int32_t pad;
};
static_assert(sizeof(Job) == 40, "ops/fleet.py JOB is 40 bytes");

template <typename T>
__device__ void run_job(const unsigned char* rec, const Job& job, int n) {
  T* dst = reinterpret_cast<T*>(job.dst);
  if (job.src != 0) {
    const T* src = reinterpret_cast<const T*>(job.src);
    for (int i = threadIdx.x; i < job.n_block; i += kThreads) dst[i] = src[i];
    __syncthreads();
  }
  const int32_t* rows = reinterpret_cast<const int32_t*>(rec + job.rows);
  const T* vals = reinterpret_cast<const T*>(rec + job.vals);
  for (int i = threadIdx.x; i < n; i += kThreads) dst[rows[i]] = vals[i];
}

__global__ void __launch_bounds__(kThreads) fleet_scatter_kernel(
    const unsigned char* rec, int nj, int n, unsigned long long* done, unsigned long long seq,
    unsigned long long* count, unsigned long long target) {
  __shared__ Job job;
  if (blockIdx.x >= nj) return;  // the empty launch: no job
  if (threadIdx.x == 0) job = reinterpret_cast<const Job*>(rec)[blockIdx.x];
  __syncthreads();
  const int rows = n >= 0 ? n : job.n;
  if (job.elem == 4) {
    run_job<uint32_t>(rec, job, rows);
  } else {
    run_job<uint8_t>(rec, job, rows);
  }
  if (done == nullptr) return;
  __syncthreads();  // every thread's reads of the records are done
  if (threadIdx.x != 0) return;
  __threadfence();
  if (atomicAdd(count, 1ULL) + 1 == target) {
    asm volatile("st.release.sys.u64 [%0], %1;" ::"l"(done), "l"(seq) : "memory");
  }
}

}  // namespace

// One view's jobs on one device: `nj` jobs in the records at device address
// `rec`, `n` rows each (-1: each job's own count); `done`, `seq`, `count`
// and `target` as above, or null.  nj 0 launches one block that does
// nothing (the floor chip_smoke.py times).
extern "C" int dtpu_fleet_scatter(const void* rec, int nj, int n, unsigned long long* done,
                                  unsigned long long seq, unsigned long long* count,
                                  unsigned long long target, void* stream_ptr) {
  if (nj < 0) return static_cast<int>(cudaErrorInvalidValue);
  fleet_scatter_kernel<<<nj > 0 ? nj : 1, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const unsigned char*>(rec), nj, n, nj > 0 ? done : nullptr, seq, count, target);
  return static_cast<int>(cudaGetLastError());
}

// The device address of pinned host memory, taken once a buffer.
extern "C" int dtpu_fleet_device_address(void* host, void** out) {
  cudaError_t err = cudaHostGetDevicePointer(out, host, 0);
  if (err != cudaSuccess) cudaGetLastError();  // not left behind for the next launch's check
  return static_cast<int>(err);
}
