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
// What a launch reads: one record buffer that ops/fleet.py::pack_records
// fills on the host, in pinned memory:
//   - a table of jobs, 40 B each (ops/fleet.py JOB): the destination, the
//     source block (null: write the destination in place), the byte
//     offsets of the job's rows (int32, indices into the destination) and
//     values (the destination's dtype, one a row), the row count, the
//     block's length and the element size (1 or 4 B: bool, int8, int32,
//     float32, copied as bytes, so the result is the host's bits);
//   - the rows and values, each section 16-byte aligned.  Jobs of one view
//     share one rows section (K6), or one a shard (K11).
// A job is one block: it copies the source block into the destination if
// it has one, __syncthreads (the copy is then visible to the block), and
// writes its rows.  The dirty set is a set, so no two rows of a job name
// one element and the writes need no order.
//
// The kernel reads the pinned buffer through its device address
// (cudaHostGetDevicePointer): each record crosses PCIe once, on the
// kernel's first touch.  A cudaMemcpyAsync of the records into device
// scratch before the launch was timed against it on the card, in turns in
// the same runs: neither won every run (the two within 0.03 ms, either
// way), so the copy, a second buffer and a second call, went (PERF.md).
//
// Bound on an H100: bytes, and at the mirror's sizes the launch.  The
// records (40 B a job, 4 B a row, 1-4 B a value) cross PCIe once (64 GB/s
// a direction, PCIe 5.0 x16) and each value is written once to device
// memory; a K11 job also reads and writes its block once.  At 37 dirty
// rows and four fields the rows and values are 518 B, ~8 ns over PCIe
// (the job table and the alignment add ~220 B): the floor is the
// launch itself, which chip_smoke.py times as an empty launch of this
// kernel (no job).  What the design does about it: one launch a view on a
// device, whatever the fields and shards, in place of the torch ops' two
// copies and an index_copy_ a field (K6) or a clone, two copies and an
// index_copy_ a shard and field (K11), and no wait for the host: the
// record buffers come from a ring whose slot is reused only after the
// launch that read it has run (ops/fleet.py::RecordRing).

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
__device__ void run_job(const unsigned char* rec, const Job& job) {
  T* dst = reinterpret_cast<T*>(job.dst);
  if (job.src != 0) {
    const T* src = reinterpret_cast<const T*>(job.src);
    for (int i = threadIdx.x; i < job.n_block; i += kThreads) dst[i] = src[i];
    __syncthreads();
  }
  const int32_t* rows = reinterpret_cast<const int32_t*>(rec + job.rows);
  const T* vals = reinterpret_cast<const T*>(rec + job.vals);
  for (int i = threadIdx.x; i < job.n; i += kThreads) dst[rows[i]] = vals[i];
}

__global__ void __launch_bounds__(kThreads) fleet_scatter_kernel(const unsigned char* rec, int nj) {
  __shared__ Job job;
  if (blockIdx.x >= nj) return;  // the empty launch: no job
  if (threadIdx.x == 0) job = reinterpret_cast<const Job*>(rec)[blockIdx.x];
  __syncthreads();
  if (job.elem == 4) {
    run_job<uint32_t>(rec, job);
  } else {
    run_job<uint8_t>(rec, job);
  }
}

}  // namespace

// One view's jobs on one device: `nj` jobs in the pinned records at
// `rec_host`.  nj 0 launches one block that does nothing (the floor
// chip_smoke.py times).
extern "C" int dtpu_fleet_scatter(const void* rec_host, int nj, void* stream_ptr) {
  if (nj < 0) return static_cast<int>(cudaErrorInvalidValue);
  void* rec = nullptr;
  if (nj > 0) {
    cudaError_t err = cudaHostGetDevicePointer(&rec, const_cast<void*>(rec_host), 0);
    if (err != cudaSuccess) {
      cudaGetLastError();  // not left behind for the next launch's check
      return static_cast<int>(err);
    }
  }
  fleet_scatter_kernel<<<nj > 0 ? nj : 1, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const unsigned char*>(rec), nj);
  return static_cast<int>(cudaGetLastError());
}
