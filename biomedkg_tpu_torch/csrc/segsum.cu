// Sorted segment-sum for NVIDIA Hopper (sm_90a).
//
//   out[n, :] = sum of data[i, :] over the rows i with ids[i] == n
//
// ids are int32, normally ascending (destination-sorted graph edges); an id
// outside [0, num_segments) — the padding id -1 — is skipped. data is
// float32 or bfloat16 (read through __bfloat162float); the sum is float32.
// The result is exact for any id order: only the summation order differs
// from a sequential sum.
//
// Replaces the TPU kernel biomedkg_tpu/ops/pallas/segsum.py::_segsum_pallas
// (kernel body _kernel): there a windowed one-hot matmul on the MXU with the
// whole output resident in VMEM. Hopper has no use for either trick: the
// sum needs no matrix unit, and an atomicAdd into the L2-resident output
// replaces the resident block.
//
// Bound: device-memory bytes. A call reads M*d*itemsize bytes of data and
// 4*M bytes of ids and writes N*d*4 bytes; it does M*d float adds. At the
// serving path's shapes (M = 1.16 M edge slots, d = 256, f32, N = 51,712)
// that is ~1.25 GB, about 0.37 ms at 3.35 TB/s, against ~4 us of adds at
// 67 TFLOP/s. What this simple design does about that bound: every data
// byte is read once, by neighbouring threads at neighbouring addresses
// (threads span the feature columns of one row), with kUnroll rows of
// loads in flight per thread; each thread keeps a running sum for the
// current id and flushes it with one atomicAdd when the id changes, so
// sorted input costs one atomic per (distinct id in the chunk, column)
// and the output is written about once. Unsorted input flushes on every
// change and stays exact, only slower. Faster designs (TMA / cp.async
// staging, warp-level segmented scans, fewer atomics) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // threads per block
constexpr int kUnroll = 4;        // rows of loads in flight per thread
constexpr int kBlocksPerSm = 16;  // grid size target
constexpr int64_t kMinRows = 32;  // least rows per thread group

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One step of the running sum: flush on an id change, skip out-of-range.
__device__ __forceinline__ void step(int32_t id, float v, int32_t& cur,
                                     float& acc, float* out, int d, int c,
                                     int64_t num_segments) {
  if (id < 0 || id >= num_segments) return;
  if (id != cur) {
    if (cur >= 0) atomicAdd(out + (int64_t)cur * d + c, acc);
    cur = id;
    acc = 0.f;
  }
  acc += v;
}

// The block's threads form groups of `group_width` lanes; a group owns a
// contiguous chunk of `rows_per_group` rows and its lanes walk the columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    segsum_kernel(const T* __restrict__ data, const int32_t* __restrict__ ids,
                  float* __restrict__ out, int64_t m, int d,
                  int64_t num_segments, int group_width,
                  int64_t rows_per_group) {
  const int groups = kThreads / group_width;
  const int lane = threadIdx.x % group_width;
  const int64_t group = (int64_t)blockIdx.x * groups + threadIdx.x / group_width;
  const int64_t row0 = group * rows_per_group;
  if (row0 >= m) return;  // no block-level barrier below
  const int64_t row1 = row0 + rows_per_group < m ? row0 + rows_per_group : m;

  for (int c = lane; c < d; c += group_width) {
    float acc = 0.f;
    int32_t cur = -1;
    int64_t i = row0;
    for (; i + kUnroll <= row1; i += kUnroll) {
      int32_t id[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        id[u] = ids[i + u];
        v[u] = to_float(data[(i + u) * d + c]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        step(id[u], v[u], cur, acc, out, d, c, num_segments);
    }
    for (; i < row1; ++i)
      step(ids[i], to_float(data[i * d + c]), cur, acc, out, d, c,
           num_segments);
    if (cur >= 0) atomicAdd(out + (int64_t)cur * d + c, acc);
  }
}

template <typename T>
int launch(const void* data, const void* ids, void* out, long long m, int d,
           long long num_segments, void* stream) {
  if (m <= 0 || d <= 0 || num_segments <= 0) return (int)cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  int group_width = 1;
  while (group_width < d && group_width < kThreads) group_width <<= 1;
  const int groups = kThreads / group_width;
  const int64_t target_groups = (int64_t)sms * kBlocksPerSm * groups;
  int64_t rows_per_group = (m + target_groups - 1) / target_groups;
  if (rows_per_group < kMinRows) rows_per_group = kMinRows;
  const int64_t rows_per_block = rows_per_group * groups;
  const int64_t blocks = (m + rows_per_block - 1) / rows_per_block;

  segsum_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(data), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), m, d, num_segments, group_width,
      rows_per_group);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. `out` must hold num_segments*d zeroed
// floats; nothing is allocated and nothing synchronises. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int segsum_f32(const void* data, const void* ids, void* out,
                          long long m, int d, long long num_segments,
                          void* stream) {
  return launch<float>(data, ids, out, m, d, num_segments, stream);
}

extern "C" int segsum_bf16(const void* data, const void* ids, void* out,
                           long long m, int d, long long num_segments,
                           void* stream) {
  return launch<__nv_bfloat16>(data, ids, out, m, d, num_segments, stream);
}
