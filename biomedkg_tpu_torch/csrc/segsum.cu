// Sorted segment-sum for NVIDIA Hopper (sm_90a).
//
//   out[n, :] = sum of data[i, :] over the rows i with ids[i] == n
//
// ids are int32, normally ascending (destination-sorted graph edges); an id
// outside [0, num_segments) — the padding id -1 — is skipped. data is
// float32 or bfloat16; the sum is float32. The result is exact for any id
// order: only the summation order differs from a sequential sum.
//
// Replaces the TPU kernel biomedkg_tpu/ops/pallas/segsum.py::_segsum_pallas
// (kernel body _kernel): there a windowed one-hot matmul on the MXU with the
// whole output resident in VMEM. Hopper has no use for either trick: the
// sum needs no matrix unit, and the output is written straight to memory.
//
// Bound: device-memory bytes. A call reads M*d*itemsize bytes of data and
// 4*M bytes of ids and writes N*d*4 bytes; it does M*d float adds. At the
// serving path's shapes (M = 1.16 M edge slots, d = 256, f32, N = 51,712)
// that is ~1.25 GB, about 0.37 ms at 3.35 TB/s, against ~4 us of adds at
// 67 TFLOP/s.
//
// Two designs, picked per call by the wrapper (ops/segsum.py::
// segsum_instance):
//
// * The owner design (owner_kernel; instances "packed" and "general"), the
//   path's. One cooperative launch, every block resident, no output fill:
//   - Rows are cut into chunks; a group of `group` lanes walks a chunk in
//     order, a row at a time. In the "packed" instance a lane takes 16-byte
//     units of a row (4 floats or 8 bf16), up to P of them, and a group
//     walks in rounds of U / 2 rows, the next round's loads in flight
//     while it adds one (ids four a load); "general" takes any width and
//     alignment one element a lane.
//   - Each group's first round of loads is issued first; under it, phase A
//     checks the ids for ascending order (every thread a share) and zeroes
//     the output row of each segment that crosses a chunk boundary; then
//     one grid barrier.
//   - Ascending ids (phase B): each run of equal ids inside a chunk is a
//     whole segment and is stored once with plain stores, and the empty
//     output rows between two runs are zeroed by the group that holds the
//     second; a run that crosses a chunk boundary is added (16-byte vector
//     atomics) into the row phase A zeroed; last, the grid zeroes the rows
//     below the first id and above the last. Every output row has one
//     writer, or is zeroed before the barrier and only added to after it.
//   - Ids in any other order: the grid zeroes the output, passes a second
//     barrier and adds every run atomically. Exact, not fast.
//   The barrier counts arrivals in a persistent per-stream workspace
//   (count, generation, order flag) that it leaves as it found it: the
//   last block to arrive resets the count and advances the generation;
//   the order flag holds the generation in which it was raised, so no
//   call clears it for the next.
//
// * The first design (first_kernel, instance "first"), kept off the path
//   for the A/B: lanes span the feature columns of one row, one element a
//   lane, kUnroll rows in flight; each lane flushes its running sum with
//   one atomicAdd when the id changes into an output the wrapper zeroed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The first design

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
    first_kernel(const T* __restrict__ data, const int32_t* __restrict__ ids,
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
int launch_first(const void* data, const void* ids, void* out, long long m,
                 int d, long long num_segments, void* stream) {
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

  first_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(data), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), m, d, num_segments, group_width,
      rows_per_group);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The owner design

constexpr int kOwnThreads = 256;
constexpr int kOwnMinBlocks = 2;  // blocks an SM the registers must allow

// A lane's unit of a row: a 16-byte pack (kPacked) or one element.
template <typename T, bool kPacked> struct Pack;

template <> struct Pack<float, true> {
  static constexpr int V = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(float* a, const Raw& r) {
    a[0] += r.x; a[1] += r.y; a[2] += r.z; a[3] += r.w;
  }
};

template <> struct Pack<__nv_bfloat16, true> {
  static constexpr int V = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  // a bf16 is the high half of a float
  static __device__ __forceinline__ void add2(float* a, uint32_t w) {
    a[0] += __uint_as_float(w << 16);
    a[1] += __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ void add(float* a, const Raw& r) {
    add2(a, r.x); add2(a + 2, r.y); add2(a + 4, r.z); add2(a + 6, r.w);
  }
};

template <typename T> struct Pack<T, false> {
  static constexpr int V = 1;
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return __ldcs(p); }
  static __device__ __forceinline__ void add(float* a, const Raw& r) {
    a[0] += to_float(r);
  }
};

// Write V floats at o: stored, or added with vector atomics.
template <int V>
__device__ __forceinline__ void put(float* o, const float* a, bool atomic) {
  if constexpr (V == 1) {
    if (atomic) atomicAdd(o, a[0]);
    else *o = a[0];
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 v = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2],
                                   a[4 * q + 3]);
      float4* p = reinterpret_cast<float4*>(o) + q;
      if (atomic) atomicAdd(p, v);
      else *p = v;
    }
  }
}

template <int V>
__device__ __forceinline__ void put_zero(float* o) {
  const float z[V] = {};
  put<V>(o, z, false);
}

// The barrier's workspace: arrivals, generation, order flag.
struct Sync {
  unsigned count, gen, flag;
};

// All blocks of a cooperative launch wait here for each other; `gen` is
// the generation this barrier ends. The last block to arrive resets the
// count for the next barrier before it releases the others.
__device__ void grid_barrier(Sync* s, unsigned gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&s->count, 1u) == gridDim.x - 1) {
      atomicExch(&s->count, 0u);
      __threadfence();
      atomicAdd(&s->gen, 1u);
    } else {
      while (*reinterpret_cast<volatile unsigned*>(&s->gen) == gen)
        __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// One group's view of the columns: a row is taken by `group` lanes, P units
// a lane; pass `pass` covers columns [pass * group * P * V, (pass + 1) *
// group * P * V) and the lane's j-th unit starts at column col(j).
template <int V, int P>
struct Cols {
  int base, stride, d;
  __device__ Cols(int lane, int group, int pass, int d_)
      : base((pass * group * P + lane) * V), stride(group * V), d(d_) {}
  __device__ __forceinline__ int col(int j) const { return base + j * stride; }
  __device__ __forceinline__ bool ok(int j) const { return col(j) < d; }
};

// Zero output rows [lo, hi) in the lane's columns of one pass.
template <int V, int P>
__device__ __forceinline__ void zero_rows(float* out, int64_t lo, int64_t hi,
                                          const Cols<V, P>& c) {
  for (int64_t r = lo; r < hi; ++r)
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (c.ok(j)) put_zero<V>(out + r * c.d + c.col(j));
}

// Zero, over the whole grid, output rows [lo, hi) in every column.
template <int V>
__device__ void grid_zero_rows(float* out, int64_t lo, int64_t hi, int d) {
  const int64_t units = (int64_t)(d / V);
  const int64_t total = (hi - lo) * units;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; u < total;
       u += step)
    put_zero<V>(out + (lo + u / units) * d + (u % units) * V);
}

// One round of a group's walk: R rows' ids and the lane's units of them.
template <typename T, bool kPacked, int P, int R>
struct Round {
  int32_t id[R];
  typename Pack<T, kPacked>::Raw raw[R][P];
};

// Load the round of rows [i0, i0 + R) below b (ids four a load where the
// round is whole: i0 is then a multiple of 4 and the ids 16-byte aligned).
template <typename T, bool kPacked, int P, int R>
__device__ __forceinline__ void load_round(
    Round<T, kPacked, P, R>& r, const T* __restrict__ data,
    const int32_t* __restrict__ ids, int64_t i0, int64_t b,
    const Cols<Pack<T, kPacked>::V, P>& c) {
  if (kPacked && i0 + R <= b) {
#pragma unroll
    for (int u = 0; u < R; u += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(ids + i0 + u));
      r.id[u] = v.x; r.id[u + 1] = v.y; r.id[u + 2] = v.z; r.id[u + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < R; ++u) r.id[u] = i0 + u < b ? __ldg(ids + i0 + u) : 0;
  }
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (i0 + u < b && c.ok(j))
        r.raw[u][j] = Pack<T, kPacked>::load(data + (i0 + u) * c.d + c.col(j));
}

// One chunk, rows [a, b), walked by a group, one pass of columns, in
// rounds of U / 2 rows: while the group adds one round, the next is in
// flight (`r0`, `r1`; with `loaded` they already hold the first two).
// kOrdered (the ids ascend): a run of equal ids that neither continues the
// previous chunk's last run nor goes on into the next chunk is a whole
// segment and is stored, the empty rows between two runs are zeroed, and
// a run that crosses a chunk boundary is added into the row phase A
// zeroed. Otherwise every run is added into the zeroed output.
template <typename T, bool kPacked, int P, int U, bool kOrdered>
__device__ void walk(const T* __restrict__ data,
                     const int32_t* __restrict__ ids, float* __restrict__ out,
                     int64_t a, int64_t b, int64_t m, int n,
                     const Cols<Pack<T, kPacked>::V, P>& c,
                     Round<T, kPacked, P, U / 2>& r0,
                     Round<T, kPacked, P, U / 2>& r1, bool loaded) {
  using K = Pack<T, kPacked>;
  constexpr int V = K::V, H = U / 2;
  const int d = c.d;
  const int32_t head = __ldg(ids + a);
  const bool first_open = kOrdered && a > 0 && __ldg(ids + a - 1) == head;
  const bool last_open =
      kOrdered && b < m && __ldg(ids + b) == __ldg(ids + b - 1);
  if (kOrdered && a > 0)
    zero_rows<V, P>(out, max(__ldg(ids + a - 1) + 1, 0), min(head, n), c);
  int32_t cur = head;
  bool first = true;
  float acc[P][V];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int q = 0; q < V; ++q) acc[j][q] = 0.f;

  auto flush = [&](bool add) {
    if (cur >= 0 && cur < n) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (c.ok(j)) put<V>(out + (int64_t)cur * d + c.col(j), acc[j], add);
    }
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int q = 0; q < V; ++q) acc[j][q] = 0.f;
  };
  auto add_round = [&](const Round<T, kPacked, P, H>& r, int64_t i0) {
#pragma unroll
    for (int u = 0; u < H; ++u) {
      if (i0 + u >= b) break;
      if (r.id[u] != cur) {
        flush(!kOrdered || (first && first_open));
        if (kOrdered)
          zero_rows<V, P>(out, max(cur + 1, 0), min(r.id[u], n), c);
        cur = r.id[u];
        first = false;
      }
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (c.ok(j)) K::add(acc[j], r.raw[u][j]);
    }
  };

  if (!loaded) {
    load_round(r0, data, ids, a, b, c);
    load_round(r1, data, ids, a + H, b, c);
  }
  for (int64_t i0 = a;;) {
    add_round(r0, i0);
    if ((i0 += H) >= b) break;
    load_round(r0, data, ids, i0 + H, b, c);
    add_round(r1, i0);
    if ((i0 += H) >= b) break;
    load_round(r1, data, ids, i0 + H, b, c);
  }
  flush(!kOrdered || (first && first_open) || last_open);
}

template <typename T, bool kPacked, int P, int U>
__global__ void __launch_bounds__(kOwnThreads, kOwnMinBlocks)
    owner_kernel(const T* __restrict__ data, const int32_t* __restrict__ ids,
                 float* __restrict__ out, int64_t m, int d, int n, int group,
                 int64_t chunk_rows, int64_t chunks, Sync* sync) {
  constexpr int V = Pack<T, kPacked>::V;
  __shared__ unsigned s_gen;
  if (threadIdx.x == 0)
    s_gen = *reinterpret_cast<volatile unsigned*>(&sync->gen);
  __syncthreads();
  const unsigned gen = s_gen;
  const int lane = threadIdx.x % group;
  const int64_t groups = (int64_t)gridDim.x * (kOwnThreads / group);
  const int64_t g0 = (int64_t)blockIdx.x * (kOwnThreads / group) +
                     threadIdx.x / group;
  const int passes = (d + group * P * V - 1) / (group * P * V);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t threads = (int64_t)gridDim.x * blockDim.x;

  // the first two rounds of the group's first chunk are in flight through
  // phase A and the barrier
  Round<T, kPacked, P, U / 2> r0, r1;
  if (g0 < chunks) {
    const int64_t a = g0 * chunk_rows;
    const int64_t b = a + chunk_rows < m ? a + chunk_rows : m;
    const Cols<V, P> c(lane, group, 0, d);
    load_round(r0, data, ids, a, b, c);
    load_round(r1, data, ids, a + U / 2, b, c);
  }

  // -- phase A: the order check, the rows of the crossing segments -------
  bool bad = false;
  if (kPacked) {  // ids 16-byte aligned: four a load
    const int64_t quads = (m + 3) / 4;
#pragma unroll 4
    for (int64_t q = tid; q < quads; q += threads) {
      const int64_t i = 4 * q;
      if (i + 4 <= m) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(ids) + q);
        const int32_t prev = i > 0 ? __ldg(ids + i - 1) : v.x;
        bad |= prev > v.x || v.x > v.y || v.y > v.z || v.z > v.w;
      } else {
        for (int64_t k = i > 0 ? i : 1; k < m; ++k)
          bad |= __ldg(ids + k - 1) > __ldg(ids + k);
      }
    }
  } else {
#pragma unroll 4
    for (int64_t k = tid + 1; k < m; k += threads)
      bad |= __ldg(ids + k - 1) > __ldg(ids + k);
  }
  for (int64_t ch = g0; ch < chunks; ch += groups) {
    const int64_t a = ch * chunk_rows;
    if (a == 0) continue;
    const int32_t id = __ldg(ids + a);
    if (id == __ldg(ids + a - 1) && id >= 0 && id < n)
      for (int pass = 0; pass < passes; ++pass)
        zero_rows<V, P>(out, id, id + 1, Cols<V, P>(lane, group, pass, d));
  }
  if (bad) *reinterpret_cast<volatile unsigned*>(&sync->flag) = gen + 1;
  grid_barrier(sync, gen);

  // -- phase B ------------------------------------------------------------
  const bool ordered = __ldcg(&sync->flag) != gen + 1;
  if (!ordered) {
    grid_zero_rows<V>(out, 0, n, d);
    grid_barrier(sync, gen + 1);
  }
  for (int64_t ch = g0; ch < chunks; ch += groups) {
    const int64_t a = ch * chunk_rows;
    const int64_t b = a + chunk_rows < m ? a + chunk_rows : m;
    for (int pass = 0; pass < passes; ++pass) {
      const Cols<V, P> c(lane, group, pass, d);
      const bool loaded = ch == g0 && pass == 0;
      if (ordered)
        walk<T, kPacked, P, U, true>(data, ids, out, a, b, m, n, c, r0, r1,
                                     loaded);
      else
        walk<T, kPacked, P, U, false>(data, ids, out, a, b, m, n, c, r0, r1,
                                      loaded);
    }
  }
  // the rows below the first id and above the last, off the walk's path
  if (ordered) {
    const int32_t lo_id = __ldg(ids), hi_id = __ldg(ids + m - 1);
    grid_zero_rows<V>(out, 0, max(min(lo_id, n), 0), d);
    grid_zero_rows<V>(out, min(max(hi_id + 1, 0), n), n, d);
  }
}

// The owner design's kernels, by code (see segsum_launch): (type, packed)
// with P units a lane a row and U rows in flight. Keep in step with
// ops/segsum.py::OWNER_KERNELS.
const void* owner_kernel_of(int code) {
  switch (code) {
    case 2: return (const void*)owner_kernel<float, true, 2, 8>;
    case 3: return (const void*)owner_kernel<__nv_bfloat16, true, 1, 8>;
    case 4: return (const void*)owner_kernel<float, false, 4, 8>;
    case 5: return (const void*)owner_kernel<__nv_bfloat16, false, 4, 8>;
    default: return nullptr;
  }
}

}  // namespace

// Plain C interface for ctypes; nothing is allocated and nothing
// synchronises. Each function returns a cudaError_t (0 = success).
//
// Kernel codes (ops/segsum.py::OWNER_KERNELS): 0 first float32, 1 first
// bf16, 2 packed float32, 3 packed bf16, 4 general float32, 5 general
// bf16.
//
// segsum_launch: for the first design `out` holds num_segments*d zeroed
// floats and the geometry arguments are ignored; for the owner design `out`
// needs no fill, `sync` is the stream's zeroed-once workspace (3 unsigned
// ints, left as found) and the geometry comes from ops/segsum.py::
// owner_plan: lanes a group, rows a chunk, chunks, blocks (all resident).
extern "C" int segsum_launch(const void* data, const void* ids, void* out,
                             long long m, int d, long long num_segments,
                             int code, int group, long long chunk_rows,
                             long long chunks, int blocks, void* sync,
                             void* stream) {
  if (m <= 0 || d <= 0 || num_segments <= 0) return (int)cudaSuccess;
  if (code == 0)
    return launch_first<float>(data, ids, out, m, d, num_segments, stream);
  if (code == 1)
    return launch_first<__nv_bfloat16>(data, ids, out, m, d, num_segments,
                                       stream);
  const void* kernel = owner_kernel_of(code);
  if (kernel == nullptr || num_segments > 0x7fffffffLL || group < 1 ||
      group > 32 || kOwnThreads % group || chunk_rows < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  int n = (int)num_segments;
  int64_t m64 = m, rows = chunk_rows, nch = chunks;
  Sync* s = static_cast<Sync*>(sync);
  void* args[] = {(void*)&data, (void*)&ids, &out, &m64, &d, &n, &group,
                  &rows, &nch, &s};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(kOwnThreads), args, 0,
      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The blocks of instance `code` that fit on one SM at once.
extern "C" int segsum_blocks_per_sm(int code, int* blocks) {
  const void* kernel = owner_kernel_of(code);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kOwnThreads, 0);
}
