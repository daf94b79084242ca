// Fused negative scoring of the four KGE decoders for NVIDIA Hopper
// (sm_90a), forward and backward, in two families. For slot i of the K*E
// negative slots of a training step, with h = z[ns[i]], t = z[nd[i]] and
// r = re[rel[i]], the score is a sum over "units" of
//
//   distmult  h*r*t                                   (unit = feature j)
//   transe    -|h + r - t|   (z already L1-normalised; unit = feature j)
//   complex   r0*(h0*t0 + h1*t1) + r1*(h0*t1 - h1*t0)
//   rotate    -sqrt(max(u0^2 + u1^2, 1e-12)),  u0 = h0*r0 - h1*r1 - t0,
//                                              u1 = h0*r1 + h1*r0 - t1
//
// where for the paired modes a unit is the pair of features (j, j + d/2)
// (x0 = x[j], x1 = x[j + d/2]) and rotate's table row is [cos | sin]. z is
// float32 or bfloat16 (read through __bfloat162float); re, the relation
// table, is float32 (the caller rounds it to z's type first); everything
// else is float32. ns, nd and rel are clipped into range. The backward, for
// an upstream gradient ds, sums each unit's partial derivatives times ds[i]
// into dz[ns[i]] (src side), dz[nd[i]] (dst side) and the relation
// gradient: d(re) (R, d) for distmult, transe and complex, and
// dtheta (R, d/2) for rotate, -du0*rot_im + du1*rot_re with
// du = -ds*u/dist, as the reference's _distance_bwd computes it. transe's
// sign is (x > 0) - (x < 0), so sign(0) = 0.
//
// Replaces the TPU kernels of biomedkg_tpu/ops/pallas/negscore.py:
//  * streamed family: _fwd_call (_fwd_kernel) and _bwd_call (_bwd_kernel,
//    _bwd_kernel_dense) in modes "distmult", "complex", "transe" and
//    "rotate" (_combine_fwd/_dh/_dt, _distance_score, _distance_bwd);
//  * dual-sorted family ("sorted2" sampler): _fwd_call_ds (_fwd_kernel_ds)
//    and _bwd_call_ds (_bwd_kernel_ds) in the same four modes.
// There the z table sits in VMEM, h (and under sorted2 t) is rebuilt by
// windowed one-hot matmuls on the MXU (Mosaic cannot gather), and per-slot
// relation rows come from a one-hot matmul. On Hopper the whole z table
// (about 3k x 256 bf16, 1.5 MB at the training envelope) stays in the
// 50 MB L2, so rows are plain gathers, the relation table lives in shared
// memory, and no (K*E, d) array reaches device memory.
//
// Bound: arithmetic. Per slot and feature the forward does 3 (distmult),
// 4 (transe), 5 (complex) or 6.5 (rotate) float32 operations and the
// backward about 8, 10, 15 and 16.5; rotate also spends one special-function
// operation per unit forward (sqrt) and two backward (sqrt, divide), at
// 1/16 of the float32 rate, which sets its bound. The bytes a call must
// move (z, three int32 index arrays, the table, the scores; ds, dz and
// d(re) backward) are 8-11 MB at the envelope, 2-3 us at 3.35 TB/s, below
// the 5-25 us of operations at 67 TFLOP/s. chip_smoke.py prints each
// kernel's bound and time (PERF.md); these designs are far from the
// bound, since each slot costs dependent L2 round trips (indices, then
// rows), and the first design's backward atomics queue in L2.
//
// The path's forward, for both families, is the redesign below ("run");
// the first design's stay for the A/B:
//
// Streamed family (any order of ns and nd; fast for ascending ns):
//  * forward (first design): one warp per slot, kUnroll slots in flight
//    per warp (half as many for the paired modes, which load twice the
//    rows), each lane reading 16 bytes of z[ns] and z[nd] per feature
//    pack; the relation table in shared memory; a warp-shuffle sum ends a
//    slot;
//  * backward (first design): a warp walks a contiguous run of slots, its
//    lanes on consecutive units so each warp-wide atomic is coalesced; it
//    keeps a running float32 row of the current src id's gradient in
//    shared memory and flushes it with one atomicAdd per feature when the
//    id changes (ns sorted: about 140 slots per id at the envelope); the dst
//    side adds into dz[nd] with float32 atomics that resolve in L2; the
//    relation gradient is summed per block in shared memory and flushed
//    once per block.
//
// Dual-sorted family: under sorted2 each chunk of `chunk` (2048) slots has
// both endpoints in narrow spans (ns sorted: about 15 ids per chunk at the
// envelope; nd in a band of about N/200 + 1 ids). One block per chunk:
//  * it finds the chunk's src and dst id spans (a block min/max);
//  * a span of at most `cap` rows is staged from z into shared memory as
//    float32 rows, read there by every slot of the chunk;
//  * backward (first design), the gradients of a staged side are summed
//    into a float32 band of the same rows in shared memory and flushed to
//    dz once per chunk, one atomicAdd per row and feature: about 1.6 M
//    global atomics per step at the envelope where the streamed backward
//    makes about 105 M for the dst side alone. Each warp walks a
//    contiguous run of the chunk with a running src row (one band atomic
//    per id change, as the streamed backward); the dst side and the
//    relation gradient take shared atomics;
//  * a side whose span exceeds `cap` (a band that wraps the id range,
//    about one chunk per step, or nd in any order) reads z and adds into
//    dz directly with global atomics, in the same kernel: every input stays
//    exact, only slower.
// The cap is kSpanCap = 32 rows per side, lowered at launch when the
// card's opt-in shared memory per block cannot hold 2 (forward) or 4
// (backward) cap x d float32 buffers beside the tables and the running
// rows.
//
// Forward redesign ("run"), both families: a warp walks a contiguous run
// of slots (the grid's resident warps each take an equal run). Lane p
// holds pack p of the
// current src id's row in float32 registers (8 features, or 4 of each
// half for the paired modes, at d = 256: 16 bytes of a bf16 row, every
// lane busy in every mode), reloaded only where ns changes; per slot it
// reads its t pack and the relation row's pack from a float32 table in
// shared memory and adds its units in order; eight slots' partials are
// summed together by a transpose reduction (9 shuffles). Slot ids come 32
// at a time, a batch ahead, and a group of 8 slots with one src id runs
// with no branch between its slots. t is gathered from z in L2, 8 bf16 (4
// float32) rows in flight a warp: half the first design's gathers. Any
// order of ns and nd stays exact, so the dual-sorted family runs it too: a
// design that staged each block's spans of ids in shared memory was slower
// than this one on the same sorted2 inputs in every mode and both types
// (PERF.md, PR 12) and was dropped.
//
// The backwards above are the first design, kept for the A/B. The path's
// backward, for both families, is the owner design: every dz row is written
// exactly once, without atomics, by the group of warps that owns its node
// id.
//  * bucket_kernel (one cooperative launch) sorts the slot ids by clipped
//    ns and by clipped nd, stably (a counting sort: per-warp counts of a
//    contiguous tile of slots in shared memory, their prefixes over the
//    warps of a block, over the blocks and over the ids, then a second walk
//    of each tile that places each slot at its bucket's next position);
//    offsets (n + 1 per side) and the slot ids in bucket order (m per side)
//    go to device memory. Two grid barriers; any order of ns and nd.
//  * owner_kernel: a group of kGroupWarps warps owns an id v; each warp
//    walks its share of v's src bucket (the slots whose h is v) and of its
//    dst bucket (the slots whose t is v). Lane l holds pack l (V features,
//    16 bytes where the widths allow) of v's own row in registers, gathers
//    the other endpoint's pack of each slot from L2 with kOwnSlots (paired
//    modes half as many) slots in flight, each batch's slot metadata
//    loaded a batch ahead, and sums the unit gradients in float32
//    registers. The group's rows meet in shared memory and its first warp
//    writes dz[v] once, in z's type. A width of more than 32 packs takes
//    more passes over the same buckets. The relation gradient is summed in
//    the src walk only (each slot counts once), into one partial (r, dr)
//    table a warp in shared memory that only its lanes touch, each its own
//    columns (lane major, 16-byte accesses without bank conflicts); the
//    block adds the sum of its warps' partials into dre with one 16-byte
//    vector atomic per 4 floats. Each slot's unit terms are computed twice,
//    once by each owner. A group, and not one warp, owns an id because
//    under "sorted2" an id's dst bucket is the sum of the chunk bands that
//    cover it, up to six times the mean, and the longest walk sets the time.
// Bound: the same function, so the same bound; the design gathers 2 rows a
// slot from L2 (z is 1.5 MB in bf16 at the envelope) where the first
// design makes 105 M float32 atomics on the dst side alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace {

enum Mode : int { kDistMult = 0, kComplex = 1, kTransE = 2, kRotatE = 3 };

template <int M>
constexpr bool kPaired = M == kComplex || M == kRotatE;

constexpr int kThreads = 256;               // threads per block (streamed)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                  // slots in flight per warp
constexpr int kBlocksPerSm = 4;             // grid size target
constexpr int kDefaultSmem = 48 * 1024;     // dynamic shared memory without
                                            // the opt-in attribute
constexpr int kDsThreads = 512;             // threads per block (dual-sorted)
constexpr int kDsWarps = kDsThreads / 32;
constexpr int kSpanCap = 32;                // rows per side staged per chunk
constexpr int kBucketThreads = 256;         // threads per block (buckets)
constexpr int kBucketWarps = kBucketThreads / 32;   // 8: two int4 a key
static_assert(kBucketWarps == 8, "a key's warp counters are two int4");
constexpr int kOwnWarps = 8;                // warps per block (owner), at most
constexpr int kOwnSlots = 4;                // slots in flight per owner warp
constexpr int kOwnBlocksPerSm = 2;          // register budget: 128 a thread
constexpr int kGroupWarps = 4;              // warps that share a node id
constexpr int kKeyChunks = 16;              // 32-slot chunks of keys a bucket
                                            // warp holds in registers
constexpr int kMaxBlockRun = 32;            // bucket blocks a warp prefixes
constexpr int kScanPerThread = 8;           // keys a thread scans at once
constexpr int kScanChunk = kScanPerThread * kBucketThreads;
constexpr int kFwdWarps = 8;                // warps per block (forward
                                            // redesign, both designs)
constexpr int kFwdSlots = 8;                // slots summed together a warp
constexpr int kFwdRows = 8;                 // bf16 t rows in flight a warp
                                            // (float32 half as many)
constexpr int kFwdBlocksPerSm = 2;          // register budget: 128 a thread

// slots in flight per warp: the paired modes hold twice the rows
template <int M>
constexpr int kSlots = kPaired<M> ? kUnroll / 2 : kUnroll;

// width of the relation gradient's rows: dtheta has d/2 for rotate
template <int M>
__host__ __device__ __forceinline__ int grad_width(int d) {
  return M == kRotatE ? d / 2 : d;
}

// V consecutive features of a row as floats: 16-byte loads when V > 1.
template <typename T, int V>
struct Pack;

template <>
struct Pack<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Pack<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* out) {
    out[0] = __ldg(p);
  }
};

template <>
struct Pack<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
};

template <>
struct Pack<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    out[0] = __bfloat162float(p[0]);
  }
};

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

// V consecutive floats of the shared relation table: 16-byte reads when
// V > 1, so a lane's V features cost V/4 reads and not V bank-conflicted
// ones (lanes sit V floats apart).
template <int V>
__device__ __forceinline__ void load_shared(const float* p, float* out) {
  if constexpr (V == 1) {
    out[0] = p[0];
  } else {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 v = reinterpret_cast<const float4*>(p)[k];
      out[4 * k] = v.x;
      out[4 * k + 1] = v.y;
      out[4 * k + 2] = v.z;
      out[4 * k + 3] = v.w;
    }
  }
}

__device__ __forceinline__ int clip(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One unit's score term (the x1 values are unused by unpaired modes).
// kFast (the forward redesign): rotate's distance as s * rsqrt(s) (within
// 3 ulp) where the first design takes an IEEE sqrt.
template <int M, bool kFast = false>
__device__ __forceinline__ float unit_score(float h0, float h1, float t0,
                                            float t1, float r0, float r1) {
  if constexpr (M == kDistMult) {
    return h0 * r0 * t0;
  } else if constexpr (M == kTransE) {
    return -fabsf(h0 + r0 - t0);
  } else if constexpr (M == kComplex) {
    return r0 * (h0 * t0 + h1 * t1) + r1 * (h0 * t1 - h1 * t0);
  } else {
    const float u0 = h0 * r0 - h1 * r1 - t0;
    const float u1 = h0 * r1 + h1 * r0 - t1;
    const float s = fmaxf(u0 * u0 + u1 * u1, 1e-12f);
    if constexpr (kFast) {
      return -(s * rsqrtf(s));
    } else {
      return -sqrtf(s);
    }
  }
}

// One unit's gradient times g: d/dh, d/dt and d/d(relation) for both
// features of the unit (rotate: dr0 is dtheta, dr1 unused).
struct UnitGrad {
  float dh0, dh1, dt0, dt1, dr0, dr1;
};

// kFast (the owner design): rotate's 1/dist from one rsqrt (within 2 ulp)
// where the first design takes a sqrt and two divides.
template <int M, bool kFast = false>
__device__ __forceinline__ UnitGrad unit_grad(float g, float h0, float h1,
                                              float t0, float t1, float r0,
                                              float r1) {
  UnitGrad o{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if constexpr (M == kDistMult) {
    const float gr = g * r0;
    o.dh0 = gr * t0;
    o.dt0 = gr * h0;
    o.dr0 = g * h0 * t0;
  } else if constexpr (M == kTransE) {
    const float x = h0 + r0 - t0;
    const float gs = g * (float)((x > 0.f) - (x < 0.f));
    o.dh0 = -gs;
    o.dt0 = gs;
    o.dr0 = -gs;
  } else if constexpr (M == kComplex) {
    o.dh0 = g * (r0 * t0 + r1 * t1);
    o.dh1 = g * (r0 * t1 - r1 * t0);
    o.dt0 = g * (r0 * h0 - r1 * h1);
    o.dt1 = g * (r0 * h1 + r1 * h0);
    o.dr0 = g * (h0 * t0 + h1 * t1);
    o.dr1 = g * (h0 * t1 - h1 * t0);
  } else {
    const float rot0 = h0 * r0 - h1 * r1;
    const float rot1 = h0 * r1 + h1 * r0;
    const float u0 = rot0 - t0;
    const float u1 = rot1 - t1;
    float du0, du1;
    if constexpr (kFast) {
      const float scale = -g * rsqrtf(fmaxf(u0 * u0 + u1 * u1, 1e-12f));
      du0 = scale * u0;
      du1 = scale * u1;
    } else {
      const float dist = sqrtf(fmaxf(u0 * u0 + u1 * u1, 1e-12f));
      du0 = -g * u0 / dist;
      du1 = -g * u1 / dist;
    }
    o.dh0 = du0 * r0 + du1 * r1;
    o.dh1 = -du0 * r1 + du1 * r0;
    o.dt0 = -du0;
    o.dt1 = -du1;
    o.dr0 = -du0 * rot1 + du1 * rot0;
  }
  return o;
}

// ---------------------------------------------------------------------------
// Streamed family

// Shared memory: the relation table re (r*d floats).
template <int M, typename T, int V>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ z, const int32_t* __restrict__ ns,
               const int32_t* __restrict__ nd,
               const int32_t* __restrict__ rel, const float* __restrict__ re,
               float* __restrict__ out, int64_t m, int n, int d, int r) {
  constexpr int U = kSlots<M>;
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < r * d; i += kThreads) smem[i] = re[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t num_warps = ((int64_t)gridDim.x * kThreads) >> 5;
  const int off = kPaired<M> ? d / 2 : 0;   // second feature of a unit
  const int packs = (kPaired<M> ? d / 2 : d) / V;
  for (int64_t s0 = warp * U; s0 < m; s0 += num_warps * U) {
    int hs[U], ts[U], rs[U];
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t s = s0 + u;
      const bool ok = s < m;
      hs[u] = ok ? clip(ns[s], n - 1) : 0;
      ts[u] = ok ? clip(nd[s], n - 1) : 0;
      rs[u] = ok ? clip(rel[s], r - 1) : 0;
      acc[u] = 0.f;
    }
    for (int p = lane; p < packs; p += 32) {
      const int j = p * V;
      float h0[U][V], t0[U][V], h1[U][V], t1[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        Pack<T, V>::load(z + (int64_t)hs[u] * d + j, h0[u]);
        Pack<T, V>::load(z + (int64_t)ts[u] * d + j, t0[u]);
        if constexpr (kPaired<M>) {
          Pack<T, V>::load(z + (int64_t)hs[u] * d + off + j, h1[u]);
          Pack<T, V>::load(z + (int64_t)ts[u] * d + off + j, t1[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float r0[V], r1[V];
        load_shared<V>(smem + rs[u] * d + j, r0);
        if constexpr (kPaired<M>)
          load_shared<V>(smem + rs[u] * d + off + j, r1);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if constexpr (kPaired<M>) {
            acc[u] += unit_score<M>(h0[u][v], h1[u][v], t0[u][v], t1[u][v],
                                    r0[v], r1[v]);
          } else {
            acc[u] += unit_score<M>(h0[u][v], 0.f, t0[u][v], 0.f, r0[v], 0.f);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float a = warp_sum(acc[u]);
      if (lane == 0 && s0 + u < m) out[s0 + u] = a;
    }
  }
}

// Shared memory: re (r*d), the block's relation-gradient sums (r*dr), and
// one running src-side dz row per warp (kWarps*d). Lane l owns units l,
// l+32, ... in every slot: the running row needs no synchronisation inside
// a warp, and each warp-wide atomic covers 32 consecutive floats.
template <int M, typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const T* __restrict__ z, const int32_t* __restrict__ ns,
               const int32_t* __restrict__ nd,
               const int32_t* __restrict__ rel, const float* __restrict__ re,
               const float* __restrict__ ds, float* __restrict__ dz,
               float* __restrict__ dre, int64_t m, int n, int d, int r,
               int64_t slots_per_warp) {
  constexpr int U = kSlots<M>;
  const int dr = grad_width<M>(d);
  extern __shared__ __align__(16) float smem[];
  float* sre = smem;
  float* sdre = smem + r * d;
  float* row = sdre + r * dr + (threadIdx.x >> 5) * d;
  for (int i = threadIdx.x; i < r * d; i += kThreads) sre[i] = re[i];
  for (int i = threadIdx.x; i < r * dr; i += kThreads) sdre[i] = 0.f;
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < d; i += 32) row[i] = 0.f;
  __syncthreads();

  const int off = kPaired<M> ? d / 2 : 0;
  const int units = kPaired<M> ? d / 2 : d;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t begin = warp * slots_per_warp;
  const int64_t end = begin + slots_per_warp < m ? begin + slots_per_warp : m;
  int cur = -1;  // the src id whose running row is held in `row`
  for (int64_t s0 = begin; s0 < end; s0 += U) {
    int hs[U], ts[U], rs[U], flush[U];
    float g[U];
    bool ok[U], change[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t s = s0 + u;
      ok[u] = s < end;
      hs[u] = ok[u] ? clip(ns[s], n - 1) : 0;
      ts[u] = ok[u] ? clip(nd[s], n - 1) : 0;
      rs[u] = ok[u] ? clip(rel[s], r - 1) : 0;
      g[u] = ok[u] ? ds[s] : 0.f;
    }
    // the src id sequence is the same for every unit: decide the flushes
    // once per group of slots
#pragma unroll
    for (int u = 0; u < U; ++u) {
      change[u] = ok[u] && hs[u] != cur;
      flush[u] = cur;
      if (change[u]) cur = hs[u];
    }
    for (int c = lane; c < units; c += 32) {
      float h0[U], t0[U], h1[U], t1[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        h0[u] = load1(z + (int64_t)hs[u] * d + c);
        t0[u] = load1(z + (int64_t)ts[u] * d + c);
        h1[u] = kPaired<M> ? load1(z + (int64_t)hs[u] * d + off + c) : 0.f;
        t1[u] = kPaired<M> ? load1(z + (int64_t)ts[u] * d + off + c) : 0.f;
      }
      float acc0 = row[c];
      float acc1 = kPaired<M> ? row[off + c] : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        if (change[u]) {
          if (flush[u] >= 0) {
            atomicAdd(dz + (int64_t)flush[u] * d + c, acc0);
            if constexpr (kPaired<M>)
              atomicAdd(dz + (int64_t)flush[u] * d + off + c, acc1);
          }
          acc0 = 0.f;
          acc1 = 0.f;
        }
        const float r0 = sre[rs[u] * d + c];
        const float r1 = kPaired<M> ? sre[rs[u] * d + off + c] : 0.f;
        const UnitGrad o = unit_grad<M>(g[u], h0[u], h1[u], t0[u], t1[u],
                                        r0, r1);
        acc0 += o.dh0;
        atomicAdd(dz + (int64_t)ts[u] * d + c, o.dt0);
        atomicAdd(sdre + rs[u] * dr + c, o.dr0);
        if constexpr (kPaired<M>) {
          acc1 += o.dh1;
          atomicAdd(dz + (int64_t)ts[u] * d + off + c, o.dt1);
        }
        if constexpr (M == kComplex)
          atomicAdd(sdre + rs[u] * dr + off + c, o.dr1);
      }
      row[c] = acc0;
      if constexpr (kPaired<M>) row[off + c] = acc1;
    }
  }
  // each lane flushes the units it owns: the running row is never read
  // across lanes (lanes may be diverged here, with no __syncwarp)
  if (cur >= 0) {
    for (int c = lane; c < units; c += 32) {
      atomicAdd(dz + (int64_t)cur * d + c, row[c]);
      if constexpr (kPaired<M>)
        atomicAdd(dz + (int64_t)cur * d + off + c, row[off + c]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < r * dr; i += kThreads) {
    const float v = sdre[i];
    if (v != 0.f) atomicAdd(dre + i, v);
  }
}

// ---------------------------------------------------------------------------
// Dual-sorted family: one block per chunk of `chunk` slots

// The chunk's clipped src and dst id spans: span[0..3] = lo_s, hi_s, lo_d,
// hi_d (shared). Ends with the block synchronised.
__device__ void chunk_span(const int32_t* __restrict__ ns,
                           const int32_t* __restrict__ nd, int64_t c0,
                           int64_t c1, int n, int* span) {
  __shared__ int part[4][kDsWarps];
  int v[4] = {n, -1, n, -1};    // lo_s, hi_s, lo_d, hi_d
  for (int64_t s = c0 + threadIdx.x; s < c1; s += kDsThreads) {
    const int a = clip(ns[s], n - 1);
    const int b = clip(nd[s], n - 1);
    v[0] = min(v[0], a);
    v[1] = max(v[1], a);
    v[2] = min(v[2], b);
    v[3] = max(v[3], b);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v[0] = min(v[0], __shfl_xor_sync(0xffffffffu, v[0], o));
    v[1] = max(v[1], __shfl_xor_sync(0xffffffffu, v[1], o));
    v[2] = min(v[2], __shfl_xor_sync(0xffffffffu, v[2], o));
    v[3] = max(v[3], __shfl_xor_sync(0xffffffffu, v[3], o));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) part[k][warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    const int k = threadIdx.x;
    int x = part[k][0];
    for (int w = 1; w < kDsWarps; ++w)
      x = (k & 1) ? max(x, part[k][w]) : min(x, part[k][w]);
    span[k] = x;
  }
  __syncthreads();
}

// rows lo..lo+rows-1 of z into `dst` as float32 (block-wide)
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ z, int lo,
                                           int rows, int d, float* dst) {
  const T* src = z + (int64_t)lo * d;
  for (int i = threadIdx.x; i < rows * d; i += kDsThreads)
    dst[i] = load1(src + i);
}

// feature c of row `id`: from the staged rows when `sh` is set, else from z
template <typename T>
__device__ __forceinline__ float feature(const float* sh, int lo,
                                         const T* __restrict__ z, int id,
                                         int d, int c) {
  return sh ? sh[(id - lo) * d + c] : load1(z + (int64_t)id * d + c);
}

// Shared memory: re (r*d), the staged src rows (cap*d) and dst rows
// (cap*d).
template <int M, typename T>
__global__ void __launch_bounds__(kDsThreads)
    ds_fwd_kernel(const T* __restrict__ z, const int32_t* __restrict__ ns,
                  const int32_t* __restrict__ nd,
                  const int32_t* __restrict__ rel,
                  const float* __restrict__ re, float* __restrict__ out,
                  int64_t m, int n, int d, int r, int chunk, int cap) {
  constexpr int U = kSlots<M>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int span[4];
  float* sre = smem;
  float* rows_s = sre + r * d;
  float* rows_d = rows_s + cap * d;
  const int64_t c0 = (int64_t)blockIdx.x * chunk;
  const int64_t c1 = c0 + chunk < m ? c0 + chunk : m;
  for (int i = threadIdx.x; i < r * d; i += kDsThreads) sre[i] = re[i];
  chunk_span(ns, nd, c0, c1, n, span);
  const int lo_s = span[0], lo_d = span[2];
  const bool staged_s = span[1] - lo_s < cap;
  const bool staged_d = span[3] - lo_d < cap;
  if (staged_s) stage_rows(z, lo_s, span[1] - lo_s + 1, d, rows_s);
  if (staged_d) stage_rows(z, lo_d, span[3] - lo_d + 1, d, rows_d);
  __syncthreads();
  const float* hsh = staged_s ? rows_s : nullptr;
  const float* tsh = staged_d ? rows_d : nullptr;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int off = kPaired<M> ? d / 2 : 0;
  const int units = kPaired<M> ? d / 2 : d;
  for (int64_t s0 = c0 + warp * U; s0 < c1; s0 += kDsWarps * U) {
    int hs[U], ts[U], rs[U];
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t s = s0 + u;
      const bool ok = s < c1;
      hs[u] = ok ? clip(ns[s], n - 1) : lo_s;
      ts[u] = ok ? clip(nd[s], n - 1) : lo_d;
      rs[u] = ok ? clip(rel[s], r - 1) : 0;
      acc[u] = 0.f;
    }
    for (int c = lane; c < units; c += 32) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float h0 = feature(hsh, lo_s, z, hs[u], d, c);
        const float t0 = feature(tsh, lo_d, z, ts[u], d, c);
        const float r0 = sre[rs[u] * d + c];
        if constexpr (kPaired<M>) {
          const float h1 = feature(hsh, lo_s, z, hs[u], d, off + c);
          const float t1 = feature(tsh, lo_d, z, ts[u], d, off + c);
          acc[u] += unit_score<M>(h0, h1, t0, t1, r0,
                                  sre[rs[u] * d + off + c]);
        } else {
          acc[u] += unit_score<M>(h0, 0.f, t0, 0.f, r0, 0.f);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float a = warp_sum(acc[u]);
      if (lane == 0 && s0 + u < c1) out[s0 + u] = a;
    }
  }
}

// Shared memory: re (r*d), the block's relation-gradient sums (r*dr), the
// staged src and dst rows (cap*d each), the src and dst dz bands (cap*d
// each) and one running src-side row per warp (kDsWarps*d). Each warp
// walks a contiguous run of the chunk's slots, so, ns being sorted, it
// keeps the current src id's gradient in its running row (lane l owns units
// l, l+32, ...) and adds it into the src band once per id change, as the
// streamed backward does into dz; the dst side and the relation gradient
// take shared atomics.
template <int M, typename T>
__global__ void __launch_bounds__(kDsThreads)
    ds_bwd_kernel(const T* __restrict__ z, const int32_t* __restrict__ ns,
                  const int32_t* __restrict__ nd,
                  const int32_t* __restrict__ rel,
                  const float* __restrict__ re, const float* __restrict__ ds,
                  float* __restrict__ dz, float* __restrict__ dre, int64_t m,
                  int n, int d, int r, int chunk, int cap) {
  constexpr int U = kSlots<M>;
  const int dr = grad_width<M>(d);
  extern __shared__ __align__(16) float smem[];
  __shared__ int span[4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* sre = smem;
  float* sdre = sre + r * d;
  float* row = sdre + r * dr + warp * d;
  float* rows_s = sdre + r * dr + kDsWarps * d;
  float* rows_d = rows_s + cap * d;
  float* band_s = rows_d + cap * d;
  float* band_d = band_s + cap * d;
  const int64_t c0 = (int64_t)blockIdx.x * chunk;
  const int64_t c1 = c0 + chunk < m ? c0 + chunk : m;
  for (int i = threadIdx.x; i < r * d; i += kDsThreads) sre[i] = re[i];
  for (int i = threadIdx.x; i < r * dr; i += kDsThreads) sdre[i] = 0.f;
  for (int i = lane; i < d; i += 32) row[i] = 0.f;
  chunk_span(ns, nd, c0, c1, n, span);
  const int lo_s = span[0], lo_d = span[2];
  const int rows_src = span[1] - lo_s + 1, rows_dst = span[3] - lo_d + 1;
  const bool staged_s = rows_src <= cap;
  const bool staged_d = rows_dst <= cap;
  if (staged_s) {
    stage_rows(z, lo_s, rows_src, d, rows_s);
    for (int i = threadIdx.x; i < rows_src * d; i += kDsThreads)
      band_s[i] = 0.f;
  }
  if (staged_d) {
    stage_rows(z, lo_d, rows_dst, d, rows_d);
    for (int i = threadIdx.x; i < rows_dst * d; i += kDsThreads)
      band_d[i] = 0.f;
  }
  __syncthreads();
  const float* hsh = staged_s ? rows_s : nullptr;
  const float* tsh = staged_d ? rows_d : nullptr;
  // where a side's gradient goes: its shared band, or dz itself
  float* gs = staged_s ? band_s - (int64_t)lo_s * d : dz;
  float* gd = staged_d ? band_d - (int64_t)lo_d * d : dz;

  const int off = kPaired<M> ? d / 2 : 0;
  const int units = kPaired<M> ? d / 2 : d;
  const int64_t per_warp = (c1 - c0 + kDsWarps - 1) / kDsWarps;
  const int64_t begin = c0 + warp * per_warp;
  const int64_t end = begin + per_warp < c1 ? begin + per_warp : c1;
  int cur = -1;  // the src id whose running row is held in `row`
  for (int64_t s0 = begin; s0 < end; s0 += U) {
    int hs[U], ts[U], rs[U], flush[U];
    float g[U];
    bool ok[U], change[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t s = s0 + u;
      ok[u] = s < end;
      hs[u] = ok[u] ? clip(ns[s], n - 1) : lo_s;
      ts[u] = ok[u] ? clip(nd[s], n - 1) : lo_d;
      rs[u] = ok[u] ? clip(rel[s], r - 1) : 0;
      g[u] = ok[u] ? ds[s] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      change[u] = ok[u] && hs[u] != cur;
      flush[u] = cur;
      if (change[u]) cur = hs[u];
    }
    for (int c = lane; c < units; c += 32) {
      float acc0 = row[c];
      float acc1 = kPaired<M> ? row[off + c] : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!ok[u]) continue;
        if (change[u]) {
          if (flush[u] >= 0) {
            atomicAdd(gs + (int64_t)flush[u] * d + c, acc0);
            if constexpr (kPaired<M>)
              atomicAdd(gs + (int64_t)flush[u] * d + off + c, acc1);
          }
          acc0 = 0.f;
          acc1 = 0.f;
        }
        const float h0 = feature(hsh, lo_s, z, hs[u], d, c);
        const float t0 = feature(tsh, lo_d, z, ts[u], d, c);
        const float r0 = sre[rs[u] * d + c];
        float h1 = 0.f, t1 = 0.f, r1 = 0.f;
        if constexpr (kPaired<M>) {
          h1 = feature(hsh, lo_s, z, hs[u], d, off + c);
          t1 = feature(tsh, lo_d, z, ts[u], d, off + c);
          r1 = sre[rs[u] * d + off + c];
        }
        const UnitGrad o = unit_grad<M>(g[u], h0, h1, t0, t1, r0, r1);
        acc0 += o.dh0;
        atomicAdd(gd + (int64_t)ts[u] * d + c, o.dt0);
        atomicAdd(sdre + rs[u] * dr + c, o.dr0);
        if constexpr (kPaired<M>) {
          acc1 += o.dh1;
          atomicAdd(gd + (int64_t)ts[u] * d + off + c, o.dt1);
        }
        if constexpr (M == kComplex)
          atomicAdd(sdre + rs[u] * dr + off + c, o.dr1);
      }
      row[c] = acc0;
      if constexpr (kPaired<M>) row[off + c] = acc1;
    }
  }
  // each lane flushes the units it owns (the running row is per lane)
  if (cur >= 0) {
    for (int c = lane; c < units; c += 32) {
      atomicAdd(gs + (int64_t)cur * d + c, row[c]);
      if constexpr (kPaired<M>)
        atomicAdd(gs + (int64_t)cur * d + off + c, row[off + c]);
    }
  }
  __syncthreads();
  if (staged_s) {
    float* dst = dz + (int64_t)lo_s * d;
    for (int i = threadIdx.x; i < rows_src * d; i += kDsThreads) {
      const float v = band_s[i];
      if (v != 0.f) atomicAdd(dst + i, v);
    }
  }
  if (staged_d) {
    float* dst = dz + (int64_t)lo_d * d;
    for (int i = threadIdx.x; i < rows_dst * d; i += kDsThreads) {
      const float v = band_d[i];
      if (v != 0.f) atomicAdd(dst + i, v);
    }
  }
  for (int i = threadIdx.x; i < r * dr; i += kDsThreads) {
    const float v = sdre[i];
    if (v != 0.f) atomicAdd(dre + i, v);
  }
}

// ---------------------------------------------------------------------------
// Owner design: bucket build

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned mask;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(mask));
  return mask;
}

// All blocks of a cooperative launch wait here for each other. `bar` is
// zeroed before the launch; `round` counts the barriers this block passed.
__device__ void grid_barrier(unsigned* bar, unsigned& round) {
  __syncthreads();
  ++round;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned target = round * gridDim.x;
    while (*reinterpret_cast<volatile unsigned*>(bar) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// exclusive prefix sum of one int a thread over the block (`sh` holds
// kBucketThreads ints), and the block's total; ends with the block
// synchronised
__device__ int block_exclusive_sum(int v, int* sh, int* total) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int o = 1; o < kBucketThreads; o <<= 1) {
    const int x = threadIdx.x >= o ? sh[threadIdx.x - o] : 0;
    __syncthreads();
    sh[threadIdx.x] += x;
    __syncthreads();
  }
  const int inclusive = sh[threadIdx.x];
  *total = sh[kBucketThreads - 1];
  __syncthreads();
  return inclusive - v;
}

// The warp's keys on one side for its slots s + 32c + lane, c <
// kKeyChunks, all loaded before any is used: the clipped id relative to the
// key range [k0, k0 + kn), or -1 outside it or at or past `end`.
__device__ __forceinline__ void load_keys(const int32_t* __restrict__ ids,
                                          int64_t s, int64_t end, int n,
                                          int k0, int kn,
                                          int (&key)[kKeyChunks]) {
  const int lane = threadIdx.x & 31;
  bool ok[kKeyChunks];
#pragma unroll
  for (int c = 0; c < kKeyChunks; ++c) {
    const int64_t i = s + c * 32 + lane;
    ok[c] = i < end;
    key[c] = ok[c] ? __ldg(ids + i) : 0;
  }
#pragma unroll
  for (int c = 0; c < kKeyChunks; ++c) {
    const int k = clip(key[c], n - 1) - k0;
    key[c] = ok[c] && k >= 0 && k < kn ? k : -1;
  }
}

// Counts of the keys in [k0, k0 + kn) over each warp's tile [t0, t1),
// turned into their exclusive prefix over the block's warps in
// cnt[side][key][warp]; with `blk`, the block's totals go to
// blk[side][block][k0 + key]. A key's kBucketWarps counters are adjacent,
// so its prefix takes two 16-byte reads and writes.
__device__ void count_range(const int32_t* __restrict__ ns,
                            const int32_t* __restrict__ nd, int64_t t0,
                            int64_t t1, int n, int k0, int kn, int cap,
                            int* cnt, int32_t* __restrict__ blk) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 2 * cap * kBucketWarps / 4;
       i += kBucketThreads)
    reinterpret_cast<int4*>(cnt)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  int* col0 = cnt + warp;
  int* col1 = cnt + cap * kBucketWarps + warp;
  for (int64_t s = t0; s < t1; s += 32 * kKeyChunks) {
    int key0[kKeyChunks], key1[kKeyChunks];
    load_keys(ns, s, t1, n, k0, kn, key0);
    load_keys(nd, s, t1, n, k0, kn, key1);
#pragma unroll
    for (int c = 0; c < kKeyChunks; ++c) {   // both sides at once
      const unsigned peers0 = __match_any_sync(0xffffffffu, key0[c]);
      const unsigned peers1 = __match_any_sync(0xffffffffu, key1[c]);
      if (key0[c] >= 0 && lane == __ffs(peers0) - 1)
        col0[key0[c] * kBucketWarps] += __popc(peers0);
      if (key1[c] >= 0 && lane == __ffs(peers1) - 1)
        col1[key1[c] * kBucketWarps] += __popc(peers1);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * kn; i += kBucketThreads) {
    const int side = i / kn, key = i % kn;
    int4* c = reinterpret_cast<int4*>(cnt + (side * cap + key) * kBucketWarps);
    const int4 lo = c[0], hi = c[1];
    int run = 0;
    c[0] = make_int4(run, run + lo.x, run + lo.x + lo.y,
                     run + lo.x + lo.y + lo.z);
    run += lo.x + lo.y + lo.z + lo.w;
    c[1] = make_int4(run, run + hi.x, run + hi.x + hi.y,
                     run + hi.x + hi.y + hi.z);
    run += hi.x + hi.y + hi.z + hi.w;
    if (blk)
      blk[((int64_t)side * gridDim.x + blockIdx.x) * n + k0 + key] = run;
  }
  __syncthreads();
}

// A stable counting sort of the slots by clipped ns (side 0) and clipped nd
// (side 1), as torch.argsort(keys, stable=True): off[side] (n + 1) holds
// each id's first position, ord[side] (m) the slot ids in bucket order.
// Warp w of block g owns the w-th tile of the g-th run of slots, so tiles
// in (g, w) order cover the slots in order, and a slot's position is its
// id's offset, plus its id's count in earlier blocks, in earlier warps of
// its block, and in earlier slots of its tile. Keys are taken in ranges of
// `cap` (the shared counters' room); `blk` (2, G, n) and `tot` (2, n) are
// scratch; `bar` is zeroed before the launch; G <= kBucketWarps *
// kMaxBlockRun. Every phase issues its loads together before it uses them:
// a walk over a tile holds kKeyChunks chunks of keys in registers.
// Shared memory: cnt[2][cap][kBucketWarps] ints.
__global__ void __launch_bounds__(kBucketThreads)
    bucket_kernel(const int32_t* __restrict__ ns,
                  const int32_t* __restrict__ nd, int64_t m, int n, int cap,
                  int32_t* __restrict__ blk, int32_t* __restrict__ tot,
                  int32_t* __restrict__ off, int32_t* __restrict__ ord,
                  unsigned* bar) {
  extern __shared__ __align__(16) int cnt[];
  __shared__ int scan[kBucketThreads];
  __shared__ __align__(16) int stage[kScanChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int blocks = gridDim.x, g = blockIdx.x;
  const int64_t tiles = (int64_t)blocks * kBucketWarps;
  const int64_t per = (m + tiles - 1) / tiles;
  const int64_t first = ((int64_t)g * kBucketWarps + warp) * per;
  const int64_t t0 = first < m ? first : m;
  const int64_t t1 = t0 + per < m ? t0 + per : m;
  const int ranges = (n + cap - 1) / cap;
  unsigned round = 0;

  for (int k0 = 0; k0 < n; k0 += cap)
    count_range(ns, nd, t0, t1, n, k0, min(cap, n - k0), cap, cnt, blk);
  grid_barrier(bar, round);

  // each key's exclusive prefix over the blocks (in place), and its total:
  // a block takes 32 keys of a side, warp w the blocks [w*pb, (w+1)*pb).
  // What other blocks wrote before a barrier is read past L1 (__ldcg).
  const int groups = (n + 31) / 32;
  const int pb = (blocks + kBucketWarps - 1) / kBucketWarps;
  for (int item = g; item < 2 * groups; item += blocks) {
    const int side = item / groups, key = (item % groups) * 32 + lane;
    const int ga = min(blocks, warp * pb), gb = min(blocks, ga + pb);
    int32_t* col = blk + (int64_t)side * blocks * n + key;
    int vals[kMaxBlockRun];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kMaxBlockRun; ++i) {
      vals[i] = key < n && ga + i < gb ? __ldcg(col + (int64_t)(ga + i) * n)
                                       : 0;
      sum += vals[i];
    }
    scan[threadIdx.x] = sum;
    __syncthreads();
    int run = 0;
    for (int w = 0; w < warp; ++w) run += scan[w * 32 + lane];
    if (key < n) {
#pragma unroll
      for (int i = 0; i < kMaxBlockRun; ++i) {
        if (ga + i < gb) col[(int64_t)(ga + i) * n] = run;
        run += vals[i];
      }
      if (warp == kBucketWarps - 1) tot[side * n + key] = run;
    }
    __syncthreads();
  }
  grid_barrier(bar, round);

  // each key's first position in this block: its offset (the exclusive
  // prefix of the totals over the keys) plus its count in earlier blocks,
  // into this block's own row of blk; block 0 writes the offsets. The keys
  // go kScanChunk at a time through shared memory: loaded and stored by
  // consecutive threads, scanned 8 adjacent keys a thread.
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int32_t* t = tot + side * n;
    int32_t* base = blk + ((int64_t)side * blocks + g) * n;
    int carry = 0;
    for (int c0 = 0; c0 < n; c0 += kScanChunk) {
      const int len = min(kScanChunk, n - c0);
      int v[kScanPerThread];
#pragma unroll
      for (int u = 0; u < kScanPerThread; ++u) {
        const int i = threadIdx.x + u * kBucketThreads;
        v[u] = i < len ? __ldcg(t + c0 + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kScanPerThread; ++u)
        stage[threadIdx.x + u * kBucketThreads] = v[u];
      __syncthreads();
      int4* mine = reinterpret_cast<int4*>(stage) + 2 * threadIdx.x;
      const int4 lo = mine[0], hi = mine[1];
      int total = 0;
      int run = carry + block_exclusive_sum(lo.x + lo.y + lo.z + lo.w + hi.x +
                                                hi.y + hi.z + hi.w,
                                            scan, &total);
      carry += total;
      int4 plo, phi;
      plo.x = run;
      plo.y = plo.x + lo.x;
      plo.z = plo.y + lo.y;
      plo.w = plo.z + lo.z;
      phi.x = plo.w + lo.w;
      phi.y = phi.x + hi.x;
      phi.z = phi.y + hi.y;
      phi.w = phi.z + hi.z;
      mine[0] = plo;
      mine[1] = phi;
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kScanPerThread; ++u) {
        const int i = threadIdx.x + u * kBucketThreads;
        v[u] = i < len ? __ldcg(base + c0 + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kScanPerThread; ++u) {
        const int i = threadIdx.x + u * kBucketThreads;
        if (i < len) {
          base[c0 + i] = stage[i] + v[u];
          if (g == 0) off[side * (n + 1) + c0 + i] = stage[i];
        }
      }
      __syncthreads();
    }
    if (g == 0 && threadIdx.x == 0) off[side * (n + 1) + n] = (int)m;
  }
  __syncthreads();

  // per key range: each (warp, key) counter becomes the key's position for
  // the warp's first slot of that key (consecutive threads on consecutive
  // keys); then each warp places its tile
  for (int k0 = 0; k0 < n; k0 += cap) {
    const int kn = min(cap, n - k0);
    if (ranges > 1)
      count_range(ns, nd, t0, t1, n, k0, kn, cap, cnt, nullptr);
    for (int i0 = threadIdx.x; i0 < 2 * kn;
         i0 += kBucketThreads * kKeyChunks) {
      int add[kKeyChunks];
#pragma unroll
      for (int u = 0; u < kKeyChunks; ++u) {
        const int i = i0 + u * kBucketThreads;
        add[u] = i < 2 * kn
                     ? blk[((int64_t)(i / kn) * blocks + g) * n + k0 + i % kn]
                     : 0;
      }
#pragma unroll
      for (int u = 0; u < kKeyChunks; ++u) {
        const int i = i0 + u * kBucketThreads;
        if (i >= 2 * kn) break;
        int4* c = reinterpret_cast<int4*>(
            cnt + ((i / kn) * cap + i % kn) * kBucketWarps);
        const int4 lo = c[0], hi = c[1];
        c[0] = make_int4(lo.x + add[u], lo.y + add[u], lo.z + add[u],
                         lo.w + add[u]);
        c[1] = make_int4(hi.x + add[u], hi.y + add[u], hi.z + add[u],
                         hi.w + add[u]);
      }
    }
    __syncthreads();
    int* col0 = cnt + warp;
    int* col1 = cnt + cap * kBucketWarps + warp;
    for (int64_t s = t0; s < t1; s += 32 * kKeyChunks) {
      int key0[kKeyChunks], key1[kKeyChunks];
      load_keys(ns, s, t1, n, k0, kn, key0);
      load_keys(nd, s, t1, n, k0, kn, key1);
      const unsigned below = lanemask_lt();
#pragma unroll
      for (int c = 0; c < kKeyChunks; ++c) {   // both sides at once
        const int32_t slot = (int32_t)(s + c * 32 + lane);
        const unsigned peers0 = __match_any_sync(0xffffffffu, key0[c]);
        const unsigned peers1 = __match_any_sync(0xffffffffu, key1[c]);
        if (key0[c] >= 0)
          ord[col0[key0[c] * kBucketWarps] + __popc(peers0 & below)] = slot;
        if (key1[c] >= 0)
          ord[m + col1[key1[c] * kBucketWarps] + __popc(peers1 & below)] =
              slot;
        __syncwarp();
        if (key0[c] >= 0 && lane == __ffs(peers0) - 1)
          col0[key0[c] * kBucketWarps] += __popc(peers0);
        if (key1[c] >= 0 && lane == __ffs(peers1) - 1)
          col1[key1[c] * kBucketWarps] += __popc(peers1);
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Owner design: the backward

// two 16-byte loads' worth of a row (eight floats)
struct alignas(16) Raw32 {
  uint4 lo, hi;
};

// V consecutive features of a row as the bytes a lane loads at once (32 as
// two 16-byte loads, 16, 8, 4 or 2), converted to or from float32.
template <typename T, int V>
struct Raw {
  static constexpr int kBytes = V * (int)sizeof(T);
  using Type = typename std::conditional<
      kBytes == 32, Raw32,
      typename std::conditional<
          kBytes == 16, uint4,
          typename std::conditional<
              kBytes == 8, uint2,
              typename std::conditional<kBytes == 4, uint32_t,
                                        uint16_t>::type>::type>::type>::type;

  static __device__ __forceinline__ Type load(const T* p) {
    if constexpr (kBytes == 32) {
      const uint4* q = reinterpret_cast<const uint4*>(p);
      return Raw32{__ldg(q), __ldg(q + 1)};
    } else {
      return __ldg(reinterpret_cast<const Type*>(p));
    }
  }
  static __device__ __forceinline__ void to_float(const Type& raw,
                                                  float* out) {
    T v[V];
    memcpy(v, &raw, kBytes);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if constexpr (std::is_same<T, float>::value) {
        out[k] = v[k];
      } else {
        out[k] = __bfloat162float(v[k]);
      }
    }
  }
  static __device__ __forceinline__ void store(T* p, const float* in) {
    T v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if constexpr (std::is_same<T, float>::value) {
        v[k] = in[k];
      } else {
        v[k] = __float2bfloat16(in[k]);
      }
    }
    Type raw;
    memcpy(&raw, v, kBytes);
    *reinterpret_cast<Type*>(p) = raw;
  }
};

// The owner kernel's shared tables (the relation table and the partial
// gradients) keep each half of a row (its `units` columns, packs * V) lane
// major: lane p's pack (columns p*V .. p*V + V-1) is cut into groups of E =
// min(V, 4) columns, and group k sits at (k * packs + p) * E, so that one
// access of a warp reads a group of every lane without bank conflicts, as
// one 16-byte access a lane when E = 4. For V < 4 this is the plain layout.
template <int V>
struct Lanes {
  static constexpr int E = V < 4 ? V : 4;

  // where column c of a half lives
  static __device__ __forceinline__ int index(int c, int packs) {
    const int p = c / V, v = c % V;
    return ((v / E) * packs + p) * E + v % E;
  }
  // the first column of group q (q = k * packs + p) of a half
  static __device__ __forceinline__ int column(int q, int packs) {
    return (q % packs) * V + (q / packs) * E;
  }
  static __device__ __forceinline__ void read(const float* half, int packs,
                                              int p, float* out) {
#pragma unroll
    for (int k = 0; k < V / E; ++k) {
      const float* q = half + (k * packs + p) * E;
      if constexpr (E == 4) {
        const float4 x = *reinterpret_cast<const float4*>(q);
        out[4 * k] = x.x;
        out[4 * k + 1] = x.y;
        out[4 * k + 2] = x.z;
        out[4 * k + 3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) out[E * k + e] = q[e];
      }
    }
  }
  static __device__ __forceinline__ void add(float* half, int packs, int p,
                                             const float* x) {
#pragma unroll
    for (int k = 0; k < V / E; ++k) {
      float* q = half + (k * packs + p) * E;
      if constexpr (E == 4) {
        float4 a = *reinterpret_cast<float4*>(q);
        a.x += x[4 * k];
        a.y += x[4 * k + 1];
        a.z += x[4 * k + 2];
        a.w += x[4 * k + 3];
        *reinterpret_cast<float4*>(q) = a;
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) q[e] += x[E * k + e];
      }
    }
  }
};

// One slot's other endpoint, relation and upstream gradient (id 0, 0, 0
// for s < 0).
struct SlotMeta {
  int id, rs;
  float g;
};

__device__ __forceinline__ SlotMeta slot_meta(const int32_t* __restrict__ other,
                                              const int32_t* __restrict__ rel,
                                              const float* __restrict__ ds,
                                              int s, int n, int r) {
  SlotMeta x{0, 0, 0.f};
  if (s >= 0) {
    x.id = clip(other[s], n - 1);
    x.rs = clip(rel[s], r - 1);
    x.g = ds[s];
  }
  return x;
}

// One walk of an owner over one of its buckets: slots ord[begin..end), in
// which the owner's id is h (kSrc) or t, the other endpoint's id read from
// `other` (nd or ns). Adds the owner's unit gradients into acc0/acc1 and,
// in the src walk, the relation gradient into the warp's partial table
// `part` (r, dr; Lanes layout). The lane handles pack p, features j = p*V
// .. j+V-1 (and j + off ..), `live` when its pack lies inside the row;
// every lane runs the shuffles.
// A batch is 32 slots, lane i holding slot i's metadata; the next batch's
// metadata and the one after's slot ids are loaded before this batch's
// rows are gathered, kOwnSlots (paired modes half as many) at a time.
template <int M, typename T, int V, bool kSrc>
__device__ __forceinline__ void owner_walk(
    const T* __restrict__ z, const int32_t* __restrict__ other,
    const int32_t* __restrict__ rel, const float* __restrict__ ds,
    const int32_t* __restrict__ ord, int begin, int end, int n, int d,
    int r, int dr, int off, int packs, int p, bool live, const float* own0,
    const float* own1, const float* sre, float* part, float* acc0,
    float* acc1) {
  constexpr int U = kPaired<M> ? kOwnSlots / 2 : kOwnSlots;
  using R = Raw<T, V>;
  using L = Lanes<V>;
  const int j = p * V;
  const int lane = threadIdx.x & 31;
  SlotMeta cur = slot_meta(other, rel, ds,
                           begin + lane < end ? ord[begin + lane] : -1, n, r);
  int ahead = begin + 32 + lane < end ? ord[begin + 32 + lane] : -1;
  for (int b0 = begin; b0 < end; b0 += 32) {
    const int count = min(32, end - b0);
    const SlotMeta next = slot_meta(other, rel, ds, ahead, n, r);
    ahead = b0 + 64 + lane < end ? ord[b0 + 64 + lane] : -1;
    for (int k0 = 0; k0 < count; k0 += U) {
      typename R::Type raw0[U], raw1[U];
      int rk[U];
      float gk[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = __shfl_sync(0xffffffffu, cur.id, k0 + u);
        rk[u] = __shfl_sync(0xffffffffu, cur.rs, k0 + u);
        gk[u] = __shfl_sync(0xffffffffu, cur.g, k0 + u);
        if (live && k0 + u < count) {
          raw0[u] = R::load(z + (int64_t)row * d + j);
          if constexpr (kPaired<M>)
            raw1[u] = R::load(z + (int64_t)row * d + off + j);
        }
      }
      if (!live) continue;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u >= count) break;
        float x0[V], x1[V], r0[V], r1[V], dr0[V], dr1[V];
        R::to_float(raw0[u], x0);
        L::read(sre + rk[u] * d, packs, p, r0);
        if constexpr (kPaired<M>) {
          R::to_float(raw1[u], x1);
          L::read(sre + rk[u] * d + off, packs, p, r1);
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float o1 = kPaired<M> ? own1[v] : 0.f;
          const float y1 = kPaired<M> ? x1[v] : 0.f;
          const float q1 = kPaired<M> ? r1[v] : 0.f;
          if constexpr (kSrc) {
            const UnitGrad o =
                unit_grad<M, true>(gk[u], own0[v], o1, x0[v], y1, r0[v], q1);
            acc0[v] += o.dh0;
            acc1[v] += o.dh1;
            dr0[v] = o.dr0;
            dr1[v] = o.dr1;
          } else {
            const UnitGrad o =
                unit_grad<M, true>(gk[u], x0[v], y1, own0[v], o1, r0[v], q1);
            acc0[v] += o.dt0;
            acc1[v] += o.dt1;
          }
        }
        if constexpr (kSrc) {
          L::add(part + rk[u] * dr, packs, p, dr0);
          if constexpr (M == kComplex)
            L::add(part + rk[u] * dr + off, packs, p, dr1);
        }
      }
    }
    cur = next;
  }
}

// A group of `group` warps (the block's warps in groups, each group's
// warps adjacent) owns a node id; ids are strided over the grid's groups.
// Each warp of the group walks its share of the id's src and dst buckets
// (a contiguous quarter of each for a group of four), and the group's
// first warp adds the warps' float32 rows in warp order and writes the
// dz row once. off/ord are bucket_kernel's output: side 0 (ns) at
// off[0..n], ord[0..m), side 1 (nd) at off[n+1..2n+1], ord[m..2m). dz (n,
// d) in z's type is written whole; dre (r, dr) float32 must be zeroed.
// Shared memory: re (r*d), one partial (r, dr) relation-gradient table a
// warp, both in the Lanes layout (each half of a row: the paired modes'
// two, or complex's two gradient halves), and one row-pack stage a warp
// (32 * V floats, twice that for the paired modes), lane major.
template <int M, typename T, int V>
__global__ void __launch_bounds__(kOwnWarps * 32, kOwnBlocksPerSm)
    owner_kernel(const T* __restrict__ z, const int32_t* __restrict__ ns,
                 const int32_t* __restrict__ nd,
                 const int32_t* __restrict__ rel,
                 const float* __restrict__ re, const float* __restrict__ ds,
                 const int32_t* __restrict__ off,
                 const int32_t* __restrict__ ord, T* __restrict__ dz,
                 float* __restrict__ dre, int64_t m, int n, int d, int r,
                 int group) {
  using R = Raw<T, V>;
  using L = Lanes<V>;
  constexpr int H = kPaired<M> ? 2 : 1;      // row halves a lane holds
  extern __shared__ __align__(16) float smem[];
  const int dr = grad_width<M>(d);
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int member = warp % group;
  const int groups = warps / group;
  const int table = r * dr;
  const int units = kPaired<M> ? d / 2 : d;
  const int packs = units / V;
  float* sre = smem;
  float* part = smem + r * d + warp * table;
  float* stages = smem + r * d + warps * table;
  float* stage = stages + warp * 32 * V * H;
  for (int i = threadIdx.x; i < r * d; i += blockDim.x) {
    const int row = i / d, c = i % d;
    sre[row * d + (c / units) * units + L::index(c % units, packs)] = re[i];
  }
  for (int i = lane; i < table; i += 32) part[i] = 0.f;
  __syncthreads();

  const int half = kPaired<M> ? d / 2 : 0;
  const unsigned barrier = 1 + warp / group;  // the group's named barrier
  for (int v = blockIdx.x * groups + warp / group; v < n;
       v += gridDim.x * groups) {
    const int s0 = off[v], s1 = off[v + 1];
    const int d0 = off[n + 1 + v], d1 = off[n + 2 + v];
    // this warp's share of each bucket
    const int sa = s0 + (int)((int64_t)(s1 - s0) * member / group);
    const int sb = s0 + (int)((int64_t)(s1 - s0) * (member + 1) / group);
    const int da = d0 + (int)((int64_t)(d1 - d0) * member / group);
    const int db = d0 + (int)((int64_t)(d1 - d0) * (member + 1) / group);
    for (int p0 = 0; p0 < packs; p0 += 32) {
      const bool live = p0 + lane < packs;
      const int p = live ? p0 + lane : 0;
      const int j = p * V;
      float own0[V], own1[V], acc0[V], acc1[V];
#pragma unroll
      for (int k = 0; k < V; ++k) own0[k] = own1[k] = acc0[k] = acc1[k] = 0.f;
      if (live) {
        R::to_float(R::load(z + (int64_t)v * d + j), own0);
        if constexpr (kPaired<M>)
          R::to_float(R::load(z + (int64_t)v * d + half + j), own1);
      }
      owner_walk<M, T, V, true>(z, nd, rel, ds, ord, sa, sb, n, d, r, dr,
                                half, packs, p, live, own0, own1, sre, part,
                                acc0, acc1);
      owner_walk<M, T, V, false>(z, ns, rel, ds, ord + m, da, db, n, d, r,
                                 dr, half, packs, p, live, own0, own1, sre,
                                 part, acc0, acc1);
      if (group > 1) {      // the group's rows meet in shared memory
#pragma unroll
        for (int k = 0; k < V; ++k) {
          stage[k * 32 + lane] = acc0[k];
          if constexpr (kPaired<M>) stage[(V + k) * 32 + lane] = acc1[k];
        }
        asm volatile("bar.sync %0, %1;" ::"r"(barrier), "r"(group * 32)
                     : "memory");
        if (member == 0) {
          for (int w = 1; w < group; ++w) {
            const float* q = stage + w * 32 * V * H;
#pragma unroll
            for (int k = 0; k < V; ++k) {
              acc0[k] += q[k * 32 + lane];
              if constexpr (kPaired<M>) acc1[k] += q[(V + k) * 32 + lane];
            }
          }
        }
        asm volatile("bar.sync %0, %1;" ::"r"(barrier), "r"(group * 32)
                     : "memory");
      }
      if (live && member == 0) {
        R::store(dz + (int64_t)v * d + j, acc0);
        if constexpr (kPaired<M>)
          R::store(dz + (int64_t)v * d + half + j, acc1);
      }
    }
  }
  __syncthreads();
  // the block's warps' partials, summed, into dre, a group of E columns at
  // a time: one 16-byte vector atomic a group when E = 4 (dre 16-byte
  // aligned), else E scalar ones
  constexpr int E = L::E;
  const float* parts = smem + r * d;
  for (int i = threadIdx.x * E; i < table; i += blockDim.x * E) {
    float x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = 0.f;
    for (int w = 0; w < warps; ++w)
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] += parts[w * table + i + e];
    const int row = i / dr, within = i % dr;
    float* out = dre + row * dr + (within / units) * units +
                 L::column((within % units) / E, packs);
    if constexpr (E == 4) {
      if (x[0] != 0.f || x[1] != 0.f || x[2] != 0.f || x[3] != 0.f)
        atomicAdd(reinterpret_cast<float4*>(out),
                  make_float4(x[0], x[1], x[2], x[3]));
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (x[e] != 0.f) atomicAdd(out + e, x[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward redesign: "run" (both families)

// A half-row (`units` features) of the float32 relation table as the
// forward keeps it in shared memory: lane p's V features are cut into
// groups of E (all V when they take at most 16 bytes, else 16 bytes),
// group k at (k * packs + p) * E, so that one access of a warp reads a
// group of every lane without bank conflicts.
// Only float32 with V = 8 splits (E = 4, two groups; the owner kernel's
// Lanes layout); every other case is the plain layout.
template <typename T, int V>
struct TableLayout {
  static constexpr int E =
      V * (int)sizeof(T) > 16 ? 16 / (int)sizeof(T) : V;
  static_assert(E == V || 2 * E == V, "a lane's pack is one or two groups");
  using R = Raw<T, V>;

  static __device__ __forceinline__ int index(int c, int packs) {
    const int p = c / V, v = c % V;
    return ((v / E) * packs + p) * E + v % E;
  }
  static __device__ __forceinline__ typename R::Type read(const T* half,
                                                          int packs, int p) {
    if constexpr (E == V) {
      return *reinterpret_cast<const typename R::Type*>(half + p * V);
    } else {
      return Raw32{*reinterpret_cast<const uint4*>(half + p * E),
                   *reinterpret_cast<const uint4*>(half + (packs + p) * E)};
    }
  }
};

// where element c of a row sits in its shared copy
template <typename T, int V>
__device__ __forceinline__ int table_index(int c, int units, int packs) {
  return c < units ? TableLayout<T, V>::index(c, packs)
                   : units + TableLayout<T, V>::index(c - units, packs);
}

// The row of `id`, the lane's pack p of each half (V features at p * V,
// and at off + p * V for the paired modes), as raw bytes from z.
template <int M, typename T, int V>
__device__ __forceinline__ void fetch_row(const T* __restrict__ z, int id,
                                          int d, int off, int p,
                                          typename Raw<T, V>::Type& x0,
                                          typename Raw<T, V>::Type& x1) {
  const T* row = z + (int64_t)id * d + p * V;
  x0 = Raw<T, V>::load(row);
  if constexpr (kPaired<M>) x1 = Raw<T, V>::load(row + off);
}

// the clipped (h, t, relation) ids of slot s (0, 0, 0 for s < 0)
struct SlotIds {
  int h, t, r;
};

__device__ __forceinline__ SlotIds slot_ids(const int32_t* __restrict__ ns,
                                            const int32_t* __restrict__ nd,
                                            const int32_t* __restrict__ rel,
                                            int64_t s, int n, int r) {
  SlotIds x{0, 0, 0};
  if (s >= 0) {
    x.h = clip(__ldg(ns + s), n - 1);
    x.t = clip(__ldg(nd + s), n - 1);
    x.r = clip(__ldg(rel + s), r - 1);
  }
  return x;
}

// The sums over a warp of kFwdSlots = 8 slots' partials (acc[u], slot u),
// by a transpose reduction: each step halves the slots a lane holds and
// adds its partner's half (4 + 2 + 1 shuffles), then two plain steps; 9
// shuffles where eight warp sums take 40. Lane l ends with slot (l >> 2) &
// 7's sum. As a tree over the lanes' partials P: P[l] + P[l + 16] for l <
// 16, then the same halving over 16, 8, 4 and 2 (ops/negscore.py,
// lane_scores_plain).
__device__ __forceinline__ float reduce_slots(const float (&acc)[8]) {
  const int lane = threadIdx.x & 31;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float a4[4], a2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b4 ? acc[i + 4] : acc[i];
    a4[i] = keep + __shfl_xor_sync(0xffffffffu, b4 ? acc[i] : acc[i + 4], 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b3 ? a4[i + 2] : a4[i];
    a2[i] = keep + __shfl_xor_sync(0xffffffffu, b3 ? a4[i] : a4[i + 2], 8);
  }
  float a = (b2 ? a2[1] : a2[0]) +
            __shfl_xor_sync(0xffffffffu, b2 ? a2[0] : a2[1], 4);
  a += __shfl_xor_sync(0xffffffffu, a, 2);
  a += __shfl_xor_sync(0xffffffffu, a, 1);
  return a;
}

// The lane's pack of the src row of `id` into float32 registers.
template <int M, typename T, int V>
__device__ __forceinline__ void load_h(const T* __restrict__ z, int id,
                                       int d, int off, int p, float* h0,
                                       float* h1) {
  typename Raw<T, V>::Type x0, x1;
  fetch_row<M, T, V>(z, id, d, off, p, x0, x1);
  Raw<T, V>::to_float(x0, h0);
  if constexpr (kPaired<M>) Raw<T, V>::to_float(x1, h1);
}

// One slot's partial score over the lane's V units, added in order: h
// (float32 registers), t (raw bytes) and the relation row `rrow` of the
// shared table.
template <int M, typename T, int V>
__device__ __forceinline__ float lane_term(
    const float* h0, const float* h1, const typename Raw<T, V>::Type& t0,
    const typename Raw<T, V>::Type& t1, const float* rrow, int off,
    int packs, int p) {
  using R = Raw<T, V>;
  using Q = Raw<float, V>;
  using S = TableLayout<float, V>;
  float x0[V], x1[V], r0[V], r1[V];
  R::to_float(t0, x0);
  Q::to_float(S::read(rrow, packs, p), r0);
  if constexpr (kPaired<M>) {
    R::to_float(t1, x1);
    Q::to_float(S::read(rrow + off, packs, p), r1);
  }
  float a = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if constexpr (kPaired<M>) {
      a += unit_score<M, true>(h0[v], h1[v], x0[v], x1[v], r0[v], r1[v]);
    } else {
      a += unit_score<M, true>(h0[v], 0.f, x0[v], 0.f, r0[v], 0.f);
    }
  }
  return a;
}

// A warp's walk over the slots [begin, end): lane l holds pack p0 + l (V
// features of each half; 32 packs a pass, more passes for wider rows) of
// the current src id's row in float32 registers, reloaded only where ns
// changes, and gathers each slot's t pack from z (in L2) with kFwdRows
// slots in flight (float32 half as many: the same bytes); the relation
// row comes from the shared float32 table `stab` (TableLayout). Slots go in groups of kFwdSlots: a group with one src id (a
// vote) is computed with no branch between its slots, so that their loads
// and sums overlap; a group where ns changes, slot by slot. Each group's
// partials are summed by reduce_slots and stored by one lane each; a
// later pass adds into what the first stored (the same lane). Slot ids
// are loaded 32 at a time, one a lane, a batch ahead.
template <int M, typename T, int V>
__device__ __forceinline__ void fwd_walk(
    const T* __restrict__ z, const int32_t* __restrict__ ns,
    const int32_t* __restrict__ nd, const int32_t* __restrict__ rel,
    const float* stab, float* __restrict__ out, int64_t begin, int64_t end,
    int n, int d, int r) {
  using R = Raw<T, V>;
  constexpr int F = sizeof(T) == 4 ? kFwdRows / 2 : kFwdRows;
  static_assert(kFwdSlots == 8 && kFwdSlots % F == 0, "reduce_slots takes 8");
  const int units = kPaired<M> ? d / 2 : d;
  const int off = kPaired<M> ? units : 0;
  const int packs = units / V;
  const int lane = threadIdx.x & 31;
  for (int p0 = 0; p0 < packs; p0 += 32) {
    const bool live = p0 + lane < packs;
    const int p = live ? p0 + lane : 0;
    int cur = -1;                // the src id whose pack h0/h1 hold
    float h0[V], h1[V];
#pragma unroll
    for (int v = 0; v < V; ++v) h0[v] = h1[v] = 0.f;
    SlotIds ids = slot_ids(ns, nd, rel, begin + lane < end ? begin + lane : -1,
                           n, r);
    for (int64_t b0 = begin; b0 < end; b0 += 32) {
      const int count = end - b0 < 32 ? (int)(end - b0) : 32;
      const int64_t ahead = b0 + 32 + lane;
      const SlotIds next = slot_ids(ns, nd, rel, ahead < end ? ahead : -1, n,
                                    r);
      for (int k0 = 0; k0 < count; k0 += kFwdSlots) {
        // a slot past `count` takes slot k0's ids (its sum is not stored)
        const int hk0 = __shfl_sync(0xffffffffu, ids.h, k0);
        const bool mine = lane >= k0 && lane < k0 + kFwdSlots && lane < count;
        const bool one_h = __all_sync(0xffffffffu, !mine || ids.h == hk0);
        if (one_h && hk0 != cur) {   // the group's one src id, loaded once
          load_h<M, T, V>(z, hk0, d, off, p, h0, h1);
          cur = hk0;
        }
        float acc[kFwdSlots];
#pragma unroll
        for (int f0 = 0; f0 < kFwdSlots; f0 += F) {
          typename R::Type t0[F], t1[F];
#pragma unroll
          for (int u = 0; u < F; ++u) {
            const int k = k0 + f0 + u;
            const int t = __shfl_sync(0xffffffffu, ids.t, k < count ? k : k0);
            fetch_row<M, T, V>(z, t, d, off, p, t0[u], t1[u]);
          }
          if (one_h) {     // no branch between the group's slots
#pragma unroll
            for (int u = 0; u < F; ++u) {
              const int k = k0 + f0 + u;
              const int rr =
                  __shfl_sync(0xffffffffu, ids.r, k < count ? k : k0);
              acc[f0 + u] = lane_term<M, T, V>(h0, h1, t0[u], t1[u],
                                               stab + rr * d, off, packs, p);
            }
          } else {         // ns changes inside the group: slot by slot
#pragma unroll
            for (int u = 0; u < F; ++u) {
              const int k = k0 + f0 + u;
              const int src = k < count ? k : k0;
              const int h = __shfl_sync(0xffffffffu, ids.h, src);
              const int rr = __shfl_sync(0xffffffffu, ids.r, src);
              if (h != cur) {
                load_h<M, T, V>(z, h, d, off, p, h0, h1);
                cur = h;
              }
              acc[f0 + u] = lane_term<M, T, V>(h0, h1, t0[u], t1[u],
                                               stab + rr * d, off, packs, p);
            }
          }
        }
        if (!live) {       // a lane past the row's packs adds nothing
#pragma unroll
          for (int u = 0; u < kFwdSlots; ++u) acc[u] = 0.f;
        }
        const float s = reduce_slots(acc);
        const int k = k0 + ((lane >> 2) & 7);
        if ((lane & 3) == 0 && k < count) {
          float* o = out + b0 + k;
          *o = p0 == 0 ? s : *o + s;
        }
      }
      ids = next;
    }
  }
}

// the relation table (float32, already rounded to z's type) into shared
// memory, each half-row in the TableLayout (block-wide)
template <int M, int V>
__device__ __forceinline__ void stage_table(const float* __restrict__ re,
                                            int r, int d, float* stab) {
  const int units = kPaired<M> ? d / 2 : d;
  const int packs = units / V;
#pragma unroll 4
  for (int row = 0; row < r; ++row)
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      stab[row * d + table_index<float, V>(c, units, packs)] =
          re[row * d + c];
}

// Shared memory: the relation table (float32, TableLayout). Warp w of the
// grid walks slots [w * per_warp, (w + 1) * per_warp).
template <int M, typename T, int V>
__global__ void __launch_bounds__(kFwdWarps * 32, kFwdBlocksPerSm)
    run_fwd_kernel(const T* __restrict__ z, const int32_t* __restrict__ ns,
                   const int32_t* __restrict__ nd,
                   const int32_t* __restrict__ rel,
                   const float* __restrict__ re, float* __restrict__ out,
                   int64_t m, int n, int d, int r, int64_t per_warp) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  float* stab = reinterpret_cast<float*>(fwd_smem);
  stage_table<M, V>(re, r, d, stab);
  __syncthreads();
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t begin = warp * per_warp;
  const int64_t end = begin + per_warp < m ? begin + per_warp : m;
  if (begin < end)
    fwd_walk<M, T, V>(z, ns, nd, rel, stab, out, begin, end, n, d, r);
}

// ---------------------------------------------------------------------------
// Launchers

int device_attr(cudaDeviceAttr attr, int* value) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(value, attr, device);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int M, typename T, int V>
int launch_fwd(const void* z, const void* ns, const void* nd, const void* rel,
               const void* re, void* out, long long m, int n, int d, int r,
               void* stream) {
  int sms = 0;
  int err = device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)r * d * sizeof(float);
  err = allow_smem(fwd_kernel<M, T, V>, smem);
  if (err != cudaSuccess) return err;
  const int64_t per_block = (int64_t)kWarps * kSlots<M>;
  int64_t blocks = (m + per_block - 1) / per_block;
  if (blocks > (int64_t)sms * kBlocksPerSm)
    blocks = (int64_t)sms * kBlocksPerSm;
  fwd_kernel<M, T, V>
      <<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(z), static_cast<const int32_t*>(ns),
          static_cast<const int32_t*>(nd), static_cast<const int32_t*>(rel),
          static_cast<const float*>(re), static_cast<float*>(out), m, n, d,
          r);
  return (int)cudaGetLastError();
}

template <int M, typename T>
int launch_bwd(const void* z, const void* ns, const void* nd, const void* rel,
               const void* re, const void* ds, void* dz, void* dre,
               long long m, int n, int d, int r, void* stream) {
  int sms = 0;
  int err = device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err != cudaSuccess) return err;
  const size_t smem =
      ((size_t)r * d + (size_t)r * grad_width<M>(d) + (size_t)kWarps * d) *
      sizeof(float);
  err = allow_smem(bwd_kernel<M, T>, smem);
  if (err != cudaSuccess) return err;
  // contiguous runs of at least 32 slots per warp, about kBlocksPerSm
  // blocks per SM
  const int64_t target_warps = (int64_t)sms * kBlocksPerSm * kWarps;
  int64_t per_warp = (m + target_warps - 1) / target_warps;
  if (per_warp < 32) per_warp = 32;
  const int64_t warps = (m + per_warp - 1) / per_warp;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  bwd_kernel<M, T><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(z), static_cast<const int32_t*>(ns),
      static_cast<const int32_t*>(nd), static_cast<const int32_t*>(rel),
      static_cast<const float*>(re), static_cast<const float*>(ds),
      static_cast<float*>(dz), static_cast<float*>(dre), m, n, d, r,
      per_warp);
  return (int)cudaGetLastError();
}

// The dual-sorted kernels' dynamic shared memory: the tables and `bufs`
// cap x d float32 buffers, with cap lowered from kSpanCap until it fits the
// card's opt-in limit (0: every chunk takes the global path).
int ds_smem(size_t tables, int bufs, int d, int* cap, size_t* bytes) {
  int limit = 0;
  int err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &limit);
  if (err != cudaSuccess) return err;
  const size_t room = (size_t)limit - 1024;   // the kernels' static arrays
  const size_t per_row = (size_t)bufs * d * sizeof(float);
  int c = kSpanCap;
  while (c > 0 && tables + c * per_row > room) --c;
  *cap = c;
  *bytes = tables + c * per_row;
  return (int)cudaSuccess;
}

template <int M, typename T>
int launch_ds_fwd(const void* z, const void* ns, const void* nd,
                  const void* rel, const void* re, void* out, long long m,
                  int n, int d, int r, int chunk, void* stream) {
  if (chunk <= 0) return (int)cudaErrorInvalidValue;
  int cap = 0;
  size_t smem = 0;
  int err = ds_smem((size_t)r * d * sizeof(float), 2, d, &cap, &smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(ds_fwd_kernel<M, T>, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (m + chunk - 1) / chunk;
  ds_fwd_kernel<M, T>
      <<<(unsigned)blocks, kDsThreads, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(z), static_cast<const int32_t*>(ns),
          static_cast<const int32_t*>(nd), static_cast<const int32_t*>(rel),
          static_cast<const float*>(re), static_cast<float*>(out), m, n, d, r,
          chunk, cap);
  return (int)cudaGetLastError();
}

template <int M, typename T>
int launch_ds_bwd(const void* z, const void* ns, const void* nd,
                  const void* rel, const void* re, const void* ds, void* dz,
                  void* dre, long long m, int n, int d, int r, int chunk,
                  void* stream) {
  if (chunk <= 0) return (int)cudaErrorInvalidValue;
  int cap = 0;
  size_t smem = 0;
  const size_t tables = ((size_t)r * d + (size_t)r * grad_width<M>(d) +
                         (size_t)kDsWarps * d) * sizeof(float);
  int err = ds_smem(tables, 4, d, &cap, &smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(ds_bwd_kernel<M, T>, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (m + chunk - 1) / chunk;
  ds_bwd_kernel<M, T>
      <<<(unsigned)blocks, kDsThreads, smem, (cudaStream_t)stream>>>(
          static_cast<const T*>(z), static_cast<const int32_t*>(ns),
          static_cast<const int32_t*>(nd), static_cast<const int32_t*>(rel),
          static_cast<const float*>(re), static_cast<const float*>(ds),
          static_cast<float*>(dz), static_cast<float*>(dre), m, n, d, r,
          chunk, cap);
  return (int)cudaGetLastError();
}

int launch_buckets(const void* ns, const void* nd, long long m, int n,
                   int blocks, void* blk, void* tot, void* off, void* ord,
                   void* bar, void* stream) {
  if (blocks <= 0 || blocks > kBucketWarps * kMaxBlockRun || n <= 0 ||
      m <= 0 || m > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  int err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &limit);
  if (err != cudaSuccess) return err;
  // keys per range: two sides' counters for every warp, beside the static
  // scan and stage arrays (and 1 KB to spare)
  const int room = (limit - (int)((kBucketThreads + kScanChunk) * sizeof(int)) -
                    1024) / (int)(2 * kBucketWarps * sizeof(int));
  const int cap = n < room ? n : room;
  const size_t smem = (size_t)2 * kBucketWarps * cap * sizeof(int);
  err = allow_smem(bucket_kernel, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err != cudaSuccess) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bucket_kernel, kBucketThreads, smem);
  if (err != cudaSuccess) return err;
  if ((long long)blocks > (long long)sms * per_sm)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const int32_t* ns_p = static_cast<const int32_t*>(ns);
  const int32_t* nd_p = static_cast<const int32_t*>(nd);
  int64_t m64 = m;
  int32_t* blk_p = static_cast<int32_t*>(blk);
  int32_t* tot_p = static_cast<int32_t*>(tot);
  int32_t* off_p = static_cast<int32_t*>(off);
  int32_t* ord_p = static_cast<int32_t*>(ord);
  unsigned* bar_p = static_cast<unsigned*>(bar);
  void* args[] = {&ns_p, &nd_p, &m64, &n, (void*)&cap, &blk_p,
                  &tot_p, &off_p, &ord_p, &bar_p};
  err = (int)cudaLaunchCooperativeKernel((const void*)bucket_kernel,
                                         dim3(blocks), dim3(kBucketThreads),
                                         args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return (int)cudaGetLastError();
}

template <int M, typename T, int V>
int launch_owner(const void* z, const void* ns, const void* nd,
                 const void* rel, const void* re, const void* ds,
                 const void* off, const void* ord, void* dz, void* dre,
                 long long m, int n, int d, int r, void* stream) {
  if (reinterpret_cast<uintptr_t>(dre) % 16) return (int)cudaErrorInvalidValue;
  int sms = 0, limit = 0, per_sm = 0;
  int err = device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err != cudaSuccess) return err;
  err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &limit);
  if (err != cudaSuccess) return err;
  // the relation table and one partial gradient table a warp: as many warps
  // a block as fit, up to kOwnWarps
  const size_t table = (size_t)r * d * sizeof(float);
  const size_t part = (size_t)r * grad_width<M>(d) * sizeof(float);
  const size_t stage = (size_t)32 * V * (kPaired<M> ? 2 : 1) * sizeof(float);
  int warps = kOwnWarps;
  while (warps > 0 && table + warps * (part + stage) > (size_t)limit) --warps;
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const int group = warps < kGroupWarps ? warps : kGroupWarps;
  warps -= warps % group;
  const size_t smem = table + warps * (part + stage);
  auto kernel = owner_kernel<M, T, V>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, warps * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int groups = warps / group;
  int64_t blocks = (n + groups - 1) / groups;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  kernel<<<(unsigned)blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(z), static_cast<const int32_t*>(ns),
      static_cast<const int32_t*>(nd), static_cast<const int32_t*>(rel),
      static_cast<const float*>(re), static_cast<const float*>(ds),
      static_cast<const int32_t*>(off), static_cast<const int32_t*>(ord),
      static_cast<T*>(dz), static_cast<float*>(dre), m, n, d, r, group);
  return (int)cudaGetLastError();
}

// The features a lane of the owner kernel loads at once: the largest V
// (up to 32 bytes) that divides the (half-)width, that z's and dz's bases
// allow, and that still gives the 32 lanes a pack each, else 1.
int owner_vector(int units, size_t elem, const void* z, const void* dz,
                 int widest) {
  for (int v = widest; v > 1; v /= 2) {
    const size_t bytes = v * elem;
    if (units % v == 0 && units / v >= 32 &&
        reinterpret_cast<uintptr_t>(z) % bytes == 0 &&
        reinterpret_cast<uintptr_t>(dz) % bytes == 0)
      return v;
  }
  return 1;
}

// The features a lane of the forward redesign takes at once: 8, else 4,
// where that divides the (half-)width, z's base allows it and the 32 lanes
// still get a pack each; else 1.
int fwd_vector(int units, size_t elem, const void* z) {
  for (int v = 8; v >= 4; v /= 2)
    if (units % v == 0 && units / v >= 32 &&
        reinterpret_cast<uintptr_t>(z) % (v * elem) == 0)
      return v;
  return 1;
}

template <int M, typename T, int V>
int launch_run_fwd(const void* z, const void* ns, const void* nd,
                   const void* rel, const void* re, void* out, long long m,
                   int n, int d, int r, void* stream) {
  int sms = 0;
  int err = device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)r * d * sizeof(float);
  auto kernel = run_fwd_kernel<M, T, V>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // every resident warp a contiguous run of whole groups of kFwdSlots
  const int64_t warps = (int64_t)sms * kFwdBlocksPerSm * kFwdWarps;
  int64_t per_warp = (m + warps - 1) / warps;
  per_warp = (per_warp + kFwdSlots - 1) / kFwdSlots * kFwdSlots;
  const int64_t used = (m + per_warp - 1) / per_warp;
  const int64_t blocks = (used + kFwdWarps - 1) / kFwdWarps;
  kernel<<<(unsigned)blocks, kFwdWarps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(z), static_cast<const int32_t*>(ns),
      static_cast<const int32_t*>(nd), static_cast<const int32_t*>(rel),
      static_cast<const float*>(re), static_cast<float*>(out), m, n, d, r,
      per_warp);
  return (int)cudaGetLastError();
}

// mode checks shared by every entry point: a known mode, and an even d for
// the paired modes
bool bad_mode(int mode, int d) {
  if (mode < kDistMult || mode > kRotatE) return true;
  return (mode == kComplex || mode == kRotatE) && d % 2 != 0;
}

}  // namespace

// Plain C interface for ctypes. `mode`: 0 distmult, 1 complex, 2 transe,
// 3 rotate. `vec` selects the streamed forward's 16-byte loads (z's rows
// 16-byte aligned and the (half-)width a multiple of the pack: 4 floats or
// 8 bfloat16s); `chunk` is the dual-sorted kernels' slots per block (the
// sampler's BLOCK). `out` holds m floats; `dz` (n*d) and `dre` (r*d, or
// r*d/2 for rotate) must be zeroed floats. Nothing is allocated and nothing
// synchronises. Returns the cudaError_t of the launch (0 = success).
#define NEGSCORE_DISPATCH(CALL)                               \
  switch (mode) {                                             \
    case kDistMult: return CALL(kDistMult);                   \
    case kComplex: return CALL(kComplex);                     \
    case kTransE: return CALL(kTransE);                       \
    default: return CALL(kRotatE);                            \
  }

extern "C" int negscore_fwd_f32(int mode, const void* z, const void* ns,
                                const void* nd, const void* rel,
                                const void* re, void* out, long long m, int n,
                                int d, int r, int vec, void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
#define CALL(M)                                                          \
  (vec ? launch_fwd<M, float, 4>(z, ns, nd, rel, re, out, m, n, d, r,    \
                                 stream)                                 \
       : launch_fwd<M, float, 1>(z, ns, nd, rel, re, out, m, n, d, r,    \
                                 stream))
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}

extern "C" int negscore_fwd_bf16(int mode, const void* z, const void* ns,
                                 const void* nd, const void* rel,
                                 const void* re, void* out, long long m,
                                 int n, int d, int r, int vec, void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
#define CALL(M)                                                            \
  (vec ? launch_fwd<M, __nv_bfloat16, 8>(z, ns, nd, rel, re, out, m, n, d, \
                                         r, stream)                        \
       : launch_fwd<M, __nv_bfloat16, 1>(z, ns, nd, rel, re, out, m, n, d, \
                                         r, stream))
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}

// The forward redesign: negscore_run_fwd_{f32,bf16} ("run", both
// families). It takes any order of ns and nd and writes all m scores.
extern "C" int negscore_run_fwd_f32(int mode, const void* z, const void* ns,
                                    const void* nd, const void* rel,
                                    const void* re, void* out, long long m,
                                    int n, int d, int r, void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
  const int units = (mode == kComplex || mode == kRotatE) ? d / 2 : d;
  const int v = fwd_vector(units, sizeof(float), z);
#define CALL(M)                                                         \
  (v == 8   ? launch_run_fwd<M, float, 8>(z, ns, nd, rel, re, out, m, n, \
                                          d, r, stream)                 \
   : v == 4 ? launch_run_fwd<M, float, 4>(z, ns, nd, rel, re, out, m, n, \
                                          d, r, stream)                 \
            : launch_run_fwd<M, float, 1>(z, ns, nd, rel, re, out, m, n, \
                                          d, r, stream))
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}

extern "C" int negscore_run_fwd_bf16(int mode, const void* z, const void* ns,
                                     const void* nd, const void* rel,
                                     const void* re, void* out, long long m,
                                     int n, int d, int r, void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
  const int units = (mode == kComplex || mode == kRotatE) ? d / 2 : d;
  const int v = fwd_vector(units, sizeof(__nv_bfloat16), z);
  using B = __nv_bfloat16;
#define CALL(M)                                                             \
  (v == 8   ? launch_run_fwd<M, B, 8>(z, ns, nd, rel, re, out, m, n, d, r,  \
                                      stream)                               \
   : v == 4 ? launch_run_fwd<M, B, 4>(z, ns, nd, rel, re, out, m, n, d, r,  \
                                      stream)                               \
            : launch_run_fwd<M, B, 1>(z, ns, nd, rel, re, out, m, n, d, r,  \
                                      stream))
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}

extern "C" int negscore_bwd_f32(int mode, const void* z, const void* ns,
                                const void* nd, const void* rel,
                                const void* re, const void* ds, void* dz,
                                void* dre, long long m, int n, int d, int r,
                                void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
#define CALL(M) \
  launch_bwd<M, float>(z, ns, nd, rel, re, ds, dz, dre, m, n, d, r, stream)
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}

extern "C" int negscore_bwd_bf16(int mode, const void* z, const void* ns,
                                 const void* nd, const void* rel,
                                 const void* re, const void* ds, void* dz,
                                 void* dre, long long m, int n, int d, int r,
                                 void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
#define CALL(M)                                                              \
  launch_bwd<M, __nv_bfloat16>(z, ns, nd, rel, re, ds, dz, dre, m, n, d, r, \
                               stream)
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}

extern "C" int negscore_ds_fwd_f32(int mode, const void* z, const void* ns,
                                   const void* nd, const void* rel,
                                   const void* re, void* out, long long m,
                                   int n, int d, int r, int chunk,
                                   void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
#define CALL(M) \
  launch_ds_fwd<M, float>(z, ns, nd, rel, re, out, m, n, d, r, chunk, stream)
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}

extern "C" int negscore_ds_fwd_bf16(int mode, const void* z, const void* ns,
                                    const void* nd, const void* rel,
                                    const void* re, void* out, long long m,
                                    int n, int d, int r, int chunk,
                                    void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
#define CALL(M)                                                          \
  launch_ds_fwd<M, __nv_bfloat16>(z, ns, nd, rel, re, out, m, n, d, r,  \
                                  chunk, stream)
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}

extern "C" int negscore_ds_bwd_f32(int mode, const void* z, const void* ns,
                                   const void* nd, const void* rel,
                                   const void* re, const void* ds, void* dz,
                                   void* dre, long long m, int n, int d,
                                   int r, int chunk, void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
#define CALL(M)                                                       \
  launch_ds_bwd<M, float>(z, ns, nd, rel, re, ds, dz, dre, m, n, d, r, \
                          chunk, stream)
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}

extern "C" int negscore_ds_bwd_bf16(int mode, const void* z, const void* ns,
                                    const void* nd, const void* rel,
                                    const void* re, const void* ds, void* dz,
                                    void* dre, long long m, int n, int d,
                                    int r, int chunk, void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
#define CALL(M)                                                          \
  launch_ds_bwd<M, __nv_bfloat16>(z, ns, nd, rel, re, ds, dz, dre, m, n, \
                                  d, r, chunk, stream)
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}

// The owner design. negscore_buckets: the stable counting sort of the m
// slots by clipped ns and nd over n ids (bucket_kernel), one cooperative
// launch of `blocks` blocks (at most one a multiprocessor is safe: the
// kernel asks for the room of one); scratch blk (2 * blocks * n ints), tot
// (2 * n ints), outputs off (2 * (n + 1) ints) and ord (2 * m ints); `bar`
// one zeroed unsigned int. negscore_owner_bwd_{f32,bf16}: the backward
// from those buckets; dz (n*d, z's type) is written whole, dre (r*d, or
// r*d/2 for rotate, float32, 16-byte aligned) must be zeroed.
extern "C" int negscore_buckets(const void* ns, const void* nd, long long m,
                                int n, int blocks, void* blk, void* tot,
                                void* off, void* ord, void* bar,
                                void* stream) {
  return launch_buckets(ns, nd, m, n, blocks, blk, tot, off, ord, bar,
                        stream);
}

extern "C" int negscore_owner_bwd_f32(int mode, const void* z, const void* ns,
                                      const void* nd, const void* rel,
                                      const void* re, const void* ds,
                                      const void* off, const void* ord,
                                      void* dz, void* dre, long long m, int n,
                                      int d, int r, void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0 || n <= 0) return (int)cudaSuccess;
  const int units = (mode == kComplex || mode == kRotatE) ? d / 2 : d;
  const int v = owner_vector(units, sizeof(float), z, dz, 8);
#define CALL(M)                                                             \
  (v == 8   ? launch_owner<M, float, 8>(z, ns, nd, rel, re, ds, off, ord,   \
                                        dz, dre, m, n, d, r, stream)        \
   : v == 4 ? launch_owner<M, float, 4>(z, ns, nd, rel, re, ds, off, ord,   \
                                        dz, dre, m, n, d, r, stream)        \
   : v == 2 ? launch_owner<M, float, 2>(z, ns, nd, rel, re, ds, off, ord,   \
                                        dz, dre, m, n, d, r, stream)        \
            : launch_owner<M, float, 1>(z, ns, nd, rel, re, ds, off, ord,   \
                                        dz, dre, m, n, d, r, stream))
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}

extern "C" int negscore_owner_bwd_bf16(int mode, const void* z,
                                       const void* ns, const void* nd,
                                       const void* rel, const void* re,
                                       const void* ds, const void* off,
                                       const void* ord, void* dz, void* dre,
                                       long long m, int n, int d, int r,
                                       void* stream) {
  if (bad_mode(mode, d)) return (int)cudaErrorInvalidValue;
  if (m <= 0 || d <= 0 || n <= 0) return (int)cudaSuccess;
  const int units = (mode == kComplex || mode == kRotatE) ? d / 2 : d;
  const int v = owner_vector(units, sizeof(__nv_bfloat16), z, dz, 8);
  using B = __nv_bfloat16;
#define CALL(M)                                                               \
  (v == 8   ? launch_owner<M, B, 8>(z, ns, nd, rel, re, ds, off, ord, dz,     \
                                    dre, m, n, d, r, stream)                  \
   : v == 4 ? launch_owner<M, B, 4>(z, ns, nd, rel, re, ds, off, ord, dz,     \
                                    dre, m, n, d, r, stream)                  \
   : v == 2 ? launch_owner<M, B, 2>(z, ns, nd, rel, re, ds, off, ord, dz,     \
                                    dre, m, n, d, r, stream)                  \
            : launch_owner<M, B, 1>(z, ns, nd, rel, re, ds, off, ord, dz,     \
                                    dre, m, n, d, r, stream))
  NEGSCORE_DISPATCH(CALL)
#undef CALL
}
