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
// kernel's bound and time (PERF.md); this simple design is far from the
// bound, since each slot costs dependent L2 round trips (indices, then
// rows) and the backward's atomics queue in L2.
//
// Streamed family (any order of ns and nd; fast for ascending ns):
//  * forward: one warp per slot, kUnroll slots in flight per warp (half as
//    many for the paired modes, which load twice the rows), each lane
//    reading 16 bytes of z[ns] and z[nd] per feature pack; the relation
//    table in shared memory; a warp-shuffle sum ends a slot;
//  * backward: a warp walks a contiguous run of slots, its lanes on
//    consecutive units so each warp-wide atomic is coalesced; it keeps a
//    running float32 row of the current src id's gradient in shared
//    memory and flushes it with one atomicAdd per feature when the id
//    changes (ns sorted: about 140 slots per id at the envelope); the dst
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
//  * backward, the gradients of a staged side are summed into a float32
//    band of the same rows in shared memory and flushed to dz once per
//    chunk, one atomicAdd per row and feature: about 1.6 M global atomics
//    per step at the envelope where the streamed backward makes about
//    105 M for the dst side alone. Each warp walks a contiguous run of the
//    chunk with a running src row (one band atomic per id change, as the
//    streamed backward); the dst side and the relation gradient take
//    shared atomics;
//  * a side whose span exceeds `cap` (a band that wraps the id range,
//    about one chunk per step, or nd in any order) reads z and adds into
//    dz directly with global atomics, in the same kernel: every input stays
//    exact, only slower.
// The cap is kSpanCap = 32 rows per side, lowered at launch when the
// card's opt-in shared memory per block cannot hold 2 (forward) or 4
// (backward) cap x d float32 buffers beside the tables and the running
// rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
template <int M>
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
    return -sqrtf(fmaxf(u0 * u0 + u1 * u1, 1e-12f));
  }
}

// One unit's gradient times g: d/dh, d/dt and d/d(relation) for both
// features of the unit (rotate: dr0 is dtheta, dr1 unused).
struct UnitGrad {
  float dh0, dh1, dt0, dt1, dr0, dr1;
};

template <int M>
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
    const float dist = sqrtf(fmaxf(u0 * u0 + u1 * u1, 1e-12f));
    const float du0 = -g * u0 / dist;
    const float du1 = -g * u1 / dist;
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
