// Fused DistMult negative scoring for NVIDIA Hopper (sm_90a): forward and
// backward of
//
//   s[i] = sum_j z[ns[i], j] * re[rel[i], j] * z[nd[i], j]
//
// over the K*E negative slots of a KGE training step. ns is ascending (the
// stratified-sorted sampler); nd is unsorted; ns, nd and rel are clipped
// into range, as the reference's clip-mode gathers do. z is float32 or
// bfloat16 (read through __bfloat162float); re, the relation table, is
// float32 (the caller rounds it to z's type first) and products and sums
// are float32. Backward, for an upstream gradient ds:
//
//   dz[ns[i]] += ds[i] * re[rel[i]] * z[nd[i]]     (src side)
//   dz[nd[i]] += ds[i] * re[rel[i]] * z[ns[i]]     (dst side)
//   dre[rel[i]] += ds[i] * z[ns[i]] * z[nd[i]]
//
// with dz and dre float32 sums.
//
// Replaces the TPU kernels biomedkg_tpu/ops/pallas/negscore.py::_fwd_call
// (_fwd_kernel) and ::_bwd_call (_bwd_kernel, _bwd_kernel_dense) in mode
// "distmult". There the z table sits in VMEM, h = z[ns] is rebuilt by
// windowed one-hot matmuls on the MXU (Mosaic cannot gather), t = z[nd] is
// streamed through HBM as a (K*E, d) array and the dst gradient is either a
// dense one-hot matmul or a separate XLA scatter. On Hopper the whole z
// table (about 3k x 256 bf16, 1.5 MB at the training envelope) stays in the
// 50 MB L2, so both rows are plain gathers inside the kernel and no
// (K*E, d) array reaches device memory.
//
// Bound: arithmetic. Per slot and feature the forward does 3 float32
// operations (two products, one add) and the backward 8; the bytes a call
// must move are the z table, three int32 index arrays, the relation table
// and the scores (plus ds, dz and dre backward), about 8 MB forward and
// 11 MB backward at the training envelope (K*E = 409,600 slots, d = 256).
// So the least times there are about 4.7 us forward and 12.5 us backward
// at the card's 67 TFLOP/s float32 rate, against 2-3 us of bytes at
// 3.35 TB/s. This simple design is far from that (0.13 ms forward and
// 0.44 ms backward on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md): each
// slot is two dependent L2 round trips (indices, then rows), and the
// backward's atomics queue in L2. What it does about the latency:
//
//  * Forward: one warp per slot, kUnroll slots in flight per warp, each
//    lane reading 16 bytes of z[ns] and z[nd] per feature pack; the
//    relation table lives in shared memory, read 16 bytes at a time; a
//    warp-shuffle sum ends a slot.
//  * Backward: a warp walks a contiguous run of slots, its lanes on
//    consecutive features so that each warp-wide atomic is coalesced.
//    Because ns is sorted (about 140 slots per id at the envelope) it
//    keeps a running float32 row of ds*re*t for the current src id in
//    shared memory and flushes it with one atomicAdd per feature when the
//    id changes, as segsum.cu does; any order stays exact, only slower.
//    The dst side adds ds*re*h into dz[nd] with float32 atomics that
//    resolve in L2: no dt stream and no second scatter kernel. dre is
//    summed per block in shared memory and flushed once per block.
//
// Faster designs (several slots per warp with the index loads hoisted a
// run ahead, vector atomics, dst-sorted slots) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                  // slots in flight per warp
constexpr int kBlocksPerSm = 4;             // grid size target
constexpr int kDefaultSmem = 48 * 1024;     // dynamic shared memory without
                                            // the opt-in attribute

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

// Shared memory: the relation table re (r*d floats).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ z, const int32_t* __restrict__ ns,
               const int32_t* __restrict__ nd,
               const int32_t* __restrict__ rel, const float* __restrict__ re,
               float* __restrict__ out, int64_t m, int n, int d, int r) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < r * d; i += kThreads) smem[i] = re[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t num_warps = ((int64_t)gridDim.x * kThreads) >> 5;
  const int packs = d / V;
  for (int64_t s0 = warp * kUnroll; s0 < m; s0 += num_warps * kUnroll) {
    int hs[kUnroll], ts[kUnroll], rs[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t s = s0 + u;
      const bool ok = s < m;
      hs[u] = ok ? clip(ns[s], n - 1) : 0;
      ts[u] = ok ? clip(nd[s], n - 1) : 0;
      rs[u] = ok ? clip(rel[s], r - 1) : 0;
      acc[u] = 0.f;
    }
    for (int p = lane; p < packs; p += 32) {
      float h[kUnroll][V], t[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        Pack<T, V>::load(z + (int64_t)hs[u] * d + p * V, h[u]);
        Pack<T, V>::load(z + (int64_t)ts[u] * d + p * V, t[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float rr[V];
        load_shared<V>(smem + rs[u] * d + p * V, rr);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[u] += h[u][v] * t[u][v] * rr[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float a = warp_sum(acc[u]);
      if (lane == 0 && s0 + u < m) out[s0 + u] = a;
    }
  }
}

// Shared memory: re (r*d), the block's dre sums (r*d), and one running
// src-side dz row per warp (kWarps*d). Lane l owns features l, l+32, ...
// in every slot: the running row needs no synchronisation inside a warp,
// and each warp-wide atomic covers 32 consecutive floats (4 sectors).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const T* __restrict__ z, const int32_t* __restrict__ ns,
               const int32_t* __restrict__ nd,
               const int32_t* __restrict__ rel, const float* __restrict__ re,
               const float* __restrict__ ds, float* __restrict__ dz,
               float* __restrict__ dre, int64_t m, int n, int d, int r,
               int64_t slots_per_warp) {
  extern __shared__ __align__(16) float smem[];
  float* sre = smem;
  float* sdre = smem + r * d;
  float* row = sdre + r * d + (threadIdx.x >> 5) * d;
  for (int i = threadIdx.x; i < r * d; i += kThreads) {
    sre[i] = re[i];
    sdre[i] = 0.f;
  }
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < d; i += 32) row[i] = 0.f;
  __syncthreads();

  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t begin = warp * slots_per_warp;
  const int64_t end = begin + slots_per_warp < m ? begin + slots_per_warp : m;
  int cur = -1;  // the src id whose running row is held in `row`
  for (int64_t s0 = begin; s0 < end; s0 += kUnroll) {
    int hs[kUnroll], ts[kUnroll], rs[kUnroll], flush[kUnroll];
    float g[kUnroll];
    bool ok[kUnroll], change[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t s = s0 + u;
      ok[u] = s < end;
      hs[u] = ok[u] ? clip(ns[s], n - 1) : 0;
      ts[u] = ok[u] ? clip(nd[s], n - 1) : 0;
      rs[u] = ok[u] ? clip(rel[s], r - 1) : 0;
      g[u] = ok[u] ? ds[s] : 0.f;
    }
    // the src id sequence is the same for every feature: decide the
    // flushes once per group of slots
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      change[u] = ok[u] && hs[u] != cur;
      flush[u] = cur;
      if (change[u]) cur = hs[u];
    }
    for (int c = lane; c < d; c += 32) {
      float h[kUnroll], t[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        Pack<T, 1>::load(z + (int64_t)hs[u] * d + c, &h[u]);
        Pack<T, 1>::load(z + (int64_t)ts[u] * d + c, &t[u]);
      }
      float acc = row[c];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        if (change[u]) {
          if (flush[u] >= 0) atomicAdd(dz + (int64_t)flush[u] * d + c, acc);
          acc = 0.f;
        }
        const float gr = g[u] * sre[rs[u] * d + c];
        acc += gr * t[u];
        atomicAdd(dz + (int64_t)ts[u] * d + c, gr * h[u]);
        atomicAdd(sdre + rs[u] * d + c, g[u] * h[u] * t[u]);
      }
      row[c] = acc;
    }
  }
  if (cur >= 0) {
    for (int c = lane; c < d; c += 32)
      atomicAdd(dz + (int64_t)cur * d + c, row[c]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < r * d; i += kThreads) {
    const float v = sdre[i];
    if (v != 0.f) atomicAdd(dre + i, v);
  }
}

int num_sms(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     device);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int V>
int launch_fwd(const void* z, const void* ns, const void* nd, const void* rel,
               const void* re, void* out, long long m, int n, int d, int r,
               void* stream) {
  int sms = 0;
  int err = num_sms(&sms);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)r * d * sizeof(float);
  err = allow_smem(fwd_kernel<T, V>, smem);
  if (err != cudaSuccess) return err;
  const int64_t per_block = (int64_t)kWarps * kUnroll;
  int64_t blocks = (m + per_block - 1) / per_block;
  if (blocks > (int64_t)sms * kBlocksPerSm)
    blocks = (int64_t)sms * kBlocksPerSm;
  fwd_kernel<T, V><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(z), static_cast<const int32_t*>(ns),
      static_cast<const int32_t*>(nd), static_cast<const int32_t*>(rel),
      static_cast<const float*>(re), static_cast<float*>(out), m, n, d, r);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* z, const void* ns, const void* nd, const void* rel,
               const void* re, const void* ds, void* dz, void* dre,
               long long m, int n, int d, int r, void* stream) {
  int sms = 0;
  int err = num_sms(&sms);
  if (err != cudaSuccess) return err;
  const size_t smem = ((size_t)2 * r + kWarps) * d * sizeof(float);
  err = allow_smem(bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  // contiguous runs of at least 32 slots per warp, about kBlocksPerSm
  // blocks per SM
  const int64_t target_warps = (int64_t)sms * kBlocksPerSm * kWarps;
  int64_t per_warp = (m + target_warps - 1) / target_warps;
  if (per_warp < 32) per_warp = 32;
  const int64_t warps = (m + per_warp - 1) / per_warp;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  bwd_kernel<T><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(z), static_cast<const int32_t*>(ns),
      static_cast<const int32_t*>(nd), static_cast<const int32_t*>(rel),
      static_cast<const float*>(re), static_cast<const float*>(ds),
      static_cast<float*>(dz), static_cast<float*>(dre), m, n, d, r,
      per_warp);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. `vec` selects the forward's 16-byte loads
// (z's rows 16-byte aligned and d a multiple of the pack: 4 floats or 8
// bfloat16s).
// `out` holds m floats; `dz` (n*d) and `dre` (r*d) must be zeroed floats.
// Nothing is allocated and nothing synchronises. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int negscore_fwd_f32(const void* z, const void* ns, const void* nd,
                                const void* rel, const void* re, void* out,
                                long long m, int n, int d, int r, int vec,
                                void* stream) {
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
  return vec ? launch_fwd<float, 4>(z, ns, nd, rel, re, out, m, n, d, r,
                                    stream)
             : launch_fwd<float, 1>(z, ns, nd, rel, re, out, m, n, d, r,
                                    stream);
}

extern "C" int negscore_fwd_bf16(const void* z, const void* ns,
                                 const void* nd, const void* rel,
                                 const void* re, void* out, long long m,
                                 int n, int d, int r, int vec, void* stream) {
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
  return vec ? launch_fwd<__nv_bfloat16, 8>(z, ns, nd, rel, re, out, m, n, d,
                                            r, stream)
             : launch_fwd<__nv_bfloat16, 1>(z, ns, nd, rel, re, out, m, n, d,
                                            r, stream);
}

extern "C" int negscore_bwd_f32(const void* z, const void* ns, const void* nd,
                                const void* rel, const void* re,
                                const void* ds, void* dz, void* dre,
                                long long m, int n, int d, int r,
                                void* stream) {
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
  return launch_bwd<float>(z, ns, nd, rel, re, ds, dz, dre, m, n, d, r,
                           stream);
}

extern "C" int negscore_bwd_bf16(const void* z, const void* ns,
                                 const void* nd, const void* rel,
                                 const void* re, const void* ds, void* dz,
                                 void* dre, long long m, int n, int d, int r,
                                 void* stream) {
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
  return launch_bwd<__nv_bfloat16>(z, ns, nd, rel, re, ds, dz, dre, m, n, d,
                                   r, stream);
}
