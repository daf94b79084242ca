// Relation-blocked grouped GEMM for NVIDIA Hopper (sm_90a).
//
//   out[e, :] = x[e, :] @ W[block_rel[e / B]]          (transpose = 0)
//   out[e, :] = x[e, :] @ W[block_rel[e / B]]^T        (transpose = 1)
//
// x is (rows, K) with rows a multiple of the block size B; every B-row block
// holds edges of one relation, named by block_rel (int32). W is (R, K, N),
// or (R, N, K) read as its transpose, so the backward's d_msg = g @ W[r]^T
// is the same kernel with no transposed copy. A relation id outside [0, R)
// leaves its rows zero. The sum is float32; out has x's type.
//
// Replaces the TPU kernel biomedkg_tpu/ops/pallas/relmm.py::_relmm_pallas
// (kernel body _fwd_kernel; its backward _relmm_bwd runs it on W^T). There
// one grid step per B-row block multiplies the whole block on the MXU, with
// the block's W[r] picked by a scalar-prefetched index map. Here a CTA takes
// one tile of at most kBM rows inside one B-row block (tiles never straddle
// two blocks, so any B works and the ragged last tile of a block is masked)
// and one tile of kBN output columns; it reads the block's relation itself
// and streams K tiles of x and W[r] through shared memory.
//
// Bound. A call does 2*rows*K*N operations and moves rows*(K+N) elements of
// x and out, R*K*N of W and 4 bytes per block. At the RGAT training shape
// (bf16, rows 40,960, 768 -> 512) that is 32.2 GFLOP, 0.033 ms on the bf16
// tensor cores at 989 TFLOP/s, against about 105 MB, 0.031 ms at 3.35 TB/s:
// at the ridge. At the serving shape (float32, rows ~1.16 M, 768 -> 512,
// no tensor cores in full float32) it is 0.91 TFLOP, at least 13.6 ms at
// 67 TFLOP/s: operations. What this first design does about it: the bf16
// instance runs on the tensor cores (WMMA bf16 16x16x16 fragments, float32
// accumulators), each element of a shared tile feeding 32 (warp tile)
// products, its tiles staged by 16-byte loads where the widths allow; the
// float32 instance is a register-tiled SIMT product (a 4x4 micro-tile per
// thread, full float32: no TF32, ROADMAP.md hazard H1). Both read each x
// and W tile once per CTA from device memory. Both are far from the bound
// (PERF.md has their times); not done yet: wgmma with TMA-fed multi-stage
// pipelines, wider CTA tiles, cp.async double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // rows per CTA tile
constexpr int kBN = 64;  // output columns per CTA tile

// ---- float32: SIMT, 256 threads as 16 x 16, a 4x4 micro-tile each -------
constexpr int kF32Threads = 256;
constexpr int kF32BK = 16;

template <bool kTrans>
__global__ void __launch_bounds__(kF32Threads)
    relmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const int32_t* __restrict__ block_rel,
                     float* __restrict__ out, int k, int n, int num_rel,
                     int block_size, int tiles_per_block) {
  // the x tile is stored k-major with one pad column: the loads walk k
  // fastest and the padding spreads their stores over the banks
  __shared__ float as[kF32BK][kBM + 1];
  __shared__ float bs[kF32BK][kBN];
  const int64_t blk = blockIdx.x / tiles_per_block;
  const int64_t row0 =
      blk * block_size + (int64_t)(blockIdx.x % tiles_per_block) * kBM;
  const int64_t blk_end = (blk + 1) * (int64_t)block_size;
  const int64_t row_end = row0 + kBM < blk_end ? row0 + kBM : blk_end;
  const int m_rows = (int)(row_end - row0);
  const int col0 = blockIdx.y * kBN;
  const int r = block_rel[blk];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (r >= 0 && r < num_rel) {  // uniform over the CTA
    const float* wr = w + (int64_t)r * k * n;
    for (int k0 = 0; k0 < k; k0 += kF32BK) {
      for (int i = threadIdx.x; i < kBM * kF32BK; i += kF32Threads) {
        const int m = i / kF32BK, kk = i % kF32BK;
        as[kk][m] = (m < m_rows && k0 + kk < k)
                        ? x[(row0 + m) * k + k0 + kk] : 0.f;
      }
      for (int i = threadIdx.x; i < kF32BK * kBN; i += kF32Threads) {
        // neighbouring threads on neighbouring addresses of W[r]
        const int kk = kTrans ? i % kF32BK : i / kBN;
        const int c = kTrans ? i / kF32BK : i % kBN;
        float v = 0.f;
        if (k0 + kk < k && col0 + c < n)
          v = kTrans ? wr[(int64_t)(col0 + c) * k + k0 + kk]
                     : wr[(int64_t)(k0 + kk) * n + col0 + c];
        bs[kk][c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kF32BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
    if (m >= m_rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < n) out[(row0 + m) * n + c] = acc[i][j];
    }
  }
}

// ---- bf16: WMMA on the tensor cores, 4 warps as 2 x 2, 32x32 each --------
constexpr int kBf16Threads = 128;
constexpr int kBf16BK = 32;
constexpr int kPadH = 8;  // bf16 leading dimensions stay multiples of 8
constexpr int kPadF = 4;  // float leading dimension stays a multiple of 4

// The shared x and W[r] tiles by 16-byte loads of 8 bf16: needs k % 8 == 0
// (and n % 8 == 0 unless transposed) and 16-byte aligned bases, so a vector
// is wholly inside or wholly outside the matrix.
template <bool kTrans>
__device__ __forceinline__ void load_tiles_vec(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wr,
    __nv_bfloat16 (*as)[kBf16BK + kPadH], __nv_bfloat16 (*bs)[kBN + kPadH],
    int64_t row0, int m_rows, int col0, int k0, int k, int n) {
  constexpr int kVa = kBf16BK / 8;  // vectors per row of the x tile
  for (int v = threadIdx.x; v < kBM * kVa; v += kBf16Threads) {
    const int m = v / kVa, kk = (v % kVa) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m < m_rows && k0 + kk < k)
      val = *reinterpret_cast<const uint4*>(x + (row0 + m) * k + k0 + kk);
    *reinterpret_cast<uint4*>(&as[m][kk]) = val;
  }
  if (!kTrans) {
    constexpr int kVb = kBN / 8;  // vectors per row of the W tile
    for (int v = threadIdx.x; v < kBf16BK * kVb; v += kBf16Threads) {
      const int kk = v / kVb, c = (v % kVb) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + kk < k && col0 + c < n)
        val = *reinterpret_cast<const uint4*>(
            wr + (int64_t)(k0 + kk) * n + col0 + c);
      *reinterpret_cast<uint4*>(&bs[kk][c]) = val;
    }
  } else {  // W[r] is (n, k): vectors run along k, one output column each
    for (int v = threadIdx.x; v < kBN * kVa; v += kBf16Threads) {
      const int c = v / kVa, kk = (v % kVa) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (col0 + c < n && k0 + kk < k)
        val = *reinterpret_cast<const uint4*>(
            wr + (int64_t)(col0 + c) * k + k0 + kk);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) bs[kk + i][c] = h[i];
    }
  }
}

template <bool kTrans>
__global__ void __launch_bounds__(kBf16Threads)
    relmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      const int32_t* __restrict__ block_rel,
                      __nv_bfloat16* __restrict__ out, int k, int n,
                      int num_rel, int block_size, int tiles_per_block,
                      bool vec) {
  using namespace nvcuda;
  // 32-byte alignment: wmma::load/store_matrix_sync want 256-bit pointers
  __shared__ __align__(32) __nv_bfloat16 as[kBM][kBf16BK + kPadH];
  __shared__ __align__(32) __nv_bfloat16 bs[kBf16BK][kBN + kPadH];
  __shared__ __align__(32) float cs[kBM][kBN + kPadF];
  const int64_t blk = blockIdx.x / tiles_per_block;
  const int64_t row0 =
      blk * block_size + (int64_t)(blockIdx.x % tiles_per_block) * kBM;
  const int64_t blk_end = (blk + 1) * (int64_t)block_size;
  const int64_t row_end = row0 + kBM < blk_end ? row0 + kBM : blk_end;
  const int m_rows = (int)(row_end - row0);
  const int col0 = blockIdx.y * kBN;
  const int r = block_rel[blk];
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (r >= 0 && r < num_rel) {  // uniform over the CTA
    const __nv_bfloat16* wr = w + (int64_t)r * k * n;
    for (int k0 = 0; k0 < k; k0 += kBf16BK) {
      if (vec) {
        load_tiles_vec<kTrans>(x, wr, as, bs, row0, m_rows, col0, k0, k, n);
      } else {
        for (int i = threadIdx.x; i < kBM * kBf16BK; i += kBf16Threads) {
          const int m = i / kBf16BK, kk = i % kBf16BK;
          as[m][kk] = (m < m_rows && k0 + kk < k)
                          ? x[(row0 + m) * k + k0 + kk] : zero;
        }
        for (int i = threadIdx.x; i < kBf16BK * kBN; i += kBf16Threads) {
          const int kk = kTrans ? i % kBf16BK : i / kBN;
          const int c = kTrans ? i / kBf16BK : i % kBN;
          __nv_bfloat16 v = zero;
          if (k0 + kk < k && col0 + c < n)
            v = kTrans ? wr[(int64_t)(col0 + c) * k + k0 + kk]
                       : wr[(int64_t)(k0 + kk) * n + col0 + c];
          bs[kk][c] = v;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBf16BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &as[wm * 32 + i * 16][kk],
                                 kBf16BK + kPadH);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], &bs[kk][wn * 32 + j * 16],
                                 kBN + kPadH);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&cs[wm * 32 + i * 16][wn * 32 + j * 16],
                              acc[i][j], kBN + kPadF, wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kBf16Threads) {
    const int m = i / kBN, c = i % kBN;
    if (m < m_rows && col0 + c < n)
      out[(row0 + m) * n + col0 + c] = __float2bfloat16(cs[m][c]);
  }
}

template <bool kTrans>
void start(dim3 grid, cudaStream_t stream, const float* x, const float* w,
           const int32_t* block_rel, float* out, int k, int n, int num_rel,
           int block_size, int tiles_per_block) {
  relmm_f32_kernel<kTrans><<<grid, kF32Threads, 0, stream>>>(
      x, w, block_rel, out, k, n, num_rel, block_size, tiles_per_block);
}

template <bool kTrans>
void start(dim3 grid, cudaStream_t stream, const __nv_bfloat16* x,
           const __nv_bfloat16* w, const int32_t* block_rel,
           __nv_bfloat16* out, int k, int n, int num_rel, int block_size,
           int tiles_per_block) {
  const bool vec = k % 8 == 0 && (kTrans || n % 8 == 0) &&
                   ((uintptr_t)x | (uintptr_t)w) % 16 == 0;
  relmm_bf16_kernel<kTrans><<<grid, kBf16Threads, 0, stream>>>(
      x, w, block_rel, out, k, n, num_rel, block_size, tiles_per_block, vec);
}

template <typename T>
int launch(const void* x, const void* w, const void* block_rel, void* out,
           long long rows, int k, int n, int num_rel, int block_size,
           int transpose, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  if (block_size <= 0 || rows % block_size) return (int)cudaErrorInvalidValue;
  const int tiles_per_block = (block_size + kBM - 1) / kBM;
  const long long grid_x = rows / block_size * tiles_per_block;
  const long long grid_y = (n + kBN - 1) / kBN;
  if (grid_x > 0x7fffffffLL || grid_y > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const int32_t* br = static_cast<const int32_t*>(block_rel);
  T* op = static_cast<T*>(out);
  if (transpose)
    start<true>(grid, (cudaStream_t)stream, xp, wp, br, op, k, n, num_rel,
                block_size, tiles_per_block);
  else
    start<false>(grid, (cudaStream_t)stream, xp, wp, br, op, k, n, num_rel,
                 block_size, tiles_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. x (rows, k); w (num_rel, k, n), or
// (num_rel, n, k) with transpose = 1; block_rel (rows / block_size,) int32;
// out (rows, n), every element written. Nothing is allocated and nothing
// synchronises. Returns the cudaError_t of the launch (0 = success).
extern "C" int relmm_f32(const void* x, const void* w, const void* block_rel,
                         void* out, long long rows, int k, int n, int num_rel,
                         int block_size, int transpose, void* stream) {
  return launch<float>(x, w, block_rel, out, rows, k, n, num_rel, block_size,
                       transpose, stream);
}

extern "C" int relmm_bf16(const void* x, const void* w, const void* block_rel,
                          void* out, long long rows, int k, int n,
                          int num_rel, int block_size, int transpose,
                          void* stream) {
  return launch<__nv_bfloat16>(x, w, block_rel, out, rows, k, n, num_rel,
                               block_size, transpose, stream);
}
