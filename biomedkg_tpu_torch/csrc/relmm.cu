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
// one tile of rows inside one B-row block (tiles never straddle two blocks,
// so any B works and the ragged last tile of a block is masked) and one tile
// of output columns; it reads the block's relation itself and streams K
// tiles of x and W[r] through shared memory.
//
// Bound. A call does 2*rows*K*N operations and moves rows*(K+N) elements of
// x and out, R*K*N of W and 4 bytes per block. At the RGAT training shape
// (bf16, rows 40,960, 768 -> 512) that is 32.2 GFLOP, 0.033 ms on the bf16
// tensor cores at 989 TFLOP/s, against about 105 MB, 0.031 ms at 3.35 TB/s:
// at the ridge. At the serving shape (float32, rows ~1.16 M, 768 -> 256,
// no tensor cores in full float32) it is 0.46 TFLOP, at least 6.8 ms at
// 67 TFLOP/s: operations.
//
// Four instances (ops/relmm.py picks one per call, relmm_instance):
//  - wgmma (bf16; K and N multiples of 8, 16-byte aligned bases): tiles of
//    128 rows x 128 columns, one persistent CTA per SM walking them, three
//    warpgroups. One producer thread keeps TMA loads of the x tile (a 2-D
//    tensor map over (rows, K)) and the W[r] tile (a 3-D map with the
//    relation as a coordinate: no copy of the weights) in flight through a
//    4-stage ring of 64-deep K tiles in shared memory (128-byte swizzle),
//    with full and empty mbarriers. Two consumer warpgroups each run
//    wgmma.mma_async m64n128k16 (bf16 in, float32 accumulators in
//    registers) on 64 of the rows: B is N-major in the forward (the
//    transpose bit) and K-major in d_msg. setmaxnreg moves registers from
//    the producer to the consumers. The consumers hand a stage back as soon
//    as the next stage's products are issued, so that loads run up to four
//    stages ahead, into the next tile during this tile's epilogue. The
//    epilogue rounds to bf16 in registers, transposes within each quad of
//    lanes by shuffles and stores 16 bytes a lane. Rows past the block's
//    end are loaded and multiplied, and masked at the store; TMA zero-fills
//    past the matrices' edges.
//  - simt_f32 (float32, full precision off the tensor cores: no TF32,
//    ROADMAP.md hazard H1; N a multiple of 4, 16-byte aligned bases): a CTA
//    of 128 x 128, 256 threads, an 8 x 8 micro-tile each: 64 FMAs for four
//    float4 shared reads, where the first design had 16 for eight scalar
//    ones. K tiles of 8 stream through a 4-stage cp.async ring, so the
//    next tiles load during this tile's FMAs. Both operands sit in shared
//    memory as 8 rows of 128 values, one per k (padded to 132 floats), read
//    as float4: the forward's W[r] rows are copied 16 bytes at a time as
//    they lie; the x tile and d_msg's W[r]^T are copied 4 bytes at a time
//    along K into their transposed places, which the padding spreads over
//    all 32 banks. 121-128 registers, no spill: two CTAs per SM.
//  - wmma_general and simt_f32_general (any widths and alignments): the
//    first design, 64 x 64 tiles, legacy WMMA 16x16x16 (bf16) and a 4 x 4
//    SIMT micro-tile (float32), synchronous loads. Off the path (odd
//    widths) and kept as the yardstick the redesign is timed against.
// PERF.md has every instance's times beside its bound.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// The instances, in the order of ops/relmm.py's INSTANCES.
enum Instance : int {
  kWmmaGeneral = 0,
  kWgmma = 1,
  kSimtGeneral = 2,
  kSimt = 3,
};

// ===== the general instances: any widths and alignments =====================
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
int start_general(const void* x, const void* w, const void* block_rel,
                  void* out, long long rows, int k, int n, int num_rel,
                  int block_size, int transpose, cudaStream_t stream) {
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
    start<true>(grid, stream, xp, wp, br, op, k, n, num_rel, block_size,
                tiles_per_block);
  else
    start<false>(grid, stream, xp, wp, br, op, k, n, num_rel, block_size,
                 tiles_per_block);
  return (int)cudaSuccess;
}

// ===== shared by the redesigned instances ====================================

using hopper::smem_u32;

// A tile of output: tiles are numbered with the column tiles of one row
// tile together, so that CTAs running at once share the x tile (read from
// device memory once and from L2 after).
struct Tile {
  int64_t blk, row0;
  int m_rows, col0;
};

__device__ __forceinline__ Tile tile_of(int64_t tile, int bm, int bn,
                                        int block_size, int tiles_per_block,
                                        int col_tiles) {
  const int64_t row_tile = tile / col_tiles;
  Tile t;
  t.col0 = (int)(tile % col_tiles) * bn;
  t.blk = row_tile / tiles_per_block;
  t.row0 = t.blk * block_size + (row_tile % tiles_per_block) * bm;
  const int64_t end = (t.blk + 1) * (int64_t)block_size;
  t.m_rows = (int)((t.row0 + bm < end ? t.row0 + bm : end) - t.row0);
  return t;
}

// ===== float32: 128 x 128 tiles, an 8 x 8 micro-tile a thread ===============
namespace simt {

constexpr int kBM = 128, kBN = 128, kBK = 8, kStages = 4, kThreads = 256;
constexpr int kLd = kBM + 4;  // a k-row of a tile, padded: 132 floats

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

template <bool kTrans>
__global__ void __launch_bounds__(kThreads, 2)
    relmm_f32_simt_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const int32_t* __restrict__ block_rel,
                          float* __restrict__ out, int k, int n, int num_rel,
                          int block_size, int tiles_per_block,
                          int col_tiles) {
  __shared__ __align__(16) float as[kStages][kBK][kLd];
  __shared__ __align__(16) float bs[kStages][kBK][kLd];
  const Tile t =
      tile_of(blockIdx.x, kBM, kBN, block_size, tiles_per_block, col_tiles);
  const int r = block_rel[t.blk];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (r >= 0 && r < num_rel) {  // uniform over the CTA
    const float* wr = w + (int64_t)r * k * n;
    const int k_tiles = (k + kBK - 1) / kBK;
    // Element e = threadIdx.x + 256 i of a (128, 8) tile stored along K:
    // row m0 + 32 i, depth kk0. Eight lanes read a row's 32 bytes; the
    // stores land at depth * 132 + row, 32 distinct banks per warp.
    const int m0 = threadIdx.x / kBK, kk0 = threadIdx.x % kBK;
    const float* xs = x + (t.row0 + m0) * k + kk0;
    // the forward's W[r] (k, n) is copied 16 bytes of a row at a time, as
    // it lies; d_msg's (n, k) rows run along K, as x's do
    const int kkb = threadIdx.x / 32, cb = (threadIdx.x % 32) * 4;
    const float* ws = kTrans ? wr + (int64_t)(t.col0 + m0) * k + kk0
                             : wr + (int64_t)kkb * n + t.col0 + cb;
    auto load = [&](int kt, int s) {
      const int k0 = kt * kBK;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = m0 + 32 * i < t.m_rows && k0 + kk0 < k;
        cp_async4(&as[s][kk0][m0 + 32 * i],
                  ok ? xs + (int64_t)32 * i * k + k0 : x, ok);
      }
      if (kTrans) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = t.col0 + m0 + 32 * i < n && k0 + kk0 < k;
          cp_async4(&bs[s][kk0][m0 + 32 * i],
                    ok ? ws + (int64_t)32 * i * k + k0 : w, ok);
        }
      } else {
        const bool ok = k0 + kkb < k && t.col0 + cb < n;
        cp_async16(&bs[s][kkb][cb], ok ? ws + (int64_t)k0 * n : w, ok);
      }
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < k_tiles) load(s, s);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
      // tile kt has landed for every thread, and every thread is done with
      // the slot the next load overwrites (tile kt - 1's)
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
      __syncthreads();
      if (kt + kStages - 1 < k_tiles)
        load(kt + kStages - 1, (kt + kStages - 1) % kStages);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      const int s = kt % kStages;
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[s][kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&as[s][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[s][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[s][kk][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
  // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise by tx, as
  // float4 stores (n % 4 == 0: a vector is wholly inside or outside)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i / 4) * 64 + ty * 4 + i % 4;
    if (m >= t.m_rows) continue;
    float* orow = out + (t.row0 + m) * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = t.col0 + h * 64 + tx * 4;
      if (c < n)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

}  // namespace simt

// ===== bf16: wgmma fed by TMA ================================================
namespace wg {

using namespace hopper;

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 4;
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int kTileBytes = kBM * kBK * 2;  // the x tile; W's (kBK x kBN) too
constexpr int kStageBytes = 2 * kTileBytes;
// the ring, 1024 bytes to align it (the 128-byte swizzle repeats every
// 1024), and a full and an empty barrier per stage
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
// one CTA per SM: 168 registers a thread at launch (a wgmma with its 64
// accumulators needs about 90); the producer keeps 40, the consumers take
// 232 (128 x 40 + 256 x 232 <= 65,536)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kConsumerWarps = 8;

// desc_sw128 (hopper.cuh): K-major tiles (x; d_msg's W) use the stride
// offset alone; the forward's N-major W tile also steps 8192 bytes from its
// first 64 columns to its next (the leading offset).

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128], bf16 in, float32 sums; kTransB 1
// reads B N-major.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

// Lane q of each quad holds words v[g] = row values of column group g; after
// two butterfly rounds it holds v[p] = lane p's word of group q.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
#pragma unroll
  for (int b = 1; b <= 2; b <<= 1) {
    const bool upper = q & b;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      if (g & b) continue;
      const uint32_t got =
          __shfl_xor_sync(0xffffffffu, upper ? v[g] : v[g | b], b);
      if (upper)
        v[g] = got;
      else
        v[g | b] = got;
    }
  }
}

template <bool kTrans>
__global__ void __launch_bounds__(kThreads, 1)
    relmm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_w,
                            const int32_t* __restrict__ block_rel,
                            __nv_bfloat16* __restrict__ out, int k, int n,
                            int num_rel, int block_size, int tiles_per_block,
                            int col_tiles, int64_t num_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = ring + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int k_iters = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent: each CTA walks tiles blockIdx.x, + gridDim.x, ... Both
  // roles skip a tile whose relation is outside [0, R) (its rows are
  // zero), so their running stage counts `it` agree.
  const int group = threadIdx.x / 128;
  if (group == 2) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int it = 0;
      for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const Tile t = tile_of(tile, kBM, kBN, block_size, tiles_per_block,
                               col_tiles);
        const int r = block_rel[t.blk];
        if (r < 0 || r >= num_rel) continue;
        for (int kb = 0; kb < k_iters; ++kb, ++it) {
          const int s = it % kStages;
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          const uint32_t a = ring + s * kStageBytes, b = a + kTileBytes;
          // TMA counts a box's zero-filled bytes too
          mbar_expect_tx(full(s), kStageBytes);
          tma_load_2d(a, &map_x, full(s), kb * kBK, (int)t.row0);
          if (kTrans) {  // W[r]^T: (n, k) rows along K, one 128 x 64 box
            tma_load_3d(b, &map_w, full(s), kb * kBK, t.col0, r);
          } else {  // W[r]: (k, n) rows along N, two 64 x 64 boxes
            tma_load_3d(b, &map_w, full(s), t.col0, kb * kBK, r);
            tma_load_3d(b + kTileBytes / 2, &map_w, full(s), t.col0 + 64,
                        kb * kBK, r);
          }
        }
      }
    }
  } else {  // consumers: warpgroup `group` takes rows 64 group .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    int it = 0;
    for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
      const Tile t = tile_of(tile, kBM, kBN, block_size, tiles_per_block,
                             col_tiles);
      const int r = block_rel[t.blk];
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      if (r >= 0 && r < num_rel) {
        for (int kb = 0; kb < k_iters; ++kb, ++it) {
          const int s = it % kStages;
          mbar_wait(full(s), (it / kStages) & 1);
          const uint32_t a = ring + s * kStageBytes + group * (kTileBytes / 2);
          const uint32_t b = ring + s * kStageBytes + kTileBytes;
          fence_acc(acc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            const uint64_t da = desc_sw128(a + kk * 32, 16, 1024);
            if (kTrans)
              wgmma_m64n128k16<0>(acc, da, desc_sw128(b + kk * 32, 16, 1024));
            else
              wgmma_m64n128k16<1>(
                  acc, da, desc_sw128(b + kk * 2048, kTileBytes / 2, 1024));
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          // the previous stage's products are done: hand its slot back
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          fence_acc(acc);
          if (kb > 0 && lane == 0) mbar_arrive(empty((it - 1) % kStages));
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty((it - 1) % kStages));
      }
      // acc[4 i + 2 j + c] is row 16 warp + lane / 4 + 8 j, column
      // 8 i + 2 (lane % 4) + c of this warpgroup's 64 x 128 tile; the
      // stores run while the producer loads the next tile's stages
      const int q = lane % 4;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = group * 64 + warp * 16 + lane / 4 + 8 * j;
        __nv_bfloat16* orow = out + (t.row0 + m) * n;
#pragma unroll
        for (int a4 = 0; a4 < 4; ++a4) {
          uint32_t v[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            v[g] = pack_bf16x2(acc[(4 * a4 + g) * 4 + 2 * j],
                               acc[(4 * a4 + g) * 4 + 2 * j + 1]);
          quad_transpose(v, q);
          // n % 8 == 0: the 8 columns are wholly inside or outside
          const int c = t.col0 + 8 * (4 * a4 + q);
          if (m < t.m_rows && c < n)
            *reinterpret_cast<uint4*>(orow + c) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

}  // namespace wg

// ===== host =================================================================

// The 1-D grid of the redesigned instances: row tiles x column tiles.
bool grid_1d(long long rows, int n, int block_size, int bm, int bn,
             int* tiles_per_block, int* col_tiles, unsigned* grid) {
  *tiles_per_block = (block_size + bm - 1) / bm;
  *col_tiles = (n + bn - 1) / bn;
  const long long g = rows / block_size * *tiles_per_block * *col_tiles;
  *grid = (unsigned)g;
  return g <= 0x7fffffffLL;
}

template <bool kTrans>
int start_wgmma(const void* x, const void* w, const void* block_rel,
                void* out, long long rows, int k, int n, int num_rel,
                int block_size, cudaStream_t stream) {
  int tiles_per_block, col_tiles;
  unsigned grid;
  if (!grid_1d(rows, n, block_size, wg::kBM, wg::kBN, &tiles_per_block,
               &col_tiles, &grid))
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_x, map_w;
  const cuuint64_t x_dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t x_strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t x_box[2] = {wg::kBK, wg::kBM};
  // W as (R, outer, inner), inner contiguous: (R, k, n) forward, (R, n, k)
  // for d_msg; the relation is the outermost coordinate
  const cuuint64_t inner = kTrans ? k : n, outer = kTrans ? n : k;
  const cuuint64_t w_dims[3] = {inner, outer, (cuuint64_t)num_rel};
  const cuuint64_t w_strides[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t w_box[3] = {64, kTrans ? (cuuint32_t)wg::kBN : wg::kBK, 1};
  if (!hopper::encode_bf16(&map_x, x, 2, x_dims, x_strides, x_box) ||
      !hopper::encode_bf16(&map_w, w, 3, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  const auto kernel = wg::relmm_bf16_wgmma_kernel<kTrans>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  // one CTA per SM, each walking tiles until none is left
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid < (unsigned)sms ? grid : (unsigned)sms, wg::kThreads,
           wg::kSmemBytes, stream>>>(
      map_x, map_w, static_cast<const int32_t*>(block_rel),
      static_cast<__nv_bfloat16*>(out), k, n, num_rel, block_size,
      tiles_per_block, col_tiles, (int64_t)grid);
  return (int)cudaSuccess;
}

template <bool kTrans>
int start_simt(const void* x, const void* w, const void* block_rel,
               void* out, long long rows, int k, int n, int num_rel,
               int block_size, cudaStream_t stream) {
  int tiles_per_block, col_tiles;
  unsigned grid;
  if (!grid_1d(rows, n, block_size, simt::kBM, simt::kBN, &tiles_per_block,
               &col_tiles, &grid))
    return (int)cudaErrorInvalidConfiguration;
  simt::relmm_f32_simt_kernel<kTrans><<<grid, simt::kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int32_t*>(block_rel), static_cast<float*>(out), k, n,
      num_rel, block_size, tiles_per_block, col_tiles);
  return (int)cudaSuccess;
}

bool aligned16(const void* x, const void* w, const void* out) {
  return ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 == 0;
}

// The instance ops/relmm.py::relmm_instance picks for these widths and bases.
int default_instance(bool bf16, const void* x, const void* w, const void* out,
                     int k, int n) {
  if (bf16)
    return aligned16(x, w, out) && k > 0 && k % 8 == 0 && n % 8 == 0
               ? kWgmma
               : kWmmaGeneral;
  return aligned16(x, w, out) && n % 4 == 0 ? kSimt : kSimtGeneral;
}

int launch(int instance, const void* x, const void* w, const void* block_rel,
           void* out, long long rows, int k, int n, int num_rel,
           int block_size, int transpose, void* stream_handle) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  if (block_size <= 0 || rows % block_size) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const bool bf16 = instance == kWgmma || instance == kWmmaGeneral;
  if (num_rel <= 0)  // no relation: every row is zero
    return (int)cudaMemsetAsync(out, 0, rows * n * (bf16 ? 2 : 4), stream);
  if ((instance == kWgmma || instance == kSimt) &&
      default_instance(bf16, x, w, out, k, n) != instance)
    return (int)cudaErrorInvalidValue;
  int err;
  switch (instance) {
    case kWgmma:
      err = transpose ? start_wgmma<true>(x, w, block_rel, out, rows, k, n,
                                          num_rel, block_size, stream)
                      : start_wgmma<false>(x, w, block_rel, out, rows, k, n,
                                           num_rel, block_size, stream);
      break;
    case kSimt:
      err = transpose ? start_simt<true>(x, w, block_rel, out, rows, k, n,
                                         num_rel, block_size, stream)
                      : start_simt<false>(x, w, block_rel, out, rows, k, n,
                                          num_rel, block_size, stream);
      break;
    case kWmmaGeneral:
      err = start_general<__nv_bfloat16>(x, w, block_rel, out, rows, k, n,
                                         num_rel, block_size, transpose,
                                         stream);
      break;
    case kSimtGeneral:
      err = start_general<float>(x, w, block_rel, out, rows, k, n, num_rel,
                                 block_size, transpose, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return err != (int)cudaSuccess ? err : (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. x (rows, k); w (num_rel, k, n), or
// (num_rel, n, k) with transpose = 1; block_rel (rows / block_size,) int32;
// out (rows, n), every element written. Nothing is allocated and nothing
// synchronises. Each returns the cudaError_t of the launch (0 = success).
//
// relmm_launch runs the named instance (0 wmma_general, 1 wgmma,
// 2 simt_f32_general, 3 simt_f32; the instance sets the type, bf16 or
// float32) and refuses a redesigned one that cannot take these widths or
// bases; relmm_f32 and relmm_bf16 run the instance relmm_instance picks.
extern "C" int relmm_launch(const void* x, const void* w,
                            const void* block_rel, void* out, long long rows,
                            int k, int n, int num_rel, int block_size,
                            int transpose, void* stream, int instance) {
  return launch(instance, x, w, block_rel, out, rows, k, n, num_rel,
                block_size, transpose, stream);
}

extern "C" int relmm_f32(const void* x, const void* w, const void* block_rel,
                         void* out, long long rows, int k, int n, int num_rel,
                         int block_size, int transpose, void* stream) {
  return launch(default_instance(false, x, w, out, k, n), x, w, block_rel,
                out, rows, k, n, num_rel, block_size, transpose, stream);
}

extern "C" int relmm_bf16(const void* x, const void* w, const void* block_rel,
                          void* out, long long rows, int k, int n,
                          int num_rel, int block_size, int transpose,
                          void* stream) {
  return launch(default_instance(true, x, w, out, k, n), x, w, block_rel, out,
                rows, k, n, num_rel, block_size, transpose, stream);
}
