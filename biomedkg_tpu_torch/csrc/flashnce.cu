// Flash InfoNCE denominators for NVIDIA Hopper (sm_90a), forward and
// backward.
//
// For the L2-normalised projection tables an, bn (N, d) of GRACE's two
// views and the additive float32 column mask col (N,) (0 for a real node,
// -FLT_MAX for a pad):
//
//   inter[i, j] = an_i . bn_j / tau + col_j
//   intra[i, j] = an_i . an_j / tau + col_j,  intra[i, i] = -FLT_MAX
//   den[i]      = logsumexp_j concat(inter[i, :], intra[i, :])
//
// and, from the saved den and the cotangent g (N,), with the softmax
// cotangents gi = g_i exp(inter - den_i), gt = g_i exp(intra - den_i):
//
//   d_an[i] = (sum_j gi_ij bn_j + sum_j gt_ij an_j + sum_j gt_ji an_j) / tau
//   d_bn[j] =  sum_i gi_ij an_i / tau
//
// Replaces the TPU kernels of biomedkg_tpu/ops/pallas/flashnce.py:
// flash_denom's _denom_impl (pallas_call of _fwd_kernel) and _vjp_bwd
// (pallas_call of _bwd_rows_kernel and of _bwd_cols_kernel). The (N, N)
// logits never reach device memory, in either direction.
//
// Forward (fwd_kernel). A CTA owns 64 rows of an, kept in shared memory
// for the whole call. It streams 64-row tiles of bn and then of an through
// shared memory, computes each 64 x 64 logit tile, and folds it into a
// running max and sum of exponentials per row, held in registers by the
// four threads that share the row; den is written once. A ragged last tile
// is masked by index, so any N works; the diagonal of intra is masked by
// global row and column index.
//
// Backward (bwd_kernel): the flash split of the Pallas design into a rows
// side and a columns side, so that no output element is written by two
// CTAs and no atomics are needed (the result is deterministic). The three
// sums above are three "jobs", and a launch runs all three (blockIdx.y):
//   0 rows, inter: own an_o, streamed bn_s -> sum_s gi_os bn_s
//   1 intra:       own an_o, streamed an_s -> sum_s (gt_os + gt_so) an_s
//   2 cols, inter: own bn_o, streamed an_s -> sum_s gi_so an_s   (d_bn)
// Job 1 is both sides of the intra term at once: an_o . an_s is the logit
// at (o, s) and at (s, o), and both cotangents multiply an_s into row o.
// A job's CTA owns 64 rows of its own table, streams 64-row tiles of the
// other, rebuilds each logit tile (one product), turns it into softmax
// cotangents from the saved den and g, and accumulates their product with
// the streamed tile (the second product) into a 64 x d float32 block kept
// in registers: 6 N^2 d multiply-adds per backward, as many as a design
// that rebuilt both logit tiles once and wrote the column side with atomics
// (the alternative the Pallas comment names). The wrapper sums the jobs:
// d_an = job 0 + job 1, d_bn = job 2.
//
// Precision. float32 runs SIMT in full float32 (no TF32, ROADMAP.md hazard
// H1). bfloat16 feeds both products to the tensor cores (WMMA 16 x 16 x 16,
// float32 accumulators); the logits, max, sums, exp and den are float32
// (the forward's running sum across tiles a double), and the cotangents
// are rounded to bf16 only as operands of the second product (where the
// reference's XLA path rounds them, gcl_module.py:125-127). Any d up to
// kMaxD.
//
// Bound. At GRACE's path shape (N = 37,376, d = 256) a forward makes two
// N x N x d products, 1.43e12 operations: 21.3 ms on the float32 units at
// 67 TFLOP/s, 1.45 ms on the bf16 tensor cores, plus 2.8e9 exps; the
// backward needs at least six such products. Operations bound both;
// device-memory traffic is a few MB. What the design does about it: the
// own tile is read once per CTA and each streamed tile once per CTA pass,
// both products of a tile share its shared-memory copy, and the bf16
// instance runs on the tensor cores. Tiles move in 16-byte loads and
// stores; the float32 products read shared memory as float4 (a thread's
// 4 x 4 logits four k at a time, the backward's 4 x 16 block of d four
// cotangents at a time); the forward and the float32 backward (one CTA per
// SM) load the next streamed tile into registers while they work on this
// one, and the bf16 backward leaves that to the SM's other CTA. Per
// logit the epilogue spends a multiply by 1/tau and one __expf; the
// backward stages g, den and col of both tiles in shared memory. Not done
// yet: wgmma fed by TMA with a multi-stage ring, register-resident logits
// (no shared-memory round trip), and skipping tiles whose rows are all
// pads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;          // own rows per CTA = rows per streamed tile
constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr int kLdL = kRows + 4;    // float logit tile, leading dimension
constexpr int kLdW = kRows + 8;    // bf16 cotangent tile, leading dimension
constexpr float kNeg = -FLT_MAX;   // the reference's finfo(float32).min
constexpr int kJobs = 3;           // backward: rows-inter, intra, cols-inter

// leading dimension of a shared (64, dp) tile: float32 four pad columns
// (16-byte rows for the float4 loads along k; 16 rows at one k land on
// distinct banks, dp + 4 being 4 or 20 mod 32); bf16 a multiple of 8, as
// WMMA wants
template <typename T> __host__ __device__ int tile_ld(int dp);
template <> __host__ __device__ int tile_ld<float>(int dp) { return dp + 4; }
template <> __host__ __device__ int tile_ld<__nv_bfloat16>(int dp) {
  return dp + 8;
}

__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void zero(__nv_bfloat16& v) {
  v = __float2bfloat16(0.f);
}

// Rows [r0, r0 + 64) of the (n, d) matrix m into the shared tile s
// (64, dp), zero beyond n rows and d columns, one element per thread,
// neighbouring threads on neighbouring addresses: the path for a d that is
// no multiple of the 16-byte vector (TileLoader below takes the others).
template <typename T>
__device__ void load_tile(T* s, int ld, const T* __restrict__ m, int64_t r0,
                          int n, int d, int dp) {
  for (int i = threadIdx.x; i < kRows * dp; i += kThreads) {
    const int r = i / dp, c = i % dp;
    T v;
    zero(v);
    if (r0 + r < n && c < d) v = m[(r0 + r) * d + c];
    s[r * ld + c] = v;
  }
}

// A 64-row tile on its way from device memory to shared memory, in two
// halves so that the loads overlap the work on the previous tile: fetch()
// issues them into registers, store() writes the registers into the
// shared tile after the caller's barrier. With ``vec`` (d a multiple of
// the 16-byte vector, 16-byte aligned bases) a thread moves kRegs 16-byte
// vectors, a warp a contiguous stretch of the tile; otherwise fetch() only
// notes the tile and store() runs load_tile.
template <typename T>
struct TileLoader {
  static constexpr int kV = 16 / sizeof(T);
  static constexpr int kRegs = kRows * kMaxD / kV / kThreads;
  uint4 v[kRegs];
  const T* m;
  int64_t r0;

  __device__ __forceinline__ void fetch(const T* __restrict__ src,
                                        int64_t rows0, int n, int d, int dp,
                                        bool vec) {
    m = src;
    r0 = rows0;
    if (!vec) return;
    const int per_row = dp / kV;
#pragma unroll
    for (int t = 0; t < kRegs; ++t) {
      const int i = threadIdx.x + t * kThreads;
      const int r = i / per_row, c = (i % per_row) * kV;
      v[t] = make_uint4(0u, 0u, 0u, 0u);
      if (r < kRows && r0 + r < n && c < d)
        v[t] = *reinterpret_cast<const uint4*>(src + (r0 + r) * d + c);
    }
  }

  __device__ __forceinline__ void store(T* s, int ld, int n, int d, int dp,
                                        bool vec) const {
    if (!vec) {
      load_tile(s, ld, m, r0, n, d, dp);
      return;
    }
    const int per_row = dp / kV;
#pragma unroll
    for (int t = 0; t < kRegs; ++t) {
      const int i = threadIdx.x + t * kThreads;
      const int r = i / per_row, c = (i % per_row) * kV;
      if (r < kRows) *reinterpret_cast<uint4*>(s + r * ld + c) = v[t];
    }
  }
};

// ---- the logit tile ls = xs . zs^T (64 x 64, float32 sums) --------------

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// float32: 256 threads as 16 x 16, thread (ty, tx) owns rows ty + 16 i and
// columns tx + 16 j; it reads four k at a time as float4 (8 shared loads
// per 64 multiply-adds), still summing in k order
__device__ void logit_tile(const float* xs, const float* zs, int ld, int dp,
                           float* ls) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < dp; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(xs + (ty + 16 * i) * ld + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(zs + (tx + 16 * j) * ld + k);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(lane(a[i], q), lane(b[j], q), acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ls[(ty + 16 * i) * kLdL + tx + 16 * j] = acc[i][j];
}

// bf16: 8 warps as 4 x 2, warp (wm, wn) owns rows 16 wm and columns 32 wn
__device__ void logit_tile(const __nv_bfloat16* xs, const __nv_bfloat16* zs,
                           int ld, int dp, float* ls) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32, wm = warp % 4, wn = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k0 = 0; k0 < dp; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> a;
    wmma::load_matrix_sync(a, xs + wm * 16 * ld + k0, ld);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      // zs^T as a column-major (k, n) operand: element (k, n) at zs[n][k]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> b;
      wmma::load_matrix_sync(b, zs + (wn * 32 + jj * 16) * ld + k0, ld);
      wmma::mma_sync(acc[jj], a, b, acc[jj]);
    }
  }
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
    wmma::store_matrix_sync(ls + wm * 16 * kLdL + wn * 32 + jj * 16,
                            acc[jj], kLdL, wmma::mem_row_major);
}

// CTAs per SM: the float32 kernels' tiles take most of an SM's shared
// memory, so one; the bf16 ones fit two, and their registers are capped to
// let them (the backward's tensor-core accumulators alone are 64 a thread)
template <typename T> struct Occupancy {
  static constexpr int kMinBlocks = sizeof(T) == 2 ? 2 : 1;
};

// ---- forward --------------------------------------------------------------

// Folds one logit tile into the running (m, s) of row r = threadIdx.x / 4;
// the row's four threads take 16 columns each and agree after the shuffles.
// cv holds the thread's 16 columns' mask values, -inf beyond the last
// column (no term); the masks are -FLT_MAX, as in the reference, so
// exp(m - m_new) stays defined.
__device__ __forceinline__ void online_update(
    const float* ls, float& m, double& s, int64_t row, int64_t c0,
    const float (&cv)[16], float inv_tau, bool diag) {
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  float v[16];
  float mx = -INFINITY;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int c = part * 16 + q;
    float x = ls[r * kLdL + c] * inv_tau + cv[q];
    if (diag && c0 + c == row) x = kNeg;
    v[q] = x;
    mx = fmaxf(mx, x);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(m, mx);
  float t = 0.f;
#pragma unroll
  for (int q = 0; q < 16; ++q) t += __expf(v[q] - m_new);
  t += __shfl_xor_sync(0xffffffffu, t, 1);
  t += __shfl_xor_sync(0xffffffffu, t, 2);
  s = s * (double)expf(m - m_new) + (double)t;
  m = m_new;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Occupancy<T>::kMinBlocks)
    fwd_kernel(const T* __restrict__ an, const T* __restrict__ bn,
               const float* __restrict__ col, float* __restrict__ den, int n,
               int d, int dp, float tau, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = tile_ld<T>(dp);
  T* xs = reinterpret_cast<T*>(smem);
  T* zs = xs + kRows * ld;
  float* ls = reinterpret_cast<float*>(zs + kRows * ld);
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int64_t row = r0 + threadIdx.x / 4;
  // the streamed tiles in order: bn then an at each column tile c0; the
  // next one's loads are in flight while this one is worked on
  TileLoader<T> next;
  next.fetch(an, r0, n, d, dp, vec);
  next.store(xs, ld, n, d, dp, vec);
  next.fetch(bn, 0, n, d, dp, vec);
  // the running sum is a double: it takes one term per tile, about 1,200
  // at the path's N, and float32 would lose about sqrt(1,200) ulps
  float m = kNeg;
  double s = 0.0;
  const float inv_tau = 1.f / tau;
  for (int64_t c0 = 0; c0 < n; c0 += kRows) {
    float cv[16];  // this thread's 16 columns of the tile: their masks
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int64_t gc = c0 + (threadIdx.x % 4) * 16 + q;
      cv[q] = gc < n ? col[gc] : -INFINITY;
    }
    for (int intra = 0; intra < 2; ++intra) {
      __syncthreads();  // the previous tile's readers are done
      next.store(zs, ld, n, d, dp, vec);
      __syncthreads();
      if (!intra)
        next.fetch(an, c0, n, d, dp, vec);
      else if (c0 + kRows < n)
        next.fetch(bn, c0 + kRows, n, d, dp, vec);
      logit_tile(xs, zs, ld, dp, ls);
      __syncthreads();
      online_update(ls, m, s, row, c0, cv, inv_tau, intra);
    }
  }
  if (threadIdx.x % 4 == 0 && row < n) den[row] = m + logf((float)s);
}

// ---- backward -------------------------------------------------------------

// g, den and col of rows [r0, r0 + 64) into the shared vectors v (3, 64),
// zero beyond n.
__device__ __forceinline__ void load_vectors(
    float* v, int64_t r0, int n, const float* __restrict__ g,
    const float* __restrict__ den, const float* __restrict__ col) {
  if (threadIdx.x < kRows) {
    const int64_t i = r0 + threadIdx.x;
    const bool in = i < n;
    v[threadIdx.x] = in ? g[i] : 0.f;
    v[kRows + threadIdx.x] = in ? den[i] : 0.f;
    v[2 * kRows + threadIdx.x] = in ? col[i] : 0.f;
  }
}

// The cotangent of logit l between own row o = o0 + r and streamed row
// s = s0 + c; own and st are the shared (g, den, col) vectors of the own
// and the streamed tile. The rows term (o the row i, s the column j) is
// g_o exp(l / tau + col_s - den_o), the columns term the same with o and s
// swapped. Job 0 takes the rows term, job 2 the columns term, job 1 both
// (zero on the diagonal). Zero beyond the last streamed row.
__device__ __forceinline__ float cotangent(
    float l, int r, int c, int64_t o, int64_t s, int n, int job,
    const float* own, const float* st, float inv_tau) {
  if (s >= n || (job == 1 && o == s)) return 0.f;
  const float x = l * inv_tau;
  float w = 0.f;
  if (job != 2) w = own[r] * __expf(x + st[2 * kRows + c] - own[kRows + r]);
  if (job != 0) w += st[c] * __expf(x + own[2 * kRows + r] - st[kRows + c]);
  return w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Occupancy<T>::kMinBlocks)
    bwd_kernel(const T* __restrict__ an, const T* __restrict__ bn,
               const float* __restrict__ col, const float* __restrict__ den,
               const float* __restrict__ g, float* __restrict__ out, int n,
               int n64, int d, int dp, float tau, bool vec) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = tile_ld<T>(dp);
  T* xs = reinterpret_cast<T*>(smem);
  T* zs = xs + kRows * ld;
  float* ls = reinterpret_cast<float*>(zs + kRows * ld);
  const int job = blockIdx.y;
  const T* own = job == 2 ? bn : an;
  const T* streamed = job == 0 ? bn : an;
  const int64_t o0 = (int64_t)blockIdx.x * kRows;
  float* out_job = out + ((int64_t)job * n64 + o0) * dp;

  constexpr bool kF32 = sizeof(T) == 4;
  // float32 overlaps the next streamed tile's loads with the work on this
  // one (its only CTA on the SM would otherwise wait on them); bf16 leaves
  // that to the SM's other CTA and keeps the registers
  constexpr bool kOverlap = kF32;
  TileLoader<T> next;
  next.fetch(own, o0, n, d, dp, vec);
  next.store(xs, ld, n, d, dp, vec);
  if constexpr (kOverlap) next.fetch(streamed, 0, n, d, dp, vec);

  // float32: thread (ty, tx) owns rows ty + 16 i and the float4 columns
  // 4 tx + 64 q
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float4 acc[4][kMaxD / 64];
  // bf16: warp (wm, wh) owns rows 16 wm, columns 128 wh + 16 q
  const int warp = threadIdx.x / 32, wm = warp % 4, wh = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> frag[8];
  if constexpr (kF32) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < kMaxD / 64; ++q)
        acc[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) wmma::fill_fragment(frag[q], 0.f);
  }
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(ls + kRows * kLdL);
  float* own_v = reinterpret_cast<float*>(ws) + (kF32 ? 0 : kRows * kLdW / 2);
  float* st_v = own_v + 3 * kRows;
  load_vectors(own_v, o0, n, g, den, col);
  const float inv_tau = 1.f / tau;

  for (int64_t s0 = 0; s0 < n; s0 += kRows) {
    __syncthreads();
    if constexpr (!kOverlap) next.fetch(streamed, s0, n, d, dp, vec);
    next.store(zs, ld, n, d, dp, vec);
    load_vectors(st_v, s0, n, g, den, col);
    __syncthreads();
    if constexpr (kOverlap)
      if (s0 + kRows < n) next.fetch(streamed, s0 + kRows, n, d, dp, vec);
    logit_tile(xs, zs, ld, dp, ls);
    __syncthreads();
    // the cotangents: in place (float32) or rounded into ws (bf16)
#pragma unroll 4
    for (int e = threadIdx.x; e < kRows * kRows; e += kThreads) {
      const int r = e / kRows, c = e % kRows;
      const float w = cotangent(ls[r * kLdL + c], r, c, o0 + r, s0 + c, n,
                                job, own_v, st_v, inv_tau);
      if constexpr (kF32)
        ls[r * kLdL + c] = w;
      else
        ws[r * kLdW + c] = __float2bfloat16(w);
    }
    __syncthreads();
    if constexpr (kF32) {
      // four cotangents of a row and a float4 of the streamed row per
      // shared load (9 wavefronts per 64 multiply-adds a warp), in c order
      const float* zf = reinterpret_cast<const float*>(zs);
      for (int c = 0; c < kRows; c += 4) {
        float4 w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = *reinterpret_cast<const float4*>(ls + (ty + 16 * i) * kLdL
                                                  + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int q = 0; q < kMaxD / 64; ++q) {
            const int cz = 64 * q + 4 * tx;
            if (cz < dp) {
              const float4 z =
                  *reinterpret_cast<const float4*>(zf + (c + cc) * ld + cz);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float wi = lane(w[i], cc);
                acc[i][q].x = fmaf(wi, z.x, acc[i][q].x);
                acc[i][q].y = fmaf(wi, z.y, acc[i][q].y);
                acc[i][q].z = fmaf(wi, z.z, acc[i][q].z);
                acc[i][q].w = fmaf(wi, z.w, acc[i][q].w);
              }
            }
          }
        }
      }
    } else {
      // the warp's four cotangent fragments once, then its column blocks
      const __nv_bfloat16* zh = reinterpret_cast<const __nv_bfloat16*>(zs);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[kRows / 16];
#pragma unroll
      for (int k = 0; k < kRows / 16; ++k)
        wmma::load_matrix_sync(a[k], ws + wm * 16 * kLdW + 16 * k, kLdW);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = wh * 128 + q * 16;
        if (c < dp) {  // uniform over the warp
#pragma unroll
          for (int k = 0; k < kRows / 16; ++k) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> b;
            wmma::load_matrix_sync(b, zh + 16 * k * ld + c, ld);
            wmma::mma_sync(frag[q], a[k], b, frag[q]);
          }
        }
      }
    }
  }

  if constexpr (kF32) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < kMaxD / 64; ++q) {
        const int c = 64 * q + 4 * tx;
        if (c < dp) {
          const float4 a = acc[i][q];
          *reinterpret_cast<float4*>(out_job + (ty + 16 * i) * dp + c) =
              make_float4(a.x * inv_tau, a.y * inv_tau, a.z * inv_tau,
                          a.w * inv_tau);
        }
      }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = wh * 128 + q * 16;
      if (c < dp) {
        for (int t = 0; t < frag[q].num_elements; ++t) frag[q].x[t] *= inv_tau;
        wmma::store_matrix_sync(out_job + wm * 16 * dp + c, frag[q], dp,
                                wmma::mem_row_major);
      }
    }
  }
}

int round16(int d) { return (d + 15) / 16 * 16; }

// the own and streamed tiles, the float logit tile, and backward: the bf16
// cotangent tile and the own and streamed (g, den, col) vectors
template <typename T>
size_t smem_bytes(int dp, bool backward) {
  size_t bytes = 2 * (size_t)kRows * tile_ld<T>(dp) * sizeof(T) +
                 (size_t)kRows * kLdL * sizeof(float);
  if (backward) {
    if (sizeof(T) == 2) bytes += (size_t)kRows * kLdW * sizeof(__nv_bfloat16);
    bytes += 6 * kRows * sizeof(float);
  }
  return bytes;
}

template <typename T>
bool use_vec(const void* an, const void* bn, int d) {
  return d % TileLoader<T>::kV == 0 &&
         ((uintptr_t)an | (uintptr_t)bn) % 16 == 0;
}

// a kernel's dynamic shared memory, the whole carveout given to shared
// memory so that two bf16 CTAs fit on an SM
template <typename K>
cudaError_t set_smem(K* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch_fwd(const void* an, const void* bn, const void* col, void* den,
               int n, int d, float tau, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const int dp = round16(d);
  const size_t bytes = smem_bytes<T>(dp, false);
  const cudaError_t err = set_smem(fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + kRows - 1) / kRows);
  fwd_kernel<T><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      static_cast<const T*>(an), static_cast<const T*>(bn),
      static_cast<const float*>(col), static_cast<float*>(den), n, d, dp,
      tau, use_vec<T>(an, bn, d));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* an, const void* bn, const void* col,
               const void* den, const void* g, void* out, int n, int d,
               float tau, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const int dp = round16(d);
  const int n64 = (n + kRows - 1) / kRows * kRows;
  const size_t bytes = smem_bytes<T>(dp, true);
  const cudaError_t err = set_smem(bwd_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(n64 / kRows), kJobs);
  bwd_kernel<T><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      static_cast<const T*>(an), static_cast<const T*>(bn),
      static_cast<const float*>(col), static_cast<const float*>(den),
      static_cast<const float*>(g), static_cast<float*>(out), n, n64, d, dp,
      tau, use_vec<T>(an, bn, d));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. an, bn (n, d) contiguous, float32 or bf16
// by the function's name; col, den, g (n,) float32; d <= 256. Forward: den
// (n,) written. Backward: out (3, ceil(n / 64) * 64, round_up(d, 16))
// float32, every element written (job-major; rows past n and columns past
// d are padding the caller drops). Nothing is allocated and nothing
// synchronises. Returns the cudaError_t of the launch (0 = success).
extern "C" int flashnce_fwd_f32(const void* an, const void* bn,
                                const void* col, void* den, int n, int d,
                                float tau, void* stream) {
  return launch_fwd<float>(an, bn, col, den, n, d, tau, stream);
}

extern "C" int flashnce_fwd_bf16(const void* an, const void* bn,
                                 const void* col, void* den, int n, int d,
                                 float tau, void* stream) {
  return launch_fwd<__nv_bfloat16>(an, bn, col, den, n, d, tau, stream);
}

extern "C" int flashnce_bwd_f32(const void* an, const void* bn,
                                const void* col, const void* den,
                                const void* g, void* out, int n, int d,
                                float tau, void* stream) {
  return launch_bwd<float>(an, bn, col, den, g, out, n, d, tau, stream);
}

extern "C" int flashnce_bwd_bf16(const void* an, const void* bn,
                                 const void* col, const void* den,
                                 const void* g, void* out, int n, int d,
                                 float tau, void* stream) {
  return launch_bwd<__nv_bfloat16>(an, bn, col, den, g, out, n, d, tau,
                                   stream);
}
