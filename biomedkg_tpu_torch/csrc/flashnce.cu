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
// First design, forward (fwd_kernel). A CTA owns 64 rows of an, kept in
// shared memory for the whole call. It streams 64-row tiles of bn and then
// of an through shared memory, computes each 64 x 64 logit tile, and folds
// it into a running max and sum of exponentials per row, held in
// registers by the four threads that share the row; den is written once.
// A ragged last tile is masked by index, so any N works; the diagonal of
// intra is masked by global row and column index.
//
// First design, backward (bwd_kernel): the flash split of the Pallas
// design into a rows side and a columns side, so that no output element
// is written by two CTAs and no atomics are needed (the result is
// deterministic). The three sums above are three "jobs", and a launch runs
// all three (blockIdx.y):
//   0 rows, inter: own an_o, streamed bn_s -> sum_s gi_os bn_s
//   1 intra:       own an_o, streamed an_s -> sum_s (gt_os + gt_so) an_s
//   2 cols, inter: own bn_o, streamed an_s -> sum_s gi_so an_s   (d_bn)
// Job 1 is both sides of the intra term at once: an_o . an_s is the logit
// at (o, s) and at (s, o), and both cotangents multiply an_s into row o.
// A job's CTA owns 64 rows of its own table, streams 64-row tiles of the
// other, rebuilds each logit tile (one product), turns it into softmax
// cotangents from the saved den and g, and accumulates their product with
// the streamed tile (the second product) into a 64 x d float32 block kept
// in registers: 6 N^2 d multiply-adds per backward, where the function
// needs 5 (jobs 0 and 2 both rebuild the inter logits; a design that built
// them once would write the column side with atomics, the alternative the
// Pallas comment names). The wrapper sums the jobs: d_an = job 0 + job 1,
// d_bn = job 2.
//
// Precision. float32 runs SIMT in full float32 (no TF32, ROADMAP.md hazard
// H1). bfloat16 feeds both products to the tensor cores (WMMA 16 x 16 x 16,
// float32 accumulators); the logits, max, sums, exp and den are float32
// (the forward's running sum across tiles a double), and the cotangents
// are rounded to bf16 only as operands of the second product (where the
// reference's XLA path rounds them, gcl_module.py:125-127). Any d up to
// kMaxD.
//
// Pad tiles. The neighbour batch's pads hold col = -FLT_MAX, and a term
// whose column is a pad is exp(x - FLT_MAX - m) = 0 exactly, as is a
// cotangent term whose g is 0. The wrapper passes live flags (2, ceil(N /
// 64)) uint8 (ops/flashnce.py::live_tiles): row 0 "a real column in this
// 64-row tile", row 1 "a nonzero g in it", read from the data, never from
// where the pads lie. The skipping kernels leave out the tiles and tile
// pairs whose every term is such an exact 0: the forward a column tile
// with no real column; the backward's job 0 a pair whose own g or
// streamed columns are all 0 / pads, job 2 the same with own and streamed
// swapped, job 1 only when both of its terms are 0; an own tile with no
// live pair writes its zeros and exits. Where no column is real at all,
// every column tile counts as live (den is then -FLT_MAX itself, and a
// pad column's term exp(x - FLT_MAX - den) is 1, not 0).
//
// Designs (launch codes, ops/flashnce.py's DESIGNS):
//   0 first_f32   the first design in float32: 64 x 64 logit
//                 tiles through shared memory, every tile computed
//   1 first_bf16  the first design in bf16, every tile computed
//   2 skip_bf16   the first design in bf16 with the pad-tile skip; bitwise
//                 equal to first_bf16 (it leaves out adds of an exact 0)
//   3 wide_f32    the float32 redesign (namespace wide below), with the
//                 skip
//   4 wgmma_bf16  the bf16 redesign (namespace wg below), with the skip;
//                 for d a multiple of 8 and 16-byte aligned tables (TMA)
//   5 whole_f32   wide_f32 with its backward on one slot: every item
//                 whole, one CTA an item, nothing cut
// The path runs wide_f32 and wgmma_bf16 (ops/flashnce.py::flash_design;
// skip_bf16 where TMA cannot take the tables); the first designs,
// skip_bf16 and whole_f32 stay for the A/B in chip_smoke.py.
//
// Bound. At GRACE's path shape (N = 37,376, d = 256) a forward makes two
// N x N x d products, 1.43e12 operations: 21.3 ms on the float32 units at
// 67 TFLOP/s, 1.45 ms on the bf16 tensor cores, plus 2.8e9 exps; the
// backward needs five such products. Operations bound both, over
// the live tile pairs only; device-memory traffic is a few MB. The first
// design: the own tile is read once per CTA and each streamed tile once
// per CTA pass, both products of a tile share its shared-memory copy, and
// the bf16 instance runs on the tensor cores (WMMA); tiles move in 16-byte
// loads, the next streamed tile is loaded into registers while this one
// is worked on. What held its float32 instances back (29-33 % of the
// bound): one CTA of 8 warps per SM (two whole 64 x 260 tiles), a 4 x 4
// logit micro-tile, and a shared-memory round trip for every logit. The
// redesign (namespace wide): 8 x 8 and 8 x 4 register tiles fed by a
// cp.async ring, the logits and cotangents formed in registers, two CTAs
// per SM in the forward. The bf16 redesign (namespace wg): wgmma fed by
// TMA, the logits and cotangents in registers.

#include <cuda.h>  // CUtensorMap (the encoder comes through the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ---- live tiles -------------------------------------------------------------

// The live flags of 64-row tiles (flags row 0: a real column, row 1: a
// nonzero g). all_col: no tile has a real column, so every one counts as
// live (see the header). Every thread of the CTA must construct it.
struct Live {
  const uint8_t* col;
  const uint8_t* g;
  int tiles;
  bool all_col;

  // flags may be null where nothing is skipped (then c, gz, pair unused)
  __device__ Live(const uint8_t* flags, int t64)
      : col(flags), g(flags + t64), tiles(t64) {
    int any = flags == nullptr;
    for (int i = threadIdx.x; !any && i < t64; i += blockDim.x)
      any |= flags[i];
    all_col = !__syncthreads_or(any);
  }
  // 64-row tile t
  __device__ __forceinline__ bool c(int t) const {
    return t < tiles && (all_col || col[t]);
  }
  __device__ __forceinline__ bool gz(int t) const {
    return t < tiles && g[t];
  }
  // whether a backward pair holds a nonzero term, from the own rows'
  // flags (go, co) and the streamed rows' (gs, cs): job 0 the rows term
  // g_o exp(l + col_s - den_o), job 2 the columns term g_s exp(l + col_o -
  // den_s), job 1 either
  static __device__ __forceinline__ bool pair(int job, bool go, bool co,
                                              bool gs, bool cs) {
    const bool rows = go && cs, cols = gs && co;
    return job == 0 ? rows : job == 2 ? cols : (rows || cols);
  }
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

// kSkip: leave out the column tiles without a real column (flags).
template <typename T, bool kSkip>
__global__ void __launch_bounds__(kThreads, Occupancy<T>::kMinBlocks)
    fwd_kernel(const T* __restrict__ an, const T* __restrict__ bn,
               const float* __restrict__ col,
               const uint8_t* __restrict__ flags, float* __restrict__ den,
               int n, int d, int dp, float tau, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = tile_ld<T>(dp);
  T* xs = reinterpret_cast<T*>(smem);
  T* zs = xs + kRows * ld;
  float* ls = reinterpret_cast<float*>(zs + kRows * ld);
  const int64_t r0 = (int64_t)blockIdx.x * kRows;
  const int64_t row = r0 + threadIdx.x / 4;
  const Live live(kSkip ? flags : nullptr, (n + kRows - 1) / kRows);
  // the first live column tile at or after c
  auto live_from = [&](int64_t c) -> int64_t {
    if constexpr (kSkip) {
      while (c < n && !live.c((int)(c / kRows))) c += kRows;
    }
    return c;
  };
  // the streamed tiles in order: bn then an at each live column tile c0;
  // the next one's loads are in flight while this one is worked on
  TileLoader<T> next;
  next.fetch(an, r0, n, d, dp, vec);
  next.store(xs, ld, n, d, dp, vec);
  next.fetch(bn, live_from(0), n, d, dp, vec);
  // the running sum is a double: it takes one term per tile, about 1,200
  // at the path's N, and float32 would lose about sqrt(1,200) ulps
  float m = kNeg;
  double s = 0.0;
  const float inv_tau = 1.f / tau;
  for (int64_t c0 = live_from(0); c0 < n; c0 = live_from(c0 + kRows)) {
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
      if (!intra) {
        next.fetch(an, c0, n, d, dp, vec);
      } else {
        const int64_t c1 = live_from(c0 + kRows);
        if (c1 < n) next.fetch(bn, c1, n, d, dp, vec);
      }
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
// swapped. Job 0 takes the rows term, job 2 the columns term, job 1 both.
// The intra diagonal's logit is -FLT_MAX whatever its column mask, as in
// the reference: its terms are exp(-FLT_MAX - den) = 0 unless no column
// is real (den then -FLT_MAX too). Zero beyond the last streamed row.
__device__ __forceinline__ float cotangent(
    float l, int r, int c, int64_t o, int64_t s, int n, int job,
    const float* own, const float* st, float inv_tau) {
  if (s >= n) return 0.f;
  const float x = l * inv_tau;
  const bool diag = job == 1 && o == s;
  float w = 0.f;
  if (job != 2)
    w = own[r] *
        __expf((diag ? kNeg : x + st[2 * kRows + c]) - own[kRows + r]);
  if (job != 0)
    w += st[c] *
         __expf((diag ? kNeg : x + own[2 * kRows + r]) - st[kRows + c]);
  return w;
}

// kSkip: leave out the tile pairs whose terms are all 0 (flags); an own
// tile with none live writes its zeros and exits.
template <typename T, bool kSkip>
__global__ void __launch_bounds__(kThreads, Occupancy<T>::kMinBlocks)
    bwd_kernel(const T* __restrict__ an, const T* __restrict__ bn,
               const float* __restrict__ col, const float* __restrict__ den,
               const float* __restrict__ g,
               const uint8_t* __restrict__ flags, float* __restrict__ out,
               int n, int n64, int d, int dp, float tau, bool vec) {
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
  const Live live(kSkip ? flags : nullptr, n64 / kRows);
  // the first streamed tile at or after s that pairs with this own tile
  auto live_from = [&](int64_t s) -> int64_t {
    if constexpr (kSkip) {
      const int ot = blockIdx.x;
      while (s < n &&
             !Live::pair(job, live.gz(ot), live.c(ot),
                         live.gz((int)(s / kRows)), live.c((int)(s / kRows))))
        s += kRows;
    }
    return s;
  };
  const int64_t first = live_from(0);
  if (first >= n) {  // no live pair (kSkip only): zeros
    for (int i = threadIdx.x; i < kRows * dp / 4; i += kThreads)
      reinterpret_cast<float4*>(out_job)[i] = make_float4(0.f, 0.f, 0.f,
                                                          0.f);
    return;
  }

  constexpr bool kF32 = sizeof(T) == 4;
  // float32 overlaps the next streamed tile's loads with the work on this
  // one (its only CTA on the SM would otherwise wait on them); bf16 leaves
  // that to the SM's other CTA and keeps the registers
  constexpr bool kOverlap = kF32;
  TileLoader<T> next;
  next.fetch(own, o0, n, d, dp, vec);
  next.store(xs, ld, n, d, dp, vec);
  if constexpr (kOverlap) next.fetch(streamed, first, n, d, dp, vec);

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

  for (int64_t s0 = first; s0 < n; s0 = live_from(s0 + kRows)) {
    __syncthreads();
    if constexpr (!kOverlap) next.fetch(streamed, s0, n, d, dp, vec);
    next.store(zs, ld, n, d, dp, vec);
    load_vectors(st_v, s0, n, g, den, col);
    __syncthreads();
    if constexpr (kOverlap) {
      const int64_t s1 = live_from(s0 + kRows);
      if (s1 < n) next.fetch(streamed, s1, n, d, dp, vec);
    }
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

// ===== float32 redesign (wide_f32) ==========================================
//
// Both kernels are built on one register-tiled product, a logit tile
// L = own (128 x d) . streamed (kRowsB x d)^T: 256 threads as 16 x 16,
// thread (ty, tx) holding the logits of rows 4 ty + i, 64 + 4 ty + i
// (i < 4) and columns 4 tx + j (and 64 + 4 tx + j where kRowsB = 128) in
// registers. The d axis streams through a ring of kStages cp.async slots
// for both operands at once (8 k a slot, stored k-major so that a thread
// reads its rows and columns as float4: 4 shared loads per 64
// multiply-adds at 8 x 8, 3 per 32 at 8 x 4), so shared memory stays
// small. Pointers to a thread's rows are set once per tile, not per load.
//
// Forward (kRowsB = 128, 8 x 8 logits a thread, two CTAs per SM): the
// online max and sum over the tiles stay in the thread's registers (its 8
// columns of each row, a double sum as in the first design), and the 16
// threads of a row merge theirs with shuffles once, at the end: no logit
// passes through shared memory. A CTA takes one slice of the live column
// tiles of its 128 rows (blockIdx.y of `splits`, chosen so that the grid
// fills whole waves of the card); where splits > 1 each slice writes its
// (max, sum) per row to a workspace, and the slice that finishes last (a
// ticket per row tile) merges them in slice order, so the result does not
// depend on which finishes first.
//
// Backward (kRowsB = kSB = 64, 8 x 4 logits a thread, one CTA per SM):
// per live pair the cotangents are formed in the logit product's
// registers and staged once, transposed, as the cotangent tile of the
// second product, whose d axis is an 8 x 16 register accumulator a thread
// (rows as above, columns 64 q + 4 tx + j) fed by the streamed rows
// through the same ring (8 rows of d a slot, 16-byte copies). The ring
// runs on across phases and tiles: the next items' loads are in flight
// while this one is computed. The logit product, the cotangents and the
// second product are three loops, so that the logits' registers are free
// in the second product (one loop kept both alive and spilled). The three
// jobs and the output layout are the first design's: no atomics on
// output values, deterministic. The grid fills the card's last wave: the
// items (a job and an own tile) that fill whole waves run whole, one CTA
// each, and the rest are cut into slices of their live streamed tiles,
// merged in slice order (bwd_f32 below).
namespace wide {

constexpr int kO = 128;       // own rows per CTA
constexpr int kS = 128;       // streamed rows per tile
constexpr int kBK = 8;        // k (d, or streamed rows) per ring slot
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kLdA = kO + 4, kLdB = kS + 4, kLdW = kO + 4;
constexpr int kP1 = kBK * (kLdA + kLdB);  // floats of a product-1 slot
constexpr int kP2 = kBK * (kMaxD + 4);    // floats of a product-2 slot
constexpr int kFwdMinBlocks = 2, kBwdMinBlocks = 1;

using hopper::smem_u32;
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// row (or column) i of a thread's 8 in a 128-row tile, for t = ty (rows)
// or tx (columns): 4 t + i for i < 4, 64 + 4 t + i - 4 after
__device__ __forceinline__ int of8(int t, int i) {
  return 4 * t + (i & 3) + 64 * (i >> 2);
}

// A thread's rows of one operand tile for the product-1 loads: the
// address of its first row m0 = threadIdx.x / 8 at depth kk0 =
// threadIdx.x % 8, the other three 32 rows apart, and which of them lie
// inside the table (bit i: row m0 + 32 i).
struct Rows {
  const float* p;
  unsigned ok;
};

template <int kCount = 4>
__device__ __forceinline__ Rows rows_of(const float* m, int64_t r0, int n,
                                        int d) {
  const int m0 = threadIdx.x / kBK, kk0 = threadIdx.x % kBK;
  Rows r{m + (r0 + m0) * d + kk0, 0u};
#pragma unroll
  for (int i = 0; i < kCount; ++i)
    if (r0 + m0 + 32 * i < n) r.ok |= 1u << i;
  return r;
}

// One product-1 slot: k [k0, k0 + 8) of the 128 own rows into (8, kLdA)
// and of the kRowsB streamed rows into (8, kRowsB + 4), zero past the
// tables' rows and d columns (base: any valid address, read by none).
// Eight lanes read a row's 32 bytes; the stores land on 32 banks.
template <int kRowsB = kS>
__device__ __forceinline__ void load_p1(float* slot, Rows a, Rows b,
                                        const float* base, int k0, int d) {
  constexpr int kLd = kRowsB + 4;
  const int m0 = threadIdx.x / kBK, kk0 = threadIdx.x % kBK;
  const bool kin = k0 + kk0 < d;
  const int64_t step = (int64_t)32 * d;
  float* as = slot + kk0 * kLdA + m0;
  float* bs = slot + kBK * kLdA + kk0 * kLd + m0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool oka = kin && (a.ok >> i & 1u);
    cp4(as + 32 * i, oka ? a.p + i * step + k0 : base, oka);
  }
#pragma unroll
  for (int i = 0; i < kRowsB / 32; ++i) {
    const bool okb = kin && (b.ok >> i & 1u);
    cp4(bs + 32 * i, okb ? b.p + i * step + k0 : base, okb);
  }
}

// The 8 x (kRowsB / 16) logits of one product-1 slot, added in k order:
// rows as two float4 a k, columns as kRowsB / 64 float4 (4 or 3 shared
// loads per 64 or 32 multiply-adds).
template <int kRowsB = kS>
__device__ __forceinline__ void mma_p1(const float* slot,
                                       float (&l)[8][kRowsB / 16]) {
  constexpr int kLd = kRowsB + 4, kJ = kRowsB / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* a = slot + 4 * ty;
  const float* b = slot + kBK * kLdA + 4 * tx;
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kLdA);
    const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kLdA + 64);
    const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float y[kJ];
#pragma unroll
    for (int h = 0; h < kJ / 4; ++h) {
      const float4 v =
          *reinterpret_cast<const float4*>(b + kk * kLd + 64 * h);
      y[4 * h] = v.x;
      y[4 * h + 1] = v.y;
      y[4 * h + 2] = v.z;
      y[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) l[i][j] = fmaf(x[i], y[j], l[i][j]);
  }
}

// ---- forward ----------------------------------------------------------------

constexpr size_t kFwdSmem = (size_t)kStages * kP1 * sizeof(float);

__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
    fwd_f32(const float* __restrict__ an, const float* __restrict__ bn,
            const float* __restrict__ col, const uint8_t* __restrict__ flags,
            float* __restrict__ den, double* __restrict__ part_s,
            float* __restrict__ part_m, int* __restrict__ tickets, int n,
            int d, float tau) {
  extern __shared__ __align__(16) float ring[];
  __shared__ int last;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t o0 = (int64_t)blockIdx.x * kO;
  const int64_t rows = (int64_t)gridDim.x * kO;  // the workspace's rows
  const int splits = gridDim.y, p = blockIdx.y;
  const int tiles = (n + kS - 1) / kS;
  const Live live(flags, (n + 63) / 64);
  auto col_live = [&](int u) { return live.c(2 * u) || live.c(2 * u + 1); };
  auto live_from = [&](int u) {
    while (u < tiles && !col_live(u)) ++u;
    return u;
  };
  // this slice: the live column tiles of rank [lo, lo + count)
  int total = 0;
  for (int base = 0; base < tiles; base += kThreads)
    total += __syncthreads_count(base + tid < tiles &&
                                 col_live(base + tid));
  const int lo = (int)((int64_t)total * p / splits);
  const int count = (int)((int64_t)total * (p + 1) / splits) - lo;
  int u0 = live_from(0);
  for (int k = 0; k < lo; ++k) u0 = live_from(u0 + 1);

  // the ring's items: per tile, k1 slots of (an, bn) then k1 of (an, an)
  const int k1 = (d + kBK - 1) / kBK;
  const Rows own = rows_of(an, o0, n, d);
  int pu = u0, pk = 0, pi = 0, pk0 = 0;  // producer: tile, rank, item, k
  Rows st = rows_of(bn, (int64_t)pu * kS, n, d);
  auto issue = [&](int slot) {
    if (pk < count) {
      load_p1(ring + slot * kP1, own, st, an, pk0, d);
      pk0 += kBK;
      if (++pi == k1) {  // the tile's intra half: an's rows
        pk0 = 0;
        st = rows_of(an, (int64_t)pu * kS, n, d);
      } else if (pi == 2 * k1) {
        pi = pk0 = 0;
        ++pk;
        pu = live_from(pu + 1);
        st = rows_of(bn, (int64_t)pu * kS, n, d);
      }
    }
    commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // the running max and sum of this thread's rows over its columns
  float m[8];
  double sum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    sum[i] = 0.0;
  }
  const float inv_tau = 1.f / tau;
  int slot = 0;
  for (int t = 0, u = u0; t < count; ++t, u = live_from(u + 1)) {
    const int64_t s0 = (int64_t)u * kS;
    for (int intra = 0; intra < 2; ++intra) {
      float l[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) l[i][j] = 0.f;
      for (int kt = 0; kt < k1; ++kt) {
        wait_ring();
        __syncthreads();
        issue((slot + kStages - 1) % kStages);
        mma_p1(ring + slot * kP1, l);
        slot = (slot + 1) % kStages;
      }
      float cv[8];  // this thread's columns' masks, -inf past the last
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t c = s0 + of8(tx, j);
        cv[j] = c < n ? __ldg(col + c) : -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t row = o0 + of8(ty, i);
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x = l[i][j] * inv_tau + cv[j];
          if (intra && s0 + of8(tx, j) == row) x = kNeg;
          l[i][j] = x;
          mx = fmaxf(mx, x);
        }
        const float m_new = fmaxf(m[i], mx);
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) e += __expf(l[i][j] - m_new);
        sum[i] = sum[i] * (double)expf(m[i] - m_new) + (double)e;
        m[i] = m_new;
      }
    }
  }
  wait_all();

  // merge the 16 threads of each row (the warp's other 16 lanes hold other
  // rows); both lanes of a pair compute the same sum
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int w = 1; w < 16; w *= 2) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], w);
      const double so = __shfl_xor_sync(0xffffffffu, sum[i], w);
      const float mn = fmaxf(m[i], mo);
      sum[i] = sum[i] * (double)expf(m[i] - mn) + so * (double)expf(mo - mn);
      m[i] = mn;
    }
  if (splits == 1) {
    if (tx == 0)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t row = o0 + of8(ty, i);
        if (row < n) den[row] = m[i] + logf((float)sum[i]);
      }
    return;
  }
  if (tx == 0)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t at = p * rows + o0 + of8(ty, i);
      part_m[at] = m[i];
      part_s[at] = sum[i];
    }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int64_t row = o0 + tid;
  if (tid < kO && row < n) {
    float mx = kNeg;
    for (int q = 0; q < splits; ++q)
      mx = fmaxf(mx, __ldcg(part_m + q * rows + row));
    double total_s = 0.0;
    for (int q = 0; q < splits; ++q)
      total_s += __ldcg(part_s + q * rows + row) *
                 (double)expf(__ldcg(part_m + q * rows + row) - mx);
    den[row] = mx + logf((float)total_s);
  }
}

// ---- backward ---------------------------------------------------------------

constexpr int kSB = 64;  // the backward's streamed rows per tile
// dynamic shared memory: the ring (product-2 slots are the larger), the
// cotangent tile (transposed: a streamed row's 128 own rows together),
// the own and the streamed (g, den, col)
constexpr size_t kBwdSmem =
    ((size_t)kStages * kP2 + kSB * kLdW + 3 * kO + 3 * kSB) * sizeof(float);

// The index of the rank-th (from 0) i < count with pred(i), or count where
// there are fewer; every thread of the CTA calls it and gets the answer.
template <typename P>
__device__ int nth(int count, int rank, P pred) {
  __shared__ int per_warp[kThreads / 32], found;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int base = 0; base < count; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool hit = i < count && pred(i);
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) per_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = __popc(ballot & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      before += w < warp ? per_warp[w] : 0;
      total += per_warp[w];
    }
    if (hit && before == rank) found = i;
    __syncthreads();
    if (rank < total) return found;
    rank -= total;
  }
  return count;
}

// The backward's items: a job and a 128-row own tile, item i = job *
// owns + own tile (the order of the grid of one CTA an item). An item's
// live pairs (Live::pair) are its streamed tiles with a real column (c of
// them), with a nonzero g (g) or with either (cg), by what its own tile
// holds, so that every thread counts any item's from three sums. Every
// thread of the CTA must construct it.
struct BwdItems {
  Live live;
  int owns, c, g, cg;

  __device__ BwdItems(const uint8_t* flags, int n64)
      : live(flags, n64 / kSB), owns((n64 + kO - 1) / kO), c(0), g(0),
        cg(0) {
    for (int base = 0; base < live.tiles; base += kThreads) {
      const int u = base + threadIdx.x;
      const bool cu = live.c(u), gu = live.gz(u);
      c += __syncthreads_count(cu);
      g += __syncthreads_count(gu);
      cg += __syncthreads_count(cu || gu);
    }
  }
  __device__ __forceinline__ int total() const { return kJobs * owns; }
  __device__ __forceinline__ bool go(int ot) const {
    return live.gz(2 * ot) || live.gz(2 * ot + 1);
  }
  __device__ __forceinline__ bool co(int ot) const {
    return live.c(2 * ot) || live.c(2 * ot + 1);
  }
  // the live pairs of item i
  __device__ __forceinline__ int pairs(int i) const {
    const int job = i / owns, ot = i % owns;
    const bool rows = go(ot), cols = co(ot);
    if (job == 0) return rows ? c : 0;
    if (job == 2) return cols ? g : 0;
    return rows && cols ? cg : rows ? c : cols ? g : 0;
  }
};

// Streamed tiles [lo, lo + count) of item i's live pairs, in their order:
// acc = sum over them of the cotangents times the streamed rows, stored
// times `scale` to the (128, dp) block at dst (its first `rows` rows).
__device__ __forceinline__ void bwd_item(
    const float* __restrict__ an, const float* __restrict__ bn,
    const float* __restrict__ col, const float* __restrict__ den,
    const float* __restrict__ g, const BwdItems& items, int i, int lo,
    int count, float* __restrict__ dst, int rows, float scale, int n, int d,
    int dp, float tau, bool vec, float* sm) {
  float* ring = sm;
  float* wt = ring + kStages * kP2;
  float* ov = wt + kSB * kLdW;
  float* sv = ov + 3 * kO;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int job = i / items.owns, ot = i % items.owns;
  const float* own = job == 2 ? bn : an;
  const float* st = job == 0 ? bn : an;
  const int64_t o0 = (int64_t)ot * kO;
  const Live& live = items.live;
  const int tiles = live.tiles;
  const bool go = items.go(ot), co = items.co(ot);
  auto is_live = [&](int u) {
    return Live::pair(job, go, co, live.gz(u), live.c(u));
  };
  auto live_from = [&](int u) {
    while (u < tiles && !is_live(u)) ++u;
    return u;
  };
  const int first = nth(tiles, lo, is_live);
  if (tid < kO) {
    const int64_t r = o0 + tid;
    const bool in = r < n;
    ov[tid] = in ? g[r] : 0.f;
    ov[kO + tid] = in ? den[r] : 0.f;
    ov[2 * kO + tid] = in ? col[r] : 0.f;
  }

  // the ring's items: per tile, k1 product-1 slots, then kSB / kBK
  // product-2 slots of 8 streamed rows by dp
  const int k1 = (d + kBK - 1) / kBK, per_tile = k1 + kSB / kBK;
  const int ldz = dp + 4;
  const Rows own_rows = rows_of(own, o0, n, d);
  int pu = first, pk = 0, pi = 0;  // producer: tile, its rank, item
  Rows st_rows = rows_of<kSB / 32>(st, (int64_t)pu * kSB, n, d);
  auto issue = [&](int slot) {
    if (pk < count) {
      float* sl = ring + slot * kP2;
      if (pi < k1) {
        load_p1<kSB>(sl, own_rows, st_rows, st, pi * kBK, d);
      } else {
        const int64_t r0 = (int64_t)pu * kSB + (int64_t)(pi - k1) * kBK;
        if (vec) {
          const int per_row = dp / 4;
          for (int e = tid; e < kBK * per_row; e += kThreads) {
            const int r = e / per_row, c = (e % per_row) * 4;
            const bool ok = r0 + r < n && c < d;
            cp16(sl + r * ldz + c, ok ? st + (r0 + r) * d + c : st, ok);
          }
        } else {
          for (int e = tid; e < kBK * dp; e += kThreads) {
            const int r = e / dp, c = e % dp;
            const bool ok = r0 + r < n && c < d;
            cp4(sl + r * ldz + c, ok ? st + (r0 + r) * d + c : st, ok);
          }
        }
      }
      if (++pi == per_tile) {
        pi = 0;
        ++pk;
        pu = live_from(pu + 1);
        st_rows = rows_of<kSB / 32>(st, (int64_t)pu * kSB, n, d);
      }
    }
    commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float4 acc[8][4];  // rows of8(ty, i), columns 64 q + 4 tx + (0..3)
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float inv_tau = 1.f / tau;
  int slot = 0;
  // the next ring slot: waits until it has landed for every thread
  // and the slot the next load overwrites is read by none, issues
  // that load
  auto next_slot = [&]() {
    wait_ring();
    __syncthreads();
    issue((slot + kStages - 1) % kStages);
    const float* sl = ring + slot * kP2;
    slot = (slot + 1) % kStages;
    return sl;
  };
  for (int t = 0, u = first; t < count; ++t, u = live_from(u + 1)) {
    const int64_t s0 = (int64_t)u * kSB;
    // the streamed (g, den, col); the previous tile's readers passed the
    // barrier after its cotangents
    if (tid < kSB) {
      const int64_t r = s0 + tid;
      const bool in = r < n;
      sv[tid] = in ? g[r] : 0.f;
      sv[kSB + tid] = in ? den[r] : 0.f;
      sv[2 * kSB + tid] = in ? col[r] : 0.f;
    }
    float l[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) l[i][j] = 0.f;
    for (int it = 0; it < k1; ++it) mma_p1<kSB>(next_slot(), l);
    // the cotangents of the rows and columns this thread holds
    // (rows of8(ty, i), columns 4 tx + j), staged transposed for
    // the second product
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = of8(ty, i);
      const int64_t o = o0 + r;
      const float g_o = ov[r], den_o = ov[kO + r];
      const float col_o = ov[2 * kO + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tx + j;
        const int64_t s = s0 + c;
        const float x = l[i][j] * inv_tau;
        const bool diag = job == 1 && o == s;  // see cotangent()
        float w = 0.f;
        if (job != 2)
          w = g_o * __expf((diag ? kNeg : x + sv[2 * kSB + c]) - den_o);
        if (job != 0)
          w += sv[c] * __expf((diag ? kNeg : x + col_o) - sv[kSB + c]);
        if (s >= n || o >= n) w = 0.f;
        l[i][j] = w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* wr = wt + (4 * tx + j) * kLdW + 4 * ty;
      *reinterpret_cast<float4*>(wr) =
          make_float4(l[0][j], l[1][j], l[2][j], l[3][j]);
      *reinterpret_cast<float4*>(wr + 64) =
          make_float4(l[4][j], l[5][j], l[6][j], l[7][j]);
    }
    __syncthreads();
    for (int it = k1; it < per_tile; ++it) {
      const float* sl = next_slot();
      // 8 streamed rows: acc += w[:, rows] . z[rows, :], in row order;
      // all four column blocks, also past dp (inside the shared
      // allocation, never stored): no branch between loads and products
      const float* wr = wt + (it - k1) * kBK * kLdW + 4 * ty;
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 w0 = *reinterpret_cast<const float4*>(wr + kk * kLdW);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wr + kk * kLdW + 64);
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float* zr = sl + kk * ldz + 4 * tx;
        float4 z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          z[q] = *reinterpret_cast<const float4*>(zr + 64 * q);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[i][q].x = fmaf(w[i], z[q].x, acc[i][q].x);
            acc[i][q].y = fmaf(w[i], z[q].y, acc[i][q].y);
            acc[i][q].z = fmaf(w[i], z[q].z, acc[i][q].z);
            acc[i][q].w = fmaf(w[i], z[q].w, acc[i][q].w);
          }
      }
    }
  }
  wait_all();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = of8(ty, i);
    if (r >= rows) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 64 * q + 4 * tx;
      if (c < dp) {
        const float4 a = acc[i][q];
        *reinterpret_cast<float4*>(dst + (int64_t)r * dp + c) =
            make_float4(a.x * scale, a.y * scale, a.z * scale,
                        a.w * scale);
      }
    }
  }
}

// item i's block of the output (job-major, (3, n64, dp)) and its rows
__device__ __forceinline__ float* item_block(float* out, const BwdItems& it,
                                             int i, int n64, int dp,
                                             int* rows) {
  const int job = i / it.owns, ot = i % it.owns;
  const int64_t o0 = (int64_t)ot * kO;
  *rows = (int)(n64 - o0 < kO ? n64 - o0 : kO);
  return out + ((int64_t)job * n64 + o0) * dp;
}

__device__ __forceinline__ void zero_block(float* dst, int rows, int dp) {
  for (int i = threadIdx.x; i < rows * dp / 4; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The backward on a grid that fills the card's last wave. L items have a
// live pair, of W = `slots` CTAs resident at once. The grid's CTAs are
// units, dispatched in order:
//   - the dead items' (no live pair) zeros;
//   - the first L - r items run whole, r = L mod W, one CTA each (the
//     whole waves);
//   - the last r items' slices: W units, per = W / r for each item and
//     one more for the first W mod r, each a contiguous run of the item's
//     live streamed tiles (k = min(those units, its live tiles) slices;
//     units past k exit). Slice p of cut item j writes its unscaled block
//     to the workspace at unit s = its first unit s0 + p, and the slice
//     that takes the item's ticket last adds the k blocks in slice order
//     and writes the item's rows: the result does not depend on which
//     finishes first;
//   - the grid's remaining units (it has 3 * owns + W) exit.
// With W = 1 nothing is cut: one CTA an item (design whole_f32).
// The plan is read from the flags by every CTA (no host read of L);
// ops/flashnce.py::bwd_plan is its model on the host. tally, where given,
// gets (L, r, the slices run) added.
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
    bwd_f32(const float* __restrict__ an, const float* __restrict__ bn,
            const float* __restrict__ col, const float* __restrict__ den,
            const float* __restrict__ g, const uint8_t* __restrict__ flags,
            float* __restrict__ out, float* __restrict__ part,
            int* __restrict__ tickets,
            unsigned long long* __restrict__ tally, int slots, int n,
            int n64, int d, int dp, float tau, bool vec) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int last;
  const BwdItems items(flags, n64);
  const int total = items.total();
  int live = 0;
  for (int base = 0; base < total; base += kThreads)
    live += __syncthreads_count(base + threadIdx.x < total &&
                                items.pairs(base + threadIdx.x) > 0);
  const int dead = total - live, cut = live % slots, whole = live - cut;
  auto is_live = [&](int i) { return items.pairs(i) > 0; };
  const int b = blockIdx.x;
  if (b == 0 && threadIdx.x == 0 && tally != nullptr) {
    atomicAdd(tally, (unsigned long long)live);
    atomicAdd(tally + 1, (unsigned long long)cut);
  }
  int rows;
  if (b < dead) {
    const int i = nth(total, b, [&](int x) { return !is_live(x); });
    zero_block(item_block(out, items, i, n64, dp, &rows), rows, dp);
    return;
  }
  const float inv_tau = 1.f / tau;
  if (b < dead + whole) {
    const int i = nth(total, b - dead, is_live);
    float* dst = item_block(out, items, i, n64, dp, &rows);
    bwd_item(an, bn, col, den, g, items, i, 0, items.pairs(i), dst, rows,
             inv_tau, n, d, dp, tau, vec, sm);
    return;
  }
  const int s = b - dead - whole;
  if (cut == 0 || s >= slots) return;
  const int per = slots / cut, extra = slots % cut;
  int j, p, units;
  if (s < extra * (per + 1)) {
    j = s / (per + 1), p = s % (per + 1), units = per + 1;
  } else {
    const int t = s - extra * (per + 1);
    j = extra + t / per, p = t % per, units = per;
  }
  const int i = nth(total, whole + j, is_live);
  const int pairs = items.pairs(i);
  const int k = units < pairs ? units : pairs;
  if (p >= k) return;
  if (p == 0 && threadIdx.x == 0 && tally != nullptr)
    atomicAdd(tally + 2, (unsigned long long)k);
  const int lo = (int)((int64_t)pairs * p / k);
  const int count = (int)((int64_t)pairs * (p + 1) / k) - lo;
  float* dst = item_block(out, items, i, n64, dp, &rows);
  const int64_t block = (int64_t)kO * dp;  // floats of a slice's block
  bwd_item(an, bn, col, den, g, items, i, lo, count, part + s * block, rows,
           1.f, n, d, dp, tau, vec, sm);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + j, 1) == k - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float4* parts =
      reinterpret_cast<const float4*>(part + (s - p) * block);
  for (int e = threadIdx.x; e < rows * dp / 4; e += kThreads) {
    float4 v = __ldcg(parts + e);
    for (int q = 1; q < k; ++q) {
      const float4 w = __ldcg(parts + q * (block / 4) + e);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    reinterpret_cast<float4*>(dst)[e] =
        make_float4(v.x * inv_tau, v.y * inv_tau, v.z * inv_tau,
                    v.w * inv_tau);
  }
}

}  // namespace wide

// ===== bf16 redesign (wgmma_bf16) ===========================================
//
// Both kernels are warp-specialised: warpgroups 0 and 1 consume, warpgroup
// 2's first warp produces. The producer reads every tile by TMA (one box
// of rows x 64 columns per 128-byte swizzled panel, four panels at d =
// 256; rows and columns past the table come in as zeros) into a ring of
// stages with a full and an empty mbarrier each, and writes beside each
// tile the streamed rows' vectors (col; backward also g and den), which
// hold 0 and -inf past the last row, so that those logits are masked by
// global index and col is never read past N. A CTA owns 128 rows (its own
// tile, loaded once), 64 per consumer warpgroup, and each warpgroup runs
// wgmma on its 64 rows against the streamed tiles, float32 accumulators in
// registers. One swizzled copy of a streamed tile serves both products: as
// a K-major B it gives the logits own . streamed^T (K = d), as an N-major B
// the backward's cotangents . streamed (K = the streamed rows, N = d).
//
// Forward (128 streamed rows a tile, a ring of 2): per live column tile of
// 128 (either 64-row half live), bn's tile then an's; the 64 x 128 logit
// tile (64 registers a thread) is scaled, masked and folded into a running
// max and sum per row in the registers that hold it, as wide_f32 does
// (the thread's 32 columns of its two rows; the quad merges once at the
// end). The slices and the ticket merge of wide_f32's forward fill the
// last wave (FlashForward.splits).
//
// Backward (64 streamed rows a tile, a ring of 4): the three jobs of the
// first design, without atomics. Per live pair (the own 128 rows' flags
// against the streamed 64's, as wide_f32), the 64 x 64 logit tile (32
// registers) becomes the softmax cotangents in place; they are rounded to
// bf16 and passed from registers as the A operand of the second wgmma
// (m64n256k16: the accumulator fragment of m64n64 is the A fragment of
// four k16 steps, no shuffle), whose 64 x 256 float32 output block (128
// registers a thread) stays in the accumulators across the whole stream.
// The second product is 256 wide whatever d: a stage's panels past d are
// zeroed once and never loaded.
//
// Registers: one CTA per SM, 168 registers a thread at launch; the producer
// keeps 40 and the consumers take 232 (128 x 40 + 256 x 232 <= 65,536).
// Shared memory: the own tile 64 KB and the ring, 128 KB either way.
//
// What bounds them (an H100 at GRACE's shape, PERF.md): clock64 probes
// inside both kernels show the tensor cores idle while the warpgroups fold
// the logits (forward) or form the cotangents (backward): both warpgroups
// do it at the same time, and the fold is about the exps' cost on the
// special-function units. A warpgroup alone issues its wgmma at 62 % of the
// SM's rate, two together at 93 %, so turns trade the fold's overlap for
// slower products. These did not shorten either kernel: the two
// warpgroups taking turns to issue
// (FlashAttention-3's ping-pong), the forward's own rows as register A
// fragments with a third stage, a backward turn issuing one tile's second
// product with the next tile's logits, and TMA multicast of the streamed
// tiles to a cluster of two CTAs (slower: the pair waits on each other).
// Keep every wgmma outside branches that ptxas cannot prove uniform: it
// serialises them there (C7520).
namespace wg {

using namespace hopper;

constexpr int kThreads = 384;      // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kO = 128;            // own rows per CTA
constexpr int kFS = 128;           // forward: streamed rows per tile
constexpr int kBS = 64;            // backward: streamed rows per tile
constexpr int kFwdStages = 2, kBwdStages = 4;
constexpr int kPanel = 64;         // bf16 columns of one 128-byte panel
constexpr int kPanels = kMaxD / kPanel;
constexpr int kRowBytes = 128;     // one row of a panel
constexpr int kOwnBytes = kPanels * kO * kRowBytes;
constexpr int kFwdTile = kPanels * kFS * kRowBytes;
constexpr int kBwdTile = kPanels * kBS * kRowBytes;
constexpr int kFwdVec = kFS;       // floats beside a forward tile: col
constexpr int kBwdVec = 3 * kBS;   // beside a backward tile: g, den, col

// the own tile, the ring's tiles and vectors, the barriers (full and empty
// per stage, the own tile's), and 1024 bytes to align the tiles (the
// 128-byte swizzle repeats every 1024)
constexpr size_t smem_bytes(int stages, int tile, int vec) {
  return 1024 + kOwnBytes + (size_t)stages * (tile + vec * sizeof(float)) +
         (2 * stages + 1) * 8;
}
constexpr size_t kFwdSmem = smem_bytes(kFwdStages, kFwdTile, kFwdVec);
constexpr size_t kBwdSmem = smem_bytes(kBwdStages, kBwdTile, kBwdVec);

// Rows [r0, r0 + rows) of a table into the tile at dst: one box per panel,
// each panel rows x 128 bytes.
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int panels, int rows,
                                          int64_t r0) {
  for (int p = 0; p < panels; ++p)
    tma_load_2d(dst + p * rows * kRowBytes, map, bar, p * kPanel, (int)r0);
}

// Keep the compiler from moving register reads or writes across the
// asynchronous wgmma (after its wait: the registers are settled here).
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the 256 consumer threads only (the producer warps have left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory,
// both K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
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
      "%64, %65, p, 1, 1, 0, 0;\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory,
// both K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 256] += A[64 x 16] B[16 x 256], A from registers (the bf16 pairs
// a[0..3] of the m64k16 fragment), B from shared memory N-major.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The shared memory of a kernel with kStages stages of kTile bytes and
// kVec floats each, from its 1024-byte aligned base: the own tile, the
// ring's tiles, the ring's vectors, the barriers.
template <int kStages, int kTile, int kVec>
struct Layout {
  uint8_t* raw;  // the generic address of `own`
  uint32_t own, bars;
  __device__ explicit Layout(uint8_t* smem) {
    const uint32_t at = smem_u32(smem);
    own = (at + 1023) & ~1023u;
    raw = smem + (own - at);
    bars = own + kOwnBytes + kStages * (kTile + kVec * 4);
  }
  __device__ uint32_t tile(int s) const { return own + kOwnBytes + s * kTile; }
  __device__ float* vec(int s) const {
    return reinterpret_cast<float*>(raw + kOwnBytes + kStages * kTile) +
           s * kVec;
  }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (kStages + s); }
  __device__ uint32_t own_bar() const { return bars + 16 * kStages; }
  // thread 0: a full barrier waits for the producer warp's 32 lanes and
  // the tile's bytes, an empty one for the consumers' 8 warps
  __device__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_init(own_bar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// The ring position of the it-th tile: its stage and the parity of its
// round.
template <int kStages>
struct Slot {
  int s;
  uint32_t parity;
  __device__ explicit Slot(int it) : s(it % kStages), parity((it / kStages) & 1) {}
};


// ---- forward ----------------------------------------------------------------

// Folds one 64 x 128 logit tile into the running max and sum of this
// thread's two rows (acc[4 i + 2 j + c]: local row rl + 8 j of the own
// tile, column 8 i + 2 q + c of the streamed tile): scaled by 1 / tau, the
// column masks cv added (-inf past the last column), with kDiag the
// diagonal (local row == local column: the streamed tile is the own one)
// at -FLT_MAX. Partial maxima and sums two a row, for the latency.
template <bool kDiag>
__device__ __forceinline__ void fold(float (&acc)[64], const float* cv, int rl,
                                     int q, float inv_tau, float (&m)[2],
                                     double (&sum)[2]) {
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float2 c2 = *reinterpret_cast<const float2*>(cv + 8 * i + 2 * q);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = acc[4 * i + 2 * j + c];
        x = x * inv_tau + (c ? c2.y : c2.x);
        if (kDiag && 8 * i + 2 * q + c == rl + 8 * j) x = kNeg;
        mx[j][c] = fmaxf(mx[j][c], x);
      }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float m_new = fmaxf(m[j], fmaxf(mx[j][0], mx[j][1]));
    float e[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) e[c] += __expf(acc[4 * i + 2 * j + c] - m_new);
    sum[j] = sum[j] * (double)expf(m[j] - m_new) + (double)(e[0] + e[1]);
    m[j] = m_new;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fwd_bf16(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b,
             const float* __restrict__ col, const uint8_t* __restrict__ flags,
             float* __restrict__ den, double* __restrict__ part_s,
             float* __restrict__ part_m, int* __restrict__ tickets, int n,
             int d, float tau) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last;
  const Layout<kFwdStages, kFwdTile, kFwdVec> sm(smem_raw);
  const int tid = threadIdx.x;
  const int64_t o0 = (int64_t)blockIdx.x * kO;
  const int64_t rows = (int64_t)gridDim.x * kO;  // the workspace's rows
  const int splits = gridDim.y, p = blockIdx.y;
  const int tiles = (n + kFS - 1) / kFS;
  const Live live(flags, (n + 63) / 64);
  auto col_live = [&](int u) { return live.c(2 * u) || live.c(2 * u + 1); };
  auto live_from = [&](int u) {
    while (u < tiles && !col_live(u)) ++u;
    return u;
  };
  // this slice: the live column tiles of rank [lo, lo + count)
  int total = 0;
  for (int base = 0; base < tiles; base += kThreads)
    total += __syncthreads_count(base + tid < tiles && col_live(base + tid));
  const int lo = (int)((int64_t)total * p / splits);
  const int count = (int)((int64_t)total * (p + 1) / splits) - lo;
  int u0 = live_from(0);
  for (int k = 0; k < lo; ++k) u0 = live_from(u0 + 1);
  const int panels = (d + kPanel - 1) / kPanel;
  if (tid == 0) sm.init();
  __syncthreads();

  const int group = tid / 128;
  if (group == 2) {  // producer: the first warp, every lane
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid >= 2 * 128 + 32) return;
    const int lane = tid % 32;
    if (lane == 0) {
      mbar_expect_tx(sm.own_bar(), panels * kO * kRowBytes);
      load_rows(sm.own, &map_a, sm.own_bar(), panels, kO, o0);
    }
    int it = 0;
    for (int t = 0, u = u0; t < count; ++t, u = live_from(u + 1))
      for (int intra = 0; intra < 2; ++intra, ++it) {
        const Slot<kFwdStages> at(it);
        mbar_wait(sm.empty(at.s), at.parity ^ 1);
        float* cv = sm.vec(at.s);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int64_t c = (int64_t)u * kFS + 4 * lane + k;
          cv[4 * lane + k] = c < n ? col[c] : -INFINITY;
        }
        if (lane == 0) {  // the vectors first, then this lane's arrival
          mbar_expect_tx(sm.full(at.s), panels * kFS * kRowBytes);
          load_rows(sm.tile(at.s), intra ? &map_a : &map_b, sm.full(at.s),
                    panels, kFS, (int64_t)u * kFS);
        } else {
          mbar_arrive(sm.full(at.s));
        }
      }
    return;
  }

  // consumers: warpgroup `group` owns local rows 64 group .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = (tid / 32) % 4, lane = tid % 32, q = lane % 4;
  const int rl = 64 * group + 16 * warp + lane / 4;  // local row, j = 0
  const int ksteps = (d + 15) / 16;
  const float inv_tau = 1.f / tau;
  const uint32_t own = sm.own + group * 64 * kRowBytes;
  // the running max and sum of this thread's rows over its columns; the
  // sum a double, as in the other designs
  float m[2] = {kNeg, kNeg};
  double sum[2] = {0.0, 0.0};
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(sm.own_bar(), 0);
  int it = 0;
  for (int t = 0, u = u0; t < count; ++t, u = live_from(u + 1))
    for (int intra = 0; intra < 2; ++intra, ++it) {
      const Slot<kFwdStages> at(it);
      mbar_wait(sm.full(at.s), at.parity);
      const uint32_t st = sm.tile(at.s);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll 4
      for (int k = 0; k < ksteps; ++k) {
        const uint32_t kb = (k % 4) * 32;
        wgmma_m64n128k16_ss(
            acc, desc_sw128(own + (k / 4) * kO * kRowBytes + kb, 16, 1024),
            desc_sw128(st + (k / 4) * kFS * kRowBytes + kb, 16, 1024), k > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      if (intra && (int64_t)u * kFS == o0)
        fold<true>(acc, sm.vec(at.s), rl, q, inv_tau, m, sum);
      else
        fold<false>(acc, sm.vec(at.s), rl, q, inv_tau, m, sum);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(at.s));
    }

  // merge the quad's four threads of each row
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int w = 1; w < 4; w *= 2) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[j], w);
      const double so = __shfl_xor_sync(0xffffffffu, sum[j], w);
      const float mn = fmaxf(m[j], mo);
      sum[j] = sum[j] * (double)expf(m[j] - mn) + so * (double)expf(mo - mn);
      m[j] = mn;
    }
  if (splits == 1) {
    if (q == 0)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int64_t row = o0 + rl + 8 * j;
        if (row < n) den[row] = m[j] + logf((float)sum[j]);
      }
    return;
  }
  if (q == 0)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t i = p * rows + o0 + rl + 8 * j;
      part_m[i] = m[j];
      part_s[i] = sum[j];
    }
  // the slice that finishes last merges, in slice order (wide_f32's)
  __threadfence();
  consumers_sync();
  if (tid == 0) last = atomicAdd(tickets + blockIdx.x, 1) == splits - 1;
  consumers_sync();
  if (!last) return;
  __threadfence();
  const int64_t row = o0 + tid;
  if (tid < kO && row < n) {
    float mx = kNeg;
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, __ldcg(part_m + s * rows + row));
    double total_s = 0.0;
    for (int s = 0; s < splits; ++s)
      total_s += __ldcg(part_s + s * rows + row) *
                 (double)expf(__ldcg(part_m + s * rows + row) - mx);
    den[row] = mx + logf((float)total_s);
  }
}

// ---- backward ---------------------------------------------------------------

// The softmax cotangents of one 64 x 64 logit tile, in place (l[4 i + 2 j +
// c]: local row rl + 8 j of the own tile, column 8 i + 2 q + c of the
// streamed tile): kJob 0 the rows term, 2 the columns term, 1 both, as
// cotangent() above; kDiag: the tile holds the intra diagonal, where local
// row == column + shift. v holds the streamed (g, den, col); the own rows'
// are (g_o, den_o, col_o). Rows past the last are zeros with (0, 0, -inf)
// on either side, so every term there is an exact 0.
template <int kJob, bool kDiag>
__device__ __forceinline__ void cotangents(float (&l)[32], const float* v,
                                           int rl, int q, int shift,
                                           const float (&g_o)[2],
                                           const float (&den_o)[2],
                                           const float (&col_o)[2],
                                           float inv_tau) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c0 = 8 * i + 2 * q;
    float2 gs = make_float2(0.f, 0.f), ds = gs, cs = gs;
    if (kJob != 0) {
      gs = *reinterpret_cast<const float2*>(v + c0);
      ds = *reinterpret_cast<const float2*>(v + kBS + c0);
    }
    if (kJob != 2) cs = *reinterpret_cast<const float2*>(v + 2 * kBS + c0);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = l[4 * i + 2 * j + c];
        const float xs = x * inv_tau;
        const bool diag = kDiag && c0 + c + shift == rl + 8 * j;
        float w = 0.f;
        if (kJob != 2)
          w = g_o[j] *
              __expf((diag ? kNeg : xs + (c ? cs.y : cs.x)) - den_o[j]);
        if (kJob != 0)
          w += (c ? gs.y : gs.x) *
               __expf((diag ? kNeg : xs + col_o[j]) - (c ? ds.y : ds.x));
        x = w;
      }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    bwd_bf16(const __grid_constant__ CUtensorMap own_a,
             const __grid_constant__ CUtensorMap own_b,
             const __grid_constant__ CUtensorMap st_a,
             const __grid_constant__ CUtensorMap st_b,
             const float* __restrict__ col, const float* __restrict__ den,
             const float* __restrict__ g, const uint8_t* __restrict__ flags,
             float* __restrict__ out, int n, int n64, int d, int dp,
             float tau) {
  extern __shared__ uint8_t smem_raw[];
  const Layout<kBwdStages, kBwdTile, kBwdVec> sm(smem_raw);
  const int tid = threadIdx.x, job = blockIdx.y, ot = blockIdx.x;
  const int64_t o0 = (int64_t)ot * kO;
  // this CTA's block of the job's output: rows [o0, min(o0 + 128, n64))
  float* out_job = out + ((int64_t)job * n64 + o0) * dp;
  const int out_rows = (int)(n64 - o0 < kO ? n64 - o0 : kO);
  const int tiles = n64 / kBS;
  const Live live(flags, tiles);
  const bool go = live.gz(2 * ot) || live.gz(2 * ot + 1);
  const bool co = live.c(2 * ot) || live.c(2 * ot + 1);
  auto live_from = [&](int u) {
    while (u < tiles && !Live::pair(job, go, co, live.gz(u), live.c(u))) ++u;
    return u;
  };
  const int first = live_from(0);
  if (first >= tiles) {  // no live pair: zeros
    for (int i = tid; i < out_rows * dp / 4; i += kThreads)
      reinterpret_cast<float4*>(out_job)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int panels = (d + kPanel - 1) / kPanel;
  // the panels past d, read as zeros by the second product
  const int zero_from = panels * kBS * kRowBytes;
  for (int s = 0; s < kBwdStages; ++s) {
    uint4* z = reinterpret_cast<uint4*>(sm.raw + kOwnBytes + s * kBwdTile +
                                        zero_from);
    for (int i = tid; i < (kBwdTile - zero_from) / 16; i += kThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) sm.init();
  __syncthreads();

  const int group = tid / 128;
  if (group == 2) {  // producer: the first warp, every lane
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid >= 2 * 128 + 32) return;
    const int lane = tid % 32;
    if (lane == 0) {
      mbar_expect_tx(sm.own_bar(), panels * kO * kRowBytes);
      load_rows(sm.own, job == 2 ? &own_b : &own_a, sm.own_bar(), panels, kO,
                o0);
    }
    const CUtensorMap* st = job == 0 ? &st_b : &st_a;
    int it = 0;
    for (int u = first; u < tiles; u = live_from(u + 1), ++it) {
      const Slot<kBwdStages> at(it);
      mbar_wait(sm.empty(at.s), at.parity ^ 1);
      float* v = sm.vec(at.s);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = 2 * lane + k;
        const int64_t s = (int64_t)u * kBS + r;
        const bool in = s < n;
        v[r] = in ? g[s] : 0.f;
        v[kBS + r] = in ? den[s] : 0.f;
        v[2 * kBS + r] = in ? col[s] : -INFINITY;
      }
      if (lane == 0) {  // the vectors first, then this lane's arrival
        mbar_expect_tx(sm.full(at.s), panels * kBS * kRowBytes);
        load_rows(sm.tile(at.s), st, sm.full(at.s), panels, kBS,
                  (int64_t)u * kBS);
      } else {
        mbar_arrive(sm.full(at.s));
      }
    }
    return;
  }

  // consumers: warpgroup `group` owns local rows 64 group .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = (tid / 32) % 4, lane = tid % 32, q = lane % 4;
  const int rl = 64 * group + 16 * warp + lane / 4;  // local row, j = 0
  float g_o[2], den_o[2], col_o[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int64_t o = o0 + rl + 8 * j;
    const bool in = o < n;
    g_o[j] = in ? g[o] : 0.f;
    den_o[j] = in ? den[o] : 0.f;
    col_o[j] = in ? col[o] : -INFINITY;
  }
  const int ksteps = (d + 15) / 16;
  const float inv_tau = 1.f / tau;
  const uint32_t own = sm.own + group * 64 * kRowBytes;
  // acc[4 i + 2 j + c]: local row rl + 8 j, column 8 i + 2 q + c
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  mbar_wait(sm.own_bar(), 0);
  int it = 0;
  for (int u = first; u < tiles; u = live_from(u + 1), ++it) {
    const Slot<kBwdStages> at(it);
    mbar_wait(sm.full(at.s), at.parity);
    const uint32_t st = sm.tile(at.s);
    float l[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) l[i] = 0.f;
    fence_regs(l);
    wgmma_fence();
#pragma unroll 4
    for (int k = 0; k < ksteps; ++k) {
      const uint32_t kb = (k % 4) * 32;
      wgmma_m64n64k16_ss(
          l, desc_sw128(own + (k / 4) * kO * kRowBytes + kb, 16, 1024),
          desc_sw128(st + (k / 4) * kBS * kRowBytes + kb, 16, 1024), k > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(l);
    const float* v = sm.vec(at.s);
    const int64_t s0 = (int64_t)u * kBS;
    const int shift = (int)(s0 - o0);
    if (job == 0)
      cotangents<0, false>(l, v, rl, q, shift, g_o, den_o, col_o, inv_tau);
    else if (job == 2)
      cotangents<2, false>(l, v, rl, q, shift, g_o, den_o, col_o, inv_tau);
    else if (shift >= 0 && shift < kO)
      cotangents<1, true>(l, v, rl, q, shift, g_o, den_o, col_o, inv_tau);
    else
      cotangents<1, false>(l, v, rl, q, shift, g_o, den_o, col_o, inv_tau);
    // the cotangents as the A fragments of four k16 steps: columns
    // 16 k .. + 15 are l[8 k .. 8 k + 7]
    uint32_t a[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[k][r] = pack_bf16x2(l[8 * k + 2 * r], l[8 * k + 2 * r + 1]);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n256k16_rs(
          acc, a[k],
          desc_sw128(st + k * 16 * kRowBytes, kBS * kRowBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(a);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(at.s));
  }

#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * i + 2 * q;
    if (c < dp)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = rl + 8 * j;
        if (r < out_rows)
          *reinterpret_cast<float2*>(out_job + (int64_t)r * dp + c) =
              make_float2(acc[4 * i + 2 * j] * inv_tau,
                          acc[4 * i + 2 * j + 1] * inv_tau);
      }
  }
}

}  // namespace wg

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

// a kernel's dynamic shared memory; with max_carveout the whole carveout
// given to shared memory, so that two first-design CTAs fit on an SM where
// their registers allow (wide_f32's leave the CUDA driver its choice: the
// L1 that a shared-memory-only carveout takes away cost its forward 11 %
// on an H100)
template <typename K>
cudaError_t set_smem(K* kernel, size_t bytes, bool max_carveout = true) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess || !max_carveout) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

enum Design {
  kFirstF32 = 0,
  kFirstBf16 = 1,
  kSkipBf16 = 2,
  kWideF32 = 3,
  kWgmmaBf16 = 4,
  kWholeF32 = 5
};

template <typename T, bool kSkip>
int launch_fwd(const void* an, const void* bn, const void* col,
               const uint8_t* flags, void* den, int n, int d, float tau,
               cudaStream_t stream) {
  const int dp = round16(d);
  const size_t bytes = smem_bytes<T>(dp, false);
  const cudaError_t err = set_smem(fwd_kernel<T, kSkip>, bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n + kRows - 1) / kRows);
  fwd_kernel<T, kSkip><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(an), static_cast<const T*>(bn),
      static_cast<const float*>(col), flags, static_cast<float*>(den), n, d,
      dp, tau, use_vec<T>(an, bn, d));
  return (int)cudaGetLastError();
}

template <typename T, bool kSkip>
int launch_bwd(const void* an, const void* bn, const void* col,
               const void* den, const void* g, const uint8_t* flags,
               void* out, int n, int d, float tau, cudaStream_t stream) {
  const int dp = round16(d);
  const int n64 = (n + kRows - 1) / kRows * kRows;
  const size_t bytes = smem_bytes<T>(dp, true);
  const cudaError_t err = set_smem(bwd_kernel<T, kSkip>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(n64 / kRows), kJobs);
  bwd_kernel<T, kSkip><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(an), static_cast<const T*>(bn),
      static_cast<const float*>(col), static_cast<const float*>(den),
      static_cast<const float*>(g), flags, static_cast<float*>(out), n, n64,
      d, dp, tau, use_vec<T>(an, bn, d));
  return (int)cudaGetLastError();
}

// A wave of kernel on the current card: its SMs times the CTAs an SM
// holds, or -1.
template <typename K>
int wave_of(K* kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (set_smem(kernel, smem, false) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess ||
      sms * per_sm <= 0)
    return -1;
  return sms * per_sm;
}

// The forward slices per 128-row tile of a design that slices (wide_f32,
// whole_f32, wgmma_bf16): the fewest (up to 8) whose grid fills at least
// 90 % of its last wave, else the fullest.
template <typename K>
int fwd_splits(K* kernel, int threads, size_t smem, int n) {
  const int64_t wave = wave_of(kernel, threads, smem);
  if (wave <= 0) return -1;
  const int64_t rows = (n + wide::kO - 1) / wide::kO;
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= 8; ++s) {
    const int64_t ctas = rows * s, waves = (ctas + wave - 1) / wave;
    const double fill = (double)ctas / (double)(waves * wave);
    if (fill >= 0.9) return s;
    if (fill > best_fill + 1e-9) best = s, best_fill = fill;
  }
  return best;
}

// ---- wgmma_bf16's tensor maps -------------------------------------------------

// The bf16 (n, d) row-major table at base as boxes of `rows` rows x 64
// columns with the 128-byte swizzle; zeros past its rows and columns.
bool table_map(CUtensorMap* map, const void* base, int n, int d, int rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {wg::kPanel, (cuuint32_t)rows};
  return hopper::encode_bf16(map, base, 2, dims, strides, box);
}

// What ops/flashnce.py::flash_design sends to wgmma_bf16: TMA wants
// 16-byte aligned bases and row strides (d a multiple of 8).
bool wgmma_takes(const void* an, const void* bn, int d) {
  return d % 8 == 0 && ((uintptr_t)an | (uintptr_t)bn) % 16 == 0;
}

int launch_wgmma_fwd(const void* an, const void* bn, const void* col,
                     const uint8_t* flags, void* den, void* part_s,
                     void* part_m, void* tickets, int splits, int n, int d,
                     float tau, cudaStream_t stream) {
  if (!wgmma_takes(an, bn, d) || splits < 1 || splits > 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;  // own and streamed rows alike: 128-row boxes
  if (!table_map(&map_a, an, n, d, wg::kO) ||
      !table_map(&map_b, bn, n, d, wg::kFS))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = set_smem(wg::fwd_bf16, wg::kFwdSmem, false);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + wg::kO - 1) / wg::kO), (unsigned)splits);
  wg::fwd_bf16<<<grid, wg::kThreads, wg::kFwdSmem, stream>>>(
      map_a, map_b, static_cast<const float*>(col), flags,
      static_cast<float*>(den), static_cast<double*>(part_s),
      static_cast<float*>(part_m), static_cast<int*>(tickets), n, d, tau);
  return (int)cudaGetLastError();
}

int launch_wgmma_bwd(const void* an, const void* bn, const void* col,
                     const void* den, const void* g, const uint8_t* flags,
                     void* out, int n, int d, float tau, cudaStream_t stream) {
  if (!wgmma_takes(an, bn, d)) return (int)cudaErrorInvalidValue;
  CUtensorMap own_a, own_b, st_a, st_b;
  if (!table_map(&own_a, an, n, d, wg::kO) ||
      !table_map(&own_b, bn, n, d, wg::kO) ||
      !table_map(&st_a, an, n, d, wg::kBS) ||
      !table_map(&st_b, bn, n, d, wg::kBS))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = set_smem(wg::bwd_bf16, wg::kBwdSmem, false);
  if (err != cudaSuccess) return (int)err;
  const int dp = round16(d), n64 = (n + 63) / 64 * 64;
  const dim3 grid((unsigned)((n64 + wg::kO - 1) / wg::kO), kJobs);
  wg::bwd_bf16<<<grid, wg::kThreads, wg::kBwdSmem, stream>>>(
      own_a, own_b, st_a, st_b, static_cast<const float*>(col),
      static_cast<const float*>(den), static_cast<const float*>(g), flags,
      static_cast<float*>(out), n, n64, d, dp, tau);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. an, bn (n, d) contiguous, float32 or bf16
// as the design takes them; col, den, g (n,) float32; d <= 256; flags
// (2, ceil(n / 64)) uint8 (ops/flashnce.py::live_tiles; the first designs
// 0 and 1 do not read it). Nothing is allocated and nothing synchronises.
// Each returns the cudaError_t of the launch (0 = success); an unknown
// design is cudaErrorInvalidValue.

// The forward slices of design (wide_f32 or wgmma_bf16) for n rows (the
// size of its workspace), or -1.
extern "C" int flashnce_fwd_splits(int design, int n) {
  switch (design) {
    case kWideF32:
    case kWholeF32:
      return fwd_splits(wide::fwd_f32, wide::kThreads, wide::kFwdSmem, n);
    case kWgmmaBf16:
      return fwd_splits(wg::fwd_bf16, wg::kThreads, wg::kFwdSmem, n);
  }
  return -1;
}

// The backward's slots of design wide_f32 (W, the CTAs resident at once:
// the size of its workspace), or -1.
extern "C" int flashnce_bwd_slots(int design) {
  if (design != kWideF32) return -1;
  return wave_of(wide::bwd_f32, wide::kThreads, wide::kBwdSmem);
}

// den (n,) written. wide_f32, whole_f32 and wgmma_bf16 with splits > 1
// take a workspace of splits * ceil(n / 128) * 128 doubles (part_s) and
// as many floats (part_m), and ceil(n / 128) tickets, zero on entry; the
// others ignore them. wgmma_bf16 refuses (cudaErrorInvalidValue) a d that is no
// multiple of 8, bases that are not 16-byte aligned, and a tensor map that
// does not encode.
extern "C" int flashnce_fwd(int design, const void* an, const void* bn,
                            const void* col, const void* flags, void* den,
                            void* part_s, void* part_m, void* tickets,
                            int splits, int n, int d, float tau,
                            void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* fl = static_cast<const uint8_t*>(flags);
  switch (design) {
    case kFirstF32:
      return launch_fwd<float, false>(an, bn, col, fl, den, n, d, tau, st);
    case kFirstBf16:
      return launch_fwd<__nv_bfloat16, false>(an, bn, col, fl, den, n, d,
                                              tau, st);
    case kSkipBf16:
      return launch_fwd<__nv_bfloat16, true>(an, bn, col, fl, den, n, d, tau,
                                             st);
    case kWideF32:
    case kWholeF32: {
      if (splits < 1 || splits > 8) return (int)cudaErrorInvalidValue;
      const cudaError_t err = set_smem(wide::fwd_f32, wide::kFwdSmem, false);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid((unsigned)((n + wide::kO - 1) / wide::kO),
                      (unsigned)splits);
      wide::fwd_f32<<<grid, wide::kThreads, wide::kFwdSmem, st>>>(
          static_cast<const float*>(an), static_cast<const float*>(bn),
          static_cast<const float*>(col), fl, static_cast<float*>(den),
          static_cast<double*>(part_s), static_cast<float*>(part_m),
          static_cast<int*>(tickets), n, d, tau);
      return (int)cudaGetLastError();
    }
    case kWgmmaBf16:
      return launch_wgmma_fwd(an, bn, col, fl, den, part_s, part_m, tickets,
                              splits, n, d, tau, st);
  }
  return (int)cudaErrorInvalidValue;
}

// out (3, ceil(n / 64) * 64, round_up(d, 16)) float32, every element
// written (job-major; rows past n and columns past d are padding the
// caller drops). wide_f32 takes a workspace of `slots` (128,
// round_up(d, 16)) float32 blocks (part) and `slots` tickets, zero on
// entry, slots from flashnce_bwd_slots, and adds (items with a live pair,
// items cut, slices) to the int64 tally (3,) where it is not null; the
// others ignore them (whole_f32 runs wide_f32's kernel on one slot).
extern "C" int flashnce_bwd(int design, const void* an, const void* bn,
                            const void* col, const void* den, const void* g,
                            const void* flags, void* out, void* part,
                            void* tickets, void* tally, int slots, int n,
                            int d, float tau, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* fl = static_cast<const uint8_t*>(flags);
  switch (design) {
    case kFirstF32:
      return launch_bwd<float, false>(an, bn, col, den, g, fl, out, n, d,
                                      tau, st);
    case kFirstBf16:
      return launch_bwd<__nv_bfloat16, false>(an, bn, col, den, g, fl, out,
                                              n, d, tau, st);
    case kSkipBf16:
      return launch_bwd<__nv_bfloat16, true>(an, bn, col, den, g, fl, out, n,
                                             d, tau, st);
    case kWideF32:
    case kWholeF32: {
      if (design == kWholeF32) {  // one slot: nothing is cut
        slots = 1;
        part = tickets = tally = nullptr;
      }
      if (slots < 1) return (int)cudaErrorInvalidValue;
      const cudaError_t err = set_smem(wide::bwd_f32, wide::kBwdSmem, false);
      if (err != cudaSuccess) return (int)err;
      const int dp = round16(d), n64 = (n + 63) / 64 * 64;
      const int owns = (n64 + wide::kO - 1) / wide::kO;
      const bool vec = d % 4 == 0 && ((uintptr_t)an | (uintptr_t)bn) % 16 == 0;
      wide::bwd_f32<<<(unsigned)(kJobs * owns + slots), wide::kThreads,
                      wide::kBwdSmem, st>>>(
          static_cast<const float*>(an), static_cast<const float*>(bn),
          static_cast<const float*>(col), static_cast<const float*>(den),
          static_cast<const float*>(g), fl, static_cast<float*>(out),
          static_cast<float*>(part), static_cast<int*>(tickets),
          static_cast<unsigned long long*>(tally), slots, n, n64, d, dp, tau,
          vec);
      return (int)cudaGetLastError();
    }
    case kWgmmaBf16:
      return launch_wgmma_bwd(an, bn, col, den, g, fl, out, n, d, tau, st);
  }
  return (int)cudaErrorInvalidValue;
}

// What the compiler made of a kernel (cudaFuncGetAttributes): attrs gets
// registers a thread, local (spill) bytes a thread, static shared bytes,
// and the most threads a CTA. backward 0 / 1, design as above.
extern "C" int flashnce_attributes(int backward, int design, int* attrs) {
  cudaFuncAttributes a;
  cudaError_t err = cudaErrorInvalidValue;
  switch (design * 2 + (backward ? 1 : 0)) {
    case 2 * kFirstF32:
      err = cudaFuncGetAttributes(&a, fwd_kernel<float, false>);
      break;
    case 2 * kFirstF32 + 1:
      err = cudaFuncGetAttributes(&a, bwd_kernel<float, false>);
      break;
    case 2 * kFirstBf16:
      err = cudaFuncGetAttributes(&a, fwd_kernel<__nv_bfloat16, false>);
      break;
    case 2 * kFirstBf16 + 1:
      err = cudaFuncGetAttributes(&a, bwd_kernel<__nv_bfloat16, false>);
      break;
    case 2 * kSkipBf16:
      err = cudaFuncGetAttributes(&a, fwd_kernel<__nv_bfloat16, true>);
      break;
    case 2 * kSkipBf16 + 1:
      err = cudaFuncGetAttributes(&a, bwd_kernel<__nv_bfloat16, true>);
      break;
    case 2 * kWideF32:
      err = cudaFuncGetAttributes(&a, wide::fwd_f32);
      break;
    case 2 * kWideF32 + 1:
      err = cudaFuncGetAttributes(&a, wide::bwd_f32);
      break;
    case 2 * kWgmmaBf16:
      err = cudaFuncGetAttributes(&a, wg::fwd_bf16);
      break;
    case 2 * kWgmmaBf16 + 1:
      err = cudaFuncGetAttributes(&a, wg::bwd_bf16);
      break;
    case 2 * kWholeF32:
      err = cudaFuncGetAttributes(&a, wide::fwd_f32);
      break;
    case 2 * kWholeF32 + 1:
      err = cudaFuncGetAttributes(&a, wide::bwd_f32);
      break;
  }
  if (err != cudaSuccess) return (int)err;
  attrs[0] = a.numRegs;
  attrs[1] = (int)a.localSizeBytes;
  attrs[2] = (int)a.sharedSizeBytes;
  attrs[3] = a.maxThreadsPerBlock;
  return 0;
}
