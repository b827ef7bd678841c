// Fused AMP decode: one launch runs every iteration and the debias for all
// blocks of the block-diagonal A, for G points at once (a sweep's grid: the
// same A, one y per point).  Per point p and block b (global id
// id_offset + b, whatever the point):
//
//   x = 0, z = y
//   repeat iters times:
//     sigma = ||z|| / sqrt(s)
//     x'    = soft(x + A^T z, mult * sigma)
//     z     = y - A x' + z * ||x'||_0 / s
//   debias: x *= clip(<Ax, y> / max(<Ax, Ax>, 1e-12), 1, 2)
//
// Replaces the TPU kernel repro/kernels/amp_fused.py::amp_decode_fused_pallas
// (body _amp_kernel).
//
// What bounds it on an H100: operations.  Only y in and x out touch device
// memory; the 2 * iters + 1 products with A, each s * c float64 adds per
// block, are the work.  The Pallas kernel makes a chunk's A once and keeps it
// in VMEM; a whole A_b (16 MiB at 1024 x 4096) does not fit one SM.
//
// Design: one block of one point per thread-block cluster of K CTAs on
// neighbouring SMs (K = 16 at 1024 x 4096; K is a function of (s, c) only,
// chosen by kernels/layout.py::amp_cluster_size).  The grid is
// (K * n_blocks, G): blockIdx.x / K is the block, blockIdx.y the point, and
// nothing else in the body depends on the point, so each point decodes to
// the bits of its own G = 1 launch.  CTA k of a cluster owns
//   * the columns [k c / K, (k+1) c / K): x, the adjoint and the threshold;
//   * the rows    [k s / K, (k+1) s / K): the final sum of the forward
//     product, z' and y for those rows;
// and keeps a whole copy of z.  Gaussian entries do not fit as floats and
// are made from the hash in every product, spread over K SMs.
//
// Rademacher entries are hashed ONCE per decode into the CTA's s x (c / K)
// slice of sign bits in shared memory, row-major (a word holds 32 columns of
// a row), and, where it fits, a column-major copy (a word holds 32 rows of a
// column; at 1024 x 4096, 32 KB each).  A product with +-1 entries never
// flips and adds one entry at a time: before each product the CTA builds,
// per group of 4 consecutive columns (forward) or rows (adjoint), a table of
// the 16 signed sums ((+-v0 +- v1) +- v2) +- v3 in float64, entry m taking
// bit u of m as the sign of v_u.  A row's (forward) or column's (adjoint)
// product is then one shared-memory lookup, indexed by a nibble of its sign
// word, and one float64 add per 4 entries of A.  A 16-double table fills the
// 32 banks, so the lookups of a half-warp into one table never conflict.
// Groups start at each column slice's and each row segment's first entry
// (layout.py::amp_groups); a short last group reads v = +0.0 with sign bit
// 0, which adds nothing.  z and x, float32 values, are kept as floats.
//
// Every shape the one-bit-per-entry layout fitted still fits (RadPlan): the
// tables are built a chunk of row or column words at a time where all of
// them do not fit, the partials carried in shared memory from chunk to
// chunk, and without the column-major copy the adjoint turns each 32 x 32
// tile of the row-major bits around in registers as it reads it.  Neither
// changes an add or its order.
//
// What bounds an iteration then: the shared-memory bandwidth of the
// 2 * s * c / (4 K) lookups (~8 200 clocks a CTA at 1024 x 4096, about 40 %
// of an iteration alone), and the latency of the DSMEM exchanges and
// cluster barriers.  So a Rademacher CTA holds at most 64 registers and
// ~106 KB of shared memory at 1024 x 4096, and two CTAs share an SM: one's
// exchanges overlap the other's lookups.  The exchanges keep their loads in
// flight together (rank_sums, gather_z), and the cuts divide in 32 bits.
//
// One iteration, with the peers' shared memory read through DSMEM:
//   1. adjoint on the CTA's columns over all rows, float64: warp = one
//      32-column word over one of G row segments (lane = column, rows
//      ascending in groups of 4), the G partials added in segment order;
//      then the soft threshold;
//   2. forward partials over the CTA's columns for all s rows, float64
//      (thread = row, columns ascending in groups of 4); cluster.sync();
//   3. CTA k sums the K partials of its rows in rank order 0..K-1, forms
//      z' with the same _rn steps as the plain version, and its share of
//      ||z'||^2; ||x'||_0 is the sum of the K per-CTA counts; cluster.sync();
//   4. every CTA gathers the whole z' (row i from the CTA that owns it) and
//      the K shares of ||z'||^2, summed in rank order.
// The debias dots reduce the same way, and a last cluster.sync() keeps every
// CTA resident until no peer reads its shared memory.
//
// Non-finite observations propagate as in the plain version and the
// reference, whose max, sign and clip carry a NaN through: a poisoned
// frame's NaN or Inf reaches y, and the block must decode to NaN where the
// plain version does.  CUDA's fmaxf / fminf / fmax return the other operand
// of a NaN, so the soft threshold, its sign and the debias clamp use the
// NaN-propagating forms below; on finite inputs they are bitwise the
// forms they replace.  The Onsager count counts a NaN as nonzero, as the
// plain version's `x != 0` does.
//
// Rounding follows the plain version (core/amp.py::amp_blocked_core) step
// for step: the products with A, ||z||^2 and the two debias dots are summed
// in double and rounded once to float; every other step is one float32
// operation, written with _rn intrinsics so that nvcc contracts none of them
// into a fused multiply-add.  Splitting a double sum into partials, or into
// groups of 4, changes only the order of double adds, about 2^-53 relative
// against a float32 ulp of 2^-24 (tests/test_torch_split_sums.py emulates
// the kernel's order on the CPU).  Every reduction runs in a fixed order,
// with no atomics, so runs are bitwise repeatable and a block decodes to the
// same bits in any range.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hash.cuh"

namespace cg = cooperative_groups;

namespace {

using repro_torch::block_hash;
using repro_torch::block_sum;
using repro_torch::entry_hash;
using repro_torch::gaussian_entry;
using repro_torch::row_hash;
using repro_torch::signed_by;

constexpr int kThreads = 512;     // layout.py AMP_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;   // layout.py AMP_MAX_CLUSTER
constexpr int kRowsPerPass = 2;   // forward: rows a thread owns per pass
constexpr int64_t kSmemMax = 232448;  // shared memory a CTA may take
// The Rademacher path:
constexpr int kRankBatch = 8;     // peers' partials a thread loads at once
constexpr int kGroup = 4;         // layout.py AMP_GROUP: entries of A per table
constexpr int kTable = 1 << kGroup;  // signed sums of one group
constexpr int kNibbles = 32 / kGroup;  // groups of one 32-bit sign word
constexpr int kWordTables = kNibbles * kTable;  // doubles of one word's tables

// Start of part k of n items cut into `parts` (layout.py::cut).  The
// Rademacher path divides in 32 bits (FAST): k * n stays below 2^32, as
// k <= parts <= 16 and a shape that fits in shared memory has far fewer
// than 2^28 rows or columns.
template <bool FAST = false>
__host__ __device__ __forceinline__ int cut(int n, int parts, int k) {
  if (FAST)
    return static_cast<int>(static_cast<uint32_t>(k) * static_cast<uint32_t>(n) /
                            static_cast<uint32_t>(parts));
  return static_cast<int>(static_cast<int64_t>(k) * n / parts);
}

// Sizes of one CTA's shared memory on the Gaussian path, on the host and the
// device alike.
struct Plan {
  int cw_max;    // widest column slice
  int words;     // 32-column words of it
  int rows_max;  // widest row slice
  int part_len;  // doubles of the partials: s forward, G * words * 32 adjoint
  __host__ __device__ Plan(int s, int c, int K, int G) {
    cw_max = (c + K - 1) / K;
    words = (cw_max + 31) / 32;
    rows_max = (s + K - 1) / K;
    part_len = s > G * words * 32 ? s : G * words * 32;
  }
  __host__ __device__ int64_t bytes(int s) const {
    const int64_t doubles = static_cast<int64_t>(s) + part_len + cw_max + rows_max + 4 + kWarps;
    const int64_t words32 = kWarps + 1 + rows_max + s;
    return doubles * 8 + words32 * 4;
  }
};

// Sizes of one CTA's shared memory on the Rademacher path, on the host and
// the device alike.  The column-major copy of the sign bits is kept where it
// fits beside the smallest chunks of tables; the chunks are then the most
// 32-row words of every row segment (zr) and 32-column words (xw) that fit,
// all of them at 1024 x 4096.
struct RadPlan {
  int cw_max;     // widest column slice
  int words;      // 32-column words of it
  int swz_shift;  // row i's sign words are stored in the order
  int swz_mask;   // w ^ ((i >> swz_shift) & swz_mask), so that 32 rows'
                  // word w lie in 32 banks (row_word)
  int rows_max;   // widest row slice
  int seg_words;  // 32-row words of the longest adjoint row segment
  int apart_len;  // doubles of the adjoint's partials, G * words * 32
  int tstride;    // words per 32 rows of the column-major copy, 0 if none
  int tbits_len;  // words of the column-major copy
  int zr, xw;     // 32-row and 32-column words of a chunk of tables
  int region;     // doubles of the adjoint's partials and tables, and of the
                  // forward's partials (s) and tables over them
  __host__ __device__ RadPlan(int s, int c, int K, int G) {
    cw_max = (c + K - 1) / K;
    words = (cw_max + 31) / 32;
    // d = the largest power of two dividing words, at most 32: rows whose
    // i * words fall on one bank are 32 / d apart, and d of them meet
    const int d = (words & -words) < 32 ? (words & -words) : 32;
    swz_mask = d - 1;
    swz_shift = 5;
    for (int t = d; t > 1; t >>= 1) --swz_shift;
    rows_max = (s + K - 1) / K;
    seg_words = ((s + G - 1) / G + 31) / 32;
    apart_len = G * words * 32;
    // every byte but the region's and the copy's
    const int64_t fixed = 8 * static_cast<int64_t>(rows_max + 4 + kWarps) +
                          4 * (kWarps + 1 + rows_max + static_cast<int64_t>(s) + cw_max +
                               static_cast<int64_t>(s) * words);
    const int64_t copy = static_cast<int64_t>(G) * seg_words * words * 32;
    const int64_t least = region_of(s, G, 1, 1);
    tstride = fixed + 8 * least + 4 * copy <= kSmemMax ? words * 32 : 0;
    tbits_len = tstride > 0 ? static_cast<int>(copy) : 0;
    const int64_t room = (kSmemMax - fixed - 4 * static_cast<int64_t>(tbits_len)) / 8;
    zr = clamp((room - apart_len) / (static_cast<int64_t>(G) * kWordTables), seg_words);
    xw = clamp((room - s) / kWordTables, words);
    region = static_cast<int>(region_of(s, G, zr, xw));
  }
  __host__ __device__ static int clamp(int64_t v, int hi) {
    return v < 1 ? 1 : (v > hi ? hi : static_cast<int>(v));
  }
  __host__ __device__ int64_t region_of(int s, int G, int zr_, int xw_) const {
    const int64_t a = apart_len + static_cast<int64_t>(G) * zr_ * kWordTables;
    const int64_t f = s + static_cast<int64_t>(xw_) * kWordTables;
    return a > f ? a : f;
  }
  __host__ __device__ int64_t bytes(int s) const {
    const int64_t doubles = static_cast<int64_t>(region) + rows_max + 4 + kWarps;
    const int64_t words32 = kWarps + 1 + rows_max + static_cast<int64_t>(s) + cw_max +
                            static_cast<int64_t>(s) * words + tbits_len;
    return doubles * 8 + words32 * 4;
  }
  // Index of row i's sign word w in the row-major sign bits.
  __device__ __forceinline__ int row_word(int i, int w) const {
    return i * words + (w ^ ((i >> swz_shift) & swz_mask));
  }
};

__host__ __device__ inline int64_t smem_bytes(int s, int c, int K, int G, bool rad) {
  return rad ? RadPlan(s, c, K, G).bytes(s) : Plan(s, c, K, G).bytes(s);
}

// One term of a product with A for the Gaussian entry made from h: the float
// entry times v (exact in double).
__device__ __forceinline__ double gauss_term(uint32_t h, double v, float scale) {
  return static_cast<double>(__fmul_rn(gaussian_entry(h), scale)) * v;
}

// max(v, 0), NaN for a NaN v (jnp.maximum, torch.clamp).
__device__ __forceinline__ float relu_nan(float v) {
  return v > 0.0f || v != v ? v : 0.0f;
}

// soft(r, tau) = sign(r) * max(|r| - tau, 0) as the plain version computes
// it: +mag, -mag or 0 * mag by the sign of r, so a NaN r or tau gives NaN.
__device__ __forceinline__ float soft_nan(float r, float tau) {
  const float mag = relu_nan(__fsub_rn(fabsf(r), tau));
  return r > 0.0f ? mag : (r < 0.0f ? -mag : __fmul_rn(0.0f, mag));
}

// clip(q, 1, 2), NaN for a NaN q (jnp.clip, torch.clamp).
__device__ __forceinline__ float clip12_nan(float q) {
  return q != q ? q : fminf(fmaxf(q, 1.0f), 2.0f);
}

template <bool RAD>
__device__ __forceinline__ float finish(double sum, float scale) {
  return static_cast<float>(RAD ? sum * static_cast<double>(scale) : sum);
}

// Sum over the cluster's CTAs, in rank order, of the double at `slot` in each
// CTA's shared memory.  Every thread gets it.
__device__ __forceinline__ double cluster_sum(cg::cluster_group& cluster,
                                              double* slot, int K, double* bcast) {
  if (threadIdx.x < 32) {
    const int q = threadIdx.x;
    const double v = q < K ? *cluster.map_shared_rank(slot, q) : 0.0;
    double t = 0.0;
    for (int r = 0; r < K; ++r) t += __shfl_sync(0xffffffffu, v, r);
    if (q == 0) *bcast = t;
  }
  __syncthreads();
  const double t = *bcast;
  __syncthreads();
  return t;
}

// The Gaussian path's products, from the row hashes amat.
//
// part[g * words * 32 + j] = sum over rows of segment g, ascending, of
// A[i, c0 + j] z[i], for the CTA's columns j < cw.
__device__ __forceinline__ void adjoint(const double* z, const uint32_t* amat,
                                        double* part, int s, int c0, int cw,
                                        const Plan& P, int G, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int u = warp; u < P.words * G; u += kWarps) {
    const int w = u % P.words, g = u / P.words;
    const int j = w * 32 + lane;
    const int i1 = cut(s, G, g + 1);
    double acc = 0.0;
    if (j < cw) {
#pragma unroll 4
      for (int i = cut(s, G, g); i < i1; ++i)
        acc += gauss_term(entry_hash(amat[i], static_cast<uint32_t>(c0 + j)), z[i], scale);
    }
    part[g * P.words * 32 + j] = acc;
  }
}

// part[i] = sum over the CTA's columns, ascending, of A[i, c0 + j] x[j], for
// every row i < s.
__device__ __forceinline__ void forward(const double* x, const uint32_t* amat,
                                        double* part, int s, int c0, int cw,
                                        const Plan& P, float scale) {
  for (int i0 = threadIdx.x; i0 < s; i0 += kThreads * kRowsPerPass) {
    double sum[kRowsPerPass];
#pragma unroll
    for (int k = 0; k < kRowsPerPass; ++k) sum[k] = 0.0;
    uint32_t hr[kRowsPerPass];
#pragma unroll
    for (int k = 0; k < kRowsPerPass; ++k) {
      const int i = i0 + k * kThreads;
      hr[k] = i < s ? amat[i] : 0u;
    }
    for (int j = 0; j < cw; ++j) {
      const double xj = x[j];
#pragma unroll
      for (int k = 0; k < kRowsPerPass; ++k)
        sum[k] += gauss_term(entry_hash(hr[k], static_cast<uint32_t>(c0 + j)), xj, scale);
    }
#pragma unroll
    for (int k = 0; k < kRowsPerPass; ++k) {
      const int i = i0 + k * kThreads;
      if (i < s) part[i] = sum[k];
    }
  }
}

// The Rademacher path's products, from the sign bits and the tables.
//
// Half h of table t: the signed sums ((+-v0 +- v1) +- v2) +- v3 of
// v[i..i+3] (an entry at or past `end` +0.0) in float64, entry m taking bit u
// of m as the sign of v_u.  Half h makes the 4 entries m with bit 2 equal to
// h and bit 3 clear, each with 2 adds onto the shared +-v0 +- v1, and stores
// each with its negation, entry 15 - m (-T[m] = T[15 - m] exactly, but for
// the sign of a zero, which no sum from +0.0 keeps).  A thread converts each
// v to double once.  Odd tables store each pair in the other order, and a
// thread's k-th pair is rotated by t / 2, so that the 16 stores of a
// half-warp (8 tables) fall in 32 banks.
__device__ __forceinline__ void half_table(const float* v, int i, int end, int t, int h,
                                           double* tab) {
  double a[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) a[u] = i + u < end ? static_cast<double>(v[i + u]) : 0.0;
  // bits 0 and 1 of m: +v0 + v1, -v0 + v1, and their negations
  const double l0 = a[0] + a[1], l1 = -a[0] + a[1];
  const double v2 = h ? -a[2] : a[2];
  const bool odd = t & 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = (k + (t >> 1)) & 3, m = j | (h << 2);
    const double l = (j ^ (j >> 1)) & 1 ? l1 : l0;
    const double e = ((j & 2 ? -l : l) + v2) + a[3];
    tab[odd ? kTable - 1 - m : m] = odd ? -e : e;
    tab[odd ? m : kTable - 1 - m] = odd ? e : -e;
  }
}

// A 32 x 32 tile of bits turned around across a warp: lane t's word holds
// row t's bits of columns 0..31 in, and column t's bits of rows 0..31 out.
// Five butterfly steps, each swapping the off-diagonal j x j blocks.
__device__ __forceinline__ uint32_t transpose32(uint32_t v, int lane) {
  uint32_t m = 0x0000FFFFu;  // bits t with t & j == 0
#pragma unroll
  for (int j = 16; j > 0; j >>= 1, m ^= m << j) {
    const uint32_t other = __shfl_xor_sync(0xffffffffu, v, j);
    v = lane & j ? (v & ~m) | ((other & ~m) >> j) : (v & m) | ((other & m) << j);
  }
  return v;
}

// Lane j's sign word of column 32 w + j over rows lo + 32 r + (0..31) of the
// row segment [lo, hi), turned around from the row-major bits; 0 past hi.
// Every lane of the warp calls it.
__device__ __forceinline__ uint32_t column_word(const uint32_t* amat, int lo, int hi, int r,
                                                int w, int lane, const RadPlan& P) {
  const int i = lo + 32 * r + lane;
  return transpose32(i < hi ? amat[P.row_word(i, w)] : 0u, lane);
}

// The column-major copy of the row-major sign bits amat: word
// (g * seg_words + r) * tstride + j holds column j's bits of rows
// lo_g + 32 r + (0..31) of row segment g at bits 0..31, 0 past the segment.
__device__ __forceinline__ void transpose_bits(const uint32_t* amat, uint32_t* bits_t, int s,
                                               int G, const RadPlan& P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_seg = P.seg_words * P.words;
  for (int u = warp; u < G * per_seg; u += kWarps) {
    const int g = u / per_seg, r = u % per_seg / P.words, w = u % P.words;
    const uint32_t v =
        column_word(amat, cut<true>(s, G, g), cut<true>(s, G, g + 1), r, w, lane, P);
    bits_t[(g * P.seg_words + r) * P.tstride + w * 32 + lane] = v;
  }
}

// Tables (g * zr + r - r0) * kNibbles + n of the adjoint, for the 32-row
// words r0 <= r < r0 + zr of every row segment g: the signed sums of z over
// rows lo_g + 32 r + kGroup n + (0..kGroup-1), two threads a table.
__device__ __forceinline__ void z_tables(const float* z, double* ztab, int s, int G, int r0,
                                         const RadPlan& P) {
  const int per_seg = P.zr * kNibbles;
  for (int e = threadIdx.x; e < 2 * G * per_seg; e += kThreads) {
    const int t = e >> 1, g = t / per_seg;
    const int lo = cut<true>(s, G, g), hi = cut<true>(s, G, g + 1);
    half_table(z, lo + 32 * r0 + kGroup * (t - g * per_seg), hi, t, e & 1, ztab + t * kTable);
  }
}

// Tables (w - w0) * kNibbles + n of the forward, for the 32-column words
// w0 <= w < w0 + xw: the signed sums of x over the CTA's columns
// 32 w + kGroup n + (0..kGroup-1), two threads a table.
__device__ __forceinline__ void x_tables(const float* x, double* xtab, int cw, int w0,
                                         const RadPlan& P) {
  const int n = 2 * min(P.xw, P.words - w0) * kNibbles;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int t = e >> 1;
    half_table(x, w0 * 32 + kGroup * t, cw, t, e & 1, xtab + t * kTable);
  }
}

// acc plus the entries of one word's tables tw that the nibbles of b pick,
// nibble 0 first.
__device__ __forceinline__ double add_word(double acc, const double* tw, uint32_t b) {
#pragma unroll
  for (int n = 0; n < kNibbles; ++n) acc += tw[n * kTable + ((b >> (kGroup * n)) & (kTable - 1))];
  return acc;
}

// apart[g * words * 32 + j] = sum over rows of segment g of A[i, c0 + j] z[i],
// for the CTA's columns j < cw: the rows' groups of kGroup ascending, one
// table lookup each, the tables zr row words of every segment at a time.
__device__ __forceinline__ void adjoint_tables(const float* z, const uint32_t* amat,
                                               const uint32_t* bits_t, double* apart,
                                               double* ztab, int s, int G, int cw,
                                               const RadPlan& P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = 0; r0 < P.seg_words; r0 += P.zr) {
    if (r0 > 0) __syncthreads();  // every column is done with the last tables
    z_tables(z, ztab, s, G, r0, P);
    __syncthreads();
    for (int u = warp; u < P.words * G; u += kWarps) {
      const int w = u % P.words, g = u / P.words;
      const int j = w * 32 + lane;
      const int lo = cut<true>(s, G, g), hi = cut<true>(s, G, g + 1);
      const int r1 = min(r0 + P.zr, (hi - lo + 31) / 32);
      const double* tab = ztab + g * P.zr * kWordTables;  // row word r at r - r0
      double acc = r0 > 0 ? apart[g * P.words * 32 + j] : 0.0;
      if (P.tstride > 0) {
        if (j < cw) {
          const uint32_t* bits = bits_t + g * P.seg_words * P.tstride + j;
          for (int r = r0; r < r1; ++r)
            acc = add_word(acc, tab + (r - r0) * kWordTables, bits[r * P.tstride]);
        }
      } else {
        for (int r = r0; r < r1; ++r) {
          const uint32_t b = column_word(amat, lo, hi, r, w, lane, P);
          if (j < cw) acc = add_word(acc, tab + (r - r0) * kWordTables, b);
        }
      }
      apart[g * P.words * 32 + j] = acc;
    }
  }
}

// part[i] = sum over the CTA's columns of A[i, c0 + j] x[j], for every row
// i < s: the columns' groups of kGroup ascending, one table lookup each, the
// tables xw words at a time.  x is complete when it is called.
__device__ __forceinline__ void forward_tables(const float* x, const uint32_t* amat,
                                               double* part, double* xtab, int s, int cw,
                                               const RadPlan& P) {
  for (int w0 = 0; w0 < P.words; w0 += P.xw) {
    if (w0 > 0) __syncthreads();  // every row is done with the last tables
    x_tables(x, xtab, cw, w0, P);
    __syncthreads();
    const int w1 = min(w0 + P.xw, P.words);
    for (int i0 = threadIdx.x; i0 < s; i0 += kThreads * kRowsPerPass) {
      double sum[kRowsPerPass];
#pragma unroll
      for (int k = 0; k < kRowsPerPass; ++k) {
        const int i = i0 + k * kThreads;
        sum[k] = w0 > 0 && i < s ? part[i] : 0.0;
      }
      for (int w = w0; w < w1; ++w) {
        uint32_t bits[kRowsPerPass];
#pragma unroll
        for (int k = 0; k < kRowsPerPass; ++k) {
          const int i = i0 + k * kThreads;
          bits[k] = i < s ? amat[P.row_word(i, w)] : 0u;
        }
        const double* tw = xtab + (w - w0) * kWordTables;
#pragma unroll
        for (int n = 0; n < kNibbles; ++n) {
#pragma unroll
          for (int k = 0; k < kRowsPerPass; ++k)
            sum[k] += tw[n * kTable + ((bits[k] >> (kGroup * n)) & (kTable - 1))];
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPerPass; ++k) {
        const int i = i0 + k * kThreads;
        if (i < s) part[i] = sum[k];
      }
    }
  }
}

// sums[i] = the sum over the cluster's CTAs, in rank order, of entry r0 + i
// of each CTA's `part`, for this CTA's rows i < rw.  A thread loads
// kRankBatch ranks' partials at once, so that they are in flight together,
// then adds them in rank order.
__device__ __forceinline__ void rank_sums(cg::cluster_group& cluster, double* part, int r0,
                                          int rw, int K, double* sums) {
  for (int i = threadIdx.x; i < rw; i += kThreads) {
    double sum = 0.0;
    for (int q0 = 0; q0 < K; q0 += kRankBatch) {
      double v[kRankBatch];
#pragma unroll
      for (int u = 0; u < kRankBatch; ++u)
        v[u] = q0 + u < K ? cluster.map_shared_rank(part, q0 + u)[r0 + i] : 0.0;
#pragma unroll
      for (int u = 0; u < kRankBatch; ++u)
        if (q0 + u < K) sum += v[u];
    }
    sums[i] = sum;
  }
}

// z[i] = z'[i] for every row, from CTA floor(((i + 1) K - 1) / s), the last
// whose rows start at or before i; two loads in flight a thread.
__device__ __forceinline__ void gather_z(cg::cluster_group& cluster, double* znew, float* z,
                                         int s, int K) {
  for (int i = threadIdx.x; i < s; i += 2 * kThreads) {
    double v[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int ik = i + k * kThreads;
      v[k] = 0.0;
      if (ik < s) {
        const int q = static_cast<int>((static_cast<uint32_t>(ik + 1) * K - 1) /
                                       static_cast<uint32_t>(s));
        v[k] = cluster.map_shared_rank(znew, q)[ik - cut<true>(s, K, q)];
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (i + k * kThreads < s) z[i + k * kThreads] = static_cast<float>(v[k]);
  }
}

// One block of one point, decoded by this CTA and its cluster.
template <bool RAD>
__device__ __forceinline__ void decode(const float* __restrict__ yb,
                                       const uint32_t* __restrict__ seed_p,
                                       const uint32_t* __restrict__ offset_p,
                                       float* __restrict__ xb, int s, int c, int K, int G,
                                       int iters, float mult, int debias, float scale) {
  // z and x hold float32 values: floats on the Rademacher path
  using Real = std::conditional_t<RAD, float, double>;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t b = blockIdx.x / K;
  // row of yb and xb: point blockIdx.y's block b
  const int64_t row = static_cast<int64_t>(blockIdx.y) * gridDim.x / K + b;
  const int tid = threadIdx.x;
  const int c0 = cut<RAD>(c, K, rank), cw = cut<RAD>(c, K, rank + 1) - c0;
  const int r0 = cut<RAD>(s, K, rank), rw = cut<RAD>(s, K, rank + 1) - r0;
  const std::conditional_t<RAD, RadPlan, Plan> P(s, c, K, G);

  // Gaussian: z, the partials, x, then the doubles and words below.
  // Rademacher: the region of partials and tables (RadPlan), then the
  // doubles and words below, then z, x, the sign bits and their copy.
  extern __shared__ double smem[];
  Real* z;
  Real* x;
  double* part;                            // this CTA's partials: s forward
  double* znew;                            // rw: z' on this CTA's rows
  if constexpr (RAD) {
    part = smem;
    znew = part + P.region;
  } else {
    z = smem;
    part = z + s;
    x = part + P.part_len;
    znew = x + P.cw_max;
  }
  double* dslot = znew + P.rows_max;       // [0] ||z||^2, [1] <Ax,y>, [2] <Ax,Ax>
                                           // shares of this CTA; [3] broadcast
  double* dscratch = dslot + 4;            // kWarps
  int* iscratch = reinterpret_cast<int*>(dscratch + kWarps);  // kWarps
  int* islot = iscratch + kWarps;          // ||x'||_0 on this CTA's columns
  float* y = reinterpret_cast<float*>(islot + 1);             // rw
  // amat: Rademacher, the sign bits of A_b[:, c0:c0+cw], row i word w holding
  // columns c0 + 32 w + (0..31) at bits 0..31 (RadPlan::row_word), then their
  // column-major copy bits_t; Gaussian, the s row hashes.
  uint32_t* amat;
  if constexpr (RAD) {
    z = y + P.rows_max;
    x = z + s;
    amat = reinterpret_cast<uint32_t*>(x + P.cw_max);
  } else {
    amat = reinterpret_cast<uint32_t*>(y + P.rows_max);
  }

  const uint32_t hb = block_hash(*seed_p, *offset_p + static_cast<uint32_t>(b));
  const float* yrow = yb + row * s;
  for (int i = tid; i < s; i += kThreads) z[i] = yrow[i];
  for (int i = tid; i < rw; i += kThreads) y[i] = yrow[r0 + i];
  for (int j = tid; j < cw; j += kThreads) x[j] = Real(0);
  if constexpr (RAD) {
    for (int idx = tid; idx < s * P.words; idx += kThreads) {
      const int i = idx / P.words, w = idx % P.words;
      const uint32_t hr = row_hash(hb, static_cast<uint32_t>(i));
      const int jn = min(32, cw - w * 32);
      uint32_t bits = 0u;
      for (int t = 0; t < jn; ++t)
        bits |= (entry_hash(hr, static_cast<uint32_t>(c0 + w * 32 + t)) >> 31) << t;
      amat[P.row_word(i, w)] = bits;
    }
    if (P.tstride > 0) {
      __syncthreads();
      transpose_bits(amat, amat + s * P.words, s, G, P);
    }
  } else {
    for (int i = tid; i < s; i += kThreads) amat[i] = row_hash(hb, static_cast<uint32_t>(i));
  }
  __syncthreads();

  // ||y||^2: this CTA's rows, then the K shares in rank order
  double ss = 0.0;
  for (int i = tid; i < rw; i += kThreads) ss += static_cast<double>(z[r0 + i]) * z[r0 + i];
  ss = block_sum(ss, dscratch);
  if (tid == 0) dslot[0] = ss;
  cluster.sync();
  double zz = cluster_sum(cluster, dslot, K, dslot + 3);

  const float sqrt_s = sqrtf(static_cast<float>(s));
  for (int it = 0; it < iters; ++it) {
    const float tau = __fmul_rn(mult, __fdiv_rn(static_cast<float>(sqrt(zz)), sqrt_s));

    // 1. adjoint and soft threshold on this CTA's columns (the Rademacher
    // adjoint's partials at the start of the region, its tables after them)
    if constexpr (RAD)
      adjoint_tables(z, amat, amat + s * P.words, part, part + P.apart_len, s, G, cw, P);
    else
      adjoint(z, amat, part, s, c0, cw, P, G, scale);
    __syncthreads();
    int nnz = 0;
    for (int j = tid; j < cw; j += kThreads) {
      double acc = 0.0;
      for (int g = 0; g < G; ++g) acc += part[g * P.words * 32 + j];
      const float r = __fadd_rn(static_cast<float>(x[j]), finish<RAD>(acc, scale));
      const float xn = soft_nan(r, tau);
      x[j] = xn;
      nnz += xn != 0.0f ? 1 : 0;
    }
    nnz = block_sum(nnz, iscratch);  // ends with a barrier: x is complete
    if (tid == 0) *islot = nnz;

    // 2. forward partials over this CTA's columns, all rows (the Rademacher
    // forward's tables after the s partials)
    if constexpr (RAD)
      forward_tables(x, amat, part, part + s, s, cw, P);
    else
      forward(x, amat, part, s, c0, cw, P, scale);
    cluster.sync();

    // 3. this CTA's rows: the K partials in rank order, z', ||z'||^2 share.
    // Rademacher: the rank-order sums into znew first, each row by the
    // thread that reads it next, and ||x'||_0 added by each warp (an int
    // sum, in any order), its loads in flight with the partials'
    int total = 0;
    if constexpr (RAD) {
      const int lane = tid & 31;
      const int count = lane < K ? *cluster.map_shared_rank(islot, lane) : 0;
      rank_sums(cluster, part, r0, rw, K, znew);
      total = __reduce_add_sync(0xffffffffu, count);
    } else {
      for (int q = 0; q < K; ++q) total += *cluster.map_shared_rank(islot, q);
    }
    const float onsager = __fdiv_rn(static_cast<float>(total), static_cast<float>(s));
    ss = 0.0;
    for (int i = tid; i < rw; i += kThreads) {
      double sum = 0.0;
      if constexpr (RAD)
        sum = znew[i];
      else
        for (int q = 0; q < K; ++q) sum += cluster.map_shared_rank(part, q)[r0 + i];
      const float zn = __fadd_rn(__fsub_rn(y[i], finish<RAD>(sum, scale)),
                                 __fmul_rn(static_cast<float>(z[r0 + i]), onsager));
      znew[i] = zn;
      ss += static_cast<double>(zn) * zn;
    }
    ss = block_sum(ss, dscratch);
    if (tid == 0) dslot[0] = ss;
    cluster.sync();

    // 4. the whole z' and ||z'||^2 from every CTA, in rank order
    if constexpr (RAD) {
      gather_z(cluster, znew, z, s, K);
    } else {
      for (int q = 0; q < K; ++q) {
        const double* peer = cluster.map_shared_rank(znew, q);
        const int lo = cut(s, K, q), n = cut(s, K, q + 1) - lo;
        for (int i = tid; i < n; i += kThreads) z[lo + i] = peer[i];
      }
    }
    zz = cluster_sum(cluster, dslot, K, dslot + 3);
  }

  float factor = 1.0f;
  if (debias) {
    if constexpr (RAD) {
      forward_tables(x, amat, part, part + s, s, cw, P);
      cluster.sync();
      rank_sums(cluster, part, r0, rw, K, znew);
    } else {
      forward(x, amat, part, s, c0, cw, P, scale);
      cluster.sync();
    }
    double num = 0.0, den = 0.0;
    for (int i = tid; i < rw; i += kThreads) {
      double sum = 0.0;
      if constexpr (RAD)
        sum = znew[i];
      else
        for (int q = 0; q < K; ++q) sum += cluster.map_shared_rank(part, q)[r0 + i];
      const float ax = finish<RAD>(sum, scale);
      num += static_cast<double>(ax) * y[i];
      den += static_cast<double>(ax) * ax;
    }
    num = block_sum(num, dscratch);
    den = block_sum(den, dscratch);
    if (tid == 0) {
      dslot[1] = num;
      dslot[2] = den;
    }
    cluster.sync();
    num = cluster_sum(cluster, dslot + 1, K, dslot + 3);
    den = cluster_sum(cluster, dslot + 2, K, dslot + 3);
    // max(den, 1e-12) keeps a NaN den, as the plain version's clamp does
    const double den_safe = den > 1e-12 || den != den ? den : 1e-12;
    factor = clip12_nan(static_cast<float>(num / den_safe));
  }
  for (int j = tid; j < cw; j += kThreads)
    xb[row * c + c0 + j] = __fmul_rn(static_cast<float>(x[j]), factor);
  cluster.sync();  // no CTA leaves while a peer may still read its memory
}

template <bool RAD>
__global__ void amp_fused_kernel(const float* __restrict__ yb,
                                 const uint32_t* __restrict__ seed_p,
                                 const uint32_t* __restrict__ offset_p,
                                 float* __restrict__ xb, int s, int c, int K, int G,
                                 int iters, float mult, int debias, float scale);

// The Gaussian path leaves the registers to the compiler; two Rademacher
// CTAs share an SM, at 64 registers a thread.
template <>
__global__ void __launch_bounds__(kThreads)
amp_fused_kernel<false>(const float* __restrict__ yb, const uint32_t* __restrict__ seed_p,
                        const uint32_t* __restrict__ offset_p, float* __restrict__ xb,
                        int s, int c, int K, int G, int iters, float mult, int debias,
                        float scale) {
  decode<false>(yb, seed_p, offset_p, xb, s, c, K, G, iters, mult, debias, scale);
}

template <>
__global__ void __launch_bounds__(kThreads, 2)
amp_fused_kernel<true>(const float* __restrict__ yb, const uint32_t* __restrict__ seed_p,
                       const uint32_t* __restrict__ offset_p, float* __restrict__ xb,
                       int s, int c, int K, int G, int iters, float mult, int debias,
                       float scale) {
  decode<true>(yb, seed_p, offset_p, xb, s, c, K, G, iters, mult, debias, scale);
}

// The attributes are caps of the kernel function, whatever the launch: set
// them once to the most any launch may use.
template <bool RAD>
cudaError_t configure() {
  static cudaError_t status = [] {
    cudaError_t err = cudaFuncSetAttribute(
        amp_fused_kernel<RAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(amp_fused_kernel<RAD>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  }();
  return status;
}

// The launch configuration of G points of n_blocks blocks.
cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr, int n_blocks, int points,
                                 int K, int bytes, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(K) * n_blocks, static_cast<unsigned>(points));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of this shape the card holds at once, or a negative CUDA error.
template <bool RAD>
int max_active_clusters(int s, int c, int K, int G) {
  cudaError_t err = configure<RAD>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(
      attr, 1, 1, K, static_cast<int>(smem_bytes(s, c, K, G, RAD)), nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, amp_fused_kernel<RAD>, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}

template <bool RAD>
int launch(const float* yb, const uint32_t* seed, const uint32_t* id_offset,
           float* xb, int n_blocks, int points, int s, int c, int K, int G, int iters,
           float mult, int debias, float scale, cudaStream_t stream) {
  const int bytes = static_cast<int>(smem_bytes(s, c, K, G, RAD));
  auto kernel = amp_fused_kernel<RAD>;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(attr, n_blocks, points, K, bytes, stream);

  cudaError_t err = configure<RAD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  // Check that one cluster of this shape fits the card, once per shape.
  static int checked_k = 0, checked_bytes = -1;
  if (checked_k != K || checked_bytes != bytes) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    checked_k = K;
    checked_bytes = bytes;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, yb, seed, id_offset, xb, s, c, K, G, iters,
                           mult, debias, scale);
  // cudaLaunchKernelEx returns this launch's own status; clear it from the
  // runtime's last-error state so that no later caller picks it up
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// Shared memory of one CTA for blocks of s rows and c columns, decoded by
// clusters of K CTAs with G row segments in the adjoint.
extern "C" int64_t amp_fused_smem_bytes(int s, int c, int K, int G, int rademacher) {
  return smem_bytes(s, c, K, G, rademacher != 0);
}

// Clusters of K CTAs decoding s x c blocks that the card holds at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error code.
extern "C" int amp_fused_max_active_clusters(int s, int c, int K, int G, int rademacher) {
  return rademacher ? max_active_clusters<true>(s, c, K, G)
                    : max_active_clusters<false>(s, c, K, G);
}

// yb: (points, n_blocks, s) float32; xb: (points, n_blocks, c) float32;
// seed, id_offset: one uint32 each in device memory; K, G from layout.py;
// scale = f32(1/sqrt(s)).
extern "C" int amp_fused_launch(const float* yb, const uint32_t* seed,
                                const uint32_t* id_offset, float* xb,
                                int n_blocks, int points, int s, int c, int K, int G,
                                int iters, float threshold_mult, int debias,
                                int rademacher, float scale, void* stream) {
  if (n_blocks <= 0 || points <= 0 || c <= 0) return 0;
  if (K < 1 || K > kMaxCluster || K > s || G < 1 || G > s || points > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes(s, c, K, G, rademacher != 0) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto st = static_cast<cudaStream_t>(stream);
  return rademacher ? launch<true>(yb, seed, id_offset, xb, n_blocks, points, s, c, K, G,
                                   iters, threshold_mult, debias, scale, st)
                    : launch<false>(yb, seed, id_offset, xb, n_blocks, points, s, c, K, G,
                                    iters, threshold_mult, debias, scale, st);
}
