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
// and keeps a whole copy of z.  Rademacher entries are hashed ONCE per
// decode: the CTA's s x (c / K) slice of A_b is stored as sign bits in
// shared memory (64 KB at K = 8, 32 KB at K = 16), and every product reads
// bits.  Gaussian entries do not fit as floats and are made from the hash in
// every product, as before, but spread over K SMs.
//
// One iteration, with the peers' shared memory read through DSMEM:
//   1. adjoint on the CTA's columns over all rows, float64: warp = one
//      32-column word over one of G row segments (ascending rows), the G
//      partials added in segment order; then the soft threshold;
//   2. forward partials over the CTA's columns for all s rows, float64;
//      cluster.sync();
//   3. CTA k sums the K partials of its rows in rank order 0..K-1, forms
//      z' with the same _rn steps as the plain version, and its share of
//      ||z'||^2; ||x'||_0 is the sum of the K per-CTA counts; cluster.sync();
//   4. every CTA gathers the whole z' and the K shares of ||z'||^2, in rank
//      order.
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
// into a fused multiply-add.  Splitting a double sum into partials changes
// only the order of double adds, about 2^-53 relative against a float32
// ulp of 2^-24 (tests/test_torch_split_sums.py checks the split on the CPU).
// Every reduction runs in a fixed order, with no atomics, so runs are
// bitwise repeatable and a block decodes to the same bits in any range.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// Start of part k of n items cut into `parts` (layout.py::cut).
__host__ __device__ __forceinline__ int cut(int n, int parts, int k) {
  return static_cast<int>(static_cast<int64_t>(k) * n / parts);
}

// Sizes of one CTA's shared memory, on the host and the device alike.
struct Plan {
  int cw_max;    // widest column slice
  int words;     // 32-column words of it
  int wstride;   // words per row of the sign bits (odd: no bank conflicts)
  int rows_max;  // widest row slice
  int part_len;  // doubles of the partials: s forward, G * words * 32 adjoint
  __host__ __device__ Plan(int s, int c, int K, int G) {
    cw_max = (c + K - 1) / K;
    words = (cw_max + 31) / 32;
    wstride = words | 1;
    rows_max = (s + K - 1) / K;
    part_len = s > G * words * 32 ? s : G * words * 32;
  }
  __host__ __device__ int64_t bytes(int s, bool rad) const {
    const int64_t doubles = static_cast<int64_t>(s) + part_len + cw_max + rows_max + 4 + kWarps;
    const int64_t words32 = kWarps + 1 + rows_max +
                            (rad ? static_cast<int64_t>(s) * wstride : s);
    return doubles * 8 + words32 * 4;
  }
};

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

// part[g * words * 32 + j] = sum over rows of segment g, ascending, of
// A[i, c0 + j] z[i], for the CTA's columns j < cw.
template <bool RAD>
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
      for (int i = cut(s, G, g); i < i1; ++i) {
        if (RAD)
          acc += signed_by(amat[i * P.wstride + w] << (31 - lane), z[i]);
        else
          acc += gauss_term(entry_hash(amat[i], static_cast<uint32_t>(c0 + j)), z[i], scale);
      }
    }
    part[g * P.words * 32 + j] = acc;
  }
}

// part[i] = sum over the CTA's columns, ascending, of A[i, c0 + j] x[j], for
// every row i < s.
template <bool RAD>
__device__ __forceinline__ void forward(const double* x, const uint32_t* amat,
                                        double* part, int s, int c0, int cw,
                                        const Plan& P, float scale) {
  for (int i0 = threadIdx.x; i0 < s; i0 += kThreads * kRowsPerPass) {
    double sum[kRowsPerPass];
#pragma unroll
    for (int k = 0; k < kRowsPerPass; ++k) sum[k] = 0.0;
    if (RAD) {
      for (int w = 0; w < P.words; ++w) {
        uint32_t bits[kRowsPerPass];
#pragma unroll
        for (int k = 0; k < kRowsPerPass; ++k) {
          const int i = i0 + k * kThreads;
          bits[k] = i < s ? amat[i * P.wstride + w] : 0u;
        }
        const double* xw = x + w * 32;
        if (cw - w * 32 >= 32) {
#pragma unroll
          for (int t = 0; t < 32; ++t) {
#pragma unroll
            for (int k = 0; k < kRowsPerPass; ++k) sum[k] += signed_by(bits[k] << (31 - t), xw[t]);
          }
        } else {
          for (int t = 0; t < cw - w * 32; ++t) {
#pragma unroll
            for (int k = 0; k < kRowsPerPass; ++k) sum[k] += signed_by(bits[k] << (31 - t), xw[t]);
          }
        }
      }
    } else {
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
    }
#pragma unroll
    for (int k = 0; k < kRowsPerPass; ++k) {
      const int i = i0 + k * kThreads;
      if (i < s) part[i] = sum[k];
    }
  }
}

template <bool RAD>
__global__ void __launch_bounds__(kThreads)
amp_fused_kernel(const float* __restrict__ yb, const uint32_t* __restrict__ seed_p,
                 const uint32_t* __restrict__ offset_p, float* __restrict__ xb,
                 int s, int c, int K, int G, int iters, float mult, int debias,
                 float scale) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t b = blockIdx.x / K;
  // row of yb and xb: point blockIdx.y's block b
  const int64_t row = static_cast<int64_t>(blockIdx.y) * gridDim.x / K + b;
  const int tid = threadIdx.x;
  const int c0 = cut(c, K, rank), cw = cut(c, K, rank + 1) - c0;
  const int r0 = cut(s, K, rank), rw = cut(s, K, rank + 1) - r0;
  const Plan P(s, c, K, G);

  extern __shared__ double smem[];
  double* z = smem;                        // s: the whole z
  double* part = z + s;                    // part_len: this CTA's partials
  double* x = part + P.part_len;           // cw: x on this CTA's columns
  double* znew = x + P.cw_max;             // rw: z' on this CTA's rows
  double* dslot = znew + P.rows_max;       // [0] ||z||^2, [1] <Ax,y>, [2] <Ax,Ax>
                                           // shares of this CTA; [3] broadcast
  double* dscratch = dslot + 4;            // kWarps
  int* iscratch = reinterpret_cast<int*>(dscratch + kWarps);  // kWarps
  int* islot = iscratch + kWarps;          // ||x'||_0 on this CTA's columns
  float* y = reinterpret_cast<float*>(islot + 1);             // rw
  uint32_t* amat = reinterpret_cast<uint32_t*>(y + P.rows_max);
  // amat: Rademacher, the sign bits of A_b[:, c0:c0+cw], row i word w holding
  // columns c0 + 32 w + (0..31) at bits 0..31; Gaussian, the s row hashes.

  const uint32_t hb = block_hash(*seed_p, *offset_p + static_cast<uint32_t>(b));
  const float* yrow = yb + row * s;
  for (int i = tid; i < s; i += kThreads) z[i] = yrow[i];
  for (int i = tid; i < rw; i += kThreads) y[i] = yrow[r0 + i];
  for (int j = tid; j < cw; j += kThreads) x[j] = 0.0;
  if (RAD) {
    for (int idx = tid; idx < s * P.words; idx += kThreads) {
      const int i = idx / P.words, w = idx % P.words;
      const uint32_t hr = row_hash(hb, static_cast<uint32_t>(i));
      const int jn = min(32, cw - w * 32);
      uint32_t bits = 0u;
      for (int t = 0; t < jn; ++t)
        bits |= (entry_hash(hr, static_cast<uint32_t>(c0 + w * 32 + t)) >> 31) << t;
      amat[i * P.wstride + w] = bits;
    }
  } else {
    for (int i = tid; i < s; i += kThreads) amat[i] = row_hash(hb, static_cast<uint32_t>(i));
  }
  __syncthreads();

  // ||y||^2: this CTA's rows, then the K shares in rank order
  double ss = 0.0;
  for (int i = tid; i < rw; i += kThreads) ss += z[r0 + i] * z[r0 + i];
  ss = block_sum(ss, dscratch);
  if (tid == 0) dslot[0] = ss;
  cluster.sync();
  double zz = cluster_sum(cluster, dslot, K, dslot + 3);

  const float sqrt_s = sqrtf(static_cast<float>(s));
  for (int it = 0; it < iters; ++it) {
    const float tau = __fmul_rn(mult, __fdiv_rn(static_cast<float>(sqrt(zz)), sqrt_s));

    // 1. adjoint and soft threshold on this CTA's columns
    adjoint<RAD>(z, amat, part, s, c0, cw, P, G, scale);
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

    // 2. forward partials over this CTA's columns, all rows
    forward<RAD>(x, amat, part, s, c0, cw, P, scale);
    cluster.sync();

    // 3. this CTA's rows: the K partials in rank order, z', ||z'||^2 share
    int total = 0;
    for (int q = 0; q < K; ++q) total += *cluster.map_shared_rank(islot, q);
    const float onsager = __fdiv_rn(static_cast<float>(total), static_cast<float>(s));
    ss = 0.0;
    for (int i = tid; i < rw; i += kThreads) {
      double sum = 0.0;
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
    for (int q = 0; q < K; ++q) {
      const double* peer = cluster.map_shared_rank(znew, q);
      const int lo = cut(s, K, q), n = cut(s, K, q + 1) - lo;
      for (int i = tid; i < n; i += kThreads) z[lo + i] = peer[i];
    }
    zz = cluster_sum(cluster, dslot, K, dslot + 3);
  }

  float factor = 1.0f;
  if (debias) {
    forward<RAD>(x, amat, part, s, c0, cw, P, scale);
    cluster.sync();
    double num = 0.0, den = 0.0;
    for (int i = tid; i < rw; i += kThreads) {
      double sum = 0.0;
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
      attr, 1, 1, K, static_cast<int>(Plan(s, c, K, G).bytes(s, RAD)), nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, amp_fused_kernel<RAD>, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}

template <bool RAD>
int launch(const float* yb, const uint32_t* seed, const uint32_t* id_offset,
           float* xb, int n_blocks, int points, int s, int c, int K, int G, int iters,
           float mult, int debias, float scale, cudaStream_t stream) {
  const Plan P(s, c, K, G);
  const int bytes = static_cast<int>(P.bytes(s, RAD));
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
  return Plan(s, c, K, G).bytes(s, rademacher != 0);
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
  if (Plan(s, c, K, G).bytes(s, rademacher != 0) > 232448)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto st = static_cast<cudaStream_t>(stream);
  return rademacher ? launch<true>(yb, seed, id_offset, xb, n_blocks, points, s, c, K, G,
                                   iters, threshold_mult, debias, scale, st)
                    : launch<false>(yb, seed, id_offset, xb, n_blocks, points, s, c, K, G,
                                    iters, threshold_mult, debias, scale, st);
}
