// Blocked adjoint projection r[m, b] = A_b^T y[m, b] for M devices at once.
//
// Replaces the TPU kernel repro/kernels/ota_project.py::ota_project_t_pallas
// (body _t_kernel).
//
// What bounds it on an H100: integer operations.  Only y and r move through
// device memory (40 KB at the path's 1 x 2 x 1024 -> 4096), while every
// entry of A_b is made from the counter hash of (seed, b, row, col), about
// nine integer operations on the SM's 64 int32 lanes, and then takes one
// float64 add per device.  A_b is never stored.
//
// The work is cut four ways (kernels/layout.py):
//
//   grid    = (CS * tiles, min(n_blocks, 65 535), groups), clusters of CS
//             CTAs along x (CS = 8 at s_block = 1024, each CTA at least 128
//             rows; tiles of 256 columns; device groups of at most 8,
//             near-equal: 25 -> 6, 6, 6, 7); a CTA takes blocks blockIdx.y,
//             + gridDim.y, ... in turn;
//   cluster = one block b, one tile, one group of devices: CTA rank q owns
//             the rows [q s / CS, (q+1) s / CS);
//   CTA     = 2 row groups of 128 threads, each a contiguous half of the
//             CTA's rows;
//   thread  = a register tile of 2 columns (t and t + 128 of the tile) x
//             the device group's MD devices.
//
// Each row group stages its rows' hashes row_hash(block_hash(seed, b), i)
// and its devices' y (as doubles) in shared memory, 128 rows at a time.
// Every thread of a group reads the same row at the same time, so those
// reads are broadcasts, and four rows' hashes come in one 16-byte load.
// Each staged row hash feeds 2 entries, each entry MD devices, each y value
// 2 columns.  At the path's shape the grid has 256 CTAs of 8 warps, about
// two on each of the 132 SMs, where the kernel it replaces had 32 CTAs.
//
// Sums run in double and are rounded once to float, as the plain version
// (ref.py::ota_project_t_ref) rounds them.  A thread sums its group's rows
// in ascending order from 0.0; the two groups' partials are added in group
// order, and the CS CTAs' partials of a column in rank order through
// distributed shared memory by the CTA that writes the column: no atomics,
// so runs are bitwise repeatable.  Rademacher entries accumulate +-y (a
// sign-bit flip) and the scale 1/sqrt(s_block) is applied after the dot;
// Gaussian entries are made by Box-Muller (precise logf and cosf) and
// multiplied in.  The shared memory is static (17 KB) and needs no
// attribute, so a launch sets no state of the kernel function and can be
// captured in a CUDA graph.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace cg = cooperative_groups;

namespace {

using repro_torch::block_hash;
using repro_torch::entry_hash;
using repro_torch::gaussian_entry;
using repro_torch::row_hash;
using repro_torch::signed_by;

constexpr int kColThreads = 128;               // layout.py OTA_T_COLUMN_THREADS
constexpr int kGroups = 2;                     // layout.py OTA_T_ROW_GROUPS
constexpr int kThreads = kColThreads * kGroups;  // layout.py OTA_T_THREADS
constexpr int kCols = 2;                       // layout.py OTA_T_COLS_PER_THREAD
constexpr int kTileCols = kColThreads * kCols;   // layout.py OTA_T_TILE_COLS
constexpr int kMaxDevices = 8;                 // layout.py OTA_MAX_DEVICES
constexpr int kMaxCluster = 8;                 // layout.py OTA_T_MAX_CLUSTER
constexpr int kChunk = 128;                    // staged rows per group and pass
constexpr int kMaxGridY = 65535;               // the grid's y limit; more blocks loop
static_assert(kChunk % 4 == 0, "rows are read four at a time");
static_assert(kGroups * kChunk >= kTileCols, "the staging buffer holds the partials too");

// Start of part k of n items cut into `parts` (layout.py::cut).
__device__ __forceinline__ int cut(int n, int parts, int k) {
  return static_cast<int>(static_cast<int64_t>(k) * n / parts);
}

template <int MD, bool RAD>
__device__ __forceinline__ void tile(const float* __restrict__ y, float* __restrict__ r,
                                     uint32_t* hr, double* buf,
                                     cg::cluster_group& cluster, int rank, int CS,
                                     uint32_t hb, int d0, int b, int n_blocks,
                                     int s_block, int c, int col0, float scale) {
  const int lane = threadIdx.x % kColThreads, group = threadIdx.x / kColThreads;
  // the CTA's rows, and this thread's group's share of them
  const int i0 = cut(s_block, CS, rank), height = cut(s_block, CS, rank + 1) - i0;
  const int g0 = i0 + cut(height, kGroups, group);
  const int g1 = i0 + cut(height, kGroups, group + 1);
  const int widest = (height + kGroups - 1) / kGroups;  // the groups differ by at most 1
  uint32_t* hg = hr + group * kChunk;
  double* yg = buf + group * MD * kChunk;

  uint32_t col[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    col[k] = static_cast<uint32_t>(col0 + lane + k * kColThreads);
  double acc[kCols][MD];
#pragma unroll
  for (int k = 0; k < kCols; ++k)
#pragma unroll
    for (int d = 0; d < MD; ++d) acc[k][d] = 0.0;

  // yg[d * kChunk + ii] holds y[d0 + d, b, p + ii].  The rows are padded to
  // a multiple of 4 with y = 0: an accumulator starts at +0.0 and so never
  // holds -0.0, and adding +-0.0 to it changes no bit.
  for (int pass = 0; pass < widest; pass += kChunk) {
    const int p = g0 + pass;
    const int rows = max(0, min(kChunk, g1 - p)), rows4 = (rows + 3) & ~3;
    __syncthreads();
    // y's loads first, so that their latency hides behind the row hashes
    for (int idx = lane; idx < MD * rows4; idx += kColThreads) {
      const int d = idx / rows4, ii = idx - d * rows4;
      yg[d * kChunk + ii] =
          ii < rows ? static_cast<double>(
                          y[(static_cast<int64_t>(d0 + d) * n_blocks + b) * s_block + p + ii])
                    : 0.0;
    }
    for (int ii = lane; ii < rows4; ii += kColThreads)
      hg[ii] = ii < rows ? row_hash(hb, static_cast<uint32_t>(p + ii)) : 0u;
    __syncthreads();
    for (int ii = 0; ii < rows4; ii += 4) {
      const uint4 h4 = *reinterpret_cast<const uint4*>(hg + ii);
      const uint32_t hrow[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        double yv[MD];
#pragma unroll
        for (int d = 0; d < MD; ++d) yv[d] = yg[d * kChunk + ii + u];
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const uint32_t h = entry_hash(hrow[u], col[k]);
          if (RAD) {
#pragma unroll
            for (int d = 0; d < MD; ++d) acc[k][d] += signed_by(h, yv[d]);
          } else {
            const double a = static_cast<double>(__fmul_rn(gaussian_entry(h), scale));
#pragma unroll
            for (int d = 0; d < MD; ++d) acc[k][d] = fma(a, yv[d], acc[k][d]);
          }
        }
      }
    }
  }

  // the CTA's partials, buf[d * kTileCols + column in the tile]: group 1's,
  // then group 0's plus group 1's, in group order
  __syncthreads();
  if (group == 1) {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
#pragma unroll
      for (int d = 0; d < MD; ++d) buf[d * kTileCols + lane + k * kColThreads] = acc[k][d];
  }
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int k = 0; k < kCols; ++k)
#pragma unroll
      for (int d = 0; d < MD; ++d) {
        double* slot = buf + d * kTileCols + lane + k * kColThreads;
        *slot = acc[k][d] + *slot;
      }
  }
  cluster.sync();

  // CTA q writes its share of the tile's (device, column) outputs: the CS
  // CTAs' partials, all read at once, added in rank order
  const int o1 = cut(MD * kTileCols, CS, rank + 1);
  for (int o = cut(MD * kTileCols, CS, rank) + threadIdx.x; o < o1; o += kThreads) {
    const int d = o / kTileCols, j = col0 + o % kTileCols;
    if (j >= c) continue;
    double part[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      part[q] = q < CS ? cluster.map_shared_rank(buf, q)[o] : 0.0;
    double sum = 0.0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < CS) sum += part[q];
    r[(static_cast<int64_t>(d0 + d) * n_blocks + b) * c + j] =
        static_cast<float>(RAD ? sum * static_cast<double>(scale) : sum);
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partials
}

// MDMAX: the widest device group of the launch (1, 2, 4 or 8), so that a
// launch for one device holds no accumulators for eight.
template <int MDMAX, bool RAD>
__global__ void __launch_bounds__(kThreads)
ota_project_t_kernel(const float* __restrict__ y, const uint32_t* __restrict__ seed_p,
                     float* __restrict__ r, int m, int n_blocks, int s_block, int c,
                     int CS, int groups, float scale) {
  __shared__ __align__(16) uint32_t hr[kGroups * kChunk];   // the staged rows' hashes
  __shared__ double buf[kGroups * kMaxDevices * kChunk];    // staged y, then the partials
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int col0 = static_cast<int>(blockIdx.x / CS) * kTileCols;
  const int group = blockIdx.z;
  const int d0 = cut(m, groups, group), nd = cut(m, groups, group + 1) - d0;
  // blocks b, b + gridDim.y, ...: a launch of more blocks than the grid's
  // y limit (65 535) loops; every CTA of a cluster takes the same blocks
  for (int b = blockIdx.y; b < n_blocks; b += gridDim.y) {
    const uint32_t hb = block_hash(*seed_p, static_cast<uint32_t>(b));
#define REPRO_TILE(MD)                                                                     \
  case MD:                                                                                 \
    if constexpr (MD <= MDMAX)                                                             \
      tile<MD, RAD>(y, r, hr, buf, cluster, rank, CS, hb, d0, b, n_blocks, s_block, c,     \
                    col0, scale);                                                          \
    break;
    switch (nd) {
      REPRO_TILE(1)
      REPRO_TILE(2)
      REPRO_TILE(3)
      REPRO_TILE(4)
      REPRO_TILE(5)
      REPRO_TILE(6)
      REPRO_TILE(7)
      REPRO_TILE(8)
      default:
        break;
    }
#undef REPRO_TILE
  }
}

template <int MDMAX>
cudaError_t launch(const cudaLaunchConfig_t& cfg, const float* y, const uint32_t* seed,
                   float* r, int m, int n_blocks, int s_block, int c, int CS, int groups,
                   int rademacher, float scale) {
  return rademacher ? cudaLaunchKernelEx(&cfg, ota_project_t_kernel<MDMAX, true>, y, seed, r,
                                         m, n_blocks, s_block, c, CS, groups, scale)
                    : cudaLaunchKernelEx(&cfg, ota_project_t_kernel<MDMAX, false>, y, seed, r,
                                         m, n_blocks, s_block, c, CS, groups, scale);
}

}  // namespace

// y: (m, n_blocks, s_block) float32; r: (m, n_blocks, c) float32; seed: one
// uint32 in device memory; CS, groups from layout.py; scale = f32(1/sqrt(s_block)).
extern "C" int ota_project_t_launch(const float* y, const uint32_t* seed, float* r,
                                    int m, int n_blocks, int s_block, int c, int CS,
                                    int groups, int rademacher, float scale,
                                    void* stream) {
  if (m <= 0 || n_blocks <= 0 || c <= 0 || s_block <= 0) return 0;
  const int widest = groups < 1 ? 0 : (m + groups - 1) / groups;
  if (CS < 1 || CS > kMaxCluster || groups < 1 || widest > kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = (static_cast<int64_t>(c) + kTileCols - 1) / kTileCols;
  if (groups > 65535 || tiles * CS > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * CS), min(n_blocks, kMaxGridY), groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      widest == 1   ? launch<1>(cfg, y, seed, r, m, n_blocks, s_block, c, CS, groups, rademacher, scale)
      : widest == 2 ? launch<2>(cfg, y, seed, r, m, n_blocks, s_block, c, CS, groups, rademacher, scale)
      : widest <= 4 ? launch<4>(cfg, y, seed, r, m, n_blocks, s_block, c, CS, groups, rademacher, scale)
                    : launch<8>(cfg, y, seed, r, m, n_blocks, s_block, c, CS, groups, rademacher, scale);
  // cudaLaunchKernelEx returns this launch's own status; clear it from the
  // runtime's last-error state so that no later caller picks it up
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
