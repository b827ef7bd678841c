// Blocked compressive projection y[m, b] = A_b x[m, b] for M devices at once.
//
// Replaces the TPU kernel repro/kernels/ota_project.py::ota_project_pallas
// (body _fwd_kernel, helpers _tile_A and _splitmix32).
//
// What bounds it on an H100: operations.  Only x and y move through device
// memory, while every entry of A_b (16 MiB per block at 1024 x 4096) is made
// from about ten integer operations of the hash and then takes one float64
// multiply-add per device.
//
// A_b is never stored.  The work is cut four ways (kernels/layout.py):
//
//   grid    = (CS * G, min(n_blocks, 65 535), ceil(s_block / 128)), clusters
//             of CS CTAs along x (CS = 8 at c = 4096; G device groups); a
//             CTA takes blocks blockIdx.y, + gridDim.y, ... in turn;
//   cluster = one block b, one group of devices, one 128-row tile: CTA
//             rank q owns the columns [q c / CS, (q+1) c / CS);
//   CTA     = 4 warps, each a contiguous quarter of the CTA's columns;
//   thread  = a register tile of 4 rows (lane, lane + 32, ...) x the
//             group's MD devices.
//
// Devices are cut into the fewest groups of at most 8, near-equal (25: 6, 6,
// 6, 7), and the group's size MD picks the kernel body, so no accumulator
// adds zeros for a device that is not there.  For each column a thread makes
// its 4 entries once (each feeds MD devices), loads each device's x value
// once from shared memory as a broadcast (each feeds 4 rows), and adds with
// one float64 FMA of the entry (+-1.0 for Rademacher, the scale applied
// after the dot) and x: the product is exact, so the FMA rounds as an add.
// At 25 devices x 2 blocks x 4096 -> 1024 the grid has 512 CTAs.
//
// Sums run in double and are rounded once to float, as the plain version
// (ref.py::ota_project_ref) rounds them.  A thread sums its columns in
// ascending order; the 4 warps' partials are added in warp order, and the
// CS CTAs' partials in rank order through DSMEM, by the CTA that writes the
// row: no atomics, so runs are bitwise repeatable.
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

constexpr int kWarps = 4;                  // layout.py OTA_WARPS
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;                   // layout.py OTA_ROWS_PER_THREAD
constexpr int kTileRows = 32 * kRows;      // layout.py OTA_TILE_ROWS
constexpr int kMaxDevices = 8;             // layout.py OTA_MAX_DEVICES
constexpr int kMaxCluster = 8;             // layout.py OTA_MAX_CLUSTER
constexpr int kChunk = 128;                // staged columns per warp and pass
constexpr int kMaxGridY = 65535;           // the grid's y limit; more blocks loop

// Start of part k of n items cut into `parts` (layout.py::cut).
__device__ __forceinline__ int cut(int n, int parts, int k) {
  return static_cast<int>(static_cast<int64_t>(k) * n / parts);
}

template <int MD, bool RAD>
__device__ __forceinline__ void tile(const float* __restrict__ x, float* __restrict__ y,
                                     double* buf, double* cpart,
                                     cg::cluster_group& cluster, int rank, int CS,
                                     uint32_t hb, int d0, int b, int n_blocks, int c,
                                     int s_block, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.z * kTileRows;
  const int c0 = cut(c, CS, rank), cw = cut(c, CS, rank + 1) - c0;

  uint32_t hr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    hr[r] = row_hash(hb, static_cast<uint32_t>(row0 + r * 32 + lane));
  double acc[kRows][MD];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int d = 0; d < MD; ++d) acc[r][d] = 0.0;

  // warp w sums the columns [c0 + wlo, c0 + whi), staged kChunk at a time:
  // buf[(w * MD + d) * kChunk + t] holds x[d0 + d, b, c0 + wlo + pass + t]
  const int wlo = cut(cw, kWarps, warp), wn = cut(cw, kWarps, warp + 1) - wlo;
  const int widest = (cw + kWarps - 1) / kWarps;  // cut's parts differ by at most 1
  for (int pass = 0; pass < widest; pass += kChunk) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kWarps * MD * kChunk; idx += kThreads) {
      const int w = idx / (MD * kChunk), d = (idx / kChunk) % MD, t = idx % kChunk;
      const int lo = cut(cw, kWarps, w), n = cut(cw, kWarps, w + 1) - lo;
      buf[idx] = pass + t < n
                     ? x[(static_cast<int64_t>(d0 + d) * n_blocks + b) * c + c0 + lo + pass + t]
                     : 0.0;
    }
    __syncthreads();
    const double* xs = buf + warp * MD * kChunk;
    const int jn = min(kChunk, wn - pass);
    for (int t = 0; t < jn; ++t) {
      const uint32_t col = static_cast<uint32_t>(c0 + wlo + pass + t);
      double a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint32_t h = entry_hash(hr[r], col);
        a[r] = RAD ? ((h & 0x80000000u) ? -1.0 : 1.0)
                   : static_cast<double>(__fmul_rn(gaussian_entry(h), scale));
      }
#pragma unroll
      for (int d = 0; d < MD; ++d) {
        const double xv = xs[d * kChunk + t];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][d] = fma(a[r], xv, acc[r][d]);
      }
    }
  }

  // the warps' partials, then the CTA's partial in warp order
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int d = 0; d < MD; ++d) buf[(warp * MD + d) * kTileRows + r * 32 + lane] = acc[r][d];
  __syncthreads();
  for (int o = threadIdx.x; o < MD * kTileRows; o += kThreads) {
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += buf[w * MD * kTileRows + o];
    cpart[o] = sum;
  }
  cluster.sync();

  // CTA q writes its share of the tile's (device, row) outputs: the CS
  // CTAs' partials in rank order
  const int o1 = cut(MD * kTileRows, CS, rank + 1);
  for (int o = cut(MD * kTileRows, CS, rank) + threadIdx.x; o < o1; o += kThreads) {
    const int d = o / kTileRows, row = row0 + o % kTileRows;
    if (row >= s_block) continue;
    double sum = 0.0;
    for (int q = 0; q < CS; ++q) sum += cluster.map_shared_rank(cpart, q)[o];
    y[(static_cast<int64_t>(d0 + d) * n_blocks + b) * s_block + row] =
        static_cast<float>(RAD ? sum * static_cast<double>(scale) : sum);
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partials
}

template <bool RAD>
__global__ void __launch_bounds__(kThreads)
ota_project_kernel(const float* __restrict__ x, const uint32_t* __restrict__ seed_p,
                   float* __restrict__ y, int m, int n_blocks, int c, int s_block,
                   int CS, int groups, float scale) {
  __shared__ double buf[kWarps * kMaxDevices * kTileRows];  // x chunks, then partials
  __shared__ double cpart[kMaxDevices * kTileRows];          // the CTA's partial
  static_assert(kChunk <= kTileRows, "x chunks must fit the partials' buffer");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / CS;
  const int d0 = cut(m, groups, group), nd = cut(m, groups, group + 1) - d0;
  // blocks b, b + gridDim.y, ...: a launch of more blocks than the grid's
  // y limit (65 535) loops; every CTA of a cluster takes the same blocks
  for (int b = blockIdx.y; b < n_blocks; b += gridDim.y) {
    const uint32_t hb = block_hash(*seed_p, static_cast<uint32_t>(b));
#define REPRO_TILE(MD)                                                                  \
  case MD:                                                                              \
    tile<MD, RAD>(x, y, buf, cpart, cluster, rank, CS, hb, d0, b, n_blocks, c, s_block,   \
                  scale);                                                               \
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

}  // namespace

// x: (m, n_blocks, c) float32; y: (m, n_blocks, s_block) float32; seed: one
// uint32 in device memory; CS, groups from layout.py; scale = f32(1/sqrt(s_block)).
extern "C" int ota_project_launch(const float* x, const uint32_t* seed, float* y,
                                  int m, int n_blocks, int c, int s_block, int CS,
                                  int groups, int rademacher, float scale, void* stream) {
  if (m <= 0 || n_blocks <= 0 || c <= 0 || s_block <= 0) return 0;
  if (CS < 1 || CS > kMaxCluster || groups < 1 || (m + groups - 1) / groups > kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (s_block + kTileRows - 1) / kTileRows;
  if (tiles > 65535 || static_cast<int64_t>(CS) * groups > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(CS * groups), min(n_blocks, kMaxGridY), tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      rademacher ? cudaLaunchKernelEx(&cfg, ota_project_kernel<true>, x, seed, y, m, n_blocks,
                                      c, s_block, CS, groups, scale)
                 : cudaLaunchKernelEx(&cfg, ota_project_kernel<false>, x, seed, y, m, n_blocks,
                                      c, s_block, CS, groups, scale);
  // cudaLaunchKernelEx returns this launch's own status; clear it from the
  // runtime's last-error state so that no later caller picks it up
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}
