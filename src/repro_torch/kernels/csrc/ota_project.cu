// Blocked compressive projection y[m, b] = A_b x[m, b] for M devices at once.
//
// A_b (s_block x c) is never stored: each entry is made from the counter
// hash of (seed, b, row, col) where it is used.  All M devices share A_b, so
// a CTA makes each entry of its tile once and applies it to every device's
// vector:
//
//   grid  = (n_blocks, ceil(s_block / 32), ceil(M / MB))
//   block = 256 threads = 8 warps; lane = row inside the 32-row tile,
//           warp = a 1/8 share of the columns of each staged x chunk.
//
// The x chunks of the CTA's MB devices are staged in shared memory
// (MB x 128 values); every lane of a warp reads the same column, so those
// reads are broadcasts.  Each thread keeps MB partial sums in registers.
// The 8 warps' partials are then summed in warp order through shared memory,
// so the result does not depend on scheduling.
//
// Sums run in double and are rounded once to float, as the plain version
// (ref.py::ota_project_ref) rounds them, so the two agree to about an ulp.
// Rademacher entries accumulate +-x (a sign-bit flip) and the scale
// 1/sqrt(s_block) is applied after the dot; Gaussian entries are made by
// Box-Muller and multiplied in.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace {

using repro_torch::block_hash;
using repro_torch::entry_hash;
using repro_torch::gaussian_entry;
using repro_torch::row_hash;
using repro_torch::signed_by;

constexpr int kRows = 32;    // rows per CTA (one per lane)
constexpr int kWarps = 8;    // column shares per CTA
constexpr int kCols = 128;   // staged columns per chunk
constexpr int kThreads = kRows * kWarps;

template <int MB>
constexpr int smem_doubles() {
  return (MB * kCols > kWarps * MB * kRows) ? MB * kCols : kWarps * MB * kRows;
}

template <int MB, bool RAD>
__global__ void __launch_bounds__(kThreads)
ota_project_kernel(const float* __restrict__ x, const uint32_t* __restrict__ seed_p,
                   float* __restrict__ y, int m, int n_blocks, int c, int s_block,
                   float scale) {
  extern __shared__ double buf[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.y * kRows + lane;
  const int d0 = blockIdx.z * MB;
  const uint32_t hr = row_hash(block_hash(*seed_p, static_cast<uint32_t>(b)),
                               static_cast<uint32_t>(row));

  double acc[MB];
#pragma unroll
  for (int d = 0; d < MB; ++d) acc[d] = 0.0;

  constexpr int kShare = kCols / kWarps;
  for (int j0 = 0; j0 < c; j0 += kCols) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < MB * kCols; idx += kThreads) {
      const int d = idx / kCols, jj = idx % kCols;
      const int dev = d0 + d, j = j0 + jj;
      buf[idx] = (dev < m && j < c)
                     ? x[(static_cast<int64_t>(dev) * n_blocks + b) * c + j]
                     : 0.0;
    }
    __syncthreads();
    const int jend = min(kShare, c - j0 - warp * kShare);
    for (int t = 0; t < jend; ++t) {
      const int jj = warp * kShare + t;
      const uint32_t h = entry_hash(hr, static_cast<uint32_t>(j0 + jj));
      if (RAD) {
#pragma unroll
        for (int d = 0; d < MB; ++d) acc[d] += signed_by(h, buf[d * kCols + jj]);
      } else {
        const double a = __fmul_rn(gaussian_entry(h), scale);
#pragma unroll
        for (int d = 0; d < MB; ++d) acc[d] += a * buf[d * kCols + jj];
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int d = 0; d < MB; ++d) buf[(warp * MB + d) * kRows + lane] = acc[d];
  __syncthreads();
  for (int o = threadIdx.x; o < MB * kRows; o += kThreads) {
    const int d = o / kRows, r = o % kRows;
    const int dev = d0 + d, out_row = blockIdx.y * kRows + r;
    if (dev >= m || out_row >= s_block) continue;
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += buf[(w * MB + d) * kRows + r];
    y[(static_cast<int64_t>(dev) * n_blocks + b) * s_block + out_row] =
        static_cast<float>(RAD ? sum * static_cast<double>(scale) : sum);
  }
}

template <int MB, bool RAD>
int launch_one(const float* x, const uint32_t* seed, float* y, int m,
               int n_blocks, int c, int s_block, float scale,
               cudaStream_t stream) {
  constexpr int bytes = smem_doubles<MB>() * 8;
  cudaError_t err = cudaFuncSetAttribute(
      ota_project_kernel<MB, RAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_blocks, (s_block + kRows - 1) / kRows, (m + MB - 1) / MB);
  ota_project_kernel<MB, RAD><<<grid, kThreads, bytes, stream>>>(
      x, seed, y, m, n_blocks, c, s_block, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int MB>
int launch(const float* x, const uint32_t* seed, float* y, int m, int n_blocks,
           int c, int s_block, int rademacher, float scale, cudaStream_t stream) {
  return rademacher
             ? launch_one<MB, true>(x, seed, y, m, n_blocks, c, s_block, scale, stream)
             : launch_one<MB, false>(x, seed, y, m, n_blocks, c, s_block, scale, stream);
}

}  // namespace

// x: (m, n_blocks, c) float32; y: (m, n_blocks, s_block) float32; seed: one
// uint32 in device memory; scale = f32(1/sqrt(s_block)).
extern "C" int ota_project_launch(const float* x, const uint32_t* seed, float* y,
                                  int m, int n_blocks, int c, int s_block,
                                  int rademacher, float scale, void* stream) {
  if (m <= 0 || n_blocks <= 0 || c <= 0 || s_block <= 0) return 0;
  if ((s_block + kRows - 1) / kRows > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto st = static_cast<cudaStream_t>(stream);
  if (m <= 1) return launch<1>(x, seed, y, m, n_blocks, c, s_block, rademacher, scale, st);
  if (m <= 2) return launch<2>(x, seed, y, m, n_blocks, c, s_block, rademacher, scale, st);
  if (m <= 4) return launch<4>(x, seed, y, m, n_blocks, c, s_block, rademacher, scale, st);
  if (m <= 8) return launch<8>(x, seed, y, m, n_blocks, c, s_block, rademacher, scale, st);
  if (m <= 16) return launch<16>(x, seed, y, m, n_blocks, c, s_block, rademacher, scale, st);
  if ((m + 31) / 32 > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch<32>(x, seed, y, m, n_blocks, c, s_block, rademacher, scale, st);
}
