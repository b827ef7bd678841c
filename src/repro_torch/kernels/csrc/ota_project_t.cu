// Blocked adjoint projection r[m, b] = A_b^T y[m, b] for M devices at once.
//
// A_b (s_block x c) is never stored: each entry is made from the counter
// hash of (seed, b, row, col) where it is used, exactly as ota_project.cu
// makes it.  All M devices share A_b, so a CTA makes each entry it needs once
// and applies it to every one of its MB devices:
//
//   grid  = (n_blocks, ceil(c / 256), ceil(M / MB))
//   block = 256 threads; thread t owns column j = blockIdx.y * 256 + t.
//
// The CTA stages the row hashes row_hash(block_hash(seed, b), i) and its MB
// devices' y[., b, :] (as doubles) in shared memory, in chunks of rows that
// fit 200 KB; every thread reads the same row at the same time, so those
// reads are broadcasts.  Each thread then walks the rows in ascending order
// and keeps MB sums in registers.  There is no reduction across threads and
// no atomics, so two runs agree bitwise; the ragged tail of c is masked.
//
// Sums run in double and are rounded once to float, as the plain version
// (ref.py::ota_project_t_ref) rounds them.  Rademacher entries accumulate
// +-y (a sign-bit flip) and the scale 1/sqrt(s_block) is applied after the
// dot; Gaussian entries are made by Box-Muller and multiplied in.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "hash.cuh"

namespace {

using repro_torch::block_hash;
using repro_torch::entry_hash;
using repro_torch::gaussian_entry;
using repro_torch::row_hash;
using repro_torch::signed_by;

constexpr int kThreads = 256;              // columns per CTA
constexpr int kSmemBudget = 200 * 1024;    // staged rows' bytes per CTA

template <int MB>
constexpr int bytes_per_row() {
  return MB * static_cast<int>(sizeof(double)) + static_cast<int>(sizeof(uint32_t));
}

template <int MB, bool RAD>
__global__ void __launch_bounds__(kThreads)
ota_project_t_kernel(const float* __restrict__ y, const uint32_t* __restrict__ seed_p,
                     float* __restrict__ r, int m, int n_blocks, int s_block, int c,
                     int rows_chunk, float scale) {
  extern __shared__ double smem[];
  double* ys = smem;                                          // [MB][rows_chunk]
  uint32_t* hr = reinterpret_cast<uint32_t*>(smem + MB * rows_chunk);

  const int b = blockIdx.x;
  const int j = blockIdx.y * kThreads + threadIdx.x;
  const int d0 = blockIdx.z * MB;
  const bool active = j < c;
  const uint32_t hb = block_hash(*seed_p, static_cast<uint32_t>(b));

  double acc[MB];
#pragma unroll
  for (int d = 0; d < MB; ++d) acc[d] = 0.0;

  for (int i0 = 0; i0 < s_block; i0 += rows_chunk) {
    const int rows = min(rows_chunk, s_block - i0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < rows; idx += kThreads)
      hr[idx] = row_hash(hb, static_cast<uint32_t>(i0 + idx));
    for (int idx = threadIdx.x; idx < MB * rows; idx += kThreads) {
      const int d = idx / rows, ii = idx % rows;
      const int dev = d0 + d;
      ys[d * rows_chunk + ii] =
          dev < m ? y[(static_cast<int64_t>(dev) * n_blocks + b) * s_block + i0 + ii]
                  : 0.0;
    }
    __syncthreads();
    if (!active) continue;
    for (int ii = 0; ii < rows; ++ii) {
      const uint32_t h = entry_hash(hr[ii], static_cast<uint32_t>(j));
      if (RAD) {
#pragma unroll
        for (int d = 0; d < MB; ++d) acc[d] += signed_by(h, ys[d * rows_chunk + ii]);
      } else {
        const double a = __fmul_rn(gaussian_entry(h), scale);
#pragma unroll
        for (int d = 0; d < MB; ++d) acc[d] += a * ys[d * rows_chunk + ii];
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int d = 0; d < MB; ++d) {
    const int dev = d0 + d;
    if (dev >= m) break;
    r[(static_cast<int64_t>(dev) * n_blocks + b) * c + j] =
        static_cast<float>(RAD ? acc[d] * static_cast<double>(scale) : acc[d]);
  }
}

template <int MB, bool RAD>
int launch_one(const float* y, const uint32_t* seed, float* r, int m, int n_blocks,
               int s_block, int c, float scale, cudaStream_t stream) {
  const int rows_chunk = std::min(s_block, kSmemBudget / bytes_per_row<MB>());
  const int bytes = rows_chunk * bytes_per_row<MB>();
  cudaError_t err = cudaFuncSetAttribute(
      ota_project_t_kernel<MB, RAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_blocks, (c + kThreads - 1) / kThreads, (m + MB - 1) / MB);
  ota_project_t_kernel<MB, RAD><<<grid, kThreads, bytes, stream>>>(
      y, seed, r, m, n_blocks, s_block, c, rows_chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int MB>
int launch(const float* y, const uint32_t* seed, float* r, int m, int n_blocks,
           int s_block, int c, int rademacher, float scale, cudaStream_t stream) {
  return rademacher
             ? launch_one<MB, true>(y, seed, r, m, n_blocks, s_block, c, scale, stream)
             : launch_one<MB, false>(y, seed, r, m, n_blocks, s_block, c, scale, stream);
}

}  // namespace

// y: (m, n_blocks, s_block) float32; r: (m, n_blocks, c) float32; seed: one
// uint32 in device memory; scale = f32(1/sqrt(s_block)).
extern "C" int ota_project_t_launch(const float* y, const uint32_t* seed, float* r,
                                    int m, int n_blocks, int s_block, int c,
                                    int rademacher, float scale, void* stream) {
  if (m <= 0 || n_blocks <= 0 || c <= 0 || s_block <= 0) return 0;
  if ((c + kThreads - 1) / kThreads > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto st = static_cast<cudaStream_t>(stream);
  if (m <= 1) return launch<1>(y, seed, r, m, n_blocks, s_block, c, rademacher, scale, st);
  if (m <= 2) return launch<2>(y, seed, r, m, n_blocks, s_block, c, rademacher, scale, st);
  if (m <= 4) return launch<4>(y, seed, r, m, n_blocks, s_block, c, rademacher, scale, st);
  if (m <= 8) return launch<8>(y, seed, r, m, n_blocks, s_block, c, rademacher, scale, st);
  if (m <= 16) return launch<16>(y, seed, r, m, n_blocks, s_block, c, rademacher, scale, st);
  if ((m + 31) / 32 > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  return launch<32>(y, seed, r, m, n_blocks, s_block, c, rademacher, scale, st);
}
