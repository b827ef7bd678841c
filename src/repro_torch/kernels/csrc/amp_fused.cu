// Fused AMP decode: one launch runs every iteration and the debias for all
// blocks of the block-diagonal A.  Per block b (global id id_offset + b):
//
//   x = 0, z = y
//   repeat iters times:
//     sigma = ||z|| / sqrt(s)
//     x'    = soft(x + A^T z, mult * sigma)
//     z     = y - A x' + z * ||x'||_0 / s
//   debias: x *= clip(<Ax, y> / max(<Ax, Ax>, 1e-12), 1, 2)
//
// One CTA per block.  x (c values), z and y (s values each) and the s row
// hashes stay in shared memory for the whole decode; A is regenerated from
// the counter hash in every product (2 * iters + 1 passes), and never stored.
//
// Rounding follows the plain version (core/amp.py::amp_blocked_core) step
// for step: the products with A, ||z||^2 and the two debias dots are summed
// in double and rounded once to float; every other step is one float32
// operation, written with _rn intrinsics so that nvcc contracts none of them
// into a fused multiply-add.  AMP's soft threshold makes the decode
// sensitive to a one-ulp change of any entry near the threshold, so this is
// what keeps the kernel within rtol 1e-4 / atol 1e-5 of the plain version.
// All reductions are block-wide shuffles summed in a fixed order, with no
// atomics, so runs are bitwise repeatable and a block decodes to the same
// bits whatever range it is decoded in.
#include <cuda_runtime.h>

#include <cstdint>

#include "hash.cuh"

namespace {

using repro_torch::block_hash;
using repro_torch::block_sum;
using repro_torch::entry_hash;
using repro_torch::gaussian_entry;
using repro_torch::row_hash;
using repro_torch::signed_by;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerPass = 8;   // adjoint: columns a thread owns per pass
constexpr int kRowsPerPass = 2;   // forward: rows a thread owns per pass

// One term of a product with A: +-v for Rademacher entries (the scale is
// applied to the sum), the float entry times v (exact in double) otherwise.
template <bool RAD>
__device__ __forceinline__ double term(uint32_t h, double v, float scale) {
  return RAD ? signed_by(h, v)
             : static_cast<double>(__fmul_rn(gaussian_entry(h), scale)) * v;
}

template <bool RAD>
__device__ __forceinline__ float finish(double sum, float scale) {
  return static_cast<float>(RAD ? sum * static_cast<double>(scale) : sum);
}

// ax[k] = (A x)[i0 + k * kThreads] for this thread's rows
template <bool RAD>
__device__ __forceinline__ void forward_rows(const double* x, const uint32_t* hr,
                                             int i0, int s, int c, float scale,
                                             float* ax) {
  uint32_t hri[kRowsPerPass];
  double sum[kRowsPerPass];
#pragma unroll
  for (int k = 0; k < kRowsPerPass; ++k) {
    const int i = i0 + k * kThreads;
    hri[k] = i < s ? hr[i] : 0u;
    sum[k] = 0.0;
  }
  for (int j = 0; j < c; ++j) {
    const double xj = x[j];
#pragma unroll
    for (int k = 0; k < kRowsPerPass; ++k)
      sum[k] += term<RAD>(entry_hash(hri[k], static_cast<uint32_t>(j)), xj, scale);
  }
#pragma unroll
  for (int k = 0; k < kRowsPerPass; ++k) ax[k] = finish<RAD>(sum[k], scale);
}

template <bool RAD>
__global__ void __launch_bounds__(kThreads)
amp_fused_kernel(const float* __restrict__ yb, const uint32_t* __restrict__ seed_p,
                 const uint32_t* __restrict__ offset_p, float* __restrict__ xb,
                 int s, int c, int iters, float mult, int debias, float scale) {
  extern __shared__ double smem[];
  double* x = smem;                        // c float values, held as double
  double* z = x + c;                       // s float values, held as double
  double* dscratch = z + s;                // kWarps
  float* y = reinterpret_cast<float*>(dscratch + kWarps);
  float* fscratch = y + s;                 // kWarps
  uint32_t* hr = reinterpret_cast<uint32_t*>(fscratch + kWarps);

  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const uint32_t hb = block_hash(*seed_p, *offset_p + static_cast<uint32_t>(b));
  for (int i = tid; i < s; i += kThreads) {
    const float v = yb[b * s + i];
    y[i] = v;
    z[i] = v;
    hr[i] = row_hash(hb, static_cast<uint32_t>(i));
  }
  for (int j = tid; j < c; j += kThreads) x[j] = 0.0;
  const float sqrt_s = sqrtf(static_cast<float>(s));

  for (int it = 0; it < iters; ++it) {
    // sigma = ||z|| / sqrt(s) from this thread's rows (the rows it wrote)
    double ss = 0.0;
    for (int i = tid; i < s; i += kThreads) ss += z[i] * z[i];
    ss = block_sum(ss, dscratch);
    const float tau = __fmul_rn(mult, __fdiv_rn(static_cast<float>(sqrt(ss)), sqrt_s));

    // adjoint + soft threshold on this thread's columns
    float nnz = 0.0f;
    for (int j0 = tid; j0 < c; j0 += kThreads * kColsPerPass) {
      double acc[kColsPerPass];
#pragma unroll
      for (int k = 0; k < kColsPerPass; ++k) acc[k] = 0.0;
      for (int i = 0; i < s; ++i) {
        const uint32_t h_r = hr[i];
        const double zi = z[i];
#pragma unroll
        for (int k = 0; k < kColsPerPass; ++k) {
          const int j = j0 + k * kThreads;
          if (j < c) acc[k] += term<RAD>(entry_hash(h_r, static_cast<uint32_t>(j)), zi, scale);
        }
      }
#pragma unroll
      for (int k = 0; k < kColsPerPass; ++k) {
        const int j = j0 + k * kThreads;
        if (j >= c) continue;
        const float r = __fadd_rn(static_cast<float>(x[j]), finish<RAD>(acc[k], scale));
        const float mag = fmaxf(__fsub_rn(fabsf(r), tau), 0.0f);
        const float xn = r > 0.0f ? mag : (r < 0.0f ? -mag : 0.0f);
        x[j] = xn;
        nnz += xn != 0.0f ? 1.0f : 0.0f;
      }
    }
    nnz = block_sum(nnz, fscratch);  // exact: counts stay below 2^24
    const float onsager = __fdiv_rn(nnz, static_cast<float>(s));

    // forward on this thread's rows: z = (y - A x') + z * onsager
    for (int i0 = tid; i0 < s; i0 += kThreads * kRowsPerPass) {
      float ax[kRowsPerPass];
      forward_rows<RAD>(x, hr, i0, s, c, scale, ax);
#pragma unroll
      for (int k = 0; k < kRowsPerPass; ++k) {
        const int i = i0 + k * kThreads;
        if (i < s)
          z[i] = __fadd_rn(__fsub_rn(y[i], ax[k]),
                           __fmul_rn(static_cast<float>(z[i]), onsager));
      }
    }
  }

  float factor = 1.0f;
  if (debias) {
    double num = 0.0, den = 0.0;
    for (int i0 = tid; i0 < s; i0 += kThreads * kRowsPerPass) {
      float ax[kRowsPerPass];
      forward_rows<RAD>(x, hr, i0, s, c, scale, ax);
#pragma unroll
      for (int k = 0; k < kRowsPerPass; ++k) {
        const int i = i0 + k * kThreads;
        if (i < s) {
          num += static_cast<double>(ax[k]) * y[i];
          den += static_cast<double>(ax[k]) * ax[k];
        }
      }
    }
    num = block_sum(num, dscratch);
    den = block_sum(den, dscratch);
    factor = fminf(fmaxf(static_cast<float>(num / fmax(den, 1e-12)), 1.0f), 2.0f);
  }
  __syncthreads();
  for (int j = tid; j < c; j += kThreads)
    xb[b * c + j] = __fmul_rn(static_cast<float>(x[j]), factor);
}

}  // namespace

// Shared memory one CTA needs for blocks of s rows and c columns.
extern "C" int64_t amp_fused_smem_bytes(int s, int c) {
  return static_cast<int64_t>(c + s + kWarps) * 8 +
         static_cast<int64_t>(2 * s + kWarps) * 4;
}

// yb: (n_blocks, s) float32; xb: (n_blocks, c) float32; seed, id_offset:
// one uint32 each in device memory; scale = f32(1/sqrt(s)).
extern "C" int amp_fused_launch(const float* yb, const uint32_t* seed,
                                const uint32_t* id_offset, float* xb,
                                int n_blocks, int s, int c, int iters,
                                float threshold_mult, int debias, int rademacher,
                                float scale, void* stream) {
  if (n_blocks <= 0 || c <= 0) return 0;
  const int64_t smem = amp_fused_smem_bytes(s, c);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto st = static_cast<cudaStream_t>(stream);
  const int bytes = static_cast<int>(smem);
  cudaError_t err;
  if (rademacher) {
    err = cudaFuncSetAttribute(amp_fused_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    amp_fused_kernel<true><<<n_blocks, kThreads, bytes, st>>>(
        yb, seed, id_offset, xb, s, c, iters, threshold_mult, debias, scale);
  } else {
    err = cudaFuncSetAttribute(amp_fused_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    amp_fused_kernel<false><<<n_blocks, kThreads, bytes, st>>>(
        yb, seed, id_offset, xb, s, c, iters, threshold_mult, debias, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
