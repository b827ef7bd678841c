// Counter-based hash of (seed, block, row, col) and helpers shared by the
// projection and AMP kernels.  Bitwise equal to repro_torch/kernels/ref.py::hash3:
//
//   hash3(seed, b, i, j) = mix(mix(mix(seed ^ b) ^ i) ^ j)
//
// with mix the lowbias32 finalizer.  The stages are hoisted: the block stage
// runs once per block, the row stage once per row, so only the column stage
// runs per entry of A.
#pragma once

#include <cstdint>

namespace repro_torch {

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  x ^= x >> 15;
  x *= 0x735A2D97u;
  x ^= x >> 15;
  return x;
}

__device__ __forceinline__ uint32_t block_hash(uint32_t seed, uint32_t block) {
  return splitmix32(seed ^ block);
}

__device__ __forceinline__ uint32_t row_hash(uint32_t hb, uint32_t row) {
  return splitmix32(hb ^ row);
}

__device__ __forceinline__ uint32_t entry_hash(uint32_t hr, uint32_t col) {
  return splitmix32(hr ^ col);
}

// Rademacher entries are +-scale: the kernels accumulate +-v by flipping the
// sign bit of v with the hash's top bit, and apply the scale after the dot.
__device__ __forceinline__ double signed_by(uint32_t h, double v) {
  const long long sign = static_cast<long long>(h & 0x80000000u) << 32;
  return __longlong_as_double(__double_as_longlong(v) ^ sign);
}

// Gaussian entry N(0, 1) by Box-Muller from h and mix(h ^ 0xDEADBEEF), with
// u = (f32(h) + 0.5) * 2^-32 as in ref.py; precise logf/cosf/sqrtf (the
// library is built without --use_fast_math).
__device__ __forceinline__ float gaussian_entry(uint32_t h) {
  const uint32_t h2 = splitmix32(h ^ 0xDEADBEEFu);
  const float u1 = (__uint2float_rn(h) + 0.5f) * 2.3283064365386963e-10f;
  const float u2 = (__uint2float_rn(h2) + 0.5f) * 2.3283064365386963e-10f;
  return sqrtf(-2.0f * logf(u1)) * cosf(6.2831854820251465f * u2);
}

// Deterministic block-wide sum: warp shuffles, then the warp partials in
// warp order by warp 0.  `scratch` holds blockDim.x / 32 values.  Every
// thread gets the result.  Same inputs and block size give the same bits.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T t = lane < n_warps ? scratch[lane] : T(0);
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) scratch[0] = t;
  }
  __syncthreads();
  return scratch[0];
}

}  // namespace repro_torch
