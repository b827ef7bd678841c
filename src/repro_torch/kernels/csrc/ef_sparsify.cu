// Fused error feedback + threshold sparsification over M device rows.
//
//   g_ec   = g + delta
//   keep   = |g_ec| >= tau[row]
//   g_sp   = keep ? g_ec : 0
//   delta' = g_ec - g_sp
//
// One pass over device memory: two reads and two writes per entry.  The
// ragged tail of a row is masked, never padded.  Bitwise equal to
// ref.py::ef_sparsify_ref: there is no multiply to contract.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void ef_sparsify_kernel(const float* __restrict__ g,
                                   const float* __restrict__ delta,
                                   const float* __restrict__ tau,
                                   float* __restrict__ g_sp,
                                   float* __restrict__ new_delta, int64_t n) {
  const int64_t row = blockIdx.y;
  const float t = tau[row];
  const int64_t base = row * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    const float ec = g[base + j] + delta[base + j];
    const float sp = fabsf(ec) >= t ? ec : 0.0f;
    g_sp[base + j] = sp;
    new_delta[base + j] = ec - sp;
  }
}

}  // namespace

// g, delta, g_sp, new_delta: (m, n) row-major float32; tau: (m,) float32.
extern "C" int ef_sparsify_launch(const float* g, const float* delta,
                                  const float* tau, float* g_sp,
                                  float* new_delta, int64_t m, int64_t n,
                                  void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (m > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  constexpr int kThreads = 256;
  int64_t blocks_x = (n + kThreads - 1) / kThreads;
  if (blocks_x > 4096) blocks_x = 4096;
  dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(m));
  ef_sparsify_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, delta, tau, g_sp, new_delta, n);
  return static_cast<int>(cudaGetLastError());
}
