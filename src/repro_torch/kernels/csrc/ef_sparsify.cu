// Fused error feedback + threshold sparsification over M device rows.
//
//   g_ec   = g + delta
//   keep   = |g_ec| >= tau[row]
//   g_sp   = keep ? g_ec : 0
//   delta' = g_ec - g_sp
//
// Replaces the TPU kernel repro/kernels/ef_sparsify.py::ef_sparsify_pallas
// (body _kernel).
//
// What bounds it on an H100: bytes.  Per entry it reads g and delta and
// writes g_sp and delta' (16 bytes) against one add, one compare and one
// subtract: 3.1 MB at the main path's 25 x 7850, about a microsecond at the
// memory rate.
//
// The (M, n) rows are one flat array of M n entries.  Each thread moves 16
// bytes (four floats) per access of each of the four arrays, and takes each
// entry's threshold from its flat index's row: one division for the first of
// the four, then a step to the next row wherever the four cross a row's end.
// Rows of n = 7850 floats are 31 400 bytes long, so every odd row starts 8
// bytes off a 16-byte boundary; the vector body therefore starts at the
// first 16-byte boundary of the flat range, and the head before it and the
// tail after it (at most 3 entries each) are masked single entries, never a
// copy into a padded buffer.  Where the four arrays do not share their
// offset from 16 bytes, every entry takes the single-entry path.  One wave
// of CTAs, sized to the SMs, walks the range with a grid-stride loop.
//
// Bitwise equal to ref.py::ef_sparsify_ref: there is no multiply to contract.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;  // 2048 threads, an SM's most

__device__ __forceinline__ void sparsify(float g, float d, float t, float& sp, float& nd) {
  const float ec = g + d;
  sp = fabsf(ec) >= t ? ec : 0.0f;
  nd = ec - sp;
}

// Entries [0, head) and [head + 4 nvec, total) are single entries; the nvec
// groups of four between them are 16-byte aligned in all arrays.
__global__ void __launch_bounds__(kThreads)
ef_sparsify_kernel(const float* __restrict__ g, const float* __restrict__ delta,
                   const float* __restrict__ tau, float* __restrict__ g_sp,
                   float* __restrict__ new_delta, int64_t n, int64_t total, int64_t head,
                   int64_t nvec) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;

  const int64_t tail = head + 4 * nvec;
  for (int64_t e = tid; e < head + (total - tail); e += stride) {
    const int64_t i = e < head ? e : tail + (e - head);
    sparsify(g[i], delta[i], __ldg(tau + i / n), g_sp[i], new_delta[i]);
  }

  const float4* g4 = reinterpret_cast<const float4*>(g + head);
  const float4* d4 = reinterpret_cast<const float4*>(delta + head);
  float4* sp4 = reinterpret_cast<float4*>(g_sp + head);
  float4* nd4 = reinterpret_cast<float4*>(new_delta + head);
  for (int64_t v = tid; v < nvec; v += stride) {
    const int64_t e0 = head + 4 * v;
    int64_t row = e0 / n, col = e0 - row * n;
    float t = __ldg(tau + row);
    const float4 a = g4[v], b = d4[v];
    float4 sp, nd;
    // each entry is the next of the flat range: past a row's last entry
    // comes the next row's threshold (no read past the last row: a row
    // step happens only before an entry that exists)
    sparsify(a.x, b.x, t, sp.x, nd.x);
    if (++col == n) { col = 0; t = __ldg(tau + ++row); }
    sparsify(a.y, b.y, t, sp.y, nd.y);
    if (++col == n) { col = 0; t = __ldg(tau + ++row); }
    sparsify(a.z, b.z, t, sp.z, nd.z);
    if (++col == n) { col = 0; t = __ldg(tau + ++row); }
    sparsify(a.w, b.w, t, sp.w, nd.w);
    sp4[v] = sp;
    nd4[v] = nd;
  }
}

}  // namespace

// g, delta, g_sp, new_delta: (m, n) row-major float32; tau: (m,) float32.
extern "C" int ef_sparsify_launch(const float* g, const float* delta,
                                  const float* tau, float* g_sp,
                                  float* new_delta, int64_t m, int64_t n,
                                  void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t total = m * n;
  // entries before the first 16-byte boundary, where all four arrays share
  // their offset from it; else none of the range is vectorised
  const uintptr_t off = reinterpret_cast<uintptr_t>(g) & 15u;
  const bool shared = (reinterpret_cast<uintptr_t>(delta) & 15u) == off &&
                      (reinterpret_cast<uintptr_t>(g_sp) & 15u) == off &&
                      (reinterpret_cast<uintptr_t>(new_delta) & 15u) == off && off % 4 == 0;
  const int64_t head = shared ? std::min<int64_t>(total, ((16 - off) & 15u) / 4) : total;
  const int64_t nvec = (total - head) / 4;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one wave at most, and no CTA without work: the vector groups, or the
  // single entries where there are no groups
  const int64_t work = std::max<int64_t>(nvec, total - 4 * nvec);
  const int64_t blocks =
      std::min<int64_t>(static_cast<int64_t>(sms) * kCtasPerSm, (work + kThreads - 1) / kThreads);
  ef_sparsify_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(g, delta, tau, g_sp, new_delta, n,
                                                            total, head, nvec);
  return static_cast<int>(cudaGetLastError());
}
