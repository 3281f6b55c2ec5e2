// Batched tridiagonal (Thomas) solve, CUDA C++ for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel `_tridiag_kernel`
// (src/repro/kernels/tridiag/kernel.py:26, dispatched by `tridiag_nb`).
// It is the inner solve of every half-sweep of the "tridiag" solver
// backend, and the path the fused kernel falls back to past its
// shared-memory residency limit.
//
// Design. One thread per system. The wrapper lays the batch out (N, B):
// at step i, thread b reads element i*B + b, so neighbouring threads read
// neighbouring addresses and every load and store is coalesced. The
// recurrence is sequential in N; the forward multipliers cp and partials
// dp go to an (N, B) scratch that the wrapper allocates, in the same
// layout. The kernel masks b >= B itself (no padding). dl[0] and du[N-1]
// are never read; N == 1 gives x = b / d. Divisions are IEEE (no fast
// math), so the arithmetic is the plain version's up to FMA contraction.
//
// Bound: bytes. Per node the kernel reads 4 inputs, writes x, and writes
// then reads cp and dp: 9 x 4 bytes, for ~8 flops. A row half-sweep of
// layer 1 of the 400x120x84x10 MLP at chunk=256 (N=30, B=825,344, 24.8 M
// nodes) moves ~0.89 GB, >= 0.27 ms at 3.35 TB/s; counting only the
// inputs read once and the output written once (0.50 GB) the floor is
// 0.15 ms. The flops (~0.2 GFLOP) are far below the fp32 peak.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void tridiag_kernel(const float* __restrict__ dl,
                               const float* __restrict__ d,
                               const float* __restrict__ du,
                               const float* __restrict__ b,
                               float* __restrict__ x,
                               float* __restrict__ cp,
                               float* __restrict__ dp,
                               int n, int64_t batch) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= batch) return;
  const float d0 = d[col];
  if (n == 1) {
    x[col] = b[col] / d0;
    return;
  }
  float c = du[col] / d0;
  float p = b[col] / d0;
  cp[col] = c;
  dp[col] = p;
  for (int i = 1; i < n; ++i) {
    const int64_t o = static_cast<int64_t>(i) * batch + col;
    const float l = dl[o];
    const float den = d[o] - l * c;
    c = du[o] / den;
    p = (b[o] - l * p) / den;
    cp[o] = c;
    dp[o] = p;
  }
  float xv = p;
  x[static_cast<int64_t>(n - 1) * batch + col] = xv;
  for (int i = n - 2; i >= 0; --i) {
    const int64_t o = static_cast<int64_t>(i) * batch + col;
    xv = dp[o] - cp[o] * xv;
    x[o] = xv;
  }
}

}  // namespace

// Solve `batch` systems of size n laid out (n, batch), all float32 and
// contiguous, on `stream` of CUDA device `device`. Returns the CUDA error
// code of the launch (0 = success).
extern "C" int tridiag_launch(const void* dl, const void* d, const void* du,
                              const void* b, void* x, void* cp, void* dp,
                              int n, long long batch, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const long long blocks = (batch + threads - 1) / threads;
  tridiag_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dl), static_cast<const float*>(d),
      static_cast<const float*>(du), static_cast<const float*>(b),
      static_cast<float*>(x), static_cast<float*>(cp),
      static_cast<float*>(dp), n, static_cast<int64_t>(batch));
  return static_cast<int>(cudaGetLastError());
}
