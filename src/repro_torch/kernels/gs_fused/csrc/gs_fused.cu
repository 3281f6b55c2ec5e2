// The whole block Gauss-Seidel (SOR) sweep loop of the crossbar solve,
// fused into one kernel. CUDA C++ for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel `_gs_fused_kernel`
// (src/repro/kernels/gs_fused/kernel.py:47, dispatched by `gs_fused_nb`).
//
// What it computes, per (tile x sample) system of M rows x N columns:
// `sweeps` times { row Thomas solve along N given the column voltages,
// with precomputed multipliers cp and inverse denominators inv_den (no
// divisions); column Thomas solve along M given the fresh row voltages;
// vc += omega * (vc_gs - vc); residual = max |dvc| }, then one final
// un-relaxed row and column solve whose results are the outputs vr, vc.
// The electrical scalars (off-diagonals -g_row and -g_col, omega) are per
// system. `tol` does not enter: exactly `sweeps` sweeps run.
//
// Design. One thread block per system. The block keeps the system in
// shared memory across all sweeps: the constant inputs (g, row sources,
// column injections, row and column cp / inv_den), the SOR carry vc, the
// row solution and the column partials, 10 buffers of M x S floats. Row
// phase: thread i walks row i along N. Column phase: thread j walks
// column j along M, and relaxes vc as it back-substitutes, so the column
// solution needs no buffer of its own. The shared row stride S = N | 1 is
// odd, so both walks are free of bank conflicts (row walk: threads
// S floats apart; column walk: threads 1 float apart) and no transpose is
// needed. The per-system residual is a warp-shuffle and shared-memory max
// over the block. Past the opt-in shared memory of one block (227 KB on
// H100: about 75 x 75 tiles) the wrapper does not launch this kernel and
// falls back to the per-half-sweep `tridiag` kernel.
//
// Bound. Bytes in and out once: 8 arrays of M x N read (g, sources,
// injections, 4 coefficient arrays, warm start), 3 scalars, 2 arrays of
// M x N written and the residual: ~40 bytes per node. Operations: per
// node and sweep 20 flops (row: 2 for the rhs, 3 forward, 2 backward;
// column the same; 3 for the SOR update and 3 for the residual), 14 in
// the final sweep. For layer 1 of the 400x120x84x10 MLP at chunk=256
// (26,624 systems of 31 x 30, 48 sweeps) that is 0.99 GB (0.30 ms at
// 3.35 TB/s) against 24 GFLOP (0.36 ms at 67 TFLOP/s fp32): the flops
// bound it, barely. The recurrences are sequential, so in practice the
// latency of each dependent shared-memory step, not either bound, sets
// the time.

#include <cuda_runtime.h>
#include <cstdint>
#include <math.h>

namespace {

constexpr int kBuffers = 10;  // shared buffers of M x S floats per system
constexpr int kMaxWarps = 32;

__device__ __forceinline__ float nan_max(float a, float b) {
  // max that propagates NaN, as the reference's jnp.max does.
  return (b > a || b != b) ? b : a;
}

__global__ void gs_fused_kernel(
    const float* __restrict__ g, const float* __restrict__ src,
    const float* __restrict__ injc, const float* __restrict__ cpr,
    const float* __restrict__ idr, const float* __restrict__ cpc,
    const float* __restrict__ idc, const float* __restrict__ odr,
    const float* __restrict__ odc, const float* __restrict__ om,
    const float* __restrict__ vc0, float* __restrict__ vr_out,
    float* __restrict__ vc_out, float* __restrict__ res_out, int m, int n,
    int sweeps) {
  extern __shared__ float smem[];
  __shared__ float warp_max[kMaxWarps];
  const int s = n | 1;
  const int tile = m * s;
  float* sg = smem;
  float* ssrc = sg + tile;
  float* sinj = ssrc + tile;
  float* scpr = sinj + tile;
  float* sidr = scpr + tile;
  float* scpc = sidr + tile;
  float* sidc = scpc + tile;
  float* svc = sidc + tile;  // SOR carry of the column voltages
  float* svr = svc + tile;   // row partials, then the row solution
  float* sdp = svr + tile;   // column partials

  const int sys = blockIdx.x;
  const int64_t base = static_cast<int64_t>(sys) * m * n;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int e = tid; e < m * n; e += nt) {
    const int i = e / n;
    const int k = i * s + (e - i * n);
    sg[k] = g[base + e];
    ssrc[k] = src[base + e];
    sinj[k] = injc[base + e];
    scpr[k] = cpr[base + e];
    sidr[k] = idr[base + e];
    scpc[k] = cpc[base + e];
    sidc[k] = idc[base + e];
    svc[k] = vc0[base + e];
  }
  const float a_r = odr[sys];
  const float a_c = odc[sys];
  const float w = om[sys];
  __syncthreads();

  float res = INFINITY;  // this thread's part of the last sweep's residual
  for (int it = 0; it <= sweeps; ++it) {
    const bool last = (it == sweeps);
    // Row phase: thread i solves row i along N.
    if (tid < m) {
      const int r = tid * s;
      float p = (sg[r] * svc[r] + ssrc[r]) * sidr[r];
      svr[r] = p;
      for (int j = 1; j < n; ++j) {
        const int k = r + j;
        p = (sg[k] * svc[k] + ssrc[k] - a_r * p) * sidr[k];
        svr[k] = p;
      }
      float x = p;
      for (int j = n - 2; j >= 0; --j) {
        const int k = r + j;
        x = svr[k] - scpr[k] * x;
        svr[k] = x;
      }
    }
    __syncthreads();
    // Column phase: thread j solves column j along M, then relaxes vc
    // (or, after the last sweep, writes the un-relaxed solution out).
    if (tid < n) {
      const int c = tid;
      float p = (sg[c] * svr[c] + sinj[c]) * sidc[c];
      sdp[c] = p;
      for (int i = 1; i < m; ++i) {
        const int k = i * s + c;
        p = (sg[k] * svr[k] + sinj[k] - a_c * p) * sidc[k];
        sdp[k] = p;
      }
      float local = 0.0f;
      float x = p;
      for (int i = m - 1; i >= 0; --i) {
        const int k = i * s + c;
        if (i < m - 1) x = sdp[k] - scpc[k] * x;
        if (last) {
          vc_out[base + static_cast<int64_t>(i) * n + c] = x;
        } else {
          const float old = svc[k];
          const float nv = old + w * (x - old);
          svc[k] = nv;
          local = nan_max(local, fabsf(nv - old));
        }
      }
      if (!last) res = local;
    } else if (!last) {
      res = 0.0f;
    }
    __syncthreads();
  }

  for (int e = tid; e < m * n; e += nt) {
    const int i = e / n;
    vr_out[base + e] = svr[i * s + (e - i * n)];
  }

  // Block max of the per-thread residuals.
  for (int off = 16; off > 0; off >>= 1) {
    res = nan_max(res, __shfl_xor_sync(0xffffffffu, res, off));
  }
  if ((tid & 31) == 0) warp_max[tid >> 5] = res;
  __syncthreads();
  if (tid == 0) {
    float r = warp_max[0];
    for (int wi = 1; wi < (nt + 31) / 32; ++wi) r = nan_max(r, warp_max[wi]);
    res_out[sys] = r;
  }
}

}  // namespace

// Dynamic shared memory the kernel needs for an m x n tile, in bytes.
extern "C" long long gs_fused_smem_bytes(int m, int n) {
  return static_cast<long long>(kBuffers) * m * (n | 1) * sizeof(float);
}

// cudaDevAttrMaxSharedMemoryPerBlockOptin of `device` (bytes), or the
// negated CUDA error code.
extern "C" int gs_fused_max_smem(int device) {
  int value = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? value : -static_cast<int>(err);
}

// Run the fused solve over `batch` systems of m x n on `stream` of CUDA
// device `device`. Arrays are float32 and contiguous: (batch, m, n) for
// g, src, injc, cpr, idr, cpc, idc, vc0, vr, vc; (batch,) for odr, odc,
// om, res. Returns the CUDA error code of the launch (0 = success).
extern "C" int gs_fused_launch(const void* g, const void* src,
                               const void* injc, const void* cpr,
                               const void* idr, const void* cpc,
                               const void* idc, const void* odr,
                               const void* odc, const void* om,
                               const void* vc0, void* vr, void* vc,
                               void* res, int m, int n, int sweeps,
                               long long batch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = gs_fused_smem_bytes(m, n);
  err = cudaFuncSetAttribute(gs_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wide = m > n ? m : n;
  const int threads = ((wide + 31) / 32) * 32;
  gs_fused_kernel<<<static_cast<unsigned>(batch), threads,
                    static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(src),
      static_cast<const float*>(injc), static_cast<const float*>(cpr),
      static_cast<const float*>(idr), static_cast<const float*>(cpc),
      static_cast<const float*>(idc), static_cast<const float*>(odr),
      static_cast<const float*>(odc), static_cast<const float*>(om),
      static_cast<const float*>(vc0), static_cast<float*>(vr),
      static_cast<float*>(vc), static_cast<float*>(res), m, n, sweeps);
  return static_cast<int>(cudaGetLastError());
}
