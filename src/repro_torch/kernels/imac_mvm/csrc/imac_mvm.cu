// Quantised differential analog MVM, CUDA C++ for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel `_mvm_kernel`
// (src/repro/kernels/imac_mvm/kernel.py:38, dispatched by
// `imac_mvm_padded`). It computes y = DAC(x) @ Q(w) in float32:
//   DAC(x) = round(clip(x, 0, 1) * n) / n,  n = 2^dac_bits - 1 (clip only if 0)
//   Q(w)   = sign(w) * round(|w| / step) * step,  step = 1 / (levels - 1)
//            after clip(w, -1, 1) (clip only if levels <= 1)
// It is the AnalogLinear product of every FFN projection of the LM
// substrate's `--analog` serving mode (three launches per layer).
//
// Numerics. Rounding is half to even (rintf), as jnp.round and
// torch.round. Both quantisers divide, in the form of the reference's
// ref.py and of the port's plain version (the TPU kernel multiplies by
// the reciprocal, which can differ by one ulp and flip a level at a .5
// boundary); the level step arrives as the float32 rounding of the
// double 1/(levels-1), as the reference's Python-float step. The products
// and divisions are written with __fmul_rn / __fdiv_rn so that nothing
// is contracted; only the accumulation uses FMA, in float32 (FFMA, not
// TF32: TF32 keeps ~3 decimal digits and would not hold the f32
// reference). sign(0) = 0.
//
// Design. A shared-memory tiled GEMM: each block computes a BM x BN
// output tile, stepping K in BK-wide slices. Each thread loads its share
// of the next x and w slices into registers while the current slice is
// multiplied from shared memory (one slice of register prefetch), and
// quantises each element as it stores it to shared memory, so the
// quantised operands never exist in device memory. The quantisers are
// kept out of the load phase: an IEEE division has a branchy slow path,
// and code placed between two loads would keep the second from issuing
// until the first has arrived. Each thread accumulates a TM x TN
// micro-tile. The ragged M/K/N edges are masked (out-of-range elements
// load as 0, which both quantisers map to 0) instead of padded to 128 as
// the TPU wrapper does. Two tile shapes: 64x64x16 with 4x4 micro-tiles
// for M > IMAC_MVM_SKINNY_MAX_M, and a skinny 16x32x64 tile with 1x4
// micro-tiles for M <= IMAC_MVM_SKINNY_MAX_M (decode and short prefills),
// which has more blocks and more w loads in flight per thread for the same
// N. tools/time_imac_mvm_tiles.py times the two against each other at the
// serving shapes (a build with -DIMAC_MVM_SKINNY_MAX_M=0 has only the
// 64x64 tile).
//
// Bound. At decode (M = 4 slots) the kernel streams w once: bytes bound,
// 4 * K * N bytes (180 MB for a yi-9b projection, 0.054 ms at 3.35
// TB/s). At large M it is bound by 2*M*K*N fp32 operations at 67 TFLOP/s
// (the CUDA-core rate; the quantised operands are small exact integers
// times a scale, so int8 tensor cores or wgmma are the later redesign).
// Every block re-reads x and w slices from L2, not HBM, for all but the
// first reader.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef IMAC_MVM_SKINNY_MAX_M
#define IMAC_MVM_SKINNY_MAX_M 16
#endif

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// clip to [lo, hi]; NaN passes through, as jnp.clip / torch.clamp.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

__device__ __forceinline__ float dac(float x, int dac_n) {
  x = clip(x, 0.0f, 1.0f);
  if (dac_n == 0) return x;
  const float n = static_cast<float>(dac_n);
  return __fdiv_rn(rintf(__fmul_rn(x, n)), n);
}

__device__ __forceinline__ float wquant(float w, int levels, float step) {
  w = clip(w, -1.0f, 1.0f);
  if (levels <= 1) return w;
  const float s = w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f);
  return __fmul_rn(__fmul_rn(s, rintf(__fdiv_rn(fabsf(w), step))), step);
}

template <typename TX, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
imac_mvm_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, int m_rows, int k_dim, int n_cols,
                int dac_n, int levels, float step) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kXPer = BM * BK / kThreads;  // x elements each thread loads per slice
  constexpr int kWPer = BK * BN / kThreads;  // w elements each thread loads per slice
  static_assert(BM * BK % kThreads == 0 && BK * BN % kThreads == 0, "tile/threads");

  __shared__ __align__(16) float xs[BK][BM + 4];  // x slice, transposed: xs[k][m]
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float xr[kXPer];
  float wr[kWPer];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // Load slice k0's raw values into registers: x along K (consecutive
  // threads, consecutive k of one row), w along N. The loads are
  // independent, so all of a thread's loads of a slice are in flight at
  // once; quantising waits until the values are stored to shared memory.
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * kThreads;
      const int m = m0 + e / BK, k = k0 + e % BK;
      xr[i] = (m < m_rows && k < k_dim) ? to_float(x[static_cast<int64_t>(m) * k_dim + k])
                                        : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kWPer; ++i) {
      const int e = tid + i * kThreads;
      const int k = k0 + e / BN, n = n0 + e % BN;
      wr[i] = (k < k_dim && n < n_cols) ? w[static_cast<int64_t>(k) * n_cols + n] : 0.0f;
    }
  };

  load(0);
  for (int k0 = 0; k0 < k_dim; k0 += BK) {
#pragma unroll
    for (int i = 0; i < kXPer; ++i) {
      const int e = tid + i * kThreads;
      xs[e % BK][e / BK] = dac(xr[i], dac_n);
    }
#pragma unroll
    for (int i = 0; i < kWPer; ++i) {
      const int e = tid + i * kThreads;
      ws[e / BN][e % BN] = wquant(wr[i], levels, step);
    }
    __syncthreads();
    if (k0 + BK < k_dim) load(k0 + BK);  // in flight while this slice is multiplied
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= m_rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < n_cols) y[static_cast<int64_t>(m) * n_cols + n] = acc[i][j];
    }
  }
}

template <typename TX, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const void* x, const void* w, void* y, int m, int k, int n,
                   int dac_n, int levels, float step, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 block((BM / TM) * (BN / TN));
  imac_mvm_kernel<TX, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), m, k, n, dac_n, levels, step);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch(const void* x, const void* w, void* y, int m, int k, int n,
                     int dac_n, int levels, float step, cudaStream_t stream) {
  if (m <= IMAC_MVM_SKINNY_MAX_M) {
    return launch<TX, 16, 32, 64, 1, 4>(x, w, y, m, k, n, dac_n, levels, step, stream);
  }
  return launch<TX, 64, 64, 16, 4, 4>(x, w, y, m, k, n, dac_n, levels, step, stream);
}

}  // namespace

// y (m, n) float32 = DAC(x) @ Q(w) for x (m, k) (float32, or bfloat16 when
// x_is_bf16) and w (k, n) float32, all contiguous, on `stream` of CUDA
// device `device`. dac_n = 2^bits - 1 (0: clip only); levels <= 1: clip
// only; step = float(1.0 / (levels - 1)). Returns the CUDA error code of
// the launch (0 = success).
extern "C" int imac_mvm_launch(const void* x, int x_is_bf16, const void* w,
                               void* y, int m, int k, int n, int dac_n,
                               int levels, float step, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x_is_bf16
            ? dispatch<__nv_bfloat16>(x, w, y, m, k, n, dac_n, levels, step, s)
            : dispatch<float>(x, w, y, m, k, n, dac_n, levels, step, s);
  return static_cast<int>(err);
}
