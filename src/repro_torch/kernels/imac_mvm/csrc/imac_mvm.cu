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
// Design, two routes; the launch plan, computed by `launch_plan` in ops.py
// and passed in, picks one by its M bucket (0: the 64x64 tile):
//
// M <= 16 (decode and prefill): a split-K
// weight-streaming kernel. At M = 4 the product is bound by the bytes of
// w, 4 * K * N (180 MB for a yi-9b projection, 0.054 ms at 3.35 TB/s),
// so the design streams w once at the highest rate it can:
//   * Grid: column tiles (bn = 128 or 64 columns) x K splits (<= 8); each
//     block owns one column tile and one contiguous K range (k_chunk
//     rows). The plan gives >= 2 blocks per SM, sized from the clusters
//     the card holds at once (imac_mvm_splitk_max_clusters).
//   * Each of the 256 threads owns 4 consecutive columns and every kt-th
//     row of the range (kt = 1024 / bn threads along K). It streams its
//     w elements through a ring of kStages stages in shared memory with
//     16-byte cp.async copies that bypass L1 (w is read once and is
//     larger than L2), kStages - 1 stages in flight, and quantises a
//     value only once its stage has arrived. Each thread reads back only
//     the slots it copied, so the ring needs no barrier. The first stages
//     are issued before x is quantised, so that work hides their latency.
//   * x stays on chip: each block DAC-quantises its M x range slice of x
//     once into shared memory (xs[k][m], f32, at most x_rows rows at a
//     time), read back as float4 broadcasts. The M accumulators of each
//     column live in registers, the kernel templated on an M bucket
//     (4 / 8 / 12 / 16).
//   * The splits of one column tile form a thread-block cluster. Each
//     block sums its kt row partials in shared memory in a fixed order,
//     then the cluster sums the blocks' partials over distributed shared
//     memory in rank order, in the same launch. No atomics: two launches
//     on the same inputs give bit-identical outputs.
//   * Ragged edges: rows past K or past a split are never loaded; a
//     column past N loads as 0; when N % 4 != 0 or w is not 16-byte
//     aligned, each thread loads its 4 columns one float at a time.
// Each weight element costs ~30 SASS instructions at M = 4 (the quantiser,
// whose IEEE division's fast path sits between a reciprocal and a branch to
// its slow path, then M FMAs) against the ~35 an SM can issue per element
// at 3.35 TB/s; at M = 12-16 issue rate and the 2 blocks per SM that their
// accumulators leave room for bind before the bytes do.
//
// M > 16: a shared-memory tiled GEMM, 64x64x16 tiles
// with 4x4 micro-tiles. Each thread loads its share of the next x and w
// slices into registers while the current slice is multiplied from shared
// memory, and quantises each element as it stores it to shared memory, so
// the quantised operands never exist in device memory. The quantisers are
// kept out of the load phase: an IEEE division has a branchy slow path,
// and code placed between two loads would keep the second from issuing
// until the first has arrived. The ragged M/K/N edges are masked
// (out-of-range elements load as 0, which both quantisers map to 0)
// instead of padded to 128 as the TPU wrapper does. It is bound by
// 2*M*K*N fp32 operations at 67 TFLOP/s (the CUDA-core rate; the
// quantised operands are small exact integers times a scale, so int8
// tensor cores or wgmma are its later redesign).
//
// tools/time_imac_mvm_tiles.py times the two routes against each other at
// the serving shapes (M bucket 0 launches the 64x64 tile at any M).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

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

// ---------------------------------------------------------------------------
// M <= 16: split-K weight streaming.
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 256;
constexpr int kStageRows = 2;  // K rows each thread copies per pipeline stage
constexpr int kStages = 4;     // ring depth: kStages - 1 stages in flight
constexpr int kRingFloats = kStages * kStageRows * kSplitThreads * 4;
constexpr int kRedFloats = 16 * kSplitThreads;  // kt x 4 rows x bn columns, kt * bn = 4 * threads
static_assert(kRedFloats <= kRingFloats, "the row reduction reuses the ring");

// Copy w[row, col..col+3] to shared memory asynchronously (cp.async,
// cached in L2 only: w is streamed once). Out-of-range elements are
// zero-filled without being read (source size 0). VEC: one 16-byte copy
// (n_cols % 4 == 0 and w 16-byte aligned); else four 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void copy_w4(float* dst, const float* __restrict__ w, int64_t off,
                                        int col, int n_cols, bool row_ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC) {
    const bool ok = row_ok && col < n_cols;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(ok ? w + off : w), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = row_ok && col + j < n_cols;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d + 4 * j),
                   "l"(ok ? w + off + j : w), "r"(ok ? 4 : 0)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[m][j] += xs_row[m] * Q(w4[j]) for the MB rows of one K row.
template <int MB>
__device__ __forceinline__ void fma_row(float (&acc)[MB][4], float4 w4, const float* xs_row,
                                        int levels, float step) {
  const float q[4] = {wquant(w4.x, levels, step), wquant(w4.y, levels, step),
                      wquant(w4.z, levels, step), wquant(w4.w, levels, step)};
  const float4* xr = reinterpret_cast<const float4*>(xs_row);
#pragma unroll
  for (int g = 0; g < MB / 4; ++g) {
    const float4 xv = xr[g];
    const float xm[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[4 * g + i][j] = fmaf(xm[i], q[j], acc[4 * g + i][j]);
  }
}

// Grid: n_tiles * splits blocks in clusters of `splits` along x; block
// rank r of cluster t owns columns [t*bn, t*bn + bn) and rows
// [r*k_chunk, min((r+1)*k_chunk, K)).
//
// Shared memory: the w ring [kStages][kStageRows][threads] float4 (each
// thread reads only the slots it copied itself, so the ring needs no
// barrier; reused for the row reduction), xs [x_rows][MB], part [MB][bn].
template <typename TX, int MB, bool VEC>
__global__ void __launch_bounds__(kSplitThreads, 2)
imac_mvm_splitk_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ y, int m_rows, int k_dim, int n_cols, int bn,
                       int k_chunk, int x_rows, int dac_n, int levels, float step) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) float smem[];
  float4* ring = reinterpret_cast<float4*>(smem);
  float* xs = smem + kRingFloats;
  float* part = xs + x_rows * MB;

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / splits) * bn;
  const int lanes = bn / 4;
  const int kt = kSplitThreads / lanes;
  const int tid = threadIdx.x;
  const int tx = tid % lanes;
  const int ty = tid / lanes;
  const int col = n0 + 4 * tx;
  const int k_lo = split * k_chunk;
  const int k_hi = min(k_lo + k_chunk, k_dim);

  float acc[MB][4];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int r0 = k_lo; r0 < k_hi; r0 += x_rows) {
    const int rows = min(x_rows, k_hi - r0);
    // This thread's rows: kk = ty + kt * i for i < cnt; stage s holds
    // i in [s * kStageRows, (s + 1) * kStageRows). The stage count is the
    // block's, so every thread commits the same groups.
    const int cnt = ty < rows ? (rows - ty + kt - 1) / kt : 0;
    const int n_stages = ((rows + kt - 1) / kt + kStageRows - 1) / kStageRows;
    const int64_t row0 = static_cast<int64_t>(r0 + ty) * n_cols + col;
    const int64_t row_step = static_cast<int64_t>(kt) * n_cols;
    auto issue = [&](int s) {
#pragma unroll
      for (int r = 0; r < kStageRows; ++r) {
        const int i = s * kStageRows + r;
        copy_w4<VEC>(reinterpret_cast<float*>(
                         ring + ((s % kStages) * kStageRows + r) * kSplitThreads + tid),
                     w, row0 + i * row_step, col, n_cols, i < cnt);
      }
    };

    if (r0 != k_lo) __syncthreads();  // every thread is done with the previous slice of x
    // The first stages of w are in flight while x is quantised.
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_stages) issue(s);
      cp_async_commit();
    }
    // DAC-quantise x[:, r0:r0+rows] into xs[kk][m], one K row per thread:
    // its M loads are issued before any is quantised (rows past M are 0).
    for (int kk = tid; kk < rows; kk += kSplitThreads) {
      float v[MB];
#pragma unroll
      for (int m = 0; m < MB; ++m)
        v[m] = m < m_rows ? to_float(x[static_cast<int64_t>(m) * k_dim + r0 + kk]) : 0.0f;
      float4* dst = reinterpret_cast<float4*>(xs + kk * MB);
#pragma unroll
      for (int g = 0; g < MB / 4; ++g)
        dst[g] = make_float4(dac(v[4 * g], dac_n), dac(v[4 * g + 1], dac_n),
                             dac(v[4 * g + 2], dac_n), dac(v[4 * g + 3], dac_n));
    }
    __syncthreads();

    for (int s = 0; s < n_stages; ++s) {
      // Refill the slot consumed in the previous step, then wait for stage s.
      if (s + kStages - 1 < n_stages) issue(s + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
#pragma unroll
      for (int r = 0; r < kStageRows; ++r) {
        const int i = s * kStageRows + r;
        if (i < cnt)
          fma_row<MB>(acc, ring[((s % kStages) * kStageRows + r) * kSplitThreads + tid],
                      xs + (ty + i * kt) * MB, levels, step);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is dead: reuse it for the reduction

  // Sum the kt row partials of each column, 4 rows of M at a time, in ty order.
  float* red = smem;  // [kt][4][bn]
#pragma unroll
  for (int g = 0; g < MB / 4; ++g) {
    if (4 * g >= m_rows) break;  // uniform across the block
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<float4*>(red + (ty * 4 + i) * bn)[tx] =
          make_float4(acc[4 * g + i][0], acc[4 * g + i][1], acc[4 * g + i][2], acc[4 * g + i][3]);
    __syncthreads();
    for (int e = tid; e < 4 * bn; e += kSplitThreads) {
      const int i = e / bn, c = e % bn;
      float s = 0.0f;
      for (int t = 0; t < kt; ++t) s += red[(t * 4 + i) * bn + c];
      part[(4 * g + i) * bn + c] = s;
    }
    __syncthreads();
  }

  // Sum the cluster's block partials in rank order, over distributed
  // shared memory; the cluster's blocks share out the outputs.
  cluster.sync();
  for (int e = split * kSplitThreads + tid; e < m_rows * bn; e += splits * kSplitThreads) {
    const int m = e / bn, c = e % bn;
    if (n0 + c >= n_cols) continue;
    float s = 0.0f;
    for (int r = 0; r < splits; ++r) s += cluster.map_shared_rank(part, r)[e];
    y[static_cast<int64_t>(m) * n_cols + n0 + c] = s;
  }
  cluster.sync();  // no block leaves while another reads its partials
}

size_t splitk_smem_bytes(int mb, int bn, int x_rows) {
  return sizeof(float) * (kRingFloats + static_cast<size_t>(x_rows) * mb +
                          static_cast<size_t>(mb) * bn);
}

struct Plan {
  int mb, bn, splits, k_chunk, x_rows;
};

bool plan_ok(const Plan& p, int m, int k, int n) {
  const bool mb_ok = p.mb == 4 || p.mb == 8 || p.mb == 12 || p.mb == 16;
  const int64_t tiles = (static_cast<int64_t>(n) + p.bn - 1) / std::max(p.bn, 1);
  return mb_ok && m <= p.mb && (p.bn == 64 || p.bn == 128) && p.splits >= 1 &&
         p.splits <= 8 && p.k_chunk >= 1 && static_cast<int64_t>(p.splits) * p.k_chunk >= k &&
         static_cast<int64_t>(p.splits - 1) * p.k_chunk < k && p.x_rows >= 1 &&
         p.x_rows <= p.k_chunk && tiles * p.splits <= 0x7fffffff;
}

template <typename TX>
using SplitKKernel = void (*)(const TX*, const float*, float*, int, int, int, int, int, int,
                              int, int, float);

// The instantiation for M bucket mb, with 16-byte w copies or not.
template <typename TX>
SplitKKernel<TX> splitk_kernel(int mb, bool vec) {
  switch (mb) {
    case 4: return vec ? imac_mvm_splitk_kernel<TX, 4, true> : imac_mvm_splitk_kernel<TX, 4, false>;
    case 8: return vec ? imac_mvm_splitk_kernel<TX, 8, true> : imac_mvm_splitk_kernel<TX, 8, false>;
    case 12:
      return vec ? imac_mvm_splitk_kernel<TX, 12, true> : imac_mvm_splitk_kernel<TX, 12, false>;
    case 16:
      return vec ? imac_mvm_splitk_kernel<TX, 16, true> : imac_mvm_splitk_kernel<TX, 16, false>;
    default: return nullptr;
  }
}

// Opt `kernel` into the plan's dynamic shared memory, and fill in its
// cluster launch configuration (grid: n_tiles * splits blocks).
template <typename TX>
cudaError_t splitk_config(SplitKKernel<TX> kernel, const Plan& p, int n, cudaStream_t stream,
                          cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const size_t smem = splitk_smem_bytes(p.mb, p.bn, p.x_rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n + p.bn - 1) / p.bn * p.splits));
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename TX>
cudaError_t launch_splitk(const void* x, const void* w, void* y, int m, int k, int n,
                          const Plan& p, int dac_n, int levels, float step,
                          cudaStream_t stream) {
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const SplitKKernel<TX> kernel = splitk_kernel<TX>(p.mb, vec);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = splitk_config<TX>(kernel, p, n, stream, cfg, attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TX*>(x), static_cast<const float*>(w),
                           static_cast<float*>(y), m, k, n, p.bn, p.k_chunk, p.x_rows, dac_n,
                           levels, step);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of the plan's kernel the device holds at once (0: none fits).
template <typename TX>
cudaError_t max_clusters(const Plan& p, bool vec, int* clusters) {
  const SplitKKernel<TX> kernel = splitk_kernel<TX>(p.mb, vec);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = splitk_config<TX>(kernel, p, p.bn, nullptr, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// ---------------------------------------------------------------------------
// M > 16: the 64x64x16 tile.
// ---------------------------------------------------------------------------

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
                     const Plan& p, int dac_n, int levels, float step, cudaStream_t stream) {
  if (p.mb > 0) {
    if (!plan_ok(p, m, k, n)) return cudaErrorInvalidValue;
    return launch_splitk<TX>(x, w, y, m, k, n, p, dac_n, levels, step, stream);
  }
  return launch<TX, 64, 64, 16, 4, 4>(x, w, y, m, k, n, dac_n, levels, step, stream);
}

}  // namespace

// y (m, n) float32 = DAC(x) @ Q(w) for x (m, k) (float32, or bfloat16 when
// x_is_bf16) and w (k, n) float32, all contiguous, on `stream` of CUDA
// device `device`. dac_n = 2^bits - 1 (0: clip only); levels <= 1: clip
// only; step = float(1.0 / (levels - 1)). The launch plan: m_bucket 0
// takes the 64x64 tile (any m); otherwise (m <= m_bucket) the split-K
// kernel with M bucket m_bucket (4, 8, 12, 16), column tile bn
// (64, 128), `splits` K ranges of k_chunk rows (the cluster size, <= 8),
// and x quantised into shared memory x_rows rows at a time. Returns the
// CUDA error code of the launch (0 = success).
extern "C" int imac_mvm_launch(const void* x, int x_is_bf16, const void* w, void* y, int m,
                               int k, int n, int dac_n, int levels, float step, int m_bucket,
                               int bn, int splits, int k_chunk, int x_rows, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p{m_bucket, bn, splits, k_chunk, x_rows};
  err = x_is_bf16 ? dispatch<__nv_bfloat16>(x, w, y, m, k, n, p, dac_n, levels, step, s)
                  : dispatch<float>(x, w, y, m, k, n, p, dac_n, levels, step, s);
  return static_cast<int>(err);
}

// The most clusters of `splits` blocks of the split-K kernel (x bfloat16 or
// float32, 16-byte w loads or not, M bucket m_bucket, column tile bn, x_rows
// rows of x in shared memory) that device `device` runs at once, into
// *clusters. Returns the CUDA error code (0 = success).
extern "C" int imac_mvm_splitk_max_clusters(int x_is_bf16, int vec, int m_bucket, int bn,
                                            int splits, int x_rows, int device, int* clusters) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p{m_bucket, bn, splits, x_rows, x_rows};
  return static_cast<int>(x_is_bf16 ? max_clusters<__nv_bfloat16>(p, vec != 0, clusters)
                                    : max_clusters<float>(p, vec != 0, clusters));
}
