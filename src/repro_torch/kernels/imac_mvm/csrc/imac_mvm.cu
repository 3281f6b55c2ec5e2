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
// Design, three routes; the launch plan, computed by `launch_plan` in
// ops.py and passed in, picks one: the integer tensor-core route for
// M >= 9 with integer quantisers (imac_mvm_int8_launch; it beats split-K
// from M = 12 on the H100), else the split-K kernel for M <= 16 and the
// 64x64 tile above (M bucket 0 of imac_mvm_launch).
//
// M <= 16 without the integer route (decode's M <= 8; any quantisers): a split-K
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
// M >= 9, integer quantisers (1 <= dac_bits <= 8, 2 <= levels <= 128):
// an exact integer product on the tensor cores. A DAC level
// ix = rint(clip(x) * n) is an integer in 0..255 and a weight level
// r = sign(w) * rint(|clip(w)| / step) one in -127..127, and
// DAC(x) @ Q(w) = (ix @ r) * step / n. So:
//   * Two pack kernels compute the levels with exactly the expressions of
//     dac() and wquant() below (the same .5 boundaries): x (M, K) into u8
//     (M, Kp) and w (K, N) into s8 stored transposed as (N, Kp), both
//     K-major as wgmma takes 8-bit operands, Kp = K rounded up to 16
//     bytes (TMA's stride rule) and zero-filled (level 0 adds nothing).
//     The w pass transposes through shared memory, so its float4 reads
//     along N and its 16-byte writes along K both stay coalesced. A NaN
//     has no level: it packs as 0 and sets a per-row (x) or per-column
//     (w) flag, and the epilogue writes NaN there, as the reference's
//     NaN * 0 does. +-inf clips.
//   * The GEMM (imac_mvm_int8_kernel): one producer warpgroup, of which
//     one thread keeps TMA loads of 128-byte K slices of both operands
//     (128-byte swizzle) in flight through a ring of kStages stages in
//     shared memory, full/empty mbarriers per stage; one or two consumer
//     warpgroups (64 or 128 rows) each run wgmma.m64n128k32.s32.u8.s8 on
//     the stages that have arrived. The sums are s32 and exact:
//     |ix @ r| <= 255 * 127 * K < 2^31 for K <= 66,000 (guarded).
//   * The epilogue writes y = float((double)isum * c), c = double(step) / n
//     from the host: the correctly rounded value of the exact sum, which no
//     order of summation changes. The plain version imac_mvm_levels_ref
//     (ref.py) forms the same sum exactly in float64 and equals it bit for
//     bit; against the float32 reference it holds at the tile's tolerance.
//   * Split-K: the splits of one output tile form a cluster (<= 8) and sum
//     their s32 partial tiles over distributed shared memory. Integer sums
//     are associative, so relaunches are bit-identical. The plan splits K
//     only when the output tiles are fewer than one wave (M = 32: 86 or 32
//     column tiles for 132 SMs).
// Bound: the pack reads x and w once (4 * K * N bytes of w dominate at
// small M) and writes 1 byte per element; the GEMM streams the s8 copy
// of w; at M = 2048 the operations (2 * M * K * N at 1,979 int8 TOPS) and
// the bytes are within a few percent of each other.
//
// M > 16, other quantisers (clip only, levels > 128, dac_bits > 8), or
// K > 66,000: a shared-memory tiled GEMM, 64x64x16 tiles
// with 4x4 micro-tiles. Each thread loads its share of the next x and w
// slices into registers while the current slice is multiplied from shared
// memory, and quantises each element as it stores it to shared memory, so
// the quantised operands never exist in device memory. The quantisers are
// kept out of the load phase: an IEEE division has a branchy slow path,
// and code placed between two loads would keep the second from issuing
// until the first has arrived. The ragged M/K/N edges are masked
// (out-of-range elements load as 0, which both quantisers map to 0)
// instead of padded to 128 as the TPU wrapper does. It is bound by
// 2*M*K*N fp32 operations at 67 TFLOP/s (the CUDA-core rate).
//
// tools/time_imac_mvm_tiles.py times the three routes against each other
// at the serving shapes (M bucket 0 launches the 64x64 tile at any M).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
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
// M >= 9, integer quantisers: pack to levels, then u8 x s8 -> s32 on wgmma.
// ---------------------------------------------------------------------------

constexpr int kPackThreads = 256;
constexpr int kInt8BK = 128;  // K bytes per ring stage: one 128-byte swizzled row per operand row
constexpr int kInt8BN = 128;  // output columns per block: the wgmma's n
constexpr int kInt8MaxK = 66000;  // 255 * 127 * K < 2^31: the s32 sums are exact

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// The DAC level rint(clip(x, 0, 1) * n) of dac() (0 for NaN, flagged).
__device__ __forceinline__ uint32_t dac_level(float x, float n, bool& nan) {
  x = clip(x, 0.0f, 1.0f);
  nan |= is_nan(x);
  return is_nan(x) ? 0u : static_cast<uint32_t>(rintf(__fmul_rn(x, n)));
}

// The weight level sign(w) * rint(|clip(w, -1, 1)| / step) of wquant()
// (0 for NaN, flagged), as a byte.
__device__ __forceinline__ uint32_t weight_level(float w, float step, bool& nan) {
  w = clip(w, -1.0f, 1.0f);
  nan |= is_nan(w);
  if (is_nan(w)) return 0u;
  const float s = w > 0.0f ? 1.0f : (w < 0.0f ? -1.0f : 0.0f);
  return static_cast<uint32_t>(static_cast<int>(__fmul_rn(s, rintf(__fdiv_rn(fabsf(w), step))))) &
         0xffu;
}

// x (M, K) -> xq (M, Kp) u8 levels; x_nan[m] = 1 where row m holds a NaN.
// One thread per 16-byte chunk of xq (16 consecutive k of one row); k >= K
// packs as 0. VEC: the chunk's 16 values load as 16-byte vectors (K a
// multiple of 4 for float32, 8 for bfloat16, x 16-byte aligned).
template <typename TX, bool VEC>
__global__ void __launch_bounds__(kPackThreads)
imac_mvm_pack_x_kernel(const TX* __restrict__ x, uint8_t* __restrict__ xq,
                       int* __restrict__ x_nan, int m_rows, int k_dim, int kp, int dac_n) {
  const int chunks = kp / 16;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kPackThreads + threadIdx.x;
  if (e >= static_cast<int64_t>(m_rows) * chunks) return;
  const int m = static_cast<int>(e / chunks);
  const int k0 = static_cast<int>(e % chunks) * 16;
  const TX* row = x + static_cast<int64_t>(m) * k_dim;
  float v[16];
  if (VEC && k0 + 16 <= k_dim) {
    if constexpr (sizeof(TX) == 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(row + k0)[q];
        v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint4 raw = reinterpret_cast<const uint4*>(row + k0)[q];
        const TX* b = reinterpret_cast<const TX*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[8 * q + j] = to_float(b[j]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = k0 + j < k_dim ? to_float(row[k0 + j]) : 0.0f;
  }
  const float n = static_cast<float>(dac_n);
  uint32_t word[4] = {0u, 0u, 0u, 0u};
  bool nan = false;
#pragma unroll
  for (int j = 0; j < 16; ++j) word[j / 4] |= dac_level(v[j], n, nan) << (8 * (j % 4));
  *reinterpret_cast<uint4*>(xq + static_cast<int64_t>(m) * kp + k0) =
      make_uint4(word[0], word[1], word[2], word[3]);
  if (nan) x_nan[m] = 1;
}

// w (K, N) float32 -> wq (N, Kp) s8 levels, transposed; w_nan[n] = 1 where
// column n holds a NaN. A block packs a 64 (K) x 64 (N) tile: thread
// (tn, tk) loads rows k0 + 4tk .. +3 of columns n0 + 4tn .. +3 (float4
// along N: a warp reads 2 rows x 256 contiguous bytes), packs each
// column's 4 levels into one word of the transposed tile in shared memory,
// and then writes one 16-byte chunk of it (4 threads: 64 contiguous
// bytes of one output row). VEC: float4 loads (N % 4 == 0, w aligned).
template <bool VEC>
__global__ void __launch_bounds__(kPackThreads)
imac_mvm_pack_w_kernel(const float* __restrict__ w, int8_t* __restrict__ wq,
                       int* __restrict__ w_nan, int k_dim, int n_cols, int kp, float step) {
  __shared__ uint32_t tile[64][17];  // [n][k / 4], padded against bank conflicts
  const int tid = threadIdx.x;
  const int tn = tid % 16, tk = tid / 16;
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const int col = n0 + 4 * tn;
  float v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * tk + i;
    const float* src = w + static_cast<int64_t>(k) * n_cols + col;
    if (VEC) {
      const float4 f = k < k_dim && col < n_cols ? *reinterpret_cast<const float4*>(src)
                                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[i][0] = f.x, v[i][1] = f.y, v[i][2] = f.z, v[i][3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = k < k_dim && col + j < n_cols ? src[j] : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bool nan = false;
    uint32_t word = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) word |= weight_level(v[i][j], step, nan) << (8 * i);
    tile[4 * tn + j][tk] = word;
    if (nan && col + j < n_cols) w_nan[col + j] = 1;
  }
  __syncthreads();
  const int n = tid / 4, c = tid % 4;
  const int kc = k0 + 16 * c;
  if (n0 + n < n_cols && kc < kp)
    *reinterpret_cast<uint4*>(wq + static_cast<int64_t>(n0 + n) * kp + kc) =
        make_uint4(tile[n][4 * c], tile[n][4 * c + 1], tile[n][4 * c + 2], tile[n][4 * c + 3]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// TMA: the box at (c0 = K byte, c1 = row) of `map` into shared memory at
// `dst`, completing `bytes` on the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzled
// rows (as TMA's SWIZZLE_128B writes them): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d (64 x 128 s32, the warpgroup's fragment) += A (64 x 32 u8) B^T (128 x 32 s8).
__device__ __forceinline__ void wgmma_u8s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// The shared memory of the GEMM with WGS consumer warpgroups (64 * WGS rows).
template <int WGS>
struct Int8Layout {
  static constexpr int kBM = 64 * WGS;
  static constexpr int kStages = WGS == 1 ? 4 : 6;
  static constexpr int kABytes = kBM * kInt8BK;
  static constexpr int kStageBytes = kABytes + kInt8BN * kInt8BK;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kRedStride = kInt8BN + 4;  // s32 per row of the partial tile
  static constexpr size_t kBytes = 1024 + kRingBytes + 2 * kStages * sizeof(uint64_t);
  static_assert(kBM * kRedStride * 4 <= kRingBytes, "the partial tile reuses the ring");
  static_assert(kStageBytes % 1024 == 0 && kABytes % 1024 == 0, "1024-byte aligned stages");
};

// Grid: (column tiles x splits, row tiles), the splits of one output tile a
// cluster along x. Block rank r of cluster t owns columns [128t, 128t + 128),
// rows [BM * blockIdx.y, +BM) and K steps [r * chunk, min((r + 1) * chunk,
// k_steps)) of 128 bytes. Threads: WGS consumer warpgroups, then one
// producer warpgroup (one thread issues the TMA loads).
template <int WGS>
__global__ void __launch_bounds__((WGS + 1) * 128, 1)
imac_mvm_int8_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w, float* __restrict__ y,
                     const int* __restrict__ x_nan, const int* __restrict__ w_nan, int m_rows,
                     int n_cols, int k_steps, int chunk, double c) {
  using L = Int8Layout<WGS>;
  namespace cg = cooperative_groups;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t full = ring + L::kRingBytes;                      // kStages mbarriers
  const uint32_t empty = full + L::kStages * sizeof(uint64_t);     // kStages mbarriers

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int split = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / splits) * kInt8BN;
  const int m0 = blockIdx.y * L::kBM;
  const int s0 = split * chunk;
  const int steps = min(chunk, k_steps - s0);
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WGS) {
    // Producer: keep the ring full. A stage is refilled once every
    // consumer warpgroup has released it (its empty barrier's phase).
    if (t == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % L::kStages;
        mbar_wait(empty + 8 * s, ((i / L::kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, L::kStageBytes);
        const uint32_t dst = ring + s * L::kStageBytes;
        tma_load(dst, &tm_x, (s0 + i) * kInt8BK, m0, full + 8 * s);
        tma_load(dst + L::kABytes, &tm_w, (s0 + i) * kInt8BK, n0, full + 8 * s);
      }
    }
  } else {
    // Consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the tile, all
    // 128 columns; four k32 steps per stage, the descriptors advanced by
    // 32 bytes inside the swizzled rows.
    int acc[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0;
    for (int i = 0; i < steps; ++i) {
      const int s = i % L::kStages;
      mbar_wait(full + 8 * s, (i / L::kStages) & 1);
      const uint32_t a = ring + s * L::kStageBytes + wg * 64 * kInt8BK;
      const uint32_t b = ring + s * L::kStageBytes + L::kABytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kInt8BK / 32; ++kk)
        wgmma_u8s8(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (t == 0) mbar_arrive(empty + 8 * s);
    }
    // Every consumer is done with the ring: it now holds the block's
    // partial tile red[row][col] (s32), from the wgmma fragment layout
    // (warp w of the warpgroup: rows 16w + lane/4 (+8); columns
    // 8j + 2(lane%4) (+1) for j < 16).
    asm volatile("bar.sync 1, %0;\n" ::"n"(WGS * 128) : "memory");
    int* red = reinterpret_cast<int*>(ring_ptr);
    const int warp = t / 32, lane = t % 32;
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      const int row = 64 * wg + 16 * warp + lane / 4 + 8 * ((r / 2) % 2);
      const int col = 8 * (r / 4) + 2 * (lane % 4) + r % 2;
      red[row * L::kRedStride + col] = acc[r];
    }
  }
  cluster.sync();

  // Sum the cluster's partial tiles over distributed shared memory (exact
  // in s32, so the order does not matter), scale, and write y; the
  // cluster's blocks share out the tile's elements.
  const int* red = reinterpret_cast<const int*>(ring_ptr);
  constexpr int kThreads = (WGS + 1) * 128;
  for (int e = split * kThreads + threadIdx.x; e < L::kBM * kInt8BN; e += splits * kThreads) {
    const int row = e / kInt8BN, col = e % kInt8BN;
    const int m = m0 + row, n = n0 + col;
    if (m >= m_rows || n >= n_cols) continue;
    int sum = 0;
    for (int q = 0; q < splits; ++q) sum += cluster.map_shared_rank(red, q)[row * L::kRedStride + col];
    y[static_cast<int64_t>(m) * n_cols + n] =
        (x_nan[m] | w_nan[n]) ? __int_as_float(0x7fc00000)
                              : __double2float_rn(__dmul_rn(static_cast<double>(sum), c));
  }
  cluster.sync();  // no block leaves while another reads its partial tile
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, through the runtime's entry-point query
// (the library links no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a (rows, kp) u8 matrix, row-major, in boxes of box_rows
// rows x 128 bytes with the 128-byte swizzle; out-of-range boxes fill 0.
cudaError_t levels_map(CUtensorMap* map, const void* base, int rows, int kp, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kInt8BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                              strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

using Int8Kernel = void (*)(CUtensorMap, CUtensorMap, float*, const int*, const int*, int, int,
                            int, int, double);

Int8Kernel int8_kernel(int wgs) {
  switch (wgs) {
    case 1: return imac_mvm_int8_kernel<1>;
    case 2: return imac_mvm_int8_kernel<2>;
    default: return nullptr;
  }
}

size_t int8_smem_bytes(int wgs) {
  return wgs == 1 ? Int8Layout<1>::kBytes : Int8Layout<2>::kBytes;
}

// Opt the GEMM into its shared memory and fill in its cluster launch
// configuration (grid: n_tiles * splits x m_tiles blocks).
cudaError_t int8_config(int wgs, int splits, int n_tiles, int m_tiles, cudaStream_t stream,
                        cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  const Int8Kernel kernel = int8_kernel(wgs);
  if (kernel == nullptr || splits < 1 || splits > 8) return cudaErrorInvalidValue;
  const size_t smem = int8_smem_bytes(wgs);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_tiles * splits), static_cast<unsigned>(m_tiles));
  cfg.blockDim = dim3((wgs + 1) * 128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename TX>
cudaError_t launch_pack_x(const void* x, uint8_t* xq, int* x_nan, int m, int k, int kp,
                          int dac_n, cudaStream_t stream) {
  const int64_t chunks = static_cast<int64_t>(m) * (kp / 16);
  const unsigned blocks = static_cast<unsigned>((chunks + kPackThreads - 1) / kPackThreads);
  const bool vec = k % (16 / sizeof(TX)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec)
    imac_mvm_pack_x_kernel<TX, true><<<blocks, kPackThreads, 0, stream>>>(
        static_cast<const TX*>(x), xq, x_nan, m, k, kp, dac_n);
  else
    imac_mvm_pack_x_kernel<TX, false><<<blocks, kPackThreads, 0, stream>>>(
        static_cast<const TX*>(x), xq, x_nan, m, k, kp, dac_n);
  return cudaGetLastError();
}

cudaError_t launch_pack_w(const void* w, int8_t* wq, int* w_nan, int k, int n, int kp,
                          float step, cudaStream_t stream) {
  const dim3 grid((n + 63) / 64, (kp + 63) / 64);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec)
    imac_mvm_pack_w_kernel<true><<<grid, kPackThreads, 0, stream>>>(
        static_cast<const float*>(w), wq, w_nan, k, n, kp, step);
  else
    imac_mvm_pack_w_kernel<false><<<grid, kPackThreads, 0, stream>>>(
        static_cast<const float*>(w), wq, w_nan, k, n, kp, step);
  return cudaGetLastError();
}

cudaError_t launch_int8(const void* x, bool x_bf16, const void* w, void* y, int m, int k, int n,
                        int dac_n, int levels, float step, double c, void* xq, void* wq,
                        int* flags, int kp, int wgs, int splits, int chunk, cudaStream_t stream) {
  const int k_steps = (kp + kInt8BK - 1) / kInt8BK;
  const bool ok = dac_n >= 1 && dac_n <= 255 && levels >= 2 && levels <= 128 && k >= 1 &&
                  k <= kInt8MaxK && kp % 16 == 0 && kp >= k && kp < k + 16 && chunk >= 1 &&
                  static_cast<int64_t>(splits) * chunk >= k_steps &&
                  static_cast<int64_t>(splits - 1) * chunk < k_steps &&
                  reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  if (!ok) return cudaErrorInvalidValue;
  const int bm = 64 * wgs;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = int8_config(wgs, splits, (n + kInt8BN - 1) / kInt8BN, (m + bm - 1) / bm,
                                stream, cfg, attr);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_x, tm_w;
  if ((err = levels_map(&tm_x, xq, m, kp, bm)) != cudaSuccess) return err;
  if ((err = levels_map(&tm_w, wq, n, kp, kInt8BN)) != cudaSuccess) return err;
  int* x_nan = flags;
  int* w_nan = flags + m;
  if ((err = cudaMemsetAsync(flags, 0, sizeof(int) * (static_cast<size_t>(m) + n), stream)) !=
      cudaSuccess)
    return err;
  err = x_bf16 ? launch_pack_x<__nv_bfloat16>(x, static_cast<uint8_t*>(xq), x_nan, m, k, kp,
                                              dac_n, stream)
               : launch_pack_x<float>(x, static_cast<uint8_t*>(xq), x_nan, m, k, kp, dac_n,
                                      stream);
  if (err != cudaSuccess) return err;
  if ((err = launch_pack_w(w, static_cast<int8_t*>(wq), w_nan, k, n, kp, step, stream)) !=
      cudaSuccess)
    return err;
  err = cudaLaunchKernelEx(&cfg, int8_kernel(wgs), tm_x, tm_w, static_cast<float*>(y),
                           static_cast<const int*>(x_nan), static_cast<const int*>(w_nan), m, n,
                           k_steps, chunk, c);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// ---------------------------------------------------------------------------
// M > 16, other quantisers: the 64x64x16 tile.
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

// y (m, n) float32 = DAC(x) @ Q(w) through the integer route, for integer
// quantisers (1 <= dac_n <= 255, 2 <= levels <= 128) and k <= 66,000: x
// (m, k) float32 (or bfloat16 when x_is_bf16) and w (k, n) float32, all
// contiguous, on `stream` of CUDA device `device`. Workspace from the
// caller: xq (m * kp bytes) and wq (n * kp bytes), 16-byte aligned, and
// flags (m + n ints); kp = k rounded up to 16. c = double(step) / dac_n.
// The plan: wgs consumer warpgroups (64 * wgs rows a block), `splits` K
// ranges of `chunk` 128-byte steps (the cluster size, <= 8). Four
// launches in order on the stream: zero the flags, pack x, pack w, the
// GEMM. Returns the CUDA error code (0 = success).
extern "C" int imac_mvm_int8_launch(const void* x, int x_is_bf16, const void* w, void* y, int m,
                                    int k, int n, int dac_n, int levels, float step, double c,
                                    void* xq, void* wq, void* flags, int kp, int wgs, int splits,
                                    int chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_int8(x, x_is_bf16 != 0, w, y, m, k, n, dac_n, levels, step, c, xq, wq,
                    static_cast<int*>(flags), kp, wgs, splits, chunk,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The most clusters of `splits` blocks of the integer route's GEMM with
// wgs consumer warpgroups that device `device` runs at once, into
// *clusters. Returns the CUDA error code (0 = success).
extern "C" int imac_mvm_int8_max_clusters(int wgs, int splits, int device, int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = int8_config(wgs, splits, 1, 1, nullptr, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, int8_kernel(wgs), &cfg));
}
