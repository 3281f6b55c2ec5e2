// Flash-decoding attention (one query token against a KV cache), CUDA C++
// for Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel `_decode_kernel`
// (src/repro/kernels/decode_attention/kernel.py:30, dispatched by
// `decode_attention_flat`). For each (batch, KV head) row it computes the
// softmax attention of the G grouped query heads over the row's first
// `len` cache positions, with Dk (scores) and Dv (values) free to differ.
// It is the decode step's attention in every attention layer of the LM
// substrate (one launch per layer per decode tick).
//
// Bound. Bytes: each K and V element of the valid prefix is read once
// (B*len*Hkv*(Dk+Dv)*2 bytes in bfloat16: 537 MB at B=32, S=8192, Hkv=4,
// D=128 at full lengths, 0.160 ms at 3.35 TB/s), against 4*G*(Dk+Dv)
// flops per position: 8 flops per byte at G=8, below the card's ridge.
// Two routes: `plan_for` in ops.py picks one by shape, and `split_plan`
// sizes the split-KV grid, which is passed in.
//
// Split-KV route (bfloat16, G <= 8, Dk = Dv in {64, 128}, 16-byte aligned
// rows: every shape of the serving path):
//   * Grid: (B*Hkv rows) x `splits` blocks; the splits of one row are one
//     thread-block cluster (<= 8, the portable size). Block rank r owns the
//     positions [r*chunk, (r+1)*chunk) of its row; `chunk` is a multiple of
//     the block's tile (4 warps x 16 positions), and the plan sizes it
//     from the cache's capacity S, never from the lengths (they live on
//     the device), taking the fewest positions on a block's critical path
//     over waves of the clusters the card holds at once: blocks of equal
//     work start and end together, and each wave boundary drains the
//     copies in flight. A split that starts
//     at or past its row's length reads nothing and publishes m = -1e30,
//     l = 0, acc = 0; split 0 starts at 0, so every row has a non-empty
//     split.
//   * Staging: each warp takes every 4th tile of its block's range and
//     streams its K and V rows through its own ring of kStages tiles in
//     shared memory with 16-byte cp.async copies that bypass L1
//     (kStages - 1 tiles in flight while one is computed), in bfloat16 as
//     the cache holds them. The warp reads back only its own ring, so the
//     main loop has warp barriers only. Positions at or past the length
//     are zero-filled without being read.
//   * Arithmetic on the tensor cores (mma.sync.m16n8k16, fp32
//     accumulate): scores = q (heads in rows 0-7 of A, held in registers
//     for the whole range) x K^T (ldmatrix from a swizzled tile), then
//     out += P x V (ldmatrix.trans) with P entering as a hi + lo pair of
//     bfloat16 values in rows 0-7 and 8-15 of the same A fragment, so that
//     P.V keeps the float32 P of the plain version at no extra MMA. The
//     score fragment's layout is the P fragment's: no shuffles between the
//     two products. Each K and V element is read from shared memory once
//     per warp and serves all G heads.
//   * Online softmax per warp: scores scaled in float32, positions at or
//     past the length score -1e30, (m, l, acc) carried in registers.
//   * Combine: each block combines its 4 warps' partials in warp order in
//     shared memory; after cluster.sync() the cluster combines its blocks'
//     partials over distributed shared memory in rank order
//     (m* = max m_r, l = sum exp(m_r - m*) l_r, out = sum exp(m_r - m*)
//     acc_r / l), each block writing a share of the outputs, and a second
//     cluster.sync() keeps every block resident while another reads its
//     partials. One launch, no atomics, no scratch in device memory:
//     relaunches are bit-identical.
//
// Rows route (what the split-KV route does not take: float32, G > 8,
// other head dims such as the MLA-like Dk=576, Dv=512, whose accumulators
// would not fit the registers, or rows not 16-byte aligned; every float32
// caller is a reduced config of head dim 32): one block per (batch,
// KV-head) row looping over blocks of `bs` positions staged in shared
// memory as float32 (K rows padded to Dk + 1 floats), all G heads sharing
// each staged block, one warp per head updating (m, l, alpha), each thread
// its accumulator entries; 16-byte loads where rows are aligned, 8 in
// flight per thread.
//
// Masking (both routes). Positions at or past the row's length score
// -1e30, as in the TPU kernel, and are exact: a masked score contributes
// exp(-1e30 - m) = 0 once a valid score has set m, and a partial with
// m = -1e30, l = 0 contributes 0 to the combine. (len = 0 is not
// supported: the row would be 0 / 0.) A length past S is clamped to S,
// the plain version's mask. S need not be a multiple of any tile.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

// ---------------------------------------------------------------------------
// Rows route.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBatch = 8;          // loads each thread keeps in flight while staging

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One load of the cache staging: a 16-byte vector of T (kVec) or one T.
template <typename T, bool kVec>
struct Chunk;

template <typename T>
struct Chunk<T, false> {
  static constexpr int kWidth = 1;
  T raw;
  __device__ __forceinline__ void load(const T* p) { raw = *p; }
  __device__ __forceinline__ void unpack(float* f) const { f[0] = to_float(raw); }
};

template <>
struct Chunk<float, true> {
  static constexpr int kWidth = 4;
  float4 raw;
  __device__ __forceinline__ void load(const float* p) {
    raw = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void unpack(float* f) const {
    f[0] = raw.x; f[1] = raw.y; f[2] = raw.z; f[3] = raw.w;
  }
};

template <>
struct Chunk<__nv_bfloat16, true> {
  static constexpr int kWidth = 8;
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void unpack(float* f) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

// Stage the K and V rows of positions [s0, s0 + n_valid) in shared memory
// as float32. Each thread issues kBatch independent loads before it
// converts and stores any of them, so that many loads are in flight.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_block(const T* __restrict__ k_row,
                                            const T* __restrict__ v_row, int64_t k_ss,
                                            int64_t v_ss, int s0, int n_valid, int dk,
                                            int dv, float* k_s, int ks, float* v_s) {
  using C = Chunk<T, kVec>;
  constexpr int W = C::kWidth;
  const int kc = dk / W, vc = dv / W;  // chunks per row
  const int nk = n_valid * kc;
  const int total = nk + n_valid * vc;
  for (int e0 = threadIdx.x; e0 < total; e0 += kThreads * kBatch) {
    C chunk[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      if (e < nk) {
        chunk[j].load(k_row + (s0 + e / kc) * k_ss + (e % kc) * W);
      } else if (e < total) {
        const int f = e - nk;
        chunk[j].load(v_row + (s0 + f / vc) * v_ss + (f % vc) * W);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * kThreads;
      float vals[W];
      if (e < nk) {
        chunk[j].unpack(vals);
        float* dst = k_s + (e / kc) * ks + (e % kc) * W;
#pragma unroll
        for (int i = 0; i < W; ++i) dst[i] = vals[i];
      } else if (e < total) {
        const int f = e - nk;
        chunk[j].unpack(vals);
        float* dst = v_s + (f / vc) * dv + (f % vc) * W;
#pragma unroll
        for (int i = 0; i < W; ++i) dst[i] = vals[i];
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, int hkv, int g, int s_len, int dk,
                        int dv, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
                        int bs) {
  extern __shared__ float smem[];
  const int ks = dk + 1;               // padded K row stride
  float* q_s = smem;                   // g x dk
  float* k_s = q_s + g * dk;           // bs x ks
  float* v_s = k_s + bs * ks;          // bs x dv
  float* p_s = v_s + bs * dv;          // g x bs scores, then probabilities
  float* acc_s = p_s + g * bs;         // g x dv
  float* m_s = acc_s + g * dv;         // g running max
  float* l_s = m_s + g;                // g running sum
  float* a_s = l_s + g;                // g rescale of this block

  const int row = blockIdx.x;
  const int b = row / hkv;
  const int h = row % hkv;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  constexpr int kWarps = kThreads / 32;
  const int len = min(lengths[b], s_len);

  const T* q_row = q + static_cast<int64_t>(row) * g * dk;
  const T* k_row = k + b * k_sb + h * k_sh;
  const T* v_row = v + b * v_sb + h * v_sh;

  for (int e = tid; e < g * dk; e += kThreads) q_s[e] = to_float(q_row[e]);
  for (int e = tid; e < g * dv; e += kThreads) acc_s[e] = 0.0f;
  for (int e = tid; e < g; e += kThreads) {
    m_s[e] = kNegInf;
    l_s[e] = 0.0f;
  }

  for (int s0 = 0; s0 < len; s0 += bs) {
    const int n_valid = min(bs, len - s0);  // positions of this block below len
    __syncthreads();  // the previous block's K, V and p are no longer read
    stage_block<T, kVec>(k_row, v_row, k_ss, v_ss, s0, n_valid, dk, dv, k_s, ks, v_s);
    __syncthreads();

    // Scores: consecutive threads take consecutive positions of one head.
    for (int e = tid; e < g * bs; e += kThreads) {
      const int gi = e / bs, si = e % bs;
      float sc = kNegInf;
      if (si < n_valid) {
        const float* qg = q_s + gi * dk;
        const float* kr = k_s + si * ks;
        float dot = 0.0f;
        for (int d = 0; d < dk; ++d) dot = fmaf(qg[d], kr[d], dot);
        sc = dot * scale;
      }
      p_s[e] = sc;
    }
    __syncthreads();

    // Online-softmax update, one warp per head.
    for (int gi = warp; gi < g; gi += kWarps) {
      float* pg = p_s + gi * bs;
      float mx = kNegInf;
      for (int si = lane; si < bs; si += 32) mx = fmaxf(mx, pg[si]);
      mx = warp_max(mx);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int si = lane; si < bs; si += 32) {
        const float p = expf(pg[si] - m_new);
        pg[si] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[gi] = alpha * l_s[gi] + sum;
        m_s[gi] = m_new;
        a_s[gi] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p @ V over the valid positions.
    for (int e = tid; e < g * dv; e += kThreads) {
      const int gi = e / dv, d = e % dv;
      const float* pg = p_s + gi * bs;
      float sum = 0.0f;
      for (int si = 0; si < n_valid; ++si) sum = fmaf(pg[si], v_s[si * dv + d], sum);
      acc_s[e] = a_s[gi] * acc_s[e] + sum;
    }
  }
  __syncthreads();

  T* out_row = out + static_cast<int64_t>(row) * g * dv;
  for (int e = tid; e < g * dv; e += kThreads) store(out_row + e, acc_s[e] / l_s[e / dv]);
}

template <typename T, bool kVec>
cudaError_t run(dim3 grid, long long smem, cudaStream_t stream, const void* q, const void* k,
                const void* v, const void* lengths, void* out, int hkv, int g, int s_len,
                int dk, int dv, long long k_sb, long long k_ss, long long k_sh,
                long long v_sb, long long v_ss, long long v_sh, float scale, int bs) {
  auto kernel = decode_attention_kernel<T, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), hkv, g, s_len, dk, dv, k_sb,
      k_ss, k_sh, v_sb, v_ss, v_sh, scale, bs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Split-KV route (bfloat16).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kStages = 3;    // per-warp ring depth: kStages - 1 tiles in flight
constexpr int kHeads = 8;     // the most grouped heads (rows 0-7 of the MMA)
constexpr int kPos = 16;      // positions of a warp's tile: the MMA's K depth

template <int D>
struct SplitLayout {
  static constexpr int kTileElems = 2 * kPos * D;  // K then V of one tile
  static constexpr size_t kRingBytes =
      static_cast<size_t>(kSplitWarps) * kStages * kTileElems * sizeof(bf16);
  static constexpr int kPartFloats = 2 * kHeads + kHeads * D;  // m[8], l[8], acc[8][D]
  static constexpr size_t kBytes = kRingBytes + sizeof(float) * kPartFloats;
  // A warp's partial is written over its own ring once the ring is dead.
  static_assert(sizeof(float) * kPartFloats <= kStages * kTileElems * sizeof(bf16),
                "partial fits");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16-byte chunk c of tile row r lives at chunk c ^ (r & 7), so that
// ldmatrix's 8 rows of one chunk column hit 8 distinct bank groups.
__device__ __forceinline__ int swz(int r, int c) { return c ^ (r & 7); }

// Copy the K and V rows of positions [p0, p0 + kPos) into one ring slot;
// positions at or past `end` are zero-filled without being read.
template <int D>
__device__ __forceinline__ void stage_tile(bf16* slot, const bf16* __restrict__ k_row,
                                           const bf16* __restrict__ v_row, int64_t k_ss,
                                           int64_t v_ss, int p0, int end, int lane) {
  constexpr int kVec = 16 / sizeof(bf16);    // elements per chunk
  constexpr int kChunks = D / kVec;          // chunks per row
  constexpr int kPer = kPos * kChunks / 32;  // chunks per lane, of K and of V each
  static_assert(kPos * kChunks % 32 == 0, "tile/lanes");
  bf16* ks = slot;
  bf16* vs = slot + kPos * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = lane + 32 * i;
    const int r = e / kChunks, c = e % kChunks;
    const int pos = p0 + r;
    const bool ok = pos < end;
    const int dst = r * D + swz(r, c) * kVec;
    cp_async16(ks + dst, ok ? k_row + pos * k_ss + c * kVec : k_row, ok);
    cp_async16(vs + dst, ok ? v_row + pos * v_ss + c * kVec : v_row, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += A (16x16, rows 0-7 from a0/a2, rows 8-15 from a1/a3) x B (16x8).
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p = hi + lo in bfloat16: hi = bf16(p), lo = bf16(p - hi).
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(p0 - hf.x, p1 - hf.y);
}

// Lane state of the bfloat16 route: lane L serves head g = L / 4 (rows of
// the MMA), t = L % 4 its column pair. acc[n] holds out[g][n*8 + 2t + {0,1}]
// from P_hi in [0..1] and from P_lo in [2..3].
template <int D>
struct MmaState {
  uint32_t qa[D / 16][2];  // q[g][16 kk + 2t + {0,1}] and [.. + 8]
  float acc[D / 8][4];
  float m, l;              // of head g; l summed over this lane's positions only
};

template <int D>
__device__ __forceinline__ void mma_init(MmaState<D>& st, const bf16* __restrict__ q_row,
                                         int g_count, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st.qa[kk][h] = g < g_count ? *reinterpret_cast<const uint32_t*>(
                                       q_row + g * D + kk * 16 + h * 8 + 2 * t)
                                 : 0u;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.acc[n][i] = 0.0f;
  st.m = kNegInf;
  st.l = 0.0f;
}

template <int D>
__device__ __forceinline__ void mma_tile(MmaState<D>& st, const bf16* slot, int p0,
                                         int end, float scale, int lane) {
  const bf16* ks = slot;
  const bf16* vs = slot + kPos * D;
  const int t = lane & 3;
  const int mj = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row

  // Scores of 16 positions (two n-tiles of 8) x heads: c[nt][0..1] is
  // S[g][nt*8 + 2t + {0,1}]; c[nt][2..3] belong to the empty rows 8-15.
  float c[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t b[4];
    const int pos = (mj >> 1) * 8 + mr;
    ldmatrix_x4(b, ks + pos * D + swz(pos, 2 * kk + (mj & 1)) * 8);
    mma_bf16(c[0], st.qa[kk][0], 0u, st.qa[kk][1], 0u, b[0], b[1]);
    mma_bf16(c[1], st.qa[kk][0], 0u, st.qa[kk][1], 0u, b[2], b[3]);
  }

  float s[4];
  float mx = kNegInf;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = p0 + (i >> 1) * 8 + 2 * t + (i & 1);
    s[i] = pos < end ? c[i >> 1][i & 1] * scale : kNegInf;
    mx = fmaxf(mx, s[i]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(st.m, mx);
  const float alpha = expf(st.m - m_new);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = expf(s[i] - m_new);
    sum += s[i];
  }
  st.l = alpha * st.l + sum;
  st.m = m_new;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.acc[n][i] *= alpha;

  // P (heads x 16 positions) as A: rows 0-7 P_hi, rows 8-15 P_lo.
  uint32_t a0, a1, a2, a3;
  split_bf16(s[0], s[1], a0, a1);
  split_bf16(s[2], s[3], a2, a3);
#pragma unroll
  for (int jj = 0; jj < D / 16; ++jj) {
    uint32_t b[4];
    const int pos = (mj & 1) * 8 + mr;
    ldmatrix_x4_trans(b, vs + pos * D + swz(pos, 2 * jj + (mj >> 1)) * 8);
    mma_bf16(st.acc[2 * jj], a0, a1, a2, a3, b[0], b[1]);
    mma_bf16(st.acc[2 * jj + 1], a0, a1, a2, a3, b[2], b[3]);
  }
}

// Write the warp's partial: m[8], l[8], acc[8][D].
template <int D>
__device__ __forceinline__ void mma_publish(MmaState<D>& st, float* part, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float l = st.l;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (t == 0) {
    part[g] = st.m;
    part[kHeads + g] = l;
  }
  float* acc = part + 2 * kHeads + g * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    *reinterpret_cast<float2*>(acc + n * 8 + 2 * t) =
        make_float2(st.acc[n][0] + st.acc[n][2], st.acc[n][1] + st.acc[n][3]);
}

// Grid: B*Hkv*splits blocks in clusters of `splits` along x; block rank r
// of cluster (row) owns positions [r*chunk, min((r+1)*chunk, len)).
//
// Shared memory: the warps' rings [kSplitWarps][kStages][K, V of kPos x D]
// (each warp's reused for its partial) and the block's partial m[8], l[8],
// acc[8][D].
template <int D>
__global__ void __launch_bounds__(kSplitThreads, 2)
decode_attention_splitkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const int* __restrict__ lengths,
                                bf16* __restrict__ out, int hkv, int g_count, int s_len,
                                int chunk, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale) {
  namespace cg = cooperative_groups;
  using L = SplitLayout<D>;
  extern __shared__ __align__(16) unsigned char split_smem[];
  bf16* rings = reinterpret_cast<bf16*>(split_smem);
  float* bpart = reinterpret_cast<float*>(split_smem + L::kRingBytes);

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / splits;
  const int b = row / hkv;
  const int h = row % hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = min(lengths[b], s_len);
  const int lo = rank * chunk;
  const int end = min(lo + chunk, len);

  const bf16* k_row = k + b * k_sb + h * k_sh;
  const bf16* v_row = v + b * v_sb + h * v_sh;
  bf16* ring = rings + warp * kStages * L::kTileElems;

  MmaState<D> st;
  mma_init<D>(st, q + static_cast<int64_t>(row) * g_count * D, g_count, lane);

  // This warp's tiles start at lo + (warp + i * kSplitWarps) * kPos.
  const int first = lo + warp * kPos;
  constexpr int kStride = kSplitWarps * kPos;
  const int n_tiles = first < end ? (end - first + kStride - 1) / kStride : 0;
  auto tile_start = [&](int i) { return first + i * kStride; };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles)
      stage_tile<D>(ring + i * L::kTileElems, k_row, v_row, k_ss, v_ss, tile_start(i), end,
                    lane);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    // Refill the slot computed in the previous step, then wait for tile i.
    const int next = i + kStages - 1;
    if (next < n_tiles)
      stage_tile<D>(ring + (next % kStages) * L::kTileElems, k_row, v_row, k_ss, v_ss,
                    tile_start(next), end, lane);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copies of tile i have landed
    mma_tile<D>(st, ring + (i % kStages) * L::kTileElems, tile_start(i), end, scale, lane);
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  float* wpart = reinterpret_cast<float*>(ring);
  mma_publish<D>(st, wpart, lane);
  __syncthreads();

  // The block's partial: its warps' partials combined in warp order.
  constexpr int kWarpStride = kStages * L::kTileElems * static_cast<int>(sizeof(bf16)) / 4;
  const float* w0 = reinterpret_cast<const float*>(rings);
  for (int e = tid; e < kHeads * D; e += kSplitThreads) {
    const int g = e / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, w0[w * kWarpStride + g]);
    float l = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float* wp = w0 + w * kWarpStride;
      const float f = expf(wp[g] - mx);
      l += f * wp[kHeads + g];
      a += f * wp[2 * kHeads + e];
    }
    bpart[2 * kHeads + e] = a;
    if (e % D == 0) {
      bpart[g] = mx;
      bpart[kHeads + g] = l;
    }
  }

  // The row's output: the cluster's block partials combined in rank order,
  // over distributed shared memory; the blocks share out the outputs.
  cluster.sync();
  bf16* out_row = out + static_cast<int64_t>(row) * g_count * D;
  for (int e = rank * kSplitThreads + tid; e < g_count * D; e += splits * kSplitThreads) {
    const int g = e / D;
    float mx = kNegInf;
    for (int r = 0; r < splits; ++r) mx = fmaxf(mx, cluster.map_shared_rank(bpart, r)[g]);
    float l = 0.0f, a = 0.0f;
    for (int r = 0; r < splits; ++r) {
      const float* rp = cluster.map_shared_rank(bpart, r);
      const float f = expf(rp[g] - mx);
      l += f * rp[kHeads + g];
      a += f * rp[2 * kHeads + e];
    }
    store(out_row + e, a / l);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

using SplitKernel = void (*)(const bf16*, const bf16*, const bf16*, const int*, bf16*, int, int,
                             int, int, int64_t, int64_t, int64_t, int64_t, int64_t, int64_t,
                             float);

SplitKernel splitkv_kernel(int d, size_t* smem) {
  switch (d) {
    case 64:
      *smem = SplitLayout<64>::kBytes;
      return decode_attention_splitkv_kernel<64>;
    case 128:
      *smem = SplitLayout<128>::kBytes;
      return decode_attention_splitkv_kernel<128>;
    default:
      return nullptr;
  }
}

// Opt the kernel for head dim d into its shared memory and fill in its
// cluster launch configuration (`blocks` blocks in clusters of `splits`).
cudaError_t splitkv_config(int d, int splits, unsigned blocks, cudaStream_t stream,
                           SplitKernel* kernel, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  size_t smem = 0;
  *kernel = splitkv_kernel(d, &smem);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" long long decode_attention_smem_bytes(int g, int dk, int dv, int bs) {
  return 4LL * (static_cast<long long>(g) * dk + static_cast<long long>(bs) * (dk + 1) +
                static_cast<long long>(bs) * dv + static_cast<long long>(g) * bs +
                static_cast<long long>(g) * dv + 3LL * g);
}

// The rows route: attention of q (batch*hkv, g, dk) contiguous against the cache k, v
// (element strides k_sb/k_ss/k_sh over batch, position, head; the last
// dimension dense) for the first lengths[b] positions of each row; out
// (batch*hkv, g, dv). All of q, k, v, out float32, or bfloat16 when
// is_bf16. `bs` positions per block. Returns the CUDA error code of the
// launch (0 = success).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths, void* out,
    int is_bf16, int batch, int hkv, int g, int s_len, int dk, int dv,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int bs, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = decode_attention_smem_bytes(g, dk, dv, bs);
  const dim3 grid(static_cast<unsigned>(batch) * static_cast<unsigned>(hkv));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte loads where every row start is 16-byte aligned.
  const int width = is_bf16 ? 8 : 4;
  const bool vec = dk % width == 0 && dv % width == 0 && k_sb % width == 0 &&
                   k_ss % width == 0 && k_sh % width == 0 && v_sb % width == 0 &&
                   v_ss % width == 0 && v_sh % width == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (is_bf16) {
    err = vec ? run<__nv_bfloat16, true>(grid, smem, s, q, k, v, lengths, out, hkv, g, s_len,
                                          dk, dv, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, bs)
              : run<__nv_bfloat16, false>(grid, smem, s, q, k, v, lengths, out, hkv, g, s_len,
                                           dk, dv, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, bs);
  } else {
    err = vec ? run<float, true>(grid, smem, s, q, k, v, lengths, out, hkv, g, s_len, dk, dv,
                                 k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, bs)
              : run<float, false>(grid, smem, s, q, k, v, lengths, out, hkv, g, s_len, dk, dv,
                                  k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, bs);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The split-KV route: attention of q (batch*hkv, g, d) contiguous against
// the cache k, v (element strides over batch, position, head; the last
// dimension dense, d = Dk = Dv in {64, 128}, every row start 16-byte
// aligned), g <= 8, for the first lengths[b] positions of each row; out
// (batch*hkv, g, d). All of q, k, v, out bfloat16. The plan: `splits`
// blocks per row (the cluster size, <= 8), each owning `chunk` positions
// (a multiple of the block's tile of 64 positions), with
// (splits - 1) * chunk < s_len <= splits * chunk. Returns the CUDA error
// code of the launch (0 = success).
extern "C" int decode_attention_splitkv_launch(
    const void* q, const void* k, const void* v, const void* lengths, void* out, int batch,
    int hkv, int g, int s_len, int d, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, float scale, int splits, int chunk,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int width = 16 / sizeof(bf16);  // elements per 16 bytes
  constexpr int tile = kSplitWarps * kPos;
  const long long rows = static_cast<long long>(batch) * hkv;
  const bool ok =
      (d == 64 || d == 128) && g >= 1 && g <= kHeads && s_len >= 1 && splits >= 1 &&
      splits <= 8 && chunk >= tile && chunk % tile == 0 &&
      static_cast<long long>(splits) * chunk >= s_len &&
      static_cast<long long>(splits - 1) * chunk < s_len && rows * splits <= 0x7fffffffLL &&
      k_sb % width == 0 && k_ss % width == 0 && k_sh % width == 0 && v_sb % width == 0 &&
      v_ss % width == 0 && v_sh % width == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(v) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  SplitKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = splitkv_config(d, splits, static_cast<unsigned>(rows * splits),
                       static_cast<cudaStream_t>(stream), &kernel, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q),
                           static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                           static_cast<const int*>(lengths), static_cast<bf16*>(out), hkv, g,
                           s_len, chunk, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The most clusters of `splits` blocks of the split-KV kernel (head dim d)
// that device `device` runs at once, into *clusters (0: none fits).
// Returns the CUDA error code (0 = success).
extern "C" int decode_attention_splitkv_max_clusters(int d, int splits, int device,
                                                     int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  SplitKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = splitkv_config(d, splits, splits, nullptr, &kernel, cfg, attr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return static_cast<int>(err);
}
