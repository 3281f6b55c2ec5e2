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
// Design. One block per (batch, KV-head) row; on the TPU the cache
// blocks were a sequential grid axis carrying (m, l, acc) in VMEM, here a
// loop inside the block carries them in shared memory. Per block of `bs`
// positions: the K and V rows are staged in shared memory as float32
// (K rows padded to Dk + 1 floats so that threads on consecutive
// positions hit distinct banks), the G x bs scores are computed (all G
// heads share the staged K and V: GQA's bandwidth saving), one warp per
// head updates its running max m, sum l and rescale alpha, and then each
// thread updates its own accumulator entries acc[g][d] = alpha * acc +
// sum_s p[g][s] * V[s][d]. The output acc / l is written once, in the
// input dtype (float32 or bfloat16). The cache is read in place through
// its (batch, position, head) strides, in 16-byte vectors where the rows
// are 16-byte aligned, with 8 loads in flight per thread while a block
// is staged.
//
// Masking. Positions at or past the row's length score -1e30, as in the
// TPU kernel; the loop stops at the last block holding a valid position
// and the accumulator sums only valid positions. Both are exact: a
// masked score contributes exp(-1e30 - m) = 0 once a valid score has set
// m, and the first block always holds one since len >= 1. (len = 0 is
// not supported: the row would be 0 / 0.) A length past S is clamped to
// S, the plain version's mask. The ragged last block is masked here, so
// S need not be a multiple of bs.
//
// Bound. Bytes: each K and V element of the valid prefix is read once
// (B*S*Hkv*(Dk+Dv)*2 bytes in bfloat16: 537 MB at B=32, S=8192, Hkv=4,
// D=128, 0.16 ms at 3.35 TB/s), against 4*G*S*(Dk+Dv) flops per row.
// This first kernel does not overlap a block's staging with the previous
// block's arithmetic, reads its operands from shared memory for every
// multiply-add, and at the serving shape (B*Hkv = 16 rows) runs only 16
// blocks: split-KV across blocks is the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
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

}  // namespace

extern "C" long long decode_attention_smem_bytes(int g, int dk, int dv, int bs) {
  return 4LL * (static_cast<long long>(g) * dk + static_cast<long long>(bs) * (dk + 1) +
                static_cast<long long>(bs) * dv + static_cast<long long>(g) * bs +
                static_cast<long long>(g) * dv + 3LL * g);
}

// Attention of q (batch*hkv, g, dk) contiguous against the cache k, v
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
