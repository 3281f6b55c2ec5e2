// Batched tridiagonal (Thomas) solve on strided operands, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces the reference's Pallas TPU kernel `_tridiag_kernel`
// (src/repro/kernels/tridiag/kernel.py:26, called at :77). It is the inner
// solve of every half-sweep of the "tridiag" solver backend, and the path
// the fused kernel falls back to past its shared-memory residency limit.
//
// What it computes. Systems along the last axis of one broadcast shape
// (..., N): dl[0] and du[N-1] are never read; N == 1 gives x = b / d. The
// recurrence is the plain version's (den = d - l*c, c = du / den,
// p = (b - l*p) / den, x = p - c*x) with IEEE division and no fast math.
//
// Operands. Each of dl, d, du, b comes as the wrapper's view: up to 6
// batch axes (merged where every operand's strides allow) plus the element
// axis, with a 64-bit stride per axis that may be 0 (a broadcast). x is
// written densely in the layout the wrapper gives (b's own memory order).
// Nothing is copied or padded; the ragged edge is masked here.
//
// Bound: bytes. The backend hands the kernel b (read once) and x (written
// once) at full size, and coefficients that are broadcast over samples
// (stride 0) and so are read once from HBM and then from L2. At layer 1 of
// the 400x120x84x10 MLP (256 samples x 104 tiles of 31x30: 24.8 M nodes)
// that is 2 x 99.0 MB + the distinct coefficients (0.4 MB), >= 0.059 ms at
// 3.35 TB/s; ~8 flops a node are far below the fp32 rate.
//
// Design, against the three costs of the first port:
// 1. Layout copies. The first kernel wanted dense (N, B) operands, so the
//    wrapper transposed all four (stride-0 broadcasts included) and x back.
//    Here a block takes whole slabs: S consecutive systems of the innermost
//    batch axis at one outer index (P slabs when S is small). At both
//    main-path layouts a slab is one contiguous run of memory (rows: S
//    systems of N contiguous elements; columns: one (sample, tile) M x N
//    block, system stride 1). Threads stage each slab into shared memory
//    with coalesced 4-byte cp.async copies, walking it along whichever of
//    the two axes has the smaller stride, into an [element][system] layout
//    that holds all the block's systems side by side at an odd element
//    stride (no bank conflicts on either side). One thread then solves one
//    system from shared memory, and x goes back to HBM coalesced the same
//    way. Operands that are uniform over a slab (stride 0 along both the
//    system and the element axis: the backend's off-diagonals, per-config
//    scalars) are read once per thread, from L1/L2, and take no shared
//    memory; a template instance without their slots serves them.
// 2. Global scratch. The forward multipliers c overwrite d's staged slot
//    and the partials p overwrite b's, which the backward sweep turns into
//    x in place: c and p never leave the SM. Shared memory per block is
//    4 x slots x N x ((P x S) | 1) bytes (slots = 2, or 4 with dl and du);
//    the wrapper keeps it on chip while blocks of 8 warps in all fit an SM
//    (`ops.on_chip_limit`), which holds the backend's systems up to
//    N ~ 105. Past that (the 512x512 configuration's column systems,
//    N = 401) the same kernel, instantiated with OnChip = false, reads the
//    operands through their strides, keeps p in x and c in a global
//    workspace laid out [element][thread] (coalesced).
// 3. Coefficients rebuilt every sweep: the backend now builds them once per
//    solve at g's own (sample-free) shape; the kernel takes the stride-0
//    view, so no full-size d exists anywhere.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxAxes = 6;
constexpr int kMaxSlabs = 32;   // slabs a block takes at most
constexpr int kTensors = 5;     // dl, d, du, b, x
constexpr int kDl = 0, kD = 1, kDu = 2, kB = 3, kX = 4;
// Shared-memory slots (on chip): b, then p, then x; d, then c; dl; du.
constexpr int kSlotX = 0, kSlotC = 1, kSlotDl = 2, kSlotDu = 3;

// Unsigned division by a runtime constant through a multiply-high: exact
// for dividends below 2^31 (Granlund and Montgomery).
struct FastDiv {
  uint32_t div, mul, shift;
};

FastDiv make_fast_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, static_cast<uint32_t>(m), s};
}

__device__ __forceinline__ int fdiv(int n, const FastDiv& f) {
  const uint32_t u = static_cast<uint32_t>(n);
  return static_cast<int>((__umulhi(u, f.mul) + u) >> f.shift);
}

struct Params {
  const float* in[4];                // dl, d, du, b
  float* x;
  float* ws;                         // c workspace (OnChip == false)
  long long st[kTensors][kMaxAxes];  // batch strides; axis ndim-1 is the inner axis
  long long es[kTensors];            // element strides
  uint32_t size[kMaxAxes];
  FastDiv axis_div[kMaxAxes];
  int ndim;
  int n;                             // elements a system
  int S, P, spad;                    // systems a slab, slabs a block, (P*S) | 1
  uint32_t tiles;                    // slabs along the inner axis
  FastDiv tiles_div;
  uint32_t n_slabs;
  int efast[kTensors];               // staging order: 1 = element index fastest
  int contig[kTensors];              // node j of a slab sits at offset j
  FastDiv n_div, s_div;              // by N, S
  long long ws_stride;               // threads of the grid
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Move tensor t's slabs between global and shared memory: Load copies
// global -> shared with cp.async, else shared -> global. Node (k, e) of
// slab s sits at shared offset e*spad + s*S + k: the block's systems side
// by side, element by element, so that neighbouring threads (systems) hit
// neighbouring banks whichever slab they belong to. The nodes are walked in
// t's fastest order (consecutive threads on consecutive addresses), and a
// slab that is one run of memory (node j at offset j) needs no stride
// arithmetic: a division by N or S and two multiply-adds a node.
template <bool Load>
__device__ __forceinline__ void move_slabs(const Params& p, int t, float* g, float* sm,
                                           const long long* base, const int* count) {
  const int n = p.n;
  const int spad = p.spad;
  const int S = p.S;
  const long long ss = p.st[t][p.ndim - 1];
  const long long es = p.es[t];
  auto walk = [&](auto efast_tag, auto contig_tag) {
    constexpr bool kEfast = decltype(efast_tag)::value;
    constexpr bool kContig = decltype(contig_tag)::value;
    for (int s = 0; s < p.P; ++s) {
      const int cnt = count[s];
      if (cnt == 0) break;                 // slabs past the end come last
      float* gs = g + base[s];
      float* ms = sm + s * S;
      const int len = (kEfast ? cnt : S) * n;
      for (int j = threadIdx.x; j < len; j += kThreads) {
        int k, e;
        if constexpr (kEfast) {
          k = fdiv(j, p.n_div);
          e = j - k * n;
        } else {
          e = fdiv(j, p.s_div);
          k = j - e * S;
          if (k >= cnt) continue;
        }
        float* gp = kContig ? gs + j : gs + (k * ss + e * es);
        if constexpr (Load) {
          cp_async4(ms + e * spad + k, gp);
        } else {
          *gp = ms[e * spad + k];
        }
      }
    }
  };
  using T = std::true_type;
  using F = std::false_type;
  if (p.efast[t]) {
    if (p.contig[t]) walk(T{}, T{}); else walk(T{}, F{});
  } else {
    if (p.contig[t]) walk(F{}, T{}); else walk(F{}, F{});
  }
}

// One system of a block whose operands are staged (b in slot 0, d in 1,
// dl and du in 2 and 3 when DenseOff, else one value each a slab); p and
// x overwrite b, c overwrites d.
template <bool DenseOff>
__device__ __forceinline__ void solve_on_chip(float* xs, float* cs, const float* ls,
                                              const float* us, float l, float u, int n,
                                              int spad) {
  const float d0 = cs[0];
  if (n == 1) {
    xs[0] = xs[0] / d0;
    return;
  }
  float c = (DenseOff ? us[0] : u) / d0;
  float pv = xs[0] / d0;
  cs[0] = c;
  xs[0] = pv;
  int o = 0;
  for (int e = 1; e < n - 1; ++e) {
    o += spad;
    if (DenseOff) l = ls[o];
    const float den = cs[o] - l * c;       // reads d before c overwrites it
    pv = (xs[o] - l * pv) / den;
    xs[o] = pv;
    if (DenseOff) u = us[o];
    c = u / den;
    cs[o] = c;
  }
  o += spad;                               // e = n-1: du[N-1] is never read
  if (DenseOff) l = ls[o];
  const float den = cs[o] - l * c;
  pv = (xs[o] - l * pv) / den;
  xs[o] = pv;
  float xv = pv;
  for (int e = n - 2; e >= 0; --e) {
    o -= spad;
    xv = xs[o] - cs[o] * xv;
    xs[o] = xv;
  }
}

// One system read through its strides; p goes to x, c to the workspace.
__device__ __forceinline__ void solve_strided(const float* dl, const float* d, const float* du,
                                              const float* b, const long long* es, float* x,
                                              long long xes, float* cw, long long cstep,
                                              int n) {
  const float d0 = __ldg(d);
  if (n == 1) {
    x[0] = __ldg(b) / d0;
    return;
  }
  float c = __ldg(du) / d0;
  float pv = __ldg(b) / d0;
  cw[0] = c;
  x[0] = pv;
  for (int e = 1; e < n; ++e) {
    const float l = __ldg(dl + e * es[kDl]);
    const float den = __ldg(d + e * es[kD]) - l * c;
    pv = (__ldg(b + e * es[kB]) - l * pv) / den;
    x[e * xes] = pv;
    if (e < n - 1) {                        // du[N-1] is never read
      c = __ldg(du + e * es[kDu]) / den;
      cw[e * cstep] = c;
    }
  }
  float xv = pv;
  for (int e = n - 2; e >= 0; --e) {
    xv = x[e * xes] - cw[e * cstep] * xv;
    x[e * xes] = xv;
  }
}

template <bool OnChip, bool DenseOff>
__global__ void __launch_bounds__(kThreads)
tridiag_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  __shared__ long long base[kTensors][kMaxSlabs];
  __shared__ int count[kMaxSlabs];

  const int tid = threadIdx.x;
  const int inner = p.ndim - 1;
  // Each slab's offset into every tensor and its number of systems (the
  // inner axis's last tile is ragged; slabs past the end have none).
  if (tid < p.P) {
    const uint32_t q = blockIdx.x * static_cast<uint32_t>(p.P) + tid;
    long long off[kTensors] = {0, 0, 0, 0, 0};
    int cnt = 0;
    if (q < p.n_slabs) {
      int outer = fdiv(static_cast<int>(q), p.tiles_div);
      const uint32_t first = (q - outer * p.tiles) * static_cast<uint32_t>(p.S);
      cnt = min(static_cast<uint32_t>(p.S), p.size[inner] - first);
#pragma unroll
      for (int t = 0; t < kTensors; ++t) off[t] = first * p.st[t][inner];
      for (int a = inner - 1; a >= 0; --a) {
        const int next = fdiv(outer, p.axis_div[a]);
        const int ia = outer - next * static_cast<int>(p.size[a]);
        outer = next;
#pragma unroll
        for (int t = 0; t < kTensors; ++t) off[t] += ia * p.st[t][a];
      }
    }
    count[tid] = cnt;
#pragma unroll
    for (int t = 0; t < kTensors; ++t) base[t][tid] = off[t];
  }
  __syncthreads();

  const int n = p.n;
  const int slab = tid / p.S;
  const int k = tid - slab * p.S;
  const bool mine = slab < p.P && k < count[slab];

  if constexpr (OnChip) {
    const int slot_floats = n * p.spad;
    // Stage b and d (and dl, du when they vary over a slab), coalesced.
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!DenseOff && (t == kDl || t == kDu)) continue;
      float* dst = smem + (t == kB ? kSlotX : t == kD ? kSlotC : t == kDl ? kSlotDl : kSlotDu)
                          * slot_floats;
      move_slabs<true>(p, t, const_cast<float*>(p.in[t]), dst, base[t], count);
    }
    cp_async_wait_all();
    __syncthreads();
    if (mine) {
      const int o = tid;                   // slab * S + k
      float l = 0.f, u = 0.f;
      if (!DenseOff) {                     // one value each a slab
        l = __ldg(p.in[kDl] + base[kDl][slab]);
        u = __ldg(p.in[kDu] + base[kDu][slab]);
      }
      solve_on_chip<DenseOff>(smem + kSlotX * slot_floats + o, smem + kSlotC * slot_floats + o,
                              smem + kSlotDl * slot_floats + o, smem + kSlotDu * slot_floats + o,
                              l, u, n, p.spad);
    }
    __syncthreads();
    move_slabs<false>(p, kX, p.x, smem + kSlotX * slot_floats, base[kX], count);
  } else if (mine) {
    const float* op[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) op[t] = p.in[t] + base[t][slab] + k * p.st[t][inner];
    solve_strided(op[kDl], op[kD], op[kDu], op[kB], p.es,
                  p.x + base[kX][slab] + k * p.st[kX][inner], p.es[kX],
                  p.ws + static_cast<long long>(blockIdx.x) * kThreads + tid, p.ws_stride, n);
  }
}

}  // namespace

extern "C" {

int tridiag_threads() { return kThreads; }
int tridiag_max_axes() { return kMaxAxes; }
int tridiag_max_slabs() { return kMaxSlabs; }
int tridiag_static_smem_bytes() {
  return static_cast<int>(sizeof(long long) * kTensors * kMaxSlabs + sizeof(int) * kMaxSlabs);
}

// Solve the systems of one broadcast (..., n) shape on `stream` of CUDA
// device `device`; returns the CUDA error code of the launch (0 = success).
//
//   ptrs     dl, d, du, b, x (float32)
//   sizes    the ndim batch axes, innermost last, each < 2^31
//   strides  per tensor (in ptrs' order): ndim batch strides, then the
//            element stride, in elements
//   plan     S, P, spad, dense_off (dl and du staged; else one value each
//            a slab), efast and contig of dl, d, du, b, x, grid, dynamic
//            shared-memory bytes
//   ws       c workspace of n * grid * kThreads floats (on_chip == 0)
int tridiag_launch(const void* const* ptrs, const long long* sizes,
                   const long long* strides, int ndim, int n, const int* plan,
                   void* ws, int on_chip, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ndim < 1 || ndim > kMaxAxes || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  for (int t = 0; t < 4; ++t) p.in[t] = static_cast<const float*>(ptrs[t]);
  p.x = static_cast<float*>(const_cast<void*>(ptrs[kX]));
  p.ws = static_cast<float*>(ws);
  for (int t = 0; t < kTensors; ++t) {
    for (int a = 0; a < ndim; ++a) p.st[t][a] = strides[t * (ndim + 1) + a];
    p.es[t] = strides[t * (ndim + 1) + ndim];
  }
  uint64_t outer = 1;
  for (int a = 0; a < ndim; ++a) {
    p.size[a] = static_cast<uint32_t>(sizes[a]);
    p.axis_div[a] = make_fast_div(p.size[a]);
    if (a < ndim - 1) outer *= p.size[a];
  }
  p.ndim = ndim;
  p.n = n;
  p.S = plan[0];
  p.P = plan[1];
  p.spad = plan[2];
  const bool dense_off = plan[3] != 0;
  for (int t = 0; t < kTensors; ++t) {
    p.efast[t] = plan[4 + t];
    p.contig[t] = plan[9 + t];
  }
  const int grid = plan[14];
  const int smem_bytes = plan[15];
  if (p.S < 1 || p.P < 1 || p.P > kMaxSlabs || p.S * p.P > kThreads || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.tiles = (p.size[ndim - 1] + p.S - 1) / p.S;
  p.tiles_div = make_fast_div(p.tiles);
  p.n_slabs = static_cast<uint32_t>(outer * p.tiles);
  p.n_div = make_fast_div(static_cast<uint32_t>(n));
  p.s_div = make_fast_div(static_cast<uint32_t>(p.S));
  p.ws_stride = static_cast<long long>(grid) * kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!on_chip) {
    tridiag_kernel<false, true><<<grid, kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = dense_off ? tridiag_kernel<true, true> : tridiag_kernel<true, false>;
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem_bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
