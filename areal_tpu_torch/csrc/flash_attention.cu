// Packed varlen flash attention for Hopper (sm_90a): forward, and the two
// backward kernels (dq; dk and dv).
//
// Replaces the Pallas TPU kernels of areal_tpu/ops/pallas/flash_attention.py:
// `_flash_forward` (:419; bodies `_fwd_kernel_tri`, `_fwd_kernel`) and
// `_flash_backward` (:928; `_bwd_kernel_tri`, `_bwd_kernel`, `_dq_kernel`,
// `_dkv_kernel`). Causal self-attention over one packed token axis:
// q [T, H, D], k and v [T, Hkv, D] (the model's layout), int32 segment ids
// [T] with 0 for padding. A query attends a key iff both carry the same
// nonzero id, the key does not come later, and (with a window W) the key is
// less than W tokens back. GQA maps query head h to kv head h / (H / Hkv)
// without repeating K/V. An optional soft cap squashes the scaled scores
// (cap * tanh(s / cap)). The forward writes out (q's dtype) and the natural
// log-sum-exp lse [H, T] (f32); a padding row gets out 0 and lse -2.38e38,
// the reference's finite sentinel. The backward takes delta = rowsum(dO*O)
// [H, T] (computed by the caller, as the reference leaves it to XLA).
//
// Contract (as the reference's band kernels): real segment ids are
// non-decreasing along the axis and padding sits at the tail. The caller
// passes, per token, the first index of its segment (seg_start) and one
// past its last (seg_end); each block derives its own key or query range
// from them. The TPU kernels' triangle/band tables, scalar prefetch and
// interior-block specialisation exist because a TPU walks its grid in order
// with a large VMEM; here every block finds its range and runs alone.
//
// Bound. At the trainer's shape (T 8192, H 12, Hkv 2, D 128, eight
// segments of 512-1536 tokens and 384 pad) the mask keeps ~4.2M pairs: one
// forward does ~26 GFLOP of QK and PV work and moves ~55 MB, so it is bound
// by operations, 0.0262 ms at the card's 989 TFLOP/s bf16 peak; the
// backward's bound counts five products (S recomputed, dP, dV, dK, dQ),
// 0.0656 ms. The kernels below do seven: dq recomputes S and dP beside the
// dk/dv kernel's, so that dq needs no float atomics.
//
// Design, v4 (tensor cores: bf16 with D 64 or 128, the trainer's case).
// Each block is one producer warpgroup and two consumer warpgroups of 64
// rows (FA3's structure). One producer thread keeps TMA loads in flight
// through a ring of stages with full/empty mbarriers, so no consumer
// spends an instruction or a register on a copy; `setmaxnreg` hands the
// producer's registers to the consumers, whose accumulators need them
// (dk and dv at D 128 hold 128 f32 each). The products are wgmma on
// 128-byte-swizzled tiles straight from TMA; a score tile leaves the
// accumulators only as bf16 A fragments in registers (P for PV, dS for dS
// K, P^T and dS^T for dV and dK), and V, K, Q and dO serve as B operands
// of those products read MN-major through the transpose bit, so nothing
// is transposed or staged by hand. Masks are key ranges (each row sees
// keys [its segment or window start, itself]; each key is seen by queries
// [itself, its segment or window end)), two compares an element, and only
// the tiles that cross a segment start, the window edge or the diagonal
// are masked at all (the reference's _block_needs_mask); the exponentials
// are ex2.approx on log2-domain scores.
//  - forward and dq: items of (2 bq tokens, kv head). Rows fold
//    token-major (row r: token t0 + r / n_rep, head g n_rep + r % n_rep),
//    so a warpgroup's Q (and dO) tile is one TMA box [bq, n_rep, 64] of
//    [T, H, D] (bq = 64 / n_rep: 10 tokens at n_rep 6), both warpgroups
//    share each K/V tile of the group, and the output tile leaves through
//    the same box by a TMA store. Keys run in tiles of 64 from the item's
//    key start `lo` (TMA needs no alignment and zero-fills past T) to its
//    last real token; a warpgroup skips tiles outside its own range. One
//    persistent block per SM walks the items, last q tiles first (within a
//    segment those walk the most keys); the producer loads the next item's
//    Q into a second slot while the consumers finish the current one, so
//    a block's set-up and epilogue no longer stall it (v4.0, a block per
//    item, spent ~0.1 ms of its 0.25 there on an H100). Forward: online
//    softmax in f32,
//    P rounded to bf16 before PV as the reference; dq: P from lse,
//    dS = P (dP - delta).
//  - dk/dv: one block per (128 keys, kv head, part of the GQA group): keys
//    are the rows (64 per consumer), query tiles (64; 48 at D 128, so that
//    dk, dv and both score tiles fit the registers) stream per head of
//    the part from the block's first key to the segment (or window) end of
//    its last real key. v3 summed the whole group in one block, so the
//    block at a 1536-token segment's start walked 6 x 48 tiles in series
//    while the card had 256 blocks for 132 SMs; splitting the group into
//    `parts` (the wrapper's plan: the smallest divisor of n_rep that gives
//    two blocks per SM, 3 at the slice shape) cuts that path. Each part
//    writes an f32 partial into a workspace and the last block of a (key
//    tile, kv head) to arrive at its int32 counter (__threadfence, then
//    atomicAdd) sums the parts in part order and resets the counter: no
//    float atomics, bit-identical reruns. A thread-block cluster summing
//    through distributed shared memory would save the workspace's L2
//    round trip, but ties the parts to co-scheduled SMs; the counter keeps
//    the grid free and mirrors the paged-decode kernel's merge.
//  - delta = rowsum(dO O) is a small kernel of its own (8 lanes a row),
//    where v3's wrapper spent ~0.15 ms of PyTorch casts and reductions.
//  - TMA descriptors are encoded on the host per call with
//    cuTensorMapEncodeTiled, fetched from the driver the runtime already
//    loaded (cudaGetDriverEntryPoint), so the library links no -lcuda. A
//    1-D box must start 16-byte aligned: lse and delta tiles load from the
//    aligned index below and are read from the offset.
// v3, replaced here: 4 warps of mma.sync m16n8k16 over 64 folded
// rows, cp.async double buffering and ldmatrix, each warp re-reading the
// whole K/V tile; 0.431 ms forward, 1.804 ms backward at the slice shape
// on an H100 (16x and 28x the bounds).
//
// CUDA cores (f32, and bf16 with other head dims up to 256; not on the
// trainer's path): f32 FMAs on tiles staged in shared memory as f32, 256
// threads as a 16 x 16 grid, each thread owning a small register tile of
// scores and of the output. Forward: one block per (q tile, kv head) with
// the GQA group's rows folded into one tile; dq: one block per (64-token q
// tile, q head); dk/dv: one block per (k tile, kv head), summing over the
// group in registers. D up to 256 (D % 8 == 0); they halve their tiles
// above D 128 to stay within shared memory.

#include <cuda.h>  // CUtensorMap and its enums; the driver call is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid: tx = tid % 16, ty = tid / 16
// finite masking sentinel shared with the JAX reference
constexpr float kNegInf = -2.3819763e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxD = 256;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

enum DType { kF32 = 0, kBF16 = 1 };

struct Params {
  const void* q;         // [T, H, D]
  const void* k;         // [T, Hkv, D]
  const void* v;         // [T, Hkv, D]
  const int* seg;        // [T], 0 = padding
  const int* seg_start;  // [T] first index of the token's segment
  const int* seg_end;    // [T] one past its last index
  void* out;             // [T, H, D] (forward)
  float* lse;            // [H, T] (written by the forward, read by the backward)
  const void* dout;      // [T, H, D] (backward)
  const float* delta;    // [H, T] rowsum(dO * O) (backward)
  void* dq;              // [T, H, D]
  void* dk;              // [T, Hkv, D]
  void* dv;              // [T, Hkv, D]
  float* ws;             // v4 dk/dv: [parts][dk | dv][T][Hkv][D] f32 partials
  int* counters;         // v4 dk/dv: [key tiles * Hkv], 0 between launches
  int T, H, Hkv, D, n_rep;
  float scale;           // softmax scale
  float soft_cap;        // <= 0: none
  int window;            // <= 0: none
  int bq;                // forward: tokens per q tile (v4: per warpgroup)
  int parts;             // v4 dk/dv: blocks sharing one GQA group
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision: the reference's dots take T operands
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// max / sum over the 16 threads of a row group (tx = lane % 16)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage `rows` rows of D elements into shared memory as f32 with row
// stride ld. row_ptr(r) gives row r's source (16-byte aligned) or nullptr
// for a zero row. 16-byte loads along D.
template <typename T, typename RowPtr>
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows, int D,
                                          RowPtr row_ptr) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = D / kVec;
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr;
    const int c = (i - r * vpr) * kVec;
    float* d = dst + r * ld + c;
    const T* src = row_ptr(r);
    if (src != nullptr) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = to_f(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) d[j] = 0.f;
    }
  }
}

// key kt visible from query t of segment sq (sq > 0)
__device__ __forceinline__ bool visible(int t, int sq, int kt, int sk,
                                        int window) {
  return kt <= t && sk == sq && (window <= 0 || t - kt < window);
}

// scaled (and capped) score; tt returns tanh for the cap's derivative
__device__ __forceinline__ float score(float dot, const Params& p, float& tt) {
  float x = dot * p.scale;
  tt = 0.f;
  if (p.soft_cap > 0.f) {
    tt = tanhf(x / p.soft_cap);
    x = p.soft_cap * tt;
  }
  return x;
}

// Key range [lo, hi) of the query tokens [t0, t0 + n): from the earliest
// segment or window start of a real token to the last real token.
__device__ __forceinline__ void key_range(const Params& p, int t0, int n,
                                          int* s_lo, int* s_hi) {
  if (threadIdx.x == 0) {
    *s_lo = INT_MAX;
    *s_hi = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int t = t0 + i;
    if (p.seg[t] > 0) {
      int lo = p.seg_start[t];
      if (p.window > 0) lo = max(lo, t - p.window + 1);
      atomicMin(s_lo, lo);
      atomicMax(s_hi, t + 1);
    }
  }
  __syncthreads();
}

// --------------------------------------------------------------------------
// forward
// --------------------------------------------------------------------------

template <typename T, int RPT, int CPT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int R = 16 * RPT;  // folded rows: n_rep heads x bq tokens
  constexpr int BK = 64;
  constexpr int KPT = BK / 16;
  const int g = blockIdx.y;
  const int bq = p.bq;
  const int q0 = blockIdx.x * bq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D = p.D, ld = D + 1, nt = p.T, n_rep = p.n_rep;
  const int nq = min(bq, nt - q0);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  extern __shared__ float smem[];
  float* Qs = smem;             // [R][ld]
  float* Ks = Qs + R * ld;      // [BK][ld]
  float* Vs = Ks + BK * ld;     // [BK][ld]
  float* Ps = Vs + BK * ld;     // [R][BK + 1]
  int* kseg = reinterpret_cast<int*>(Ps + R * (BK + 1));  // [BK]
  __shared__ int s_lo, s_hi;

  key_range(p, q0, nq, &s_lo, &s_hi);
  // row r = rep * bq + i: token q0 + i of query head g * n_rep + rep
  load_tile<T>(Qs, ld, R, D, [&](int r) -> const T* {
    const int rep = r / bq, i = r - rep * bq;
    if (rep >= n_rep || i >= nq) return nullptr;
    return q + (size_t(q0 + i) * p.H + g * n_rep + rep) * D;
  });
  const int lo = s_lo, hi = s_hi;

  int row_t[RPT], row_seg[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    const int rep = r / bq, ii = r - rep * bq;
    const bool ok = rep < n_rep && ii < nq;
    row_t[i] = ok ? q0 + ii : -1;
    row_seg[i] = ok ? p.seg[q0 + ii] : 0;
  }
  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = lo; k0 < hi; k0 += BK) {
    const int n = min(BK, hi - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<T>(Ks, ld, BK, D, [&](int r) -> const T* {
      return r < n ? k + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
    });
    load_tile<T>(Vs, ld, BK, D, [&](int r) -> const T* {
      return r < n ? v + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
    });
    for (int j = threadIdx.x; j < BK; j += kThreads)
      kseg[j] = j < n ? p.seg[k0 + j] : -1;
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float qv = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(qv, kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int c = tx + 16 * j;
        float tt;
        const float x = score(s[i][j], p, tt) * kLog2e;
        const bool ok = row_seg[i] > 0 && c < n &&
                        visible(row_t[i], row_seg[i], k0 + c, kseg[c], p.window);
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        // masked entries are exactly the sentinel; they contribute 0
        const float pr = s[i][j] == kNegInf ? 0.f : exp2f(s[i][j] - m_new);
        sum += pr;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = round_to<T>(pr);
      }
      sum = group_sum(sum);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < D ? Vs[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pr = Ps[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pr, vv[c], acc[i][c]);
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = row_t[i];
    if (t < 0) continue;
    const int h = g * n_rep + (ty + 16 * i) / bq;
    const bool live = l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    T* orow = out + (size_t(t) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) orow[d] = from_f<T>(acc[i][c] * inv);
    }
    if (tx == 0)
      p.lse[size_t(h) * nt + t] = live ? m[i] * kLn2 + logf(l[i]) : kNegInf;
  }
}

// --------------------------------------------------------------------------
// backward: dq
// --------------------------------------------------------------------------

template <typename T, int CPT, int BK>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  constexpr int RPT = 4;
  constexpr int R = 16 * RPT;  // q tokens per block
  constexpr int KPT = BK / 16;
  const int h = blockIdx.y;
  const int g = h / p.n_rep;
  const int q0 = blockIdx.x * R;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D = p.D, ld = D + 1, nt = p.T;
  const int nq = min(R, nt - q0);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);

  extern __shared__ float smem[];
  float* Qs = smem;              // [R][ld]
  float* dOs = Qs + R * ld;      // [R][ld]
  float* Ks = dOs + R * ld;      // [BK][ld]
  float* Vs = Ks + BK * ld;      // [BK][ld]
  float* DSs = Vs + BK * ld;     // [R][BK + 1]
  int* kseg = reinterpret_cast<int*>(DSs + R * (BK + 1));  // [BK]
  __shared__ int s_lo, s_hi;

  key_range(p, q0, nq, &s_lo, &s_hi);
  load_tile<T>(Qs, ld, R, D, [&](int r) -> const T* {
    return r < nq ? q + (size_t(q0 + r) * p.H + h) * D : nullptr;
  });
  load_tile<T>(dOs, ld, R, D, [&](int r) -> const T* {
    return r < nq ? dout + (size_t(q0 + r) * p.H + h) * D : nullptr;
  });
  const int lo = s_lo, hi = s_hi;

  int row_t[RPT], row_seg[RPT];
  float row_lse2[RPT], row_delta[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i;
    const bool ok = r < nq;
    row_t[i] = ok ? q0 + r : -1;
    row_seg[i] = ok ? p.seg[q0 + r] : 0;
    // pad rows carry the sentinel; clamp its log2 form so it stays finite
    row_lse2[i] = ok ? fmaxf(p.lse[size_t(h) * nt + q0 + r] * kLog2e, kNegInf)
                     : 0.f;
    row_delta[i] = ok ? p.delta[size_t(h) * nt + q0 + r] : 0.f;
  }
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int k0 = lo; k0 < hi; k0 += BK) {
    const int n = min(BK, hi - k0);
    __syncthreads();
    load_tile<T>(Ks, ld, BK, D, [&](int r) -> const T* {
      return r < n ? k + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
    });
    load_tile<T>(Vs, ld, BK, D, [&](int r) -> const T* {
      return r < n ? v + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
    });
    for (int j = threadIdx.x; j < BK; j += kThreads)
      kseg[j] = j < n ? p.seg[k0 + j] : -1;
    __syncthreads();

    float s[RPT][KPT], dp[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    for (int d = 0; d < D; ++d) {
      float kv[KPT], vv[KPT];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        kv[j] = Ks[(tx + 16 * j) * ld + d];
        vv[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float qv = Qs[(ty + 16 * i) * ld + d];
        const float ov = dOs[(ty + 16 * i) * ld + d];
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = fmaf(qv, kv[j], s[i][j]);
          dp[i][j] = fmaf(ov, vv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int c = tx + 16 * j;
        float tt;
        const float x = score(s[i][j], p, tt) * kLog2e;
        const bool ok = row_seg[i] > 0 && c < n &&
                        visible(row_t[i], row_seg[i], k0 + c, kseg[c], p.window);
        const float pr = ok ? exp2f(x - row_lse2[i]) : 0.f;
        float ds = pr * (dp[i][j] - row_delta[i]);
        if (p.soft_cap > 0.f) ds *= 1.f - tt * tt;
        DSs[(ty + 16 * i) * (BK + 1) + c] = round_to<T>(ds);
      }
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      float kv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int d = tx + 16 * c;
        kv[c] = d < D ? Ks[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float ds = DSs[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = row_t[i];
    if (t < 0) continue;
    T* row = dq + (size_t(t) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) row[d] = from_f<T>(acc[i][c] * p.scale);
    }
  }
}

// --------------------------------------------------------------------------
// backward: dk, dv
// --------------------------------------------------------------------------

template <typename T, int CPT, int B>
__global__ void __launch_bounds__(kThreads) flash_dkdv_kernel(const Params p) {
  constexpr int KPT = B / 16;  // key rows and q columns per thread
  const int g = blockIdx.y;
  const int k0 = blockIdx.x * B;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D = p.D, ld = D + 1, nt = p.T, n_rep = p.n_rep;
  const int nk = min(B, nt - k0);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);

  extern __shared__ float smem[];
  float* Ks = smem;               // [B][ld]
  float* Vs = Ks + B * ld;        // [B][ld]
  float* Qs = Vs + B * ld;        // [B][ld]
  float* dOs = Qs + B * ld;       // [B][ld]
  float* Ps = dOs + B * ld;       // [B keys][B + 1]
  float* DSs = Ps + B * (B + 1);  // [B keys][B + 1]
  float* lse2_s = DSs + B * (B + 1);                     // [B]
  float* delta_s = lse2_s + B;                           // [B]
  int* qseg = reinterpret_cast<int*>(delta_s + B);       // [B]
  __shared__ int s_hi;

  // queries [k0, hi): causal from the tile's first key to the segment (or
  // window) end of its last real key
  if (threadIdx.x == 0) s_hi = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < nk; i += kThreads) {
    const int t = k0 + i;
    if (p.seg[t] > 0) {
      int end = p.seg_end[t];
      if (p.window > 0) end = min(end, t + p.window);
      atomicMax(&s_hi, end);
    }
  }
  load_tile<T>(Ks, ld, B, D, [&](int r) -> const T* {
    return r < nk ? k + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
  });
  load_tile<T>(Vs, ld, B, D, [&](int r) -> const T* {
    return r < nk ? v + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
  });
  __syncthreads();
  const int hi = s_hi;

  int key_t[KPT], key_seg[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int r = ty + 16 * i;
    key_t[i] = k0 + r;
    key_seg[i] = r < nk ? p.seg[k0 + r] : 0;
  }
  float dk[KPT][CPT], dv[KPT][CPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = g * n_rep + rep;
    for (int qq = k0; qq < hi; qq += B) {
      const int n = min(B, hi - qq);
      __syncthreads();
      load_tile<T>(Qs, ld, B, D, [&](int r) -> const T* {
        return r < n ? q + (size_t(qq + r) * p.H + h) * D : nullptr;
      });
      load_tile<T>(dOs, ld, B, D, [&](int r) -> const T* {
        return r < n ? dout + (size_t(qq + r) * p.H + h) * D : nullptr;
      });
      for (int j = threadIdx.x; j < B; j += kThreads) {
        const bool ok = j < n;
        qseg[j] = ok ? p.seg[qq + j] : 0;
        lse2_s[j] = ok ? fmaxf(p.lse[size_t(h) * nt + qq + j] * kLog2e, kNegInf)
                       : 0.f;
        delta_s[j] = ok ? p.delta[size_t(h) * nt + qq + j] : 0.f;
      }
      __syncthreads();

      float s[KPT][KPT], dp[KPT][KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = 0.f;
          dp[i][j] = 0.f;
        }
      for (int d = 0; d < D; ++d) {
        float qv[KPT], ov[KPT];
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          qv[j] = Qs[(tx + 16 * j) * ld + d];
          ov[j] = dOs[(tx + 16 * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const float kv = Ks[(ty + 16 * i) * ld + d];
          const float vv = Vs[(ty + 16 * i) * ld + d];
#pragma unroll
          for (int j = 0; j < KPT; ++j) {
            s[i][j] = fmaf(qv[j], kv, s[i][j]);
            dp[i][j] = fmaf(ov[j], vv, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int c = tx + 16 * j;  // q row within the tile
          float tt;
          const float x = score(s[i][j], p, tt) * kLog2e;
          const bool ok = key_seg[i] > 0 && c < n &&
                          visible(qq + c, qseg[c], key_t[i], key_seg[i], p.window);
          const float pr = ok ? exp2f(x - lse2_s[c]) : 0.f;
          float ds = pr * (dp[i][j] - delta_s[c]);
          if (p.soft_cap > 0.f) ds *= 1.f - tt * tt;
          Ps[(ty + 16 * i) * (B + 1) + c] = round_to<T>(pr);
          DSs[(ty + 16 * i) * (B + 1) + c] = round_to<T>(ds);
        }
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        float ov[CPT], qv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int d = tx + 16 * c;
          ov[c] = d < D ? dOs[j * ld + d] : 0.f;
          qv[c] = d < D ? Qs[j * ld + d] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          const float pr = Ps[(ty + 16 * i) * (B + 1) + j];
          const float ds = DSs[(ty + 16 * i) * (B + 1) + j];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            dv[i][c] = fmaf(pr, ov[c], dv[i][c]);
            dk[i][c] = fmaf(ds, qv[c], dk[i][c]);
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int r = ty + 16 * i;
    if (r >= nk) continue;
    const size_t base = (size_t(k0 + r) * p.Hkv + g) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        dk_out[base + d] = from_f<T>(dk[i][c] * p.scale);
        dv_out[base + d] = from_f<T>(dv[i][c]);
      }
    }
  }
}

// --------------------------------------------------------------------------
// v4: tensor-core kernels for Hopper (bf16, D 64 or 128)
// --------------------------------------------------------------------------
//
// Every block is three warpgroups: warpgroup 0 is the producer (one thread
// issues every TMA load; registers cut to kProducerRegs), warpgroups 1 and 2
// are consumers (kConsumerRegs registers) that run wgmma on 64 rows each.
// Tiles land in shared memory in TMA's 128-byte swizzle: a tile is a stack
// of 128-byte lines (64 bf16 of one row), and a D 128 row is two such tiles
// ("chunks"). The wgmma descriptors below read that layout: K-major (the
// product's depth runs along the line) for Q, K, V and dO as operands
// whose rows are the product's M or N, and MN-major (depth across lines,
// the transpose bit) for V, K, Q and dO as the B operand of PV, dS K,
// P^T dO and dS^T Q.
//
// Accumulator layout of wgmma m64nNk16 (f32), per thread with warp w of the
// warpgroup, gid = lane / 4 and tig = lane % 4: d[4j + e] is row
// 16w + gid + 8 (e / 2), column 8j + 2 tig + (e % 2). A 64 x 16 A operand
// from registers has the mma.sync m16n8k16 A layout per warp, so the
// accumulators of column tiles 2kk and 2kk + 1, packed to bf16, are the A
// operand of a product over those 16 columns (c_to_a).

using bf16 = __nv_bfloat16;
constexpr int kWg = 128;                  // threads per warpgroup
constexpr int kV4Threads = 3 * kWg;       // producer + two consumers
constexpr int kRows = 64;                 // rows per consumer (wgmma M)
constexpr int kChunk = 64;                // bf16 per 128-byte line
constexpr int kLine = 128;
// Register split between the producer warpgroup and the two consumers.
// setmaxnreg moves registers within the block's launch allocation (384
// threads x kLaunchRegs = 64512), so 128 P + 256 C must stay within it: a
// larger request waits forever. dk/dv, whose consumers hold dk and dv, takes
// 24 / 240; the forward and dq 40 / 232.
constexpr int kLaunchRegs = 65536 / kV4Threads / 8 * 8;  // 168 under the bounds
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kKvProducerRegs = 24, kKvConsumerRegs = 240;
static_assert(kWg * kProducerRegs + 2 * kWg * kConsumerRegs <= kV4Threads * kLaunchRegs &&
                  kWg * kKvProducerRegs + 2 * kWg * kKvConsumerRegs <=
                      kV4Threads * kLaunchRegs,
              "setmaxnreg beyond the launch allocation");
constexpr int kSms = 132;                 // H100 SXM

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the accumulators of column tiles 2kk, 2kk + 1 (s[8kk .. 8kk + 7]) as the
// A operand of a product over those 16 columns, rounded to bf16
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&s)[N], int kk) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA ------------------------------------------------------

// Barrier and TMA helpers take 32-bit shared-memory addresses (the
// producer's registers are few), with pointer forms for the consumers.
__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// one arrival that also announces `bytes` of TMA traffic on this phase
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  bar_expect_tx(smem_u32(bar), bytes);
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  bar_wait(smem_u32(bar), parity);
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1, int c2) {
  tma_3d(smem_u32(dst), map, smem_u32(bar), c0, c1, c2);
}

__device__ __forceinline__ void tma_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// A 1-D box must start 16-byte aligned in global memory: vectors of 32-bit
// values are loaded from the aligned index below the one wanted, kVecPad
// values longer, and read from vec_skip(i) on.
constexpr int kVecPad = 4;
__device__ __forceinline__ int vec_start(int i) { return i & ~(kVecPad - 1); }
__device__ __forceinline__ int vec_skip(int i) { return i & (kVecPad - 1); }

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// the two consumer warpgroups only
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWg) : "memory");
}

// --- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned atoms of 8 lines): SBO = 1024 bytes between 8-line
// groups; LBO = the distance between 64-element chunks along the lines
// (read by MN-major operands wider than one chunk; K-major ones ignore it).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// K-major operand: k-step kk (16 elements of depth) of a tile whose lines
// are its rows; depth past 64 is the next chunk, `chunk` bytes on
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int kk, uint32_t chunk) {
  return desc_sw128(base + (kk >> 2) * chunk + (kk & 3) * 32, 16);
}

// MN-major B operand: k-step kk (16 lines of depth) of chunk c
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int kk, int c, uint32_t chunk) {
  return desc_sw128(base + c * chunk + kk * 16 * kLine, chunk);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from touching accumulators across an async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] = A[64 x 16] * B[16 x 64], A and B in shared memory: the first
// k-step, which writes D without reading it (so D is dead between tiles)
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A and B in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 48] = / += A[64 x 16] * B[16 x 48], as the two above (the dk/dv
// kernel's query tiles at D 128)
__device__ __forceinline__ void wgmma_ss_first(float (&d)[24], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[24], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers, B in shared
// memory read MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// --- block set-up shared by the three kernels ---------------------------------

// The kernels' tensor maps (the ones a kernel does not read stay unset).
struct Maps {
  CUtensorMap q;      // [T, H, D] bf16, boxes {64, box heads, box tokens}
  CUtensorMap k;      // [T, Hkv, D]
  CUtensorMap v;
  CUtensorMap dout;   // as q
  CUtensorMap out;    // forward: out, dq: dq; as q
  CUtensorMap lse;    // [H * T] f32 (dk/dv)
  CUtensorMap delta;  // [H * T] f32 (dk/dv)
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// zero lines [rows, 64) of n consecutive 64-line tiles: the rows a Q or dO
// box leaves out when n_rep does not divide 64 (never stored; zero so that
// the products on them stay finite)
__device__ __forceinline__ void zero_tail(unsigned char* tiles, int n, int rows) {
  const int per = (kRows - rows) * kLine / 16;
  for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
    const int t = i / per, j = i - t * per;
    reinterpret_cast<uint4*>(tiles + t * kRows * kLine + rows * kLine)[j] =
        make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// [full x n_full] (one producer arrival), [empty x n_full] (every consumer
// thread), then n_once barriers of one arrival
__device__ __forceinline__ void init_barriers(uint64_t* bars, int n_full, int n_once) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_full; ++i) {
      bar_init(bars + i, 1);
      bar_init(bars + n_full + i, 2 * kWg);
    }
    for (int i = 0; i < n_once; ++i) bar_init(bars + 2 * n_full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Key range [lo, hi) of the real tokens among [t0, t0 + n): from the
// segment (or window) start of the first to one past the last; lo == hi
// when there is none. Padding sits at the tail, and a pad token's seg_start
// is the first pad index. (ops/cuda/flash_attention.py::q_range mirrors it.)
__device__ __forceinline__ void q_range(const Params& p, int t0, int n, int& lo,
                                        int& hi) {
  lo = hi = 0;
  if (t0 >= p.T || p.seg[t0] <= 0) return;
  const int tl = min(t0 + n, p.T) - 1;
  const int last = p.seg[tl] > 0 ? tl : p.seg_start[tl] - 1;
  lo = p.seg_start[t0];
  if (p.window > 0) lo = max(lo, t0 - p.window + 1);
  hi = last + 1;
}

// One past the last query that sees a real key among [k0, k0 + n): the
// segment (or window) end of the last real key; 0 when there is none.
// (ops/cuda/flash_attention.py::k_range mirrors it.)
__device__ __forceinline__ int k_range(const Params& p, int k0, int n) {
  if (k0 >= p.T || p.seg[k0] <= 0) return 0;
  const int tl = min(k0 + n, p.T) - 1;
  const int last = p.seg[tl] > 0 ? tl : p.seg_start[tl] - 1;
  int hi = p.seg_end[last];
  if (p.window > 0) hi = min(hi, last + p.window);
  return hi;
}

// --- forward and dq: persistent blocks over (2 bq tokens, kv head) items ------
//
// Rows are folded token-major: row r of a consumer is token t0 + r / n_rep
// of query head g n_rep + r % n_rep, so its Q (and dO) tile is one TMA box
// [bq tokens][n_rep heads][64] of the [T, H, D] tensor, and so is its
// output tile, which leaves through the same box by a TMA store. One block
// per SM walks the items blockIdx.x, + gridDim.x, ...; items run last q
// tiles first (within a segment those walk the most keys). The producer
// streams K and V from each item's key start `lo` in tiles of BK keys (no
// alignment: TMA zero-fills past T) through a ring of STAGES that runs on
// across items, and loads the next item's Q (and dO) into the other of two
// slots while the consumers finish the current one, so an item's start and
// its epilogue overlap its neighbours' work.

template <int D, int BK, int STAGES, bool kBwd>
struct QSide {
  static constexpr int DC = D / kChunk;
  static constexpr int kQTile = kRows * kLine;                  // one chunk, 64 rows
  static constexpr int kRowSet = (kBwd ? 2 : 1) * DC * kQTile;  // a consumer's Q (| dO)
  static constexpr int kQ = 0;                                  // [slot][consumer]
  static constexpr int kKV = kQ + 4 * kRowSet;
  static constexpr int kKVTile = BK * kLine;                    // one chunk of K or V
  static constexpr int kStage = 2 * DC * kKVTile;               // [K | V][DC]
  static constexpr int kBar = kKV + STAGES * kStage;
  // full[STAGES], empty[STAGES], qfull[slot][consumer], qempty[slot][consumer]
  static constexpr int kBytes = kBar + (2 * STAGES + 8) * 8 + 1024;  // + alignment
};

// the item's tokens and kv head; rows of consumer w start at q0 + w bq
__device__ __forceinline__ void q_item(const Params& p, int idx, int& g, int& q0) {
  const int n_blk = (p.T + 2 * p.bq - 1) / (2 * p.bq);
  g = idx % p.Hkv;
  q0 = (n_blk - 1 - idx / p.Hkv) * 2 * p.bq;
}

// key ranges of both consumers' tokens, and the block's [lo, hi)
__device__ __forceinline__ void q_item_keys(const Params& p, int q0, int (&wlo)[2],
                                            int (&whi)[2], int& lo, int& hi) {
  q_range(p, q0, p.bq, wlo[0], whi[0]);
  q_range(p, q0 + p.bq, p.bq, wlo[1], whi[1]);
  lo = hi = 0;
  if (wlo[0] < whi[0] || wlo[1] < whi[1]) {
    lo = wlo[0] < whi[0] ? wlo[0] : wlo[1];
    if (wlo[1] < whi[1]) lo = min(lo, wlo[1]);
    hi = max(whi[0], whi[1]);
  }
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the stores issued so far have read their shared memory
__device__ __forceinline__ void tma_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// one consumer warpgroup (named barriers 2 and 3)
__device__ __forceinline__ void consumer_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + wg), "n"(kWg) : "memory");
}

// (lo, hi) as bf16 into row r, columns col and col + 1 (col even) of a
// 64-line tile in TMA's 128-byte swizzle (16-byte granule index XOR row % 8)
__device__ __forceinline__ void st_swizzled(unsigned char* tile, int r, int col, float lo,
                                            float hi) {
  const int off = r * kLine + ((((col >> 3) ^ (r & 7)) << 4) | ((col & 7) << 1));
  *reinterpret_cast<uint32_t*>(tile + off) = pack_bf16(lo, hi);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int BK, int STAGES, bool kBwd>
__device__ __forceinline__ void q_side(const Maps& maps, const Params& p) {
  using L = QSide<D, BK, STAGES, kBwd>;
  constexpr int DC = L::DC;
  constexpr int NT = BK / 8;  // score column tiles
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;  // [slot * 2 + consumer]
  uint64_t* qempty = qfull + 4;
  const int T = p.T, n_rep = p.n_rep, bq = p.bq;
  const int n_items = (T + 2 * bq - 1) / (2 * bq) * p.Hkv;

  init_barriers(full, STAGES, 8);
  // rows no Q box covers stay zero (n_rep not dividing 64; never stored)
  zero_tail(smem + L::kQ, 4 * L::kRowSet / L::kQTile, bq * n_rep);
  __syncthreads();

  if (threadIdx.x < kWg) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      const uint32_t qbytes = (kBwd ? 2 : 1) * DC * kChunk * n_rep * bq * 2;
      int it = 0;
      int n = 0;
      for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++n) {
        int g, q0, wlo[2], whi[2], lo, hi;
        q_item(p, idx, g, q0);
        q_item_keys(p, q0, wlo, whi, lo, hi);
        const int slot = n & 1;
        const uint32_t use = n >> 1;
        for (int w = 0; w < 2; ++w) {
          uint64_t* qf = qfull + slot * 2 + w;
          bar_wait(qempty + slot * 2 + w, (use & 1) ^ 1);
          bar_expect_tx(qf, qbytes);
          unsigned char* rs = smem + L::kQ + (slot * 2 + w) * L::kRowSet;
          for (int c = 0; c < DC; ++c) {
            tma_3d(rs + c * L::kQTile, &maps.q, qf, c * kChunk, g * n_rep, q0 + w * bq);
            if (kBwd)
              tma_3d(rs + (DC + c) * L::kQTile, &maps.dout, qf, c * kChunk, g * n_rep,
                     q0 + w * bq);
          }
        }
        const int n_tiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % STAGES;
          const int k0 = lo + t * BK;
          bar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          bar_expect_tx(&full[s], 2 * DC * L::kKVTile);
          unsigned char* st = smem + L::kKV + s * L::kStage;
          for (int c = 0; c < DC; ++c) {
            tma_3d(st + c * L::kKVTile, &maps.k, &full[s], c * kChunk, g, k0);
            tma_3d(st + (DC + c) * L::kKVTile, &maps.v, &full[s], c * kChunk, g, k0);
          }
        }
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / kWg - 1;
  const int tid = threadIdx.x % kWg;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const float scale_log2 = p.scale * kLog2e;
  const bool cap = p.soft_cap > 0.f;
  const float cap_log2 = p.soft_cap * kLog2e, cap_in = p.scale / p.soft_cap;
  int it = 0;
  int n = 0;
  for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++n) {
    int g, q0, wlo[2], whi[2], lo, hi;
    q_item(p, idx, g, q0);
    q_item_keys(p, q0, wlo, whi, lo, hi);
    const int n_tiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;
    const int t0 = q0 + wg * bq;
    const int my_lo = wlo[wg], my_hi = whi[wg];
    const int slot = n & 1;
    unsigned char* rs = smem + L::kQ + (slot * 2 + wg) * L::kRowSet;
    const uint32_t q_base = smem_u32(rs);
    const uint32_t o_base = q_base + DC * L::kQTile;
    // every row a real token of one segment: tiles inside it and the
    // window, and wholly before the diagonal, need no mask
    const int t_last = min(t0 + bq, T) - 1;
    const bool one_seg =
        t0 < T && p.seg[t0] > 0 && p.seg_start[t_last] == p.seg_start[t0];
    const int seg0 = one_seg ? p.seg_start[t0] : 0;
    // row i sees keys [row_lo, row_t] (none for padding)
    int row_t[2], row_h[2], row_lo[2];
    bool row_ok[2];
    float row_lse2[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + gid + 8 * i;
      row_t[i] = t0 + r / n_rep;
      row_h[i] = g * n_rep + r % n_rep;
      row_ok[i] = r < bq * n_rep && row_t[i] < T;
      row_lo[i] = INT_MAX;
      if (row_ok[i] && p.seg[row_t[i]] > 0) {
        row_lo[i] = p.seg_start[row_t[i]];
        if (p.window > 0) row_lo[i] = max(row_lo[i], row_t[i] - p.window + 1);
      }
      if (kBwd && row_ok[i]) {
        // pad rows carry the sentinel; clamp its log2 form so it stays finite
        row_lse2[i] =
            fmaxf(p.lse[size_t(row_h[i]) * T + row_t[i]] * kLog2e, kNegInf);
        row_delta[i] = p.delta[size_t(row_h[i]) * T + row_t[i]];
      }
    }

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[DC][32];
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    float sc[BK / 2], dp[BK / 2];  // each tile's first k-step writes them
    bar_wait(qfull + slot * 2 + wg, (n >> 1) & 1);

    for (int t = 0; t < n_tiles; ++t, ++it) {
      const int s = it % STAGES;
      const int k0 = lo + t * BK;
      bar_wait(&full[s], (it / STAGES) & 1);
      if (k0 < my_hi && k0 + BK > my_lo) {
        const uint32_t k_base = smem_u32(smem + L::kKV + s * L::kStage);
        const uint32_t v_base = k_base + DC * L::kKVTile;
        wgmma_fence();
        wgmma_ss_first(sc, desc_k(q_base, 0, L::kQTile), desc_k(k_base, 0, L::kKVTile));
#pragma unroll
        for (int kk = 1; kk < D / 16; ++kk)
          wgmma_ss(sc, desc_k(q_base, kk, L::kQTile), desc_k(k_base, kk, L::kKVTile));
        if (kBwd) {
          wgmma_ss_first(dp, desc_k(o_base, 0, L::kQTile), desc_k(v_base, 0, L::kKVTile));
#pragma unroll
          for (int kk = 1; kk < D / 16; ++kk)
            wgmma_ss(dp, desc_k(o_base, kk, L::kQTile), desc_k(v_base, kk, L::kKVTile));
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);
        if (kBwd) fence_regs(dp);

        const bool unmasked = one_seg && k0 >= seg0 && k0 + BK - 1 <= t0 &&
                              (p.window <= 0 || t_last - k0 < p.window);
        float mx[2] = {kNegInf, kNegInf};
        // scores in the log2 domain, masked to the sentinel (forward) or P
        // and dS (dq), with the mask and the cap resolved outside the loop
        auto scores = [&](auto masked, auto capped) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;
              const int kt = k0 + 8 * j + 2 * tig + (e & 1);
              float x, tt = 0.f;
              if (decltype(capped)::value) {
                tt = tanhf(sc[4 * j + e] * cap_in);
                x = cap_log2 * tt;
              } else {
                x = sc[4 * j + e] * scale_log2;
              }
              const bool ok = !decltype(masked)::value ||
                              (kt >= row_lo[i] && kt <= row_t[i]);
              if (kBwd) {
                const float pr = ok ? ex2(x - row_lse2[i]) : 0.f;
                float ds = pr * (dp[4 * j + e] - row_delta[i]);
                if (decltype(capped)::value) ds *= 1.f - tt * tt;
                sc[4 * j + e] = ds;
              } else {
                x = ok ? x : kNegInf;
                sc[4 * j + e] = x;
                mx[i] = fmaxf(mx[i], x);
              }
            }
          }
        };
        if (cap) {
          if (unmasked) scores(std::false_type{}, std::true_type{});
          else scores(std::true_type{}, std::true_type{});
        } else {
          if (unmasked) scores(std::false_type{}, std::false_type{});
          else scores(std::true_type{}, std::false_type{});
        }
        if (!kBwd) {
          float corr[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float m_new = fmaxf(m[i], quad_max(mx[i]));
            corr[i] = ex2(m[i] - m_new);
            m[i] = m_new;
          }
          float sum[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;
              // masked entries are exactly the sentinel; they contribute 0
              const float pr = unmasked || sc[4 * j + e] != kNegInf
                                   ? ex2(sc[4 * j + e] - m[i])
                                   : 0.f;
              sum[i] += pr;
              sc[4 * j + e] = pr;
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
          for (int c = 0; c < DC; ++c)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc[c][4 * j + 0] *= corr[0];
              acc[c][4 * j + 1] *= corr[0];
              acc[c][4 * j + 2] *= corr[1];
              acc[c][4 * j + 3] *= corr[1];
            }
        }
        // P V (forward) or dS K (dq): P / dS rounded to bf16 in registers,
        // V or K read MN-major
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) c_to_a(pa[kk], sc, kk);
        const uint32_t b_base = kBwd ? k_base : v_base;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            wgmma_rs(acc[c], pa[kk], desc_mn(b_base, kk, c, L::kKVTile));
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int c = 0; c < DC; ++c) fence_regs(acc[c]);
      }
      bar_arrive(&empty[s]);
    }

    // epilogue: the tile (bf16) into this consumer's Q slot, which its
    // products no longer read, then out to global by the Q box's TMA store
    // (rows past T are clipped; pad rows hold exactly 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mul = p.scale;
      if (!kBwd) {
        const bool live = l[i] > 0.f;
        mul = live ? 1.f / l[i] : 0.f;
        if (row_ok[i] && tig == 0)
          p.lse[size_t(row_h[i]) * T + row_t[i]] =
              live ? m[i] * kLn2 + logf(l[i]) : kNegInf;
      }
      const int r = warp * 16 + gid + 8 * i;
      if (r >= bq * n_rep) continue;  // keep the zero tail
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          st_swizzled(rs + c * L::kQTile, r, 8 * j + 2 * tig, acc[c][4 * j + 2 * i] * mul,
                      acc[c][4 * j + 2 * i + 1] * mul);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync(wg);
    if (tid == 0) {
      for (int c = 0; c < DC; ++c)
        tma_store_3d(&maps.out, rs + c * L::kQTile, c * kChunk, g * n_rep, t0);
      tma_store_read_wait();
      bar_arrive(qempty + slot * 2 + wg);  // the slot is free for item n + 2
    }
  }
  if (tid == 0) tma_store_wait();
}

template <int D, int BK, int STAGES>
__global__ void __launch_bounds__(kV4Threads, 1)
    flash_fwd_v4_kernel(const __grid_constant__ Maps maps, const Params p) {
  q_side<D, BK, STAGES, false>(maps, p);
}

template <int D, int BK, int STAGES>
__global__ void __launch_bounds__(kV4Threads, 1)
    flash_dq_v4_kernel(const __grid_constant__ Maps maps, const Params p) {
  q_side<D, BK, STAGES, true>(maps, p);
}

// --- dk, dv: one block per (128 keys, kv head, part of the GQA group) ---------
//
// Keys are the rows: consumer w owns keys k0 + 64 w .. + 63 and computes
// S^T = K Q^T and dP^T = V dO^T against query tiles of BQ, which the
// producer streams for each head of the block's part of the group, from
// the block's first key to the segment (or window) end of its last real
// key. P^T and dS^T stay in registers as the A operands of dV += P^T dO and
// dK += dS^T Q (dO and Q read MN-major). With parts > 1 each block writes
// its f32 partial into the workspace and the last block of a (key tile, kv
// head) to arrive at its counter sums the parts in part order: no float
// atomics, and reruns are bit-identical.

template <int D, int BQ, int STAGES>
struct KSide {
  static constexpr int DC = D / kChunk;
  static constexpr int kKTile = 2 * kRows * kLine;        // one chunk, 128 keys
  static constexpr int kK = 0;                            // [DC] tiles
  static constexpr int kV = kK + DC * kKTile;
  static constexpr int kQO = kV + DC * kKTile;
  static constexpr int kQTile = BQ * kLine;               // one chunk of Q or dO
  static constexpr int kStage = 2 * DC * kQTile;          // [Q | dO][DC]
  static constexpr int kVec = kQO + STAGES * kStage;      // [STAGES][lse | delta]
  static constexpr int kVecBytes = (BQ + kVecPad) * 4 + 128 - (BQ + kVecPad) * 4 % 128;
  static constexpr int kBar = kVec + STAGES * 2 * kVecBytes;
  static constexpr int kFlag = kBar + (2 * STAGES + 1) * 8;
  static constexpr int kBytes = kFlag + 16 + 1024;
};

template <int D, int BQ, int STAGES>
__global__ void __launch_bounds__(kV4Threads, 1)
    flash_dkdv_v4_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = KSide<D, BQ, STAGES>;
  constexpr int DC = L::DC;
  constexpr int NT = BQ / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;
  int* s_last = reinterpret_cast<int*>(smem + L::kFlag);
  const int T = p.T, parts = p.parts, hp = p.n_rep / parts;
  const int part = blockIdx.x % parts;
  const int g = (blockIdx.x / parts) % p.Hkv;
  const int kb = blockIdx.x / (parts * p.Hkv);
  const int k0 = kb * 2 * kRows;
  const int hi = max(k_range(p, k0, kRows), k_range(p, k0 + kRows, kRows));
  const int n_qt = hi > k0 ? (hi - k0 + BQ - 1) / BQ : 0;
  const int n_it = hp * n_qt;

  init_barriers(full, STAGES, 1);
  __syncthreads();

  if (threadIdx.x < kWg) {  // producer
    setmaxnreg_dec<kKvProducerRegs>();
    if (threadIdx.x == 0) {
      const uint32_t base = smem_u32(smem);
      const uint32_t kv = smem_u32(kvbar);
      bar_expect_tx(kv, 2 * DC * L::kKTile);
      for (int c = 0; c < DC; ++c) {
        tma_3d(base + L::kK + c * L::kKTile, &maps.k, kv, c * kChunk, g, k0);
        tma_3d(base + L::kV + c * L::kKTile, &maps.v, kv, c * kChunk, g, k0);
      }
      const int h0 = g * p.n_rep + part * hp;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        const int h = h0 + it / n_qt;
        const int qq = k0 + (it % n_qt) * BQ;
        const uint32_t fb = base + L::kBar + s * 8;  // full[s]
        bar_wait(fb + STAGES * 8, ((it / STAGES) & 1) ^ 1);
        bar_expect_tx(fb, 2 * DC * L::kQTile + 2 * (BQ + kVecPad) * 4);
        const uint32_t st = base + L::kQO + s * L::kStage;
        for (int c = 0; c < DC; ++c) {
          tma_3d(st + c * L::kQTile, &maps.q, fb, c * kChunk, h, qq);
          tma_3d(st + (DC + c) * L::kQTile, &maps.dout, fb, c * kChunk, h, qq);
        }
        const uint32_t vec = base + L::kVec + s * 2 * L::kVecBytes;
        tma_1d(vec, &maps.lse, fb, vec_start(h * T + qq));
        tma_1d(vec + L::kVecBytes, &maps.delta, fb, vec_start(h * T + qq));
      }
    }
    return;
  }

  // consumers
  setmaxnreg_inc<kKvConsumerRegs>();
  const int wg = threadIdx.x / kWg - 1;
  const int tid = threadIdx.x % kWg;
  const int ctid = threadIdx.x - kWg;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int kw0 = k0 + wg * kRows;
  const int my_hi = k_range(p, kw0, kRows);
  // all 64 keys real and of one segment: query tiles inside it and the
  // window, and wholly after the diagonal, need no mask
  const bool one_seg = kw0 + kRows <= T && p.seg[kw0] > 0 &&
                       p.seg_start[kw0 + kRows - 1] == p.seg_start[kw0];
  const int seg_end0 = one_seg ? p.seg_end[kw0] : 0;
  // key i is seen by queries [key_t, key_hi) (none for padding)
  int key_t[2], key_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key_t[i] = kw0 + warp * 16 + gid + 8 * i;
    key_hi[i] = key_t[i];
    if (key_t[i] < T && p.seg[key_t[i]] > 0) {
      key_hi[i] = p.seg_end[key_t[i]];
      if (p.window > 0) key_hi[i] = min(key_hi[i], key_t[i] + p.window);
    }
  }
  const float scale_log2 = p.scale * kLog2e;
  const bool cap = p.soft_cap > 0.f;
  const float cap_log2 = p.soft_cap * kLog2e, cap_in = p.scale / p.soft_cap;
  const uint32_t k_base = smem_u32(smem + L::kK) + wg * kRows * kLine;
  const uint32_t v_base = smem_u32(smem + L::kV) + wg * kRows * kLine;
  bar_wait(kvbar, 0);

  float dk[DC][32], dv[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[c][e] = dv[c][e] = 0.f;
  float st[BQ / 2], dpt[BQ / 2];  // each tile's first k-step writes them

  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES;
    const int qq = k0 + (it % n_qt) * BQ;
    bar_wait(&full[s], (it / STAGES) & 1);
    if (qq < my_hi && qq + BQ > kw0) {
      const uint32_t q_base = smem_u32(smem + L::kQO + s * L::kStage);
      const uint32_t o_base = q_base + DC * L::kQTile;
      // recompute the K and V descriptors each tile: hoisted out of the
      // loop they would hold 32 registers beside dk and dv
      uint32_t kb = k_base, vb = v_base;
      asm volatile("" : "+r"(kb), "+r"(vb));
      const unsigned char* vec = smem + L::kVec + s * 2 * L::kVecBytes;
      const int hq = g * p.n_rep + part * hp + it / n_qt;
      const float* ls = reinterpret_cast<const float*>(vec) + vec_skip(hq * T + qq);
      const float* dl = reinterpret_cast<const float*>(vec + L::kVecBytes) +
                        vec_skip(hq * T + qq);
      wgmma_fence();
      wgmma_ss_first(st, desc_k(kb, 0, L::kKTile), desc_k(q_base, 0, L::kQTile));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss(st, desc_k(kb, kk, L::kKTile), desc_k(q_base, kk, L::kQTile));
      wgmma_ss_first(dpt, desc_k(vb, 0, L::kKTile), desc_k(o_base, 0, L::kQTile));
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk)
        wgmma_ss(dpt, desc_k(vb, kk, L::kKTile), desc_k(o_base, kk, L::kQTile));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(st);
      fence_regs(dpt);

      const bool unmasked = one_seg && qq >= kw0 + kRows - 1 && qq + BQ <= seg_end0 &&
                            (p.window <= 0 || qq + BQ - 1 - kw0 < p.window);
      // P^T and dS^T, with the mask and the cap resolved outside the loop
      auto scores = [&](auto masked, auto capped) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const int c = 8 * j + 2 * tig + (e & 1);  // query within the tile
            float x, tt = 0.f;
            if (decltype(capped)::value) {
              tt = tanhf(st[4 * j + e] * cap_in);
              x = cap_log2 * tt;
            } else {
              x = st[4 * j + e] * scale_log2;
            }
            const bool ok = !decltype(masked)::value ||
                            (qq + c >= key_t[i] && qq + c < key_hi[i]);
            // pad queries carry the sentinel; clamp its log2 form so it
            // stays finite
            const float pr = ok ? ex2(x - fmaxf(ls[c] * kLog2e, kNegInf)) : 0.f;
            float ds = pr * (dpt[4 * j + e] - dl[c]);
            if (decltype(capped)::value) ds *= 1.f - tt * tt;
            st[4 * j + e] = pr;
            dpt[4 * j + e] = ds;
          }
          // read each column's lse and delta where it is used, not all up
          // front (that would hold 32 more registers beside dk and dv)
          asm volatile("" ::: "memory");
        }
      };
      if (cap) {
        if (unmasked) scores(std::false_type{}, std::true_type{});
        else scores(std::true_type{}, std::true_type{});
      } else {
        if (unmasked) scores(std::false_type{}, std::false_type{});
        else scores(std::true_type{}, std::false_type{});
      }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        c_to_a(pa[kk], st, kk);
        c_to_a(da[kk], dpt, kk);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          wgmma_rs(dv[c], pa[kk], desc_mn(o_base, kk, c, L::kQTile));
          wgmma_rs(dk[c], da[kk], desc_mn(q_base, kk, c, L::kQTile));
        }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        fence_regs(dk[c]);
        fence_regs(dv[c]);
      }
    }
    bar_arrive(&empty[s]);
  }

  const size_t plane = size_t(T) * p.Hkv * D;
  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);
  if (parts == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key_t[i] >= T) continue;
      const size_t base = (size_t(key_t[i]) * p.Hkv + g) * D + 2 * tig;
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = c * kChunk + 8 * j;
          *reinterpret_cast<__nv_bfloat162*>(dk_out + base + d) = __floats2bfloat162_rn(
              dk[c][4 * j + 2 * i] * p.scale, dk[c][4 * j + 2 * i + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(dv_out + base + d) =
              __floats2bfloat162_rn(dv[c][4 * j + 2 * i], dv[c][4 * j + 2 * i + 1]);
        }
    }
    return;
  }
  // this part's f32 partial, [part][dk | dv][T][Hkv][D]
  float* wk = p.ws + size_t(part) * 2 * plane;
  float* wv = wk + plane;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key_t[i] >= T) continue;
    const size_t base = (size_t(key_t[i]) * p.Hkv + g) * D + 2 * tig;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = c * kChunk + 8 * j;
        *reinterpret_cast<float2*>(wk + base + d) =
            make_float2(dk[c][4 * j + 2 * i], dk[c][4 * j + 2 * i + 1]);
        *reinterpret_cast<float2*>(wv + base + d) =
            make_float2(dv[c][4 * j + 2 * i], dv[c][4 * j + 2 * i + 1]);
      }
  }
  __threadfence();
  consumers_sync();
  int* counter = p.counters + kb * p.Hkv + g;
  if (ctid == 0) *s_last = atomicAdd(counter, 1) == parts - 1;
  consumers_sync();
  if (!*s_last) return;
  __threadfence();
  // the last block sums the parts in part order
  constexpr int kVecs = D / 4;
  for (int idx = ctid; idx < 2 * kRows * kVecs; idx += 2 * kWg) {
    const int key = k0 + idx / kVecs;
    if (key >= T) continue;
    const size_t off = (size_t(key) * p.Hkv + g) * D + (idx % kVecs) * 4;
    float4 sk = __ldcg(reinterpret_cast<const float4*>(p.ws + off));
    float4 sv = __ldcg(reinterpret_cast<const float4*>(p.ws + plane + off));
    for (int q = 1; q < parts; ++q) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(p.ws + q * 2 * plane + off));
      const float4 b =
          __ldcg(reinterpret_cast<const float4*>(p.ws + q * 2 * plane + plane + off));
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += b.x; sv.y += b.y; sv.z += b.z; sv.w += b.w;
    }
    __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(dk_out + off);
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(dv_out + off);
    ok[0] = __floats2bfloat162_rn(sk.x * p.scale, sk.y * p.scale);
    ok[1] = __floats2bfloat162_rn(sk.z * p.scale, sk.w * p.scale);
    ov[0] = __floats2bfloat162_rn(sv.x, sv.y);
    ov[1] = __floats2bfloat162_rn(sv.z, sv.w);
  }
  if (ctid == 0) *counter = 0;
}

// --------------------------------------------------------------------------
// backward preprocessing: delta = rowsum(dO * O)
// --------------------------------------------------------------------------

// delta[h, t] = sum over d of dO[t, h, d] O[t, h, d] in f32 (the reference
// leaves it to XLA): 8 lanes per (t, h) row, 16-byte loads, 32 rows per block
template <typename T>
__global__ void __launch_bounds__(256)
    flash_delta_kernel(const T* dout, const T* out, float* delta, int nt, int H,
                       int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int row = blockIdx.x * 32 + threadIdx.x / 8;  // t * H + h
  const int lane = threadIdx.x % 8;
  float sum = 0.f;
  if (row < nt * H) {
    const T* a = dout + size_t(row) * D;
    const T* b = out + size_t(row) * D;
    for (int c = lane * kVec; c < D; c += 8 * kVec) {
      const uint4 ra = *reinterpret_cast<const uint4*>(a + c);
      const uint4 rb = *reinterpret_cast<const uint4*>(b + c);
      const T* ea = reinterpret_cast<const T*>(&ra);
      const T* eb = reinterpret_cast<const T*>(&rb);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sum = fmaf(to_f(ea[j]), to_f(eb[j]), sum);
    }
  }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0 && row < nt * H) delta[size_t(row % H) * nt + row / H] = sum;
}

// --------------------------------------------------------------------------
// launches
// --------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <typename T, int CPT>
cudaError_t launch_fwd(Params p, cudaStream_t stream) {
  constexpr int RPT = CPT == 16 ? 4 : 8;
  constexpr int R = 16 * RPT, BK = 64;
  if (p.n_rep > R) return cudaErrorInvalidValue;
  p.bq = R / p.n_rep;
  const size_t ld = p.D + 1;
  const size_t bytes = (R * ld + 2 * BK * ld + R * (BK + 1)) * 4 + BK * 4;
  auto kernel = flash_fwd_kernel<T, RPT, CPT>;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + p.bq - 1) / p.bq, p.Hkv);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int CPT>
cudaError_t launch_bwd(Params p, cudaStream_t stream) {
  constexpr int B = CPT == 16 ? 32 : 64;  // dq key tile; dk/dv key and q tiles
  constexpr int R = 64;                    // dq q tile
  const size_t ld = p.D + 1;
  const size_t dq_bytes = (2 * R * ld + 2 * B * ld + R * (B + 1)) * 4 + B * 4;
  auto dq_kernel = flash_dq_kernel<T, CPT, B>;
  cudaError_t err = set_smem(dq_kernel, dq_bytes);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3((p.T + R - 1) / R, p.H), kThreads, dq_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t kv_bytes = (4 * B * ld + 2 * B * (B + 1) + 2 * B) * 4 + B * 4;
  auto kv_kernel = flash_dkdv_kernel<T, CPT, B>;
  err = set_smem(kv_kernel, kv_bytes);
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3((p.T + B - 1) / B, p.Hkv), kThreads, kv_bytes, stream>>>(p);
  return cudaGetLastError();
}

// --- v4 host side ------------------------------------------------------------

// the v4 kernels' tiles (ops/cuda/flash_attention.py::plan reads them back
// through flash_tiles and refuses to launch if its own differ)
constexpr int kKeyTile = 64;  // forward and dq: keys per K/V tile
// dk/dv: queries per Q/dO tile; 48 at D 128 keeps the score tiles (24
// registers each) beside dk and dv (128) within the consumers' 240
constexpr int query_tile(int D) { return D > 64 ? 48 : 64; }
constexpr int kFwdStages = 3, kDqStages = 2, kKvStages = 2;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library links no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// [T, heads, D] bf16 in boxes of {64, box_h heads, box_t tokens}, 128-byte
// swizzle (the wgmma descriptors' layout); zero fill past the edges
bool map_rows(CUtensorMap* map, const void* ptr, int T, int heads, int D, int box_h,
              int box_t) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(D), cuuint64_t(heads), cuuint64_t(T)};
  const cuuint64_t strides[2] = {cuuint64_t(D) * 2, cuuint64_t(heads) * D * 2};
  const cuuint32_t box[3] = {cuuint32_t(kChunk), cuuint32_t(box_h), cuuint32_t(box_t)};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// n f32 values in boxes of `box`; zero fill past the end
bool map_vec(CUtensorMap* map, const float* ptr, size_t n, int box) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[1] = {cuuint64_t(n)};
  const cuuint64_t strides[1] = {0};  // rank 1: none is read
  const cuuint32_t boxd[1] = {cuuint32_t(box)};
  const cuuint32_t unit[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims,
             strides, boxd, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// forward and dq: one persistent block per SM, or one per item if fewer
int q_grid(const Params& p) {
  const int n_items = (p.T + 2 * p.bq - 1) / (2 * p.bq) * p.Hkv;
  return n_items < kSms ? n_items : kSms;
}

template <int D>
cudaError_t launch_fwd_v4(Params p, cudaStream_t stream) {
  using L = QSide<D, kKeyTile, kFwdStages, false>;
  p.bq = kRows / p.n_rep;
  Maps maps = {};
  if (!map_rows(&maps.q, p.q, p.T, p.H, D, p.n_rep, p.bq) ||
      !map_rows(&maps.out, p.out, p.T, p.H, D, p.n_rep, p.bq) ||
      !map_rows(&maps.k, p.k, p.T, p.Hkv, D, 1, kKeyTile) ||
      !map_rows(&maps.v, p.v, p.T, p.Hkv, D, 1, kKeyTile))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_v4_kernel<D, kKeyTile, kFwdStages>;
  const cudaError_t err = set_smem(kernel, L::kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<q_grid(p), kV4Threads, L::kBytes, stream>>>(maps, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_v4(Params p, cudaStream_t stream) {
  if (p.parts < 1 || p.n_rep % p.parts != 0 ||
      (p.parts > 1 && (p.ws == nullptr || p.counters == nullptr)))
    return cudaErrorInvalidValue;
  p.bq = kRows / p.n_rep;
  Maps dq_maps = {};
  if (!map_rows(&dq_maps.q, p.q, p.T, p.H, D, p.n_rep, p.bq) ||
      !map_rows(&dq_maps.dout, p.dout, p.T, p.H, D, p.n_rep, p.bq) ||
      !map_rows(&dq_maps.out, p.dq, p.T, p.H, D, p.n_rep, p.bq) ||
      !map_rows(&dq_maps.k, p.k, p.T, p.Hkv, D, 1, kKeyTile) ||
      !map_rows(&dq_maps.v, p.v, p.T, p.Hkv, D, 1, kKeyTile))
    return cudaErrorInvalidValue;
  using LQ = QSide<D, kKeyTile, kDqStages, true>;
  auto dq_kernel = flash_dq_v4_kernel<D, kKeyTile, kDqStages>;
  cudaError_t err = set_smem(dq_kernel, LQ::kBytes);
  if (err != cudaSuccess) return err;
  dq_kernel<<<q_grid(p), kV4Threads, LQ::kBytes, stream>>>(dq_maps, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Maps kv_maps = {};
  const size_t ht = size_t(p.H) * p.T;
  if (!map_rows(&kv_maps.q, p.q, p.T, p.H, D, 1, query_tile(D)) ||
      !map_rows(&kv_maps.dout, p.dout, p.T, p.H, D, 1, query_tile(D)) ||
      !map_rows(&kv_maps.k, p.k, p.T, p.Hkv, D, 1, 2 * kRows) ||
      !map_rows(&kv_maps.v, p.v, p.T, p.Hkv, D, 1, 2 * kRows) ||
      !map_vec(&kv_maps.lse, p.lse, ht, query_tile(D) + kVecPad) ||
      !map_vec(&kv_maps.delta, p.delta, ht, query_tile(D) + kVecPad))
    return cudaErrorInvalidValue;
  using LK = KSide<D, query_tile(D), kKvStages>;
  auto kv_kernel = flash_dkdv_v4_kernel<D, query_tile(D), kKvStages>;
  err = set_smem(kv_kernel, LK::kBytes);
  if (err != cudaSuccess) return err;
  const int n_kb = (p.T + 2 * kRows - 1) / (2 * kRows);
  kv_kernel<<<n_kb * p.Hkv * p.parts, kV4Threads, LK::kBytes, stream>>>(kv_maps, p);
  return cudaGetLastError();
}

bool valid_shape(int T, int H, int Hkv, int D) {
  return T >= 0 && Hkv > 0 && H % Hkv == 0 && D > 0 && D % 8 == 0 &&
         D <= kMaxD;
}

Params make_params(const void* q, const void* k, const void* v, const int* seg,
                   const int* seg_start, const int* seg_end, int T, int H,
                   int Hkv, int D, float scale, float soft_cap, int window) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = seg;
  p.seg_start = seg_start;
  p.seg_end = seg_end;
  p.T = T;
  p.H = H;
  p.Hkv = Hkv;
  p.D = D;
  p.n_rep = H / Hkv;
  p.scale = scale;
  p.soft_cap = soft_cap;
  p.window = window;
  return p;
}

// dispatch on dtype and head dim: tensor cores for bf16 with D 64 or 128,
// else the CUDA-core kernels by head-dim bucket (CPT output columns per
// thread)
template <template <typename, int> class L>
cudaError_t dispatch(int dtype, const Params& p, cudaStream_t s) {
  if (dtype == kBF16 && p.D == 64) return L<bf16, -64>::run(p, s);
  if (dtype == kBF16 && p.D == 128) return L<bf16, -128>::run(p, s);
  if (dtype == kF32) {
    if (p.D <= 64) return L<float, 4>::run(p, s);
    if (p.D <= 128) return L<float, 8>::run(p, s);
    return L<float, 16>::run(p, s);
  }
  if (dtype == kBF16) {
    if (p.D <= 64) return L<__nv_bfloat16, 4>::run(p, s);
    if (p.D <= 128) return L<__nv_bfloat16, 8>::run(p, s);
    return L<__nv_bfloat16, 16>::run(p, s);
  }
  return cudaErrorInvalidValue;
}

// CPT > 0: the CUDA-core kernels' bucket; CPT = -D: the v4 tensor-core
// kernels for head dim D (bf16 only)
template <typename T, int CPT>
struct Fwd {
  static cudaError_t run(const Params& p, cudaStream_t s) {
    if constexpr (CPT < 0) {
      return launch_fwd_v4<-CPT>(p, s);
    } else {
      return launch_fwd<T, CPT>(p, s);
    }
  }
};

template <typename T, int CPT>
struct Bwd {
  static cudaError_t run(const Params& p, cudaStream_t s) {
    if constexpr (CPT < 0) {
      return launch_bwd_v4<-CPT>(p, s);
    } else {
      return launch_bwd<T, CPT>(p, s);
    }
  }
};

}  // namespace

// C entry points, loaded with ctypes. Each returns a cudaError_t (0 = all
// kernels launched) and launches on `stream` without synchronising.

extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v,
                         const int* seg, const int* seg_start,
                         const int* seg_end, void* out, float* lse, int T,
                         int H, int Hkv, int D, float scale, float soft_cap,
                         int window, void* stream) {
  if (!valid_shape(T, H, Hkv, D)) return cudaErrorInvalidValue;
  if (T == 0 || H == 0) return cudaSuccess;
  Params p = make_params(q, k, v, seg, seg_start, seg_end, T, H, Hkv, D, scale,
                         soft_cap, window);
  p.out = out;
  p.lse = lse;
  return static_cast<int>(
      dispatch<Fwd>(dtype, p, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_bwd(int dtype, const void* q, const void* k, const void* v,
                         const int* seg, const int* seg_start,
                         const int* seg_end, const float* lse, const void* out,
                         const void* dout, float* delta, void* dq, void* dk,
                         void* dv, float* workspace, int* counters, int T, int H,
                         int Hkv, int D, float scale, float soft_cap,
                         int window, int parts, void* stream) {
  if (!valid_shape(T, H, Hkv, D)) return cudaErrorInvalidValue;
  if (T == 0 || H == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int delta_blocks = (T * H + 31) / 32;
  if (dtype == kBF16) {
    flash_delta_kernel<bf16><<<delta_blocks, 256, 0, st>>>(
        static_cast<const bf16*>(dout), static_cast<const bf16*>(out), delta, T, H, D);
  } else if (dtype == kF32) {
    flash_delta_kernel<float><<<delta_blocks, 256, 0, st>>>(
        static_cast<const float*>(dout), static_cast<const float*>(out), delta, T, H, D);
  } else {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p = make_params(q, k, v, seg, seg_start, seg_end, T, H, Hkv, D, scale,
                         soft_cap, window);
  p.lse = const_cast<float*>(lse);
  p.dout = dout;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.ws = workspace;
  p.counters = counters;
  p.parts = parts;
  return static_cast<int>(dispatch<Bwd>(dtype, p, st));
}

// The v4 kernels' tiles at head dim D: rows per consumer warpgroup, keys
// per K/V tile (forward, dq), keys per dk/dv block, queries per Q/dO tile
// (dk/dv).
extern "C" void flash_tiles(int D, int* out) {
  out[0] = kRows;
  out[1] = kKeyTile;
  out[2] = 2 * kRows;
  out[3] = query_tile(D);
}
