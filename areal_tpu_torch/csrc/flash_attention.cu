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
// segments of ~1k tokens) one forward does ~26 GFLOP of QK and PV work and
// moves ~55 MB, so it is bound by operations: ~26 us at the card's bf16
// tensor-core peak; the backward (five products) ~65 us.
//
// Design. Two families of kernels share the ranges, masks and rounding
// below; the C entry points pick one by dtype and head dim.
//  - Tensor cores (bf16 with D 64 or 128, the trainer's case): warp-level
//    mma.sync m16n8k16 on bf16 with f32 accumulation, 4 warps of 16 rows
//    per block. Scores and probabilities stay in registers: the score
//    accumulator's layout is the A-operand layout of the next product
//    (FA2), so P (and dS) feed PV (and dS K, P^T dO, dS^T Q) without
//    touching shared memory. Tiles are staged in shared memory as bf16,
//    row-major, by cp.async 16-byte copies, double-buffered: the next
//    tile's copies are in flight while this tile's products run, instead
//    of each thread waiting out one global load after another. An
//    operand a product reads along its rows (V
//    for PV; K, Q and dO in the backward) is read transposed by
//    ldmatrix.trans. No TMA, wgmma or warp specialisation yet (the next
//    step).
//  - CUDA cores (f32, and other head dims up to 256): f32 FMAs on tiles
//    staged in shared memory as f32, 256 threads as a 16 x 16 grid, each
//    thread owning a small register tile of scores and of the output.
// In both:
//  - forward: one block per (q tile, kv head). The block holds the whole
//    GQA group's query rows (n_rep heads x bq tokens folded into one row
//    tile), so each K/V tile is read once for the group. Keys run from the
//    segment (or window) start of the tile's first real token to the
//    causal diagonal, 64 at a time; online softmax in f32 in the log2
//    domain; P rounds to V's dtype before PV, as the reference.
//  - dq: one block per (64-token q tile, q head), keys as the forward; it
//    recomputes P from lse and accumulates dS K in registers.
//  - dk/dv: one block per (k tile, kv head). It walks the group's query
//    heads and the q tiles from the diagonal to the segment (or window)
//    end, and sums over the group in registers: no atomics, so results
//    are deterministic.
// D up to 256 (D % 8 == 0); the CUDA-core kernels halve their tiles above
// D 128 to stay within shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

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
  int T, H, Hkv, D, n_rep;
  float scale;           // softmax scale
  float soft_cap;        // <= 0: none
  int window;            // <= 0: none
  int bq;                // forward: tokens per q tile
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
// tensor-core kernels (bf16, D 64 or 128)
// --------------------------------------------------------------------------
//
// Fragment layout of mma.sync m16n8k16 (bf16 in, f32 out), per lane with
// gid = lane / 4 and tig = lane % 4:
//   A (16 x 16, rows x k): a0 = (gid, 2tig..2tig+1), a1 = (gid+8, same),
//                          a2 = (gid, 2tig+8..+9),   a3 = (gid+8, same)
//   B (16 x 8, k x cols):  b0 = (2tig..2tig+1, gid), b1 = (2tig+8..+9, gid)
//   C (16 x 8, f32):       c0, c1 = (gid, 2tig..+1), c2, c3 = (gid+8, same)
// so the C fragments of two adjacent 8-column tiles are, packed to bf16,
// the A fragment of a product over those 16 columns.

using bf16 = __nv_bfloat16;
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16) of a row-major
// bf16 tile with row stride ld
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int ld,
                                       int r0, int c0, int gid, int tig) {
  const bf16* p = t + (r0 + gid) * ld + c0 + 2 * tig;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragments of a product over rows [r0, r0 + 16) (its k) of a row-major
// bf16 tile, for the two 8-column tiles at columns c0 and c0 + 8 (its n):
// the tile read transposed by ldmatrix. b[0], b[1] serve columns c0..c0+7,
// b[2], b[3] columns c0+8..c0+15.
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* t, int ld,
                                        int r0, int c0, int lane) {
  const bf16* p = t + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(s));
}

// the C fragments of column tiles 2kk and 2kk + 1 as the A fragment of a
// product over their 16 columns (rounded to bf16)
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying `rows` rows of D bf16 into a row-major shared tile with row
// stride ld (16-byte cp.async copies, all in flight at once). Rows whose
// row_ptr is null are zeroed with plain stores.
template <int D, typename RowPtr>
__device__ __forceinline__ void stage_async(bf16* dst, int ld, int rows,
                                            RowPtr row_ptr) {
  constexpr int kVpr = D / 8;
  for (int i = threadIdx.x; i < rows * kVpr; i += blockDim.x) {
    const int r = i / kVpr;
    const int c = (i - r * kVpr) * 8;
    const bf16* src = row_ptr(r);
    if (src != nullptr) {
      cp_async16(dst + r * ld + c, src + c);
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0, 0, 0, 0);
    }
  }
}

// Start copying n 32-bit values (n <= count) into dst; the rest get `fill`.
template <typename T>
__device__ __forceinline__ void stage_words_async(T* dst, const T* src, int n,
                                                  int count, T fill) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    if (j < n) {
      cp_async4(dst + j, src + j);
    } else {
      dst[j] = fill;
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(const Params p) {
  constexpr int R = 16 * kMmaWarps;  // folded rows: n_rep heads x bq tokens
  constexpr int BK = 64;
  constexpr int LD = D + 8;          // padded bf16 row stride (bank spread)
  constexpr int NT = BK / 8;         // score column tiles
  constexpr int DT = D / 8;          // output column tiles
  const int g = blockIdx.y;
  const int bq = p.bq;
  const int q0 = blockIdx.x * bq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nt = p.T, n_rep = p.n_rep;
  const int nq = min(bq, nt - q0);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [R][LD]
  bf16* KV = Qs + R * LD;                         // [2 buffers][K | V][BK][LD]
  int* kseg = reinterpret_cast<int*>(KV + 4 * BK * LD);  // [2][BK]
  __shared__ int s_lo, s_hi;

  key_range(p, q0, nq, &s_lo, &s_hi);
  const int lo = s_lo, hi = s_hi;
  const int n_tiles = lo < hi ? (hi - lo + BK - 1) / BK : 0;
  stage_async<D>(Qs, LD, R, [&](int r) -> const bf16* {
    const int rep = r / bq, i = r - rep * bq;
    if (rep >= n_rep || i >= nq) return nullptr;
    return q + (size_t(q0 + i) * p.H + g * n_rep + rep) * D;
  });
  auto fetch = [&](int it, int buf) {
    const int k0 = lo + it * BK;
    const int n = min(BK, hi - k0);
    bf16* Kb = KV + buf * 2 * BK * LD;
    stage_async<D>(Kb, LD, BK, [&](int r) -> const bf16* {
      return r < n ? k + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
    });
    stage_async<D>(Kb + BK * LD, LD, BK, [&](int r) -> const bf16* {
      return r < n ? v + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
    });
    stage_words_async(kseg + buf * BK, p.seg + k0, n, BK, -1);
  };
  if (n_tiles > 0) fetch(0, 0);
  cp_async_commit();

  // this lane's two rows: gid and gid + 8 of the warp's 16
  int row_t[2], row_seg[2], row_h[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    const int rep = r / bq, ii = r - rep * bq;
    const bool ok = rep < n_rep && ii < nq;
    row_t[i] = ok ? q0 + ii : -1;
    row_seg[i] = ok ? p.seg[q0 + ii] : 0;
    row_h[i] = g * n_rep + rep;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int k0 = lo + it * BK;
    const int n = min(BK, hi - k0);
    if (it + 1 < n_tiles) fetch(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) have landed
    __syncthreads();
    const bf16* Ks = KV + buf * 2 * BK * LD;
    const bf16* Vs = Ks + BK * LD;
    const int* ks = kseg + buf * BK;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      load_a(a, Qs, LD, warp * 16, kk * 16, gid, tig);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* b = Ks + (j * 8 + gid) * LD + kk * 16 + 2 * tig;
        mma_bf16(s[j], a, ld32(b), ld32(b + 8));
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = j * 8 + 2 * tig + (e & 1);
        float tt;
        const float x = score(s[j][e], p, tt) * kLog2e;
        const bool ok = row_seg[i] > 0 && c < n &&
                        visible(row_t[i], row_seg[i], k0 + c, ks[c], p.window);
        s[j][e] = ok ? x : kNegInf;
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float pr = s[j][e] == kNegInf ? 0.f : exp2f(s[j][e] - m[i]);
        sum[i] += pr;
        s[j][e] = pr;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];
        load_bt(b, Vs, LD, kk * 16, j * 8, lane);
        mma_bf16(o[j], a, b[0], b[1]);
        mma_bf16(o[j + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the buffer is free for the tile after next
  }

  cp_async_wait<0>();  // nothing left in flight (a block may have no tiles)
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row_t[i];
    if (t < 0) continue;
    const bool live = l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
    bf16* orow = out + (size_t(t) * p.H + row_h[i]) * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    if (tig == 0)
      p.lse[size_t(row_h[i]) * nt + t] = live ? m[i] * kLn2 + logf(l[i]) : kNegInf;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_dq_mma_kernel(const Params p) {
  constexpr int R = 16 * kMmaWarps;  // q tokens per block
  constexpr int BK = 64;
  constexpr int LD = D + 8;
  constexpr int NT = BK / 8;
  constexpr int DT = D / 8;
  const int h = blockIdx.y;
  const int g = h / p.n_rep;
  const int q0 = blockIdx.x * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nt = p.T;
  const int nq = min(R, nt - q0);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [R][LD]
  bf16* dOs = Qs + R * LD;                        // [R][LD]
  bf16* KV = dOs + R * LD;                        // [2 buffers][K | V][BK][LD]
  int* kseg = reinterpret_cast<int*>(KV + 4 * BK * LD);  // [2][BK]
  __shared__ int s_lo, s_hi;

  key_range(p, q0, nq, &s_lo, &s_hi);
  const int lo = s_lo, hi = s_hi;
  const int n_tiles = lo < hi ? (hi - lo + BK - 1) / BK : 0;
  stage_async<D>(Qs, LD, R, [&](int r) -> const bf16* {
    return r < nq ? q + (size_t(q0 + r) * p.H + h) * D : nullptr;
  });
  stage_async<D>(dOs, LD, R, [&](int r) -> const bf16* {
    return r < nq ? dout + (size_t(q0 + r) * p.H + h) * D : nullptr;
  });
  auto fetch = [&](int it, int buf) {
    const int k0 = lo + it * BK;
    const int n = min(BK, hi - k0);
    bf16* Kb = KV + buf * 2 * BK * LD;
    stage_async<D>(Kb, LD, BK, [&](int r) -> const bf16* {
      return r < n ? k + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
    });
    stage_async<D>(Kb + BK * LD, LD, BK, [&](int r) -> const bf16* {
      return r < n ? v + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
    });
    stage_words_async(kseg + buf * BK, p.seg + k0, n, BK, -1);
  };
  if (n_tiles > 0) fetch(0, 0);
  cp_async_commit();

  int row_t[2], row_seg[2];
  float row_lse2[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    const bool ok = r < nq;
    row_t[i] = ok ? q0 + r : -1;
    row_seg[i] = ok ? p.seg[q0 + r] : 0;
    // pad rows carry the sentinel; clamp its log2 form so it stays finite
    row_lse2[i] = ok ? fmaxf(p.lse[size_t(h) * nt + q0 + r] * kLog2e, kNegInf) : 0.f;
    row_delta[i] = ok ? p.delta[size_t(h) * nt + q0 + r] : 0.f;
  }
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int k0 = lo + it * BK;
    const int n = min(BK, hi - k0);
    if (it + 1 < n_tiles) fetch(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Ks = KV + buf * 2 * BK * LD;
    const bf16* Vs = Ks + BK * LD;
    const int* ks = kseg + buf * BK;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, Qs, LD, warp * 16, kk * 16, gid, tig);
      load_a(ao, dOs, LD, warp * 16, kk * 16, gid, tig);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* bk = Ks + (j * 8 + gid) * LD + kk * 16 + 2 * tig;
        const bf16* bv = Vs + (j * 8 + gid) * LD + kk * 16 + 2 * tig;
        mma_bf16(s[j], aq, ld32(bk), ld32(bk + 8));
        mma_bf16(dp[j], ao, ld32(bv), ld32(bv + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = j * 8 + 2 * tig + (e & 1);
        float tt;
        const float x = score(s[j][e], p, tt) * kLog2e;
        const bool ok = row_seg[i] > 0 && c < n &&
                        visible(row_t[i], row_seg[i], k0 + c, ks[c], p.window);
        const float pr = ok ? exp2f(x - row_lse2[i]) : 0.f;
        float ds = pr * (dp[j][e] - row_delta[i]);
        if (p.soft_cap > 0.f) ds *= 1.f - tt * tt;
        s[j][e] = ds;
      }
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];
        load_bt(b, Ks, LD, kk * 16, j * 8, lane);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  cp_async_wait<0>();  // nothing left in flight (a block may have no tiles)
  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row_t[i];
    if (t < 0) continue;
    bf16* row = dq + (size_t(t) * p.H + h) * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * i] * p.scale, acc[j][2 * i + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_dkdv_mma_kernel(const Params p) {
  constexpr int B = 16 * kMmaWarps;  // keys per block
  constexpr int BQ = 32;             // queries per tile
  constexpr int LD = D + 8;
  constexpr int NQ = BQ / 8;         // score column (query) tiles
  constexpr int DT = D / 8;
  const int g = blockIdx.y;
  const int k0 = blockIdx.x * B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int nt = p.T, n_rep = p.n_rep;
  const int nk = min(B, nt - k0);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [B][LD]
  bf16* Vs = Ks + B * LD;                         // [B][LD]
  bf16* QO = Vs + B * LD;                         // [2 buffers][Q | dO][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(QO + 4 * BQ * LD);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                            // [2][BQ]
  int* qseg = reinterpret_cast<int*>(delta_s + 2 * BQ);       // [2][BQ]
  __shared__ int s_hi;

  // queries [k0, hi): causal from the tile's first key to the segment (or
  // window) end of its last real key
  if (threadIdx.x == 0) s_hi = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < nk; i += blockDim.x) {
    const int t = k0 + i;
    if (p.seg[t] > 0) {
      int end = p.seg_end[t];
      if (p.window > 0) end = min(end, t + p.window);
      atomicMax(&s_hi, end);
    }
  }
  stage_async<D>(Ks, LD, B, [&](int r) -> const bf16* {
    return r < nk ? k + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
  });
  stage_async<D>(Vs, LD, B, [&](int r) -> const bf16* {
    return r < nk ? v + (size_t(k0 + r) * p.Hkv + g) * D : nullptr;
  });
  __syncthreads();
  const int hi = s_hi;
  // one iteration per (query head of the group, q tile)
  const int n_qt = hi > k0 ? (hi - k0 + BQ - 1) / BQ : 0;
  const int n_it = n_rep * n_qt;
  auto fetch = [&](int it, int buf) {
    const int h = g * n_rep + it / n_qt;
    const int qq = k0 + (it % n_qt) * BQ;
    const int n = min(BQ, hi - qq);
    bf16* Qb = QO + buf * 2 * BQ * LD;
    stage_async<D>(Qb, LD, BQ, [&](int r) -> const bf16* {
      return r < n ? q + (size_t(qq + r) * p.H + h) * D : nullptr;
    });
    stage_async<D>(Qb + BQ * LD, LD, BQ, [&](int r) -> const bf16* {
      return r < n ? dout + (size_t(qq + r) * p.H + h) * D : nullptr;
    });
    stage_words_async(lse_s + buf * BQ, p.lse + size_t(h) * nt + qq, n, BQ, 0.f);
    stage_words_async(delta_s + buf * BQ, p.delta + size_t(h) * nt + qq, n, BQ, 0.f);
    stage_words_async(qseg + buf * BQ, p.seg + qq, n, BQ, 0);
  };
  if (n_it > 0) fetch(0, 0);
  cp_async_commit();

  int key_t[2], key_seg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    key_t[i] = k0 + r;
    key_seg[i] = r < nk ? p.seg[k0 + r] : 0;
  }
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[j][e] = 0.f;
      dv[j][e] = 0.f;
    }

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    const int qq = k0 + (it % n_qt) * BQ;
    const int n = min(BQ, hi - qq);
    if (it + 1 < n_it) fetch(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qs = QO + buf * 2 * BQ * LD;
    const bf16* dOs = Qs + BQ * LD;
    const float* ls = lse_s + buf * BQ;
    const float* dl = delta_s + buf * BQ;
    const int* qs = qseg + buf * BQ;

    // S^T and dP^T: this warp's 16 keys x BQ queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a(ak, Ks, LD, warp * 16, kk * 16, gid, tig);
      load_a(av, Vs, LD, warp * 16, kk * 16, gid, tig);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const bf16* bq = Qs + (j * 8 + gid) * LD + kk * 16 + 2 * tig;
        const bf16* bo = dOs + (j * 8 + gid) * LD + kk * 16 + 2 * tig;
        mma_bf16(s[j], ak, ld32(bq), ld32(bq + 8));
        mma_bf16(dp[j], av, ld32(bo), ld32(bo + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = j * 8 + 2 * tig + (e & 1);  // query within the tile
        float tt;
        const float x = score(s[j][e], p, tt) * kLog2e;
        const bool ok = key_seg[i] > 0 && c < n &&
                        visible(qq + c, qs[c], key_t[i], key_seg[i], p.window);
        // pad rows carry the sentinel; clamp its log2 form so it stays finite
        const float pr = ok ? exp2f(x - fmaxf(ls[c] * kLog2e, kNegInf)) : 0.f;
        float ds = pr * (dp[j][e] - dl[c]);
        if (p.soft_cap > 0.f) ds *= 1.f - tt * tt;
        s[j][e] = pr;
        dp[j][e] = ds;
      }
    }
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
      uint32_t ap[4], ads[4];
      c_to_a(ap, s[2 * kk], s[2 * kk + 1]);
      c_to_a(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t bo[4], bq[4];
        load_bt(bo, dOs, LD, kk * 16, j * 8, lane);
        load_bt(bq, Qs, LD, kk * 16, j * 8, lane);
        mma_bf16(dv[j], ap, bo[0], bo[1]);
        mma_bf16(dv[j + 1], ap, bo[2], bo[3]);
        mma_bf16(dk[j], ads, bq[0], bq[1]);
        mma_bf16(dk[j + 1], ads, bq[2], bq[3]);
      }
    }
    __syncthreads();
  }

  cp_async_wait<0>();  // nothing left in flight (a block may have no tiles)
  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    if (r >= nk) continue;
    const size_t base = (size_t(k0 + r) * p.Hkv + g) * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk_out + base + j * 8) =
          __floats2bfloat162_rn(dk[j][2 * i] * p.scale, dk[j][2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + base + j * 8) =
          __floats2bfloat162_rn(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
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

template <int D>
cudaError_t launch_fwd_mma(Params p, cudaStream_t stream) {
  constexpr int R = 16 * kMmaWarps, BK = 64;
  if (p.n_rep > R) return cudaErrorInvalidValue;
  p.bq = R / p.n_rep;
  // Q tile, two buffers of K and V tiles, two buffers of key segment ids
  const size_t bytes = size_t(R + 4 * BK) * (D + 8) * 2 + 2 * BK * 4;
  auto kernel = flash_fwd_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + p.bq - 1) / p.bq, p.Hkv);
  kernel<<<grid, kMmaThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_mma(Params p, cudaStream_t stream) {
  constexpr int R = 16 * kMmaWarps, BK = 64, B = 16 * kMmaWarps, BQ = 32;
  // Q and dO tiles, two buffers of K and V tiles and key segment ids
  const size_t dq_bytes = size_t(2 * R + 4 * BK) * (D + 8) * 2 + 2 * BK * 4;
  auto dq_kernel = flash_dq_mma_kernel<D>;
  cudaError_t err = set_smem(dq_kernel, dq_bytes);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3((p.T + R - 1) / R, p.H), kMmaThreads, dq_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // K and V tiles, two buffers of Q and dO tiles and of lse, delta, ids
  const size_t kv_bytes = size_t(2 * B + 4 * BQ) * (D + 8) * 2 + 3 * 2 * BQ * 4;
  auto kv_kernel = flash_dkdv_mma_kernel<D>;
  err = set_smem(kv_kernel, kv_bytes);
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3((p.T + B - 1) / B, p.Hkv), kMmaThreads, kv_bytes, stream>>>(p);
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

// CPT > 0: the CUDA-core kernels' bucket; CPT = -D: the tensor-core
// kernels for head dim D (bf16 only)
template <typename T, int CPT>
struct Fwd {
  static cudaError_t run(const Params& p, cudaStream_t s) {
    if constexpr (CPT < 0) {
      return launch_fwd_mma<-CPT>(p, s);
    } else {
      return launch_fwd<T, CPT>(p, s);
    }
  }
};

template <typename T, int CPT>
struct Bwd {
  static cudaError_t run(const Params& p, cudaStream_t s) {
    if constexpr (CPT < 0) {
      return launch_bwd_mma<-CPT>(p, s);
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
                         const int* seg_end, const float* lse,
                         const void* dout, const float* delta, void* dq,
                         void* dk, void* dv, int T, int H, int Hkv, int D,
                         float scale, float soft_cap, int window,
                         void* stream) {
  if (!valid_shape(T, H, Hkv, D)) return cudaErrorInvalidValue;
  if (T == 0 || H == 0) return cudaSuccess;
  Params p = make_params(q, k, v, seg, seg_start, seg_end, T, H, Hkv, D, scale,
                         soft_cap, window);
  p.lse = const_cast<float*>(lse);
  p.dout = dout;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  return static_cast<int>(
      dispatch<Bwd>(dtype, p, static_cast<cudaStream_t>(stream)));
}
