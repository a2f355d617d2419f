// Paged decode attention for Hopper (sm_90a), v5: split-K over pages.
//
// Replaces the Pallas TPU kernel `_decode_kernel` reached through
// `decode` in areal_tpu/ops/pallas/paged_attention.py. One new query
// token per slot attends to its KV pages read in place from the whole
// pool [L, P, 2, Hkv, page, D] (K and V interleaved per page, heads
// before tokens), addressed by a layer index, a page table [B, M] (a
// narrowed view: row stride table_stride) and the resident lengths lens
// [B] (which exclude the token itself). The token's own K/V arrive as
// separate operands and fold in last, so the pool stays read-only during
// the layer loop. Soft cap, sliding window and an int8 pool with f32
// per-(token, head) scales are supported.
//
// Bound. Per call the kernel must read sum_b lens_b * Hkv * D * 2 *
// itemsize bytes of K/V (plus 8 bytes of scales per token and head for
// the int8 pool) and does 4 * sum_b lens_b * Hq * D flops: about one
// flop per byte, far below the card's ~295 flop/byte ridge, so it is
// bound by memory bandwidth. At the slice shape (64 slots, lens over
// [0, 2047], Hkv 2, D 128) that is ~67 MB in bf16 (0.020 ms at 3.35
// TB/s) and ~34 MB + scales for the int8 pool (0.0105 ms).
//
// v4 (the design this replaces) ran one 512-thread block per (kv head,
// slot) that walked the slot's pages in order with QK and PV on CUDA
// cores: 128 blocks at the slice shape, ~10 us per page on the longest
// slot's walk, 0.1686 ms (bf16) / 0.1926 ms (int8) on an H100 against a
// 0.0706 / 0.0724 ms SDPA call over pre-gathered K/V.
//
// Design (v5).
//  - Work item = (split, kv head, slot); a split is `split_pages`
//    consecutive table columns (2 at page 128). The host sizes the launch
//    from the table width alone (it never reads lens, so the engine's
//    decode chunk stays free of host syncs): one wave of persistent 4-warp
//    blocks (SMs x resident blocks per SM: 3 at D 128). Each block first derives, from
//    lens in shared memory, every slot's visible range and live splits and
//    a scan of the slots' item counts, so the blocks share the live items
//    evenly (block k takes live items k, k + gridDim.x, ...; a slot's
//    splits go to different blocks). A slot that sees nothing in the pool
//    is one item: its self token. Splits at or past min(len, width * page)
//    or wholly before the sliding window are no items at all.
//  - A block streams its items' tiles (64 positions, 16 per warp) through
//    two staging buffers with 16-byte cp.async copies: the next item's
//    first tile is in flight while this item's epilogue runs. An item
//    carries the page id of its first page; rows outside the visible range
//    are zero-filled, never read from the pool.
//  - bf16 queries: the GQA group's n_rep query rows, padded to 16, are the
//    A tile of mma.sync.m16n8k16 with f32 accumulators. QK^T takes K from
//    shared memory as the B operand (bf16: exact widening of int8 K; the K
//    scale multiplies the f32 scores after the dot). The online softmax
//    runs in registers on the accumulator fragments (row max and sum by
//    quad shuffles; the padding half of the rows is skipped when n_rep <=
//    8). P.V reads V with ldmatrix.trans: P rounds to bf16 over a bf16
//    pool (as the reference does); over an int8 pool P times the V scale,
//    brought into [0, 1] by a per-warp power of two (softmax_tile), rounds
//    to f16 (11 significant bits, against bf16's 8; the reference keeps
//    this product in f32) and V widens exactly to f16 in shared memory, so
//    that product is f16.
//  - f32 queries (f32 pool, or f32 queries over an int8 pool; small
//    shapes only): the same split, staging, softmax and merge with both
//    products on CUDA cores in f32, in the same fragment layout.
//  - Each warp keeps its own (m, l, acc); the block combines its warps in
//    pairs in a fixed order, ((w0 + w2) + (w1 + w3)), through an idle
//    buffer, and writes the split's partial (m, l, acc[n_rep, D]) in f32 to
//    a workspace.
//  - Merge in the same launch: the block of every live split bumps a
//    per-(slot, kv head) int32 arrival counter after a __threadfence; the
//    block that arrives last merges the live splits in split order against
//    their common max, folds in the self token (always attended), writes
//    the output in q's dtype and resets the counter to 0. A slot with one
//    live split merges at once. No float atomics: the result is
//    bit-identical across runs and block orders. The finite sentinel
//    kNegInf and the guard m > kNegInf / 2 make a slot with lens 0 give
//    exactly the self-token result. The counters are per device: launches
//    that share a device must not run concurrently on two streams.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;            // MMA rows: the GQA group, padded
constexpr int kMaxD = 256;           // head dim
constexpr int kTK = 16 * kWarps;     // tokens per staged tile, 16 per warp
constexpr int kChunk = 16;           // bytes per cp.async copy
// finite masking sentinel shared with the JAX reference: a fully masked
// row keeps a finite max, and the rescale guard (m > kNegInf / 2) keeps
// exp() away from inf - inf
constexpr float kNegInf = -2.3819763e38f;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;        // [B, Hq, D]
  const void* k_self;   // [B, Hkv, D]
  const void* v_self;   // [B, Hkv, D]
  const void* pool;     // [L, P, 2, Hkv, page, D], 16-byte aligned
  const float* scales;  // [L, P, 2, Hkv, page] (int8 pool only)
  const int* table;     // [B, >= width], row stride table_stride
  const int* lens;      // [B]
  void* out;            // [B, Hq, D]
  float* part_acc;      // [B, Hkv, n_splits, n_rep, D]
  float* part_ml;       // [B, Hkv, n_splits, 2, n_rep]  (m, then l)
  int* counters;        // [B * Hkv], 0 between launches
  int layer, n_pages, hq, hkv, d, page, width, table_stride, n_rep;
  int batch, split_pages, n_splits;
  float scale, soft_cap;  // soft_cap <= 0: none
  int window;             // <= 0: none
  int nbuf;               // staging buffers (2 unless shared memory is short)
  int srow;               // staged row stride in bytes
  // byte offsets of the shared-memory regions (computed on the host)
  int off_q, off_stage, off_v16, off_sc, off_p, off_comb, off_ml;
  int comb_in_stage;      // the combine slots alias an idle staging buffer
  int off_slots;          // per-slot live ranges and item offsets
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

__device__ __forceinline__ void zero16(void* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

// Fragment layout of mma.sync m16n8k16 (16-bit in, f32 out), per lane with
// gid = lane / 4 and tig = lane % 4:
//   A (16 x 16, rows x k): a0 = (gid, 2tig..2tig+1), a1 = (gid+8, same),
//                          a2 = (gid, 2tig+8..+9),   a3 = (gid+8, same)
//   B (16 x 8, k x cols):  b0 = (2tig..2tig+1, gid), b1 = (2tig+8..+9, gid)
//   C (16 x 8, f32):       c0, c1 = (gid, 2tig..+1), c2, c3 = (gid+8, same)
// so the C fragments of two adjacent 8-column tiles are, packed to 16 bits,
// the A fragment of a product over those 16 columns. The f32 path keeps
// its sums in the same layout, so softmax and combine code is shared.

template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two neighbouring int8 values widened (exactly) to a bf16 pair
__device__ __forceinline__ uint32_t ld_i8x2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return pack2<bf16>(static_cast<float>(c.x), static_cast<float>(c.y));
}

// A fragment of rows [0, 16) x columns [c0, c0 + 16) of a row-major 16-bit
// tile with row stride ld (elements)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int ld,
                                       int c0, int gid, int tig) {
  const bf16* p = t + gid * ld + c0 + 2 * tig;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragments of a product over rows [r0, r0 + 16) (its k) of a row-major
// 16-bit tile, for the two 8-column tiles at columns c0 and c0 + 8 (its
// n): the tile read transposed by ldmatrix. b[0], b[1] serve columns
// c0..c0+7, b[2], b[3] columns c0+8..c0+15.
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const void* t, int ld,
                                        int r0, int c0, int lane) {
  const uint16_t* p = static_cast<const uint16_t*>(t) +
                      (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(s));
}

// The positions of a slot that the query sees, [lo, hi), and the splits
// [s0, s1) that hold them (s0 == s1: none). Pages outside are never read.
__device__ __forceinline__ void visible_splits(const Params& p, int len,
                                               int& lo, int& hi, int& s0,
                                               int& s1) {
  hi = min(len, p.width * p.page);
  // the query sits at position len; a window keeps kpos > len - window
  lo = p.window > 0 ? max(0, len - p.window + 1) : 0;
  const int st = p.split_pages * p.page;
  s0 = lo < hi ? lo / st : 0;
  s1 = lo < hi ? (hi - 1) / st + 1 : 0;
}

// Scores of one warp's 16 tokens (columns c_base + j * 8 + 2 tig + e & 1 of
// the tile at t0) to probabilities, in place: scale, K scale, soft cap,
// mask, then the online softmax update of (m, l); returns the rescale of
// the warp's earlier sums in corr. For an int8 pool the probabilities are
// then multiplied by the V scale. On the tensor-core path (kF16: P * vs
// goes to the MMA in f16) also by vf, a power of two that brings the
// largest of the 16 V scales into [0.5, 1): P * vs * vf lies in [0, 1], so
// its f16 rounding keeps 11 significant bits whatever the scales' size
// (bare P * vs would fall below f16's normal range, 6.1e-5, once the
// scales are small). vf is held as its biased exponent vfe (vf = 2^(vfe -
// 127)); the warp's sums carry the current vf, corr also moves them from
// the previous tile's vf to this one's (exact), and the combine takes vf
// out. All of it is integer arithmetic on exponent bits: no division.
__device__ __forceinline__ float pow2_bits(int e) {  // 2^(e - 127), e clamped
  return __int_as_float(min(max(e, 1), 254) << 23);
}

template <bool kQuant, bool kF16>
__device__ __forceinline__ void softmax_tile(float (&s)[2][4], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int& vfe, const Params& p, int t0,
                                             int c_base, int a, int b,
                                             const float* ksc, const float* vsc,
                                             int gid, int tig) {
  // rows past the GQA group are padding: masked like invisible positions;
  // rows 8..15 (the fragments' second half) are skipped outright when the
  // group has at most 8 heads (a warp-uniform branch)
  const bool hi = p.n_rep > 8;
  const bool row_live[2] = {gid < p.n_rep, gid + 8 < p.n_rep};
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e >= 2 && !hi) continue;
      const int c = c_base + j * 8 + 2 * tig + (e & 1);
      const int pos = t0 + c;
      float x = s[j][e] * p.scale;
      if constexpr (kQuant) x *= ksc[c];
      if (p.soft_cap > 0.f) x = p.soft_cap * tanhf(x / p.soft_cap);
      s[j][e] = (pos >= a && pos < b && row_live[e >> 1]) ? x : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i == 1 && !hi) {
      corr[1] = 1.f;
      continue;
    }
    const float m_new = fmaxf(m[i], quad_max(mx[i]));
    corr[i] = expf(m[i] > kNegInf / 2 ? m[i] - m_new : 0.f);
    m[i] = m_new;
  }
  // this tile's vf (kept when the warp sees no position: all scales 0):
  // vm in [2^(E - 127), 2^(E - 126)) for its exponent bits E, vf = 2^(126 - E)
  int vfe_new = vfe;
  if constexpr (kF16) {
    const int cb = c_base + 2 * tig;
    const float vm = quad_max(fmaxf(fmaxf(vsc[cb], vsc[cb + 1]),
                                    fmaxf(vsc[cb + 8], vsc[cb + 9])));
    if (vm > 0.f) vfe_new = max(253 - (__float_as_int(vm) >> 23), 1);
  }
  const float vf = pow2_bits(vfe_new);
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      if (i == 1 && !hi) {
        s[j][e] = 0.f;
        continue;
      }
      const float pr = s[j][e] == kNegInf ? 0.f : expf(s[j][e] - m[i]);
      sum[i] += pr;
      if constexpr (kF16) {
        s[j][e] = pr * (vsc[c_base + j * 8 + 2 * tig + (e & 1)] * vf);
      } else if constexpr (kQuant) {
        s[j][e] = pr * vsc[c_base + j * 8 + 2 * tig + (e & 1)];
      } else {
        s[j][e] = pr;
      }
    }
  }
  l[0] = l[0] * corr[0] + quad_sum(sum[0]);
  if (hi) l[1] = l[1] * corr[1] + quad_sum(sum[1]);
  if constexpr (kF16) {
    const float r = pow2_bits(127 + vfe_new - vfe);  // vf_new / vf_old
    corr[0] *= r;
    corr[1] *= r;
    vfe = vfe_new;
  }
}

// The output of (slot b, kv head g): the partials of splits [s0, s1)
// rescaled to their common max and summed in split order, then the token
// itself (always attended, never masked or scaled). s0 == s1 gives the
// self token alone. Loads go out together: a row's max and sum by
// one warp over the splits (lanes fold their splits online, then combine
// in a fixed order), then each output column's sum with its loads
// unrolled.
template <typename QT>
__device__ void finish(const Params& p, int b, int g, int s0, int s1,
                       float* row_s) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = p.d, n_rep = p.n_rep;
  const size_t sh = size_t(b) * p.hkv + g;
  const QT* qb = static_cast<const QT*>(p.q) + (size_t(b) * p.hq + g * n_rep) * D;
  const QT* ksb = static_cast<const QT*>(p.k_self) + sh * D;
  const QT* vsb = static_cast<const QT*>(p.v_self) + sh * D;
  // partials are read through L2 (__ldcg): other blocks wrote them
  const float* ml0 = p.part_ml + sh * p.n_splits * 2 * n_rep;
  const float* acc0 = p.part_acc + sh * p.n_splits * n_rep * D;
  float* max_s = row_s;            // [kRows] the splits' common max
  float* sum_s = row_s + kRows;    // [kRows] their rescaled sum
  float* self_s = row_s + 2 * kRows;
  for (int r = warp; r < n_rep; r += kWarps) {
    float part = 0.f;
#pragma unroll 4
    for (int d = lane; d < D; d += 32) part += to_f(qb[r * D + d]) * to_f(ksb[d]);
    float x = warp_sum(part) * p.scale;
    if (p.soft_cap > 0.f) x = p.soft_cap * tanhf(x / p.soft_cap);
    // each lane folds its splits (s0 + lane, s0 + lane + 32, ...) online,
    // then the warp combines the lanes in a fixed order
    float mm = kNegInf, ll = 0.f;
    for (int s2 = s0 + lane; s2 < s1; s2 += 32) {
      const float* ml = ml0 + size_t(s2) * 2 * n_rep;
      const float ms = __ldcg(ml + r), ls = __ldcg(ml + n_rep + r);
      const float m_new = fmaxf(mm, ms);
      ll = ll * expf(mm > kNegInf / 2 ? mm - m_new : 0.f) + ls * expf(ms - m_new);
      mm = m_new;
    }
    const float mw = warp_max(mm);
    ll = warp_sum(mm > kNegInf / 2 ? ll * expf(mm - mw) : 0.f);
    if (lane == 0) {
      self_s[r] = x;
      max_s[r] = mw;
      sum_s[r] = ll;
    }
  }
  __syncthreads();
  QT* ob = static_cast<QT*>(p.out) + (size_t(b) * p.hq + g * n_rep) * D;
  for (int i = 4 * tid; i < n_rep * D; i += 4 * kThreads) {
    const int r = i / D;  // D % 4 == 0: the 4 columns share a row
    const float mm = max_s[r];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int s2 = s0; s2 < s1; ++s2) {
      const float w = expf(__ldcg(ml0 + size_t(s2) * 2 * n_rep + r) - mm);
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(acc0 + size_t(s2) * n_rep * D + i));
      acc.x += v.x * w;
      acc.y += v.y * w;
      acc.z += v.z * w;
      acc.w += v.w * w;
    }
    const float s_self = self_s[r];
    const float m_new = fmaxf(mm, s_self);
    const float corr = expf(mm > kNegInf / 2 ? mm - m_new : 0.f);
    const float p_self = expf(s_self - m_new);
    const float l = corr * sum_s[r] + p_self;
    const int c = i - r * D;
    ob[i] = from_f<QT>((acc.x * corr + p_self * to_f(vsb[c])) / l);
    ob[i + 1] = from_f<QT>((acc.y * corr + p_self * to_f(vsb[c + 1])) / l);
    ob[i + 2] = from_f<QT>((acc.z * corr + p_self * to_f(vsb[c + 2])) / l);
    ob[i + 3] = from_f<QT>((acc.w * corr + p_self * to_f(vsb[c + 3])) / l);
  }
}

// A work item: split s of (slot b, kv head g) with its visible positions
// [a, bnd), staged as n_tiles tiles from t_first (pid: the page id of the
// first tile's page); or, with no tiles, the self token of a slot that
// sees nothing in the pool. idx == n_items: none.
struct Item {
  int idx, b, s, g, a, bnd, t_first, n_tiles, s0, s1, pid;
};

// Per-slot values every block derives from lens at its start, in shared
// memory: the visible range [lo, hi), the live splits [s0, s1) and the
// first item of the slot among one head's items (off, B + 1 entries).
struct Slots {
  int *lo, *hi, *s0, *s1, *off;
};

// Item idx of the block's list: items run over (kv head, slot, live split)
// with the split fastest, so one slot's splits go to different blocks; a
// slot without a live split has one item, its self token.
__device__ Item make_item(const Params& p, const Slots& sl, int idx, int n_items) {
  Item it;
  it.idx = idx;
  if (idx >= n_items) return it;
  const int per_head = sl.off[p.batch];
  it.g = idx / per_head;
  const int rem = idx - it.g * per_head;
  int lo = 0, hi = p.batch - 1;  // the last slot whose first item <= rem
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (sl.off[mid] <= rem) lo = mid; else hi = mid - 1;
  }
  it.b = lo;
  it.s0 = sl.s0[lo];
  it.s1 = sl.s1[lo];
  it.s = it.s0 + (rem - sl.off[lo]);
  if (it.s0 == it.s1) {
    it.a = it.bnd = it.t_first = it.n_tiles = it.pid = 0;
    return it;
  }
  const int st = p.split_pages * p.page;
  it.a = max(it.s * st, sl.lo[lo]);
  it.bnd = min((it.s + 1) * st, sl.hi[lo]);
  it.t_first = it.s * st + ((it.a - it.s * st) / kTK) * kTK;
  it.n_tiles = (it.bnd - it.t_first + kTK - 1) / kTK;
  it.pid = p.table[size_t(it.b) * p.table_stride + it.t_first / p.page];
  return it;
}

// Persistent blocks over the live items (see the header note). A block
// streams its items' tiles through its two staging buffers without a
// break: the next item's first tile is in flight while this item's
// epilogue (combine, partial, merge) runs.
// Up to D 128 the registers are capped so that 3 blocks fit on an SM (168
// a thread, no spills): the third block's tiles overlap the other two's
// latency-bound tile and epilogue work.
template <typename QT, typename PT, int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX <= 128 ? 3 : 1)
    paged_decode_split_kernel(const Params p) {
  constexpr bool kMma = std::is_same<QT, bf16>::value;
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  // the P.V operand type on the tensor cores (see the header note)
  using VT = typename std::conditional<kQuant, __half, bf16>::type;
  constexpr int LD = DMAX + 8;  // padded 16-bit row (elements): no bank conflicts
  constexpr int DT = DMAX / 8;  // output column tiles
  constexpr int KT = DMAX / 16; // QK k-steps
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int D = p.d, n_rep = p.n_rep;

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  __shared__ float row_s[3 * kRows];  // the merge's per-row values

  const size_t stripe = size_t(p.page) * D;  // one [page, D] head stripe
  const size_t layer_base = size_t(p.layer) * p.n_pages;
  const PT* pool = static_cast<const PT*>(p.pool);
  const int srow = p.srow;
  const size_t buf_bytes = size_t(2) * kTK * srow;  // K | V
  unsigned char* stage = smem + p.off_stage;
  float* sc = reinterpret_cast<float*>(smem + p.off_sc);  // [nbuf][K|V][kTK]
  const bool dbl = p.nbuf == 2;
  // a page of whole tiles (page % 64 == 0): one page id per tile
  const bool whole = p.page % kTK == 0;

  // K columns [D, D + 8) enter the last k-step over a bf16 pool whose D is
  // not a multiple of 16: each staged tile keeps them 0
  const bool pad_k = kMma && !kQuant && (D & 15);
  // query rows past n_rep and columns past D stay 0 for every item
  constexpr int kQRow = kMma ? LD * 2 : DMAX * 4;  // bytes per staged q row
  for (int i = tid; i < kRows * kQRow / 4; i += kThreads) {
    const int r = i / (kQRow / 4), cb = (i - r * (kQRow / 4)) * 4;
    if (r >= n_rep || cb >= D * int(sizeof(QT)))
      *reinterpret_cast<uint32_t*>(smem + p.off_q + r * kQRow + cb) = 0u;
  }

  // start the copies of tile j of item `it` into buffer `buf`; rows outside
  // the visible range [a, bnd) are zero-filled and never read from the pool
  auto stage_tile = [&](const Item& it, int j, int buf) {
    const int t0 = it.t_first + j * kTK;
    const int* trow = p.table + size_t(it.b) * p.table_stride;
    unsigned char* dk = stage + buf * buf_bytes;
    unsigned char* dv = dk + size_t(kTK) * srow;
    constexpr int kE = kChunk / int(sizeof(PT));
    const int cpr = D / kE;  // chunks per row
    // the item's first page id rides in the item (no table load here)
    const int pg0 = it.t_first / p.page;
    const int pg_t = t0 / p.page;
    const int pid_t = pg_t == pg0 ? it.pid : trow[pg_t];
    const size_t off_t =
        ((layer_base + pid_t) * 2 * p.hkv + it.g) * stripe + size_t(t0 - pg_t * p.page) * D;
    // this thread's chunks (row r, chunk c), stepped without division
    int r = tid / cpr, c = tid - (tid / cpr) * cpr;
    const int dr = kThreads / cpr, dc = kThreads - dr * cpr;
    for (int i = tid; i < kTK * cpr; i += kThreads) {
      const int pos = t0 + r;
      unsigned char* dst_k = dk + r * srow + c * kChunk;
      unsigned char* dst_v = dv + r * srow + c * kChunk;
      if (pos >= it.a && pos < it.bnd) {
        size_t off = off_t + size_t(r) * D;
        if (!whole) {
          const int pg = pos / p.page;
          off = ((layer_base + trow[pg]) * 2 * p.hkv + it.g) * stripe + size_t(pos - pg * p.page) * D;
        }
        const PT* src = pool + off + c * kE;
        cp_async16(dst_k, src);
        cp_async16(dst_v, src + p.hkv * stripe);
      } else {
        zero16(dst_k);
        zero16(dst_v);
      }
      r += dr;
      c += dc;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
    if (pad_k)
      for (int rr = tid; rr < kTK; rr += kThreads) zero16(dk + rr * srow + D * 2);
    if constexpr (kQuant) {
      float* dst = sc + buf * 2 * kTK;
      for (int rr = tid; rr < kTK; rr += kThreads) {
        const int pos = t0 + rr;
        if (pos >= it.a && pos < it.bnd) {
          const int pg = whole ? pg_t : pos / p.page;
          const int pid = whole ? pid_t : trow[pg];
          const size_t head = (layer_base + pid) * 2 * p.hkv + it.g;
          const float* src = p.scales + head * p.page + (pos - pg * p.page);
          cp_async4(dst + rr, src);
          cp_async4(dst + kTK + rr, src + size_t(p.hkv) * p.page);
        } else {
          dst[rr] = 0.f;
          dst[kTK + rr] = 0.f;
        }
      }
    }
  };

  // the live items, from lens: per-slot ranges, then a scan of the
  // slots' item counts (one warp, 32 slots at a time)
  Slots sl;
  sl.lo = reinterpret_cast<int*>(smem + p.off_slots);
  sl.hi = sl.lo + p.batch;
  sl.s0 = sl.hi + p.batch;
  sl.s1 = sl.s0 + p.batch;
  sl.off = sl.s1 + p.batch;
  for (int b = tid; b < p.batch; b += kThreads)
    visible_splits(p, p.lens[b], sl.lo[b], sl.hi[b], sl.s0[b], sl.s1[b]);
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < p.batch; base += 32) {
      const int b = base + lane;
      const int n = b < p.batch ? max(sl.s1[b] - sl.s0[b], 1) : 0;
      int x = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (b < p.batch) sl.off[b] = carry + x - n;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) sl.off[p.batch] = carry;
  }
  __syncthreads();
  const int total = p.hkv * sl.off[p.batch];
  Item cur = make_item(p, sl, blockIdx.x, total);
  int buf = 0;
  if (dbl && cur.idx < total && cur.n_tiles > 0) stage_tile(cur, 0, 0);
  cp_async_commit();
  while (cur.idx < total) {
    if (cur.n_tiles == 0) {  // the slot sees only itself
      finish<QT>(p, cur.b, cur.g, cur.s0, cur.s1, row_s);
      __syncthreads();
      cur = make_item(p, sl, cur.idx + gridDim.x, total);
      if (dbl && cur.idx < total && cur.n_tiles > 0) stage_tile(cur, 0, buf);
      cp_async_commit();
      continue;
    }
    {
      // the query rows (their own copy group), then the item after this one
      const unsigned char* qb = static_cast<const unsigned char*>(p.q) +
                                (size_t(cur.b) * p.hq + cur.g * n_rep) * D * sizeof(QT);
      const int qcpr = D * int(sizeof(QT)) / kChunk;
      for (int i = tid; i < n_rep * qcpr; i += kThreads) {
        const int r = i / qcpr, c = i - r * qcpr;
        cp_async16(smem + p.off_q + r * kQRow + c * kChunk,
                   qb + (size_t(r) * D * sizeof(QT)) + c * kChunk);
      }
      cp_async_commit();
    }
    const Item nxt = make_item(p, sl, cur.idx + gridDim.x, total);

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    int vfe = 127;  // exponent bits of the power of two o carries (kF16)
    float o[DT][4];
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

    for (int it = 0; it < cur.n_tiles; ++it) {
      if (dbl) {
        // prefetch the following tile: this item's next, or the next
        // item's first
        if (it + 1 < cur.n_tiles) {
          stage_tile(cur, it + 1, buf ^ 1);
        } else if (nxt.idx < total && nxt.n_tiles > 0) {
          stage_tile(nxt, 0, buf ^ 1);
        }
        cp_async_commit();
        cp_async_wait<1>();  // this tile's group (and q's) has landed
      } else {
        stage_tile(cur, it, buf);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      const int t0 = cur.t_first + it * kTK;
      const int a = cur.a, bnd = cur.bnd;
      const unsigned char* sk = stage + buf * buf_bytes;
      const unsigned char* sv = sk + size_t(kTK) * srow;
      const float* ksc = sc + buf * 2 * kTK;
      const float* vsc = ksc + kTK;
      float sacc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
      float corr[2];

      if constexpr (kMma) {
        const bf16* Qs = reinterpret_cast<const bf16*>(smem + p.off_q);
        const void* Vt = sv;
        if constexpr (kQuant) {
          // V widens exactly to f16 in shared memory (ldmatrix needs 16 bits)
          __half* V16 = reinterpret_cast<__half*>(smem + p.off_v16);
          const int vpr = D / 8;
          for (int i = tid; i < kTK * vpr; i += kThreads) {
            const int r = i / vpr, c = (i - r * vpr) * 8;
            const uint2 raw = *reinterpret_cast<const uint2*>(sv + r * srow + c);
            const int8_t* e8 = reinterpret_cast<const int8_t*>(&raw);
            uint32_t w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              w[k] = pack2<__half>(static_cast<float>(e8[2 * k]),
                                   static_cast<float>(e8[2 * k + 1]));
            *reinterpret_cast<uint4*>(V16 + r * LD + c) = make_uint4(w[0], w[1], w[2], w[3]);
          }
          Vt = V16;
        }
        // S = Q K^T over this warp's 16 tokens (two 8-token column tiles)
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          if (kk * 16 < D) {
            uint32_t aq[4];
            load_a(aq, Qs, LD, kk * 16, gid, tig);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int tok = warp * 16 + j * 8 + gid;
              uint32_t b0, b1;
              if constexpr (kQuant) {
                const int8_t* kp = reinterpret_cast<const int8_t*>(sk + tok * srow) + kk * 16 + 2 * tig;
                b0 = ld_i8x2(kp);
                b1 = ld_i8x2(kp + 8);
              } else {
                const bf16* kp = reinterpret_cast<const bf16*>(sk + tok * srow) + kk * 16 + 2 * tig;
                b0 = ld32(kp);
                b1 = ld32(kp + 8);
              }
              mma16<bf16>(sacc[j], aq, b0, b1);
            }
          }
        }
        softmax_tile<kQuant, kMma && kQuant>(sacc, m, l, corr, vfe, p, t0, warp * 16, a, bnd, ksc, vsc, gid, tig);
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          o[j][0] *= corr[0];
          o[j][1] *= corr[0];
          o[j][2] *= corr[1];
          o[j][3] *= corr[1];
        }
        if constexpr (kQuant) __syncthreads();  // the widened V is complete
        uint32_t pa[4];
        pa[0] = pack2<VT>(sacc[0][0], sacc[0][1]);
        pa[1] = pack2<VT>(sacc[0][2], sacc[0][3]);
        pa[2] = pack2<VT>(sacc[1][0], sacc[1][1]);
        pa[3] = pack2<VT>(sacc[1][2], sacc[1][3]);
        const int vld = kQuant ? LD : srow / 2;
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          if (j * 8 < D) {
            uint32_t bv[4];
            load_bt(bv, Vt, vld, warp * 16, j * 8, lane);
            mma16<VT>(o[j], pa, bv[0], bv[1]);
            mma16<VT>(o[j + 1], pa, bv[2], bv[3]);
          }
        }
      } else {
        // f32 queries: both products on CUDA cores, same fragment layout
        const float* Qs = reinterpret_cast<const float*>(smem + p.off_q);
        float* Pw = reinterpret_cast<float*>(smem + p.off_p) + warp * kRows * 16;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = gid + 8 * (e >> 1);
            const int tok = warp * 16 + j * 8 + 2 * tig + (e & 1);
            if (row < n_rep) {
              const PT* kr = reinterpret_cast<const PT*>(sk + tok * srow);
              const float* qr = Qs + row * DMAX;
              float acc = 0.f;
              for (int d = 0; d < D; ++d) acc = fmaf(qr[d], to_f(kr[d]), acc);
              sacc[j][e] = acc;
            }
          }
        }
        softmax_tile<kQuant, kMma && kQuant>(sacc, m, l, corr, vfe, p, t0, warp * 16, a, bnd, ksc, vsc, gid, tig);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Pw[(gid + 8 * (e >> 1)) * 16 + j * 8 + 2 * tig + (e & 1)] = sacc[j][e];
        __syncwarp();
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          if (j * 8 < D) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = gid + 8 * (e >> 1);
              const int col = j * 8 + 2 * tig + (e & 1);
              float acc = o[j][e] * corr[e >> 1];
              for (int t = 0; t < 16; ++t) {
                const PT* vr = reinterpret_cast<const PT*>(sv + (warp * 16 + t) * srow);
                acc = fmaf(Pw[row * 16 + t], to_f(vr[col]), acc);
              }
              o[j][e] = acc;
            }
          }
        }
        __syncwarp();
      }
      __syncthreads();  // the buffer is free for the tile after next
      if (dbl) buf ^= 1;
    }

    // combine the 4 warps' (m, l, acc) into the split's partial: each
    // warp rescaled to the block's max, summed in warp order
    const int b = cur.b, g = cur.g, s = cur.s;
    const size_t sh = size_t(b) * p.hkv + g;  // (slot, kv head)
    float* wml = reinterpret_cast<float*>(smem + p.off_ml);  // [m|l][warp][row]
    if (tig == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wml[warp * kRows + gid + 8 * i] = m[i];
        wml[(kWarps + warp) * kRows + gid + 8 * i] = l[i];
      }
    }
    __syncthreads();
    float scl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mm = kNegInf;
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wml[w * kRows + gid + 8 * i]);
      // times 1 / vf (1 when no tile set it)
      scl[i] = m[i] > kNegInf / 2 ? expf(m[i] - mm) * pow2_bits(254 - vfe) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= scl[e >> 1];
    // warps in pairs, in a fixed order: ((w0 + w2) + (w1 + w3)); the two
    // [16, DMAX] f32 slots alias a region that is idle now (the buffer just
    // consumed, or the widened-V tile)
    float* comb = reinterpret_cast<float*>(
        p.comb_in_stage ? stage + (dbl ? buf ^ 1 : 0) * buf_bytes : smem + p.off_comb);
    // float2 per lane, rows padded by 8 floats: conflict-free; rows past
    // n_rep are padding and are skipped
    constexpr int CLD = DMAX + 8;
    const bool live0 = gid < n_rep, live1 = gid + 8 < n_rep;
    auto put = [&](float* slot) {
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        if (j * 8 < D) {
          float* d0 = slot + gid * CLD + j * 8 + 2 * tig;
          if (live0) *reinterpret_cast<float2*>(d0) = make_float2(o[j][0], o[j][1]);
          if (live1) *reinterpret_cast<float2*>(d0 + 8 * CLD) = make_float2(o[j][2], o[j][3]);
        }
      }
    };
    auto add = [&](const float* slot) {
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        if (j * 8 < D) {
          const float* d0 = slot + gid * CLD + j * 8 + 2 * tig;
          if (live0) {
            const float2 v = *reinterpret_cast<const float2*>(d0);
            o[j][0] += v.x;
            o[j][1] += v.y;
          }
          if (live1) {
            const float2 v = *reinterpret_cast<const float2*>(d0 + 8 * CLD);
            o[j][2] += v.x;
            o[j][3] += v.y;
          }
        }
      }
    };
    if (warp >= 2) put(comb + (warp - 2) * kRows * CLD);
    __syncthreads();
    if (warp < 2) add(comb + warp * kRows * CLD);
    __syncthreads();
    if (warp == 1) put(comb);
    __syncthreads();
    const size_t part = sh * p.n_splits + s;
    if (warp == 0) {
      add(comb);
      float* pacc = p.part_acc + part * n_rep * D;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        if (j * 8 < D) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = gid + 8 * i;
            if (row < n_rep)
              *reinterpret_cast<float2*>(pacc + row * D + j * 8 + 2 * tig) =
                  make_float2(o[j][2 * i], o[j][2 * i + 1]);
          }
        }
      }
    }
    if (tid < n_rep) {
      float mm = kNegInf;
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wml[w * kRows + tid]);
      float ll = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float mw = wml[w * kRows + tid];
        if (mw > kNegInf / 2) ll += wml[(kWarps + w) * kRows + tid] * expf(mw - mm);
      }
      float* pml = p.part_ml + part * 2 * n_rep;
      pml[tid] = mm;
      pml[n_rep + tid] = ll;
    }

    // arrive; the last of the (slot, kv head)'s live splits merges (a
    // single live split merges at once, without the counter)
    __threadfence();
    __syncthreads();
    const int n_live = cur.s1 - cur.s0;
    if (tid == 0) s_last = n_live == 1 || atomicAdd(p.counters + sh, 1) == n_live - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      finish<QT>(p, b, g, cur.s0, cur.s1, row_s);
      if (tid == 0 && n_live > 1) p.counters[sh] = 0;
    }
    __syncthreads();  // shared memory is free for the next item
    cur = nxt;
  }
  cp_async_wait<0>();
}

size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// shared-memory layout for `nbuf` staging buffers; returns the total bytes
template <typename QT, typename PT, int DMAX>
size_t layout(Params& p) {
  constexpr bool kMma = std::is_same<QT, bf16>::value;
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int LD = DMAX + 8;
  size_t off = 0;
  p.off_q = int(off);
  off += align16(size_t(kRows) * (kMma ? LD * 2 : DMAX * 4));
  p.off_stage = int(off);
  const size_t stage = size_t(p.nbuf) * 2 * kTK * p.srow;
  off += align16(stage);
  p.off_v16 = int(off);
  if (kMma && kQuant) off += align16(size_t(kTK) * LD * 2);
  p.off_sc = int(off);
  if (kQuant) off += align16(size_t(p.nbuf) * 2 * kTK * 4);
  p.off_p = int(off);
  if (!kMma) off += align16(size_t(kWarps) * kRows * 16 * 4);
  // the combine's two [16, DMAX] f32 slots: an idle staging buffer, else
  // the widened-V tile, else a region of their own
  const size_t comb = size_t(2) * kRows * (DMAX + 8) * 4;
  p.comb_in_stage = size_t(2) * kTK * p.srow >= comb;
  if (p.comb_in_stage) {
    p.off_comb = p.off_stage;
  } else if (kMma && kQuant && size_t(kTK) * LD * 2 >= comb) {
    p.off_comb = p.off_v16;
  } else {
    p.off_comb = int(off);
    off += align16(comb);
  }
  p.off_ml = int(off);
  off += 2 * kWarps * kRows * 4;
  p.off_slots = int(off);  // lo, hi, s0, s1 per slot, then B + 1 offsets
  off += align16(size_t(5 * p.batch + 1) * 4);
  return off;
}

template <typename QT, typename PT, int DMAX>
cudaError_t launch(Params p, int batch, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<QT, bf16>::value;
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  if ((p.d * int(sizeof(PT))) % kChunk != 0) return cudaErrorInvalidValue;
  // bf16 pool under mma: staged rows are the padded compute rows;
  // otherwise rows of D values + 16 bytes (bank spread)
  p.srow = (kMma && !kQuant) ? (DMAX + 8) * 2 : p.d * int(sizeof(PT)) + kChunk;
  p.batch = batch;
  p.nbuf = 2;
  size_t bytes = layout<QT, PT, DMAX>(p);
  if (bytes > kSmemMax) {
    p.nbuf = 1;
    bytes = layout<QT, PT, DMAX>(p);
  }
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = paged_decode_split_kernel<QT, PT, DMAX>;
  // one wave of persistent blocks: as many as the card holds at once
  // (computed once per device and shared-memory size; never from lens)
  static int cached_dev = -1, cached_blocks = 0;
  static size_t cached_bytes = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != cached_dev || bytes != cached_bytes) {
    if (bytes > kSmemDefault) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
      if (err != cudaSuccess) return err;
    }
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
    if (err != cudaSuccess) return err;
    cached_dev = dev;
    cached_bytes = bytes;
    cached_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  // at most n_splits items per (slot, kv head)
  const long total = long(p.n_splits) * p.hkv * batch;
  const int grid = int(total < cached_blocks ? total : cached_blocks);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename QT, typename PT>
cudaError_t launch_d(const Params& p, int batch, cudaStream_t stream) {
  if (p.d <= 64) return launch<QT, PT, 64>(p, batch, stream);
  if (p.d <= 128) return launch<QT, PT, 128>(p, batch, stream);
  return launch<QT, PT, kMaxD>(p, batch, stream);
}

}  // namespace

// C entry point, loaded with ctypes. Returns a cudaError_t (0 = launched).
// `workspace` holds B * Hkv * n_splits * n_rep * (D + 2) floats (split
// partials); `counters` B * Hkv int32 zeros, left zero by the launch.
extern "C" int paged_decode(int q_dtype, int pool_dtype, const void* q,
                            const void* k_self, const void* v_self,
                            const void* pool, const float* scales,
                            const int* table, const int* lens, void* out,
                            float* workspace, int* counters, int layer,
                            int batch, int hq, int hkv, int d, int n_pages,
                            int page, int width, int table_stride,
                            int split_pages, int n_splits, float scale,
                            float soft_cap, int window, void* stream) {
  if (batch == 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kRows || d % 8 != 0 ||
      d > kMaxD || page <= 0 || width <= 0 || split_pages <= 0 ||
      n_splits != (width + split_pages - 1) / split_pages ||
      (reinterpret_cast<uintptr_t>(pool) & 15) != 0 || workspace == nullptr ||
      counters == nullptr)
    return cudaErrorInvalidValue;
  if ((pool_dtype == kI8) != (scales != nullptr)) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_self = k_self;
  p.v_self = v_self;
  p.pool = pool;
  p.scales = scales;
  p.table = table;
  p.lens = lens;
  p.out = out;
  p.n_rep = hq / hkv;
  p.part_acc = workspace;
  p.part_ml = workspace + size_t(batch) * hkv * n_splits * p.n_rep * d;
  p.counters = counters;
  p.layer = layer;
  p.n_pages = n_pages;
  p.hq = hq;
  p.hkv = hkv;
  p.d = d;
  p.page = page;
  p.width = width;
  p.table_stride = table_stride;
  p.split_pages = split_pages;
  p.n_splits = n_splits;
  p.scale = scale;
  p.soft_cap = soft_cap;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == kF32 && pool_dtype == kF32) {
    err = launch_d<float, float>(p, batch, s);
  } else if (q_dtype == kBF16 && pool_dtype == kBF16) {
    err = launch_d<bf16, bf16>(p, batch, s);
  } else if (q_dtype == kBF16 && pool_dtype == kI8) {
    err = launch_d<bf16, int8_t>(p, batch, s);
  } else if (q_dtype == kF32 && pool_dtype == kI8) {
    err = launch_d<float, int8_t>(p, batch, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
