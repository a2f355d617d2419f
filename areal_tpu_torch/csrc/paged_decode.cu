// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` reached through
// `decode` in areal_tpu/ops/pallas/paged_attention.py. One new query
// token per slot attends to its KV pages read in place from the whole
// pool [L, P, 2, Hkv, page, D] (K and V interleaved per page, heads
// before tokens), addressed by a layer index, a page table [B, M] and
// the resident lengths lens [B] (which exclude the token itself). The
// token's own K/V arrive as separate operands and fold into the online
// softmax last, so the pool stays read-only during the layer loop.
//
// Bound. Per call the kernel must read sum_b lens_b * Hkv * D * 2 *
// itemsize bytes of K/V (plus 8 bytes of scales per token and head for
// the int8 pool) and does 4 * sum_b lens_b * Hq * D flops: about one
// flop per byte, far below the card's ~295 flop/byte ridge, so it is
// bound by memory bandwidth. At 64 slots, a mean of 1024 resident
// tokens, Hkv 2, D 128 and bf16 that is ~67 MB, ~20 us at 3.35 TB/s.
//
// Design (simple first version; not yet at its bound). One block of 512
// threads per (kv head, slot) holds the GQA group's n_rep query rows in
// shared memory as f32 and walks the slot's pages in order, one tile (a
// whole page unless shared memory is short) at a time. A block is alone
// on its SM, so it brings its own 16 warps to hide shared-memory and FMA
// latency: with 4 warps the page loop stalls on every dependent load.
//  - K and V tiles are staged in shared memory with 16-byte cp.async
//    copies along D, double-buffered: the next tile's copy is in flight
//    while this tile is computed. Rows are padded by 64 bytes so that the
//    QK reads below are free of bank conflicts.
//  - QK: four threads per token, each taking every fourth 16-byte chunk
//    of its K row against the broadcast query rows, combined with two
//    shuffles; the int8 K scale multiplies the score after the dot, then
//    soft cap, then the window mask.
//  - online softmax in f32 (max, sum, rescale), one warp per query row.
//  - PV: each thread owns (row, column pair) outputs and steps 4 tokens
//    at a time (4 probabilities as one float4, V as column pairs); the
//    int8 V scale rides on the probabilities.
// Pages past lens are never read; with a sliding window, tiles wholly
// before the window are not read either. int8 values widen only in
// registers. The design's critical path is the longest slot on one SM;
// the next design (a later change) is split-K flash-decoding across
// pages, with the GQA group packed into MMA rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 16;   // query heads per kv head
constexpr int kMaxD = 256;    // head dim
constexpr int kMaxPairs = kMaxRep * kMaxD / 2 / kThreads;  // PV pairs per thread
constexpr int kChunk = 16;    // bytes per staged copy / per K read
constexpr int kTPT = 4;       // threads per token in QK
constexpr int kPad = kChunk * kTPT;  // shared row padding (bank spread)
// finite masking sentinel shared with the JAX reference: a fully masked
// row keeps a finite max, and the rescale guard (m > kNegInf / 2) keeps
// exp() away from inf - inf
constexpr float kNegInf = -2.3819763e38f;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Params {
  const void* q;        // [B, Hq, D]
  const void* k_self;   // [B, Hkv, D]
  const void* v_self;   // [B, Hkv, D]
  const void* pool;     // [L, P, 2, Hkv, page, D], 16-byte aligned
  const float* scales;  // [L, P, 2, Hkv, page] (int8 pool only)
  const int* table;     // [B, >= width], row stride table_stride
  const int* lens;      // [B]
  void* out;            // [B, Hq, D]
  int layer, n_pages, hq, hkv, d, page, width, table_stride, n_rep, tile;
  int sstride;            // score row stride: tile rounded up to 4
  float scale, soft_cap;  // soft_cap <= 0: none
  int window;             // <= 0: none
  int row_bytes;          // padded shared-memory row: D * itemsize + kPad
  // byte offsets of the shared-memory regions (computed on the host)
  int off_kv, off_q, off_s, off_sc, off_row;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of PT widened to floats
template <typename PT>
struct Chunk {
  static constexpr int n = kChunk / sizeof(PT);
  float v[n];
  __device__ __forceinline__ void load(const unsigned char* p) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const PT* e = reinterpret_cast<const PT*>(&raw);
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] = to_f(e[i]);
  }
};

// two neighbouring PT values widened to floats
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// query position sits at `len`; a window keeps kpos > len - window
__device__ __forceinline__ bool visible(int kpos, int len, int window) {
  return window <= 0 || kpos > len - window;
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const Params p) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int kE = Chunk<PT>::n;  // elements per 16-byte chunk
  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // slot
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = p.d;
  const int n_rep = p.n_rep;
  const int tile = p.tile;
  const int ss = p.sstride;
  const int rb = p.row_bytes;
  const int cpr = D * int(sizeof(PT)) / kChunk;  // chunks per row

  extern __shared__ __align__(16) unsigned char smem[];
  // [2 buffers][K | V][tile rows of rb bytes]
  unsigned char* kv_s = smem + p.off_kv;
  float* q_s = reinterpret_cast<float*>(smem + p.off_q);    // [n_rep, D]
  float* s_s = reinterpret_cast<float*>(smem + p.off_s);    // [n_rep, ss]
  float* sc_s = reinterpret_cast<float*>(smem + p.off_sc);  // [2][K|V][tile]
  float* m_s = reinterpret_cast<float*>(smem + p.off_row);  // [kMaxRep]
  float* l_s = m_s + kMaxRep;
  float* c_s = l_s + kMaxRep;
  float* self_s = c_s + kMaxRep;

  const int len = p.lens[b];
  const int head0 = g * n_rep;
  const QT* qb = static_cast<const QT*>(p.q) + (size_t(b) * p.hq + head0) * D;
  for (int i = tid; i < n_rep * D; i += kThreads) q_s[i] = to_f(qb[i]);
  if (tid < kMaxRep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // this thread's output pairs e = tid + k * kThreads (k < nk): row
  // o_row[k], columns o_col[k] and o_col[k] + 1
  const int half = D / 2;
  const int n_pairs = n_rep * half;
  const int nk = tid < n_pairs ? (n_pairs - 1 - tid) / kThreads + 1 : 0;
  int o_row[kMaxPairs], o_col[kMaxPairs];
  float acc0[kMaxPairs], acc1[kMaxPairs];
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    const int e = tid + k * kThreads;
    o_row[k] = k < nk ? e / half : 0;
    o_col[k] = k < nk ? 2 * (e - o_row[k] * half) : 0;
    acc0[k] = 0.f;
    acc1[k] = 0.f;
  }

  // positions the table can address; a window also skips whole tiles
  // before its first visible position
  const int resident = min(len, p.width * p.page);
  const int lo = p.window > 0 ? max(0, len - p.window + 1) : 0;
  const int t_begin = (lo / tile) * tile;
  const int n_tiles = t_begin < resident ? (resident - t_begin + tile - 1) / tile : 0;
  const int* trow = p.table + size_t(b) * p.table_stride;
  const size_t stripe = size_t(p.page) * D;  // one [page, D] head stripe
  const PT* pool = static_cast<const PT*>(p.pool);

  // start the copies of tile `t0` into buffer `buf`
  auto issue = [&](int t0, int buf) {
    const int pg = t0 / p.page;
    const int off = t0 - pg * p.page;
    const int n = min(tile, resident - t0);
    const size_t head = (size_t(p.layer) * p.n_pages + trow[pg]) * 2 * p.hkv + g;
    const unsigned char* src_k = reinterpret_cast<const unsigned char*>(
        pool + head * stripe + size_t(off) * D);
    const unsigned char* src_v = reinterpret_cast<const unsigned char*>(
        pool + (head + p.hkv) * stripe + size_t(off) * D);
    unsigned char* dst_k = kv_s + size_t(buf) * 2 * tile * rb;
    unsigned char* dst_v = dst_k + size_t(tile) * rb;
    const int src_rb = D * int(sizeof(PT));
    for (int i = tid; i < n * cpr; i += kThreads) {
      const int row = i / cpr;
      const int c = i - row * cpr;
      cp_async16(dst_k + row * rb + c * kChunk, src_k + row * src_rb + c * kChunk);
      cp_async16(dst_v + row * rb + c * kChunk, src_v + row * src_rb + c * kChunk);
    }
    if (kQuant) {
      const float* ks = p.scales + head * p.page + off;
      const float* vs = p.scales + (head + p.hkv) * p.page + off;
      float* dst = sc_s + buf * 2 * tile;
      for (int i = tid; i < n; i += kThreads) {
        cp_async4(dst + i, ks + i);
        cp_async4(dst + tile + i, vs + i);
      }
    }
  };

  if (n_tiles > 0) issue(t_begin, 0);
  cp_async_commit();

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * tile;
    const int buf = it & 1;
    const int n = min(tile, resident - t0);
    if (it + 1 < n_tiles) issue(t0 + tile, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed
    __syncthreads();
    const unsigned char* k_s = kv_s + size_t(buf) * 2 * tile * rb;
    const unsigned char* v_s = k_s + size_t(tile) * rb;
    const float* ksc = sc_s + buf * 2 * tile;
    const float* vsc = ksc + tile;

    // scores: kTPT threads per token (consecutive lanes), each taking
    // every kTPT-th 16-byte chunk of the K row; every lane joins the
    // shuffles, live or not
    const int sub = tid % kTPT;
    for (int t_base = 0; t_base < n; t_base += kThreads / kTPT) {
      const int t = t_base + tid / kTPT;
      const bool live = t < n;
      float part[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) part[r] = 0.f;
      if (live) {
        const unsigned char* krow = k_s + t * rb;
        for (int c = sub; c < cpr; c += kTPT) {
          Chunk<PT> kc;
          kc.load(krow + c * kChunk);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < n_rep) {
              const float* qr = q_s + r * D + c * kE;
              float a = part[r];
#pragma unroll
              for (int e = 0; e < kE; e += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qr + e);
                a = fmaf(qv.x, kc.v[e], a);
                a = fmaf(qv.y, kc.v[e + 1], a);
                a = fmaf(qv.z, kc.v[e + 2], a);
                a = fmaf(qv.w, kc.v[e + 3], a);
              }
              part[r] = a;
            }
          }
        }
      }
      const bool vis = visible(t0 + t, len, p.window);
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < n_rep) {
          float dot = part[r];
#pragma unroll
          for (int o = 1; o < kTPT; o <<= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (live && sub == 0) {
            float sc = dot * p.scale;
            if (kQuant) sc *= ksc[t];
            if (p.soft_cap > 0.f) sc = p.soft_cap * tanhf(sc / p.soft_cap);
            s_s[r * ss + t] = vis ? sc : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per query row; probabilities overwrite the
    // scores (times the V scale for the int8 pool)
    for (int r = warp; r < n_rep; r += kWarps) {
      float* row = s_s + r * ss;
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev > kNegInf / 2 ? m_prev - m_new : 0.f);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float pr =
            visible(t0 + t, len, p.window) ? expf(row[t] - m_new) : 0.f;
        sum += pr;
        row[t] = kQuant ? pr * vsc[t] : pr;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = corr * l_s[r] + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // P.V over this thread's output pairs, 4 tokens per step
#pragma unroll
    for (int k = 0; k < kMaxPairs; ++k) {
      if (k < nk) {
        const float corr = c_s[o_row[k]];
        acc0[k] *= corr;
        acc1[k] *= corr;
      }
    }
    int t = 0;
    for (; t + 4 <= n; t += 4) {
      const PT* v0 = reinterpret_cast<const PT*>(v_s + t * rb);
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) {
        if (k < nk) {
          const float4 pw = *reinterpret_cast<const float4*>(s_s + o_row[k] * ss + t);
          const PT* vc = v0 + o_col[k];
          const float2 va = load_pair(vc);
          const float2 vb = load_pair(reinterpret_cast<const PT*>(
              reinterpret_cast<const unsigned char*>(vc) + rb));
          const float2 vc2 = load_pair(reinterpret_cast<const PT*>(
              reinterpret_cast<const unsigned char*>(vc) + 2 * rb));
          const float2 vd = load_pair(reinterpret_cast<const PT*>(
              reinterpret_cast<const unsigned char*>(vc) + 3 * rb));
          acc0[k] = fmaf(pw.x, va.x, acc0[k]);
          acc1[k] = fmaf(pw.x, va.y, acc1[k]);
          acc0[k] = fmaf(pw.y, vb.x, acc0[k]);
          acc1[k] = fmaf(pw.y, vb.y, acc1[k]);
          acc0[k] = fmaf(pw.z, vc2.x, acc0[k]);
          acc1[k] = fmaf(pw.z, vc2.y, acc1[k]);
          acc0[k] = fmaf(pw.w, vd.x, acc0[k]);
          acc1[k] = fmaf(pw.w, vd.y, acc1[k]);
        }
      }
    }
    for (; t < n; ++t) {
      const PT* v0 = reinterpret_cast<const PT*>(v_s + t * rb);
#pragma unroll
      for (int k = 0; k < kMaxPairs; ++k) {
        if (k < nk) {
          const float pw = s_s[o_row[k] * ss + t];
          const float2 va = load_pair(v0 + o_col[k]);
          acc0[k] = fmaf(pw, va.x, acc0[k]);
          acc1[k] = fmaf(pw, va.y, acc1[k]);
        }
      }
    }
    __syncthreads();  // the buffer is free for the tile after next
  }

  // fold in the token itself: always attended, never masked or scaled
  const QT* ksb = static_cast<const QT*>(p.k_self) + (size_t(b) * p.hkv + g) * D;
  const QT* vsb = static_cast<const QT*>(p.v_self) + (size_t(b) * p.hkv + g) * D;
  for (int r = warp; r < n_rep; r += kWarps) {
    float part = 0.f;
    for (int d = lane; d < D; d += 32) part += q_s[r * D + d] * to_f(ksb[d]);
    float sc = warp_sum(part) * p.scale;
    if (p.soft_cap > 0.f) sc = p.soft_cap * tanhf(sc / p.soft_cap);
    if (lane == 0) self_s[r] = sc;
  }
  __syncthreads();

  QT* ob = static_cast<QT*>(p.out) + (size_t(b) * p.hq + head0) * D;
#pragma unroll
  for (int k = 0; k < kMaxPairs; ++k) {
    if (k < nk) {
      const int r = o_row[k];
      const int d = o_col[k];
      const float m_prev = m_s[r];
      const float s_self = self_s[r];
      const float m_new = fmaxf(m_prev, s_self);
      const float corr = expf(m_prev > kNegInf / 2 ? m_prev - m_new : 0.f);
      const float p_self = expf(s_self - m_new);
      const float l = corr * l_s[r] + p_self;
      const float a0 = acc0[k] * corr + p_self * to_f(vsb[d]);
      const float a1 = acc1[k] * corr + p_self * to_f(vsb[d + 1]);
      ob[r * D + d] = from_f<QT>(a0 / l);
      ob[r * D + d + 1] = from_f<QT>(a1 / l);
    }
  }
}

size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// shared-memory layout for one tile size; returns the total bytes
size_t layout(Params& p) {
  size_t off = 0;
  p.off_kv = int(off);
  off += align16(size_t(2) * 2 * p.tile * p.row_bytes);
  p.off_q = int(off);
  off += align16(size_t(p.n_rep) * p.d * 4);
  p.sstride = (p.tile + 3) & ~3;
  p.off_s = int(off);
  off += align16(size_t(p.n_rep) * p.sstride * 4);
  p.off_sc = int(off);
  off += align16(size_t(2) * 2 * p.tile * 4);
  p.off_row = int(off);
  off += 4 * kMaxRep * 4;
  return off;
}

template <typename QT, typename PT>
cudaError_t launch(Params p, int batch, cudaStream_t stream) {
  if ((p.d * int(sizeof(PT))) % kChunk != 0) return cudaErrorInvalidValue;
  p.row_bytes = p.d * int(sizeof(PT)) + kPad;
  // the whole page per tile unless that overflows shared memory; halving
  // keeps the tile a divisor of the page
  size_t bytes = layout(p);
  while (bytes > kSmemMax && p.tile % 2 == 0 && p.tile > 8) {
    p.tile /= 2;
    bytes = layout(p);
  }
  if (bytes > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<QT, PT>;
  if (bytes > kSmemDefault) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(p.hkv, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. Returns a cudaError_t (0 = launched).
extern "C" int paged_decode(int q_dtype, int pool_dtype, const void* q,
                            const void* k_self, const void* v_self,
                            const void* pool, const float* scales,
                            const int* table, const int* lens, void* out,
                            int layer, int batch, int hq, int hkv, int d,
                            int n_pages, int page, int width, int table_stride,
                            float scale, float soft_cap, int window,
                            void* stream) {
  if (batch == 0) return cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxRep || d % 8 != 0 ||
      d > kMaxD || page <= 0 || width <= 0 ||
      (reinterpret_cast<uintptr_t>(pool) & 15) != 0)
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
  p.layer = layer;
  p.n_pages = n_pages;
  p.hq = hq;
  p.hkv = hkv;
  p.d = d;
  p.page = page;
  p.width = width;
  p.table_stride = table_stride;
  p.n_rep = hq / hkv;
  p.tile = page;
  p.scale = scale;
  p.soft_cap = soft_cap;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == kF32 && pool_dtype == kF32) {
    err = launch<float, float>(p, batch, s);
  } else if (q_dtype == kBF16 && pool_dtype == kBF16) {
    err = launch<__nv_bfloat16, __nv_bfloat16>(p, batch, s);
  } else if (q_dtype == kBF16 && pool_dtype == kI8) {
    err = launch<__nv_bfloat16, int8_t>(p, batch, s);
  } else if (q_dtype == kF32 && pool_dtype == kI8) {
    err = launch<float, int8_t>(p, batch, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
