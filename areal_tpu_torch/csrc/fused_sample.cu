// Fused LM-head + sampling epilogue for Hopper (sm_90a).
//
// Replaces the TPU kernel areal_tpu/ops/pallas/fused_sample.py::
// fused_sample_pallas (body _kernel). Per row of x [R, E] it computes, over
// the head W [E, V], without ever writing the [R, V] logits:
//   logits = x @ W in f32 (optionally soft-capped), warped = logits / max(t,
//   1e-6); norm = logsumexp(warped); argmax = first maximum of the raw
//   logits; a Gumbel-top-1 sample over warped + G, one excluded token masked
//   out of that argmax only; the warped logit of one gathered token.
// G comes from a counter hash of (seed, row, column) (the murmur3 finalizer
// in uint32), bit for bit the stream of the TPU kernel and of the plain
// PyTorch version (ops/fused_sample.py::fused_sample_plain).
//
// What bounds it on this card: bytes. The work is one read of W (E * V
// elements); at R = 32 the product is ~32 flops per byte of bf16 W, far
// under the tensor cores' ~295 but about all the CUDA cores sustain (7.5 G
// FMAs at the serving shape cannot take less than ~0.26 ms there, against
// 0.14 ms for the bytes). So the serving layout (bf16, V contiguous) runs
// the product on the tensor cores and streams W through shared memory;
// every other layout runs it on CUDA cores.
//
// Design. The TPU kernel walks the vocabulary in a sequential grid and
// carries eight scratch rows from block to block. Here blocks run in
// parallel and share nothing, so the work is two passes:
//   pass 1, one block per (vocab tile, tile of 32 rows), row tiles of one
//     vocab tile next to each other so that the second finds W in L2. The
//     block computes its [32, tile] logits in f32, passes them through
//     shared memory to one warp per row, which folds soft cap, validity
//     (col < V), temperature, hash and the running reductions and writes
//     ONE partial record per (tile, row). Two versions of the product:
//     - tensor cores (bf16, V contiguous, E and V multiples of 8): tiles of
//       128 columns, 4 warps of 32 columns each; W and x move to shared
//       memory in chunks of 64 E steps by 16-byte cp.async copies, four
//       stages deep, so ~50 KB per block are in flight while mma.sync
//       m16n8k16 (f32 accumulation) consumes the oldest stage, W read
//       transposed by ldmatrix;
//     - CUDA cores (f32, E contiguous, odd sizes): tiles of 256 columns; x
//       staged as f32, 128 E steps at a time; each of 128 threads owns two
//       columns and keeps 32 x 2 f32 sums in registers, reading x as
//       broadcast float4 (8 FMAs per shared-memory load) and W straight
//       from global memory, coalesced across the warp, one group of four E
//       steps prefetched ahead.
//   pass 2, one warp per row: merges the partials with the online-softmax
//     rescale and (value, lower column first) comparisons, then emits
//     tokens, logprobs, argmax, gathered logprob and norm.
// No float atomics anywhere: the result does not depend on block order, and
// ties resolve to the lowest column, as a first-max argmax over the whole
// vocabulary does.
//
// The head may be [E, V] with V contiguous (an untied head) or with E
// contiguous (tied embeddings hand over embed.T); the wrapper passes the
// leading stride and which of the two it is. The head is never copied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kThreads = 128;             // threads per pass-1 block
constexpr int kCols = 2;                  // columns per thread
constexpr int kTileV = kThreads * kCols;  // 256 columns per block
constexpr int kRT = 32;                   // rows per block (register tile)
constexpr int kEK = 128;                  // E chunk staged in shared memory
constexpr int kPF = 6;                    // floats per partial record
constexpr int kPI = 2;                    // ints per partial record

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// uniform in (0, 1] from the counter hash of (seed, row, column)
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t row,
                                              uint32_t col) {
  uint32_t h = (col * 0x9E3779B9u) ^ (row * 0x85EBCA6Bu) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (__uint2float_rn(h >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

// Four consecutive E steps of one column of W, as raw elements.
template <typename WT>
struct Group4 {
  WT v[4];
};

// V contiguous: element (e, col) at w[e * ld + col]; scalar loads, the warp's
// 32 lanes on 32 neighbouring columns.
template <typename WT>
__device__ __forceinline__ Group4<WT> load_vc(const WT* __restrict__ w,
                                              int64_t ld, int e, int E,
                                              int col) {
  Group4<WT> g;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int ee = min(e + k, E - 1);  // past E: x is 0 there, any finite W does
    g.v[k] = w[(int64_t)ee * ld + col];
  }
  return g;
}

// E contiguous: element (e, col) at w[col * ld + e]; one vector load of four
// elements (the wrapper checks E % 4 == 0, ld % 4 == 0 and the alignment).
__device__ __forceinline__ Group4<float> load_ec(const float* __restrict__ w,
                                                 int64_t ld, int e, int E,
                                                 int col) {
  int ee = min(e, E - 4);
  float4 t = *reinterpret_cast<const float4*>(w + (int64_t)col * ld + ee);
  Group4<float> g;
  g.v[0] = t.x; g.v[1] = t.y; g.v[2] = t.z; g.v[3] = t.w;
  return g;
}
__device__ __forceinline__ Group4<__nv_bfloat16> load_ec(
    const __nv_bfloat16* __restrict__ w, int64_t ld, int e, int E, int col) {
  int ee = min(e, E - 4);
  uint2 t = *reinterpret_cast<const uint2*>(w + (int64_t)col * ld + ee);
  Group4<__nv_bfloat16> g;
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&t.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&t.y);
  g.v[0] = a.x; g.v[1] = a.y; g.v[2] = b.x; g.v[3] = b.y;
  return g;
}

template <typename WT, bool VC>
__device__ __forceinline__ Group4<WT> load_group(const WT* __restrict__ w,
                                                 int64_t ld, int e, int E,
                                                 int col) {
  if constexpr (VC) {
    return load_vc<WT>(w, ld, e, E, col);
  } else {
    return load_ec(w, ld, e, E, col);
  }
}

// (value, column) pairs ordered by larger value, then lower column.
__device__ __forceinline__ bool beats(float v, int i, float ov, int oi) {
  return v > ov || (v == ov && i < oi);
}

// The reductions of one logits tile lt [kRT][TV] (soft cap applied) in
// shared memory: one warp per row folds temperature, validity, the hash and
// the running maxima over the tile's columns and writes the (tile, row)
// partial record. Called by every thread of the block.
template <int TV>
__device__ __forceinline__ void tile_reduce(
    const float* smem, int tile, int row0,
    const float* __restrict__ temperature, const int* __restrict__ exclude,
    const int* __restrict__ gather_ids, const int* __restrict__ seed_ptr,
    int R, int V, float* __restrict__ part_f, int* __restrict__ part_i) {
  const int tid = threadIdx.x;
  const int tile0 = tile * TV;
  const int warp = tid / 32, lane = tid % 32;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  for (int r = warp; r < kRT; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= R) break;
    const float t = fmaxf(temperature[row], 1e-6f);
    const int excl = exclude ? exclude[row] : -1;
    const int gid = gather_ids ? gather_ids[row] : -1;
    float m = kNegInf, amv = kNegInf, gp = kNegInf, gw = 0.0f, gat = kNegInf;
    int ami = 0, gi = 0;
    // each lane walks its columns in increasing order: strictly-greater
    // updates keep the lowest column among equals
    for (int i = 0; i < TV / 32; ++i) {
      const int cc = lane + 32 * i;
      const int c = tile0 + cc;
      if (c >= V) break;
      const float logit = smem[r * TV + cc];
      const float warped = logit / t;
      m = fmaxf(m, warped);
      if (logit > amv) { amv = logit; ami = c; }
      // u reaches exactly 1 once in 2^24 draws (its top value rounds up in
      // f32), where -log(-log(u)) is +inf; one ulp below 1 caps the noise
      // at 16.6, as the plain version does (U_MAX)
      const float u = fminf(hash_uniform(seed, (uint32_t)row, (uint32_t)c),
                            0.99999994f);
      float pert = warped - logf(-logf(u));
      if (c == excl) pert = kNegInf;
      if (pert > gp) { gp = pert; gw = warped; gi = c; }
      if (c == gid) gat = warped;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float l = 0.0f;
    for (int i = 0; i < TV / 32; ++i) {
      const int cc = lane + 32 * i;
      if (tile0 + cc >= V) break;
      l += expf(smem[r * TV + cc] / t - m);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, off);
      float ov = __shfl_xor_sync(0xffffffffu, amv, off);
      int oi = __shfl_xor_sync(0xffffffffu, ami, off);
      if (beats(ov, oi, amv, ami)) { amv = ov; ami = oi; }
      float op = __shfl_xor_sync(0xffffffffu, gp, off);
      float ow = __shfl_xor_sync(0xffffffffu, gw, off);
      int og = __shfl_xor_sync(0xffffffffu, gi, off);
      if (beats(op, og, gp, gi)) { gp = op; gw = ow; gi = og; }
      gat = fmaxf(gat, __shfl_xor_sync(0xffffffffu, gat, off));
    }
    if (lane == 0) {
      float* pf = part_f + ((int64_t)tile * R + row) * kPF;
      int* pi = part_i + ((int64_t)tile * R + row) * kPI;
      pf[0] = m; pf[1] = l; pf[2] = amv; pf[3] = gp; pf[4] = gw; pf[5] = gat;
      pi[0] = ami; pi[1] = gi;
    }
  }
}

template <typename WT, bool VC>
__global__ void __launch_bounds__(kThreads, 4)
fused_sample_partial_kernel(
    const WT* __restrict__ x, int64_t x_ld, const WT* __restrict__ w,
    int64_t w_ld, const float* __restrict__ temperature,
    const int* __restrict__ exclude, const int* __restrict__ gather_ids,
    const int* __restrict__ seed_ptr, float soft_cap, int R, int E, int V,
    float* __restrict__ part_f, int* __restrict__ part_i) {
  // x chunk [kRT][kEK] f32 during the product, then the logits tile
  // [kRT][kTileV] f32 for the reductions
  __shared__ __align__(16) float smem[kRT * kTileV];
  const int tid = threadIdx.x;
  const int n_row_tiles = (R + kRT - 1) / kRT;
  const int tile = blockIdx.x / n_row_tiles;
  const int tile0 = tile * kTileV;
  const int row0 = (blockIdx.x % n_row_tiles) * kRT;

  int col[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    // past V: compute on the last real column, masked in the reductions
    col[c] = min(tile0 + tid + c * kThreads, V - 1);
  }

  float acc[kRT][kCols];
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  const float4* xs4 = reinterpret_cast<const float4*>(smem);
  for (int e0 = 0; e0 < E; e0 += kEK) {
    __syncthreads();
    for (int i = tid; i < kRT * kEK; i += kThreads) {
      int r = i / kEK, ek = i % kEK;
      int row = row0 + r, e = e0 + ek;
      smem[i] = (row < R && e < E) ? to_f32(x[(int64_t)row * x_ld + e]) : 0.0f;
    }
    __syncthreads();
    Group4<WT> nxt[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      nxt[c] = load_group<WT, VC>(w, w_ld, e0, E, col[c]);
    }
    const int groups = min(kEK, E - e0 + 3) / 4;
    for (int g = 0; g < groups; ++g) {
      float wv[kCols][4];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int k = 0; k < 4; ++k) wv[c][k] = to_f32(nxt[c].v[k]);
      }
      if (g + 1 < groups) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          nxt[c] = load_group<WT, VC>(w, w_ld, e0 + 4 * (g + 1), E, col[c]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        float4 xv = xs4[r * (kEK / 4) + g];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float a = acc[r][c];
          a = fmaf(xv.x, wv[c][0], a);
          a = fmaf(xv.y, wv[c][1], a);
          a = fmaf(xv.z, wv[c][2], a);
          a = fmaf(xv.w, wv[c][3], a);
          acc[r][c] = a;
        }
      }
    }
  }

  // the tile's logits (soft cap applied) through shared memory
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float v = acc[r][c];
      if (soft_cap > 0.0f) v = tanhf(v / soft_cap) * soft_cap;
      smem[r * kTileV + tid + c * kThreads] = v;
    }
  }
  __syncthreads();

  tile_reduce<kTileV>(smem, tile, row0, temperature, exclude, gather_ids,
                      seed_ptr, R, V, part_f, part_i);
}

// --------------------------------------------------------------------------
// pass 1 on the tensor cores (bf16, V contiguous)
// --------------------------------------------------------------------------
//
// Fragment layout of mma.sync m16n8k16 (bf16 in, f32 out), per lane with
// gid = lane / 4 and tig = lane % 4:
//   A (16 x 16, rows x k): a0 = (gid, 2tig..2tig+1), a1 = (gid+8, same),
//                          a2 = (gid, 2tig+8..+9),   a3 = (gid+8, same)
//   B (16 x 8, k x cols):  b0 = (2tig..2tig+1, gid), b1 = (2tig+8..+9, gid)
//   C (16 x 8, f32):       c0, c1 = (gid, 2tig..+1), c2, c3 = (gid+8, same)

using bf16 = __nv_bfloat16;
constexpr int kTcTileV = 128;             // columns per block, 32 per warp
constexpr int kTcKC = 64;                 // E steps per stage
constexpr int kTcStages = 4;
constexpr int kTcWLd = kTcTileV + 8;      // padded rows: no bank conflicts
constexpr int kTcXLd = kTcKC + 8;
constexpr int kTcWTile = kTcKC * kTcWLd;  // bf16 elements of a stage's W
constexpr int kTcXTile = kRT * kTcXLd;
constexpr int kTcStage = kTcWTile + kTcXTile;
constexpr int kTcSmemBytes = kTcStages * kTcStage * (int)sizeof(bf16);
static_assert(kTcSmemBytes >= kRT * kTcTileV * (int)sizeof(float),
              "the logits tile reuses the stages' memory");

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16) of a row-major
// bf16 tile with row stride ld
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int ld,
                                       int r0, int c0, int gid, int tig) {
  const bf16* p = t + (r0 + gid) * ld + c0 + 2 * tig;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of one stage: W rows [e0, e0 + kTcKC) x the tile's
// columns, and x rows [row0, row0 + kRT) x the same E steps, in 16-byte
// chunks of 8 elements. E, V and both strides are multiples of 8, so a
// chunk lies wholly inside or wholly outside; outside chunks are zeroed.
__device__ __forceinline__ void tc_stage(bf16* stage, const bf16* __restrict__ x,
                                         int64_t x_ld,
                                         const bf16* __restrict__ w,
                                         int64_t w_ld, int e0, int R, int E,
                                         int V, int row0, int tile0) {
  bf16* ws = stage;
  bf16* xs = stage + kTcWTile;
  constexpr int kWChunks = kTcTileV / 8;
  for (int i = threadIdx.x; i < kTcKC * kWChunks; i += kThreads) {
    const int k = i / kWChunks, c8 = (i % kWChunks) * 8;
    const int e = e0 + k, col = tile0 + c8;
    bf16* dst = ws + k * kTcWLd + c8;
    if (e < E && col < V) {
      cp_async16(dst, w + (int64_t)e * w_ld + col);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  constexpr int kXChunks = kTcKC / 8;
  for (int i = threadIdx.x; i < kRT * kXChunks; i += kThreads) {
    const int r = i / kXChunks, c8 = (i % kXChunks) * 8;
    const int row = row0 + r, e = e0 + c8;
    bf16* dst = xs + r * kTcXLd + c8;
    if (row < R && e < E) {
      cp_async16(dst, x + (int64_t)row * x_ld + e);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
fused_sample_partial_tc_kernel(
    const bf16* __restrict__ x, int64_t x_ld, const bf16* __restrict__ w,
    int64_t w_ld, const float* __restrict__ temperature,
    const int* __restrict__ exclude, const int* __restrict__ gather_ids,
    const int* __restrict__ seed_ptr, float soft_cap, int R, int E, int V,
    float* __restrict__ part_f, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* stages = reinterpret_cast<bf16*>(tc_smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int n_row_tiles = (R + kRT - 1) / kRT;
  const int tile = blockIdx.x / n_row_tiles;
  const int tile0 = tile * kTcTileV;
  const int row0 = (blockIdx.x % n_row_tiles) * kRT;

  // acc[mt][nt]: rows mt*16 + (gid, gid+8), columns warp*32 + nt*8 + 2tig..
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    }
  }

  const int n_chunks = (E + kTcKC - 1) / kTcKC;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < n_chunks) {
      tc_stage(stages + s * kTcStage, x, x_ld, w, w_ld, s * kTcKC, R, E, V,
               row0, tile0);
    }
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    // chunk c has landed (all but the newest kTcStages - 2 groups are done),
    // and every warp is past chunk c - 1, whose stage is refilled next
    cp_async_wait<kTcStages - 2>();
    __syncthreads();
    const int nxt = c + kTcStages - 1;
    if (nxt < n_chunks) {
      tc_stage(stages + (nxt % kTcStages) * kTcStage, x, x_ld, w, w_ld,
               nxt * kTcKC, R, E, V, row0, tile0);
    }
    cp_async_commit();
    const bf16* ws = stages + (c % kTcStages) * kTcStage;
    const bf16* xs = ws + kTcWTile;
#pragma unroll
    for (int k0 = 0; k0 < kTcKC; k0 += 16) {
      uint32_t a[2][4];
      load_a(a[0], xs, kTcXLd, 0, k0, gid, tig);
      load_a(a[1], xs, kTcXLd, 16, k0, gid, tig);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        load_bt(b, ws, kTcWLd, k0, warp * 32 + np * 16, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // the tile's logits (soft cap applied) through shared memory
  cp_async_wait<0>();
  __syncthreads();
  float* lt = reinterpret_cast<float*>(tc_smem);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = acc[mt][nt][i];
        if (soft_cap > 0.0f) v = tanhf(v / soft_cap) * soft_cap;
        const int r = mt * 16 + gid + (i / 2) * 8;
        const int cc = warp * 32 + nt * 8 + 2 * tig + (i % 2);
        lt[r * kTcTileV + cc] = v;
      }
    }
  }
  __syncthreads();
  tile_reduce<kTcTileV>(lt, tile, row0, temperature, exclude, gather_ids,
                        seed_ptr, R, V, part_f, part_i);
}

// One warp per row: merge the tiles' partial records and emit.
__global__ void __launch_bounds__(32)
fused_sample_merge_kernel(
    const float* __restrict__ part_f, const int* __restrict__ part_i,
    const float* __restrict__ temperature,
    const unsigned char* __restrict__ greedy, int R, int n_tiles,
    int* __restrict__ tokens, float* __restrict__ logprobs,
    int* __restrict__ argmax, float* __restrict__ gathered,
    float* __restrict__ norm_out) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  float m = kNegInf, l = 0.0f, amv = kNegInf, gp = kNegInf, gw = 0.0f;
  float gat = kNegInf;
  int ami = 0, gi = 0;
  for (int tile = lane; tile < n_tiles; tile += 32) {
    const float* pf = part_f + ((int64_t)tile * R + row) * kPF;
    const int* pi = part_i + ((int64_t)tile * R + row) * kPI;
    const float mt = pf[0];
    const float mn = fmaxf(m, mt);
    l = l * expf(m - mn) + pf[1] * expf(mt - mn);
    m = mn;
    if (beats(pf[2], pi[0], amv, ami)) { amv = pf[2]; ami = pi[0]; }
    if (beats(pf[3], pi[1], gp, gi)) { gp = pf[3]; gw = pf[4]; gi = pi[1]; }
    gat = fmaxf(gat, pf[5]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, off);
    const float ol = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, om);
    // both lanes of a pair add the same two terms: the smaller-max term
    // second, so the pair agrees bit for bit
    const float a = (m >= om) ? l * expf(m - mn) : ol * expf(om - mn);
    const float b = (m >= om) ? ol * expf(om - mn) : l * expf(m - mn);
    l = a + b;
    m = mn;
    float ov = __shfl_xor_sync(0xffffffffu, amv, off);
    int oi = __shfl_xor_sync(0xffffffffu, ami, off);
    if (beats(ov, oi, amv, ami)) { amv = ov; ami = oi; }
    float op = __shfl_xor_sync(0xffffffffu, gp, off);
    float ow = __shfl_xor_sync(0xffffffffu, gw, off);
    int og = __shfl_xor_sync(0xffffffffu, gi, off);
    if (beats(op, og, gp, gi)) { gp = op; gw = ow; gi = og; }
    gat = fmaxf(gat, __shfl_xor_sync(0xffffffffu, gat, off));
  }
  if (lane == 0) {
    const float t = fmaxf(temperature[row], 1e-6f);
    const float norm = m + logf(l);
    const bool g = greedy[row] != 0;
    tokens[row] = g ? ami : gi;
    logprobs[row] = g ? amv / t - norm : gw - norm;
    argmax[row] = ami;
    gathered[row] = gat - norm;
    norm_out[row] = norm;
  }
}

template <typename WT>
cudaError_t launch_partial(bool vc, int grid, cudaStream_t stream,
                           const void* x, int64_t x_ld, const void* w,
                           int64_t w_ld, const float* temperature,
                           const int* exclude, const int* gather_ids,
                           const int* seed, float soft_cap, int R, int E,
                           int V, float* part_f, int* part_i) {
  const WT* xp = static_cast<const WT*>(x);
  const WT* wp = static_cast<const WT*>(w);
  if (vc) {
    fused_sample_partial_kernel<WT, true><<<grid, kThreads, 0, stream>>>(
        xp, x_ld, wp, w_ld, temperature, exclude, gather_ids, seed, soft_cap,
        R, E, V, part_f, part_i);
  } else {
    fused_sample_partial_kernel<WT, false><<<grid, kThreads, 0, stream>>>(
        xp, x_ld, wp, w_ld, temperature, exclude, gather_ids, seed, soft_cap,
        R, E, V, part_f, part_i);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether these operands take the tensor-core version of pass 1.
bool tensor_core_layout(int dtype, int v_contig, const void* x, int64_t x_ld,
                        const void* w, int64_t w_ld, int E, int V) {
  return dtype == 1 && v_contig != 0 && E % 8 == 0 && V % 8 == 0 &&
         x_ld % 8 == 0 && w_ld % 8 == 0 && aligned16(x) && aligned16(w);
}

}  // namespace

// The narrowest vocab tile of any version: the wrapper sizes the partial
// buffers for ceil(V / this) tiles.
extern "C" int fused_sample_tile_v() { return kTcTileV; }

// dtype: 0 = float32, 1 = bfloat16 (x and w). v_contig: 1 when W's columns
// (V) are contiguous and w_ld is the stride between E steps, 0 when E is
// contiguous and w_ld is the stride between columns. cuda_cores: 1 keeps
// pass 1 on the CUDA cores where the tensor-core version would run.
// part_f / part_i: scratch of n_tiles * R * 6 floats / 2 ints for n_tiles =
// ceil(V / fused_sample_tile_v()). exclude / gather_ids may be null.
// Returns the CUDA error of the launches.
extern "C" int fused_sample(
    int dtype, int v_contig, int cuda_cores, const void* x, long long x_ld,
    const void* w, long long w_ld, const float* temperature,
    const unsigned char* greedy, const int* exclude, const int* gather_ids,
    const int* seed, float soft_cap, int R, int E, int V, float* part_f,
    int* part_i, int* tokens, float* logprobs, int* argmax, float* gathered,
    float* norm, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_row_tiles = (R + kRT - 1) / kRT;
  const bool tc = !cuda_cores && tensor_core_layout(dtype, v_contig, x, x_ld,
                                                    w, w_ld, E, V);
  const int n_tiles = tc ? (V + kTcTileV - 1) / kTcTileV
                         : (V + kTileV - 1) / kTileV;
  const int grid = n_tiles * n_row_tiles;
  cudaError_t err;
  if (tc) {
    err = cudaFuncSetAttribute(fused_sample_partial_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTcSmemBytes);
    if (err != cudaSuccess) return (int)err;
    fused_sample_partial_tc_kernel<<<grid, kThreads, kTcSmemBytes, stream>>>(
        static_cast<const bf16*>(x), x_ld, static_cast<const bf16*>(w), w_ld,
        temperature, exclude, gather_ids, seed, soft_cap, R, E, V, part_f,
        part_i);
    err = cudaGetLastError();
  } else if (dtype == 0) {
    err = launch_partial<float>(v_contig != 0, grid, stream, x, x_ld, w, w_ld,
                                temperature, exclude, gather_ids, seed,
                                soft_cap, R, E, V, part_f, part_i);
  } else if (dtype == 1) {
    err = launch_partial<__nv_bfloat16>(
        v_contig != 0, grid, stream, x, x_ld, w, w_ld, temperature, exclude,
        gather_ids, seed, soft_cap, R, E, V, part_f, part_i);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  fused_sample_merge_kernel<<<R, 32, 0, stream>>>(
      part_f, part_i, temperature, greedy, R, n_tiles, tokens, logprobs,
      argmax, gathered, norm);
  return (int)cudaGetLastError();
}
