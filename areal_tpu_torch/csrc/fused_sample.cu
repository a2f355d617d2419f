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
// What bounds it. The head is 151936 x 1536 bf16 (467 MB) at the serving
// widths. At R 32 (a decode step of 32 slots) the product is 15 GFLOP, so
// the call is bound by one read of W from HBM: 0.139 ms on an H100. At the
// spec verify's R 320 (64 slots x 5 positions) it is 149 GFLOP, bound by
// the tensor cores: 0.151 ms at 989 TFLOP/s bf16; R 576 (K 8) 0.272 ms.
// The TPU kernel keeps all rows resident and streams W once from HBM; so
// does v3, with L2 serving the row bands that share a tile.
//
// Design, v3 (bf16, V contiguous: the serving layout). A persistent grid
// walks the vocabulary in tiles of 256 columns in a static order:
//  - Rows come in groups of 64 (wgmma's M), a band each. The card's SMs
//    are dealt to the bands, one block per SM; block q serves band q %
//    bands and walks tiles ci, ci + per_band, ... (ci = q / bands), so a
//    tile's readers, one per band, run side by side and HBM sees W once
//    while L2 hands it to each band. One producer thread keeps TMA loads
//    of W [64 E x 256] and x [64 rows x 64 E] (zero fill past R, E and V)
//    in flight through four 40 KB stages in the 128-byte swizzle, full and
//    empty mbarriers between it and the consumers.
//  - Two consumer warpgroups take the block's tiles in turn (ping-pong):
//    each runs wgmma m64n256k16 (bf16 in, f32 out; W read MN-major through
//    the transpose bit) over a tile's 24 stages, then folds its
//    accumulators while the other warpgroup's product runs. A pair of
//    mbarriers passes the turn: a warpgroup waits on its tile's stages only
//    after the other has seen its own tile's last stage land, since a
//    parity wait cannot tell a phase from the one two back. setmaxnreg
//    hands the producer's registers to the consumers (128 accumulators a
//    thread).
//  - The epilogue: each thread owns 2 rows x 64 columns of a tile and
//    carries, across its tiles, a running state per row (max and rescaled
//    sum of exponentials of the warped logits, first-max raw argmax, Gumbel
//    top-1 with its warped logit, gathered logit): the TPU kernel's carried
//    scratch, with a loop over tiles in place of its sequential grid. The
//    raw argmax, warped logits and sums fold in registers. Sampled rows
//    then test each column against the best perturbed value the row's
//    lanes hold with the fast exponentials (gumbel_tile says why no winner
//    is lost) and take the two accurate logs only for the few that pass;
//    greedy rows skip the hash and the logs, since their token is the
//    argmax and the merge never reads their Gumbel fields. After the last
//    tile the four lanes of a row merge by shuffles and write ONE partial
//    record per (block, warpgroup, row).
//  - The merge kernel folds a row's 2 x per_band records in a fixed order.
//    No float atomics and a static schedule (the SM count), so outputs are
//    bit-identical from run to run; ties resolve to the lowest column, as
//    a first-max argmax over the whole vocabulary does.
// Bytes this tiling moves (V 151936, E 1536): at R 32 (one band of 132
// blocks) HBM reads W once, 467 MB, and L2 hands the SMs W once plus x's 58
// MB (594 tiles x 32 rows); at R 320 (five bands of 26 blocks) HBM reads W
// once while the bands keep step, and L2 hands out W five times (2.3 GB)
// plus x's 584 MB; at R 576 (nine bands of 14) W nine times (4.2 GB) plus
// x's 1.05 GB. So R 32 is bound by HBM, and R >= 128 by the L2 traffic of
// the bands' re-reads and by the Gumbel fold. A thread-block cluster per
// tile multicasting each W stage to all its bands would cut that traffic
// to one pass; built that way (clusters of up to 8 blocks, one TMA
// multicast per stage, the empty barriers collecting every block's
// release) it ran slower at every R tried on an H100, several times so
// at R 320, each cluster's lockstep stalling its few streams.
// v2, replaced here: one block per (128-column tile, 32-row tile) with
// mma.sync m16n8k16 from a 4-stage cp.async ring, the epilogue one warp per
// row through shared memory, and n_tiles x R partial records: W crossed L2
// once per 32-row tile (4.7 GB at R 320), 1.754 ms there on an H100.
//
// CUDA cores (f32, E contiguous, odd sizes or alignments): one block per
// (256-column tile, 32-row tile), written from the same epilogue arithmetic:
// x staged as f32, 128 E steps at a time; each of 128 threads owns two
// columns and keeps 32 x 2 f32 sums in registers, reading x as broadcast
// float4 and W straight from global memory, coalesced across the warp, one
// group of four E steps prefetched ahead; the tile's logits pass through
// shared memory to one warp per row, which writes ONE partial record per
// (tile, row) for the same merge kernel.
//
// The head may be [E, V] with V contiguous (an untied head) or with E
// contiguous (tied embeddings hand over embed.T); the wrapper passes the
// leading stride and which of the two it is, and picks the pass
// (ops/cuda/fused_sample.py::choose_pass). The head is never copied.
// TMA descriptors are encoded per call (they carry x's and W's addresses,
// so a CUDA graph that captured the call replays on the same tensors).

#include <cuda.h>  // CUtensorMap and its enums; the driver call is looked up
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
// v3: the product on wgmma, one read of W for all rows (bf16, V contiguous)
// --------------------------------------------------------------------------
//
// Accumulator layout of wgmma m64nNk16 (f32), per thread with warp w of the
// warpgroup, gid = lane / 4 and tig = lane % 4: d[4j + e] is row
// 16w + gid + 8 (e / 2), column 8j + 2 tig + (e % 2). So a thread holds two
// rows (e / 2 = 0, 1), 64 columns each, visited in increasing order.

constexpr int kWg = 128;                      // threads per warpgroup
constexpr int kV3Threads = 3 * kWg;           // producer + two consumers
constexpr int kGroupRows = 64;                // rows per block (wgmma M)
constexpr int kTileN = 256;                   // columns per tile (wgmma N)
constexpr int kLine = 128;                    // bytes per swizzled line
constexpr int kChunk = 64;                    // bf16 per line
constexpr int kKC = 64;                       // E steps per stage
constexpr int kStages = 4;
constexpr int kXStage = kGroupRows * kLine;           // 8 KB of x
constexpr int kWChunk = kKC * kLine;                  // 64 columns of W, 8 KB
constexpr int kWStage = (kTileN / kChunk) * kWChunk;  // 32 KB of W
constexpr int kStage = kXStage + kWStage;
// the epilogue folds a tile's accumulators in 4 chunks of 32 a thread,
// staged through shared memory: value i of thread t at [i][t], per
// consumer warpgroup
constexpr int kFoldChunk = 32;
constexpr int kBufOff = kStages * kStage;
constexpr int kBuf = kFoldChunk * kWg * 4;            // 16 KB
constexpr int kBarOff = kBufOff + 2 * kBuf;
// full[kStages], empty[kStages], turn[2]
constexpr int kV3Smem = kBarOff + (2 * kStages + 2) * 8 + 1024;  // + alignment
// setmaxnreg moves registers within the block's launch allocation (384
// threads x 168 = 64512): 128 x 40 + 256 x 232 stays within it
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kWg * kProducerRegs + 2 * kWg * kConsumerRegs <=
                  kV3Threads * (65536 / kV3Threads / 8 * 8),
              "setmaxnreg beyond the launch allocation");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// one arrival that also announces `bytes` of TMA traffic on this phase
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned atoms of 8 lines): SBO = 1024 bytes between 8-line
// groups; LBO = the distance between 64-element chunks along the lines
// (read by the MN-major B operand, 256 columns = four chunks; K-major
// operands ignore it).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching accumulators across an async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 256] (+)= A[64 x 16] * B[16 x 256]: A (x) K-major, B (W) MN-major
// (the transpose bit), both in shared memory; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One row's running state over the columns a thread (then a warpgroup)
// has folded: the TPU kernel's carried scratch.
struct RowState {
  float m, l;      // max and rescaled sum of exp of the warped logits
  float amv;       // raw argmax value, column ami
  float gp, gw;    // Gumbel-perturbed maximum and its warped logit, column gi
  float gat;       // the gathered column's warped logit
  int ami, gi;
};

__device__ __forceinline__ RowState row_state_init() {
  RowState s;
  s.m = kNegInf; s.l = 0.0f; s.amv = kNegInf; s.gp = kNegInf; s.gw = 0.0f;
  s.gat = kNegInf; s.ami = 0; s.gi = 0;
  return s;
}

// Per-row operands of a thread's row.
struct RowArgs {
  float t;         // temperature, floored at 1e-6
  int excl, gath;  // excluded and gathered column, -1 for none
  uint32_t row;
  bool ok, greedy;
};

// The exact perturbed value of one column, warped - log(-log u) with u
// capped one ulp below 1 as the plain version does (U_MAX): out of line,
// since the fold calls it for the few columns that pass its test.
__device__ __noinline__ float gumbel_pert(float warped, uint32_t seed, uint32_t row,
                                          uint32_t col) {
  const float u = fminf(hash_uniform(seed, row, col), 0.99999994f);
  return warped - logf(-logf(u));
}

// Fold row half I of one tile (accumulators d[4j + 2I + b], columns col0 +
// 8j + b, increasing) into the row's state: soft cap, raw argmax, gathered
// logit, and the sum of exponentials of the warped logits, which overwrite
// the accumulators (dead until the warpgroup's next product).
template <int I>
__device__ __forceinline__ void fold_row(float (&acc)[128], RowState& st,
                                         const RowArgs& a, int col0, int V,
                                         float soft_cap) {
  float mt = kNegInf;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int c = col0 + 8 * j + b;
      float& v = acc[4 * j + 2 * I + b];
      if (c < V) {
        float logit = v;
        if (soft_cap > 0.0f) logit = tanhf(logit / soft_cap) * soft_cap;
        // increasing columns: strictly-greater updates keep the first max
        if (logit > st.amv) { st.amv = logit; st.ami = c; }
        const float warped = logit / a.t;
        v = warped;
        mt = fmaxf(mt, warped);
        if (c == a.gath) st.gat = warped;
      }
    }
  }
  const float mn = fmaxf(st.m, mt);
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (col0 + 8 * j + b < V) sum += __expf(acc[4 * j + 2 * I + b] - mn);
    }
  }
  st.l = st.l * __expf(st.m - mn) + sum;
  st.m = mn;
}

// Gumbel top-1 of a tile's sampled rows, over the warped logits fold_row
// left in the accumulators. A column's perturbed value warped - log(-log
// u) reaches a bar b only if u >= exp(-exp(warped - b)); b is the best
// exact value the row's four lanes hold. That test runs on the fast
// exponentials, widened by `lift` (the exact value's rounding, ~1e-7 of
// |pert| plus ulps of the logs) and by 1e-6 in u (their error), so it
// keeps every column that can win; the candidates then take the two
// accurate logs (gumbel_pert), which alone decide. The loops stay rolled
// (unrolled over 128 registers the fold outgrows the instruction cache):
// 32 values at a time pass through the thread's slots of `buf` ([value]
// [thread]), and each lane then walks its own candidates, in increasing
// column order per row.
__device__ __forceinline__ void gumbel_tile(const float (&acc)[128], float* buf, int tid,
                                            RowState (&st)[2], const RowArgs (&ra)[2],
                                            int col0, int V, uint32_t seed,
                                            unsigned quad) {
  bool on[2];
  float bar[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    on[i] = ra[i].ok && !ra[i].greedy;
    bar[i] = st[i].gp;
    if (on[i]) {  // the row's four lanes share it
      bar[i] = fmaxf(bar[i], __shfl_xor_sync(quad, bar[i], 1));
      bar[i] = fmaxf(bar[i], __shfl_xor_sync(quad, bar[i], 2));
    }
  }
  if (!on[0] && !on[1]) return;
#pragma unroll
  for (int q = 0; q < 128 / kFoldChunk; ++q) {
#pragma unroll
    for (int i = 0; i < kFoldChunk; ++i) buf[i * kWg + tid] = acc[q * kFoldChunk + i];
    uint32_t cand = 0;
    // the bar holds for the whole chunk, so its columns' tests are
    // independent and overlap; candidates raise it once they are exact
#pragma unroll 2
    for (int jj = 0; jj < kFoldChunk / 4; ++jj) {
      const int c0 = col0 + 8 * (q * kFoldChunk / 4 + jj);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = c0 + (e & 1);
        const float warped = buf[(jj * 4 + e) * kWg + tid];
        const float lift = 2e-5f + 2e-7f * fabsf(bar[i]);
        const float u = fminf(hash_uniform(seed, ra[i].row, (uint32_t)c), 0.99999994f);
        const bool hit = u >= __expf(-__expf(warped - bar[i] + lift)) - 1e-6f;
        if (hit && on[i] && c < V && c != ra[i].excl) cand |= 1u << (jj * 4 + e);
      }
    }
    while (cand) {
      const int k = __ffs(cand) - 1;
      cand &= cand - 1;
      const int i = (k >> 1) & 1;
      const int c = col0 + 8 * (q * kFoldChunk / 4 + (k >> 2)) + (k & 1);
      const float warped = buf[k * kWg + tid];
      const float pert = gumbel_pert(warped, seed, i ? ra[1].row : ra[0].row, (uint32_t)c);
      // constant indices keep both states in registers
      if (i == 0 && pert > st[0].gp) { st[0].gp = pert; st[0].gw = warped; st[0].gi = c; }
      if (i == 1 && pert > st[1].gp) { st[1].gp = pert; st[1].gw = warped; st[1].gi = c; }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) bar[i] = fmaxf(bar[i], st[i].gp);
  }
}

// Merge the states of lanes `off` apart; both lanes end with the same bits
// (the term of the smaller maximum is added second on both).
__device__ __forceinline__ void merge_lanes(RowState& s, int off) {
  const float om = __shfl_xor_sync(0xffffffffu, s.m, off);
  const float ol = __shfl_xor_sync(0xffffffffu, s.l, off);
  const float mn = fmaxf(s.m, om);
  const float a = (s.m >= om) ? s.l * expf(s.m - mn) : ol * expf(om - mn);
  const float b = (s.m >= om) ? ol * expf(om - mn) : s.l * expf(s.m - mn);
  s.l = a + b;
  s.m = mn;
  const float ov = __shfl_xor_sync(0xffffffffu, s.amv, off);
  const int oi = __shfl_xor_sync(0xffffffffu, s.ami, off);
  if (beats(ov, oi, s.amv, s.ami)) { s.amv = ov; s.ami = oi; }
  const float op = __shfl_xor_sync(0xffffffffu, s.gp, off);
  const float ow = __shfl_xor_sync(0xffffffffu, s.gw, off);
  const int og = __shfl_xor_sync(0xffffffffu, s.gi, off);
  if (beats(op, og, s.gp, s.gi)) { s.gp = op; s.gw = ow; s.gi = og; }
  s.gat = fmaxf(s.gat, __shfl_xor_sync(0xffffffffu, s.gat, off));
}

struct V3Params {
  const float* temperature;
  const unsigned char* greedy;
  const int* exclude;     // may be null
  const int* gather_ids;  // may be null
  const int* seed;
  float soft_cap;
  int R, E, V;
  int bands;              // row groups, walking the vocabulary side by side
  int per_band;           // blocks per band
  float* part_f;          // [2 * per_band][R] records
  int* part_i;
};

// Grid: bands * per_band blocks. Block q owns row group q % bands and
// walks tiles ci, ci + per_band, ... for ci = q / bands; consecutive blocks
// are the bands of one ci, so a tile's readers run side by side and L2
// serves all but the first of them.
__global__ void __launch_bounds__(kV3Threads, 1)
fused_sample_v3_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const V3Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* turn = empty + kStages;  // [warpgroup]: the other one's mainloop is done
  const int band = blockIdx.x % p.bands, ci = blockIdx.x / p.bands;
  const int row0 = band * kGroupRows;
  const int n_tiles = (p.V + kTileN - 1) / kTileN;
  const int n_k = (p.E + kKC - 1) / kKC;
  const int n_items = ci < n_tiles ? (n_tiles - 1 - ci) / p.per_band + 1 : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 4);  // each warp of the consuming warpgroup
    }
    bar_init(turn, 1);
    bar_init(turn + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWg) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int n = 0; n < n_items; ++n) {
        const int tile0 = (ci + n * p.per_band) * kTileN;
        for (int kc = 0; kc < n_k; ++kc, ++it) {
          const int s = it % kStages;
          bar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          bar_expect_tx(&full[s], kStage);
          unsigned char* st = smem + s * kStage;
          tma_2d(st, &map_x, &full[s], kc * kKC, row0);
#pragma unroll
          for (int c = 0; c < kTileN / kChunk; ++c) {
            tma_2d(st + kXStage + c * kWChunk, &map_w, &full[s],
                   tile0 + c * kChunk, kc * kKC);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes items n with n % 2 == wg
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / kWg - 1;
  const int tid = threadIdx.x % kWg;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const unsigned quad = 0xFu << (4 * gid);
  float* buf = reinterpret_cast<float*>(smem + kBufOff + wg * kBuf);
  const uint32_t seed = (uint32_t)p.seed[0];
  RowArgs ra[2];
  RowState st[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + gid + 8 * i;
    ra[i].row = (uint32_t)row;
    ra[i].ok = row < p.R;
    ra[i].t = ra[i].ok ? fmaxf(p.temperature[row], 1e-6f) : 1.0f;
    ra[i].greedy = ra[i].ok ? p.greedy[row] != 0 : true;
    ra[i].excl = ra[i].ok && p.exclude ? p.exclude[row] : -1;
    ra[i].gath = ra[i].ok && p.gather_ids ? p.gather_ids[row] : -1;
    st[i] = row_state_init();
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  int it = 0;
  for (int n = 0; n < n_items; ++n) {
    if ((n & 1) != wg) {
      it += n_k;
      continue;
    }
    const int tile0 = (ci + n * p.per_band) * kTileN;
    // Parity waits see one phase back only, so a warpgroup waits on a
    // stage only once the other has seen every stage before it: item n
    // starts when item n - 1's last stage has landed.
    if (n > 0) bar_wait(&turn[wg], ((n - 1) >> 1) & 1);
    int prev = -1;
    fence_regs(acc);
    for (int kc = 0; kc < n_k; ++kc, ++it) {
      const int s = it % kStages;
      bar_wait(&full[s], (it / kStages) & 1);
      if (kc == n_k - 1 && tid == 0) bar_arrive(&turn[wg ^ 1]);
      const uint32_t xb = smem_u32(smem + s * kStage);
      const uint32_t wb = xb + kXStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        wgmma_n256(acc, desc_sw128(xb + kk * 32, 16),
                   desc_sw128(wb + kk * 16 * kLine, kWChunk), kc > 0 || kk > 0);
      }
      wgmma_commit();
      if (prev >= 0) {
        // the product that read the previous stage is done: release it
        wgmma_wait<1>();
        if (lane == 0) bar_arrive(&empty[prev]);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) bar_arrive(&empty[prev]);
    const int col0 = tile0 + 2 * tig;
    if (ra[0].ok) fold_row<0>(acc, st[0], ra[0], col0, p.V, p.soft_cap);
    if (ra[1].ok) fold_row<1>(acc, st[1], ra[1], col0, p.V, p.soft_cap);
    gumbel_tile(acc, buf, tid, st, ra, col0, p.V, seed, quad);
  }
  // the row's four lanes, then one record per (block's ci, warpgroup, row)
  const int slot = ci * 2 + wg;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    merge_lanes(st[i], 1);
    merge_lanes(st[i], 2);
    if (tig == 0 && ra[i].ok) {
      float* pf = p.part_f + ((int64_t)slot * p.R + ra[i].row) * kPF;
      int* pi = p.part_i + ((int64_t)slot * p.R + ra[i].row) * kPI;
      pf[0] = st[i].m; pf[1] = st[i].l; pf[2] = st[i].amv;
      pf[3] = st[i].gp; pf[4] = st[i].gw; pf[5] = st[i].gat;
      pi[0] = st[i].ami; pi[1] = st[i].gi;
    }
  }
}

// One warp per row: merge the row's partial records in a fixed order and
// emit.
__global__ void __launch_bounds__(32)
fused_sample_merge_kernel(
    const float* __restrict__ part_f, const int* __restrict__ part_i,
    const float* __restrict__ temperature,
    const unsigned char* __restrict__ greedy, int R, int n_parts,
    int* __restrict__ tokens, float* __restrict__ logprobs,
    int* __restrict__ argmax, float* __restrict__ gathered,
    float* __restrict__ norm_out) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  float m = kNegInf, l = 0.0f, amv = kNegInf, gp = kNegInf, gw = 0.0f;
  float gat = kNegInf;
  int ami = 0, gi = 0;
  for (int part = lane; part < n_parts; part += 32) {
    const float* pf = part_f + ((int64_t)part * R + row) * kPF;
    const int* pi = part_i + ((int64_t)part * R + row) * kPI;
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

// --- v3 host side -------------------------------------------------------------

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

// a row-major bf16 matrix [rows, cols] with row stride ld (elements), in
// boxes of 64 x 64 in the 128-byte swizzle; zero fill past the edges
bool map_matrix(CUtensorMap* map, const void* ptr, int rows, int cols, int64_t ld) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(ld) * 2};
  const cuuint32_t box[2] = {cuuint32_t(kChunk), cuuint32_t(64)};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// SMs of the current device: v3 runs one block on each.
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    sms = 1;
  return sms;
}

// The v3 schedule for R rows over V columns (ops/cuda/fused_sample.py::plan
// mirrors it): one band per group of 64 rows, the card's SMs dealt to the
// bands, no more blocks in a band than tiles.
struct V3Plan {
  int bands, per_band;
};

V3Plan v3_plan(int R, int V) {
  const int bands = (R + kGroupRows - 1) / kGroupRows;
  const int n_tiles = (V + kTileN - 1) / kTileN;
  int per_band = sm_count() / bands;
  if (per_band > n_tiles) per_band = n_tiles;
  if (per_band < 1) per_band = 1;
  return {bands, per_band};
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Partial records per row of the given pass (0: CUDA cores, 1: v3): the
// wrapper allocates this many times R records of 6 floats and 2 ints.
extern "C" int fused_sample_slots(int v3, int R, int V) {
  if (R < 1 || V < 1) return 0;
  if (v3) return 2 * v3_plan(R, V).per_band;
  return (V + kTileV - 1) / kTileV;
}

// The v3 schedule: out[0..1] = bands, blocks per band.
extern "C" int fused_sample_plan(int R, int V, int* out) {
  if (R < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const V3Plan pl = v3_plan(R, V);
  out[0] = pl.bands;
  out[1] = pl.per_band;
  return 0;
}

// The SM count the plan reads.
extern "C" int fused_sample_sms() { return sm_count(); }

// v3: 1 runs the wgmma pass (the wrapper's choice: bf16, V contiguous, E,
// V and both strides multiples of 8, 16-byte aligned), 0 the CUDA-core
// pass. dtype: 0 = float32, 1 = bfloat16 (x and w). v_contig: 1 when W's
// columns (V) are contiguous and w_ld is the stride between E steps, 0
// when E is contiguous and w_ld is the stride between columns.
// part_f / part_i: scratch of fused_sample_slots(v3, R, V) * R * 6 floats
// / 2 ints. exclude / gather_ids may be null. Returns the CUDA error of the
// launches; a v3 request on operands it does not take returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int fused_sample(
    int v3, int dtype, int v_contig, const void* x, long long x_ld,
    const void* w, long long w_ld, const float* temperature,
    const unsigned char* greedy, const int* exclude, const int* gather_ids,
    const int* seed, float soft_cap, int R, int E, int V, float* part_f,
    int* part_i, int* tokens, float* logprobs, int* argmax, float* gathered,
    float* norm, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (R < 1 || E < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  int n_parts;
  if (v3) {
    if (dtype != 1 || v_contig == 0 || E % 8 || V % 8 || x_ld % 8 || w_ld % 8 ||
        !aligned16(x) || !aligned16(w))
      return (int)cudaErrorInvalidValue;
    const V3Plan pl = v3_plan(R, V);
    CUtensorMap mx, mw;
    if (!map_matrix(&mx, x, R, E, x_ld) || !map_matrix(&mw, w, E, V, w_ld))
      return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(fused_sample_v3_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kV3Smem);
    if (err != cudaSuccess) return (int)err;
    V3Params p;
    p.temperature = temperature;
    p.greedy = greedy;
    p.exclude = exclude;
    p.gather_ids = gather_ids;
    p.seed = seed;
    p.soft_cap = soft_cap;
    p.R = R;
    p.E = E;
    p.V = V;
    p.bands = pl.bands;
    p.per_band = pl.per_band;
    p.part_f = part_f;
    p.part_i = part_i;
    fused_sample_v3_kernel<<<pl.bands * pl.per_band, kV3Threads, kV3Smem, stream>>>(
        mx, mw, p);
    err = cudaGetLastError();
    n_parts = 2 * pl.per_band;
  } else {
    const int n_row_tiles = (R + kRT - 1) / kRT;
    n_parts = (V + kTileV - 1) / kTileV;
    const int grid = n_parts * n_row_tiles;
    if (dtype == 0) {
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
  }
  if (err != cudaSuccess) return (int)err;
  fused_sample_merge_kernel<<<R, 32, 0, stream>>>(
      part_f, part_i, temperature, greedy, R, n_parts, tokens, logprobs,
      argmax, gathered, norm);
  return (int)cudaGetLastError();
}
