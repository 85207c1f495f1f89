// The decode GEMMs for Hopper (sm_90a): K1 and K2 at M <= 16 rows, for
// every weight codec, plain or on one layer of stacked weights (K12).
//
// Replaces gemma_tpu/ops/matmul.py:_mm_kernel (K1, :577, call :908) with
// its _norm_a prologue (:563) and post-norm + residual epilogue,
// matmul.py:_gated_kernel (K2, :629, call :998), _acc_step's codec
// branches inside both (i4 :517-538, nuq4 :475-516, i8 :539-, sfp/nuq and
// bf16/f32 :471-474: K7a, K7b) at the M of decode (one row per slot), and
// matmul.py:_b_inputs_stacked (:768, K12) feeding them.  Computes
//   C[M, N] = scale * A[M, K] . dequant(W)[N, K]^T
// (K2: bf16 gelu_tanh(C1) * C2 with matmul.py:664-665's constants), A
// bf16, products exact in bf16 and summed in f32, with the numerics of the
// other tiles: bf16, sfp / nuq and nuq4 weights enter as the exact bf16 of
// their value, f32 rounded to bf16 (nearest even); i8 and i4 codes enter
// raw and each 128-wide group closes on the OUTPUT as the TPU kernel does:
//   i8: C += inv_g * (A_g . C_g) - (inv_g * zp_g) * sum(A_g),
//   i4: C += s_g * (A_g . C_g) + m_g * sum(A_g),
// sum(A_g) the f32 sum of the group's bf16 A.  One C entry per GEMM is one
// launch: the prologue norm (f32 A) and the post-norm + residual add run
// inside the kernel (the folds below), as inside the TPU kernel.
//
// What bounds it on an H100: the weights' bytes at 3.35 TB/s, N*K*esize
// plus the group arrays (i8 8 bytes a 128-group; i4 and nuq4 0.5625 bytes
// a weight with their scales or tables), e.g. Gemma2-27B's i4 linear
// 4608 x 36864 = 95.6 MB -> 28.5 us, its gated FFN 191 MB -> 57 us.  At
// M <= 16 a weight byte meets at most 32 multiply-adds: far below the
// tensor cores' rate, so the tile has to keep enough bytes in flight and
// touch A and the scales little.
//
// Design.  The product runs transposed, C^T = W . A^T, on mma.sync
// m16n8k16: a warp's 16 weight rows, decoded in registers, are the 16-row
// operand (fragment row g weight row n0 + g, row g + 8 weight row n0 + g +
// 8; K2: gate 1's row n0 + g and gate 2's same row, so one thread holds
// both factors of its outputs), A^T the 8-wide one: one n-tile for M <= 8,
// two above (the old tile wasted 12 of 16 MMA rows on A at M = 4).  A lane
// walks its rows' bytes in chunks of 2 x 16 bytes a row (128 bytes a row:
// 256 K of the packed kinds, else 128, 64 or 32), with the K of a chunk
// permuted identically on W and A so each lane's bytes are contiguous.
//  - A block of 8 warps puts `kw` warps on each of 8 / kw row groups; they
//    split the block's K and add their partial sums through shared memory
//    in order.  `splits` blocks of one thread-block cluster split a
//    panel's K further: each leaves its partial products in its shared
//    memory, and each adds its share of the panel's columns over the
//    cluster's partials (distributed shared memory) in split order.  The
//    caller chooses both from the shapes alone (ops/matmul.py:
//    decode_split): few warps a row group for a large N, more for a small
//    one, so that a wave of blocks fills the card; splits where a block's
//    slice of A would pass 4608 K.  Never from M: a row's sums are taken
//    in one order at every batch size, and no float atomics, so a GEMM
//    gives the same bits on every run.
//  - A is staged once per block: its K slice of all M rows is copied into
//    shared memory (rows padded so a warp's 8-byte reads of 8 rows are
//    free of bank conflicts) by cp.async, every copy in flight at once,
//    instead of every block re-reading A from L2 at every step.
//  - i8 / i4's group sums of A come from the tensor cores: an operand of
//    ones times the step's A^T (two m16n8k8 a step) accumulates them in
//    the accumulator layout of the outputs, so no pass over A and no
//    shuffles; a group closes with its (scale, offset) pairs, which ride
//    in the ring beside the codes (lane t of a row holds fragment row
//    t & 1's pair of group t >> 1 and shuffles it out).
//  - The weights stream through a register ring of kDepth chunks (16-byte
//    non-coherent loads a chunk ahead of the one being multiplied).  The
//    tile is bound by latency in the warps' decode-and-multiply chains
//    more than by the bytes in flight: three blocks an SM (24 warps, 80
//    registers) measured faster on an H100 than two blocks with a ring of
//    three chunks, or one with six or eight (PERF.md).
//  - nuq4 decodes its tables, not each weight: per 256-block each lane
//    of a row turns 4 of the row's 16 SFP table bytes into bf16, and the
//    4 lanes gather them by shuffles into two byte planes (low and high
//    bytes of the 16 entries, 4 registers each); four weights are then two
//    table selects and two byte permutes (nuq4_plane_frag).
//  - The prologue norm: a row's multiplier needs its sum of squares over
//    the whole K, of which a block stages only its split's slice.  Each
//    block reads its slice of the f32 rows, leaves the sums of squares of
//    its 32-K segments in shared memory, and once every block of the
//    cluster has (a cluster barrier) reads every segment sum (distributed
//    shared memory) in one order; then it reads the rows again and writes
//    bf16(m + m w) into the staging.  Every block of the grid reads the same rows;
//    bringing them into shared memory by cp.async instead, sharing the
//    staging across a cluster or the sums across a grid barrier measured
//    no faster (PERF.md).  The order depends on K alone
//    (gemm_common.cuh), so the bits of a row's A do not change with M, the
//    split or the warps.
//  - The post-norm needs whole rows of N, split over panels (and, in a
//    cluster, over its blocks' shares of a panel): every block leaves its
//    columns in shared memory and one partial sum of squares a row in
//    `slots`.  Where every block fits on the card at once the launch is
//    cooperative (the runtime then guarantees they are resident) and the
//    blocks meet at a grid barrier; each adds the partials in block order
//    and finishes its own columns (gemm_common.cuh:post_grid).  Else each
//    block also leaves its columns in y, takes a ticket, and the last
//    block adds the partials in the same order and finishes every row
//    (post_tail); the ticket is zero again when the kernel ends.  No block
//    waits for another outside a cooperative launch.
// Columns past N and rows past M are never written.  N must be a multiple
// of 8 (whole fragment rows; odd N is refused), K a multiple of the
// codec's chunk.

#include <cooperative_groups.h>

#include "gemm_common.cuh"

namespace cg = cooperative_groups;
using namespace gemma;

constexpr int kDecodeRows = 16;    // the entries refuse more rows of A
constexpr int kDepth = 2;  // chunks in a lane's register ring
// Blocks an SM by the launch bounds, the most at which ptxas keeps every
// kernel free of spills: three (80 registers a thread) at M <= 8
// (ops/matmul.py:DECODE_WAVE), but two for the stacked kernels of the
// affine and table kinds (the layer's offsets of their group arrays and
// tables); two at M > 8, whose second n-tile takes more registers, i4's
// there one.
__host__ __device__ constexpr int blocks_per_sm(int codec, int nt,
                                                bool stacked) {
  const bool side = codec == kI8 || codec == kI4 || codec == kNuq4;
  return nt == 2 ? (codec == kI4 ? 1 : 2) : stacked && side ? 2 : 3;
}

// Dynamic shared memory a block may take (A's slice and the partials).
// The caller's splits keep A's slice within 4608 K (DECODE_SLICE): 72 KB
// at 8 rows, 144 KB at 16, where a block holds an SM alone.
constexpr int kDecodeSmemMax = 200 * 1024;
// Blocks that split the K of a panel: one thread-block cluster, at most
// the portable cluster size.
constexpr int kMaxSplits = 8;

// A block's dynamic shared memory, byte offsets: A's slice of the longest
// split (padded rows), then (split K) the block's partial products, then
// (kw > 1) the warps' partial sums, then (prologue norm) the sums of
// squares of its slice's segments and the rows' multipliers (also the
// epilogue's), then (post-norm) its share of the panel's output columns.
struct DecodeSmem {
  int red, wred, segs, segs_ld, mul, yt, bytes;
};

template <int CODEC, bool GATED>
__host__ __device__ __forceinline__ DecodeSmem decode_smem(int M, int K,
                                                           int splits, int kw,
                                                           bool pro,
                                                           bool post) {
  using C = Codec<CODEC>;
  const int chunks = K / C::kChunk, cmax = (chunks + splits - 1) / splits;
  const int pad = CODEC == kNuq4 ? 2 : 4;
  const int pc = warp_cols<GATED>() * (8 / kw);
  DecodeSmem L;
  L.red = (M * (cmax * C::kChunk + pad) * 2 + 15) / 16 * 16;
  L.wred = L.red + (splits > 1 ? M * 2 * pc * 4 : 0);
  L.segs = L.wred + (kw > 1 ? 8 * (M > 8 ? 2 : 1) * 4 * 32 * 4 : 0);
  L.segs_ld = cmax * C::kChunk / kNormSeg;  // the longest split's segments
  L.mul = L.segs + (pro ? M * L.segs_ld * 4 : 0);
  L.yt = L.mul + 16 * 4;
  L.bytes = L.yt + (post ? M * ((pc + splits - 1) / splits) * 4 : 0);
  return L;
}

// The output of one (row m, column n): scaled, K2 gated.
template <bool GATED>
__device__ __forceinline__ float finish(const DecodeArgs& p, float c1,
                                        float c2) {
  c1 *= p.scale[0];
  if constexpr (GATED) {
    c2 *= p.scale[1];
    const float arg = c1 * (0.797884560804236f + 0.03567740813636141f * c1 * c1);
    c1 = (c1 * (0.5f + 0.5f * tanhf(arg))) * c2;
  }
  return c1;
}

__device__ __forceinline__ void store_out(const DecodeArgs& p, size_t off,
                                          float v) {
  if (p.out_bf16)
    static_cast<__nv_bfloat16*>(p.out)[off] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p.out)[off] = v;
}

// Output (m, n) = v, of a block's share of the panel (yt[j] its column
// j's slot there): under a post-norm the raw value goes to y and yt for
// the epilogue; else add + v to out.
__device__ __forceinline__ void emit(const DecodeArgs& p, int m, int n,
                                    float v, float* yt) {
  const size_t off = (size_t)m * p.N + n;
  if (p.post_w != nullptr) {
    if (!p.coop) p.y[off] = v;
    *yt = v;
  } else {
    store_out(p, off, p.add != nullptr ? __fadd_rn(v, __ldg(p.add + off)) : v);
  }
}

// A's slice (chunks [c0, c1)) into the staging, normalized there under a
// prologue norm.  A row's multiplier needs its sum of squares over the
// whole K: each block leaves the sums of squares of its slice's segments
// in its shared memory, and (K split over a cluster) every block reads all
// of them, segment by segment in one order, from the block that holds it
// (distributed shared memory).
template <int CODEC, bool GATED>
__device__ __forceinline__ void stage_a(const DecodeArgs& p, int c0, int c1,
                                        __nv_bfloat16* As, int SA) {
  using C = Codec<CODEC>;
  constexpr int PAD = CODEC == kNuq4 ? 2 : 4;
  extern __shared__ __align__(16) uint8_t smem[];
  const int M = p.M, K = p.K, S = p.splits;
  const int k0 = c0 * C::kChunk, k1 = c1 * C::kChunk;
  if (p.norm == nullptr) {
    copy_stage<PAD>(p.a, K, k0, (k1 - k0) / 8, M, As, SA);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = K / C::kChunk;
  const DecodeSmem L = decode_smem<CODEC, GATED>(M, K, S, p.kw, true,
                                                 p.post_w != nullptr);
  float* segs = reinterpret_cast<float*>(smem + L.segs);
  float* mul = reinterpret_cast<float*>(smem + L.mul);
  const int ld = L.segs_ld;
  norm_segments(p.a32, K, k0, k1, M, segs, ld);
  if (S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int m = warp; m < M; m += kDecodeThreads / 32) {
      const float r = norm_row_mul(K, lane, [&](int s) {
        // The split that holds segment s, and its first segment.
        const int q = ((s * kNormSeg / C::kChunk + 1) * S - 1) / chunks;
        const int s0 = q * chunks / S * C::kChunk / kNormSeg;
        return cluster.map_shared_rank(segs, q) + m * ld + s - s0;
      });
      if (lane == 0) mul[m] = r;
    }
  } else {
    __syncthreads();
    for (int m = warp; m < M; m += kDecodeThreads / 32) {
      const float r = norm_row_mul(K, lane, [&](int s) {
        return segs + m * ld + s;
      });
      if (lane == 0) mul[m] = r;
    }
  }
  __syncthreads();
  norm_stage(p.a32, p.norm, K, k0, (k1 - k0) / 8, M, mul, As, SA);
}

template <int CODEC, int NT, bool GATED, bool STACKED>
__device__ __forceinline__ void decode_body(const DecodeArgs& p) {
  using C = Codec<CODEC>;
  // Row padding of the staged A (elements): 8 bytes, or 4 for nuq4's
  // 4-byte reads, keeps a warp's reads of 8 rows on distinct banks.
  constexpr int PAD = CODEC == kNuq4 ? 2 : 4;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int M = p.M, N = p.N, K = p.K, S = p.splits;
  const int chunks = K / C::kChunk, cmax = (chunks + S - 1) / S;
  const int c0 = (int)((long long)blockIdx.y * chunks / S);
  const int c1 = (int)((long long)(blockIdx.y + 1) * chunks / S);
  const int SA = cmax * C::kChunk + PAD;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);

  // This warp: row group rg (its fragment rows), K part kp of the
  // block's slice, chunks [w0, w1).
  const int kw = p.kw, rg = warp / kw, kp = warp % kw;
  const int PC = warp_cols<GATED>() * (8 / kw), col0 = blockIdx.x * PC;
  const int w0 = c0 + kp * (c1 - c0) / kw, w1 = c0 + (kp + 1) * (c1 - c0) / kw;
  const Rows rows = rows_of<CODEC, GATED, STACKED>(p, col0, rg, g);
  Slot ring[kDepth];
#pragma unroll
  for (int j = 0; j < kDepth - 1; ++j)
    if (w0 + j < w1)
      load_slot<CODEC, GATED, STACKED>(ring[j], rows, p, w0 + j, t);

  // A's slice: columns [c0, c1) chunks of all M rows (stage_a).
  stage_a<CODEC, GATED>(p, c0, c1, As, SA);
  __syncthreads();
  float acc[NT][4], part[NT][4], asum[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = part[nt][e] = asum[nt][e] = 0.f;

  for (int cb = w0; cb < w1; cb += kDepth) {
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const int c = cb + j;
      if (c < w1) {
        if (c + kDepth - 1 < w1)
          load_slot<CODEC, GATED, STACKED>(ring[(j + kDepth - 1) % kDepth],
                                           rows, p, c + kDepth - 1, t);
        consume_chunk<CODEC, NT>(ring[j], As, SA, (c - c0) * C::kChunk, M,
                                 g, t, lane, acc, part, asum);
      }
    }
  }

  // The kw partial sums of a row group meet in its warp kp = 0, in order.
  const bool post = !GATED && p.post_w != nullptr;
  const DecodeSmem L = decode_smem<CODEC, GATED>(M, K, S, kw,
                                                 p.norm != nullptr, post);
  float* red = reinterpret_cast<float*>(smem + L.red);
  if (kw > 1) {
    float* wred = reinterpret_cast<float*>(smem + L.wred);  // [8][NT*4][32]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        wred[(warp * NT * 4 + nt * 4 + e) * 32 + lane] = acc[nt][e];
    __syncthreads();
    if (kp == 0) {
      for (int j = 1; j < kw; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[nt][e] += wred[((warp + j) * NT * 4 + nt * 4 + e) * 32 + lane];
    }
  }
  const bool writer = kp == 0;
  float* yt = reinterpret_cast<float*>(smem + L.yt);
  // The panel's first column and width, recomputed rather than held
  // across the loop.
  const int PCe = warp_cols<GATED>() * (8 / p.kw), c0e = fresh_ctaid_x() * PCe;
  int ylo = 0, ycols = PCe;  // the block's share of the panel's columns

  // Lane (g, t) of a writer holds rows m = 8 nt + 2 t (+1) of fragment rows
  // g (acc 0, 1) and g + 8 (acc 2, 3).
  if (S == 1) {
    if (writer) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * nt + 2 * t + e;
          if (m >= M) continue;
          if constexpr (GATED) {
            if (rows.n0 < N)
              store_out(p, (size_t)m * N + rows.n0,
                        finish<true>(p, acc[nt][e], acc[nt][2 + e]));
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = row_n<false>(rows, h);
              if (n < N)
                emit(p, m, n, finish<false>(p, acc[nt][2 * h + e], 0.f),
                     yt + m * PCe + n - c0e);
            }
          }
        }
    }
    if (!post) return;
  } else {
    // Split K over the cluster's S blocks: each block leaves its partial
    // products [M, NB * PC] in its shared memory, and block r adds the S
    // partials of its share of the panel's columns in split order.
    constexpr int NB = GATED ? 2 : 1;
    const int W = NB * PCe;
    if (writer) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * nt + 2 * t + e;
          if (m >= M) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row_n<GATED>(rows, h) < N)
              red[m * W + (GATED ? h * PCe : 0) + row_n<GATED>(rows, h) -
                  c0e] = acc[nt][2 * h + e];
        }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = (int)cluster.block_rank();
    ylo = rank * PCe / S;
    ycols = (rank + 1) * PCe / S - ylo;
    for (int i = fresh_tid_x(); i < M * ycols; i += kDecodeThreads) {
      const int m = i / ycols, cl = ylo + i % ycols;
      if (c0e + cl >= N) continue;
      float v1 = 0.f, v2 = 0.f;
      for (int sp = 0; sp < S; ++sp) {
        const float* peer = cluster.map_shared_rank(red, sp) + m * W + cl;
        v1 += peer[0];
        if constexpr (GATED) v2 += peer[PCe];
      }
      const float v = finish<GATED>(p, v1, v2);
      if constexpr (GATED)
        store_out(p, (size_t)m * N + c0e + cl, v);
      else
        emit(p, m, c0e + cl, v, yt + m * ycols + cl - ylo);
    }
    cluster.sync();  // every block's partials stay until their readers are done
    if (!post) return;
  }

  // The post-norm: this block's partial sums of squares (blocks in column
  // order: panel, then rank), then the ticket and the last block's tail.
  __syncthreads();
  const int cnt = max(0, min(ycols, N - c0e - ylo));
  post_partials(p, yt, ycols, cnt, blockIdx.x * gridDim.y + blockIdx.y);
  float* mul = reinterpret_cast<float*>(smem + L.mul);
  if (p.coop)
    post_grid(p, yt, ycols, cnt, c0e + ylo, gridDim.x * gridDim.y, mul);
  else
    post_tail(p, gridDim.x * gridDim.y, mul);
}

// The kernels by name, one pair per codec, so the launch counters and the
// profiler tell the kinds apart (the last template argument is GATED).
#define GEMMA_DECODE_KERNELS(KIND, CODEC)                                     \
  template <int NT, bool GATED>                                              \
  __global__ void __launch_bounds__(kDecodeThreads,                          \
                                    blocks_per_sm(CODEC, NT, false))         \
      mm_##KIND##_kernel(DecodeArgs p) {                                     \
    decode_body<CODEC, NT, GATED, false>(p);                                 \
  }                                                                          \
  template <int NT, bool GATED>                                              \
  __global__ void __launch_bounds__(kDecodeThreads,                          \
                                    blocks_per_sm(CODEC, NT, true))          \
      mm_stacked_##KIND##_kernel(DecodeArgs p) {                             \
    decode_body<CODEC, NT, GATED, true>(p);                                  \
  }

GEMMA_DECODE_KERNELS(i8, kI8)
GEMMA_DECODE_KERNELS(sfp, kSfp)
GEMMA_DECODE_KERNELS(bf16, kBf16)
GEMMA_DECODE_KERNELS(f32, kF32)
GEMMA_DECODE_KERNELS(i4, kI4)
GEMMA_DECODE_KERNELS(nuq4, kNuq4)

using DecodeKernel = void (*)(DecodeArgs);

template <int CODEC, int NT, bool GATED, bool STACKED>
static DecodeKernel decode_kernel() {
#define GEMMA_PICK(KIND, CODE)                  \
  if constexpr (CODEC == CODE) {                \
    if constexpr (STACKED)                      \
      return &mm_stacked_##KIND##_kernel<NT, GATED>; \
    else                                        \
      return &mm_##KIND##_kernel<NT, GATED>;    \
  }
  GEMMA_PICK(i8, kI8)
  GEMMA_PICK(sfp, kSfp)
  GEMMA_PICK(bf16, kBf16)
  GEMMA_PICK(f32, kF32)
  GEMMA_PICK(i4, kI4)
  GEMMA_PICK(nuq4, kNuq4)
#undef GEMMA_PICK
  return nullptr;
}

// One launch: the grid (panels, splits), in clusters of (1, splits) where
// splits > 1.
template <int CODEC, int NT, bool GATED, bool STACKED>
static cudaError_t launch_one(const DecodeArgs& p, dim3 grid, int smem,
                              cudaStream_t st) {
  const DecodeKernel k = decode_kernel<CODEC, NT, GATED, STACKED>();
  // Once per kernel: allow the dynamic shared memory past 48 KB.
  static const cudaError_t attr = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, kDecodeSmemMax);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = grid.y;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = grid.y > 1 ? 1 : 0;  // a cluster only where K is split
  DecodeArgs q = p;
  if (p.post_w != nullptr) {
    // The post-norm's grid barrier where every block fits on the card at
    // once (clusters of the split counted as the runtime would place
    // them): a cooperative launch, which guarantees they are resident;
    // else the last block's tail.
    static int fit_smem = -1, fit_y = 0, fit = 0;  // clusters that fit
    if (smem != fit_smem || (int)grid.y != fit_y) {
      cudaError_t e;
      if (grid.y > 1) {
        e = cudaOccupancyMaxActiveClusters(&fit, k, &cfg);
      } else {
        int dev = 0, sms = 0;
        e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
          e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (e == cudaSuccess)
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &fit, k, kDecodeThreads, (size_t)smem);
        fit *= sms;
      }
      if (e != cudaSuccess) return e;
      fit_smem = smem;
      fit_y = (int)grid.y;
    }
    q.coop = (int)grid.x <= fit;
    if (q.coop) {
      at[cfg.numAttrs] = at[1];
      ++cfg.numAttrs;
    }
  }
  return cudaLaunchKernelEx(&cfg, k, q);
}

// False when K, N or (nuq4) the tables' row stride is not what the kernel
// walks: whole chunks, whole fragment rows (N a multiple of 8), table rows
// of nuq4_tstride(K) bytes.
template <int CODEC>
static bool set_w(DecodeArgs& p, int b, const BOperand& w, int N, int K) {
  p.codes[b] = w.codes;
  p.aux[b] = w.inv;
  p.zp[b] = w.zp;
  p.scale[b] = w.scale;
  if (CODEC == kNuq4) p.tstride = w.tstride;
  if (K % Codec<CODEC>::kChunk || N % 8 || N < 8) return false;
  if constexpr (CODEC == kNuq4) return w.tstride == nuq4_tstride(K);
  return true;
}

// The dynamic shared memory of a launch, or -1 when the entry refuses it:
// rows of A past kDecodeRows (matmul_sm90.cu's), a split outside [1,
// min(chunks, kMaxSplits)], kw not 1, 2, 4 or 8, a post-norm without its
// scratch, or a pointer the kernel reads in 16-byte words (out: 8)
// misaligned.
template <int CODEC, bool GATED>
static int decode_check(const DecodeArgs& p) {
  const int chunks = p.K / Codec<CODEC>::kChunk, S = p.splits;
  const bool post = p.post_w != nullptr;
  auto odd = [](const void* q, int b) {
    return (reinterpret_cast<uintptr_t>(q) & (b - 1)) != 0;
  };
  if (p.M < 1 || p.M > kDecodeRows || S < 1 || S > chunks ||
      S > kMaxSplits || (p.kw != 1 && p.kw != 2 && p.kw != 4 && p.kw != 8) ||
      (post && (p.y == nullptr || p.slots == nullptr || p.ticket == nullptr)) ||
      odd(p.a, 16) || odd(p.a32, 16) || odd(p.norm, 16) || odd(p.post_w, 16) ||
      odd(p.add, 16) || odd(p.y, 16) || odd(p.out, 8))
    return -1;
  const int smem = decode_smem<CODEC, GATED>(p.M, p.K, S, p.kw,
                                             p.norm != nullptr, post).bytes;
  return smem > kDecodeSmemMax ? -1 : smem;
}

template <int CODEC, bool GATED>
static cudaError_t launch_decode(DecodeArgs& p, const int* layer, int smem,
                                 cudaStream_t st) {
  p.layer = layer;
  const int pc = warp_cols<GATED>() * (8 / p.kw);
  const dim3 grid((p.N + pc - 1) / pc, p.splits);
  if (layer != nullptr)
    return p.M > 8 ? launch_one<CODEC, 2, GATED, true>(p, grid, smem, st)
                   : launch_one<CODEC, 1, GATED, true>(p, grid, smem, st);
  return p.M > 8 ? launch_one<CODEC, 2, GATED, false>(p, grid, smem, st)
                 : launch_one<CODEC, 1, GATED, false>(p, grid, smem, st);
}

// A as the kernel reads it: bf16 `a`, or f32 `a` with the prologue's
// weights `norm`, normalized in the kernel.
static void set_a(DecodeArgs& p, const void* a, const float* norm) {
  p.norm = norm;
  if (norm != nullptr)
    p.a32 = static_cast<const float*>(a);
  else
    p.a = static_cast<const __nv_bfloat16*>(a);
}

// out = add + postnorm(scale * A . B^T), A optionally RMS-normalized first,
// in one launch.  Under a post-norm: y, f32 [M, N] for the raw products
// (may be out when out is f32), slots, f32 [blocks, M] (blocks = panels x
// splits), and ticket, one int that is zero between launches (the last
// block re-zeroes it; launches that share it must not overlap).  layer:
// null (K1), or the device layer index of stacked weights (K12).  splits:
// the blocks that share the K of a panel (see the note above).
template <int CODEC>
static int matmul_entry(const void* a, const float* norm, const BOperand& w,
                        const int* layer, int kw, int splits,
                        const float* post_w, const float* add, float* y,
                        float* slots, int* ticket, void* out, int M, int N,
                        int K, int out_bf16, int* launched, cudaStream_t st) {
  *launched = 0;
  DecodeArgs p = {};
  p.M = M; p.N = N; p.K = K;
  p.kw = kw;
  p.splits = splits;
  if (!set_w<CODEC>(p, 0, w, N, K) || !set_w<CODEC>(p, 1, w, N, K))
    return (int)cudaErrorInvalidValue;
  set_a(p, a, norm);
  p.post_w = post_w; p.add = add; p.y = y; p.slots = slots; p.ticket = ticket;
  p.out = out; p.out_bf16 = out_bf16;
  const int smem = decode_check<CODEC, false>(p);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = launch_decode<CODEC, false>(p, layer, smem, st);
  if (e != cudaSuccess) return (int)e;
  *launched = kLaunchedSelf;
  return (int)cudaGetLastError();
}

template <int CODEC>
static int gated_entry(const void* a, const float* norm, const BOperand& w1,
                       const BOperand& w2, const int* layer, int kw, int splits,
                       void* out, int M, int N, int K, int* launched,
                       cudaStream_t st) {
  *launched = 0;
  DecodeArgs p = {};
  p.M = M; p.N = N; p.K = K;
  p.kw = kw;
  p.splits = splits;
  if (!set_w<CODEC>(p, 0, w1, N, K) || !set_w<CODEC>(p, 1, w2, N, K))
    return (int)cudaErrorInvalidValue;
  set_a(p, a, norm);
  p.out = out; p.out_bf16 = 1;
  const int smem = decode_check<CODEC, true>(p);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = launch_decode<CODEC, true>(p, layer, smem, st);
  if (e != cudaSuccess) return (int)e;
  *launched = kLaunchedSelf;
  return (int)cudaGetLastError();
}

// The C entries, one per GEMM and codec (kind "nuq" calls the sfp ones):
// K1 and K2, then K12's (their weights stacked [L, N, K] ([L, N, K/2]
// packed), i8 / i4 group arrays [L, K/128, N], nuq4 tables [L, N,
// tstride]; the pointers are layer 0's, *layer the layer to read).  i8
// brings inv / zp, i4 its scales / mins in the same slots, nuq4 its tables
// and their row stride.

extern "C" int gemma_matmul_i8(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  return matmul_entry<kI8>(a, norm, affine_b(codes, inv, zp, scale),
                             nullptr, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_i8(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  return gated_entry<kI8>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                            affine_b(codes2, inv2, zp2, scale2), nullptr,
                            kw, splits, out, M, N, K, launched, st);
}

extern "C" int gemma_matmul_sfp(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  return matmul_entry<kSfp>(a, norm, affine_b(codes, inv, zp, scale),
                             nullptr, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_sfp(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  return gated_entry<kSfp>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                            affine_b(codes2, inv2, zp2, scale2), nullptr,
                            kw, splits, out, M, N, K, launched, st);
}

extern "C" int gemma_matmul_bf16(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  return matmul_entry<kBf16>(a, norm, affine_b(codes, inv, zp, scale),
                             nullptr, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_bf16(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  return gated_entry<kBf16>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                            affine_b(codes2, inv2, zp2, scale2), nullptr,
                            kw, splits, out, M, N, K, launched, st);
}

extern "C" int gemma_matmul_f32(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  return matmul_entry<kF32>(a, norm, affine_b(codes, inv, zp, scale),
                             nullptr, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_f32(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  return gated_entry<kF32>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                            affine_b(codes2, inv2, zp2, scale2), nullptr,
                            kw, splits, out, M, N, K, launched, st);
}

extern "C" int gemma_matmul_i4(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  return matmul_entry<kI4>(a, norm, affine_b(codes, inv, zp, scale),
                             nullptr, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_i4(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  return gated_entry<kI4>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                            affine_b(codes2, inv2, zp2, scale2), nullptr,
                            kw, splits, out, M, N, K, launched, st);
}

extern "C" int gemma_matmul_nuq4(
    const void* a, const float* norm,
    const void* codes, const void* tables, int tstride, float scale,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  return matmul_entry<kNuq4>(a, norm, nuq4_b(codes, tables, tstride, scale),
                             nullptr, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_nuq4(
    const void* a, const float* norm,
    const void* codes1, const void* tables1, int tstride1, float scale1,
    const void* codes2, const void* tables2, int tstride2, float scale2,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  return gated_entry<kNuq4>(a, norm, nuq4_b(codes1, tables1, tstride1, scale1),
                            nuq4_b(codes2, tables2, tstride2, scale2), nullptr,
                            kw, splits, out, M, N, K, launched, st);
}

extern "C" int gemma_matmul_stacked_i8(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    const int* layer,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kI8>(a, norm, affine_b(codes, inv, zp, scale),
                             layer, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_stacked_i8(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kI8>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                            affine_b(codes2, inv2, zp2, scale2), layer,
                            kw, splits, out, M, N, K, launched, st);
}

extern "C" int gemma_matmul_stacked_sfp(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    const int* layer,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kSfp>(a, norm, affine_b(codes, inv, zp, scale),
                             layer, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_stacked_sfp(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kSfp>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                            affine_b(codes2, inv2, zp2, scale2), layer,
                            kw, splits, out, M, N, K, launched, st);
}

extern "C" int gemma_matmul_stacked_bf16(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    const int* layer,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kBf16>(a, norm, affine_b(codes, inv, zp, scale),
                             layer, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_stacked_bf16(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kBf16>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                            affine_b(codes2, inv2, zp2, scale2), layer,
                            kw, splits, out, M, N, K, launched, st);
}

extern "C" int gemma_matmul_stacked_f32(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    const int* layer,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kF32>(a, norm, affine_b(codes, inv, zp, scale),
                             layer, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_stacked_f32(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kF32>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                            affine_b(codes2, inv2, zp2, scale2), layer,
                            kw, splits, out, M, N, K, launched, st);
}

extern "C" int gemma_matmul_stacked_i4(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    const int* layer,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kI4>(a, norm, affine_b(codes, inv, zp, scale),
                             layer, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_stacked_i4(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kI4>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                            affine_b(codes2, inv2, zp2, scale2), layer,
                            kw, splits, out, M, N, K, launched, st);
}

extern "C" int gemma_matmul_stacked_nuq4(
    const void* a, const float* norm,
    const void* codes, const void* tables, int tstride, float scale,
    const int* layer,
    int kw, int splits, const float* post_w, const float* add, float* y,
    float* slots, int* ticket, void* out, int M, int N, int K, int out_bf16,
    int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kNuq4>(a, norm, nuq4_b(codes, tables, tstride, scale),
                             layer, kw, splits, post_w, add, y, slots,
                             ticket, out, M, N, K, out_bf16, launched,
                             st);
}

extern "C" int gemma_gated_stacked_nuq4(
    const void* a, const float* norm,
    const void* codes1, const void* tables1, int tstride1, float scale1,
    const void* codes2, const void* tables2, int tstride2, float scale2,
    const int* layer,
    int kw, int splits, void* out, int M, int N, int K, int* launched,
    cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kNuq4>(a, norm, nuq4_b(codes1, tables1, tstride1, scale1),
                            nuq4_b(codes2, tables2, tstride2, scale2), layer,
                            kw, splits, out, M, N, K, launched, st);
}
