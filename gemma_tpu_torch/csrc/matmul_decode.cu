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
// sum(A_g) the f32 sum of the group's bf16 A.  One C entry per GEMM chains
// the norm passes of gemm_common.cuh around its kernel (prenorm_kernel
// before, postnorm_add_kernel after: the post-norm needs whole rows of N,
// which blocks that split N cannot see) and reports through `launched`
// which kernels it put on the stream.
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
//    free of bank conflicts), instead of every block re-reading A from L2
//    at every step.
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
// Columns past N and rows past M are never written.  N must be a multiple
// of 8 (whole fragment rows; odd N is refused), K a multiple of the
// codec's chunk.

#include <cooperative_groups.h>

#include "gemm_common.cuh"

namespace cg = cooperative_groups;
using namespace gemma;

constexpr int kDecodeRows = 16;    // the entries refuse more rows of A
constexpr int kDecodeThreads = 256;  // 8 warps, each 16 weight rows
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

// The output columns of a warp's fragment rows: K1 16 weight rows, K2 8
// of each gate; a block's panel is those of its 8 / kw row groups.
template <bool GATED>
__host__ __device__ constexpr int warp_cols() {
  return GATED ? 8 : 16;
}

struct DecodeArgs {
  const __nv_bfloat16* a;  // [M, K]
  const void* codes[2];    // [N, K] of the codec's element ([N, K/2] packed)
  // i8: inverse scales, i4: scales, f32 [N, K/128] ([G, N] stacked);
  // nuq4: the tables, u8 [N, tstride]
  const void* aux[2];
  const float* zp[2];  // i8: zero points, i4: mins
  float scale[2];
  const int* layer;    // stacked: device int32, the layer to read
  void* out;           // [M, N], f32 or bf16
  int M, N, K, out_bf16;
  int kw;      // warps of a block that split its K (1, 2, 4 or 8)
  int splits;  // blocks of a cluster that split the K of a panel
  int tstride;
};

// One ring slot: a lane's bytes of one chunk.
struct Slot {
  uint4 q[2][2];     // [fragment row g / g + 8][half of the chunk]
  uint32_t tab[2];   // nuq4: word t of each row's 16 table bytes
  float mul, off;    // i8 / i4: lane t's (scale, offset) pair
};

__device__ __forceinline__ uint4 ldg_nc(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The block's view of the weights, in few registers: fragment row 0's
// weight row n0 (row 1's is n0 + 8 for K1, gate 2's n0 for K2), the byte
// offset of its codes in the weight tensor, and the layer.
struct Rows {
  size_t off;
  int n0, l;
};

template <int CODEC>
__device__ __forceinline__ size_t row_bytes(const DecodeArgs& p) {
  using C = Codec<CODEC>;
  return C::kPacked ? p.K / 2 : (size_t)p.K * C::kEsize;
}

template <bool GATED>
__device__ __forceinline__ int row_n(const Rows& r, int h) {
  return GATED ? r.n0 : r.n0 + 8 * h;
}

template <int CODEC, bool GATED, bool STACKED>
__device__ __forceinline__ Rows rows_of(const DecodeArgs& p, int col0,
                                        int rg, int g) {
  Rows r;
  r.l = STACKED ? __ldg(p.layer) : 0;
  r.n0 = col0 + warp_cols<GATED>() * rg + g;
  const size_t nn = r.n0 < p.N ? (size_t)r.n0 : 0;
  r.off = ((size_t)r.l * p.N + nn) * row_bytes<CODEC>(p);
  return r;
}

// Chunk c into a slot: the codes of both fragment rows (zeros past N),
// nuq4's table word, i8 / i4's (scale, offset) pair.  N is a multiple of
// 8, so rows n0 and n0 + 8 exist or not together with their 8-row group.
template <int CODEC, bool GATED, bool STACKED>
__device__ __forceinline__ void load_slot(Slot& s, const Rows& r,
                                          const DecodeArgs& p, int c, int t) {
  using C = Codec<CODEC>;
  const size_t N = (size_t)p.N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = row_n<GATED>(r, h);
    const int gate = GATED ? h : 0;
    const bool ok = n < p.N;
    if (ok) {
      const uint8_t* src = static_cast<const uint8_t*>(p.codes[gate]) + r.off +
                           (GATED ? 0 : h * 8 * row_bytes<CODEC>(p)) +
                           (size_t)c * 128 + 16 * t;
      s.q[h][0] = ldg_nc(src);
      s.q[h][1] = ldg_nc(src + 64);
    } else {
      s.q[h][0] = s.q[h][1] = make_uint4(0, 0, 0, 0);
    }
    if constexpr (CODEC == kNuq4)
      s.tab[h] = ok ? __ldg(reinterpret_cast<const uint32_t*>(
                          static_cast<const uint8_t*>(p.aux[gate]) +
                          ((size_t)r.l * N + n) * p.tstride + c * 16 + 4 * t))
                    : 0u;
  }
  if constexpr (CODEC == kI8 || CODEC == kI4) {
    const int h = t & 1;
    const int n = row_n<GATED>(r, h);
    const int gi = c * C::kGroups + (C::kGroups == 2 ? t >> 1 : 0);
    s.mul = s.off = 0.f;
    if (n < p.N) {
      const size_t G = p.K / 128;
      const size_t at =
          (size_t)r.l * G * N + (STACKED ? gi * N + n : n * G + gi);
      const int gate = GATED ? h : 0;
      const float m = __ldg(static_cast<const float*>(p.aux[gate]) + at);
      const float z = __ldg(p.zp[gate] + at);
      s.mul = m;
      s.off = CODEC == kI8 ? -(m * z) : z;
    }
  }
}

// D += ones(16 x 8) . B(8 x 8): the sums over 8 K of each column of B (a
// row of A) in every row of D (mma.sync m16n8k8, bf16 in, f32 out).
__device__ __forceinline__ void ones_mma(float* d, uint32_t b) {
  const uint32_t one = 0x3f803f80u;  // bf16 1.0, 1.0
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%4}, {%5}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(one), "r"(b));
}

// One chunk of the product: decode, multiply, close the affine groups.
// As: the block's A slice (row stride SA elements, column 0 = chunk c0's
// first K); kc: the chunk's first column in the slice.  i8 / i4 take the
// group sums of A on the tensor cores beside the product: an operand of
// ones times the step's A^T (two m16n8k8, one for each register of the
// B fragment) gives, in the accumulator layout of the outputs (rows 2t,
// 2t + 1 of A), the sums over the step's K.
template <int CODEC, int NT>
__device__ __forceinline__ void consume(const Slot& s, const __nv_bfloat16* As,
                                       int SA, int kc, int M, int g, int t,
                                       int lane, float (&acc)[NT][4],
                                       float (&part)[NT][4],
                                       float (&asum)[NT][4]) {
  using C = Codec<CODEC>;
  constexpr bool AFF = CODEC == kI8 || CODEC == kI4;
  constexpr bool NUQ = CODEC == kNuq4;
  uint4 plo[2], phi[2];
  if constexpr (NUQ) {
#pragma unroll
    for (int h = 0; h < 2; ++h) nuq4_planes(s.tab[h], plo[h], phi[h]);
  }
  // The A rows of this lane's n-tiles (rows past M read as zeros).
  const __nv_bfloat16* arow[NT];
  bool aok[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    aok[nt] = 8 * nt + g < M;
    arow[nt] = As + (size_t)(aok[nt] ? 8 * nt + g : 0) * SA + kc;
  }
  constexpr int NG = C::kGroups;
  constexpr int SPG = C::kSteps / NG;  // steps per group
#pragma unroll
  for (int grp = 0; grp < NG; ++grp) {
#pragma unroll
    for (int st = 0; st < SPG; ++st) {
      int h, w, k;  // the half, its 4-byte word, the step's first column
      if constexpr (CODEC == kI4) {
        h = st / 4, w = st % 4;
        k = 128 * grp + 64 * h + 16 * t + 4 * w;
      } else if constexpr (NUQ) {
        h = st / 8, w = (st / 2) % 4;
        k = 64 * h + 16 * t + 4 * w + 2 * (st % 2);
      } else {
        constexpr int HS = C::kSteps / 2;
        h = st / HS, w = st % HS;
        k = h * (C::kChunk / 2) + C::kEpl * t + 4 * w;
      }
      uint32_t f[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if constexpr (CODEC == kI4)
          i4_frag(word_of(s.q[r][h], w), grp, f[r]);
        else if constexpr (NUQ)
          nuq4_plane_frag(word_of(s.q[r][h], w) >> (16 * (st % 2)), plo[r],
                          phi[r], f[r]);
        else
          b_frag<CODEC>(s.q[r][h], w, f[r]);
      }
      const uint32_t a[4] = {f[0][0], f[1][0], f[0][1], f[1][1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2] = {0u, 0u};
        if (aok[nt]) {
          if constexpr (NUQ) {  // columns k, k+1 and k+128, k+129
            b[0] = *reinterpret_cast<const uint32_t*>(arow[nt] + k);
            b[1] = *reinterpret_cast<const uint32_t*>(arow[nt] + k + 128);
          } else {
            const uint2 x = *reinterpret_cast<const uint2*>(arow[nt] + k);
            b[0] = x.x;
            b[1] = x.y;
          }
        }
        mma_bf16_16816(AFF ? part[nt] : acc[nt], a, b);
        if constexpr (AFF) {
          ones_mma(asum[nt], b[0]);
          ones_mma(asum[nt], b[1]);
        }
      }
    }
    if constexpr (AFF) {
      // Fragment rows 0 and 1's pair of this group, from lanes t = 2 grp
      // and 2 grp + 1 of the row (i8: group 0 only).
      const int src = (lane & ~3) | (NG == 2 ? grp << 1 : 0);
      const float s0 = __shfl_sync(0xffffffffu, s.mul, src);
      const float o0 = __shfl_sync(0xffffffffu, s.off, src);
      const float s1 = __shfl_sync(0xffffffffu, s.mul, src | 1);
      const float o1 = __shfl_sync(0xffffffffu, s.off, src | 1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float r0 = asum[nt][0], r1 = asum[nt][1];
        float* pp = part[nt];
        acc[nt][0] += s0 * pp[0] + o0 * r0;
        acc[nt][1] += s0 * pp[1] + o0 * r1;
        acc[nt][2] += s1 * pp[2] + o1 * r0;
        acc[nt][3] += s1 * pp[3] + o1 * r1;
#pragma unroll
        for (int e = 0; e < 4; ++e) pp[e] = asum[nt][e] = 0.f;
      }
    }
  }
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

  // A's slice: columns [c0, c1) chunks of all M rows, 16-byte loads.
  {
    const int n16 = (c1 - c0) * C::kChunk / 8;
    const __nv_bfloat16* src = p.a + (size_t)c0 * C::kChunk;
    for (int i = tid; i < M * n16; i += kDecodeThreads) {
      const int m = i / n16, j = i % n16;
      const uint4 v = ldg_nc(src + (size_t)m * K + 8 * j);
      uint32_t* dst = reinterpret_cast<uint32_t*>(As + (size_t)m * SA + 8 * j);
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  }
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
        consume<CODEC, NT>(ring[j], As, SA, (c - c0) * C::kChunk, M, g, t,
                           lane, acc, part, asum);
      }
    }
  }

  // The kw partial sums of a row group meet in its warp kp = 0, in order.
  float* red = reinterpret_cast<float*>(
      smem + ((size_t)M * SA * 2 + 15) / 16 * 16);
  if (kw > 1) {
    float* wred = red + (S > 1 ? M * 2 * PC : 0);  // [8][NT * 4][32]
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

  // Lane (g, t) of a writer holds rows m = 8 nt + 2 t (+1) of fragment rows
  // g (acc 0, 1) and g + 8 (acc 2, 3).
  if (S == 1) {
    if (!writer) return;
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
          for (int h = 0; h < 2; ++h)
            if (row_n<false>(rows, h) < N)
              store_out(p, (size_t)m * N + row_n<false>(rows, h),
                        finish<false>(p, acc[nt][2 * h + e], 0.f));
        }
      }
    return;
  }

  // Split K over the cluster's S blocks: each block leaves its partial
  // products [M, NB * PC] in its shared memory, and block r adds the S
  // partials of its share of the panel's columns in split order.
  constexpr int NB = GATED ? 2 : 1;
  const int W = NB * PC;
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
          red[m * W + (GATED ? h * PC : 0) + row_n<GATED>(rows, h) - col0] =
              acc[nt][2 * h + e];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int lo = rank * PC / S, cols = (rank + 1) * PC / S - lo;
  for (int i = tid; i < M * cols; i += kDecodeThreads) {
    const int m = i / cols, cl = lo + i % cols;
    if (col0 + cl >= N) continue;
    float v1 = 0.f, v2 = 0.f;
    for (int sp = 0; sp < S; ++sp) {
      const float* peer = cluster.map_shared_rank(red, sp) + m * W + cl;
      v1 += peer[0];
      if constexpr (GATED) v2 += peer[PC];
    }
    store_out(p, (size_t)m * N + col0 + cl, finish<GATED>(p, v1, v2));
  }
  cluster.sync();  // every block's partials stay until their readers are done
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
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = 1;
  at.val.clusterDim.y = grid.y;
  at.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = &at;
  cfg.numAttrs = grid.y > 1 ? 1 : 0;  // a cluster only where K is split
  return cudaLaunchKernelEx(&cfg, k, p);
}

// The block's shared memory for `splits` blocks a panel and `kw` warps a
// row group: A's slice of the longest split, padded rows, then (split K)
// the block's partial products, then (kw > 1) the warps' partial sums.
template <int CODEC, bool GATED>
static int decode_smem(int M, int K, int splits, int kw) {
  using C = Codec<CODEC>;
  const int chunks = K / C::kChunk, cmax = (chunks + splits - 1) / splits;
  const int pad = CODEC == kNuq4 ? 2 : 4;
  const int a_bytes = (M * (cmax * C::kChunk + pad) * 2 + 15) / 16 * 16;
  const int pc = warp_cols<GATED>() * (8 / kw);
  const int red = splits > 1 ? M * 2 * pc * 4 : 0;
  const int wred = kw > 1 ? 8 * (M > 8 ? 2 : 1) * 4 * 32 * 4 : 0;
  return a_bytes + red + wred;
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
// min(chunks, kMaxSplits)], kw not 1, 2, 4 or 8, A not 16-byte aligned.
template <int CODEC, bool GATED>
static int decode_check(const DecodeArgs& p, const void* a) {
  const int chunks = p.K / Codec<CODEC>::kChunk, S = p.splits;
  if (p.M < 1 || p.M > kDecodeRows || S < 1 || S > chunks ||
      S > kMaxSplits || (p.kw != 1 && p.kw != 2 && p.kw != 4 && p.kw != 8) ||
      (reinterpret_cast<uintptr_t>(a) & 15))
    return -1;
  const int smem = decode_smem<CODEC, GATED>(p.M, p.K, S, p.kw);
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

// out = add + postnorm(scale * A . B^T), A optionally RMS-normalized first.
// y: f32 [M, N] staging for the epilogue pass (may be out when out is f32).
// layer: null (K1), or the device layer index of stacked weights (K12).
// splits: the blocks that share the K of a panel (see the note above).
template <int CODEC>
static int matmul_entry(const void* a, const float* norm, const BOperand& w,
                        const int* layer, int kw, int splits,
                        const float* post_w,
                        const float* add,
                        __nv_bfloat16* a_scratch, float* y, void* out, int M,
                        int N, int K, int out_bf16, int* launched,
                        cudaStream_t st) {
  const bool post = post_w != nullptr || add != nullptr;
  *launched = 0;
  DecodeArgs p = {};
  p.M = M; p.N = N; p.K = K;
  p.kw = kw;
  p.splits = splits;
  if (!set_w<CODEC>(p, 0, w, N, K) || !set_w<CODEC>(p, 1, w, N, K))
    return (int)cudaErrorInvalidValue;
  const int smem = decode_check<CODEC, false>(p, norm != nullptr ? a_scratch : a);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  p.out = post ? static_cast<void*>(y) : out;
  p.out_bf16 = post ? 0 : out_bf16;
  p.a = operand_a(a, norm, a_scratch, M, K, launched, st);
  const cudaError_t e = launch_decode<CODEC, false>(p, layer, smem, st);
  if (e != cudaSuccess) return (int)e;
  *launched |= kLaunchedSelf;
  if (post) {
    postnorm_add_kernel<<<M, 256, 0, st>>>(y, post_w, add, out, N, out_bf16);
    *launched |= kLaunchedPostnorm;
  }
  return (int)cudaGetLastError();
}

template <int CODEC>
static int gated_entry(const void* a, const float* norm, const BOperand& w1,
                       const BOperand& w2, const int* layer, int kw, int splits,
                       __nv_bfloat16* a_scratch,
                       void* out, int M, int N, int K, int* launched,
                       cudaStream_t st) {
  *launched = 0;
  DecodeArgs p = {};
  p.M = M; p.N = N; p.K = K;
  p.kw = kw;
  p.splits = splits;
  if (!set_w<CODEC>(p, 0, w1, N, K) || !set_w<CODEC>(p, 1, w2, N, K))
    return (int)cudaErrorInvalidValue;
  const int smem = decode_check<CODEC, true>(p, norm != nullptr ? a_scratch : a);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  p.out = out; p.out_bf16 = 1;
  p.a = operand_a(a, norm, a_scratch, M, K, launched, st);
  const cudaError_t e = launch_decode<CODEC, true>(p, layer, smem, st);
  if (e != cudaSuccess) return (int)e;
  *launched |= kLaunchedSelf;
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
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  return matmul_entry<kI8>(a, norm, affine_b(codes, inv, zp, scale), nullptr,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_i8(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  return gated_entry<kI8>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                           affine_b(codes2, inv2, zp2, scale2), nullptr,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}

extern "C" int gemma_matmul_sfp(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  return matmul_entry<kSfp>(a, norm, affine_b(codes, inv, zp, scale), nullptr,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_sfp(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  return gated_entry<kSfp>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                           affine_b(codes2, inv2, zp2, scale2), nullptr,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}

extern "C" int gemma_matmul_bf16(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  return matmul_entry<kBf16>(a, norm, affine_b(codes, inv, zp, scale), nullptr,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_bf16(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  return gated_entry<kBf16>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                           affine_b(codes2, inv2, zp2, scale2), nullptr,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}

extern "C" int gemma_matmul_f32(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  return matmul_entry<kF32>(a, norm, affine_b(codes, inv, zp, scale), nullptr,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_f32(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  return gated_entry<kF32>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                           affine_b(codes2, inv2, zp2, scale2), nullptr,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}

extern "C" int gemma_matmul_i4(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  return matmul_entry<kI4>(a, norm, affine_b(codes, inv, zp, scale), nullptr,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_i4(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  return gated_entry<kI4>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                           affine_b(codes2, inv2, zp2, scale2), nullptr,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}

extern "C" int gemma_matmul_nuq4(
    const void* a, const float* norm,
    const void* codes, const void* tables, int tstride, float scale,
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  return matmul_entry<kNuq4>(a, norm, nuq4_b(codes, tables, tstride, scale), nullptr,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_nuq4(
    const void* a, const float* norm,
    const void* codes1, const void* tables1, int tstride1, float scale1,
    const void* codes2, const void* tables2, int tstride2, float scale2,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  return gated_entry<kNuq4>(a, norm, nuq4_b(codes1, tables1, tstride1, scale1),
                           nuq4_b(codes2, tables2, tstride2, scale2), nullptr,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}

extern "C" int gemma_matmul_stacked_i8(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    const int* layer,
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kI8>(a, norm, affine_b(codes, inv, zp, scale), layer,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_stacked_i8(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kI8>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                           affine_b(codes2, inv2, zp2, scale2), layer,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}

extern "C" int gemma_matmul_stacked_sfp(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    const int* layer,
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kSfp>(a, norm, affine_b(codes, inv, zp, scale), layer,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_stacked_sfp(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kSfp>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                           affine_b(codes2, inv2, zp2, scale2), layer,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}

extern "C" int gemma_matmul_stacked_bf16(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    const int* layer,
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kBf16>(a, norm, affine_b(codes, inv, zp, scale), layer,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_stacked_bf16(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kBf16>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                           affine_b(codes2, inv2, zp2, scale2), layer,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}

extern "C" int gemma_matmul_stacked_f32(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    const int* layer,
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kF32>(a, norm, affine_b(codes, inv, zp, scale), layer,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_stacked_f32(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kF32>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                           affine_b(codes2, inv2, zp2, scale2), layer,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}

extern "C" int gemma_matmul_stacked_i4(
    const void* a, const float* norm,
    const void* codes, const float* inv, const float* zp, float scale,
    const int* layer,
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kI4>(a, norm, affine_b(codes, inv, zp, scale), layer,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_stacked_i4(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kI4>(a, norm, affine_b(codes1, inv1, zp1, scale1),
                           affine_b(codes2, inv2, zp2, scale2), layer,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}

extern "C" int gemma_matmul_stacked_nuq4(
    const void* a, const float* norm,
    const void* codes, const void* tables, int tstride, float scale,
    const int* layer,
    int kw, int splits, const float* post_w,
    const float* add, __nv_bfloat16* a_scratch, float* y, void* out, int M,
    int N, int K, int out_bf16, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return matmul_entry<kNuq4>(a, norm, nuq4_b(codes, tables, tstride, scale), layer,
                            kw, splits, post_w, add, a_scratch, y,
                            out, M, N, K, out_bf16, launched, st);
}

extern "C" int gemma_gated_stacked_nuq4(
    const void* a, const float* norm,
    const void* codes1, const void* tables1, int tstride1, float scale1,
    const void* codes2, const void* tables2, int tstride2, float scale2,
    const int* layer,
    int kw, int splits, __nv_bfloat16* a_scratch,
    void* out, int M, int N, int K, int* launched, cudaStream_t st) {
  if (layer == nullptr) return (int)cudaErrorInvalidValue;
  return gated_entry<kNuq4>(a, norm, nuq4_b(codes1, tables1, tstride1, scale1),
                           nuq4_b(codes2, tables2, tstride2, scale2), layer,
                           kw, splits, a_scratch, out, M, N, K,
                           launched, st);
}
