// What the GEMM sources share: matmul.cu (the heads K3 and K6),
// matmul_decode.cu (K1 and K2 at M <= 16, the decode tile) and
// matmul_sm90.cu (K1 and K2 at M > 16, the prefill tile).  The weight
// codecs' element decoders (gemma_tpu/ops/matmul.py:_acc_step and
// _sfp_tile_to_bf16; the i8 byte converters are common.cuh's), the walk of
// K in 128-byte chunks that the heads and the decode tile share, the
// decode tile's warp (its register ring and chunk product, which K3 and K6 run
// too) with the prologue norm and the post-norm epilogue folded into it,
// the norm passes that the prefill tile chains around its kernels,
// and the B operand as the C entries receive it.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace gemma {

enum : int { kI8 = 0, kSfp = 1, kBf16 = 2, kF32 = 3, kI4 = 4, kNuq4 = 5 };

// The bytes of a row of nuq4 tables: 16 per 256-block of K, padded to a
// multiple of 128 (the layout the tables are loaded in).
__host__ __device__ __forceinline__ int nuq4_tstride(int K) {
  return (K / 256 * 16 + 127) / 128 * 128;
}

// Each 16-bit lane of the result: 0xffff where bit 7 of the lane's low
// byte of x is set, else 0 (prmt's sign-replicate mode: a selector nibble
// with bit 3 set copies the sign of the byte it names into every bit).
__device__ __forceinline__ uint32_t lane_mask_bit7(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(0u), "r"(0xaa88u));
  return r;
}

// Two SFP bytes, one in the low byte of each 16-bit lane of x, -> two bf16
// (matmul.py:_sfp_tile_to_bf16).  The lane masks come from byte
// permutes in sign mode: v >= 64 is bit 6 of v (bit 7 after a shift), v
// != 0 bit 7 of v + 127; no step carries from one lane into the other (v
// <= 127).
__device__ __forceinline__ uint32_t sfp2_to_bf16x2(uint32_t x) {
  const uint32_t v = x & 0x007f007fu;
  const uint32_t big = lane_mask_bit7(v << 1);           // v >= 64
  const uint32_t nz = lane_mask_bit7(v + 0x007f007fu);   // v != 0
  const uint32_t lo = 0x34003400u + (v << 5);
  const uint32_t hi = 0x38003800u + (v << 4);
  return (((lo & ~big) | (hi & big)) & nz) | ((x << 8) & 0x80008000u);
}

// i4: the four nibbles at position nb (0 low, 1 high) of the bytes of x ->
// two bf16x2 words (bytes 0,1 and 2,3), exactly: a nibble c under the byte
// 0x43 is the bf16 128 + c (ulp 1 in [128, 256)), minus 128 is c.
__device__ __forceinline__ void i4_frag(uint32_t x, int nb, uint32_t* bf) {
  const uint32_t n4 = (x >> (4 * nb)) & 0x0f0f0f0fu;
  uint32_t raw[2] = {__byte_perm(n4, 0x43434343u, 0x4140u),
                     __byte_perm(n4, 0x43434343u, 0x4342u)};
  uint32_t bias = 0x43004300u;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const __nv_bfloat162 d = __hsub2(
        *reinterpret_cast<__nv_bfloat162*>(&raw[e]),
        *reinterpret_cast<__nv_bfloat162*>(&bias));
    bf[e] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

// nuq4: the four 4-bit codes in the nibbles of the low 16 bits of `sel`
// -> their four SFP table bytes (byte i of the result for nibble i);
// `tbl` holds the 256-block's 16 table bytes.  A byte permute selects
// among 8 bytes by the low three bits of each selector nibble (its fourth
// bit would replicate a sign instead), so: pick from entries 0-7 and from
// entries 8-15 by the codes' low three bits, then between the two by each
// code's fourth bit.
__device__ __forceinline__ uint32_t nuq4_lookup4(uint32_t sel,
                                                 const uint4& tbl) {
  const uint32_t s7 = sel & 0x7777u;
  const uint32_t lo = __byte_perm(tbl.x, tbl.y, s7);
  const uint32_t hi = __byte_perm(tbl.z, tbl.w, s7);
  return __byte_perm(lo, hi, 0x3210u | ((sel >> 1) & 0x4444u));
}

// nuq4 tables decoded once per 256-block instead of once per weight: the
// 16 bf16 entries as two byte planes, `lo` holding byte 0 and `hi` byte 1
// of every entry (entry e in byte e % 4 of word e / 4, as the SFP bytes lie
// in the table).  Each of the 4 lanes of a weight row decodes the 4 entries
// of word t of the row's table (`x`); the planes are gathered from the 4
// lanes by shuffles within the group of 4.
__device__ __forceinline__ void nuq4_planes(uint32_t x, uint4& lo, uint4& hi) {
  const uint32_t w0 = sfp2_to_bf16x2(__byte_perm(x, 0, 0x4140u));  // e0, e1
  const uint32_t w1 = sfp2_to_bf16x2(__byte_perm(x, 0, 0x4342u));  // e2, e3
  const uint32_t l = __byte_perm(w0, w1, 0x6420u);
  const uint32_t h = __byte_perm(w0, w1, 0x7531u);
  lo = make_uint4(__shfl_sync(0xffffffffu, l, 0, 4), __shfl_sync(0xffffffffu, l, 1, 4),
                  __shfl_sync(0xffffffffu, l, 2, 4), __shfl_sync(0xffffffffu, l, 3, 4));
  hi = make_uint4(__shfl_sync(0xffffffffu, h, 0, 4), __shfl_sync(0xffffffffu, h, 1, 4),
                  __shfl_sync(0xffffffffu, h, 2, 4), __shfl_sync(0xffffffffu, h, 3, 4));
}

// nuq4 by the planes: the four codes of `sel` (two packed bytes, elements
// j, 128 + j, j + 1, 129 + j) -> bf[0] = (j, j + 1), bf[1] = (128 + j,
// 129 + j) as bf16x2: one table select per plane and two byte permutes
// that set each entry's low and high byte side by side.
__device__ __forceinline__ void nuq4_plane_frag(uint32_t sel, const uint4& lo,
                                                const uint4& hi,
                                                uint32_t* bf) {
  const uint32_t l = nuq4_lookup4(sel, lo), h = nuq4_lookup4(sel, hi);
  bf[0] = __byte_perm(l, h, 0x6240u);
  bf[1] = __byte_perm(l, h, 0x7351u);
}

// A codec's element size and what follows from it: a lane loads 16 bytes
// (kEpl elements) from each half of a chunk, the 4 lanes of a weight row
// cover 64 bytes per half, so a chunk (128 bytes of a row) spans 8 * kEpl
// of K in kEpl / 2 steps of mma.sync m16n8k16 (each lane brings 4 K per
// step).  The packed kinds hold two elements a byte; i4's chunk is two
// 128-wide affine groups.
template <int CODEC>
struct Codec {
  static constexpr bool kPacked = CODEC == kI4 || CODEC == kNuq4;
  static constexpr int kEsize = CODEC == kBf16 ? 2 : CODEC == kF32 ? 4 : 1;
  static constexpr int kEpl = kPacked ? 32 : 16 / kEsize;
  static constexpr int kChunk = 8 * kEpl;  // 256, 128, 64, 32 elements
  static constexpr int kSteps = kEpl / 2;  // 16, 8, 4, 2
  static constexpr int kGroups = CODEC == kI4 ? 2 : 1;  // per chunk
};

__device__ __forceinline__ uint32_t word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// The fragment (k, k+1 | k+2, k+3 as two bf16x2 words) of step `w` of the
// half-chunk a lane holds in `q`, for the one-byte and dense codecs.
template <int CODEC>
__device__ __forceinline__ void b_frag(const uint4& q, int w, uint32_t* bf) {
  if constexpr (CODEC == kI8) {
    i8x4_to_bf16x2(word_of(q, w), bf);
  } else if constexpr (CODEC == kSfp) {
    const uint32_t x = word_of(q, w);
    bf[0] = sfp2_to_bf16x2(__byte_perm(x, 0, 0x4140u));
    bf[1] = sfp2_to_bf16x2(__byte_perm(x, 0, 0x4342u));
  } else if constexpr (CODEC == kBf16) {
    bf[0] = word_of(q, 2 * w);
    bf[1] = word_of(q, 2 * w + 1);
  } else {
    bf[0] = pack_bf16x2(__uint_as_float(q.x), __uint_as_float(q.y));
    bf[1] = pack_bf16x2(__uint_as_float(q.z), __uint_as_float(q.w));
  }
}

// ---------------------------------------------------------------------------
// The decode tile's warp (matmul_decode.cu's K1 / K2 / K12 at M <= 16 rows,
// matmul.cu's heads K3 and K6): a warp's 16 weight rows, decoded in
// registers, are mma.sync's 16-row operand and A^T (staged in shared
// memory) the 8-wide one; a lane streams its rows' bytes through a
// register ring of 128-byte chunks (matmul_decode.cu's note has the
// design).

constexpr int kDecodeThreads = 256;  // 8 warps, each 16 weight rows

// The output columns of a warp's fragment rows: K1 16 weight rows, K2 8
// of each gate; a block's panel is those of its 8 / kw row groups.
template <bool GATED>
__host__ __device__ constexpr int warp_cols() {
  return GATED ? 8 : 16;
}

struct DecodeArgs {
  const __nv_bfloat16* a;  // [M, K] bf16, or null under a prologue norm
  const float* a32;        // prologue: f32 A [M, K], normalized in-kernel
  const float* norm;       // prologue: RMSNorm weights [K], or null
  const void* codes[2];    // [N, K] of the codec's element ([N, K/2] packed)
  // i8: inverse scales, i4: scales, f32 [N, K/128] ([G, N] stacked);
  // nuq4: the tables, u8 [N, tstride]
  const void* aux[2];
  const float* zp[2];  // i8: zero points, i4: mins
  float scale[2];
  const int* layer;    // stacked: device int32, the layer to read
  void* out;           // [M, N], f32 or bf16
  // Epilogue: out = add + postnorm(C), either may be null.  Under a post
  // norm every block leaves its rows' partial sums of squares in slots
  // [blocks, M]; then a grid barrier (coop), or its raw columns in y ([M,
  // N] f32, may be out) and a ticket, the last block finishing every row.
  const float* post_w;
  const float* add;
  float* y;
  float* slots;
  int* ticket;
  int coop;  // launched cooperatively: the post-norm meets at a grid barrier
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
__device__ __forceinline__ void consume_chunk(const Slot& s,
                                             const __nv_bfloat16* As, int SA,
                                             int kc, int M, int g, int t,
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

// ---------------------------------------------------------------------------
// The K1 / K2 prologue norm (gemma_tpu/ops/matmul.py:_norm_a) folded into
// the staging of A: m = a * (1 / sqrtf(ss / K + 1e-6)), A = bf16(m + m * w),
// as prenorm_kernel computes it, with ss, the row's f32 sum of squares
// over the logical K, taken in one fixed order whatever the rows, the split
// of K or the warps: squares of kNormSeg consecutive K summed as
// norm_segments says, then the K / kNormSeg segment sums as norm_row_mul
// says (ops/matmul.py:prenorm_fixed_order emulates both).  The squares and
// sums use the _rn intrinsics, so no multiply-add is contracted.

constexpr int kNormSeg = 32;  // K of one partial sum of squares

__device__ __forceinline__ float sq_add(float s, float x) {
  return __fadd_rn(s, __fmul_rn(x, x));
}

// blockIdx.x and threadIdx.x read afresh: a value wanted after a long loop
// is recomputed there instead of held in a register across it.
__device__ __forceinline__ int fresh_ctaid_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int fresh_tid_x() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// 1 / sqrtf(ss / K + 1e-6) of one row, by one warp: seg(s) points at the
// row's segment s; lane l adds segments l, l + 32, ... in turn, and the 32
// lanes meet in a butterfly (xor 16, 8, 4, 2, 1).
template <typename SegAt>
__device__ __forceinline__ float norm_row_mul(int K, int lane, SegAt seg) {
  float ss = 0.f;
  for (int s = lane; s < K / kNormSeg; s += 32) ss = __fadd_rn(ss, *seg(s));
  ss = warp_sum(ss);
  return 1.0f / sqrtf(ss / (float)K + 1e-6f);
}

// x normalized by the row's multiplier r and scaled by (1 + w).
__device__ __forceinline__ float norm1(float x, float w, float r) {
  const float m = __fmul_rn(x, r);
  return __fmaf_rn(m, w, m);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

// Staging bf16 A: every copy a cp.async, issued all at once and waited for
// once, so a block's A crosses from L2 in one round trip and through no
// registers (a loop of loads and stores waits one round trip an item).

// Rows [0, M) of bf16 a (row stride K), K [k0, k0 + 8 n8), into As (row
// stride SA elements): two 8-byte copies an 8-element item (the rows'
// 8-byte padding keeps them 8-byte aligned), four 4-byte ones for nuq4's
// 4-byte padding (PAD 2).  The caller syncs the block.
template <int PAD>
__device__ __forceinline__ void copy_stage(const __nv_bfloat16* a, int K,
                                           int k0, int n8, int M,
                                           __nv_bfloat16* As, int SA) {
  for (int i = threadIdx.x; i < M * n8; i += kDecodeThreads) {
    const int m = i / n8, j = i - m * n8;
    const __nv_bfloat16* src = a + (size_t)m * K + k0 + 8 * j;
    __nv_bfloat16* dst = As + (size_t)m * SA + 8 * j;
    if constexpr (PAD % 4 == 0) {
      cp_async8(dst, src);
      cp_async8(dst + 4, src + 4);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) cp_async4(dst + 2 * q, src + 2 * q, 4);
    }
  }
  cp_async_commit();
  cp_async_wait(0);
}

// The sums of squares of the kNormSeg-wide segments of rows [0, M) of a32
// (row stride K) in K [k0, k1): segs[m * ld + s] for segment k0 / kNormSeg
// + s.  Eight lanes take a segment, lane j its 4 consecutive K: ((x0^2 +
// x1^2) + x2^2) + x3^2, then a butterfly over the 8 lanes (xor 4, 2, 1).
// A warp has 4 x kNormU segments in flight (more spilled registers in the
// decode tile).
constexpr int kNormU = 3;
__device__ __forceinline__ void norm_segments(const float* a32, int K, int k0,
                                              int k1, int M, float* segs,
                                              int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane >> 3, j = lane & 7;
  const int nseg = (k1 - k0) / kNormSeg, total = M * nseg;
  constexpr int kSweep = 4 * kDecodeThreads / 32;  // segments of all warps
  for (int base = 4 * warp; base < total; base += kSweep * kNormU) {
    float4 x[kNormU];
#pragma unroll
    for (int u = 0; u < kNormU; ++u) {
      const int i = base + kSweep * u + q;
      x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total) {
        const int m = i / nseg, s = i - m * nseg;
        x[u] = ldg4(a32 + (size_t)m * K + k0 + s * kNormSeg + 4 * j);
      }
    }
#pragma unroll
    for (int u = 0; u < kNormU; ++u) {
      float v = sq_add(sq_add(__fmul_rn(x[u].x, x[u].x), x[u].y), x[u].z);
      v = sq_add(v, x[u].w);
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
      const int i = base + kSweep * u + q;
      if (j == 0 && i < total) {
        const int m = i / nseg;
        segs[m * ld + i - m * nseg] = v;
      }
    }
  }
}

// A's K [k0, k0 + 8 n8) of rows [0, M), normalized (mul[m] the rows'
// multipliers, w the weights [K]), as bf16 into As (row stride SA).
__device__ __forceinline__ void norm_stage(const float* a32, const float* w,
                                           int K, int k0, int n8, int M,
                                           const float* mul,
                                           __nv_bfloat16* As, int SA) {
#pragma unroll 1
  for (int i = threadIdx.x; i < M * n8; i += kDecodeThreads) {
    const int m = i / n8, j = i - m * n8;
    const float* src = a32 + (size_t)m * K + k0 + 8 * j;
    const float4 x0 = ldg4(src), x1 = ldg4(src + 4);
    const float4 w0 = ldg4(w + k0 + 8 * j), w1 = ldg4(w + k0 + 8 * j + 4);
    const float r = mul[m];
    uint32_t* dst = reinterpret_cast<uint32_t*>(As + (size_t)m * SA + 8 * j);
    dst[0] = pack_bf16x2(norm1(x0.x, w0.x, r), norm1(x0.y, w0.y, r));
    dst[1] = pack_bf16x2(norm1(x0.z, w0.z, r), norm1(x0.w, w0.w, r));
    dst[2] = pack_bf16x2(norm1(x1.x, w1.x, r), norm1(x1.y, w1.y, r));
    dst[3] = pack_bf16x2(norm1(x1.z, w1.z, r), norm1(x1.w, w1.w, r));
  }
}


// ---------------------------------------------------------------------------
// The K1 post-norm + residual epilogue (matmul.py:612-626, in the order of
// postnorm_add_kernel) folded into the decode tile.  The norm needs whole
// rows of N, which no block sees, so every block leaves one partial sum of
// squares per row in p.slots (block b's at b * M + m, blocks in column
// order), and the rows' multipliers add them in one fixed order: no float
// atomics.  A cooperative launch meets at a grid barrier and each block
// finishes its own columns (post_grid); otherwise the last block to take
// the ticket finishes every row from y (post_tail).  Every thread of every
// block reaches them.

// Block `blk`'s partial sums of squares of its `cnt` columns of each row,
// yt[m * ld + j] (j < cnt): lane l adds columns l, l + 32, ... in turn,
// then the warp's butterfly.
__device__ __forceinline__ void post_partials(const DecodeArgs& p,
                                              const float* yt, int ld,
                                              int cnt, int blk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < p.M; m += kDecodeThreads / 32) {
    float ss = 0.f;
    for (int j = lane; j < cnt; j += 32) ss = sq_add(ss, yt[m * ld + j]);
    ss = warp_sum(ss);
    if (lane == 0) p.slots[(size_t)blk * p.M + m] = ss;
  }
}

// The partial sums a lane of the last block loads at a time, and the
// items (float4 of y, w and add) a thread of it has in flight.
constexpr int kPartB = 4;
constexpr int kTailB = 2;

// Each row's post-norm multiplier from the blocks' partial sums (lane l
// adds blocks l, l + 32, ... in turn, then the butterfly) into mul[].
__device__ __forceinline__ void slot_muls(const DecodeArgs& p, int nblocks,
                                          float* mul) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < p.M; m += kDecodeThreads / 32) {
    float ss = 0.f;
    for (int b0 = lane; b0 < nblocks; b0 += 32 * kPartB) {
      float part[kPartB];
#pragma unroll
      for (int u = 0; u < kPartB; ++u) {
        const int b = b0 + 32 * u;
        part[u] = b < nblocks ? __ldcg(p.slots + (size_t)b * p.M + m) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kPartB; ++u)
        if (b0 + 32 * u < nblocks) ss = __fadd_rn(ss, part[u]);
    }
    ss = warp_sum(ss);
    if (lane == 0) mul[m] = 1.0f / sqrtf(ss / (float)p.N + 1e-6f);
  }
}

// The cooperative epilogue: every block resident, they meet at a grid
// barrier once every partial is written, and each block finishes its own
// columns (yt[m * ld + j], j < cnt, output column n0 + j) from shared
// memory: out = add + (m + m * w), m = y * mul.
__device__ __forceinline__ void post_grid(const DecodeArgs& p,
                                          const float* yt, int ld, int cnt,
                                          int n0, int nblocks, float* mul) {
  const int total = p.M * cnt;
  // The first item's weight and residual load before the barrier.
  float w0 = 0.f, d0 = 0.f;
  if (threadIdx.x < total) {
    const int m = threadIdx.x / cnt, n = n0 + threadIdx.x % cnt;
    w0 = __ldg(p.post_w + n);
    if (p.add != nullptr) d0 = __ldg(p.add + (size_t)m * p.N + n);
  }
  __threadfence();
  cooperative_groups::this_grid().sync();
  slot_muls(p, nblocks, mul);
  __syncthreads();
#pragma unroll 1
  for (int i = threadIdx.x; i < total; i += kDecodeThreads) {
    const int m = i / cnt, j = i - m * cnt, n = n0 + j;
    const float w = i == threadIdx.x ? w0 : __ldg(p.post_w + n);
    const float d = i == threadIdx.x ? d0
                    : p.add != nullptr ? __ldg(p.add + (size_t)m * p.N + n)
                                       : 0.f;
    float o = norm1(yt[m * ld + j], w, mul[m]);
    if (p.add != nullptr) o = __fadd_rn(o, d);
    const size_t off = (size_t)m * p.N + n;
    if (p.out_bf16)
      static_cast<__nv_bfloat16*>(p.out)[off] = __float2bfloat16_rn(o);
    else
      static_cast<float*>(p.out)[off] = o;
  }
}

// The ticket, then the last block: each row's multiplier from the slots
// (lane l adds blocks l, l + 32, ... in turn, then the butterfly) into
// mul[], and out = add + (m + m * w), m = y * mul, over all M x N (y read
// through L2: other blocks wrote it; out may alias y).  It re-zeroes the
// ticket, so the next launch and a graph replay need no memset.
__device__ __forceinline__ void post_tail(const DecodeArgs& p, int nblocks,
                                          float* mul) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(p.ticket, 1) == nblocks - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n4 = p.M * p.N / 4;
  const float4* y4 = reinterpret_cast<const float4*>(p.y);
  // The first items' loads go out with the partials', before the
  // multipliers they wait for.
  float4 v[kTailB], w[kTailB], d[kTailB];
#pragma unroll
  for (int u = 0; u < kTailB; ++u) {
    const int i = threadIdx.x + u * kDecodeThreads;
    if (i < n4) {
      v[u] = __ldcg(y4 + i);
      w[u] = ldg4(p.post_w + (4 * i) % p.N);
      d[u] = p.add != nullptr ? ldg4(p.add + 4 * (size_t)i)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  slot_muls(p, nblocks, mul);
  __syncthreads();
  for (int i0 = threadIdx.x; i0 < n4; i0 += kTailB * kDecodeThreads) {
    if (i0 != threadIdx.x) {
#pragma unroll
      for (int u = 0; u < kTailB; ++u) {
        const int i = i0 + u * kDecodeThreads;
        if (i < n4) {
          v[u] = __ldcg(y4 + i);
          w[u] = ldg4(p.post_w + (4 * i) % p.N);
          d[u] = p.add != nullptr ? ldg4(p.add + 4 * (size_t)i)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kTailB; ++u) {
      const int i = i0 + u * kDecodeThreads;
      if (i >= n4) continue;
      const float r = mul[4 * i / p.N];
      float o[4] = {norm1(v[u].x, w[u].x, r), norm1(v[u].y, w[u].y, r),
                    norm1(v[u].z, w[u].z, r), norm1(v[u].w, w[u].w, r)};
      if (p.add != nullptr) {
        o[0] = __fadd_rn(o[0], d[u].x);
        o[1] = __fadd_rn(o[1], d[u].y);
        o[2] = __fadd_rn(o[2], d[u].z);
        o[3] = __fadd_rn(o[3], d[u].w);
      }
      if (p.out_bf16)
        reinterpret_cast<uint2*>(p.out)[i] =
            make_uint2(pack_bf16x2(o[0], o[1]), pack_bf16x2(o[2], o[3]));
      else
        reinterpret_cast<float4*>(p.out)[i] =
            make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  if (threadIdx.x == 0) *p.ticket = 0;
}

}  // namespace gemma

// The norm passes keep their names outside the namespace (the profiler's
// kernel names).
// out[m] = bf16(RMSNorm(a[m]) * (1 + w)): the GEMM prologue, f32 math,
// mean over the logical K.  One block per row.
__global__ void __launch_bounds__(256) prenorm_kernel(
    const float* a, const float* w, __nv_bfloat16* out, int K) {
  const int row = blockIdx.x;
  const float* ar = a + (size_t)row * K;
  __shared__ float red[8];
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) ss += ar[k] * ar[k];
  ss = gemma::warp_sum(ss);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) tot += red[i];
  const float mul = 1.0f / sqrtf(tot / (float)K + 1e-6f);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float m = ar[k] * mul;
    out[(size_t)row * K + k] = __float2bfloat16_rn(m + m * w[k]);
  }
}

// out[m] = (add[m]) + postnorm(y[m]) over whole rows of N; w or add may be
// null.  One block per row; out may alias y.
__global__ void __launch_bounds__(256) postnorm_add_kernel(
    const float* y, const float* w, const float* add, void* out, int N,
    int out_bf16) {
  const int row = blockIdx.x;
  const float* yr = y + (size_t)row * N;
  float mul = 1.f;
  if (w != nullptr) {
    __shared__ float red[8];
    float ss = 0.f;
    for (int k = threadIdx.x; k < N; k += blockDim.x) ss += yr[k] * yr[k];
    ss = gemma::warp_sum(ss);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += red[i];
    mul = 1.0f / sqrtf(tot / (float)N + 1e-6f);
  }
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    float v = yr[k];
    if (w != nullptr) {
      const float m = v * mul;
      v = m + m * w[k];
    }
    if (add != nullptr) v += add[(size_t)row * N + k];
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[(size_t)row * N + k] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[(size_t)row * N + k] = v;
  }
}

namespace gemma {

// Bits of an entry's `launched` report: its own kernel, then the passes.
constexpr int kLaunchedSelf = 1, kLaunchedPrenorm = 2, kLaunchedPostnorm = 4;
constexpr int kLaunchedMerge = 2;  // the top-k entries' selection

// A for the GEMM: `a` itself (bf16), or RMSNorm(a) written to a_scratch
// when a prologue norm is given (a is then f32).
static const __nv_bfloat16* operand_a(const void* a, const float* norm,
                                      __nv_bfloat16* a_scratch, int M, int K,
                                      int* launched, cudaStream_t st) {
  if (norm == nullptr) return static_cast<const __nv_bfloat16*>(a);
  prenorm_kernel<<<M, 256, 0, st>>>(static_cast<const float*>(a), norm, a_scratch, K);
  *launched |= kLaunchedPrenorm;
  return a_scratch;
}

// One B operand as the C entries receive it: the affine kinds bring
// inv/zp (i8) or scales/mins (i4); nuq4 brings its tables, which travel in
// the `inv` slot (it has no other use for it, so the kernels' argument
// block is the same for every codec), and their row stride in bytes.
struct BOperand {
  const void* codes;
  const float* inv;
  const float* zp;
  float scale;
  int tstride;
};

static BOperand affine_b(const void* codes, const float* inv, const float* zp,
                         float scale) {
  return {codes, inv, zp, scale, 0};
}

static BOperand nuq4_b(const void* codes, const void* tables, int tstride,
                       float scale) {
  return {codes, static_cast<const float*>(tables), nullptr, scale, tstride};
}

}  // namespace gemma
