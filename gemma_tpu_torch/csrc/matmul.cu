// The fused logits heads for Hopper (sm_90a): K3 and K6 of the port, each
// instantiated per weight codec (K7a's one-byte and dense decoders, K7b's
// 4.5-bit ones), and the C entries of the norm passes alone.
//
// Replaces gemma_tpu/ops/matmul.py:_top1_kernel (K3, the fused greedy head;
// see top1_body below), matmul.py:_topk_kernel (K6, the fused top-k head;
// see topk_body) and, inside both, matmul.py:_acc_step's i8, sfp/nuq and
// bf16/f32 branches with _sfp_tile_to_bf16 (K7a) and its nuq4 and i4
// branches (K7b).  K1 and K2 (and K12, their stacked form) are
// matmul_decode.cu's at M <= 16 rows and matmul_sm90.cu's above.  The
// heads compute
//   logits[M, N] = scale * A[M, K] . dequant(B)[N, K]^T
// without writing them, with A bf16, the B tile turned into bf16 in
// registers, products accumulated in f32.  The codecs (template parameter
// CODEC):
//   i8    codes i8 [N, K] + inv/zp f32 [N, K/128], dequant = inv*(c - zp)
//         per 128-wide K group g, applied to the OUTPUT as the TPU kernel
//         does: C += inv_g * (A_g . C_g) - (inv_g * zp_g) * sum(A_g), so
//         the codes feed the tensor cores raw (exact in bf16);
//   sfp   bytes u8 [N, K] (also kind "nuq", whose device bytes are SFP):
//         sign = bit 7, v = low 7 bits, bf16 bits 0x3400 + 32 v (v < 64) or
//         0x3800 + 16 v, 0 for v = 0 (byte 0x80 is -0.0), by 16-bit-lane
//         integer arithmetic on two values at a time; no group affine;
//   bf16  [N, K]: the words feed the tensor cores as they are;
//   f32   [N, K]: rounded to bf16 (nearest even) in registers, as the TPU
//         kernel's b_tile.astype(a_tile.dtype) does with a bf16 A;
//   i4    codes u8 [N, K/2], two 4-bit codes a byte in split halves: byte
//         g*128 + j of a row holds elements j (low nibble) and 128 + j
//         (high nibble) of the row's 256-block g; scales and mins f32
//         [N, K/128], dequant = s*c + m per 128-wide group, applied to the
//         OUTPUT like i8: C += s_g * (A_g . C_g) + m_g * sum(A_g).  A
//         nibble becomes bf16 exactly: OR'ed under the byte 0x43 it is the
//         bf16 128 + c, and one bf16x2 subtraction of 128 leaves c;
//   nuq4  codes as i4's; tables u8 [N, tstride]: 16 SFP bytes per
//         256-block, the block's cluster centres (rows padded to tstride
//         = round_up(K/16, 128) bytes, the layout they are loaded in).  A
//         lane keeps its row's 16 table bytes of the chunk in four
//         registers and looks four codes up at once with three byte
//         permutes (two 8-entry selects on the codes' low three bits, one
//         select between them on their fourth bit), then decodes the
//         picked SFP bytes as the sfp codec does.  The TPU kernel's
//         128-lane gather windows have no counterpart: a table never
//         leaves the lane's registers.  The tensor scale multiplies the
//         output.
// K3 is one launch: the decode tile's warp (gemm_common.cuh) with the
// final norm folded in (see top1_body).  K6's entry runs prenorm_kernel
// (A f32 -> bf16 RMSNorm(A), once per row instead of in every block)
// before its kernel and its merge after; each entry reports through
// `launched` which of them it put on the stream (kLaunched* bits), so the
// caller counts the launches that happened.  The passes, the codecs'
// element decoders and the B operand are gemm_common.cuh's.
//
// What bounds the heads on an H100 (3.35 TB/s): the weights' bytes, e.g.
// the logits head 256000x2304 = 608 MB (i8), 590 MB (sfp), 1180 MB (bf16),
// 332 MB (i4, nuq4) -> 182, 176, 352, 99 us; they write no logits.
// K6's design (mm_tile / mm_tile_packed): mma.sync m16n8k16 (bf16 in, f32
// accumulate) with no shared-memory staging.  A block walks 8-column tiles
// of N; each tile is one 16 x 8 output tile whose K eight warps split, in
// chunks of 2 x 64 bytes per B row (256 elements at two a byte, else 128,
// 64 or 32 at 1, 2 or 4 bytes each): a lane loads 2 x 16 B per B row per
// chunk and converts in registers.  The K of a chunk are permuted
// identically on A and B (a sum over k does not care) so each lane's bytes
// are contiguous.  For the packed kinds a chunk is one 256-block: i4 walks
// its low nibbles (group 2c) and then its high nibbles (group 2c + 1),
// four consecutive bytes a step, so a lane's A columns of a step are
// c*256 + 128*nb + 64*h + 16*t + 4*w + {0..3}; nuq4 takes the four nibbles
// of two consecutive bytes a step, A columns c*256 + 64*h + 16*t + 4*w +
// 2*hf + {0, 1, 128, 129}.  The warps' partial tiles meet in shared memory
// and the next chunk's bytes are prefetched into registers.

#include <climits>

#include "gemm_common.cuh"

using namespace gemma;

struct MMArgs {
  const __nv_bfloat16* a;  // [M, K]
  const void* codes[2];    // [N, K] of the codec's element ([N, K/2] packed)
  // i8: inverse scales, i4: scales, [N, K/128]; nuq4: the tables, u8
  // [N, nuq4_tstride(K)], 16 bytes a 256-block (read through a cast)
  const float* inv[2];
  const float* zp[2];      // i8: zero points, i4: mins; [N, K/128]
  float scale[2];
  void* out;  // [M, N], f32 or bf16
  int M, N, K;
  int out_bf16;
};

template <int CODEC, int NB, int NT>
__device__ __forceinline__ void load_b(uint4 (&dst)[NB][NT][2],
                                       const MMArgs& p, int n0, int gid,
                                       int t, int c) {
  using C = Codec<CODEC>;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + gid;
      if (n < p.N) {
        const char* src = static_cast<const char*>(p.codes[b]);
        if constexpr (C::kPacked)  // rows of K/2 bytes, chunks of 128
          src += (size_t)n * (p.K / 2) + (size_t)c * 128 + 16 * t;
        else
          src += ((size_t)n * p.K + c * C::kChunk + C::kEpl * t) * C::kEsize;
        dst[b][j][0] = __ldg(reinterpret_cast<const uint4*>(src));
        dst[b][j][1] = __ldg(reinterpret_cast<const uint4*>(src + 64));
      } else {
        dst[b][j][0] = make_uint4(0, 0, 0, 0);
        dst[b][j][1] = make_uint4(0, 0, 0, 0);
      }
    }
  }
}

// nuq4: each B row's 16 table bytes of chunk (256-block) c.
template <int NB, int NT>
__device__ __forceinline__ void load_t(uint4 (&dst)[NB][NT], const MMArgs& p,
                                       int n0, int gid, int c) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + gid;
      const uint8_t* tables = reinterpret_cast<const uint8_t*>(p.inv[b]);
      dst[b][j] = n < p.N
          ? __ldg(reinterpret_cast<const uint4*>(
                tables + (size_t)n * nuq4_tstride(p.K) + (size_t)c * 16))
          : make_uint4(0, 0, 0, 0);
    }
  }
}

// nuq4: the low 16 bits of `sel` are the four codes of two consecutive
// packed bytes (elements j, 128 + j, j + 1, 129 + j of the 256-block);
// `tbl` holds the block's 16 SFP table bytes (nuq4_lookup4 picks them).
// bf[0] = (j, j + 1), bf[1] = (128 + j, 129 + j).
__device__ __forceinline__ void nuq4_frag(uint32_t sel, const uint4& tbl,
                                          uint32_t* bf) {
  const uint32_t r = nuq4_lookup4(sel, tbl);
  bf[0] = sfp2_to_bf16x2(__byte_perm(r, 0, 0x4240u));
  bf[1] = sfp2_to_bf16x2(__byte_perm(r, 0, 0x4341u));
}

// Where rows na and na + 1 of affine group g lie in a group array: [N, G]
// as loaded, or [G, N] (GN) as stack_quant_tensors lays a stacked one.
template <bool GN>
__device__ __forceinline__ void group_at(int na, int g, int N, int G,
                                         size_t& ia, size_t& ib) {
  if constexpr (GN) {
    ia = (size_t)g * N + na;
    ib = ia + 1;
  } else {
    ia = (size_t)na * G + g;
    ib = (size_t)(na + 1) * G + g;
  }
}

// The block's (16*MT) x BN output tile at rows m0.., columns nb..: on
// return the warps with ks == 0 hold the full sums in `acc` (mma.sync
// fragment layout: lane (gid, t) has rows gid and gid + 8 of each 16-row
// tile, columns 2t and 2t + 1 of each 8-column tile).  Every thread of
// the block must call it (it synchronizes), with the same m0 and nb.
// GN: the i8 group arrays are [G, N] (a stacked weight's layer).
template <int CODEC, int MT, int NT, int KSPLIT, int WARPS, bool GATED,
          bool GN = false>
__device__ __forceinline__ void mm_tile(const MMArgs& p, int m0, int nb,
                                        float (&acc)[GATED ? 2 : 1][MT][NT][4]) {
  using C = Codec<CODEC>;
  constexpr bool AFFINE = CODEC == kI8;  // a chunk is a 128-wide group
  constexpr int NB = GATED ? 2 : 1;
  constexpr int TILES = WARPS / KSPLIT;
  constexpr int FRAG = NB * MT * NT * 4;
  constexpr int HS = C::kSteps / 2;  // steps per half-chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int ks = warp % KSPLIT, tile = warp / KSPLIT;
  const int n0 = nb + tile * 8 * NT;
  const int M = p.M, N = p.N, K = p.K, chunks = K / C::kChunk;

  float part[AFFINE ? NB : 1][MT][NT][4];  // i8: one group's raw products
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[b][i][j][e] = 0.f;
          if constexpr (AFFINE) part[b][i][j][e] = 0.f;
        }

  uint4 bcur[NB][NT][2];
  if (ks < chunks) load_b<CODEC, NB, NT>(bcur, p, n0, gid, t, ks);

  for (int c = ks; c < chunks; c += KSPLIT) {
    uint4 bnext[NB][NT][2];
    const int cn = c + KSPLIT;
    if (cn < chunks) load_b<CODEC, NB, NT>(bnext, p, n0, gid, t, cn);

    float psum[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) psum[i][0] = psum[i][1] = 0.f;

#pragma unroll
    for (int s = 0; s < C::kSteps; ++s) {
      const int h = s / HS, w = s % HS;
      const int k = c * C::kChunk + h * (C::kChunk / 2) + C::kEpl * t + 4 * w;
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + 16 * i + gid + 8 * hh;
          uint2 x = make_uint2(0, 0);
          if (row < M)
            x = *reinterpret_cast<const uint2*>(p.a + (size_t)row * K + k);
          af[i][hh] = x.x;      // a0 / a1: k, k+1
          af[i][2 + hh] = x.y;  // a2 / a3: k+2, k+3
          if constexpr (AFFINE) {
            const float v0 = __uint_as_float(x.x << 16);
            const float v1 = __uint_as_float(x.x & 0xffff0000u);
            const float v2 = __uint_as_float(x.y << 16);
            const float v3 = __uint_as_float(x.y & 0xffff0000u);
            psum[i][hh] += (v0 + v1) + (v2 + v3);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bf[2];
          b_frag<CODEC>(bcur[b][j][h], w, bf);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            if constexpr (AFFINE)
              mma_bf16_16816(part[b][i][j], af[i], bf);
            else
              mma_bf16_16816(acc[b][i][j], af[i], bf);
          }
        }
      }
    }

    if constexpr (AFFINE) {
      // Group sums of A: each lane saw 32 of the 128 k; the 4 lanes of a
      // row (t = 0..3) together saw all of them.
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          psum[i][hh] += __shfl_xor_sync(0xffffffffu, psum[i][hh], 1);
          psum[i][hh] += __shfl_xor_sync(0xffffffffu, psum[i][hh], 2);
        }
      const int G = chunks, g = c;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int na = n0 + 8 * j + 2 * t;  // N is even: na + 1 < N too
          float inva = 0.f, invb = 0.f, izpa = 0.f, izpb = 0.f;
          if (na < N) {
            size_t ia, ib;
            group_at<GN>(na, g, N, G, ia, ib);
            inva = p.inv[b][ia];
            invb = p.inv[b][ib];
            izpa = inva * p.zp[b][ia];
            izpb = invb * p.zp[b][ib];
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            float* cc = part[b][i][j];
            acc[b][i][j][0] += inva * cc[0] - izpa * psum[i][0];
            acc[b][i][j][1] += invb * cc[1] - izpb * psum[i][0];
            acc[b][i][j][2] += inva * cc[2] - izpa * psum[i][1];
            acc[b][i][j][3] += invb * cc[3] - izpb * psum[i][1];
            cc[0] = cc[1] = cc[2] = cc[3] = 0.f;
          }
        }
      }
    }
    if (cn < chunks) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          bcur[b][j][0] = bnext[b][j][0];
          bcur[b][j][1] = bnext[b][j][1];
        }
    }
  }

  if constexpr (KSPLIT > 1) {
    __shared__ float red[TILES][KSPLIT > 1 ? KSPLIT - 1 : 1][FRAG][32];
    float* flat = &acc[0][0][0][0];
    __syncthreads();  // a previous call's ks == 0 warps have read `red`
    if (ks > 0) {
#pragma unroll
      for (int e = 0; e < FRAG; ++e) red[tile][ks - 1][e][lane] = flat[e];
    }
    __syncthreads();
    if (ks == 0) {
      for (int r = 0; r < KSPLIT - 1; ++r)
#pragma unroll
        for (int e = 0; e < FRAG; ++e) flat[e] += red[tile][r][e][lane];
    }
  }
}

// mm_tile for the packed codecs (i4, nuq4): the same tile, the same split
// of K over warps and lanes, and the same two 16-byte loads per lane, B row
// and chunk, but a chunk is a 256-block of two nibbles a byte, walked in 16
// steps.  i4 takes the low nibbles (affine group 2c) and then the high
// ones (group 2c + 1), closing each group into `acc` as i8 does; nuq4
// takes the four nibbles of two bytes a step and looks them up in the
// row's table of the chunk, which rides beside the codes in `tcur` /
// `tnext`.  Kept apart from mm_tile so that the one-byte and dense codecs
// compile to what they were.  GN: i4's group arrays are [G, N].
template <int CODEC, int MT, int NT, int KSPLIT, int WARPS, bool GATED,
          bool GN = false>
__device__ __forceinline__ void mm_tile_packed(
    const MMArgs& p, int m0, int nb, float (&acc)[GATED ? 2 : 1][MT][NT][4]) {
  using C = Codec<CODEC>;
  static_assert(C::kPacked, "mm_tile walks the one-byte and dense codecs");
  // i4: a group's raw products are scaled into `acc` when it closes.
  constexpr bool AFFINE = CODEC == kI4;
  constexpr bool NUQ = CODEC == kNuq4;
  constexpr int NB = GATED ? 2 : 1;
  constexpr int TILES = WARPS / KSPLIT;
  constexpr int FRAG = NB * MT * NT * 4;
  constexpr int SPG = C::kSteps / C::kGroups;  // steps per affine group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int ks = warp % KSPLIT, tile = warp / KSPLIT;
  const int n0 = nb + tile * 8 * NT;
  const int M = p.M, N = p.N, K = p.K, chunks = K / C::kChunk;

  float part[AFFINE ? NB : 1][MT][NT][4];  // one group's raw products
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[b][i][j][e] = 0.f;
          if constexpr (AFFINE) part[b][i][j][e] = 0.f;
        }

  uint4 bcur[NB][NT][2];
  uint4 tcur[NUQ ? NB : 1][NUQ ? NT : 1];  // nuq4: the chunk's tables
  if (ks < chunks) {
    load_b<CODEC, NB, NT>(bcur, p, n0, gid, t, ks);
    if constexpr (NUQ) load_t<NB, NT>(tcur, p, n0, gid, ks);
  }

  for (int c = ks; c < chunks; c += KSPLIT) {
    uint4 bnext[NB][NT][2];
    uint4 tnext[NUQ ? NB : 1][NUQ ? NT : 1];
    const int cn = c + KSPLIT;
    if (cn < chunks) {
      load_b<CODEC, NB, NT>(bnext, p, n0, gid, t, cn);
      if constexpr (NUQ) load_t<NB, NT>(tnext, p, n0, gid, cn);
    }

#pragma unroll
    for (int grp = 0; grp < C::kGroups; ++grp) {
      float psum[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) psum[i][0] = psum[i][1] = 0.f;

#pragma unroll
      for (int s = 0; s < SPG; ++s) {
        // Which half-chunk (h) and 4-byte word (w) of it this step reads,
        // and the A column k that its first B element multiplies.
        int h, w, k;
        if constexpr (CODEC == kI4) {
          h = s / 4, w = s % 4;
          k = c * 256 + 128 * grp + 64 * h + 16 * t + 4 * w;
        } else {
          h = s / 8, w = (s / 2) % 4;
          k = c * 256 + 64 * h + 16 * t + 4 * w + 2 * (s % 2);
        }
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = m0 + 16 * i + gid + 8 * hh;
            uint2 x = make_uint2(0, 0);
            if (row < M) {
              const __nv_bfloat16* ar = p.a + (size_t)row * K + k;
              if constexpr (NUQ) {  // columns k, k+1 and k+128, k+129
                x.x = *reinterpret_cast<const uint32_t*>(ar);
                x.y = *reinterpret_cast<const uint32_t*>(ar + 128);
              } else {
                x = *reinterpret_cast<const uint2*>(ar);
              }
            }
            af[i][hh] = x.x;      // a0 / a1: the step's first two K
            af[i][2 + hh] = x.y;  // a2 / a3: its last two
            if constexpr (AFFINE) {
              const float v0 = __uint_as_float(x.x << 16);
              const float v1 = __uint_as_float(x.x & 0xffff0000u);
              const float v2 = __uint_as_float(x.y << 16);
              const float v3 = __uint_as_float(x.y & 0xffff0000u);
              psum[i][hh] += (v0 + v1) + (v2 + v3);
            }
          }
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t bf[2];
            if constexpr (CODEC == kI4)
              i4_frag(word_of(bcur[b][j][h], w), grp, bf);
            else
              nuq4_frag(word_of(bcur[b][j][h], w) >> (16 * (s % 2)),
                        tcur[b][j], bf);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              if constexpr (AFFINE)
                mma_bf16_16816(part[b][i][j], af[i], bf);
              else
                mma_bf16_16816(acc[b][i][j], af[i], bf);
            }
          }
        }
      }

      if constexpr (AFFINE) {
        // Group sums of A: each lane saw 32 of the 128 k; the 4 lanes of a
        // row (t = 0..3) together saw all of them.
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            psum[i][hh] += __shfl_xor_sync(0xffffffffu, psum[i][hh], 1);
            psum[i][hh] += __shfl_xor_sync(0xffffffffu, psum[i][hh], 2);
          }
        const int G = chunks * C::kGroups, g = c * C::kGroups + grp;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int na = n0 + 8 * j + 2 * t;  // N is even: na + 1 < N too
            // The group's scales (p.inv) and mins (p.zp): s * c + m.
            float sa = 0.f, sb = 0.f, ma = 0.f, mb = 0.f;
            if (na < N) {
              size_t ia, ib;
              group_at<GN>(na, g, N, G, ia, ib);
              sa = p.inv[b][ia];
              sb = p.inv[b][ib];
              ma = p.zp[b][ia];
              mb = p.zp[b][ib];
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              float* cc = part[b][i][j];
              acc[b][i][j][0] += sa * cc[0] + ma * psum[i][0];
              acc[b][i][j][1] += sb * cc[1] + mb * psum[i][0];
              acc[b][i][j][2] += sa * cc[2] + ma * psum[i][1];
              acc[b][i][j][3] += sb * cc[3] + mb * psum[i][1];
              cc[0] = cc[1] = cc[2] = cc[3] = 0.f;
            }
          }
        }
      }
    }
    if (cn < chunks) {
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          bcur[b][j][0] = bnext[b][j][0];
          bcur[b][j][1] = bnext[b][j][1];
          if constexpr (NUQ) tcur[b][j] = tnext[b][j];
        }
    }
  }

  if constexpr (KSPLIT > 1) {
    __shared__ float red[TILES][KSPLIT > 1 ? KSPLIT - 1 : 1][FRAG][32];
    float* flat = &acc[0][0][0][0];
    __syncthreads();  // a previous call's ks == 0 warps have read `red`
    if (ks > 0) {
#pragma unroll
      for (int e = 0; e < FRAG; ++e) red[tile][ks - 1][e][lane] = flat[e];
    }
    __syncthreads();
    if (ks == 0) {
      for (int r = 0; r < KSPLIT - 1; ++r)
#pragma unroll
        for (int e = 0; e < FRAG; ++e) flat[e] += red[tile][r][e][lane];
    }
  }
}

// ---------------------------------------------------------------------------
// K3: the fused greedy head (replaces matmul.py:_top1_kernel).
//
// (token, prob) per row of softcap(scale * A . B^T) over all N columns
// without writing the [M, N] logits.  Masked columns (allowed mask 0) and
// columns past N are -inf: they leave the argmax and the sum.  Online
// state per row: max m, sum s of exp(x - m), lowest index at m; prob = 1 /
// max(s, 1e-30) (the winner's own term is exp(0) = 1); a row with no live
// column gives token 0 (matmul.py:1303-1331).  need_prob = 0 skips the cap
// and the exp: argmax of the raw logits, prob 1.0 (matmul.py:1243-1253).
//
// Design: the decode tile's warp (gemm_common.cuh), not mm_tile.  A
// block stages its (up to 16) rows of A once, for the whole K, the final
// norm folded in as in the decode GEMMs; a warp takes 16 vocabulary rows
// at a time (a row group) as mma.sync's 16-row operand, A^T the 8-wide one
// (one n-tile to M = 8, two to 16), and walks the whole K of its groups as
// one stream of chunks through a register ring of kHeadDepth chunks: no
// barrier between groups, and the next group's first chunks load while
// the last ones multiply.  Blocks are persistent (as many as fit on the
// card at once) and their warps grid-stride over the N / 16 row groups
// (ops/matmul.py:top1_plan).  After a group every lane applies the scale,
// the cap, the mask and the online update to its own 2 x 2 outputs per
// n-tile: vocabulary rows g and g + 8, A rows 2t and 2t + 1, one state per
// A row, so a state never mixes two rows of A and a lane's columns arrive
// in increasing order.  The 8 lanes of a row (equal t) merge by shuffles,
// the warps in warp order through shared memory, and the blocks' states go
// to `part`; the last block to take the ticket merges them, lane l the
// blocks l, l + 32, ..., then the butterfly (ties to the lowest index).
// What bounds it: the weights' bytes (608 MB i8 at Gemma2-2B: 0.18 ms).
struct Top1Args {
  DecodeArgs mm;        // A (bf16, or f32 and the norm), B, M, N, K
  float cap;
  const uint8_t* mask;  // [N] 0/1, or null
  int need_prob;
  float* part_m;        // [M, gridDim.x]
  float* part_s;
  int* part_i;
  int* ticket;          // zero before the launch; the last block re-zeroes it
  int* tok;             // [M]
  float* prob;          // [M]
};

struct Top1State {
  float m, s;
  int i;
};

// The merge of two online states (commutative; ties to the lowest index).
__device__ __forceinline__ Top1State top1_merge(Top1State a, Top1State b,
                                                bool need_prob) {
  Top1State r;
  r.m = fmaxf(a.m, b.m);
  r.i = a.m > b.m ? a.i : b.m > a.m ? b.i : min(a.i, b.i);
  r.s = 0.f;
  if (need_prob) {
    if (a.m != -INFINITY) r.s += a.s * expf(a.m - r.m);
    if (b.m != -INFINITY) r.s += b.s * expf(b.m - r.m);
  }
  return r;
}

__device__ __forceinline__ Top1State top1_shfl(Top1State x, int mask) {
  Top1State y;
  y.m = __shfl_xor_sync(0xffffffffu, x.m, mask);
  y.s = __shfl_xor_sync(0xffffffffu, x.s, mask);
  y.i = __shfl_xor_sync(0xffffffffu, x.i, mask);
  return y;
}

// One logit v at column col into a state whose columns came in increasing
// order (a tie keeps the earlier, lower index).
__device__ __forceinline__ void top1_push(Top1State& s, float v, int col,
                                          bool need_prob) {
  if (v > s.m) {
    if (need_prob) s.s = s.s * expf(s.m - v) + 1.f;
    s.m = v;
    s.i = col;
  } else if (need_prob) {
    s.s += expf(v - s.m);
  }
}

constexpr int kHeadWarps = 8;  // K6: warps splitting the K of one 16x8 tile
// The heads run 528 blocks as one wave of 4 per SM, which needs 64
// registers a thread or fewer.  The packed codecs' top-k kernels are held
// to that by their launch bounds (i4's took 74 and ran two waves); the
// other instantiations fit unasked and keep their bounds as they were.
constexpr int kHeadBlocksPerSM = 4;
// K3: chunks in a lane's register ring, and blocks an SM by the launch
// bounds: two (128 registers) keep every instantiation free of spills but
// i4's at M > 8, which takes one; three (80 registers) spilled, and
// measured slower (PERF.md).
__host__ __device__ constexpr int top1_blocks_per_sm(int codec, int nt) {
  return nt == 2 && codec == kI4 ? 1 : 2;
}
constexpr int kTop1Depth = 2;
// Its dynamic shared memory at most: 16 rows of A at K 4608 with the
// norm's segment sums take 157 KB.
constexpr int kTop1SmemMax = 200 * 1024;

// K3's dynamic shared memory, byte offsets: A's rows (all of K, padded),
// then (final norm) their segment sums of squares, then the multipliers.
struct HeadSmem {
  int segs, mul, bytes;
};

template <int CODEC>
__host__ __device__ __forceinline__ HeadSmem head_smem(int M, int K,
                                                       bool pro) {
  const int pad = CODEC == kNuq4 ? 2 : 4;
  HeadSmem L;
  L.segs = (M * (K + pad) * 2 + 15) / 16 * 16;
  L.mul = L.segs + (pro ? M * (K / kNormSeg) * 4 : 0);
  L.bytes = L.mul + 16 * 4;
  return L;
}

template <int CODEC, int NT>
__device__ __forceinline__ void top1_body(const Top1Args& q) {
  using C = Codec<CODEC>;
  constexpr int PAD = CODEC == kNuq4 ? 2 : 4;
  constexpr int D = kTop1Depth;
  extern __shared__ __align__(16) uint8_t smem[];
  const DecodeArgs& p = q.mm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * 16, M = min(16, p.M - m0);
  const int N = p.N, K = p.K, chunks = K / C::kChunk, SA = K + PAD;
  const bool need_prob = q.need_prob != 0;
  const bool capped = need_prob && q.cap != 0.f;
  // This warp's row groups: gw, gw + W, ... of the N / 16.
  const int groups = (N + 15) / 16, W = gridDim.x * (kDecodeThreads / 32);
  const int gw = blockIdx.x * (kDecodeThreads / 32) + warp;
  const int total = gw < groups ? ((groups - 1 - gw) / W + 1) * chunks : 0;
  const HeadSmem L = head_smem<CODEC>(min(16, p.M), K, p.norm != nullptr);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  float* mul = reinterpret_cast<float*>(smem + L.mul);
  auto rows_at = [&](int j) {
    Rows r;
    r.l = 0;
    r.n0 = 16 * (gw + j / chunks * W) + g;
    r.off = (size_t)(r.n0 < N ? r.n0 : 0) * row_bytes<CODEC>(p);
    return r;
  };
  Slot ring[D];
#pragma unroll
  for (int j = 0; j < D - 1; ++j)
    if (j < total)
      load_slot<CODEC, false, false>(ring[j], rows_at(j), p, j % chunks, t);

  // A's rows m0.. (all of K), normalized here under the final norm.
  if (p.norm == nullptr) {
    copy_stage<PAD>(p.a + (size_t)m0 * K, K, 0, K / 8, M, As, SA);
  } else {
    const float* a32 = p.a32 + (size_t)m0 * K;
    float* segs = reinterpret_cast<float*>(smem + L.segs);
    norm_segments(a32, K, 0, K, M, segs, K / kNormSeg);
    __syncthreads();
    for (int m = warp; m < M; m += kDecodeThreads / 32) {
      const float r = norm_row_mul(K, lane, [&](int s) {
        return segs + m * (K / kNormSeg) + s;
      });
      if (lane == 0) mul[m] = r;
    }
    __syncthreads();
    norm_stage(a32, p.norm, K, 0, K / 8, M, mul, As, SA);
  }
  __syncthreads();

  Top1State st[NT][2];
  float acc[NT][4], part[NT][4], asum[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) st[nt][e] = {-INFINITY, 0.f, INT_MAX};
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = part[nt][e] = asum[nt][e] = 0.f;
  }
  for (int jb = 0; jb < total; jb += D) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int j = jb + u;
      if (j < total) {
        if (j + D - 1 < total)
          load_slot<CODEC, false, false>(ring[(u + D - 1) % D],
                                         rows_at(j + D - 1), p,
                                         (j + D - 1) % chunks, t);
        const int c = j % chunks;
        consume_chunk<CODEC, NT>(ring[u], As, SA, c * C::kChunk, M, g, t,
                                 lane, acc, part, asum);
        if (c == chunks - 1) {
          // The group's outputs: vocabulary rows n0 (acc 0, 1) and n0 + 8
          // (acc 2, 3), A rows 8 nt + 2 t + e.
          const int n0 = 16 * (gw + j / chunks * W) + g;
          bool live[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = n0 + 8 * h;
            live[h] = col < N && (q.mask == nullptr || q.mask[col] != 0);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (8 * nt + 2 * t + e < M) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  if (!live[h]) continue;
                  float v = acc[nt][2 * h + e] * p.scale[0];
                  if (capped) v = q.cap * tanhf(v / q.cap);
                  top1_push(st[nt][e], v, n0 + 8 * h, need_prob);
                }
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
          }
        }
      }
    }
  }

  // The 8 lanes of a row (g = 0..7), then the warps in order.
  __shared__ Top1State wst[kDecodeThreads / 32][16];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      Top1State& s = st[nt][e];
      s = top1_merge(s, top1_shfl(s, 4), need_prob);
      s = top1_merge(s, top1_shfl(s, 8), need_prob);
      s = top1_merge(s, top1_shfl(s, 16), need_prob);
      const int m = 8 * nt + 2 * t + e;
      if (g == 0 && m < M) wst[warp][m] = s;
    }
  __syncthreads();
  if (tid < M) {
    Top1State r = wst[0][tid];
    for (int w = 1; w < kDecodeThreads / 32; ++w)
      r = top1_merge(r, wst[w][tid], need_prob);
    const size_t at = (size_t)(m0 + tid) * gridDim.x + blockIdx.x;
    q.part_m[at] = r.m;
    q.part_s[at] = r.s;
    q.part_i[at] = r.i;
    __threadfence();
  }
  __shared__ bool is_last;
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(q.ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The last block: one warp per row merges the row's gridDim.x states.
  for (int row = warp; row < p.M; row += kDecodeThreads / 32) {
    Top1State r = {-INFINITY, 0.f, INT_MAX};
    for (int bx = lane; bx < (int)gridDim.x; bx += 32) {
      const size_t at = (size_t)row * gridDim.x + bx;
      r = top1_merge(r, {__ldcg(q.part_m + at), __ldcg(q.part_s + at),
                         __ldcg(q.part_i + at)}, need_prob);
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) r = top1_merge(r, top1_shfl(r, o), need_prob);
    if (lane == 0) {
      q.tok[row] = r.m == -INFINITY ? 0 : r.i;
      q.prob[row] = need_prob ? 1.0f / fmaxf(r.s, 1e-30f) : 1.0f;
    }
  }
  if (threadIdx.x == 0) *q.ticket = 0;
}

// ---------------------------------------------------------------------------
// K6: the fused top-k head (replaces matmul.py:_topk_kernel).
//
// Per row, the k_top <= 128 largest of softcap(scale * A . B^T) over all N
// columns, as values f32 and column indices i32, descending, ties to the
// lower index, without writing the [M, N] logits.  Masked columns and
// columns past N never enter; when fewer than k_top columns are live the
// remaining entries are (-inf, index 0) (matmul.py:1483-1491).
//
// The TPU kernel's grid walks N in order with one running list per row.
// Here N is split over the blocks: each block walks `tpb`
// consecutive 8-column tiles and keeps, per row, a sorted list of k_top
// (value, index) pairs in shared memory (16 rows x 128 x 8 B).  After a
// tile, warp 0 (which holds the 16x8 sums) tests its values against each
// row's k_top-th entry; the few that pass are inserted one at a time by
// the whole warp (count the entries that come before the candidate by
// ballot, shift the tail by one).  Each block's lists go to `part`, and a
// second kernel of the same C entry, topk_merge_kernel (one block per row),
// merges the row's gridDim.x sorted lists the same way.  Everything
// compares by (value descending, index ascending), a total order, so the
// tie rule holds across tiles, blocks and the merge.
constexpr int kTopkMax = 128;

struct TopkArgs {
  MMArgs mm;
  float cap;
  const uint8_t* mask;  // [N] 0/1, or null
  int k_top;
  int tpb;              // 8-column tiles per block
  float* part_v;        // [M, gridDim.x, k_top]
  int* part_i;
};

// (av, ai) comes before (bv, bi) in the output order.
__device__ __forceinline__ bool topk_before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// The warp inserts (v, c) into the sorted list lv/li of 32 * kq slots; the
// last entry drops out.
__device__ __forceinline__ void topk_insert(float* lv, int* li, int kq,
                                            float v, int c, int lane) {
  float pv[kTopkMax / 32];
  int pi[kTopkMax / 32];
  int pos = 0;  // entries that come before the candidate: a prefix
#pragma unroll
  for (int q = 0; q < kTopkMax / 32; ++q) {
    if (q < kq) {
      const int s = lane + 32 * q;
      pv[q] = s > 0 ? lv[s - 1] : 0.f;
      pi[q] = s > 0 ? li[s - 1] : 0;
      pos += __popc(__ballot_sync(0xffffffffu, topk_before(lv[s], li[s], v, c)));
    }
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kTopkMax / 32; ++q) {
    if (q < kq) {
      const int s = lane + 32 * q;
      if (s == pos) {
        lv[s] = v;
        li[s] = c;
      } else if (s > pos) {
        lv[s] = pv[q];
        li[s] = pi[q];
      }
    }
  }
  __syncwarp();
}

// Every lane offers (v, c) (when live) to one list; the warp inserts, in
// lane order, those that come before the list's k_top-th entry.  Returns
// whether any did.
__device__ __forceinline__ bool topk_offer(float* lv, int* li, int k_top,
                                           bool live, float v, int c, int lane) {
  const int kq = (k_top + 31) >> 5;
  bool any = false;
  for (;;) {
    const float tv = lv[k_top - 1];
    const int ti = li[k_top - 1];
    const unsigned m =
        __ballot_sync(0xffffffffu, live && topk_before(v, c, tv, ti));
    if (m == 0) return any;
    any = true;
    const int src = __ffs(m) - 1;
    topk_insert(lv, li, kq, __shfl_sync(0xffffffffu, v, src),
                __shfl_sync(0xffffffffu, c, src), lane);
    if (lane == src) live = false;
  }
}

template <int CODEC>
__device__ __forceinline__ void topk_body(const TopkArgs& q) {
  __shared__ float lv[16][kTopkMax];
  __shared__ int li[16][kTopkMax];
  const MMArgs& p = q.mm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * 16;
  const int rows = min(16, p.M - m0);
  const int k_top = q.k_top;
  for (int i = threadIdx.x; i < 16 * kTopkMax; i += blockDim.x) {
    (&lv[0][0])[i] = -INFINITY;
    (&li[0][0])[i] = INT_MAX;
  }
  __syncthreads();

  for (int c = 0; c < q.tpb; ++c) {
    const int nb = (blockIdx.x * q.tpb + c) * 8;
    if (nb >= p.N) break;  // uniform over the block
    float acc[1][1][1][4];
    if constexpr (Codec<CODEC>::kPacked)
      mm_tile_packed<CODEC, 1, 1, kHeadWarps, kHeadWarps, false>(p, m0, nb,
                                                                 acc);
    else
      mm_tile<CODEC, 1, 1, kHeadWarps, kHeadWarps, false>(p, m0, nb, acc);
    if (warp != 0) continue;
    float v[4];
    bool live[4], any = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = gid + 8 * h, col = nb + 2 * t + e;
        float x = acc[0][0][0][2 * h + e] * p.scale[0];
        if (q.cap != 0.f) x = q.cap * tanhf(x / q.cap);
        v[2 * h + e] = x;
        const bool ok = row < rows && col < p.N &&
                        (q.mask == nullptr || q.mask[col] != 0);
        live[2 * h + e] = ok;
        if (ok)
          any |= topk_before(x, col, lv[row][k_top - 1], li[row][k_top - 1]);
      }
    }
    if (!__any_sync(0xffffffffu, any)) continue;
    for (int r = 0; r < rows; ++r) {
      const bool mine = gid == (r & 7);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = r < 8 ? v[e] : v[2 + e];
        const bool ok = mine && (r < 8 ? live[e] : live[2 + e]);
        topk_offer(lv[r], li[r], k_top, ok, x, nb + 2 * t + e, lane);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * k_top; i += blockDim.x) {
    const int r = i / k_top, j = i % k_top;
    const size_t at =
        ((size_t)(m0 + r) * gridDim.x + blockIdx.x) * k_top + j;
    q.part_v[at] = lv[r][j];
    q.part_i[at] = li[r][j];
  }
}

// Row blockIdx.x: merge its `nblocks` sorted lists of k_top pairs
// (part_v / part_i [M, nblocks, k_top], dead entries (-inf, INT_MAX)) into
// vals / idxs [M, k_top]; dead entries leave as (-inf, 0).  Eight warps
// merge every eighth list each, then warp 0 merges the eight results.  A
// list is sorted, so once 32 consecutive entries all fail the rest do too.
constexpr int kMergeWarps = 8;

__global__ void __launch_bounds__(kMergeWarps * 32) topk_merge_kernel(
    const float* part_v, const int* part_i, int nblocks, int k_top,
    float* vals, int* idxs) {
  __shared__ float lv[kMergeWarps][kTopkMax];
  __shared__ int li[kMergeWarps][kTopkMax];
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = lane; j < kTopkMax; j += 32) {
    lv[warp][j] = -INFINITY;
    li[warp][j] = INT_MAX;
  }
  __syncwarp();
  for (int b = warp; b < nblocks; b += kMergeWarps) {
    const size_t base = ((size_t)row * nblocks + b) * k_top;
    for (int j0 = 0; j0 < k_top; j0 += 32) {
      const int j = j0 + lane;
      const bool live = j < k_top;
      const float v = live ? part_v[base + j] : 0.f;
      const int c = live ? part_i[base + j] : 0;
      if (!topk_offer(lv[warp], li[warp], k_top, live, v, c, lane)) break;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < kMergeWarps; ++w) {
    for (int j0 = 0; j0 < k_top; j0 += 32) {
      const int j = j0 + lane;
      const bool live = j < k_top;
      const float v = live ? lv[w][j] : 0.f;
      const int c = live ? li[w][j] : 0;
      if (!topk_offer(lv[0], li[0], k_top, live, v, c, lane)) break;
    }
  }
  for (int j = lane; j < k_top; j += 32) {
    const float v = lv[0][j];
    vals[(size_t)row * k_top + j] = v;
    idxs[(size_t)row * k_top + j] = v == -INFINITY ? 0 : li[0][j];
  }
}

// The kernels by name, one set per codec, so the launch counters and the
// profiler tell the kinds apart.
#define GEMMA_CODEC_KERNELS(KIND, CODEC, TOPK_BOUNDS)                        \
  template <int NT>                                                          \
  __global__ void __launch_bounds__(kDecodeThreads,                          \
                                    top1_blocks_per_sm(CODEC, NT))           \
      top1_##KIND##_kernel(Top1Args q) {                                     \
    top1_body<CODEC, NT>(q);                                                 \
  }                                                                          \
  __global__ void __launch_bounds__ TOPK_BOUNDS                              \
      topk_##KIND##_kernel(TopkArgs q) {                                     \
    topk_body<CODEC>(q);                                                     \
  }

GEMMA_CODEC_KERNELS(i8, kI8, (kHeadWarps * 32))
GEMMA_CODEC_KERNELS(sfp, kSfp, (kHeadWarps * 32))
GEMMA_CODEC_KERNELS(bf16, kBf16, (kHeadWarps * 32))
GEMMA_CODEC_KERNELS(f32, kF32, (kHeadWarps * 32))
GEMMA_CODEC_KERNELS(i4, kI4, (kHeadWarps * 32, kHeadBlocksPerSM))
GEMMA_CODEC_KERNELS(nuq4, kNuq4, (kHeadWarps * 32, kHeadBlocksPerSM))

// False when K or (nuq4) the tables' row stride is not what the kernels
// walk: whole chunks, and table rows of nuq4_tstride(K) bytes.
template <int CODEC>
static bool set_b(MMArgs& p, int b, const BOperand& w, int K) {
  p.codes[b] = w.codes;
  p.inv[b] = w.inv;
  p.zp[b] = w.zp;
  p.scale[b] = w.scale;
  if (K % Codec<CODEC>::kChunk) return false;
  if constexpr (CODEC == kNuq4) return w.tstride == nuq4_tstride(K);
  return true;
}

// The 8-column tiles of N split evenly over at most `blocks` blocks (per
// 16 rows): tiles per block, and the grid.
static dim3 head_grid(int M, int N, int blocks, int* tpb) {
  const int tiles = (N + 7) / 8;
  const int want = min(blocks, tiles);
  *tpb = (tiles + want - 1) / want;
  return dim3((tiles + *tpb - 1) / *tpb, (M + 15) / 16);
}

using Top1Kernel = void (*)(Top1Args);

template <int CODEC, int NT>
static Top1Kernel top1_kernel() {
#define GEMMA_PICK(KIND, CODE) \
  if constexpr (CODEC == CODE) return &top1_##KIND##_kernel<NT>;
  GEMMA_PICK(i8, kI8)
  GEMMA_PICK(sfp, kSfp)
  GEMMA_PICK(bf16, kBf16)
  GEMMA_PICK(f32, kF32)
  GEMMA_PICK(i4, kI4)
  GEMMA_PICK(nuq4, kNuq4)
#undef GEMMA_PICK
  return nullptr;
}

// One K3 launch: as many blocks as fit on the card at once (at most
// `blocks`, the capacity of part_*, and one per 8 row groups), a row of
// them per 16 rows of A.
template <int CODEC, int NT>
static cudaError_t launch_top1(Top1Args& q, int blocks, int smem,
                               cudaStream_t st) {
  const Top1Kernel k = top1_kernel<CODEC, NT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, kTop1SmemMax);
  if (attr != cudaSuccess) return attr;
  static int fit_smem = -1, fit = 0;  // blocks an SM at the last smem
  if (smem != fit_smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, k, kDecodeThreads, (size_t)smem);
    if (e != cudaSuccess) return e;
    fit_smem = smem;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const int groups = (q.mm.N + 15) / 16, per = kDecodeThreads / 32;
  const dim3 grid(min(min(blocks, fit * sms), (groups + per - 1) / per),
                  (q.mm.M + 15) / 16);
  void* args[] = {&q};
  return cudaLaunchKernel(reinterpret_cast<const void*>(k), grid,
                          dim3(kDecodeThreads), args, (size_t)smem, st);
}

// The greedy head: (tok, prob) of softcap(scale * A . B^T), A normalized
// in the kernel when `norm` is given (then a is f32).  part_*: [M, blocks]
// scratch, blocks the most the launch may use; ticket: one int, zero
// between launches (the last block re-zeroes it; launches that share it
// must not overlap).
template <int CODEC>
static int top1_entry(const void* a, const float* norm, const BOperand& w,
                      float cap, const uint8_t* mask, int need_prob,
                      float* part_m, float* part_s, int* part_i, int* ticket,
                      int* tok, float* prob, int M, int N, int K, int blocks,
                      int* launched, cudaStream_t st) {
  using C = Codec<CODEC>;
  *launched = 0;
  Top1Args q = {};
  DecodeArgs& p = q.mm;
  p.codes[0] = w.codes;
  p.aux[0] = w.inv;
  p.zp[0] = w.zp;
  p.scale[0] = w.scale;
  p.tstride = w.tstride;
  p.M = M; p.N = N; p.K = K;
  p.norm = norm;
  if (norm != nullptr)
    p.a32 = static_cast<const float*>(a);
  else
    p.a = static_cast<const __nv_bfloat16*>(a);
  if (blocks < 1 || M < 1 || N < 1 || K % C::kChunk ||
      (CODEC == kNuq4 && w.tstride != nuq4_tstride(K)) ||
      (reinterpret_cast<uintptr_t>(a) & 15) ||
      (reinterpret_cast<uintptr_t>(norm) & 15))
    return (int)cudaErrorInvalidValue;
  q.cap = cap; q.mask = mask; q.need_prob = need_prob;
  q.part_m = part_m; q.part_s = part_s; q.part_i = part_i;
  q.ticket = ticket; q.tok = tok; q.prob = prob;
  const int smem = head_smem<CODEC>(min(M, 16), K, norm != nullptr).bytes;
  if (smem > kTop1SmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t e = M > 8 ? launch_top1<CODEC, 2>(q, blocks, smem, st)
                              : launch_top1<CODEC, 1>(q, blocks, smem, st);
  if (e != cudaSuccess) return (int)e;
  *launched = kLaunchedSelf;
  return 0;
}

// The top-k head: vals / idxs [M, k_top] of softcap(scale * A . B^T).
// part_v / part_i: [M, blocks, k_top] scratch for the blocks' lists.
template <int CODEC>
static int topk_entry(const void* a, const float* norm, const BOperand& w,
                      float cap, const uint8_t* mask, int k_top,
                      __nv_bfloat16* a_scratch, float* part_v, int* part_i,
                      float* vals, int* idxs, int M, int N, int K, int blocks,
                      int* launched, cudaStream_t st) {
  *launched = 0;
  TopkArgs q = {};
  if (blocks < 1 || k_top < 1 || k_top > kTopkMax ||
      !set_b<CODEC>(q.mm, 0, w, K) || !set_b<CODEC>(q.mm, 1, w, K))
    return (int)cudaErrorInvalidValue;
  q.mm.a = operand_a(a, norm, a_scratch, M, K, launched, st);
  q.mm.M = M; q.mm.N = N; q.mm.K = K;
  q.cap = cap; q.mask = mask; q.k_top = k_top;
  q.part_v = part_v; q.part_i = part_i;
  const dim3 grid = head_grid(M, N, blocks, &q.tpb);
  if constexpr (CODEC == kI8)
    topk_i8_kernel<<<grid, kHeadWarps * 32, 0, st>>>(q);
  else if constexpr (CODEC == kSfp)
    topk_sfp_kernel<<<grid, kHeadWarps * 32, 0, st>>>(q);
  else if constexpr (CODEC == kBf16)
    topk_bf16_kernel<<<grid, kHeadWarps * 32, 0, st>>>(q);
  else if constexpr (CODEC == kF32)
    topk_f32_kernel<<<grid, kHeadWarps * 32, 0, st>>>(q);
  else if constexpr (CODEC == kI4)
    topk_i4_kernel<<<grid, kHeadWarps * 32, 0, st>>>(q);
  else
    topk_nuq4_kernel<<<grid, kHeadWarps * 32, 0, st>>>(q);
  *launched |= kLaunchedSelf;
  topk_merge_kernel<<<M, kMergeWarps * 32, 0, st>>>(part_v, part_i, grid.x,
                                                    k_top, vals, idxs);
  *launched |= kLaunchedMerge;
  return (int)cudaGetLastError();
}

// The C entries, one per GEMM and codec (kind "nuq" calls the sfp ones).
// inv and zp are read for i8 (and, as scales and mins, for i4) only.

extern "C" int gemma_top1_i8(const void* a, const float* norm,
                                 const void* codes, const float* inv,
                                 const float* zp, float scale, float cap,
                                 const uint8_t* mask, int need_prob,
                                 float* part_m,
                                 float* part_s, int* part_i, int* ticket,
                                 int* tok, float* prob, int M, int N, int K,
                                 int blocks, int* launched, cudaStream_t st) {
  return top1_entry<kI8>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket,
                         tok, prob, M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_i8(const void* a, const float* norm,
                                 const void* codes, const float* inv,
                                 const float* zp, float scale, float cap,
                                 const uint8_t* mask, int k_top,
                                 __nv_bfloat16* a_scratch, float* part_v,
                                 int* part_i, float* vals, int* idxs, int M,
                                 int N, int K, int blocks, int* launched,
                                 cudaStream_t st) {
  return topk_entry<kI8>(a, norm, affine_b(codes, inv, zp, scale), cap, mask, k_top,
                         a_scratch, part_v, part_i, vals, idxs, M, N, K,
                         blocks, launched, st);
}

extern "C" int gemma_top1_sfp(const void* a, const float* norm,
                                 const void* codes, const float* inv,
                                 const float* zp, float scale, float cap,
                                 const uint8_t* mask, int need_prob,
                                 float* part_m,
                                 float* part_s, int* part_i, int* ticket,
                                 int* tok, float* prob, int M, int N, int K,
                                 int blocks, int* launched, cudaStream_t st) {
  return top1_entry<kSfp>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket,
                         tok, prob, M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_sfp(const void* a, const float* norm,
                                 const void* codes, const float* inv,
                                 const float* zp, float scale, float cap,
                                 const uint8_t* mask, int k_top,
                                 __nv_bfloat16* a_scratch, float* part_v,
                                 int* part_i, float* vals, int* idxs, int M,
                                 int N, int K, int blocks, int* launched,
                                 cudaStream_t st) {
  return topk_entry<kSfp>(a, norm, affine_b(codes, inv, zp, scale), cap, mask, k_top,
                         a_scratch, part_v, part_i, vals, idxs, M, N, K,
                         blocks, launched, st);
}

extern "C" int gemma_top1_bf16(const void* a, const float* norm,
                                 const void* codes, const float* inv,
                                 const float* zp, float scale, float cap,
                                 const uint8_t* mask, int need_prob,
                                 float* part_m,
                                 float* part_s, int* part_i, int* ticket,
                                 int* tok, float* prob, int M, int N, int K,
                                 int blocks, int* launched, cudaStream_t st) {
  return top1_entry<kBf16>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket,
                         tok, prob, M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_bf16(const void* a, const float* norm,
                                 const void* codes, const float* inv,
                                 const float* zp, float scale, float cap,
                                 const uint8_t* mask, int k_top,
                                 __nv_bfloat16* a_scratch, float* part_v,
                                 int* part_i, float* vals, int* idxs, int M,
                                 int N, int K, int blocks, int* launched,
                                 cudaStream_t st) {
  return topk_entry<kBf16>(a, norm, affine_b(codes, inv, zp, scale), cap, mask, k_top,
                         a_scratch, part_v, part_i, vals, idxs, M, N, K,
                         blocks, launched, st);
}

extern "C" int gemma_top1_f32(const void* a, const float* norm,
                                 const void* codes, const float* inv,
                                 const float* zp, float scale, float cap,
                                 const uint8_t* mask, int need_prob,
                                 float* part_m,
                                 float* part_s, int* part_i, int* ticket,
                                 int* tok, float* prob, int M, int N, int K,
                                 int blocks, int* launched, cudaStream_t st) {
  return top1_entry<kF32>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket,
                         tok, prob, M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_f32(const void* a, const float* norm,
                                 const void* codes, const float* inv,
                                 const float* zp, float scale, float cap,
                                 const uint8_t* mask, int k_top,
                                 __nv_bfloat16* a_scratch, float* part_v,
                                 int* part_i, float* vals, int* idxs, int M,
                                 int N, int K, int blocks, int* launched,
                                 cudaStream_t st) {
  return topk_entry<kF32>(a, norm, affine_b(codes, inv, zp, scale), cap, mask, k_top,
                         a_scratch, part_v, part_i, vals, idxs, M, N, K,
                         blocks, launched, st);
}

// i4: `inv` holds the group scales and `zp` the group mins.
extern "C" int gemma_top1_i4(const void* a, const float* norm,
                                 const void* codes, const float* inv,
                                 const float* zp, float scale, float cap,
                                 const uint8_t* mask, int need_prob,
                                 float* part_m,
                                 float* part_s, int* part_i, int* ticket,
                                 int* tok, float* prob, int M, int N, int K,
                                 int blocks, int* launched, cudaStream_t st) {
  return top1_entry<kI4>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket,
                         tok, prob, M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_i4(const void* a, const float* norm,
                                 const void* codes, const float* inv,
                                 const float* zp, float scale, float cap,
                                 const uint8_t* mask, int k_top,
                                 __nv_bfloat16* a_scratch, float* part_v,
                                 int* part_i, float* vals, int* idxs, int M,
                                 int N, int K, int blocks, int* launched,
                                 cudaStream_t st) {
  return topk_entry<kI4>(a, norm, affine_b(codes, inv, zp, scale), cap, mask, k_top,
                         a_scratch, part_v, part_i, vals, idxs, M, N, K,
                         blocks, launched, st);
}

// nuq4: tables [N, tstride] of SFP bytes, 16 per 256-block of K.
extern "C" int gemma_top1_nuq4(const void* a, const float* norm,
                                 const void* codes, const void* tables, int tstride, float scale, float cap,
                                 const uint8_t* mask, int need_prob,
                                 float* part_m,
                                 float* part_s, int* part_i, int* ticket,
                                 int* tok, float* prob, int M, int N, int K,
                                 int blocks, int* launched, cudaStream_t st) {
  return top1_entry<kNuq4>(a, norm, nuq4_b(codes, tables, tstride, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket,
                         tok, prob, M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_nuq4(const void* a, const float* norm,
                                 const void* codes, const void* tables, int tstride, float scale, float cap,
                                 const uint8_t* mask, int k_top,
                                 __nv_bfloat16* a_scratch, float* part_v,
                                 int* part_i, float* vals, int* idxs, int M,
                                 int N, int K, int blocks, int* launched,
                                 cudaStream_t st) {
  return topk_entry<kNuq4>(a, norm, nuq4_b(codes, tables, tstride, scale), cap, mask, k_top,
                         a_scratch, part_v, part_i, vals, idxs, M, N, K,
                         blocks, launched, st);
}

// The passes alone, for checking each against its plain version.
extern "C" int gemma_prenorm_bf16(const float* a, const float* w,
                                  __nv_bfloat16* out, int M, int K,
                                  int* launched, cudaStream_t st) {
  prenorm_kernel<<<M, 256, 0, st>>>(a, w, out, K);
  *launched = kLaunchedSelf;
  return (int)cudaGetLastError();
}

extern "C" int gemma_postnorm_add(const float* y, const float* w,
                                  const float* add, void* out, int M, int N,
                                  int out_bf16, int* launched,
                                  cudaStream_t st) {
  postnorm_add_kernel<<<M, 256, 0, st>>>(y, w, add, out, N, out_bf16);
  *launched = kLaunchedSelf;
  return (int)cudaGetLastError();
}

extern "C" int gemma_topk_merge(const float* part_v, const int* part_i,
                                float* vals, int* idxs, int M, int nblocks,
                                int k_top, int* launched, cudaStream_t st) {
  *launched = 0;
  if (k_top < 1 || k_top > kTopkMax) return (int)cudaErrorInvalidValue;
  topk_merge_kernel<<<M, kMergeWarps * 32, 0, st>>>(part_v, part_i, nblocks,
                                                    k_top, vals, idxs);
  *launched = kLaunchedSelf;
  return (int)cudaGetLastError();
}
