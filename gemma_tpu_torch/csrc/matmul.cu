// The fused logits heads for Hopper (sm_90a): K3 and K6 of the port, each
// instantiated per weight codec (K7a's one-byte and dense decoders, K7b's
// 4.5-bit ones), and the C entries of the norm passes alone.
//
// Replaces gemma_tpu/ops/matmul.py:_top1_kernel (K3, the fused greedy head;
// see top1_body below), matmul.py:_topk_kernel (K6, the fused top-k head;
// see its section) and, inside both, matmul.py:_acc_step's i8, sfp/nuq and
// bf16/f32 branches with _sfp_tile_to_bf16 (K7a) and its nuq4 and i4
// branches (K7b).  K1 and K2 (and K12, their stacked form) are
// matmul_decode.cu's at M <= 16 rows and matmul_sm90.cu's above.  The
// heads compute
//   logits[M, N] = scale * A[M, K] . dequant(B)[N, K]^T
// with A bf16, the B tile turned into bf16 in
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
//         block's table is decoded once into two byte planes of bf16
//         entries (gemm_common.cuh:nuq4_planes) and four codes are looked
//         up at once by byte permutes (nuq4_plane_frag).  The TPU
//         kernel's 128-lane gather windows have no counterpart: a table
//         never leaves the lanes' registers.  The tensor scale multiplies
//         the output.
// K3 is one launch: the decode tile's warp (gemm_common.cuh) with the
// final norm folded in (see top1_body).  K6 runs the same stream, the
// final norm folded in as well, and then its selection (see
// topk_merge_kernel); its entry reports through `launched` which of the
// two it put on the stream (kLaunched* bits), so the caller counts the
// launches that happened.  The codecs' element decoders and the B
// operand are gemm_common.cuh's.
//
// What bounds the heads on an H100 (3.35 TB/s): the weights' bytes, e.g.
// the logits head 256000x2304 = 608 MB (i8), 590 MB (sfp), 1180 MB (bf16),
// 332 MB (i4, nuq4) -> 182, 176, 352, 99 us.  K3 writes no logits; K6
// writes and reads back M x N f32 (4 MB at M = 4, ~2.5 us).

#include <climits>

#include "gemm_common.cuh"

using namespace gemma;

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
// Design: the decode tile's warp (gemm_common.cuh).  A
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
  float* logits;        // K6: [M, N] f32, the capped logits (masked -inf)
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

// K3's merges: the 8 lanes of a row (g = 0..7) of each warp's states, the
// warps in order, then the blocks by the last block to take the ticket.
template <int NT>
__device__ __forceinline__ void top1_finish(const Top1Args& q,
                                            Top1State (&st)[NT][2], int M,
                                            int m0) {
  const DecodeArgs& p = q.mm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool need_prob = q.need_prob != 0;
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

template <int CODEC, int NT, bool TOPK>
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
  const bool capped = (TOPK || need_prob) && q.cap != 0.f;
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
              const int m = 8 * nt + 2 * t + e;
              if (m < M) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  if (TOPK ? n0 + 8 * h >= N : !live[h]) continue;
                  float v = acc[nt][2 * h + e] * p.scale[0];
                  if (capped) v = q.cap * tanhf(v / q.cap);
                  if constexpr (TOPK)  // K6: every column, masked ones -inf
                    q.logits[(size_t)(m0 + m) * N + n0 + 8 * h] = live[h] ? v : -INFINITY;
                  else
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

  if constexpr (!TOPK) top1_finish(q, st, M, m0);
}

// ---------------------------------------------------------------------------
// K6: the fused top-k head (replaces matmul.py:_topk_kernel).
//
// Per row, the k_top <= 128 largest of softcap(scale * A . B^T) over all N
// columns, as values f32 and column indices i32, descending, ties to the
// lower index.  Masked columns and columns past N never enter; when fewer
// than k_top columns are live the remaining entries are (-inf, index 0)
// (matmul.py:1483-1491).
//
// Two launches.  The head is K3's stream (top1_body with TOPK): the same
// persistent blocks, row groups and register ring, the final norm folded
// in, and at each group's end every lane stores its capped outputs to an
// [M, N] f32 buffer (masked columns as -inf): 4 MB at M = 4 beside the
// head's 608 MB of i8 weights.  Then topk_merge_kernel selects: block (s,
// row) takes kSelSlice consecutive entries of the row and keeps its k_top
// best in a sorted list, and the last block of the row to take the ticket
// selects the row's k_top best of those lists.  A selection orders every
// entry by one 64-bit key, the value's bits made monotone above (-0.0 as
// +0.0) and the complement of its index below, so that (value descending,
// index ascending) is the key's order: a total order, and the result is
// the same whatever the number of slices.  It prunes first (block_topk:
// the k_top-th largest of the threads' own maxima bounds the answer from
// below), then finds the k_top-th key of what is left by radix passes
// over 8-bit digits from the top (radix_kth), gathers the keys at or above
// it and sorts those (bitonic, k_top padded to a power of two).
constexpr int kTopkMax = 128;
constexpr int kSelThreads = 256;
constexpr int kSelSlice = 4096;      // entries a block of the first stage
constexpr int kSelMaxMerge = 8192;   // entries the merging block holds
constexpr unsigned long long kDeadKey =
    (0x007fffffull << 32) | 0x80000000ull;  // (-inf, INT_MAX): an empty slot

struct SelArgs {
  const float* in_v;  // [M, n] values: the head's logits, or lists
  const int* in_i;    // [M, n] their indices, or null: the position
  int n, k_top, slices;
  float* part_v;      // [M, slices, k_top]: the slices' lists
  int* part_i;
  int* tickets;       // [M], zero between launches; the last block re-zeroes
  float* vals;        // [M, k_top]
  int* idxs;
};

__device__ __forceinline__ unsigned long long sel_key(float v, int i) {
  const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
  const uint32_t hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)hi << 32) | (uint32_t)~i;
}
__device__ __forceinline__ float sel_value(unsigned long long key) {
  const uint32_t hi = (uint32_t)(key >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}
__device__ __forceinline__ int sel_index(unsigned long long key) {
  return (int)~(uint32_t)key;
}

struct SelShared {
  unsigned hist[256];
  unsigned long long tmax[kSelThreads];  // each thread's largest key
  int bin, above, in_bin, n_gt, n_eq;
};

// The radix search for the need-th largest of keys[0, cnt): passes over
// 8-bit digits from the top, each a histogram of the digits among the keys
// that match `prefix` on `mask`, the bin where the count from the top
// reaches the keys still needed; done as soon as every key of that bin is
// taken.  On return the need-th key matches prefix on mask, and `need`
// keys still to take match it (all of them but with equal keys).
struct Kth {
  unsigned long long prefix, mask;
  int need;
};

__device__ Kth radix_kth(const unsigned long long* keys, int cnt, int need,
                         SelShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Kth r = {0ull, 0ull, need};
  for (int pass = 0; pass < 8 && r.need > 0; ++pass) {
    const int shift = 56 - 8 * pass;
    for (int i = tid; i < 256; i += kSelThreads) sh.hist[i] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < cnt; i0 += kSelThreads) {
      const int i = i0 + tid;
      const unsigned long long key = i < cnt ? keys[i] : 0ull;
      const bool in = i < cnt && (key & r.mask) == r.prefix;
      const unsigned dig = (unsigned)(key >> shift) & 255u;
      const unsigned bal = __ballot_sync(0xffffffffu, in);
      if (in) {  // one atomic a digit a warp
        const unsigned peers = __match_any_sync(bal, dig);
        if (lane == __ffs(peers) - 1) atomicAdd(&sh.hist[dig], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l holds bins 255 - 8l down to 248 - 8l; counts from the top.
      unsigned c[8], tot = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) tot += c[j] = sh.hist[255 - 8 * lane - j];
      unsigned incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      unsigned run = incl - tot;
      if (run < (unsigned)r.need && (unsigned)r.need <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (run + c[j] >= (unsigned)r.need) {
            sh.bin = 255 - 8 * lane - j;
            sh.above = (int)run;
            sh.in_bin = (int)c[j];
            break;
          }
          run += c[j];
        }
      }
    }
    __syncthreads();
    r.need -= sh.above;
    r.prefix |= (unsigned long long)sh.bin << shift;
    r.mask |= 0xffull << shift;
    const bool all_of_bin = r.need == sh.in_bin;
    __syncthreads();  // sh read by all before the next pass writes it
    if (all_of_bin) break;
  }
  return r;
}

// The min(k_top, cnt) largest of keys[0, cnt) into out[0, ..) in
// descending order, out padded with kDeadKey to k_top: the keys above the
// k-th's prefix (all taken) and `need` of those that match it, sorted
// (bitonic, k_top padded to a power of two).  Every thread of the block
// calls it.  Equal keys (empty slots) are interchangeable.
__device__ void select_sorted(const unsigned long long* keys, int cnt,
                              int k_top, unsigned long long* out,
                              SelShared& sh) {
  const int tid = threadIdx.x;
  const int k_sel = min(k_top, cnt);
  const Kth r = radix_kth(keys, cnt, k_sel, sh);
  if (tid == 0) sh.n_gt = sh.n_eq = 0;
  __syncthreads();
  for (int i = tid; i < cnt; i += kSelThreads) {
    const unsigned long long key = keys[i], top = key & r.mask;
    if (top > r.prefix) {
      out[atomicAdd(&sh.n_gt, 1)] = key;
    } else if (top == r.prefix) {
      const int at = atomicAdd(&sh.n_eq, 1);
      if (at < r.need) out[k_sel - r.need + at] = key;
    }
  }
  int P = 1;
  while (P < k_top) P <<= 1;
  for (int i = k_sel + tid; i < P; i += kSelThreads) out[i] = kDeadKey;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < P / 2; t += kSelThreads) {
        const int i = 2 * stride * (t / stride) + t % stride, j = i + stride;
        const unsigned long long x = out[i], y = out[j];
        if ((x < y) == ((i & size) == 0)) {
          out[i] = y;
          out[j] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The k_top best of keys[0, cnt) as select_sorted gives them, after a
// pruning: thread t's largest key over entries t, t + kSelThreads, ...;
// the k_top-th largest of those maxima bounds the k_top-th largest key
// from below (k_top threads each hold a key at or above it), so only the
// keys at or above its prefix go on, into cand (cnt slots), typically a
// few times k_top of a slice's 4096.  A thread with no entry offers key 0,
// below every real key.
__device__ void block_topk(const unsigned long long* keys, int cnt, int k_top,
                           unsigned long long* cand, unsigned long long* out,
                           SelShared& sh) {
  const int tid = threadIdx.x;
  unsigned long long mx = 0ull;
  for (int i = tid; i < cnt; i += kSelThreads) mx = keys[i] > mx ? keys[i] : mx;
  sh.tmax[tid] = mx;
  __syncthreads();
  const unsigned long long bound = radix_kth(sh.tmax, kSelThreads, k_top, sh).prefix;
  if (tid == 0) sh.n_gt = 0;
  __syncthreads();
  for (int i = tid; i < cnt; i += kSelThreads)
    if (keys[i] >= bound) cand[atomicAdd(&sh.n_gt, 1)] = keys[i];
  __syncthreads();
  const int n = sh.n_gt;
  __syncthreads();  // n read by all before select_sorted resets it
  select_sorted(cand, n, k_top, out, sh);
}

// One row's result: values, and indices 0 where the value is -inf.
__device__ __forceinline__ void sel_write(const unsigned long long* sel,
                                          int k, float* vals, int* idxs) {
  for (int j = threadIdx.x; j < k; j += kSelThreads) {
    const float v = sel_value(sel[j]);
    vals[j] = v;
    idxs[j] = v == -INFINITY ? 0 : sel_index(sel[j]);
  }
}

__global__ void __launch_bounds__(kSelThreads) topk_merge_kernel(SelArgs a) {
  // keys, then cand: max(slice, slices * k_top) each
  extern __shared__ unsigned long long keys[];
  __shared__ unsigned long long sel[kTopkMax];
  __shared__ SelShared sh;
  __shared__ bool is_last;
  const int s = blockIdx.x, row = blockIdx.y, k = a.k_top, tid = threadIdx.x;
  unsigned long long* cand = keys + max(kSelSlice, a.slices * k);
  const int lo = s * kSelSlice, cnt = min(kSelSlice, a.n - lo);
  const float* v = a.in_v + (size_t)row * a.n + lo;
  const int* ii = a.in_i != nullptr ? a.in_i + (size_t)row * a.n + lo : nullptr;
  for (int i = tid; i < cnt; i += kSelThreads)
    keys[i] = sel_key(v[i], ii != nullptr ? ii[i] : lo + i);
  __syncthreads();
  block_topk(keys, cnt, k, cand, sel, sh);
  if (a.slices == 1) {
    sel_write(sel, k, a.vals + (size_t)row * k, a.idxs + (size_t)row * k);
    return;
  }
  const size_t mine = ((size_t)row * a.slices + s) * k;
  for (int j = tid; j < k; j += kSelThreads) {
    a.part_v[mine + j] = sel_value(sel[j]);
    a.part_i[mine + j] = sel_index(sel[j]);
  }
  // One thread fences for the block after the barrier, takes the ticket,
  // and the last block's fences again before its threads read the lists.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(a.tickets + row, 1) == a.slices - 1;
    if (is_last) __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  // The last block of the row: its slices' lists, every entry once.
  const int total = a.slices * k;
  const size_t base = (size_t)row * total;
  for (int i = tid; i < total; i += kSelThreads)
    keys[i] = sel_key(__ldcg(a.part_v + base + i), __ldcg(a.part_i + base + i));
  __syncthreads();
  block_topk(keys, total, k, cand, sel, sh);
  sel_write(sel, k, a.vals + (size_t)row * k, a.idxs + (size_t)row * k);
  if (tid == 0) a.tickets[row] = 0;
}

// The selection's launch: slices (n / kSelSlice rounded up) x M blocks.
static cudaError_t launch_select(const SelArgs& a, int M, cudaStream_t st) {
  const int bytes = 2 * max(kSelSlice, a.slices * a.k_top) * 8;
  static const cudaError_t attr = cudaFuncSetAttribute(
      topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * kSelMaxMerge * 8);
  if (attr != cudaSuccess) return attr;
  topk_merge_kernel<<<dim3(a.slices, M), kSelThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

// Refuses what the selection does not take: k_top outside 1..kTopkMax or
// above n, a slice count other than n's, or more list entries than the
// merging block holds.
static bool select_ok(int n, int k_top, int slices) {
  return k_top >= 1 && k_top <= kTopkMax && k_top <= n &&
         slices == (n + kSelSlice - 1) / kSelSlice &&
         slices * k_top <= kSelMaxMerge;
}

// The heads' kernels by name, one pair per codec, so the launch counters
// and the profiler tell the kinds apart.
#define GEMMA_CODEC_KERNELS(KIND, CODEC)                                     \
  template <int NT>                                                          \
  __global__ void __launch_bounds__(kDecodeThreads,                          \
                                    top1_blocks_per_sm(CODEC, NT))           \
      top1_##KIND##_kernel(Top1Args q) {                                     \
    top1_body<CODEC, NT, false>(q);                                          \
  }                                                                          \
  template <int NT>                                                          \
  __global__ void __launch_bounds__(kDecodeThreads,                          \
                                    top1_blocks_per_sm(CODEC, NT))           \
      topk_##KIND##_kernel(Top1Args q) {                                     \
    top1_body<CODEC, NT, true>(q);                                           \
  }

GEMMA_CODEC_KERNELS(i8, kI8)
GEMMA_CODEC_KERNELS(sfp, kSfp)
GEMMA_CODEC_KERNELS(bf16, kBf16)
GEMMA_CODEC_KERNELS(f32, kF32)
GEMMA_CODEC_KERNELS(i4, kI4)
GEMMA_CODEC_KERNELS(nuq4, kNuq4)

using Top1Kernel = void (*)(Top1Args);

template <int CODEC, int NT, bool TOPK>
static Top1Kernel head_kernel() {
#define GEMMA_PICK(KIND, CODE)                                                 \
  if constexpr (CODEC == CODE)                                                 \
    return TOPK ? &topk_##KIND##_kernel<NT> : &top1_##KIND##_kernel<NT>;
  GEMMA_PICK(i8, kI8)
  GEMMA_PICK(sfp, kSfp)
  GEMMA_PICK(bf16, kBf16)
  GEMMA_PICK(f32, kF32)
  GEMMA_PICK(i4, kI4)
  GEMMA_PICK(nuq4, kNuq4)
#undef GEMMA_PICK
  return nullptr;
}

// One head launch (K3, or K6's first): as many blocks as fit on the card
// at once (at most `blocks`, and one per 8 row groups), a row of them per
// 16 rows of A.
template <int CODEC, int NT, bool TOPK>
static cudaError_t launch_head(Top1Args& q, int blocks, int smem,
                               cudaStream_t st) {
  const Top1Kernel k = head_kernel<CODEC, NT, TOPK>();
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

// The arguments both heads share, checked: A bf16, or f32 with the final
// norm folded in; B; M, N, K.  Returns the dynamic shared memory, or -1
// for what the heads do not take.
template <int CODEC>
static int head_args(Top1Args& q, const void* a, const float* norm,
                     const BOperand& w, float cap, const uint8_t* mask,
                     int M, int N, int K, int blocks) {
  using C = Codec<CODEC>;
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
  q.cap = cap;
  q.mask = mask;
  if (blocks < 1 || M < 1 || N < 1 || N % 8 || K % C::kChunk ||
      (CODEC == kNuq4 && w.tstride != nuq4_tstride(K)) ||
      (reinterpret_cast<uintptr_t>(a) & 15) ||
      (reinterpret_cast<uintptr_t>(norm) & 15))
    return -1;
  const int smem = head_smem<CODEC>(min(M, 16), K, norm != nullptr).bytes;
  return smem > kTop1SmemMax ? -1 : smem;
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
  *launched = 0;
  Top1Args q = {};
  const int smem = head_args<CODEC>(q, a, norm, w, cap, mask, M, N, K, blocks);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  q.need_prob = need_prob;
  q.part_m = part_m; q.part_s = part_s; q.part_i = part_i;
  q.ticket = ticket; q.tok = tok; q.prob = prob;
  const cudaError_t e = M > 8 ? launch_head<CODEC, 2, false>(q, blocks, smem, st)
                              : launch_head<CODEC, 1, false>(q, blocks, smem, st);
  if (e != cudaSuccess) return (int)e;
  *launched = kLaunchedSelf;
  return 0;
}

// The top-k head: vals / idxs [M, k_top] of softcap(scale * A . B^T), A as
// K3 takes it.  logits: [M, N] f32 scratch; part_*: [M, slices, k_top]
// scratch; tickets: [M], zero between launches.
template <int CODEC>
static int topk_entry(const void* a, const float* norm, const BOperand& w,
                      float cap, const uint8_t* mask, int k_top,
                      float* logits, float* part_v, int* part_i, int* tickets,
                      float* vals, int* idxs, int M, int N, int K, int blocks,
                      int slices, int* launched, cudaStream_t st) {
  *launched = 0;
  Top1Args q = {};
  const int smem = head_args<CODEC>(q, a, norm, w, cap, mask, M, N, K, blocks);
  if (smem < 0 || !select_ok(N, k_top, slices))
    return (int)cudaErrorInvalidValue;
  q.logits = logits;
  cudaError_t e = M > 8 ? launch_head<CODEC, 2, true>(q, blocks, smem, st)
                        : launch_head<CODEC, 1, true>(q, blocks, smem, st);
  if (e != cudaSuccess) return (int)e;
  *launched = kLaunchedSelf;
  const SelArgs sa = {logits, nullptr, N, k_top, slices, part_v, part_i,
                      tickets, vals, idxs};
  e = launch_select(sa, M, st);
  if (e != cudaSuccess) return (int)e;
  *launched |= kLaunchedMerge;
  return 0;
}

// The C entries, one per head and codec (kind "nuq" calls the sfp ones).
// inv and zp are read for i8 (and, as scales and mins, for i4) only.
extern "C" int gemma_top1_i8(const void* a, const float* norm,
                             const void* codes, const float* inv, const float* zp,
                             float scale, float cap,
                             const uint8_t* mask, int need_prob,
                             float* part_m, float* part_s, int* part_i,
                             int* ticket, int* tok, float* prob, int M, int N,
                             int K, int blocks, int* launched,
                             cudaStream_t st) {
  return top1_entry<kI8>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket, tok, prob,
                         M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_i8(const void* a, const float* norm,
                             const void* codes, const float* inv, const float* zp,
                             float scale, float cap,
                             const uint8_t* mask, int k_top, float* logits,
                             float* part_v, int* part_i, int* tickets,
                             float* vals, int* idxs, int M, int N, int K,
                             int blocks, int slices, int* launched,
                             cudaStream_t st) {
  return topk_entry<kI8>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         k_top, logits, part_v, part_i, tickets, vals, idxs,
                         M, N, K, blocks, slices, launched, st);
}

extern "C" int gemma_top1_sfp(const void* a, const float* norm,
                             const void* codes, const float* inv, const float* zp,
                             float scale, float cap,
                             const uint8_t* mask, int need_prob,
                             float* part_m, float* part_s, int* part_i,
                             int* ticket, int* tok, float* prob, int M, int N,
                             int K, int blocks, int* launched,
                             cudaStream_t st) {
  return top1_entry<kSfp>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket, tok, prob,
                         M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_sfp(const void* a, const float* norm,
                             const void* codes, const float* inv, const float* zp,
                             float scale, float cap,
                             const uint8_t* mask, int k_top, float* logits,
                             float* part_v, int* part_i, int* tickets,
                             float* vals, int* idxs, int M, int N, int K,
                             int blocks, int slices, int* launched,
                             cudaStream_t st) {
  return topk_entry<kSfp>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         k_top, logits, part_v, part_i, tickets, vals, idxs,
                         M, N, K, blocks, slices, launched, st);
}

extern "C" int gemma_top1_bf16(const void* a, const float* norm,
                             const void* codes, const float* inv, const float* zp,
                             float scale, float cap,
                             const uint8_t* mask, int need_prob,
                             float* part_m, float* part_s, int* part_i,
                             int* ticket, int* tok, float* prob, int M, int N,
                             int K, int blocks, int* launched,
                             cudaStream_t st) {
  return top1_entry<kBf16>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket, tok, prob,
                         M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_bf16(const void* a, const float* norm,
                             const void* codes, const float* inv, const float* zp,
                             float scale, float cap,
                             const uint8_t* mask, int k_top, float* logits,
                             float* part_v, int* part_i, int* tickets,
                             float* vals, int* idxs, int M, int N, int K,
                             int blocks, int slices, int* launched,
                             cudaStream_t st) {
  return topk_entry<kBf16>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         k_top, logits, part_v, part_i, tickets, vals, idxs,
                         M, N, K, blocks, slices, launched, st);
}

extern "C" int gemma_top1_f32(const void* a, const float* norm,
                             const void* codes, const float* inv, const float* zp,
                             float scale, float cap,
                             const uint8_t* mask, int need_prob,
                             float* part_m, float* part_s, int* part_i,
                             int* ticket, int* tok, float* prob, int M, int N,
                             int K, int blocks, int* launched,
                             cudaStream_t st) {
  return top1_entry<kF32>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket, tok, prob,
                         M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_f32(const void* a, const float* norm,
                             const void* codes, const float* inv, const float* zp,
                             float scale, float cap,
                             const uint8_t* mask, int k_top, float* logits,
                             float* part_v, int* part_i, int* tickets,
                             float* vals, int* idxs, int M, int N, int K,
                             int blocks, int slices, int* launched,
                             cudaStream_t st) {
  return topk_entry<kF32>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         k_top, logits, part_v, part_i, tickets, vals, idxs,
                         M, N, K, blocks, slices, launched, st);
}

// i4: `inv` holds the group scales and `zp` the group mins.
extern "C" int gemma_top1_i4(const void* a, const float* norm,
                             const void* codes, const float* inv, const float* zp,
                             float scale, float cap,
                             const uint8_t* mask, int need_prob,
                             float* part_m, float* part_s, int* part_i,
                             int* ticket, int* tok, float* prob, int M, int N,
                             int K, int blocks, int* launched,
                             cudaStream_t st) {
  return top1_entry<kI4>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket, tok, prob,
                         M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_i4(const void* a, const float* norm,
                             const void* codes, const float* inv, const float* zp,
                             float scale, float cap,
                             const uint8_t* mask, int k_top, float* logits,
                             float* part_v, int* part_i, int* tickets,
                             float* vals, int* idxs, int M, int N, int K,
                             int blocks, int slices, int* launched,
                             cudaStream_t st) {
  return topk_entry<kI4>(a, norm, affine_b(codes, inv, zp, scale), cap, mask,
                         k_top, logits, part_v, part_i, tickets, vals, idxs,
                         M, N, K, blocks, slices, launched, st);
}

// nuq4: tables [N, tstride] of SFP bytes, 16 per 256-block of K.
extern "C" int gemma_top1_nuq4(const void* a, const float* norm,
                             const void* codes, const void* tables, int tstride,
                             float scale, float cap,
                             const uint8_t* mask, int need_prob,
                             float* part_m, float* part_s, int* part_i,
                             int* ticket, int* tok, float* prob, int M, int N,
                             int K, int blocks, int* launched,
                             cudaStream_t st) {
  return top1_entry<kNuq4>(a, norm, nuq4_b(codes, tables, tstride, scale), cap, mask,
                         need_prob, part_m, part_s, part_i, ticket, tok, prob,
                         M, N, K, blocks, launched, st);
}

extern "C" int gemma_topk_nuq4(const void* a, const float* norm,
                             const void* codes, const void* tables, int tstride,
                             float scale, float cap,
                             const uint8_t* mask, int k_top, float* logits,
                             float* part_v, int* part_i, int* tickets,
                             float* vals, int* idxs, int M, int N, int K,
                             int blocks, int slices, int* launched,
                             cudaStream_t st) {
  return topk_entry<kNuq4>(a, norm, nuq4_b(codes, tables, tstride, scale), cap, mask,
                         k_top, logits, part_v, part_i, tickets, vals, idxs,
                         M, N, K, blocks, slices, launched, st);
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

// K6's selection alone, as a merge: the k_top best of each row's nblocks
// lists part_v / part_i [M, nblocks, k_top] (any order within and across
// lists) into vals / idxs [M, k_top]; scratch_* [M, slices, k_top] and
// tickets [M] as topk_entry's.
extern "C" int gemma_topk_merge(const float* part_v, const int* part_i,
                                float* vals, int* idxs, int M, int nblocks,
                                int k_top, float* scratch_v, int* scratch_i,
                                int* tickets, int slices, int* launched,
                                cudaStream_t st) {
  *launched = 0;
  const int n = nblocks * k_top;
  if (M < 1 || nblocks < 1 || !select_ok(n, k_top, slices))
    return (int)cudaErrorInvalidValue;
  const SelArgs sa = {part_v, part_i, n, k_top, slices, scratch_v, scratch_i,
                      tickets, vals, idxs};
  const cudaError_t e = launch_select(sa, M, st);
  if (e != cudaSuccess) return (int)e;
  *launched = kLaunchedSelf;
  return 0;
}
