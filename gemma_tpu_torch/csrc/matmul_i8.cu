// i8-weight GEMMs for Hopper (sm_90a): K1, K2 and K3 of the port.
//
// Replaces gemma_tpu/ops/matmul.py:_mm_kernel (K1, with _acc_step's i8
// branch, the _norm_a prologue and the post-norm + residual epilogue),
// matmul.py:_gated_kernel (K2) and matmul.py:_top1_kernel (K3, the fused
// greedy head; see top1_i8_kernel below).  Computes
//   C[M, N] = scale * A[M, K] . dequant(B)[N, K]^T,   dequant = inv*(c - zp)
// per 128-wide K group g, applied to the OUTPUT as the TPU kernel does:
//   C += inv_g * (A_g . C_g) - (inv_g * zp_g) * sum(A_g)
// so the i8 codes feed the tensor cores raw (exact in bf16), A is bf16,
// products accumulate in f32.  The gated variant keeps two accumulators
// over one A and emits bf16 gelu_tanh(C1) * C2 with matmul.py:664-665's
// constants.  One C entry per GEMM runs up to three kernels on the stream:
//   prenorm_kernel     A f32 -> bf16 RMSNorm(A) (f32 mean over the logical
//                      K, (1 + w)), once per row instead of in every block;
//   mm_i8_kernel       the GEMM (or gated GEMM);
//   postnorm_add_kernel  out = add + postnorm(C) over whole rows: the post
//                      norm needs all N = 2304 outputs of a row, which
//                      blocks that split N cannot see.
// Each entry reports through `launched` which of them it put on the stream
// (kLaunched* bits), so the caller counts the launches that happened.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   decode (M = B <= 16) is bytes-bound on the weights: N*K code bytes +
//   8*N*K/128 scale bytes, e.g. qkv 4096x2304 = 9.9 MB -> 2.9 us, the
//   logits head 256000x2304 = 608 MB -> 182 us;
//   prefill (M = 4*512) is operations-bound: 2*M*N*K, e.g. the gated FFN
//   2*2*2048*9216*2304 = 174 GFLOP -> 176 us;
//   the greedy head (K3) reads the logits GEMM's codes and scales,
//   590 MB + 37 MB at N = 256000, and writes no logits: 187 us.
// Simple design: mma.sync m16n8k16 (bf16 in, f32 accumulate) with no
// shared-memory staging.  Each warp owns a (16*MT) x (8*NT) output tile;
// a lane loads 2 x 16 B of codes per B row per group and converts them to
// bf16 in registers with byte permutes and adds (common.cuh), not the
// quarter-rate integer-to-float unit.  The 128 K of a group are permuted
// identically on A and B (a sum over k does not care) so each lane's code
// bytes are contiguous.  At M <= 16 eight warps split the K groups of one
// 16x8 tile (reduced through shared memory) and the next group's codes
// are prefetched into registers.  Measured on the card, the decode GEMMs
// are latency-bound (waves of short blocks), not bandwidth-bound; left for
// later: TMA/cp.async multi-stage pipelines with persistent blocks,
// wgmma for prefill, and fusing the passes.

#include <climits>

#include "common.cuh"

using namespace gemma;

struct MMArgs {
  const __nv_bfloat16* a;  // [M, K]
  const int8_t* codes[2];
  const float* inv[2];  // [N, K/128]
  const float* zp[2];   // [N, K/128]
  float scale[2];
  void* out;  // [M, N], f32 or bf16
  int M, N, K;
  int out_bf16;
};

template <int NB, int NT>
__device__ __forceinline__ void load_b(uint4 (&dst)[NB][NT][2],
                                       const MMArgs& p, int n0, int gid,
                                       int t, int g) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + gid;
      if (n < p.N) {
        const uint4* src = reinterpret_cast<const uint4*>(
            p.codes[b] + (size_t)n * p.K + g * 128 + 16 * t);
        dst[b][j][0] = __ldg(src);
        dst[b][j][1] = __ldg(src + 4);  // +64 bytes
      } else {
        dst[b][j][0] = make_uint4(0, 0, 0, 0);
        dst[b][j][1] = make_uint4(0, 0, 0, 0);
      }
    }
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// The block's (16*MT) x BN output tile at rows m0.., columns nb..: on
// return the warps with ks == 0 hold the full sums in `acc` (mma.sync
// fragment layout: lane (gid, t) has rows gid and gid + 8 of each 16-row
// tile, columns 2t and 2t + 1 of each 8-column tile).  Every thread of
// the block must call it (it synchronizes), with the same m0 and nb.
template <int MT, int NT, int KSPLIT, int WARPS, bool GATED>
__device__ __forceinline__ void mm_tile(const MMArgs& p, int m0, int nb,
                                        float (&acc)[GATED ? 2 : 1][MT][NT][4]) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int TILES = WARPS / KSPLIT;
  constexpr int FRAG = NB * MT * NT * 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int ks = warp % KSPLIT, tile = warp / KSPLIT;
  const int n0 = nb + tile * 8 * NT;
  const int M = p.M, N = p.N, K = p.K, G = K / 128;

  float part[NB][MT][NT][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][i][j][e] = part[b][i][j][e] = 0.f;

  uint4 bcur[NB][NT][2];
  if (ks < G) load_b<NB, NT>(bcur, p, n0, gid, t, ks);

  for (int g = ks; g < G; g += KSPLIT) {
    uint4 bnext[NB][NT][2];
    const int gn = g + KSPLIT;
    if (gn < G) load_b<NB, NT>(bnext, p, n0, gid, t, gn);

    float psum[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) psum[i][0] = psum[i][1] = 0.f;

#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int koff = (s < 4) ? (16 * t + 4 * s) : (64 + 16 * t + 4 * (s - 4));
      const int k = g * 128 + koff;
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 16 * i + gid + 8 * h;
          uint2 x = make_uint2(0, 0);
          if (row < M)
            x = *reinterpret_cast<const uint2*>(p.a + (size_t)row * K + k);
          af[i][h] = x.x;      // a0 / a1: k, k+1
          af[i][2 + h] = x.y;  // a2 / a3: k+2, k+3
          const float v0 = __uint_as_float(x.x << 16);
          const float v1 = __uint_as_float(x.x & 0xffff0000u);
          const float v2 = __uint_as_float(x.y << 16);
          const float v3 = __uint_as_float(x.y & 0xffff0000u);
          psum[i][h] += (v0 + v1) + (v2 + v3);
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bf[2];
          i8x4_to_bf16x2(word_of(bcur[b][j][s >> 2], s & 3), bf);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_bf16_16816(part[b][i][j], af[i], bf);
        }
      }
    }

    // Group sums of A: each lane saw 32 of the 128 k; the 4 lanes of a
    // row (t = 0..3) together saw all of them.
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        psum[i][h] += __shfl_xor_sync(0xffffffffu, psum[i][h], 1);
        psum[i][h] += __shfl_xor_sync(0xffffffffu, psum[i][h], 2);
      }

#pragma unroll
    for (int b = 0; b < NB; ++b) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int na = n0 + 8 * j + 2 * t;  // N is even: na + 1 < N too
        float inva = 0.f, invb = 0.f, izpa = 0.f, izpb = 0.f;
        if (na < N) {
          inva = p.inv[b][(size_t)na * G + g];
          invb = p.inv[b][(size_t)(na + 1) * G + g];
          izpa = inva * p.zp[b][(size_t)na * G + g];
          izpb = invb * p.zp[b][(size_t)(na + 1) * G + g];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float* c = part[b][i][j];
          acc[b][i][j][0] += inva * c[0] - izpa * psum[i][0];
          acc[b][i][j][1] += invb * c[1] - izpb * psum[i][0];
          acc[b][i][j][2] += inva * c[2] - izpa * psum[i][1];
          acc[b][i][j][3] += invb * c[3] - izpb * psum[i][1];
          c[0] = c[1] = c[2] = c[3] = 0.f;
        }
      }
    }
    if (gn < G) {
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

template <int MT, int NT, int KSPLIT, int WARPS, bool GATED>
__global__ void __launch_bounds__(WARPS * 32) mm_i8_kernel(MMArgs p) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int TILES = WARPS / KSPLIT;
  constexpr int BM = 16 * MT;
  constexpr int BN = TILES * 8 * NT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int ks = warp % KSPLIT, tile = warp / KSPLIT;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN + tile * 8 * NT;
  const int M = p.M, N = p.N;

  float acc[NB][MT][NT][4];
  mm_tile<MT, NT, KSPLIT, WARPS, GATED>(p, m0, blockIdx.x * BN, acc);
  if (ks != 0) return;

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 16 * i + gid + 8 * h;
        const int col = n0 + 8 * j + 2 * t;
        if (row >= M || col >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c1 = acc[0][i][j][2 * h + e] * p.scale[0];
          if constexpr (GATED) {
            const float c2 = acc[NB - 1][i][j][2 * h + e] * p.scale[1];
            const float arg = c1 * (0.797884560804236f + 0.03567740813636141f * c1 * c1);
            c1 = (c1 * (0.5f + 0.5f * tanhf(arg))) * c2;
          }
          v[e] = c1;
        }
        const size_t off = (size_t)row * N + col;
        if (p.out_bf16) {
          *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out) + off) =
              pack_bf16x2(v[0], v[1]);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) =
              make_float2(v[0], v[1]);
        }
      }
    }
  }
}

// out[m] = bf16(RMSNorm(a[m]) * (1 + w)): the GEMM prologue, f32 math,
// mean over the logical K.  One block per row.
__global__ void __launch_bounds__(256) prenorm_kernel(
    const float* a, const float* w, __nv_bfloat16* out, int K) {
  const int row = blockIdx.x;
  const float* ar = a + (size_t)row * K;
  __shared__ float red[8];
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) ss += ar[k] * ar[k];
  ss = warp_sum(ss);
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
    ss = warp_sum(ss);
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

// ---------------------------------------------------------------------------
// K3: the fused greedy head (replaces matmul.py:_top1_kernel).
//
// (token, prob) per row of softcap(scale * A . B^T) over all N columns
// without writing the [M, N] logits.  Masked columns (allowed mask 0) and
// columns past N are -inf: they leave the argmax and the sum.  Each block
// walks `tpb` consecutive 8-column tiles (mm_tile, the decode GEMM's
// 16x8 tile with 8 warps splitting K) and keeps, per row, the online
// state (max m, sum s of exp(x - m), lowest index at m); the block's
// states go to `part`, and the last block to finish (an atomic ticket)
// merges them: s = sum_i s_i * exp(m_i - M), ties to the lowest index.
// prob = 1 / max(s, 1e-30) (the winner's own term is exp(0) = 1); a row
// with no live column gives token 0 (matmul.py:1303-1331).
// need_prob = 0 skips the cap and the exp: argmax of the raw logits,
// prob 1.0 (matmul.py:1243-1253).
struct Top1Args {
  MMArgs mm;
  float cap;
  const uint8_t* mask;  // [N] 0/1, or null
  int need_prob;
  int tpb;              // 8-column tiles per block
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

constexpr int kTop1Warps = 8;  // the decode GEMM's 8-way K split, one tile

__global__ void __launch_bounds__(kTop1Warps * 32) top1_i8_kernel(Top1Args q) {
  const MMArgs& p = q.mm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * 16;
  const bool need_prob = q.need_prob != 0;
  const bool capped = need_prob && q.cap != 0.f;
  Top1State st[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) st[h] = {-INFINITY, 0.f, INT_MAX};

  for (int c = 0; c < q.tpb; ++c) {
    const int nb = (blockIdx.x * q.tpb + c) * 8;
    if (nb >= p.N) break;  // uniform over the block
    float acc[1][1][1][4];
    mm_tile<1, 1, kTop1Warps, kTop1Warps, false>(p, m0, nb, acc);
    if (warp != 0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // columns in increasing order
        const int col = nb + 2 * t + e;
        if (col >= p.N || (q.mask != nullptr && q.mask[col] == 0)) continue;
        float v = acc[0][0][0][2 * h + e] * p.scale[0];
        if (capped) v = q.cap * tanhf(v / q.cap);
        Top1State& s = st[h];
        if (v > s.m) {
          if (need_prob) s.s = s.s * expf(s.m - v) + 1.f;
          s.m = v;
          s.i = col;
        } else if (need_prob) {
          s.s += expf(v - s.m);
        }
      }
    }
  }

  __shared__ bool is_last;
  if (warp == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // The 4 lanes of a row (t = 0..3) saw interleaved columns.
      st[h] = top1_merge(st[h], top1_shfl(st[h], 1), need_prob);
      st[h] = top1_merge(st[h], top1_shfl(st[h], 2), need_prob);
      const int row = m0 + gid + 8 * h;
      if (t == 0 && row < p.M) {
        const size_t at = (size_t)row * gridDim.x + blockIdx.x;
        q.part_m[at] = st[h].m;
        q.part_s[at] = st[h].s;
        q.part_i[at] = st[h].i;
      }
    }
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(q.ticket, 1) == (int)(gridDim.x * gridDim.y) - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The last block: one warp per row merges the row's gridDim.x states.
  for (int row = warp; row < p.M; row += kTop1Warps) {
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

// Bits of an entry's `launched` report: its own kernel, then the passes.
constexpr int kLaunchedSelf = 1, kLaunchedPrenorm = 2, kLaunchedPostnorm = 4;

template <int MT, int NT, int KSPLIT, int WARPS, bool GATED>
static void launch_mm(const MMArgs& p, cudaStream_t st) {
  constexpr int BN = (WARPS / KSPLIT) * 8 * NT;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + 16 * MT - 1) / (16 * MT));
  mm_i8_kernel<MT, NT, KSPLIT, WARPS, GATED><<<grid, WARPS * 32, 0, st>>>(p);
}

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

// out = add + postnorm(scale * A . B^T), A optionally RMS-normalized first.
// y: f32 [M, N] staging for the epilogue pass (may be out when out is f32).
extern "C" int gemma_matmul_i8(const void* a, const float* norm,
                               const int8_t* codes, const float* inv,
                               const float* zp, float scale,
                               const float* post_w, const float* add,
                               __nv_bfloat16* a_scratch, float* y, void* out,
                               int M, int N, int K, int out_bf16,
                               int* launched, cudaStream_t st) {
  const bool post = post_w != nullptr || add != nullptr;
  *launched = 0;
  MMArgs p = {};
  p.a = operand_a(a, norm, a_scratch, M, K, launched, st);
  p.codes[0] = p.codes[1] = codes;
  p.inv[0] = p.inv[1] = inv;
  p.zp[0] = p.zp[1] = zp;
  p.scale[0] = p.scale[1] = scale;
  p.out = post ? static_cast<void*>(y) : out;
  p.M = M; p.N = N; p.K = K;
  p.out_bf16 = post ? 0 : out_bf16;
  if (M <= 16)
    launch_mm<1, 1, 8, 8, false>(p, st);
  else
    launch_mm<2, 4, 1, 4, false>(p, st);
  *launched |= kLaunchedSelf;
  if (post) {
    postnorm_add_kernel<<<M, 256, 0, st>>>(y, post_w, add, out, N, out_bf16);
    *launched |= kLaunchedPostnorm;
  }
  return (int)cudaGetLastError();
}

extern "C" int gemma_gated_i8(const void* a, const float* norm,
                              const int8_t* codes1, const float* inv1,
                              const float* zp1, float scale1,
                              const int8_t* codes2, const float* inv2,
                              const float* zp2, float scale2,
                              __nv_bfloat16* a_scratch, void* out, int M,
                              int N, int K, int* launched, cudaStream_t st) {
  *launched = 0;
  MMArgs p = {};
  p.a = operand_a(a, norm, a_scratch, M, K, launched, st);
  p.codes[0] = codes1; p.codes[1] = codes2;
  p.inv[0] = inv1; p.inv[1] = inv2;
  p.zp[0] = zp1; p.zp[1] = zp2;
  p.scale[0] = scale1; p.scale[1] = scale2;
  p.out = out; p.M = M; p.N = N; p.K = K; p.out_bf16 = 1;
  if (M <= 16)
    launch_mm<1, 1, 8, 8, true>(p, st);
  else
    launch_mm<2, 2, 1, 4, true>(p, st);
  *launched |= kLaunchedSelf;
  return (int)cudaGetLastError();
}

// The greedy head: (tok, prob) of softcap(scale * A . B^T), A RMS-normalized
// first when `norm` is given (then a is f32 and a_scratch bf16 [M, K]).
// part_*: [M, blocks] scratch; ticket: one int, zero between calls.  At
// most `blocks` blocks (per 16 rows) split the 8-column tiles evenly.
extern "C" int gemma_top1_i8(const void* a, const float* norm,
                             const int8_t* codes, const float* inv,
                             const float* zp, float scale, float cap,
                             const uint8_t* mask, int need_prob,
                             __nv_bfloat16* a_scratch, float* part_m,
                             float* part_s, int* part_i, int* ticket,
                             int* tok, float* prob, int M, int N, int K,
                             int blocks, int* launched, cudaStream_t st) {
  *launched = 0;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  Top1Args q = {};
  q.mm.a = operand_a(a, norm, a_scratch, M, K, launched, st);
  q.mm.codes[0] = q.mm.codes[1] = codes;
  q.mm.inv[0] = q.mm.inv[1] = inv;
  q.mm.zp[0] = q.mm.zp[1] = zp;
  q.mm.scale[0] = q.mm.scale[1] = scale;
  q.mm.M = M; q.mm.N = N; q.mm.K = K;
  q.cap = cap; q.mask = mask; q.need_prob = need_prob;
  q.part_m = part_m; q.part_s = part_s; q.part_i = part_i;
  q.ticket = ticket; q.tok = tok; q.prob = prob;
  const int tiles = (N + 7) / 8;
  const int want = min(blocks, tiles);
  q.tpb = (tiles + want - 1) / want;
  const dim3 grid((tiles + q.tpb - 1) / q.tpb, (M + 15) / 16);
  top1_i8_kernel<<<grid, kTop1Warps * 32, 0, st>>>(q);
  *launched |= kLaunchedSelf;
  return (int)cudaGetLastError();
}

// The two passes alone, for checking each against its plain version.
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
