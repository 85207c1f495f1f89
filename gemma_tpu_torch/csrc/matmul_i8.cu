// i8-weight GEMMs for Hopper (sm_90a): K1 and K2 of the port.
//
// Replaces gemma_tpu/ops/matmul.py:_mm_kernel (K1, with _acc_step's i8
// branch, the _norm_a prologue and the post-norm + residual epilogue) and
// matmul.py:_gated_kernel (K2).  Computes
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
//   2*2*2048*9216*2304 = 174 GFLOP -> 176 us.
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

template <int MT, int NT, int KSPLIT, int WARPS, bool GATED>
__global__ void __launch_bounds__(WARPS * 32) mm_i8_kernel(MMArgs p) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int TILES = WARPS / KSPLIT;
  constexpr int BM = 16 * MT;
  constexpr int BN = TILES * 8 * NT;
  constexpr int FRAG = NB * MT * NT * 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int ks = warp % KSPLIT, tile = warp / KSPLIT;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN + tile * 8 * NT;
  const int M = p.M, N = p.N, K = p.K, G = K / 128;

  float acc[NB][MT][NT][4];
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
