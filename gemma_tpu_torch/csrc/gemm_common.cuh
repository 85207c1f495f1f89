// What the GEMM sources share: matmul.cu (the heads K3 and K6),
// matmul_decode.cu (K1 and K2 at M <= 16, the decode tile) and
// matmul_sm90.cu (K1 and K2 at M > 16, the prefill tile).  The weight
// codecs' element decoders (gemma_tpu/ops/matmul.py:_acc_step and
// _sfp_tile_to_bf16; the i8 byte converters are common.cuh's), the walk of
// K in 128-byte chunks that the heads and the decode tile share, the norm
// passes one C entry chains around its GEMM, and the B operand as the C
// entries receive it.
#pragma once

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
constexpr int kLaunchedMerge = 4;  // the top-k entries' second pass

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
