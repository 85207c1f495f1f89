// K13: the nuq4 gather diagnostic's GEMM for Hopper (sm_90a).
//
// Replaces scripts/proto_nuq_diag.py:kern (its pallas_call in run()), a
// standalone diagnostic that splits the nuq4 GEMM's cost into the cast,
// the unpack and the gather.  Computes, full K per output tile,
//   out[M, N] f32 = A[M, K] bf16 . B[N, K]^T
// with B made from u8 codes [N, K] by the variant (template parameter V):
//   D1  bf16(int8(code)): the byte read as a signed int8 (kern's
//       astype(int8).astype(bf16));
//   D2  bf16(int32(code)): the byte zero-extended, 0..255 (astype(int32)
//       .astype(bf16));
//   D3  bf16(table[n, sub * 128 + code]) with sub = (k / 128) / 16, from
//       f32 tables [N, tl] (kern's per-128-chunk take_along_axis over a
//       128-wide table slice).  The slices are 128 wide, so D3 reads code
//       & 127: kern's callers pass codes below 128.
// Products accumulate in f32.
//
// Design: K1's decode tile (csrc/matmul.cu) cut down to one codec byte
// and no affine: mma.sync m16n8k16, one 16x8 output tile per block, its 8
// warps splitting K in 128-byte chunks, the chunk's K permuted alike on A
// and B so that each lane's 2 x 16 code bytes are contiguous; the warps'
// sums are reduced through shared memory.  D1 and D2 convert four bytes
// at a time by byte permutes (exact: at most 8 significant bits); D3
// stages the block's 8 table rows in shared memory and gathers from there.
// Bound on an H100: bytes at M = 16 (N*K code bytes, plus N*tl*4 table
// bytes for D3), e.g. N = 9216, K = 2304: 21.2 MB -> 6.3 us (D1, D2).

#include "common.cuh"

using namespace gemma;

constexpr int kDiagWarps = 8;
constexpr int kDiagMaxTl = 1536;  // 8 table rows of f32 in 48 KB

struct DiagArgs {
  const __nv_bfloat16* a;  // [M, K]
  const uint8_t* codes;    // [N, K]
  const float* tables;     // D3: [N, tl]
  float* out;              // [M, N]
  int M, N, K, tl;
};

__device__ __forceinline__ uint32_t word_at(const uint4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// Four unsigned bytes -> two packed bf16x2 words (bytes 0,1 and 2,3),
// exactly: each byte c becomes the low mantissa byte of 2^23, minus 2^23.
__device__ __forceinline__ void u8x4_to_bf16x2(uint32_t w, uint32_t* out) {
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B00u, 0x5440u + i)) - 8388608.0f;
  out[0] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
  out[1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
}

template <int V>
__device__ __forceinline__ void diag_body(const DiagArgs& p) {
  extern __shared__ float tbl[];  // D3: the block's 8 rows of tables
  __shared__ float red[kDiagWarps - 1][4][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * 8, m0 = blockIdx.y * 16;
  const int n = n0 + gid;
  if constexpr (V == 3) {
    for (int i = threadIdx.x; i < 8 * p.tl; i += blockDim.x) {
      const int r = i / p.tl;
      tbl[i] = n0 + r < p.N
          ? p.tables[(size_t)(n0 + r) * p.tl + (i - r * p.tl)] : 0.f;
    }
    __syncthreads();
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int chunks = p.K / 128;
  for (int c = warp; c < chunks; c += kDiagWarps) {
    uint4 q[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
    if (n < p.N) {
      const uint8_t* src = p.codes + (size_t)n * p.K + c * 128 + 16 * t;
      q[0] = __ldg(reinterpret_cast<const uint4*>(src));
      q[1] = __ldg(reinterpret_cast<const uint4*>(src + 64));
    }
    const float* trow = tbl + gid * p.tl + (c / 16) * 128;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int h = s / 4, w = s % 4;
      const int k = c * 128 + h * 64 + 16 * t + 4 * w;
      uint32_t af[4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + gid + 8 * hh;
        uint2 x = make_uint2(0, 0);
        if (row < p.M)
          x = *reinterpret_cast<const uint2*>(p.a + (size_t)row * p.K + k);
        af[hh] = x.x;      // k, k+1
        af[2 + hh] = x.y;  // k+2, k+3
      }
      const uint32_t word = word_at(q[h], w);
      uint32_t bf[2];
      if constexpr (V == 1) {
        i8x4_to_bf16x2(word, bf);
      } else if constexpr (V == 2) {
        u8x4_to_bf16x2(word, bf);
      } else {
        bf[0] = pack_bf16x2(trow[word & 0x7f], trow[(word >> 8) & 0x7f]);
        bf[1] = pack_bf16x2(trow[(word >> 16) & 0x7f], trow[(word >> 24) & 0x7f]);
      }
      mma_bf16_16816(acc, af, bf);
    }
  }

  if (warp > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp - 1][e][lane] = acc[e];
  }
  __syncthreads();
  if (warp != 0) return;
  for (int r = 0; r < kDiagWarps - 1; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += red[r][e][lane];
  const int col = n0 + 2 * t;  // N is a multiple of 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + gid + 8 * hh;
    if (row < p.M && col < p.N)
      *reinterpret_cast<float2*>(p.out + (size_t)row * p.N + col) =
          make_float2(acc[2 * hh], acc[2 * hh + 1]);
  }
}

__global__ void __launch_bounds__(kDiagWarps * 32) nuq_diag_d1_kernel(DiagArgs p) {
  diag_body<1>(p);
}
__global__ void __launch_bounds__(kDiagWarps * 32) nuq_diag_d2_kernel(DiagArgs p) {
  diag_body<2>(p);
}
__global__ void __launch_bounds__(kDiagWarps * 32) nuq_diag_d3_kernel(DiagArgs p) {
  diag_body<3>(p);
}

constexpr int kDiagLaunched = 1;

template <int V>
static int diag_entry(const void* a, const void* codes, const float* tables,
                      float* out, int M, int N, int K, int tl, int* launched,
                      cudaStream_t st) {
  *launched = 0;
  if (M < 1 || N % 8 || K % 128) return (int)cudaErrorInvalidValue;
  if (V == 3 && (tables == nullptr || tl > kDiagMaxTl ||
                 ((K / 128 - 1) / 16 + 1) * 128 > tl))
    return (int)cudaErrorInvalidValue;
  const DiagArgs p = {static_cast<const __nv_bfloat16*>(a),
                      static_cast<const uint8_t*>(codes), tables, out,
                      M, N, K, tl};
  const dim3 grid(N / 8, (M + 15) / 16);
  const size_t smem = V == 3 ? (size_t)8 * tl * sizeof(float) : 0;
  if constexpr (V == 1)
    nuq_diag_d1_kernel<<<grid, kDiagWarps * 32, smem, st>>>(p);
  else if constexpr (V == 2)
    nuq_diag_d2_kernel<<<grid, kDiagWarps * 32, smem, st>>>(p);
  else
    nuq_diag_d3_kernel<<<grid, kDiagWarps * 32, smem, st>>>(p);
  *launched = kDiagLaunched;
  return (int)cudaGetLastError();
}

// tables (and tl) are read by D3 only.
extern "C" int gemma_nuq_diag_d1(const void* a, const void* codes,
                                 const float* tables, float* out, int M,
                                 int N, int K, int tl, int* launched,
                                 cudaStream_t st) {
  return diag_entry<1>(a, codes, tables, out, M, N, K, tl, launched, st);
}

extern "C" int gemma_nuq_diag_d2(const void* a, const void* codes,
                                 const float* tables, float* out, int M,
                                 int N, int K, int tl, int* launched,
                                 cudaStream_t st) {
  return diag_entry<2>(a, codes, tables, out, M, N, K, tl, launched, st);
}

extern "C" int gemma_nuq_diag_d3(const void* a, const void* codes,
                                 const float* tables, float* out, int M,
                                 int N, int K, int tl, int* launched,
                                 cudaStream_t st) {
  return diag_entry<3>(a, codes, tables, out, M, N, K, tl, launched, st);
}
