// K13: the nuq4 gather diagnostic's GEMM for Hopper (sm_90a).
//
// Replaces scripts/proto_nuq_diag.py:kern (its pallas_call in run()), a
// standalone diagnostic that splits the nuq4 GEMM's cost into the cast,
// the unpack and the gather.  Computes, full K per output,
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
// Design: the decode tile of K1 (matmul_decode.cu's note; the warp, its
// register ring and the staging of A in gemm_common.cuh) with the one-byte
// codes as its weights and no affine groups, so that the diagnostic
// measures the tile the serving GEMMs run:
//  - the product runs transposed, C^T = B . A^T, on mma.sync m16n8k16: a
//    warp's 16 code rows, converted in registers, are the 16-row operand
//    and A^T the 8-wide one (one n-tile for M <= 8, two above);
//  - A's K slice is staged once a block in shared memory by cp.async (as
//    gemm_common.cuh:copy_stage copies it);
//  - a lane streams its rows' bytes through a register ring of 16-byte
//    non-coherent loads, one 128-byte chunk ahead (load_slot);
//  - `kw` warps share a row group's K in a block and `splits` blocks of a
//    thread-block cluster a panel's K, both chosen by the caller from the
//    shapes alone (ops/nuq_diag.py:diag_split); the warps' partial sums
//    meet in shared memory and the cluster's through distributed shared
//    memory, each in one fixed order: no float atomics, the same bits on
//    every run;
//  - D1 and D2 convert four bytes at a time by exact byte permutes; D3
//    stages its block's table rows once, for the 128-entry slices its K
//    slice reads, as bf16 in shared memory, and gathers from there.  The
//    bf16 copy is exact for this function: D3 rounds the gathered f32
//    entry to bf16 before the product, and rounding an entry before or
//    after it is gathered gives the same bits.
// Bound on an H100: bytes at M = 16 (N*K code bytes, plus N*tl*4 table
// bytes for D3), e.g. N = 9216, K = 2304: 21.2 MB -> 6.3 us (D1, D2).

#include <cooperative_groups.h>

#include "gemm_common.cuh"

namespace cg = cooperative_groups;
using namespace gemma;

constexpr int kDiagRows = 16;         // rows of A the entries take
constexpr int kDiagDepth = 2;         // chunks in a lane's register ring
constexpr int kDiagTPad = 16;         // D3 table rows' padding (entries)
constexpr int kDiagTBatch = 8;        // D3 staging: loads a thread has in flight
constexpr int kDiagMaxSplits = 8;     // the portable cluster size
constexpr int kDiagSmemMax = 200 * 1024;
constexpr int kDiagPad = 4;           // A's row padding (elements)
constexpr int kDiagChunk = 128;       // K of a chunk: 128 one-byte codes

// A block's dynamic shared memory, byte offsets: A's slice of the longest
// split (padded rows), then (split K) the block's partial products
// [M, PC], then (kw > 1) the warps' partial sums, then (D3) the table rows
// of its panel, tbl_ld bf16 entries a row: the 128-entry slices its
// chunks read (chunk c reads slice c / 16) and kDiagTPad more, so that
// consecutive rows start 8 banks apart (the script's codes of a 256-block
// lie in one 16-entry window, 8 banks of a row).  ops/nuq_diag.py:
// diag_smem.
struct DiagSmem {
  int red, wred, tbl, tbl_ld, bytes;
};

__host__ __device__ __forceinline__ DiagSmem diag_smem(int V, int M, int K,
                                                       int splits, int kw) {
  const int chunks = K / kDiagChunk, cmax = (chunks + splits - 1) / splits;
  const int pc = warp_cols<false>() * (8 / kw);
  DiagSmem L;
  L.red = (M * (cmax * kDiagChunk + kDiagPad) * 2 + 15) / 16 * 16;
  L.wred = L.red + (splits > 1 ? M * pc * 4 : 0);
  L.tbl = L.wred + (kw > 1 ? 8 * (M > 8 ? 2 : 1) * 4 * 32 * 4 : 0);
  const int slices = splits == 1 ? (chunks - 1) / 16 + 1 : (cmax - 1) / 16 + 2;
  L.tbl_ld = V == 3 ? slices * 128 + kDiagTPad : 0;
  L.bytes = L.tbl + pc * L.tbl_ld * 2;
  return L;
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

// Two table entries for bytes sh / 8 and sh / 8 + 1 of x, as bf16x2.
__device__ __forceinline__ uint32_t gather2(const uint16_t* t, uint32_t x,
                                            int sh) {
  return (uint32_t)t[(x >> sh) & 0x7f] | (uint32_t)t[(x >> (sh + 8)) & 0x7f] << 16;
}

// The fragment (k, k+1 | k+2, k+3) of the four codes in word x; t: the
// row's 128-entry table slice (D3).
template <int V>
__device__ __forceinline__ void diag_frag(uint32_t x, const uint16_t* t,
                                          uint32_t* bf) {
  if constexpr (V == 1) {
    i8x4_to_bf16x2(x, bf);
  } else if constexpr (V == 2) {
    u8x4_to_bf16x2(x, bf);
  } else {
    bf[0] = gather2(t, x, 0);
    bf[1] = gather2(t, x, 16);
  }
}

// One chunk (128 K) of a warp's product, in the order of the decode
// tile's one-byte codecs (gemm_common.cuh:consume_chunk): step st takes
// half h = st / 4, word w = st % 4, K k = 64 h + 16 t + 4 w on both
// operands.  tr[r]: fragment row r's table slice (D3).
template <int V, int NT>
__device__ __forceinline__ void diag_chunk(const Slot& s,
                                           const __nv_bfloat16* As, int SA,
                                           int kc, int M, int g, int t,
                                           const uint16_t* const (&tr)[2],
                                           float (&acc)[NT][4]) {
  const __nv_bfloat16* arow[NT];
  bool aok[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    aok[nt] = 8 * nt + g < M;
    arow[nt] = As + (size_t)(aok[nt] ? 8 * nt + g : 0) * SA + kc;
  }
#pragma unroll
  for (int st = 0; st < 8; ++st) {
    const int h = st / 4, w = st % 4, k = 64 * h + 16 * t + 4 * w;
    uint32_t f[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) diag_frag<V>(word_of(s.q[r][h], w), tr[r], f[r]);
    const uint32_t a[4] = {f[0][0], f[1][0], f[0][1], f[1][1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b[2] = {0u, 0u};
      if (aok[nt]) {
        const uint2 x = *reinterpret_cast<const uint2*>(arow[nt] + k);
        b[0] = x.x;
        b[1] = x.y;
      }
      mma_bf16_16816(acc[nt], a, b);
    }
  }
}

// D3: the panel's table rows [col0, col0 + pc), slices [s0, s0 + ns), as
// bf16 into tbl (row stride ld entries); rows past N read as zeros.  A
// thread keeps kDiagTBatch loads in flight (a loop of load-then-store
// waits one round trip an item).
__device__ __forceinline__ void stage_tables(const DecodeArgs& p, int col0,
                                             int pc, int s0, int ns,
                                             uint16_t* tbl, int ld) {
  const float* tables = static_cast<const float*>(p.aux[0]);
  const int tl = p.tstride, w = ns * 128;
  if (tl % 4 == 0 && (reinterpret_cast<uintptr_t>(tables) & 15) == 0) {
    const int w4 = w / 4, total = pc * w4;
    for (int i0 = threadIdx.x; i0 < total; i0 += kDiagTBatch * kDecodeThreads) {
      float4 x[kDiagTBatch];
#pragma unroll
      for (int u = 0; u < kDiagTBatch; ++u) {
        const int i = i0 + u * kDecodeThreads;
        const int r = i / w4, j = 4 * (i - r * w4), n = col0 + r;
        x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < total && n < p.N) x[u] = ldg4(tables + (size_t)n * tl + s0 * 128 + j);
      }
#pragma unroll
      for (int u = 0; u < kDiagTBatch; ++u) {
        const int i = i0 + u * kDecodeThreads;
        const int r = i / w4, j = 4 * (i - r * w4);
        if (i < total)
          *reinterpret_cast<uint2*>(tbl + r * ld + j) =
              make_uint2(pack_bf16x2(x[u].x, x[u].y), pack_bf16x2(x[u].z, x[u].w));
      }
    }
  } else {
    for (int i = threadIdx.x; i < pc * w; i += kDecodeThreads) {
      const int r = i / w, j = i - r * w, n = col0 + r;
      const float x = n < p.N ? __ldg(tables + (size_t)n * tl + s0 * 128 + j) : 0.f;
      tbl[r * ld + j] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
    }
  }
}

template <int V, int NT>
__device__ __forceinline__ void diag_body(const DecodeArgs& p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int M = p.M, N = p.N, K = p.K, S = p.splits, kw = p.kw;
  const int chunks = K / kDiagChunk, cmax = (chunks + S - 1) / S;
  const int c0 = (int)((long long)blockIdx.y * chunks / S);
  const int c1 = (int)((long long)(blockIdx.y + 1) * chunks / S);
  const int SA = cmax * kDiagChunk + kDiagPad;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  const DiagSmem L = diag_smem(V, M, K, S, kw);

  // This warp: row group rg, K part kp of the block's slice, chunks
  // [w0, w1).  The codes ride kSfp's ring (one byte a weight, no affine).
  const int rg = warp / kw, kp = warp % kw;
  const int PC = warp_cols<false>() * (8 / kw), col0 = blockIdx.x * PC;
  const int w0 = c0 + kp * (c1 - c0) / kw, w1 = c0 + (kp + 1) * (c1 - c0) / kw;
  const Rows rows = rows_of<kSfp, false, false>(p, col0, rg, g);
  Slot ring[kDiagDepth];
#pragma unroll
  for (int j = 0; j < kDiagDepth - 1; ++j)
    if (w0 + j < w1) load_slot<kSfp, false, false>(ring[j], rows, p, w0 + j, t);

  // A's slice by cp.async (copy_stage's copies, all in flight at once);
  // D3's tables are staged meanwhile.
  uint16_t* tbl = reinterpret_cast<uint16_t*>(smem + L.tbl);
  const int s0 = c0 / 16, n8 = (c1 - c0) * kDiagChunk / 8;
  for (int i = tid; i < M * n8; i += kDecodeThreads) {
    const int m = i / n8, j = i - m * n8;
    const __nv_bfloat16* src = p.a + (size_t)m * K + c0 * kDiagChunk + 8 * j;
    __nv_bfloat16* dst = As + (size_t)m * SA + 8 * j;
    cp_async8(dst, src);
    cp_async8(dst + 4, src + 4);
  }
  cp_async_commit();
  if constexpr (V == 3)
    stage_tables(p, col0, PC, s0, (c1 - 1) / 16 - s0 + 1, tbl, L.tbl_ld);
  cp_async_wait(0);
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const uint16_t* trow[2] = {tbl + (16 * rg + g) * L.tbl_ld,
                             tbl + (16 * rg + g + 8) * L.tbl_ld};
  for (int cb = w0; cb < w1; cb += kDiagDepth) {
#pragma unroll
    for (int j = 0; j < kDiagDepth; ++j) {
      const int c = cb + j;
      if (c < w1) {
        if (c + kDiagDepth - 1 < w1)
          load_slot<kSfp, false, false>(ring[(j + kDiagDepth - 1) % kDiagDepth],
                                        rows, p, c + kDiagDepth - 1, t);
        const int sl = (c / 16 - s0) * 128;
        const uint16_t* const tr[2] = {trow[0] + sl, trow[1] + sl};
        diag_chunk<V, NT>(ring[j], As, SA, (c - c0) * kDiagChunk, M, g, t, tr,
                          acc);
      }
    }
  }

  // The kw partial sums of a row group meet in its warp kp = 0, in order.
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
  // Lane (g, t) of a writer holds rows m = 8 nt + 2 t (+1) of weight rows
  // n0 (acc 0, 1) and n0 + 8 (acc 2, 3).
  const bool writer = kp == 0;
  float* out = static_cast<float*>(p.out);
  if (S == 1) {
    if (!writer) return;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * nt + 2 * t + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = rows.n0 + 8 * h;
          if (m < M && n < N) out[(size_t)m * N + n] = acc[nt][2 * h + e];
        }
      }
    return;
  }
  // K split over the cluster's S blocks: each leaves its partial products
  // [M, PC] in its shared memory, and block r adds the S partials of its
  // share of the panel's columns in split order.
  float* red = reinterpret_cast<float*>(smem + L.red);
  if (writer) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * nt + 2 * t + e;
        if (m >= M) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          red[m * PC + rows.n0 + 8 * h - col0] = acc[nt][2 * h + e];
      }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  const int lo = rank * PC / S, cols = (rank + 1) * PC / S - lo;
  for (int i = tid; i < M * cols; i += kDecodeThreads) {
    const int m = i / cols, cl = lo + i % cols;
    if (col0 + cl >= N) continue;
    float v = 0.f;
    for (int sp = 0; sp < S; ++sp) v += cluster.map_shared_rank(red, sp)[m * PC + cl];
    out[(size_t)m * N + col0 + cl] = v;
  }
  cluster.sync();  // every block's partials stay until their readers are done
}

// One kernel name per variant (the profiler's), NT the n-tiles of A.
// Blocks an SM as the decode tile's one-byte codecs: three at M <= 8, two
// above.
#define GEMMA_DIAG_KERNEL(NAME, V)                                          \
  template <int NT>                                                         \
  __global__ void __launch_bounds__(kDecodeThreads, NT == 2 ? 2 : 3)        \
      NAME(DecodeArgs p) {                                                  \
    diag_body<V, NT>(p);                                                    \
  }
GEMMA_DIAG_KERNEL(nuq_diag_d1_kernel, 1)
GEMMA_DIAG_KERNEL(nuq_diag_d2_kernel, 2)
GEMMA_DIAG_KERNEL(nuq_diag_d3_kernel, 3)
#undef GEMMA_DIAG_KERNEL

template <int V, int NT>
static void (*diag_kernel())(DecodeArgs) {
  if constexpr (V == 1) return nuq_diag_d1_kernel<NT>;
  else if constexpr (V == 2) return nuq_diag_d2_kernel<NT>;
  else return nuq_diag_d3_kernel<NT>;
}

template <int V, int NT>
static cudaError_t diag_launch(const DecodeArgs& p, int smem, cudaStream_t st) {
  void (*k)(DecodeArgs) = diag_kernel<V, NT>();
  // Once per kernel: allow the dynamic shared memory past 48 KB.
  static const cudaError_t attr = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, kDiagSmemMax);
  if (attr != cudaSuccess) return attr;
  const int pc = warp_cols<false>() * (8 / p.kw);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = p.splits;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + pc - 1) / pc, p.splits);
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;  // a cluster only where K is split
  return cudaLaunchKernelEx(&cfg, k, p);
}

constexpr int kDiagLaunched = 1;

// Refused: M outside [1, kDiagRows], N not a multiple of 8, K not of 128,
// kw not 1, 2, 4 or 8, splits outside [1, min(chunks, kDiagMaxSplits)], a
// block's shared memory past kDiagSmemMax, A not 16-byte aligned, and for
// D3 no tables or tables narrower than the slices K reads.
template <int V>
static int diag_entry(const void* a, const void* codes, const float* tables,
                      float* out, int M, int N, int K, int tl, int kw,
                      int splits, int* launched, cudaStream_t st) {
  *launched = 0;
  const int chunks = K / kDiagChunk;
  if (M < 1 || M > kDiagRows || N < 8 || N % 8 || K < kDiagChunk ||
      K % kDiagChunk || (kw != 1 && kw != 2 && kw != 4 && kw != 8) ||
      splits < 1 || splits > chunks || splits > kDiagMaxSplits ||
      (reinterpret_cast<uintptr_t>(a) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (V == 3 && (tables == nullptr || ((chunks - 1) / 16 + 1) * 128 > tl))
    return (int)cudaErrorInvalidValue;
  const int smem = diag_smem(V, M, K, splits, kw).bytes;
  if (smem > kDiagSmemMax) return (int)cudaErrorInvalidValue;
  DecodeArgs p = {};
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.codes[0] = codes;
  p.aux[0] = tables;
  p.tstride = tl;
  p.out = out;
  p.M = M; p.N = N; p.K = K;
  p.kw = kw;
  p.splits = splits;
  const cudaError_t e = M > 8 ? diag_launch<V, 2>(p, smem, st)
                              : diag_launch<V, 1>(p, smem, st);
  if (e != cudaSuccess) return (int)e;
  *launched = kDiagLaunched;
  return (int)cudaGetLastError();
}

// tables (and tl) are read by D3 only; kw and splits: ops/nuq_diag.py:
// diag_split.
extern "C" int gemma_nuq_diag_d1(const void* a, const void* codes,
                                 const float* tables, float* out, int M,
                                 int N, int K, int tl, int kw, int splits,
                                 int* launched, cudaStream_t st) {
  return diag_entry<1>(a, codes, tables, out, M, N, K, tl, kw, splits,
                       launched, st);
}

extern "C" int gemma_nuq_diag_d2(const void* a, const void* codes,
                                 const float* tables, float* out, int M,
                                 int N, int K, int tl, int kw, int splits,
                                 int* launched, cudaStream_t st) {
  return diag_entry<2>(a, codes, tables, out, M, N, K, tl, kw, splits,
                       launched, st);
}

extern "C" int gemma_nuq_diag_d3(const void* a, const void* codes,
                                 const float* tables, float* out, int M,
                                 int N, int K, int tl, int kw, int splits,
                                 int* launched, cudaStream_t st) {
  return diag_entry<3>(a, codes, tables, out, M, N, K, tl, kw, splits,
                       launched, st);
}
