// The prefill GEMMs for Hopper (sm_90a): K1 and K2 at M > 16 rows, for
// every weight codec, plain or on one layer of stacked weights (K12).
//
// Replaces gemma_tpu/ops/matmul.py:_mm_kernel (K1, call :908) and
// matmul.py:_gated_kernel (K2, call :998) with _acc_step's codec branches
// (K7a, K7b) at the M of prefill (B x chunk rows), and
// matmul.py:_b_inputs_stacked (K12) feeding them.  Computes
//   C[M, N] = scale * A[M, K] . dequant(W)[N, K]^T
// (K2: bf16 gelu_tanh(C1) * C2 with matmul.py:664-665's constants), A
// bf16, products accumulated in f32, with matmul.cu's numerics: bf16 and
// sfp / nuq / nuq4 weights enter the product as the exact bf16 of their
// value, f32 rounded to bf16 (nearest even); i8 and i4 codes enter raw and
// each 128-wide group closes on the OUTPUT as the TPU kernel does:
//   i8: C += inv_g * (A_g . C_g) - (inv_g * zp_g) * sum(A_g),
//   i4: C += s_g * (A_g . C_g) + m_g * sum(A_g),
// sum(A_g) the f32 sum of the group's bf16 A.  One C entry per GEMM
// chains the norm passes of gemm_common.cuh as matmul.cu's entries do.
//
// What bounds it on an H100: operations, 2*M*N*K at 989 TFLOP/s bf16
// dense (the gated FFN at M = 2048, 2*2*2048*9216*2304 = 174 GFLOP ->
// 176 us; qkv 2*2048*4096*2304 -> 39 us); the bytes (A once, the weights
// once, C once) are a tenth of that.  Inside an SM, shared memory: a
// wgmma m64n128k16 with both operands in shared memory reads 6 KB in the
// 64 cycles the tensor cores take for it, of the 128 bytes a cycle the
// SM's shared memory serves.
//
// Design: one block per 128 x 128 output tile (K2: 128 rows x 64 columns
// of each gate), K walked in stages of 64 (128 bytes of bf16, one 128-byte
// swizzle row), a ring of stages in shared memory, two consumer
// warpgroups (warps 0-7), each the stage's wgmmas for half the tile, and
// a producer lane (warp 8) that issues the TMA loads: per stage one of the
// A tile [128, 64] (128-byte swizzle) and of the weights' bytes for the
// same K range (bf16: the B tile [128, 64], swizzled; the other codecs
// their raw bytes, 64 codes, 64 bytes of nibbles (the stage takes one
// half) or 64 f32 a row; nuq4 also the 256-block's 16 table bytes a row),
// all on one mbarrier (`loaded`), refilling a slot once both warpgroups
// released it (`empty`, after the slot's wgmmas completed).  Where the
// weights go through registers the producer's warp sits in a warpgroup of
// its own (warps 9-11 idle), which gives the consumers its registers.
// bf16 weights (`consume`): C = A . W^T as wgmma m64n128k16 (K2: two
// m64n64k16), both operands read from shared memory by descriptor
// (`tile_desc`), each warpgroup 64 rows of A; two blocks an SM.
// The other codecs (`consume_rs`): C^T = W . A^T, the weights as wgmma's
// A operand in registers, decoded from the raw bytes by the consumers
// themselves (`build_frags`: a 16-byte load, a byte permute and the
// codec's decoder of gemm_common.cuh per fragment row and 16-wide step),
// the A tile as its B operand read by descriptor: m64n128k16 over the
// tile's 128 rows of A.  The next stage's fragments are decoded while the
// stage's wgmmas run (two fragment buffers).  So no bf16 copy of the
// weights is written or read in shared memory, and the decoding runs on
// the eight consumer warps beside the tensor cores.  K2 puts gate 1's
// weight row in fragment row g and gate 2's in g + 8 of the same warp, so
// one thread holds both factors of its outputs.  i8 and i4 accumulate
// each 128-group (two stages) into a partial accumulator and fold it into
// the main one with the scales of the thread's two weight rows (plain
// loads: a row of [N, K/128] f32 is 72 bytes at K = 2304, not a multiple
// of TMA's 16; [G, N] on a stacked layer) and the group's sums of the
// tile's 128 rows of A, which the consumers take from the staged A tile
// (a thread pair a row) and share through shared memory.  (Decoding
// into a bf16 tile in shared memory by seven converter warps instead
// measured on an H100 5-9% faster for i8 and i4 but 2-33% slower for sfp,
// nuq4 and f32: one design serves them all.)
// The epilogue scales (and gates) in registers and stores straight to
// global memory, rows past M and columns past N predicated (TMA
// zero-fills their loads).  The stacked form reads the layer from the
// device and addresses it as the third coordinate of 3-D tensor maps, so
// nothing is copied per layer.  Left for later: persistent blocks over a
// tile scheduler (288 tiles of N = 2304 fill 2.2 waves of 132 SMs), a
// TMA store of C, clusters sharing the A tile.

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing linked

#include "gemm_common.cuh"

using namespace gemma;

constexpr int kBM = 128;           // rows of A per block
constexpr int kBN = 128;           // weight rows per block (K2: 64 a gate)
constexpr int kBK = 64;            // K per stage
constexpr int kTile = 128 * 128;   // bytes of a [128, 64] bf16 tile
constexpr int kConsumers = 256;    // warps 0-7
constexpr int kSmemBudget = 215 * 1024;  // of a block's 227 KB

// A stage's shared memory per codec (offsets from its 1024-aligned base):
// the A tile, then the bf16 B tile or the raw weight bytes (kRawRow a
// weight row), then nuq4's table bytes.  Past the ring: the group row
// sums of A for i8 / i4, two buffers of kBM floats.
template <int CODEC>
struct Plan {
  static constexpr bool kRegA = CODEC != kBf16;  // weights via registers
  static constexpr bool kAffine = CODEC == kI8 || CODEC == kI4;
  static constexpr bool kPacked = CODEC == kI4 || CODEC == kNuq4;
  static constexpr int kRawRow = !kRegA ? 0 : CODEC == kF32 ? 256 : 64;
  static constexpr int kTabRow = CODEC == kNuq4 ? 16 : 0;
  static constexpr int kA = 0, kB = kTile, kRaw = kTile;
  static constexpr int kTab = kRaw + kBN * kRawRow;
  static constexpr int kStage =
      ((kRegA ? kTab + kBN * kTabRow : 2 * kTile) + 1023) / 1024 * 1024;
  // bf16 runs two blocks an SM, so that one block's epilogue and pipeline
  // fill overlap the other's main loop.
  static constexpr int kBlocksPerSM = kRegA ? 1 : 2;
  // Consumers, then the producer's warp (bf16) or warpgroup (the others,
  // whose registers go to the consumers).
  static constexpr int kThreads = kConsumers + (kRegA ? 128 : 32);
  static constexpr int kStages =
      kSmemBudget / kBlocksPerSM / kStage > 6
          ? 6 : kSmemBudget / kBlocksPerSM / kStage;
  static constexpr int kRowSums = kStages * kStage;
  static constexpr int kSmem =
      kRowSums + (kAffine ? 2 * kBM * 4 : 0) + 1024;  // + alignment
  // Bytes one stage's TMA loads bring (boxes past the tensor count too).
  static constexpr uint32_t kTx =
      kTile + (kRegA ? kBN * kRawRow : kTile) + kBN * kTabRow;
  // What K must be a multiple of: i8's groups, the packed kinds' blocks,
  // a stage (bf16), 32 (f32, whose last stage TMA zero-fills).
  static constexpr int kKMultiple =
      CODEC == kI8 || CODEC == kSfp ? 128 : kPacked ? 256
      : CODEC == kBf16 ? 64 : 32;
};

struct Sm90Args {
  // i8: inverse scales and zero points; i4: scales and mins.  [N, K/128],
  // or [L, K/128, N] when `layer` is set.
  const float* inv[2];
  const float* zp[2];
  float scale[2];
  const int* layer;  // device int32: the stacked layer to read, or null
  void* out;         // [M, N], f32 or bf16
  int M, N, K;
  int out_bf16;
};

// --- the swizzled tile and its wgmma descriptor ---------------------------
// A [rows, 64] bf16 tile is K-major, one 128-byte row per tile row, in
// 1024-byte atoms of 8 rows, with the 128-byte swizzle: 16-byte chunk c of
// row r lies at chunk c ^ (r & 7) of its row (what TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes; `swz` reads it back).  The
// descriptor: start address >> 4 (bits 0-13), leading byte offset 1 (not
// read under a swizzle), stride byte offset 1024 >> 4 (the next 8-row
// atom, bits 32-45), swizzle mode 1 = 128 bytes (bits 62-63).  The k-th
// 16-wide step of the tile starts 32 bytes on: + 2 in the start field
// (the swizzle applies to the address bits, so the chunks follow).  Tile
// bases are 1024-aligned (base offset 0).
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3ffffu) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// --- mbarriers and TMA ------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

// Until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}

// One box of a 3-D tensor map at (x, y, z), innermost first, into `dst`;
// its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         uint64_t* bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(x),
      "r"(y), "r"(z)
      : "memory");
}

// --- wgmma --------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the accumulator registers to this point: reads after a
// wgmma_wait cannot be moved above it.
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both from shared memory
// (K-major, 128-byte swizzle); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both from shared memory
// (K-major, 128-byte swizzle); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A from registers (the
// warp's 16 rows in mma.sync's fragment layout: a0 row g, k 2t..2t+1; a1
// row g + 8; a2 row g, k 2t+8..2t+9; a3 row g + 8), B from shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// One 16-wide K step of the stage on a warpgroup's accumulators: K1 one
// 64 x 128 product; K2 one 64 x 64 product per gate, gate 2's weight rows
// 64 further into the B tile (8 KB: + 512 in the start field).
template <bool GATED, int NB, int NACC>
__device__ __forceinline__ void mma_step(float (&d)[NB][NACC], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (GATED) {
    wgmma_n64(d[0], da, db, scale_d);
    wgmma_n64(d[1], da, db + ((64 * 128) >> 4), scale_d);
  } else {
    wgmma_n128(d[0], da, db, scale_d);
  }
}

// --- the loads ---------------------------------------------------------------
// The block's tensor maps (kernel parameters), its tile and its layer.
struct Tma {
  const CUtensorMap* a;     // A [M, K] bf16
  const CUtensorMap* b[2];  // the weights (K2: gate 1's, gate 2's)
  const CUtensorMap* t[2];  // nuq4's tables
  int m0, n0, l;
};

// Stage i's TMA loads into slot i % S, on loaded[i % S]: the A tile, and
// the B tile's two boxes of 64 weight rows (K1's two halves, K2's gates).
template <int CODEC, bool GATED>
__device__ __forceinline__ void issue_stage(uint8_t* smem, uint64_t* loaded,
                                            const Tma& q, int i) {
  using P = Plan<CODEC>;
  const int s = i % P::kStages;
  uint8_t* st = smem + s * P::kStage;
  const int k0 = i * kBK;
  const int n1 = GATED ? q.n0 : q.n0 + 64;
  const CUtensorMap& b1 = *q.b[GATED ? 1 : 0];
  mbar_expect_tx(&loaded[s], P::kTx);
  tma_load(st + P::kA, *q.a, &loaded[s], k0, q.m0, 0);
  if constexpr (P::kRegA) {
    const int x = P::kPacked ? k0 / 256 * 128 + k0 % 128 : k0;
    tma_load(st + P::kRaw, *q.b[0], &loaded[s], x, q.n0, q.l);
    tma_load(st + P::kRaw + 64 * P::kRawRow, b1, &loaded[s], x, n1, q.l);
    if constexpr (CODEC == kNuq4) {
      tma_load(st + P::kTab, *q.t[0], &loaded[s], k0 / 256 * 16, q.n0, q.l);
      tma_load(st + P::kTab + 64 * 16, *q.t[GATED ? 1 : 0], &loaded[s],
               k0 / 256 * 16, n1, q.l);
    }
  } else {
    tma_load(st + P::kB, *q.b[0], &loaded[s], k0, q.n0, q.l);
    tma_load(st + P::kB + 64 * 128, b1, &loaded[s], k0, n1, q.l);
  }
}

// The producer (one lane): stage i into slot i % S once both consumer
// warpgroups released the slot's previous stage.
template <int CODEC, bool GATED>
__device__ __forceinline__ void produce(uint8_t* smem, uint64_t* loaded,
                                        uint64_t* empty, const Tma& q,
                                        int iters) {
  constexpr int S = Plan<CODEC>::kStages;
  for (int i = 0; i < iters; ++i) {
    if (i >= S) mbar_wait(&empty[i % S], ((i / S) & 1) ^ 1);
    issue_stage<CODEC, GATED>(smem, loaded, q, i);
  }
}

// --- the weights as wgmma's register operand --------------------------------
// The B-tile rows (weight rows) that consumer warp w (0-7 over both
// warpgroups) holds as fragment rows g and g + 8: K1 rows 16 w + g and
// 16 w + g + 8; K2 gate 1's row 8 w + g (tile row 8 w + g) and gate 2's
// same row (tile row 64 + 8 w + g).
template <bool GATED>
__device__ __forceinline__ void frag_rows(int w, int g, int& ra, int& rb) {
  if constexpr (GATED) {
    ra = 8 * w + g;
    rb = 64 + ra;
  } else {
    ra = 16 * w + g;
    rb = ra + 8;
  }
}

// Fragment rows ra and rb of a stage's raw weights -> the A fragments of
// its four 16-wide K steps (f[s]: a0 / a2 row ra, a1 / a3 row rb; a0, a1
// k 16 s + 2t, +1; a2, a3 k 16 s + 2t + 8, +9).  The four lanes of a row
// load the same 16 bytes (a broadcast) and each permutes its four out.
// nb: i4 / nuq4 take the low nibbles in the first half of a 256-block,
// the high ones in the second.
template <int CODEC>
__device__ __forceinline__ void build_frags(const uint8_t* st, int ra, int rb,
                                            int t, int nb,
                                            uint32_t (&f)[4][4]) {
  using P = Plan<CODEC>;
  const uint8_t* raw = st + P::kRaw;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? rb : ra;
    uint4 tbl = make_uint4(0, 0, 0, 0);
    if constexpr (CODEC == kNuq4)
      tbl = *reinterpret_cast<const uint4*>(st + P::kTab + row * 16);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t o[2];  // k 16 s + 2t, +1 and 16 s + 2t + 8, +9 as bf16x2
      if constexpr (CODEC == kF32) {
        const float* r = reinterpret_cast<const float*>(raw + row * 256);
        const float2 u = *reinterpret_cast<const float2*>(r + 16 * s + 2 * t);
        const float2 v =
            *reinterpret_cast<const float2*>(r + 16 * s + 2 * t + 8);
        o[0] = pack_bf16x2(u.x, u.y);
        o[1] = pack_bf16x2(v.x, v.y);
      } else {
        const uint4 q =
            *reinterpret_cast<const uint4*>(raw + row * 64 + 16 * s);
        // Bytes 2t, 2t + 1 (word t / 2) and 2t + 8, 2t + 9 (word 2 + t / 2).
        const uint32_t lo = (t & 2) ? q.y : q.x, hi = (t & 2) ? q.w : q.z;
        const uint32_t x = __byte_perm(lo, hi, (t & 1) ? 0x7632u : 0x5410u);
        if constexpr (CODEC == kI8) {
          i8x4_to_bf16x2(x, o);
        } else if constexpr (CODEC == kSfp) {
          o[0] = sfp2_to_bf16x2(__byte_perm(x, 0, 0x4140u));
          o[1] = sfp2_to_bf16x2(__byte_perm(x, 0, 0x4342u));
        } else if constexpr (CODEC == kI4) {
          i4_frag(x, nb, o);
        } else {
          // The four codes, in order, as the nibbles of a 16-bit selector.
          const uint32_t n4 = (x >> (4 * nb)) & 0x0f0f0f0fu;
          const uint32_t c2 = n4 | (n4 >> 4);
          const uint32_t r =
              nuq4_lookup4((c2 & 0xffu) | ((c2 >> 8) & 0xff00u), tbl);
          o[0] = sfp2_to_bf16x2(__byte_perm(r, 0, 0x4140u));
          o[1] = sfp2_to_bf16x2(__byte_perm(r, 0, 0x4342u));
        }
      }
      f[s][h] = o[0];
      f[s][2 + h] = o[1];
    }
  }
}

// Ties fragment registers to this point: they stay untouched until the
// wgmmas that read them have completed.
__device__ __forceinline__ void frag_fence(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f[s][e])::"memory");
}

// The f32 sum of 32 bf16 of row `row` of a staged A tile: chunks 4 hf ..
// 4 hf + 3.
__device__ __forceinline__ float row_sum32(const uint8_t* a_tile, int row,
                                           int hf) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4 q =
        *reinterpret_cast<const uint4*>(a_tile + swz(row, 4 * hf + c));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s += __uint_as_float(w[e] << 16) + __uint_as_float(w[e] & 0xffff0000u);
  }
  return s;
}

// The scale pair of weight row n's group g: i8 (inv, inv * zp), i4
// (scale, min); zeros past N.
template <int CODEC>
__device__ __forceinline__ float2 group_scales(const Sm90Args& p, int gate,
                                               int n, int l, int g) {
  if (n >= p.N) return make_float2(0.f, 0.f);
  const int G = p.K / 128;
  const size_t at = p.layer != nullptr
                        ? ((size_t)l * G + g) * p.N + n  // [L, G, N]
                        : (size_t)n * G + g;             // [N, G]
  const float a = (gate ? p.inv[1] : p.inv[0])[at];
  const float z = (gate ? p.zp[1] : p.zp[0])[at];
  return make_float2(a, CODEC == kI8 ? a * z : z);
}

template <int CODEC, bool GATED>
__device__ __forceinline__ void consume_rs(uint8_t* smem, uint64_t* loaded,
                                           uint64_t* empty, const Sm90Args& p,
                                           const Tma& q, int iters) {
  using P = Plan<CODEC>;
  constexpr int S = P::kStages;
  constexpr bool AFF = P::kAffine;
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  int ra, rb;
  frag_rows<GATED>(tid >> 5, g, ra, rb);
  // The weight rows' output columns and gates.
  const int gate_a = 0, gate_b = GATED ? 1 : 0;
  const int m0 = q.m0, l = q.l;
  const int na = q.n0 + ra, nb_col = q.n0 + (GATED ? rb - 64 : rb);
  float acc[64];  // rows ra / rb x the tile's 128 rows of A
  float part[AFF ? 64 : 1];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  uint32_t fr[2][4][4];
  // i8 / i4: the group's scale pairs of rows ra and rb; the sum over the
  // group of row tid / 2 of A (a pair of threads a row).
  float2 sa = make_float2(0.f, 0.f), sb = sa;
  float grs = 0.f;
  float* row_sums = reinterpret_cast<float*>(smem + P::kRowSums);

  // Stage i's fragments (into f), the descriptor of its A tile, and the
  // release of its slot by this warp.
  auto build = [&](int i, uint32_t (&f)[4][4]) {
    const int s = i % S;
    mbar_wait(&loaded[s], (i / S) & 1);
    build_frags<CODEC>(smem + s * P::kStage, ra, rb, t, ((i * kBK) & 255) >> 7,
                       f);
  };
  auto db_of = [&](int i) { return tile_desc(smem + (i % S) * P::kStage); };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % S]);
  };

  // Each stage's wgmmas complete before the next stage's start (i8 / i4:
  // a group's products go to `part` and fold into `acc` when it closes);
  // the next stage's fragments are decoded while they run.  (Queueing the
  // next stage's wgmmas first, where one accumulator allows it, measured
  // no faster.)
  if (iters > 0) build(0, fr[0]);
  for (int i0 = 0; i0 < iters; i0 += 2) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = i0 + b;  // for i8 / i4, b is the half of the group
      if (i >= iters) break;
      uint8_t* st = smem + (i % S) * P::kStage;
      const uint64_t db = db_of(i);
      if constexpr (AFF) {
        if (b == 0) {  // the group's scales, early
          sa = group_scales<CODEC>(p, gate_a, na, l, i >> 1);
          sb = group_scales<CODEC>(p, gate_b, nb_col, l, i >> 1);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if constexpr (AFF)  // the group's first step overwrites `part`
          wgmma_rs_n128(part, fr[b][kk], db + 2 * kk, b | kk);
        else
          wgmma_rs_n128(acc, fr[b][kk], db + 2 * kk, 1);
      }
      wgmma_commit();
      if constexpr (AFF) {
        const float r = row_sum32(st + P::kA, tid >> 1, tid & 1);
        grs += r + __shfl_xor_sync(0xffffffffu, r, 1);
      }
      if (i + 1 < iters) build(i + 1, fr[b ^ 1]);
      wgmma_wait<0>();
      frag_fence(fr[b]);
      if constexpr (!AFF) {
        reg_fence(acc);
      } else {
        reg_fence(part);
        if (b == 1) {
          // Close the group: its row sums of A through shared memory.
          float* rsum = row_sums + ((i >> 1) & 1) * kBM;
          if ((tid & 1) == 0) rsum[tid >> 1] = grs;
          grs = 0.f;
          asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float2 r2 =
                *reinterpret_cast<const float2*>(rsum + 8 * j + 2 * t);
            float* a4 = &acc[4 * j];
            const float* c4 = &part[4 * j];
            if constexpr (CODEC == kI8) {  // inv and inv * zp
              a4[0] += sa.x * c4[0] - sa.y * r2.x;
              a4[1] += sa.x * c4[1] - sa.y * r2.y;
              a4[2] += sb.x * c4[2] - sb.y * r2.x;
              a4[3] += sb.x * c4[3] - sb.y * r2.y;
            } else {  // scales and mins
              a4[0] += sa.x * c4[0] + sa.y * r2.x;
              a4[1] += sa.x * c4[1] + sa.y * r2.y;
              a4[2] += sb.x * c4[2] + sb.y * r2.x;
              a4[3] += sb.x * c4[3] + sb.y * r2.y;
            }
          }
        }
      }
      release(i);
    }
  }

  // acc[4 j + e]: row ra, A row 8 j + 2t + e; acc[4 j + 2 + e]: row rb.
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * t + e;
      if (row >= p.M) continue;
      const float c1 = acc[4 * j + e] * p.scale[0];
      if constexpr (GATED) {
        if (na >= p.N) continue;
        const float c2 = acc[4 * j + 2 + e] * p.scale[1];
        const float arg = c1 * (0.797884560804236f + 0.03567740813636141f * c1 * c1);
        static_cast<__nv_bfloat16*>(p.out)[(size_t)row * p.N + na] =
            __float2bfloat16_rn((c1 * (0.5f + 0.5f * tanhf(arg))) * c2);
      } else {
        const float c2 = acc[4 * j + 2 + e] * p.scale[0];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = h ? nb_col : na;
          if (col >= p.N) continue;
          const size_t off = (size_t)row * p.N + col;
          const float v = h ? c2 : c1;
          if (p.out_bf16)
            static_cast<__nv_bfloat16*>(p.out)[off] = __float2bfloat16_rn(v);
          else
            static_cast<float*>(p.out)[off] = v;
        }
      }
    }
  }
}

template <int CODEC, bool GATED>
__device__ __forceinline__ void consume(uint8_t* smem, uint64_t* loaded,
                                        uint64_t* empty, const Sm90Args& p,
                                        const Tma& q, int iters) {
  using P = Plan<CODEC>;
  constexpr int S = P::kStages;
  constexpr int NB = GATED ? 2 : 1;
  constexpr int NACC = GATED ? 32 : 64;  // accumulators per gate and thread
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3;
  const int wg = tid >> 7, m0 = q.m0, n0 = q.n0;
  // The thread's tile rows r0 and r0 + 8; its columns 8 j + 2 t (+ 1).
  const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  float acc[NB][NACC];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[b][e] = 0.f;

  for (int i = 0; i < iters; ++i) {
    const int s = i % S;
    uint8_t* st = smem + s * P::kStage;
    mbar_wait(&loaded[s], (i / S) & 1);
    const uint64_t da = tile_desc(st + P::kA + wg * 64 * 128);
    const uint64_t db = tile_desc(st + P::kB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      mma_step<GATED>(acc, da + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
    // The previous stage's wgmmas are done: release its slot.
    wgmma_wait<1>();
#pragma unroll
    for (int b = 0; b < NB; ++b) reg_fence(acc[b]);
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % S]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NB; ++b) reg_fence(acc[b]);

#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h;
      const int col = n0 + 8 * j + 2 * t;
      if (row >= p.M || col >= p.N) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float c1 = acc[0][4 * j + 2 * h + e] * p.scale[0];
        if constexpr (GATED) {
          const float c2 = acc[NB - 1][4 * j + 2 * h + e] * p.scale[1];
          const float arg = c1 * (0.797884560804236f + 0.03567740813636141f * c1 * c1);
          c1 = (c1 * (0.5f + 0.5f * tanhf(arg))) * c2;
        }
        v[e] = c1;
      }
      const size_t off = (size_t)row * p.N + col;
      if (p.out_bf16)
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out) + off) =
            pack_bf16x2(v[0], v[1]);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + off) =
            make_float2(v[0], v[1]);
    }
  }
}

template <int CODEC, bool GATED>
__device__ __forceinline__ void sm90_body(
    const CUtensorMap& ta, const CUtensorMap& tb0, const CUtensorMap& tb1,
    const CUtensorMap& tt0, const CUtensorMap& tt1, const Sm90Args& p) {
  using P = Plan<CODEC>;
  constexpr int S = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  // loaded: the stage's TMA bytes landed; empty: both consumer warpgroups
  // are done with it (one arrival a warp).
  __shared__ __align__(8) uint64_t bars[2 * S];
  uint64_t* loaded = bars;
  uint64_t* empty = bars + S;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int iters = (p.K + kBK - 1) / kBK;
  const Tma q = {&ta, {&tb0, &tb1}, {&tt0, &tt1}, (int)blockIdx.y * kBM,
                 (int)blockIdx.x * (GATED ? kBN / 2 : kBN),
                 p.layer != nullptr ? __ldg(p.layer) : 0};
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // One branch per role to the end, so that setmaxnreg holds: with the
  // weights in registers the producer's warpgroup gives the consumers its
  // registers (384 threads start at 168; 128 x 128 go to 2 x 128 x 64).
  if (tid < kConsumers) {
    if constexpr (P::kRegA) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
      consume_rs<CODEC, GATED>(smem, loaded, empty, p, q, iters);
    } else {
      consume<CODEC, GATED>(smem, loaded, empty, p, q, iters);
    }
  } else {
    if constexpr (P::kRegA)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) produce<CODEC, GATED>(smem, loaded, empty, q, iters);
  }
}

// The kernels by name, one per codec, so the launch counters and the
// profiler tell the kinds apart (the template argument is GATED).
#define GEMMA_SM90_KERNEL(KIND, CODEC)                                      \
  template <bool GATED>                                                     \
  __global__ void __launch_bounds__(Plan<CODEC>::kThreads,                \
                                    Plan<CODEC>::kBlocksPerSM)              \
      mm_sm90_##KIND##_kernel(                                              \
      const __grid_constant__ CUtensorMap ta,                               \
      const __grid_constant__ CUtensorMap tb0,                              \
      const __grid_constant__ CUtensorMap tb1,                              \
      const __grid_constant__ CUtensorMap tt0,                              \
      const __grid_constant__ CUtensorMap tt1, const Sm90Args p) {          \
    sm90_body<CODEC, GATED>(ta, tb0, tb1, tt0, tt1, p);                     \
  }

GEMMA_SM90_KERNEL(i8, kI8)
GEMMA_SM90_KERNEL(sfp, kSfp)
GEMMA_SM90_KERNEL(bf16, kBf16)
GEMMA_SM90_KERNEL(f32, kF32)
GEMMA_SM90_KERNEL(i4, kI4)
GEMMA_SM90_KERNEL(nuq4, kNuq4)

template <int CODEC, bool GATED>
static auto kernel_of() {
  if constexpr (CODEC == kI8) return mm_sm90_i8_kernel<GATED>;
  else if constexpr (CODEC == kSfp) return mm_sm90_sfp_kernel<GATED>;
  else if constexpr (CODEC == kBf16) return mm_sm90_bf16_kernel<GATED>;
  else if constexpr (CODEC == kF32) return mm_sm90_f32_kernel<GATED>;
  else if constexpr (CODEC == kI4) return mm_sm90_i4_kernel<GATED>;
  else return mm_sm90_nuq4_kernel<GATED>;
}

// --- host: tensor maps ---------------------------------------------------------
// cuTensorMapEncodeTiled lives in libcuda: taken through the runtime's
// entry-point query, so the library links nothing beyond the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A 3-D map of [depth, rows, cols] elements (cols innermost, rows of
// `row_bytes`), loaded in boxes of [1, box_rows, box_cols]; loads past an
// edge read zeros.  False where TMA refuses it (a base or a row stride
// not a multiple of 16 bytes).
static bool make_map(CUtensorMap* m, CUtensorMapDataType type,
                     const void* base, uint64_t cols, uint64_t rows,
                     uint64_t depth, uint64_t row_bytes, uint32_t box_cols,
                     uint32_t box_rows, bool swizzle) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr || base == nullptr ||
      reinterpret_cast<uintptr_t>(base) % 16 != 0 || row_bytes % 16 != 0)
    return false;
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * rows};
  const cuuint32_t box[3] = {box_cols, box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(m, type, 3, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weights' map: bf16 straight into the swizzled B tile, the other
// codecs' raw bytes of a stage (64 codes, 64 bytes of nibbles, 64 f32)
// unswizzled, 64 rows a box; nuq4's tables, 16 bytes of a 256-block.
template <int CODEC>
static bool weight_maps(CUtensorMap* tb, CUtensorMap* tt, const BOperand& w,
                        int N, int K, int layers) {
  const uint64_t n = N, l = layers;
  bool ok;
  if constexpr (CODEC == kBf16)
    ok = make_map(tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w.codes, K, n, l,
                  2ull * K, 64, 64, true);
  else if constexpr (CODEC == kF32)
    ok = make_map(tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w.codes, K, n, l,
                  4ull * K, 64, 64, false);
  else if constexpr (Plan<CODEC>::kPacked)
    ok = make_map(tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, w.codes, K / 2, n, l,
                  K / 2, 64, 64, false);
  else
    ok = make_map(tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, w.codes, K, n, l, K, 64,
                  64, false);
  if constexpr (CODEC == kNuq4)
    ok = ok && w.tstride == nuq4_tstride(K) &&
         make_map(tt, CU_TENSOR_MAP_DATA_TYPE_UINT8, w.inv, w.tstride, n, l,
                  w.tstride, 16, 64, false);
  return ok;
}

// out = add + postnorm(scale * A . W^T) (K1), or bf16 gelu(A . W1^T) *
// (A . W2^T) (K2), A optionally RMS-normalized first; layer: null, or the
// device layer index of stacked weights of `layers` layers (K12).
// Returns cudaErrorInvalidValue, launching nothing, on what the kernel
// does not take.
template <int CODEC, bool GATED>
static int sm90_entry(const void* a, const float* norm, const BOperand& w1,
                      const BOperand& w2, const int* layer, int layers,
                      const float* post_w, const float* add,
                      __nv_bfloat16* a_scratch, float* y, void* out, int M,
                      int N, int K, int out_bf16, int* launched,
                      cudaStream_t st) {
  using P = Plan<CODEC>;
  *launched = 0;
  const bool post = !GATED && (post_w != nullptr || add != nullptr);
  if (M < 1 || N < 8 || N % 8 || K < P::kKMultiple || K % P::kKMultiple ||
      layers < 1 || (layer == nullptr && layers != 1) ||
      (norm != nullptr && a_scratch == nullptr) || (post && y == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb0, tb1, tt0 = {}, tt1 = {};
  const void* a_bf16 = norm != nullptr ? a_scratch : a;
  if (!make_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a_bf16, K, M, 1,
                2ull * K, kBK, kBM, true) ||
      !weight_maps<CODEC>(&tb0, &tt0, w1, N, K, layers) ||
      !weight_maps<CODEC>(&tb1, &tt1, w2, N, K, layers))
    return (int)cudaErrorInvalidValue;
  const auto kern = kernel_of<CODEC, GATED>();
  static bool sized = false;  // the ring's dynamic shared memory, once
  if (!sized) {
    // setmaxnreg moves registers between warpgroups: the consumers' 232
    // exist only if the kernel starts at the 168 that 384 threads allow
    // (else they would wait for registers forever): refuse another build.
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kern);
    if (e != cudaSuccess) return (int)e;
    if (P::kRegA && attr.numRegs != 168)
      return (int)cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  operand_a(a, norm, a_scratch, M, K, launched, st);
  Sm90Args p = {};
  p.inv[0] = w1.inv; p.inv[1] = w2.inv;
  p.zp[0] = w1.zp; p.zp[1] = w2.zp;
  p.scale[0] = w1.scale; p.scale[1] = w2.scale;
  p.layer = layer;
  p.out = post ? static_cast<void*>(y) : out;
  p.M = M; p.N = N; p.K = K;
  p.out_bf16 = GATED ? 1 : post ? 0 : out_bf16;
  const int bn = GATED ? kBN / 2 : kBN;
  const dim3 grid((N + bn - 1) / bn, (M + kBM - 1) / kBM);
  kern<<<grid, P::kThreads, P::kSmem, st>>>(ta, tb0, tb1, tt0, tt1, p);
  *launched |= kLaunchedSelf;
  if (post) {
    postnorm_add_kernel<<<M, 256, 0, st>>>(y, post_w, add, out, N, out_bf16);
    *launched |= kLaunchedPostnorm;
  }
  return (int)cudaGetLastError();
}

// The C entries, one per GEMM and codec (kind "nuq" calls the sfp ones).
// The B operands as matmul.cu's entries take them; layer: null (K1 / K2),
// or a device int32 layer index into stacked weights of `layers` layers
// (K12: codes [L, N, K] ([L, N, K/2] packed), i8 / i4 group arrays
// [L, K/128, N], nuq4 tables [L, N, tstride], the pointers layer 0's).

extern "C" int gemma_matmul_sm90_i8(
    const void* a, const float* norm, const void* codes, const float* inv, const float* zp, float scale,
    const int* layer, int layers, const float* post_w, const float* add,
    __nv_bfloat16* a_scratch, float* y, void* out, int M, int N, int K,
    int out_bf16, int* launched, cudaStream_t st) {
  const BOperand w = affine_b(codes, inv, zp, scale);
  return sm90_entry<kI8, false>(a, norm, w, w, layer, layers, post_w, add,
                                   a_scratch, y, out, M, N, K, out_bf16,
                                   launched, st);
}

extern "C" int gemma_gated_sm90_i8(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer, int layers, __nv_bfloat16* a_scratch, void* out, int M,
    int N, int K, int* launched, cudaStream_t st) {
  return sm90_entry<kI8, true>(
      a, norm, affine_b(codes1, inv1, zp1, scale1),
      affine_b(codes2, inv2, zp2, scale2), layer, layers,
                                  nullptr, nullptr, a_scratch, nullptr, out,
                                  M, N, K, 1, launched, st);
}

extern "C" int gemma_matmul_sm90_sfp(
    const void* a, const float* norm, const void* codes, const float* inv, const float* zp, float scale,
    const int* layer, int layers, const float* post_w, const float* add,
    __nv_bfloat16* a_scratch, float* y, void* out, int M, int N, int K,
    int out_bf16, int* launched, cudaStream_t st) {
  const BOperand w = affine_b(codes, inv, zp, scale);
  return sm90_entry<kSfp, false>(a, norm, w, w, layer, layers, post_w, add,
                                   a_scratch, y, out, M, N, K, out_bf16,
                                   launched, st);
}

extern "C" int gemma_gated_sm90_sfp(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer, int layers, __nv_bfloat16* a_scratch, void* out, int M,
    int N, int K, int* launched, cudaStream_t st) {
  return sm90_entry<kSfp, true>(
      a, norm, affine_b(codes1, inv1, zp1, scale1),
      affine_b(codes2, inv2, zp2, scale2), layer, layers,
                                  nullptr, nullptr, a_scratch, nullptr, out,
                                  M, N, K, 1, launched, st);
}

extern "C" int gemma_matmul_sm90_bf16(
    const void* a, const float* norm, const void* codes, const float* inv, const float* zp, float scale,
    const int* layer, int layers, const float* post_w, const float* add,
    __nv_bfloat16* a_scratch, float* y, void* out, int M, int N, int K,
    int out_bf16, int* launched, cudaStream_t st) {
  const BOperand w = affine_b(codes, inv, zp, scale);
  return sm90_entry<kBf16, false>(a, norm, w, w, layer, layers, post_w, add,
                                   a_scratch, y, out, M, N, K, out_bf16,
                                   launched, st);
}

extern "C" int gemma_gated_sm90_bf16(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer, int layers, __nv_bfloat16* a_scratch, void* out, int M,
    int N, int K, int* launched, cudaStream_t st) {
  return sm90_entry<kBf16, true>(
      a, norm, affine_b(codes1, inv1, zp1, scale1),
      affine_b(codes2, inv2, zp2, scale2), layer, layers,
                                  nullptr, nullptr, a_scratch, nullptr, out,
                                  M, N, K, 1, launched, st);
}

extern "C" int gemma_matmul_sm90_f32(
    const void* a, const float* norm, const void* codes, const float* inv, const float* zp, float scale,
    const int* layer, int layers, const float* post_w, const float* add,
    __nv_bfloat16* a_scratch, float* y, void* out, int M, int N, int K,
    int out_bf16, int* launched, cudaStream_t st) {
  const BOperand w = affine_b(codes, inv, zp, scale);
  return sm90_entry<kF32, false>(a, norm, w, w, layer, layers, post_w, add,
                                   a_scratch, y, out, M, N, K, out_bf16,
                                   launched, st);
}

extern "C" int gemma_gated_sm90_f32(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer, int layers, __nv_bfloat16* a_scratch, void* out, int M,
    int N, int K, int* launched, cudaStream_t st) {
  return sm90_entry<kF32, true>(
      a, norm, affine_b(codes1, inv1, zp1, scale1),
      affine_b(codes2, inv2, zp2, scale2), layer, layers,
                                  nullptr, nullptr, a_scratch, nullptr, out,
                                  M, N, K, 1, launched, st);
}

extern "C" int gemma_matmul_sm90_i4(
    const void* a, const float* norm, const void* codes, const float* inv, const float* zp, float scale,
    const int* layer, int layers, const float* post_w, const float* add,
    __nv_bfloat16* a_scratch, float* y, void* out, int M, int N, int K,
    int out_bf16, int* launched, cudaStream_t st) {
  const BOperand w = affine_b(codes, inv, zp, scale);
  return sm90_entry<kI4, false>(a, norm, w, w, layer, layers, post_w, add,
                                   a_scratch, y, out, M, N, K, out_bf16,
                                   launched, st);
}

extern "C" int gemma_gated_sm90_i4(
    const void* a, const float* norm,
    const void* codes1, const float* inv1, const float* zp1, float scale1,
    const void* codes2, const float* inv2, const float* zp2, float scale2,
    const int* layer, int layers, __nv_bfloat16* a_scratch, void* out, int M,
    int N, int K, int* launched, cudaStream_t st) {
  return sm90_entry<kI4, true>(
      a, norm, affine_b(codes1, inv1, zp1, scale1),
      affine_b(codes2, inv2, zp2, scale2), layer, layers,
                                  nullptr, nullptr, a_scratch, nullptr, out,
                                  M, N, K, 1, launched, st);
}

extern "C" int gemma_matmul_sm90_nuq4(
    const void* a, const float* norm, const void* codes, const void* tables, int tstride, float scale,
    const int* layer, int layers, const float* post_w, const float* add,
    __nv_bfloat16* a_scratch, float* y, void* out, int M, int N, int K,
    int out_bf16, int* launched, cudaStream_t st) {
  const BOperand w = nuq4_b(codes, tables, tstride, scale);
  return sm90_entry<kNuq4, false>(a, norm, w, w, layer, layers, post_w, add,
                                   a_scratch, y, out, M, N, K, out_bf16,
                                   launched, st);
}

extern "C" int gemma_gated_sm90_nuq4(
    const void* a, const float* norm,
    const void* codes1, const void* tables1, int tstride1, float scale1,
    const void* codes2, const void* tables2, int tstride2, float scale2,
    const int* layer, int layers, __nv_bfloat16* a_scratch, void* out, int M,
    int N, int K, int* launched, cudaStream_t st) {
  return sm90_entry<kNuq4, true>(
      a, norm, nuq4_b(codes1, tables1, tstride1, scale1),
      nuq4_b(codes2, tables2, tstride2, scale2), layer, layers,
                                  nullptr, nullptr, a_scratch, nullptr, out,
                                  M, N, K, 1, launched, st);
}

