// Prefill attention over a KV ring for Hopper (sm_90a): K5.
//
// Replaces gemma_tpu/ops/flash_attention.py:_flash_kernel (called through
// _flash_pallas) over an i8, bf16 or f32 pool.  q is read in the caller's
// [B, T, heads, D] f32 layout through its strides, and the output is
// written f32 in the same layout: query row r = t*G + g of KV head h is
// q[b, t, h*G + g].  For every row at position qpos = base[b] + r/G, ring
// row s holds absolute position key_abs (rebuilt from newest[b]) and is
// attendable iff
//   qpos - min(window-1, qpos) <= key_abs <= max(qpos, prefix_end[b]-1),
//   key_abs >= 0 and s < ring,
// as flash_attention.py:78-91.  The compute type is f32 for an f32 pool
// and bf16 otherwise (flash_attention.py:65-69): q rounds to it.  Scores
// are q . k (times scale_k for i8 codes), soft-capped with tanhf.  One pass
// with the online softmax of the JAX kernel: running (m, l, acc) per row,
// p = exp(score - m) unnormalised, times scale_v for i8 (not in l), rounded
// to the compute type before the V product; acc / l once at the end.  A
// fully masked row gives 0, never NaN (alpha is 0 while m is -inf, p is 0
// where the mask says no).
//
// Design.  A block takes BR query rows of one (b, KV head), a warp for
// every 16 (BR = 64 for bf16 and f32 pools, 128 for i8: flash_rows), and
// walks BC = 32-row tiles of the ring in ring-row space (the
// JAX grid's s_idx), so every tile is contiguous in memory even where the
// live range wraps.  The tiles it visits are those that hold a key some row
// of the block may attend, in the order of their positions; all others are
// skipped (ops/flash_attention.py:flash_tile_plan is the same plan in
// Python, which the tests hold against the dense mask).  No row >= ring,
// garbage row or scale past it is read: such rows of a tile are zero-filled
// and masked.
//  - K and V tiles arrive by cp.async into a ring of 2 shared-memory stages,
//    the next tile in flight while the current one is multiplied.
//  - i8 and bf16 pools: QK^T and P.V on the tensor cores, mma.sync m16n8k16
//    with bf16 operands and f32 accumulation; Q, K (ldmatrix) and V
//    (ldmatrix.trans) fragments from padded shared memory, P kept in
//    registers as the A operand of the second product.  i8 tiles land as
//    codes and are converted once per tile to an exact bf16 tile (byte
//    permutes, common.cuh), which all eight warps then read.
//  - f32 pools stay f32: split TF32 on mma.sync m16n8k8, three products
//    (hi.hi + hi.lo + lo.hi, hi = tf32(x), lo = tf32(x - hi)) for both
//    products, ~2^-21 relative per product where TF32 alone leaves 2^-11
//    (1e-3 of max|out|, over the 1e-4 an f32 pool is held to).  The S
//    accumulator serves as P.V's A operand with each 8-key chunk's keys
//    permuted (A column t <-> key 2t, t+4 <-> key 2t+1; V read to match).
//  - Tiles whose every key every row of the block may attend skip the
//    per-score mask; the accumulator is rescaled only when a row's max
//    moved.
//  - Blocks run heaviest row tile first; BR = 64 gives T*G/64 row tiles
//    per (b, head): 256 blocks for Gemma2-2B's 4 x 4 heads at T = 512,
//    within the 264 slots of two 99 KB blocks an SM (bf16, D = 256); i8's
//    128 give 128 blocks of 8 warps, one an SM.
//  - No atomics: each output is summed in one order, so the same inputs
//    give the same bits.
// What bounds it on an H100: operations.  Per (b, h), 4 * rows * keys * D
// flops over the attendable pairs, ~12.9 GFLOP for Gemma2-2B's B = 4 chunk
// of 512 at position 512: 13 us at the bf16 tensor-core peak, beside one
// tanhf and one exp per score on the special-function units.

#include "common.cuh"

using namespace gemma;

constexpr int BC = 32;  // ring rows per key tile
// Query rows a block (16 a warp): 128 for i8 pools, whose tile conversion
// eight warps then share, else 64 (two blocks an SM for bf16).
template <typename T>
__host__ __device__ constexpr int flash_rows() {
  return std::is_same<T, int8_t>::value ? 128 : 64;
}
constexpr float kLog2e = 1.4426950408889634f;

struct FlashArgs {
  const float* q;       // [B, T, heads, D] through (q_bs, q_ts, q_hs), d unit
  const void* pool;     // [B, NL, 2, KVH, S_alloc, D] of the pool's type
  const float* scales;  // [B, NL, 2, KVH, 1, S_alloc] (i8 pools), else null
  const int* base;      // [B] position of the chunk's first query
  const int* newest;    // [B] newest position written this step
  const int* prefix_end;  // [B]
  float* out;           // [B, T, heads, D] contiguous
  int n_layers, layer, kvh, t, groups, s_alloc, ring, window;
  int q_bs, q_ts, q_hs;
  float att_cap;
};

// The ring tiles a row tile visits: `n1` tiles from `first`, then `n2` from
// tile 0 (the part of a wrapped live range past the ring's end); mirrors
// ops/flash_attention.py:flash_tile_plan.
struct TilePlan {
  int first, n1, n2;
  __device__ __forceinline__ int tile(int i) const { return i < n1 ? first + i : i - n1; }
};

__device__ __forceinline__ TilePlan tile_plan(int r0, int rows, int tg, int G,
                                              int base, int newest, int pe,
                                              int ring, int window) {
  const int rlast = min(r0 + rows, tg) - 1;
  const int qlo = base + r0 / G, qhi = base + rlast / G;
  const int a_lo = max(max(qlo - min(window - 1, qlo), newest - ring + 1), 0);
  const int a_hi = min(max(qhi, pe - 1), newest);
  TilePlan tp = {0, 0, 0};
  if (a_lo > a_hi) return tp;
  const int nt = (ring + BC - 1) / BC;
  const int t_lo = (a_lo % ring) / BC, t_hi = (a_hi % ring) / BC;
  tp.first = t_lo;
  if (a_lo % ring <= a_hi % ring) {
    tp.n1 = t_hi - t_lo + 1;
  } else {
    tp.n1 = nt - t_lo;
    tp.n2 = min(t_hi + 1, t_lo);
  }
  return tp;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// D += A(16x16 bf16, row) * B(16x8 bf16, col), f32 accumulate; not
// volatile (a register-only op), so the compiler may schedule it.
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo, each a TF32 value (round to nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// D += A(16x8 tf32, row) * B(8x8 tf32, col), f32 accumulate.
__device__ __forceinline__ void mma_tf32_1688(float* c, const uint32_t* a,
                                              const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The three products of split TF32, small terms first.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ahi,
                                           const uint32_t* alo,
                                           const uint32_t* bhi,
                                           const uint32_t* blo) {
  mma_tf32_1688(c, alo, bhi);
  mma_tf32_1688(c, ahi, blo);
  mma_tf32_1688(c, ahi, bhi);
}

// Shared memory of one block.  Compute-type rows are padded (bf16 by 8
// elements, f32 by 4) so that ldmatrix's and the split-TF32 loads' rows
// fall on distinct banks.
template <typename T, int D>
struct FlashSmem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  using C = typename std::conditional<kF32, float, __nv_bfloat16>::type;
  static constexpr int LD = D + (kF32 ? 4 : 8);      // compute rows
  static constexpr int LD8 = D + 16;                  // i8 staging rows
  static constexpr int NSTAGE = 2;  // stages of the cp.async ring
  static constexpr int NCT = kQuant ? 1 : NSTAGE;     // compute-type K/V tiles
  static constexpr int BR = flash_rows<T>();
  static constexpr int q_bytes = BR * LD * (int)sizeof(C);
  static constexpr int kv_bytes = 2 * NCT * BC * LD * (int)sizeof(C);
  static constexpr int stage8_bytes = kQuant ? 2 * NSTAGE * BC * LD8 : 0;
  static constexpr int scale_bytes = kQuant ? 2 * NSTAGE * BC * 4 : 0;
  static constexpr int bytes = q_bytes + kv_bytes + stage8_bytes + scale_bytes;
};

template <typename T, int D>
__device__ __forceinline__ void flash_attention_body(const FlashArgs& p) {
  using S = FlashSmem<T, D>;
  using C = typename S::C;
  constexpr bool kF32 = S::kF32, kQuant = S::kQuant;
  constexpr int LD = S::LD, LD8 = S::LD8, BR = S::BR, NSTAGE = S::NSTAGE;
  constexpr int FLASH_THREADS = 2 * BR;
  constexpr int NT = BC / 8;   // 8-key tiles of S
  constexpr int ND = D / 8;    // 8-wide d tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  C* sQ = reinterpret_cast<C*>(smem);
  C* sK = reinterpret_cast<C*>(smem + S::q_bytes);   // [NCT][BC][LD]
  C* sV = sK + S::NCT * BC * LD;                      // [NCT][BC][LD]
  int8_t* sK8 = reinterpret_cast<int8_t*>(smem + S::q_bytes + S::kv_bytes);  // [NSTAGE][BC][LD8]
  int8_t* sV8 = sK8 + NSTAGE * BC * LD8;
  float* sSc = reinterpret_cast<float*>(smem + S::q_bytes + S::kv_bytes + S::stage8_bytes);  // [NSTAGE][2][BC]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rt = gridDim.x - 1 - blockIdx.x;  // heaviest row tile first
  const int r0 = rt * BR, h = blockIdx.y, b = blockIdx.z;
  const int G = p.groups, tg = p.t * G, ring = p.ring;
  const int base = p.base[b], newest = p.newest[b], pe = p.prefix_end[b];
  const int pm = newest % ring;
  const TilePlan plan = tile_plan(r0, BR, tg, G, base, newest, pe, ring, p.window);
  const int ntiles = plan.n1 + plan.n2;

  const size_t plane = (size_t)p.s_alloc * D;
  const size_t kidx = (((size_t)b * p.n_layers + p.layer) * 2 + 0) * p.kvh + h;
  const size_t vidx = (((size_t)b * p.n_layers + p.layer) * 2 + 1) * p.kvh + h;
  const T* kpan = static_cast<const T*>(p.pool) + kidx * plane;
  const T* vpan = static_cast<const T*>(p.pool) + vidx * plane;
  const float* ksc = kQuant ? p.scales + kidx * p.s_alloc : nullptr;
  const float* vsc = kQuant ? p.scales + vidx * p.s_alloc : nullptr;

  // Tile i of the plan into stage i % NSTAGE (rows >= ring zero-filled).
  auto load_tile = [&](int i) {
    const int s0 = plan.tile(i) * BC, st = i % NSTAGE;
    if constexpr (kQuant) {
      constexpr int CPR = D / 16;  // 16-byte chunks a row
      for (int c = tid; c < BC * CPR; c += FLASH_THREADS) {
        const int r = c / CPR, k = c % CPR;
        const bool ok = s0 + r < ring;
        const size_t off = (size_t)(ok ? s0 + r : 0) * D + 16 * k;
        cp_async16(sK8 + (st * BC + r) * LD8 + 16 * k, kpan + off, ok ? 16 : 0);
        cp_async16(sV8 + (st * BC + r) * LD8 + 16 * k, vpan + off, ok ? 16 : 0);
      }
      if (tid < 2 * BC) {
        const int r = tid % BC, kv = tid / BC;
        const bool ok = s0 + r < ring;
        cp_async4(sSc + (st * 2 + kv) * BC + r, (kv ? vsc : ksc) + (ok ? s0 + r : 0),
                  ok ? 4 : 0);
      }
    } else {
      constexpr int EPC = 16 / sizeof(T);  // elements a 16-byte chunk
      constexpr int CPR = D / EPC;
      for (int c = tid; c < BC * CPR; c += FLASH_THREADS) {
        const int r = c / CPR, k = c % CPR;
        const bool ok = s0 + r < ring;
        const size_t off = (size_t)(ok ? s0 + r : 0) * D + EPC * k;
        cp_async16(sK + (st * BC + r) * LD + EPC * k, kpan + off, ok ? 16 : 0);
        cp_async16(sV + (st * BC + r) * LD + EPC * k, vpan + off, ok ? 16 : 0);
      }
    }
  };

  // Prologue: the first NSTAGE - 1 tiles in flight, then Q.
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < ntiles) load_tile(i);
    cp_async_commit();
  }
  {
    const float* qb = p.q + (size_t)b * p.q_bs;
    for (int c = tid; c < BR * D / 4; c += FLASH_THREADS) {
      const int r = c / (D / 4), k = c % (D / 4);
      const int row = r0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < tg) {
        const int ti = row / G, gi = row % G;
        v = *reinterpret_cast<const float4*>(qb + (size_t)ti * p.q_ts +
                                             (size_t)(h * G + gi) * p.q_hs + 4 * k);
      }
      if constexpr (kF32) {
        *reinterpret_cast<float4*>(sQ + r * LD + 4 * k) = v;
      } else {
        *reinterpret_cast<uint2*>(sQ + r * LD + 4 * k) =
            make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
      }
    }
  }

  // This thread's two rows (fragment rows g8 and g8 + 8 of its warp).
  int start[2], last[2];
  bool live[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = r0 + warp * 16 + g8 + 8 * u;
    live[u] = row < tg;
    const int qpos = base + (live[u] ? row : 0) / G;
    start[u] = qpos - min(p.window - 1, qpos);
    last[u] = max(qpos, pe - 1);
  }
  // A tile whose every key every row of the block attends needs no mask:
  // the block's rows all live, the latest window start at or before its
  // first position, the earliest `last` at or after its last one.
  const bool all_live = r0 + BR <= tg;
  int start_max, last_min;
  {
    const int qlo = base + r0 / G, qhi = base + (min(r0 + BR, tg) - 1) / G;
    start_max = qhi - min(p.window - 1, qhi);
    last_min = max(qlo, pe - 1);
  }
  const float cap = p.att_cap, inv_cap = cap != 0.f ? 1.f / cap : 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const C* qw = sQ + (warp * 16) * LD;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait(NSTAGE - 2);
    __syncthreads();  // tile i landed for all; tile i - 1 consumed by all
    const int st = i % NSTAGE;
    const C* tK;
    const C* tV;
    if constexpr (kQuant) {
      // The codes to an exact bf16 tile, once for all the block's warps.
      constexpr int CPR = D / 16;
      for (int c = tid; c < 2 * BC * CPR; c += FLASH_THREADS) {
        const int kv = c / (BC * CPR), r = (c / CPR) % BC, k = c % CPR;
        const uint4 w = *reinterpret_cast<const uint4*>(
            (kv ? sV8 : sK8) + (st * BC + r) * LD8 + 16 * k);
        uint32_t bf[8];
        i8x4_to_bf16x2(w.x, bf);
        i8x4_to_bf16x2(w.y, bf + 2);
        i8x4_to_bf16x2(w.z, bf + 4);
        i8x4_to_bf16x2(w.w, bf + 6);
        uint4* dst = reinterpret_cast<uint4*>((kv ? sV : sK) + r * LD + 16 * k);
        dst[0] = make_uint4(bf[0], bf[1], bf[2], bf[3]);
        dst[1] = make_uint4(bf[4], bf[5], bf[6], bf[7]);
      }
      __syncthreads();
      tK = sK;
      tV = sV;
    } else {
      tK = sK + st * BC * LD;
      tV = sV + st * BC * LD;
    }
    // The next tile's loads go out now (its stage was tile i - 1's).
    if (i + NSTAGE - 1 < ntiles) load_tile(i + NSTAGE - 1);
    cp_async_commit();

    // S = Q K^T for the warp's 16 rows x BC keys.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (kF32) {
#pragma unroll 4
      for (int ks = 0; ks < D / 8; ++ks) {
        uint32_t ah[4], al[4];
        split_tf32(qw[g8 * LD + 8 * ks + t4], ah[0], al[0]);
        split_tf32(qw[(g8 + 8) * LD + 8 * ks + t4], ah[1], al[1]);
        split_tf32(qw[g8 * LD + 8 * ks + t4 + 4], ah[2], al[2]);
        split_tf32(qw[(g8 + 8) * LD + 8 * ks + t4 + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh[2], bl[2];
          const float* kr = tK + (8 * n + g8) * LD + 8 * ks + t4;
          split_tf32(kr[0], bh[0], bl[0]);
          split_tf32(kr[4], bh[1], bl[1]);
          mma_3xtf32(s[n], ah, al, bh, bl);
        }
      }
    } else {
#pragma unroll 4
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, qw + (lane & 15) * LD + 16 * ks + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t kb[4];
          const int mi = lane >> 3;
          ldmatrix_x4(kb, tK + (8 * (n + (mi >> 1)) + (lane & 7)) * LD + 16 * ks + (mi & 1) * 8);
          mma_16816(s[n], a, kb);
          mma_16816(s[n + 1], a, kb + 2);
        }
      }
    }

    // Scale, cap, mask; the online softmax update.
    const int s0 = plan.tile(i) * BC;
    const float* tsk = sSc + (st * 2 + 0) * BC;
    const float* tsv = sSc + (st * 2 + 1) * BC;
    const int off = newest - pm;  // key_abs = s + off for s <= pm, else - ring
    bool full = all_live && s0 + BC <= ring && !(s0 <= pm && pm < s0 + BC - 1);
    if (full) {
      const int ka0 = s0 + (s0 <= pm ? off : off - ring);
      full = ka0 >= 0 && ka0 >= start_max && ka0 + BC - 1 <= last_min;
    }
    float mx[2] = {-INFINITY, -INFINITY};
    auto prep = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 8 * n + 2 * t4 + (e & 1), u = e >> 1;
          float v = s[n][e];
          if constexpr (kQuant) v *= tsk[kk];
          if (cap != 0.f) v = cap * tanhf(v * inv_cap);
          if constexpr (decltype(masked)::value) {
            const int sr = s0 + kk;
            const int ka = sr + (sr <= pm ? off : off - ring);
            const bool ok = live[u] && sr < ring && ka >= 0 && ka >= start[u] && ka <= last[u];
            v = ok ? v : -INFINITY;
          }
          s[n][e] = v;
          mx[u] = fmaxf(mx[u], v);
        }
    };
    if (full) prep(std::false_type());
    else prep(std::true_type());
    float alpha[2], mnew[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
      mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
      mnew[u] = fmaxf(m[u], mx[u]);
      alpha[u] = m[u] == -INFINITY ? 0.f : exp2f((m[u] - mnew[u]) * kLog2e);
      m[u] = mnew[u];
      l[u] *= alpha[u];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1;
        const float pr = s[n][e] == -INFINITY ? 0.f : exp2f((s[n][e] - mnew[u]) * kLog2e);
        l[u] += pr;
        float pv = pr;
        if constexpr (kQuant) pv *= tsv[8 * n + 2 * t4 + (e & 1)];
        s[n][e] = pv;  // now P (times scale_v), unrounded
      }
    // Rescale only when some row's max moved (once a row's max settles,
    // alpha is 1 for every later tile).
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // O += P V.
    if constexpr (kF32) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t ah[4], al[4];
        split_tf32(s[n][0], ah[0], al[0]);
        split_tf32(s[n][2], ah[1], al[1]);
        split_tf32(s[n][1], ah[2], al[2]);
        split_tf32(s[n][3], ah[3], al[3]);
        const float* v0 = tV + (8 * n + 2 * t4) * LD + g8;
#pragma unroll 8
        for (int dn = 0; dn < ND; ++dn) {
          uint32_t bh[2], bl[2];
          split_tf32(v0[8 * dn], bh[0], bl[0]);
          split_tf32(v0[LD + 8 * dn], bh[1], bl[1]);
          mma_3xtf32(o[dn], ah, al, bh, bl);
        }
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < BC / 16; ++kc) {
        uint32_t a[4];
        a[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
        a[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
        a[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        a[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
        const int mi = lane >> 3;
        const C* vr = tV + (16 * kc + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
        for (int dn = 0; dn < ND; dn += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vr + 8 * dn);
          mma_16816(o[dn], a, vb);
          mma_16816(o[dn + 1], a, vb + 2);
        }
      }
    }
  }
  cp_async_wait(0);

  // out = acc / l; a row with no attendable key gives 0.
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
    l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = r0 + warp * 16 + g8 + 8 * u;
    if (row >= tg) continue;
    const float inv = l[u] > 0.f ? 1.f / l[u] : 0.f;
    const int ti = row / G, gi = row % G;
    float* orow = p.out + (((size_t)b * p.t + ti) * p.kvh * G + (size_t)h * G + gi) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n + 2 * t4) =
          make_float2(o[n][2 * u] * inv, o[n][2 * u + 1] * inv);
  }
}

// One kernel name per pool type, so a profiler trace tells them apart.
template <int D>
__global__ void __launch_bounds__(2 * flash_rows<int8_t>(), 1) flash_attention_i8_kernel(FlashArgs p) {
  flash_attention_body<int8_t, D>(p);
}
template <int D>
__global__ void __launch_bounds__(2 * flash_rows<__nv_bfloat16>(), 2) flash_attention_bf16_kernel(FlashArgs p) {
  flash_attention_body<__nv_bfloat16, D>(p);
}
template <int D>
__global__ void __launch_bounds__(2 * flash_rows<float>(), 1) flash_attention_f32_kernel(FlashArgs p) {
  flash_attention_body<float, D>(p);
}

template <typename T, int D>
static int launch_flash(const FlashArgs& p, int batch, int* launched,
                        cudaStream_t st) {
  constexpr int bytes = FlashSmem<T, D>::bytes;
  void (*kernel)(FlashArgs);
  if constexpr (std::is_same<T, int8_t>::value) kernel = flash_attention_i8_kernel<D>;
  else if constexpr (std::is_same<T, __nv_bfloat16>::value) kernel = flash_attention_bf16_kernel<D>;
  else kernel = flash_attention_f32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  constexpr int BR = flash_rows<T>();
  const dim3 grid((p.t * p.groups + BR - 1) / BR, p.kvh, batch);
  kernel<<<grid, 2 * BR, bytes, st>>>(p);
  *launched = 1;
  return (int)cudaGetLastError();
}

// The wrapper passes the tile plan's geometry (flash_tile_plan's rows and
// keys a tile); any other than the kernel's is refused, as are q strides
// that break the 16-byte reads.
template <typename T>
static int dispatch_flash(const FlashArgs& p, int batch, int d, int rows,
                          int keys, int* launched, cudaStream_t st) {
  *launched = 0;
  if (rows != flash_rows<T>() || keys != BC || p.ring <= 0 || p.window <= 0 ||
      (p.q_bs | p.q_ts | p.q_hs) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(p.q) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (d == 256) return launch_flash<T, 256>(p, batch, launched, st);
  if (d == 128) return launch_flash<T, 128>(p, batch, launched, st);
  return (int)cudaErrorInvalidValue;
}

static FlashArgs flash_args(const float* q, const void* pool,
                            const float* scales, const int* base,
                            const int* newest, const int* prefix_end,
                            float* out, int n_layers, int layer, int kvh,
                            int t, int groups, int s_alloc, int ring,
                            int window, int q_bs, int q_ts, int q_hs,
                            float att_cap) {
  FlashArgs p = {};
  p.q = q; p.pool = pool; p.scales = scales; p.base = base;
  p.newest = newest; p.prefix_end = prefix_end; p.out = out;
  p.n_layers = n_layers; p.layer = layer; p.kvh = kvh; p.t = t;
  p.groups = groups; p.s_alloc = s_alloc; p.ring = ring; p.window = window;
  p.q_bs = q_bs; p.q_ts = q_ts; p.q_hs = q_hs; p.att_cap = att_cap;
  return p;
}

extern "C" int gemma_flash_attention_i8(
    const float* q, const int8_t* pool, const float* scales, const int* base,
    const int* newest, const int* prefix_end, float* out, int batch,
    int n_layers, int layer, int kvh, int t, int groups, int s_alloc, int d,
    int ring, int window, int q_bs, int q_ts, int q_hs, int rows, int keys,
    float att_cap, int* launched, cudaStream_t st) {
  const FlashArgs p = flash_args(q, pool, scales, base, newest, prefix_end,
                                 out, n_layers, layer, kvh, t, groups, s_alloc,
                                 ring, window, q_bs, q_ts, q_hs, att_cap);
  return dispatch_flash<int8_t>(p, batch, d, rows, keys, launched, st);
}

extern "C" int gemma_flash_attention_bf16(
    const float* q, const __nv_bfloat16* pool, const int* base,
    const int* newest, const int* prefix_end, float* out, int batch,
    int n_layers, int layer, int kvh, int t, int groups, int s_alloc, int d,
    int ring, int window, int q_bs, int q_ts, int q_hs, int rows, int keys,
    float att_cap, int* launched, cudaStream_t st) {
  const FlashArgs p = flash_args(q, pool, nullptr, base, newest, prefix_end,
                                 out, n_layers, layer, kvh, t, groups, s_alloc,
                                 ring, window, q_bs, q_ts, q_hs, att_cap);
  return dispatch_flash<__nv_bfloat16>(p, batch, d, rows, keys, launched, st);
}

extern "C" int gemma_flash_attention_f32(
    const float* q, const float* pool, const int* base, const int* newest,
    const int* prefix_end, float* out, int batch, int n_layers, int layer,
    int kvh, int t, int groups, int s_alloc, int d, int ring, int window,
    int q_bs, int q_ts, int q_hs, int rows, int keys, float att_cap,
    int* launched, cudaStream_t st) {
  const FlashArgs p = flash_args(q, pool, nullptr, base, newest, prefix_end,
                                 out, n_layers, layer, kvh, t, groups, s_alloc,
                                 ring, window, q_bs, q_ts, q_hs, att_cap);
  return dispatch_flash<float>(p, batch, d, rows, keys, launched, st);
}
