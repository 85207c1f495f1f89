// Decode attention over a KV ring for Hopper (sm_90a): K4, K8, K9, K10
// and K11 of the port.
//
// Replaces, in gemma_tpu/ops/decode_attention.py:
//   K4  _decode_fused_packed_kernel (:545), over an i8 pool (through
//       _decode_fused_packed_q_pallas) and a bf16 or f32 pool
//       (_decode_fused_packed_pallas): decode_attention_<kind>_kernel;
//   K8  _decode_fused_kernel (:386; _decode_fused_pallas :949 and
//       _decode_fused_q_pallas :1081 without s_block):
//       decode_write_attend_<kind>_kernel;
//   K9  _kv_write_kernel (:61) and _kv_write_q_kernel (:104):
//       kv_write_<kind>_kernel;
//   K10 _decode_att_kernel (:212; _decode_att_pallas, _decode_att_q_pallas):
//       decode_attend_<kind>_kernel;
//   K11 _decode_fused_sblocked_kernel (:739; the s_block variants of the
//       two K8 callers): decode_sblocked_<kind>_kernel.
//
// K4, K8 and K10 share one body.  Per batch row b and KV head h:
//   1. the new K and V rows: from the fused qkv row (K4) or from the split
//      q / kv GEMMs' outputs through their strides (K8), raw f32 rows that
//      get optional (1 + w) RMSNorms of k and q, RoPE or half-RoPE (query
//      scale folded in as _pe_apply does) and become the pool's type: i8
//      codes (scale = amax/127, inv = 0 when the scale is 0, codes rounded
//      half to even) with their scale lanes, or rows rounded to bf16, or
//      as they are.  K8 also takes pre-encoded rows (pe_mode -1): q as
//      given, the rows already in the pool's type, i8 scales from `nsc`.
//      The row is written in place at ring row pos % ring, or at the
//      garbage row `ring` for an invalid slot.  K10 has no new row;
//   2. attention of the G query heads over the ring with the new row
//      substituted: scores q . k (times scale_k for i8), soft cap, window
//      mask, an exact softmax over the cluster (each kept score read once
//      more, from shared memory, for exp(s - M) / L), probabilities (times
//      scale_v for i8) rounded to the compute type before the V product.
//      The compute type is f32 for an f32 pool and bf16 otherwise
//      (decode_attention.py:487-488): q, the new row and the probabilities
//      round to it.  Output bf16 [B, H*D] (K4) or f32 [B, H, D] (K8, K10),
//      heads kv-major.
// Rows the mask rules out (outside the window, or never written yet) are
// skipped: the walk covers absolute positions
// max(pos-window+1, pos-ring+1, 0)..pos.
//
// Design (decode_attention_body below has the steps): one thread-block
// cluster per (b, h), of 8 blocks (4 above 4 KV heads), each taking a
// contiguous run of the live positions.  A block puts its K, V and scale
// loads in flight (cp.async) before it encodes the new row, reads K once
// (scores kept in shared memory between the cluster's (max, denominator)
// exchange and the V pass), 8 lanes a K row and D split across lanes for
// V.  Every block encodes the new row; rank 0 alone writes it, and the
// block whose run holds it substitutes it in shared memory (its pool row
// is never read), so no block reads a row another block is writing.
// Partial sums are added in a fixed order (lanes, warps, ranks): the same
// inputs give the same bits.
//
// K11 runs the same body with no cluster: the live positions of (b, h) are
// cut into runs whose number and length come from the ring, the window
// and the head count alone (sb_split: batch 1 at Gemma2 widths fills the
// card, ~264 blocks), one block a run; blocks past the live frontier
// return at once, so the reads follow the ring's occupancy.  A block
// keeps its rows' max m, the sum s of exp(score - m) over its rows, the
// new row's exp weight er apart, and acc = the panel rows' exp weights
// (times scale_v for i8) rounded to the compute type, times V.  The last
// block of (b, h) to take the ticket (an atomic counter it re-zeroes)
// merges the runs' partials with weights exp(m_j - M) (a run with no row
// weighs 0), its threads spread over the G*D outputs, normalizes once by
// max(s, 1e-30) and adds the new row's V times its share (times scale_v,
// rounded to the compute type).  Run 0 writes the row.  The TPU kernel's
// S block (pick_s_block) decides only whether K11 is taken.
//
// K9: from the raw f32 or bf16 rows through their strides, one warp per
// (b, k/v, h) row, four rows a block: 16-byte loads, the row encoded in
// registers (i8 by the encode K4 and K8 run, I8Row) and written to its
// ring row with its scale; nothing else of the pool moves.
//
// What bounds them on an H100: bytes.  Per call the attention kernels
// must read the live K and V rows, 2*D*sizeof(T) bytes per live row per
// (b, h) (+ 8 for i8's scales), plus q, the new rows and the output; at
// B=4, 4 KV heads, D=256 and 2054 live rows over the slots that is 4.3 MB
// (i8), 8.4 MB (bf16) or 16.8 MB (f32) -> 1.3, 2.5 or 5.0 us at 3.35 TB/s.
// At decode sizes the K4 body is bound by latency instead: the global
// loads, the new row's encode, and three cluster barriers.  K9 moves
// B*2*KVH rows in and out, 41 KB at Gemma2-2B's batch 4 with f32 rows and
// an i8 pool (~0.01 us): it is one launch's latency.  Built with
// -fmad=false so RoPE and the norms round like the plain version's
// separate multiplies and adds (the attention's own products use explicit
// fused multiply-adds).

#include <cooperative_groups.h>

#include <mutex>
#include <set>

#include "common.cuh"

using namespace gemma;

// K4's arguments: the fused qkv row per slot.
struct DecArgs {
  const float* qkv;     // [B, (heads + 2*kvh) * D]
  const float* inv_ts;  // [D/2] (rope) or [D/4] (half rope)
  const float* knorm;   // [D] or null
  const float* qnorm;   // [D] or null
  void* pool;           // [B, NL, 2, KVH, S_alloc, D] of the pool's type
  float* scales;        // [B, NL, 2, KVH, 1, S_alloc] (i8 pools), else null
  const int* pos;       // [B] position of the new token
  const bool* valid;    // [B] or null; an invalid slot writes the garbage row
  __nv_bfloat16* out;   // [B, heads*D]
  int n_layers, layer, kvh, heads, s_alloc, ring, window, pe_mode;
  float qscale, att_cap;
};

// K8's, K10's and K11's arguments: q and the new rows from the split
// GEMMs.
struct SplitArgs {
  const float* q;       // slot b's heads*D query values at q + b*q_bs
  const void* knew;     // new K row of (b, h) at knew + b*new_bs + h*new_hs,
  const void* vnew;     //   and V: f32 with pe_mode >= 0, the pool's type
                        //   with pe_mode -1; null: no new row (K10)
  const float* nsc;     // [B, 2, KVH] scales of pre-encoded i8 rows, or null
  const float* inv_ts;  // [D/2] (rope) or [D/4] (half rope), or null
  const float* knorm;   // [D] or null
  const float* qnorm;   // [D] or null
  void* pool;
  float* scales;
  const int* pos;
  const bool* valid;
  float* out;           // [B, heads, D]
  int q_bs, new_bs, new_hs;
  int n_layers, layer, kvh, heads, s_alloc, ring, window, pe_mode;
  float qscale, att_cap;
};

// The new row of (b, h) after step 1: its ring row (-1: none) and, for
// i8, its K and V scales.
struct NewRow {
  int row;
  float sk, sv;
};

template <int NW, bool MAX>
__device__ float block_reduce(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < NW; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// (1 + w) RMSNorm of x[0..D) in shared memory, in place.
template <int D, int NW>
__device__ void norm_row(float* x, const float* w, float* red) {
  const int tid = threadIdx.x;
  const float v = tid < D ? x[tid] : 0.f;
  const float ss = block_reduce<NW, false>(v * v, red);
  const float mul = 1.0f / sqrtf(ss / (float)D + 1e-6f);
  if (tid < D) {
    const float m = v * mul;
    x[tid] = m + m * w[tid];
  }
  __syncthreads();
}

// sin and cos of a RoPE angle without a call: the angle less its nearest
// multiple of pi/2 in double precision (exact to ~2^-35 for |theta| <
// 2^17, positions far past any ring), then single-precision minimax
// polynomials on [-pi/4, pi/4] (about 1 ulp, as sinf / cosf) and the
// quadrant.  sincosf would compile in its huge-argument reduction, a real
// call whose saved registers show as spills.
__device__ __forceinline__ void rope_sincos(float theta, float* sn, float* cs) {
  const double t = (double)theta;
  const double k = rint(t * 0.63661977236758134308);  // 2 / pi
  const float r = (float)fma(-k, 1.57079632679489661923, t);
  const float z = r * r;
  float sp = __fmaf_rn(z, -1.9515295891e-4f, 8.3321608736e-3f);
  sp = __fmaf_rn(z, sp, -1.6666654611e-1f);
  const float sr = __fmaf_rn(r * z, sp, r);
  float cp = __fmaf_rn(z, 2.443315711809948e-5f, -1.388731625493765e-3f);
  cp = __fmaf_rn(z, cp, 4.166664568298827e-2f);
  const float cr = __fmaf_rn(z * z, cp, __fmaf_rn(-0.5f, z, 1.0f));
  const int q = (int)((long long)k & 3);
  *sn = q == 0 ? sr : q == 1 ? cr : q == 2 ? -sr : -cr;
  *cs = q == 0 ? cr : q == 1 ? -sr : q == 2 ? -cr : sr;
}

// RoPE (mode 0) or half-RoPE (mode 1) of `nrows` rows x[r*D..] in place.
template <int D>
__device__ void rope_rows(float* x, int nrows, int pos, const float* inv_ts,
                          int mode, float mul) {
  const float posf = (float)pos;
  if (mode == 0) {
    constexpr int half = D / 2;
    for (int idx = threadIdx.x; idx < nrows * half; idx += blockDim.x) {
      float* r = x + (idx / half) * D;
      const int i = idx % half;
      const float theta = posf * inv_ts[i];
      float s, c;
      rope_sincos(theta, &s, &c);
      const float x0 = r[i] * mul, x1 = r[i + half] * mul;
      r[i] = x0 * c - x1 * s;
      r[i + half] = x0 * s + x1 * c;
    }
  } else {
    constexpr int qh = D / 4;
    for (int idx = threadIdx.x; idx < nrows * qh; idx += blockDim.x) {
      float* r = x + (idx / qh) * D;
      const int i = idx % qh;
      const float theta = posf * inv_ts[i];
      float s, c;
      rope_sincos(theta, &s, &c);
      const float x0 = r[i], x1 = r[i + qh];
      r[i] = x0 * c - x1 * s;
      r[i + qh] = x0 * s + x1 * c;
    }
    __syncthreads();
    if (mul != 1.0f)
      for (int idx = threadIdx.x; idx < nrows * D; idx += blockDim.x) x[idx] *= mul;
  }
  __syncthreads();
}



template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ int8_t from_f32<int8_t>(float x) { return (int8_t)x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// The i8 row encode of ops/kv_quant.py:quantize_rows, the one K4, K8 and
// K9 share: from the row's max |x| (a max: exact in any order),
// scale = amax / 127 and inv = 1 / scale, 0 for an all-zero row (IEEE
// division: the source builds without fast-math); a code is rint(x * inv),
// round half to even as torch.round and jnp.rint.
struct I8Row {
  float scale, inv;
  __device__ __forceinline__ explicit I8Row(float amax)
      : scale(amax / 127.0f), inv(scale > 0.f ? 1.0f / scale : 0.f) {}
  __device__ __forceinline__ float code(float x) const { return rintf(x * inv); }
};

__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// The (b, l, k/v, h) panel index of the pool, times s_alloc * D for its
// first element.
template <typename Args>
__device__ __forceinline__ size_t panel_of(const Args& p, int b, int kv, int h) {
  return (((size_t)b * p.n_layers + p.layer) * 2 + kv) * p.kvh + h;
}

// Step 1 for slot b, KV head h: q (G rows) into sq, rounded to the compute
// type; the new K and V rows into sk and sv, encoded and in the pool's
// type (i8: codes as floats), written to the pool by the `writer` block.
// Every thread of the block calls it.  K4's, from the fused qkv row:
template <typename T, int D, int G, int NW>
__device__ __forceinline__ NewRow encode_rows(const DecArgs& p, int b, int h,
                                              bool writer, float* sk,
                                              float* sv, float* sq,
                                              float* red) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  const int tid = threadIdx.x;
  const size_t row_len = (size_t)(p.heads + 2 * p.kvh) * D;
  const float* qkv = p.qkv + b * row_len;
  if (tid < D) {
    sk[tid] = qkv[(size_t)(p.heads + 2 * h) * D + tid];
    sv[tid] = qkv[(size_t)(p.heads + 2 * h + 1) * D + tid];
  }
  for (int i = tid; i < G * D; i += blockDim.x) sq[i] = qkv[(size_t)h * G * D + i];
  __syncthreads();

  const int pos = p.pos[b];
  if (p.knorm != nullptr) norm_row<D, NW>(sk, p.knorm, red);
  rope_rows<D>(sk, 1, pos, p.inv_ts, p.pe_mode, 1.0f);
  if (p.qnorm != nullptr)
    for (int g = 0; g < G; ++g) norm_row<D, NW>(sq + g * D, p.qnorm, red);
  rope_rows<D>(sq, G, pos, p.inv_ts, p.pe_mode, p.qscale);

  const size_t plane = (size_t)p.s_alloc * D;  // one (b, l, kv, h) panel
  const size_t kbase = panel_of(p, b, 0, h), vbase = panel_of(p, b, 1, h);
  T* kpan = static_cast<T*>(p.pool) + kbase * plane;
  T* vpan = static_cast<T*>(p.pool) + vbase * plane;
  const int row = (p.valid == nullptr || p.valid[b]) ? pos % p.ring : p.ring;
  float new_sk = 1.f, new_sv = 1.f;  // the new row's scales (i8)
  if constexpr (kQuant) {
    const I8Row ek(block_reduce<NW, true>(tid < D ? fabsf(sk[tid]) : 0.f, red));
    const I8Row ev(block_reduce<NW, true>(tid < D ? fabsf(sv[tid]) : 0.f, red));
    new_sk = ek.scale;
    new_sv = ev.scale;
    if (tid < D) {
      sk[tid] = ek.code(sk[tid]);
      sv[tid] = ev.code(sv[tid]);
    }
    if (writer && tid == 0) {
      p.scales[kbase * p.s_alloc + row] = new_sk;
      p.scales[vbase * p.s_alloc + row] = new_sv;
    }
  } else if (tid < D) {
    sk[tid] = cdt_round<T>(sk[tid]);  // the row in the pool's type
    sv[tid] = cdt_round<T>(sv[tid]);
  }
  if (tid < D && writer) {
    kpan[(size_t)row * D + tid] = from_f32<T>(sk[tid]);
    vpan[(size_t)row * D + tid] = from_f32<T>(sv[tid]);
  }
  for (int i = tid; i < G * D; i += blockDim.x) sq[i] = cdt_round<T>(sq[i]);
  __syncthreads();
  return {row, new_sk, new_sv};
}

// K8's, K10's and K11's, from q and the rows through their strides, or
// pre-encoded; K10 has no new row.
template <typename T, int D, int G, int NW>
__device__ __forceinline__ NewRow encode_rows(const SplitArgs& p, int b,
                                              int h, bool writer, float* sk,
                                              float* sv, float* sq,
                                              float* red) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  const int tid = threadIdx.x;
  const bool has_new = p.knew != nullptr;
  if (has_new && tid < D) {
    const size_t at = (size_t)b * p.new_bs + (size_t)h * p.new_hs + tid;
    if (p.pe_mode >= 0) {
      sk[tid] = static_cast<const float*>(p.knew)[at];
      sv[tid] = static_cast<const float*>(p.vnew)[at];
    } else {
      sk[tid] = to_f32(static_cast<const T*>(p.knew)[at]);
      sv[tid] = to_f32(static_cast<const T*>(p.vnew)[at]);
    }
  }
  const float* q = p.q + (size_t)b * p.q_bs + (size_t)h * G * D;
  for (int i = tid; i < G * D; i += blockDim.x) sq[i] = q[i];
  __syncthreads();

  const int pos = p.pos[b];
  if (p.pe_mode >= 0) {
    if (has_new) {
      if (p.knorm != nullptr) norm_row<D, NW>(sk, p.knorm, red);
      rope_rows<D>(sk, 1, pos, p.inv_ts, p.pe_mode, 1.0f);
    }
    if (p.qnorm != nullptr)
      for (int g = 0; g < G; ++g) norm_row<D, NW>(sq + g * D, p.qnorm, red);
    rope_rows<D>(sq, G, pos, p.inv_ts, p.pe_mode, p.qscale);
  }

  NewRow nr = {-1, 1.f, 1.f};
  if (has_new) {
    nr.row = (p.valid == nullptr || p.valid[b]) ? pos % p.ring : p.ring;
    const size_t kp = panel_of(p, b, 0, h), vp = panel_of(p, b, 1, h);
    if constexpr (kQuant) {
      if (p.pe_mode >= 0) {
        const I8Row ek(block_reduce<NW, true>(tid < D ? fabsf(sk[tid]) : 0.f, red));
        const I8Row ev(block_reduce<NW, true>(tid < D ? fabsf(sv[tid]) : 0.f, red));
        nr.sk = ek.scale;
        nr.sv = ev.scale;
        if (tid < D) {
          sk[tid] = ek.code(sk[tid]);
          sv[tid] = ev.code(sv[tid]);
        }
      } else {
        nr.sk = p.nsc[((size_t)b * 2 + 0) * p.kvh + h];
        nr.sv = p.nsc[((size_t)b * 2 + 1) * p.kvh + h];
      }
      if (writer && tid == 0) {
        p.scales[kp * p.s_alloc + nr.row] = nr.sk;
        p.scales[vp * p.s_alloc + nr.row] = nr.sv;
      }
    } else if (p.pe_mode >= 0 && tid < D) {
      sk[tid] = cdt_round<T>(sk[tid]);  // the row in the pool's type
      sv[tid] = cdt_round<T>(sv[tid]);
    }
    if (writer && tid < D) {
      T* pool = static_cast<T*>(p.pool);
      pool[(kp * p.s_alloc + nr.row) * D + tid] = from_f32<T>(sk[tid]);
      pool[(vp * p.s_alloc + nr.row) * D + tid] = from_f32<T>(sv[tid]);
    }
  }
  for (int i = tid; i < G * D; i += blockDim.x) sq[i] = cdt_round<T>(sq[i]);
  __syncthreads();
  return nr;
}

__device__ __forceinline__ void store_out(const DecArgs& p, size_t at, float o) {
  p.out[at] = __float2bfloat16_rn(o);
}
__device__ __forceinline__ void store_out(const SplitArgs& p, size_t at, float o) {
  p.out[at] = o;
}

// K4's body, shared by K8, K10 and K11.  The live positions p_lo..pos of
// (b, h) are cut into contiguous runs, one a block:
//  - K4 / K8 / K10: one thread-block cluster of CL blocks (dec_cluster) per
//    (b, h), rank r taking p_lo + r*n/CL up to p_lo + (r+1)*n/CL (n live
//    positions; ops/decode_attention.py:decode_row_split), so the newest
//    position, the new row, falls to the last rank;
//  - K11: nj blocks per (b, h), no cluster, block j taking p_lo + j*run up
//    to p_lo + (j+1)*run, clipped to pos (sb_split: nj and run from the
//    ring, the window and the head count alone); blocks past the live
//    frontier return at once.
// A block:
//  1. puts its rows' loads in flight before it encodes the new row: K and
//     V in chunks of DC = 32 rows, the first NS chunks of each (2 to 4,
//     up to ~100 KB) and every row's i8 scales at once, later chunks
//     through the same slots as earlier ones are used (cp.async groups).
//     The new row's ring row is zero-filled and patched from the encoded
//     row in shared memory (the in-compute substitution);
//  2. scores its rows, 8 lanes a row (4 rows a warp at a time), q in
//     registers: scale_k, soft cap; keeps them in shared memory, with its
//     max m_r and l_r = sum exp(s - m_r) (K is read once);
//  3. K4 / K8 / K10: exchanges (m_r, l_r) across the cluster: M = max
//     m_r, L = sum over ranks in order of l_r exp(m_r - M); turns each
//     kept score into the probability exp(s - M) * (1 / L) (times
//     scale_v), rounded to the compute type.  K11: turns each into its
//     exp weight against the block's own max, exp(s - m_r) (times
//     scale_v), rounded to the compute type; the new row's weight is kept
//     apart (er) and its V left out;
//  4. multiplies V by the probabilities, lanes splitting D; lanes, warps
//     and then ranks add their partial sums in order.  K11 writes its
//     partial (m_r, l_r, er, acc[G][D]) instead; the last block of (b, h)
//     to take the ticket merges them (sb_merge).
constexpr int DC = 32;          // rows a chunk
constexpr int DEC_WARPS = 8;
constexpr int DEC_MAXR = 2048;  // rows a block: rings up to cluster * 2048

// Blocks a cluster (one per (b, h)): 8 up to 4 KV heads (Gemma2-2B), else
// 4 (9B's 8, 27B's 16), so that B = 4 runs in one wave: 32 clusters of 8
// did not all find room at once (9B: 0.0301 ms against 0.0230 with 4).
// From the head count alone, never the batch: a slot's sums are taken in
// the same order at every batch size.  ops/decode_attention.py:
// decode_cluster.
__host__ __device__ constexpr int dec_cluster(int kvh) { return kvh <= 4 ? 8 : 4; }

// K11's split (ops/decode_attention.py:sblock_split): runs of `run` rows,
// a multiple of DC and at least SB_MIN_RUN, as short as lets batch 1 fill
// SB_TARGET blocks (two an SM on an H100's 132) over the longest live
// span min(ring, window); nj runs cover that span.  Runs of 64 rows were
// slower than runs of 128 at batch 4 (each block's fixed costs: the
// encode, the ticket), so no run is shorter than 128.
constexpr int SB_TARGET = 264;
constexpr int SB_MIN_RUN = 128;
constexpr int SB_MAXR = 2048;      // the longest run the entries take
constexpr int SB_MAX_RUNS = 512;   // the most runs, whose weights sb_merge keeps
__host__ __device__ inline void sb_split(int ring, int window, int kvh,
                                         int* nj, int* run) {
  const int live = ring < window ? ring : window;
  const int per = (SB_TARGET + kvh - 1) / kvh;
  int r = ((live + per - 1) / per + DC - 1) / DC * DC;
  r = r > SB_MIN_RUN ? r : SB_MIN_RUN;
  *run = r;
  *nj = (live + r - 1) / r;
}

// K11's arguments: K8's, the runs' partials and the arrival tickets.
struct SblockArgs {
  SplitArgs d;
  float* part;   // [B, KVH, nj, G, D + 4]: m, s, er, a pad, then acc[D]
  int* ticket;   // [B * KVH], zero between launches
  int nj, run;   // sb_split's
};

// Rows whose scores a block keeps, reserved beside the chunk slots when NS
// is chosen: K4 / K8 / K10 up to 1024 (rings of 8192 over clusters of 8),
// K11 its run (SB_TARGET keeps Gemma2's runs at 512 rows or fewer); and
// the most chunk slots of K (and of V): K11's runs are up to 512 rows
// long, and more slots keep more of a run in flight where rows are small.
constexpr int DEC_RESERVE = 1024, DEC_NSMAX = 4;
constexpr int SB_RESERVE = 512, SB_NSMAX = 8;

template <typename T, int D, int G, int RESERVE, int NSMAX>
struct DecSmem {
  static constexpr int RB = D * (int)sizeof(T);     // bytes a row
  static constexpr int NP = RB / 16;                // 16-byte pieces a row
  static constexpr int EPP = 16 / (int)sizeof(T);   // elements a piece
  static constexpr int CB = DC * RB;                // bytes a chunk
  // Per kept row: G scores (i8: and the K and V scales).
  static constexpr int per_row = G * 4 + (std::is_same<T, int8_t>::value ? 8 : 0);
  // Chunk slots of K and of V: 2 to NSMAX each, as many as keep the block
  // within ~100 KB beside the scores of RESERVE rows (two blocks an SM, so
  // clusters always find room); f32 rows at D = 256 take 2 slots and one
  // block an SM.
  static constexpr int fit = (100 * 1024 - RESERVE * per_row) / (2 * CB);
  static constexpr int NS = fit < 2 ? 2 : fit > NSMAX ? NSMAX : fit;
  static constexpr int ring = NS * CB;
  static constexpr int acc = DEC_WARPS * G * D * 4;
  static constexpr int kring_or_acc = ring > acc ? ring : acc;
  // Dynamic shared memory for `maxr` kept rows.
  static constexpr int bytes(int maxr) { return kring_or_acc + ring + maxr * per_row; }
};

// A 16-byte piece of a pool row -> its 16 / sizeof(T) elements as exact
// floats (i8 codes by byte permutes, bf16 by shifts).
template <typename T>
__device__ __forceinline__ void piece_f32(const uint4& w, float* f) {
  if constexpr (std::is_same<T, int8_t>::value) {
    i8x4_to_f32(w.x, f);
    i8x4_to_f32(w.y, f + 4);
    i8x4_to_f32(w.z, f + 8);
    i8x4_to_f32(w.w, f + 12);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(x[i] << 16);
      f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
    }
  } else {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
}

// Whether the entry brings a new row (K10 has none).
__device__ __forceinline__ bool brings_row(const DecArgs&) { return true; }
__device__ __forceinline__ bool brings_row(const SplitArgs& p) { return p.knew != nullptr; }

// K11's merge, by the last block of (b, h) to finish: the nl live runs'
// partials at `all` ([nl][G][D + 4]).  Warp g takes query head g's run
// weights w_j = exp(m_j - M) (0 for a run with no row) into wts[g][j] and
// its sums S = sum s_j w_j and ER = sum er_j w_j (lane l runs j = l, l +
// 32, ..., then the butterfly); then the block's threads take the G*D
// outputs, each summing acc_j w_j over j in order, and add the new row's
// V times its share ER / S (times scale_v, rounded to the compute type):
// out = O / max(S, 1e-30) + cdt(ER / max(S, 1e-30)) * V_new.
template <typename T, int D, int G>
__device__ __forceinline__ void sb_merge(const SplitArgs& p, const float* all,
                                         int nl, int b, int h,
                                         const float* nv, float new_sv,
                                         float* wts) {
  constexpr int NW = DEC_WARPS;
  constexpr int RS = G * (D + 4);  // floats a run
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int PL = SB_MAX_RUNS / 32;  // runs a lane holds
  __shared__ float den[G], share[G];
  for (int g = warp; g < G; g += NW) {
    // Every (m, s, er) of the lane's runs in flight at once.
    float mj[PL], sj[PL], ej[PL];
#pragma unroll
    for (int u = 0; u < PL; ++u) {
      const int j = lane + 32 * u;
      const float* pj = all + (size_t)j * RS + g * (D + 4);
      mj[u] = j < nl ? __ldcg(pj) : -INFINITY;
      sj[u] = j < nl ? __ldcg(pj + 1) : 0.f;
      ej[u] = j < nl ? __ldcg(pj + 2) : 0.f;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < PL; ++u) mx = fmaxf(mx, mj[u]);
    mx = warp_max(mx);
    float s = 0.f, r = 0.f;
#pragma unroll
    for (int u = 0; u < PL; ++u) {
      const int j = lane + 32 * u;
      const float w = mj[u] == -INFINITY ? 0.f : expf(mj[u] - mx);
      if (j < nl) wts[g * nl + j] = w;
      s += sj[u] * w;
      r += ej[u] * w;
    }
    s = warp_sum(s);
    r = warp_sum(r);
    if (lane == 0) {
      den[g] = fmaxf(s, 1e-30f);
      share[g] = r;
    }
  }
  __syncthreads();
  for (int x = tid; x < G * D; x += NW * 32) {
    const int g = x / D, d = x - g * D;
    const float* pg = all + g * (D + 4) + 4 + d;
    const float* wg = wts + g * nl;
    float o = 0.f;
    // 32 runs' loads in flight at a time, summed in run order.
    for (int j0 = 0; j0 < nl; j0 += 32) {
      float v[32];
#pragma unroll
      for (int u = 0; u < 32; ++u)
        v[u] = j0 + u < nl ? __ldcg(pg + (size_t)(j0 + u) * RS) : 0.f;
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (j0 + u < nl) o += v[u] * wg[j0 + u];
    }
    float pr = share[g] / den[g];
    if constexpr (std::is_same<T, int8_t>::value) pr *= new_sv;
    p.out[(size_t)b * p.heads * D + (size_t)(h * G + g) * D + d] =
        o / den[g] + cdt_round<T>(pr) * nv[d];
  }
}

template <typename T, int D, int G, bool SB, typename Args>
__device__ __forceinline__ void decode_attention_body(const Args& p,
                                                      const SblockArgs* sa) {
  namespace cg = cooperative_groups;
  using S = DecSmem<T, D, G, SB ? SB_RESERVE : DEC_RESERVE,
                        SB ? SB_NSMAX : DEC_NSMAX>;
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  constexpr int NW = DEC_WARPS, NP = S::NP, EPP = S::EPP, NS = S::NS;
  constexpr int PPL = NP / 8;                     // scoring: pieces a lane
  constexpr int LPRB = NP < 32 ? NP : 32;         // values: lanes a row
  constexpr int RPIB = 32 / LPRB, PPLB = NP / LPRB;
  cg::cluster_group cluster = cg::this_cluster();
  // K11's grid is run-major (block = run * B * KVH + (b, h)), so every
  // pair's first runs, the live ones, are scheduled before the runs past
  // the frontiers, which return at once.
  const int CL = SB ? sa->nj : (int)cluster.dim_blocks().x;
  const int nbh = gridDim.x / CL;
  const int rank = SB ? (int)blockIdx.x / nbh : (int)cluster.block_rank();
  const int bh = SB ? (int)blockIdx.x % nbh : (int)blockIdx.x / CL;
  const int b = bh / p.kvh, h = bh % p.kvh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // This block's run of live positions.
  const int pos = p.pos[b];
  const int p_lo = max(max(pos - p.window + 1, pos - p.ring + 1), 0);
  const int n = pos - p_lo + 1;
  int first, nr, maxr;
  if constexpr (SB) {
    maxr = sa->run;
    first = p_lo + rank * sa->run;
    nr = min(sa->run, n - rank * sa->run);
    if (nr <= 0) return;  // past the live frontier: nothing to read
  } else {
    maxr = (p.ring + CL - 1) / CL;
    first = p_lo + (rank * n) / CL;
    nr = p_lo + ((rank + 1) * n) / CL - first;
  }
  extern __shared__ __align__(16) unsigned char dsm[];
  unsigned char* sK = dsm;                              // [NS][DC][RB]
  float* acc_s = reinterpret_cast<float*>(dsm);         // [NW][G][D], after scoring
  unsigned char* sV = dsm + S::kring_or_acc;            // [NS][DC][RB]
  float* sc = reinterpret_cast<float*>(sV + S::ring);   // [maxr][G]
  float* sSk = sc + maxr * G;                           // [maxr] (i8)
  float* sSv = sSk + maxr;
  __shared__ float sk[D], sv[D], sq[G * D];
  __shared__ float red[NW * G];
  __shared__ float cm[G], cl[G];  // this block's max and denominator
  __shared__ float cer[G];        // K11: the new row's exp weight
  __shared__ float part[SB ? 1 : G * D];  // this block's share of the output

  const int nch = (nr + DC - 1) / DC;
  const int s_first = first % p.ring;  // ring row of the run's first position
  // The new row (pos % ring, or the garbage row for an invalid slot) and
  // its index in this block's run, if there.
  const int row = brings_row(p) ? ((p.valid == nullptr || p.valid[b]) ? pos % p.ring : p.ring) : -1;
  const int newi = (row == pos % p.ring && pos >= first && pos < first + nr) ? pos - first : -1;

  const size_t plane = (size_t)p.s_alloc * D;
  const size_t kbase = panel_of(p, b, 0, h), vbase = panel_of(p, b, 1, h);
  const unsigned char* kpan = reinterpret_cast<const unsigned char*>(static_cast<const T*>(p.pool) + kbase * plane);
  const unsigned char* vpan = reinterpret_cast<const unsigned char*>(static_cast<const T*>(p.pool) + vbase * plane);
  const float* ksc = kQuant ? p.scales + kbase * p.s_alloc : nullptr;
  const float* vsc = kQuant ? p.scales + vbase * p.s_alloc : nullptr;
  auto ring_row = [&](int i) {  // i < nr <= ring
    const int s = s_first + i;
    return s >= p.ring ? s - p.ring : s;
  };

  // Chunk c of K or V into slot c % NS: DC rows of NP pieces; rows past
  // the run and the new row zero-filled.  Groups are committed in order;
  // `group` counts them, kgrp / vgrp say which holds chunk c.
  auto load_chunk = [&](const unsigned char* pan, unsigned char* ring, int c) {
    unsigned char* slot = ring + (c % NS) * S::CB;
    for (int e = tid; e < DC * NP; e += NW * 32) {
      const int r = e / NP, k = e % NP, i = c * DC + r;
      const bool ok = i < nr && i != newi;
      cp_async16(slot + r * S::RB + 16 * k, pan + (size_t)(ok ? ring_row(i) : 0) * S::RB + 16 * k,
                 ok ? 16 : 0);
    }
  };
  int group = 0;
  const int pre = nch < NS ? nch : NS;  // chunks whose K and V go out first
  auto kgrp = [&](int c) { return c < NS ? c : pre + (c - NS); };
  auto vgrp = [&](int c, int kgroups) { return c < NS ? c : kgroups + (c - NS); };
  if constexpr (kQuant) {
    for (int i = tid; i < nr; i += NW * 32) {
      const bool ok = i != newi;
      const int s = ok ? ring_row(i) : 0;
      cp_async4(sSk + i, ksc + s, ok ? 4 : 0);
      cp_async4(sSv + i, vsc + s, ok ? 4 : 0);
    }
  }
  for (int c = 0; c < pre; ++c) {
    load_chunk(kpan, sK, c);
    load_chunk(vpan, sV, c);
    cp_async_commit();
    ++group;
  }

  // Every block encodes the new row (cheap: D values); rank 0 (K11: run
  // 0) writes it to the pool.
  const NewRow nr_ = encode_rows<T, D, G, NW>(p, b, h, rank == 0, sk, sv, sq, red);
  // One reciprocal each, multiplied in the loops: a division there compiles
  // a call to its slow path, and registers saved around such calls spill.
  const float cap = p.att_cap, inv_cap = cap != 0.f ? 1.f / cap : 0.f;

  // --- scores: 8 lanes a row, lane j holds pieces j, j+8, ... of q ---
  const int j8 = lane & 7, rg = lane >> 3;
  float qf[G][PPL * EPP];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < PPL; ++k)
#pragma unroll
      for (int e = 0; e < EPP; ++e) qf[g][k * EPP + e] = sq[g * D + (k * 8 + j8) * EPP + e];
  float m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = -INFINITY;
  for (int c = 0; c < nch; ++c) {
    if (c >= 1 && c + NS - 1 < nch) {  // K of a chunk past the first NS
      load_chunk(kpan, sK, c + NS - 1);
      cp_async_commit();
      ++group;
    }
    cp_async_wait(group - kgrp(c) - 1);
    __syncthreads();
    unsigned char* slot = sK + (c % NS) * S::CB;
    if constexpr (kQuant) {
      if (c == 0 && newi >= 0 && tid == 0) {
        sSk[newi] = nr_.sk;
        sSv[newi] = nr_.sv;
      }
    }
    if (newi >= c * DC && newi < (c + 1) * DC) {
      for (int d = tid; d < D; d += NW * 32)
        reinterpret_cast<T*>(slot + (newi - c * DC) * S::RB)[d] = from_f32<T>(sk[d]);
      __syncthreads();
    }
    // Every lane takes part in its row group's shuffles; rows past the run
    // (zero-filled) are dropped after them.
    const int r = warp * 4 + rg, i = c * DC + r;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      float f[EPP];
      piece_f32<T>(*reinterpret_cast<const uint4*>(slot + r * S::RB + 16 * (k * 8 + j8)), f);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < EPP; ++e) acc[g] = __fmaf_rn(qf[g][k * EPP + e], f[e], acc[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v = acc[g];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if (i < nr) {
        if constexpr (kQuant) v *= sSk[i];
        if (cap != 0.f) v = cap * tanhf(v * inv_cap);
        if (j8 == 0) sc[i * G + g] = v;
        m[g] = fmaxf(m[g], v);
      }
    }
    if (c + NS < nch) __syncthreads();  // slot c % NS is refilled next
  }
  const int kgroups = group;

  // The block's max, then its denominator sum exp(s - max) over the kept
  // scores: one barrier each (G values a reduction).
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float wmx = warp_max(m[g]);
    if (lane == 0) red[warp * G + g] = wmx;
  }
  __syncthreads();
  // K11 runs of NS + 1 to 2 NS chunks: the V chunks past the first NS go
  // out now, into the K slots the scores are done with, instead of each
  // waiting for a V slot during the V pass.
  const bool early = SB && nch > NS && nch <= 2 * NS;
  if (early) {
    for (int c = NS; c < nch; ++c) {
      load_chunk(vpan, sK, c);
      cp_async_commit();
      ++group;
    }
  }
  float mb[G], e[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mb[g] = red[g];
    for (int w = 1; w < NW; ++w) mb[g] = fmaxf(mb[g], red[w * G + g]);
    e[g] = 0.f;
  }
  for (int i = tid; i < nr; i += NW * 32)
#pragma unroll
    for (int g = 0; g < G; ++g) e[g] += expf(sc[i * G + g] - mb[g]);
  __syncthreads();  // red read by all before it is reused
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float ws = warp_sum(e[g]);
    if (lane == 0) red[warp * G + g] = ws;
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float tot = 0.f;
      for (int w = 0; w < NW; ++w) tot += red[w * G + g];
      cm[g] = mb[g];
      cl[g] = nr > 0 ? tot : 0.f;
      cer[g] = 0.f;
    }
  }
  float M[G], L[G], invL[G];
  if constexpr (SB) {
    // K11: weights against this block's own max, unnormalized.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      M[g] = mb[g];
      L[g] = 1.f;
      invL[g] = 1.f;
    }
    __syncthreads();  // cer zeroed before the new row's owner sets it
  } else {
    cluster.sync();
    // The ranks' values are read unrolled (clusters of at most 8), so the
    // distributed-shared-memory loads are all in flight at once.
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float rm[8], rl[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        rm[r] = r < CL ? cluster.map_shared_rank(cm, r)[g] : -INFINITY;
        rl[r] = r < CL ? cluster.map_shared_rank(cl, r)[g] : 0.f;
      }
      float mm = -INFINITY, ll = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) mm = fmaxf(mm, rm[r]);
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (rl[r] > 0.f) ll += rl[r] * expf(rm[r] - mm);
      M[g] = mm;
      L[g] = ll;
      invL[g] = 1.f / ll;
    }
  }
  // Probabilities (K11: exp weights) times scale_v, rounded to the compute
  // type, in place.  K11 keeps the new row's weight apart.
  for (int i = tid; i < nr; i += NW * 32) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float ex = expf(sc[i * G + g] - M[g]);
      if (SB && i == newi) {
        cer[g] = ex;
        sc[i * G + g] = 0.f;
        continue;
      }
      float pr = ex * invL[g];
      if constexpr (kQuant) pr *= sSv[i];
      sc[i * G + g] = cdt_round<T>(pr);
    }
  }

  // --- values: LPRB lanes a row, RPIB rows a warp at a time ---
  const int jb = lane % LPRB, rb = lane / LPRB;
  float acc[G][PPLB * EPP];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int x = 0; x < PPLB * EPP; ++x) acc[g][x] = 0.f;
  for (int c = 0; c < nch; ++c) {
    if (!early && c >= 1 && c + NS - 1 < nch) {  // V of a chunk past the first NS
      load_chunk(vpan, sV, c + NS - 1);
      cp_async_commit();
      ++group;
    }
    cp_async_wait(group - vgrp(c, kgroups) - 1);
    __syncthreads();
    unsigned char* slot = (early && c >= NS ? sK : sV) + (c % NS) * S::CB;
    if (!SB && newi >= c * DC && newi < (c + 1) * DC) {
      for (int d = tid; d < D; d += NW * 32)
        reinterpret_cast<T*>(slot + (newi - c * DC) * S::RB)[d] = from_f32<T>(sv[d]);
      __syncthreads();
    }
    for (int r = rb + RPIB * warp; r < DC; r += RPIB * NW) {
      const int i = c * DC + r;
      if (i >= nr) break;
      float pr[G];
#pragma unroll
      for (int g = 0; g < G; ++g) pr[g] = sc[i * G + g];
#pragma unroll
      for (int k = 0; k < PPLB; ++k) {
        float f[EPP];
        piece_f32<T>(*reinterpret_cast<const uint4*>(slot + r * S::RB + 16 * (k * LPRB + jb)), f);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int x = 0; x < EPP; ++x)
            acc[g][k * EPP + x] = __fmaf_rn(pr[g], f[x], acc[g][k * EPP + x]);
      }
    }
    if (c + NS < nch) __syncthreads();  // slot c % NS is refilled next
  }
  // Row groups of a warp, then warps in order, then ranks in order.
#pragma unroll
  for (int off = LPRB; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int x = 0; x < PPLB * EPP; ++x)
        acc[g][x] += __shfl_xor_sync(0xffffffffu, acc[g][x], off);
  __syncthreads();  // every warp done with the K ring that acc_s reuses
  if (rb == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int k = 0; k < PPLB; ++k)
#pragma unroll
        for (int x = 0; x < EPP; ++x)
          acc_s[(warp * G + g) * D + (k * LPRB + jb) * EPP + x] = acc[g][k * EPP + x];
  }
  __syncthreads();
  if constexpr (SB) {
    // This run's partial, then the ticket; the last run to arrive merges.
    float* mine = sa->part + ((size_t)bh * CL + rank) * G * (D + 4);
    for (int x = tid; x < G * D; x += NW * 32) {
      float o = 0.f;
      for (int w = 0; w < NW; ++w) o += acc_s[w * G * D + x];
      mine[(x / D) * (D + 4) + 4 + x % D] = o;
    }
    if (tid < G) {
      mine[tid * (D + 4) + 0] = cm[tid];
      mine[tid * (D + 4) + 1] = cl[tid];
      mine[tid * (D + 4) + 2] = cer[tid];
    }
    // One thread fences for the block after the barrier (release), takes
    // the ticket, and the last block's fences again before its threads
    // read the others' partials (acquire), as a grid barrier does.
    __shared__ int is_last;
    const int nl = (n + sa->run - 1) / sa->run;
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      is_last = atomicAdd(sa->ticket + bh, 1) == nl - 1;
      if (is_last) __threadfence();
    }
    __syncthreads();
    if (!is_last) return;
    sb_merge<T, D, G>(p, sa->part + (size_t)bh * CL * G * (D + 4), nl, b, h,
                      sv, nr_.sv, acc_s);
    if (tid == 0) sa->ticket[bh] = 0;
  } else {
    for (int x = tid; x < G * D; x += NW * 32) {
      float o = 0.f;
      for (int w = 0; w < NW; ++w) o += acc_s[w * G * D + x];
      part[x] = o;
    }
    cluster.sync();
    if (rank == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        for (int d = tid; d < D; d += NW * 32) {
          float ro[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) ro[r] = r < CL ? cluster.map_shared_rank(part, r)[g * D + d] : 0.f;
          float o = 0.f;
#pragma unroll
          for (int r = 0; r < 8; ++r) o += ro[r];
          if (!(L[g] > 0.f)) o = 0.f;
          store_out(p, (size_t)b * p.heads * D + (size_t)(h * G + g) * D + d, o);
        }
    }
    cluster.sync();  // keep every block's shared memory alive until rank 0 has read it
  }
}

// One kernel name per entry and pool type, so a profiler trace tells them
// apart.
#define GEMMA_DEC_KERNEL(NAME, T, ARGS)                                     \
  template <int D, int G>                                                   \
  __global__ void __launch_bounds__(DEC_WARPS * 32) NAME(ARGS p) {          \
    decode_attention_body<T, D, G, false>(p, nullptr);                      \
  }
GEMMA_DEC_KERNEL(decode_attention_i8_kernel, int8_t, DecArgs)
GEMMA_DEC_KERNEL(decode_attention_bf16_kernel, __nv_bfloat16, DecArgs)
GEMMA_DEC_KERNEL(decode_attention_f32_kernel, float, DecArgs)
GEMMA_DEC_KERNEL(decode_write_attend_i8_kernel, int8_t, SplitArgs)
GEMMA_DEC_KERNEL(decode_write_attend_bf16_kernel, __nv_bfloat16, SplitArgs)
GEMMA_DEC_KERNEL(decode_write_attend_f32_kernel, float, SplitArgs)
GEMMA_DEC_KERNEL(decode_attend_i8_kernel, int8_t, SplitArgs)
GEMMA_DEC_KERNEL(decode_attend_bf16_kernel, __nv_bfloat16, SplitArgs)
GEMMA_DEC_KERNEL(decode_attend_f32_kernel, float, SplitArgs)
#undef GEMMA_DEC_KERNEL

// K4 / K8 / K10 launch as clusters of dec_cluster(kvh) blocks (runtime
// cluster dimensions), K11 (cl 0) without; the shared-memory ceiling is
// raised once per kernel, to the most any ring takes, not on every decode
// launch.
template <typename Args>
static cudaError_t launch_one(void (*kernel)(Args), const Args& p, int bytes,
                              int max_bytes, int blocks, int cl,
                              cudaStream_t st) {
  static std::mutex mu;
  static std::set<void*> ready;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready.count(reinterpret_cast<void*>(kernel))) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
      if (e != cudaSuccess) return e;
      ready.insert(reinterpret_cast<void*>(kernel));
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(DEC_WARPS * 32);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 0 ? 1 : 0;

  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// K4 (DecArgs); K8 (op 1) or K10 (op 2) (SplitArgs).
template <typename T, int D, int G, typename Args>
static cudaError_t launch_dec(const Args& p, int op, int batch, cudaStream_t st) {
  using S = DecSmem<T, D, G, DEC_RESERVE, DEC_NSMAX>;
  const int cl = dec_cluster(p.kvh);
  const int bytes = S::bytes((p.ring + cl - 1) / cl), max_bytes = S::bytes(DEC_MAXR);
  void (*kernel)(Args);
  if constexpr (std::is_same<Args, DecArgs>::value) {
    if constexpr (std::is_same<T, int8_t>::value) kernel = decode_attention_i8_kernel<D, G>;
    else if constexpr (std::is_same<T, __nv_bfloat16>::value) kernel = decode_attention_bf16_kernel<D, G>;
    else kernel = decode_attention_f32_kernel<D, G>;
  } else if constexpr (std::is_same<T, int8_t>::value) {
    kernel = op == 1 ? decode_write_attend_i8_kernel<D, G> : decode_attend_i8_kernel<D, G>;
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    kernel = op == 1 ? decode_write_attend_bf16_kernel<D, G> : decode_attend_bf16_kernel<D, G>;
  } else {
    kernel = op == 1 ? decode_write_attend_f32_kernel<D, G> : decode_attend_f32_kernel<D, G>;
  }
  return launch_one(kernel, p, bytes, max_bytes, batch * p.kvh * cl, cl, st);
}

template <typename T, typename Args>
static int dispatch_dec(const Args& p, int op, int batch, int d,
                        int* launched, cudaStream_t st) {
  *launched = 0;
  const int g = p.heads / p.kvh;
  if (p.heads % p.kvh != 0 || p.ring <= 0 || p.window <= 0 ||
      (p.ring + dec_cluster(p.kvh) - 1) / dec_cluster(p.kvh) > DEC_MAXR)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (d == 256 && g == 2) e = launch_dec<T, 256, 2>(p, op, batch, st);
  else if (d == 256 && g == 1) e = launch_dec<T, 256, 1>(p, op, batch, st);
  else if (d == 256 && g == 4) e = launch_dec<T, 256, 4>(p, op, batch, st);
  else if (d == 128 && g == 2) e = launch_dec<T, 128, 2>(p, op, batch, st);
  else if (d == 128 && g == 1) e = launch_dec<T, 128, 1>(p, op, batch, st);
  else if (d == 128 && g == 4) e = launch_dec<T, 128, 4>(p, op, batch, st);
  else return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  return (int)cudaGetLastError();
}

extern "C" int gemma_decode_attention_i8(
    const float* qkv, const float* inv_ts, const float* knorm,
    const float* qnorm, int8_t* pool, float* scales, const int* pos,
    const bool* valid, __nv_bfloat16* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window,
    int pe_mode, float qscale, float att_cap, int* launched,
    cudaStream_t st) {
  DecArgs p = {qkv, inv_ts, knorm, qnorm, pool, scales, pos, valid, out,
               n_layers, layer, kvh, heads, s_alloc, ring, window, pe_mode,
               qscale, att_cap};
  return dispatch_dec<int8_t>(p, 0, batch, d, launched, st);
}

extern "C" int gemma_decode_attention_bf16(
    const float* qkv, const float* inv_ts, const float* knorm,
    const float* qnorm, __nv_bfloat16* pool, const int* pos,
    const bool* valid, __nv_bfloat16* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window,
    int pe_mode, float qscale, float att_cap, int* launched,
    cudaStream_t st) {
  DecArgs p = {qkv, inv_ts, knorm, qnorm, pool, nullptr, pos, valid, out,
               n_layers, layer, kvh, heads, s_alloc, ring, window, pe_mode,
               qscale, att_cap};
  return dispatch_dec<__nv_bfloat16>(p, 0, batch, d, launched, st);
}

extern "C" int gemma_decode_attention_f32(
    const float* qkv, const float* inv_ts, const float* knorm,
    const float* qnorm, float* pool, const int* pos, const bool* valid,
    __nv_bfloat16* out, int batch, int n_layers, int layer, int kvh,
    int heads, int s_alloc, int d, int ring, int window, int pe_mode,
    float qscale, float att_cap, int* launched, cudaStream_t st) {
  DecArgs p = {qkv, inv_ts, knorm, qnorm, pool, nullptr, pos, valid, out,
               n_layers, layer, kvh, heads, s_alloc, ring, window, pe_mode,
               qscale, att_cap};
  return dispatch_dec<float>(p, 0, batch, d, launched, st);
}

// K8's, K10's and K11's arguments: q [B, 1, heads, D] at batch stride
// q_bs; the new rows through (new_bs, new_hs); out f32 [B, heads, D].
static SplitArgs split_args(const float* q, const void* knew, const void* vnew,
                          int new_bs, int new_hs, const float* nsc,
                          const float* inv_ts, const float* knorm,
                          const float* qnorm, void* pool, float* scales,
                          const int* pos, const bool* valid, float* out,
                          int n_layers, int layer, int kvh, int heads,
                          int s_alloc, int ring, int window, int q_bs,
                          int pe_mode, float qscale, float att_cap) {
  SplitArgs p = {};
  p.q = q; p.q_bs = q_bs;
  p.knew = knew; p.vnew = vnew; p.new_bs = new_bs; p.new_hs = new_hs;
  p.nsc = nsc; p.inv_ts = inv_ts; p.knorm = knorm; p.qnorm = qnorm;
  p.pool = pool; p.scales = scales; p.pos = pos; p.valid = valid;
  p.out = out;
  p.n_layers = n_layers; p.layer = layer; p.kvh = kvh; p.heads = heads;
  p.s_alloc = s_alloc; p.ring = ring; p.window = window; p.pe_mode = pe_mode;
  p.qscale = qscale; p.att_cap = att_cap;
  return p;
}

// K8: pe_mode 0 / 1 encodes in the kernel (inv_ts required, the rows
// f32); -1 takes q and the rows pre-encoded (i8: nsc required).
template <typename T>
static int write_attend(const float* q, const void* knew, const void* vnew,
                        int new_bs, int new_hs, const float* nsc,
                        const float* inv_ts, const float* knorm,
                        const float* qnorm, T* pool, float* scales,
                        const int* pos, const bool* valid, float* out,
                        int batch, int n_layers, int layer, int kvh, int heads,
                        int s_alloc, int d, int ring, int window, int q_bs,
                        int pe_mode, float qscale, float att_cap,
                        int* launched, cudaStream_t st) {
  *launched = 0;
  if ((pe_mode >= 0) != (inv_ts != nullptr)) return (int)cudaErrorInvalidValue;
  if (std::is_same<T, int8_t>::value &&
      (scales == nullptr || (pe_mode < 0 && nsc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const SplitArgs p = split_args(q, knew, vnew, new_bs, new_hs, nsc, inv_ts,
                               knorm, qnorm, pool, scales, pos, valid, out,
                               n_layers, layer, kvh, heads, s_alloc, ring,
                               window, q_bs, pe_mode, qscale, att_cap);
  return dispatch_dec<T>(p, 1, batch, d, launched, st);
}

extern "C" int gemma_decode_write_attend_i8(
    const float* q, const void* knew, const void* vnew, int new_bs,
    int new_hs, const float* nsc, const float* inv_ts, const float* knorm,
    const float* qnorm, int8_t* pool, float* scales, const int* pos,
    const bool* valid, float* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window, int q_bs,
    int pe_mode, float qscale, float att_cap, int* launched,
    cudaStream_t st) {
  return write_attend(q, knew, vnew, new_bs, new_hs, nsc, inv_ts, knorm,
                      qnorm, pool, scales, pos, valid, out, batch, n_layers,
                      layer, kvh, heads, s_alloc, d, ring, window, q_bs,
                      pe_mode, qscale, att_cap, launched, st);
}

extern "C" int gemma_decode_write_attend_bf16(
    const float* q, const void* knew, const void* vnew, int new_bs,
    int new_hs, const float* nsc, const float* inv_ts, const float* knorm,
    const float* qnorm, __nv_bfloat16* pool, float* scales, const int* pos,
    const bool* valid, float* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window, int q_bs,
    int pe_mode, float qscale, float att_cap, int* launched,
    cudaStream_t st) {
  return write_attend(q, knew, vnew, new_bs, new_hs, nsc, inv_ts, knorm,
                      qnorm, pool, scales, pos, valid, out, batch, n_layers,
                      layer, kvh, heads, s_alloc, d, ring, window, q_bs,
                      pe_mode, qscale, att_cap, launched, st);
}

extern "C" int gemma_decode_write_attend_f32(
    const float* q, const void* knew, const void* vnew, int new_bs,
    int new_hs, const float* nsc, const float* inv_ts, const float* knorm,
    const float* qnorm, float* pool, float* scales, const int* pos,
    const bool* valid, float* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window, int q_bs,
    int pe_mode, float qscale, float att_cap, int* launched,
    cudaStream_t st) {
  return write_attend(q, knew, vnew, new_bs, new_hs, nsc, inv_ts, knorm,
                      qnorm, pool, scales, pos, valid, out, batch, n_layers,
                      layer, kvh, heads, s_alloc, d, ring, window, q_bs,
                      pe_mode, qscale, att_cap, launched, st);
}

// K10: q pre-encoded; no new row.
template <typename T>
static int attend(const float* q, const T* pool, const float* scales,
                  const int* pos, float* out, int batch, int n_layers,
                  int layer, int kvh, int heads, int s_alloc, int d, int ring,
                  int window, int q_bs, float att_cap, int* launched,
                  cudaStream_t st) {
  *launched = 0;
  if (std::is_same<T, int8_t>::value && scales == nullptr)
    return (int)cudaErrorInvalidValue;
  const SplitArgs p = split_args(q, nullptr, nullptr, 0, 0, nullptr, nullptr,
                               nullptr, nullptr, const_cast<T*>(pool),
                               const_cast<float*>(scales), pos, nullptr, out,
                               n_layers, layer, kvh, heads, s_alloc, ring,
                               window, q_bs, -1, 1.0f, att_cap);
  return dispatch_dec<T>(p, 2, batch, d, launched, st);
}

extern "C" int gemma_decode_attend_i8(
    const float* q, const int8_t* pool, const float* scales, const int* pos,
    float* out, int batch, int n_layers, int layer, int kvh, int heads,
    int s_alloc, int d, int ring, int window, int q_bs, float att_cap,
    int* launched, cudaStream_t st) {
  return attend(q, pool, scales, pos, out, batch, n_layers, layer, kvh, heads,
                s_alloc, d, ring, window, q_bs, att_cap, launched, st);
}

extern "C" int gemma_decode_attend_bf16(
    const float* q, const __nv_bfloat16* pool, const float* scales,
    const int* pos, float* out, int batch, int n_layers, int layer, int kvh,
    int heads, int s_alloc, int d, int ring, int window, int q_bs,
    float att_cap, int* launched, cudaStream_t st) {
  return attend(q, pool, scales, pos, out, batch, n_layers, layer, kvh, heads,
                s_alloc, d, ring, window, q_bs, att_cap, launched, st);
}

extern "C" int gemma_decode_attend_f32(
    const float* q, const float* pool, const float* scales, const int* pos,
    float* out, int batch, int n_layers, int layer, int kvh, int heads,
    int s_alloc, int d, int ring, int window, int q_bs, float att_cap,
    int* launched, cudaStream_t st) {
  return attend(q, pool, scales, pos, out, batch, n_layers, layer, kvh, heads,
                s_alloc, d, ring, window, q_bs, att_cap, launched, st);
}

// ---------------------------------------------------------------------------
// K9: the in-place ring-row write, from the raw rows.
// ---------------------------------------------------------------------------

// k and v [B, 1, KVH, D], f32 or bf16 (in_bf16), each through its own
// batch and head strides in elements (the composed path's k is RoPE's
// output, its v a view into the fused qkv row).
struct KvWriteArgs {
  const void* k;
  const void* v;
  int k_bs, k_hs, v_bs, v_hs;
  void* pool;
  float* scales;  // (i8), else null
  const int* pos;
  const bool* valid;
  int rows, n_layers, layer, kvh, s_alloc, d, ring;
};

constexpr int KVW_WARPS = 4;   // rows a block
constexpr int KVW_MAXU = 2;    // 8-element units a lane: D <= 512

// Eight consecutive elements of a raw row at x (16-byte aligned) as f32.
template <typename TIn>
__device__ __forceinline__ void load8(const TIn* x, float* f) {
  if constexpr (std::is_same<TIn, float>::value) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(x) + 1);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __uint_as_float(w[i]);
  } else {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x));
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Eight encoded elements (i8: codes as floats) into the pool row at y.
template <typename T>
__device__ __forceinline__ void store8(T* y, const float* f) {
  if constexpr (std::is_same<T, int8_t>::value) {
    uint32_t w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      w[h] = (uint32_t)(uint8_t)(int8_t)f[4 * h] |
             (uint32_t)(uint8_t)(int8_t)f[4 * h + 1] << 8 |
             (uint32_t)(uint8_t)(int8_t)f[4 * h + 2] << 16 |
             (uint32_t)(uint8_t)(int8_t)f[4 * h + 3] << 24;
    *reinterpret_cast<uint2*>(y) = make_uint2(w[0], w[1]);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    *reinterpret_cast<uint4*>(y) =
        make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                   pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
  } else {
    reinterpret_cast<float4*>(y)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(y)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// One warp a (b, k/v, h) row, flattened as [B, 2, KVH]: lane l takes the
// 8-element units l, l + 32 of the row (16-byte loads), i8 the row's max
// |x| by a shuffle tree and the shared encode, bf16 rounding to nearest
// even, f32 as it is; then the ring row's write.
template <typename T, typename TIn>
__device__ __forceinline__ void kv_write_body(const KvWriteArgs& p) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * KVW_WARPS + (threadIdx.x >> 5);
  if (r >= p.rows) return;
  const int h = r % p.kvh, kv = (r / p.kvh) % 2, b = r / (2 * p.kvh);
  const TIn* src = static_cast<const TIn*>(kv ? p.v : p.k) +
                   (size_t)b * (kv ? p.v_bs : p.k_bs) +
                   (size_t)h * (kv ? p.v_hs : p.k_hs);
  const int nu = p.d / 8;
  float x[KVW_MAXU][8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < KVW_MAXU; ++i) {
    const int u = lane + 32 * i;
    if (u < nu) {
      load8<TIn>(src + 8 * u, x[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(x[i][e]));
    }
  }
  const int row = (p.valid == nullptr || p.valid[b]) ? p.pos[b] % p.ring : p.ring;
  const size_t panel = (((size_t)b * p.n_layers + p.layer) * 2 + kv) * p.kvh + h;
  T* dst = static_cast<T*>(p.pool) + (panel * p.s_alloc + row) * p.d;
  if constexpr (std::is_same<T, int8_t>::value) {
    const I8Row enc(warp_max(amax));
#pragma unroll
    for (int i = 0; i < KVW_MAXU; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) x[i][e] = enc.code(x[i][e]);
    if (lane == 0) p.scales[panel * p.s_alloc + row] = enc.scale;
  }
#pragma unroll
  for (int i = 0; i < KVW_MAXU; ++i) {
    const int u = lane + 32 * i;
    if (u < nu) store8<T>(dst + 8 * u, x[i]);
  }
}

// One kernel name per pool type (the profiler's), TIn the rows' type.
#define GEMMA_KVW_KERNEL(NAME, T)                                           \
  template <typename TIn>                                                   \
  __global__ void __launch_bounds__(KVW_WARPS * 32) NAME(KvWriteArgs p) {   \
    kv_write_body<T, TIn>(p);                                               \
  }
GEMMA_KVW_KERNEL(kv_write_i8_kernel, int8_t)
GEMMA_KVW_KERNEL(kv_write_bf16_kernel, __nv_bfloat16)
GEMMA_KVW_KERNEL(kv_write_f32_kernel, float)
#undef GEMMA_KVW_KERNEL

template <typename T, typename TIn>
static void (*kv_write_kernel())(KvWriteArgs) {
  if constexpr (std::is_same<T, int8_t>::value) return kv_write_i8_kernel<TIn>;
  else if constexpr (std::is_same<T, __nv_bfloat16>::value) return kv_write_bf16_kernel<TIn>;
  else return kv_write_f32_kernel<TIn>;
}

template <typename T>
static int kv_write(const void* k, const void* v, int k_bs, int k_hs,
                    int v_bs, int v_hs, int in_bf16, T* pool, float* scales,
                    const int* pos, const bool* valid, int batch,
                    int n_layers, int layer, int kvh, int s_alloc, int d,
                    int ring, int* launched, cudaStream_t st) {
  *launched = 0;
  // 16-byte loads of 8 elements: d, the strides and the rows' starts
  // must keep every unit 16-byte aligned.
  const int esize = in_bf16 ? 2 : 4;
  auto odd = [&](const void* q, int stride) {
    return (reinterpret_cast<uintptr_t>(q) & 15) != 0 ||
           ((long long)stride * esize) % 16 != 0;
  };
  if (std::is_same<T, int8_t>::value != (scales != nullptr) || d % 8 ||
      d > 8 * 32 * KVW_MAXU || batch < 1 || kvh < 1 || ring < 1 ||
      odd(k, k_bs) || odd(k, k_hs) || odd(v, v_bs) || odd(v, v_hs))
    return (int)cudaErrorInvalidValue;
  const KvWriteArgs p = {k, v, k_bs, k_hs, v_bs, v_hs, pool, scales, pos,
                         valid, batch * 2 * kvh, n_layers, layer, kvh,
                         s_alloc, d, ring};
  void (*kernel)(KvWriteArgs) = in_bf16 ? kv_write_kernel<T, __nv_bfloat16>()
                                        : kv_write_kernel<T, float>();
  kernel<<<(p.rows + KVW_WARPS - 1) / KVW_WARPS, KVW_WARPS * 32, 0, st>>>(p);
  *launched = 1;
  return (int)cudaGetLastError();
}

// K9: the raw rows k and v through their strides (elements), f32 or bf16
// (in_bf16); the pool's scales for i8 (else null).
extern "C" int gemma_kv_write_i8(
    const void* k, const void* v, int k_bs, int k_hs, int v_bs, int v_hs,
    int in_bf16, int8_t* pool, float* scales, const int* pos,
    const bool* valid, int batch, int n_layers, int layer, int kvh,
    int s_alloc, int d, int ring, int* launched, cudaStream_t st) {
  return kv_write(k, v, k_bs, k_hs, v_bs, v_hs, in_bf16, pool, scales, pos,
                  valid, batch, n_layers, layer, kvh, s_alloc, d, ring,
                  launched, st);
}

extern "C" int gemma_kv_write_bf16(
    const void* k, const void* v, int k_bs, int k_hs, int v_bs, int v_hs,
    int in_bf16, __nv_bfloat16* pool, float* scales, const int* pos,
    const bool* valid, int batch, int n_layers, int layer, int kvh,
    int s_alloc, int d, int ring, int* launched, cudaStream_t st) {
  return kv_write(k, v, k_bs, k_hs, v_bs, v_hs, in_bf16, pool, scales, pos,
                  valid, batch, n_layers, layer, kvh, s_alloc, d, ring,
                  launched, st);
}

extern "C" int gemma_kv_write_f32(
    const void* k, const void* v, int k_bs, int k_hs, int v_bs, int v_hs,
    int in_bf16, float* pool, float* scales, const int* pos,
    const bool* valid, int batch, int n_layers, int layer, int kvh,
    int s_alloc, int d, int ring, int* launched, cudaStream_t st) {
  return kv_write(k, v, k_bs, k_hs, v_bs, v_hs, in_bf16, pool, scales, pos,
                  valid, batch, n_layers, layer, kvh, s_alloc, d, ring,
                  launched, st);
}

// ---------------------------------------------------------------------------
// K11: the write + attend over runs of sb_split, one block a run, the
// partials merged by the last block of (b, h) to finish (see the body).
// ---------------------------------------------------------------------------

// Two blocks an SM, as their shared memory allows at D = 256: up to 128
// registers a thread (G = 4, no Gemma2 shape, takes what it needs).
#define GEMMA_SBLOCK_KERNEL(NAME, T)                                        \
  template <int D, int G>                                                   \
  __global__ void __launch_bounds__(DEC_WARPS * 32, G == 4 ? 1 : 2)         \
      NAME(SblockArgs a) {                                                  \
    decode_attention_body<T, D, G, true>(a.d, &a);                          \
  }
GEMMA_SBLOCK_KERNEL(decode_sblocked_i8_kernel, int8_t)
GEMMA_SBLOCK_KERNEL(decode_sblocked_bf16_kernel, __nv_bfloat16)
GEMMA_SBLOCK_KERNEL(decode_sblocked_f32_kernel, float)
#undef GEMMA_SBLOCK_KERNEL

template <typename T, int D, int G>
static cudaError_t launch_sb(const SblockArgs& a, int batch, cudaStream_t st) {
  using S = DecSmem<T, D, G, SB_RESERVE, SB_NSMAX>;
  void (*kernel)(SblockArgs);
  if constexpr (std::is_same<T, int8_t>::value) kernel = decode_sblocked_i8_kernel<D, G>;
  else if constexpr (std::is_same<T, __nv_bfloat16>::value) kernel = decode_sblocked_bf16_kernel<D, G>;
  else kernel = decode_sblocked_f32_kernel<D, G>;
  return launch_one(kernel, a, S::bytes(a.run), S::bytes(SB_MAXR),
                    batch * a.d.kvh * a.nj, 0, st);
}

template <typename T>
static int sblocked(const float* q, const void* knew, const void* vnew,
                    int new_bs, int new_hs, const float* nsc,
                    const float* inv_ts, const float* knorm,
                    const float* qnorm, T* pool, float* scales, const int* pos,
                    const bool* valid, float* out, int batch, int n_layers,
                    int layer, int kvh, int heads, int s_alloc, int d,
                    int ring, int window, int q_bs, int pe_mode, float qscale,
                    float att_cap, float* part, int part_floats, int* ticket,
                    int* launched, cudaStream_t st) {
  *launched = 0;
  if ((pe_mode >= 0) != (inv_ts != nullptr) || heads % kvh != 0 ||
      ring <= 0 || window <= 0 || knew == nullptr)
    return (int)cudaErrorInvalidValue;
  if (std::is_same<T, int8_t>::value &&
      (scales == nullptr || (pe_mode < 0 && nsc == nullptr)))
    return (int)cudaErrorInvalidValue;
  SblockArgs a;
  a.d = split_args(q, knew, vnew, new_bs, new_hs, nsc, inv_ts, knorm, qnorm,
                   pool, scales, pos, valid, out, n_layers, layer, kvh, heads,
                   s_alloc, ring, window, q_bs, pe_mode, qscale, att_cap);
  a.part = part;
  a.ticket = ticket;
  sb_split(ring, window, kvh, &a.nj, &a.run);
  const int g = heads / kvh;
  // Runs longer than SB_MAXR (rings past SB_MAXR * SB_TARGET / kvh rows)
  // and partials past the caller's buffer are refused.
  if (a.run > SB_MAXR || a.nj > SB_MAX_RUNS ||
      (long long)batch * kvh * a.nj * g * (d + 4) > (long long)part_floats)
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (d == 256 && g == 2) e = launch_sb<T, 256, 2>(a, batch, st);
  else if (d == 256 && g == 1) e = launch_sb<T, 256, 1>(a, batch, st);
  else if (d == 256 && g == 4) e = launch_sb<T, 256, 4>(a, batch, st);
  else if (d == 128 && g == 2) e = launch_sb<T, 128, 2>(a, batch, st);
  else if (d == 128 && g == 1) e = launch_sb<T, 128, 1>(a, batch, st);
  else if (d == 128 && g == 4) e = launch_sb<T, 128, 4>(a, batch, st);
  else return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *launched = 1;
  return (int)cudaGetLastError();
}

// K11: K8's parameters, then the partials [B, KVH, nj, G, D + 4] and their
// capacity in floats, and the [B * KVH] tickets.
extern "C" int gemma_decode_sblocked_i8(
    const float* q, const void* knew, const void* vnew, int new_bs,
    int new_hs, const float* nsc, const float* inv_ts, const float* knorm,
    const float* qnorm, int8_t* pool, float* scales, const int* pos,
    const bool* valid, float* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window, int q_bs,
    int pe_mode, float qscale, float att_cap, float* part, int part_floats,
    int* ticket, int* launched, cudaStream_t st) {
  return sblocked(q, knew, vnew, new_bs, new_hs, nsc, inv_ts, knorm, qnorm,
                  pool, scales, pos, valid, out, batch, n_layers, layer, kvh,
                  heads, s_alloc, d, ring, window, q_bs, pe_mode, qscale,
                  att_cap, part, part_floats, ticket, launched, st);
}

extern "C" int gemma_decode_sblocked_bf16(
    const float* q, const void* knew, const void* vnew, int new_bs,
    int new_hs, const float* nsc, const float* inv_ts, const float* knorm,
    const float* qnorm, __nv_bfloat16* pool, float* scales, const int* pos,
    const bool* valid, float* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window, int q_bs,
    int pe_mode, float qscale, float att_cap, float* part, int part_floats,
    int* ticket, int* launched, cudaStream_t st) {
  return sblocked(q, knew, vnew, new_bs, new_hs, nsc, inv_ts, knorm, qnorm,
                  pool, scales, pos, valid, out, batch, n_layers, layer, kvh,
                  heads, s_alloc, d, ring, window, q_bs, pe_mode, qscale,
                  att_cap, part, part_floats, ticket, launched, st);
}

extern "C" int gemma_decode_sblocked_f32(
    const float* q, const void* knew, const void* vnew, int new_bs,
    int new_hs, const float* nsc, const float* inv_ts, const float* knorm,
    const float* qnorm, float* pool, float* scales, const int* pos,
    const bool* valid, float* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window, int q_bs,
    int pe_mode, float qscale, float att_cap, float* part, int part_floats,
    int* ticket, int* launched, cudaStream_t st) {
  return sblocked(q, knew, vnew, new_bs, new_hs, nsc, inv_ts, knorm, qnorm,
                  pool, scales, pos, valid, out, batch, n_layers, layer, kvh,
                  heads, s_alloc, d, ring, window, q_bs, pe_mode, qscale,
                  att_cap, part, part_floats, ticket, launched, st);
}
