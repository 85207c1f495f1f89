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
// K11: one block per (b, h, S block of `bs` rows); blocks past the live
// frontier min(pos, ring-1) / bs return at once, so the reads follow the
// ring's occupancy.  A block finds its rows' max m (pass 1), then sums
// e = exp(score - m) of the ok rows (s), the new row's share apart (er),
// and the panel rows' e (times scale_v for i8) rounded to the compute
// type times V (acc).  The last live block of (b, h) to finish (an atomic
// ticket, as K3 merges) combines the partials with weights exp(m_j - M),
// a block with no ok row weighing 0, normalizes once by max(s, 1e-30) and
// adds the new row's V times its share (times scale_v, rounded to the
// compute type).  Block j = 0 writes the row.
//
// K9: one block per (b, k/v, h) copies the pool-typed row (and its scale)
// to the ring row; nothing else of the pool moves.
//
// What bounds them on an H100: bytes.  Per call the attention kernels
// must read the live K and V rows, 2*D*sizeof(T) bytes per live row per
// (b, h) (+ 8 for i8's scales), plus q, the new rows and the output; at
// B=4, 4 KV heads, D=256 and 2054 live rows over the slots that is 4.3 MB
// (i8), 8.4 MB (bf16) or 16.8 MB (f32) -> 1.3, 2.5 or 5.0 us at 3.35 TB/s.
// At decode sizes the K4 body is bound by latency instead: the global
// loads, the new row's encode, and three cluster barriers.  Built with
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
    const float ka = block_reduce<NW, true>(tid < D ? fabsf(sk[tid]) : 0.f, red);
    const float va = block_reduce<NW, true>(tid < D ? fabsf(sv[tid]) : 0.f, red);
    new_sk = ka / 127.0f;
    new_sv = va / 127.0f;
    if (tid < D) {
      sk[tid] = rintf(sk[tid] * (new_sk > 0.f ? 1.0f / new_sk : 0.f));
      sv[tid] = rintf(sv[tid] * (new_sv > 0.f ? 1.0f / new_sv : 0.f));
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
        const float ka = block_reduce<NW, true>(tid < D ? fabsf(sk[tid]) : 0.f, red);
        const float va = block_reduce<NW, true>(tid < D ? fabsf(sv[tid]) : 0.f, red);
        nr.sk = ka / 127.0f;
        nr.sv = va / 127.0f;
        if (tid < D) {
          sk[tid] = rintf(sk[tid] * (nr.sk > 0.f ? 1.0f / nr.sk : 0.f));
          sv[tid] = rintf(sv[tid] * (nr.sv > 0.f ? 1.0f / nr.sv : 0.f));
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

// The absolute position ring row s holds, given the newest position pos
// (pm = pos % ring): pos - ((pm - s) mod ring).
__device__ __forceinline__ int key_abs(int pos, int pm, int s, int ring) {
  const int d = (pm - s) % ring;
  return pos - (d < 0 ? d + ring : d);
}

// K4's body, shared by K8 and K10.  One thread-block cluster of CL blocks
// (dec_cluster) per (b, h) splits the live positions p_lo..pos into CL
// contiguous runs (rank r: p_lo + r*n/CL up to p_lo + (r+1)*n/CL, n live
// positions; ops/decode_attention.py:decode_row_split), so the newest
// position, the new row, falls to the last rank.  A block:
//  1. puts its rows' loads in flight before it encodes the new row: K and
//     V in chunks of DC = 32 rows, the first NS chunks of each (2 to 4,
//     up to ~100 KB) and every row's i8 scales at once, later chunks
//     through the same slots as earlier ones are used (cp.async groups).
//     The new row's ring row is zero-filled and patched from the encoded
//     row in shared memory (the in-compute substitution);
//  2. scores its rows, 8 lanes a row (4 rows a warp at a time), q in
//     registers: scale_k, soft cap; keeps them in shared memory, with its
//     max m_r and l_r = sum exp(s - m_r) (K is read once);
//  3. exchanges (m_r, l_r) across the cluster: M = max m_r, L = sum over
//     ranks in order of l_r exp(m_r - M); turns each kept score into the
//     probability exp(s - M) * (1 / L) (times scale_v), rounded to the
//     compute type;
//  4. multiplies V by the probabilities, lanes splitting D; lanes, warps
//     and then ranks add their partial sums in order.
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

template <typename T, int D, int G>
struct DecSmem {
  static constexpr int RB = D * (int)sizeof(T);     // bytes a row
  static constexpr int NP = RB / 16;                // 16-byte pieces a row
  static constexpr int EPP = 16 / (int)sizeof(T);   // elements a piece
  static constexpr int CB = DC * RB;                // bytes a chunk
  // Per kept row: G scores (i8: and the K and V scales).
  static constexpr int per_row = G * 4 + (std::is_same<T, int8_t>::value ? 8 : 0);
  // Chunk slots of K and of V: 2 to 4 each, as many as keep the block
  // within ~100 KB beside the scores of 1024 rows (two blocks an SM, so
  // clusters always find room); f32 rows at D = 256 take 2 slots and one
  // block an SM.
  static constexpr int fit = (100 * 1024 - 1024 * per_row) / (2 * CB);
  static constexpr int NS = fit < 2 ? 2 : fit > 4 ? 4 : fit;
  static constexpr int ring = NS * CB;
  static constexpr int acc = DEC_WARPS * G * D * 4;
  static constexpr int kring_or_acc = ring > acc ? ring : acc;
  // Dynamic shared memory for `maxr` kept rows (ceil(ring / cluster)).
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

template <typename T, int D, int G, typename Args>
__device__ __forceinline__ void decode_attention_body(const Args& p) {
  namespace cg = cooperative_groups;
  using S = DecSmem<T, D, G>;
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  constexpr int NW = DEC_WARPS, NP = S::NP, EPP = S::EPP, NS = S::NS;
  constexpr int PPL = NP / 8;                     // scoring: pieces a lane
  constexpr int LPRB = NP < 32 ? NP : 32;         // values: lanes a row
  constexpr int RPIB = 32 / LPRB, PPLB = NP / LPRB;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), CL = (int)cluster.dim_blocks().x;
  const int bh = blockIdx.x / CL;
  const int maxr = (p.ring + CL - 1) / CL;
  const int b = bh / p.kvh, h = bh % p.kvh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
  __shared__ float part[G * D];   // this block's share of the output

  // This block's run of live positions.
  const int pos = p.pos[b];
  const int p_lo = max(max(pos - p.window + 1, pos - p.ring + 1), 0);
  const int n = pos - p_lo + 1;
  const int first = p_lo + (rank * n) / CL;
  const int nr = p_lo + ((rank + 1) * n) / CL - first;
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

  // Every block of the cluster encodes the new row (cheap: D values);
  // rank 0 writes it to the pool.
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
    }
  }
  cluster.sync();
  float M[G], L[G], invL[G];
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
  // Probabilities (times scale_v), rounded to the compute type, in place.
  for (int i = tid; i < nr; i += NW * 32) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float pr = expf(sc[i * G + g] - M[g]) * invL[g];
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
    if (c >= 1 && c + NS - 1 < nch) {  // V of a chunk past the first NS
      load_chunk(vpan, sV, c + NS - 1);
      cp_async_commit();
      ++group;
    }
    cp_async_wait(group - vgrp(c, kgroups) - 1);
    __syncthreads();
    unsigned char* slot = sV + (c % NS) * S::CB;
    if (newi >= c * DC && newi < (c + 1) * DC) {
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

// One kernel name per entry and pool type, so a profiler trace tells them
// apart.
#define GEMMA_DEC_KERNEL(NAME, T, ARGS)                                     \
  template <int D, int G>                                                   \
  __global__ void __launch_bounds__(DEC_WARPS * 32) NAME(ARGS p) {          \
    decode_attention_body<T, D, G>(p);                                      \
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

// Launched as clusters of dec_cluster(kvh) blocks (runtime cluster
// dimensions); the shared-memory ceiling is raised once per kernel, to the
// most any ring takes, not on every decode launch.
template <typename Args>
static cudaError_t launch_one(void (*kernel)(Args), const Args& p, int bytes,
                              int max_bytes, int cl, int batch, cudaStream_t st) {
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
  cfg.gridDim = dim3(batch * p.kvh * cl);
  cfg.blockDim = dim3(DEC_WARPS * 32);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// K4 (DecArgs); K8 (op 1) or K10 (op 2) (SplitArgs).
template <typename T, int D, int G, typename Args>
static cudaError_t launch_dec(const Args& p, int op, int batch, cudaStream_t st) {
  using S = DecSmem<T, D, G>;
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
  return launch_one(kernel, p, bytes, max_bytes, cl, batch, st);
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
// K9: the in-place ring-row write.
// ---------------------------------------------------------------------------

struct KvWriteArgs {
  const void* rows;      // [B, 2, KVH, D] in the pool's type
  const float* nsc;      // [B, 2, KVH] (i8), else null
  void* pool;
  float* scales;         // (i8), else null
  const int* pos;
  const bool* valid;
  int n_layers, layer, kvh, s_alloc, d, ring;
};

// Block (b, k/v, h), flattened as the rows' [B, 2, KVH] index.
template <typename T>
__device__ __forceinline__ void kv_write_body(const KvWriteArgs& p) {
  const int bkh = blockIdx.x;
  const int h = bkh % p.kvh, kv = (bkh / p.kvh) % 2, b = bkh / (2 * p.kvh);
  const int row = (p.valid == nullptr || p.valid[b]) ? p.pos[b] % p.ring : p.ring;
  const size_t panel = (((size_t)b * p.n_layers + p.layer) * 2 + kv) * p.kvh + h;
  const T* src = static_cast<const T*>(p.rows) + (size_t)bkh * p.d;
  T* dst = static_cast<T*>(p.pool) + (panel * p.s_alloc + row) * p.d;
  for (int i = threadIdx.x; i < p.d; i += blockDim.x) dst[i] = src[i];
  if (p.scales != nullptr && threadIdx.x == 0)
    p.scales[panel * p.s_alloc + row] = p.nsc[bkh];
}

__global__ void kv_write_i8_kernel(KvWriteArgs p) { kv_write_body<int8_t>(p); }
__global__ void kv_write_bf16_kernel(KvWriteArgs p) { kv_write_body<__nv_bfloat16>(p); }
__global__ void kv_write_f32_kernel(KvWriteArgs p) { kv_write_body<float>(p); }

template <typename T>
static int kv_write(const T* rows, const float* nsc, T* pool, float* scales,
                    const int* pos, const bool* valid, int batch, int n_layers,
                    int layer, int kvh, int s_alloc, int d, int ring,
                    int* launched, cudaStream_t st) {
  *launched = 0;
  if (std::is_same<T, int8_t>::value != (scales != nullptr) ||
      (scales != nullptr && nsc == nullptr))
    return (int)cudaErrorInvalidValue;
  const KvWriteArgs p = {rows, nsc, pool, scales, pos, valid, n_layers,
                         layer, kvh, s_alloc, d, ring};
  const dim3 grid(batch * 2 * kvh), block(128);
  if constexpr (std::is_same<T, int8_t>::value)
    kv_write_i8_kernel<<<grid, block, 0, st>>>(p);
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
    kv_write_bf16_kernel<<<grid, block, 0, st>>>(p);
  else
    kv_write_f32_kernel<<<grid, block, 0, st>>>(p);
  *launched = 1;
  return (int)cudaGetLastError();
}

extern "C" int gemma_kv_write_i8(
    const int8_t* rows, const float* nsc, int8_t* pool, float* scales,
    const int* pos, const bool* valid, int batch, int n_layers, int layer,
    int kvh, int s_alloc, int d, int ring, int* launched, cudaStream_t st) {
  return kv_write(rows, nsc, pool, scales, pos, valid, batch, n_layers, layer,
                  kvh, s_alloc, d, ring, launched, st);
}

extern "C" int gemma_kv_write_bf16(
    const __nv_bfloat16* rows, const float* nsc, __nv_bfloat16* pool,
    float* scales, const int* pos, const bool* valid, int batch,
    int n_layers, int layer, int kvh, int s_alloc, int d, int ring,
    int* launched, cudaStream_t st) {
  return kv_write(rows, nsc, pool, scales, pos, valid, batch, n_layers, layer,
                  kvh, s_alloc, d, ring, launched, st);
}

extern "C" int gemma_kv_write_f32(
    const float* rows, const float* nsc, float* pool, float* scales,
    const int* pos, const bool* valid, int batch, int n_layers, int layer,
    int kvh, int s_alloc, int d, int ring, int* launched, cudaStream_t st) {
  return kv_write(rows, nsc, pool, scales, pos, valid, batch, n_layers, layer,
                  kvh, s_alloc, d, ring, launched, st);
}

// ---------------------------------------------------------------------------
// K11: S-blocked write + attend with an online softmax across blocks.
// ---------------------------------------------------------------------------

struct SblockArgs {
  SplitArgs d;
  float* part;   // [B, KVH, nj, G, D + 4]: m, s, er, pad, then acc[D]
  int* ticket;   // [B * KVH], zero between launches
  int bs;        // rows per block; s_alloc % bs == 0
};

constexpr int SB_WARPS = 8;

template <typename T, int D, int G>
__device__ __forceinline__ void sblocked_body(const SblockArgs& a) {
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  constexpr int NW = SB_WARPS;
  constexpr int DPL = D / 32;
  const SplitArgs& p = a.d;
  const int nj = p.s_alloc / a.bs;
  const int j = blockIdx.x % nj;
  const int bh = blockIdx.x / nj;
  const int b = bh / p.kvh, h = bh % p.kvh;
  const int pos = p.pos[b];
  const int hi = min(pos, p.ring - 1) / a.bs;
  if (j > hi) return;  // past the live frontier: nothing to read
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ float sk[D], sv[D], sq[G * D];
  __shared__ float red[32];
  __shared__ float wm[NW][G], ws[NW][G], wr[NW][G];
  __shared__ float acc_s[NW][G][D];
  __shared__ int is_last;

  const NewRow nr = encode_rows<T, D, G, NW>(p, b, h, j == 0, sk, sv, sq,
                                             red);
  const int row = nr.row;
  const float new_sk = nr.sk, new_sv = nr.sv;
  const size_t plane = (size_t)p.s_alloc * D;
  const size_t kbase = panel_of(p, b, 0, h), vbase = panel_of(p, b, 1, h);
  const T* kpan = static_cast<const T*>(p.pool) + kbase * plane;
  const T* vpan = static_cast<const T*>(p.pool) + vbase * plane;
  const float* ksc = kQuant ? p.scales + kbase * p.s_alloc : nullptr;
  const float* vsc = kQuant ? p.scales + vbase * p.s_alloc : nullptr;

  float qr[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) qr[g][i] = sq[g * D + lane * DPL + i];

  const int start = max(pos - p.window + 1, 0);
  const int pm = pos % p.ring;
  const int s0 = j * a.bs, s1 = s0 + a.bs;
  const float cap = p.att_cap;
  auto ok_row = [&](int s) {
    if (s >= p.ring) return false;
    const int ka = key_abs(pos, pm, s, p.ring);
    return ka >= start && ka <= pos;
  };
  // The new row's score, like every other, is an f32 multiply-and-sum of
  // q and the row in the compute type.
  auto score = [&](int s, float* out_sc) {
    float c[DPL];
    if (s == row) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) c[i] = sk[lane * DPL + i];
    } else {
      const T* src = kpan + (size_t)s * D + lane * DPL;
#pragma unroll
      for (int i = 0; i < DPL; i += 4) ld4(src + i, c + i);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) d += qr[g][i] * c[i];
      float v = warp_sum(d);
      if constexpr (kQuant) v *= s == row ? new_sk : ksc[s];
      if (cap != 0.f) v = cap * tanhf(v / cap);
      out_sc[g] = v;
    }
  };

  // Pass 1: the block's max over its ok rows.
  float m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = -INFINITY;
  for (int s = s0 + warp; s < s1; s += NW) {
    if (!ok_row(s)) continue;
    float sc[G];
    score(s, sc);
#pragma unroll
    for (int g = 0; g < G; ++g) m[g] = fmaxf(m[g], sc[g]);
  }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) wm[warp][g] = m[g];
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mm = -INFINITY;
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, wm[w][g]);
    m[g] = mm;
  }

  // Pass 2: exp weights from the block max; the new row's apart.
  float acc[G][DPL], ssum[G], er[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    ssum[g] = er[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }
  for (int s = s0 + warp; s < s1; s += NW) {
    if (!ok_row(s)) continue;
    float sc[G];
    score(s, sc);
    if (s == row) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float e = expf(sc[g] - m[g]);
        ssum[g] += e;
        er[g] += e;
      }
      continue;
    }
    float c[DPL];
    const T* src = vpan + (size_t)s * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; i += 4) ld4(src + i, c + i);
    const float sv_s = kQuant ? vsc[s] : 1.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float e = expf(sc[g] - m[g]);
      ssum[g] += e;
      const float w = cdt_round<T>(e * sv_s);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] += w * c[i];
    }
  }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) { ws[warp][g] = ssum[g]; wr[warp][g] = er[g]; }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_s[warp][g][lane * DPL + i] = acc[g][i];
  __syncthreads();

  float* mine = a.part + ((size_t)bh * nj + j) * G * (D + 4);
  if (tid < G) {
    float st = 0.f, rt = 0.f;
    for (int w = 0; w < NW; ++w) { st += ws[w][tid]; rt += wr[w][tid]; }
    mine[tid * (D + 4) + 0] = m[tid];
    mine[tid * (D + 4) + 1] = st;
    mine[tid * (D + 4) + 2] = rt;
  }
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float o = 0.f;
      for (int w = 0; w < NW; ++w) o += acc_s[w][g][tid];
      mine[g * (D + 4) + 4 + tid] = o;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(a.ticket + bh, 1) == hi;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // The last live block of (b, h): combine blocks 0..hi.
  const float* all = a.part + (size_t)bh * nj * G * (D + 4);
  if (tid < D) {
    const float nv = sv[tid];  // the new V in the pool's type (i8: codes)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = -INFINITY;
      for (int jj = 0; jj <= hi; ++jj)
        mx = fmaxf(mx, __ldcg(all + ((size_t)jj * G + g) * (D + 4)));
      float st = 0.f, rt = 0.f, o = 0.f;
      for (int jj = 0; jj <= hi; ++jj) {
        const float* pj = all + ((size_t)jj * G + g) * (D + 4);
        const float mj = __ldcg(pj);
        if (mj == -INFINITY) continue;  // no ok row in block jj
        const float w = expf(mj - mx);
        st += __ldcg(pj + 1) * w;
        rt += __ldcg(pj + 2) * w;
        o += __ldcg(pj + 4 + tid) * w;
      }
      const float den = fmaxf(st, 1e-30f);
      float pr = rt / den;
      if constexpr (kQuant) pr *= new_sv;
      o = o / den + cdt_round<T>(pr) * nv;
      p.out[(size_t)b * p.heads * D + (size_t)(h * G + g) * D + tid] = o;
    }
  }
  if (tid == 0) a.ticket[bh] = 0;
}

#define GEMMA_SBLOCK_KERNEL(NAME, T)                                        \
  template <int D, int G>                                                   \
  __global__ void __launch_bounds__(SB_WARPS * 32) NAME(SblockArgs a) {     \
    sblocked_body<T, D, G>(a);                                              \
  }
GEMMA_SBLOCK_KERNEL(decode_sblocked_i8_kernel, int8_t)
GEMMA_SBLOCK_KERNEL(decode_sblocked_bf16_kernel, __nv_bfloat16)
GEMMA_SBLOCK_KERNEL(decode_sblocked_f32_kernel, float)
#undef GEMMA_SBLOCK_KERNEL

template <typename T, int D, int G>
static void launch_sb(const SblockArgs& a, int batch, cudaStream_t st) {
  const dim3 grid(batch * a.d.kvh * (a.d.s_alloc / a.bs)), block(SB_WARPS * 32);
  if constexpr (std::is_same<T, int8_t>::value)
    decode_sblocked_i8_kernel<D, G><<<grid, block, 0, st>>>(a);
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
    decode_sblocked_bf16_kernel<D, G><<<grid, block, 0, st>>>(a);
  else
    decode_sblocked_f32_kernel<D, G><<<grid, block, 0, st>>>(a);
}

template <typename T>
static int sblocked(const float* q, const void* knew, const void* vnew,
                    int new_bs, int new_hs, const float* nsc,
                    const float* inv_ts, const float* knorm,
                    const float* qnorm, T* pool, float* scales, const int* pos,
                    const bool* valid, float* out, int batch, int n_layers,
                    int layer, int kvh, int heads, int s_alloc, int d,
                    int ring, int window, int q_bs, int pe_mode, float qscale,
                    float att_cap, float* part, int* ticket, int s_block,
                    int* launched, cudaStream_t st) {
  *launched = 0;
  if ((pe_mode >= 0) != (inv_ts != nullptr) || s_block <= 0 ||
      s_alloc % s_block != 0 || heads % kvh != 0)
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
  a.bs = s_block;
  const int g = heads / kvh;
  if (d == 256 && g == 2) launch_sb<T, 256, 2>(a, batch, st);
  else if (d == 256 && g == 1) launch_sb<T, 256, 1>(a, batch, st);
  else if (d == 256 && g == 4) launch_sb<T, 256, 4>(a, batch, st);
  else if (d == 128 && g == 2) launch_sb<T, 128, 2>(a, batch, st);
  else if (d == 128 && g == 1) launch_sb<T, 128, 1>(a, batch, st);
  else if (d == 128 && g == 4) launch_sb<T, 128, 4>(a, batch, st);
  else return (int)cudaErrorInvalidValue;
  *launched = 1;
  return (int)cudaGetLastError();
}

// K11: K8's parameters, then the partials [B, KVH, s_alloc / s_block, G,
// D + 4], the [B * KVH] tickets and the block's rows.
extern "C" int gemma_decode_sblocked_i8(
    const float* q, const void* knew, const void* vnew, int new_bs,
    int new_hs, const float* nsc, const float* inv_ts, const float* knorm,
    const float* qnorm, int8_t* pool, float* scales, const int* pos,
    const bool* valid, float* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window, int q_bs,
    int pe_mode, float qscale, float att_cap, float* part, int* ticket,
    int s_block, int* launched, cudaStream_t st) {
  return sblocked(q, knew, vnew, new_bs, new_hs, nsc, inv_ts, knorm, qnorm,
                  pool, scales, pos, valid, out, batch, n_layers, layer, kvh,
                  heads, s_alloc, d, ring, window, q_bs, pe_mode, qscale,
                  att_cap, part, ticket, s_block, launched, st);
}

extern "C" int gemma_decode_sblocked_bf16(
    const float* q, const void* knew, const void* vnew, int new_bs,
    int new_hs, const float* nsc, const float* inv_ts, const float* knorm,
    const float* qnorm, __nv_bfloat16* pool, float* scales, const int* pos,
    const bool* valid, float* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window, int q_bs,
    int pe_mode, float qscale, float att_cap, float* part, int* ticket,
    int s_block, int* launched, cudaStream_t st) {
  return sblocked(q, knew, vnew, new_bs, new_hs, nsc, inv_ts, knorm, qnorm,
                  pool, scales, pos, valid, out, batch, n_layers, layer, kvh,
                  heads, s_alloc, d, ring, window, q_bs, pe_mode, qscale,
                  att_cap, part, ticket, s_block, launched, st);
}

extern "C" int gemma_decode_sblocked_f32(
    const float* q, const void* knew, const void* vnew, int new_bs,
    int new_hs, const float* nsc, const float* inv_ts, const float* knorm,
    const float* qnorm, float* pool, float* scales, const int* pos,
    const bool* valid, float* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window, int q_bs,
    int pe_mode, float qscale, float att_cap, float* part, int* ticket,
    int s_block, int* launched, cudaStream_t st) {
  return sblocked(q, knew, vnew, new_bs, new_hs, nsc, inv_ts, knorm, qnorm,
                  pool, scales, pos, valid, out, batch, n_layers, layer, kvh,
                  heads, s_alloc, d, ring, window, q_bs, pe_mode, qscale,
                  att_cap, part, ticket, s_block, launched, st);
}
