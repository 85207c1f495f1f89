// Fused decode attention over an int8 KV ring for Hopper (sm_90a): K4.
//
// Replaces gemma_tpu/ops/decode_attention.py:_decode_fused_packed_kernel
// (i8 variant, called through _decode_fused_packed_q_pallas).  Per batch
// row b and KV head h, from the qkv GEMM's f32 row (q heads kv-major,
// then per-KV-head interleaved K, V):
//   1. optional (1 + w) RMSNorms of k and q, RoPE or half-RoPE (query
//      scale folded in as _pe_apply does), int8 quantization of the new
//      K and V rows (scale = amax/127, inv = 0 when the scale is 0, codes
//      rounded half to even), written in place at ring row pos % ring
//      (or the garbage row `ring` for an invalid slot) with
//      their scale lanes;
//   2. attention of the G query heads over the ring with the new row
//      substituted: scores (bf16 q . codes) * scale_k, soft cap, window
//      mask, an exact softmax (pass 1 finds each row's max and
//      denominator, pass 2 recomputes the scores), probabilities *
//      scale_v rounded to bf16 before the V product, bf16 out [B, H*D].
// Rows the mask rules out (outside the window, or never written yet) are
// skipped: the walk covers absolute positions
// max(pos-window+1, pos-ring+1, 0)..pos.  No panel is staged whole, so
// this kernel serves every ring length.
//
// Design: one thread-block cluster of CL = 8 blocks per (b, h), 16 warps
// each; warp w of rank r takes every 128th live position from r*16 + w.
// The clusters combine pass 1's (max, denominator) and pass 2's partial
// outputs through distributed shared memory, so the exact softmax stays
// one launch.  Every block encodes the new row; rank 0 alone writes it,
// and every block substitutes it in-compute where s == row, so no block
// reads a row another block is writing.
//
// What bounds it on an H100: bytes.  Per call it must read the live K and
// V codes and scales, (2*D + 8) bytes per live row per (b, h), plus the
// qkv row and the output; at B=4, 4 KV heads, D=256 and 700 live rows
// that is 5.8 MB -> 1.7 us at 3.35 TB/s.  This design reads K twice and
// runs B*KVH*8 blocks; a single online-softmax pass and vectorized row
// loads are left for later.  Built with -fmad=false so RoPE and the
// norms round like the plain version's separate multiplies and adds.

#include <cooperative_groups.h>

#include "common.cuh"

using namespace gemma;

struct DecArgs {
  const float* qkv;     // [B, (heads + 2*kvh) * D]
  const float* inv_ts;  // [D/2] (rope) or [D/4] (half rope)
  const float* knorm;   // [D] or null
  const float* qnorm;   // [D] or null
  int8_t* pool;         // [B, NL, 2, KVH, S_alloc, D]
  float* scales;        // [B, NL, 2, KVH, 1, S_alloc]
  const int* pos;       // [B] position of the new token
  const bool* valid;    // [B] or null; an invalid slot writes the garbage row
  __nv_bfloat16* out;   // [B, heads*D]
  int n_layers, layer, kvh, heads, s_alloc, ring, window, pe_mode;
  float qscale, att_cap;
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
      const float s = sinf(theta), c = cosf(theta);
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
      const float s = sinf(theta), c = cosf(theta);
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

// Warps per block: 16, or 8 at G = 4 so the [NW][G][D] partial sums fit
// 32 KB of shared memory.
template <int G>
__host__ __device__ constexpr int dec_warps() { return G >= 4 ? 8 : 16; }

// Blocks per (b, h): one thread-block cluster, which splits the live rows
// and combines through distributed shared memory.
constexpr int CL = 8;

template <int D, int G>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(dec_warps<G>() * 32)
    decode_attention_i8_kernel(DecArgs p) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int NW = dec_warps<G>();
  constexpr int DPL = D / 32;  // elements per lane
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / CL;
  const int b = bh / p.kvh, h = bh % p.kvh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  __shared__ float sk[D], sv[D], sq[G * D];
  __shared__ float red[32];
  __shared__ float wm[NW][G], wl[NW][G];
  __shared__ float acc_s[NW][G][D];
  __shared__ float cm[G], cl[G];  // this block's pass-1 max and denominator
  __shared__ float part[G * D];   // this block's share of the output

  const size_t row_len = (size_t)(p.heads + 2 * p.kvh) * D;
  const float* qkv = p.qkv + b * row_len;
  if (tid < D) {
    sk[tid] = qkv[(size_t)(p.heads + 2 * h) * D + tid];
    sv[tid] = qkv[(size_t)(p.heads + 2 * h + 1) * D + tid];
  }
  for (int i = tid; i < G * D; i += blockDim.x) sq[i] = qkv[(size_t)h * G * D + i];
  __syncthreads();

  // Every block of the cluster encodes the new row (cheap: D values);
  // rank 0 writes it, and every block substitutes it where s == row
  // instead of reading the panel, so no block waits for another's write.
  const int pos = p.pos[b];
  if (p.knorm != nullptr) norm_row<D, NW>(sk, p.knorm, red);
  rope_rows<D>(sk, 1, pos, p.inv_ts, p.pe_mode, 1.0f);
  if (p.qnorm != nullptr)
    for (int g = 0; g < G; ++g) norm_row<D, NW>(sq + g * D, p.qnorm, red);
  rope_rows<D>(sq, G, pos, p.inv_ts, p.pe_mode, p.qscale);

  const size_t plane = (size_t)p.s_alloc * D;  // one (b, l, kv, h) panel
  const size_t kbase = ((((size_t)b * p.n_layers + p.layer) * 2 + 0) * p.kvh + h);
  const size_t vbase = ((((size_t)b * p.n_layers + p.layer) * 2 + 1) * p.kvh + h);
  int8_t* kpan = p.pool + kbase * plane;
  int8_t* vpan = p.pool + vbase * plane;
  float* ksc = p.scales + kbase * p.s_alloc;
  float* vsc = p.scales + vbase * p.s_alloc;
  const int row = (p.valid == nullptr || p.valid[b]) ? pos % p.ring : p.ring;
  const float ka = block_reduce<NW, true>(tid < D ? fabsf(sk[tid]) : 0.f, red);
  const float va = block_reduce<NW, true>(tid < D ? fabsf(sv[tid]) : 0.f, red);
  const float new_sk = ka / 127.0f, new_sv = va / 127.0f;
  if (tid < D) {
    const float ck = rintf(sk[tid] * (new_sk > 0.f ? 1.0f / new_sk : 0.f));
    const float cv = rintf(sv[tid] * (new_sv > 0.f ? 1.0f / new_sv : 0.f));
    if (rank == 0) {
      kpan[(size_t)row * D + tid] = (int8_t)ck;
      vpan[(size_t)row * D + tid] = (int8_t)cv;
    }
    sk[tid] = ck;  // the new row's codes, as exact floats
    sv[tid] = cv;
  }
  if (rank == 0 && tid == 0) {
    ksc[row] = new_sk;
    vsc[row] = new_sv;
  }
  for (int i = tid; i < G * D; i += blockDim.x) sq[i] = bf16_round(sq[i]);
  __syncthreads();

  float qr[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) qr[g][i] = sq[g * D + lane * DPL + i];

  const int p_hi = pos;
  const int p_lo = max(max(pos - p.window + 1, pos - p.ring + 1), 0);
  const int first = p_lo + rank * NW + warp;  // this warp's rows: every
  constexpr int STEP = CL * NW;               // STEP-th live position
  const float cap = p.att_cap;

  auto load_codes = [&](const int8_t* pan, const float* fresh, int s, float* c) {
    if (s == row) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) c[i] = fresh[lane * DPL + i];
      return;
    }
    const int8_t* src = pan + (size_t)s * D + lane * DPL;
    if constexpr (DPL == 8) {
      const uint2 w = *reinterpret_cast<const uint2*>(src);
      i8x4_to_f32(w.x, c);
      i8x4_to_f32(w.y, c + 4);
    } else {
      i8x4_to_f32(*reinterpret_cast<const uint32_t*>(src), c);
    }
  };
  auto score = [&](int s, float* out_sc) {
    float c[DPL];
    load_codes(kpan, sk, s, c);
    const float sk_s = s == row ? new_sk : ksc[s];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) d += qr[g][i] * c[i];
      float v = warp_sum(d) * sk_s;
      if (cap != 0.f) v = cap * tanhf(v / cap);
      out_sc[g] = v;
    }
  };

  // Pass 1: per-row max and softmax denominator over this block's rows,
  // then over the cluster.
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) { m[g] = -INFINITY; l[g] = 0.f; }
#pragma unroll 4
  for (int pp = first; pp <= p_hi; pp += STEP) {
    float sc[G];
    score(pp % p.ring, sc);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mn = fmaxf(m[g], sc[g]);
      l[g] = l[g] * expf(m[g] - mn) + expf(sc[g] - mn);
      m[g] = mn;
    }
  }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) { wm[warp][g] = m[g]; wl[warp][g] = l[g]; }
  __syncthreads();
  if (tid < G) {
    float mm = -INFINITY, ll = 0.f;
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, wm[w][tid]);
    for (int w = 0; w < NW; ++w)
      if (wl[w][tid] > 0.f) ll += wl[w][tid] * expf(wm[w][tid] - mm);
    cm[tid] = mm;
    cl[tid] = ll;
  }
  cluster.sync();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mm = -INFINITY, ll = 0.f;
    for (int r = 0; r < CL; ++r) mm = fmaxf(mm, cluster.map_shared_rank(cm, r)[g]);
    for (int r = 0; r < CL; ++r) {
      const float lr = cluster.map_shared_rank(cl, r)[g];
      if (lr > 0.f) ll += lr * expf(cluster.map_shared_rank(cm, r)[g] - mm);
    }
    m[g] = mm;
    l[g] = ll;
  }

  // Pass 2: normalized probabilities * scale_v, rounded to bf16, times V.
  float acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
#pragma unroll 4
  for (int pp = first; pp <= p_hi; pp += STEP) {
    const int s = pp % p.ring;
    float sc[G];
    score(s, sc);
    float c[DPL];
    load_codes(vpan, sv, s, c);
    const float sv_s = s == row ? new_sv : vsc[s];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pr = bf16_round(expf(sc[g] - m[g]) / l[g] * sv_s);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] += pr * c[i];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc_s[warp][g][lane * DPL + i] = acc[g][i];
  __syncthreads();
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float o = 0.f;
      for (int w = 0; w < NW; ++w) o += acc_s[w][g][tid];
      part[g * D + tid] = o;
    }
  }
  cluster.sync();
  if (rank == 0 && tid < D) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float o = 0.f;
      for (int r = 0; r < CL; ++r) o += cluster.map_shared_rank(part, r)[g * D + tid];
      if (!(l[g] > 0.f)) o = 0.f;
      p.out[(size_t)b * p.heads * D + (size_t)(h * G + g) * D + tid] = __float2bfloat16_rn(o);
    }
  }
  cluster.sync();  // keep every block's shared memory alive until rank 0 has read it
}

template <int D, int G>
static void launch_dec(const DecArgs& p, int batch, cudaStream_t st) {
  decode_attention_i8_kernel<D, G><<<batch * p.kvh * CL, dec_warps<G>() * 32, 0, st>>>(p);
}

extern "C" int gemma_decode_attention_i8(
    const float* qkv, const float* inv_ts, const float* knorm,
    const float* qnorm, int8_t* pool, float* scales, const int* pos,
    const bool* valid, __nv_bfloat16* out, int batch, int n_layers, int layer,
    int kvh, int heads, int s_alloc, int d, int ring, int window,
    int pe_mode, float qscale, float att_cap, int* launched,
    cudaStream_t st) {
  *launched = 0;
  DecArgs p = {qkv, inv_ts, knorm, qnorm, pool, scales, pos, valid, out,
               n_layers, layer, kvh, heads, s_alloc, ring, window, pe_mode,
               qscale, att_cap};
  const int g = heads / kvh;
  if (d == 256 && g == 2) launch_dec<256, 2>(p, batch, st);
  else if (d == 256 && g == 1) launch_dec<256, 1>(p, batch, st);
  else if (d == 256 && g == 4) launch_dec<256, 4>(p, batch, st);
  else if (d == 128 && g == 2) launch_dec<128, 2>(p, batch, st);
  else if (d == 128 && g == 1) launch_dec<128, 1>(p, batch, st);
  else if (d == 128 && g == 4) launch_dec<128, 4>(p, batch, st);
  else return (int)cudaErrorInvalidValue;
  *launched = 1;
  return (int)cudaGetLastError();
}
