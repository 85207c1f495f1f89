// Fused decode attention over a KV ring for Hopper (sm_90a): K4.
//
// Replaces gemma_tpu/ops/decode_attention.py:_decode_fused_packed_kernel
// over an i8 pool (called through _decode_fused_packed_q_pallas) and over
// a bf16 or f32 pool (_decode_fused_packed_pallas).  Per batch row b and
// KV head h, from the qkv GEMM's f32 row (q heads kv-major, then
// per-KV-head interleaved K, V):
//   1. optional (1 + w) RMSNorms of k and q, RoPE or half-RoPE (query
//      scale folded in as _pe_apply does), then the new K and V rows in
//      the pool's type, written in place at ring row pos % ring (or the
//      garbage row `ring` for an invalid slot): i8 codes (scale =
//      amax/127, inv = 0 when the scale is 0, codes rounded half to even)
//      with their scale lanes, or the rows rounded to bf16, or as they are;
//   2. attention of the G query heads over the ring with the new row
//      substituted: scores q . k (times scale_k for i8), soft cap, window
//      mask, an exact softmax (pass 1 finds each row's max and
//      denominator, pass 2 recomputes the scores), probabilities (times
//      scale_v for i8) rounded to the compute type before the V product,
//      bf16 out [B, H*D].  The compute type is f32 for an f32 pool and
//      bf16 otherwise (decode_attention.py:662-663): q, the new row and the
//      probabilities round to it.
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
// V rows, 2*D*sizeof(T) bytes per live row per (b, h) (+ 8 for i8's
// scales), plus the qkv row and the output; at B=4, 4 KV heads, D=256 and
// 700 live rows that is 5.8 MB (i8), 11.5 MB (bf16) or 23 MB (f32) ->
// 1.7, 3.4 or 6.9 us at 3.35 TB/s.  This design reads K twice and runs
// B*KVH*8 blocks; a single online-softmax pass is left for later.  Built
// with -fmad=false so RoPE and the norms round like the plain version's
// separate multiplies and adds.

#include <cooperative_groups.h>

#include "common.cuh"

using namespace gemma;

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

template <typename T, int D, int G>
__device__ __forceinline__ void decode_attention_body(const DecArgs& p) {
  namespace cg = cooperative_groups;
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
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
    if (rank == 0 && tid == 0) {
      p.scales[kbase * p.s_alloc + row] = new_sk;
      p.scales[vbase * p.s_alloc + row] = new_sv;
    }
  } else if (tid < D) {
    sk[tid] = cdt_round<T>(sk[tid]);  // the row in the pool's type
    sv[tid] = cdt_round<T>(sv[tid]);
  }
  if (tid < D && rank == 0) {
    kpan[(size_t)row * D + tid] = from_f32<T>(sk[tid]);
    vpan[(size_t)row * D + tid] = from_f32<T>(sv[tid]);
  }
  for (int i = tid; i < G * D; i += blockDim.x) sq[i] = cdt_round<T>(sq[i]);
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
  const float* ksc = kQuant ? p.scales + kbase * p.s_alloc : nullptr;
  const float* vsc = kQuant ? p.scales + vbase * p.s_alloc : nullptr;

  auto load_row = [&](const T* pan, const float* fresh, int s, float* c) {
    if (s == row) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) c[i] = fresh[lane * DPL + i];
      return;
    }
    const T* src = pan + (size_t)s * D + lane * DPL;
#pragma unroll
    for (int i = 0; i < DPL; i += 4) ld4(src + i, c + i);
  };
  auto score = [&](int s, float* out_sc) {
    float c[DPL];
    load_row(kpan, sk, s, c);
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

  // Pass 2: normalized probabilities (* scale_v for i8), rounded to the
  // compute type, times V.
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
    load_row(vpan, sv, s, c);
    const float sv_s = kQuant ? (s == row ? new_sv : vsc[s]) : 1.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float pr = expf(sc[g] - m[g]) / l[g];
      if constexpr (kQuant) pr *= sv_s;
      pr = cdt_round<T>(pr);
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

// One kernel name per pool type, so a profiler trace tells them apart.
template <int D, int G>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(dec_warps<G>() * 32)
    decode_attention_i8_kernel(DecArgs p) {
  decode_attention_body<int8_t, D, G>(p);
}
template <int D, int G>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(dec_warps<G>() * 32)
    decode_attention_bf16_kernel(DecArgs p) {
  decode_attention_body<__nv_bfloat16, D, G>(p);
}
template <int D, int G>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(dec_warps<G>() * 32)
    decode_attention_f32_kernel(DecArgs p) {
  decode_attention_body<float, D, G>(p);
}

template <typename T, int D, int G>
static void launch_dec(const DecArgs& p, int batch, cudaStream_t st) {
  const dim3 grid(batch * p.kvh * CL), block(dec_warps<G>() * 32);
  if constexpr (std::is_same<T, int8_t>::value)
    decode_attention_i8_kernel<D, G><<<grid, block, 0, st>>>(p);
  else if constexpr (std::is_same<T, __nv_bfloat16>::value)
    decode_attention_bf16_kernel<D, G><<<grid, block, 0, st>>>(p);
  else
    decode_attention_f32_kernel<D, G><<<grid, block, 0, st>>>(p);
}

template <typename T>
static int dispatch_dec(const DecArgs& p, int batch, int d, int* launched,
                        cudaStream_t st) {
  *launched = 0;
  const int g = p.heads / p.kvh;
  if (d == 256 && g == 2) launch_dec<T, 256, 2>(p, batch, st);
  else if (d == 256 && g == 1) launch_dec<T, 256, 1>(p, batch, st);
  else if (d == 256 && g == 4) launch_dec<T, 256, 4>(p, batch, st);
  else if (d == 128 && g == 2) launch_dec<T, 128, 2>(p, batch, st);
  else if (d == 128 && g == 1) launch_dec<T, 128, 1>(p, batch, st);
  else if (d == 128 && g == 4) launch_dec<T, 128, 4>(p, batch, st);
  else return (int)cudaErrorInvalidValue;
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
  return dispatch_dec<int8_t>(p, batch, d, launched, st);
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
  return dispatch_dec<__nv_bfloat16>(p, batch, d, launched, st);
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
  return dispatch_dec<float>(p, batch, d, launched, st);
}
