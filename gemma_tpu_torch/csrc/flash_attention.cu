// Prefill attention over an int8 KV ring for Hopper (sm_90a): K5.
//
// Replaces gemma_tpu/ops/flash_attention.py:_flash_kernel (i8 variant,
// called through _flash_pallas).  q is [B, KVH, T*G, D] f32 with t-major
// rows (row = t*G + g); the output has the same layout, f32.  For every
// query row at position qpos = base[b] + row/G, keys are ring rows s with
// absolute position key_abs (rebuilt from newest[b]) attendable iff
//   qpos - min(window-1, qpos) <= key_abs <= max(qpos, prefix_end[b]-1),
//   key_abs >= 0 and s < ring,
// as flash_attention.py:78-91.  Scores are (bf16 q . codes) * scale_k,
// soft-capped; scale_v multiplies the probabilities (not the
// denominator), which round to bf16 before the V product.  The softmax is
// exact: pass 1 walks the key tiles for each row's max and denominator,
// pass 2 recomputes the scores and accumulates normalized probabilities
// times V.  A fully masked row gives 0, never NaN.  Keys are read by
// absolute position, only over the range the block's rows can attend, so
// rows past the live ring and outside every window cost nothing and no
// garbage row, scale or code past `ring` is ever read (the 0*NaN hazard
// of flash_attention.py:70-76 cannot arise).
//
// Grid: (T*G/32 row tiles, KVH, B); 256 threads; 32 query rows and 64
// keys per tile, staged in shared memory; scores and P.V on CUDA cores
// in f32 (codes to f32 by byte permutes, common.cuh).  What bounds it on
// an H100: operations.  Per (b, h) it does
// 2 * 2 * rows * live_keys * D multiply-adds in the unmasked region
// (q.k and p.v), ~2 * 2 * 1024 * 700 * 256 = 0.73 GFLOP for a 512-token
// chunk of G=2 over 700 live rows, 12 GFLOP over B=4, KVH=4: 12 us at the
// bf16 tensor-core rate.  This first kernel uses CUDA cores (67 TFLOP/s
// f32 peak) and reads K twice; mma.sync/wgmma tiles for QK^T and PV, a
// single online-softmax pass and causal tile skipping are left for later.

#include "common.cuh"

using namespace gemma;

constexpr int FR = 32;  // query rows per block
constexpr int FS = 64;  // keys per tile

struct FlashArgs {
  const float* q;       // [B, KVH, TG, D]
  const int8_t* pool;   // [B, NL, 2, KVH, S_alloc, D]
  const float* scales;  // [B, NL, 2, KVH, 1, S_alloc]
  const int* base;      // [B] position of the chunk's first query
  const int* newest;    // [B] newest position written this step
  const int* prefix_end;  // [B]
  float* out;           // [B, KVH, TG, D]
  int n_layers, layer, kvh, tg, groups, s_alloc, ring, window;
  float att_cap;
};

template <int D>
constexpr int flash_smem_bytes() {
  return FR * (D + 4) * 4 + FS * (D + 4) + FS * D + FR * (FS + 1) * 4 + 3 * FS * 4;
}

template <int D>
__global__ void __launch_bounds__(256) flash_attention_i8_kernel(FlashArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);                  // [FR][D+4]
  int8_t* sK = reinterpret_cast<int8_t*>(sQ + FR * (D + 4));   // [FS][D+4]
  int8_t* sV = sK + FS * (D + 4);                              // [FS][D]
  float* sP = reinterpret_cast<float*>(sV + FS * D);           // [FR][FS+1]
  float* sSk = sP + FR * (FS + 1);                             // [FS]
  float* sSv = sSk + FS;                                       // [FS]
  int* sAbs = reinterpret_cast<int*>(sSv + FS);                // [FS], -1 = none

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * FR, h = blockIdx.y, b = blockIdx.z;
  const int tg = p.tg, G = p.groups;
  const int base = p.base[b], newest = p.newest[b], pe = p.prefix_end[b];

  const size_t qoff = (((size_t)b * p.kvh + h) * tg) * D;
  for (int i = tid; i < FR * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    sQ[r * (D + 4) + d] = (r0 + r < tg) ? bf16_round(p.q[qoff + (size_t)(r0 + r) * D + d]) : 0.f;
  }

  // This thread's two query rows: ty and ty + 16.
  int start[2], last[2];
  bool live[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int rr = r0 + ty + 16 * u;
    live[u] = rr < tg;
    const int qpos = base + (live[u] ? rr : 0) / G;
    start[u] = qpos - min(p.window - 1, qpos);
    last[u] = max(qpos, pe - 1);
  }
  const int rlast = min(r0 + FR, tg) - 1;
  const int qlo = base + r0 / G, qhi = base + rlast / G;
  const int p_lo = max(max(qlo - min(p.window - 1, qlo), newest - p.ring + 1), 0);
  const int p_hi = min(max(qhi, pe - 1), newest);

  const size_t plane = (size_t)p.s_alloc * D;
  const size_t kidx = (((size_t)b * p.n_layers + p.layer) * 2 + 0) * p.kvh + h;
  const size_t vidx = (((size_t)b * p.n_layers + p.layer) * 2 + 1) * p.kvh + h;
  const int8_t* kpan = p.pool + kidx * plane;
  const int8_t* vpan = p.pool + vidx * plane;
  const float* ksc = p.scales + kidx * p.s_alloc;
  const float* vsc = p.scales + vidx * p.s_alloc;
  const float cap = p.att_cap;

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  constexpr int DC = D / 64;  // 4-wide d chunks per thread in P.V
  float acc[2][DC][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][c][e] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int p0 = p_lo; p0 <= p_hi; p0 += FS) {
      __syncthreads();  // previous tile fully consumed (and sQ written)
      if (tid < FS) {
        const int pp = p0 + tid;
        const bool ok = pp <= p_hi;
        const int s = ok ? pp % p.ring : 0;
        sAbs[tid] = ok ? pp : -1;
        sSk[tid] = ok ? ksc[s] : 0.f;
        sSv[tid] = ok ? vsc[s] : 0.f;
      }
      // K (and in pass 2 V) codes, 4 bytes per thread per step.
      for (int i = tid; i < FS * D / 4; i += blockDim.x) {
        const int kk = i / (D / 4), w = i % (D / 4);
        const int pp = p0 + kk;
        uint32_t kw = 0, vw = 0;
        if (pp <= p_hi) {
          const size_t off = (size_t)(pp % p.ring) * D + 4 * w;
          kw = *reinterpret_cast<const uint32_t*>(kpan + off);
          if (pass == 1) vw = *reinterpret_cast<const uint32_t*>(vpan + off);
        }
        *reinterpret_cast<uint32_t*>(sK + kk * (D + 4) + 4 * w) = kw;
        if (pass == 1) *reinterpret_cast<uint32_t*>(sV + kk * D + 4 * w) = vw;
      }
      __syncthreads();

      // Scores for rows {ty, ty+16} x keys {tx + 16j}.
      float sc[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[u][j] = 0.f;
      for (int d = 0; d < D; d += 4) {
        const float4 q0 = *reinterpret_cast<const float4*>(sQ + ty * (D + 4) + d);
        const float4 q1 = *reinterpret_cast<const float4*>(sQ + (ty + 16) * (D + 4) + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float c[4];
          i8x4_to_f32(*reinterpret_cast<const uint32_t*>(sK + (tx + 16 * j) * (D + 4) + d), c);
          sc[0][j] += q0.x * c[0] + q0.y * c[1] + q0.z * c[2] + q0.w * c[3];
          sc[1][j] += q1.x * c[0] + q1.y * c[1] + q1.z * c[2] + q1.w * c[3];
        }
      }
      bool ok[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        const int ka = sAbs[kk];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v = sc[u][j] * sSk[kk];
          if (cap != 0.f) v = cap * tanhf(v / cap);
          sc[u][j] = v;
          ok[u][j] = live[u] && ka >= 0 && ka >= start[u] && ka <= last[u];
        }
      }

      if (pass == 0) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (ok[u][j]) mx = fmaxf(mx, sc[u][j]);
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float mn = fmaxf(m[u], mx);
          float e = 0.f;
          if (mn != -INFINITY) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (ok[u][j]) e += expf(sc[u][j] - mn);
          }
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
          if (mn != -INFINITY) {
            l[u] = l[u] * expf(m[u] - mn) + e;
            m[u] = mn;
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kk = tx + 16 * j;
            const float pr = (ok[u][j] && l[u] > 0.f)
                                 ? bf16_round(expf(sc[u][j] - m[u]) / l[u] * sSv[kk])
                                 : 0.f;
            sP[(ty + 16 * u) * (FS + 1) + kk] = pr;
          }
        __syncthreads();
        for (int kk = 0; kk < FS; ++kk) {
          const float p0v = sP[ty * (FS + 1) + kk];
          const float p1v = sP[(ty + 16) * (FS + 1) + kk];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            float v[4];
            i8x4_to_f32(*reinterpret_cast<const uint32_t*>(sV + kk * D + 64 * c + 4 * tx), v);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[0][c][e] += p0v * v[e];
              acc[1][c][e] += p1v * v[e];
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (!live[u]) continue;
    float* o = p.out + qoff + (size_t)(r0 + ty + 16 * u) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      *reinterpret_cast<float4*>(o + 64 * c + 4 * tx) =
          make_float4(acc[u][c][0], acc[u][c][1], acc[u][c][2], acc[u][c][3]);
  }
}

template <int D>
static int launch_flash(const FlashArgs& p, int batch, int* launched,
                        cudaStream_t st) {
  constexpr int bytes = flash_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_attention_i8_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.tg + FR - 1) / FR, p.kvh, batch);
  flash_attention_i8_kernel<D><<<grid, 256, bytes, st>>>(p);
  *launched = 1;
  return (int)cudaGetLastError();
}

extern "C" int gemma_flash_attention_i8(
    const float* q, const int8_t* pool, const float* scales, const int* base,
    const int* newest, const int* prefix_end, float* out, int batch,
    int n_layers, int layer, int kvh, int tg, int groups, int s_alloc, int d,
    int ring, int window, float att_cap, int* launched, cudaStream_t st) {
  *launched = 0;
  FlashArgs p = {q, pool, scales, base, newest, prefix_end, out, n_layers,
                 layer, kvh, tg, groups, s_alloc, ring, window, att_cap};
  if (d == 256) return launch_flash<256>(p, batch, launched, st);
  if (d == 128) return launch_flash<128>(p, batch, launched, st);
  return (int)cudaErrorInvalidValue;
}
