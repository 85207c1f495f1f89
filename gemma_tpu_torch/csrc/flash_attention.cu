// Prefill attention over a KV ring for Hopper (sm_90a): K5.
//
// Replaces gemma_tpu/ops/flash_attention.py:_flash_kernel (called through
// _flash_pallas) over an i8, bf16 or f32 pool.  q is [B, KVH, T*G, D] f32
// with t-major rows (row = t*G + g); the output has the same layout, f32.
// For every query row at position qpos = base[b] + row/G, keys are ring
// rows s with absolute position key_abs (rebuilt from newest[b])
// attendable iff
//   qpos - min(window-1, qpos) <= key_abs <= max(qpos, prefix_end[b]-1),
//   key_abs >= 0 and s < ring,
// as flash_attention.py:78-91.  The compute type is f32 for an f32 pool
// and bf16 otherwise (flash_attention.py:65-69): q rounds to it.  Scores
// are q . k (times scale_k for i8 codes), soft-capped; scale_v multiplies
// the probabilities (not the denominator), which round to the compute
// type before the V product.  The softmax is exact: pass 1 walks the key
// tiles for each row's max and denominator, pass 2 recomputes the scores
// and accumulates normalized probabilities times V.  A fully masked row
// gives 0, never NaN.  Keys are read by absolute position, only over the
// range the block's rows can attend, so rows past the live ring and
// outside every window cost nothing and no garbage row, scale or key past
// `ring` is ever read (the 0*NaN hazard of flash_attention.py:70-76 cannot
// arise).
//
// Grid: (T*G/32 row tiles, KVH, B); 256 threads; 32 query rows and 64
// keys per tile, staged in shared memory in the pool's type; scores and
// P.V on CUDA cores in f32 (i8 codes to f32 by byte permutes, bf16 by a
// shift; common.cuh).  What bounds it on an H100: operations.  Per (b, h)
// it does 2 * 2 * rows * live_keys * D multiply-adds in the unmasked
// region (q.k and p.v), ~2 * 2 * 1024 * 700 * 256 = 0.73 GFLOP for a
// 512-token chunk of G=2 over 700 live rows, 12 GFLOP over B=4, KVH=4:
// 12 us at the bf16 tensor-core rate.  This first kernel uses CUDA cores
// (67 TFLOP/s f32 peak) and reads K twice; mma.sync/wgmma tiles for QK^T
// and PV, a single online-softmax pass and causal tile skipping are left
// for later.

#include "common.cuh"

using namespace gemma;

constexpr int FR = 32;  // query rows per block
constexpr int FS = 64;  // keys per tile

struct FlashArgs {
  const float* q;       // [B, KVH, TG, D]
  const void* pool;     // [B, NL, 2, KVH, S_alloc, D] of the pool's type
  const float* scales;  // [B, NL, 2, KVH, 1, S_alloc] (i8 pools), else null
  const int* base;      // [B] position of the chunk's first query
  const int* newest;    // [B] newest position written this step
  const int* prefix_end;  // [B]
  float* out;           // [B, KVH, TG, D]
  int n_layers, layer, kvh, tg, groups, s_alloc, ring, window;
  float att_cap;
};

// Four pool elements copied as one word (4, 8 or 16 bytes).
template <typename T> struct Word4;
template <> struct Word4<int8_t> { using type = uint32_t; };
template <> struct Word4<__nv_bfloat16> { using type = uint2; };
template <> struct Word4<float> { using type = uint4; };

template <typename T, int D>
constexpr int flash_smem_bytes() {
  return FR * (D + 4) * 4 + FS * (D + 4) * (int)sizeof(T) + FS * D * (int)sizeof(T)
         + FR * (FS + 1) * 4 + 3 * FS * 4;
}

template <typename T, int D>
__device__ __forceinline__ void flash_attention_body(const FlashArgs& p) {
  using W = typename Word4<T>::type;
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);        // [FR][D+4]
  T* sK = reinterpret_cast<T*>(sQ + FR * (D + 4));   // [FS][D+4]
  T* sV = sK + FS * (D + 4);                         // [FS][D]
  float* sP = reinterpret_cast<float*>(sV + FS * D); // [FR][FS+1]
  float* sSk = sP + FR * (FS + 1);                   // [FS]
  float* sSv = sSk + FS;                             // [FS]
  int* sAbs = reinterpret_cast<int*>(sSv + FS);      // [FS], -1 = none

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * FR, h = blockIdx.y, b = blockIdx.z;
  const int tg = p.tg, G = p.groups;
  const int base = p.base[b], newest = p.newest[b], pe = p.prefix_end[b];

  const size_t qoff = (((size_t)b * p.kvh + h) * tg) * D;
  for (int i = tid; i < FR * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    sQ[r * (D + 4) + d] = (r0 + r < tg) ? cdt_round<T>(p.q[qoff + (size_t)(r0 + r) * D + d]) : 0.f;
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
  const T* kpan = static_cast<const T*>(p.pool) + kidx * plane;
  const T* vpan = static_cast<const T*>(p.pool) + vidx * plane;
  const float* ksc = kQuant ? p.scales + kidx * p.s_alloc : nullptr;
  const float* vsc = kQuant ? p.scales + vidx * p.s_alloc : nullptr;
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
        sSk[tid] = ok && kQuant ? ksc[s] : 1.f;
        sSv[tid] = ok && kQuant ? vsc[s] : 1.f;
      }
      // K (and in pass 2 V), four elements per thread per step.
      for (int i = tid; i < FS * D / 4; i += blockDim.x) {
        const int kk = i / (D / 4), w = i % (D / 4);
        const int pp = p0 + kk;
        W kw = {}, vw = {};
        if (pp <= p_hi) {
          const size_t off = (size_t)(pp % p.ring) * D + 4 * w;
          kw = *reinterpret_cast<const W*>(kpan + off);
          if (pass == 1) vw = *reinterpret_cast<const W*>(vpan + off);
        }
        *reinterpret_cast<W*>(sK + kk * (D + 4) + 4 * w) = kw;
        if (pass == 1) *reinterpret_cast<W*>(sV + kk * D + 4 * w) = vw;
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
          ld4(sK + (tx + 16 * j) * (D + 4) + d, c);
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
          float v = sc[u][j];
          if constexpr (kQuant) v *= sSk[kk];
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
            float pr = 0.f;
            if (ok[u][j] && l[u] > 0.f) {
              pr = expf(sc[u][j] - m[u]) / l[u];
              if constexpr (kQuant) pr *= sSv[kk];
              pr = cdt_round<T>(pr);
            }
            sP[(ty + 16 * u) * (FS + 1) + kk] = pr;
          }
        __syncthreads();
        for (int kk = 0; kk < FS; ++kk) {
          const float p0v = sP[ty * (FS + 1) + kk];
          const float p1v = sP[(ty + 16) * (FS + 1) + kk];
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            float v[4];
            ld4(sV + kk * D + 64 * c + 4 * tx, v);
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

// One kernel name per pool type, so a profiler trace tells them apart.
template <int D>
__global__ void __launch_bounds__(256) flash_attention_i8_kernel(FlashArgs p) {
  flash_attention_body<int8_t, D>(p);
}
template <int D>
__global__ void __launch_bounds__(256) flash_attention_bf16_kernel(FlashArgs p) {
  flash_attention_body<__nv_bfloat16, D>(p);
}
template <int D>
__global__ void __launch_bounds__(256) flash_attention_f32_kernel(FlashArgs p) {
  flash_attention_body<float, D>(p);
}

template <typename T, int D>
static int launch_flash(const FlashArgs& p, int batch, int* launched,
                        cudaStream_t st) {
  constexpr int bytes = flash_smem_bytes<T, D>();
  void (*kernel)(FlashArgs);
  if constexpr (std::is_same<T, int8_t>::value) kernel = flash_attention_i8_kernel<D>;
  else if constexpr (std::is_same<T, __nv_bfloat16>::value) kernel = flash_attention_bf16_kernel<D>;
  else kernel = flash_attention_f32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.tg + FR - 1) / FR, p.kvh, batch);
  kernel<<<grid, 256, bytes, st>>>(p);
  *launched = 1;
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_flash(const FlashArgs& p, int batch, int d, int* launched,
                          cudaStream_t st) {
  *launched = 0;
  if (d == 256) return launch_flash<T, 256>(p, batch, launched, st);
  if (d == 128) return launch_flash<T, 128>(p, batch, launched, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gemma_flash_attention_i8(
    const float* q, const int8_t* pool, const float* scales, const int* base,
    const int* newest, const int* prefix_end, float* out, int batch,
    int n_layers, int layer, int kvh, int tg, int groups, int s_alloc, int d,
    int ring, int window, float att_cap, int* launched, cudaStream_t st) {
  FlashArgs p = {q, pool, scales, base, newest, prefix_end, out, n_layers,
                 layer, kvh, tg, groups, s_alloc, ring, window, att_cap};
  return dispatch_flash<int8_t>(p, batch, d, launched, st);
}

extern "C" int gemma_flash_attention_bf16(
    const float* q, const __nv_bfloat16* pool, const int* base,
    const int* newest, const int* prefix_end, float* out, int batch,
    int n_layers, int layer, int kvh, int tg, int groups, int s_alloc, int d,
    int ring, int window, float att_cap, int* launched, cudaStream_t st) {
  FlashArgs p = {q, pool, nullptr, base, newest, prefix_end, out, n_layers,
                 layer, kvh, tg, groups, s_alloc, ring, window, att_cap};
  return dispatch_flash<__nv_bfloat16>(p, batch, d, launched, st);
}

extern "C" int gemma_flash_attention_f32(
    const float* q, const float* pool, const int* base, const int* newest,
    const int* prefix_end, float* out, int batch, int n_layers, int layer,
    int kvh, int tg, int groups, int s_alloc, int d, int ring, int window,
    float att_cap, int* launched, cudaStream_t st) {
  FlashArgs p = {q, pool, nullptr, base, newest, prefix_end, out, n_layers,
                 layer, kvh, tg, groups, s_alloc, ring, window, att_cap};
  return dispatch_flash<float>(p, batch, d, launched, st);
}
