// The categorical draw of sampled decode for Hopper (sm_90a).
//
// A kernel of the port with no TPU counterpart: the JAX package draws with
// XLA ops on the fused top-k head's [B, k] output
// (gemma_tpu/ops/sampling.py:_draw_from_topk, keys from
// gemma_tpu/utils/basics.py:sample_key).  In eager PyTorch the same draw is
// some hundred tiny launches per step (Threefry in 64-bit tensor ops), on
// a decode loop that is bound by launches already, so it is one launch
// here: one warp per row computes
//   p = softmax(vals[row, :k]);  T == 0: choice 0
//   adj = p^(1/T) / sum(p^(1/T)) when T != 1, else p
//   choice = argmax_j log(adj_j) + gumbel_j     (ties to the lower j)
//   tok = idxs[row, choice], prob = p[choice]   (before the temperature)
// with gumbel_j = -log(-log(max(tiny, u_j))), u_j the top 23 bits of word j
// of the Threefry-2x32 stream keyed by fold_in(fold_in((seed_hi, seed_lo),
// qi[row]), pos[row]): the draw depends on (seed, query, position) alone.
// Bound: k * 8 bytes per row, nothing; the launch itself is the cost.

#include <climits>

#include "common.cuh"

using namespace gemma;

namespace {

constexpr int kMaxK = 128;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds, as jax.random's default PRNG runs it.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][r]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

__global__ void __launch_bounds__(128) draw_topk_kernel(
    const float* vals, const int* idxs, const int* qi, const int* pos,
    uint32_t seed_hi, uint32_t seed_lo, int M, float temperature, int k,
    int* tok, float* prob) {
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* v = vals + (size_t)row * k;

  float x[kMaxK / 32], p[kMaxK / 32];
  float m = -INFINITY;
#pragma unroll
  for (int q = 0; q < kMaxK / 32; ++q) {
    const int j = lane + 32 * q;
    x[q] = j < k ? v[j] : -INFINITY;
    m = fmaxf(m, x[q]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxK / 32; ++q) {
    const int j = lane + 32 * q;
    p[q] = j < k ? expf(x[q] - m) : 0.f;
    s += p[q];
  }
  s = warp_sum(s);
#pragma unroll
  for (int q = 0; q < kMaxK / 32; ++q) p[q] = p[q] / s;

  int choice = 0;
  if (temperature != 0.f) {
    float adj[kMaxK / 32];
    if (temperature != 1.f) {
      const float inv_t = 1.0f / temperature;
      float sa = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxK / 32; ++q) {
        adj[q] = lane + 32 * q < k ? powf(p[q], inv_t) : 0.f;
        sa += adj[q];
      }
      sa = warp_sum(sa);
#pragma unroll
      for (int q = 0; q < kMaxK / 32; ++q) adj[q] = adj[q] / sa;
    } else {
#pragma unroll
      for (int q = 0; q < kMaxK / 32; ++q) adj[q] = p[q];
    }
    // The stream's key: fold the query index, then the position.
    uint32_t k0 = seed_hi, k1 = seed_lo;
    uint32_t a = 0, b = (uint32_t)qi[row];
    threefry2x32(k0, k1, a, b);
    k0 = a; k1 = b;
    a = 0; b = (uint32_t)pos[row];
    threefry2x32(k0, k1, a, b);
    k0 = a; k1 = b;

    float best = -INFINITY;
    int best_j = INT_MAX;
#pragma unroll
    for (int q = 0; q < kMaxK / 32; ++q) {
      const int j = lane + 32 * q;
      if (j >= k) continue;
      uint32_t c0 = 0, c1 = (uint32_t)j;
      threefry2x32(k0, k1, c0, c1);
      const uint32_t bits = c0 ^ c1;
      float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      u = fmaxf(u, 1.17549435e-38f);
      const float score = logf(adj[q]) + (-logf(-logf(u)));
      // j grows with q, so a strict > keeps the lane's lowest j on ties.
      if (score > best || best_j == INT_MAX) {
        best = score;
        best_j = j;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oj = __shfl_xor_sync(0xffffffffu, best_j, o);
      if (oj != INT_MAX &&
          (best_j == INT_MAX || ob > best || (ob == best && oj < best_j))) {
        best = ob;
        best_j = oj;
      }
    }
    choice = best_j;
  }
  // The chosen entry's prob lives in lane choice % 32, register choice / 32.
  float pc = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxK / 32; ++q)
    if (q == choice / 32) pc = p[q];
  pc = __shfl_sync(0xffffffffu, pc, choice & 31);
  if (lane == 0) {
    tok[row] = idxs[(size_t)row * k + choice];
    prob[row] = pc;
  }
}

}  // namespace

extern "C" int gemma_draw_topk(const float* vals, const int* idxs,
                               const int* qi, const int* pos, int seed_hi,
                               int seed_lo, int M, float temperature, int k,
                               int* tok, float* prob, int* launched,
                               cudaStream_t st) {
  *launched = 0;
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  draw_topk_kernel<<<(M + 3) / 4, 128, 0, st>>>(
      vals, idxs, qi, pos, (uint32_t)seed_hi, (uint32_t)seed_lo, M,
      temperature, k, tok, prob);
  *launched = 1;
  return (int)cudaGetLastError();
}
