// Shared device helpers for the port's hand-written sm_90a kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define GEMMA_NEG_INF (-2.3819763e38f)  // ops/attention.py NEG_INF

namespace gemma {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Two floats -> packed bf16x2 (round to nearest even); `lo` is the lower index.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Four signed bytes of `w` -> four exact floats without the quarter-rate
// integer-to-float conversion: each byte, biased to c + 128, becomes the
// low mantissa byte of 2^23 (bits 0x4B0000xx), and 2^23 + 128 is
// subtracted: one byte permute and one add per value.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B00u, 0x5440u + i)) - 8388736.0f;
}

// Four signed bytes -> two packed bf16x2 words (bytes 0,1 and 2,3).
// Exact: an integer of magnitude <= 128 has at most 8 significant bits,
// so its f32 bits end in 16 zeros and the high half is its bf16.
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t* out) {
  float f[4];
  i8x4_to_f32(w, f);
  out[0] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
  out[1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
}

// The attention kernels' compute type for a pool of element type T
// (decode_attention.py:662-663, flash_attention.py:65-69): f32 for an f32
// pool, bf16 otherwise (i8 codes are exact in bf16).  Rounds x to it.
template <typename T>
__device__ __forceinline__ float cdt_round(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return bf16_round(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 or 4 bytes global -> shared; src_bytes 0 zero-fills the
// destination without reading the source.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most `n` of this thread's groups are pending; n is clamped
// to 0..7 (waiting for more groups than needed is safe).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// D += A(16x16 bf16, row) * B(16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace gemma
