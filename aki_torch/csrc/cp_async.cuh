// Small building blocks of the int8 serving kernels (decode_attention.cu,
// fused_quant.cu): 16- and 4-byte cp.async copies from global to shared
// memory with their commit / wait, and the exact int8 -> f32 conversion
// both kernels use in place of I2F (a quarter-rate instruction on sm_90).
// Everything sits in an anonymous namespace: each source that includes it
// is its own shared library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, cached in L2 only (each byte is read once)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 4 bytes, cached in L1 as well (scales that neighbouring blocks share)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The four int8 values of ``w`` as f32, exactly: byte ^ 0x80 is x + 128,
// placed in the low mantissa byte of 2^23 (0x4B000000) it reads as
// 2^23 + 128 + x, and one subtraction leaves x. One PRMT and one FADD a
// value instead of a quarter-rate I2F.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) - 8388736.f;
}

}  // namespace
