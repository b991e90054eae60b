// BabyBear field arithmetic for the CUDA kernels of risc0_tpu_torch.
//
// Words are canonical Montgomery residues (R = 2^32) held as uint32_t; the
// torch side stores the same bits as int32.  The product is REDC on the
// native 32x32->64 multiply (M = P^-1 mod 2^32).  The reference
// (risc0_tpu/field.py:211-228) splits that multiply into 16-bit limbs only
// because the TPU's vector unit lacks it.
#pragma once

#include <cstdint>

namespace bb {

constexpr uint32_t P = 0x78000001u;  // 15 * 2^27 + 1
constexpr uint32_t M = 0x88000001u;  // P^-1 mod 2^32

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t x = a + b;  // < 2^32 since a, b < P < 2^31
  return x >= P ? x - P : x;
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  uint32_t x = a + P - b;
  return x >= P ? x - P : x;
}

// Montgomery product a*b*2^-32 mod P (reference baby_bear.rs:337-350).
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint64_t o = (uint64_t)a * b;
  uint32_t low = 0u - (uint32_t)o;
  uint32_t red = M * low;
  o += (uint64_t)red * P;  // < 2^62 + 2^63: no wrap
  uint32_t ret = (uint32_t)(o >> 32);
  return ret >= P ? ret - P : ret;
}

}  // namespace bb
