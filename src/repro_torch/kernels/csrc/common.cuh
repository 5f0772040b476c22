// Shared helpers of the port's CUDA kernels: f32 <-> storage conversions.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Codes per byte of the LQ wire format: bits 1/2/4 pack, the rest use a byte.
template <int BITS> __host__ __device__ constexpr int codes_per_byte() {
  return (BITS == 1 || BITS == 2 || BITS == 4) ? 8 / BITS : 1;
}

}  // namespace repro_torch
