// Shared helpers of the port's CUDA kernels: f32 <-> storage conversions,
// the LQ wire format's codes per byte, cp.async copies into shared memory
// (lut_matmul.cu and paged_attention.cu), and the fixed-order reduction of
// split-K partial tiles (quant_matmul.cu and lut_matmul.cu).
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

namespace {

// cp.async: a copy from global to shared memory that holds no register
// while in flight.  It lands after cp_async_wait of its group, and is seen
// by other threads after a barrier that follows the wait.  The "memory"
// clobbers keep the compiler from moving shared-memory reads across a wait
// (before their copy lands) or across the copy that refills their slot.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
// 4 bytes, of which the first src_bytes (4 or 0) are read; the rest is zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// out[m, n] = sum over splits of ws[s, m, n] in a fixed order: a block owns
// 32 outputs; its warp q sums splits q, q + 8, ... and the 8 warp sums are
// added in warp order.
constexpr int RED_GROUPS = 8;

template <typename T>
__global__ void __launch_bounds__(32 * RED_GROUPS)
splitk_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                     int MN, int splits) {
  constexpr int RU = 4;  // loads in flight per thread
  __shared__ float part[RED_GROUPS][32];
  const int lane = threadIdx.x % 32, q = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (i < MN) {
    for (int s0 = q; s0 < splits; s0 += RED_GROUPS * RU) {
      float v[RU];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int s = s0 + u * RED_GROUPS;
        v[u] = s < splits ? ws[(size_t)s * MN + i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < RU; ++u) sum += v[u];
    }
  }
  part[q][lane] = sum;
  __syncthreads();
  if (q == 0 && i < MN) {
    float total = part[0][lane];
#pragma unroll
    for (int w = 1; w < RED_GROUPS; ++w) total += part[w][lane];
    out[i] = from_f32<T>(total);
  }
}

// Launch the reduction of ws (splits, MN) f32 into out (MN); returns
// cudaGetLastError().  No atomics: every call gives the same bytes.
template <typename T>
int splitk_reduce(const float* ws, T* out, int mn, int splits,
                  cudaStream_t stream) {
  splitk_reduce_kernel<T><<<(mn + 31) / 32, 32 * RED_GROUPS, 0, stream>>>(
      ws, out, mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch
