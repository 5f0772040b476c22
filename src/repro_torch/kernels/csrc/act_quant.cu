// act_quant: runtime activation quantization per row and local region.
//
// Replaces the Pallas TPU kernel src/repro/kernels/act_quant.py:act_quant
// (body _kernel).  x (M, K) is f32 or bf16.  For each row and each region
// of 128 values along K (the group size of every registered scheme): min
// and max, scale = (max - min) / levels
// (1 where the range is 0, levels = 2^bits - 1), zmin = min, then codes
// round_half_even((x - min) / scale) clipped to [0, levels], packed along K
// as core/packing.py packs them: code j of a byte at shift (j % cpb) * bits
// for bits 1/2/4, one code per byte otherwise.  Outputs packed (M, K/cpb)
// uint8, scale and zmin (M, K/128) f32.
//
// The codes must equal the plain version's byte for byte, on the card and
// on the CPU: a code at a rounding boundary flips if the step or the
// quotient is off by an ulp.  So both divisions are IEEE divisions rounded
// to nearest (__fdiv_rn, never a multiply by 1/scale), rintf rounds half to
// even as torch.round does, and min/max are exact in any order.
//
// What bounds it on an H100: latency.  At decode (M = the slots, K 2048 or
// 8192) one call moves a few KB, far below what a microsecond of memory
// traffic carries; at prefill (M = 176) it is bound by bytes (x read once,
// a quarter to a sixteenth of it written back).  Design: one warp per
// (row, region), 4 values per lane held in registers, min/max by shuffle reductions, so x is read once and nothing but the
// outputs is written.  At 1 bit a byte holds the 8 codes of two lanes:
// the lanes OR their parts together with a shuffle and the first of them
// stores the byte.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int WARPS = 8;               // (row, region) tasks per block
constexpr unsigned FULL = 0xffffffffu;
constexpr int VPL = 4;                 // values per lane
constexpr int GS = 32 * VPL;           // the region: 128 values

template <int BITS, typename T>
__global__ void __launch_bounds__(32 * WARPS)
act_quant_kernel(const T* __restrict__ x, uint8_t* __restrict__ packed,
                 float* __restrict__ scale, float* __restrict__ zmin, int M,
                 int K) {
  constexpr int CPB = codes_per_byte<BITS>();
  constexpr int LEVELS = (1 << BITS) - 1;
  const int lane = threadIdx.x & 31;
  const int G = K / GS;
  const long long task = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= (long long)M * G) return;          // the whole warp leaves
  const int row = (int)(task / G);
  const int g = (int)(task % G);
  const int k0 = g * GS + lane * VPL;

  const T* xr = x + (size_t)row * K + k0;
  float v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) v[i] = to_f32(xr[i]);
  float mn = v[0], mx = v[0];
#pragma unroll
  for (int i = 1; i < VPL; ++i) {
    mn = fminf(mn, v[i]);
    mx = fmaxf(mx, v[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(FULL, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  }
  const float rng = mx - mn;
  const float s = rng > 0.f ? __fdiv_rn(rng, (float)LEVELS) : 1.f;

  unsigned c[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const float q = rintf(__fdiv_rn(v[i] - mn, s));
    c[i] = (unsigned)fminf(fmaxf(q, 0.f), (float)LEVELS);
  }

  uint8_t* out = packed + (size_t)row * (K / CPB);
  if constexpr (VPL >= CPB) {
#pragma unroll
    for (int b = 0; b < VPL / CPB; ++b) {
      unsigned byte = 0;
#pragma unroll
      for (int j = 0; j < CPB; ++j) byte |= c[b * CPB + j] << (j * BITS);
      out[k0 / CPB + b] = (uint8_t)byte;
    }
  } else {
    constexpr int L = CPB / VPL;                 // lanes sharing one byte
    unsigned part = 0;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      part |= c[i] << (((lane % L) * VPL + i) * BITS);
#pragma unroll
    for (int o = 1; o < L; o <<= 1) part |= __shfl_xor_sync(FULL, part, o);
    if (lane % L == 0) out[k0 / CPB] = (uint8_t)part;
  }
  if (lane == 0) {
    scale[(size_t)row * G + g] = s;
    zmin[(size_t)row * G + g] = mn;
  }
}

template <int BITS, typename T>
int launch(const void* x, void* packed, void* scale, void* zmin, int M, int K,
           cudaStream_t stream) {
  const long long tasks = (long long)M * (K / GS);
  const dim3 grid((unsigned)((tasks + WARPS - 1) / WARPS));
  act_quant_kernel<BITS, T><<<grid, 32 * WARPS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(packed),
      static_cast<float*>(scale), static_cast<float*>(zmin), M, K);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bits(int bits, const void* x, void* packed, void* scale,
                  void* zmin, int M, int K, cudaStream_t stream) {
  switch (bits) {
    case 1: return launch<1, T>(x, packed, scale, zmin, M, K, stream);
    case 2: return launch<2, T>(x, packed, scale, zmin, M, K, stream);
    case 3: return launch<3, T>(x, packed, scale, zmin, M, K, stream);
    case 4: return launch<4, T>(x, packed, scale, zmin, M, K, stream);
    case 5: return launch<5, T>(x, packed, scale, zmin, M, K, stream);
    case 6: return launch<6, T>(x, packed, scale, zmin, M, K, stream);
    case 7: return launch<7, T>(x, packed, scale, zmin, M, K, stream);
    case 8: return launch<8, T>(x, packed, scale, zmin, M, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch (0 = launched).  x_bf16 selects bf16 x (else f32); K is a
// multiple of 128.
extern "C" int repro_act_quant(const void* x, void* packed, void* scale,
                               void* zmin, int M, int K, int bits, int x_bf16,
                               void* stream) {
  using namespace repro_torch;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch_bits<__nv_bfloat16>(bits, x, packed, scale, zmin, M, K, s);
  return dispatch_bits<float>(bits, x, packed, scale, zmin, M, K, s);
}
