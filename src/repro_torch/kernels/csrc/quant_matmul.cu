// quant_matmul: out (M, N) = x (M, K) @ dequant(W), W in the LQ wire format.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quant_matmul.py:quant_matmul
// (body _kernel, unpack _unpack_block).  W is uint8 codes packed along K,
// (K/cpb, N) row-major, with f32 scale/zmin of shape (K/group_size, N), so
// w[k, n] = code * scale[k / gs, n] + zmin[k / gs, n].  x is f32 or bf16; the
// sum is kept in f32 and the output is written in x's dtype.
//
// What bounds it on an H100: bytes.  At the decode shapes of llama3.2-1b
// (M = the number of slots, 1..16; K 2048/8192; N 512..8192) each weight
// byte is used M times, far below the ~295 operations per byte at which the
// card stops being bound by its 3.35 TB/s; the packed codes (bits/8 bytes
// per weight) plus 8 bytes of scale/zmin per region and column are what
// has to move.
//
// Design: a block owns a BM x 32 output tile.  Its 32 lanes are 32
// neighbouring columns, so each load of a packed row is one 32-byte
// coalesced sector.  The block's 8 warps split K between them one whole
// local region at a time (warp w walks regions w, w+8, ...), so a thread
// loads its column's scale and zmin once per region and dequantizes each
// code in registers (code * scale + zmin, never written back to memory)
// straight into BM f32 sums; x is read with one broadcast load per warp.
// The 8 partial sums meet in shared memory at the end.  Ragged M and N
// edges are masked here, not padded by the caller.  Everything is read
// once per M tile, and no weight tensor in fp is ever materialized.  What
// it leaves on the table (a later PR's work): one block per 32 columns
// gives only N/32 blocks at small M, and x is re-read from L1 per code.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BN = 32;  // output columns per block: one warp along N
constexpr int KS = 8;   // warps per block, each walking every 8th region

template <int BITS, int BM, typename T>
__global__ void __launch_bounds__(BN * KS)
quant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale,
                    const float* __restrict__ zmin, T* __restrict__ out, int M,
                    int K, int N, int group_size) {
  constexpr int CPB = codes_per_byte<BITS>();
  constexpr unsigned MASK = (1u << BITS) - 1u;
  const int lane = threadIdx.x;
  const int slice = threadIdx.y;
  const int n = blockIdx.x * BN + lane;
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);
  const int n_regions = K / group_size;
  const int region_bytes = group_size / CPB;

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  if (n < N) {
    const T* xm = x + (size_t)m0 * K;
    for (int g = slice; g < n_regions; g += KS) {
      const float s = scale[(size_t)g * N + n];
      const float z = zmin[(size_t)g * N + n];
      const uint8_t* p = packed + (size_t)g * region_bytes * N + n;
      const int k0 = g * group_size;
#pragma unroll 4
      for (int i = 0; i < region_bytes; ++i) {
        const unsigned byte = p[(size_t)i * N];
#pragma unroll
        for (int j = 0; j < CPB; ++j) {
          const float w = (float)((byte >> (j * BITS)) & MASK) * s + z;
          const int k = k0 + i * CPB + j;
#pragma unroll
          for (int r = 0; r < BM; ++r)
            if (r < rows) acc[r] += to_f32(xm[(size_t)r * K + k]) * w;
        }
      }
    }
  }

  __shared__ float red[KS][BM][BN];
#pragma unroll
  for (int r = 0; r < BM; ++r) red[slice][r][lane] = acc[r];
  __syncthreads();
  for (int r = slice; r < rows; r += KS) {
    if (n < N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < KS; ++w) sum += red[w][r][lane];
      out[(size_t)(m0 + r) * N + n] = from_f32<T>(sum);
    }
  }
}

template <int BITS, typename T>
void launch(const void* x, const void* packed, const void* scale,
            const void* zmin, void* out, int M, int K, int N, int group_size,
            cudaStream_t stream) {
  const dim3 block(BN, KS);
  const auto* px = static_cast<const T*>(x);
  const auto* pp = static_cast<const uint8_t*>(packed);
  const auto* ps = static_cast<const float*>(scale);
  const auto* pz = static_cast<const float*>(zmin);
  auto* po = static_cast<T*>(out);
  if (M <= 4) {
    const dim3 grid((N + BN - 1) / BN, (M + 3) / 4);
    quant_matmul_kernel<BITS, 4, T><<<grid, block, 0, stream>>>(
        px, pp, ps, pz, po, M, K, N, group_size);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
    quant_matmul_kernel<BITS, 16, T><<<grid, block, 0, stream>>>(
        px, pp, ps, pz, po, M, K, N, group_size);
  }
}

template <typename T>
int dispatch_bits(int bits, const void* x, const void* packed,
                  const void* scale, const void* zmin, void* out, int M,
                  int K, int N, int group_size, cudaStream_t stream) {
  switch (bits) {
    case 1: launch<1, T>(x, packed, scale, zmin, out, M, K, N, group_size, stream); break;
    case 2: launch<2, T>(x, packed, scale, zmin, out, M, K, N, group_size, stream); break;
    case 3: launch<3, T>(x, packed, scale, zmin, out, M, K, N, group_size, stream); break;
    case 4: launch<4, T>(x, packed, scale, zmin, out, M, K, N, group_size, stream); break;
    case 5: launch<5, T>(x, packed, scale, zmin, out, M, K, N, group_size, stream); break;
    case 6: launch<6, T>(x, packed, scale, zmin, out, M, K, N, group_size, stream); break;
    case 7: launch<7, T>(x, packed, scale, zmin, out, M, K, N, group_size, stream); break;
    case 8: launch<8, T>(x, packed, scale, zmin, out, M, K, N, group_size, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch (0 = launched).  x_bf16 selects bf16 x/out (else f32).
extern "C" int repro_quant_matmul(const void* x, const void* packed,
                                  const void* scale, const void* zmin,
                                  void* out, int M, int K, int N, int bits,
                                  int group_size, int x_bf16, void* stream) {
  using namespace repro_torch;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch_bits<__nv_bfloat16>(bits, x, packed, scale, zmin, out, M,
                                        K, N, group_size, s);
  return dispatch_bits<float>(bits, x, packed, scale, zmin, out, M, K, N,
                              group_size, s);
}
