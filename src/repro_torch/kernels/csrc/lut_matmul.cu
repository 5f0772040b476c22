// lut_matmul: out (M, N) f32 = dequant(a) (M, K) @ w (K, N), by the paper's
// section-V table lookup instead of multiply-accumulate.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lut_matmul.py:lut_matmul
// (body _kernel).  a is BITS-bit activation codes (BITS <= 4) packed along K,
// (M, K/cpb) uint8, with f32 scale/zmin (M, K/group_size) per row and local
// region; w is f32 (K, N).  For each region g of row m and column n,
//     sum_j a_j w_j = s * sum_{v=1}^{2^b-1} v * T[v] + zmin * sum_j w_j,
//     T[v] = sum_{j : code_j == v} w_j            (the table, adds only)
// and the regions' terms are summed in f32.  This equals dequant(a) @ w.
//
// The TPU kernel walks the regions on a sequential grid axis into a VMEM
// accumulator and builds the table as one binary matmul per code value.
// Here a block owns a BM x 32 output tile and loops over the regions
// itself: its 8 warps walk every 8th region (warp w: w, w+8, ...), lane n of
// a warp owns column n, and the partial sums meet in shared memory at the
// end.  Per region each thread builds the table of every row it owns in
// registers with masked selects, t[r][v] += (code == v) ? w : 0, unrolled
// over r and v so the table never goes to local memory (indexing it by the
// code would), keeps sum_j w_j, and adds s*sum_v v*t[v] + zmin*sum_w into
// its f32 sum.  The codes are unpacked here, not by the caller; they are
// read with one broadcast load per row and byte.
//
// What bounds it on an H100: at decode (M = the slots) bytes, the f32 w
// (4 bytes per weight, ~243 MB per llama3.2-1b layer) read once; at prefill
// (M = 176) the CUDA-core adds of the table build, at least one f32 add per
// (m, k, n), against the 67 TFLOP/s f32 peak (the tensor cores take no part
// in a table build).  BM is set so that the tables fit in registers: 16 rows
// at 1-2 bits, 8 at 3, 4 at 4 bits, and 4 whenever M <= 4.  What it leaves on
// the table (a later PR's work): N/32 blocks at decode fill few SMs when
// N is small, w is re-read from L2 by every BM-row tile at prefill, and each
// table entry costs a select and an add where the paper's scatter costs one
// add.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BN = 32;  // output columns per block: one warp along N
constexpr int KS = 8;   // warps per block, each walking every 8th region

template <int BITS, int BM>
__global__ void __launch_bounds__(BN * KS)
lut_matmul_kernel(const uint8_t* __restrict__ codes,
                  const float* __restrict__ scale,
                  const float* __restrict__ zmin, const float* __restrict__ w,
                  float* __restrict__ out, int M, int K, int N,
                  int group_size) {
  constexpr int CPB = codes_per_byte<BITS>();
  constexpr unsigned MASK = (1u << BITS) - 1u;
  constexpr int V = (1 << BITS) - 1;  // table entries v = 1..V (0 adds nothing)
  const int lane = threadIdx.x;
  const int slice = threadIdx.y;
  const int n = blockIdx.x * BN + lane;
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);
  const int G = K / group_size;
  const int kp = K / CPB;
  const int region_bytes = group_size / CPB;

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  if (n < N) {
    for (int g = slice; g < G; g += KS) {
      float t[BM][V];
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v) t[r][v] = 0.f;
      float wsum = 0.f;
      const float* wg = w + (size_t)g * group_size * N + n;
      const uint8_t* cg = codes + (size_t)m0 * kp + (size_t)g * region_bytes;
#pragma unroll 2
      for (int i = 0; i < region_bytes; ++i) {
        unsigned byte[BM];
#pragma unroll
        for (int r = 0; r < BM; ++r)
          byte[r] = r < rows ? cg[(size_t)r * kp + i] : 0u;  // code 0: no add
#pragma unroll
        for (int j = 0; j < CPB; ++j) {
          const float wv = wg[(size_t)(i * CPB + j) * N];
          wsum += wv;
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            const unsigned c = (byte[r] >> (j * BITS)) & MASK;
#pragma unroll
            for (int v = 0; v < V; ++v)
              t[r][v] += (c == (unsigned)(v + 1)) ? wv : 0.f;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        if (r < rows) {
          float code_dot = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) code_dot += (float)(v + 1) * t[r][v];
          const size_t sg = (size_t)(m0 + r) * G + g;
          acc[r] += scale[sg] * code_dot + zmin[sg] * wsum;
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
      for (int s = 0; s < KS; ++s) sum += red[s][r][lane];
      out[(size_t)(m0 + r) * N + n] = sum;
    }
  }
}

template <int BITS, int BM>
int launch(const void* codes, const void* scale, const void* zmin,
           const void* w, void* out, int M, int K, int N, int group_size,
           cudaStream_t stream) {
  const dim3 block(BN, KS);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lut_matmul_kernel<BITS, BM><<<grid, block, 0, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(scale),
      static_cast<const float*>(zmin), static_cast<const float*>(w),
      static_cast<float*>(out), M, K, N, group_size);
  return (int)cudaGetLastError();
}

template <int BITS, int BM_LARGE>
int dispatch_rows(const void* codes, const void* scale, const void* zmin,
                  const void* w, void* out, int M, int K, int N,
                  int group_size, cudaStream_t stream) {
  if (M <= 4)
    return launch<BITS, 4>(codes, scale, zmin, w, out, M, K, N, group_size,
                           stream);
  return launch<BITS, BM_LARGE>(codes, scale, zmin, w, out, M, K, N,
                                group_size, stream);
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes.  Returns cudaGetLastError() after the
// launch (0 = launched); bits outside 1..4 return cudaErrorInvalidValue.
extern "C" int repro_lut_matmul(const void* codes, const void* scale,
                                const void* zmin, const void* w, void* out,
                                int M, int K, int N, int bits, int group_size,
                                void* stream) {
  using namespace repro_torch;
  auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return dispatch_rows<1, 16>(codes, scale, zmin, w, out, M, K, N, group_size, s);
    case 2: return dispatch_rows<2, 16>(codes, scale, zmin, w, out, M, K, N, group_size, s);
    case 3: return dispatch_rows<3, 8>(codes, scale, zmin, w, out, M, K, N, group_size, s);
    case 4: return dispatch_rows<4, 4>(codes, scale, zmin, w, out, M, K, N, group_size, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
