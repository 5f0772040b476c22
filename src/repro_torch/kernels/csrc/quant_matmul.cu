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
// has to move.  To stream at that rate the card needs ~2-3 MB of loads in
// flight, ~16-20 KB per SM, and enough blocks to put them on every SM.
//
// Two kernels, chosen by M in the wrapper (kernels/quant_matmul.py):
//
// M <= 16, every decode step: split K.  A block owns BM rows (4 or 16, one
// tile covers M) by a strip of TX * VEC columns and one contiguous range of
// packed rows (split s of S: rows [s*R/S, (s+1)*R/S)); its plan() picks S so
// that the grid has up to 2 blocks per SM, at least one, even at N = 512
// (256-264 blocks for every llama3.2-1b projection at M = 4).
//   - Wide loads: each thread owns VEC consecutive columns (16 at BM 4, 8 at
//     BM 16) of a contiguous chunk of the block's rows and loads them from a
//     packed row as one 16- or 8-byte load, so a warp moves 256 B per
//     instruction.  It keeps the next U rows in flight while it uses the U
//     before them, and its first rows go out before x is staged.  Its scale
//     and zmin load as float4s once per region it crosses.  Columns past a
//     ragged or unaligned N take a predicated byte path in the same walk.
//   - x in shared memory: the block stages its BM x K-range slice of x once,
//     as f32, and reads it by broadcast, BM rows of one k per 16-byte load.
//   - Each code is dequantized in registers (one FMA: code * scale + zmin; the
//     code becomes a float by a byte permute into 2^23's mantissa and one
//     subtract, off the slow conversion pipe) into BM x VEC f32 sums.  That
//     is 3 instructions per weight besides the BM FMAs, so at M = 4 the
//     walk runs 7 arithmetic instructions per weight and is bound by
//     instruction throughput, not by bytes, on the large projections; on
//     the small ones the two launches and the block's fixed work (staging,
//     the meeting of its thread rows) dominate.  PERF.md holds the
//     measured split.
//   - The TY thread rows of a block split its range into contiguous chunks
//     and meet by one shuffle and a 4-warp sum in shared memory; each split
//     writes its f32 partial tile to a workspace (S, M, N), and a second
//     kernel (common.cuh, shared with lut_matmul.cu) sums the splits in a
//     fixed order.  No atomics: every call gives
//     the same bytes, and a CUDA graph captures both launches (no host sync,
//     no allocation inside).
//
// M > 16, the prefill bucket: one pass.  A block owns a BM x 32 output tile,
// its 32 lanes 32 neighbouring columns (one 32-byte sector per load of a
// packed row); its 8 warps walk every 8th local region and meet in shared
// memory.  At M = 176 each weight byte is used 176 times, so this tile is
// bound by its scalar FMAs; a tensor-core path is a later PR's work.
//
// Ragged M and N edges are masked here, not padded by the caller.  No weight
// tensor in fp is ever materialized.
#include "common.cuh"

namespace repro_torch {
namespace {

// ---------------------------------------------------------------------------
// M > 16: one pass, a BM x 32 tile per block
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// M <= 16: split K, wide loads, x in shared memory
// ---------------------------------------------------------------------------

constexpr int TX = 16;  // threads across N
constexpr int TY = 8;   // thread rows across the block's packed rows
constexpr int THREADS = TX * TY;
constexpr int WARPS = THREADS / 32;  // each warp holds two thread rows
// the plan (kernels/quant_matmul.py) keeps x's slice within it
constexpr int X_SMEM_BYTES = 32 * 1024;

template <int BM> struct SplitGeom {
  static constexpr int VEC = BM == 4 ? 16 : 8;  // columns (bytes) per thread
  static constexpr int U = BM == 4 ? 4 : 8;     // rows per load batch
  static constexpr int BNS = TX * VEC;  // columns per block (plan: BLOCK_COLS)
};

// VEC bytes of one packed row, 4 per word, byte c of the thread's columns in
// byte c % 4 of word c / 4.
template <int VEC> struct Codes { uint32_t w[VEC / 4]; };

template <int VEC>
__device__ __forceinline__ Codes<VEC> load_codes(const uint8_t* row, int n0,
                                                 int N, bool full) {
  Codes<VEC> c;
  if (full) {
    if constexpr (VEC == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + n0));
      c.w[0] = v.x; c.w[1] = v.y; c.w[2] = v.z; c.w[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + n0));
      c.w[0] = v.x; c.w[1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) c.w[i] = 0u;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (n0 + j < N)
        c.w[j / 4] |= (uint32_t)__ldg(row + n0 + j) << (8 * (j % 4));
  }
  return c;
}

// rows [r, min(r + U, hi)) of the thread's columns into buf
template <int VEC, int U>
__device__ __forceinline__ void load_batch(Codes<VEC> (&buf)[U],
                                           const uint8_t* __restrict__ packed,
                                           int r, int hi, int n0, int N,
                                           bool full) {
#pragma unroll
  for (int i = 0; i < U; ++i)
    if (r + i < hi)
      buf[i] = load_codes<VEC>(packed + (size_t)(r + i) * N, n0, N, full);
}

template <int VEC>
__device__ __forceinline__ void load_affine(const float* __restrict__ srow,
                                            const float* __restrict__ zrow,
                                            int n0, int N, bool full,
                                            float (&s)[VEC], float (&z)[VEC]) {
  if (full) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(srow + n0 + j));
      const float4 b = __ldg(reinterpret_cast<const float4*>(zrow + n0 + j));
      s[j] = a.x; s[j + 1] = a.y; s[j + 2] = a.z; s[j + 3] = a.w;
      z[j] = b.x; z[j + 1] = b.y; z[j + 2] = b.z; z[j + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const bool in = n0 + j < N;
      s[j] = in ? __ldg(srow + n0 + j) : 0.f;
      z[j] = in ? __ldg(zrow + n0 + j) : 0.f;
    }
  }
}

// acc[r][c] += x[r][k] * w[k][c] over the CPB codes of one packed row;
// xs points at the row's first k in the staged slice ([k][BM] f32).
template <int BITS, int BM, int VEC>
__device__ __forceinline__ void accumulate(const Codes<VEC>& codes,
                                           const float* xs,
                                           const float (&s)[VEC],
                                           const float (&z)[VEC],
                                           float (&acc)[BM][VEC]) {
  constexpr int CPB = codes_per_byte<BITS>();
  constexpr uint32_t MASK4 = ((1u << BITS) - 1u) * 0x01010101u;  // per byte
#pragma unroll
  for (int j = 0; j < CPB; ++j) {
    float xv[BM];
#pragma unroll
    for (int r = 0; r < BM; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xs + j * BM + r);
      xv[r] = v.x; xv[r + 1] = v.y; xv[r + 2] = v.z; xv[r + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const uint32_t word = CPB == 1 ? codes.w[q]
                                     : (codes.w[q] >> (j * BITS)) & MASK4;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = q * 4 + b;
        // 0x4B0000cc is the float 2^23 + cc: one permute and one subtract
        // give the code as a float, exactly
        const float code =
            __uint_as_float(__byte_perm(word, 0x4B00u, 0x5440u | b)) -
            8388608.f;
        const float w = fmaf(code, s[c], z[c]);
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r][c] = fmaf(xv[r], w, acc[r][c]);
      }
    }
  }
}

template <int BITS, int BM, typename T>
__global__ void __launch_bounds__(THREADS)
quant_matmul_splitk_kernel(const T* __restrict__ x,
                           const uint8_t* __restrict__ packed,
                           const float* __restrict__ scale,
                           const float* __restrict__ zmin,
                           float* __restrict__ ws, int M, int K, int N,
                           int group_size, bool vec_ok) {
  using G = SplitGeom<BM>;
  constexpr int VEC = G::VEC, U = G::U, BNS = G::BNS;
  constexpr int CPB = codes_per_byte<BITS>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int split = blockIdx.y, splits = gridDim.y;
  const int R = K / CPB;
  const int rb = (int)((long long)split * R / splits);
  const int re = (int)((long long)(split + 1) * R / splits);
  const int kb = rb * CPB, klen = (re - rb) * CPB;

  // this thread's columns and its contiguous chunk of the block's rows;
  // threads past N walk nothing
  const int n0 = blockIdx.x * BNS + tx * VEC;
  const bool full = vec_ok && n0 + VEC <= N;
  const int rpr = group_size / CPB;  // packed rows per local region
  const int lo = rb + ty * (re - rb) / TY;
  const int hi = n0 < N ? rb + (ty + 1) * (re - rb) / TY : lo;

  // the first rows of W and their region's scale/zmin go out before x is
  // staged, so their latency overlaps the staging
  Codes<VEC> cur[U];
  float s[VEC], z[VEC];
  int g = lo / rpr, gnext = (g + 1) * rpr;
  if (lo < hi)
    load_affine<VEC>(scale + (size_t)g * N, zmin + (size_t)g * N, n0, N, full,
                     s, z);
  load_batch<VEC, U>(cur, packed, lo, hi, n0, N, full);

  // stage x[0:BM, kb:kb+klen] as f32, [k][BM]; rows past M are zeros.  A
  // pass's loads all go out before any is stored: one pass holds the whole
  // slice at every llama3.2-1b shape
  constexpr int SU = 4;  // loads of x per row and thread in one pass
  for (int i0 = 0; i0 < klen; i0 += THREADS * SU) {
    float v[BM][SU];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int i = i0 + u * THREADS + tid;
        v[r][u] =
            r < M && i < klen ? to_f32(x[(size_t)r * K + kb + i]) : 0.f;
      }
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int i = i0 + u * THREADS + tid;
        if (i < klen) smem[i * BM + r] = v[r][u];
      }
  }
  __syncthreads();

  float acc[BM][VEC];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[r][c] = 0.f;

  // U rows in flight while the U before them are used
  for (int r = lo; r < hi; r += U) {
    Codes<VEC> nxt[U];
    load_batch<VEC, U>(nxt, packed, r + U, hi, n0, N, full);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int row = r + i;
      if (row < hi) {
        if (row >= gnext) {  // a new local region
          g = row / rpr;
          gnext = (g + 1) * rpr;
          load_affine<VEC>(scale + (size_t)g * N, zmin + (size_t)g * N, n0, N,
                           full, s, z);
        }
        accumulate<BITS, BM, VEC>(cur[i], smem + (row * CPB - kb) * BM, s, z,
                                  acc);
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) cur[i] = nxt[i];
  }

  // the two thread rows of a warp, then the warps, in a fixed order
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
  __syncthreads();  // every thread is done with the staged x
  float* red = smem;  // [WARPS][BM][BNS]
  const int warp = tid / 32;
  if ((tid & 31) < TX) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < VEC; c += 4) {
        float* dst = red + (warp * BM + r) * BNS + tx * VEC + c;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
      }
  }
  __syncthreads();
  const int rows = min(BM, M);
  for (int e = tid; e < rows * BNS; e += THREADS) {
    const int r = e / BNS, col = e % BNS;
    const int n = blockIdx.x * BNS + col;
    if (n < N) {
      float sum = red[r * BNS + col];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) sum += red[(w * BM + r) * BNS + col];
      ws[((size_t)split * M + r) * N + n] = sum;
    }
  }
}

template <int BITS, int BM, typename T>
int launch_splitk(const void* x, const void* packed, const void* scale,
                  const void* zmin, void* ws, void* out, int M, int K, int N,
                  int group_size, int splits, cudaStream_t stream) {
  using G = SplitGeom<BM>;
  constexpr int CPB = codes_per_byte<BITS>();
  const int R = K / CPB;
  const int widest = (R + splits - 1) / splits;
  const size_t x_bytes = (size_t)widest * CPB * BM * sizeof(float);
  const size_t red_bytes = (size_t)WARPS * BM * G::BNS * sizeof(float);
  if (M > BM || splits < 1 || splits > R || x_bytes > X_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  // wide loads need N a multiple of VEC and 16-byte aligned operands, so
  // that every thread's columns of every row start aligned
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const bool vec_ok = N % G::VEC == 0 && aligned(packed) && aligned(scale) &&
                      aligned(zmin);
  const dim3 grid((N + G::BNS - 1) / G::BNS, splits);
  quant_matmul_splitk_kernel<BITS, BM, T>
      <<<grid, THREADS, x_bytes > red_bytes ? x_bytes : red_bytes, stream>>>(
          static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
          static_cast<const float*>(scale), static_cast<const float*>(zmin),
          static_cast<float*>(ws), M, K, N, group_size, vec_ok);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return splitk_reduce<T>(static_cast<const float*>(ws), static_cast<T*>(out),
                          M * N, splits, stream);
}

template <int BITS, typename T>
int splitk_bm(int bm, const void* x, const void* packed, const void* scale,
              const void* zmin, void* ws, void* out, int M, int K, int N,
              int group_size, int splits, cudaStream_t stream) {
  if (bm == 4)
    return launch_splitk<BITS, 4, T>(x, packed, scale, zmin, ws, out, M, K, N,
                                     group_size, splits, stream);
  if (bm == 16)
    return launch_splitk<BITS, 16, T>(x, packed, scale, zmin, ws, out, M, K,
                                      N, group_size, splits, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_splitk(int bits, int bm, const void* x, const void* packed,
                    const void* scale, const void* zmin, void* ws, void* out,
                    int M, int K, int N, int group_size, int splits,
                    cudaStream_t stream) {
#define REPRO_SPLITK(B)                                                     \
  return splitk_bm<B, T>(bm, x, packed, scale, zmin, ws, out, M, K, N,      \
                         group_size, splits, stream);
  switch (bits) {
    case 1: REPRO_SPLITK(1)
    case 2: REPRO_SPLITK(2)
    case 4: REPRO_SPLITK(4)
    // a byte holds one code below 8 bits too: the 8-bit walk reads it as it is
    case 3: case 5: case 6: case 7: case 8: REPRO_SPLITK(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_SPLITK
}

template <int BITS, typename T>
void launch(const void* x, const void* packed, const void* scale,
            const void* zmin, void* out, int M, int K, int N, int group_size,
            cudaStream_t stream) {
  const dim3 block(BN, KS);
  const dim3 grid((N + BN - 1) / BN, (M + 15) / 16);
  quant_matmul_kernel<BITS, 16, T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scale), static_cast<const float*>(zmin),
      static_cast<T*>(out), M, K, N, group_size);
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

// C interface, bound with ctypes.  Each returns cudaGetLastError() after its
// launches (0 = launched).  x_bf16 selects bf16 x/out (else f32).
//
// The one-pass kernel (M > 16).
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

// The split-K kernel and its reduction (M <= bm, bm 4 or 16): ws is f32
// (splits, M, N) scratch.
extern "C" int repro_quant_matmul_splitk(const void* x, const void* packed,
                                         const void* scale, const void* zmin,
                                         void* ws, void* out, int M, int K,
                                         int N, int bits, int group_size,
                                         int bm, int splits, int x_bf16,
                                         void* stream) {
  using namespace repro_torch;
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch_splitk<__nv_bfloat16>(bits, bm, x, packed, scale, zmin, ws,
                                          out, M, K, N, group_size, splits, s);
  return dispatch_splitk<float>(bits, bm, x, packed, scale, zmin, ws, out, M,
                                K, N, group_size, splits, s);
}
