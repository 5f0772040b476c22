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
// The affine is linear, so a region may also be cut into parts, each adding
// s * sum_v v * T[v](part) + zmin * sum_{j in part} w_j: the parts sum to
// the whole.
//
// The TPU kernel walks the regions on a sequential grid axis into a VMEM
// accumulator and builds the table as one binary matmul per code value.
// Here each thread builds its tables in registers: per K row, the code of
// each of its rows is extracted and compared with every v once, and each
// table entry of its columns takes one predicated add of w (the binary
// mask_v @ W), unrolled over rows, values and columns so that the table is
// never indexed by the code (which would put it in local memory).  The
// codes are unpacked here, not by the caller.
//
// What bounds it on an H100: at decode (M = the slots) bytes, the f32 w
// (4 bytes per weight, ~243 MB per llama3.2-1b layer) read once, so the card
// needs ~2-3 MB of loads in flight and blocks on every SM; at prefill
// (M = 176) the CUDA-core adds of the table build, at least one f32 add per
// (m, k, n), against the 67 TFLOP/s f32 peak (the tensor cores take no part
// in a table build).
//
// Two kernels, chosen by M in the wrapper (kernels/lut_matmul.py):
//
// M <= 16, every decode step: split K.  A block of 64 threads owns a strip
// of 256 columns, BM rows (a tile of M) and one contiguous range of packed
// code bytes (split s of S: bytes [s*R/S, (s+1)*R/S)), which may cover part
// of a region; plan() picks S so that every llama3.2-1b projection has at
// least 132 blocks at M = 4, and so that no sum has more terms than
// error_bound counts (a region cut into P parts sums R/P + G*P terms, no
// more than R + G while P <= R/G).
//   - Wide loads, many in flight: each thread owns 4 adjacent columns and
//     copies them from a row of w as one 16-byte cp.async (a warp moves 512
//     contiguous bytes) into its own slots of a ring in shared memory, 24
//     rows deep, so that 16-22 rows (256-352 bytes a thread) are in flight
//     while it uses the batch that has landed, with no register holding
//     them.  Columns past a ragged N, or an N or w pointer not 16-byte
//     aligned, take 4-byte copies (zero-filled past N) in the same walk.
//     The code bytes of the next batch load into registers meanwhile.
//   - Shared compares: a thread's rows and K rows are its warp's, so each
//     code is extracted, and compared with each v, once per (row, K row) for
//     the thread's 4 columns: 4 x BM x V predicated adds and 4 adds of
//     sum_j w_j per K row.  The tables take 4 x BM x V registers; BM is 4
//     at 2 bits (48 table floats), 8 at 1, 2 at 3 and 1 at 4 bits, and the
//     row tiles of one strip and split are neighbours in the grid, so that
//     they read w from L2.  Measured, these adds and compares, not bytes,
//     bound the walk: at M = 4 it streams w at under 2 TB/s, and at M = 16
//     or 4 bits, with four times the adds, it is slower than a library
//     f32 matmul (PERF.md).
//   - At each region boundary the thread adds the part's s * sum_v v*T[v] +
//     zmin * sum w to its sums (s and zmin were loaded when the region began)
//     and clears the tables.  Each split writes its f32 partial tile to a
//     workspace (S, M, N) and the reduction of common.cuh sums the splits in
//     a fixed order.  No atomics: every call gives the same bytes, and a
//     CUDA graph captures both launches.
//
// M > 16, the prefill bucket: one pass.  A block owns a BM x 32 output tile
// (BM 16 at 1-2 bits, 8 at 3, 4 at 4 bits), lane n of a warp owns column n,
// and its 8 warps walk every 8th region (warp w: w, w+8, ...), meeting in
// shared memory at the end.  Per region each thread builds the table of every
// row it owns with masked selects, t[r][v] += (code == v) ? w : 0, keeps
// sum_j w_j, and adds s*sum_v v*t[v] + zmin*sum_w into its f32 sum.  What it
// leaves on the table (a later PR's work): w is re-read from L2 by every
// BM-row tile, and each table entry costs a select and an add where the
// paper's scatter costs one add.
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


// ---------------------------------------------------------------------------
// M <= 16: split K, w streamed by cp.async, tables shared by 4 columns
// ---------------------------------------------------------------------------

constexpr int SPLIT_THREADS = 64;  // a block's threads, all across N
constexpr int CW = 4;              // columns per thread: one float4 of a w row
constexpr int SPLIT_COLS = SPLIT_THREADS * CW;  // plan: BLOCK_COLS
constexpr int RING_ROWS = 24;      // rows of w a thread holds in shared memory

template <int BITS> struct SplitWalk {
  static constexpr int CPB = codes_per_byte<BITS>();
  // code bytes per row in one batch, and the K rows they hold (8 at 1 bit,
  // 4 at 2, 2 at 3, 4 at 4 bits): small batches wait on fewer rows at a
  // time and hold fewer code registers
  static constexpr int UB = BITS >= 3 ? 2 : 1;
  static constexpr int UK = UB * CPB;
  // batches in the ring: all but one are in flight while one is used
  static constexpr int STAGES = RING_ROWS / UK;
};

// The ring is filled by cp.async (common.cuh): each thread waits only for
// its own copies and reads only what it copied, so it needs no barrier.

template <int BITS, int BM>
__global__ void __launch_bounds__(SPLIT_THREADS)
lut_matmul_splitk_kernel(const uint8_t* __restrict__ codes,
                         const float* __restrict__ scale,
                         const float* __restrict__ zmin,
                         const float* __restrict__ w, float* __restrict__ ws,
                         int M, int K, int N, int group_size, bool vec_ok) {
  using S = SplitWalk<BITS>;
  constexpr int CPB = S::CPB, UB = S::UB, UK = S::UK, STAGES = S::STAGES;
  constexpr unsigned MASK = (1u << BITS) - 1u;
  constexpr int V = (1 << BITS) - 1;  // table entries v = 1..V (0 adds nothing)
  // slot [stage][row][thread]: a warp's reads of one row are contiguous
  __shared__ float4 ring[STAGES][UK][SPLIT_THREADS];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int rows = min(BM, M - m0);
  const int n0 = blockIdx.y * SPLIT_COLS + tid * CW;
  if (n0 >= N) return;  // no barrier below: idle threads leave at once
  const bool full = vec_ok && n0 + CW <= N;
  const int split = blockIdx.z, splits = gridDim.z;
  const int kp = K / CPB;              // code bytes per row
  const int bb = (int)((long long)split * kp / splits);
  const int be = (int)((long long)(split + 1) * kp / splits);
  const int G = K / group_size;
  const int rb = group_size / CPB;     // code bytes per region
  const uint8_t* cm = codes + (size_t)m0 * kp;

  // the rows of the batch from code byte b on into ring stage st (none
  // past the split's end); columns past N are zero-filled
  auto stage = [&](int st, int b) {
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      if (b + i < be) {
#pragma unroll
        for (int j = 0; j < CPB; ++j) {
          const float* src = w + (size_t)((b + i) * CPB + j) * N + n0;
          float4* dst = &ring[st][i * CPB + j][tid];
          if (full) {
            cp_async16(dst, src);
          } else {
#pragma unroll
            for (int c = 0; c < CW; ++c)
              cp_async4(reinterpret_cast<float*>(dst) + c,
                        n0 + c < N ? src + c : w, n0 + c < N ? 4 : 0);
          }
        }
      }
    }
    cp_async_commit();  // one group per batch, empty past the end
  };
  // the code bytes [b, b + UB) of the tile's rows (0 past the split's end or
  // past M: code 0 adds nothing)
  auto load_codes = [&](unsigned (&c)[BM][UB], int b) {
#pragma unroll
    for (int i = 0; i < UB; ++i)
#pragma unroll
      for (int r = 0; r < BM; ++r)
        c[r][i] = b + i < be && r < rows ? __ldg(cm + (size_t)r * kp + b + i)
                                         : 0u;
  };

  float t[BM][V][CW], wsum[CW], acc[BM][CW];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      acc[r][c] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) t[r][v][c] = 0.f;
    }
#pragma unroll
  for (int c = 0; c < CW; ++c) wsum[c] = 0.f;

  // the region of the walk's byte, its end, and its rows' scale and zmin
  int g = bb / rb, gend = (g + 1) * rb;
  float s[BM], z[BM];
  auto load_affine = [&]() {
#pragma unroll
    for (int r = 0; r < BM; ++r) {
      s[r] = r < rows ? __ldg(scale + (size_t)(m0 + r) * G + g) : 0.f;
      z[r] = r < rows ? __ldg(zmin + (size_t)(m0 + r) * G + g) : 0.f;
    }
  };
  // the part of region g that ends here: its terms into acc, tables cleared
  auto flush = [&]() {
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        float code_dot = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          code_dot += (float)(v + 1) * t[r][v][c];
          t[r][v][c] = 0.f;
        }
        acc[r][c] += s[r] * code_dot + z[r] * wsum[c];
      }
#pragma unroll
    for (int c = 0; c < CW; ++c) wsum[c] = 0.f;
  };
  // the batch from code byte b on (its rows of w in ring stage st, its code
  // bytes in c) into the tables
  auto use = [&](int st, const unsigned (&c)[BM][UB], int b) {
#pragma unroll
    for (int i = 0; i < UB; ++i) {
      if (b + i < be) {
        if (b + i == gend) {  // a new region
          flush();
          ++g;
          gend += rb;
          load_affine();
        }
#pragma unroll
        for (int j = 0; j < CPB; ++j) {
          const float4 w4 = ring[st][i * CPB + j][tid];
          const float wv[CW] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int q = 0; q < CW; ++q) wsum[q] += wv[q];
#pragma unroll
          for (int r = 0; r < BM; ++r) {
            const unsigned code = (c[r][i] >> (j * BITS)) & MASK;
#pragma unroll
            for (int v = 0; v < V; ++v)
              if (code == (unsigned)(v + 1)) {
#pragma unroll
                for (int q = 0; q < CW; ++q) t[r][v][q] += wv[q];
              }
          }
        }
      }
    }
  };

  // STAGES - 1 batches of w in flight while one is used; the codes of the
  // next batch load while this one is used
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) stage(st, bb + st * UB);
  unsigned c0[BM][UB], c1[BM][UB];
  load_codes(c0, bb);
  load_affine();
  int st = 0;
  auto step = [&](const unsigned (&cur)[BM][UB], unsigned (&nxt)[BM][UB],
                  int b) {
    stage(st == 0 ? STAGES - 1 : st - 1, b + (STAGES - 1) * UB);
    load_codes(nxt, b + UB);
    cp_async_wait<STAGES - 1>();  // batch b has landed
    use(st, cur, b);
    st = st == STAGES - 1 ? 0 : st + 1;
  };
  for (int b = bb; b < be; b += 2 * UB) {
    step(c0, c1, b);
    step(c1, c0, b + UB);
  }
  cp_async_wait<0>();  // no copy outlives the block
  flush();

#pragma unroll
  for (int r = 0; r < BM; ++r) {
    if (r >= rows) break;
    float* dst = ws + ((size_t)split * M + m0 + r) * N + n0;
    if (full) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (n0 + c < N) dst[c] = acc[r][c];
    }
  }
}

template <int BITS, int BM>
int launch_splitk(const void* codes, const void* scale, const void* zmin,
                  const void* w, void* ws, void* out, int M, int K, int N,
                  int group_size, int splits, cudaStream_t stream) {
  constexpr int CPB = codes_per_byte<BITS>();
  const int kp = K / CPB;
  if (M < 1 || N < 1 || group_size < CPB || group_size % CPB ||
      K % group_size || splits < 1 || splits > kp || splits > 65535)
    return (int)cudaErrorInvalidValue;
  // float4 loads need N a multiple of 4 and a 16-byte aligned w, so that
  // every thread's columns of every row start aligned
  const bool vec_ok = N % CW == 0 && (uintptr_t)w % 16 == 0;
  const dim3 grid((M + BM - 1) / BM, (N + SPLIT_COLS - 1) / SPLIT_COLS,
                  splits);
  lut_matmul_splitk_kernel<BITS, BM><<<grid, SPLIT_THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(scale),
      static_cast<const float*>(zmin), static_cast<const float*>(w),
      static_cast<float*>(ws), M, K, N, group_size, vec_ok);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return splitk_reduce<float>(static_cast<const float*>(ws),
                              static_cast<float*>(out), M * N, splits,
                              stream);
}

// the row tiles each bit width is built for (plan: BM_MAX and below)
template <int BITS>
int splitk_bm(int bm, const void* codes, const void* scale, const void* zmin,
              const void* w, void* ws, void* out, int M, int K, int N,
              int group_size, int splits, cudaStream_t stream) {
#define REPRO_LUT_SPLITK(B)                                                  \
  if (bm == B)                                                               \
    return launch_splitk<BITS, B>(codes, scale, zmin, w, ws, out, M, K, N,   \
                                  group_size, splits, stream);
  REPRO_LUT_SPLITK(1)
  if constexpr (BITS <= 3) { REPRO_LUT_SPLITK(2) }
  if constexpr (BITS <= 2) { REPRO_LUT_SPLITK(4) }
  if constexpr (BITS == 1) { REPRO_LUT_SPLITK(8) }
#undef REPRO_LUT_SPLITK
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes.  Each returns cudaGetLastError() after its
// launches (0 = launched); bits outside 1..4 return cudaErrorInvalidValue.
//
// The one-pass kernel (M > 16).
extern "C" int repro_lut_matmul(const void* codes, const void* scale,
                                const void* zmin, const void* w, void* out,
                                int M, int K, int N, int bits, int group_size,
                                void* stream) {
  using namespace repro_torch;
  auto s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return launch<1, 16>(codes, scale, zmin, w, out, M, K, N, group_size, s);
    case 2: return launch<2, 16>(codes, scale, zmin, w, out, M, K, N, group_size, s);
    case 3: return launch<3, 8>(codes, scale, zmin, w, out, M, K, N, group_size, s);
    case 4: return launch<4, 4>(codes, scale, zmin, w, out, M, K, N, group_size, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The split-K kernel and its reduction (M <= 16; bm rows per tile, 1-8 as
// plan() gives them): ws is f32 (splits, M, N) scratch.
extern "C" int repro_lut_matmul_splitk(const void* codes, const void* scale,
                                       const void* zmin, const void* w,
                                       void* ws, void* out, int M, int K,
                                       int N, int bits, int group_size, int bm,
                                       int splits, void* stream) {
  using namespace repro_torch;
  auto s = static_cast<cudaStream_t>(stream);
#define REPRO_LUT_BITS(B)                                                    \
  case B:                                                                    \
    return splitk_bm<B>(bm, codes, scale, zmin, w, ws, out, M, K, N,         \
                        group_size, splits, s);
  switch (bits) {
    REPRO_LUT_BITS(1)
    REPRO_LUT_BITS(2)
    REPRO_LUT_BITS(3)
    REPRO_LUT_BITS(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_LUT_BITS
}
