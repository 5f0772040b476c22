// paged_attention: flash-decode over the paged KV pool, wire format and all.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py:paged_attention (bodies _kernel_fp and
// _kernel_quant, helper _online_step).  q is (B, Lq, KV, G, D); K/V pages are
// fp (n_pages, ps, KV, D) or LQ wire pages: packed (n_pages, ps, KV, D/cpb)
// uint8 with f32 scale/zmin (n_pages, ps, KV, D/gs), at kv bits 8/4/2/1.
// table (B, P) int32 holds each slot's physical pages in order; pos (B,)
// int32 the absolute position of each slot's first query row.  Key
// p*ps + r is visible to query row (lq, g) iff p*ps + r <= pos[b] + lq.
// The output has q's shape and dtype.
//
// What bounds it on an H100: bytes.  Each cached token is read once per kv
// head (D*bits/8 code bytes plus 8 bytes per region) and used by the G*Lq
// query rows of that head only, a handful of operations per byte.
//
// Design: one block per (slot, kv head); the block holds all Lq*G query
// rows of that head, so each page is read from memory once and serves
// every GQA group and every query of a speculative run.  The block walks
// its table entries in order and stops at the slot's last live page
// (pages past it are all masked).  A page's K and V rows are dequantized
// in registers (code * scale + zmin) into shared memory as f32, never as an
// fp page in device memory.  Scores, the running max, the denominator and
// the accumulator are f32; masked probabilities are set to zero after the
// running-max update, so a page whose keys are all masked (scratch page 0
// behind a padded table entry) adds nothing.
//
// The Pallas body has a second dequant form, "lut" (bits <= 4), which
// rewrites q.k and p.v as sums of binary matmuls so that the TPU's matrix
// unit does the work.  It computes the same function.  Here the kernel is
// bound by bytes, not by operations, so the "affine" and "lut" selectors
// both run this one in-register-dequant kernel; whether a LUT form pays on
// Hopper is an open question in ROADMAP.md.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;

// Element d of cache row `row` (= (page * ps + r) * KV + head) as f32.
template <int BITS, typename PT>
__device__ __forceinline__ float load_kv(const PT* __restrict__ data,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ zmin,
                                         size_t row, int d, int D, int gs) {
  if constexpr (BITS == 0) {
    return to_f32(data[row * D + d]);
  } else {
    constexpr int CPB = codes_per_byte<BITS>();
    constexpr unsigned MASK = (1u << BITS) - 1u;
    const unsigned byte = data[row * (D / CPB) + d / CPB];
    const float code = (float)((byte >> ((d % CPB) * BITS)) & MASK);
    const size_t reg = row * (D / gs) + d / gs;
    return code * scale[reg] + zmin[reg];
  }
}

// BITS == 0: fp pages of type PT; else wire pages (PT = uint8_t).
template <typename QT, typename PT, int BITS>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const QT* __restrict__ q, const PT* __restrict__ kd,
                       const float* __restrict__ ks,
                       const float* __restrict__ kz,
                       const PT* __restrict__ vd,
                       const float* __restrict__ vs,
                       const float* __restrict__ vz,
                       const int* __restrict__ table,
                       const int* __restrict__ pos, QT* __restrict__ out,
                       int Lq, int KV, int G, int D, int ps, int P, int gs,
                       float sm_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int R = Lq * G;
  const int DK = D + 1;                // padded K row: no bank conflicts
  float* q_s = smem;                   // R * D
  float* acc = q_s + R * D;            // R * D
  float* k_s = acc + R * D;            // ps * DK
  float* v_s = k_s + ps * DK;          // ps * D
  float* s_s = v_s + ps * D;           // R * ps scores, then probabilities
  float* m_s = s_s + R * ps;           // R running max
  float* l_s = m_s + R;                // R running denominator
  float* c_s = l_s + R;                // R this page's correction factor
  const int tid = threadIdx.x;

  // row i = lq * G + g of this head; q/out index ((b, lq, h, g), d)
  for (int e = tid; e < R * D; e += THREADS) {
    const int i = e / D, d = e % D;
    const int lq = i / G, g = i % G;
    q_s[e] = to_f32(q[((((size_t)b * Lq + lq) * KV + h) * G + g) * D + d]);
    acc[e] = 0.f;
  }
  for (int i = tid; i < R; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  const int p0 = pos[b];
  const int n_live = min(P, (p0 + Lq - 1) / ps + 1);
  __syncthreads();

  for (int p = 0; p < n_live; ++p) {
    const size_t page = (size_t)table[(size_t)b * P + p];
    for (int e = tid; e < ps * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const size_t row = (page * ps + r) * KV + h;
      k_s[r * DK + d] = load_kv<BITS>(kd, ks, kz, row, d, D, gs);
      v_s[e] = load_kv<BITS>(vd, vs, vz, row, d, D, gs);
    }
    __syncthreads();
    for (int e = tid; e < R * ps; e += THREADS) {
      const int i = e / ps, r = e % ps;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += q_s[i * D + d] * k_s[r * DK + d];
      s_s[e] = dot * sm_scale;
    }
    __syncthreads();
    for (int i = tid; i < R; i += THREADS) {
      const int qpos = p0 + i / G;
      const int kpos0 = p * ps;
      float mx = m_s[i];
      for (int r = 0; r < ps; ++r)
        if (kpos0 + r <= qpos) mx = fmaxf(mx, s_s[i * ps + r]);
      float sum = 0.f;
      for (int r = 0; r < ps; ++r) {
        const float pr = (kpos0 + r <= qpos) ? expf(s_s[i * ps + r] - mx) : 0.f;
        s_s[i * ps + r] = pr;
        sum += pr;
      }
      const float corr = expf(m_s[i] - mx);
      l_s[i] = l_s[i] * corr + sum;
      m_s[i] = mx;
      c_s[i] = corr;
    }
    __syncthreads();
    for (int e = tid; e < R * D; e += THREADS) {
      const int i = e / D, d = e % D;
      float pv = 0.f;
      for (int r = 0; r < ps; ++r) pv += s_s[i * ps + r] * v_s[r * D + d];
      acc[e] = acc[e] * c_s[i] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < R * D; e += THREADS) {
    const int i = e / D, d = e % D;
    const int lq = i / G, g = i % G;
    out[((((size_t)b * Lq + lq) * KV + h) * G + g) * D + d] =
        from_f32<QT>(acc[e] / fmaxf(l_s[i], 1e-30f));
  }
}

struct Args {
  const void *q, *kd, *ks, *kz, *vd, *vs, *vz, *table, *pos;
  void* out;
  int B, Lq, KV, G, D, ps, P, gs;
  float sm_scale;
  size_t smem;
  cudaStream_t stream;
};

template <typename QT, typename PT, int BITS>
int launch(const Args& a) {
  const dim3 grid(a.B, a.KV);
  paged_attention_kernel<QT, PT, BITS><<<grid, THREADS, a.smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const PT*>(a.kd),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.kz),
      static_cast<const PT*>(a.vd), static_cast<const float*>(a.vs),
      static_cast<const float*>(a.vz), static_cast<const int*>(a.table),
      static_cast<const int*>(a.pos), static_cast<QT*>(a.out), a.Lq, a.KV,
      a.G, a.D, a.ps, a.P, a.gs, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename QT>
int dispatch(const Args& a, int bits, int page_bf16) {
  switch (bits) {
    case 0:
      return page_bf16 ? launch<QT, __nv_bfloat16, 0>(a)
                       : launch<QT, float, 0>(a);
    case 1: return launch<QT, uint8_t, 1>(a);
    case 2: return launch<QT, uint8_t, 2>(a);
    case 4: return launch<QT, uint8_t, 4>(a);
    case 8: return launch<QT, uint8_t, 8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes.  bits 0 = fp pages (page_bf16 picks their
// dtype), else wire pages at 8/4/2/1 bits; for fp pages the scale/zmin
// pointers are unused.  smem is the dynamic shared memory the caller
// computed.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int repro_paged_attention(
    const void* q, const void* kd, const void* ks, const void* kz,
    const void* vd, const void* vs, const void* vz, const void* table,
    const void* pos, void* out, int B, int Lq, int KV, int G, int D, int ps,
    int P, int bits, int gs, int q_bf16, int page_bf16, float sm_scale,
    long long smem, void* stream) {
  using namespace repro_torch;
  const Args a{q,  kd, ks, kz, vd, vs, vz, table, pos, out,
               B,  Lq, KV, G,  D,  ps, P,  gs,    sm_scale,
               (size_t)smem, static_cast<cudaStream_t>(stream)};
  if (q_bf16) return dispatch<__nv_bfloat16>(a, bits, page_bf16);
  return dispatch<float>(a, bits, page_bf16);
}
