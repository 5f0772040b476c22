// paged_attention: flash-decode over the paged KV pool, wire format and all.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention.py:paged_attention (bodies _kernel_fp and
// _kernel_quant, helper _online_step).  q is (B, Lq, KV, G, D); K/V pages are
// fp (n_pages, ps, KV, D) or LQ wire pages: packed (n_pages, ps, KV, D/cpb)
// uint8 with f32 scale/zmin (n_pages, ps, KV, D/gs), at kv bits 8/4/2/1.
// table (B, P) int32 holds each slot's physical pages in order; pos (B,)
// int32 the absolute position of each slot's first query row.  Key
// p*ps + r is visible to query row i = lq*G + g iff p*ps + r <= pos[b] + lq.
// The output has q's shape and dtype.
//
// What bounds it on an H100: bytes.  Each cached token is read once per kv
// head (D*bits/8 code bytes plus 8 bytes per region) and used by the Lq*G
// query rows of that head only, a handful of operations per byte.  At
// decode a slot holds a few hundred to a few thousand tokens, so the card
// is filled only if the page walk of one (slot, kv head) is cut across
// blocks.
//
// The TPU kernel walks the pages on the sequential ("arbitrary") grid axis
// with the softmax state in VMEM scratch.  Blocks here run in no order, so
// the walk is split and the state of each split goes through device memory
// (flash-decoding), in two kernels:
//
// paged_split_kernel, one block per (slot, kv head, split, row tile).
// Split s of S covers table entries [s*P/S, (s+1)*P/S) (kernels/splitk.py
// split_rows; S from plan() in kernels/paged_attention.py, from shapes
// alone) and walks only the keys below pos[b] + Lq: a split past the slot's
// live keys writes the empty partial (m = NEG_INF, l = 0, acc = 0) and
// returns, and the keys after pos in the last live page are never read.
// The block reads pos and the table itself, so the launch needs no value
// from the device.
//   - The Lq*G query rows of the head are cut into row tiles (geometry()
//     in kernels/paged_attention.py): a tile holds up to 32 rows at
//     D <= 128, 16 up to D 512 and fewer past it, so at decode (one tile)
//     each page is read once per kv head, and beyond a tile once a tile.
//     A warp holds RT rows (4, or 2 and 1 past D 512; q in a shared-memory
//     tile, the f32 accumulator in registers), and the tile's nt warps (a
//     "row team") use the same staged keys.
//   - Bytes: each key's rows (codes, scale and zmin of K and V, or the fp
//     rows) are copied into the team's ring in shared memory by cp.async,
//     16 bytes a copy where a row's length and the pointers allow (a 4-bit
//     row of D 64 is two 16-byte copies of codes and one each of scale and
//     zmin), else 8 or 4, else plain loads (a 1-bit row of D 8 and the
//     like).  The ring holds STAGES chunks; two are in flight while the
//     warp computes on the third, and no register holds them.  Scale and
//     zmin are staged only where a lane's E elements share a region (as
//     on the serve path); else each element reads its own from global
//     memory, which keeps the ring small at any group size.
//   - Work: a key's row is cut across L lanes of E elements (E = 8, 16
//     past D 256, 32 past D 512, 96 past D 1024; L*E >= D), a "token
//     group", so a warp takes a chunk of T = 32/L keys at once.  Each
//     lane dequantizes its E codes in registers (code * scale + zmin; a
//     code becomes a float by the exponent trick, with no conversion
//     instruction), adds its RT partial dots, and the L lanes sum them by
//     shuffles.  The running max is the warp's (shuffles across its T
//     keys), so the rescale of l and acc is a uniform branch taken only
//     when the max grows (exp(0) = 1 otherwise, the same bytes as
//     rescaling always).  Masked probabilities are zero after the max
//     update, as in the TPU kernel.  Scores are scaled by log2(e) and
//     exponentiated by exp2.
//   - Up to 4 row teams ("token teams") take interleaved chunks of the
//     split when it is long enough, and at least 2 where a warp takes one
//     key a chunk (T = 1; see error_bound in kernels/paged_attention.py).
//     At the end each warp sums its T token groups by shuffles, and the
//     token teams' states are combined in team order through shared
//     memory into the split's partial (m, l, acc[R][D]) of the tile's
//     rows, f32, in the workspace.
//
// paged_combine_kernel, one thread per output element: for each row,
// M = max_s m_s, then out = sum_s acc_s 2^(m_s - M) / max(sum_s l_s
// 2^(m_s - M), 1e-30) (m in log2 units), summed in split order, in q's
// dtype.  An empty split adds exactly 0 (key 0 is always visible, so M is
// finite).  No atomics anywhere: every call, and a CUDA-graph replay,
// gives the same bytes.
//
// The Pallas body has a second dequant form, "lut" (bits <= 4), which
// rewrites q.k and p.v as sums of binary matmuls so that the TPU's matrix
// unit does the work.  It computes the same function.  Here the kernel is
// bound by bytes, not by operations, so the "affine" and "lut" selectors
// both run this one in-register-dequant kernel; whether a LUT form pays on
// Hopper is an open question in ROADMAP.md.
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr float NEG_INF = -1e30f;
constexpr int STAGES = 3;      // chunks in a ring
constexpr int MAX_WARPS = 8;   // warps a block: row teams x token teams
constexpr unsigned FULL = 0xffffffffu;

// query rows a warp holds at E elements a lane (ROWS_PER_WARP): RT*E
// accumulators a thread
__host__ __device__ constexpr int rows_per_warp(int E) {
  return E <= 16 ? 4 : E == 32 ? 2 : 1;
}

// The launch: shapes, the block's geometry (from the wrapper's geometry())
// and the byte layout of a key's slot in the ring.
struct Params {
  const void* q;
  const unsigned char *kd, *vd;     // codes or fp rows
  const unsigned char *ks, *kz, *vs, *vz;
  const int* table;
  const int* pos;
  float* ws;
  int Lq, KV, G, D, ps, P, S, gs, ng, R;  // ng regions a row
  int L, T, NT, TW;                 // lanes a key, groups a warp, teams
  int row_bytes, grp_bytes;         // a key's code (or fp) row, scale row
  int row_pad, grp_pad;             // the same in the ring (16-byte pad;
                                    // no scale rows there if GROUPED)
  int slot_bytes;                   // K then V: row (+ scale + zmin)
  int wr, wg;                       // copy widths of rows and scale rows
  int zero;                         // the slots have padding to clear
  int q_bf16, q_vec;                // q's type; 16-byte loads of q rows
  float sm_scale, inv_ps;
};

// bytes of a lane's E elements of a row
template <int BITS, typename PT, int E>
__host__ __device__ constexpr int lane_bytes() {
  return BITS == 0 ? E * (int)sizeof(PT) : E * BITS / 8;
}

// The lane's E elements of a row (codes at `row` in the ring, the row's
// scale/zmin at `sc`/`zm`), dequantized in registers.  The lane's elements
// start at element d0, in region g0 (at most ng - 1: elements past D, the
// lanes' padding, take region ng - 1, finite, and q is 0 there); unless
// GROUPED (gs not a multiple of E) they all lie in it.
template <int BITS, typename PT, bool GROUPED, int E>
__device__ __forceinline__ void load_row(const unsigned char* row,
                                         const float* sc, const float* zm,
                                         int g0, int d0, int gs, int ng,
                                         float (&x)[E]) {
  if constexpr (BITS == 0) {
    if constexpr (sizeof(PT) == 4) {
#pragma unroll
      for (int c = 0; c < E / 4; ++c) {
        const float4 v = reinterpret_cast<const float4*>(row)[c];
        x[4 * c] = v.x, x[4 * c + 1] = v.y, x[4 * c + 2] = v.z,
        x[4 * c + 3] = v.w;
      }
    } else {                          // bf16: the high half of an f32
#pragma unroll
      for (int c = 0; c < E / 8; ++c) {
        const uint4 v = reinterpret_cast<const uint4*>(row)[c];
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[8 * c + 2 * i] = __uint_as_float(w[i] << 16);
          x[8 * c + 2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      }
    }
  } else {
    constexpr unsigned MASK = (1u << BITS) - 1u;
    constexpr int NB = E * BITS / 8;  // 96 down to 1 bytes; the lane's
                                      // offset is a multiple of NB
    unsigned w[NB >= 4 ? NB / 4 : 1];
    if constexpr (NB % 16 == 0) {
#pragma unroll
      for (int c = 0; c < NB / 16; ++c) {
        const uint4 v = reinterpret_cast<const uint4*>(row)[c];
        w[4 * c] = v.x, w[4 * c + 1] = v.y, w[4 * c + 2] = v.z,
        w[4 * c + 3] = v.w;
      }
    } else if constexpr (NB % 8 == 0) {
#pragma unroll
      for (int c = 0; c < NB / 8; ++c) {
        const uint2 v = reinterpret_cast<const uint2*>(row)[c];
        w[2 * c] = v.x, w[2 * c + 1] = v.y;
      }
    } else if constexpr (NB % 4 == 0) {
#pragma unroll
      for (int c = 0; c < NB / 4; ++c)
        w[c] = reinterpret_cast<const unsigned*>(row)[c];
    } else if constexpr (NB == 2) {
      w[0] = *reinterpret_cast<const unsigned short*>(row);
    } else {
      w[0] = *row;
    }
    float s = sc[g0], z = zm[g0];
    // GROUPED: the region moves on at element `edge` of the lane, every gs
    // (counted, not divided, so no register holds a region per element)
    int g = g0, edge = (g0 + 1) * gs - d0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned code = (w[e * BITS / 32] >> ((e * BITS) % 32)) & MASK;
      // 2^23 + code as a float, minus 2^23: the code, exactly
      const float f = __uint_as_float(0x4b000000u | code) - 8388608.f;
      if constexpr (GROUPED) {
        if (e == edge) {
          g = min(g + 1, ng - 1), edge += gs;
          s = sc[g], z = zm[g];
        }
      }
      x[e] = fmaf(f, s, z);
    }
  }
}

// one copy of w bytes (16/8/4 by cp.async, 2/1 by plain loads)
__device__ __forceinline__ void copy_bytes(unsigned char* dst,
                                           const unsigned char* src, int w) {
  switch (w) {
    case 16: cp_async16(dst, src); break;
    case 8: cp_async8(dst, src); break;
    case 4: cp_async4(dst, src, 4); break;
    case 2:
      *reinterpret_cast<unsigned short*>(dst) =
          *reinterpret_cast<const unsigned short*>(src);
      break;
    default: *dst = *src;
  }
}

// Barrier of one row team (its NT warps), or the warp alone.
__device__ __forceinline__ void team_sync(int team, int nt) {
  if (nt == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(32 * nt)
                 : "memory");
  }
}

template <typename PT, int BITS, bool GROUPED, int E>
__global__ void __launch_bounds__(32 * MAX_WARPS)
paged_split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool QUANT = BITS != 0;
  constexpr int RT = rows_per_warp(E);
  const int s = blockIdx.x % p.S, tile = blockIdx.x / p.S;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rt = warp % p.NT, team = warp / p.NT;
  const int grp = lane / p.L, j = lane % p.L;
  const int d0 = j * E;
  const int R = p.R, D = p.D;
  // the block's row tile: rows row0 + [0, nrows) of the head's R
  const int tile_rows = p.NT * RT;
  const int row0 = tile * tile_rows, nrows = min(tile_rows, R - row0);
  float* ws = p.ws + ((size_t)(b * p.KV + h) * p.S + s) * (R * (D + 2));

  // the combine kernel may be scheduled now; it waits for this grid to end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int pos0 = p.pos[b];
  const int t_lo = s * p.P / p.S * p.ps;
  const int t_hi = min((s + 1) * p.P / p.S * p.ps,
                       min(pos0 + p.Lq, p.P * p.ps));
  if (t_lo >= t_hi) {                 // past the live keys: empty partial
    for (int i = tid; i < nrows; i += nthreads)
      ws[row0 + i] = NEG_INF, ws[R + row0 + i] = 0.f;
    for (int i = tid; i < nrows * D; i += nthreads)
      ws[2 * R + row0 * D + i] = 0.f;
    return;
  }

  // shared memory: each warp's q tile, then the token teams' rings
  const int ring_bytes = STAGES * p.T * p.slot_bytes;
  const int q_bytes = nthreads / 32 * RT * p.L * E * 4;
  unsigned char* rings = smem + q_bytes;
  // zero the rings once where slots have padding (past D, past a row's
  // regions): it is read as code 0 with scale and zmin 0, which adds nothing
  if (p.zero) {
    for (int i = tid * 16; i < p.TW * ring_bytes; i += nthreads * 16)
      *reinterpret_cast<uint4*>(rings + i) = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  // the warp's rows: q (0 past D and past R) and query positions
  float qr[RT][E];
  int qpos[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = row0 + rt * RT + r;
    qpos[r] = -1;                     // a row past R sees no key
    const int lq = i / p.G, g = i - lq * p.G;
    const size_t off = ((((size_t)b * p.Lq + lq) * p.KV + h) * p.G + g) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] = 0.f;
    if (i >= R) continue;
    qpos[r] = pos0 + lq;
    if (p.q_vec && d0 + E <= D) {     // 16-byte loads of the lane's E
      if (p.q_bf16) {
        const uint4* src = reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.q) + off + d0);
#pragma unroll
        for (int c = 0; c < E / 8; ++c) {
          const uint4 v = src[c];
          const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            qr[r][8 * c + 2 * k] = __uint_as_float(w[k] << 16);
            qr[r][8 * c + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
          }
        }
      } else {
        const float4* src = reinterpret_cast<const float4*>(
            static_cast<const float*>(p.q) + off + d0);
#pragma unroll
        for (int c = 0; c < E / 4; ++c) {
          const float4 v = src[c];
          qr[r][4 * c] = v.x, qr[r][4 * c + 1] = v.y, qr[r][4 * c + 2] = v.z,
          qr[r][4 * c + 3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (d0 + e < D)
          qr[r][e] = p.q_bf16
              ? to_f32(static_cast<const __nv_bfloat16*>(p.q)[off + d0 + e])
              : static_cast<const float*>(p.q)[off + d0 + e];
    }
  }
  // the warp's q tile in shared memory, float4 (r, c) of lane j at
  // (r*E/4 + c)*L + j, so that a group's lanes read 16 bytes apart
  float4* qs = reinterpret_cast<float4*>(smem) + warp * RT * p.L * (E / 4);
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < E / 4; ++c)
        qs[(r * (E / 4) + c) * p.L + j] =
            make_float4(qr[r][4 * c], qr[r][4 * c + 1], qr[r][4 * c + 2],
                        qr[r][4 * c + 3]);
  }
  __syncwarp();
  const int g0 = QUANT ? min(d0 / p.gs, p.ng - 1) : 0;

  float m[RT], l[RT], acc[RT][E];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = NEG_INF, l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  // the team's chunks: chunk k holds keys t_lo + (k*TW + team)*T + [0, T),
  // one a token group
  unsigned char* ring = rings + team * ring_bytes;
  const int step = p.TW * p.T;
  const int nk = max(0, (t_hi - t_lo - team * p.T + step - 1) / step);
  // a key's copies: its code (or fp) rows, and where a lane's elements
  // share a region (!GROUPED) its scale and zmin rows
  const int ur = p.row_bytes / p.wr;
  const int ug = QUANT && !GROUPED ? p.grp_bytes / p.wg : 0;
  const int uhalf = ur + 2 * ug;      // copies of K's (or V's) rows
  const int upt = 2 * uhalf;          // copies a key
  const int half = p.slot_bytes / 2;  // K's part of a slot, then V's
  // a group's lanes copy the key it will use: lane j of row-team warp rt
  // takes copies j + L*(rt + NT*i) (one, where a key has no more than L*NT
  // copies): source, its stride and offset, destination, width
  struct Copy {
    const unsigned char* src;
    int stride, off, dst, w;
  };
  auto decode = [&](int u) {
    const bool v = u >= uhalf;
    u -= v ? uhalf : 0;
    Copy c;
    if (u < ur) {
      c = {v ? p.vd : p.kd, p.row_bytes, u * p.wr, u * p.wr, p.wr};
    } else {
      u -= ur;
      const bool z = u >= ug;
      u -= z ? ug : 0;
      c = {v ? (z ? p.vz : p.vs) : (z ? p.kz : p.ks), p.grp_bytes, u * p.wg,
           p.row_pad + (z ? p.grp_pad : 0) + u * p.wg, p.wg};
    }
    c.dst += v ? half : 0;
    return c;
  };
  const int u_first = j + p.L * rt, u_step = p.L * p.NT;
  const Copy c0 = decode(u_first < upt ? u_first : 0);

  // the pool row of key t of this slot and head; t / ps by a float
  // reciprocal, corrected (exact below 2^24 keys)
  auto key_row = [&](int t) {
    int pg = __float2int_rz((float)t * p.inv_ps);
    pg -= pg * p.ps > t;
    pg += (pg + 1) * p.ps <= t;
    return ((size_t)p.table[(size_t)b * p.P + pg] * p.ps + (t - pg * p.ps)) *
               p.KV + h;
  };

  auto issue = [&](int k) {
    const int t = t_lo + (k * p.TW + team) * p.T + grp;
    if (k < nk && t < t_hi) {
      const size_t row = key_row(t);
      unsigned char* slot = ring + ((k % STAGES) * p.T + grp) * p.slot_bytes;
      if (u_first < upt)
        copy_bytes(slot + c0.dst, c0.src + row * c0.stride + c0.off, c0.w);
      for (int u = u_first + u_step; u < upt; u += u_step) {
        const Copy c = decode(u);
        copy_bytes(slot + c.dst, c.src + row * c.stride + c.off, c.w);
      }
    }
    cp_async_commit();                // one group a chunk, empty past nk
  };

  const int lane_off = d0 / E * lane_bytes<BITS, PT, E>();
  auto compute = [&](int k) {
    const int t = t_lo + (k * p.TW + team) * p.T + grp;  // the group's key
    const unsigned char* slot =
        ring + ((k % STAGES) * p.T + grp) * p.slot_bytes;
    // scale and zmin rows of K and V: staged after the codes, or (GROUPED)
    // in global memory, at a live key's row (a key past the split's end
    // reads the split's first, and is masked)
    const float *ks, *kz, *vs, *vz;
    if constexpr (GROUPED) {
      const size_t off = key_row(t < t_hi ? t : t_lo) * p.ng;
      ks = reinterpret_cast<const float*>(p.ks) + off;
      kz = reinterpret_cast<const float*>(p.kz) + off;
      vs = reinterpret_cast<const float*>(p.vs) + off;
      vz = reinterpret_cast<const float*>(p.vz) + off;
    } else {
      ks = reinterpret_cast<const float*>(slot + p.row_pad);
      kz = ks + p.grp_pad / 4;
      vs = reinterpret_cast<const float*>(slot + half + p.row_pad);
      vz = vs + p.grp_pad / 4;
    }
    float x[E];
    load_row<BITS, PT, GROUPED, E>(slot + lane_off, ks, kz, g0, d0, p.gs,
                                   p.ng, x);
    float sc[RT];                     // scores, then probabilities
#pragma unroll
    for (int r = 0; r < RT; ++r) {    // two chains a dot
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 qv = qs[(r * (E / 4) + e / 4) * p.L + j];
        a = fmaf(qv.x, x[e], a);
        c = fmaf(qv.y, x[e + 1], c);
        a = fmaf(qv.z, x[e + 2], a);
        c = fmaf(qv.w, x[e + 3], c);
      }
      sc[r] = a + c;
    }
    for (int o = 1; o < p.L; o <<= 1)  // the L lanes of the key
#pragma unroll
      for (int r = 0; r < RT; ++r) sc[r] += __shfl_xor_sync(FULL, sc[r], o);
    float mx[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {    // log2(e)-scaled scores
      sc[r] = t < t_hi && t <= qpos[r] ? sc[r] * p.sm_scale : NEG_INF;
      mx[r] = sc[r];
    }
    for (int o = p.L; o < 32; o <<= 1)  // the warp's keys
#pragma unroll
      for (int r = 0; r < RT; ++r)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], o));
    bool grew = false;
#pragma unroll
    for (int r = 0; r < RT; ++r) grew |= mx[r] > m[r];
    if (grew) {                       // uniform across the warp
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float mn = fmaxf(m[r], mx[r]);
        const float c = exp2f(m[r] - mn);  // 1 where this row did not grow
        l[r] *= c;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] *= c;
        m[r] = mn;
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      sc[r] = sc[r] > NEG_INF ? exp2f(sc[r] - m[r]) : 0.f;
      l[r] += sc[r];
    }
    // a key past the split's end has no copy in its slot (p = 0 there,
    // but the slot may hold any bits)
    if (t >= t_hi) return;
    load_row<BITS, PT, GROUPED, E>(slot + half + lane_off, vs, vz, g0, d0,
                                   p.gs, p.ng, x);
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = fmaf(sc[r], x[e], acc[r][e]);
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<STAGES - 2>();      // chunk k has landed (own copies)
    team_sync(team, p.NT);            // ... everyone's; chunk k-1 is done
    issue(k + STAGES - 1);            // into chunk k-1's slot
    compute(k);
  }
  cp_async_wait<0>();

  // the warp's T token groups, summed by shuffles (every lane of a group
  // holds the group's l)
  for (int o = p.L; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], o);
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[r][e] += __shfl_xor_sync(FULL, acc[r][e], o);
    }
  }

  // token teams' states through shared memory, combined in team order
  __syncthreads();                    // every ring is done
  // one team's m[n], l[n], acc[n][D] for the tile's n = tile_rows rows
  float* part = reinterpret_cast<float*>(smem);
  const int n = tile_rows, pw = n * (D + 2);
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int i = rt * RT + r;      // the row in the tile
      if (i >= nrows) continue;
      float* pt = part + team * pw;
      if (j == 0) pt[i] = m[r], pt[n + i] = l[r];
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (d0 + e < D) pt[2 * n + i * D + d0 + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nrows * D; idx += nthreads) {
    const int i = idx / D;
    float mt = NEG_INF;
    for (int w = 0; w < p.TW; ++w) mt = fmaxf(mt, part[w * pw + i]);
    float a = 0.f, lt = 0.f;
    for (int w = 0; w < p.TW; ++w) {
      const float c = exp2f(part[w * pw + i] - mt);
      a = fmaf(part[w * pw + 2 * n + idx], c, a);
      lt = fmaf(part[w * pw + n + i], c, lt);
    }
    ws[2 * R + row0 * D + idx] = a;
    if (idx - i * D == 0) ws[row0 + i] = mt, ws[R + row0 + i] = lt;
  }
}

// out[b, lq, h, g, d] for row i = lq*G + g of (b, h): the splits' partials
// combined in split order, one thread an output, COMBINE_THREADS outputs a
// block (blockIdx.y).  Launched as a programmatic dependent of the split
// kernel, so its blocks may start early; they wait for the split kernel to
// finish before reading its partials.
constexpr int COMBINE_THREADS = 256;

template <typename QT>
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_combine_kernel(const float* __restrict__ ws, QT* __restrict__ out,
                     int S, int R, int D, int Lq, int KV, int G) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int idx = blockIdx.y * COMBINE_THREADS + threadIdx.x;
  if (idx >= R * D) return;
  const int bh = blockIdx.x, b = bh / KV, h = bh - b * KV;
  const int sw = R * (D + 2);
  const float* base = ws + (size_t)bh * S * sw;
  constexpr int CB = 16;                 // splits whose loads go together
  const int i = idx / D, d = idx - i * D;
  // split s0 + c's m, l and acc, 0-weighted past S
  float mm[CB], ll[CB], aa[CB];
  auto load = [&](int s0) {
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const float* w = base + (size_t)(s0 + c) * sw;
      const bool in = s0 + c < S;
      mm[c] = in ? w[i] : NEG_INF;
      ll[c] = in ? w[R + i] : 0.f;
      aa[c] = in ? w[2 * R + idx] : 0.f;
    }
  };
  load(0);
  float mt = NEG_INF;
#pragma unroll
  for (int c = 0; c < CB; ++c) mt = fmaxf(mt, mm[c]);
  for (int s0 = CB; s0 < S; ++s0) mt = fmaxf(mt, base[(size_t)s0 * sw + i]);
  float a = 0.f, lt = 0.f;
  for (int s0 = 0; s0 < S; s0 += CB) {
    if (s0) load(s0);
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      if (s0 + c >= S) break;
      const float e = exp2f(mm[c] - mt);  // 0 for an empty split
      a = fmaf(aa[c], e, a);
      lt = fmaf(ll[c], e, lt);
    }
  }
  const int lq = i / G, g = i - lq * G;
  out[((((size_t)b * Lq + lq) * KV + h) * G + g) * D + d] =
      from_f32<QT>(a / fmaxf(lt, 1e-30f));
}

template <typename QT>
int launch_combine(const float* ws, void* out, int B, int S, int R, int D,
                   int Lq, int KV, int G, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV, (R * D + COMBINE_THREADS - 1) / COMBINE_THREADS);
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, paged_combine_kernel<QT>, ws,
                                 static_cast<QT*>(out), S, R, D, Lq, KV, G);
}

// the widest copy (16, 8, 4, 2 or 1 bytes) that divides n and keeps every
// pointer aligned
int copy_width(int n, std::initializer_list<const void*> ptrs) {
  int w = 16;
  for (const void* q : ptrs)
    while (w > 1 && ((uintptr_t)q % w || n % w)) w >>= 1;
  while (w > 1 && n % w) w >>= 1;
  return w;
}

int pad16(int n) { return (n + 15) / 16 * 16; }

template <typename PT, int BITS, bool GROUPED, int E>
int launch_split(Params p, int B, int tiles, cudaStream_t stream) {
  constexpr int RT = rows_per_warp(E);
  const int dp = p.L * E;                     // D padded to the lanes
  p.row_pad = pad16(dp * lane_bytes<BITS, PT, E>() / E);
  p.wr = copy_width(p.row_bytes, {p.kd, p.vd});
  if (BITS) {
    p.ng = p.D / p.gs;
    p.grp_bytes = 4 * p.ng;
    // staged only where a lane's elements share a region
    p.grp_pad = GROUPED ? 0 : pad16(p.grp_bytes);
    p.wg = copy_width(p.grp_bytes, {p.ks, p.kz, p.vs, p.vz});
  } else {
    p.ng = 1, p.grp_bytes = p.grp_pad = 0, p.wg = 1;
  }
  // a slot's stride modulo 128 bytes puts the T groups' reads of a row in
  // different banks (a group reads L * lane_bytes contiguous bytes)
  int shift = (p.L * lane_bytes<BITS, PT, E>() + 31) / 32 * 32;
  if (shift >= 128) shift = 0;
  p.slot_bytes = 2 * (p.row_pad + 2 * p.grp_pad);
  while (p.slot_bytes % 128 != shift) p.slot_bytes += 32;
  p.zero = p.row_pad > p.row_bytes || p.grp_pad > p.grp_bytes;
  const size_t ring = (size_t)p.NT * p.TW * RT * p.L * E * sizeof(float)
                      + (size_t)p.TW * STAGES * p.T * p.slot_bytes;
  const size_t part =
      (size_t)p.TW * p.NT * RT * (p.D + 2) * sizeof(float);
  const size_t smem = ring > part ? ring : part;
  auto kernel = paged_split_kernel<PT, BITS, GROUPED, E>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(p.S * tiles, p.KV, B), 32 * p.NT * p.TW, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// E elements a lane, from the wrapper's geometry(); at E 8 and 16 a lane's
// elements lie in one region when gs is a multiple of E, and the E 32 and
// 96 blocks (D past 512) find each element's region
template <typename PT, int BITS>
int launch_format(const Params& p, int B, int E, int tiles, cudaStream_t st) {
  constexpr bool Q = BITS != 0;
  switch (E) {
    case 8:
      return p.gs % 8 == 0 ? launch_split<PT, BITS, false, 8>(p, B, tiles, st)
                           : launch_split<PT, BITS, Q, 8>(p, B, tiles, st);
    case 16:
      return p.gs % 16 == 0
                 ? launch_split<PT, BITS, false, 16>(p, B, tiles, st)
                 : launch_split<PT, BITS, Q, 16>(p, B, tiles, st);
    case 32: return launch_split<PT, BITS, Q, 32>(p, B, tiles, st);
    case 96: return launch_split<PT, BITS, Q, 96>(p, B, tiles, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// C interface, bound with ctypes.  bits 0 = fp pages (page_bf16 picks their
// dtype), else wire pages at 8/4/2/1 bits; for fp pages the scale/zmin
// pointers are unused.  ws is f32 scratch of B*KV*splits*R*(D+2) floats;
// E, L, T, nt, tw and tiles are the block geometry the wrapper decided
// (geometry() in kernels/paged_attention.py), checked here.  Returns the
// first CUDA error of the two launches (0 = both launched).
extern "C" int repro_paged_attention(
    const void* q, const void* kd, const void* ks, const void* kz,
    const void* vd, const void* vs, const void* vz, const void* table,
    const void* pos, void* ws, void* out, int B, int Lq, int KV, int G,
    int D, int ps, int P, int bits, int gs, int splits, int E, int L, int T,
    int nt, int tw, int tiles, int q_bf16, int page_bf16, float sm_scale,
    void* stream) {
  using namespace repro_torch;
  Params p{};
  p.q = q;
  p.kd = static_cast<const unsigned char*>(kd);
  p.vd = static_cast<const unsigned char*>(vd);
  p.ks = static_cast<const unsigned char*>(ks);
  p.kz = static_cast<const unsigned char*>(kz);
  p.vs = static_cast<const unsigned char*>(vs);
  p.vz = static_cast<const unsigned char*>(vz);
  p.table = static_cast<const int*>(table);
  p.pos = static_cast<const int*>(pos);
  p.ws = static_cast<float*>(ws);
  p.Lq = Lq, p.KV = KV, p.G = G, p.D = D, p.ps = ps, p.P = P, p.S = splits;
  p.gs = gs, p.R = Lq * G;
  p.L = L, p.T = T, p.NT = nt, p.TW = tw;
  // scores in base 2: exp2 of log2(e)-scaled scores
  p.q_bf16 = q_bf16, p.sm_scale = sm_scale * 1.4426950408889634f;
  p.inv_ps = 1.f / ps;
  const int qb = q_bf16 ? 2 : 4;
  p.q_vec = (uintptr_t)q % 16 == 0 && D * qb % 16 == 0;
  const long tile_rows = (long)nt * rows_per_warp(E);
  if (L * E < D || L < 1 || 32 % L || T * L != 32 || nt < 1 || tw < 1 ||
      nt * tw > MAX_WARPS || tiles < 1 || tiles * tile_rows < p.R ||
      (tiles - 1) * tile_rows >= p.R || (long)splits * tiles > 0x7fffffffL ||
      (long)p.R * D > 65535L * COMBINE_THREADS)
    return (int)cudaErrorInvalidValue;
  p.row_bytes = bits ? D * bits / 8 : D * (page_bf16 ? 2 : 4);
  auto st = static_cast<cudaStream_t>(stream);
  int err;
  switch (bits) {
    case 0:
      err = page_bf16 ? launch_format<__nv_bfloat16, 0>(p, B, E, tiles, st)
                      : launch_format<float, 0>(p, B, E, tiles, st);
      break;
    case 1: err = launch_format<uint8_t, 1>(p, B, E, tiles, st); break;
    case 2: err = launch_format<uint8_t, 2>(p, B, E, tiles, st); break;
    case 4: err = launch_format<uint8_t, 4>(p, B, E, tiles, st); break;
    case 8: err = launch_format<uint8_t, 8>(p, B, E, tiles, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  err = q_bf16 ? launch_combine<__nv_bfloat16>(p.ws, out, B, splits, p.R, D,
                                               Lq, KV, G, st)
               : launch_combine<float>(p.ws, out, B, splits, p.R, D, Lq, KV,
                                       G, st);
  if (err) return err;
  return (int)cudaGetLastError();
}
