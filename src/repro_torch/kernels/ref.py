"""Plain PyTorch versions of the kernels' arithmetic (port of
``repro/kernels/ref.py``).

Weight wire format ("QWeight"), regions along the contraction axis K:

    packed : uint8 (K // codes_per_byte, N)   codes packed along K
    scale  : f32   (G, N)   G = K // group_size
    zmin   : f32   (G, N)

Activation wire format ("QAct"), regions along each row:

    packed : uint8 (M, K // codes_per_byte)   codes packed along K
    scale  : f32   (M, G)
    zmin   : f32   (M, G)
"""
from __future__ import annotations

import torch

from ..core import packing

NEG_INF = -1e30


def quantize_weight(w: torch.Tensor, bits: int, group_size: int):
    """f32 (K, N) -> (packed (K/cpb, N), scale (G, N), zmin (G, N)).

    Rounding is half-to-even (``torch.round``, as ``jnp.round``); ``scale``
    is 1 where a region's range is 0.
    """
    k, n = w.shape
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    g = k // group_size
    wf = w.to(torch.float32).reshape(g, group_size, n)
    xmin = wf.amin(1)                                       # (G, N)
    xmax = wf.amax(1)
    scale = packing.step_size(xmax - xmin, bits)
    codes = torch.clamp(torch.round((wf - xmin[:, None]) / scale[:, None]),
                        0, (1 << bits) - 1).to(torch.uint8).reshape(k, n)
    packed = packing.pack(codes.T, bits).T.contiguous()     # pack along K
    return packed, scale, xmin


def dequantize_weight(packed, scale, zmin, bits: int, group_size: int,
                      dtype=torch.float32):
    """Inverse of :func:`quantize_weight` -> (K, N) in ``dtype``."""
    n = packed.shape[1]
    codes = packing.unpack(packed.T, bits).T.to(torch.float32)   # (K, N)
    k = codes.shape[0]
    g = k // group_size
    wf = (codes.reshape(g, group_size, n) * scale[:, None]
          + zmin[:, None]).reshape(k, n)
    return wf.to(dtype)


def quant_matmul(x, packed, scale, zmin, *, bits: int, group_size: int):
    """x (M, K) @ dequant(w), summed in f32, returned in x's dtype."""
    w = dequantize_weight(packed, scale, zmin, bits, group_size)
    return (x.to(torch.float32) @ w).to(x.dtype)


def act_quant(x, *, bits: int, group_size: int):
    """Runtime activation quantization, per row and per local region:
    x (M, K) -> (packed (M, K/cpb) uint8, scale (M, G), zmin (M, G)).

    Same rounding as :func:`quantize_weight`: half-to-even, scale 1 where
    a region's range is 0, true division by a tensor."""
    m, k = x.shape
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    g = k // group_size
    xf = x.to(torch.float32).reshape(m, g, group_size)
    xmin = xf.amin(-1)                                      # (M, G)
    xmax = xf.amax(-1)
    scale = packing.step_size(xmax - xmin, bits)
    codes = torch.clamp(torch.round((xf - xmin[..., None]) / scale[..., None]),
                        0, (1 << bits) - 1).to(torch.uint8).reshape(m, k)
    return packing.pack(codes, bits), scale, xmin


def act_dequant(packed, scale, zmin, *, bits: int, group_size: int):
    """Inverse of :func:`act_quant` -> f32 (M, K)."""
    codes = packing.unpack(packed, bits).to(torch.float32)      # (M, K)
    m, k = codes.shape
    g = k // group_size
    return (codes.reshape(m, g, group_size) * scale[..., None]
            + zmin[..., None]).reshape(m, k)


def lut_matmul(a_packed, a_scale, a_zmin, w, *, bits: int, group_size: int):
    """dequant(a) @ w in f32 by explicit dequantization (the oracle of the
    LUT forward; ``lut_matmul.plain`` follows the kernel's dataflow)."""
    a = act_dequant(a_packed, a_scale, a_zmin, bits=bits,
                    group_size=group_size)
    return a @ w.to(torch.float32)


ATTN_BLOCK = 256


def masked_attention(q, k, v, pos, *, block: int = ATTN_BLOCK):
    """GQA attention with the position mask: q (B, Lq, KV, G, D) against
    k, v (B, S, KV, D).  ``pos`` is a scalar or (B,): query i of slot b sits
    at ``pos[b] + i`` and sees keys ``<= pos[b] + i`` (``pos`` 0 with S = Lq
    is causal attention).  Scores and sums in f32, output in q's dtype.

    Blocked as the reference's ``flash_attention``: queries in blocks of
    ``block`` rows, each walking K/V in blocks of ``block`` keys with an
    online softmax, so no (Lq, S) score tensor and no f32 copy of the
    whole K/V is ever built (one K/V block is upcast at a time).  Masked
    scores are NEG_INF, as an unblocked softmax over ``where(valid, s,
    NEG_INF)`` would see them."""
    lq = q.shape[1]
    return torch.cat([_attend_rows(q[:, i:i + block], k, v, pos, i, block)
                      for i in range(0, lq, block)], dim=1)


def _attend_rows(q, k, v, pos, q0: int, block: int):
    """Rows ``q0 .. q0 + Lq`` of :func:`masked_attention`."""
    b, lq, _, _, d = q.shape
    # an int position is filled on the device rather than copied from the
    # host: a captured prefill may make no host copy
    posb = (torch.full((b,), pos, device=q.device) if isinstance(pos, int)
            else torch.as_tensor(pos, device=q.device).expand(b))
    qpos = posb[:, None] + q0 + torch.arange(lq, device=q.device)  # (B, Lq)
    qf = q.to(torch.float32)
    m = l = acc = None
    for s0 in range(0, k.shape[1], block):
        kb = k[:, s0:s0 + block].to(torch.float32)
        valid = (s0 + torch.arange(kb.shape[1], device=q.device)
                 <= qpos[..., None])                                # (B,Lq,s)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kb) * (d ** -0.5)
        s = torch.where(valid[:, None, None], s, NEG_INF)
        m_new = s.amax(-1) if m is None else torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        pv = torch.einsum("bkgqs,bskd->bkgqd", p,
                          v[:, s0:s0 + block].to(torch.float32))
        if m is None:
            l, acc = p.sum(-1), pv
        else:
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / l[..., None]                                # (B,KV,G,Lq,D)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)
