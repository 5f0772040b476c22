"""GQA attention with RoPE: causal prefill, cached decode and the paged
decode branch (port of ``repro/models/attention.py``, full attention only).

GQA layout: q (B, L, KV, G, D) grouped by kv head; k/v (B, S, KV, D) are
never repeated.  Prefill attention is plain PyTorch, as the JAX package
leaves it to XLA: :func:`decode_attention` at position 0.  Paged decode
goes through ``kernels/paged_attention.py`` when ``fused`` is set, else
through the gather -> dequantize -> :func:`decode_attention` path.
"""
from __future__ import annotations

import torch

from ..core import kvwire
from ..kernels import paged_attention as paged_attn
from ..kernels import ref
from . import layers
from .layers import NO_QUANT, QuantPolicy

# q (B, Lq, KV, G, D) against caches (B, S, KV, D) read into f32; query i
# of slot b sees cache slots <= pos[b] + i.  The paged kernel's plain
# version runs the same function.
decode_attention = ref.masked_attention


def attn_init(gen, *, d_model: int, n_heads: int, n_kv: int, head_dim: int,
              device=None):
    return {
        "wq": layers.dense_init(gen, d_model, n_heads * head_dim,
                                device=device),
        "wk": layers.dense_init(gen, d_model, n_kv * head_dim, device=device),
        "wv": layers.dense_init(gen, d_model, n_kv * head_dim, device=device),
        "wo": layers.dense_init(gen, n_heads * head_dim, d_model,
                                device=device),
    }


def _project_qkv(p, x, *, n_heads, n_kv, head_dim, positions, rope_theta,
                 policy):
    b, l = x.shape[:2]
    g = n_heads // n_kv
    q = layers.dense_apply(p["wq"], x, policy).reshape(b, l, n_kv, g,
                                                       head_dim)
    k = layers.dense_apply(p["wk"], x, policy).reshape(b, l, n_kv, head_dim)
    v = layers.dense_apply(p["wv"], x, policy).reshape(b, l, n_kv, head_dim)
    q = layers.apply_rope(q.reshape(b, l, n_kv * g, head_dim), positions,
                          rope_theta).reshape(q.shape)
    k = layers.apply_rope(k, positions, rope_theta)
    return q, k, v


def attn_apply(p, x, *, n_heads: int, n_kv: int, head_dim: int,
               rope_theta: float = 1e4, positions=None, cache=None,
               cache_pos=None, page_table=None, fused: bool = False,
               policy: QuantPolicy = NO_QUANT):
    """One causal attention block.  Returns (out, cache).

    cache None: uncached full-sequence forward.  cache dict(k=, v=) with
    (B, S, KV, ...) leaves and no page table: prefill, which writes
    positions [0, L) and attends within x.  With ``page_table`` (B, P):
    paged decode; the leaves are shared (n_pages, page_size, KV, ...)
    pool pages, ``cache_pos`` (B,) the position of each slot's first
    token, and the step writes its K/V into its pages before attending.
    Caches are updated in place.
    """
    b, l, _ = x.shape
    if positions is None:
        positions = torch.arange(l, device=x.device)[None]
    q, k, v = _project_qkv(p, x, n_heads=n_heads, n_kv=n_kv,
                           head_dim=head_dim, positions=positions,
                           rope_theta=rope_theta, policy=policy)
    quant = cache is not None and kvwire.is_quant_kv(cache["k"])
    if quant:
        qbits, qgroup = kvwire._infer(cache["k"]["packed"].shape[-1],
                                      head_dim, cache["k"]["scale"].shape[-1])
    kw = dict(bits=qbits, group_size=qgroup) if quant else {}
    if cache is not None and page_table is not None:
        page_size = (cache["k"]["packed"] if quant else cache["k"]).shape[1]
        n_tbl = page_table.shape[1]
        wpos = cache_pos[:, None] + torch.arange(l, device=x.device)  # (B,L)
        # positions beyond the slot's table write the scratch page instead
        # of clamping onto the slot's own last page (live rows)
        page_idx = torch.gather(
            page_table, 1, torch.clamp(wpos // page_size, max=n_tbl - 1))
        page_idx = torch.where(wpos < n_tbl * page_size, page_idx, 0)
        row = wpos % page_size
        kvwire.scatter_tokens(cache["k"], k, page_idx, row, **kw)
        kvwire.scatter_tokens(cache["v"], v, page_idx, row, **kw)
        if fused:
            out = paged_attn.paged_attention(q, cache["k"], cache["v"],
                                             page_table, cache_pos)
        else:
            k_view = kvwire.gather_pages(cache["k"], page_table)
            v_view = kvwire.gather_pages(cache["v"], page_table)
            if quant:
                k_view = kvwire.dequantize_kv(k_view, head_dim, q.dtype)
                v_view = kvwire.dequantize_kv(v_view, head_dim, q.dtype)
            out = decode_attention(q, k_view, v_view, cache_pos)
    elif cache is not None:
        if quant:
            kvwire.update_quant_kv(cache["k"], k, 0, axis=1, **kw)
            kvwire.update_quant_kv(cache["v"], v, 0, axis=1, **kw)
        else:
            cache["k"][:, :l] = k.to(cache["k"].dtype)
            cache["v"][:, :l] = v.to(cache["v"].dtype)
        out = decode_attention(q, k, v, 0)
    else:
        out = decode_attention(q, k, v, 0)
    out = out.reshape(b, l, n_heads * head_dim)
    return layers.dense_apply(p["wo"], out, policy), cache
