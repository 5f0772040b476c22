"""Dense decoder LM: parameters, caches, prefill, paged decode and
quantized serving parameters (port of ``repro/models/transformer.py`` for
full-attention + SwiGLU decoders).

The JAX package scan-stacks its layers (``"super"`` leaves of shape
(S, ...)); here ``params["layers"]`` and caches are per-layer lists walked
by a Python loop.  :func:`from_jax_params` converts the stacked layout.

Public surface:
  init_params(cfg, seed, device)             -> params
  from_jax_params(np_tree, device)           -> params
  init_cache(cfg, batch, max_len, ...)       -> per-layer cache list
  prefill(params, cfg, tokens, cache, ...)   -> (logits, cache)
  paged_decode_step(params, cfg, tokens, pages, page_table, pos, ...)
                                             -> (logits, pages)
  quantize_params(params, cfg, qcfg)         -> params with QWeight leaves
"""
from __future__ import annotations

import torch

from .. import device as _device
from ..core import kvwire, schemes
from ..kernels import ops as kops
from . import attention, layers, mlp
from .config import ModelConfig
from .layers import NO_QUANT, QuantPolicy


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def block_init(gen, cfg: ModelConfig, device=None) -> dict:
    return {
        "norm1": layers.rmsnorm_init(cfg.d_model, device),
        "mixer": attention.attn_init(
            gen, d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim, device=device),
        "norm2": layers.rmsnorm_init(cfg.d_model, device),
        "ffn": mlp.swiglu_init(gen, cfg.d_model, cfg.d_ff, device),
    }


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random f32 master parameters from ``seed`` with the distributions of
    the JAX ``init_params``: dense weights N(0, 1/in_dim), the embedding
    N(0, 1/d_model), norms at one.  The bits differ from JAX's, since the
    generators differ.  Built on the card unless ``device="cpu"``."""
    device = _device.resolve(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {"embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model,
                                       device),
            "final_norm": layers.rmsnorm_init(cfg.d_model, device),
            "layers": [block_init(gen, cfg, device)
                       for _ in range(cfg.n_layers)]}


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor / QWeight leaf of a nested dict/list."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_to(params, device) -> dict:
    """Copy a parameter tree (fp or quantized) to ``device``."""
    return tree_map(lambda a: a.to(device), params)


def from_jax_params(np_tree, device=None) -> dict:
    """The JAX parameter pytree, as numpy arrays, -> the port's parameters.

    ``np_tree["decoder"]`` carries the scan-stacked layout: ``"super"`` is a
    tuple with one block tree per pattern position whose leaves are (S, ...)
    (a (S, K, N) weight for every dense layer), plus ``"tail"`` blocks.
    Layer ``s * P + j`` is ``super[j][..][s]``.  Placed on the card unless
    ``device="cpu"``.
    """
    device = _device.resolve(device)

    def t(a):
        return torch.from_numpy(a.copy()).to(device)

    dec = np_tree["decoder"]
    sup = dec["super"]
    n_super = next(iter(leaves(sup[0]))).shape[0] if sup else 0
    blocks = []
    for s in range(n_super):
        for pos_tree in sup:
            blocks.append(tree_map(lambda a, s=s: t(a[s]), pos_tree))
    blocks += [tree_map(t, blk) for blk in dec["tail"]]
    return {"embed": tree_map(t, np_tree["embed"]),
            "final_norm": tree_map(t, np_tree["final_norm"]),
            "layers": blocks}


def leaves(tree):
    """Every tensor / QWeight leaf of a nested dict/list, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def block_apply(p, x, cfg: ModelConfig, *, policy: QuantPolicy, cache=None,
                cache_pos=None, positions=None, page_table=None,
                fused: bool = False):
    h = layers.rmsnorm_apply(p["norm1"], x)
    out, _ = attention.attn_apply(
        p["mixer"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        positions=positions, cache=cache,
        cache_pos=cache_pos, page_table=page_table, fused=fused,
        policy=policy)
    x = x + out
    h = layers.rmsnorm_apply(p["norm2"], x)
    return x + mlp.swiglu_apply(p["ffn"], h, policy)


def _logits(params, cfg: ModelConfig, x):
    """Final norm, then the tied read-out, in f32."""
    x = layers.rmsnorm_apply(params["final_norm"], x)
    return layers.embed_logits(params["embed"], x,
                               cfg.vocab_size).to(torch.float32)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None,
               kv_quant=None, device=None) -> list:
    """Per-layer contiguous decode cache: ``{"k", "v"}`` with (B, max_len,
    KV, D) leaves, or LQ wire dicts when ``kv_quant=(bits, group_size)``."""
    dtype = dtype or cfg.activation_dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if kv_quant is not None:
        kvwire.check_kv_bits(kv_quant[0])

    def leaf():
        if kv_quant is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        return kvwire.make_quant_kv(shape, *kv_quant, device=device)

    return [{"k": leaf(), "v": leaf()} for _ in range(cfg.n_layers)]


def prefill(params, cfg: ModelConfig, tokens, cache, *,
            policy: QuantPolicy = NO_QUANT, logits_pos=None):
    """Process prompts (B, L), writing positions [0, L) of every layer's
    cache.  Returns (logits (B, 1, V) f32, cache).  ``logits_pos`` selects
    which position's logits to return instead of the last (right-padded
    prefill buckets read their true last token; causal masking keeps
    earlier positions independent of the pad tail): an int, or a
    one-element index tensor on the tokens' device, which one captured
    prefill reads for every prompt length."""
    x = layers.embed_apply(params["embed"], tokens).to(cfg.activation_dtype)
    for p, c in zip(params["layers"], cache):
        x = block_apply(p, x, cfg, policy=policy, cache=c)
    if logits_pos is None:
        x = x[:, -1:]
    elif isinstance(logits_pos, torch.Tensor):
        x = x.index_select(1, logits_pos.reshape(1))
    else:
        x = x[:, logits_pos:logits_pos + 1]
    return _logits(params, cfg, x), cache


def paged_decode_step(params, cfg: ModelConfig, tokens, pages, page_table,
                      pos, *, policy: QuantPolicy = NO_QUANT,
                      fused: bool = False):
    """One continuous-batching decode step over the paged pool.

    tokens (B, 1); pages a per-layer list of ``{"k", "v"}`` pool leaves;
    page_table (B, P) int physical page ids (scratch page 0 pads unused
    entries); pos (B,) the position each slot's token is written at.
    ``fused`` sends every layer's attention through the paged-attention
    kernel.  Returns (logits (B, 1, V) f32, pages), pages written in place.
    """
    x = layers.embed_apply(params["embed"], tokens).to(cfg.activation_dtype)
    for p, c in zip(params["layers"], pages):
        x = block_apply(p, x, cfg, policy=policy, cache=c, cache_pos=pos,
                        positions=pos[:, None], page_table=page_table,
                        fused=fused)
    return _logits(params, cfg, x), pages


# ---------------------------------------------------------------------------
# quantized serving parameters
# ---------------------------------------------------------------------------

def quantize_params(params, cfg: ModelConfig, qcfg) -> dict:
    """Replace dense weights with packed :class:`QWeight` under one uniform
    QuantConfig.  A weight whose K (``shape[-2]``) is not a multiple of the
    group size stays fp, as in the JAX package; the embedding table, norms
    and biases stay fp."""
    qcfg = schemes.get(qcfg)
    if qcfg.w_bits is None:
        return params
    bits, gs = qcfg.w_bits, qcfg.group_size

    def walk(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k == "w" and isinstance(v, torch.Tensor) and v.ndim == 2 \
                        and v.shape[-2] % gs == 0:
                    out[k] = kops.quantize_weight(v, bits, gs)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return walk(params)
