"""Primitive layers: dense (quantization-aware), RMSNorm, embeddings, RoPE
(port of ``repro/models/layers.py``).

Functional style as in the JAX package: ``*_init(gen, ...) -> params``
(nested dicts of tensors) and ``*_apply(params, x, ...) -> y``.  A dense
weight is either a float tensor or a :class:`~repro_torch.kernels.ops.QWeight`
in the packed local-quantization-region format, which the forward sends
to ``quant_matmul``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import schemes
from ..kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """How projections behave in the forward pass: the scheme whose
    activation options (``a_bits``, ``lut``) apply to QWeight layers.
    Weights are fp or QWeight by their own type (serve mode only)."""
    cfg: schemes.QuantConfig = schemes.FP32

    @staticmethod
    def serve(cfg):
        return QuantPolicy(schemes.get(cfg))


NO_QUANT = QuantPolicy()


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def dense_init(gen, in_dim: int, out_dim: int, *, device=None):
    return {"w": _normal(gen, (in_dim, out_dim), device) * in_dim ** -0.5}


def dense_apply(p, x, policy: QuantPolicy = NO_QUANT):
    w = p["w"]
    if isinstance(w, kops.QWeight):
        cfg = policy.cfg
        return kops.quant_dense(x, w, a_bits=cfg.a_bits, lut=cfg.lut)
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, device=None):
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm_apply(p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def embed_init(gen, vocab: int, dim: int, device=None):
    return {"table": _normal(gen, (vocab, dim), device) * dim ** -0.5}


def embed_apply(p, tokens):
    return p["table"][tokens]


def embed_logits(p, x, true_vocab: int | None = None):
    """Tied read-out: x @ table^T, padded vocab columns set to -1e9."""
    table = p["table"].to(x.dtype)
    logits = x @ table.T
    if true_vocab is not None and true_vocab < table.shape[0]:
        logits[..., true_vocab:] = -1e9
    return logits


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    """Inverse frequencies in f32, computed in f64 and rounded once: an f32
    ``pow`` may differ by an ulp between the CPU and the card, and at
    position p that ulp moves a rotation angle by ~p * 1e-7 rad, enough to
    put a K element on the other side of a KV-quantization boundary."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=device) / head_dim
    return (1.0 / theta ** exps).to(torch.float32)


def apply_rope(x, positions, theta: float = 1e4):
    """x (..., L, H, D), positions (..., L) int -> same shape.  The head dim
    splits into halves (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)               # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs           # (..,L,D/2)
    cos = torch.cos(ang)[..., None, :]                              # (..,L,1,D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
