"""SwiGLU feed-forward block (port of ``repro/models/mlp.py``)."""
from __future__ import annotations

import torch.nn.functional as F

from . import layers
from .layers import NO_QUANT, QuantPolicy


def swiglu_init(gen, d_model: int, d_ff: int, device=None):
    return {
        "wi_gate": layers.dense_init(gen, d_model, d_ff, device=device),
        "wi_up": layers.dense_init(gen, d_model, d_ff, device=device),
        "wo": layers.dense_init(gen, d_ff, d_model, device=device),
    }


def swiglu_apply(p, x, policy: QuantPolicy = NO_QUANT):
    gate = layers.dense_apply(p["wi_gate"], x, policy)
    up = layers.dense_apply(p["wi_up"], x, policy)
    return layers.dense_apply(p["wo"], F.silu(gate) * up, policy)
