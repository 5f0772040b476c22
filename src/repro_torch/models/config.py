"""ModelConfig for the dense decoder (port of ``repro/models/config.py``,
dense fields only).  The port serves full-attention rope decoders with a
SwiGLU FFN and tied embeddings, the llama family; qk-norm, biases and an
untied head come with the families that need them."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # "dense" is the only ported family
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                 # 0 -> d_model // n_heads
    d_ff: int = 0
    rope_theta: float = 1e4
    vocab_pad: int = 256              # embedding table padded to multiple
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // self.vocab_pad) * self.vocab_pad

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)
