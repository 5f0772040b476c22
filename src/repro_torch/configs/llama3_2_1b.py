"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, head_dim=64, rope theta 5e5  [hf:meta-llama/Llama-3.2-1B]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    vocab_size=128256,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    vocab_size=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    rope_theta=500_000.0,
    dtype="float32",
)
