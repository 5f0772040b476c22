"""Bit-packing of low-precision codes into uint8 lanes (port of
``repro/core/packing.py``).

Bits 1/2/4 pack along the last axis, code ``j`` of a byte at shift
``(j % codes_per_byte) * bits``; bits 3/5/6/7/8 store one code per byte.
"""
from __future__ import annotations

import torch

PACKABLE_BITS = (1, 2, 4)
SUPPORTED_BITS = (1, 2, 3, 4, 5, 6, 7, 8)


def codes_per_byte(bits: int) -> int:
    """How many codes share one uint8 lane."""
    return 8 // bits if bits in PACKABLE_BITS else 1


def step_size(rng: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantization step of a region with range ``rng`` (max - min): the
    range over 2^bits - 1 levels, and 1 where the range is 0.

    The divisor is a tensor filled on ``rng``'s device, not a Python
    number: PyTorch divides a CUDA tensor by a Python scalar as a multiply
    by its reciprocal, which can differ from true division by an ulp, and
    then codes at a rounding boundary would differ between the CPU, the
    card and the JAX package."""
    levels = torch.full_like(rng, (1 << bits) - 1)
    return torch.where(rng > 0, rng / levels, torch.ones_like(rng))


def _shifts(bits: int, device) -> torch.Tensor:
    per = codes_per_byte(bits)
    return torch.arange(per, dtype=torch.int32, device=device) * bits


def pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer codes (values in [0, 2^bits)) along the last axis.

    codes (..., K) with K % codes_per_byte(bits) == 0 -> uint8
    (..., K // codes_per_byte(bits)).
    """
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"unsupported bits={bits}")
    if bits not in PACKABLE_BITS:
        return codes.to(torch.uint8)
    per = codes_per_byte(bits)
    *lead, k = codes.shape
    if k % per:
        raise ValueError(f"last dim {k} not divisible by {per} ({bits}-bit)")
    c = codes.reshape(*lead, k // per, per).to(torch.int32)
    return (c << _shifts(bits, codes.device)).sum(-1).to(torch.uint8)


def unpack(packed: torch.Tensor, bits: int,
           n_codes: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack`: uint8 codes shaped (..., n_codes)."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"unsupported bits={bits}")
    if bits not in PACKABLE_BITS:
        return packed.to(torch.uint8)
    per = codes_per_byte(bits)
    vals = ((packed.to(torch.int32)[..., None] >> _shifts(bits, packed.device))
            & ((1 << bits) - 1))
    *lead, kp, _ = vals.shape
    out = vals.reshape(*lead, kp * per).to(torch.uint8)
    if n_codes is not None:
        out = out[..., :n_codes]
    return out
