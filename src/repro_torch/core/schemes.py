"""Quantization scheme registry (port of ``repro/core/schemes.py``).

A :class:`QuantConfig` fully describes how a projection is quantized:

  * ``w_bits`` / ``a_bits``    -- weight / activation bit-widths (None = fp)
  * ``granularity``            -- 'per_tensor' (paper's DQ, section IV.B) or
                                  'per_group' (the paper's LQ, section IV.C)
  * ``group_size``             -- size of the local quantization region
  * ``lut``                    -- use the look-up-table forward path (paper
                                  section V); requires a_bits <= 4.

Named schemes mirror the paper's experiment grid:

  fp32                         -- 32-bit float baseline (section III)
  dq8 dq6 dq4 dq2              -- dynamic fixed point (one region per layer)
  lq8 lq6 lq4 lq2 lq1          -- local quantization regions (group_size=128)
  lq2_lut                      -- 2-bit LQ + LUT forward (paper section V,
                                  weights 8-bit as in paper Table 3 setup)

The ``lq*`` schemes all serve in the port: ``lq{b}w`` through
``quant_matmul``; ``lq{b}`` (and any scheme with ``a_bits``) through
``act_quant`` then ``quant_matmul``; ``lq2_lut``/``lq4_lut`` through
``act_quant`` then ``lut_matmul``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    w_bits: int | None = None          # None => float weights
    a_bits: int | None = None          # None => float activations
    granularity: str = "per_group"     # 'per_group' (LQ) | 'per_tensor' (DQ)
    group_size: int = 128              # local quantization region size
    lut: bool = False                  # paper section-V LUT forward path
    stochastic: bool = False           # stochastic rounding (QAT / gradcomp)

    def __post_init__(self):
        if self.granularity not in ("per_group", "per_tensor"):
            raise ValueError(f"bad granularity {self.granularity!r}")
        if self.lut and (self.a_bits is None or self.a_bits > 4):
            raise ValueError("LUT path needs activation bits <= 4 "
                             "(table size 2^a_bits, paper section V.A)")
        for b in (self.w_bits, self.a_bits):
            if b is not None and not (1 <= b <= 8):
                raise ValueError(f"bits must be in [1, 8], got {b}")

    @property
    def quantized(self) -> bool:
        return self.w_bits is not None or self.a_bits is not None


FP32 = QuantConfig()

_REGISTRY: dict[str, QuantConfig] = {"fp32": FP32, "none": FP32}

for _b in (8, 6, 4, 2, 1):
    _REGISTRY[f"dq{_b}"] = QuantConfig(w_bits=_b, a_bits=_b,
                                       granularity="per_tensor")
    _REGISTRY[f"lq{_b}"] = QuantConfig(w_bits=_b, a_bits=_b,
                                       granularity="per_group", group_size=128)
    # weight-only variants (serving: weights offline, activations fp --
    # the deployment mode for memory-bound decode)
    _REGISTRY[f"lq{_b}w"] = QuantConfig(w_bits=_b, a_bits=None,
                                        granularity="per_group", group_size=128)

# paper Table 3 setup: weights fixed 8-bit, activations 2-bit, LUT forward
_REGISTRY["lq2_lut"] = QuantConfig(w_bits=8, a_bits=2, lut=True,
                                   granularity="per_group", group_size=128)
_REGISTRY["lq4_lut"] = QuantConfig(w_bits=8, a_bits=4, lut=True,
                                   granularity="per_group", group_size=128)


def get(name_or_cfg) -> QuantConfig:
    if isinstance(name_or_cfg, QuantConfig):
        return name_or_cfg
    if name_or_cfg is None:
        return FP32
    try:
        return _REGISTRY[name_or_cfg]
    except KeyError:
        raise KeyError(f"unknown quant scheme {name_or_cfg!r}; "
                       f"known: {sorted(_REGISTRY)}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)
