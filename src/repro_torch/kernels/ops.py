"""Public kernel entry points and the deployment weight format (port of
``repro/kernels/ops.py``).

Dispatch follows the tensors: a CPU tensor runs the plain PyTorch version,
a CUDA tensor the hand-written kernel (``quant_matmul.py``,
``act_quant.py``, ``lut_matmul.py``).  There is no backend switch that
would put a plain version on the card's path.
"""
from __future__ import annotations

import dataclasses

import torch

from . import act_quant as _aq
from . import lut_matmul as _lm
from . import quant_matmul as _qm
from . import ref as _ref


@dataclasses.dataclass(frozen=True)
class QWeight:
    """Packed codes along K plus per-local-region affine."""
    packed: torch.Tensor   # uint8 (K/cpb, N)
    scale: torch.Tensor    # f32 (G, N)
    zmin: torch.Tensor     # f32 (G, N)
    bits: int
    group_size: int
    k: int
    n: int

    @property
    def shape(self):
        return (self.k, self.n)

    def nbytes(self) -> int:
        return (self.packed.numel() * self.packed.element_size()
                + self.scale.numel() * 4 + self.zmin.numel() * 4)

    def to(self, device) -> "QWeight":
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   scale=self.scale.to(device),
                                   zmin=self.zmin.to(device))


def quantize_weight(w: torch.Tensor, bits: int, group_size: int) -> QWeight:
    """Offline weight quantization into the kernel wire format."""
    k, n = w.shape
    packed, scale, zmin = _ref.quantize_weight(w, bits, group_size)
    return QWeight(packed=packed, scale=scale, zmin=zmin, bits=bits,
                   group_size=group_size, k=k, n=n)


def dequantize_weight(qw: QWeight, dtype=torch.float32) -> torch.Tensor:
    return _ref.dequantize_weight(qw.packed, qw.scale, qw.zmin, qw.bits,
                                  qw.group_size, dtype)


def quant_matmul(x: torch.Tensor, qw: QWeight) -> torch.Tensor:
    """x (..., K) @ dequant(qw) -> (..., N).  Leading dims are flattened."""
    lead = x.shape[:-1]
    out = _qm.quant_matmul(x.reshape(-1, qw.k), qw.packed, qw.scale,
                           qw.zmin, bits=qw.bits, group_size=qw.group_size)
    return out.reshape(*lead, qw.n)


def act_quant(x: torch.Tensor, *, bits: int, group_size: int):
    """Runtime activation quantization (paper: inputs quantized online).
    x (..., K) -> (packed (..., K/cpb), scale (..., G), zmin (..., G))."""
    lead = x.shape[:-1]
    packed, scale, zmin = _aq.act_quant(x.reshape(-1, x.shape[-1]),
                                        bits=bits, group_size=group_size)
    g = x.shape[-1] // group_size
    return (packed.reshape(*lead, -1), scale.reshape(*lead, g),
            zmin.reshape(*lead, g))


def lut_matmul(a_packed, a_scale, a_zmin, w, *, bits: int, group_size: int):
    """Paper section-V LUT forward.  a_* in the activation wire format;
    w float (K, N).  Returns f32 (M, N)."""
    return _lm.lut_matmul(a_packed, a_scale, a_zmin, w, bits=bits,
                          group_size=group_size)


def quant_dense(x: torch.Tensor, qw: QWeight, *, a_bits: int | None = None,
                lut: bool = False) -> torch.Tensor:
    """Full paper forward for one projection: optional runtime activation
    quant (``a_bits``), then the packed-weight matmul -- or the LUT path
    when ``lut=True`` (activations quantized, weights dequantized to f32
    per call in plain PyTorch, as the JAX package does outside its
    kernels)."""
    if a_bits is None:
        if lut:
            raise ValueError("LUT path requires a_bits")
        return quant_matmul(x, qw)
    lead = x.shape[:-1]
    ap, asc, azm = act_quant(x.reshape(-1, qw.k), bits=a_bits,
                             group_size=qw.group_size)
    if lut:
        out = lut_matmul(ap, asc, azm, dequantize_weight(qw), bits=a_bits,
                         group_size=qw.group_size)
        return out.reshape(*lead, qw.n).to(x.dtype)
    xq = _ref.act_dequant(ap, asc, azm, bits=a_bits,
                          group_size=qw.group_size).to(x.dtype)
    return quant_matmul(xq.reshape(*lead, qw.k), qw)
