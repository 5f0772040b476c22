"""Public kernel entry points and the deployment weight format (port of
``repro/kernels/ops.py``).

Dispatch follows the tensors: a CPU tensor runs the plain PyTorch version,
a CUDA tensor the hand-written kernel (``quant_matmul.py``).  There is no
backend switch that would put a plain version on the card's path.
"""
from __future__ import annotations

import dataclasses

import torch

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


def quant_dense(x: torch.Tensor, qw: QWeight, *, a_bits: int | None = None,
                lut: bool = False) -> torch.Tensor:
    """One projection of the paper's forward.  Only the weight-only path
    is ported: runtime activation quantization (``a_bits``) and the LUT
    forward (``lut``) need the ``act_quant`` and ``lut_matmul`` kernels."""
    if lut or a_bits is not None:
        raise NotImplementedError(
            "activation-quantized and LUT forwards (a_bits / lut schemes) "
            "are not ported yet: ROADMAP.md Queue 2 items 3-4 (act_quant, "
            "lut_matmul) and Queue 1 item 9")
    return quant_matmul(x, qw)
