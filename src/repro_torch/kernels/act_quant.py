"""Runtime activation quantization: the CUDA kernel ``csrc/act_quant.cu``,
its wrapper, its launch count and its plain version.

Port of ``repro/kernels/act_quant.py``.  Per row and per local region of
``group_size`` values along K: min and max, ``scale = (max - min) /
(2^bits - 1)`` (1 where the range is 0), ``zmin = min``, then codes
``round_half_even((x - min) / scale)`` clipped to ``[0, 2^bits - 1]`` and
packed along K as ``core.packing`` packs them.

``act_quant`` sends a CPU tensor to :func:`plain` and a CUDA tensor to
the kernel; a CUDA tensor the kernel does not take raises.  The kernel's
bytes equal the plain version's (true division, no reciprocal), which
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` check on the card.
``act_quant.launches`` counts kernel launches (and nothing else).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import packing
from . import build
from . import ref as _ref

_DTYPES = (torch.float32, torch.bfloat16)
GROUP_SIZE = 128      # the kernel's region: one warp, 4 values per lane


def plain(x, *, bits: int, group_size: int):
    """The plain PyTorch version (``ref.act_quant``)."""
    return _ref.act_quant(x, bits=bits, group_size=group_size)


@functools.cache
def _entry():
    fn = build.library("act_quant").repro_act_quant
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def act_quant(x, *, bits: int, group_size: int):
    """x (M, K) -> (packed (M, K/cpb) uint8, scale (M, G) f32, zmin (M, G)
    f32)."""
    m, k = x.shape
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    if bits not in packing.SUPPORTED_BITS:
        raise ValueError(f"unsupported bits={bits}")
    if x.device.type == "cpu":
        return plain(x, bits=bits, group_size=group_size)
    if x.dtype not in _DTYPES:
        raise TypeError(f"act_quant kernel takes f32/bf16 x, got {x.dtype}")
    if group_size != GROUP_SIZE:
        raise ValueError(f"act_quant kernel takes group_size={GROUP_SIZE}, "
                         f"got {group_size}")
    x = x.contiguous()
    g = k // group_size
    packed = torch.empty((m, k // packing.codes_per_byte(bits)),
                         dtype=torch.uint8, device=x.device)
    scale = torch.empty((m, g), dtype=torch.float32, device=x.device)
    zmin = torch.empty((m, g), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = _entry()(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            zmin.data_ptr(), m, k, bits,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    build.check(status, "act_quant")
    act_quant.launches += 1
    return packed, scale, zmin


act_quant.launches = 0
