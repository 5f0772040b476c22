"""Fused dequantize-matmul: the CUDA kernels ``csrc/quant_matmul.cu``,
their wrapper, its launch count and its plain version.

Port of ``repro/kernels/quant_matmul.py``.  ``quant_matmul`` sends a CPU
tensor to :func:`plain` and a CUDA tensor to a kernel chosen by M: up
to ``DECODE_M`` rows (every decode step) the split-K kernel and its
fixed-order reduction, launched as :func:`plan` says; above it (the
prefill bucket) the one-pass kernel.  A CUDA tensor the kernels do not take raises.
``quant_matmul.launches`` counts wrapper calls that launched (one per
call, whichever route).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import packing
from . import build
from . import ref as _ref
from .splitk import DECODE_M, TARGET_BLOCKS

_DTYPES = (torch.float32, torch.bfloat16)
# as csrc/quant_matmul.cu: a block's f32 slice of x in shared memory must
# fit X_SMEM_BYTES, and a block of BM rows owns BLOCK_COLS[BM] columns
X_SMEM_BYTES = 32 * 1024
BLOCK_COLS = {4: 256, 16: 128}
F32_U = 2.0 ** -24               # unit roundoff of float32
BF16_ULP = 2.0 ** -7             # two bf16 roundings may differ by this


def plain(x, packed, scale, zmin, *, bits: int, group_size: int):
    """The plain PyTorch version: dequantize W, then one f32 matmul."""
    return _ref.quant_matmul(x, packed, scale, zmin, bits=bits,
                             group_size=group_size)


def error_bound(x, w, y_plain):
    """Elementwise bound on |kernel - plain| at x (M, K) and the
    dequantized weight ``w`` (K, N), given the plain output.

    Both sum K products in f32, in different orders; recursive summation
    errs by at most K*u*sum|x*w| (u = 2^-24), so the two differ by at most
    2K*u*(|x| @ |w|), plus 2u of it for the dequant (one fused multiply-add
    in the kernel, a multiply and an add in the plain version).  A bf16
    output is rounded once on each side, within 2^-8 of the value each,
    so the two may also differ by 2^-7 of it."""
    k = x.shape[1]
    tol = (2 * k + 2) * F32_U * (x.abs().to(torch.float32) @ w.abs())
    if y_plain.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * y_plain.abs().to(torch.float32)
    return tol


@functools.cache
def _entry():
    fn = build.library("quant_matmul").repro_quant_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _splitk_entry():
    fn = build.library("quant_matmul").repro_quant_matmul_splitk
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(m: int, k: int, n: int, bits: int) -> tuple[int, int]:
    """The split-K launch of an (M, K) @ (K, N) product with M <=
    DECODE_M: ``(bm, splits)``, blocks of BM = ``bm`` rows by
    ``BLOCK_COLS[bm]`` columns over one of ``splits`` contiguous ranges of
    packed rows (``splitk.split_rows``).  ``splits`` gives the grid as many
    blocks as fit TARGET_BLOCKS (at least SMS while N has fewer strips than
    that) where K has enough packed rows, and keeps a block's f32 slice of
    x within X_SMEM_BYTES.  A larger M runs the one-pass kernel, which
    takes no plan."""
    if m > DECODE_M:
        raise ValueError(f"M={m} > {DECODE_M} runs the one-pass kernel")
    bm = 4 if m <= 4 else 16
    rows = k // packing.codes_per_byte(bits)
    strips = -(-n // BLOCK_COLS[bm])
    splits = max(TARGET_BLOCKS // strips, 1,
                 -(-k * 4 * bm // X_SMEM_BYTES))
    return bm, min(splits, rows)


def check_k(k: int, group_size: int) -> None:
    if k % group_size:
        # the kernel walks whole local regions, so a ragged tail region
        # would silently vanish from the product
        raise ValueError(
            f"K={k} is not a multiple of group_size={group_size}: the "
            f"trailing {k % group_size}-wide partial local region has no "
            f"step and would be dropped from the matmul")


def quant_matmul(x, packed, scale, zmin, *, bits: int, group_size: int):
    """x (M, K) @ dequant(packed/scale/zmin) (K, N) -> (M, N) in x's dtype."""
    m, k = x.shape
    check_k(k, group_size)
    if x.device.type == "cpu":
        return plain(x, packed, scale, zmin, bits=bits,
                     group_size=group_size)
    cpb = packing.codes_per_byte(bits)
    n = packed.shape[1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"quant_matmul kernel takes f32/bf16 x, got {x.dtype}")
    if group_size % cpb:
        raise ValueError(f"group_size={group_size} must be a multiple of "
                         f"{cpb} codes per byte")
    if packed.shape != (k // cpb, n) or packed.dtype != torch.uint8 \
            or scale.shape != (k // group_size, n) \
            or zmin.shape != scale.shape or scale.dtype != torch.float32 \
            or zmin.dtype != torch.float32:
        raise ValueError(f"wire shapes/dtypes do not match x {tuple(x.shape)}"
                         f" at {bits} bits, group {group_size}")
    tensors = (x, packed, scale, zmin)
    if any(t.device != x.device for t in tensors):
        raise ValueError("quant_matmul operands lie on different devices")
    x, packed, scale, zmin = (t.contiguous() for t in tensors)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if m <= DECODE_M:
            bm, splits = plan(m, k, n, bits)
            # f32 partial tiles of the splits, summed in a fixed order by
            # the second kernel: no atomics, so every call gives the same
            # bytes
            ws = torch.empty((splits, m, n), dtype=torch.float32,
                             device=x.device)
            status = _splitk_entry()(
                x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                zmin.data_ptr(), ws.data_ptr(), out.data_ptr(), m, k, n,
                bits, group_size, bm, splits, bf16, stream)
        else:
            status = _entry()(
                x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                zmin.data_ptr(), out.data_ptr(), m, k, n, bits, group_size,
                bf16, stream)
    build.check(status, "quant_matmul")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
