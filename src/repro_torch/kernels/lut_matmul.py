"""Look-up-table matmul (paper section V): the CUDA kernel
``csrc/lut_matmul.cu``, its wrapper, its launch count and its plain
version.

Port of ``repro/kernels/lut_matmul.py``.  With n-bit activation codes
(n <= 4) each local region's inner product is

    s * sum_{v=1}^{2^n-1} v * T[v] + zmin * sum_j w_j,
    T[v] = sum_{j : code_j == v} w_j,

which equals ``dequant(a) @ w``.  ``lut_matmul`` sends a CPU tensor to
:func:`plain` and a CUDA tensor to the kernel; a CUDA tensor the kernel
does not take raises.  ``lut_matmul.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import packing
from . import build

F32_U = 2.0 ** -24               # unit roundoff of float32
MAX_BITS = 4


def check_args(k: int, bits: int, group_size: int) -> None:
    if bits > MAX_BITS:
        raise ValueError("LUT path needs activation bits <= 4 (section V.A)")
    if k % group_size:
        # the kernel walks whole local regions, so a ragged tail region
        # would silently vanish from the product
        raise ValueError(
            f"K={k} is not a multiple of group_size={group_size}: the "
            f"trailing {k % group_size}-wide partial local region has no "
            f"grid step and would be dropped from the matmul")


def plain(a_packed, a_scale, a_zmin, w, *, bits: int, group_size: int):
    """The plain PyTorch version, in the kernel's dataflow: per region the
    one-hot tables ``T_v = mask_v @ W`` (binary {0,1} masks), combined as
    ``s * sum_v v*T_v + zmin * sum_j w_j``, then summed over regions.
    f32 (M, N)."""
    k, n = w.shape
    check_args(k, bits, group_size)
    m = a_packed.shape[0]
    g = k // group_size
    codes = packing.unpack(a_packed, bits, k).reshape(m, g, group_size)
    codes = codes.transpose(0, 1)                          # (G, M, R)
    wg = w.to(torch.float32).reshape(g, group_size, n)     # (G, R, N)
    code_dot = torch.zeros((g, m, n), dtype=torch.float32, device=w.device)
    for v in range(1, 1 << bits):       # v = 0 adds nothing (section V.C)
        mask = (codes == v).to(torch.float32)
        code_dot += v * torch.bmm(mask, wg)                # v * T_v
    wsum = wg.sum(1)                                       # (G, N)
    out = (a_scale.T[..., None] * code_dot
           + a_zmin.T[..., None] * wsum[:, None, :])       # (G, M, N)
    return out.sum(0)


def error_bound(a_packed, a_scale, a_zmin, w, y_plain, *, bits: int,
                group_size: int):
    """Elementwise bound on |kernel - plain| (both f32), given the plain
    output.

    Per region of R = group_size codes both sides sum each table T_v (at
    most R terms), the 2^n - 1 weighted tables, and sum_j w_j, then apply
    the region's affine and add the G = K/R region terms, in different
    orders (the plain version through matmuls, the kernel one product at a
    time, its 8 warps meeting at the end).  Recursive summation of t terms
    errs by at most t*u*(sum of their magnitudes) (u = 2^-24), so each side
    is within (R + 2^n + G + 4)*u * B of the exact value, where
    B = sum_g |s_g| * sum_j code_j |w_j| + |zmin_g| * sum_j |w_j|.  The two
    terms can cancel (zmin < 0 < s), so the bound scales with B and not
    with |y|.  Each side then rounds its last add once: 2u|y| more."""
    k, n = w.shape
    m = a_packed.shape[0]
    g = k // group_size
    codes = packing.unpack(a_packed, bits, k).to(torch.float32)
    mag = (codes.reshape(m, g, group_size) * a_scale.abs()[..., None]
           + a_zmin.abs()[..., None]).reshape(m, k)
    terms = group_size + (1 << bits) + g + 4
    return (2 * terms * F32_U * (mag @ w.abs().to(torch.float32))
            + 2 * F32_U * y_plain.abs())


@functools.cache
def _entry():
    fn = build.library("lut_matmul").repro_lut_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lut_matmul(a_packed, a_scale, a_zmin, w, *, bits: int, group_size: int):
    """dequant(a) @ w via the LUT dataflow.  a_packed (M, K/cpb) uint8,
    a_scale/a_zmin (M, G) f32, w (K, N) f32.  Returns f32 (M, N)."""
    k, n = w.shape
    check_args(k, bits, group_size)
    if w.device.type == "cpu":
        return plain(a_packed, a_scale, a_zmin, w, bits=bits,
                     group_size=group_size)
    m = a_packed.shape[0]
    cpb = packing.codes_per_byte(bits)
    if w.dtype != torch.float32:
        raise TypeError(f"lut_matmul kernel takes f32 w, got {w.dtype}")
    if group_size % cpb:
        raise ValueError(f"group_size={group_size} must be a multiple of "
                         f"{cpb} codes per byte")
    if a_packed.shape != (m, k // cpb) or a_packed.dtype != torch.uint8 \
            or a_scale.shape != (m, k // group_size) \
            or a_zmin.shape != a_scale.shape \
            or a_scale.dtype != torch.float32 \
            or a_zmin.dtype != torch.float32:
        raise ValueError(f"activation wire shapes/dtypes do not match w "
                         f"{tuple(w.shape)} at {bits} bits, group "
                         f"{group_size}")
    tensors = (a_packed, a_scale, a_zmin, w)
    if any(t.device != w.device for t in tensors):
        raise ValueError("lut_matmul operands lie on different devices")
    a_packed, a_scale, a_zmin, w = (t.contiguous() for t in tensors)
    out = torch.empty((m, n), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        status = _entry()(
            a_packed.data_ptr(), a_scale.data_ptr(), a_zmin.data_ptr(),
            w.data_ptr(), out.data_ptr(), m, k, n, bits, group_size,
            torch.cuda.current_stream().cuda_stream)
    build.check(status, "lut_matmul")
    lut_matmul.launches += 1
    return out


lut_matmul.launches = 0
