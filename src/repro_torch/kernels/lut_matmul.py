"""Look-up-table matmul (paper section V): the CUDA kernels
``csrc/lut_matmul.cu``, their wrapper, its launch count and its plain
version.

Port of ``repro/kernels/lut_matmul.py``.  With n-bit activation codes
(n <= 4) each local region's inner product is

    s * sum_{v=1}^{2^n-1} v * T[v] + zmin * sum_j w_j,
    T[v] = sum_{j : code_j == v} w_j,

which equals ``dequant(a) @ w``.  ``lut_matmul`` sends a CPU tensor to
:func:`plain` and a CUDA tensor to a kernel chosen by M: up to
``DECODE_M`` rows (every decode step) the split-K kernel and its
fixed-order reduction, launched as :func:`plan` says; above it (the
prefill bucket) the one-pass kernel.  A CUDA tensor the kernels do not
take raises.  ``lut_matmul.launches`` counts wrapper calls that launched
(one per call, whichever route).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import packing
from . import build
from .splitk import DECODE_M, TARGET_BLOCKS

F32_U = 2.0 ** -24               # unit roundoff of float32
MAX_BITS = 4
# as csrc/lut_matmul.cu: a split-K block owns BLOCK_COLS columns (64 threads
# of 4) and at most BM_MAX[bits] rows, so that its 4 x BM x (2^bits - 1)
# table floats stay in registers
BLOCK_COLS = 256
BM_MAX = {1: 8, 2: 4, 3: 2, 4: 1}


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
def plan(m: int, k: int, n: int, bits: int,
         group_size: int = 128) -> tuple[int, int]:
    """The split-K launch of an (M, K) @ (K, N) product with M <=
    DECODE_M: ``(bm, splits)``, blocks of BM = ``bm`` rows (the least
    power of two that covers M, at most ``BM_MAX[bits]``) by BLOCK_COLS
    columns over one of ``splits`` ranges of code bytes
    (``splitk.split_rows``).  A split covers whole regions (a divisor of
    G) or a P-th of one (G*P splits, P dividing a region's code bytes).
    Each table then sums at most R/P codes and G*P parts are summed, so
    error_bound's count of R + 2^n + G + 4 summed terms holds while
    R/P + G*P <= R + G, that is P <= R/G.  ``splits`` is the least of
    these that gives the grid TARGET_BLOCKS blocks, else the most.  A
    larger M runs the one-pass kernel, which takes no plan."""
    if m > DECODE_M:
        raise ValueError(f"M={m} > {DECODE_M} runs the one-pass kernel")
    check_args(k, bits, group_size)
    bm = min(BM_MAX[bits], 1 << (m - 1).bit_length())
    blocks = -(-m // bm) * -(-n // BLOCK_COLS)
    g = k // group_size
    rb = group_size // packing.codes_per_byte(bits)
    cands = sorted({d for d in range(1, g + 1) if g % d == 0}
                   | {g * p for p in range(2, group_size // g + 1)
                      if rb % p == 0})
    splits = next((c for c in cands if blocks * c >= TARGET_BLOCKS),
                  cands[-1])
    return bm, splits


@functools.cache
def _entry():
    fn = build.library("lut_matmul").repro_lut_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _splitk_entry():
    fn = build.library("lut_matmul").repro_lut_matmul_splitk
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
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
    ptrs = (a_packed.data_ptr(), a_scale.data_ptr(), a_zmin.data_ptr(),
            w.data_ptr())
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        if m <= DECODE_M:
            bm, splits = plan(m, k, n, bits, group_size)
            # f32 partial tiles of the splits, summed in a fixed order by
            # the second kernel: no atomics, so every call gives the same
            # bytes
            ws = torch.empty((splits, m, n), dtype=torch.float32,
                             device=w.device)
            status = _splitk_entry()(*ptrs, ws.data_ptr(), out.data_ptr(),
                                     m, k, n, bits, group_size, bm, splits,
                                     stream)
        else:
            status = _entry()(*ptrs, out.data_ptr(), m, k, n, bits,
                              group_size, stream)
    build.check(status, "lut_matmul")
    lut_matmul.launches += 1
    return out


lut_matmul.launches = 0
