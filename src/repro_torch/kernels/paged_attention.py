"""Fused paged attention: the CUDA kernel ``csrc/paged_attention.cu``, its
wrapper, its launch count and its plain version.

Port of ``repro/kernels/paged_attention.py``: flash-decode over the paged
pool, fp pages or LQ wire pages dequantized in registers.  q is
(B, Lq, KV, G, D); ``pos`` (B,) is the absolute position of each slot's
first query row, and query i sees keys at positions ``<= pos + i``.

``paged_attention`` sends a CPU tensor to :func:`plain` and a CUDA tensor
to the kernel; a CUDA tensor the kernel does not take raises, and nothing
falls back.  ``paged_attention.launches`` counts kernel launches.

``dequant="auto|affine|lut"`` is kept and validated as in the JAX package
(``lut`` at more than 4 bits raises ``ValueError``).  Both dequant forms
compute the same function; the kernel is bound by bytes on the card, so
both run its one in-register affine dequant (see the source's note).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core import kvwire
from . import build, ref

DEQUANT_MODES = ("auto", "affine", "lut")
_SMEM_LIMIT = 48 * 1024      # dynamic shared memory without an opt-in
_DTYPES = (torch.float32, torch.bfloat16)
F32_U = 2.0 ** -24               # unit roundoff of float32
BF16_ULP = 2.0 ** -7             # two bf16 roundings may differ by this


def dequant_path(bits: int | None, dequant: str = "auto") -> str:
    """The per-page dequant form a pool format selects: ``"fp"`` (no
    dequant), ``"affine"`` or ``"lut"``; ``auto`` picks LUT at bits <= 4."""
    if dequant not in DEQUANT_MODES:
        raise ValueError(f"dequant must be one of {DEQUANT_MODES}, "
                         f"got {dequant!r}")
    if bits is None:
        return "fp"
    lut = dequant == "lut" or (dequant == "auto" and bits <= 4)
    if lut and bits > 4:
        raise ValueError("LUT dequant needs kv bits <= 4 (section V.A)")
    return "lut" if lut else "affine"


def _bits(k_pages, d: int) -> int | None:
    if not kvwire.is_quant_kv(k_pages):
        return None
    return kvwire.kv_bits_of(k_pages, d)


def plain(q, k_pages, v_pages, page_table, pos, *, dequant: str = "auto"):
    """The plain PyTorch version: gather every table entry, dequantize to
    f32, attend with the position mask, return in q's dtype."""
    d = q.shape[-1]
    dequant_path(_bits(k_pages, d), dequant)
    kk = kvwire.gather_pages(k_pages, page_table)
    vv = kvwire.gather_pages(v_pages, page_table)
    if kvwire.is_quant_kv(kk):
        kk, vv = kvwire.dequantize_kv(kk, d), kvwire.dequantize_kv(vv, d)
    return ref.masked_attention(q, kk, vv, pos)


def error_bound(q, k_pages, v_pages, page_table, pos, out_plain):
    """Elementwise bound on |kernel - plain|, per slot, given the plain
    output.

    Scores: both sum D products in f32 in other orders and dequantize with
    or without a fused multiply-add, so a score differs by at most
    delta = (2D+2)*u*max|q.k|*D^-0.5 (u = 2^-24).  The output is a convex
    combination of V rows: a score error delta moves it by at most
    2*delta*max|v|, and the online softmax re-associates a sum over n live
    keys (plus exp and one division), at most (n+8)*u*max|v|.  A bf16
    output adds 2^-7 of the value (one rounding on each side)."""
    d = q.shape[-1]
    kk = kvwire.gather_pages(k_pages, page_table.long())
    vv = kvwire.gather_pages(v_pages, page_table.long())
    if kvwire.is_quant_kv(kk):
        kk, vv = kvwire.dequantize_kv(kk, d), kvwire.dequantize_kv(vv, d)
    tols = []
    for i in range(q.shape[0]):
        n = int(pos[i]) + q.shape[1]
        ki, vi = kk[i, :n].float(), vv[i, :n].float()
        qk = torch.einsum("lkgd,skd->lkgs", q[i].float().abs(),
                          ki.abs()).max()
        delta = (2 * d + 2) * F32_U * float(qk) * d ** -0.5
        tols.append(float(vi.abs().max()) * (2 * delta + (n + 8) * F32_U))
    tol = torch.tensor(tols, device=q.device).view(-1, 1, 1, 1, 1)
    tol = tol.expand_as(out_plain).clone()
    if out_plain.dtype == torch.bfloat16:
        tol += BF16_ULP * out_plain.abs().float()
    return tol


@functools.cache
def _entry():
    fn = build.library("paged_attention").repro_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 \
        + [ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(rows: int, d: int, page_size: int) -> int:
    """Dynamic shared memory of one block: q and acc (rows x D), the K page
    (padded rows) and the V page, scores, and three per-row scalars."""
    return 4 * (2 * rows * d + page_size * (2 * d + 1) + rows * page_size
                + 3 * rows)


def paged_attention(q, k_pages, v_pages, page_table, pos, *,
                    dequant: str = "auto"):
    """Fused flash-decode over a paged pool -> (B, Lq, KV, G, D) in q's dtype.

    ``k_pages``/``v_pages`` are one pool leaf each: fp (n_pages, ps, KV, D)
    tensors or wire dicts with (n_pages, ps, KV, D/cpb) packed codes;
    page_table (B, P) int32 physical page ids in table order.
    """
    b, lq, kvh, gq, d = q.shape
    bits = _bits(k_pages, d)
    dequant_path(bits, dequant)
    if q.device.type == "cpu":
        return plain(q, k_pages, v_pages, page_table, pos, dequant=dequant)
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention kernel takes f32/bf16 q, "
                        f"got {q.dtype}")
    if bits is None:
        kd, vd = k_pages.contiguous(), v_pages.contiguous()
        if kd.dtype not in _DTYPES or vd.dtype != kd.dtype:
            raise TypeError(f"fp pages must be f32/bf16, got {kd.dtype}")
        ks = kz = vs = vz = None
        gs = d
        page_shape = kd.shape
    else:
        kd, ks, kz = (k_pages[n].contiguous()
                      for n in ("packed", "scale", "zmin"))
        vd, vs, vz = (v_pages[n].contiguous()
                      for n in ("packed", "scale", "zmin"))
        gs = d // ks.shape[-1]
        page_shape = (*kd.shape[:-1], d)
    page_size = page_shape[1]
    if page_shape[2] != kvh:
        raise ValueError(f"pages hold {page_shape[2]} kv heads, q has {kvh}")
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    posb = torch.as_tensor(pos, device=q.device).to(torch.int32) \
        .expand(b).contiguous()
    if table.shape[0] != b:
        raise ValueError(f"page table has {table.shape[0]} rows for {b} slots")
    smem = smem_bytes(lq * gq, d, page_size)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{lq * gq} query rows x head_dim {d} need {smem} B "
                         f"of shared memory, above the kernel's "
                         f"{_SMEM_LIMIT} B")
    q = q.contiguous()
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    with torch.cuda.device(q.device):
        status = _entry()(
            ptr(q), ptr(kd), ptr(ks), ptr(kz), ptr(vd), ptr(vs), ptr(vz),
            ptr(table), ptr(posb), ptr(out), b, lq, kvh, gq, d, page_size,
            table.shape[1], bits or 0, gs, int(q.dtype == torch.bfloat16),
            int(bits is None and kd.dtype == torch.bfloat16), d ** -0.5,
            smem, torch.cuda.current_stream().cuda_stream)
    build.check(status, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
