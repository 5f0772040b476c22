"""LQ-quantized KV-cache wire format (port of ``repro/core/kvwire.py``).

Wire format per cached tensor, quantized along the head dim:

    {"packed": uint8 (..., D/cpb), "scale": f32 (..., G), "zmin": f32 (..., G)}

``bits`` is inferred from shapes (cpb = D // packed_D in {1, 2, 4, 8}), so
only the power-of-two widths 8/4/2/1 are expressible.  The paged layout
stores a leaf as (n_pages, page_size, KV, ...) pages; page 0 is the scratch
page that padded table entries and inactive slots read and write.

Unlike the JAX functions, the writers here (``update_quant_kv``,
``scatter_tokens``, ``scatter_prefill``) update the cache in place, which
keeps one copy of the pool on the device; they also return it.  The
engine's captured CUDA graphs hold the pool's page addresses, so a writer
must never give a pool leaf new storage.
"""
from __future__ import annotations

import torch

from . import packing

KV_BITS = (8, 4, 2, 1)     # the wire format's expressible widths (cpb 2^k)


def _infer(packed_d: int, d: int, scale_g: int):
    bits = {1: 8, 2: 4, 4: 2, 8: 1}[d // packed_d]
    return bits, d // scale_g


def is_quant_kv(leaf) -> bool:
    return isinstance(leaf, dict) and "packed" in leaf


def kv_bits_of(q: dict, d: int) -> int:
    return _infer(q["packed"].shape[-1], d, q["scale"].shape[-1])[0]


def quantize_kv(x: torch.Tensor, bits: int, group_size: int) -> dict:
    """x (..., D) -> wire dict, regions along the last dim."""
    d = x.shape[-1]
    if d % group_size:
        raise ValueError(f"D={d} not divisible by group_size={group_size}")
    g = d // group_size
    xg = x.to(torch.float32).reshape(*x.shape[:-1], g, group_size)
    xmin = xg.amin(-1)
    xmax = xg.amax(-1)
    scale = packing.step_size(xmax - xmin, bits)
    codes = torch.clamp(torch.round((xg - xmin[..., None]) / scale[..., None]),
                        0, (1 << bits) - 1).to(torch.uint8)
    return {"packed": packing.pack(codes.reshape(x.shape), bits),
            "scale": scale, "zmin": xmin}


def dequantize_kv(q: dict, d: int, dtype=torch.float32) -> torch.Tensor:
    bits, group_size = _infer(q["packed"].shape[-1], d, q["scale"].shape[-1])
    codes = packing.unpack(q["packed"], bits, d).to(torch.float32)
    g = d // group_size
    cg = codes.reshape(*codes.shape[:-1], g, group_size)
    x = cg * q["scale"][..., None] + q["zmin"][..., None]
    return x.reshape(codes.shape).to(dtype)


def make_quant_kv(shape: tuple, bits: int, group_size: int,
                  device=None) -> dict:
    """Zero-initialized wire cache for a (..., D) tensor.  Every leaf,
    ``scale`` included, starts at 0, so an unwritten row dequantizes to 0."""
    *lead, d = shape
    cpb = packing.codes_per_byte(bits)
    g = d // group_size
    return {"packed": torch.zeros((*lead, d // cpb), dtype=torch.uint8,
                                  device=device),
            "scale": torch.zeros((*lead, g), dtype=torch.float32,
                                 device=device),
            "zmin": torch.zeros((*lead, g), dtype=torch.float32,
                                device=device)}


def update_quant_kv(q: dict, new: torch.Tensor, slot: int, *, axis: int,
                    bits: int, group_size: int) -> dict:
    """Quantize ``new`` and write it at ``slot`` along ``axis`` (in place).
    ``new``'s extent along ``axis`` may exceed 1 (bulk prefill write)."""
    wire = quantize_kv(new, bits, group_size)
    for k in q:
        q[k].narrow(axis, slot, wire[k].shape[axis]).copy_(wire[k])
    return q


# ---------------------------------------------------------------------------
# paged layout
# ---------------------------------------------------------------------------

def make_paged_kv(n_pages: int, page_size: int, kv_heads: int, head_dim: int,
                  bits: int | None = None, group_size: int = 64,
                  dtype=torch.float32, device=None):
    """One pool leaf: fp tensor or wire dict with (n_pages, page_size) lead."""
    shape = (n_pages, page_size, kv_heads, head_dim)
    if bits is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return make_quant_kv(shape, bits, group_size, device)


def _map(leaf, fn):
    if is_quant_kv(leaf):
        return {k: fn(v) for k, v in leaf.items()}
    return fn(leaf)


def gather_pages(leaf, page_table: torch.Tensor):
    """Gather a (B, P) page table into logical (B, P*page_size, ...) views,
    fp tensors and wire dicts alike, in page-table order."""
    def g(a):
        return a[page_table].reshape(page_table.shape[0], -1, *a.shape[2:])
    return _map(leaf, g)


def scatter_tokens(leaf, new: torch.Tensor, page_idx: torch.Tensor,
                   row: torch.Tensor, *, bits: int | None = None,
                   group_size: int | None = None):
    """Write a length-L run of tokens per batch row into its pages.

    ``new`` is fp (B, L, KV, D); ``page_idx``/``row`` are (B, L) physical
    page ids and in-page rows.  Rows of inactive or overflowing slots point
    at the scratch page; which of several duplicate scratch writes lands is
    unordered, which is fine because the scratch page is never read
    unmasked.
    """
    if is_quant_kv(leaf):
        wire = quantize_kv(new, bits, group_size)
        for k, a in leaf.items():
            a[page_idx, row] = wire[k].to(a.dtype)
        return leaf
    leaf[page_idx, row] = new.to(leaf.dtype)
    return leaf


def scatter_prefill(leaf, contig, page_ids: torch.Tensor):
    """Copy a B=1 contiguous prefill cache (1, T, ...) into pool pages.

    T must equal len(page_ids) * page_size; pages the request does not own
    map to the scratch page in ``page_ids``.
    """
    if is_quant_kv(leaf):
        for k, pl in leaf.items():
            _scatter_one(pl, contig[k], page_ids)
        return leaf
    _scatter_one(leaf, contig, page_ids)
    return leaf


def _scatter_one(pl, cl, page_ids):
    ps = pl.shape[1]
    pl[page_ids] = cl.reshape(-1, ps, *cl.shape[2:]).to(pl.dtype)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def check_kv_bits(bits) -> None:
    """Only power-of-two widths round-trip through the shape inference."""
    if bits is not None and bits not in KV_BITS:
        raise ValueError(f"kv_bits must be one of {KV_BITS} or None (fp), "
                         f"got {bits!r}")


def cache_nbytes(cache) -> int:
    """Total bytes of a (possibly mixed fp/quantized) cache tree."""
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    if isinstance(cache, dict):
        return sum(cache_nbytes(v) for v in cache.values())
    if isinstance(cache, (list, tuple)):
        return sum(cache_nbytes(v) for v in cache)
    return 0


def kv_token_nbytes(kv_heads: int, head_dim: int, bits: int | None,
                    group_size: int = 64, fp_itemsize: int = 4) -> float:
    """Exact wire bytes one cached token costs for one K+V pair: packed
    codes plus an f32 (scale, zmin) pair per region, or ``fp_itemsize`` per
    element for fp caches."""
    if bits is None:
        per_head = head_dim * fp_itemsize
    else:
        check_kv_bits(bits)
        per_head = head_dim * bits / 8 + 2 * 4 * (head_dim // group_size)
    return 2.0 * kv_heads * per_head
