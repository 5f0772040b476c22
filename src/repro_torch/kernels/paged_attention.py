"""Fused paged attention: the CUDA kernel ``csrc/paged_attention.cu``, its
wrapper, its launch count and its plain version.

Port of ``repro/kernels/paged_attention.py``: flash-decode over the paged
pool, fp pages or LQ wire pages dequantized in registers.  q is
(B, Lq, KV, G, D); ``pos`` (B,) is the absolute position of each slot's
first query row, and query i sees keys at positions ``<= pos + i``.

``paged_attention`` sends a CPU tensor to :func:`plain` and a CUDA tensor
to the kernels: the page walk of each (slot, kv head) cut into
:func:`plan`'s splits and its query rows into :func:`geometry`'s row
tiles, one block each, then a kernel that combines the splits' partial
softmax states in split order (no atomics: every call gives the same
bytes).  A CUDA tensor the kernels do not take (a head_dim above MAX_D, a
dtype they lack) raises, and nothing falls back.
``paged_attention.launches`` counts wrapper calls that launched (two
kernels each).

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
from .splitk import TARGET_BLOCKS

DEQUANT_MODES = ("auto", "affine", "lut")
# A key's row is cut across L lanes of E elements each, E the first of
# LANE_ELEMS whose 32 lanes cover D; a warp holds ROWS_PER_WARP[E] query
# rows (rows_per_warp() in csrc/paged_attention.cu, which checks them); a
# block has at most MAX_WARPS warps, MAX_TOKEN_TEAMS of them taking
# different chunks of keys.
LANE_ELEMS = (8, 16, 32, 96)
ROWS_PER_WARP = {8: 4, 16: 4, 32: 2, 96: 1}
MAX_WARPS = 8
MAX_TOKEN_TEAMS = 4
MAX_D = 32 * LANE_ELEMS[-1]
SPLIT_TOKENS = 256           # keys a split walks at most, where P allows
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
    output adds 2^-7 of the value (one rounding on each side).

    The CUDA kernels split that walk, and it still fits.  A key's p*v
    passes through the adds of its lane and a rescale when the warp's
    running max grows (one each a chunk its token group takes), the
    log2(T) shuffle adds of the warp's token groups, the combine of the
    block's token teams (a rescale and up to tw - 1 adds, tw <= 4), the
    combine of the splits (a rescale and an add for each other split), and
    the division.  Adds of an exact zero (a group, team or split that saw
    no key) and rescales by exactly 1 (the part that holds the max) do not
    round.  Take a split with k live keys, walked T keys a chunk by tw
    token teams, and s splits that hold a live key: the lane's chain and
    the shuffles nest 2*(ceil(k/(T*tw)) - 1) + ceil(log2(min(T, k))) <= k
    deep, since geometry() keeps T*tw >= 2 wherever a split holds two
    keys; the teams add at most 4 and the splits s; and each of the other
    s - 1 splits holds a live key, so k <= n - (s - 1).  The nest is at
    most 1 + k + 4 + s + 1 <= n + 7, for any split count and row tiling,
    so (n+8)*u stands; tests/test_torch_paged.py counts the nest over a
    sweep of shapes and split counts.  Each score is still one dot of D products, which the
    kernels then scale by log2(e) for exp2: two more roundings of a score,
    inside delta's 2D+2."""
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
def plan(b: int, kvh: int, rows: int, n_tbl: int, page_size: int) -> int:
    """The number of splits of each slot's page walk, from shapes alone
    (no tensor value is read, so the launch can be captured in a graph).

    Split ``s`` covers table entries ``splitk.split_rows(n_tbl, splits)[s]``.
    ``splits`` is the most whose splits hold ``n_tbl // need`` entries or
    more, where ``need`` is the least count giving ``b * kvh * need`` >=
    TARGET_BLOCKS blocks, so that the grid (which :func:`geometry`'s row
    tiles only widen) reaches TARGET_BLOCKS where ``b * kvh * n_tbl``
    allows it, never with more splits than table entries, and no split
    walks more than SPLIT_TOKENS keys when the table allows more splits.
    ``rows`` (Lq*G) does not change the count: row tiles are blocks of
    their own."""
    need = -(-TARGET_BLOCKS // (b * kvh))
    splits = n_tbl // max(1, n_tbl // need)
    return min(n_tbl, max(splits, -(-n_tbl * page_size // SPLIT_TOKENS)))


@functools.cache
def geometry(rows: int, d: int, page_size: int, n_tbl: int,
             splits: int) -> tuple[int, int, int, int, int, int]:
    """The split kernel's block, as ``csrc/paged_attention.cu`` takes it
    (the one place it is decided; the C entry checks it):
    ``(E, L, T, nt, tw, tiles)``.

    A key's row is cut across L lanes of E elements (E the first of
    LANE_ELEMS whose 32 lanes cover D, L the least power of two that
    does), so a warp takes a chunk of T = 32/L keys at once, one a token
    group.  The Lq*G query rows are cut into ``tiles`` row tiles, one
    block each, of nt warps holding ROWS_PER_WARP[E] rows each (a row
    team); tw row teams take interleaved chunks of a split, as many as its
    longest split fills.  A block has at most MAX_WARPS warps (2 at
    E = 96, for shared memory), and where a warp takes one key a chunk
    (T = 1) a row team has at most half of them, so that at least two
    token teams share a split's walk (see error_bound)."""
    if d > MAX_D:
        raise ValueError(f"head_dim {d} above the kernel's {MAX_D}")
    e = next(x for x in LANE_ELEMS if 32 * x >= d)
    lanes = 1 << (-(-d // e) - 1).bit_length()
    t = 32 // lanes
    rt = ROWS_PER_WARP[e]
    warps = 2 if e == LANE_ELEMS[-1] else MAX_WARPS
    most = warps // 2 if t == 1 else warps
    tiles = -(-rows // (most * rt))
    tile_rows = -(-rows // tiles)
    nt = -(-tile_rows // rt)
    keys = -(-n_tbl // splits) * page_size
    tw = max(1, min(MAX_TOKEN_TEAMS, warps // nt, -(-keys // t)))
    return e, lanes, t, nt, tw, tiles


@functools.cache
def _entry():
    fn = build.library("paged_attention").repro_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 18 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _int32(t, device):
    """``t`` as a contiguous int32 tensor on ``device``, converted only if
    it is not one already."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
            or t.device != device or not t.is_contiguous():
        t = torch.as_tensor(t, device=device).to(torch.int32).contiguous()
    return t


def launch_args(q, k_pages, v_pages, page_table, pos):
    """Everything the CUDA launch takes, from shapes, dtypes and pointers
    alone: ``(args, out, ws)``, ``args`` the C entry's arguments before
    the stream.  Reads no tensor value.  ``plan`` is looked up at each
    call, so a test may replace it to force a split count (any count in
    1..P changes only the order of the sums)."""
    b, lq, kvh, gq, d = q.shape
    bits = _bits(k_pages, d)
    rows = lq * gq
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
    table = _int32(page_table, q.device)
    posb = _int32(pos, q.device)
    if posb.shape != (b,):
        posb = posb.expand(b).contiguous()
    if table.shape[0] != b:
        raise ValueError(f"page table has {table.shape[0]} rows for {b} slots")
    n_tbl = table.shape[1]
    splits = plan(b, kvh, rows, n_tbl, page_size)
    geom = geometry(rows, d, page_size, n_tbl, splits)
    q = q.contiguous()
    out = torch.empty_like(q)
    # each split's f32 (m[R], l[R], acc[R, D]); the combine kernel reads
    # them in split order
    ws = torch.empty(b * kvh * splits * rows * (d + 2), dtype=torch.float32,
                     device=q.device)
    ptr = lambda x: None if x is None else x.data_ptr()   # noqa: E731
    args = (ptr(q), ptr(kd), ptr(ks), ptr(kz), ptr(vd), ptr(vs), ptr(vz),
            ptr(table), ptr(posb), ptr(ws), ptr(out), b, lq, kvh, gq, d,
            page_size, n_tbl, bits or 0, gs, splits, *geom,
            int(q.dtype == torch.bfloat16),
            int(bits is None and kd.dtype == torch.bfloat16), d ** -0.5)
    return args, out, ws


def paged_attention(q, k_pages, v_pages, page_table, pos, *,
                    dequant: str = "auto"):
    """Fused flash-decode over a paged pool -> (B, Lq, KV, G, D) in q's dtype.

    ``k_pages``/``v_pages`` are one pool leaf each: fp (n_pages, ps, KV, D)
    tensors or wire dicts with (n_pages, ps, KV, D/cpb) packed codes;
    page_table (B, P) int32 physical page ids in table order.
    """
    dequant_path(_bits(k_pages, q.shape[-1]), dequant)
    if q.device.type == "cpu":
        return plain(q, k_pages, v_pages, page_table, pos, dequant=dequant)
    args, out, _ = launch_args(q, k_pages, v_pages, page_table, pos)
    with torch.cuda.device(q.device):
        status = _entry()(*args, torch.cuda.current_stream().cuda_stream)
    build.check(status, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
