"""The split-and-combine design of the port's paged attention, on the CPU.

The CUDA kernels (``csrc/paged_attention.cu``) run only on the card.  What
they compute is modelled here in torch, split by split as the split kernel
walks the keys and combined in split order as the combine kernel does, and
held to the JAX kernel in interpret mode.  The launch plan is checked to
depend on shapes alone, and the launch arguments are built from meta
tensors, which hold no values, so the wrapper reads none.

Tolerance: ``paged_attention.error_bound`` (f32 summation order, exp, and
the bf16 output rounding); the split nest is checked against the depth
that bound assumes (see its docstring).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvwire as jkv
from repro.kernels import paged_attention as jpa
from repro_torch.core import kvwire as tkv
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import splitk

RNG = np.random.default_rng(11)
NEG_INF = -1e30


def _case(bits, *, lq, b=3, kvh=2, gq=2, d=32, gs=16, ps=4, pps=5):
    """Scratch page 0 holds large garbage.  Slot 0 ends mid-table with its
    last two entries past pos (one a real page, one padded onto scratch),
    slot 1 fills its table, slot 2 sits at position 0 with every entry
    after the first on scratch: splits that hold only masked or scratch
    pages."""
    n_pages = b * pps + 1
    kf = RNG.normal(size=(n_pages, ps, kvh, d)).astype(np.float32)
    vf = RNG.normal(size=kf.shape).astype(np.float32)
    kf[0], vf[0] = 1e4, -1e4
    q = RNG.normal(size=(b, lq, kvh, gq, d)).astype(np.float32)
    table = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    pos = np.array([(pps - 2) * ps - lq - 1, pps * ps - lq, 0], np.int32)
    table[0, -1] = 0
    table[2, 1:] = 0
    if bits is None:
        jk, jv = jnp.asarray(kf), jnp.asarray(vf)
    else:
        jk = jkv.quantize_kv(jnp.asarray(kf), bits, gs)
        jv = jkv.quantize_kv(jnp.asarray(vf), bits, gs)

    def t(leaf):
        if isinstance(leaf, dict):
            return {k: torch.from_numpy(np.asarray(v).copy())
                    for k, v in leaf.items()}
        return torch.from_numpy(np.asarray(leaf).copy())

    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos))
    targs = (torch.from_numpy(q), t(jk), t(jv), torch.from_numpy(table),
             torch.from_numpy(pos))
    return jargs, targs


def split_combine(q, k_pages, v_pages, table, pos, splits):
    """The kernels' dataflow: the query rows are cut into geometry()'s row
    tiles; for each tile, split s walks table entries
    ``split_rows(P, splits)[s]`` with an online softmax (max update, then
    masked probabilities zeroed, then the rescale), and keeps only keys
    below pos + Lq; each row's (m, l, acc) of the splits are combined in
    split order.  Returns (out in q's dtype, the per-split m of shape
    (S, B, KV, R))."""
    b, lq, kvh, gq, d = q.shape
    kk = tkv.gather_pages(k_pages, table.long())
    vv = tkv.gather_pages(v_pages, table.long())
    if tkv.is_quant_kv(kk):
        kk, vv = tkv.dequantize_kv(kk, d), tkv.dequantize_kv(vv, d)
    kk, vv = kk.float(), vv.float()                      # (B, P*ps, KV, D)
    ps = kk.shape[1] // table.shape[1]
    rows = lq * gq
    e, _, _, nt, _, tiles = tpa.geometry(rows, d, ps, table.shape[1], splits)
    tile = nt * tpa.ROWS_PER_WARP[e]                 # rows a block holds
    assert (tiles - 1) * tile < rows <= tiles * tile
    outs, ms = [], []
    for r0 in range(0, rows, tile):
        rs = slice(r0, min(rows, r0 + tile))
        out, m = _walk(q, kk, vv, pos, splits, table.shape[1], ps, rs)
        outs.append(out)
        ms.append(m)
    out = torch.cat(outs, 2)
    out = out.reshape(b, kvh, lq, gq, d).permute(0, 2, 1, 3, 4)
    return out.to(q.dtype), torch.cat(ms, -1)


def _walk(q, kk, vv, pos, splits, n_tbl, ps, rs):
    """One row tile's splits and their combine, rows ``rs`` of the head's
    Lq*G: (out (B, KV, rows, D) f32, m (S, B, KV, rows))."""
    b, lq, kvh, gq, d = q.shape
    rows = lq * gq
    qr = q.float().permute(0, 2, 1, 3, 4).reshape(b, kvh, rows, d)[:, :, rs]
    qpos = (pos.long()[:, None] + torch.arange(rows) // gq)[:, rs]  # (B, r)
    live = pos.long() + lq                                         # (B,)
    n = qr.shape[2]
    parts = []
    for lo, hi in splitk.split_rows(n_tbl, splits):
        m = torch.full((b, kvh, n), NEG_INF)
        l = torch.zeros((b, kvh, n))
        acc = torch.zeros((b, kvh, n, d))
        for page in range(lo, hi):
            keys = page * ps + torch.arange(ps)
            s = torch.einsum("bhrd,bthd->bhrt", qr,
                             kk[:, page * ps:(page + 1) * ps]) * d ** -0.5
            seen = (keys[None, None, :] <= qpos[:, :, None]) \
                & (keys[None, None, :] < live[:, None, None])
            seen = seen[:, None]                           # (B, 1, R, ps)
            s = torch.where(seen, s, NEG_INF)
            m_new = torch.maximum(m, s.max(-1).values)
            p = torch.where(seen, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhrt,bthd->bhrd", p, vv[:, page * ps:(page + 1) * ps])
            m = m_new
        parts.append((m, l, acc))
    mt = parts[0][0]
    for m, _, _ in parts[1:]:
        mt = torch.maximum(mt, m)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        c = torch.exp(m - mt)
        num = num + acc * c[..., None]
        den = den + l * c
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out, torch.stack([m for m, _, _ in parts])


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("lq", [1, 3])
@pytest.mark.parametrize("bits", [None, 8, 4, 2])
def test_split_combine_matches_pallas_interpret(bits, lq, splits):
    jargs, targs = _case(bits, lq=lq)
    want = np.asarray(jpa.paged_attention(*jargs, interpret=True))
    got, m = split_combine(*targs, splits)
    assert not got.isnan().any()
    tol = tpa.error_bound(*targs, torch.from_numpy(want.copy()))
    assert bool(((got - torch.from_numpy(want.copy())).abs() <= tol).all())
    if splits == 5:
        # slot 2's splits past its one live page, and slot 0's last two,
        # hold only scratch or masked keys: their partials are empty
        assert bool((m[1:, 2] == NEG_INF).all())
        assert bool((m[-2:, 0] == NEG_INF).all())


@pytest.mark.parametrize("lq,gq", [(9, 4), (8, 8)])
def test_split_combine_row_tiles_match_pallas_interpret(lq, gq):
    """More query rows than a block holds (36 and 64 at D 32): the row
    tiles, each walking the pages again, give the JAX kernel's result."""
    jargs, targs = _case(4, lq=lq, gq=gq)
    rows, d = lq * gq, targs[0].shape[-1]
    assert tpa.geometry(rows, d, 4, 5, 5)[-1] > 1
    want = torch.from_numpy(np.asarray(
        jpa.paged_attention(*jargs, interpret=True)).copy())
    tol = tpa.error_bound(*targs, want)
    for splits in (1, 5):
        got, _ = split_combine(*targs, splits)
        assert not got.isnan().any()
        assert bool(((got - want).abs() <= tol).all())


def test_split_combine_bf16_matches_plain():
    _, (q, k, v, table, pos) = _case(4, lq=3)
    q = q.to(torch.bfloat16)
    want = tpa.plain(q, k, v, table.long(), pos.long())
    tol = tpa.error_bound(q, k, v, table, pos, want)
    for splits in (1, 2, 5):
        got, _ = split_combine(q, k, v, table, pos, splits)
        assert got.dtype == torch.bfloat16
        assert bool(((got.float() - want.float()).abs() <= tol).all())


SHAPES = [(b, kvh, n_tbl, ps) for b in (1, 2, 4, 8, 32) for kvh in (1, 2, 8)
          for n_tbl in (1, 3, 11, 64, 256, 1000) for ps in (1, 4, 16)]


@pytest.mark.parametrize("b", [1, 2, 4, 8, 32])
def test_plan_covers_the_table_and_fills_the_card(b):
    for _, kvh, n_tbl, ps in (s for s in SHAPES if s[0] == b):
        splits = tpa.plan(b, kvh, 4, n_tbl, ps)
        assert 1 <= splits <= n_tbl
        parts = splitk.split_rows(n_tbl, splits)
        assert [i for lo, hi in parts for i in range(lo, hi)] \
            == list(range(n_tbl))
        assert all(hi > lo for lo, hi in parts)
        if b * kvh * n_tbl >= splitk.TARGET_BLOCKS:
            assert b * kvh * splits >= splitk.TARGET_BLOCKS
        # no split walks more than about SPLIT_TOKENS keys where the table
        # allows more splits
        if n_tbl * ps > tpa.SPLIT_TOKENS and ps <= tpa.SPLIT_TOKENS:
            assert max(hi - lo for lo, hi in parts) * ps \
                <= 2 * tpa.SPLIT_TOKENS


def test_plan_at_the_serve_and_long_context_shapes():
    assert tpa.plan(4, 8, 4, 11, 16) == 11                 # 352 blocks
    assert tpa.plan(4, 8, 4, 256, 16) == 16                # 256 keys each


def _meta_case(b, lq, kvh, gq, d, ps, pps, n_pages, bits=4, gs=16):
    meta = torch.device("meta")
    q = torch.empty((b, lq, kvh, gq, d), dtype=torch.bfloat16, device=meta)
    wire = {"packed": torch.empty((n_pages, ps, kvh, d * bits // 8),
                                  dtype=torch.uint8, device=meta),
            "scale": torch.empty((n_pages, ps, kvh, d // gs), device=meta),
            "zmin": torch.empty((n_pages, ps, kvh, d // gs), device=meta)}
    table = torch.empty((b, pps), dtype=torch.int64, device=meta)
    pos = torch.empty((b,), dtype=torch.int64, device=meta)
    return q, wire, wire, table, pos


@pytest.mark.parametrize("lq,gq,d", [(1, 4, 64), (9, 4, 64), (8, 8, 64),
                                     (4, 8, 512), (1, 2, 3072)])
def test_launch_args_read_no_tensor_value(lq, gq, d):
    """Built from meta tensors, which hold no values: any read of one
    (``.item()``, ``.cpu()``, a comparison in Python) would raise.  The
    split count is the plan's, whatever pos holds, and the block is
    geometry()'s, row tiles included."""
    b, kvh, ps, pps, n_pages = 4, 8, 16, 11, 45
    case = _meta_case(b, lq, kvh, gq, d, ps, pps, n_pages)
    args, out, ws = tpa.launch_args(*case)
    splits = tpa.plan(b, kvh, lq * gq, pps, ps)
    q = case[0]
    assert out.shape == q.shape and out.dtype == q.dtype
    assert ws.numel() == b * kvh * splits * lq * gq * (d + 2)
    assert args[11:21] == (b, lq, kvh, gq, d, ps, pps, 4, 16, splits)
    assert args[21:27] == tpa.geometry(lq * gq, d, ps, pps, splits)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    """A head_dim past MAX_D and a q dtype the kernels lack raise before
    any launch; the row count has no limit (row tiles)."""
    with pytest.raises(ValueError, match="head_dim"):
        tpa.geometry(4, tpa.MAX_D + 16, 16, 11, 11)
    meta = torch.device("meta")
    q = torch.empty((1, 1, 2, 2, 32), device=meta)
    pages = torch.empty((3, 4, 2, 32), device=meta)
    table = torch.empty((1, 2), dtype=torch.int32, device=meta)
    pos = torch.empty((1,), dtype=torch.int32, device=meta)
    with pytest.raises(TypeError):
        tpa.launch_args(q.to(torch.float16), pages, pages, table, pos)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.empty((3, 4, 2, tpa.MAX_D + 8), device=meta)
        tpa.launch_args(torch.empty((1, 1, 2, 2, tpa.MAX_D + 8),
                                    device=meta), big, big, table, pos)
    tpa.launch_args(q.expand(1, 40, 2, 2, 32), pages, pages, table, pos)


def page_walk_took(rows: int, d: int, ps: int) -> bool:
    """Whether the one-block-per-head page-walk kernel that the split
    kernels replaced took this block: its q, accumulator, one dequantized
    K/V page and scores in 48 KB of shared memory."""
    return 4 * (2 * rows * d + ps * (2 * d + 1) + rows * ps + 3 * rows) \
        <= 48 * 1024


@pytest.mark.parametrize("d", [1, 8, 16, 32, 64, 100, 128, 256, 384, 512,
                               640, 1024, 1100, 2048, 3070])
def test_geometry_takes_every_block_the_page_walk_took(d):
    """Every (rows, D, page size) that fit the replaced kernel's 48 KB
    gets a block, with the checks the C entry makes: the lanes cover D, a
    warp's lanes split evenly into token groups, at most MAX_WARPS warps,
    and the row tiles cover the rows with none empty."""
    for ps in (1, 2, 4, 16, 64):
        for rows in range(1, 700):
            if not page_walk_took(rows, d, ps):
                break
            for n_tbl, splits in ((1, 1), (11, 11), (256, 16)):
                e, lanes, t, nt, tw, tiles = tpa.geometry(
                    rows, d, ps, n_tbl, splits)
                tile = nt * tpa.ROWS_PER_WARP[e]
                assert e in tpa.LANE_ELEMS and lanes * e >= d
                assert t * lanes == 32 and nt * tw <= tpa.MAX_WARPS
                assert (tiles - 1) * tile < rows <= tiles * tile


def split_depth(b, kvh, rows, d, n_tbl, ps, splits) -> int:
    """Roundings a key's p*v passes through in the split kernels on a full
    table, at most: the product; an add and a rescale for each later chunk
    of its token group; the shuffle adds of the warp's token groups (only
    levels whose other half saw a key); the token teams' combine (a
    rescale, an add for each other team that saw a key); the splits'
    combine (the same); the division."""
    _, _, t, _, tw, _ = tpa.geometry(rows, d, ps, n_tbl, splits)
    keys = max(hi - lo for lo, hi in splitk.split_rows(n_tbl, splits)) * ps
    chunks = -(-keys // (t * tw))
    groups = min(t, keys)
    teams = min(tw, -(-keys // t))
    levels = math.ceil(math.log2(groups)) if groups > 1 else 0
    return (1 + 2 * (chunks - 1) + levels
            + (teams > 1) + (teams - 1) + (splits > 1) + (splits - 1) + 1)


@pytest.mark.parametrize("rows,d", [(1, 16), (4, 64), (12, 64), (32, 64),
                                    (4, 128), (20, 128), (8, 256),
                                    (1, 512), (36, 64), (64, 64), (32, 512),
                                    (8, 1024), (2, 3072)])
def test_split_nest_fits_the_error_bound(rows, d):
    """error_bound's (n+8)*u term: the split kernels' nest is within n + 8
    (see its docstring) under the plan and under 1, 2 and P splits, for a
    sweep of table shapes, row tilings and head_dims up to MAX_D."""
    for b, kvh, n_tbl, ps in SHAPES:
        n = n_tbl * ps
        for splits in {tpa.plan(b, kvh, rows, n_tbl, ps), 1,
                       min(2, n_tbl), n_tbl}:
            assert split_depth(b, kvh, rows, d, n_tbl, ps, splits) \
                <= n + 8, (b, kvh, n_tbl, ps, splits)
