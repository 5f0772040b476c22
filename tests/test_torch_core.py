"""Port's format layer against the JAX package: packing, the KV wire
format, weight quantization, paged gather/scatter and byte accounting.

Wire bytes must be EQUAL (the same packed codes, scale and zmin), so the
two packages can exchange caches, pools and byte budgets.  Inputs are
made with numpy from a seed and handed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvwire as jkv
from repro.core import packing as jpack
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.config import ModelConfig as JConfig
from repro.serve import pool as jpool
from repro_torch.core import kvwire as tkv
from repro_torch.core import packing as tpack
from repro_torch.core import schemes as tschemes
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serve import pool as tpool

RNG = np.random.default_rng(0)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _ties(shape, group):
    """Values whose codes sit exactly on .5 rounding ties at 4 bits: each
    region spans [0, 15] (scale 1) and holds k + 0.5 values."""
    x = RNG.integers(0, 15, size=shape).astype(np.float32) + 0.5
    x = x.reshape(*shape[:-1], shape[-1] // group, group)
    x[..., 0], x[..., 1] = 0.0, 15.0
    return x.reshape(shape)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_pack_unpack_equal_jax(bits):
    codes = RNG.integers(0, 1 << bits, size=(3, 5, 64)).astype(np.uint8)
    tp = tpack.pack(torch.from_numpy(codes), bits)
    _eq(tp, jpack.pack(jnp.asarray(codes), bits))
    _eq(tpack.unpack(tp, bits, 64), codes)
    assert tpack.codes_per_byte(bits) == jpack.codes_per_byte(bits)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("group", [16, 32])
def test_quantize_kv_equal_jax(bits, group):
    x = RNG.normal(size=(2, 7, 3, 64)).astype(np.float32)
    x[0, 0, 0, :group] = 0.25                     # zero-range region
    tw = tkv.quantize_kv(torch.from_numpy(x), bits, group)
    jw = jkv.quantize_kv(jnp.asarray(x), bits, group)
    for k in ("packed", "scale", "zmin"):
        _eq(tw[k], jw[k])
    if bits not in tkv.KV_BITS:     # the wire format infers 8/4/2/1 only
        return
    back = tkv.dequantize_kv(tw, 64)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jkv.dequantize_kv(jw, 64)))


def test_quantize_rounds_half_to_even_like_jax():
    x = _ties((4, 64), 16)
    tw = tkv.quantize_kv(torch.from_numpy(x), 4, 16)
    _eq(tw["packed"], jkv.quantize_kv(jnp.asarray(x), 4, 16)["packed"])
    codes = tpack.unpack(tw["packed"], 4, 64).numpy().astype(np.float32)
    np.testing.assert_array_equal(codes, np.round(x))    # numpy: half-even


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_quantize_weight_equal_jax(bits):
    w = RNG.normal(size=(256, 40)).astype(np.float32)
    w[:128, 3] = -1.5                              # zero-range region
    tp, ts, tz = tref.quantize_weight(torch.from_numpy(w), bits, 128)
    jp, js, jz = jref.quantize_weight(jnp.asarray(w), bits, 128)
    _eq(tp, jp), _eq(ts, js), _eq(tz, jz)
    assert ts[0, 3] == 1.0                         # scale 1 on zero range
    np.testing.assert_array_equal(
        tref.dequantize_weight(tp, ts, tz, bits, 128).numpy(),
        np.asarray(jref.dequantize_weight(jp, js, jz, bits, 128)))
    tq = tops.quantize_weight(torch.from_numpy(w), bits, 128)
    jq = jops.quantize_weight(jnp.asarray(w), bits, 128)
    assert tq.nbytes() == jq.nbytes() and tq.shape == jq.shape


def test_quantize_weight_ties_equal_jax():
    w = _ties((40, 256), 128).T.copy()             # regions along K
    tp, _, _ = tref.quantize_weight(torch.from_numpy(w), 4, 128)
    _eq(tp, jref.quantize_weight(jnp.asarray(w), 4, 128)[0])


def _pages(bits, n_pages=9, ps=4, kvh=2, d=32):
    x = RNG.normal(size=(n_pages, ps, kvh, d)).astype(np.float32)
    if bits is None:
        return torch.from_numpy(x.copy()), jnp.asarray(x)
    return ({k: torch.from_numpy(np.asarray(v).copy()) for k, v in
             jkv.quantize_kv(jnp.asarray(x), bits, 16).items()},
            jkv.quantize_kv(jnp.asarray(x), bits, 16))


def _eq_leaf(t, j):
    if isinstance(t, dict):
        for k in t:
            _eq(t[k], j[k])
    else:
        _eq(t, j)


@pytest.mark.parametrize("bits", [None, 8, 4, 2])
def test_paged_scatter_gather_equal_jax(bits):
    tl, jl = _pages(bits)
    new = RNG.normal(size=(3, 2, 2, 32)).astype(np.float32)
    page_idx = np.array([[1, 1], [4, 5], [0, 0]], np.int32)  # 3rd: scratch
    row = np.array([[2, 3], [3, 0], [1, 1]], np.int32)
    kw = dict(bits=bits, group_size=16) if bits else {}
    tkv.scatter_tokens(tl, torch.from_numpy(new),
                       torch.from_numpy(page_idx).long(),
                       torch.from_numpy(row).long(), **kw)
    jl = jkv.scatter_tokens(jl, jnp.asarray(new), jnp.asarray(page_idx),
                            jnp.asarray(row), **kw)
    keep = np.ones(9, bool)
    keep[0] = False                                # scratch order is free
    if bits:
        for k in tl:
            _eq(tl[k][keep], np.asarray(jl[k])[keep])
    else:
        _eq(tl[keep], np.asarray(jl)[keep])
    table = np.array([[1, 4, 5], [2, 0, 0]], np.int32)
    tg = tkv.gather_pages(tl, torch.from_numpy(table).long())
    jg = jkv.gather_pages(jl, jnp.asarray(table))
    sel = (slice(None), slice(0, 4))               # table column 0 only
    _eq_leaf({k: v[sel] for k, v in tg.items()} if bits else tg[sel],
             {k: np.asarray(v)[sel] for k, v in jg.items()} if bits
             else np.asarray(jg)[sel])
    contig = RNG.normal(size=(1, 12, 2, 32)).astype(np.float32)
    cw = (tkv.quantize_kv(torch.from_numpy(contig), bits, 16) if bits
          else torch.from_numpy(contig))
    jcw = (jkv.quantize_kv(jnp.asarray(contig), bits, 16) if bits
           else jnp.asarray(contig))
    ids = np.array([3, 7, 8], np.int32)
    tkv.scatter_prefill(tl, cw, torch.from_numpy(ids).long())
    jl = jkv.scatter_prefill(jl, jcw, jnp.asarray(ids))
    _eq_leaf({k: v[ids] for k, v in tl.items()} if bits else tl[ids],
             {k: np.asarray(v)[ids] for k, v in jl.items()} if bits
             else np.asarray(jl)[ids])


def test_update_and_zero_init_equal_jax():
    shape = (1, 8, 2, 32)
    tq = tkv.make_quant_kv(shape, 4, 16)
    jq = jkv.make_quant_kv(shape, 4, 16)
    _eq_leaf(tq, jq)
    new = RNG.normal(size=(1, 3, 2, 32)).astype(np.float32)
    tkv.update_quant_kv(tq, torch.from_numpy(new), 2, axis=1, bits=4,
                        group_size=16)
    jq = jkv.update_quant_kv(jq, jnp.asarray(new), 2, axis=1, bits=4,
                             group_size=16)
    _eq_leaf(tq, jq)
    assert tkv.cache_nbytes(tq) == jkv.cache_nbytes(jq)


def test_kv_bits_checks_and_token_bytes():
    for bits in (None, 8, 4, 2, 1):
        for group in (16, 32, 64):
            assert tkv.kv_token_nbytes(8, 64, bits, group) == \
                jkv.kv_token_nbytes(8, 64, bits, group)
    for bad in (3, 5, 6, 16):
        with pytest.raises(ValueError, match="kv_bits"):
            tkv.check_kv_bits(bad)


@pytest.mark.parametrize("kv_bits", [None, 8, 4, 2, 1])
def test_pool_nbytes_equal_jax(kv_bits):
    kw = dict(name="t", family="dense", n_layers=3, d_model=128,
              vocab_size=256, n_heads=4, n_kv_heads=2, head_dim=32,
              d_ff=256, dtype="float32")
    geo = dict(n_pages=10, page_size=4, kv_bits=kv_bits, kv_group=16)
    want = jpool.pool_nbytes(JConfig(**kw), **geo)
    assert tpool.pool_nbytes(TConfig(**kw), **geo) == want
    assert tpool.PagedKVPool(TConfig(**kw), **geo).nbytes() == want


def test_scheme_registry_matches_jax():
    from repro.core import schemes as jschemes
    assert tschemes.names() == jschemes.names()
    for name in tschemes.names():
        assert dataclasses_equal(tschemes.get(name), jschemes.get(name))


def dataclasses_equal(a, b):
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)
