"""The port's dense decoder against the JAX package on the same weights:
parameter conversion, quantized parameters byte for byte, and prefill +
paged decode logits for {fp, lq4w} x kv {fp, 8, 4, 2}.

The config keeps every K a multiple of 128, so lq4w really packs every
projection (the repo's TINY, d_model 64, would keep them fp under the
skip rule).  f32 throughout.

Logit tolerance 2e-4 (logits are ~N(0, 1) here): XLA and PyTorch sum the
f32 matmuls in other orders, ~1e-6 relative.  That noise is enough for a
K/V element that lies on a rounding tie to land one code apart in the two
packages (it happens at these seeds).  Prefill logits do not see the
codes (prefill attends over fp K/V), so they are compared directly; the
pools written by prefill are compared code by code, allowing one-code
differences on a small share of elements; and the decode step then reads
the SAME pool (the JAX one, converted) in both packages, so its logits
are compared at the f32 tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvwire as jkv
from repro.core import schemes as jschemes
from repro.kernels import ops as jops
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JConfig
from repro.models.layers import NO_QUANT as J_NO_QUANT
from repro.models.layers import QuantPolicy as JPolicy
from repro.serve import pool as jpool
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.layers import NO_QUANT as T_NO_QUANT
from repro_torch.models.layers import QuantPolicy as TPolicy
from repro_torch.serve import pool as tpool

KW = dict(name="t128", family="dense", n_layers=2, d_model=128,
          vocab_size=256, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
          dtype="float32")
JCFG, TCFG = JConfig(**KW, remat="none"), TConfig(**KW)
LOGIT_TOL = 2e-4
PS, N_PAGES, GROUP = 4, 9, 16


@pytest.fixture(scope="module")
def weights():
    jp = jt.init_params(JCFG, jax.random.key(0))
    return jp, tt.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _qweights(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _qweights(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _qweights(v)
    elif isinstance(tree, (jops.QWeight, tops.QWeight)):
        yield tree


def test_from_jax_params_layout(weights):
    jp, tp = weights
    assert len(tp["layers"]) == JCFG.n_layers
    for i, lay in enumerate(tp["layers"]):
        np.testing.assert_array_equal(
            lay["mixer"]["wq"]["w"].numpy(),
            np.asarray(jp["decoder"]["super"][0]["mixer"]["wq"]["w"][i]))
        np.testing.assert_array_equal(
            lay["ffn"]["wo"]["w"].numpy(),
            np.asarray(jp["decoder"]["super"][0]["ffn"]["wo"]["w"][i]))
    n = sum(a.numel() for a in tt.leaves(tp))
    assert n == sum(a.size for a in jax.tree.leaves(jp))


def test_quantize_params_bytes_equal_jax(weights):
    jp, tp = weights
    jq = jt.quantize_params(jp, JCFG, jschemes.get("lq4w"))
    tq = tt.quantize_params(tp, TCFG, "lq4w")
    jqw, tqw = list(_qweights(jq)), list(_qweights(tq))
    assert len(jqw) == 7 and len(tqw) == 7 * JCFG.n_layers   # stacked
    assert sum(q.nbytes() for q in tqw) == sum(q.nbytes() for q in jqw)
    for i, lay in enumerate(tq["layers"]):
        for a, b in (("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"),
                     ("mixer", "wo"), ("ffn", "wi_gate"), ("ffn", "wi_up"),
                     ("ffn", "wo")):
            tw = lay[a][b]["w"]
            jw = jq["decoder"]["super"][0][a][b]["w"]
            for leaf in ("packed", "scale", "zmin"):
                np.testing.assert_array_equal(
                    getattr(tw, leaf).numpy(),
                    np.asarray(getattr(jw, leaf)[i]))


def test_quantize_params_skip_rule_matches_jax():
    """K not a multiple of the group size keeps a weight fp (K=64 here),
    while the K=128 down projection packs — in both packages."""
    kw = dict(KW, d_model=64, d_ff=128, head_dim=16)
    jp = jt.init_params(JConfig(**kw, remat="none"), jax.random.key(1))
    tp = tt.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    jq = jt.quantize_params(jp, JConfig(**kw, remat="none"),
                            jschemes.get("lq4w"))
    tq = tt.quantize_params(tp, TConfig(**kw), "lq4w")
    lay = tq["layers"][0]
    assert isinstance(lay["ffn"]["wo"]["w"], tops.QWeight)
    assert not isinstance(lay["mixer"]["wq"]["w"], tops.QWeight)
    assert len(list(_qweights(tq))) == \
        JCFG.n_layers * len(list(_qweights(jq)))


def _wire(leaf):
    return isinstance(leaf, dict)


def _assert_pools_close(jpages, tpages, kv_bits, *, max_share=0.01):
    """Every layer's K/V pages agree: codes within one step (a rounding
    tie) on at most ``max_share`` of the elements, scale/zmin and fp pages
    within f32 summation noise."""
    from repro_torch.core import packing
    for i, layer in enumerate(tpages):
        for name in ("k", "v"):
            jl = jpages["super"][0]["self"][name]
            if kv_bits is None:
                np.testing.assert_allclose(layer[name].numpy(),
                                           np.asarray(jl[i]), atol=1e-5)
                continue
            tc = packing.unpack(layer[name]["packed"], kv_bits).numpy()
            jc = packing.unpack(torch.from_numpy(
                np.asarray(jl["packed"][i]).copy()), kv_bits).numpy()
            diff = np.abs(tc.astype(int) - jc.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= max_share, (
                f"layer {i} {name}: codes differ by up to {diff.max()} on "
                f"{(diff > 0).sum()} elements")
            for leaf in ("scale", "zmin"):
                np.testing.assert_allclose(layer[name][leaf].numpy(),
                                           np.asarray(jl[leaf][i]),
                                           rtol=1e-5, atol=1e-6)


def _torch_pages(jpages):
    """A JAX pool (stacked "super" layout) as the port's per-layer pages."""
    sup = jax.tree.map(lambda a: np.asarray(a).copy(),
                       jpages["super"][0]["self"])
    n = JCFG.n_layers

    def layer(i):
        return {name: ({k: torch.from_numpy(v[i].copy())
                        for k, v in sup[name].items()}
                       if _wire(sup[name]) else
                       torch.from_numpy(sup[name][i].copy()))
                for name in ("k", "v")}
    return [layer(i) for i in range(n)]


@pytest.mark.parametrize("kv_bits", [None, 8, 4, 2])
@pytest.mark.parametrize("scheme", [None, "lq4w"])
def test_prefill_and_paged_decode_match_jax(weights, scheme, kv_bits):
    jp, tp = weights
    if scheme:
        jp = jt.quantize_params(jp, JCFG, jschemes.get(scheme))
        tp = tt.quantize_params(tp, TCFG, scheme)
        jpol = JPolicy.serve(scheme, backend="ref")
        tpol = TPolicy.serve(scheme)
    else:
        jpol, tpol = J_NO_QUANT, T_NO_QUANT
    kvq = None if kv_bits is None else (kv_bits, GROUP)
    rng = np.random.default_rng(kv_bits or 0)
    bucket, n_tok = 16, 11
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n_tok] = rng.integers(0, 256, n_tok)

    # prefill on a right-padded bucket, logits at the last real token
    jc = jt.init_cache(JCFG, 1, bucket, kv_quant=kvq)
    jlog, jc = jax.jit(lambda p, t, c: jt.prefill(
        p, JCFG, {"tokens": t}, c, policy=jpol, logits_pos=n_tok - 1))(
            jp, jnp.asarray(toks), jc)
    tc = tt.init_cache(TCFG, 1, bucket, kv_quant=kvq)
    tlog, tc = tt.prefill(tp, TCFG, torch.from_numpy(toks).long(), tc,
                          policy=tpol, logits_pos=n_tok - 1)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=LOGIT_TOL)

    # scatter into pool pages, then one decode step (slot 1 inactive)
    ids = np.array([3, 5, 1, 7], np.int32)
    geo = dict(n_pages=N_PAGES, page_size=PS, kv_bits=kv_bits,
               kv_group=GROUP)
    jpages = jpool.make_pool_pages(JCFG, **geo)
    jpages = {"super": jkv.scatter_prefill(jpages["super"], jc["super"],
                                           jnp.asarray(ids), stacked=True),
              "tail": []}
    tpages = tpool.make_pool_pages(TCFG, **geo)
    for pl, cl in zip(tpages, tc):
        for name in ("k", "v"):
            tt.kvwire.scatter_prefill(pl[name], cl[name],
                                      torch.from_numpy(ids).long())
    _assert_pools_close(jpages, tpages, kv_bits)
    table = np.array([[3, 5, 1, 7, 0], [0, 0, 0, 0, 0]], np.int32)
    pos = np.array([n_tok, 0], np.int32)
    nxt = np.array([[int(np.argmax(np.asarray(jlog)[0, 0]))], [0]],
                   np.int32)
    fused_modes = [(None, False)] + ([("interpret", True)]
                                     if kv_bits in (None, 4) else [])
    for jfused, tfused in fused_modes:
        jl, jpg = jax.jit(lambda p, pg, t=None: jt.paged_decode_step(
            p, JCFG, jnp.asarray(nxt), pg, jnp.asarray(table),
            jnp.asarray(pos), policy=jpol, fused=jfused))(jp, jpages)
        tl, tpg = tt.paged_decode_step(
            tp, TCFG, torch.from_numpy(nxt).long(), _torch_pages(jpages),
            torch.from_numpy(table).long(), torch.from_numpy(pos).long(),
            policy=tpol, fused=tfused)
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0],
                                   rtol=0, atol=LOGIT_TOL)
        _assert_pools_close(jpg, tpg, kv_bits)


@pytest.mark.parametrize("scheme", [None, "lq4w"])
def test_long_prefill_matches_jax(weights, scheme):
    """A 300-token prompt: the port's prefill attends over two key and two
    query blocks of ``ref.ATTN_BLOCK`` (the reference over one of its own),
    so blocking is held to JAX at the logits tolerance."""
    from repro_torch.kernels import ref
    jp, tp = weights
    if scheme:
        jp = jt.quantize_params(jp, JCFG, jschemes.get(scheme))
        tp = tt.quantize_params(tp, TCFG, scheme)
        jpol = JPolicy.serve(scheme, backend="ref")
        tpol = TPolicy.serve(scheme)
    else:
        jpol, tpol = J_NO_QUANT, T_NO_QUANT
    bucket, n_tok = 320, 300
    assert n_tok > ref.ATTN_BLOCK
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n_tok] = np.random.default_rng(5).integers(0, 256, n_tok)
    jc = jt.init_cache(JCFG, 1, bucket)
    jlog, _ = jax.jit(lambda p, t, c: jt.prefill(
        p, JCFG, {"tokens": t}, c, policy=jpol, logits_pos=n_tok - 1))(
            jp, jnp.asarray(toks), jc)
    tlog, _ = tt.prefill(tp, TCFG, torch.from_numpy(toks).long(),
                         tt.init_cache(TCFG, 1, bucket), policy=tpol,
                         logits_pos=n_tok - 1)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=LOGIT_TOL)
