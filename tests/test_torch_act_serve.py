"""The port's activation-quantized forwards (``lq8``, ``lq4``: act_quant
then quant_matmul; ``lq2_lut``: act_quant then lut_matmul) against the
JAX package on the same weights: prefill and paged-decode logits, the
continuous-batching Server's greedy tokens, the ``a_bits`` override and
the CLI.

The config keeps every K a multiple of 128 so every projection packs and
quantizes its activations; f32.  The JAX side runs its plain references
(``backend="ref"``), the port its plain versions.  Logit tolerance 2e-4,
as in ``test_torch_model.py``: XLA and PyTorch sum the f32 matmuls in
other orders, ~1e-6 relative.

That noise puts an activation on a rounding tie now and then: at 8 bits
a step is 1/255 of a region's range, and at these seeds the layer-0 down
projection's input of ``lq8`` with a 4-bit pool lands 1.5e-4 of a step on
either side of 156.5 in the two packages.  One code apart moves every
later activation of that row, so the logits test compares from shared
inputs, as ``test_torch_model.py`` does for the pool: each of the port's
act_quant calls is checked against the JAX call at the same place (codes
equal, or one apart at an input within 1e-3 of a step of a rounding
boundary in both packages) and then hands on the JAX codes.  The Server
tests compare greedy tokens free running.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvwire as jkv
from repro.core import schemes as jschemes
from repro.kernels import ref as jref
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JConfig
from repro.models.layers import QuantPolicy as JPolicy
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import PagedConfig as JPagedConfig
from repro.serve import RequestParams as JRequestParams
from repro.serve import Server as JServer
from repro.serve import pool as jpool
from repro_torch.core import packing
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.layers import QuantPolicy as TPolicy
from repro_torch.serve import pool as tpool
from repro_torch.serve.engine import EngineConfig, PagedConfig, PagedEngine
from repro_torch.serve.server import RequestParams, Server

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


def _torch_pages(jpages):
    """A JAX pool (stacked "super" layout) as the port's per-layer pages."""
    sup = jax.tree.map(lambda a: np.asarray(a).copy(),
                       jpages["super"][0]["self"])

    def leaf(a, i):
        if isinstance(a, dict):
            return {k: torch.from_numpy(v[i].copy()) for k, v in a.items()}
        return torch.from_numpy(a[i].copy())
    return [{name: leaf(sup[name], i) for name in ("k", "v")}
            for i in range(JCFG.n_layers)]


TIE = 1e-3            # of a step: how near a boundary a tie input lies


class SharedCodes:
    """Records every JAX act_quant call (input and outputs, in call order)
    and has the port's act_quant, call by call, check its own codes
    against the JAX ones and then return the JAX outputs."""

    def __init__(self, monkeypatch):
        self.jax, self.calls, self.ties = [], 0, 0
        jaq, taq = jref.act_quant, tops.act_quant

        def record(*arrays):
            self.jax.append([np.asarray(a).copy() for a in arrays])

        def jax_side(x, *, bits, group_size):
            out = jaq(x, bits=bits, group_size=group_size)
            jax.debug.callback(record, x, *out, ordered=True)
            return out

        def port_side(x, *, bits, group_size):
            own = taq(x, bits=bits, group_size=group_size)
            jx, *jout = self.jax[self.calls]
            self.calls += 1
            self.ties += self._check(x.numpy(), jx, own, jout, bits,
                                     group_size)
            return tuple(torch.from_numpy(a) for a in jout)

        monkeypatch.setattr(jref, "act_quant", jax_side)
        monkeypatch.setattr(tops, "act_quant", port_side)

    @staticmethod
    def _check(tx, jx, own, jout, bits, gs):
        m, k = tx.shape
        tc = packing.unpack(own[0], bits).numpy().astype(int)
        jc = packing.unpack(torch.from_numpy(jout[0]), bits).numpy()
        diff = np.abs(tc - jc.astype(int))
        assert diff.max(initial=0) <= 1
        if not diff.any():
            return 0

        def steps(x, scale, zmin):
            return ((x.reshape(m, k // gs, gs) - zmin[..., None])
                    / scale[..., None]).reshape(m, k)
        ut = steps(tx, own[1].numpy(), own[2].numpy())[diff > 0]
        uj = steps(jx.reshape(m, k), jout[1], jout[2])[diff > 0]
        assert np.abs(ut % 1 - 0.5).max() < TIE, ut
        assert np.abs(uj % 1 - 0.5).max() < TIE, uj
        return int((diff > 0).sum())

    def start(self):
        self.jax.clear()
        self.calls = 0

    def done(self):
        """Every JAX call was matched by one of the port's."""
        assert self.calls == len(self.jax) == 7 * JCFG.n_layers


@pytest.mark.parametrize("kv_bits", [None, 4])
@pytest.mark.parametrize("scheme", ["lq8", "lq4", "lq2_lut"])
def test_prefill_and_paged_decode_match_jax(weights, scheme, kv_bits,
                                            monkeypatch):
    """Prefill logits, then one paged decode step that reads the same pool
    (the JAX one, converted) in both packages, fused and unfused, from
    shared act_quant codes (module docstring)."""
    shared = SharedCodes(monkeypatch)
    jp, tp = weights
    jp = jt.quantize_params(jp, JCFG, jschemes.get(scheme))
    tp = tt.quantize_params(tp, TCFG, scheme)
    jpol, tpol = JPolicy.serve(scheme, backend="ref"), TPolicy.serve(scheme)
    kvq = None if kv_bits is None else (kv_bits, GROUP)
    rng = np.random.default_rng(kv_bits or 0)
    bucket, n_tok = 16, 11
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n_tok] = rng.integers(0, 256, n_tok)

    shared.start()
    jc = jt.init_cache(JCFG, 1, bucket, kv_quant=kvq)
    jlog, jc = jax.jit(lambda p, t, c: jt.prefill(
        p, JCFG, {"tokens": t}, c, policy=jpol, logits_pos=n_tok - 1))(
            jp, jnp.asarray(toks), jc)
    jax.effects_barrier()
    tc = tt.init_cache(TCFG, 1, bucket, kv_quant=kvq)
    tlog, _ = tt.prefill(tp, TCFG, torch.from_numpy(toks).long(), tc,
                         policy=tpol, logits_pos=n_tok - 1)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=LOGIT_TOL)
    shared.done()

    ids = np.array([3, 5, 1, 7], np.int32)
    jpages = jpool.make_pool_pages(JCFG, n_pages=N_PAGES, page_size=PS,
                                   kv_bits=kv_bits, kv_group=GROUP)
    jpages = {"super": jkv.scatter_prefill(jpages["super"], jc["super"],
                                           jnp.asarray(ids), stacked=True),
              "tail": []}
    table = np.array([[3, 5, 1, 7, 0], [0, 0, 0, 0, 0]], np.int32)
    pos = np.array([n_tok, 0], np.int32)
    nxt = np.array([[int(np.argmax(np.asarray(jlog)[0, 0]))], [0]],
                   np.int32)
    for jfused, tfused in ((None, False), ("interpret", True)):
        shared.start()
        jl, _ = jax.jit(lambda p, pg: jt.paged_decode_step(
            p, JCFG, jnp.asarray(nxt), pg, jnp.asarray(table),
            jnp.asarray(pos), policy=jpol, fused=jfused))(jp, jpages)
        jax.effects_barrier()
        tl, _ = tt.paged_decode_step(
            tp, TCFG, torch.from_numpy(nxt).long(), _torch_pages(jpages),
            torch.from_numpy(table).long(), torch.from_numpy(pos).long(),
            policy=tpol, fused=tfused)
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0],
                                   rtol=0, atol=LOGIT_TOL)
        shared.done()
    assert shared.ties <= 4


PROMPTS = [list(map(int, np.random.default_rng(1).integers(0, 256, n)))
           for n in (7, 12, 5)]
MAX_NEW = [8, 6, 7]


def _drive(srv, params_cls):
    rids = []
    for i, (p, n) in enumerate(zip(PROMPTS, MAX_NEW)):
        rids.append(srv.submit(p, params_cls(max_new_tokens=n)))
        if i == 0:
            srv.step()
            srv.step()
    outs = srv.drain(max_steps=500)
    return [outs[r] for r in rids]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("scheme", ["lq8", "lq2_lut"])
def test_continuous_tokens_equal_jax_server(weights, scheme, fused):
    jp, tp = weights
    kv = dict(kv_bits=4, kv_group=16)
    geo = dict(max_slots=2, page_size=4, n_pages=24, max_context=32)
    js = JServer(JCFG, jp, JEngineConfig(max_len=32, weight_scheme=scheme,
                                         backend="ref",
                                         fused_attention=fused, **kv),
                 JPagedConfig(**geo))
    ts = Server(TCFG, tp, EngineConfig(max_len=32, weight_scheme=scheme,
                                       fused_attention=fused, **kv),
                PagedConfig(**geo), device="cpu")
    assert _drive(ts, RequestParams) == _drive(js, JRequestParams)


def test_a_bits_overrides_the_scheme_like_jax(weights):
    from repro.serve.engine import Engine as JEngine
    jp, tp = weights
    for scheme, a_bits in (("lq4w", 8), ("lq2_lut", 4), ("lq8", None)):
        je = JEngine(JCFG, jp, JEngineConfig(max_len=32, weight_scheme=scheme,
                                             a_bits=a_bits, backend="ref"))
        te = PagedEngine(TCFG, tp, EngineConfig(max_len=32,
                                                weight_scheme=scheme,
                                                a_bits=a_bits),
                         PagedConfig(max_context=32), device="cpu")
        assert te.policy.cfg.a_bits == je.policy.cfg.a_bits
        assert te.policy.cfg.lut == je.policy.cfg.lut


@pytest.mark.parametrize("argv", [["--scheme", "lq2_lut"],
                                  ["--scheme", "lq4w", "--a-bits", "8"]])
def test_cli_serves_activation_schemes_on_cpu(argv, capsys, monkeypatch):
    """The smoke config packs only its K=128 down projection; that one
    must go through the activation path the scheme names."""
    from repro_torch.kernels import act_quant, lut_matmul
    from repro_torch.launch import serve as cli
    calls = {"act_quant": 0, "lut_matmul": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(act_quant, "plain",
                        counting("act_quant", act_quant.plain))
    monkeypatch.setattr(lut_matmul, "plain",
                        counting("lut_matmul", lut_matmul.plain))
    res = cli.main(["--arch", "llama3.2-1b", "--smoke", *argv,
                    "--kv-bits", "4", "--continuous", "2", "--steps", "3",
                    "--prompt-len", "6", "--fused-attention",
                    "--device", "cpu"])
    assert res["tokens"] == 2 * 4
    out = capsys.readouterr().out
    assert "continuous: 2 requests" in out and "lut_matmul 0" in out
    assert calls["act_quant"] > 0
    assert (calls["lut_matmul"] > 0) == ("lq2_lut" in argv)
    assert set(res["launches"]) == {"quant_matmul", "paged_attention",
                                    "act_quant", "lut_matmul"}
