"""The port's paged engine on its fixed-shape step buffers, on the CPU
(where each step's body runs eagerly on the buffers the card's captured
graphs read): prefill logits read at a device index, one bucket for
every prompt length, against the JAX engine's one jit; the decode step
against the model function it wraps; ``decode_compilations`` in the
server's stats and on the launcher's output.

The config keeps every K a multiple of 128 so lq4w packs every
projection; f32.  Logit tolerance 2e-4, as tests/test_torch_model.py
states it (XLA and PyTorch sum f32 matmuls in other orders; prefill
attends over fp K/V, so no code tie reaches the logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schemes as jschemes
from repro.models import transformer as jt
from repro.models.config import ModelConfig as JConfig
from repro.models.layers import NO_QUANT as J_NO_QUANT
from repro.models.layers import QuantPolicy as JPolicy
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import PagedConfig as JPagedConfig
from repro.serve import RequestParams as JRequestParams
from repro.serve import Server as JServer
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serve.engine import EngineConfig, PagedConfig, PagedEngine
from repro_torch.serve.server import RequestParams, Server

KW = dict(name="t128", family="dense", n_layers=2, d_model=128,
          vocab_size=256, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
          dtype="float32")
JCFG, TCFG = JConfig(**KW, remat="none"), TConfig(**KW)
LOGIT_TOL = 2e-4
BUCKET, PS = 16, 4


@pytest.fixture(scope="module")
def weights():
    jp = jt.init_params(JCFG, jax.random.key(0))
    return jp, tt.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _engine(tp, scheme, kv_bits=4, fused=False):
    kv = dict(kv_bits=kv_bits, kv_group=16) if kv_bits else {}
    return PagedEngine(TCFG, tp, EngineConfig(max_len=BUCKET,
                                              weight_scheme=scheme,
                                              fused_attention=fused, **kv),
                       PagedConfig(max_slots=2, page_size=PS, n_pages=12,
                                   max_context=BUCKET), device="cpu")


@pytest.mark.parametrize("scheme", [None, "lq4w"])
def test_prefill_bucket_reads_logits_at_a_device_index_like_jax(weights,
                                                                scheme):
    """Three prompt lengths, longest first, through one engine's bucket
    buffers: each prefill's logits equal JAX's from its one jitted prefill
    (logits_pos traced, one compilation for every length), and the pages
    each writes equal those a fresh engine writes for that prompt alone,
    so nothing of a longer prompt stays in the bucket."""
    jp, tp = weights
    if scheme:
        jp = jt.quantize_params(jp, JCFG, jschemes.get(scheme))
        jpol = JPolicy.serve(scheme, backend="ref")
    else:
        jpol = J_NO_QUANT
    jprefill = jax.jit(lambda p, t, c, lp: jt.prefill(
        p, JCFG, {"tokens": t}, c, policy=jpol, logits_pos=lp))
    eng = _engine(tp, scheme)
    pool = eng.new_pool()
    rng = np.random.default_rng(7)
    got = []
    for rid, n in enumerate((16, 3, 11)):
        prompt = rng.integers(0, 256, n)
        toks = np.zeros((1, BUCKET), np.int32)
        toks[0, :n] = prompt
        jlog, _ = jprefill(jp, jnp.asarray(toks),
                           jt.init_cache(JCFG, 1, BUCKET, kv_quant=(4, 16)),
                           jnp.int32(n - 1))
        assert pool.alloc(rid, -(-n // PS))
        ids = pool.pages_of(rid)
        logits = eng.prefill_logits(pool, prompt.tolist(), ids)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog)[:, 0],
                                   rtol=0, atol=LOGIT_TOL)
        got.append((logits, logits.clone(), prompt, ids))
    assert jprefill._cache_size() == 1
    for logits, kept, prompt, ids in got:
        assert torch.equal(logits, kept)       # no alias of the buffers
        fresh = _engine(tp, scheme)
        fpool = fresh.new_pool()
        fresh.prefill_logits(fpool, prompt.tolist(), ids)
        for a, b in zip(tt.leaves(pool.pages), tt.leaves(fpool.pages)):
            assert torch.equal(a[ids], b[ids])


@pytest.mark.parametrize("kv_bits,fused", [(4, True), (None, False)])
def test_decode_step_on_its_buffers_equals_the_model_step(weights, kv_bits,
                                                          fused):
    """The engine's decode (buffers filled from host arrays, then the body)
    gives the bytes of ``paged_decode_step`` called on the same pool, and
    returns tensors of the caller's own."""
    _, tp = weights
    eng = _engine(tp, "lq4w", kv_bits, fused)
    pool = eng.new_pool()
    assert pool.alloc(0, 3) and pool.alloc(1, 2)
    eng.prefill_logits(pool, [5, 7, 9, 11, 13, 1, 2, 3, 4], pool.pages_of(0))
    eng.prefill_logits(pool, [8, 6, 4], pool.pages_of(1))
    table = np.stack([pool.table_array(r, 4) for r in (0, 1)])
    tokens, pos = np.array([42, 17], np.int32), np.array([9, 3], np.int32)
    ref_pages = tt.tree_map(lambda a: a.clone(), pool.pages)
    want, _ = tt.paged_decode_step(
        eng.params, TCFG, torch.from_numpy(tokens).long()[:, None],
        ref_pages, torch.from_numpy(table).long(),
        torch.from_numpy(pos).long(), policy=eng.policy, fused=fused)
    got = eng.decode_logits(pool, tokens, table, pos)
    assert torch.equal(got, want[:, -1])
    got.zero_()
    assert not torch.equal(got, eng._io.logits["decode"])
    toks = eng.decode_step_batch(pool, tokens, table, pos + 1)
    assert not np.shares_memory(toks, eng._io.greedy["decode"].numpy())
    with pytest.raises(ValueError):
        eng.decode_logits(pool, tokens[:1], table[:1], pos[:1])
    with pytest.raises(ValueError):
        eng.prefill_logits(pool, list(range(BUCKET + 1)), [1])


def test_server_stats_report_decode_compilations(weights):
    """Both packages report the count: JAX compiles its decode step once;
    on the CPU the port captures nothing and says 0."""
    jp, tp = weights
    geo = dict(max_slots=2, page_size=PS, n_pages=12, max_context=BUCKET)
    js = JServer(JCFG, jp, JEngineConfig(max_len=BUCKET, backend="ref"),
                 JPagedConfig(**geo))
    ts = Server(TCFG, tp, EngineConfig(max_len=BUCKET), PagedConfig(**geo),
                device="cpu")
    for srv, params_cls in ((js, JRequestParams), (ts, RequestParams)):
        srv.submit([3, 1, 4, 1, 5], params_cls(max_new_tokens=4))
        srv.drain()
    assert js.stats()["decode_compilations"] == 1
    assert ts.stats()["decode_compilations"] == 0


def test_launcher_prints_decode_compilations(capsys):
    from repro_torch.launch import serve as cli
    res = cli.main(["--arch", "llama3.2-1b", "--smoke", "--scheme", "lq4w",
                    "--continuous", "1", "--steps", "2", "--prompt-len", "4",
                    "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert res["stats"]["decode_compilations"] == 0
    at = next(i for i, line in enumerate(out)
              if line.startswith("kernel launches:"))
    assert out[at + 1] == ("decode compilations: 0 (on the CPU the step "
                           "runs eagerly: nothing is captured)")
