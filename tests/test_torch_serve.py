"""The port's continuous-batching server against the JAX Server on the
same weights (greedy tokens must be EQUAL), the page allocator, device
selection, and the port's independence from JAX.

The config keeps every K a multiple of 128 so lq4w packs every
projection; f32.  The JAX side runs its fused kernel in Pallas interpret
mode, as its own tests do on the CPU; the port's runs its plain version.
"""
import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as jt
from repro.models.config import ModelConfig as JConfig
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import PagedConfig as JPagedConfig
from repro.serve import PagedKVPool as JPool
from repro.serve import RequestParams as JRequestParams
from repro.serve import Server as JServer
from repro_torch.models import transformer as tt
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.serve.engine import EngineConfig, PagedConfig, PagedEngine
from repro_torch.serve.pool import PagedKVPool
from repro_torch.serve.server import RequestParams, Server

KW = dict(name="t128", family="dense", n_layers=2, d_model=128,
          vocab_size=256, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
          dtype="float32")
JCFG, TCFG = JConfig(**KW, remat="none"), TConfig(**KW)
PROMPTS = [list(map(int, np.random.default_rng(1).integers(0, 256, n)))
           for n in (7, 12, 5)]
MAX_NEW = [8, 6, 7]


@pytest.fixture(scope="module")
def weights():
    jp = jt.init_params(JCFG, jax.random.key(0))
    return jp, tt.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _drive(srv, params_cls, prompts=PROMPTS, max_new=MAX_NEW):
    rids = []
    for i, (p, n) in enumerate(zip(prompts, max_new)):
        rids.append(srv.submit(p, params_cls(max_new_tokens=n)))
        if i == 0:
            srv.step()
            srv.step()
    outs = srv.drain(max_steps=500)
    return [outs[r] for r in rids]


def _both(weights, *, kv_bits, fused, n_pages=24, scheme="lq4w"):
    jp, tp = weights
    kv = dict(kv_bits=kv_bits, kv_group=16) if kv_bits else {}
    geo = dict(max_slots=2, page_size=4, n_pages=n_pages, max_context=32)
    js = JServer(JCFG, jp, JEngineConfig(max_len=32, weight_scheme=scheme,
                                         backend="ref",
                                         fused_attention=fused, **kv),
                 JPagedConfig(**geo))
    ts = Server(TCFG, tp, EngineConfig(max_len=32, weight_scheme=scheme,
                                       fused_attention=fused, **kv),
                PagedConfig(**geo), device="cpu")
    return (_drive(js, JRequestParams), js.stats(),
            _drive(ts, RequestParams), ts.stats())


@pytest.mark.parametrize("kv_bits,fused", [(None, False), (8, True),
                                           (4, False), (4, True),
                                           (2, True)])
def test_continuous_tokens_equal_jax_server(weights, kv_bits, fused):
    jout, _, tout, st = _both(weights, kv_bits=kv_bits, fused=fused)
    assert tout == jout
    assert [len(o) for o in tout] == MAX_NEW
    assert st["attention_mode"] == ("fused-plain" if fused else "xla")


@pytest.mark.parametrize("fused", [False, True])
def test_preemption_tokens_equal_jax_server(weights, fused):
    """A pool of 6 allocatable pages cannot hold two 19-token requests
    (5 pages each): the later one is preempted, re-prefilled and resumed,
    in both packages alike."""
    prompts = [PROMPTS[2], PROMPTS[1][:5]]
    jp, tp = weights
    kv = dict(kv_bits=8, kv_group=16)
    geo = dict(max_slots=2, page_size=4, n_pages=7, max_context=32)
    js = JServer(JCFG, jp, JEngineConfig(max_len=32, weight_scheme="lq4w",
                                         backend="ref",
                                         fused_attention=fused, **kv),
                 JPagedConfig(**geo))
    ts = Server(TCFG, tp, EngineConfig(max_len=32, weight_scheme="lq4w",
                                       fused_attention=fused, **kv),
                PagedConfig(**geo), device="cpu")
    jout = _drive(js, JRequestParams, prompts, [14, 14])
    tout = _drive(ts, RequestParams, prompts, [14, 14])
    assert ts.stats()["preemptions"] == js.stats()["preemptions"] > 0
    assert tout == jout


def _completion_order(srv, params_cls):
    done = []
    srv.scheduler.on_complete = lambda c: done.append(c.rid)
    first = srv.submit(PROMPTS[0], params_cls(max_new_tokens=4))
    srv.step()                                 # takes the only slot
    low = srv.submit(PROMPTS[1], params_cls(max_new_tokens=4, priority=0))
    high = srv.submit(PROMPTS[2], params_cls(max_new_tokens=4, priority=5))
    outs = srv.drain(max_steps=100)
    return done, [first, high, low], [outs[r] for r in (first, low, high)]


def test_priority_lane_admitted_first_like_jax(weights):
    """One slot: the running request finishes (admission does not
    preempt), then the high lane wins the slot over the earlier low one."""
    jp, tp = weights
    geo = dict(max_slots=1, page_size=4, n_pages=20, max_context=32)
    js = JServer(JCFG, jp, JEngineConfig(max_len=32, backend="ref"),
                 JPagedConfig(**geo))
    ts = Server(TCFG, tp, EngineConfig(max_len=32), PagedConfig(**geo),
                device="cpu")
    jdone, jwant, jout = _completion_order(js, JRequestParams)
    tdone, twant, tout = _completion_order(ts, RequestParams)
    assert tdone == twant and jdone == jwant
    assert tout == jout


def test_high_priority_is_never_the_victim_like_jax(weights):
    jp, tp = weights
    geo = dict(max_slots=2, page_size=4, n_pages=7, max_context=32)
    kv = dict(kv_bits=4, kv_group=16)
    servers = (
        JServer(JCFG, jp, JEngineConfig(max_len=32, weight_scheme="lq4w",
                                        backend="ref", **kv),
                JPagedConfig(**geo)),
        Server(TCFG, tp, EngineConfig(max_len=32, weight_scheme="lq4w",
                                      **kv),
               PagedConfig(**geo), device="cpu"))
    outs = []
    for srv, params_cls in zip(servers, (JRequestParams, RequestParams)):
        low = srv.submit(PROMPTS[2], params_cls(max_new_tokens=14))
        srv.step()
        high = srv.submit(PROMPTS[1][:5], params_cls(max_new_tokens=14,
                                                     priority=5))
        res = srv.drain(max_steps=500)
        assert srv.scheduler.request(low).n_preemptions >= 1
        assert srv.scheduler.request(high).n_preemptions == 0
        outs.append((res[low], res[high]))
    assert outs[1] == outs[0]


def test_submit_rejects_what_could_never_run(weights):
    _, tp = weights
    srv = Server(TCFG, tp, EngineConfig(max_len=32),
                 PagedConfig(max_slots=2, page_size=4, n_pages=3,
                             max_context=32), device="cpu")
    for prompt, n in (([], 4), ([1, 2], 0), ([1] * 30, 8), ([1] * 7, 8)):
        with pytest.raises(ValueError):
            srv.submit(prompt, RequestParams(max_new_tokens=n))


def test_pool_allocator_matches_jax():
    """The same alloc/free/truncate/defrag sequence gives the same page
    tables and free counts; defrag moves data with its pages and truncate
    zeroes exactly the rows past the kept prefix."""
    geo = dict(n_pages=12, page_size=4, kv_bits=4, kv_group=16)
    tpool, jpool = PagedKVPool(TCFG, **geo), JPool(JCFG, **geo)
    for pool in (tpool, jpool):
        assert pool.alloc(0, 3) and pool.alloc(1, 2) and pool.alloc(2, 4)
        assert not pool.alloc(3, 3)                   # all-or-nothing
        assert pool.free(1) == 2
        assert pool.alloc(3, 1)
    assert tpool.page_tables == jpool.page_tables
    k = tpool.pages[1]["k"]["packed"]
    for rid, tbl in tpool.page_tables.items():
        for j, p in enumerate(tbl):
            k[p] = 10 * rid + j + 1                    # tag every page
    mapping = tpool.defrag()
    assert mapping == jpool.defrag()
    assert tpool.page_tables == jpool.page_tables
    for rid, tbl in tpool.page_tables.items():
        for j, p in enumerate(tbl):
            assert int(k[p].flatten()[0]) == 10 * rid + j + 1
    assert tpool.n_free == jpool.n_free
    assert set(range(1, 12)) == set(tpool._free) | {
        p for t in tpool.page_tables.values() for p in t}
    rid = 2
    tbl = tpool.pages_of(rid)
    released = tpool.truncate(rid, 6)                  # keep 1.5 pages
    assert released == jpool.truncate(rid, 6) == 2
    assert tpool.page_tables == jpool.page_tables
    assert int(k[tbl[1], 2:].abs().sum()) == 0         # rows past 6 zeroed
    assert int(k[tbl[1], :2].flatten()[0]) == 10 * rid + 2
    np.testing.assert_array_equal(tpool.table_array(rid, 5),
                                  jpool.table_array(rid, 5))
    assert tpool.occupancy() == jpool.occupancy()


def test_entry_points_need_a_card_unless_cpu_is_asked(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = weights
    ecfg, pcfg = EngineConfig(max_len=32), PagedConfig(max_context=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedEngine(TCFG, tp, ecfg, pcfg)
    with pytest.raises(RuntimeError, match="--device cpu"):
        Server(TCFG, tp, ecfg, pcfg)
    from repro_torch.launch import serve as cli
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--arch", "llama3.2-1b", "--smoke", "--continuous", "1"])
    eng = PagedEngine(TCFG, tp, ecfg, pcfg, device="cpu")
    assert eng.device.type == "cpu" and eng.attention_mode == "xla"


def test_cli_serves_on_cpu_and_names_roadmap_for_other_flags(capsys):
    from repro_torch.launch import serve as cli
    res = cli.main(["--arch", "llama3.2-1b", "--smoke", "--scheme", "lq4w",
                    "--kv-bits", "4", "--continuous", "2", "--steps", "3",
                    "--prompt-len", "6", "--fused-attention",
                    "--device", "cpu"])
    assert res["tokens"] == 2 * 4
    assert res["stats"]["attention_mode"] == "fused-plain"
    assert "continuous: 2 requests" in capsys.readouterr().out
    for flag in (["--plan", "p.json"], ["--fleet=f.json"], ["--numerics"]):
        with pytest.raises(SystemExit):
            cli.main(["--arch", "llama3.2-1b", "--continuous", "1", *flag])
        assert "ROADMAP.md" in capsys.readouterr().err


def test_port_imports_without_jax():
    """Every repro_torch module imports with jax made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'repro' or k.startswith(('repro.', 'jax.'))\n"
        "               for k in sys.modules), 'JAX package imported'\n"
        "print(len(names))\n")
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p.endswith("src")] +
        [env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
