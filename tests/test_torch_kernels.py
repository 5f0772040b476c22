"""The port's kernel wrappers against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held to
the JAX kernels run as the JAX tests run them here (Pallas interpret
mode).  The CUDA kernels themselves are held to the plain versions in
``test_torch_cuda.py`` (marker ``cuda``), which needs a card.

Tolerances: both sides compute in f32.  quant_matmul sums K=256 products
in another order (XLA vs PyTorch), ~sqrt(K)*2^-24 relative, so 1e-5 of
the output scale; paged attention re-associates an online softmax over
at most 64 keys, well inside 2e-5 (the JAX package's own bound for its
kernel against its XLA path).  The blocked ``masked_attention`` against
one unblocked softmax: the same re-association, 2e-6 at unit-scale
values.  The act_quant and lut_matmul wrappers
are held to the JAX kernels in ``test_torch_act_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvwire as jkv
from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro_torch.core import kvwire as tkv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import splitk

RNG = np.random.default_rng(1)


def _qm_inputs(m, k, n, bits, gs=128):
    w = RNG.normal(size=(k, n)).astype(np.float32) * k ** -0.5
    x = RNG.normal(size=(m, k)).astype(np.float32)
    jq = jops.quantize_weight(jnp.asarray(w), bits, gs)
    tq = tops.quantize_weight(torch.from_numpy(w), bits, gs)
    return x, jq, tq


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("m,n", [(5, 40), (1, 130)])
def test_quant_matmul_plain_matches_pallas_interpret(bits, m, n):
    x, jq, tq = _qm_inputs(m, 256, n, bits)
    want = np.asarray(jops.quant_matmul(jnp.asarray(x), jq,
                                        backend="interpret"))
    before = tqm.quant_matmul.launches
    got = tops.quant_matmul(torch.from_numpy(x), tq).numpy()
    assert tqm.quant_matmul.launches == before   # CPU: no kernel launch
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_quant_matmul_leading_dims_and_group_sizes():
    x, jq, tq = _qm_inputs(6, 256, 24, 4, gs=64)
    x3 = x.reshape(2, 3, 256)
    got = tops.quant_matmul(torch.from_numpy(x3), tq).numpy()
    want = np.asarray(jops.quant_matmul(jnp.asarray(x3), jq,
                                        backend="interpret"))
    assert got.shape == (2, 3, 24)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_quant_matmul_rejects_ragged_k():
    w = torch.randn(256, 16)
    packed, scale, zmin = tops._ref.quantize_weight(w, 4, 128)
    x = torch.randn(2, 200)
    with pytest.raises(ValueError, match="group_size"):
        tqm.quant_matmul(x, packed[:100], scale, zmin, bits=4,
                         group_size=128)


def test_quant_dense_activation_paths_name_roadmap():
    """The activation paths ROADMAP.md listed as not ported (``a_bits``,
    ``lut``) now run; what stays refused is what the JAX package refuses:
    a LUT forward without activation bits, or with more than 4."""
    _, _, tq = _qm_inputs(2, 128, 8, 8)
    x = torch.randn(2, 128)
    for kw in (dict(a_bits=4), dict(a_bits=2, lut=True)):
        out = tops.quant_dense(x, tq, **kw)
        assert out.shape == (2, 8) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="a_bits"):
        tops.quant_dense(x, tq, lut=True)
    with pytest.raises(ValueError, match="bits <= 4"):
        tops.quant_dense(x, tq, a_bits=8, lut=True)


def _pa_case(bits, *, lq, b=2, kvh=2, gq=2, d=32, gs=16, ps=4, pps=4):
    """One paged decode case, as the JAX kernel tests build it: scratch
    page 0 holds large garbage, slot 0 sits mid-page with table entries
    past its live pages padded onto scratch, slot 1 at a page boundary."""
    n_pages = b * pps + 1
    kf = RNG.normal(size=(n_pages, ps, kvh, d)).astype(np.float32)
    vf = RNG.normal(size=kf.shape).astype(np.float32)
    kf[0], vf[0] = 1e4, -1e4
    q = RNG.normal(size=(b, lq, kvh, gq, d)).astype(np.float32)
    table = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    full = pps * ps
    pos = np.array([full - 2 * ps - 2, full - lq], np.int32)
    table[0, -1] = 0                               # padded table entry
    jq = jnp.asarray(q)
    if bits is None:
        jk, jv = jnp.asarray(kf), jnp.asarray(vf)
    else:
        jk, jv = jkv.quantize_kv(jnp.asarray(kf), bits, gs), \
            jkv.quantize_kv(jnp.asarray(vf), bits, gs)

    def t(leaf):
        if isinstance(leaf, dict):
            return {k: torch.from_numpy(np.asarray(v).copy())
                    for k, v in leaf.items()}
        return torch.from_numpy(np.asarray(leaf).copy())

    jargs = (jq, jk, jv, jnp.asarray(table), jnp.asarray(pos))
    targs = (torch.from_numpy(q), t(jk), t(jv),
             torch.from_numpy(table).long(), torch.from_numpy(pos).long())
    return jargs, targs


@pytest.mark.parametrize("lq", [1, 3])
@pytest.mark.parametrize("bits", [None, 8, 4, 2])
def test_paged_attention_plain_matches_pallas_interpret(bits, lq):
    jargs, targs = _pa_case(bits, lq=lq)
    want = np.asarray(jpa.paged_attention(*jargs, interpret=True))
    before = tpa.paged_attention.launches
    got = tpa.paged_attention(*targs).numpy()
    assert tpa.paged_attention.launches == before
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_paged_attention_plain_matches_gather_dequant_path():
    """The plain version equals the port's unfused decode path."""
    from repro_torch.models import attention
    _, (q, k, v, table, pos) = _pa_case(4, lq=3)
    kk = tkv.dequantize_kv(tkv.gather_pages(k, table), 32)
    vv = tkv.dequantize_kv(tkv.gather_pages(v, table), 32)
    np.testing.assert_allclose(
        tpa.plain(q, k, v, table, pos).numpy(),
        attention.decode_attention(q, kk, vv, pos).numpy(),
        rtol=2e-5, atol=2e-5)


def test_dequant_selector_validation_matches_jax():
    for bits in (None, 8, 4, 2, 1):
        for mode in ("auto", "affine", "lut"):
            try:
                want = jpa.dequant_path(bits, mode)
            except ValueError:
                with pytest.raises(ValueError):
                    tpa.dequant_path(bits, mode)
            else:
                assert tpa.dequant_path(bits, mode) == want
    _, targs = _pa_case(8, lq=1)
    with pytest.raises(ValueError, match="dequant"):
        tpa.paged_attention(*targs, dequant="nearest")
    with pytest.raises(ValueError, match="bits <= 4"):
        tpa.paged_attention(*targs, dequant="lut")
    _, targs = _pa_case(4, lq=1)
    a = tpa.paged_attention(*targs, dequant="affine")
    assert torch.equal(a, tpa.paged_attention(*targs, dequant="lut"))


def _unblocked_attention(q, k, v, pos):
    """One softmax over every key, as ``masked_attention`` was before it was
    blocked (the oracle of its blocking)."""
    b, lq, _, _, d = q.shape
    qpos = torch.as_tensor(pos).expand(b)[:, None] + torch.arange(lq)
    valid = torch.arange(k.shape[1]) <= qpos[..., None]
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k) * d ** -0.5
    p = torch.softmax(torch.where(valid[:, None, None], s, -1e30), dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v)


@pytest.mark.parametrize("lq,s,pos,block", [
    (300, 300, 0, 256),                 # causal prefill over two blocks
    (5, 77, [3, 60, 72], 16),           # ragged S, pos offsets, Lq > 1
    (37, 200, [0, 100, 163], 32),       # query blocks and key blocks
    (1, 176, [175, 10, 0], 64)])        # decode: one query per slot
def test_masked_attention_blocked_matches_unblocked(lq, s, pos, block):
    from repro.models import attention as jattn
    from repro_torch.kernels import ref
    q = RNG.normal(size=(3, lq, 2, 4, 16)).astype(np.float32)
    k = RNG.normal(size=(3, s, 2, 16)).astype(np.float32)
    v = RNG.normal(size=(3, s, 2, 16)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tpos = torch.as_tensor(pos)
    got = ref.masked_attention(tq, tk, tv, tpos, block=block)
    np.testing.assert_allclose(got.numpy(),
                               _unblocked_attention(tq, tk, tv, tpos).numpy(),
                               rtol=0, atol=2e-6)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


# llama3.2-1b's projections (K, N): q k v o gate up down
LLAMA_1B = ((2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
            (2048, 8192), (2048, 8192), (8192, 2048))


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 4, 7, 16])
def test_quant_matmul_plan_fills_the_card_at_decode(m, bits):
    """Every llama3.2-1b projection launches at least one block per SM at
    decode, and a block's slice of x fits its shared-memory budget."""
    for k, n in LLAMA_1B:
        bm, splits = tqm.plan(m, k, n, bits)
        assert bm >= m and bm in tqm.BLOCK_COLS
        strips = -(-n // tqm.BLOCK_COLS[bm])        # the grid's columns
        assert strips * splits >= splitk.SMS
        rows = k // (8 // bits if bits in (1, 2, 4) else 1)
        widest = max(hi - lo for lo, hi in splitk.split_rows(rows, splits))
        assert widest * (k // rows) * bm * 4 <= tqm.X_SMEM_BYTES


@pytest.mark.parametrize("rows,splits", [(1024, 132), (4096, 33), (1024, 9),
                                         (7, 7), (64, 1), (1000, 3)])
def test_quant_matmul_splits_cover_k_once(rows, splits):
    ranges = splitk.split_rows(rows, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == rows
    assert all(lo < hi for lo, hi in ranges)                  # none empty
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_quant_matmul_plan_keeps_prefill_on_the_old_kernel():
    """Up to 16 rows split K; the prefill bucket (M > 16) takes no plan:
    the wrapper launches the one-pass kernel."""
    assert tqm.DECODE_M == 16
    for k, n in LLAMA_1B:
        for m in (17, 176):
            with pytest.raises(ValueError, match="one-pass"):
                tqm.plan(m, k, n, 4)
        assert tqm.plan(16, k, n, 4)[1] > 1
