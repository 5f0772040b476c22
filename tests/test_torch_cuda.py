"""Card-only checks of the port: each CUDA kernel against its plain
PyTorch version, and the quantizers giving the same bytes on the card as
on the CPU.  Marked ``cuda``; each test decides inside itself whether a
card is present and skips without one.  The file imports no JAX, so it
runs on a machine with the card and without JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.)

Tolerances: quant_matmul is held to ``quant_matmul.error_bound`` (f32
summation order, bf16 output rounding), as chip_smoke.py holds it;
paged attention re-associates an online softmax over at most 64 keys of
unit-scale values, well inside 1e-5, and its serve-path, long-context and
odd-width cases are held to ``paged_attention.error_bound``.  act_quant
must give the plain version's bytes exactly; lut_matmul is held to
``lut_matmul.error_bound`` (f32 summation order).  TF32 is off.

The engine's captured decode step and prefill bucket must give the bytes
of the same bodies issued eagerly on the card, with exact launch counts.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import kvwire
from repro_torch.kernels import act_quant as aq
from repro_torch.kernels import lut_matmul as lm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import quant_matmul as qm

RNG = np.random.default_rng(3)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_quantizers_give_cpu_bytes_on_the_card(bits):
    dev = _card()
    w = torch.from_numpy(RNG.normal(size=(256, 96)).astype(np.float32))
    for a, b in zip(ref.quantize_weight(w, bits, 128),
                    ref.quantize_weight(w.to(dev), bits, 128)):
        assert torch.equal(a, b.cpu())
    if bits in kvwire.KV_BITS:
        cw = kvwire.quantize_kv(w, bits, 16)
        gw = kvwire.quantize_kv(w.to(dev), bits, 16)
        assert all(torch.equal(cw[k], gw[k].cpu()) for k in cw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_quant_matmul_kernel_matches_plain(bits, dtype):
    dev = _card()
    for m, k, n in ((1, 256, 70), (5, 512, 96), (37, 256, 33)):
        w = _t(RNG.normal(size=(k, n)).astype(np.float32) * k ** -0.5, dev)
        x = _t(RNG.normal(size=(m, k)).astype(np.float32), dev).to(dtype)
        qw = ops.quantize_weight(w, bits, 128)
        before = qm.quant_matmul.launches
        got = ops.quant_matmul(x, qw)
        assert qm.quant_matmul.launches == before + 1
        want = qm.plain(x, qw.packed, qw.scale, qw.zmin, bits=bits,
                        group_size=128)
        tol = qm.error_bound(x, ops.dequantize_weight(qw), want)
        assert got.dtype == dtype
        assert bool(((got.float() - want.float()).abs() <= tol).all())


# llama3.2-1b's projections (K, N): q k v o gate up down
LLAMA_1B = ((2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
            (2048, 8192), (2048, 8192), (8192, 2048))


def _qm_case(m, k, n, bits, dtype, dev):
    w = _t(RNG.normal(size=(k, n)).astype(np.float32) * k ** -0.5, dev)
    x = _t(RNG.normal(size=(m, k)).astype(np.float32), dev).to(dtype)
    return x, ops.quantize_weight(w, bits, 128)


def _assert_qm_within_bound(x, qw, got):
    want = qm.plain(x, qw.packed, qw.scale, qw.zmin, bits=qw.bits,
                    group_size=128)
    tol = qm.error_bound(x, ops.dequantize_weight(qw), want)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("bits", [4, 8])
def test_quant_matmul_decode_kernel_at_llama_shapes(bits, m, dtype):
    dev = _card()
    for k, n in LLAMA_1B:
        x, qw = _qm_case(m, k, n, bits, dtype, dev)
        _assert_qm_within_bound(x, qw, ops.quant_matmul(x, qw))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_quant_matmul_decode_kernel_at_ragged_n(bits):
    """N that is no multiple of a thread's 16 or 8 columns takes the byte
    path; 96 is a multiple of 16 short of one 256-column strip."""
    dev = _card()
    for m in (1, 7, 16):
        for k, n in ((256, 70), (512, 33), (2048, 2024), (384, 96)):
            x, qw = _qm_case(m, k, n, bits, torch.bfloat16, dev)
            _assert_qm_within_bound(x, qw, ops.quant_matmul(x, qw))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 7, 176])
def test_quant_matmul_is_deterministic_and_replays(m):
    """Two calls give the same bytes (the splits are summed in a fixed
    order), and a CUDA graph replay of the call gives the eager call's."""
    dev = _card()
    x, qw = _qm_case(m, 2048, 512, 4, torch.bfloat16, dev)
    got = ops.quant_matmul(x, qw)
    assert torch.equal(got, ops.quant_matmul(x, qw))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ops.quant_matmul(x, qw)
    replayed.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, replayed)


def _pages(bits, dev, *, lq, b=3, kvh=2, gq=4, d=64, ps=16, pps=4):
    """Scratch page 0 full of garbage; slot tables padded onto it."""
    n_pages = b * pps + 1
    kf = RNG.normal(size=(n_pages, ps, kvh, d)).astype(np.float32)
    vf = RNG.normal(size=kf.shape).astype(np.float32)
    kf[0], vf[0] = 1e4, -1e4
    q = _t(RNG.normal(size=(b, lq, kvh, gq, d)).astype(np.float32), dev)
    table = (1 + np.arange(b * pps)).reshape(b, pps).astype(np.int32)
    pos = np.array([2 * ps + 3, pps * ps - lq, 0], np.int32)
    table[0, 3] = table[2, 1:] = 0
    k, v = _t(kf, dev), _t(vf, dev)
    if bits is not None:
        k, v = kvwire.quantize_kv(k, bits, 16), kvwire.quantize_kv(v, bits, 16)
    return q, k, v, _t(table, dev), _t(pos, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("lq", [1, 3])
@pytest.mark.parametrize("bits", [None, 8, 4, 2, 1])
def test_paged_attention_kernel_matches_plain(bits, lq):
    dev = _card()
    q, k, v, table, pos = _pages(bits, dev, lq=lq)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, k, v, table, pos)
    assert pa.paged_attention.launches == before + 1
    want = pa.plain(q, k, v, table.long(), pos.long())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for dq in ("affine", "lut") if bits is not None and bits <= 4 else ():
        assert torch.equal(pa.paged_attention(q, k, v, table, pos,
                                              dequant=dq), got)


def _decode_case(dev, lq, pos, pps, bits=4, ps=16, kvh=8, gq=4, d=64):
    """The serve path's geometry (llama3.2-1b heads, page 16, 4-bit pages
    of group 16, bf16 q) with slots at ``pos`` over ``pps`` table entries;
    entries past a slot's live pages point at scratch page 0."""
    b = len(pos)
    n_pages = b * pps + 1
    kf = RNG.normal(size=(n_pages, ps, kvh, d)).astype(np.float32)
    vf = RNG.normal(size=kf.shape).astype(np.float32)
    kf[0], vf[0] = 1e4, -1e4
    q = _t(RNG.normal(size=(b, lq, kvh, gq, d)).astype(np.float32),
           dev).to(torch.bfloat16)
    table = np.zeros((b, pps), np.int32)
    for i, p in enumerate(pos):
        live = (p + lq - 1) // ps + 1
        table[i, :live] = 1 + i * pps + np.arange(live)
    k, v = _t(kf, dev), _t(vf, dev)
    if bits is not None:
        k, v = kvwire.quantize_kv(k, bits, 16), kvwire.quantize_kv(v, bits, 16)
    return q, k, v, _t(table, dev), _t(np.array(pos, np.int32), dev)


def _force_splits(monkeypatch, splits):
    """Force the kernels' split count (None: the plan's): launch_args
    looks ``plan`` up at each call."""
    if splits is not None:
        monkeypatch.setattr(pa, "plan", lambda *shape: splits)


def _within_bound(got, q, k, v, table, pos):
    want = pa.plain(q, k, v, table.long(), pos.long())
    tol = pa.error_bound(q, k, v, table, pos, want)
    assert not got.isnan().any()
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("lq", [1, 3])
@pytest.mark.parametrize("keys", [160, 4096])
def test_paged_attention_kernel_at_serve_and_long_context(keys, lq,
                                                         monkeypatch):
    """4 slots near 160 keys (the serve shape) and near 4096, under the
    plan's splits and under one split."""
    dev = _card()
    pos = [keys - lq, keys - 7 - lq, keys - 16, 37]
    case = _decode_case(dev, lq, pos, keys // 16)
    for splits in (None, 1):
        _force_splits(monkeypatch, splits)
        _within_bound(pa.paged_attention(*case), *case)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [None, 8, 4, 2, 1])
def test_paged_attention_every_split_count(bits, monkeypatch):
    """Every split count from 1 to P gives the plain version's result, with
    slots whose table entries past their live pages point at scratch
    (splits that hold only masked or scratch pages)."""
    dev = _card()
    for lq in (1, 3):
        q, k, v, table, pos = _pages(bits, dev, lq=lq)
        want = pa.plain(q, k, v, table.long(), pos.long())
        for splits in range(1, table.shape[1] + 1):
            _force_splits(monkeypatch, splits)
            got = pa.paged_attention(q, k, v, table, pos)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 2, 11])
def test_paged_attention_is_deterministic_and_replays(splits, monkeypatch):
    """Two calls give the same bytes (the splits are combined in a fixed
    order), a CUDA graph replay gives the eager call's, and each call adds
    one to the launch count."""
    dev = _card()
    case = _decode_case(dev, 1, [159, 37, 0, 150], 11)
    _force_splits(monkeypatch, splits)
    before = pa.paged_attention.launches
    got = pa.paged_attention(*case)
    assert torch.equal(got, pa.paged_attention(*case))
    assert pa.paged_attention.launches == before + 2
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = pa.paged_attention(*case)
    replayed.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, replayed)
    _within_bound(got, *case)


@pytest.mark.cuda
@pytest.mark.parametrize("d,gs,ps,gq,lq,bits", [
    (48, 24, 4, 2, 1, 8),       # regions that straddle a lane's elements
    (32, 8, 5, 3, 2, 4),        # several regions a lane, odd page size
    (16, 16, 1, 2, 3, 1),       # 1-bit rows of 2 bytes, page size 1
    (512, 128, 2, 1, 1, None),  # 16 elements a lane
    (64, 16, 16, 8, 4, 2),      # 32 query rows: 8 row warps
    (64, 16, 16, 4, 9, 4),      # 36 query rows: two row tiles
    (64, 16, 16, 8, 8, None),   # 64 query rows: two row tiles
    (512, 128, 2, 8, 4, 4),     # 32 rows at D 512: two tiles of 16
    (640, 128, 4, 2, 2, 8),     # 32 elements a lane, 2 rows a warp
    (1024, 64, 2, 1, 3, 2),     # 32 elements a lane, regions of 64
    (1100, 100, 3, 1, 1, 4),    # 96 elements a lane, 16 lanes a key
    (3072, 128, 1, 2, 1, None),  # 96 elements a lane, a row a warp
    (1024, 2, 2, 2, 2, 4),      # a region every 2 elements: global scales
    (3070, 1, 1, 1, 1, 8),      # the widest D the page-walk kernel took
])
def test_paged_attention_odd_shapes(d, gs, ps, gq, lq, bits):
    """Widths off the serve path, within error_bound, once with pages that
    start one element past an aligned address (narrower copies)."""
    dev = _card()
    n_pages, kvh, pps, b = 7, 2, 3, 2
    kf = RNG.normal(size=(n_pages, ps, kvh, d)).astype(np.float32)
    vf = RNG.normal(size=kf.shape).astype(np.float32)
    q = _t(RNG.normal(size=(b, lq, kvh, gq, d)).astype(np.float32), dev)
    table = _t(np.array([[1, 2, 0], [3, 4, 5]], np.int32), dev)
    pos = _t(np.array([ps + 1 - lq + 1, pps * ps - lq], np.int32), dev)

    def shifted(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        return flat[1:].view(x.shape).copy_(x)
    k, v = _t(kf, dev), _t(vf, dev)
    if bits is not None:
        k, v = kvwire.quantize_kv(k, bits, gs), kvwire.quantize_kv(v, bits, gs)
    for move in (False, True):
        if move:
            k, v = ((({n: shifted(t) for n, t in x.items()}
                      if isinstance(x, dict) else shifted(x)) for x in (k, v)))
        _within_bound(pa.paged_attention(q, k, v, table, pos), q, k, v,
                      table, pos)


@pytest.mark.cuda
def test_paged_attention_refuses_what_it_does_not_take():
    dev = _card()
    q, k, v, table, pos = _decode_case(dev, 1, [40, 20], 4)
    with pytest.raises(TypeError):
        pa.paged_attention(q.to(torch.float16), k, v, table, pos)
    d = pa.MAX_D + 8
    big = torch.zeros((3, 2, 8, d), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(torch.zeros((2, 1, 8, 1, d), device=dev), big,
                           big, table[:, :1], pos.clamp(max=1))
    with pytest.raises(ValueError, match="kv heads"):
        pa.paged_attention(q[:, :, :4], k, v, table, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_act_quant_kernel_gives_plain_bytes(bits, dtype):
    dev = _card()
    gs = 128
    for m, k in ((1, 256), (5, 512), (37, 256), (3, 384), (4, 2048),
                 (6, 1024)):
        x = RNG.normal(size=(m, k)).astype(np.float32)
        x[0, :gs] = 0.5                          # a region of range 0
        x = _t(x, dev).to(dtype)
        before = aq.act_quant.launches
        got = aq.act_quant(x, bits=bits, group_size=gs)
        assert aq.act_quant.launches == before + 1
        want = aq.plain(x, bits=bits, group_size=gs)
        cpu = aq.plain(x.cpu(), bits=bits, group_size=gs)
        for g, w, c in zip(got, want, cpu):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w) and torch.equal(g.cpu(), c)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_lut_matmul_kernel_matches_plain(bits):
    dev = _card()
    for m, k, n in ((1, 256, 70), (4, 512, 96), (37, 256, 33),
                    (20, 384, 64)):
        x = _t(RNG.normal(size=(m, k)).astype(np.float32), dev)
        w = _t(RNG.normal(size=(k, n)).astype(np.float32) * k ** -0.5, dev)
        a = aq.plain(x, bits=bits, group_size=128)
        before = lm.lut_matmul.launches
        got = lm.lut_matmul(*a, w, bits=bits, group_size=128)
        assert lm.lut_matmul.launches == before + 1
        want = lm.plain(*a, w, bits=bits, group_size=128)
        tol = lm.error_bound(*a, w, want, bits=bits, group_size=128)
        assert got.dtype == torch.float32 and got.shape == (m, n)
        assert bool(((got - want).abs() <= tol).all())


def _lut_case(m, k, n, bits, dev, *, offset=0):
    """Codes of a random x and an f32 w; ``offset`` > 0 starts w that many
    floats into its storage, so that it is not 16-byte aligned."""
    x = _t(RNG.normal(size=(m, k)).astype(np.float32), dev)
    flat = RNG.normal(size=k * n + offset).astype(np.float32) * k ** -0.5
    w = _t(flat, dev)[offset:].view(k, n)
    return aq.plain(x, bits=bits, group_size=128), w


def _assert_lut_within_bound(a, w, bits, got):
    want = lm.plain(*a, w, bits=bits, group_size=128)
    tol = lm.error_bound(*a, w, want, bits=bits, group_size=128)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 7, 16])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_lut_matmul_decode_kernel_at_llama_shapes(bits, m):
    """The split-K kernel at every llama3.2-1b projection, as plan()
    launches it."""
    dev = _card()
    for k, n in sorted(set(LLAMA_1B)):
        a, w = _lut_case(m, k, n, bits, dev)
        before = lm.lut_matmul.launches
        got = lm.lut_matmul(*a, w, bits=bits, group_size=128)
        assert lm.lut_matmul.launches == before + 1
        _assert_lut_within_bound(a, w, bits, got)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_lut_matmul_decode_kernel_at_ragged_n(bits):
    """N that is no multiple of 4, or a w that is not 16-byte aligned,
    takes 4-byte copies; N = 2024 leaves a partial strip."""
    dev = _card()
    for m in (1, 7, 16):
        for k, n, offset in ((256, 70, 0), (512, 33, 0), (2048, 2024, 0),
                             (384, 96, 1), (2048, 512, 3)):
            a, w = _lut_case(m, k, n, bits, dev, offset=offset)
            _assert_lut_within_bound(
                a, w, bits, lm.lut_matmul(*a, w, bits=bits, group_size=128))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 7, 16, 176])
def test_lut_matmul_is_deterministic_and_replays(m):
    """Two calls give the same bytes (the splits are summed in a fixed
    order), and a CUDA graph replay of the call gives the eager call's."""
    dev = _card()
    a, w = _lut_case(m, 2048, 512, 2, dev)
    got = lm.lut_matmul(*a, w, bits=2, group_size=128)
    assert torch.equal(got, lm.lut_matmul(*a, w, bits=2, group_size=128))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = lm.lut_matmul(*a, w, bits=2, group_size=128)
    replayed.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, replayed)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,a_bits,lut", [("lq8", 8, False),
                                               ("lq2_lut", 2, True)])
def test_quant_dense_branches_launch_their_kernels(scheme, a_bits, lut):
    dev = _card()
    w = _t(RNG.normal(size=(256, 48)).astype(np.float32) * 0.0625, dev)
    x = _t(RNG.normal(size=(2, 3, 256)).astype(np.float32), dev)
    qw = ops.quantize_weight(w, 8, 128)
    counts = (aq.act_quant, lm.lut_matmul, qm.quant_matmul)
    before = [f.launches for f in counts]
    got = ops.quant_dense(x, qw, a_bits=a_bits, lut=lut)
    added = [f.launches - b for f, b in zip(counts, before)]
    assert added == ([1, 1, 0] if lut else [1, 0, 1])
    want = ops.quant_dense(x.cpu(), qw.to("cpu"), a_bits=a_bits, lut=lut)
    assert got.shape == (2, 3, 48)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_do_not_take():
    dev = _card()
    x = torch.randn(4, 256, device=dev)
    with pytest.raises(TypeError):
        aq.act_quant(x.to(torch.float16), bits=4, group_size=128)
    with pytest.raises(ValueError):
        aq.act_quant(x, bits=4, group_size=16)
    with pytest.raises(ValueError):
        aq.act_quant(x, bits=9, group_size=128)
    a = aq.act_quant(x, bits=2, group_size=128)
    w = torch.randn(256, 32, device=dev)
    with pytest.raises(TypeError):
        lm.lut_matmul(*a, w.to(torch.bfloat16), bits=2, group_size=128)
    with pytest.raises(ValueError):
        lm.lut_matmul(a[0], a[1][:, :1], a[2], w, bits=2, group_size=128)
    with pytest.raises(ValueError):
        lm.lut_matmul(a[0], a[1], a[2].cpu(), w, bits=2, group_size=128)
    with pytest.raises(ValueError):
        lm.lut_matmul(*a, w, bits=8, group_size=128)


# ---------------------------------------------------------------------------
# the engine's captured steps
# ---------------------------------------------------------------------------

def _engine_case(scheme, fused, *, n_pages=7):
    """A small bf16 decoder (every K a multiple of 128, so act_quant and the
    packed projections run at every layer) on the card, 4-bit pages of
    group 16, 2 slots of page 4 over a 32-token bucket; 6 allocatable
    pages cannot hold two 19-token requests, so the later one is
    preempted and re-prefilled."""
    from repro_torch.models import transformer
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve.engine import EngineConfig, PagedConfig
    dev = _card()
    cfg = ModelConfig(name="t128", family="dense", n_layers=2, d_model=128,
                      vocab_size=256, n_heads=4, n_kv_heads=2, head_dim=32,
                      d_ff=256, dtype="bfloat16")
    params = transformer.init_params(cfg, 0, dev)
    ecfg = EngineConfig(max_len=32, kv_bits=4, kv_group=16,
                        weight_scheme=scheme, fused_attention=fused)
    pcfg = PagedConfig(max_slots=2, page_size=4, n_pages=n_pages,
                       max_context=32)
    return cfg, params, ecfg, pcfg, dev


def _recording_engine(cfg, params, ecfg, pcfg, dev, *, eager=False):
    """A PagedEngine that keeps a copy of every step's logits and greedy
    tokens; ``eager`` runs each step's body operation by operation instead
    of replaying its graph."""
    from repro_torch.serve.engine import PagedEngine

    class Recording(PagedEngine):
        def _run(self, kind, pool):
            if eager:
                self._run_eager(kind, pool)
            else:
                super()._run(kind, pool)
            self.log.append((kind, self._io.logits[kind].clone(),
                             self._io.greedy[kind].clone()))

    eng = Recording(cfg, params, ecfg, pcfg, device=dev)
    eng.log = []
    return eng


_PROMPTS = [[5, 77, 3, 9, 250], [1, 2, 3, 4, 5, 6], [9] * 7]


def _serve(engine, prompts=_PROMPTS, max_new=(14, 14, 9), srv=None):
    """Staggered arrivals through a Server over ``engine`` (or ``srv``) ->
    (outputs, the server)."""
    from repro_torch.serve.server import RequestParams, Server
    srv = srv or Server(engine.cfg, None, engine.ecfg, engine.pcfg,
                        engine=engine)
    rids = []
    for p, n in zip(prompts, max_new):
        rids.append(srv.submit(p, RequestParams(max_new_tokens=n)))
        srv.step()
        srv.step()
    outs = srv.drain(max_steps=500)
    return [outs[r] for r in rids], srv


def _launches():
    from repro_torch import kernels
    return {n: fn.launches for n, fn in kernels.wrappers().items()}


def _want_launches(scheme, n_layers, st):
    """Launches of each kernel on a scheme's path: 7 projections a layer in
    every prefill and decode step, one paged attention a layer and decode
    step on the fused path."""
    proj = 7 * n_layers * (st["prefills"] + st["steps"])
    lut = scheme.endswith("_lut")
    act = lut or not scheme.endswith("w")
    return {"quant_matmul": 0 if lut else proj,
            "paged_attention": n_layers * st["steps"]
            if st["attention_mode"] == "fused-cuda" else 0,
            "act_quant": proj if act else 0,
            "lut_matmul": proj if lut else 0}


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,fused", [("lq4w", True), ("lq4w", False),
                                          ("lq8", True), ("lq2_lut", True)])
def test_graphed_steps_give_the_eager_bytes(scheme, fused):
    """The same staggered run with a preemption, through the captured steps
    and through the same bodies issued eagerly: identical tokens and
    identical logit bytes at every prefill and decode step, and exact
    launch counts in both (a replay adds what its capture launched)."""
    case = _engine_case(scheme, fused)
    runs = []
    for eager in (False, True):
        eng = _recording_engine(*case, eager=eager)
        before = _launches()
        outs, srv = _serve(eng)
        st = srv.stats()
        added = {n: c - before[n] for n, c in _launches().items()}
        assert added == _want_launches(scheme, case[0].n_layers, st)
        assert st["preemptions"] > 0
        assert st["decode_compilations"] == (0 if eager else 1)
        runs.append((outs, eng.log))
    (g_out, g_log), (e_out, e_log) = runs
    assert g_out == e_out
    assert [k for k, *_ in g_log] == [k for k, *_ in e_log]
    for (kind, gl, gt), (_, el, et) in zip(g_log, e_log):
        assert torch.equal(gl, el), kind
        assert torch.equal(gt, et), kind


@pytest.mark.cuda
def test_two_servers_on_one_engine_keep_their_own_graphs():
    """Each Server's pool gets its own captures (a graph holds its pool's
    page addresses) and both serve the eager tokens.  Every graph of the
    engine draws from one pool of the allocator, so capturing for the
    second Server reserves no new device memory beyond a segment's
    rounding."""
    from repro_torch.serve.server import Server
    case = _engine_case("lq4w", True, n_pages=24)
    want, _ = _serve(_recording_engine(*case, eager=True))
    eng = _recording_engine(*case)
    first, srv1 = _serve(eng)
    srv2 = Server(eng.cfg, None, eng.ecfg, eng.pcfg, engine=eng)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    second, _ = _serve(eng, srv=srv2)
    assert first == second == want
    for srv in (srv1, srv2):
        assert srv.stats()["decode_compilations"] == 1
        assert eng.compilations(srv.pool, "prefill") == 1
        assert srv.stats()["preemptions"] == 0
    assert eng.decode_compilations == 1
    graphs = [g for srv in (srv1, srv2)
              for g in eng._graphs[srv.pool].values()]
    assert len(graphs) == 4
    assert len({g.graph.pool() for g in graphs}) == 1
    assert torch.cuda.memory_reserved() <= reserved + (2 << 20)


@pytest.mark.cuda
def test_launch_counts_are_exact_after_many_replays():
    """N decode steps on one pool: one capture, N - 1 replays, and each
    wrapper's count equals N times a step's launches."""
    from repro_torch.serve.server import RequestParams, Server
    cfg, params, ecfg, pcfg, dev = _engine_case("lq8", True, n_pages=24)
    eng = _recording_engine(cfg, params, ecfg, pcfg, dev)
    srv = Server(cfg, None, ecfg, pcfg, engine=eng)
    srv.submit(_PROMPTS[0], RequestParams(max_new_tokens=2))
    srv.drain()
    before = _launches()
    n = 12
    srv.submit(_PROMPTS[1], RequestParams(max_new_tokens=n + 1))
    srv.drain()
    added = {k: c - before[k] for k, c in _launches().items()}
    proj = 7 * cfg.n_layers * (1 + n)
    assert added == {"quant_matmul": proj, "paged_attention":
                     cfg.n_layers * n, "act_quant": proj, "lut_matmul": 0}
    assert srv.stats()["decode_compilations"] == 1


@pytest.mark.cuda
def test_decode_compilations_count_every_capture():
    """The count is of captures, not of graphs held: a pool whose decode
    graph is dropped captures again on its next step and reads 2, and
    the tokens stay the eager ones."""
    from repro_torch.serve.server import RequestParams, Server
    case = _engine_case("lq4w", True, n_pages=24)
    outs = []
    for eager in (True, False):
        eng = _recording_engine(*case, eager=eager)
        srv = Server(eng.cfg, None, eng.ecfg, eng.pcfg, engine=eng)
        rid = srv.submit(_PROMPTS[0], RequestParams(max_new_tokens=14))
        for _ in range(4):
            srv.step()
        if not eager:
            assert srv.stats()["decode_compilations"] == 1
            del eng._graphs[srv.pool]["decode"]
        srv.drain()
        outs.append(srv.output(rid))
    assert outs[0] == outs[1]
    assert srv.stats()["decode_compilations"] == 2
    assert eng.decode_compilations == 2
    assert eng.compilations(srv.pool, "prefill") == 1


@pytest.mark.cuda
def test_a_capture_that_syncs_with_the_host_raises(monkeypatch):
    """A step that reads a value back to the host cannot be captured: the
    engine raises, keeps no graph and does not go on eagerly."""
    from repro_torch.serve import engine as engine_mod
    cfg, params, ecfg, pcfg, dev = _engine_case("lq4w", True, n_pages=24)
    eng = _recording_engine(cfg, params, ecfg, pcfg, dev)
    pool = eng.new_pool()
    assert pool.alloc(0, 2)
    eng.prefill_request(pool, _PROMPTS[0], pool.pages_of(0))
    step = engine_mod.transformer.paged_decode_step

    def syncing_step(*a, **kw):
        logits, pages = step(*a, **kw)
        float(logits.sum())                     # a host read
        return logits, pages

    monkeypatch.setattr(engine_mod.transformer, "paged_decode_step",
                        syncing_step)
    table = np.zeros((2, pcfg.pages_per_slot), np.int32)
    table[0, :2] = pool.pages_of(0)
    args = (pool, np.array([7, 0]), table, np.array([5, 0]))
    for _ in range(2):
        with pytest.raises(RuntimeError):
            eng.decode_step_batch(*args)
        assert eng.decode_compilations == 0
