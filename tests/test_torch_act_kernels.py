"""The port's act_quant and lut_matmul wrappers, and every branch of
quant_dense, against the JAX package's kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode, as the JAX tests do here.  The CUDA
kernels are held to the plain versions in ``test_torch_cuda.py`` (marker
``cuda``), which needs a card.

Tolerances.  act_quant's bytes, scale and zmin equal the JAX oracle's
(``ref.act_quant``, true division) exactly.  Against the interpret-mode
kernel, zmin is equal and scale within one ulp, because XLA turns that
kernel's division by the constant 2^b - 1 into a multiply by its
reciprocal; its codes are equal wherever its scale is the true quotient,
and elsewhere differ only at exact rounding ties.  lut_matmul is held to
``lut_matmul.error_bound``: the JAX kernel and the plain version run the
same one-hot dataflow in f32 and differ only in the order of their sums.
quant_dense: 1e-5 of the output scale, as quant_matmul in
``test_torch_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schemes as jschemes
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import packing
from repro_torch.kernels import act_quant as taq
from repro_torch.kernels import lut_matmul as tlm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import splitk

RNG = np.random.default_rng(2)


def _qm_inputs(m, k, n, bits, gs=128):
    w = RNG.normal(size=(k, n)).astype(np.float32) * k ** -0.5
    x = RNG.normal(size=(m, k)).astype(np.float32)
    jq = jops.quantize_weight(jnp.asarray(w), bits, gs)
    tq = tops.quantize_weight(torch.from_numpy(w), bits, gs)
    return x, jq, tq


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_act_quant_plain_matches_pallas_interpret(bits, dtype):
    """M = 13 rows (not a multiple of 8), two regions per row; one region
    is constant (range 0, scale 1)."""
    x = RNG.normal(size=(13, 256)).astype(np.float32)
    x[4, 128:] = 0.75
    jx = jnp.asarray(x).astype(dtype)
    jp, js, jz = jops.act_quant(jx, bits=bits, group_size=128,
                                backend="interpret")
    rp, rs, rz = jref.act_quant(jx, bits=bits, group_size=128)
    xt = _t(jx.astype(jnp.float32))
    before = taq.act_quant.launches
    tp, ts, tz = tops.act_quant(xt.to(getattr(torch, dtype)), bits=bits,
                                group_size=128)
    assert taq.act_quant.launches == before          # CPU: no kernel
    for a, b in ((tp, rp), (ts, rs), (tz, rz), (tz, jz)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.0 ** -23)
    assert float(ts[4, 1]) == 1.0
    # Bytes equal the interpret-mode kernel's in every region where its
    # scale is the true quotient.  Where it is an ulp off, a code may
    # differ by one, and only at an exact rounding tie (bf16 inputs make
    # such ties common).
    tc = packing.unpack(tp, bits).numpy().astype(int).reshape(13, 2, 128)
    jc = packing.unpack(_t(jp), bits).numpy().astype(int).reshape(13, 2, 128)
    off = np.asarray(js) != ts.numpy()
    np.testing.assert_array_equal(tc[~off], jc[~off])
    q = ((xt.reshape(13, 2, 128) - tz[..., None]) / ts[..., None]).numpy()
    diff = tc != jc
    assert np.abs(tc - jc).max() <= 1
    assert np.allclose(np.abs(q[diff] % 1 - 0.5), 0, atol=1e-5)


def test_act_quant_leading_dims_and_group_sizes():
    x = RNG.normal(size=(2, 3, 128)).astype(np.float32)
    jp, js, jz = jops.act_quant(jnp.asarray(x), bits=4, group_size=32,
                                backend="ref")
    tp, ts, tz = tops.act_quant(_t(x), bits=4, group_size=32)
    assert tp.shape == (2, 3, 64) and ts.shape == (2, 3, 4)
    for a, b in ((tp, jp), (ts, js), (tz, jz)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _lut_inputs(m, k, n, bits, gs=128):
    x = RNG.normal(size=(m, k)).astype(np.float32)
    w = RNG.normal(size=(k, n)).astype(np.float32) * k ** -0.5
    ap, asc, azm = jops.act_quant(jnp.asarray(x), bits=bits, group_size=gs,
                                  backend="ref")
    return (ap, asc, azm, jnp.asarray(w)), (_t(ap), _t(asc), _t(azm), _t(w))


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("m,k,n", [(5, 256, 40), (3, 384, 130)])
def test_lut_matmul_plain_matches_pallas_interpret(bits, m, k, n):
    jargs, targs = _lut_inputs(m, k, n, bits)
    want = np.asarray(jops.lut_matmul(*jargs, bits=bits, group_size=128,
                                      backend="interpret"))
    before = tlm.lut_matmul.launches
    got = tops.lut_matmul(*targs, bits=bits, group_size=128)
    assert tlm.lut_matmul.launches == before
    assert got.dtype == torch.float32 and got.shape == (m, n)
    tol = tlm.error_bound(*targs, got, bits=bits, group_size=128).numpy()
    assert (np.abs(got.numpy() - want) <= tol).all()
    # and the oracle (explicit dequant, then one matmul) within the bound
    oracle = tops._ref.lut_matmul(*targs, bits=bits, group_size=128)
    assert bool(((got - oracle).abs() <= torch.from_numpy(tol)).all())


def test_act_quant_and_lut_matmul_raise_like_jax():
    with pytest.raises(ValueError, match="not divisible"):
        taq.act_quant(torch.randn(2, 200), bits=2, group_size=128)
    _, (ap, asc, azm, w) = _lut_inputs(4, 256, 8, 4)
    with pytest.raises(ValueError, match="bits <= 4"):
        tlm.lut_matmul(ap, asc, azm, w, bits=8, group_size=128)
    for k, gs in ((96, 64), (130, 32), (100, 128)):
        with pytest.raises(ValueError, match="dropped"):
            tlm.lut_matmul(torch.zeros((4, -(-k // 4)), dtype=torch.uint8),
                           torch.ones(4, -(-k // gs)),
                           torch.ones(4, -(-k // gs)), torch.ones(k, 8),
                           bits=2, group_size=gs)


@pytest.mark.parametrize("scheme,a_bits,lut", [("lq4w", None, False),
                                               ("lq8", 8, False),
                                               ("lq4", 4, False),
                                               ("lq2_lut", 2, True)])
def test_quant_dense_branches_match_jax(scheme, a_bits, lut):
    """Each branch of quant_dense on the same QWeight (bytes equal in the
    two packages) and the same x; the JAX side runs its kernels in
    interpret mode.  1e-5 of the output scale, as for quant_matmul: the
    branches add only act_quant (equal codes here) and a dequant."""
    w_bits = jschemes.get(scheme).w_bits
    x, jq, tq = _qm_inputs(6, 256, 48, w_bits)
    for leaf in ("packed", "scale", "zmin"):
        np.testing.assert_array_equal(getattr(tq, leaf).numpy(),
                                      np.asarray(getattr(jq, leaf)))
    x3 = x.reshape(2, 3, 256)
    want = np.asarray(jops.quant_dense(jnp.asarray(x3), jq, a_bits=a_bits,
                                       lut=lut, backend="interpret"))
    got = tops.quant_dense(torch.from_numpy(x3), tq, a_bits=a_bits, lut=lut)
    assert got.shape == (2, 3, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# llama3.2-1b's projections (K, N): q k v o gate up down; then the shapes
# the card tests use (ragged and narrow N, K of 2 and 3 regions)
LLAMA_1B = ((2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
            (2048, 8192), (2048, 8192), (8192, 2048))
TEST_SHAPES = ((256, 70), (512, 96), (256, 33), (384, 64), (2048, 2024))


def _blocks(m, n, plan):
    bm, splits = plan
    return -(-m // bm) * -(-n // tlm.BLOCK_COLS) * splits


def _pieces(k, bits, group_size, splits):
    """The lengths, in codes, of the parts whose tables the split-K kernel
    sums: each split's code bytes (``splitk.split_rows``) cut at the local
    regions' edges, in K order."""
    cpb = packing.codes_per_byte(bits)
    rb = group_size // cpb                     # code bytes per region
    out = []
    for lo, hi in splitk.split_rows(k // cpb, splits):
        while lo < hi:
            end = min(hi, (lo // rb + 1) * rb)
            out.append((end - lo) * cpb)
            lo = end
    return out


def _summed_terms(k, bits, group_size, splits):
    """The summed terms error_bound has to cover for the split-K kernel:
    the longest part's table sums, the 2^n weighted tables, every part's
    term (summed in a fixed order across the splits) and the affine's 4."""
    p = _pieces(k, bits, group_size, splits)
    return max(p) + (1 << bits) + len(p) + 4


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [1, 4, 7, 16])
def test_lut_matmul_plan_fills_the_card_at_decode(m, bits):
    """Every llama3.2-1b projection launches at least one block per SM at
    decode, with a power-of-two row tile whose tables fit registers."""
    for k, n in LLAMA_1B:
        bm, splits = tlm.plan(m, k, n, bits)
        assert bm <= tlm.BM_MAX[bits] and bm & (bm - 1) == 0
        assert bm >= min(m, tlm.BM_MAX[bits])
        assert _blocks(m, n, (bm, splits)) >= splitk.SMS


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
@pytest.mark.parametrize("k,splits", [(2048, 128), (2048, 64), (8192, 16),
                                      (384, 7), (256, 5), (1024, 13)])
def test_lut_matmul_splits_cover_k_once_in_whole_code_bytes(k, splits,
                                                            bits):
    """The splits cover K's code bytes once, in order; each part is whole
    code bytes inside one region, and the parts add up to K."""
    cpb = packing.codes_per_byte(bits)
    ranges = splitk.split_rows(k // cpb, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == k // cpb
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    parts = _pieces(k, bits, 128, splits)
    assert sum(parts) == k and all(p % cpb == 0 and p > 0 for p in parts)
    edges = np.cumsum([0] + parts)
    for lo, hi in zip(edges, edges[1:]):
        assert lo // 128 == (hi - 1) // 128          # inside one region


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
@pytest.mark.parametrize("k,n", sorted(set(LLAMA_1B + TEST_SHAPES)))
def test_lut_matmul_plan_keeps_to_the_error_budget(k, n, bits):
    """A region cut into P parts sums R/P + G*P terms, within error_bound's
    R + G while P <= R/G; every decode plan keeps to it."""
    r, g = 128, k // 128
    for m in range(1, tlm.DECODE_M + 1):
        _, splits = tlm.plan(m, k, n, bits)
        parts = _pieces(k, bits, r, splits)
        p = max(-(-r // min(parts)), 1)              # parts per region
        assert r / p + g * p <= r + g
        assert (_summed_terms(k, bits, r, splits)
                <= r + (1 << bits) + g + 4)


def test_lut_matmul_plan_keeps_prefill_on_the_old_kernel():
    """Up to 16 rows split K; the prefill bucket (M > 16) takes no plan:
    the wrapper launches the one-pass kernel."""
    assert tlm.DECODE_M == 16
    for k, n in LLAMA_1B:
        for m in (17, 176):
            with pytest.raises(ValueError, match="one-pass"):
                tlm.plan(m, k, n, 2)
        assert tlm.plan(4, k, n, 2)[1] > 1


def _split_lut(ap, asc, azm, w, *, bits, splits):
    """The split-K kernel's dataflow in PyTorch: each part's one-hot tables
    and affine, the parts of a split summed in K order, then the splits in
    order."""
    m, k = ap.shape[0], w.shape[0]
    codes = packing.unpack(ap, bits, k)
    cpb = packing.codes_per_byte(bits)
    split_ends = {hi * cpb for _, hi in splitk.split_rows(k // cpb, splits)}
    out = torch.zeros((m, w.shape[1]))
    acc, lo = torch.zeros_like(out), 0
    for hi in np.cumsum(_pieces(k, bits, 128, splits)).tolist():
        g = lo // 128
        c, wp = codes[:, lo:hi], w[lo:hi]
        code_dot = sum(v * ((c == v).float() @ wp)
                       for v in range(1, 1 << bits))
        acc = acc + (asc[:, g:g + 1] * code_dot
                     + azm[:, g:g + 1] * wp.sum(0))
        if hi in split_ends:
            out, acc = out + acc, torch.zeros_like(acc)
        lo = hi
    return out


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
@pytest.mark.parametrize("splits", [1, 3, 8, 16])
def test_lut_matmul_split_parts_sum_to_the_pallas_kernel(bits, splits):
    """Cutting regions into parts (the decode kernel's split K) still
    computes dequant(a) @ w: the parts' sums match the JAX kernel within
    error_bound, whose term count the plan's splits keep to."""
    m, k, n = 4, 512, 40
    jargs, targs = _lut_inputs(m, k, n, bits)
    want = np.asarray(jops.lut_matmul(*jargs, bits=bits, group_size=128,
                                      backend="interpret"))
    got = _split_lut(*targs, bits=bits, splits=splits)
    tol = tlm.error_bound(*targs, got, bits=bits, group_size=128).numpy()
    assert (np.abs(got.numpy() - want) <= tol).all()
