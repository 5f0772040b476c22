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
