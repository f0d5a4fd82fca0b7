"""Kernel B2r (row-major dense-attention backward, scale and causal inside)
and kernel B1 with ``scale``/``causal`` in ofasys_torch against ofasys_tpu's
Pallas kernels.

On the CPU the port's wrappers run the kernels' plain versions
(``dense_attention_bwd_rowmajor_reference``, ``dense_attention_fwd_reference``);
the JAX side runs ``_backward`` (body ``_bwd_kernel``) and ``_fwd_call`` in
interpret mode. Inputs come from a numpy seed and go to both frameworks as
the same arrays; both backwards get the same lse (from JAX's ``_fwd_call``).

Tolerances, relative to the largest entry of the reference output:
  * fp32: 1e-5 (the same fp32 products summed in another order);
  * bf16: dq, dk, dv one bf16 ulp of max|ref|, 2^-7 (outputs are rounded to
    bf16, and p and ds * scale are rounded to bf16 before their products on
    both sides, where a value on a rounding boundary can round either way
    after a reordered fp32 sum); dbias 1e-3 (an fp32 sum of unrounded ds);
    the forward's out 2^-7 and lse 1e-5.
Every mask keeps key 0 and causal cases keep Tq <= Tk, so no query row is
fully masked. The CUDA kernels are held against their plain versions on the
card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu.ops import pallas_dense_attention as jdense
from ofasys_torch.ops import dense_attention as tdense

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
ULP = 2.0 ** -7
RTOL = {"fp32": {"dq": 1e-5, "dk": 1e-5, "dv": 1e-5, "dbias": 1e-5, "out": 1e-5},
        "bf16": {"dq": ULP, "dk": ULP, "dv": ULP, "dbias": 1e-3, "out": ULP}}
H, D = 4, 32
SCALES = [1.0, 0.0884]
SHAPES = [(2, 40, 40), (3, 24, 72)]          # Tq = Tk, and Tq < Tk (the causal offset)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Tq, Tk, with_bias, with_mask, seed=0):
    rng = np.random.default_rng(seed)
    E = H * D
    q = rng.standard_normal((B, Tq, E)).astype(np.float32)
    k = rng.standard_normal((B, Tk, E)).astype(np.float32)
    v = rng.standard_normal((B, Tk, E)).astype(np.float32)
    do = rng.standard_normal((B, Tq, E)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((H, Tq, Tk))).astype(np.float32) if with_bias else None
    mask = None
    if with_mask:
        keep = rng.random((B, Tk)) > 0.25
        keep[:, 0] = True
        mask = keep[:, None, :].astype(np.int8)
    return q, k, v, do, bias, mask


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(name, got, ref, rtol):
    ref = _f32(ref)
    atol = rtol * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_f32(got), ref, rtol=0, atol=atol, err_msg=name)


def _both(dtype, B, Tq, Tk, with_bias, with_mask, scale, seed=0):
    """The same inputs as JAX arrays and torch tensors. q is scaled so that
    q.k * scale has unit size whatever the scale."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, do, bias, mask = _inputs(B, Tq, Tk, with_bias, with_mask, seed)
    q = q * (0.2 / scale)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    jbias = None if bias is None else jnp.asarray(bias).astype(jnp.bfloat16)
    jmask = None if mask is None else jnp.asarray(mask)

    def t(a, dt=tdt):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dt)

    targs = (t(jq), t(jk), t(jv), t(jdo), None if jbias is None else t(jbias, torch.bfloat16),
             None if mask is None else torch.from_numpy(mask))
    return (jq, jk, jv, jdo, jbias, jmask), targs


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES, ids=["square", "cross"])
def test_rowmajor_bwd_matches_pallas_backward(dtype, with_bias, with_mask, causal, scale, shape):
    B, Tq, Tk = shape
    tdt = DTYPES[dtype][1]
    (jq, jk, jv, jdo, jbias, jmask), (tq, tk, tv, tdo, tbias, tmask) = _both(
        dtype, B, Tq, Tk, with_bias, with_mask, scale)
    _, lse = jdense._fwd_call(jq, jk, jv, jbias, jmask, scale, causal, H)
    ref = jdense._backward(jq, jk, jv, jbias, jmask, lse, jdo, scale, causal, H)
    got = tdense.dense_attention_bwd_rowmajor(
        tq, tk, tv, tdo, torch.from_numpy(np.array(lse)[..., 0]), tbias, tmask, H, scale, causal)
    for name, g, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert g.dtype == tdt and g.shape == r.shape
        _assert_close(name, g, r, RTOL[dtype][name])
    if with_bias:
        assert got[3].dtype == torch.float32 and tuple(got[3].shape) == (H, Tq, Tk)
        _assert_close("dbias", got[3], ref[3], RTOL[dtype]["dbias"])
    else:
        assert got[3] is None and ref[3] is None


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES, ids=["square", "cross"])
def test_fwd_with_scale_and_causal_matches_pallas_forward(dtype, with_bias, causal, scale, shape):
    B, Tq, Tk = shape
    (jq, jk, jv, _, jbias, jmask), (tq, tk, tv, _, tbias, tmask) = _both(
        dtype, B, Tq, Tk, with_bias, True, scale, seed=3)
    jout, jlse = jdense._fwd_call(jq, jk, jv, jbias, jmask, scale, causal, H)
    out, lse = tdense.dense_attention_fwd(tq, tk, tv, tbias, tmask, H, scale, causal)
    _assert_close("out", out, jout, RTOL[dtype]["out"])
    np.testing.assert_allclose(lse.numpy(), np.array(jlse)[..., 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", SHAPES, ids=["square", "cross"])
def test_causal_dense_attention_gradients_match_jax_grad(dtype, with_bias, scale, shape):
    """``jax.grad`` through ``_dense_attention(..., scale, True, H)`` (B1 with
    causal inside, B2r backward) against the port's ``_dense_attention``."""
    B, Tq, Tk = shape
    tdt = DTYPES[dtype][1]
    (jq, jk, jv, jdo, jbias, jmask), (tq, tk, tv, tdo, tbias, tmask) = _both(
        dtype, B, Tq, Tk, with_bias, True, scale, seed=4)

    def loss(q, k, v, b):
        out = jdense._dense_attention(q, k, v, b, jmask, scale, True, H)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    argnums = (0, 1, 2, 3) if with_bias else (0, 1, 2)
    jgrads = jax.grad(loss, argnums=argnums)(jq, jk, jv, jbias)

    leaves = [t.requires_grad_() for t in (tq, tk, tv)]
    if with_bias:
        tbias.requires_grad_()
    before = tdense.dense_attention_bwd_rowmajor.launches
    out = tdense._dense_attention(*leaves, tbias, tmask, scale, True, H)
    (out.float() * tdo.float()).sum().backward()
    assert tdense.dense_attention_bwd_rowmajor.launches == before      # CPU: no launch counted
    for name, t, j in zip(("dq", "dk", "dv"), leaves, jgrads[:3]):
        assert t.grad.dtype == tdt
        _assert_close(name, t.grad, j, RTOL[dtype][name])
    if with_bias:
        # the bias gradient comes back rounded to the bias's bf16
        assert tbias.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(tbias.grad), _f32(jgrads[3]), rtol=2 * ULP, atol=1e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["square", "cross"])
def test_rowmajor_switch_routes_the_public_backward(monkeypatch, dtype, causal, shape):
    """With OFASYS_DENSE_BWD=rowmajor the public ``dense_attention`` (scale
    and causal folded outside, scale 1 inside) takes the row-major backward
    and not B2's; its gradients equal B2's plain version within the bf16
    rounding of ds * scale (scale is 1 inside: the same arithmetic)."""
    B, Tq, Tk = shape
    tdt = DTYPES[dtype][1]
    q, k, v, do, bias, mask = _inputs(B, Tq, Tk, True, True, seed=5)
    q4, k4, v4, do4 = (torch.from_numpy(a.reshape(a.shape[0], a.shape[1], H, D)).to(tdt)
                       for a in (q, k, v, do))
    m4 = torch.from_numpy(mask[:, :, None, :].astype(bool))

    calls = {"rowmajor": 0, "t": 0}
    for key, name in (("rowmajor", "dense_attention_bwd_rowmajor_reference"),
                      ("t", "dense_attention_bwd_reference")):
        orig = getattr(tdense, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(tdense, name, counted)

    def grads():
        leaves = [t.clone().requires_grad_() for t in (q4, k4, v4)]
        b = torch.from_numpy(bias[None]).requires_grad_()
        out = tdense.dense_attention(*leaves, bias=b, mask=m4, scale=0.125, causal=causal)
        out.backward(do4)
        return [t.grad for t in leaves] + [b.grad]

    monkeypatch.delenv("OFASYS_DENSE_BWD", raising=False)
    default = grads()
    assert calls == {"rowmajor": 1, "t": 1}       # B2's plain version delegates once
    monkeypatch.setenv("OFASYS_DENSE_BWD", "rowmajor")
    calls.update(rowmajor=0, t=0)
    switched = grads()
    assert calls == {"rowmajor": 1, "t": 0}
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), switched, default):
        _assert_close(name, a, b, 1e-6 if dtype == "fp32" else ULP)


def test_causal_needs_a_visible_key_in_every_row():
    q = torch.zeros(1, 8, H * D)
    k = torch.zeros(1, 4, H * D)
    with pytest.raises(ValueError, match="causal"):
        tdense.dense_attention_fwd(q, k, k.clone(), None, None, H, 1.0, True)
    with pytest.raises(ValueError, match="causal"):
        tdense.dense_attention_bwd_rowmajor(q, k, k.clone(), q.clone(), torch.zeros(1, H, 8),
                                            None, None, H, 1.0, True)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_rowmajor_bwd_at_wide_heads_matches_pallas_backward(dtype, causal):
    """D = 128 at Tk = 256 (B = 1, H = 1): the shape whose dk/dv sums do not
    fit one block on the card, so the kernel splits the keys into ranges.
    B2r's plain version against ``_backward`` in interpret mode, with a
    bias, a mask and the scale inside; tolerances as RTOL (bf16: one bf16
    ulp of max|ref| for dq, dk, dv, 1e-3 for dbias; fp32 1e-5)."""
    rng = np.random.default_rng(6)
    B, T, h, d, scale = 1, 256, 1, 128, 128 ** -0.5
    jdt, tdt = DTYPES[dtype]
    q, k, v, do = (rng.standard_normal((B, T, h * d)).astype(np.float32) for _ in range(4))
    q = q * (0.2 / scale)
    bias = (0.5 * rng.standard_normal((h, T, T))).astype(np.float32)
    keep = rng.random((B, T)) > 0.25
    keep[:, 0] = True
    mask = keep[:, None, :].astype(np.int8)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    jbias = jnp.asarray(bias).astype(jnp.bfloat16)
    _, lse = jdense._fwd_call(jq, jk, jv, jbias, jnp.asarray(mask), scale, causal, h)
    ref = jdense._backward(jq, jk, jv, jbias, jnp.asarray(mask), lse, jdo, scale, causal, h)

    def t(a, dt=tdt):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dt)

    got = tdense.dense_attention_bwd_rowmajor(t(jq), t(jk), t(jv), t(jdo),
                                              torch.from_numpy(np.array(lse)[..., 0]),
                                              t(jbias, torch.bfloat16), torch.from_numpy(mask), h,
                                              scale, causal)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert g.shape == r.shape
        _assert_close(name, g, r, RTOL[dtype][name])
