"""Kernel B2 (dense whole-row attention backward) in ofasys_torch against
ofasys_tpu's Pallas backward.

On the CPU the port's ``dense_attention_bwd`` runs the kernel's plain
version (``dense_attention_bwd_reference``); the JAX side runs the Pallas
kernels ``_backward_t`` (per-sample grid) and ``_backward_tg`` (G samples
per grid step) in interpret mode, as tests/test_pallas_dense_attention.py
does. Inputs come from a numpy seed and go to both frameworks as the same
arrays; both sides get the same lse (from JAX's ``_fwd_call``).

Tolerances, relative to the largest entry of the reference output:
  * fp32: 1e-5 (the same fp32 products summed in another order);
  * bf16: dq, dk, dv 1e-2 (outputs are rounded to bf16, whose ulp is 2^-8
    of the leading binade, and p and ds are rounded to bf16 before their
    products on both sides, where a value on a rounding boundary can round
    either way after a reordered fp32 sum); dbias 1e-4 (an fp32 sum of
    unrounded ds).
Through the public wrapper (prep included: q scaling, causal folded into the
bias, bf16 bias) the gradients of q, k, v and an fp32 bias are compared
with ``jax.vjp`` of ofasys_tpu's ``dense_attention`` at 1e-5 (fp32) and
2e-2 (bf16). The fp32 bias's gradient comes back through the bf16 cast of
the prep, so in both dtypes it is a bf16 value: elementwise rtol 8e-3, two
bf16 ulps, since a reordered fp32 sum can land on either side of a
rounding boundary.
Every test mask keeps key 0, and causal cases keep Tq <= Tk, so no query
row is fully masked. The CUDA kernel itself is held against its plain
version on the card by tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu.ops import pallas_dense_attention as jdense
from ofasys_torch.ops import dense_attention as tdense

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
RTOL = {"fp32": {"dq": 1e-5, "dk": 1e-5, "dv": 1e-5, "dbias": 1e-5},
        "bf16": {"dq": 1e-2, "dk": 1e-2, "dv": 1e-2, "dbias": 1e-4}}
WRAPPER_RTOL = {"fp32": 1e-5, "bf16": 2e-2}
H, D = 4, 32


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
    q = (0.2 * rng.standard_normal((B, Tq, E))).astype(np.float32)
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
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(name, got, ref, rtol):
    ref = _f32(ref)
    atol = rtol * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_f32(got), ref, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("case", [
    ("t", 1, 40, 40), ("t", 2, 40, 40), ("tg", 2, 40, 40), ("tg", 3, 24, 72), ("t", 1, 24, 72),
], ids=["B1", "B2_per_sample", "B2_G2", "cross_G3", "cross_B1"])
def test_bwd_matches_pallas_backward(dtype, with_bias, with_mask, case):
    variant, B, Tq, Tk = case
    jdt, tdt = DTYPES[dtype]
    q, k, v, do, bias, mask = _inputs(B, Tq, Tk, with_bias, with_mask)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    jbias = None if bias is None else jnp.asarray(bias).astype(jnp.bfloat16)
    jmask = None if mask is None else jnp.asarray(mask)
    _, lse = jdense._fwd_call(jq, jk, jv, jbias, jmask, 1.0, False, H)
    biasT = None if jbias is None else jnp.swapaxes(jbias, 1, 2)
    if variant == "t":
        ref = jdense._backward_t(jq, jk, jv, biasT, jmask, lse, jdo, 1.0, H)
    else:
        ref = jdense._backward_tg(jq, jk, jv, biasT, jmask, lse, jdo, 1.0, H, B)

    def t(a, dt=tdt):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dt)

    got = tdense.dense_attention_bwd(
        t(jq), t(jk), t(jv), t(jdo), torch.from_numpy(np.array(lse)[..., 0]),
        None if jbias is None else t(jbias, torch.bfloat16),
        None if mask is None else torch.from_numpy(mask), H,
    )
    for name, g, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert g.dtype == tdt and g.shape == r.shape
        _assert_close(name, g, r, RTOL[dtype][name])
    if with_bias:
        assert got[3].dtype == torch.float32 and tuple(got[3].shape) == (H, Tq, Tk)
        _assert_close("dbias", got[3], ref[3], RTOL[dtype]["dbias"])
    else:
        assert got[3] is None and ref[3] is None


def test_dbias_is_the_batch_sum():
    """dbias of a batch is the sum of the per-sample dbias (fp32 sums of
    the same unrounded ds)."""
    B, T = 4, 32
    q, k, v, do, bias, mask = (torch.from_numpy(a) if a is not None else None
                               for a in _inputs(B, T, T, True, True, seed=2))
    bias = bias.to(torch.bfloat16)
    _, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H)
    full = tdense.dense_attention_bwd(q, k, v, do, lse, bias, mask, H)[3]
    parts = sum(tdense.dense_attention_bwd(q[i:i + 1], k[i:i + 1], v[i:i + 1], do[i:i + 1],
                                           lse[i:i + 1].contiguous(), bias, mask[i:i + 1], H)[3]
                for i in range(B))
    np.testing.assert_allclose(full.numpy(), parts.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("shape", [(1, 40, 40), (2, 40, 40), (3, 24, 72)],
                         ids=["B1", "square", "cross"])
def test_public_wrapper_gradients_match_jax_vjp(dtype, causal, with_bias, with_mask, shape):
    B, Tq, Tk = shape
    jdt, tdt = DTYPES[dtype]
    q, k, v, do, bias, mask = _inputs(B, Tq, Tk, with_bias, with_mask, seed=1)
    q4, k4, v4, do4 = (a.reshape(a.shape[0], a.shape[1], H, D) for a in (q, k, v, do))
    q4 = q4 * 8.0                                    # the wrapper scales by 0.125
    b4 = None if bias is None else bias[None]
    m4 = None if mask is None else mask[:, :, None, :].astype(bool)

    def f(q, k, v, b):
        return jdense.dense_attention(q, k, v, bias=b, mask=None if m4 is None else jnp.asarray(m4),
                                      scale=0.125, causal=causal)

    jargs = [jnp.asarray(a).astype(jdt) for a in (q4, k4, v4)]
    jargs.append(None if b4 is None else jnp.asarray(b4))
    jout, vjp = jax.vjp(f, *jargs)
    jgrads = vjp(jnp.asarray(do4).astype(jdt))

    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt).requires_grad_()
             for a in jargs[:3]]
    tb = None if b4 is None else torch.from_numpy(b4).requires_grad_()
    out = tdense.dense_attention(*targs, bias=tb, mask=None if m4 is None else torch.from_numpy(m4),
                                 scale=0.125, causal=causal)
    out.backward(torch.from_numpy(np.array(jnp.asarray(do4).astype(jnp.float32))).to(tdt))
    _assert_close("out", out.detach(), jout, WRAPPER_RTOL[dtype])
    for name, t, j in zip(("dq", "dk", "dv"), targs, jgrads[:3]):
        assert t.grad.dtype == tdt
        _assert_close(name, t.grad, j, WRAPPER_RTOL[dtype])
    if with_bias:
        assert tb.grad.dtype == torch.float32
        np.testing.assert_allclose(tb.grad.numpy(), _f32(jgrads[3]), rtol=8e-3, atol=1e-6,
                                   err_msg="dbias")


@pytest.mark.parametrize("bad", ["do_shape", "do_dtype", "lse_shape", "lse_dtype"])
def test_bwd_wrapper_rejects_bad_inputs(bad):
    B, T = 2, 16
    q = torch.zeros(B, T, H * D)
    do = torch.zeros(B, T, H * D)
    lse = torch.zeros(B, H, T)
    if bad == "do_shape":
        do = torch.zeros(B, T + 1, H * D)
    elif bad == "do_dtype":
        do = do.to(torch.bfloat16)
    elif bad == "lse_shape":
        lse = torch.zeros(B, H, T, 1)
    else:
        lse = lse.double()
    with pytest.raises((TypeError, ValueError)):
        tdense.dense_attention_bwd(q, q.clone(), q.clone(), do, lse, None, None, H)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", [(2, 40, 40, 2, 88), (1, 24, 72, 2, 128), (3, 40, 200, 2, 64),
                                  (2, 21, 37, 3, 88)],
                         ids=["D88", "D128_cross", "ragged_cross", "D88_ragged"])
def test_bwd_at_wide_heads_and_ragged_shapes_matches_pallas(dtype, case):
    """B2's plain version against ``_backward_t`` in interpret mode at the
    head dims and ragged shapes the tensor-core kernel's edge logic exists
    for (D = 88 and 128, Tq != Tk, no multiple of 16), with a bias and a
    mask. Tolerances as RTOL: fp32 1e-5 of max|ref|; bf16 dq, dk, dv 1e-2,
    dbias 1e-4."""
    B, Tq, Tk, h, d = case
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    E = h * d
    q = (0.2 * rng.standard_normal((B, Tq, E))).astype(np.float32)
    k, v = (rng.standard_normal((B, Tk, E)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, Tq, E)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((h, Tq, Tk))).astype(np.float32)
    keep = rng.random((B, Tk)) > 0.25
    keep[:, 0] = True
    mask = keep[:, None, :].astype(np.int8)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    jbias = jnp.asarray(bias).astype(jnp.bfloat16)
    _, lse = jdense._fwd_call(jq, jk, jv, jbias, jnp.asarray(mask), 1.0, False, h)
    ref = jdense._backward_t(jq, jk, jv, jnp.swapaxes(jbias, 1, 2), jnp.asarray(mask), lse, jdo,
                             1.0, h)

    def t(a, dt=tdt):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dt)

    got = tdense.dense_attention_bwd(t(jq), t(jk), t(jv), t(jdo),
                                     torch.from_numpy(np.array(lse)[..., 0]),
                                     t(jbias, torch.bfloat16), torch.from_numpy(mask), h)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert g.shape == r.shape
        _assert_close(name, g, r, RTOL[dtype][name])
