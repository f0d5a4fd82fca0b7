"""Kernels B3, B4 and B5 (flash attention) in ofasys_torch against
ofasys_tpu's Pallas flash kernels.

On the CPU the port's wrappers run the kernels' plain versions
(``flash_attention_fwd_reference``, ``flash_attention_bwd_reference``); the
JAX side runs ``_flash_forward`` and ``_flash_backward`` (the dQ, dK/dV and
shared-dbias kernels) in interpret mode, with small explicit blocks so that
several tiles, the causal tile skip and a ragged last tile all run. Inputs
come from a numpy seed and go to both frameworks as the same arrays; the
backward gets the same forward output and lse on both sides.

Tolerances, relative to the largest entry of the reference output
(``max(1, |ref|)``):
  * fp32: 1e-5 for out, dq, dk, dv and the fp32 ds of a per-(b, h) bias
    (the same fp32 products summed in another order, over tiles on one side
    and whole rows on the other); lse 1e-5;
  * bf16: out, dq, dk, dv 1e-2 (bf16 outputs, whose ulp is 2^-8 of the
    leading binade; p and ds are rounded to bf16 before their products on
    both sides, the kernel's p against the running max of its tile and the
    plain version's against the row max); lse 1e-5;
  * the shared-bias gradient comes back from JAX in the bias's dtype (bf16):
    1e-2.
Through the public wrappers (``flash_attention``, ``flash_attention_with_lse``,
prep included) outputs and the gradients of q, k, v and an fp32 bias are
compared with ``jax.vjp`` of ofasys_tpu's at 1e-5 (fp32) and 2e-2 (bf16); the
fp32 bias's gradient passes the bf16 cast of the prep, so it is held at 1e-2.
Every test mask keeps key 0, so no query row is fully masked. Each
interpret-mode call stays at BH <= 4 and T <= 96. The CUDA kernels are held
against these plain versions on the card by tests/test_torch_kernels_cuda.py
and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu.ops import pallas_attention as jflash
from ofasys_torch.ops import flash_attention as tflash

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 1e-5, "bf16": 1e-2}
WRAPPER_TOL = {"fp32": 1e-5, "bf16": 2e-2}
H, D = 2, 16
SCALE = D ** -0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Tq, Tk, bias_kind, with_mask, seed=0, h=H, d=D):
    """q, k, v, do (B, T, h*d) fp32; bias fp32 (h or B*h, Tq, Tk) or None;
    keep-mask int8 (B, 1, Tk) or None."""
    rng = np.random.default_rng(seed)
    E = h * d
    q = rng.standard_normal((B, Tq, E)).astype(np.float32)
    k = rng.standard_normal((B, Tk, E)).astype(np.float32)
    v = rng.standard_normal((B, Tk, E)).astype(np.float32)
    do = rng.standard_normal((B, Tq, E)).astype(np.float32)
    nb = {"none": 0, "shared": h, "per_bh": B * h}[bias_kind]
    bias = (0.5 * rng.standard_normal((nb, Tq, Tk))).astype(np.float32) if nb else None
    mask = None
    if with_mask:
        keep = rng.random((B, Tk)) > 0.25
        keep[:, 0] = True
        mask = keep[:, None, :].astype(np.int8)
    return q, k, v, do, bias, mask


def _flat(a, B, h=H, d=D):
    """(B, T, h*d) -> JAX's (B*h, T, d)."""
    T = a.shape[1]
    return a.reshape(B, T, h, d).transpose(0, 2, 1, 3).reshape(B * h, T, d)


def _unflat(a, B, h=H, d=D):
    """JAX's (B*h, T, d) -> (B, T, h*d)."""
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    T = a.shape[1]
    return a.reshape(B, h, T, d).transpose(0, 2, 1, 3).reshape(B, T, h * d)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_close(name, got, ref, tol):
    ref = _f32(ref)
    atol = tol * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_f32(got), ref, rtol=0, atol=atol, err_msg=name)


def _jax_args(q, k, v, do, bias, mask, B, jdt, h=H, d=D):
    jq, jk, jv, jdo = (jnp.asarray(_flat(a, B, h, d)).astype(jdt) for a in (q, k, v, do))
    jbias = None if bias is None else jnp.asarray(bias).astype(jnp.bfloat16)
    jmask = None if mask is None else jnp.asarray(np.repeat(mask, h, axis=0))
    return jq, jk, jv, jdo, jbias, jmask


def _torch(a, dt):
    return torch.from_numpy(np.array(_f32(a))).to(dt)


CASES = {
    # (B, Tq, Tk, bias, mask, causal, block_q, block_k)
    "causal": (2, 48, 48, "shared", True, True, 16, 16),
    "shared_bias_mask_ragged": (2, 40, 56, "shared", True, False, 16, 16),
    "per_bh_bias": (2, 24, 40, "per_bh", False, False, 16, 16),
    "no_bias": (1, 32, 72, "none", True, False, 16, 32),
    "causal_per_bh_ragged": (2, 40, 40, "per_bh", False, True, 16, 16),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_pallas_forward(dtype, case):
    B, Tq, Tk, bias_kind, with_mask, causal, bq, bk = CASES[case]
    jdt, tdt = DTYPES[dtype]
    q, k, v, do, bias, mask = _inputs(B, Tq, Tk, bias_kind, with_mask)
    jq, jk, jv, _, jbias, jmask = _jax_args(q, k, v, do, bias, mask, B, jdt)
    ref_out, ref_lse = jflash._flash_forward(jq, jk, jv, jbias, jmask, SCALE, causal,
                                             block_q=bq, block_k=bk, return_lse=True)
    before = tflash.flash_attention_fwd.launches
    out, lse = tflash.flash_attention_fwd(
        _torch(q, tdt).contiguous(), _torch(k, tdt), _torch(v, tdt),
        None if jbias is None else _torch(jbias, torch.bfloat16),
        None if mask is None else torch.from_numpy(mask), H, SCALE, causal)
    assert tflash.flash_attention_fwd.launches == before      # the CPU launches nothing
    assert out.dtype == tdt and lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, Tq)
    _assert_close("out", out, _unflat(ref_out, B), TOL[dtype])
    _assert_close("lse", lse, np.asarray(ref_lse)[..., 0].reshape(B, H, Tq), 1e-5)


@pytest.mark.parametrize("dtype,with_g_lse", [("fp32", False), ("bf16", False), ("fp32", True)],
                         ids=["fp32", "bf16", "fp32_g_lse"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_pallas_backward(dtype, case, with_g_lse):
    B, Tq, Tk, bias_kind, with_mask, causal, bq, bk = CASES[case]
    jdt, tdt = DTYPES[dtype]
    q, k, v, do, bias, mask = _inputs(B, Tq, Tk, bias_kind, with_mask, seed=1)
    jq, jk, jv, jdo, jbias, jmask = _jax_args(q, k, v, do, bias, mask, B, jdt)
    out, lse = jflash._flash_forward(jq, jk, jv, jbias, jmask, SCALE, causal,
                                     block_q=bq, block_k=bk, return_lse=True)
    g_lse = None
    if with_g_lse:
        g_lse = jnp.asarray(np.random.default_rng(2).standard_normal((B * H, Tq, 1)), jnp.float32)
    ref = jflash._flash_backward(jq, jk, jv, jbias, jmask, out, lse, jdo, SCALE, causal,
                                 block_q=bq, block_k=bk, g_lse=g_lse)

    # dd = rowsum(do * out) - g_lse, as FlashAttentionFunction.backward forms it
    do_t, out_t = _torch(_unflat(jdo, B), tdt), _torch(_unflat(out, B), tdt)
    dd = (do_t.float() * out_t.float()).reshape(B, Tq, H, D).sum(-1).permute(0, 2, 1)
    if with_g_lse:
        dd = dd - torch.from_numpy(np.asarray(g_lse)[..., 0].reshape(B, H, Tq))
    args = (_torch(_unflat(jq, B), tdt), _torch(_unflat(jk, B), tdt), _torch(_unflat(jv, B), tdt),
            do_t, torch.from_numpy(np.asarray(lse)[..., 0].reshape(B, H, Tq)).contiguous(),
            dd.contiguous(), None if jbias is None else _torch(jbias, torch.bfloat16),
            None if mask is None else torch.from_numpy(mask), H, SCALE, causal)
    dq, dk, dv, dbias = tflash.flash_attention_bwd(*args)
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref[:3]):
        assert g.dtype == tdt
        _assert_close(name, g, _unflat(r, B), TOL[dtype])
    if bias_kind == "none":
        assert dbias is None and ref[3] is None
    else:
        # JAX returns the bias gradient in the bias's dtype (bf16)
        assert dbias.dtype == torch.float32 and tuple(dbias.shape) == tuple(bias.shape)
        _assert_close("dbias", dbias, ref[3], 1e-2)

    # each kernel's wrapper gives its part of the whole
    dq1, ds1 = tflash.flash_attention_bwd_dq(*args, want_ds=bias_kind == "per_bh")
    dk1, dv1 = tflash.flash_attention_bwd_dkv(*args)
    for a, b in ((dq1, dq), (dk1, dk), (dv1, dv)):
        assert torch.equal(a, b)
    if bias_kind == "per_bh":
        assert torch.equal(ds1, dbias)
    if bias_kind == "shared":
        assert torch.equal(tflash.flash_attention_bwd_dbias(*args), dbias)


# Head dims that the H100 kernel pads to its 16-wide fragments (88 -> 96) or
# takes with its other tiles (128), at key counts that are no multiple of the
# Pallas key block (a ragged last tile): the plain versions the card holds
# the kernels to, against the Pallas kernels at those widths.
WIDE_CASES = {
    # (B, Tq, Tk, H, D, bias, mask, causal, block_q, block_k)
    "D88_ragged": (2, 40, 72, 2, 88, "shared", True, False, 16, 32),
    "D128_ragged": (1, 24, 88, 2, 128, "per_bh", True, False, 16, 32),
    "D88_causal": (2, 40, 40, 2, 88, "shared", True, True, 16, 16),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_heads_match_pallas_forward_and_backward(dtype, case):
    B, Tq, Tk, h, d, bias_kind, with_mask, causal, bq, bk = WIDE_CASES[case]
    scale = d ** -0.5
    jdt, tdt = DTYPES[dtype]
    q, k, v, do, bias, mask = _inputs(B, Tq, Tk, bias_kind, with_mask, seed=8, h=h, d=d)
    jq, jk, jv, jdo, jbias, jmask = _jax_args(q, k, v, do, bias, mask, B, jdt, h, d)
    ref_out, ref_lse = jflash._flash_forward(jq, jk, jv, jbias, jmask, scale, causal,
                                             block_q=bq, block_k=bk, return_lse=True)
    tq, tk, tv = (_torch(_unflat(a, B, h, d), tdt) for a in (jq, jk, jv))
    tbias = None if jbias is None else _torch(jbias, torch.bfloat16)
    tmask = None if mask is None else torch.from_numpy(mask)
    out, lse = tflash.flash_attention_fwd(tq, tk, tv, tbias, tmask, h, scale, causal)
    _assert_close("out", out, _unflat(ref_out, B, h, d), TOL[dtype])
    lse_ref = np.array(ref_lse)[..., 0].reshape(B, h, Tq)
    _assert_close("lse", lse, lse_ref, 1e-5)

    ref = jflash._flash_backward(jq, jk, jv, jbias, jmask, ref_out, ref_lse, jdo, scale, causal,
                                 block_q=bq, block_k=bk)
    do_t, out_t = _torch(_unflat(jdo, B, h, d), tdt), _torch(_unflat(ref_out, B, h, d), tdt)
    dd = (do_t.float() * out_t.float()).reshape(B, Tq, h, d).sum(-1).permute(0, 2, 1)
    dq, dk, dv, dbias = tflash.flash_attention_bwd(
        tq, tk, tv, do_t, torch.from_numpy(lse_ref).contiguous(), dd.contiguous(), tbias, tmask,
        h, scale, causal)
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref[:3]):
        assert g.dtype == tdt
        _assert_close(name, g, _unflat(r, B, h, d), TOL[dtype])
    _assert_close("dbias", dbias, ref[3], 1e-2)


def test_per_bh_ds_in_fp32_matches_pallas_ds():
    """The dq kernel's ds output for a per-(b, h) bias, in fp32 inputs:
    JAX returns it in the bias's dtype, so compare before that rounding by
    feeding an fp32 bias to the JAX kernel."""
    B, Tq, Tk = 2, 40, 40
    q, k, v, do, bias, mask = _inputs(B, Tq, Tk, "per_bh", True, seed=3)
    jq, jk, jv, jdo, _, jmask = _jax_args(q, k, v, do, None, mask, B, jnp.float32)
    jbias = jnp.asarray(bias).astype(jnp.bfloat16).astype(jnp.float32)
    out, lse = jflash._flash_forward(jq, jk, jv, jbias, jmask, SCALE, True,
                                     block_q=16, block_k=16, return_lse=True)
    ref = jflash._flash_backward(jq, jk, jv, jbias, jmask, out, lse, jdo, SCALE, True,
                                 block_q=16, block_k=16)
    do_t, out_t = _torch(_unflat(jdo, B), torch.float32), _torch(_unflat(out, B), torch.float32)
    dd = (do_t * out_t).reshape(B, Tq, H, D).sum(-1).permute(0, 2, 1).contiguous()
    _, ds = tflash.flash_attention_bwd_dq(
        _torch(q, torch.float32), _torch(k, torch.float32), _torch(v, torch.float32), do_t,
        torch.from_numpy(np.asarray(lse)[..., 0].reshape(B, H, Tq)).contiguous(), dd,
        _torch(jbias, torch.bfloat16), torch.from_numpy(mask), H, SCALE, True, want_ds=True)
    _assert_close("ds", ds, ref[3], 1e-5)
    # causal: every entry above the diagonal is 0
    assert (ds.reshape(B * H, Tq, Tk).triu(1) == 0).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_kind", ["none", "shared", "per_b"])
def test_public_wrapper_matches_jax_vjp(dtype, causal, bias_kind):
    B, Tq, Tk = 2, 40, 40 if causal else 72
    jdt, tdt = DTYPES[dtype]
    q, k, v, do, _, mask = _inputs(B, Tq, Tk, "none", bias_kind != "shared", seed=4)
    rng = np.random.default_rng(5)
    nb = {"none": 0, "shared": 1, "per_b": B}[bias_kind]
    b4 = (0.5 * rng.standard_normal((nb, H, Tq, Tk))).astype(np.float32) if nb else None
    q4, k4, v4, do4 = (a.reshape(a.shape[0], a.shape[1], H, D) for a in (q, k, v, do))
    m4 = None if mask is None else mask[:, :, None, :].astype(bool)

    def f(q, k, v, b):
        return jflash.flash_attention(q, k, v, bias=b, mask=None if m4 is None else jnp.asarray(m4),
                                      scale=SCALE, causal=causal)

    jargs = [jnp.asarray(a).astype(jdt) for a in (q4, k4, v4)]
    jargs.append(None if b4 is None else jnp.asarray(b4))
    jout, vjp = jax.vjp(f, *jargs)
    jgrads = vjp(jnp.asarray(do4).astype(jdt))

    targs = [_torch(a, tdt).requires_grad_() for a in jargs[:3]]
    tb = None if b4 is None else torch.from_numpy(b4).requires_grad_()
    out = tflash.flash_attention(*targs, bias=tb, mask=None if m4 is None else torch.from_numpy(m4),
                                 scale=SCALE, causal=causal)
    out.backward(_torch(jnp.asarray(do4).astype(jdt), tdt))
    _assert_close("out", out, jout, WRAPPER_TOL[dtype])
    for name, t, j in zip(("dq", "dk", "dv"), targs, jgrads[:3]):
        assert t.grad.dtype == tdt
        _assert_close(name, t.grad, j, WRAPPER_TOL[dtype])
    if b4 is not None:
        assert tb.grad.dtype == torch.float32
        _assert_close("dbias", tb.grad, jgrads[3], 1e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_matches_jax_vjp(causal):
    """flash_attention_with_lse: out and lse, and the gradients of q, k, v
    and the bias under cotangents of both (the lse one folds into dd)."""
    B, Tq, Tk = 2, 32, 32 if causal else 48
    q, k, v, do, bias, mask = _inputs(B, Tq, Tk, "shared", True, seed=6)
    g_lse = np.random.default_rng(7).standard_normal((B * H, Tq, 1)).astype(np.float32)
    jq, jk, jv, jdo, _, jmask = _jax_args(q, k, v, do, None, mask, B, jnp.float32)
    jbias = jnp.asarray(bias).astype(jnp.bfloat16)

    def f(q, k, v, b):
        return jflash.flash_attention_with_lse(q, k, v, b, jmask, SCALE, causal)

    (jout, jlse), vjp = jax.vjp(f, jq, jk, jv, jbias)
    jgrads = vjp((jdo, jnp.asarray(g_lse)))

    targs = [_torch(_unflat(a, B), torch.float32).requires_grad_() for a in (jq, jk, jv)]
    tb = _torch(jbias, torch.bfloat16).requires_grad_()
    out, lse = tflash.flash_attention_with_lse(*targs, tb, torch.from_numpy(mask), H, SCALE, causal)
    torch.autograd.backward((out, lse), (_torch(_unflat(jdo, B), torch.float32),
                                         torch.from_numpy(g_lse[..., 0].reshape(B, H, Tq))))
    _assert_close("out", out, _unflat(jout, B), 1e-5)
    _assert_close("lse", lse, np.asarray(jlse)[..., 0].reshape(B, H, Tq), 1e-5)
    for name, t, j in zip(("dq", "dk", "dv"), targs, jgrads[:3]):
        _assert_close(name, t.grad, _unflat(j, B), 1e-5)
    assert tb.grad.dtype == torch.bfloat16
    _assert_close("dbias", tb.grad, jgrads[3], 1e-2)


def test_flash_supported_matches_jax():
    grid = [(tq, tk, d, p) for tq in (1, 15, 16, 64, 1000) for tk in (16, 255, 256, 257, 1024)
            for d in (16, 64, 256, 257) for p in (0.0, 0.1)]
    for args in grid:
        assert tflash.flash_supported(*args) == jflash.flash_supported(*args), args


def test_flash_available_is_cuda_only():
    assert not tflash.flash_available("cpu")
    assert tflash.flash_available(torch.device("cuda", 0))


@pytest.mark.parametrize("bad", ["mask_shape", "bias_dtype", "bias_rows", "causal_cross", "dtype",
                                 "want_ds_shared", "dbias_per_bh", "lse_shape"])
def test_wrappers_reject_bad_inputs(bad):
    B, T = 2, 16
    q = torch.zeros(B, T, H * D)
    lse = torch.zeros(B, H, T)
    bias = torch.zeros(H, T, T, dtype=torch.bfloat16)
    mask = torch.ones(B, 1, T, dtype=torch.int8)
    k = q.clone()
    causal = False
    call = "fwd"
    if bad == "mask_shape":
        mask = torch.ones(B, T, dtype=torch.int8)
    elif bad == "bias_dtype":
        bias = bias.float()
    elif bad == "bias_rows":
        bias = torch.zeros(3, T, T, dtype=torch.bfloat16)
    elif bad == "causal_cross":
        k, causal = torch.zeros(B, T + 1, H * D), True
        mask = torch.ones(B, 1, T + 1, dtype=torch.int8)
        bias = None
    elif bad == "dtype":
        q, k = q.double(), k.double()
    elif bad == "want_ds_shared":
        call = "dq"
    elif bad == "dbias_per_bh":
        bias, call = torch.zeros(B * H, T, T, dtype=torch.bfloat16), "dbias"
    else:
        lse, call = torch.zeros(B, H, T, 1), "dkv"
    with pytest.raises((TypeError, ValueError)):
        if call == "fwd":
            tflash.flash_attention_fwd(q, k, k.clone(), bias, mask, H, SCALE, causal)
        else:
            args = (q, k, k.clone(), q.clone(), lse, torch.zeros(B, H, T), bias, mask, H, SCALE,
                    causal)
            if call == "dq":
                tflash.flash_attention_bwd_dq(*args, want_ds=True)
            elif call == "dkv":
                tflash.flash_attention_bwd_dkv(*args)
            else:
                tflash.flash_attention_bwd_dbias(*args)
