"""Kernel B1 (dense whole-row attention forward) in ofasys_torch against
ofasys_tpu's Pallas kernel.

On the CPU the port's ``dense_attention`` runs the kernel's plain version
(``dense_attention_fwd_reference``); the JAX side runs the Pallas kernel in
interpret mode, as tests/test_pallas_dense_attention.py does. Inputs come
from a numpy seed and go to both frameworks as the same arrays.

Tolerances: fp32 atol 1e-5 (the two sides normalize p before or after p·V);
bf16 outputs atol 2e-2 (p is rounded to bf16 at a different point: the
Pallas kernel rounds the unnormalized p, the plain version the normalized
one); lse atol 1e-5 in fp32 and 1e-4 in bf16 (fp32 sums of the same bf16
products in another order). Every test mask keeps key 0, and causal cases
keep Tq <= Tk, so no query row is fully masked.

The CUDA kernel itself is held against its plain version on the card by
tests/test_torch_kernels_cuda.py and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu.ops import pallas_dense_attention as jdense
from ofasys_torch.ops import dense_attention as tdense

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
OUT_ATOL = {"fp32": 1e-5, "bf16": 2e-2}
LSE_ATOL = {"fp32": 1e-5, "bf16": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, Tq, Tk, H, D, with_bias, with_mask, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((1, H, Tq, Tk))).astype(np.float32) if with_bias else None
    mask = None
    if with_mask:
        keep = rng.random((B, Tk)) > 0.25
        keep[:, 0] = True
        mask = keep[:, None, None, :]
    return q, k, v, bias, mask


def _jax(a, dt):
    return None if a is None else jnp.asarray(a).astype(dt) if a.dtype != bool else jnp.asarray(a)


def _torch(a, dt):
    return None if a is None else torch.from_numpy(a).to(dt) if a.dtype != bool else torch.from_numpy(a)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("shape", [(2, 40, 40), (2, 24, 72)], ids=["square", "cross"])
def test_dense_attention_matches_pallas(dtype, causal, with_bias, with_mask, shape):
    B, Tq, Tk = shape
    H, D = 4, 32
    jdt, tdt = DTYPES[dtype]
    q, k, v, bias, mask = _inputs(B, Tq, Tk, H, D, with_bias, with_mask)
    ref = jdense.dense_attention(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt), bias=_jax(bias, jnp.float32),
                                 mask=_jax(mask, None), scale=0.125, causal=causal)
    out = tdense.dense_attention(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt),
                                 bias=_torch(bias, torch.float32), mask=_torch(mask, None),
                                 scale=0.125, causal=causal)
    assert out.dtype == tdt and tuple(out.shape) == (B, Tq, H, D)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0, atol=OUT_ATOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_fwd_lse_matches_fwd_call(dtype, with_bias, with_mask):
    """The lse the port returns (and B2 will need) equals _fwd_call's."""
    B, Tq, Tk, H, D = 2, 32, 48, 4, 32
    jdt, tdt = DTYPES[dtype]
    q, k, v, bias, mask = _inputs(B, Tq, Tk, H, D, with_bias, with_mask, seed=1)
    E = H * D
    q3, k3, v3 = (a.reshape(a.shape[0], a.shape[1], E) for a in (q, k, v))
    bf = None if bias is None else bias[0]
    mf = None if mask is None else mask.reshape(B, 1, Tk).astype(np.int8)
    jout, jlse = jdense._fwd_call(
        _jax(q3, jdt), _jax(k3, jdt), _jax(v3, jdt),
        None if bf is None else jnp.asarray(bf).astype(jnp.bfloat16),
        None if mf is None else jnp.asarray(mf), 1.0, False, H,
    )
    tout, tlse = tdense.dense_attention_fwd(
        _torch(q3, tdt), _torch(k3, tdt), _torch(v3, tdt),
        None if bf is None else torch.from_numpy(bf).to(torch.bfloat16),
        None if mf is None else torch.from_numpy(mf), H,
    )
    assert tuple(tlse.shape) == (B, H, Tq) and tlse.dtype == torch.float32
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[..., 0], rtol=0, atol=LSE_ATOL[dtype])
    np.testing.assert_allclose(_f32(tout), _f32(jout), rtol=0, atol=OUT_ATOL[dtype])


@pytest.mark.parametrize("B,Tq,Tk,D,H,dropout", [
    (4, 64, 64, 64, 12, 0.0), (1, 128, 128, 64, 12, 0.0), (2, 128, 128, 64, 12, 0.0),
    (8, 256, 256, 64, 12, 0.0), (8, 257, 257, 64, 12, 0.0), (8, 24, 300, 64, 12, 0.0),
    (16, 32, 32, 512, 4, 0.0), (16, 32, 32, 256, 32, 0.0), (8, 64, 64, 64, 12, 0.1),
])
def test_dense_supported_matches(B, Tq, Tk, D, H, dropout):
    assert tdense.dense_supported(B, Tq, Tk, D, H, dropout) == \
        jdense.dense_supported(B, Tq, Tk, D, H, dropout)


@pytest.mark.parametrize("bad", ["dtype", "bias_shape", "mask_dtype", "too_long", "noncontig"])
def test_wrapper_rejects_bad_inputs(bad):
    B, T, H, D = 2, 16, 2, 8
    q = torch.zeros(B, T, H * D)
    k = torch.zeros(B, T, H * D)
    bias = mask = None
    if bad == "dtype":
        q = q.half()
    elif bad == "bias_shape":
        bias = torch.zeros(H, T, T + 1, dtype=torch.bfloat16)
    elif bad == "mask_dtype":
        mask = torch.ones(B, 1, T, dtype=torch.bool)
    elif bad == "too_long":
        q = k = torch.zeros(B, 300, H * D)
    elif bad == "noncontig":
        q = torch.zeros(B, H * D, T).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        tdense.dense_attention_fwd(q, k, k.clone(), bias, mask, H)
