"""Plain attention of ofasys_torch (ops/attention.py) against ofasys_tpu's.

Same numpy inputs to both frameworks; both ``logits_dtype`` policies
(fp32 scores, and scores rounded to the compute dtype before the fp32
softmax). Tolerances: fp32 atol 1e-5; bf16 atol 2e-2 (a score one fp32 ulp
apart in the two frameworks can round to neighbouring bf16 values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu.ops import attention as jatt
from ofasys_torch.ops import attention as tatt

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
ATOL = {"fp32": 1e-5, "bf16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("logits", ["fp32", "compute"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 16), (2, 8, 24)], ids=["square", "cross"])
def test_dot_product_attention_matches(dtype, logits, with_bias, with_mask, causal, shape):
    B, Tq, Tk = shape
    H, D = 4, 16
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, H, D)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((1, H, Tq, Tk))).astype(np.float32) if with_bias else None
    keep = None
    if with_mask:
        keep = rng.random((B, Tk)) > 0.25
        keep[:, 0] = True
        keep = keep[:, None, None, :]
    jmask = jatt.combine_masks(None if keep is None else jnp.asarray(keep),
                               jatt.causal_mask(Tq, Tk) if causal else None)
    tmask = tatt.combine_masks(None if keep is None else torch.from_numpy(keep),
                               tatt.causal_mask(Tq, Tk) if causal else None)
    ref = jatt.dot_product_attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt),
        bias=None if bias is None else jnp.asarray(bias), mask=jmask, scale=0.25,
        dtype=jdt, logits_dtype=jdt if logits == "compute" else None,
    )
    out = tatt.dot_product_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
        bias=None if bias is None else torch.from_numpy(bias), mask=tmask, scale=0.25,
        dtype=tdt, logits_dtype=tdt if logits == "compute" else None,
    )
    assert out.dtype == tdt and tuple(out.shape) == (B, Tq, H, D)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("tq,tk", [(1, 1), (4, 4), (1, 9), (3, 7)])
def test_causal_mask_matches(tq, tk):
    np.testing.assert_array_equal(tatt.causal_mask(tq, tk).numpy(), np.asarray(jatt.causal_mask(tq, tk)))


def test_combine_masks_matches():
    rng = np.random.default_rng(3)
    a, b = rng.random((2, 1, 1, 5)) > 0.5, rng.random((1, 1, 5, 5)) > 0.5
    assert tatt.combine_masks(None, None) is None
    np.testing.assert_array_equal(
        tatt.combine_masks(torch.from_numpy(a), None, torch.from_numpy(b)).numpy(),
        np.asarray(jatt.combine_masks(jnp.asarray(a), None, jnp.asarray(b))),
    )
    assert tatt.MASK_VALUE == jatt.MASK_VALUE == -1e9
