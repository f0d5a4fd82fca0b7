"""The CUDA kernels of ofasys_torch against their plain PyTorch versions,
on the card. A CUDA kernel has no CPU mode: without a card these tests skip.

This file imports no JAX, so it also runs on a GPU machine without it:
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
Tolerances (bf16), for q scaled as the model scales it:
  * B1: out atol 2e-2 (p is rounded to bf16 before p.V at a different
    point), lse atol 1e-3 (fp32 sums in another order);
  * B2: dq, dk, dv within 2e-2 of the largest entry (bf16 outputs; p and ds
    are rounded to bf16 before their products on both sides, and a value on
    a rounding boundary can round either way after a reordered fp32 sum);
    dbias, an fp32 batch sum of unrounded ds, within 1e-3 of its largest
    entry.
"""

import pytest
import torch

from ofasys_torch.ops import dense_attention as tdense

SHAPES = [(8, 128, 128, 12, 64), (3, 24, 200, 4, 64), (1, 64, 64, 12, 64), (4, 190, 190, 12, 64)]
IDS = ["serving", "cross", "B1", "gigaword_encoder"]


def _inputs(B, Tq, Tk, H, D):
    g = torch.Generator(device="cuda").manual_seed(0)
    # q arrives pre-scaled, as the wrapper receives it (D ** -0.5)
    q = (torch.randn(B, Tq, H * D, device="cuda", generator=g) * D ** -0.5).to(torch.bfloat16)
    k = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    v = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    bias = torch.randn(H, Tq, Tk, device="cuda", generator=g).to(torch.bfloat16)
    mask = (torch.rand(B, 1, Tk, device="cuda", generator=g) > 0.25).to(torch.int8)
    mask[:, :, 0] = 1
    do = torch.randn(B, Tq, H * D, device="cuda", generator=g).to(torch.bfloat16)
    return q, k, v, bias, mask, do


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES[:2], ids=IDS[:2])
def test_kernel_matches_plain_version_on_card(shape):
    _need_card()
    B, Tq, Tk, H, D = shape
    q, k, v, bias, mask, _ = _inputs(B, Tq, Tk, H, D)
    before = tdense.dense_attention_fwd.launches
    out, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H)
    torch.cuda.synchronize()
    assert tdense.dense_attention_fwd.launches == before + 1
    ref, ref_lse = tdense.dense_attention_fwd_reference(q, k, v, bias, mask, H)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bwd_kernel_matches_plain_version_on_card(shape, with_bias):
    _need_card()
    B, Tq, Tk, H, D = shape
    q, k, v, bias, mask, do = _inputs(B, Tq, Tk, H, D)
    bias = bias if with_bias else None
    _, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H)
    before = tdense.dense_attention_bwd.launches
    got = tdense.dense_attention_bwd(q, k, v, do, lse, bias, mask, H)
    torch.cuda.synchronize()
    assert tdense.dense_attention_bwd.launches == before + 1
    ref = tdense.dense_attention_bwd_reference(q, k, v, do, lse, bias, mask, H)
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert a.dtype == torch.bfloat16
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, b.float().abs().max().item()), (name, err)
    if with_bias:
        err = (got[3] - ref[3]).abs().max().item()
        assert err <= 1e-3 * max(1.0, ref[3].abs().max().item()), ("dbias", err)
    else:
        assert got[3] is None


@pytest.mark.cuda
def test_autograd_function_runs_both_kernels_on_card():
    _need_card()
    B, T, H, D = 4, 96, 12, 64
    q, k, v, _, mask, do = _inputs(B, T, T, H, D)
    q4, k4, v4 = (t.view(B, T, H, D).clone().requires_grad_() for t in (q, k, v))
    bias = torch.randn(1, H, T, T, device="cuda", requires_grad=True)
    f0, b0 = tdense.dense_attention_fwd.launches, tdense.dense_attention_bwd.launches
    out = tdense.dense_attention(q4, k4, v4, bias=bias, mask=mask.bool()[:, :, None, :],
                                 scale=D ** -0.5, causal=True)
    out.backward(do.view(B, T, H, D))
    torch.cuda.synchronize()
    assert tdense.dense_attention_fwd.launches == f0 + 1
    assert tdense.dense_attention_bwd.launches == b0 + 1
    assert all(torch.isfinite(t.grad.float()).all() for t in (q4, k4, v4, bias))
