"""The CUDA kernels of ofasys_torch against their plain PyTorch versions,
on the card. A CUDA kernel has no CPU mode: without a card these tests skip.

This file imports no JAX, so it also runs on a GPU machine without it:
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
Tolerances (bf16): out atol 2e-2 (p is rounded to bf16 before p.V at a
different point), lse atol 1e-3 (fp32 sums in another order), for q scaled
as the model scales it.
"""

import pytest
import torch

from ofasys_torch.ops import dense_attention as tdense


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 128, 128, 12, 64), (3, 24, 200, 4, 64)], ids=["serving", "cross"])
def test_kernel_matches_plain_version_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    B, Tq, Tk, H, D = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    # q arrives pre-scaled, as the wrapper receives it (D ** -0.5)
    q = (torch.randn(B, Tq, H * D, device="cuda", generator=g) * D ** -0.5).to(torch.bfloat16)
    k = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    v = torch.randn(B, Tk, H * D, device="cuda", generator=g).to(torch.bfloat16)
    bias = torch.randn(H, Tq, Tk, device="cuda", generator=g).to(torch.bfloat16)
    mask = (torch.rand(B, 1, Tk, device="cuda", generator=g) > 0.25).to(torch.int8)
    mask[:, :, 0] = 1
    before = tdense.dense_attention_fwd.launches
    out, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H)
    torch.cuda.synchronize()
    assert tdense.dense_attention_fwd.launches == before + 1
    ref, ref_lse = tdense.dense_attention_fwd_reference(q, k, v, bias, mask, H)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
