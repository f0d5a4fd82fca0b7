"""The CUDA kernels of ofasys_torch against their plain PyTorch versions,
on the card. A CUDA kernel has no CPU mode: without a card these tests skip.

This file imports no JAX, so it also runs on a GPU machine without it:
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
Tolerances (bf16), for q scaled as the model scales it:
  * B1: out atol 2e-2 (p is rounded to bf16 before p.V at a different
    point), lse atol 1e-3 (fp32 sums in another order);
  * B2 and the flash backward (the one pass for B4 and B5): each gradient held to the
    reference's own size, relative Frobenius error and max error over
    max|ref|. dq, dk, dv are bf16 outputs that both sides round at the same
    points (p and ds to bf16 before their products), so they differ only
    where a reordered fp32 sum crosses a rounding boundary: GRAD_TOL, 1e-3
    Frobenius and 1e-2 max (2.5 bf16 ulps of the largest entry). dbias and
    ds are fp32 sums of unrounded ds: DS_TOL, 1e-3 on both;
  * B2r (row-major backward) and B1 with ``scale`` and ``causal`` inside:
    as B2 and B1, q unscaled and the scale given to the kernel; B2 and B2r
    give the same bits run to run (partial sums reduced in a fixed order);
  * fp32 tensors (B1's, B2's and B2r's CUDA-core kernels): 1e-4 on every measure;
  * B3 (flash attention): as B1, the same bits run to run;
  * B7 (int8 GEMM): equal to its plain version bit for bit (an exact
    integer product and the same two fp32 products), at every plan
    (``int8_plan``: small M, large M, each cluster size, the __dp4a kernel);
  * B6 (LayerNorm), bf16: y within one bf16 ulp (|y - ref| <= 2^-7 |ref| +
    1e-3), mu and rstd rtol 1e-5 (fp32 row sums in another order); dx as
    GRAD_TOL; dg and db, fp32 sums over the rows in another order, within
    LN_SUM_TOL (1e-4 on both measures), which a dg that skipped one row of
    the chunk, or a reduction that skipped one block's partial, fails;
    B6-bwd gives the same bits run to run, at every plan (``ln_bwd_plan``:
    dg and db in registers or in shared memory, the two-walk kernel).
"""

import numpy as np
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


def _grad_close(got, ref, tol):
    """Relative Frobenius error and max error over max|ref|, both <= tol."""
    got, ref = got.float(), ref.float()
    frob = ((got - ref).norm() / ref.norm()).item()
    rel_max = ((got - ref).abs().max() / ref.abs().max()).item()
    return bool(torch.isfinite(got).all()) and frob <= tol[0] and rel_max <= tol[1], (frob, rel_max)


GRAD_TOL = (1e-3, 1e-2)
DS_TOL = (1e-3, 1e-3)


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
        ok, errs = _grad_close(a, b, GRAD_TOL)
        assert ok, (name, errs)
    if with_bias:
        ok, errs = _grad_close(got[3], ref[3], DS_TOL)
        assert ok, ("dbias", errs)
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


# ----------------------------- B2r and B1 with scale and causal inside
# (B, Tq, Tk, H, D, causal): the caption encoder, its causal decoder and its
# cross attention, the vqa encoder, a causal call with Tq < Tk (the causal
# offset), a batch of one and a head dim that is no multiple of 32
ROWMAJOR_CASES = [(64, 196, 196, 12, 64, False), (64, 24, 24, 12, 64, True),
                  (64, 24, 196, 12, 64, False), (48, 214, 214, 12, 64, False),
                  (5, 40, 72, 4, 64, True), (1, 64, 64, 12, 64, True), (3, 50, 50, 4, 40, True)]
ROWMAJOR_IDS = ["caption_encoder", "caption_decoder_causal", "caption_cross", "vqa_encoder",
                "causal_offset", "B1_causal", "D40_causal"]


def _rowmajor_inputs(B, Tq, Tk, H, D):
    q, k, v, bias, mask, do = _inputs(B, Tq, Tk, H, D)
    return (q.float() * D ** 0.5).to(torch.bfloat16), k, v, bias, mask, do, D ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROWMAJOR_CASES, ids=ROWMAJOR_IDS)
def test_fwd_kernel_with_scale_and_causal_on_card(case):
    _need_card()
    B, Tq, Tk, H, D, causal = case
    q, k, v, bias, mask, _, scale = _rowmajor_inputs(B, Tq, Tk, H, D)
    out, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H, scale, causal)
    torch.cuda.synchronize()
    ref, ref_lse = tdense.dense_attention_fwd_reference(q, k, v, bias, mask, H, scale, causal)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("case", ROWMAJOR_CASES, ids=ROWMAJOR_IDS)
def test_rowmajor_bwd_kernel_matches_plain_version_on_card(case, with_bias):
    _need_card()
    B, Tq, Tk, H, D, causal = case
    q, k, v, bias, mask, do, scale = _rowmajor_inputs(B, Tq, Tk, H, D)
    bias = bias if with_bias else None
    _, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H, scale, causal)
    before = tdense.dense_attention_bwd_rowmajor.launches
    got = tdense.dense_attention_bwd_rowmajor(q, k, v, do, lse, bias, mask, H, scale, causal)
    torch.cuda.synchronize()
    assert tdense.dense_attention_bwd_rowmajor.launches == before + 1
    ref = tdense.dense_attention_bwd_rowmajor_reference(q, k, v, do, lse, bias, mask, H, scale, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert a.dtype == torch.bfloat16
        ok, errs = _grad_close(a, b, GRAD_TOL)
        assert ok, (name, errs)
    if with_bias:
        ok, errs = _grad_close(got[3], ref[3], DS_TOL)
        assert ok, ("dbias", errs)
        again = tdense.dense_attention_bwd_rowmajor(q, k, v, do, lse, bias, mask, H, scale, causal)
        assert all(torch.equal(a, b) for a, b in zip(got, again))     # the same bits run to run
    else:
        assert got[3] is None


@pytest.mark.cuda
def test_bwd_kernel_with_scale_inside_on_card():
    """B2 with the scale inside (a non-causal ``_dense_attention`` call with
    scale != 1) against its plain version and against B2r."""
    _need_card()
    B, Tq, Tk, H, D = 4, 96, 130, 12, 64
    q, k, v, bias, mask, do, scale = _rowmajor_inputs(B, Tq, Tk, H, D)
    _, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H, scale)
    got = tdense.dense_attention_bwd(q, k, v, do, lse, bias, mask, H, scale=scale)
    row = tdense.dense_attention_bwd_rowmajor(q, k, v, do, lse, bias, mask, H, scale, False)
    ref = tdense.dense_attention_bwd_reference(q, k, v, do, lse, bias, mask, H, scale=scale)
    for name, a, r, b in zip(("dq", "dk", "dv", "dbias"), got, row, ref):
        tol = DS_TOL if name == "dbias" else GRAD_TOL
        for which, x in (("B2", a), ("B2r", r)):
            ok, errs = _grad_close(x, b, tol)
            assert ok, (which, name, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("rowmajor", [False, True], ids=["default", "OFASYS_DENSE_BWD=rowmajor"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dense_attention_entry_chooses_its_backward_on_card(monkeypatch, causal, rowmajor):
    """``_dense_attention``: B2r for a causal call and under the switch, else B2."""
    _need_card()
    if rowmajor:
        monkeypatch.setenv("OFASYS_DENSE_BWD", "rowmajor")
    else:
        monkeypatch.delenv("OFASYS_DENSE_BWD", raising=False)
    B, Tq, Tk, H, D = 4, 48, 80, 12, 64
    q, k, v, bias, mask, do, scale = _rowmajor_inputs(B, Tq, Tk, H, D)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    bias = bias.clone().requires_grad_()
    counts = [f.launches for f in (tdense.dense_attention_fwd, tdense.dense_attention_bwd,
                                   tdense.dense_attention_bwd_rowmajor)]
    out = tdense._dense_attention(*leaves, bias, mask, scale, causal, H)
    out.backward(do)
    torch.cuda.synchronize()
    now = [f.launches for f in (tdense.dense_attention_fwd, tdense.dense_attention_bwd,
                                tdense.dense_attention_bwd_rowmajor)]
    use_row = causal or rowmajor
    assert [b - a for a, b in zip(counts, now)] == [1, int(not use_row), int(use_row)]
    _, lse = tdense.dense_attention_fwd_reference(q, k, v, bias.detach(), mask, H, scale, causal)
    ref = tdense.dense_attention_bwd_rowmajor_reference(q, k, v, do, lse, bias.detach(), mask, H,
                                                       scale, causal)
    for name, t, b in zip(("dq", "dk", "dv"), leaves, ref[:3]):
        ok, errs = _grad_close(t.grad, b, GRAD_TOL)
        assert ok, (name, errs)
    assert bias.grad.dtype == torch.bfloat16
    ok, errs = _grad_close(bias.grad, ref[3], (2.0 ** -8, 2.0 ** -7))     # rounded to the bias's bf16
    assert ok, ("dbias", errs)


# (B, Tq, Tk, H, D, causal): the head dims where the dk/dv sums of a whole
# (b, h) do not fit a block, so the keys are split into ranges with dq
# partials (D = 128 at Tk = 256; the 10b arch's D = 88 at Tk = 255)
WIDE_ROWMAJOR = [(2, 256, 256, 2, 128, False), (2, 256, 256, 2, 128, True),
                 (2, 255, 255, 2, 88, False), (2, 200, 255, 2, 88, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_ROWMAJOR, ids=["D128", "D128_causal", "D88_Tk255",
                                                     "D88_Tk255_causal"])
def test_rowmajor_splits_keys_at_wide_heads_on_card(case):
    """B2r at shapes whose accumulators exceed one block's 227 KB: it runs
    (key ranges, dq partials summed in order) and matches its plain version
    within GRAD_TOL and DS_TOL, the same bits twice."""
    _need_card()
    B, Tq, Tk, H, D, causal = case
    q, k, v, bias, mask, do, scale = _rowmajor_inputs(B, Tq, Tk, H, D)
    _, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H, scale, causal)
    got = tdense.dense_attention_bwd_rowmajor(q, k, v, do, lse, bias, mask, H, scale, causal)
    torch.cuda.synchronize()
    ref = tdense.dense_attention_bwd_rowmajor_reference(q, k, v, do, lse, bias, mask, H, scale, causal)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        ok, errs = _grad_close(a, b, DS_TOL if name == "dbias" else GRAD_TOL)
        assert ok, (name, errs)
    again = tdense.dense_attention_bwd_rowmajor(q, k, v, do, lse, bias, mask, H, scale, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# (B, Tq, Tk, H, D, causal): B2r (bf16, B2's tensor-core kernel with the
# causal mask inside) at the caption and text_infilling encoders, the causal
# offset (Tq < Tk) and a wide head whose keys are split into ranges
ROWMAJOR_TC = [(64, 228, 228, 12, 64, False), (128, 96, 96, 12, 64, False), (5, 40, 72, 12, 64, True),
               (2, 256, 256, 2, 128, False), (2, 256, 256, 2, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROWMAJOR_TC, ids=["caption_encoder", "infill_encoder", "causal_offset",
                                                   "D128_ranges", "D128_ranges_causal"])
def test_rowmajor_bwd_on_tensor_cores_on_card(case):
    """B2r within GRAD_TOL and DS_TOL of its plain version, the same bits
    twice, and with keys 64-127 left out (a skipped key tile) outside those
    limits on every gradient. Without causal it is B2's kernel: the same
    bits as B2."""
    _need_card()
    B, Tq, Tk, H, D, causal = case
    q, k, v, bias, mask, do, scale = _rowmajor_inputs(B, Tq, Tk, H, D)
    _, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H, scale, causal)
    got = tdense.dense_attention_bwd_rowmajor(q, k, v, do, lse, bias, mask, H, scale, causal)
    torch.cuda.synchronize()
    ref = tdense.dense_attention_bwd_rowmajor_reference(q, k, v, do, lse, bias, mask, H, scale, causal)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        ok, errs = _grad_close(a, b, DS_TOL if name == "dbias" else GRAD_TOL)
        assert ok, (name, errs)
    again = tdense.dense_attention_bwd_rowmajor(q, k, v, do, lse, bias, mask, H, scale, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    hidden = mask.clone()
    hidden[:, :, 64:128] = 0
    fault = tdense.dense_attention_bwd_rowmajor(q, k, v, do, lse, bias, hidden, H, scale, causal)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), fault, ref):
        assert not _grad_close(a, b, DS_TOL if name == "dbias" else GRAD_TOL)[0], name
    if not causal:
        b2 = tdense.dense_attention_bwd(q, k, v, do, lse, bias, mask, H, scale=scale)
        assert all(torch.equal(a, b) for a, b in zip(got, b2))


# ------------------------------------- B1 and B2 on the tensor cores (bf16)
# (B, Tq, Tk, H, D): head dims that are no multiple of 16 (88) or take more
# shared memory (128, 256: B2 splits the keys into ranges there), ragged
# Tq != Tk, a batch of one and Tk = 256
TC_SHAPES = [(4, 96, 96, 8, 88), (2, 150, 256, 4, 128), (2, 64, 100, 2, 256), (3, 40, 200, 12, 64),
             (1, 64, 64, 12, 64), (2, 256, 256, 12, 64), (3, 21, 37, 4, 40)]
TC_IDS = ["D88", "D128_Tk256", "D256", "ragged_cross", "B1", "T256", "D40_ragged"]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", TC_SHAPES, ids=TC_IDS)
def test_fwd_kernel_at_wide_heads_and_ragged_shapes_on_card(shape, causal):
    """B1 (bf16, tensor cores) against its plain version: out atol 2e-2,
    lse atol 1e-3, with the scale and (when asked) the causal mask inside."""
    _need_card()
    B, Tq, Tk, H, D = shape
    q, k, v, bias, mask, _, scale = _rowmajor_inputs(B, Tq, Tk, H, D)
    out, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H, scale, causal)
    torch.cuda.synchronize()
    ref, ref_lse = tdense.dense_attention_fwd_reference(q, k, v, bias, mask, H, scale, causal)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TC_SHAPES, ids=TC_IDS)
def test_bwd_kernel_at_wide_heads_and_ragged_shapes_on_card(shape):
    """B2 (bf16, tensor cores) against its plain version within GRAD_TOL and
    DS_TOL, with the scale inside; the same bits twice (no atomics)."""
    _need_card()
    B, Tq, Tk, H, D = shape
    q, k, v, bias, mask, do, scale = _rowmajor_inputs(B, Tq, Tk, H, D)
    _, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H, scale)
    got = tdense.dense_attention_bwd(q, k, v, do, lse, bias, mask, H, scale=scale)
    torch.cuda.synchronize()
    ref = tdense.dense_attention_bwd_reference(q, k, v, do, lse, bias, mask, H, scale=scale)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        ok, errs = _grad_close(a, b, DS_TOL if name == "dbias" else GRAD_TOL)
        assert ok, (name, errs)
    again = tdense.dense_attention_bwd(q, k, v, do, lse, bias, mask, H, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_fp32_tensors_take_the_cuda_core_kernels_on_card():
    """fp32 CUDA tensors (off the model's path) run B1's, B2's and B2r's
    fp32 kernels, counted in the same launches, within fp32 tolerances."""
    _need_card()
    B, Tq, Tk, H, D = 3, 40, 72, 4, 64
    q, k, v, bias, mask, do = (t.float() if t.dtype == torch.bfloat16 else t
                               for t in _inputs(B, Tq, Tk, H, D))
    bias = bias.to(torch.bfloat16)
    f0, b0 = tdense.dense_attention_fwd.launches, tdense.dense_attention_bwd.launches
    out, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H)
    got = tdense.dense_attention_bwd(q, k, v, do, lse, bias, mask, H)
    torch.cuda.synchronize()
    assert (tdense.dense_attention_fwd.launches - f0, tdense.dense_attention_bwd.launches - b0) == (1, 1)
    ref, ref_lse = tdense.dense_attention_fwd_reference(q, k, v, bias, mask, H)
    assert out.dtype == torch.float32 and (out - ref).abs().max().item() <= 1e-4
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got,
                          tdense.dense_attention_bwd_reference(q, k, v, do, lse, bias, mask, H)):
        ok, errs = _grad_close(a, b, (1e-4, 1e-4))
        assert ok, (name, errs)
    # B2r's fp32 kernel, with the scale and the causal mask inside
    _, lse = tdense.dense_attention_fwd(q, k, v, bias, mask, H, 0.5, True)
    got = tdense.dense_attention_bwd_rowmajor(q, k, v, do, lse, bias, mask, H, 0.5, True)
    ref = tdense.dense_attention_bwd_rowmajor_reference(q, k, v, do, lse, bias, mask, H, 0.5, True)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert a.dtype == torch.float32
        ok, errs = _grad_close(a, b, (1e-4, 1e-4))
        assert ok, ("B2r", name, errs)


# ------------------------------------------------- flash attention (B3-B5)
# (B, Tq, Tk, H, D, bias, causal): a ragged key tail (333 keys, tiles of 64),
# the causal tile skip, a short query tile against 1,000 keys (the decoder's
# cross attention), a per-(b, h) bias (ds from the dq kernel), and head dims
# that take the kernels' other instantiations (80 -> tiles for D <= 128,
# 160 -> D <= 256).
FLASH_SHAPES = {
    "ragged": (2, 300, 333, 12, 64, "shared", False),
    "causal": (2, 320, 320, 12, 64, "shared", True),
    "cross": (3, 62, 1000, 12, 64, "shared", False),
    "per_bh_causal": (2, 257, 257, 4, 64, "per_bh", True),
    "no_bias": (2, 300, 300, 4, 64, None, False),
    "d80": (2, 260, 270, 4, 80, "shared", False),
    "d160": (1, 290, 290, 2, 160, "shared", True),
    # the long paths' flash calls (train_long, H = 12, D = 64)
    "gigaword_long_encoder": (16, 1000, 1000, 12, 64, "shared", False),
    "gigaword_long_cross": (16, 64, 1000, 12, 64, "shared", False),
    "infill_long_encoder": (16, 488, 488, 12, 64, "shared", False),
    "infill_long_decoder_causal": (16, 528, 528, 12, 64, "shared", True),
    # head dims the backward takes in 112- and 48-key ranges, a batch of
    # one (its bias counts as per-(b, h): ds), and T = 4,096, where the dq
    # partials pass SCRATCH_CAP and the samples go one at a time
    "D88": (2, 300, 333, 32, 88, "shared", False),
    "D128_per_bh": (2, 300, 300, 8, 128, "per_bh", False),
    "D256_causal": (2, 290, 290, 4, 256, "shared", True),
    "B1": (1, 1000, 1000, 12, 64, "shared", False),
    "long_T4096": (2, 4096, 4096, 12, 64, "shared", False),
}


def _flash_inputs(B, Tq, Tk, H, D, bias_kind):
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(B, T, H * D, device="cuda", generator=g).to(torch.bfloat16)
                   for T in (Tq, Tk, Tk, Tq))
    nb = {"shared": H, "per_bh": B * H, None: 0}[bias_kind]
    bias = torch.randn(nb, Tq, Tk, device="cuda", generator=g).to(torch.bfloat16) if nb else None
    mask = (torch.rand(B, 1, Tk, device="cuda", generator=g) > 0.25).to(torch.int8)
    mask[:, :, 0] = 1
    return q, k, v, do, bias, mask


def _flash_bwd_args(case, g_lse=False):
    """The backward's arguments at one FLASH_SHAPES case: the forward's lse
    and dd = rowsum(do * out) from its bf16 output, minus a random lse
    cotangent with ``g_lse`` (as FlashAttentionFunction.backward forms it)."""
    from ofasys_torch.ops import flash_attention as tflash

    B, Tq, Tk, H, D, bias_kind, causal = FLASH_SHAPES[case]
    q, k, v, do, bias, mask = _flash_inputs(B, Tq, Tk, H, D, bias_kind)
    scale = (2 * D) ** -0.5
    out, lse = tflash.flash_attention_fwd(q, k, v, bias, mask, H, scale, causal)
    dd = (do.float() * out.float()).reshape(B, Tq, H, D).sum(-1).permute(0, 2, 1)
    if g_lse:
        g = torch.Generator(device="cuda").manual_seed(4)
        dd = dd - torch.randn(B, H, Tq, device="cuda", generator=g) * 0.5
    return (q, k, v, do, lse, dd.contiguous(), bias, mask, H, scale, causal), out


def _check_flash_grads(got, ref, bias_kind):
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert a.dtype == torch.bfloat16
        ok, errs = _grad_close(a, b, GRAD_TOL)
        assert ok, (name, errs)
    if bias_kind is None:
        assert got[3] is None and ref[3] is None
    else:
        assert got[3].dtype == torch.float32 and got[3].shape == ref[3].shape
        ok, errs = _grad_close(got[3], ref[3], DS_TOL)
        assert ok, ("dbias", errs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_SHAPES))
def test_flash_kernels_match_plain_versions_on_card(case):
    """B3: out atol 2e-2 (bf16 output; p is rounded to bf16 against the
    running max of its tile in the kernel, the row max in the plain
    version), lse atol 1e-3 (fp32 sums in another order). The one backward
    pass: dq, dk, dv (bf16 outputs of sums of rounded p and ds) within
    GRAD_TOL of the reference; the shared bias's gradient and the per-(b, h)
    ds (fp32 sums of unrounded ds) within DS_TOL; the same bits twice; the
    part wrappers (B4-dq, B4-dkv, B5) return its parts and launch nothing of
    their own. The same pass fed dd = 0 (a kernel that dropped it) must fail
    those limits on dq, dk and the bias gradient."""
    _need_card()
    from ofasys_torch.ops import flash_attention as tflash

    B, Tq, Tk, H, D, bias_kind, causal = FLASH_SHAPES[case]
    counts = (tflash.flash_attention_fwd.launches, tflash.flash_attention_bwd.launches)
    args, out = _flash_bwd_args(case)
    q, k, v, do, lse, dd, bias, mask, _, scale, _ = args
    torch.cuda.synchronize()
    ref, ref_lse = tflash.flash_attention_fwd_reference(q, k, v, bias, mask, H, scale, causal)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3

    got = tflash.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    assert (tflash.flash_attention_fwd.launches - counts[0],
            tflash.flash_attention_bwd.launches - counts[1]) == (1, 1)
    ref = tflash.flash_attention_bwd_reference(*args)
    _check_flash_grads(got, ref, bias_kind)
    again = tflash.flash_attention_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)

    # the part wrappers: one pass each, counted under flash_attention_bwd
    before = tflash.flash_attention_bwd.launches
    dq1, ds1 = tflash.flash_attention_bwd_dq(*args, want_ds=bias_kind == "per_bh" or B == 1)
    dk1, dv1 = tflash.flash_attention_bwd_dkv(*args)
    assert torch.equal(dq1, got[0]) and torch.equal(dk1, got[1]) and torch.equal(dv1, got[2])
    if bias_kind == "per_bh" or (bias_kind == "shared" and B == 1):
        assert torch.equal(ds1, got[3])
    elif bias_kind == "shared":
        assert torch.equal(tflash.flash_attention_bwd_dbias(*args), got[3])
    assert tflash.flash_attention_bwd.launches - before == 2 + (bias_kind == "shared" and B > 1)

    # a planted fault: dd = 0
    fq, fk, _, fbias = tflash.flash_attention_bwd(*args[:5], torch.zeros_like(dd), *args[6:])
    assert not _grad_close(fq, ref[0], GRAD_TOL)[0] and not _grad_close(fk, ref[1], GRAD_TOL)[0]
    if bias_kind is not None:
        assert not _grad_close(fbias, ref[3], DS_TOL)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "causal", "per_bh_causal", "no_bias"])
def test_flash_bwd_takes_the_lse_cotangent_on_card(case):
    """dd passed in as rowsum(do * out) - g_lse (flash_attention_with_lse's
    cotangent): the pass reads it and does not form its own."""
    _need_card()
    from ofasys_torch.ops import flash_attention as tflash

    args, _ = _flash_bwd_args(case, g_lse=True)
    _check_flash_grads(tflash.flash_attention_bwd(*args),
                       tflash.flash_attention_bwd_reference(*args), FLASH_SHAPES[case][5])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "causal", "per_bh_causal", "D256_causal"])
def test_flash_bwd_scratch_groups_give_the_same_bits_on_card(case, monkeypatch):
    """With SCRATCH_CAP cut so that the samples, and then also the key
    ranges, go in groups, dq, dk, dv and a per-(b, h) ds keep their bits
    (each range's dq partial is the same; the running sum adds them in the
    same order), and a shared bias's gradient (chunk sums in another order)
    stays within DS_TOL."""
    _need_card()
    from ofasys_torch.ops import flash_attention as tflash

    B, Tq, Tk, H, D, bias_kind, causal = FLASH_SHAPES[case]
    args, _ = _flash_bwd_args(case)
    whole = tflash.flash_attention_bwd(*args)
    ref = tflash.flash_attention_bwd_reference(*args)
    plan = tflash.backward_plan(B, H, Tq, Tk, D, bias_kind == "shared")
    assert plan.ranges > 1 and plan.group_samples == B
    slot = Tq * H * D * 4                        # one sample's dq partial of one range
    # one sample's partials; then under two slots: one range a launch
    for cap, group_ranges in ((plan.ranges * slot, plan.ranges), (2 * slot - 4, 1)):
        monkeypatch.setattr(tflash, "SCRATCH_CAP", cap)
        small = tflash.backward_plan(B, H, Tq, Tk, D, bias_kind == "shared", cap=cap)
        assert (small.group_samples, small.group_ranges) == (1, group_ranges)
        got = tflash.flash_attention_bwd(*args)
        for a, b in zip(got[:3], whole[:3]):
            assert torch.equal(a, b)
        if bias_kind == "per_bh":
            assert torch.equal(got[3], whole[3])
        _check_flash_grads(got, ref, bias_kind)


@pytest.mark.cuda
def test_flash_bwd_key_range_rule_matches_the_kernel_on_card(monkeypatch):
    """backward_plan's mirror of the kernel's shared-memory rule gives the
    C entry's largest key range, and the kernel refuses a larger one."""
    _need_card()
    import ctypes

    from ofasys_torch.ops import flash_attention as tflash
    from ofasys_torch.ops.cuda_build import load

    fn = load("flash_attention_bwd").flash_attention_bwd_max_key_range
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    for Tk in (256, 257, 488, 1000, 4096):
        for D in (16, 32, 64, 80, 88, 128, 160, 256):
            assert tflash.max_key_range(Tk, D) == fn(Tk, D), (Tk, D)
    args, _ = _flash_bwd_args("ragged")
    plan = tflash.backward_plan(2, 12, 300, 333, 64, True)
    wide = plan._replace(key_range=tflash.max_key_range(333, 64) + 16)
    monkeypatch.setattr(tflash, "backward_plan", lambda *a, **kw: wide)
    with pytest.raises(RuntimeError):
        tflash.flash_attention_bwd(*args)


# (B, Tq, Tk, H, D, bias, causal): B3 (bf16, tensor cores) at head dims it
# pads (88 -> 96) or takes with its other tiles (128; 256 with 32-key
# tiles), a batch of one at T = 1,000, and ragged Tq != Tk with Tk no
# multiple of the 64-key tile
FLASH_EDGE = {
    "D88_ragged": (2, 200, 333, 8, 88, "shared", False),
    "D128_per_bh": (2, 300, 300, 8, 128, "per_bh", False),
    "D256_causal": (2, 290, 290, 4, 256, "shared", True),
    "B1": (1, 1000, 1000, 12, 64, "shared", False),
    "ragged_no_bias": (3, 200, 333, 12, 64, None, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FLASH_EDGE))
def test_flash_fwd_at_edge_shapes_on_card(case):
    """B3 against its plain version (out atol 2e-2, lse atol 1e-3), the same
    bits twice; with keys 64-127 left out (a skipped key tile) it fails
    those limits."""
    _need_card()
    from ofasys_torch.ops import flash_attention as tflash

    B, Tq, Tk, H, D, bias_kind, causal = FLASH_EDGE[case]
    q, k, v, _, bias, mask = _flash_inputs(B, Tq, Tk, H, D, bias_kind)
    scale = (2 * D) ** -0.5
    out, lse = tflash.flash_attention_fwd(q, k, v, bias, mask, H, scale, causal)
    torch.cuda.synchronize()
    ref, ref_lse = tflash.flash_attention_fwd_reference(q, k, v, bias, mask, H, scale, causal)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    again = tflash.flash_attention_fwd(q, k, v, bias, mask, H, scale, causal)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    hidden = mask.clone()
    hidden[:, :, 64:128] = 0
    f_out, f_lse = tflash.flash_attention_fwd(q, k, v, bias, hidden, H, scale, causal)
    assert (f_out.float() - ref.float()).abs().max().item() > 2e-2 \
        or (f_lse - ref_lse).abs().max().item() > 1e-3


@pytest.mark.cuda
def test_flash_kernels_take_bf16_only_on_card():
    _need_card()
    from ofasys_torch.ops import flash_attention as tflash

    q, k, v, _, bias, mask = _flash_inputs(1, 64, 256, 2, 64, "shared")
    with pytest.raises(TypeError):
        tflash.flash_attention_fwd(q.float(), k.float(), v.float(), bias, mask, 2, 0.1, False)


@pytest.mark.cuda
def test_flash_autograd_function_runs_every_kernel_on_card():
    _need_card()
    from ofasys_torch.ops import flash_attention as tflash

    B, T, H, D = 2, 300, 12, 64
    q, k, v, do, _, mask = _flash_inputs(B, T, T, H, D, None)
    q4, k4, v4 = (t.view(B, T, H, D).clone().requires_grad_() for t in (q, k, v))
    bias = torch.randn(1, H, T, T, device="cuda", requires_grad=True)
    fns = (tflash.flash_attention_fwd, tflash.flash_attention_bwd)
    before = [f.launches for f in fns]
    out = tflash.flash_attention(q4, k4, v4, bias=bias, mask=mask.bool()[:, :, None, :],
                                 scale=(2 * D) ** -0.5, causal=True)
    out.backward(do.view(B, T, H, D))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1]
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv", "flash_attention_bwd_dbias"):
        assert not hasattr(getattr(tflash, name), "launches")   # they launch no kernel of their own
    assert all(torch.isfinite(t.grad.float()).all() for t in (q4, k4, v4, bias))
    assert bias.grad.dtype == torch.float32


# --------------------------------------------------------- int8 GEMM (B7)
# (M, K, N): a decode step's fc1 (40 rows: batch 8 x beam 5), greedy logits
# over a 50,048-symbol vocabulary, an encoder fc2, ragged M/N/K (K a multiple
# of 4 but not 16: the byte path), and K = 50 (not a multiple of 4)
INT8_SHAPES = {"decode_fc1": (40, 768, 3072), "greedy_logits": (4, 768, 50048),
               "encoder_fc2": (1472, 3072, 768), "ragged": (300, 200, 333), "k50": (7, 50, 9)}


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(INT8_SHAPES))
def test_int8_kernel_equals_plain_version_on_card(case, out_dtype):
    _need_card()
    from ofasys_torch.ops import int8_matmul as ti8
    from ofasys_torch.ops.quant import _quantize_rows, quantize_weight

    M, K, N = INT8_SHAPES[case]
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(N, K, device="cuda", generator=g) * 0.05
    xq, sx = _quantize_rows(x)
    q, scale = quantize_weight(w)
    before = ti8.int8_matmul_fwd.launches
    out = ti8.int8_matmul_fwd(xq, sx, q, scale, out_dtype)
    torch.cuda.synchronize()
    assert ti8.int8_matmul_fwd.launches == before + 1
    ref = ti8.int8_matmul_reference(xq, sx, q, scale, out_dtype)
    assert out.dtype == out_dtype and out.shape == (M, N)
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()


# (M, N, K) -> the plan int8_plan gives: every kernel and cluster size, at
# M = 1, 4, 40 and 64 (one small-M block), 65 and 1,472 (128-row tiles), N
# with a ragged tile edge, K of 16 to 8,192, and K = 200 (the __dp4a kernel)
INT8_PLAN_CASES = [
    (M, N, K, plan)
    for M, small in ((1, True), (4, True), (40, True), (64, True), (65, False), (1472, False))
    for N, K, plan in (
        ((333, 3072, ("small_m", 8)), (1000, 768, ("small_m", 4)), (1608, 8192, ("small_m", 2)),
         (200, 48, ("small_m", 1)), (3208, 16, ("small_m", 1)), (333, 200, ("dp4a", 1)))
        if small else
        ((333, 3072, ("large_m", 8 if M == 65 else 4)), (1000, 768, ("large_m", 4 if M == 65 else 2)),
         (200, 48, ("large_m", 1)), (3208, 16, ("large_m", 1)), (333, 200, ("dp4a", 1))))
]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("M,N,K,plan", INT8_PLAN_CASES,
                         ids=[f"M{M}_N{N}_K{K}_{p[0]}_x{p[1]}" for M, N, K, p in INT8_PLAN_CASES])
def test_int8_plans_equal_plain_version_on_card(M, N, K, plan, out_dtype):
    """Every plan of B7, bit for bit; a K slice left out (the last rank's
    share under a split, else the last 64 bytes) must change the bits."""
    _need_card()
    from ofasys_torch.ops import int8_matmul as ti8

    got = ti8.int8_plan(M, N, K)
    assert (got.kernel, got.split) == plan
    g = torch.Generator(device="cuda").manual_seed(5)
    xq = torch.randint(-127, 128, (M, K), device="cuda", generator=g, dtype=torch.int8)
    q = torch.randint(-127, 128, (N, K), device="cuda", generator=g, dtype=torch.int8)
    sx = torch.rand(M, 1, device="cuda", generator=g) * 0.02 + 1e-3
    scale = torch.rand(N, device="cuda", generator=g) * 0.02 + 1e-3
    out = ti8.int8_matmul_fwd(xq, sx, q, scale, out_dtype)
    torch.cuda.synchronize()
    ref = ti8.int8_matmul_reference(xq, sx, q, scale, out_dtype)
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
    assert torch.equal(ti8.int8_matmul_fwd(xq, sx, q, scale, out_dtype), out)
    k0, k1 = ti8.split_ranges(K, got.split)[-1] if got.split > 1 else (max(0, K - 64), K)
    cut = xq.clone()
    cut[:, k0:k1] = 0
    assert not torch.equal(ti8.int8_matmul_fwd(cut, sx, q, scale, out_dtype), ref)


@pytest.mark.cuda
def test_int8_operand_off_16_bytes_takes_the_dp4a_kernel_on_card():
    _need_card()
    from ofasys_torch.ops import int8_matmul as ti8

    M, N, K = 40, 768, 768
    g = torch.Generator(device="cuda").manual_seed(6)
    buf = torch.randint(-127, 128, (M * K + 1,), device="cuda", generator=g, dtype=torch.int8)
    xq = buf[1:].view(M, K)
    q = torch.randint(-127, 128, (N, K), device="cuda", generator=g, dtype=torch.int8)
    sx = torch.rand(M, 1, device="cuda", generator=g) * 0.02
    scale = torch.rand(N, device="cuda", generator=g) * 0.02
    assert xq.data_ptr() % 16 and ti8.int8_plan(M, N, K, aligned=False).kernel == "dp4a"
    out = ti8.int8_matmul_fwd(xq, sx, q, scale, torch.bfloat16)
    assert torch.equal(out, ti8.int8_matmul_reference(xq, sx, q, scale, torch.bfloat16))


@pytest.mark.cuda
def test_quantized_dense_runs_the_int8_kernel_on_card():
    _need_card()
    from ofasys_torch.model.config import GeneralistModelConfig
    from ofasys_torch.model.transformer import Dense
    from ofasys_torch.ops import int8_matmul as ti8
    from ofasys_torch.ops.quant import quantize_for_serving

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = Dense(64, 96, torch.bfloat16, GeneralistModelConfig())

    net = quantize_for_serving(Net()).cuda()
    assert net.fc1.q.dtype == torch.int8 and net.fc1.q.is_cuda and not hasattr(net.fc1, "weight")
    before = ti8.int8_matmul_fwd.launches
    y = net.fc1(torch.randn(2, 5, 64, device="cuda"))
    torch.cuda.synchronize()
    assert ti8.int8_matmul_fwd.launches == before + 1
    assert y.shape == (2, 5, 96) and y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()


@pytest.mark.cuda
def test_int8_train_matmul_on_card():
    """Quantized training's projection at the infill encoder's fused q/k/v
    (12,288 rows x 768 -> 2,304): one B7 launch, the forward equal to B7's
    plain version on the same quantized operands bit for bit; the
    straight-through backward against the bf16 plain product (dx = g w,
    dw = g^T x): the same bf16 GEMMs, so within GRAD_TOL."""
    _need_card()
    from ofasys_torch.ops import int8_matmul as ti8
    from ofasys_torch.ops.quant import _quantize_rows, int8_train_matmul, quantize_weight

    M, K, N = 12288, 768, 2304
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16).requires_grad_()
    w = (torch.randn(N, K, device="cuda", generator=g) * K ** -0.5).requires_grad_()
    before = ti8.int8_matmul_fwd.launches
    y = int8_train_matmul(x, w)
    torch.cuda.synchronize()
    assert ti8.int8_matmul_fwd.launches == before + 1
    xq, sx = _quantize_rows(x.detach())
    q, scale = quantize_weight(w.detach())
    assert y.dtype == torch.bfloat16 and torch.equal(y, ti8.int8_matmul_reference(xq, sx, q, scale,
                                                                                  torch.bfloat16))
    gy = torch.randn(M, N, device="cuda", generator=g).to(torch.bfloat16)
    y.backward(gy)
    dx_ref = gy @ w.detach().to(torch.bfloat16)
    dw_ref = (gy.t() @ x.detach()).float()
    ok, err = _grad_close(x.grad, dx_ref, GRAD_TOL)
    assert ok and x.grad.dtype == torch.bfloat16, err
    ok, err = _grad_close(w.grad, dw_ref, GRAD_TOL)
    assert ok and w.grad.dtype == torch.float32, err


# ------------------------------------------------------- LayerNorm (B6)
# (N, E): the train mix's rows (12,288 = 128 x 96), fc2_ln's width, a
# decode step, a ragged N, and an E that takes the one-element path
LN_SHAPES = {"train_E768": (12288, 768), "fc2_ln_E3072": (2048, 3072), "decode": (40, 768),
             "ragged": (1001, 768), "e100": (33, 100)}
LN_SUM_TOL = (1e-4, 1e-4)


def _ln_inputs(N, E, dtype):
    g = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(N, E, device="cuda", generator=g) * 2.0 + 0.5).to(dtype)
    dy = torch.randn(N, E, device="cuda", generator=g).to(dtype)
    w = torch.randn(E, device="cuda", generator=g) * 0.3 + 1.0
    b = torch.randn(E, device="cuda", generator=g) * 0.1
    return x, w, b, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", list(LN_SHAPES))
def test_layer_norm_kernels_match_plain_versions_on_card(case, dtype):
    _need_card()
    from ofasys_torch.ops import layer_norm as tln

    N, E = LN_SHAPES[case]
    x, w, b, dy = _ln_inputs(N, E, dtype)
    f0, b0 = tln.layer_norm_fwd.launches, tln.layer_norm_bwd.launches
    y, mu, rstd = tln.layer_norm_fwd(x, w, b, 1e-5)
    dx, dg, db = tln.layer_norm_bwd(x, w, mu, rstd, dy)
    torch.cuda.synchronize()
    assert (tln.layer_norm_fwd.launches - f0, tln.layer_norm_bwd.launches - b0) == (1, 1)
    ry, rmu, rrstd = tln.layer_norm_fwd_reference(x, w, b, 1e-5)
    assert y.dtype == dtype and dx.dtype == dtype and dg.dtype == torch.float32
    assert ((y.float() - ry.float()).abs() <= 2.0 ** -7 * ry.float().abs() + 1e-3).all()
    torch.testing.assert_close(mu, rmu, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=1e-6)
    rdx, rdg, rdb = tln.layer_norm_bwd_reference(x, w, mu, rstd, dy)
    ok, errs = _grad_close(dx, rdx, GRAD_TOL)
    assert ok, ("dx", errs)
    for name, a, r in (("dg", dg, rdg), ("db", db, rdb)):
        ok, errs = _grad_close(a, r, LN_SUM_TOL)
        assert ok, (name, errs)
    # the same run twice gives the same bits (no atomics)
    dx2, dg2, db2 = tln.layer_norm_bwd(x, w, mu, rstd, dy)
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2) and torch.equal(db, db2)
    # a planted fault: dg summed over all rows but one
    skip = dy.clone()
    skip[N // 2] = 0
    _, fdg, _ = tln.layer_norm_bwd(x, w, mu, rstd, skip)
    assert not _grad_close(fdg, rdg, LN_SUM_TOL)[0]


# B6-fwd's row held in registers at every width of the arch table and its
# FFN widths, then the two-walk kernel at an odd E and at E = 1,536 (16-byte
# vectors, not a table width); N = 300 leaves the last block part empty
LN_FWD_WIDTHS = [256, 512, 768, 1024, 1280, 2048, 2560, 2816, 3072, 4096, 5120, 10240, 11264,
                 1001, 1536]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("E", LN_FWD_WIDTHS)
def test_layer_norm_fwd_plans_match_plain_version_on_card(E, dtype):
    _need_card()
    from ofasys_torch.ops import layer_norm as tln

    x, w, b, _ = _ln_inputs(300, E, dtype)
    plan = tln.ln_fwd_plan(E, x.element_size())
    assert plan.kernel == ("rows" if E in tln.LN_WIDTHS else "two_walk")
    y, mu, rstd = tln.layer_norm_fwd(x, w, b, 1e-5)
    torch.cuda.synchronize()
    ry, rmu, rrstd = tln.layer_norm_fwd_reference(x, w, b, 1e-5)
    assert ((y.float() - ry.float()).abs() <= 2.0 ** -7 * ry.float().abs() + 1e-3).all()
    torch.testing.assert_close(mu, rmu, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=1e-6)


def _ln_bwd_parts(tln, x, w, mu, rstd, dy, drop_block=None):
    """B6-bwd by its two parts, with one block's partial zeroed between
    them when ``drop_block`` is given (a planted fault): (dg, db, blocks)."""
    plan, rows, dx, dg, db, part = tln.bwd_setup(x, w, dy)
    tln.bwd_launch(x, w, mu, rstd, dy, dx, dg, db, part, plan, rows, parts=1)
    if drop_block is not None:
        part[drop_block] = 0
    tln.bwd_launch(x, w, mu, rstd, dy, dx, dg, db, part, plan, rows, parts=2)
    torch.cuda.synchronize()
    return dg, db, part.shape[0]


# B6-bwd at the same widths: the row in registers (dg and db in registers,
# or in shared memory at 10,240 and 11,264; a ring of row buffers, or loads
# straight into registers where it does not fit), then the two-walk kernel
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("E", LN_FWD_WIDTHS)
def test_layer_norm_bwd_plans_match_plain_version_on_card(E, dtype):
    _need_card()
    from ofasys_torch.ops import layer_norm as tln

    N = 300
    x, w, b, dy = _ln_inputs(N, E, dtype)
    plan = tln.ln_bwd_plan(E, x.element_size())
    assert plan.kernel == ("rows" if E in tln.LN_WIDTHS else "two_walk")
    _, mu, rstd = tln.layer_norm_fwd_reference(x, w, b, 1e-5)
    b0 = tln.layer_norm_bwd.launches
    dx, dg, db = tln.layer_norm_bwd(x, w, mu, rstd, dy)
    torch.cuda.synchronize()
    assert tln.layer_norm_bwd.launches - b0 == 1
    rdx, rdg, rdb = tln.layer_norm_bwd_reference(x, w, mu, rstd, dy)
    ok, errs = _grad_close(dx, rdx, GRAD_TOL)
    assert ok, ("dx", errs)
    for name, a, r in (("dg", dg, rdg), ("db", db, rdb)):
        ok, errs = _grad_close(a, r, LN_SUM_TOL)
        assert ok, (name, errs)
    dx2, dg2, db2 = tln.layer_norm_bwd(x, w, mu, rstd, dy)
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2) and torch.equal(db, db2)
    # the two parts run apart give the call's bits; planted faults: a row
    # left out of the sums, one block's partial left out of the reduction
    pdg, pdb, blocks = _ln_bwd_parts(tln, x, w, mu, rstd, dy)
    assert torch.equal(pdg, dg) and torch.equal(pdb, db)
    if plan.ring:                       # the ring and straight loads: the same bits
        import dataclasses

        p0, rows, *outs, part = tln.bwd_setup(x, w, dy)
        tln.bwd_launch(x, w, mu, rstd, dy, *outs, part, dataclasses.replace(p0, ring=0), rows)
        torch.cuda.synchronize()
        assert all(torch.equal(a, r) for a, r in zip(outs, (dx, dg, db)))
    skip = dy.clone()
    skip[N // 2] = 0
    _, fdg, _ = tln.layer_norm_bwd(x, w, mu, rstd, skip)
    assert not _grad_close(fdg, rdg, LN_SUM_TOL)[0]
    fdg, fdb, _ = _ln_bwd_parts(tln, x, w, mu, rstd, dy, drop_block=blocks // 2)
    assert not _grad_close(fdg, rdg, LN_SUM_TOL)[0] and not _grad_close(fdb, rdb, LN_SUM_TOL)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "hybrid"])
def test_fused_layer_norm_module_runs_its_kernels_on_card(mode):
    _need_card()
    from ofasys_torch.ops import layer_norm as tln

    ln = tln.FusedLayerNorm(768, torch.bfloat16, mode=mode).cuda()
    x = torch.randn(4, 33, 768, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    f0, b0 = tln.layer_norm_fwd.launches, tln.layer_norm_bwd.launches
    ln(x).float().square().sum().backward()
    torch.cuda.synchronize()
    assert tln.layer_norm_fwd.launches - f0 == (1 if mode == "fused" else 0)
    assert tln.layer_norm_bwd.launches - b0 == 1
    assert all(torch.isfinite(t.float()).all() for t in (x.grad, ln.weight.grad, ln.bias.grad))


@pytest.mark.cuda
def test_resnet_trunk_bf16_against_fp32_on_card():
    """image_resnet's trunk (resnet50, cuDNN convolutions) in bf16 against
    the same parameters in fp32 with TF32 off: relative Frobenius error
    <= 5e-2 (bf16 operands and outputs rounded at each of 53 convolutions
    and norms, the bound chip_smoke's trunk check states)."""
    _need_card()
    from ofasys_torch.model import resnet as tresnet

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        g = torch.Generator().manual_seed(0)
        m16 = tresnet.ResNet("resnet50", dtype=torch.bfloat16)
        tresnet.init_resnet_(m16, g)
        m32 = tresnet.ResNet("resnet50", dtype=torch.float32)
        m32.load_state_dict(m16.state_dict())
        m16, m32 = m16.cuda(), m32.cuda()
        x = torch.randn(2, 64, 64, 3, device="cuda")
        with torch.no_grad():
            y16, y32 = m16(x), m32(x)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert y16.dtype == torch.bfloat16 and tuple(y16.shape) == (2, 4, 4, 1024)
    rel = ((y16.float() - y32).norm() / y32.norm()).item()
    assert torch.isfinite(y16.float()).all() and rel <= 5e-2, rel


def _glue_task(tmp_path, answers):
    """A GLUE sst2 task whose candidate answers are ``answers``, initialized
    on a new dictionary."""
    import json

    from ofasys_torch.configure import ConfigStore
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.task.tasks import GlueTask

    path = tmp_path / "ans2label.json"
    path.write_text(json.dumps({a: i for i, a in enumerate(answers)}))
    cfg = ConfigStore().get("ofasys.preprocess", "text").config
    saved, cfg.ans2label_file = cfg.ans2label_file, str(path)
    try:
        return GlueTask(subtask="sst2").initialize(Dictionary())
    finally:
        cfg.ans2label_file = saved


TRAVERSE_SCORE_ATOL = 0.25


@pytest.mark.cuda
def test_rank_answers_under_b1_match_plain_path_on_card(tmp_path):
    """TraverseTask's candidate scores on a tiny bf16 model (E=256, 4 heads
    of 64): B1 in every encoder layer (B=32 sources of about 72 tokens, B*T
    >= 256) and in the decoder self and cross attention of each answer whose
    pass reaches the dense gate ("maybe not" does), as many launches as
    MultiheadAttention's routing rule gives; against the same scores with
    plain attention, each score within TRAVERSE_SCORE_ATOL (bf16 logits
    summed over the answer's tokens: the bound of chip_smoke's encoder
    check), the picks equal where the top two part by more than twice that."""
    _need_card()
    from ofasys_torch import GeneralistModel
    from ofasys_torch.model.transformer import attention_route
    from ofasys_torch.preprocessor.instruction import Instruction

    answers = ["no", "yes", "maybe not"]
    task = _glue_task(tmp_path, answers)
    g = torch.Generator().manual_seed(0)
    words = ["good", "bad", "film", "plot", "the", "actors", "were", "dull", "fine"]
    recs = [{"sentence": " ".join(words[int(i)] for i in torch.randint(0, len(words), (int(n),), generator=g)),
             "label": answers[int(n) % 2]} for n in torch.randint(3, 6, (32,), generator=g)]
    gp = task.general_preprocess
    sample = gp.collate([gp(Instruction(task.templates[0], split="valid").format(**r)) for r in recs])
    model = GeneralistModel(arch="tiny")
    model.cfg.dropout = 0.0
    model.initialize(task.global_dict, device="cuda", seed=0)
    f0 = tdense.dense_attention_fwd.launches
    kernel = task.answer_scores(model, sample, answers)
    launched = tdense.dense_attention_fwd.launches - f0
    model.cfg.attn_kernel = "xla"
    plain = task.answer_scores(model, sample, answers)
    model.cfg.attn_kernel = "auto"

    cfg, H = model.cfg, model.cfg.encoder.attention_heads
    B = len(recs)
    Ts = sum(s.value["inputs"].shape[1] for s in sample["net_input"]["slots"] if s.is_src)

    def dense(Tq, Tk):
        return attention_route(cfg, "cuda", B, Tq, Tk, H, cfg.encoder.embed_dim // H, 0.0,
                               bias_shape=(1, H, Tq, Tk), mask_shape=(B, 1, 1, Tk)) == "dense"

    pre = gp.name2pre["text"]
    decoder = [cfg.decoder.layers * (dense(Tt, Tt) + dense(Tt, Ts))
               for Tt in (len(pre.encode(a)) + 1 for a in answers)]
    assert dense(Ts, Ts) and any(decoder)
    assert launched == len(answers) * cfg.encoder.layers + sum(decoder)
    assert np.isfinite(kernel).all() and np.abs(kernel - plain).max() <= TRAVERSE_SCORE_ATOL
    top2 = np.sort(plain, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * TRAVERSE_SCORE_ATOL
    assert (kernel.argmax(1)[clear] == plain.argmax(1)[clear]).all()


@pytest.mark.cuda
def test_import_reference_state_dict_onto_cuda_model_on_card():
    """A reference state_dict exported from a CPU model imports onto a model
    on the card bit for bit; the shared embedding's decoder copy is unused."""
    _need_card()
    from ofasys_torch import GeneralistModel
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.utils import torch_import as tti
    from ofasys_torch.utils.jax_params import export_params

    d = Dictionary()
    for i in range(300):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    src = GeneralistModel(arch="tiny")
    src.initialize(d, device="cpu", seed=1)
    sd = tti.export_reference_state_dict(src)
    sd["decoder.adaptor.embed_tokens.weight"] = sd["encoder.adaptor.embed_tokens.weight"]
    dst = GeneralistModel(arch="tiny")
    dst.initialize(d, device="cuda", seed=2)
    _, missing, unused = tti.import_reference_state_dict(sd, dst)
    assert missing == [] and unused == ["decoder.adaptor.embed_tokens.weight"]
    assert dst.net.embed_tokens.weight.device.type == "cuda"
    want, got = export_params(src.net), export_params(dst.net)
    for (p, a), (q, b) in zip(tti._walk(want), tti._walk(got), strict=True):
        assert p == q and np.array_equal(a, b), p


SPEC_TIE_TOL = 5e-2


@pytest.mark.cuda
def test_speculative_batch_on_card_equals_the_target_alone():
    """A hub with a tiny draft serves a dispatch of 8 greedy requests on the
    card: B1 once per encoder layer of the target and of the draft (8
    sources of about 40 tokens: B*T >= 256), none in the verify and draft
    steps (cached); every answer equals the target alone's greedy one, or
    parts from it where the target's two choices are within SPEC_TIE_TOL
    (the verify step's bf16 products round apart from a single step's) or
    where one of them takes EOS."""
    _need_card()
    from ofasys_torch import GeneralistModel, OFASys
    from ofasys_torch.model.transformer import attention_route
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess

    d = Dictionary()
    gp = GeneralPreprocess(d, active=["text"])
    models = []
    for layers, seed in ((3, 0), (1, 7)):
        m = GeneralistModel(arch="tiny")
        m.cfg.encoder.layers = m.cfg.decoder.layers = layers
        m.cfg.dropout = 0.0
        m.initialize(d, device="cuda", seed=seed)
        models.append(m)
    target, draft = (OFASys(m, None, d, gp) for m in models)
    words = ["the", "storm", "moved", "north", "over", "coast", "on", "monday"]
    g = torch.Generator().manual_seed(0)
    data = [{"src": " ".join(words[int(i)] for i in torch.randint(0, len(words), (8,), generator=g))}
            for _ in range(8)]
    opts = dict(beam_size=1, no_repeat_ngram_size=0, max_len_b=12)
    plain = target.inference("[TEXT:src] -> [TEXT:tgt]", data, **opts)
    spec = OFASys(models[0], None, d, gp).set_draft(draft, gamma=4)
    f0 = tdense.dense_attention_fwd.launches
    got = spec.inference("[TEXT:src] -> [TEXT:tgt]", data, **opts)
    launched = tdense.dense_attention_fwd.launches - f0
    T = max(len(gp.name2pre["text"].encode(r["src"])) for r in data) + 2
    routes = [attention_route(m.cfg, "cuda", 8, T, T, 4, 64, 0.0, bias_shape=(1, 4, T, T),
                              mask_shape=(8, 1, 1, T)) for m in models]
    assert routes == ["dense", "dense"]
    assert launched == sum(m.cfg.encoder.layers for m in models)
    eos = d.eos()
    for rec, a, b in zip(data, plain, got):
        if np.array_equal(a.tokens, b.tokens):
            continue
        n = min(len(a.tokens), len(b.tokens))
        p = int(np.nonzero(a.tokens[:n] != b.tokens[:n])[0][0])
        lp = _target_logprobs(target, rec, b.tokens[:p + 1])[p]
        margin = abs(float(lp[int(a.tokens[p])] - lp[int(b.tokens[p])]))
        assert eos in (a.tokens[p], b.tokens[p]) or margin <= SPEC_TIE_TOL, (p, margin)


@torch.no_grad()
def _target_logprobs(hub, rec, tokens):
    """The hub model's log-probs at each step of decoding ``tokens`` for one
    record, one single step at a time."""
    import dataclasses

    from ofasys_torch.preprocessor.instruction import Instruction
    from ofasys_torch.utils.pytree import SlotBatch, slots_to_device

    gp, net = hub.general_preprocess, hub.model.net
    slots = gp.collate([gp(Instruction("[TEXT:src] -> [TEXT:tgt]", split="test").format(**rec))])
    slots = slots["net_input"]["slots"]
    enc = net.encode(slots_to_device([s for s in slots if s.is_src], "cuda"))
    tgt = SlotBatch.target_slot(slots)
    dummy = dataclasses.replace(tgt, value={"inputs": torch.zeros((1, 16), dtype=torch.long, device="cuda")})
    bias, cb, cache = net.decode_prepare([dummy], enc, 16)
    prev, out = hub.global_dict.bos(), []
    for step, t in enumerate(tokens):
        logits, _, cache = net.decode_step(torch.full((1, 1), prev, dtype=torch.long, device="cuda"),
                                           step, enc, bias, cb, cache, tgt)
        out.append(torch.log_softmax(logits[0, -1].float(), dim=-1))
        prev = int(t)
    return torch.stack(out)
