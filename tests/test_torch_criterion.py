"""The port's label-smoothed cross entropy against ofasys_tpu's
``LabelSmoothedCrossEntropyCriterion.compute_loss``.

Logits and targets come from a numpy seed and go to both sides as the same
arrays. Compared: loss, nll_loss, ntokens, sample_size and the gradient of
the loss with respect to the logits. Tolerance: rtol 1e-5 on the sums and
atol 1e-6 on the gradient (fp32 reductions over a vocabulary of 96, taken
in another order); in bf16 the logits are bf16 on both sides and the sums
fp32, so the same tolerances hold for the sums, and the gradient, which
autograd returns in the logits' dtype, is compared at one bf16 ulp of its
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion as JCriterion,
    LabelSmoothedCrossEntropyCriterionConfig as JConfig,
)
from ofasys_torch.engine.criterion import (
    BaseCriterion,
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)

B, T, V = 3, 7, 96
PAD, EOS = 1, 2

CASES = {
    "plain": {},
    "no_smoothing": {"label_smoothing": 0.0},
    "ignore_eos": {"ignore_eos": True},
    "drop_worst": {"drop_worst_ratio": 0.3, "drop_worst_after": 2},
    "drop_worst_not_yet": {"drop_worst_ratio": 0.3, "drop_worst_after": 9},
    "sentence_avg": {"sentence_avg": True},
    "constraint_masks": {"_cmask": True},
    "accuracy": {"report_accuracy": True},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _data(seed=0):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((B, T, V))).astype(np.float32)
    target = rng.integers(4, V, size=(B, T)).astype(np.int32)
    target[0, -2:] = PAD
    target[1, -1] = PAD
    target[:, 3] = EOS
    cmask = rng.random((B, T, V)) > 0.5
    cmask[np.arange(B)[:, None], np.arange(T)[None, :], target] = True
    return logits, target, cmask


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compute_loss_matches(case, dtype):
    opts = dict(CASES[case])
    with_cmask = opts.pop("_cmask", False)
    logits, target, cmask = _data()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    update_num = 5

    jcrit = JCriterion(JConfig(**opts), pad_id=PAD)
    jsample = {"target": jnp.asarray(target), "update_num": update_num}
    if with_cmask:
        jsample["constraint_masks"] = jnp.asarray(cmask)

    def jloss(z):
        loss, ss, log = jcrit.compute_loss(z, jsample, train=True)
        return loss, (ss, log)

    (jl, (jss, jlog)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits).astype(jdt))

    tcrit = LabelSmoothedCrossEntropyCriterion(LabelSmoothedCrossEntropyCriterionConfig(**opts),
                                               pad_id=PAD)
    tsample = {"target": torch.from_numpy(target).long(), "update_num": update_num}
    if with_cmask:
        tsample["constraint_masks"] = torch.from_numpy(cmask)
    z = torch.from_numpy(logits).to(tdt).requires_grad_()
    tl, tss, tlog = tcrit.compute_loss(z, tsample, train=True)
    tl.backward()

    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tlog["nll_loss"]), float(jlog["nll_loss"]), rtol=1e-5)
    assert int(tlog["ntokens"]) == int(jlog["ntokens"])
    assert float(tss) == float(jss) == float(jlog["sample_size"])
    assert tlog["nsentences"] == jlog["nsentences"] == B
    if opts.get("report_accuracy"):
        assert int(tlog["n_correct"]) == int(jlog["n_correct"])
    jg = np.asarray(jnp.asarray(jgrad).astype(jnp.float32))
    atol = 1e-6 if dtype == "fp32" else 2 ** -8 * np.abs(jg).max()
    np.testing.assert_allclose(z.grad.float().numpy(), jg, rtol=0, atol=atol)


def test_eval_mode_skips_drop_worst():
    logits, target, _ = _data(1)
    cfg = LabelSmoothedCrossEntropyCriterionConfig(drop_worst_ratio=0.5)
    crit = LabelSmoothedCrossEntropyCriterion(cfg, pad_id=PAD)
    sample = {"target": torch.from_numpy(target).long()}
    _, _, train_log = crit.compute_loss(torch.from_numpy(logits), sample, train=True)
    _, _, eval_log = crit.compute_loss(torch.from_numpy(logits), sample, train=False)
    assert int(train_log["ntokens"]) < int(eval_log["ntokens"]) == int((target != PAD).sum())


def test_chunked_vocab_raises():
    """chunked_vocab, which raised before it was ported (the name is kept),
    now gives compute_loss's loss from the fused statistics: the hidden
    states and tied table of a random projection, the logits ``x @ W^T``
    on one side and the chunked statistics on the other (fp32, 96 symbols
    in 3 chunks of 32): loss and nll rtol 1e-5, as above."""
    from ofasys_torch.ops.fused_ce import pick_chunks

    rng = np.random.default_rng(2)
    _, target, _ = _data()
    E = 16
    x = torch.tensor(rng.standard_normal((B * T, E)), dtype=torch.float32)
    emb = torch.tensor(rng.standard_normal((V, E)) * 0.3, dtype=torch.float32)
    crit = LabelSmoothedCrossEntropyCriterion(
        LabelSmoothedCrossEntropyCriterionConfig(chunked_vocab=True), pad_id=PAD)
    sample = {"target": torch.from_numpy(target).long()}
    fused = crit.compute_loss_fused(x, emb, 3, sample)
    plain = crit.compute_loss((x @ emb.t()).reshape(B, T, V), sample)
    np.testing.assert_allclose(float(fused[0]), float(plain[0]), rtol=1e-5)
    np.testing.assert_allclose(float(fused[2]["nll_loss"]), float(plain[2]["nll_loss"]), rtol=1e-5)
    assert int(fused[2]["ntokens"]) == int(plain[2]["ntokens"])
    assert pick_chunks(V) is None     # 96 symbols: no 128-aligned chunks, the gate declines


def test_reduce_metrics():
    logs = [{"loss": 6.0, "nll_loss": 4.0, "ntokens": 4, "sample_size": 4},
            {"loss": 3.0, "nll_loss": 2.0, "ntokens": 2, "sample_size": 2}]
    out = BaseCriterion.reduce_metrics(logs)
    assert out["loss"] == 1.5 and out["nll_loss"] == 1.0 and out["ntokens"] == 6
