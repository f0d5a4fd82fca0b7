"""The CTC term of ofasys_torch's ``speech_to_text_loss`` against
ofasys_tpu's: ``ops.losses.ctc_loss`` against ``optax.ctc_loss`` (repeated
labels, padded frames, a label run longer than its frames, empty labels),
and a speech_to_text update with ``text_phone`` targets and
``ctc_weight = 0.5`` at the tiny arch (losses and every gradient).

Tolerances: the CTC loss rtol 1e-5 and its gradient atol 1e-5; the update's
losses rtol 1e-5, gradients rtol 1e-4 + atol 1e-5 of the leaf's largest
magnitude where that passes 1 (the CTC term is summed over the batch: the
embedding's gradient reaches 165, and fp32 sums in another order differ
there by 2.4e-4); fp32 on both sides.
Where a sequence has no possible alignment every path's log-probability
sits near ``log_epsilon`` = -1e5, where fp32 values are 7.8e-3 apart: there
the gradient is held to IMPOSSIBLE_GRAD_ATOL = 1e-2 (the loss still to
rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu.engine.criterion.cross_entropy import (
    SpeechToTextCriterion as JS2TCriterion,
    SpeechToTextCriterionConfig as JS2TConfig,
)
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction
from ofasys_torch.engine.criterion.cross_entropy import SpeechToTextCriterion, SpeechToTextCriterionConfig
from ofasys_torch.ops.losses import ctc_loss
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import sample_to_device

from test_torch_audio import (  # noqa: F401  (fixture)
    _asr_records, _jax_sample, _one_torch_thread, _port_params, _tiny_cfg,
)

ASR_PHONE = "[AUDIO:wav] what is the transcription? -> [TEXT:text,preprocess=text_phone]"
LOSS_RTOL = 1e-5
CTC_GRAD_ATOL = 1e-5
IMPOSSIBLE_GRAD_ATOL = 1e-2
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _case(name, seed=0, B=4, T=12, K=7, N=5):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, T, K)) * 2).astype(np.float32)
    frames = np.full(B, T)
    lens = rng.integers(1, N + 1, B)
    labels = rng.integers(1, K, (B, N))
    if name == "repeats":
        labels[:, :3] = labels[:, :1]
        labels[1] = 2
        lens[:] = N
    elif name == "padded_frames":
        frames = np.asarray([T, T - 3, 5, 2])
    elif name == "too_long":
        frames = np.asarray([T, 3, 2, 1])
        lens[:] = N
        labels[1, :] = 4                     # five repeats need nine frames
    elif name == "empty_labels":
        lens = np.asarray([0, 1, 0, N])
    logit_pads = (np.arange(T)[None] >= frames[:, None]).astype(np.float32)
    label_pads = (np.arange(N)[None] >= lens[:, None]).astype(np.float32)
    labels = np.where(label_pads > 0, 0, labels).astype(np.int32)
    return logits, logit_pads, labels, label_pads


@pytest.mark.parametrize("name", ["random", "repeats", "padded_frames", "too_long", "empty_labels"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ctc_loss_matches_optax(name, seed):
    logits, lp, labels, lbp = _case(name, seed)

    def jfn(x):
        return optax.ctc_loss(x, jnp.asarray(lp), jnp.asarray(labels), jnp.asarray(lbp), blank_id=0)

    jl = np.asarray(jfn(jnp.asarray(logits)))
    jg = np.asarray(jax.grad(lambda x: jfn(x).sum())(jnp.asarray(logits)))
    x = torch.tensor(logits, requires_grad=True)
    tl = ctc_loss(x, torch.as_tensor(lp), torch.as_tensor(labels), torch.as_tensor(lbp), blank_id=0)
    tl.sum().backward()
    assert tl.dtype == torch.float32 and tl.shape == (4,)
    assert np.isfinite(tl.detach().numpy()).all()
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=LOSS_RTOL)
    impossible = jl > 1e4
    np.testing.assert_allclose(x.grad.numpy()[~impossible], jg[~impossible], rtol=0, atol=CTC_GRAD_ATOL)
    np.testing.assert_allclose(x.grad.numpy()[impossible], jg[impossible], rtol=0,
                               atol=IMPOSSIBLE_GRAD_ATOL)
    if name == "too_long":
        # an impossible alignment scores through log_epsilon, finite, where
        # torch's own CTC gives inf
        assert tl[1].item() > 1e4
        ref = torch.nn.functional.ctc_loss(
            torch.log_softmax(torch.as_tensor(logits), -1).transpose(0, 1),
            torch.as_tensor(labels).long(), torch.as_tensor(12 - lp.sum(1)).long(),
            torch.as_tensor(5 - lbp.sum(1)).long(), reduction="none")
        assert torch.isinf(ref[1])


@pytest.fixture(scope="module")
def env():
    jd = JDictionary()
    jm = JModel(arch="tiny")
    _tiny_cfg(jm)
    jgp = JGeneralPreprocess(jd, active=["text", "audio", "text_phone"])
    jd.pad_to_multiple_(8)
    jm.initialize(jd, active_adaptors=("text", "audio_fbank"), dtype=jnp.float32)
    td = Dictionary()
    tm = GeneralistModel(arch="tiny")
    _tiny_cfg(tm)
    tgp = GeneralPreprocess(td, active=["text", "audio", "text_phone"])
    td.pad_to_multiple_(8)
    tm.initialize(td, active_adaptors=("text", "audio_fbank"), dtype=torch.float32, device="cpu")
    assert jd.symbols == td.symbols
    recs = _asr_records(np.random.default_rng(12), 6)
    recs[0]["text"] = "aaa bb"                # repeated phones
    jb = jgp.collate([jgp(JInstruction(ASR_PHONE, split="train").format(**r)) for r in recs])
    tb = tgp.collate([tgp(Instruction(ASR_PHONE, split="train").format(**r)) for r in recs])
    params = _port_params(jm, tm, [jb["net_input"]["slots"]])
    return dict(jm=jm, jd=jd, tm=tm, td=td, params=params, jb=jb, tb=tb)


def test_phone_targets_identical(env):
    np.testing.assert_array_equal(env["tb"]["encoder_target"], env["jb"]["encoder_target"])
    np.testing.assert_array_equal(env["tb"]["target"], env["jb"]["target"])
    start, end = env["td"].get_start_end_idx("<phone>")
    assert end - start == 43


@pytest.mark.parametrize("weights", [(1.0, 0.5), (0.0, 1.0)])
def test_ctc_update_matches(env, weights):
    """Loss, ce_loss, ctc_loss and every gradient of a training step."""
    ce_w, ctc_w = weights
    jm, tm = env["jm"], env["tm"]
    pad = env["td"].pad()
    jc = JS2TCriterion(JS2TConfig(ce_weight=ce_w, ctc_weight=ctc_w), pad)
    tc = SpeechToTextCriterion(SpeechToTextCriterionConfig(ce_weight=ce_w, ctc_weight=ctc_w), pad)
    jc.global_dict, tc.global_dict = env["jd"], env["td"]
    jsample = _jax_sample(env["jb"], extra=("encoder_target",))

    def jloss(p):
        loss, _, log = jc(jm, {"params": p}, jsample, rng=jax.random.PRNGKey(1), train=True)
        return loss, log

    (jl, jlog), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(env["params"])
    load_jax_params(tm.net, env["params"])
    tm.net.zero_grad()
    tl, tss, tlog = tc(tm, sample_to_device(env["tb"], "cpu"), torch.Generator().manual_seed(1),
                       train=True)
    tl.backward()
    assert np.isfinite(float(tlog["ctc_loss"].detach())) and float(tlog["ctc_loss"].detach()) > 0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    for key in ("ce_loss", "ctc_loss", "nll_loss"):
        np.testing.assert_allclose(float(tlog[key]), float(jlog[key]), rtol=LOSS_RTOL, err_msg=key)
    tgrads = export_params(tm.net, {n: torch.zeros_like(p) if p.grad is None else p.grad
                                    for n, p in tm.net.named_parameters()})
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    for path, g in jax.tree_util.tree_leaves_with_path(tgrads):
        want = np.asarray(flat_j[path])
        np.testing.assert_allclose(g, want, rtol=GRAD_RTOL, atol=GRAD_ATOL * max(1.0, np.abs(want).max()),
                                   err_msg=jax.tree_util.keystr(path))
