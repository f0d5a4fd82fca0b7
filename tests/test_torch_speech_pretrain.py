"""Audio pretraining in ofasys_torch against ofasys_tpu:
``subsampled_length``, ``span_mask`` and ``speech_pretrain_loss`` (the
masked student pass, the teacher under no_grad, the KL on masked frames
over the ``<phone>`` sub-vocabulary, the label-smoothed CE; without
phones the KL term is 0 on both sides), and a
``Task("audio_pretraining")`` fit.

ofasys_tpu draws its span masks in-jit from ``fold_in(rng, 7)`` (the
channel masks from ``fold_in(that, 1)``), which the port cannot reproduce:
the parity tests draw them with ofasys_tpu's ``span_mask`` from those keys
and hand them to the port's criterion through its ``frame_mask`` and
``channel_mask`` keywords; the port's own ``span_mask`` is held to
ofasys_tpu's properties (tests/test_speech_pretrain.py:25-38) and to its
span layout.

Tiny arch (2+2 layers, E=64, FFN 256, 4 heads), fp32 on both sides, all
dropout rates 0 (a training call with a generator then equals the
deterministic forward), the same perturbed parameters, 16 kHz wavs of
0.25-0.6 s from a numpy seed. Tolerances: losses and logged values rtol
1e-5; gradients atol 1e-5 + rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu.engine.criterion import speech_pretrain_loss as jsp
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
import ofasys_torch.task  # noqa: F401  (registers the task zoo)
from ofasys_torch import GeneralistModel, Instruction, Trainer, TrainerConfig
from ofasys_torch.configure.config_store import ConfigStore
from ofasys_torch.engine.criterion import speech_pretrain_loss as tsp
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import sample_to_device, slots_to_device

from test_torch_audio import _asr_records, _one_torch_thread, _port_params, _tiny_cfg  # noqa: F401

TPL = "[AUDIO:wav,mask=true] -> [TEXT:text]"
ADAPTORS = ("text", "audio_fbank")
N_PHONES = 40
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.mark.parametrize("T", [1, 5, 9, 10, 11, 37, 64, 480])
@pytest.mark.parametrize("stride", [2, 4, 8])
def test_subsampled_length_matches(T, stride):
    assert tsp.subsampled_length(T, stride) == jsp.subsampled_length(T, stride)


def test_subsampled_length_is_the_adaptors():
    from ofasys_torch.adaptor.audio import AudioFbankAdaptor
    from ofasys_torch import ModalityType
    from ofasys_torch.utils.pytree import SlotBatch

    m = GeneralistModel(arch="tiny")
    _tiny_cfg(m)
    ad = AudioFbankAdaptor(m.cfg, True, torch.nn.Embedding(8, 64), 1, torch.float32)
    for T in (9, 37, 64):
        slot = SlotBatch(ModalityType.AUDIO, True, {"inputs": torch.zeros(1, T, 80)}, "wav")
        with torch.no_grad():
            assert ad(slot).embed.shape[1] == tsp.subsampled_length(T, 4)


def test_span_mask_properties():
    """ofasys_tpu's properties: shape, a masked fraction in (0.15, 0.75) a
    row at mask_prob 0.5; then the port's layout: every masked frame lies
    in a run of mask_length frames from a start below T - mask_length, at
    most round(mask_prob * T / mask_length) spans a row, the same seed
    repeats and another seed differs."""
    m = tsp.span_mask(torch.Generator().manual_seed(0), 4, 100, 0.5, 10)
    assert tuple(m.shape) == (4, 100) and m.dtype == torch.bool
    frac = m.float().mean(dim=1)
    assert (frac > 0.15).all() and (frac < 0.75).all()
    for row in m.numpy():
        starts = [t for t in range(100) if row[t] and (t == 0 or not row[t - 1])]
        assert all(s < 90 for s in starts)
        runs = np.diff(np.flatnonzero(np.diff(np.concatenate([[0], row.astype(int), [0]]))))[::2]
        assert all(r >= 10 for r in runs) and len(starts) <= 5
    again = tsp.span_mask(torch.Generator().manual_seed(0), 4, 100, 0.5, 10)
    other = tsp.span_mask(torch.Generator().manual_seed(1), 4, 100, 0.5, 10)
    assert torch.equal(m, again) and not torch.equal(m, other)


@pytest.mark.parametrize("T", [4, 10, 11])
def test_span_mask_drops_frames_past_the_end(T):
    """At T <= mask_length every span starts at 0 and frames past T drop,
    as ofasys_tpu's scatter with mode='drop' does."""
    j = np.asarray(jsp.span_mask(jax.random.PRNGKey(0), 3, T, 0.65, 10))
    t = tsp.span_mask(torch.Generator().manual_seed(0), 3, T, 0.65, 10).numpy()
    assert t.shape == j.shape == (3, T)
    if T <= 10:
        np.testing.assert_array_equal(t, j)
        assert t.all()
    assert t.sum(1).min() >= min(T, 10)


@pytest.fixture(scope="module")
def env():
    jd = JDictionary()
    jm = JModel(arch="tiny")
    _tiny_cfg(jm)
    jgp = JGeneralPreprocess(jd, active=["text", "audio"])
    jd.add_namespace("<phone>", N_PHONES)
    jd.pad_to_multiple_(8)
    jm.initialize(jd, active_adaptors=ADAPTORS, dtype=jnp.float32)

    td = Dictionary()
    tm = GeneralistModel(arch="tiny")
    _tiny_cfg(tm)
    tgp = GeneralPreprocess(td, active=["text", "audio"])
    td.add_namespace("<phone>", N_PHONES)
    td.pad_to_multiple_(8)
    tm.initialize(td, active_adaptors=ADAPTORS, dtype=torch.float32, device="cpu")
    assert jd.symbols == td.symbols

    recs = _asr_records(np.random.default_rng(11), 6)
    jb = jgp.collate([jgp(JInstruction(TPL, split="train").format(**r)) for r in recs])
    tb = tgp.collate([tgp(Instruction(TPL, split="train").format(**r)) for r in recs])
    # a text source too: the encoder's text adaptor
    jt = jgp.collate([jgp(JInstruction("[TEXT:src] -> [TEXT:tgt]", split="train").format(
        src="a dog", tgt="runs"))])
    params = _port_params(jm, tm, [jb["net_input"]["slots"], jt["net_input"]["slots"]])
    return dict(jm=jm, jd=jd, tm=tm, td=td, params=params, jb=jb, tb=tb)


def _criteria(env, jd=None, td=None, **kw):
    """Both criteria, each over its package's dictionary (by default the
    model's, which has <phone> rows)."""
    jcrit = jsp.SpeechPretrainCriterion(jsp.SpeechPretrainCriterionConfig(**kw), pad_id=env["jd"].pad())
    jcrit.global_dict = env["jd"] if jd is None else jd
    tcrit = tsp.SpeechPretrainCriterion(tsp.SpeechPretrainCriterionConfig(**kw), pad_id=env["td"].pad())
    tcrit.global_dict = env["td"] if td is None else td
    return jcrit, tcrit


def test_projection_rows_without_phones(env):
    """Over a dictionary without <phone> rows both packages take
    get_start_end_idx("<phone>") = (-1, -1) for a range and project onto
    no rows: the KL term is 0 on both sides, the masks still drawn; with
    phones both take the <phone> rows."""
    vocab = len(env["td"])
    jcrit, tcrit = _criteria(env)
    assert jcrit._proj_range(vocab) == tcrit._proj_range(vocab) == env["td"].get_start_end_idx("<phone>")
    assert tcrit._proj_range(vocab)[1] - tcrit._proj_range(vocab)[0] == N_PHONES
    jcrit, tcrit = _criteria(env, jd=JDictionary(), td=Dictionary())
    assert jcrit._proj_range(vocab) == tcrit._proj_range(vocab) == (-1, -1)
    rng = jax.random.PRNGKey(4)
    _, _, jlog = jax.jit(lambda p: jcrit(env["jm"], p, env["jb"], rng=rng, train=True))(env["params"])
    frame, _ = _jax_masks(env, rng, False)
    load_jax_params(env["tm"].net, env["params"])
    with torch.no_grad():
        _, _, tlog = tcrit(env["tm"], sample_to_device(env["tb"], "cpu"), torch.Generator().manual_seed(4),
                           train=True, frame_mask=torch.as_tensor(np.array(frame)))
    assert float(jlog["mam_loss"]) == float(tlog["mam_loss"]) == 0.0
    assert int(tlog["n_masked"]) == int(jlog["n_masked"]) > 0
    np.testing.assert_allclose(float(tlog["loss"]), float(jlog["loss"]), rtol=LOSS_RTOL)


def _jax_masks(env, rng, channel):
    """The masks ofasys_tpu's criterion draws in-jit for ``rng``."""
    B, T, M = env["jb"]["net_input"]["slots"][0].value["inputs"].shape
    mrng = jax.random.fold_in(rng, 7)
    frame = jsp.span_mask(mrng, B, jsp.subsampled_length(T, 4), 0.65, 10)
    chan = jsp.span_mask(jax.random.fold_in(mrng, 1), B, M, 0.2, 10) if channel else None
    return frame, chan


def _grads_match(tm, jgrads):
    tgrads = export_params(tm.net, {n: torch.zeros_like(p) if p.grad is None else p.grad
                                    for n, p in tm.net.named_parameters()})
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    for path, g in jax.tree_util.tree_leaves_with_path(tgrads):
        np.testing.assert_allclose(g, np.asarray(flat_j[path]), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("channel", [False, True])
def test_speech_pretrain_loss_and_gradients_match(env, channel):
    kw = dict(mask_channel_prob=0.2) if channel else {}
    jcrit, tcrit = _criteria(env, **kw)
    rng = jax.random.PRNGKey(4)

    def jloss(p):
        loss, _, log = jcrit(env["jm"], p, env["jb"], rng=rng, train=True)
        return loss, log

    (jl, jlog), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(env["params"])
    frame, chan = _jax_masks(env, rng, channel)
    tm = env["tm"]
    load_jax_params(tm.net, env["params"])
    tm.net.zero_grad()
    sample = sample_to_device(env["tb"], "cpu")
    tl, tss, tlog = tcrit(tm, sample, torch.Generator().manual_seed(4), train=True,
                          frame_mask=torch.as_tensor(np.array(frame)),
                          channel_mask=None if chan is None else torch.as_tensor(np.array(chan)))
    tl.backward()
    assert float(jlog["mam_loss"]) > 0 and int(jlog["n_masked"]) > 0
    for key in ("loss", "nll_loss", "mam_loss"):
        np.testing.assert_allclose(float(tlog[key]), float(jlog[key]), rtol=LOSS_RTOL, err_msg=key)
    assert int(tlog["n_masked"]) == int(jlog["n_masked"])
    assert float(tss) == float(jlog["sample_size"])
    _grads_match(tm, jgrads)


def test_eval_call_is_the_label_smoothed_ce(env):
    """train=False (or no generator): no masking, no KL term."""
    jcrit, tcrit = _criteria(env)
    jl, _, jlog = jax.jit(lambda p: jcrit(env["jm"], p, env["jb"], rng=None, train=False))(env["params"])
    load_jax_params(env["tm"].net, env["params"])
    with torch.no_grad():
        tl, _, tlog = tcrit(env["tm"], sample_to_device(env["tb"], "cpu"), None, train=False)
    assert "mam_loss" not in tlog and "mam_loss" not in jlog
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)


def test_drawn_masks_reach_the_student(env):
    """Without a handed-in mask the criterion draws one from the step's
    generator: the same generator seed gives the same loss, another seed
    another loss, and n_masked is that mask's count of valid frames."""
    _, tcrit = _criteria(env)
    tm = env["tm"]
    sample = sample_to_device(env["tb"], "cpu")
    with torch.no_grad():
        a = tcrit(tm, sample, torch.Generator().manual_seed(0), train=True)[2]
        b = tcrit(tm, sample, torch.Generator().manual_seed(0), train=True)[2]
        c = tcrit(tm, sample, torch.Generator().manual_seed(9), train=True)[2]
        B, T, _ = sample["net_input"]["slots"][0].value["inputs"].shape
        mask = tsp.span_mask(torch.Generator().manual_seed(0), B, tsp.subsampled_length(T, 4), 0.65, 10)
        enc = tm.net.encode(slots_to_device([env["tb"]["net_input"]["slots"][0]], "cpu"))
    assert float(a["mam_loss"]) == float(b["mam_loss"]) != float(c["mam_loss"])
    assert int(a["n_masked"]) == int((mask & ~enc.padding_mask).sum())


def test_audio_pretraining_task_fits(tmp_path):
    task = ConfigStore().get("ofasys.task", "audio_pretraining").target_cls()
    assert task.cfg.criterion == "speech_pretrain_loss"
    task.cfg.dataset.batch_size = 4
    task.add_dataset(_asr_records(np.random.default_rng(2), 8), "train")
    model = GeneralistModel(arch="tiny")
    _tiny_cfg(model)
    cfg = TrainerConfig()
    cfg.common.dtype = "float32"
    cfg.checkpoint.no_save = True
    cfg.checkpoint.save_dir = str(tmp_path)
    trainer = Trainer(cfg, device="cpu")
    trainer.fit(model, [task], max_update=2)
    assert int(trainer.state.step) == 2
    assert np.isfinite(trainer.meters["audio_pretraining:loss"].avg)
    assert type(task.criterion).__name__ == "SpeechPretrainCriterion"
