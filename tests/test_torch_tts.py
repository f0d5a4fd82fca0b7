"""Text to speech in ofasys_torch against ofasys_tpu: the ``audio_tgt_fbank``
adaptor and its ``forward_output``, ``ofa_tacotron2`` with and without the
guided-attention loss (loss, logging and gradients), the AR speech
generator's frames, EOS probabilities and lengths, gcmvn denormalization,
the prenet's inference-time dropout, the hub's AUDIO targets and a
``Task("text_to_speech")`` fit.

Tiny arch (2+2 layers, E=64, FFN 256, 4 heads), fp32 on both sides, the
same perturbed parameters (``load_jax_params``), 16 kHz wavs of 0.15-0.3 s
synthesised from a numpy seed as TTS targets (80-bin fbank frames).
ofasys_tpu draws the prenet's dropout from ``jax.random``, which the port
cannot reproduce: the parity tests run with ``prenet_dropout = 0.0`` on
both sides, and a separate test holds the port's dropout to its keep rate
and its seeds.

Tolerances: the adaptor's outputs atol 1e-5; the whole forward's mel
frames and EOS logits atol 1e-4; losses rtol 1e-5; gradients atol 1e-5 +
rtol 1e-4 (fp32 sums in another order); generated frames and EOS
probabilities atol 1e-4, lengths equal (the threshold is chosen at least
1e-3 from every EOS probability).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu.configure import ConfigStore as JConfigStore
from ofasys_tpu.engine.criterion.tacotron2_loss import (
    Tacotron2Criterion as JTacotron2,
    Tacotron2CriterionConfig as JTacotron2Config,
)
from ofasys_tpu.generator.speech_generator import AutoRegressiveSpeechGenerator as JSpeechGenerator
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction, OFASys, Trainer, TrainerConfig
from ofasys_torch.adaptor.audio import AudioTgtFbankAdaptorConfig
from ofasys_torch.engine.criterion import Tacotron2Criterion, Tacotron2CriterionConfig
from ofasys_torch.generator import AutoRegressiveSpeechGenerator, SpeechGeneratorOutput
from ofasys_torch.model.transformer import AttentionProbs
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.task.tasks import TextToSpeechTask
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import sample_to_device, slots_to_device

from test_torch_audio import (  # noqa: F401  (fixture)
    _dictionary, _one_torch_thread, _port_params, _tiny_cfg, _wav_bytes, _wave, _words,
)

TTS = "[TEXT:text] -> [AUDIO:wav,adaptor=audio_tgt_fbank]"
COPY = "[TEXT:src] -> [TEXT:tgt]"
ADAPTORS = ("text", "audio_tgt_fbank")
OUT_ATOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
EOS_MARGIN = 1e-3
MAX_ITER = 12


def _records(rng, n):
    return [{"text": _words(rng, int(rng.integers(8, 20))),
             "wav": _wav_bytes(_wave(rng, rng.uniform(0.15, 0.3)))} for _ in range(n)]


@pytest.fixture(scope="module")
def env():
    """Both models share one set of perturbed weights in ofasys_tpu's tree
    (its init traced over the TTS batch and a text batch, the decoder's
    text adaptor), with the prenet's dropout at 0 on both sides."""
    node = JConfigStore().get("ofasys.adaptor", "audio_tgt_fbank").config
    saved = node.prenet_dropout
    node.prenet_dropout = 0.0
    jd = _dictionary(JDictionary)
    jm = JModel(arch="tiny")
    _tiny_cfg(jm)
    jgp = JGeneralPreprocess(jd, active=["text", "audio"])
    jm.initialize(jd, active_adaptors=ADAPTORS, dtype=jnp.float32)

    td = _dictionary(Dictionary)
    tm = GeneralistModel(arch="tiny")
    _tiny_cfg(tm)
    tgp = GeneralPreprocess(td, active=["text", "audio"])
    tm.initialize(td, active_adaptors=ADAPTORS, dtype=torch.float32, device="cpu",
                  adaptor_cfgs={"audio_tgt_fbank": AudioTgtFbankAdaptorConfig(prenet_dropout=0.0)})

    recs = _records(np.random.default_rng(3), 4)
    jb = jgp.collate([jgp(JInstruction(TTS, split="train").format(**r)) for r in recs])
    tb = tgp.collate([tgp(Instruction(TTS, split="train").format(**r)) for r in recs])
    text = [{"src": "a dog", "tgt": "runs"}] * 2
    jt = jgp.collate([jgp(JInstruction(COPY, split="train").format(**r)) for r in text])
    params = _port_params(jm, tm, [jb["net_input"]["slots"], jt["net_input"]["slots"]])
    yield dict(jm=jm, jd=jd, jgp=jgp, tm=tm, td=td, tgp=tgp, params=params, jb=jb, tb=tb, recs=recs)
    node.prenet_dropout = saved


def test_tts_batches_identical_and_adaptor_on_decoder_side(env):
    js, ts = env["jb"], env["tb"]
    for a, b in zip(js["net_input"]["slots"], ts["net_input"]["slots"], strict=True):
        assert (a.modality.name, a.is_src) == (b.modality.name, b.is_src)
        for key in a.value:
            np.testing.assert_array_equal(b.value[key], np.asarray(a.value[key]))
    np.testing.assert_array_equal(ts["target"], js["target"])
    np.testing.assert_array_equal(ts["target_lengths"], js["target_lengths"])
    names = [n for n, _ in env["tm"].net.named_parameters()]
    assert "decoder_adaptor.audio_tgt_fbank.postnet_4.kernel" in names
    assert not any(n.startswith("encoder_adaptor.audio_tgt_fbank") for n in names)
    back = export_params(env["tm"].net)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(env["params"]))
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        np.testing.assert_array_equal(a, np.asarray(flat_j[path]), err_msg=jax.tree_util.keystr(path))


def test_adaptor_and_forward_output_match(env):
    """The adaptor's embedding and positions, and forward_output's mel,
    feature_before and eos_logits, on the decoder's hidden states."""
    jm, tm = env["jm"], env["tm"]
    jslots = env["jb"]["net_input"]["slots"]
    tslots = slots_to_device(env["tb"]["net_input"]["slots"], "cpu")
    j_ad = jm.net.apply({"params": env["params"]}, [jslots[1]],
                        method=lambda net, s: net.decoder_adaptor(s))
    with torch.no_grad():
        t_ad = tm.net.decoder_adaptor([tslots[1]])
    np.testing.assert_allclose(t_ad.embed.numpy(), np.asarray(j_ad.embed), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_ad.pos_embed.numpy(), np.asarray(j_ad.pos_embed), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t_ad.padding_mask.numpy(), np.asarray(j_ad.padding_mask))

    jmel, jextra = jax.jit(lambda p, s: jm.apply(p, s))(env["params"], jslots)
    with torch.no_grad():
        tmel, textra = tm.apply(tslots)
    assert tuple(tmel.shape) == env["tb"]["target"].shape
    np.testing.assert_allclose(tmel.numpy(), np.asarray(jmel), rtol=0, atol=OUT_ATOL)
    for key in ("feature_before", "eos_logits"):
        np.testing.assert_allclose(textra[key].numpy(), np.asarray(jextra[key]), rtol=0, atol=OUT_ATOL)


@pytest.mark.parametrize("guided", [False, True])
def test_tacotron2_loss_and_gradients_match(env, guided):
    jm, tm = env["jm"], env["tm"]
    jcrit = JTacotron2(JTacotron2Config(use_guided_attention_loss=guided), pad_id=env["jd"].pad())
    tcrit = Tacotron2Criterion(Tacotron2CriterionConfig(use_guided_attention_loss=guided),
                               pad_id=env["td"].pad())

    def jloss(p):
        loss, _, log = jcrit(jm, p, env["jb"], rng=jax.random.PRNGKey(1), train=True)
        return loss, log

    (jl, jlog), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(env["params"])
    load_jax_params(tm.net, env["params"])
    tm.net.zero_grad()
    sample = sample_to_device(env["tb"], "cpu")
    tl, tss, tlog = tcrit(tm, sample, torch.Generator().manual_seed(1), train=True)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    keys = ("loss", "l1_loss", "mse_loss", "eos_loss") + (("guided_attention_loss",) if guided else ())
    for key in keys:
        np.testing.assert_allclose(float(tlog[key]), float(jlog[key]), rtol=LOSS_RTOL, err_msg=key)
    assert int(tlog["ntokens"]) == int(jlog["ntokens"]) == float(tss)
    if guided:
        assert float(jlog["guided_attention_loss"]) > 0
    tgrads = export_params(tm.net, {n: torch.zeros_like(p) if p.grad is None else p.grad
                                    for n, p in tm.net.named_parameters()})
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    for path, g in jax.tree_util.tree_leaves_with_path(tgrads):
        np.testing.assert_allclose(g, np.asarray(flat_j[path]), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_attention_observer_keeps_routes_and_costs_nothing_outside(env):
    """The observer returns one (B, H, Tq, Tk) map per decoder
    cross-attention, rows summing to 1; the forward's outputs are the same
    bits with and without it, and nothing is recorded outside its block."""
    tm = env["tm"]
    tslots = slots_to_device(env["tb"]["net_input"]["slots"], "cpu")
    with torch.no_grad():
        plain, _ = tm.apply(tslots)
        with AttentionProbs(tm.net, lambda n: n.endswith("encoder_attn")) as obs:
            seen, _ = tm.apply(tslots)
        after, _ = tm.apply(tslots)
    assert [n for n, _ in obs.maps] == ["decoder.layers_0.encoder_attn", "decoder.layers_1.encoder_attn"]
    B, Tt, Ts = 4, tslots[1].value["inputs"].shape[1], tslots[0].value["inputs"].shape[1]
    for _, p in obs.maps:
        assert tuple(p.shape) == (B, 4, Tt, Ts)
        np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-5)
    assert torch.equal(plain, seen) and torch.equal(plain, after)
    assert len(obs.maps) == 2


def _generators(env, **kw):
    return (JSpeechGenerator(env["jm"], max_iter=MAX_ITER, **kw),
            AutoRegressiveSpeechGenerator(env["tm"], max_iter=MAX_ITER, **kw))


def _threshold(eos, margin=EOS_MARGIN):
    """A threshold that stops some samples early: the median of the first
    steps' probabilities, moved off every probability by ``margin``."""
    cands = np.sort(np.concatenate([np.median(eos[:, :MAX_ITER // 2], axis=1),
                                    np.linspace(eos.min(), eos.max(), 64)]))
    for thr in cands:
        if np.abs(eos - thr).min() > margin and (eos > thr).any() and not (eos > thr).all():
            return float(thr)
    raise AssertionError(f"no threshold {margin} away from every EOS probability")


def test_speech_generator_frames_eos_and_lengths_match(env):
    """Never stopping (threshold 2): every step's frame and EOS probability;
    then a threshold between the probabilities: the lengths and the frames
    up to them."""
    load_jax_params(env["tm"].net, env["params"])
    jgen, tgen = _generators(env, eos_prob_threshold=2.0)
    jout = jgen.generate(env["params"], env["jb"], seed=0)
    tout = tgen.generate(env["tb"], seed=0)
    jeos = np.stack([o.eos_prob for o in jout])
    for a, b in zip(jout, tout, strict=True):
        assert isinstance(b, SpeechGeneratorOutput) and b.feature.shape == (MAX_ITER, 80)
        np.testing.assert_allclose(b.feature, a.feature, rtol=0, atol=OUT_ATOL)
        np.testing.assert_allclose(b.eos_prob, a.eos_prob, rtol=0, atol=OUT_ATOL)
        np.testing.assert_array_equal(b.targ_feature, a.targ_feature)

    thr = _threshold(jeos)
    jgen, tgen = _generators(env, eos_prob_threshold=thr)
    jout = jgen.generate(env["params"], env["jb"], seed=0)
    tout = tgen.generate(env["tb"], seed=0)
    lengths = [len(o.feature) for o in jout]
    assert [len(o.feature) for o in tout] == lengths
    assert min(lengths) < MAX_ITER
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.feature, a.feature, rtol=0, atol=OUT_ATOL)


def test_gcmvn_denormalization_matches(env):
    rng = np.random.default_rng(5)
    stats = (rng.standard_normal(80).astype(np.float32), rng.uniform(0.5, 2, 80).astype(np.float32))
    jgen, tgen = _generators(env, eos_prob_threshold=2.0, gcmvn_stats=stats)
    jout = jgen.generate(env["params"], env["jb"], seed=0)
    tout = tgen.generate(env["tb"], seed=0)
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.feature, a.feature, rtol=1e-6, atol=OUT_ATOL * 2)
        np.testing.assert_allclose(b.targ_feature, a.targ_feature, rtol=1e-6, atol=1e-6)
    x = rng.standard_normal((7, 80)).astype(np.float32)
    np.testing.assert_array_equal(tgen.gcmvn_denormalize(x), jgen.gcmvn_denormalize(x))


def test_prenet_dropout_at_inference(env):
    """prenet_dropout 0.5 under a noise generator: about half of the prenet's
    positive activations kept (each scaled by 2), the same seed repeats its
    frames, another seed gives other frames; without a noise generator the
    prenet is deterministic."""
    tm = GeneralistModel(arch="tiny")
    _tiny_cfg(tm)
    tm.initialize(env["td"], active_adaptors=ADAPTORS, dtype=torch.float32, device="cpu")
    load_jax_params(tm.net, env["params"])
    ad = tm.net.decoder_adaptor.audio_tgt_fbank
    assert ad.acfg.prenet_dropout == 0.5
    slot = slots_to_device(env["tb"]["net_input"]["slots"], "cpu")[1]
    seen = []
    hook = ad.prenet_1.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach()))
    with torch.no_grad():
        ad(slot, None, noise_generator=torch.Generator().manual_seed(0))
        ad(slot)
    hook.remove()
    pre = torch.relu(ad.prenet_0(slot.value["inputs"]))
    positive = pre > 0
    kept = seen[0][positive] != 0
    rate = kept.float().mean().item()
    assert abs(rate - 0.5) < 0.02, rate
    torch.testing.assert_close(seen[0][positive][kept], 2 * pre[positive][kept], rtol=1e-6, atol=1e-6)
    assert torch.equal(seen[1], pre)

    gen = AutoRegressiveSpeechGenerator(tm, max_iter=6, eos_prob_threshold=2.0)
    a, b, c = (gen.generate(env["tb"], seed=s) for s in (0, 0, 1))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.feature, y.feature)
    assert any(not np.array_equal(x.feature, z.feature) for x, z in zip(a, c))


def test_hub_serves_audio_targets_through_the_speech_generator(env):
    """An AUDIO target on the hub: one SpeechGeneratorOutput a request with
    the generator's frames and a Griffin-Lim waveform."""
    load_jax_params(env["tm"].net, env["params"])
    hub = OFASys(env["tm"], None, env["td"], env["tgp"], device="cpu")
    data = [{"text": r["text"]} for r in env["recs"][:2]]
    outs = hub.inference(TTS, data, max_iter=6, eos_prob_threshold=2.0)
    direct = AutoRegressiveSpeechGenerator(env["tm"], max_iter=6, eos_prob_threshold=2.0).generate(
        env["tgp"].collate([env["tgp"](Instruction(TTS, split="test").format(**r)) for r in data]))
    assert len(outs) == 2
    for o, d in zip(outs, direct):
        np.testing.assert_array_equal(o.feature, d.feature)
        assert o.waveform is not None and o.waveform.ndim == 1 and np.isfinite(o.waveform).all()


def test_text_to_speech_task_fits_and_infers(tmp_path):
    """Task("text_to_speech") initializes, takes 2 updates through
    Trainer.fit with guided attention on, and its inference returns
    waveforms."""
    recs = _records(np.random.default_rng(7), 8)
    task = TextToSpeechTask()
    task.cfg.criterion_args = {"use_guided_attention_loss": True}
    task.cfg.dataset.batch_size = 4
    task.add_dataset(recs, "train")
    model = GeneralistModel(arch="tiny")
    _tiny_cfg(model)
    cfg = TrainerConfig()
    cfg.common.dtype = "float32"
    cfg.checkpoint.no_save = True
    cfg.checkpoint.save_dir = str(tmp_path)
    trainer = Trainer(cfg, device="cpu")
    trainer.fit(model, [task], max_update=2)
    assert int(trainer.state.step) == 2
    assert np.isfinite(trainer.meters["text_to_speech:loss"].avg)
    assert type(task.criterion).__name__ == "Tacotron2Criterion"
    batch = next(task.get_batch_iterator("train", fresh=True).next_epoch_itr(shuffle=False))
    outs = task.inference(model, None, batch, max_iter=4, eos_prob_threshold=2.0)
    assert len(outs) == 4 and all(o.waveform is not None and o.feature.shape == (4, 80) for o in outs)
    assert dataclasses.is_dataclass(outs[0])
