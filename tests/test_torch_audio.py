"""The audio modality of ofasys_torch against ofasys_tpu: the numpy audio
utilities, the ``audio`` and ``audio_embed`` preprocessors, the
``audio_fbank`` adaptor, the encoder on audio + text sources, ASR serving
and ``speech_to_text_loss``.

Tiny arch (2+2 layers, E=64, FFN 256, 4 heads), fp32 on both sides,
16 kHz 16-bit wavs synthesised from a numpy seed (tones plus noise) and
written with the stdlib ``wave`` module, the same perturbed parameters
(carried with ``load_jax_params``).

Tolerances:
  * audio utilities and preprocessing: bit-equal;
  * the audio_fbank adaptor: atol 1e-5 (fp32 convolutions and products
    summed in another order); the encoder output on audio + text: atol 1e-4;
  * beam and greedy tokens: identical, scores atol 1e-4 (each JAX run first
    shows that no top-k boundary of its decode loop is a near-tie);
  * speech_to_text_loss: loss, nll_loss and sample_size rtol 1e-5.

The fbank frames of a batch are padded with 0.0, and the second
convolution sees ``gelu(bias)`` at padded frames on both sides: a request's
encoder states depend on the longest request of its batch, so served
batches are held against the hub on the same batch composition.
"""

import base64
import io
import wave

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction, ModalityType as JModality
from ofasys_tpu import OFASys as JOFASys
from ofasys_tpu.adaptor import audio as jaudio
from ofasys_tpu.engine.criterion.cross_entropy import (
    CrossEntropyCriterion as JCECriterion,
    CrossEntropyCriterionConfig as JCEConfig,
    SpeechToTextCriterion as JS2TCriterion,
    SpeechToTextCriterionConfig as JS2TConfig,
)
from ofasys_tpu.preprocessor import audio as jpaudio
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_tpu.preprocessor.instruction import Slot as JSlot
from ofasys_tpu.utils import audio_utils as jau
from ofasys_tpu.utils.pytree import SlotBatch as JSlotBatch
from ofasys_torch import GeneralistModel, Instruction, ModalityType, OFASys
from ofasys_torch.adaptor import audio as taudio
from ofasys_torch.engine.criterion import (
    CrossEntropyCriterion,
    CrossEntropyCriterionConfig,
    SpeechToTextCriterion,
    SpeechToTextCriterionConfig,
)
from ofasys_torch.preprocessor import audio as tpaudio
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.preprocessor.instruction import Slot
from ofasys_torch.serve import InferenceServer
from ofasys_torch.utils import audio_utils as tau
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import SlotBatch, sample_to_device, slots_to_device

ASR = "[AUDIO:wav] what is the transcription? -> [TEXT:text]"
SR = 16000
NEG_INF = -1e9
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wave(rng, seconds, sr=SR):
    """Two tones plus noise in [-1, 1], float32."""
    t = np.arange(int(sr * seconds)) / sr
    f1, f2 = rng.uniform(150, 900, 2)
    x = 0.4 * np.sin(2 * np.pi * f1 * t) + 0.2 * np.sin(2 * np.pi * f2 * t)
    return (x + 0.05 * rng.standard_normal(t.shape)).clip(-1, 1).astype(np.float32)


def _wav_bytes(x, sr=SR, width=2, channels=1):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        if width == 1:
            pcm = np.round(x * 127 + 128).astype(np.uint8)
        else:
            pcm = np.round(x * 32767).astype(np.int16)
        if channels > 1:
            pcm = np.repeat(pcm[:, None], channels, axis=1)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


# ------------------------------------------------------------ audio utilities
@pytest.mark.parametrize("kind", ["pcm16", "pcm8", "stereo", "tuple", "array", "path"])
def test_load_wav_is_bit_equal(kind, tmp_path):
    rng = np.random.default_rng(0)
    x = _wave(rng, 0.25)
    value = {"pcm16": _wav_bytes(x), "pcm8": _wav_bytes(x, width=1),
             "stereo": _wav_bytes(x, channels=2), "tuple": (x, 8000), "array": x}.get(kind)
    if kind == "path":
        value = str(tmp_path / "a.wav")
        with open(value, "wb") as f:
            f.write(_wav_bytes(x, sr=22050))
    a, sa = jau.load_wav(value)
    b, sb = tau.load_wav(value)
    assert sa == sb and b.dtype == np.float32
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("num_mels,sr", [(80, 16000), (40, 8000), (128, 22050)])
def test_fbank_and_filterbank_are_bit_equal(num_mels, sr):
    rng = np.random.default_rng(1)
    x = _wave(rng, 0.4, sr)
    np.testing.assert_array_equal(tau.mel_filterbank(num_mels, 512, sr), jau.mel_filterbank(num_mels, 512, sr))
    a = jau.logmel_fbank(x, sr, num_mels)
    b = tau.logmel_fbank(x, sr, num_mels)
    assert b.dtype == np.float32 and b.shape[1] == num_mels
    np.testing.assert_array_equal(b, a)
    # a wave shorter than one frame is padded to one frame on both sides
    np.testing.assert_array_equal(tau.logmel_fbank(x[:100], sr, num_mels), jau.logmel_fbank(x[:100], sr, num_mels))
    stats = (a.mean(0) + 0.1, a.std(0) + 0.5)
    np.testing.assert_array_equal(tau.apply_cmvn(b), jau.apply_cmvn(a))
    np.testing.assert_array_equal(tau.apply_cmvn(b, stats), jau.apply_cmvn(a, stats))


@pytest.mark.parametrize("shape,opts", [((120, 80), {}), ((30, 80), {"time_mask_p": 0.2}),
                                        ((200, 40), {"freq_mask_n": 3, "time_mask_t": 10})])
def test_spec_augment_draws_in_the_same_order(shape, opts):
    feats = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    ja, ta = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        np.testing.assert_array_equal(tau.spec_augment(feats, ta, **opts),
                                      jau.spec_augment(feats, ja, **opts))
    assert ja.integers(0, 1 << 30) == ta.integers(0, 1 << 30)


def test_griffin_lim_is_bit_equal():
    feats = jau.logmel_fbank(_wave(np.random.default_rng(3), 0.2))
    np.testing.assert_array_equal(tau.griffin_lim(feats, n_iter=2), jau.griffin_lim(feats, n_iter=2))


# -------------------------------------------------------------- preprocessors
def _pair(cls_name, **cfg):
    jcls, tcls = getattr(jpaudio, cls_name), getattr(tpaudio, cls_name)
    jcfg = getattr(jpaudio, cls_name + "Config")(**cfg)
    tcfg = getattr(tpaudio, cls_name + "Config")(**cfg)
    return jcls(None, jcfg), tcls(None, tcfg)


def _collated(pre, slot_cls, modality, values, is_src=True, split="test"):
    slots = [pre.map(slot_cls(modality, is_src, value=v, column_name="wav", split=split)) for v in values]
    return slots, pre.collate(slots)


@pytest.mark.parametrize("case", ["eval", "train_specaugment", "no_cmvn", "global_cmvn",
                                  "pad_to_fixed", "precomputed", "max_frames"])
def test_audio_preprocess_is_bit_equal(case, tmp_path):
    rng = np.random.default_rng(4)
    values = [_wav_bytes(_wave(rng, s)) for s in (0.31, 0.52, 0.2)]
    cfg, split = {}, "test"
    if case == "train_specaugment":
        split, cfg = "train", {"seed": 5}
    elif case == "no_cmvn":
        cfg = {"cmvn": "none", "pad_to_multiple": 1}
    elif case == "global_cmvn":
        path = str(tmp_path / "cmvn.npz")
        np.savez(path, mean=np.linspace(-3, 1, 80).astype(np.float32),
                 std=np.linspace(0.5, 2, 80).astype(np.float32))
        cfg = {"cmvn": "global", "gcmvn_stats_path": path}
    elif case == "pad_to_fixed":
        cfg = {"pad_to_fixed": True, "max_frames": 64}
    elif case == "precomputed":
        values = [rng.standard_normal((n, 80)).astype(np.float32) * 3 for n in (20, 33)]
    elif case == "max_frames":
        cfg = {"max_frames": 24}
    jpre, tpre = _pair("AudioPreprocess", **cfg)
    for _ in range(2):                     # the train split's generator advances alike
        js, jc = _collated(jpre, JSlot, JModality.AUDIO, values, split=split)
        ts, tc = _collated(tpre, Slot, ModalityType.AUDIO, values, split=split)
        for a, b in zip(js, ts, strict=True):
            np.testing.assert_array_equal(b.value["inputs"], a.value["inputs"])
        for key in ("inputs", "lengths"):
            got, want = tc.net_input_slot.value[key], jc.net_input_slot.value[key]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        assert tc.net_target_slot is None and tc.sample_extra is None
    if case == "pad_to_fixed":
        assert tc.net_input_slot.value["inputs"].shape[1] == 64
    if case == "train_specaugment":
        assert (ts[0].value["inputs"] == 0).any()
    np.testing.assert_array_equal(tpre.gcmvn_stats()[0] if tpre.gcmvn_stats() else 0,
                                  jpre.gcmvn_stats()[0] if jpre.gcmvn_stats() else 0)


@pytest.mark.parametrize("k", [1, 2])
def test_audio_target_side_is_bit_equal(k):
    """The TTS target side: frames packed k a row, the open slot, collate
    extras, and decode through Griffin-Lim."""
    rng = np.random.default_rng(6)
    values = [_wav_bytes(_wave(rng, s)) for s in (0.15, 0.22)]
    jpre, tpre = _pair("AudioPreprocess", n_frames_per_step=k, specaugment=False)
    js, jc = _collated(jpre, JSlot, JModality.AUDIO, values, is_src=False, split="train")
    ts, tc = _collated(tpre, Slot, ModalityType.AUDIO, values, is_src=False, split="train")
    np.testing.assert_array_equal(tc.net_input_slot.value["inputs"], jc.net_input_slot.value["inputs"])
    assert tc.net_target_slot is tc.net_input_slot
    assert set(tc.sample_extra) == set(jc.sample_extra)
    for key, want in jc.sample_extra.items():
        np.testing.assert_array_equal(tc.sample_extra[key], want)
    empty_j = jpre.map(JSlot(JModality.AUDIO, False, value=None, column_name="wav"))
    empty_t = tpre.map(Slot(ModalityType.AUDIO, False, value=None, column_name="wav"))
    assert empty_t.value["inputs"].shape == empty_j.value["inputs"].shape == (0, 80 * k)
    feature = js[0].value["inputs"][:6]
    np.testing.assert_array_equal(tpre.decode(feature), jpre.decode(feature))


@pytest.mark.parametrize("form", ["array", "base64", "short"])
def test_audio_embed_preprocess_is_bit_equal(form):
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((50, 12)).astype(np.float32)
    cfg = dict(audio_feature_dim=12, audio_feature_length=32)
    value = feats
    if form == "base64":
        value = {"data": base64.b64encode(feats.astype(">f4").tobytes()).decode(), "start_index": 5}
    elif form == "short":
        value = feats[:20]
    jpre, tpre = _pair("AudioEmbedPreprocess", **cfg)
    _, jc = _collated(jpre, JSlot, JModality.AUDIO, [value, value])
    _, tc = _collated(tpre, Slot, ModalityType.AUDIO, [value, value])
    for key in ("inputs", "lengths"):
        np.testing.assert_array_equal(tc.net_input_slot.value[key], jc.net_input_slot.value[key])


def test_general_preprocess_builds_audio_and_keeps_pending_items():
    d = Dictionary()
    gp = GeneralPreprocess(d, active=["text", "audio", "audio_embed", "motion_6d"])
    assert set(gp.name2pre) == {"text", "audio", "audio_embed", "motion_6d"}
    assert type(GeneralPreprocess(d, active=["box"]).name2pre["box"]).__name__ == "BoxPreprocess"
    with pytest.raises(NotImplementedError, match="Queue A item 11"):
        GeneralPreprocess(d, active=["phone"])


# ----------------------------------------------------------- audio_fbank
def _tiny_cfg(m, layers=2):
    c = m.cfg
    for stack in (c.encoder, c.decoder):
        stack.embed_dim, stack.ffn_embed_dim, stack.attention_heads, stack.layers = 64, 256, 4, layers
    c.dropout = 0.0


def _perturb(params, seed=0, kernel_gain=1.0):
    """Random values for tables and biases, so every parameter matters."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        name = path[-1].key
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if name in ("rel_pos_table", "image_rel_pos_table"):
            return 0.3 * noise
        if name in ("bias", "type_embedding", "c_attn", "mask_emb"):
            return a + 0.05 * noise
        if name == "scale":
            return a + 0.1 * noise
        if name == "kernel":
            return a * kernel_gain
        return a

    return jax.tree_util.tree_map_with_path(f, jax.device_get(params))


@pytest.mark.parametrize("extra_layers", [0, 1])
@pytest.mark.parametrize("masks", ["none", "channel", "frames", "both"])
def test_audio_fbank_adaptor_matches_flax(extra_layers, masks):
    rng = np.random.default_rng(9)
    B, T = 3, 37                                   # odd T: both stride-2 stages round up
    feats = rng.standard_normal((B, T, 80)).astype(np.float32)
    lengths = np.asarray([37, 30, 9], np.int32)
    value = {"inputs": feats, "lengths": lengths}
    Ts = -(-T // 4)
    if masks in ("channel", "both"):
        value["mask_channel_indices"] = rng.random((B, 80)) < 0.2
    if masks in ("frames", "both"):
        value["mask_indices"] = rng.random((B, Ts)) < 0.3
    jm, tm = JModel(arch="tiny"), GeneralistModel(arch="tiny")
    _tiny_cfg(jm)
    _tiny_cfg(tm)
    acfg = dict(extra_encoder_layers=extra_layers)
    jad = jaudio.AudioFbankAdaptor(
        cfg=jm.cfg, adaptor_cfg=jaudio.AudioFbankAdaptorConfig(**acfg), is_src=True,
        embed_tokens=nn.Embed(16, 64), pad_id=1, dtype=jnp.float32)
    jslot = JSlotBatch(JModality.AUDIO, True, value={k: jnp.asarray(v) for k, v in value.items()},
                       column_name="wav")
    params = _perturb(jad.init(jax.random.PRNGKey(1), jslot)["params"], seed=4)
    want = jad.apply({"params": params}, jslot)

    tad = taudio.AudioFbankAdaptor(tm.cfg, True, torch.nn.Embedding(16, 64), 1, torch.float32,
                                   taudio.AudioFbankAdaptorConfig(**acfg))
    load_jax_params(tad, params)
    tslot = slots_to_device([SlotBatch(ModalityType.AUDIO, True, value=value, column_name="wav")], "cpu")[0]
    with torch.no_grad():
        got = tad(tslot)
    assert tuple(got.embed.shape) == (B, Ts, 64) and got.modal_id == want.modal_id == 3
    np.testing.assert_allclose(got.embed.numpy(), np.asarray(want.embed), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.pos_embed.numpy(), np.asarray(want.pos_embed), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.padding_mask.numpy(), np.asarray(want.padding_mask))
    np.testing.assert_array_equal(got.padding_mask.numpy().sum(1), Ts - np.ceil(lengths / 4))
    np.testing.assert_array_equal(got.rel_bucket, want.rel_bucket)
    # the flax-shaped tree comes back leaf for leaf ((5, in, out) conv kernels included)
    back = export_params(tad)
    assert back["subsample_0"]["kernel"].shape == (5, 80, 256)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        np.testing.assert_array_equal(a, np.asarray(flat_j[path]), err_msg=jax.tree_util.keystr(path))


def test_unported_audio_adaptors_raise():
    d = Dictionary()
    m = GeneralistModel(arch="tiny")
    with pytest.raises(NotImplementedError, match="audio_tgt_fbank.*Queue A item 10"):
        m.initialize(d, active_adaptors=("text", "audio_tgt_fbank"), device="cpu")


# ------------------------------------------------------------- whole model
def _dictionary(cls):
    d = cls()
    for i in range(60):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def _words(rng, n_chars):
    words = ["a", "dog", "runs", "on", "the", "beach", "with", "red", "ball", "low", "tone",
             "high", "two", "people", "near", "water"]
    s = ""
    while len(s) < n_chars:
        s += rng.choice(words) + " "
    return s[:n_chars].strip()


def _asr_records(rng, n, seconds=(0.25, 0.6)):
    return [{"wav": _wav_bytes(_wave(rng, rng.uniform(*seconds))),
             "text": _words(rng, int(rng.integers(8, 14)))} for _ in range(n)]


@pytest.fixture(scope="module")
def env():
    jd = _dictionary(JDictionary)
    jm = JModel(arch="tiny")
    _tiny_cfg(jm)
    jgp = JGeneralPreprocess(jd, active=["text", "audio"])
    jm.initialize(jd, active_adaptors=("text", "audio_fbank"), dtype=jnp.float32)

    td = _dictionary(Dictionary)
    tm = GeneralistModel(arch="tiny")
    _tiny_cfg(tm)
    tgp = GeneralPreprocess(td, active=["text", "audio"])
    tm.initialize(td, active_adaptors=("text", "audio_fbank"), dtype=torch.float32, device="cpu")
    assert len(jd) == len(td) and jd.symbols == td.symbols

    recs = _asr_records(np.random.default_rng(10), 8)
    jb = jgp.collate([jgp(JInstruction(ASR, split="train").format(**r)) for r in recs])
    tb = tgp.collate([tgp(Instruction(ASR, split="train").format(**r)) for r in recs])
    params = _perturb(jm.init_params(jax.random.PRNGKey(0), jb["net_input"]["slots"]))
    return dict(jm=jm, jd=jd, jgp=jgp, tm=tm, td=td, tgp=tgp, params=params, jb=jb, tb=tb)


def test_asr_batches_identical(env):
    js, ts = env["jb"], env["tb"]
    for a, b in zip(js["net_input"]["slots"], ts["net_input"]["slots"], strict=True):
        assert (a.modality.name, a.is_src, a.column_name) == (b.modality.name, b.is_src, b.column_name)
        for key in a.value:
            np.testing.assert_array_equal(b.value[key], np.asarray(a.value[key]))
    np.testing.assert_array_equal(ts["target"], js["target"])
    # an AUDIO slot is a group of its own: the audio, the prompt and the target
    assert [s.modality.name for s in ts["net_input"]["slots"]] == ["AUDIO", "TEXT", "TEXT"]


def test_audio_fbank_lives_on_the_encoder_side_only(env):
    tm = env["tm"]
    names = [n for n, _ in tm.net.named_parameters()]
    assert any(n.startswith("encoder_adaptor.audio_fbank.subsample_1.") for n in names)
    assert not any(n.startswith("decoder_adaptor.audio_fbank") for n in names)
    load_jax_params(tm.net, env["params"])              # raises on a missing or an unused leaf
    back = export_params(tm.net)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(env["params"]))
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        np.testing.assert_array_equal(a, np.asarray(flat_j[path]), err_msg=jax.tree_util.keystr(path))


def test_fresh_audio_init_follows_flax(env):
    """The port's own initialization draws the conv kernels lecun-normal
    over the window's fan-in (5 * in) and mask_emb normal(0.02), as flax does."""
    ad = env["tm"].net.encoder_adaptor.audio_fbank
    fresh = GeneralistModel(arch="tiny")
    _tiny_cfg(fresh)
    fresh.initialize(env["td"], active_adaptors=("text", "audio_fbank"), dtype=torch.float32,
                     device="cpu", seed=3)
    fad = fresh.net.encoder_adaptor.audio_fbank
    flax_ad = env["params"]["encoder_adaptor"]["audio_fbank"]
    for i, fan_in in ((0, 5 * 80), (1, 5 * 256)):
        k = getattr(fad, f"subsample_{i}").kernel.detach().numpy()
        assert k.shape == np.asarray(flax_ad[f"subsample_{i}"]["kernel"]).shape
        assert abs(k.std() * np.sqrt(fan_in) - 1.0) < 0.05
        assert not getattr(fad, f"subsample_{i}").bias.detach().any()
    assert abs(fad.mask_emb.detach().std().item() - 0.02) < 0.005
    assert ad.acfg.extra_encoder_layers == 0


def test_encoder_on_audio_and_text_sources_matches(env):
    jm, tm = env["jm"], env["tm"]
    load_jax_params(tm.net, env["params"])
    jsrc = [s for s in env["jb"]["net_input"]["slots"] if s.is_src]
    tsrc = slots_to_device([s for s in env["tb"]["net_input"]["slots"] if s.is_src], "cpu")
    jenc = jm.net.apply({"params": env["params"]}, jsrc, method=jm.net.encode)
    with torch.no_grad():
        tenc = tm.net.encode(tsrc)
    frames = tsrc[0].value["inputs"].shape[1]
    n_text = tsrc[1].value["inputs"].shape[1]
    assert tuple(tenc.x.shape) == (8, -(-frames // 4) + n_text, 64)
    np.testing.assert_allclose(tenc.x.numpy(), np.asarray(jenc.x), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tenc.padding_mask.numpy(), np.asarray(jenc.padding_mask))
    np.testing.assert_allclose(tenc.pos_embed.numpy(), np.asarray(jenc.pos_embed), rtol=0, atol=1e-5)


def _recording_top_k(margins):
    orig = jax.lax.top_k

    def top_k(x, k):
        if k >= x.shape[-1]:
            return orig(x, k)
        vals, idx = orig(x, k + 1)

        def record(v):
            v = np.asarray(v)
            kth, nxt = v[..., k - 1], v[..., k]
            real = nxt > NEG_INF / 2
            margins.extend((kth - nxt)[real].tolist())

        jax.debug.callback(record, vals)
        return vals[..., :k], idx[..., :k]

    return top_k


@pytest.fixture(scope="module")
def serve_params(env):
    """Larger kernels and random embeddings, so the decode is not a tie."""
    rng = np.random.default_rng(11)

    def f(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "kernel":
            return a * 2.0
        if name == "embedding":
            return 0.3 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, env["params"])


@pytest.mark.parametrize("opts", [{"beam_size": 1, "max_len_b": 10}, {"beam_size": 3, "max_len_b": 10}],
                         ids=["greedy", "beam3"])
def test_hub_tokens_match_jax(env, serve_params, monkeypatch, opts):
    """Three wavs of different lengths in one batch: the shorter ones see
    the padded frames' ``gelu(bias)`` through the second convolution on
    both sides."""
    recs = [{"wav": r["wav"]} for r in _asr_records(np.random.default_rng(12), 3, (0.2, 0.7))]
    margins = []
    monkeypatch.setattr(jax.lax, "top_k", _recording_top_k(margins))
    jout = JOFASys(env["jm"], serve_params, env["jd"], env["jgp"]).inference(ASR, recs, **opts)
    monkeypatch.undo()
    assert margins and min(margins) > 1e-3, f"near-tie in the JAX run: {min(margins, default=None)}"
    hub = OFASys(env["tm"], serve_params, env["td"], env["tgp"], device="cpu")
    tout = hub.inference(ASR, recs, **opts)
    for a, b in zip(jout, tout, strict=True):
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens))
        assert abs(a.score - b.score) <= 1e-4
        assert a.text == b.text


class _Recorder:
    """Passes ``inference`` through to the hub and records each dispatch."""

    def __init__(self, hub):
        self.hub, self.device, self.calls = hub, hub.device, []

    def inference(self, instruction, data=None, **kw):
        out = self.hub.inference(instruction, data, **kw)
        self.calls.append((instruction, data, kw, out))
        return out


def test_server_batches_audio_requests(env, serve_params):
    """Served answers equal the hub's on the same batch composition (the
    server pads a group to a power of two by repeating its last record),
    and each future gets the answer to its own record."""
    hub = OFASys(env["tm"], serve_params, env["td"], env["tgp"], device="cpu")
    datas = [{"wav": r["wav"]} for r in _asr_records(np.random.default_rng(13), 5, (0.2, 0.7))]
    rec = _Recorder(hub)
    with InferenceServer(rec, max_batch=4, max_wait_ms=200.0, device="cpu") as srv:
        futs = [srv.submit(ASR, dd, beam_size=2, max_len_b=6) for dd in datas]
        outs = [f.result(timeout=300) for f in futs]
        st = srv.stats()
    assert st["requests"] == 5 and st["batches"] < 5
    where = {}
    for instruction, data, kw, out in rec.calls:
        direct = hub.inference(instruction, data, **kw)
        batch, served = (data, out) if isinstance(data, list) else ([data], [out])
        direct = direct if isinstance(data, list) else [direct]
        for d, o, r in zip(batch, served, direct, strict=True):
            np.testing.assert_array_equal(o.tokens, r.tokens)
            where[id(o)] = d
    for o, d in zip(outs, datas):
        assert where[id(o)]["wav"] is d["wav"]


# -------------------------------------------------------------- criterion
def _jax_sample(s, extra=()):
    out = {"net_input": {"slots": s["net_input"]["slots"]}, "target": jnp.asarray(s["target"])}
    for k in extra:
        out[k] = jnp.asarray(s[k])
    return out


@pytest.mark.parametrize("crit", ["speech_to_text", "speech_to_text_ctc_no_phones", "cross_entropy"])
def test_speech_to_text_loss_matches_jax(env, crit):
    """With ctc_weight > 0 and no phone targets in the sample both sides
    take the CE branch."""
    jm, tm = env["jm"], env["tm"]
    load_jax_params(tm.net, env["params"])
    pad = env["td"].pad()
    if crit == "cross_entropy":
        jc, tc = JCECriterion(JCEConfig(), pad), CrossEntropyCriterion(CrossEntropyCriterionConfig(), pad)
    else:
        kw = {"ctc_weight": 0.3} if crit.endswith("no_phones") else {}
        jc = JS2TCriterion(JS2TConfig(**kw), pad)
        tc = SpeechToTextCriterion(SpeechToTextCriterionConfig(**kw), pad)
    jl, jss, jlog = jc(jm, {"params": env["params"]}, _jax_sample(env["jb"]), None, train=False)
    with torch.no_grad():
        tl, tss, tlog = tc(tm, sample_to_device(env["tb"], "cpu"), None, train=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tss), float(jss), rtol=0)
    for key in ("loss", "nll_loss", "ntokens"):
        np.testing.assert_allclose(float(tlog[key]), float(jlog[key]), rtol=LOSS_RTOL)


def test_speech_to_text_ctc_raises(env):
    tm = env["tm"]
    sample = sample_to_device(env["tb"], "cpu")
    sample["encoder_target"] = torch.full((8, 4), 5)
    crit = SpeechToTextCriterion(SpeechToTextCriterionConfig(ctc_weight=0.5), env["td"].pad())
    with pytest.raises(NotImplementedError, match="Queue A item 11"):
        crit(tm, sample, None, train=False)
