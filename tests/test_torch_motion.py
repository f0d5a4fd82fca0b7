"""The motion modality of ofasys_torch against ofasys_tpu: the BVH / 6D
rotation utilities, the ``motion_6d`` preprocessor and adaptor,
``GaussianDiffusion``, ``diffusion_criterion``, ``DiffusionGenerator`` and
the summed five-task update of bench.py's mix (caption, text_infilling,
asr, vqa, motion_t2m).

Tiny arch (2+2 layers, E=64, FFN 256, 4 heads), fp32 on both sides, inputs
from a numpy seed, the same perturbed parameters (carried with
``load_jax_params``). The port draws its diffusion timesteps and noise from
``torch.Generator``s; here its draw methods (``DiffusionCriterion.draw``,
``DiffusionGenerator.noise``) are replaced by the ``jax.random`` draws that
ofasys_tpu makes for the same key, so both sides see the same numbers.

Tolerances:
  * motion utilities and preprocessing: bit-equal;
  * the fp32 sinusoidal time embedding: atol 1e-4. XLA's fp32 exp is off
    by one ulp in 15 of the 128 frequencies, and t up to 999 carries that
    into the sine's argument (up to 6e-5). Each comparison below first
    checks the port's own embedding to that bound and then hands the port
    JAX's, so what follows is compared on the same numbers;
  * the motion_6d adaptor: atol 1e-5;
  * GaussianDiffusion (fp32 schedule and math): rtol 1e-6 (make_betas,
    float64 numpy on both sides: bit-equal);
  * diffusion_criterion: loss rtol 1e-5;
  * DiffusionGenerator features after 10 DDIM steps (eta 0 and 0.5, the
    preprocessor's clamp): |got - want| / |want| <= 1e-4 (Frobenius). The
    x0 estimate divides by sqrt(alpha_bar_t), 4e-3 at the first step of the
    cosine schedule, which scales the fp32 rounding of the denoiser by up
    to 250;
  * the five-task update under attn_kernel='pallas' (JAX runs the Pallas
    kernels in interpret mode, the port their plain versions): those of
    tests/test_torch_image.py's three-task update (loss and gnorm rtol
    1e-4, gradients atol 1e-5 + rtol 1e-3 of the leaf's largest entry, the
    key-side biases atol 1e-4, parameters after 2 updates within 2 * 2 * lr
    and a mean error of 2e-6). The dense kernel route rounds the fp32
    position biases to bf16 on both sides, and fp32 rounding upstream
    (flax's LayerNorm takes the fast variance, the port two passes) can
    put the two fp32 values on either side of a bf16 rounding boundary: one
    of the 16,384 motion decoder bias entries here, which moves a leaf to
    1.01e-3 of its largest entry. Wherever both sides hold the same
    parameters (the one-update gradient check and the first of the
    N_UPDATES updates), the port's absolute-position and cross-attention
    biases are first held to JAX's (atol 1e-5) and then carry JAX's values
    forward (their gradient goes through the port's own), so both sides
    round the same numbers.
"""

import io
import wave

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction, ModalityType as JModality
from ofasys_tpu.adaptor import motion as jmotion
from ofasys_tpu.configure.configs import OptimizationConfig as JOptimizationConfig
from ofasys_tpu.engine import train_step as jts
from ofasys_tpu.engine.criterion.cross_entropy import (
    SpeechToTextCriterion as JS2TCriterion,
    SpeechToTextCriterionConfig as JS2TConfig,
)
from ofasys_tpu.engine.criterion.diffusion_loss import (
    DiffusionCriterion as JDiffusionCriterion,
    DiffusionCriterionConfig as JDiffusionConfig,
)
from ofasys_tpu.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion as JCriterion,
    LabelSmoothedCrossEntropyCriterionConfig as JCriterionConfig,
)
from ofasys_tpu.engine.optim import build_optimizer as jbuild_optimizer
from ofasys_tpu.generator.diffusion_generator import DiffusionGenerator as JDiffusionGenerator
from ofasys_tpu.model import diffusion as jdiff
from ofasys_tpu.preprocessor import motion as jpmotion
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_tpu.preprocessor.instruction import Slot as JSlot
from ofasys_tpu.utils import motion_utils as jmu
from ofasys_tpu.utils.pytree import SlotBatch as JSlotBatch
from ofasys_torch import GeneralistModel, Instruction, ModalityType
from ofasys_torch.adaptor import motion as tmotion
from ofasys_torch.adaptor.general import GeneralAdaptor
from ofasys_torch.configure.configs import OptimizationConfig
from ofasys_torch.engine import train_step as tts
from ofasys_torch.engine.criterion import (
    DiffusionCriterion,
    DiffusionCriterionConfig,
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
    SpeechToTextCriterion,
    SpeechToTextCriterionConfig,
)
from ofasys_torch.engine.optim import build_optimizer
from ofasys_torch.generator import DiffusionGenerator, MotionOutput
from ofasys_torch.model import diffusion as tdiff
from ofasys_torch.model.ofa import GeneralistNet
from ofasys_torch.ops import dense_attention as tdense
from ofasys_torch.preprocessor import motion as tpmotion
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.preprocessor.instruction import Slot
from ofasys_torch.utils import motion_utils as tmu
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import SlotBatch, sample_to_device, slots_to_device

MOTION = 'motion capture: " [TEXT:text] " -> [MOTION:bvh,preprocess=motion_6d,adaptor=motion_6d]'
CAPTION = "[IMAGE:img] what does the image describe? -> [TEXT:cap]"
VQA = "[IMAGE:img] [TEXT:question] -> [TEXT:answer]"
INFILL = 'what is the complete text of " [TEXT:text,mask_ratio=0.3] "? -> [TEXT:text]'
ASR = "[AUDIO:wav] what is the transcription? -> [TEXT:text]"
ADAPTORS = ("text", "image_vit", "audio_fbank", "motion_6d")
SIZE = 64                      # 4 x 4 patches of 16 pixels
FEAT = 135
SIN_ATOL = 1e-4
DIFF_RTOL = 1e-6
LOSS_RTOL = 1e-4
BIAS_ATOL = 1e-5
GEN_REL_TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
NOISE_GRAD_ATOL = 1e-4
PARAM_MEAN_ATOL = 2e-6
LR = 1e-3
N_UPDATES = 2
NOISE_MODULES = ("k_proj", "pos_k_linear", "cross_pos_k_linear")

BVH = """HIERARCHY
ROOT Hips
{
  OFFSET 0 0 0
  CHANNELS 6 Xposition Yposition Zposition Zrotation Xrotation Yrotation
  JOINT Spine
  {
    OFFSET 0 10 0
    CHANNELS 3 Zrotation Xrotation Yrotation
    JOINT Head
    {
      OFFSET 0 4 1
      CHANNELS 3 Zrotation Yrotation Xrotation
      End Site
      {
        OFFSET 0 5 0
      }
    }
  }
  JOINT Leg
  {
    OFFSET 2 -9 0
    CHANNELS 3 Xrotation Yrotation Zrotation
    End Site
    {
      OFFSET 0 -8 0
    }
  }
}
MOTION
Frames: {n}
Frame Time: 0.033333
{rows}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wave(rng, seconds, sr=16000):
    """Two tones plus noise in [-1, 1], float32."""
    t = np.arange(int(sr * seconds)) / sr
    f1, f2 = rng.uniform(150, 900, 2)
    x = 0.4 * np.sin(2 * np.pi * f1 * t) + 0.2 * np.sin(2 * np.pi * f2 * t)
    return (x + 0.05 * rng.standard_normal(t.shape)).clip(-1, 1).astype(np.float32)


def _wav_bytes(x, sr=16000):
    """16-bit mono PCM through the stdlib wave module."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.round(x * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _bvh(rng, n_frames):
    rows = np.concatenate([rng.uniform(-5, 5, (n_frames, 3)), rng.uniform(-80, 80, (n_frames, 12))], 1)
    return BVH.replace("{n}", str(n_frames)).replace(
        "{rows}", "\n".join(" ".join(f"{v:.4f}" for v in r) for r in rows))


# ------------------------------------------------------------ motion utilities
@pytest.mark.parametrize("order", ["ZXY", "ZYX", "XYZ"])
def test_rotations_are_bit_equal(order):
    ang = np.random.default_rng(0).uniform(-170, 170, (40, 3))
    R = jmu.euler_to_rotmat(ang, order)
    np.testing.assert_array_equal(tmu.euler_to_rotmat(ang, order), R)
    np.testing.assert_array_equal(tmu.rotmat_to_euler(R, order), jmu.rotmat_to_euler(R, order))
    d6 = jmu.rotmat_to_rot6d(R) + 0.01
    np.testing.assert_array_equal(tmu.rotmat_to_rot6d(R), jmu.rotmat_to_rot6d(R))
    np.testing.assert_array_equal(tmu.rot6d_to_rotmat(d6), jmu.rot6d_to_rotmat(d6))
    with pytest.raises(ValueError):
        tmu.rotmat_to_euler(R, "YXZ")


def test_bvh_round_trip_is_bit_equal():
    text = _bvh(np.random.default_rng(1), 7)
    jh, jf = jmu.parse_bvh(text)
    th, tf = tmu.parse_bvh(text)
    np.testing.assert_array_equal(tf, jf)
    assert th.frame_time == jh.frame_time and th.num_joints == jh.num_joints == 4
    for a, b in zip(th.joints, jh.joints, strict=True):
        assert (a.name, a.channels, a.parent, a.children) == (b.name, b.channels, b.parent, b.children)
        np.testing.assert_array_equal(a.offset, b.offset)
        assert th.rot_order(th.joints.index(a)) == jh.rot_order(jh.joints.index(b))
    feats = jmu.bvh_to_features(jh, jf)
    np.testing.assert_array_equal(tmu.bvh_to_features(th, tf), feats)
    np.testing.assert_array_equal(tmu.features_to_bvh(th, feats), jmu.features_to_bvh(jh, feats))
    assert tmu.save_bvh(th, tf) == jmu.save_bvh(jh, jf)
    np.testing.assert_array_equal(tmu.forward_kinematics(th, feats), jmu.forward_kinematics(jh, feats))


# -------------------------------------------------------------- preprocessor
def _map_both(values, split, normalize=False, **cfg):
    jpre = jpmotion.MotionPreprocess(None, jpmotion.MotionPreprocessConfig(**cfg))
    tpre = tpmotion.MotionPreprocess(None, tpmotion.MotionPreprocessConfig(**cfg))
    if normalize:
        rng = np.random.default_rng(2)
        mean, std = rng.standard_normal(FEAT), rng.uniform(0, 2, FEAT)
        std[:3] = 0.0                                   # clipped to 1e-6 on both sides
        jpre.set_normalization(mean, std)
        tpre.set_normalization(mean, std)
    js = [jpre.map(JSlot(JModality.MOTION, False, value=v, column_name="bvh", split=split)) for v in values]
    ts = [tpre.map(Slot(ModalityType.MOTION, False, value=v, column_name="bvh", split=split)) for v in values]
    return (jpre, js), (tpre, ts)


@pytest.mark.parametrize("case", ["eval", "train_crop", "short", "bvh_text", "normalized", "open"])
def test_motion_preprocess_is_bit_equal(case):
    rng = np.random.default_rng(3)
    values = [rng.standard_normal((n, FEAT)).astype(np.float32) for n in (90, 64, 75)]
    split, kw = "test", {}
    if case == "train_crop":
        split, kw = "train", {"seed": 4}
    elif case == "short":
        values = [rng.standard_normal((n, FEAT)).astype(np.float32) for n in (20, 70)]
    elif case == "bvh_text":
        values = [_bvh(rng, n) for n in (12, 30)]
        kw = {"window_size": 16}
    elif case == "normalized":
        kw = {"normalize": True}
    elif case == "open":
        values = [None, None]
    (jpre, js), (tpre, ts) = _map_both(values, split, **kw)
    if split == "train":                              # the crop generator advances alike
        js += [jpre.map(JSlot(JModality.MOTION, False, value=v, column_name="bvh", split=split))
               for v in values]
        ts += [tpre.map(Slot(ModalityType.MOTION, False, value=v, column_name="bvh", split=split))
               for v in values]
    for a, b in zip(js, ts, strict=True):
        for key in ("value", "masks"):
            assert b.value[key].dtype == a.value[key].dtype
            np.testing.assert_array_equal(b.value[key], a.value[key])
    jc, tc = jpre.collate(js), tpre.collate(ts)
    assert tc.net_target_slot is tc.net_input_slot
    for key in ("value", "masks"):
        np.testing.assert_array_equal(tc.net_input_slot.value[key], jc.net_input_slot.value[key])
    assert set(tc.sample_extra) == set(jc.sample_extra)
    for key, want in jc.sample_extra.items():
        np.testing.assert_array_equal(tc.sample_extra[key], want)
    feature = np.asarray(js[0].value["value"][:5], np.float32)
    got, want = tpre.decode(feature), jpre.decode(feature)
    if isinstance(want, str):
        assert got == want and want.startswith("HIERARCHY")
    else:
        np.testing.assert_array_equal(got, want)
    outs_t, outs_j = [MotionOutput(feature=feature)], [MotionOutput(feature=feature)]
    tpre.postprocess(outs_t, None)
    jpre.postprocess(outs_j, None)
    assert type(outs_t[0].bvh) is type(outs_j[0].bvh)


def test_motion_clamp_matches_jnp_clip():
    x = np.random.default_rng(5).standard_normal((2, 8, FEAT)).astype(np.float32) * 6
    jpre = jpmotion.MotionPreprocess(None, jpmotion.MotionPreprocessConfig(feature_clip=2.5))
    tpre = tpmotion.MotionPreprocess(None, tpmotion.MotionPreprocessConfig(feature_clip=2.5))
    np.testing.assert_array_equal(tpre.clamp(torch.from_numpy(x)).numpy(), np.asarray(jpre.clamp(x)))


# ----------------------------------------------------------------- adaptor
@pytest.fixture
def jax_time_embedding(monkeypatch):
    """The port's sinusoidal_embedding checked against ofasys_tpu's within
    SIN_ATOL at every call, then replaced by ofasys_tpu's values."""
    own = tmotion.sinusoidal_embedding
    worst = [0.0]

    def embed(t, dim):
        got = own(t, dim)
        want = torch.from_numpy(np.array(jmotion.sinusoidal_embedding(jnp.asarray(t.numpy()), dim)))
        worst[0] = max(worst[0], (got - want).abs().max().item())
        assert worst[0] <= SIN_ATOL, worst[0]
        return want

    monkeypatch.setattr(tmotion, "sinusoidal_embedding", embed)
    return worst


def _tiny_cfg(m, layers=2):
    c = m.cfg
    for stack in (c.encoder, c.decoder):
        stack.embed_dim, stack.ffn_embed_dim, stack.attention_heads, stack.layers = 64, 256, 4, layers
    c.dropout = 0.0


def _perturb(params, seed=0):
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
        return a

    return jax.tree_util.tree_map_with_path(f, jax.device_get(params))


@pytest.mark.parametrize("timestep", ["none", "given"])
@pytest.mark.parametrize("masked", [False, True])
def test_motion_adaptor_matches_flax(timestep, masked, jax_time_embedding):
    rng = np.random.default_rng(6)
    B, T = 3, 24
    value = {"value": rng.standard_normal((B, T, FEAT)).astype(np.float32)}
    if masked:
        value["masks"] = np.arange(T)[None, :] < np.asarray([24, 10, 17])[:, None]
    if timestep == "given":
        value["noise_level"] = np.asarray([0, 517, 999], np.int32)
    jm, tm = JModel(arch="tiny"), GeneralistModel(arch="tiny")
    _tiny_cfg(jm)
    _tiny_cfg(tm)
    jad = jmotion.Motion6dAdaptor(cfg=jm.cfg, adaptor_cfg=jmotion.Motion6dAdaptorConfig(), is_src=False,
                                  embed_tokens=nn.Embed(16, 64), pad_id=1, dtype=jnp.float32)
    jslot = JSlotBatch(JModality.MOTION, False, value={k: jnp.asarray(v) for k, v in value.items()},
                       column_name="bvh")

    def both(mod, slot):
        out = mod(slot)
        return out, mod.forward_output(out.embed, {}, slot)[0]

    params = _perturb(jad.init(jax.random.PRNGKey(1), jslot, method=both)["params"], seed=7)
    want, want_feat = jad.apply({"params": params}, jslot, method=both)
    tad = tmotion.Motion6dAdaptor(tm.cfg, False, torch.nn.Embedding(16, 64), 1, torch.float32)
    load_jax_params(tad, params)
    tslot = slots_to_device([SlotBatch(ModalityType.MOTION, False, value=value, column_name="bvh")], "cpu")[0]
    with torch.no_grad():
        got = tad(tslot)
        got_feat, _ = tad.forward_output(got.embed, {}, tslot)
    assert got.modal_id == want.modal_id == 4 and got_feat.dtype == torch.float32
    np.testing.assert_allclose(got.embed.numpy(), np.asarray(want.embed), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.pos_embed.numpy(), np.asarray(want.pos_embed), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_feat.numpy(), np.asarray(want_feat), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.padding_mask.numpy(), np.asarray(want.padding_mask))
    assert got.rel_tables is None and got.rel_bucket is None
    assert 0.0 <= jax_time_embedding[0] <= SIN_ATOL


# -------------------------------------------------------- GaussianDiffusion
@pytest.mark.parametrize("schedule", ["linear", "cosine", "scaled_linear"])
def test_make_betas_is_bit_equal(schedule):
    for n in (10, 1000):
        np.testing.assert_array_equal(tdiff.make_betas(schedule, n), jdiff.make_betas(schedule, n))
    with pytest.raises(ValueError):
        tdiff.make_betas("quadratic", 10)


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
@pytest.mark.parametrize("prediction", ["epsilon", "sample"])
@pytest.mark.parametrize("snr_gamma", [None, 5.0])
def test_gaussian_diffusion_matches_jax(schedule, prediction, snr_gamma):
    rng = np.random.default_rng(8)
    kw = dict(num_steps=1000, schedule=schedule, prediction_type=prediction, snr_gamma=snr_gamma)
    jd, td = jdiff.GaussianDiffusion(**kw), tdiff.GaussianDiffusion(**kw)
    np.testing.assert_array_equal(td.alphas_bar, np.asarray(jd._alphas_bar))
    x0, noise, pred = (rng.standard_normal((4, 6, 5)).astype(np.float32) for _ in range(3))
    t = np.asarray([0, 1, 500, 999], np.int32)
    tt = torch.from_numpy(t)
    cases = {
        "q_sample": (td.q_sample(torch.from_numpy(x0), tt, torch.from_numpy(noise)),
                     jd.q_sample(x0, t, noise)),
        "loss_weight": (td.loss_weight(tt), jd.loss_weight(jnp.asarray(t))),
        "to_x0": (td.to_x0(torch.from_numpy(x0), tt, torch.from_numpy(pred)), jd.to_x0(x0, t, pred)),
        "training_target": (td.training_target(torch.from_numpy(x0), torch.from_numpy(noise)),
                            jd.training_target(x0, noise)),
    }
    for name, (got, want) in cases.items():
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DIFF_RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("schedule", ["linear", "cosine", "scaled_linear"])
def test_diffusion_roots_are_correctly_rounded(schedule):
    """The port's root tables are numpy's fp32 roots of the fp32 alphas_bar,
    bit for bit (XLA's fp32 sqrt is correctly rounded, and so is numpy's)."""
    td = tdiff.GaussianDiffusion(num_steps=1000, schedule=schedule)
    ab = td.alphas_bar
    assert ab.dtype == np.float32
    want = {"sqrt_ab": np.sqrt(ab), "sqrt_1m_ab": np.sqrt(np.float32(1) - ab),
            "sqrt_ab_floor": np.sqrt(np.maximum(ab, np.float32(1e-8)))}
    for name, w in want.items():
        got = td.tables[name]
        assert got.dtype == np.float32, name
        np.testing.assert_array_equal(got, w, err_msg=name)
    # the fp64 root rounded to fp32 is the correctly rounded fp32 root
    np.testing.assert_array_equal(td.tables["sqrt_ab"], np.sqrt(ab.astype(np.float64)).astype(np.float32))
    t = torch.arange(1000)
    np.testing.assert_array_equal(td._gather("sqrt_1m_ab", t).numpy(), want["sqrt_1m_ab"])


@pytest.mark.parametrize("eta", [0.0, 0.7])
def test_ddim_sample_matches_jax(eta):
    """The sampling loop with a fixed linear denoiser, guidance and a clamp,
    the JAX draws injected."""
    kw = dict(num_steps=100, schedule="cosine")
    jd, td = jdiff.GaussianDiffusion(**kw), tdiff.GaussianDiffusion(**kw)
    w = np.random.default_rng(9).standard_normal((5, 5)).astype(np.float32) * 0.3
    shape = (3, 4, 5)

    def jfn(x, t):
        return jnp.tanh(x @ w) + 1e-3 * t[:, None, None]

    def tfn(x, t):
        return torch.tanh(x @ torch.from_numpy(w)) + 1e-3 * t[:, None, None]

    opts = dict(num_inference_steps=12, eta=eta, guidance_weight=0.5)
    want = jd.ddim_sample(jfn, shape, jax.random.PRNGKey(3), uncond_denoise_fn=lambda x, t: 0.5 * jfn(x, t),
                          clamp_fn=lambda x: jnp.clip(x, -3, 3), **opts)
    got = td.ddim_sample(tfn, shape, _jax_noise(jax.random.PRNGKey(3)),
                         uncond_denoise_fn=lambda x, t: 0.5 * tfn(x, t),
                         clamp_fn=lambda x: torch.clamp(x, -3, 3), **opts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _jax_noise(key):
    """ofasys_tpu's ddim_sample draws: x_T from the first split of the key,
    then each step's noise from the next split."""
    state = [key]

    def noise(shape, *_):
        state[0], sub = jax.random.split(state[0])
        return torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32)))

    return noise


# ------------------------------------------------------------- whole model
def _dictionary(cls):
    d = cls()
    for i in range(60):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def _words(rng, n_chars):
    words = ["a", "man", "walks", "runs", "jumps", "turns", "left", "right", "slowly", "then",
             "waves", "his", "arms", "what", "is", "in", "image"]
    s = ""
    while len(s) < n_chars:
        s += rng.choice(words) + " "
    return s[:n_chars].strip()


def _records(seed=7):
    rng = np.random.default_rng(seed)
    img = lambda: rng.integers(0, 256, (SIZE, SIZE, 3)).astype(np.float32)      # noqa: E731
    caption = [{"img": img(), "cap": _words(rng, int(rng.integers(18, 24)))} for _ in range(16)]
    infill = [{"text": _words(rng, int(rng.integers(40, 56)))} for _ in range(8)]
    asr = [{"wav": _wav_bytes(_wave(rng, rng.uniform(0.3, 0.6))), "text": _words(rng, int(rng.integers(8, 14)))}
           for _ in range(8)]
    vqa = [{"img": img(), "question": _words(rng, int(rng.integers(12, 16))),
            "answer": _words(rng, int(rng.integers(5, 8)))} for _ in range(8)]
    motion = [{"text": _words(rng, int(rng.integers(10, 16))),
               "bvh": rng.standard_normal(((40, 70, 90)[i % 3], FEAT)).astype(np.float32)}
              for i in range(8)]
    return {"caption": (CAPTION, caption), "infill": (INFILL, infill), "asr": (ASR, asr),
            "vqa": (VQA, vqa), "motion": (MOTION, motion)}


@pytest.fixture(scope="module")
def env():
    jd = _dictionary(JDictionary)
    jm = JModel(arch="tiny")
    _tiny_cfg(jm)
    jgp = JGeneralPreprocess(jd, active=["text", "image", "audio", "motion_6d"])
    jgp.name2pre["image"].cfg.patch_image_size = SIZE
    jm.initialize(jd, active_adaptors=ADAPTORS, dtype=jnp.float32)

    td = _dictionary(Dictionary)
    tm = GeneralistModel(arch="tiny")
    _tiny_cfg(tm)
    tgp = GeneralPreprocess(td, active=["text", "image", "audio", "motion_6d"])
    tgp.name2pre["image"].cfg.patch_image_size = SIZE
    tm.initialize(td, active_adaptors=ADAPTORS, dtype=torch.float32, device="cpu")
    assert len(jd) == len(td) and jd.symbols == td.symbols

    jb, tb = {}, {}
    for name, (tpl, recs) in _records().items():
        jb[name] = jgp.collate([jgp(JInstruction(tpl, split="train").format(**r)) for r in recs])
        tb[name] = tgp.collate([tgp(Instruction(tpl, split="train").format(**r)) for r in recs])
    params = _perturb(jm.init_params(jax.random.PRNGKey(0),
                                     [b["net_input"]["slots"] for b in jb.values()]))
    load_jax_params(tm.net, params)
    return dict(jm=jm, jd=jd, jgp=jgp, tm=tm, td=td, tgp=tgp, params=params, jb=jb, tb=tb)


def test_batches_identical(env):
    for name in env["jb"]:
        js, ts = env["jb"][name], env["tb"][name]
        for a, b in zip(js["net_input"]["slots"], ts["net_input"]["slots"], strict=True):
            assert (a.modality.name, a.is_src, a.column_name) == (b.modality.name, b.is_src, b.column_name)
            for key in a.value:
                np.testing.assert_array_equal(b.value[key], np.asarray(a.value[key]))
        np.testing.assert_array_equal(ts["target"], js["target"])
    slots = env["tb"]["motion"]["net_input"]["slots"]
    assert [s.modality.name for s in slots] == ["TEXT", "MOTION"]
    assert not slots[1].value["masks"].all()              # a 40-frame clip is padded to 64


def test_adaptor_sides_and_param_tree(env):
    """flax creates motion_6d's parameters on the decoder side only and the
    source adaptors' on the encoder side only; the trees match leaf for leaf."""
    names = [n for n, _ in env["tm"].net.named_parameters()]
    assert any(n.startswith("decoder_adaptor.motion_6d.out_proj_feat") for n in names)
    assert not any(n.startswith("encoder_adaptor.motion_6d") for n in names)
    assert not any(n.startswith(("decoder_adaptor.audio_fbank", "decoder_adaptor.image_vit")) for n in names)
    back = export_params(env["tm"].net)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(env["params"]))
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        np.testing.assert_array_equal(a, np.asarray(flat_j[path]), err_msg=jax.tree_util.keystr(path))


def _jax_sample(s):
    return {"net_input": {"slots": s["net_input"]["slots"]}, "target": jnp.asarray(s["target"])}


def _jax_draws(crit_cfg, fold, base_key=0):
    """DiffusionCriterion.draw as ofasys_tpu's criterion draws inside
    make_grad_step(fold=fold) at the sample's update_num: t and noise from
    the first two of three splits of fold_in(fold_in(key, step), fold)."""

    def draw(sample, x0, generator):
        key = jax.random.fold_in(jax.random.PRNGKey(base_key), int(sample["update_num"]))
        if fold:
            key = jax.random.fold_in(key, fold)
        t_rng, n_rng, _ = jax.random.split(key, 3)
        t = jax.random.randint(t_rng, (x0.shape[0],), 0, crit_cfg.num_steps)
        noise = jax.random.normal(n_rng, x0.shape, jnp.float32)
        return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))

    return draw


@pytest.mark.parametrize("cfg", [{}, {"loss_type": "l2", "snr_gamma": 5.0, "prediction_type": "sample"}],
                         ids=["l1", "l2_snr_sample"])
def test_diffusion_criterion_matches_jax(env, cfg, jax_time_embedding):
    jm, tm, pad = env["jm"], env["tm"], env["td"].pad()
    jcrit = JDiffusionCriterion(JDiffusionConfig(**cfg), pad)
    tcrit = DiffusionCriterion(DiffusionCriterionConfig(**cfg), pad)
    tcrit.draw = _jax_draws(tcrit.cfg, fold=0, base_key=5)
    key = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    jl, jss, jlog = jcrit(jm, {"params": env["params"]}, _jax_sample(env["jb"]["motion"]), key, train=True)
    sample = {**sample_to_device(env["tb"]["motion"], "cpu"), "update_num": 3}
    with torch.no_grad():
        tl, tss, tlog = tcrit(tm, sample, None, train=True)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tss) == float(jss) == float(env["tb"]["motion"]["ntokens"])
    assert int(tlog["ntokens"]) == int(jlog["ntokens"]) and tlog["nsentences"] == jlog["nsentences"]


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_diffusion_generator_matches_jax(env, eta, jax_time_embedding):
    """Encode once, 10 DDIM steps of the full-context decoder, the
    preprocessor's clamp, both sides from the same key's draws."""
    jm, tm = env["jm"], env["tm"]
    recs = _records(seed=8)["motion"][1][:4]
    jgp, tgp = env["jgp"], env["tgp"]
    jsample = jgp.collate([jgp(JInstruction(MOTION, split="test").format(**r)) for r in recs])
    tsample = tgp.collate([tgp(Instruction(MOTION, split="test").format(**r)) for r in recs])
    opts = dict(num_steps=1000, num_inference_steps=10, eta=eta)
    jgen = JDiffusionGenerator(jm, clamp_fn=jgp.name2pre["motion_6d"].clamp, **opts)
    tgen = DiffusionGenerator(tm, clamp_fn=tgp.name2pre["motion_6d"].clamp, **opts)
    tgen.noise = _jax_noise(jax.random.PRNGKey(2))
    want = jgen.generate({"params": env["params"]}, jsample, seed=2)
    got = tgen.generate(tsample, seed=2)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want, strict=True):
        assert isinstance(a, MotionOutput) and a.feature.shape == b.feature.shape
        assert np.isfinite(a.feature).all()
        rel = np.linalg.norm(a.feature - b.feature) / np.linalg.norm(b.feature)
        assert rel <= GEN_REL_TOL, rel
    tgp.postprocess(got, tsample)
    assert got[0].bvh is not None


# ---------------------------------------------------------- five-task update
def _close_tree(t, j, what):
    flat_t = jax.tree_util.tree_leaves_with_path(t)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(j))
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        b = np.asarray(flat_j[path], np.float32)
        assert a.shape == b.shape, (jax.tree_util.keystr(path), a.shape, b.shape)
        err = np.abs(a - b).max()
        noise = path[-1].key == "bias" and path[-2].key in NOISE_MODULES
        tol = what["atol"] + what["rtol"] * np.abs(b).max()
        if noise:
            tol = max(tol, what.get("noise_atol", 0.0))
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)
        if what.get("mean_atol") and not noise:
            mean = np.abs(a - b).mean()
            assert mean <= what["mean_atol"], (jax.tree_util.keystr(path), mean)


def _jax_position_biases(net, slots):
    """ofasys_tpu's fp32 encoder and decoder absolute-position biases and
    cross-attention bias of one task's forward, in the port's call order."""
    ea = net.encoder_adaptor([s for s in slots if s.is_src])
    da = net.decoder_adaptor([s for s in slots if not s.is_src])
    return [ea.bias_spec.abs_bias, da.bias_spec.abs_bias, net.cross_bias(da.pos_embed, ea.pos_embed)]


def _hand_over(monkeypatch, queue):
    """The port's position biases checked against the next of ``queue``
    (BIAS_ATOL) and replaced by it, value only: own + (want - own).detach()."""
    def handed(own):
        want = torch.from_numpy(np.array(queue.pop(0)))
        assert own.shape == want.shape and (own.detach() - want).abs().max().item() <= BIAS_ATOL
        out = own + (want - own).detach()
        assert torch.equal(out.detach().bfloat16(), want.bfloat16())
        return out

    abs_bias, cross = GeneralAdaptor.build_abs_pos_bias, GeneralistNet.cross_bias
    monkeypatch.setattr(GeneralAdaptor, "build_abs_pos_bias", lambda self, pe: handed(abs_bias(self, pe)))
    monkeypatch.setattr(GeneralistNet, "cross_bias", lambda self, q, k: handed(cross(self, q, k)))


def test_five_task_update_matches_ofasys_tpu(env, monkeypatch, jax_time_embedding):
    """One summed caption + text_infilling + asr + vqa + motion update under
    attn_kernel='pallas': gradients leaf by leaf, then N_UPDATES updates
    (losses, gnorm, parameters). The motion task's diffusion draws are
    ofasys_tpu's for its fold."""
    monkeypatch.delenv("OFASYS_DENSE_BWD", raising=False)
    jm, tm = env["jm"], env["tm"]
    monkeypatch.setattr(jm.cfg, "attn_kernel", "pallas")
    monkeypatch.setattr(tm.cfg, "attn_kernel", "pallas")
    load_jax_params(tm.net, env["params"])
    pad = env["td"].pad()
    tasks = list(env["jb"])
    lsce = JCriterionConfig(label_smoothing=0.1)
    jcrit = {n: JCriterion(lsce, pad) for n in tasks}
    jcrit["asr"] = JS2TCriterion(JS2TConfig(), pad)
    jcrit["motion"] = JDiffusionCriterion(JDiffusionConfig(), pad)
    tcrit = {n: LabelSmoothedCrossEntropyCriterion(LabelSmoothedCrossEntropyCriterionConfig(), pad)
             for n in tasks}
    tcrit["asr"] = SpeechToTextCriterion(SpeechToTextCriterionConfig(), pad)
    tcrit["motion"] = DiffusionCriterion(DiffusionCriterionConfig(), pad)
    fold = tasks.index("motion")
    tcrit["motion"].draw = _jax_draws(tcrit["motion"].cfg, fold)
    jbatch = {n: _jax_sample(env["jb"][n]) for n in tasks}
    tbatch = {n: sample_to_device(env["tb"][n], "cpu") for n in tasks}
    assert tbatch["motion"]["net_input"]["slots"][1].value["masks"].dtype == torch.bool
    assert tbatch["asr"]["net_input"]["slots"][0].value["inputs"].dtype == torch.float32

    calls = {"fwd": 0}
    orig = tdense.dense_attention_fwd

    def counted(*a, **kw):
        calls["fwd"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(tdense, "dense_attention_fwd", counted)
    names = [n for n, _ in tm.net.named_parameters()]
    jgrads = tgrads = None
    queue = []
    with monkeypatch.context() as m:
        _hand_over(m, queue)
        for i, n in enumerate(tasks):
            jg, _, _ = jax.jit(jts.make_grad_step(jm, jcrit[n], fold=i))(
                env["params"], 0, jbatch[n], jax.random.PRNGKey(0))
            queue += jax.device_get(jm.net.apply({"params": env["params"]}, jbatch[n]["net_input"]["slots"],
                                                 method=_jax_position_biases))
            tg, _, _ = tts.make_grad_step(tm, tcrit[n], fold=i)(list(tm.net.parameters()), 0, tbatch[n], 0)
            assert not queue
            jgrads = jg if jgrads is None else jax.tree.map(jnp.add, jgrads, jg)
            tgrads = tg if tgrads is None else [a + b for a, b in zip(tgrads, tg)]
    # the dense gate opens for the caption, infill and asr calls and for the
    # motion decoder's self and cross attention (B * 64 frames)
    assert calls["fwd"] >= 3 * 6 + 2 * 2
    _close_tree(export_params(tm.net, dict(zip(names, tgrads))), jax.device_get(jgrads),
                {"atol": GRAD_ATOL, "rtol": GRAD_RTOL, "noise_atol": NOISE_GRAD_ATOL})

    jopt = jbuild_optimizer(JOptimizationConfig(lr=(LR,)), total_num_update=10)
    topt = build_optimizer(OptimizationConfig(lr=(LR,)), total_num_update=10)
    jstate = jts.TrainState.create(env["params"], jopt)
    tstate = tts.TrainState.create(tm.net, topt)
    jstep = jax.jit(jts.make_multitask_train_step(jm, jcrit, jopt))
    tstep = tts.make_multitask_train_step(tm, tcrit, topt)
    for u in range(N_UPDATES):
        with monkeypatch.context() as m:
            if u == 0:                    # the parameters are still the same on both sides
                for n in tasks:
                    queue += jax.device_get(jm.net.apply({"params": jstate.params},
                                                         jbatch[n]["net_input"]["slots"],
                                                         method=_jax_position_biases))
                _hand_over(m, queue)
            tstate, tmet = tstep(tstate, tbatch, 0)
        assert not queue
        jstate, jmet = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        np.testing.assert_allclose(float(tmet["gnorm"]), float(jmet["gnorm"]), rtol=LOSS_RTOL)
        for n in tasks:
            for key in ("loss", "sample_size") + (() if n == "motion" else ("nll_loss",)):
                np.testing.assert_allclose(float(tmet["tasks"][n][key]),
                                           float(jmet["tasks"][n][key]), rtol=LOSS_RTOL)
    _close_tree(export_params(tm.net), jax.device_get(jstate.params),
                {"atol": 2 * N_UPDATES * LR, "rtol": 0.0, "mean_atol": PARAM_MEAN_ATOL})
