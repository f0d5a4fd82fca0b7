"""The video modality of ofasys_torch against ofasys_tpu: the ``video``
preprocessor (frame sources, uniform and random clip sampling, the
clip-consistent RandAugment, per-frame random erasing, the codec branch),
the ``video_image_sequence`` adaptor (patch, spatial and temporal
embeddings and the block-diagonal relative bucket, kept on the device per
layout) on carried-over weights, and video_caption's forward and one
update at the tiny arch (2+2 layers, E=64, 4 heads, fp32).

The clip is 4 frames of 128 px: 4 x 8 x 8 = 256 patches plus the prompt,
so every encoder self-attention and decoder cross-attention has Tk >= 256
and takes the flash route. The port's flash plain versions stand in for
the kernels (``flash_available`` patched) and ofasys_tpu runs its Pallas
flash kernels in interpret mode (``_flash_available`` patched); both round
the attention bias to bf16 before the kernel.

Tolerances:
  * preprocessed frames and collated clips: bit-equal;
  * the adaptor's embeddings and positions atol 1e-5, its bucket equal,
    the gathered bias atol 1e-5;
  * the relative-bias gather's planned backward against autograd's own
    backward of the plain gather: rtol 1e-5 + atol 1e-5 (fp32 sums in
    another order);
  * logits through the flash route atol 1e-4;
  * the update's gradients on the plain path against ofasys_tpu's XLA path:
    rtol 1e-4 + atol 1e-5 of each leaf's largest entry; on the flash route
    (bf16 bias in, bf16 bias gradient out, as ofasys_tpu's flash) against
    the XLA path: 1e-5 + 3e-2 of each leaf's largest entry, the bound and
    reasoning of tests/test_torch_long_text.py.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu.adaptor import image as jimage
from ofasys_tpu.engine import train_step as jts
from ofasys_tpu.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion as JCriterion,
    LabelSmoothedCrossEntropyCriterionConfig as JCriterionConfig,
)
from ofasys_tpu.model import positional as jpos
from ofasys_tpu.model import transformer as jtr
from ofasys_tpu.preprocessor import video as jvideo
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction
from ofasys_torch.adaptor.image import image_bucket
from ofasys_torch.adaptor.video import video_bucket
from ofasys_torch.engine import train_step as tts
from ofasys_torch.engine.criterion import (
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)
from ofasys_torch.model import transformer as ttr
from ofasys_torch.model.positional import block_diag_buckets, token_bucket
from ofasys_torch.ops import flash_attention as tflash
from ofasys_torch.preprocessor import video as tvideo
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.preprocessor.instruction import Slot
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import sample_to_device, slots_to_device

from test_torch_audio import _dictionary, _one_torch_thread, _port_params, _tiny_cfg  # noqa: F401
from test_torch_long_text import KEY_BIAS_FRACTION, NOISE_MODULES

CAPTION = "[VIDEO:video] what does the video describe? -> [TEXT:cap]"
FRAMES, SIZE = 4, 128
ADAPTORS = ("text", "video_image_sequence")
OUT_ATOL, LOGIT_ATOL = 1e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
FLASH_GRAD_RTOL = 3e-2
WORDS = ["a", "dog", "runs", "on", "the", "beach", "with", "red", "ball", "two", "people"]


def _clip(rng, n, h=96, w=112):
    return rng.integers(0, 256, (n, h, w, 3)).astype(np.uint8)


def _tune(gp, **cfg):
    pre = gp.name2pre["video"]
    pre.cfg.patch_image_size = SIZE
    pre.cfg.num_frames = FRAMES
    for k, v in cfg.items():
        setattr(pre.cfg, k, v)


def _batches(records, split="train", **cfg):
    out = []
    for gcls, dcls, icls in ((JGeneralPreprocess, JDictionary, JInstruction),
                             (GeneralPreprocess, Dictionary, Instruction)):
        gp = gcls(_dictionary(dcls), active=["text", "video"])
        _tune(gp, **cfg)
        np.random.seed(5)                     # RandAugment ops draw from the global generator
        out.append(gp.collate([gp(icls(CAPTION, split=split).format(**r)) for r in records]))
    return out


def _records(rng, n=3):
    return [{"video": _clip(rng, int(rng.integers(2, 9))),
             "cap": " ".join(rng.choice(WORDS, int(rng.integers(2, 6))))} for _ in range(n)]


# ------------------------------------------------------------- preprocessor
@pytest.mark.parametrize("case", ["uniform", "few_frames", "train_random", "train_augment",
                                  "frame_list", "npy"])
def test_video_preprocess_is_bit_equal(case, tmp_path):
    rng = np.random.default_rng(1)
    recs = _records(rng)
    cfg, split = {}, "test"
    if case == "few_frames":
        recs[0]["video"] = recs[0]["video"][:2]
    elif case == "train_random":
        split, cfg = "train", {"sample_mode": "random"}
        for r in recs:
            r["video"] = _clip(rng, 9)
    elif case == "train_augment":
        split, cfg = "train", {"video_rand_augment": True, "random_erasing_prob": 0.7}
    elif case == "frame_list":
        recs = [dict(r, video=[f for f in r["video"]]) for r in recs]
    elif case == "npy":
        for i, r in enumerate(recs):
            path = str(tmp_path / f"clip{i}.npy")
            np.save(path, r["video"])
            r["video"] = path
    jb, tb = _batches(recs, split, **cfg)
    jv, tv = jb["net_input"]["slots"][0], tb["net_input"]["slots"][0]
    assert tv.value["inputs"].shape == (3, FRAMES, SIZE, SIZE, 3)
    assert tv.value["inputs"].dtype == np.float32
    np.testing.assert_array_equal(tv.value["inputs"], jv.value["inputs"])
    for a, b in zip(jb["net_input"]["slots"][1:], tb["net_input"]["slots"][1:]):
        np.testing.assert_array_equal(b.value["inputs"], a.value["inputs"])


def test_video_codec_decode(tmp_path, monkeypatch):
    """A video file decodes through OpenCV where it is installed (to the
    same frames as ofasys_tpu's); with neither OpenCV nor pyav both
    packages raise ImportError."""
    path = str(tmp_path / "clip.mp4")
    try:
        import cv2

        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8, (64, 48))
        frames = _clip(np.random.default_rng(2), 6, 48, 64)
        for f in frames:
            writer.write(f[:, :, ::-1].copy())
        writer.release()
        tpre = tvideo.VideoPreprocess(None, tvideo.VideoPreprocessConfig())
        jpre = jvideo.VideoPreprocess(None, jvideo.VideoPreprocessConfig())
        got, want = tpre.load_frames(path), jpre.load_frames(path)
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    except ImportError:
        open(path, "wb").close()
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "av", None)
    for mod in (tvideo, jvideo):
        pre = mod.VideoPreprocess(None, mod.VideoPreprocessConfig())
        with pytest.raises(ImportError, match="cv2.*pyav"):
            pre.load_frames(path)


@pytest.mark.parametrize("n,h,w", [(1, 3, 3), (4, 8, 8), (8, 14, 14), (3, 5, 7)])
def test_video_bucket_matches(n, h, w):
    """ofasys_tpu's frame loop (adaptor/video.py:53-63) at these grids."""
    pos_ids = jimage._grid_positions(h, w, 42)
    per_frame = jpos.make_image_bucket_position(42, jpos.image_bucket_count(42))[np.ix_(pos_ids, pos_ids)]
    want = -np.ones((n * h * w, n * h * w), np.int32)
    for f in range(n):
        want[f * h * w:(f + 1) * h * w, f * h * w:(f + 1) * h * w] = per_frame
    got = video_bucket(n, h, w, 42)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["video+text", "image+text", "text"])
def test_rel_bias_gradient_matches_the_gather(layout):
    """BiasSpec's gather of the relative tables: the same bias as
    ``tables[:, bucket]``, and its planned backward (a segment sum per
    bucket, the zero row left out) the table gradient of autograd's own
    backward of that gather, the zero row excepted."""
    rng = np.random.default_rng(11)
    n_img = jpos.image_bucket_count(42)
    slots = {"video+text": [(video_bucket(3, 4, 5, 42), n_img), (token_bucket(256, 1024, 17), 511)],
             "image+text": [(image_bucket(6, 6, 42), n_img), (token_bucket(256, 1024, 40), 511)],
             "text": [(token_bucket(256, 1024, 300), 511)]}[layout]
    host = block_diag_buckets([b for b, _ in slots], [s for _, s in slots])
    bucket = ttr.RelBucket(host, "cpu")
    n, H = 3, 4
    rows = 1 + sum(s for _, s in slots)
    tables = torch.tensor(rng.standard_normal((n, rows, H)), dtype=torch.float32, requires_grad=True)
    upstream = torch.tensor(rng.standard_normal((n, H) + host.shape), dtype=torch.float32)
    spec = ttr.BiasSpec(rel_bucket=bucket, tables=tables)
    got_bias = spec.stacked()
    (got,) = torch.autograd.grad((got_bias * upstream).sum(), tables)
    plain = tables[:, torch.as_tensor(host, dtype=torch.long)].permute(0, 3, 1, 2)
    (want,) = torch.autograd.grad((plain * upstream).sum(), tables)
    np.testing.assert_array_equal(got_bias.detach().numpy(), plain.detach().numpy())
    assert (got[:, 0] == 0).all()
    np.testing.assert_allclose(got[:, 1:].numpy(), want[:, 1:].numpy(), rtol=1e-5, atol=1e-5)
    # the plan is made once per bucket
    plan = bucket.grad_plan(rows)
    assert bucket.grad_plan(rows) is plan and int(plan[1].sum()) == int((host > 0).sum())


# ------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(3)
    recs = _records(rng, 4)
    jd, td = _dictionary(JDictionary), _dictionary(Dictionary)
    jgp, tgp = JGeneralPreprocess(jd, active=["text", "video"]), GeneralPreprocess(td, active=["text", "video"])
    _tune(jgp)
    _tune(tgp)
    jb = jgp.collate([jgp(JInstruction(CAPTION, split="train").format(**r)) for r in recs])
    tb = tgp.collate([tgp(Instruction(CAPTION, split="train").format(**r)) for r in recs])
    jm, tm = JModel(arch="tiny"), GeneralistModel(arch="tiny")
    _tiny_cfg(jm)
    _tiny_cfg(tm)
    jm.initialize(jd, active_adaptors=ADAPTORS, dtype=jnp.float32)
    tm.initialize(td, active_adaptors=ADAPTORS, dtype=torch.float32, device="cpu")
    params = _port_params(jm, tm, [jb["net_input"]["slots"]])
    return dict(jm=jm, tm=tm, jd=jd, td=td, params=params, jb=jb, tb=tb)


def test_adaptor_outputs_and_bias(env):
    jm, tm = env["jm"], env["tm"]
    load_jax_params(tm.net, env["params"])
    jsrc = [s for s in env["jb"]["net_input"]["slots"] if s.is_src]
    tsrc = slots_to_device([s for s in env["tb"]["net_input"]["slots"] if s.is_src], "cpu")

    def jfn(net, slots):
        out = net.encoder_adaptor(slots)
        spec = out.bias_spec
        return out.embed, out.pos_embed, out.padding_mask, spec.bucket, spec.stacked(), spec.abs_bias

    jembed, jpos_, jmask, jbucket, jstacked, jabs = jm.net.apply({"params": env["params"]}, jsrc, method=jfn)
    with torch.no_grad():
        out = tm.net.encoder_adaptor(tsrc)
        again = tm.net.encoder_adaptor(tsrc)
    T = FRAMES * (SIZE // 16) ** 2 + tsrc[1].value["inputs"].shape[1]
    assert tuple(out.embed.shape) == (4, T, 64) and T >= 256
    np.testing.assert_allclose(out.embed.numpy(), np.asarray(jembed), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(out.pos_embed.numpy(), np.asarray(jpos_), rtol=0, atol=OUT_ATOL)
    np.testing.assert_array_equal(out.padding_mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(out.bias_spec.bucket, np.asarray(jbucket))
    # positions are batch-shared: the whole bias is (1, H, T, T), B5's case on the card
    assert tuple(out.bias_spec.layer_bias(0).shape) == (1, 4, T, T)
    np.testing.assert_allclose(out.bias_spec.stacked().numpy(), np.asarray(jstacked), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(out.bias_spec.abs_bias.numpy(), np.asarray(jabs), rtol=0, atol=OUT_ATOL)
    # the layout's bucket is built once and kept as one device tensor
    assert again.bias_spec.rel_bucket is out.bias_spec.rel_bucket


def test_forward_logits_through_flash(env, monkeypatch):
    jm, tm = env["jm"], env["tm"]
    load_jax_params(tm.net, env["params"])
    monkeypatch.setattr(jtr, "_flash_available", lambda: True)
    jl, _ = jm.net.apply({"params": env["params"]}, env["jb"]["net_input"]["slots"])
    monkeypatch.setattr(ttr, "flash_available", lambda device: True)
    calls = []
    orig = tflash.flash_attention_fwd_reference
    monkeypatch.setattr(tflash, "flash_attention_fwd_reference",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    with torch.no_grad():
        tl, _ = tm.net(slots_to_device(env["tb"]["net_input"]["slots"], "cpu"))
    # encoder self-attention and decoder cross-attention in each of 2 layers
    assert len(calls) == 4
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("route", ["plain", "flash"])
def test_video_caption_update_matches(env, monkeypatch, route):
    jm, tm = env["jm"], env["tm"]
    load_jax_params(tm.net, env["params"])
    pad = env["td"].pad()
    jcrit = JCriterion(JCriterionConfig(label_smoothing=0.1), pad_id=pad)
    tcrit = LabelSmoothedCrossEntropyCriterion(LabelSmoothedCrossEntropyCriterionConfig(label_smoothing=0.1),
                                               pad_id=pad)
    jbatch = {"net_input": {"slots": env["jb"]["net_input"]["slots"]},
              "target": jnp.asarray(env["jb"]["target"])}
    jg, jloss, _ = jax.jit(jts.make_grad_step(jm, jcrit, fold=0))(
        env["params"], 0, jbatch, jax.random.PRNGKey(0))
    bwd = []
    if route == "flash":
        monkeypatch.setattr(ttr, "flash_available", lambda device: True)
        orig = tflash.flash_attention_bwd_reference
        monkeypatch.setattr(tflash, "flash_attention_bwd_reference",
                            lambda *a, **kw: bwd.append(1) or orig(*a, **kw))
    tg, tloss, _ = tts.make_grad_step(tm, tcrit, fold=0)(list(tm.net.parameters()), 0,
                                                         sample_to_device(env["tb"], "cpu"), 0)
    assert len(bwd) == (4 if route == "flash" else 0)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5 if route == "plain" else 1e-3)
    names = [n for n, _ in tm.net.named_parameters()]
    flat_t = jax.tree_util.tree_leaves_with_path(export_params(tm.net, dict(zip(names, tg))))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jg)))
    assert len(flat_t) == len(flat_j)
    assert any("video_image_sequence" in jax.tree_util.keystr(p) for p, _ in flat_t)
    for path, a in flat_t:
        b = np.asarray(flat_j[path], np.float32)
        ref = np.abs(b).max()
        if route == "plain":
            tol = GRAD_ATOL * max(1.0, ref) + GRAD_RTOL * np.abs(b)
            assert (np.abs(a - b) <= tol).all(), (jax.tree_util.keystr(path), np.abs(a - b).max())
            continue
        if path[-1].key == "bias" and path[-2].key in NOISE_MODULES:
            ref = KEY_BIAS_FRACTION * np.abs(
                np.asarray(flat_j[path[:-1] + (jax.tree_util.DictKey("kernel"),)])).max()
        err, tol = np.abs(a - b).max(), GRAD_ATOL + FLASH_GRAD_RTOL * ref
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


def test_video_slot_needs_no_text_group():
    """A VIDEO slot is a group of its own: it keeps its frames through
    GeneralPreprocess and collates to (B, N, H, W, 3)."""
    gp = GeneralPreprocess(Dictionary(), active=["text", "video"])
    _tune(gp)
    ist = gp(Instruction(CAPTION, split="test").format(video=_clip(np.random.default_rng(4), 5)))
    assert [s.modality.name for s in ist.slots] == ["VIDEO", "TEXT", "TEXT"]
    slot = gp.name2pre["video"].map(Slot(ist.slots[0].modality, True, value=_clip(np.random.default_rng(4), 5),
                                         column_name="video", split="test"))
    assert slot.value["inputs"].shape == (FRAMES, SIZE, SIZE, 3)
