"""The image modality of ofasys_torch against ofasys_tpu: the image
preprocessor, the 2-D bucket matrices, PatchEmbed and the image_vit adaptor,
the encoder on image + text sources, caption serving and the summed
caption + text_infilling + vqa update.

Tiny arch (2+2 layers, E=64, FFN 256, 4 heads), fp32 on both sides, images
of 64 x 64 (a 4 x 4 grid of 16-pixel patches), inputs from a numpy seed,
the same perturbed parameters (carried with ``load_jax_params``).

Tolerances:
  * preprocessing and bucket matrices: bit-equal;
  * PatchEmbed and ImageVitAdaptor outputs: atol 1e-5 (fp32 products summed
    in another order); the encoder output on image + text: atol 1e-4;
  * beam and greedy tokens: identical, scores atol 1e-4 (each JAX run first
    shows that no top-k boundary of its decode loop is a near-tie);
  * the three-task update, by default and under OFASYS_DENSE_BWD=rowmajor on
    both sides with ``attn_kernel='pallas'`` (JAX runs the Pallas kernels in
    interpret mode, the port their plain versions): loss and gnorm rtol
    1e-4, gradients atol 1e-5 + rtol 1e-3 of the leaf's largest entry,
    parameters after 2 updates as in tests/test_torch_train_step.py. The
    key-side biases (``k_proj``, ``pos_k_linear``, ``cross_pos_k_linear``)
    add the same amount to every score of a softmax row: their gradient is
    0 in exact arithmetic and rounding noise of the three summed tasks on
    both sides (entries of 1e-5), held to atol 1e-4.
"""

import base64
import io

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction, ModalityType as JModality
from ofasys_tpu import OFASys as JOFASys
from ofasys_tpu.adaptor import image as jimage
from ofasys_tpu.configure.configs import OptimizationConfig as JOptimizationConfig
from ofasys_tpu.engine import train_step as jts
from ofasys_tpu.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion as JCriterion,
    LabelSmoothedCrossEntropyCriterionConfig as JCriterionConfig,
)
from ofasys_tpu.engine.optim import build_optimizer as jbuild_optimizer
from ofasys_tpu.model import positional as jpos
from ofasys_tpu.preprocessor import image as jpimage
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_tpu.preprocessor.instruction import Slot as JSlot
from ofasys_tpu.utils.pytree import SlotBatch as JSlotBatch
from ofasys_torch import GeneralistModel, Instruction, ModalityType, OFASys
from ofasys_torch.adaptor import image as timage
from ofasys_torch.configure.configs import OptimizationConfig
from ofasys_torch.engine import train_step as tts
from ofasys_torch.engine.criterion import (
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)
from ofasys_torch.engine.optim import build_optimizer
from ofasys_torch.model import positional as tpos
from ofasys_torch.ops import dense_attention as tdense
from ofasys_torch.preprocessor import image as tpimage
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.preprocessor.instruction import Slot
from ofasys_torch.serve import InferenceServer
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import SlotBatch, sample_to_device, slots_to_device

CAPTION = "[IMAGE:img] what does the image describe? -> [TEXT:cap]"
VQA = "[IMAGE:img] [TEXT:question] -> [TEXT:answer]"
INFILL = 'what is the complete text of " [TEXT:text,mask_ratio=0.3] "? -> [TEXT:text]'
SIZE = 64                      # 4 x 4 patches of 16 pixels
NEG_INF = -1e9
LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
NOISE_GRAD_ATOL = 1e-4
PARAM_MEAN_ATOL = 2e-6
LR = 1e-3
N_UPDATES = 2
NOISE_MODULES = ("k_proj", "pos_k_linear", "cross_pos_k_linear")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(rng, h=SIZE, w=SIZE):
    return rng.integers(0, 256, (h, w, 3)).astype(np.float32)


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr.astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


# --------------------------------------------------------------- preprocessor
def _map_both(value, split="test", **cfg):
    jpre = jpimage.ImagePreprocess(None, jpimage.ImagePreprocessConfig(**cfg))
    tpre = tpimage.ImagePreprocess(None, tpimage.ImagePreprocessConfig(**cfg))
    js = jpre.map(JSlot(JModality.IMAGE, True, value=value, column_name="img", split=split))
    ts = tpre.map(Slot(ModalityType.IMAGE, True, value=value, column_name="img", split=split))
    return (jpre, js), (tpre, ts)


@pytest.mark.parametrize("kind", ["at_size", "fractional", "resize", "png_bytes", "base64", "pil",
                                  "train_crop_flip"])
def test_image_preprocess_is_bit_equal(kind):
    rng = np.random.default_rng(0)
    cfg = dict(patch_image_size=32)
    split = "test"
    if kind == "at_size":
        value = _image(rng, 32, 32)
    elif kind == "fractional":                 # truncated to uint8 on both sides
        value = _image(rng, 32, 32) + 0.75
    elif kind == "resize":
        value = _image(rng, 48, 40)
    elif kind == "png_bytes":
        value = _png(_image(rng, 40, 56))
    elif kind == "base64":
        value = base64.b64encode(_png(_image(rng, 40, 56))).decode()
    elif kind == "pil":
        value = Image.fromarray(_image(rng, 50, 50).astype(np.uint8))
    else:
        value = _image(rng, 80, 72)
        cfg.update(random_crop=True, random_flip=True, seed=3,
                   mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
        split = "train"
    (jpre, js), (tpre, ts) = _map_both(value, split, **cfg)
    a, b = js.value["inputs"], ts.value["inputs"]
    assert b.dtype == np.float32 and b.shape == (32, 32, 3)
    np.testing.assert_array_equal(b, a)
    jb = jpre.collate([js, js]).net_input_slot
    tb = tpre.collate([ts, ts]).net_input_slot
    np.testing.assert_array_equal(tb.value["inputs"], jb.value["inputs"])
    assert (tb.modality.name, tb.is_src, tb.column_name, tb.split) == \
        (jb.modality.name, jb.is_src, jb.column_name, jb.split)


def test_array_at_size_needs_no_pil(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL is absent")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    arr = _image(np.random.default_rng(1), 32, 32)
    out = tpimage.resize_image(tpimage.load_image(arr), 32)
    np.testing.assert_array_equal(out, arr)
    with pytest.raises(ImportError):
        tpimage.resize_image(_image(np.random.default_rng(1), 40, 40), 32)


def test_unported_image_options_raise(tmp_path, monkeypatch):
    """A remote image source goes through cached_path's fetchers: an oss://
    source without a registered fetcher raises, with one it loads as the
    local file does, as in ofasys_tpu. RandAugment, the box preprocessor
    and image_resnet (Queue A item 7) build."""
    from ofasys_tpu.utils import file_utils as jfu
    from ofasys_torch.utils import file_utils as tfu

    pre = tpimage.ImagePreprocess(None, tpimage.ImagePreprocessConfig(rand_augment=True))
    assert (pre._rand_augment.n, pre._rand_augment.m, pre._rand_augment.rng) == (2, 9, pre.rng)
    monkeypatch.setenv("OFA_CACHE_HOME", str(tmp_path / "cache"))
    for fu in (jfu, tfu):
        monkeypatch.delitem(fu._SCHEME_FETCHERS, "oss", raising=False)
    with pytest.raises(ValueError, match="no fetcher for scheme 'oss'"):
        tpimage.load_image("oss://bucket/cat.png")
    local = tmp_path / "cat.png"
    Image.fromarray(_image(np.random.default_rng(2), 20, 24).astype(np.uint8)).save(local)

    def fetch(url, dest):
        with open(local, "rb") as a, open(dest, "wb") as b:
            b.write(a.read())

    for fu in (jfu, tfu):
        monkeypatch.setitem(fu._SCHEME_FETCHERS, "oss", fetch)
    got = tpimage.load_image("oss://bucket/cat.png")
    np.testing.assert_array_equal(got, tpimage.load_image(str(local)))
    np.testing.assert_array_equal(got, jpimage.load_image("oss://bucket/cat.png"))
    d = Dictionary()
    gp = GeneralPreprocess(d, active=["text", "image", "imagenet", "imagepretrain"])
    assert gp.name2pre["imagenet"].cfg.random_crop and not gp.name2pre["image"].cfg.random_crop
    assert type(GeneralPreprocess(d, active=["box"]).name2pre["box"]).__name__ == "BoxPreprocess"
    m = GeneralistModel(arch="tiny")
    m.cfg.encoder.layers = m.cfg.decoder.layers = 1
    m.initialize(d, active_adaptors=("text", "image_resnet"), device="cpu",
                 adaptor_cfgs={"image_resnet": timage.ImageResnetAdaptorConfig(resnet_type="resnet50")})
    assert hasattr(m.net.encoder_adaptor, "image_resnet")
    assert not hasattr(m.net.decoder_adaptor, "image_resnet")


# ------------------------------------------------------------ bucket matrices
@pytest.mark.parametrize("bucket_size", [3, 14, 42])
def test_image_bucket_matrices_equal(bucket_size):
    n = tpos.image_bucket_count(bucket_size)
    assert n == jpos.image_bucket_count(bucket_size)
    np.testing.assert_array_equal(tpos.make_image_bucket_position(bucket_size, n),
                                  jpos.make_image_bucket_position(bucket_size, n))
    np.testing.assert_array_equal(timage._grid_positions(4, 5, bucket_size),
                                  jimage._grid_positions(4, 5, bucket_size))


# ----------------------------------------------------- PatchEmbed and adaptor
def test_patch_embed_matches_flax_and_round_trips():
    rng = np.random.default_rng(2)
    images = rng.standard_normal((3, 48, 40, 3)).astype(np.float32)     # ragged edge: 3 x 2 grid
    jmod = jimage.PatchEmbed(24, 16, dtype=jnp.float32)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(images))["params"])
    params = {"kernel": np.asarray(params["kernel"]),
              "bias": rng.standard_normal(24).astype(np.float32)}
    assert params["kernel"].shape == (16, 16, 3, 24)
    tmod = timage.PatchEmbed(24, 16, torch.float32)
    load_jax_params(tmod, params)
    want = jmod.apply({"params": params}, jnp.asarray(images))
    got = tmod(torch.from_numpy(images))
    assert tuple(got.shape) == (3, 3, 2, 24)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    back = export_params(tmod)
    assert set(back) == {"kernel", "bias"}
    np.testing.assert_array_equal(back["kernel"], params["kernel"])
    np.testing.assert_array_equal(back["bias"], params["bias"])


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
        if name in ("bias", "type_embedding", "c_attn"):
            return a + 0.05 * noise
        if name == "scale":
            return a + 0.1 * noise
        if name == "kernel":
            return a * kernel_gain
        return a

    return jax.tree_util.tree_map_with_path(f, jax.device_get(params))


@pytest.mark.parametrize("vit_layers", [0, 1])
def test_image_vit_adaptor_matches_flax(vit_layers):
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    jm, tm = JModel(arch="tiny"), GeneralistModel(arch="tiny")
    _tiny_cfg(jm)
    _tiny_cfg(tm)
    jad = jimage.ImageVitAdaptor(
        cfg=jm.cfg, adaptor_cfg=jimage.ImageVitAdaptorConfig(vit_layers=vit_layers), is_src=True,
        embed_tokens=nn.Embed(16, 64), pad_id=1, dtype=jnp.float32)
    jslot = JSlotBatch(JModality.IMAGE, True, value={"inputs": jnp.asarray(images)}, column_name="img")
    params = _perturb(jad.init(jax.random.PRNGKey(1), jslot)["params"], seed=4)
    want = jad.apply({"params": params}, jslot)

    tad = timage.ImageVitAdaptor(tm.cfg, True, torch.nn.Embedding(16, 64), 1, torch.float32,
                                 vit_layers=vit_layers)
    load_jax_params(tad, params)
    tslot = SlotBatch(ModalityType.IMAGE, True, value={"inputs": torch.from_numpy(images)},
                      column_name="img")
    with torch.no_grad():
        got = tad(tslot)
    assert tuple(got.embed.shape) == (2, 16, 64) and got.modal_id == want.modal_id == 1
    np.testing.assert_allclose(got.embed.numpy(), np.asarray(want.embed), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.pos_embed.numpy(), np.asarray(want.pos_embed), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.padding_mask.numpy(), np.asarray(want.padding_mask))
    np.testing.assert_array_equal(got.rel_bucket, want.rel_bucket)
    np.testing.assert_array_equal(got.rel_tables.detach().numpy(), np.asarray(want.rel_tables))
    # the flax-shaped tree comes back leaf for leaf (4-D patch kernel included)
    back = export_params(tad)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        np.testing.assert_array_equal(a, np.asarray(flat_j[path]), err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------- whole model
def _dictionary(cls):
    d = cls()
    for i in range(60):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def _words(rng, n_chars):
    words = ["a", "dog", "runs", "on", "the", "beach", "with", "red", "ball", "what", "is", "in",
             "image", "two", "people", "near", "water"]
    s = ""
    while len(s) < n_chars:
        s += rng.choice(words) + " "
    return s[:n_chars].strip()


def _records(seed=7):
    rng = np.random.default_rng(seed)
    caption = [{"img": _image(rng), "cap": _words(rng, int(rng.integers(18, 24)))} for _ in range(16)]
    infill = [{"text": _words(rng, int(rng.integers(40, 56)))} for _ in range(8)]
    vqa = [{"img": _image(rng), "question": _words(rng, int(rng.integers(12, 16))),
            "answer": _words(rng, int(rng.integers(5, 8)))} for _ in range(8)]
    return {"caption": (CAPTION, caption), "infill": (INFILL, infill), "vqa": (VQA, vqa)}


@pytest.fixture(scope="module")
def env():
    jd = _dictionary(JDictionary)
    jm = JModel(arch="tiny")
    _tiny_cfg(jm)
    jgp = JGeneralPreprocess(jd, active=["text", "image"])
    jgp.name2pre["image"].cfg.patch_image_size = SIZE
    jm.initialize(jd, active_adaptors=("text", "image_vit"), dtype=jnp.float32)

    td = _dictionary(Dictionary)
    tm = GeneralistModel(arch="tiny")
    _tiny_cfg(tm)
    tgp = GeneralPreprocess(td, active=["text", "image"])
    tgp.name2pre["image"].cfg.patch_image_size = SIZE
    tm.initialize(td, active_adaptors=("text", "image_vit"), dtype=torch.float32, device="cpu")
    assert len(jd) == len(td) and jd.symbols == td.symbols

    jb, tb = {}, {}
    for name, (tpl, recs) in _records().items():
        jb[name] = jgp.collate([jgp(JInstruction(tpl, split="train").format(**r)) for r in recs])
        tb[name] = tgp.collate([tgp(Instruction(tpl, split="train").format(**r)) for r in recs])
    params = _perturb(jm.init_params(jax.random.PRNGKey(0),
                                     [b["net_input"]["slots"] for b in jb.values()]))
    return dict(jm=jm, jd=jd, jgp=jgp, tm=tm, td=td, tgp=tgp, params=params, jb=jb, tb=tb)


def test_batches_identical(env):
    for name in env["jb"]:
        js, ts = env["jb"][name], env["tb"][name]
        for a, b in zip(js["net_input"]["slots"], ts["net_input"]["slots"], strict=True):
            assert (a.modality.name, a.is_src, a.column_name) == (b.modality.name, b.is_src, b.column_name)
            np.testing.assert_array_equal(b.value["inputs"], np.asarray(a.value["inputs"]))
            assert b.value["inputs"].dtype == np.asarray(a.value["inputs"]).dtype
        np.testing.assert_array_equal(ts["target"], js["target"])
    # an IMAGE slot is a group of its own: vqa has image, question and target slots
    assert [s.modality.name for s in env["tb"]["vqa"]["net_input"]["slots"]] == ["IMAGE", "TEXT", "TEXT"]


def test_image_vit_lives_on_the_encoder_side_only(env):
    """flax creates image_vit's parameters where a slot calls it; the port
    builds it on the encoder side alone, so the trees match leaf for leaf."""
    tm = env["tm"]
    names = [n for n, _ in tm.net.named_parameters()]
    assert any(n.startswith("encoder_adaptor.image_vit.") for n in names)
    assert not any(n.startswith("decoder_adaptor.image_vit") for n in names)
    load_jax_params(tm.net, env["params"])              # raises on a missing or an unused leaf
    back = export_params(tm.net)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(env["params"]))
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        np.testing.assert_array_equal(a, np.asarray(flat_j[path]), err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("task", ["caption", "vqa"])
def test_encoder_on_image_and_text_sources_matches(env, task):
    """Two source slots (the image, then the caption prompt or the question)
    with rel-pos tables of different sizes (image 6,892 buckets, text 511)
    through the block-diagonal bucket matrix."""
    jm, tm = env["jm"], env["tm"]
    load_jax_params(tm.net, env["params"])
    jsrc = [s for s in env["jb"][task]["net_input"]["slots"] if s.is_src]
    tsrc = slots_to_device([s for s in env["tb"][task]["net_input"]["slots"] if s.is_src], "cpu")
    jenc = jm.net.apply({"params": env["params"]}, jsrc, method=jm.net.encode)
    with torch.no_grad():
        a = tm.net.encoder_adaptor(tsrc)
        tenc = tm.net.encode(tsrc)
    assert len(tsrc) == 2
    B, n_text = tsrc[1].value["inputs"].shape
    assert tuple(tenc.x.shape) == (B, 16 + n_text, 64)
    assert a.bias_spec.tables.shape[1] == 1 + tpos.image_bucket_count(42) + 511
    assert (a.bias_spec.bucket[:16, 16:] == 0).all() and (a.bias_spec.bucket[16:, :16] == 0).all()
    assert (a.bias_spec.bucket[:16, :16] > 0).all() and (a.bias_spec.bucket[16:, 16:] > 6892).all()
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
            return 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, env["params"])


@pytest.mark.parametrize("template,opts", [
    (CAPTION, {"beam_size": 1, "max_len_b": 10}),
    (CAPTION, {"beam_size": 3, "max_len_b": 10}),
    (VQA, {"beam_size": 2, "max_len_b": 8}),
], ids=["caption_greedy", "caption_beam3", "vqa_beam2"])
def test_hub_tokens_match_jax(env, serve_params, monkeypatch, template, opts):
    rng = np.random.default_rng(5)
    recs = [{"img": _image(rng), "question": _words(rng, 14)} for _ in range(3)]
    if template == CAPTION:
        recs = [{"img": r["img"]} for r in recs]
    margins = []
    monkeypatch.setattr(jax.lax, "top_k", _recording_top_k(margins))
    jout = JOFASys(env["jm"], serve_params, env["jd"], env["jgp"]).inference(template, recs, **opts)
    monkeypatch.undo()
    assert margins and min(margins) > 1e-3, f"near-tie in the JAX run: {min(margins, default=None)}"
    hub = OFASys(env["tm"], serve_params, env["td"], env["tgp"], device="cpu")
    tout = hub.inference(template, recs, **opts)
    for a, b in zip(jout, tout, strict=True):
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens))
        assert abs(a.score - b.score) <= 1e-4
        assert a.text == b.text


def test_server_batches_image_requests(env, serve_params):
    hub = OFASys(env["tm"], serve_params, env["td"], env["tgp"], device="cpu")
    rng = np.random.default_rng(6)
    datas = [{"img": _image(rng)} for _ in range(5)]
    datas[1] = {"img": _png(datas[1]["img"])}               # bytes and arrays batch together
    direct = [hub.inference(CAPTION, dd, beam_size=2, max_len_b=6) for dd in datas]
    with InferenceServer(hub, max_batch=4, max_wait_ms=200.0, device="cpu") as srv:
        futs = [srv.submit(CAPTION, dd, beam_size=2, max_len_b=6) for dd in datas]
        outs = [f.result(timeout=300) for f in futs]
        st = srv.stats()
    for o, ref in zip(outs, direct):
        np.testing.assert_array_equal(o.tokens, ref.tokens)
    assert st["requests"] == 5 and st["batches"] < 5


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


def _jax_sample(s):
    return {"net_input": {"slots": s["net_input"]["slots"]}, "target": jnp.asarray(s["target"])}


@pytest.mark.parametrize("bwd", ["default", "rowmajor"])
def test_three_task_update_matches_ofasys_tpu(env, monkeypatch, bwd):
    """One summed caption + text_infilling + vqa update under
    attn_kernel='pallas': gradients leaf by leaf, then N_UPDATES updates
    (losses, gnorm, parameters). With OFASYS_DENSE_BWD=rowmajor both sides
    take the row-major backward on every dense attention."""
    if bwd == "rowmajor":
        monkeypatch.setenv("OFASYS_DENSE_BWD", "rowmajor")
    else:
        monkeypatch.delenv("OFASYS_DENSE_BWD", raising=False)
    jm, tm = env["jm"], env["tm"]
    monkeypatch.setattr(jm.cfg, "attn_kernel", "pallas")
    monkeypatch.setattr(tm.cfg, "attn_kernel", "pallas")
    load_jax_params(tm.net, env["params"])
    pad = env["td"].pad()
    jcrit = JCriterion(JCriterionConfig(label_smoothing=0.1), pad_id=pad)
    tcrit = LabelSmoothedCrossEntropyCriterion(
        LabelSmoothedCrossEntropyCriterionConfig(label_smoothing=0.1), pad_id=pad)
    tasks = list(env["jb"])
    jbatch = {n: _jax_sample(env["jb"][n]) for n in tasks}
    tbatch = {n: sample_to_device(env["tb"][n], "cpu") for n in tasks}
    # images reach the net as fp32, token ids as integers
    assert tbatch["caption"]["net_input"]["slots"][0].value["inputs"].dtype == torch.float32
    assert tbatch["caption"]["net_input"]["slots"][1].value["inputs"].dtype == torch.int64

    calls = {"rowmajor": 0, "fwd": 0}
    for key, name in (("rowmajor", "dense_attention_bwd_rowmajor"), ("fwd", "dense_attention_fwd")):
        orig = getattr(tdense, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(tdense, name, counted)

    names = [n for n, _ in tm.net.named_parameters()]
    jgrads = tgrads = None
    for i, n in enumerate(tasks):
        jg, _, _ = jax.jit(jts.make_grad_step(jm, jcrit, fold=i))(
            env["params"], 0, jbatch[n], jax.random.PRNGKey(0))
        tg, _, _ = tts.make_grad_step(tm, tcrit, fold=i)(list(tm.net.parameters()), 0, tbatch[n], 0)
        jgrads = jg if jgrads is None else jax.tree.map(jnp.add, jgrads, jg)
        tgrads = tg if tgrads is None else [a + b for a, b in zip(tgrads, tg)]
    # the dense gate (B * Tq >= 256) opens for the caption and infill calls
    # and the vqa encoder: each ran the dense forward, and its backward was
    # row-major exactly under the switch
    assert calls["fwd"] >= 2 * 6 + 2
    assert calls["rowmajor"] == (calls["fwd"] if bwd == "rowmajor" else 0)
    _close_tree(export_params(tm.net, dict(zip(names, tgrads))), jax.device_get(jgrads),
                {"atol": GRAD_ATOL, "rtol": GRAD_RTOL, "noise_atol": NOISE_GRAD_ATOL})

    jopt = jbuild_optimizer(JOptimizationConfig(lr=(LR,)), total_num_update=10)
    topt = build_optimizer(OptimizationConfig(lr=(LR,)), total_num_update=10)
    jstate = jts.TrainState.create(env["params"], jopt)
    tstate = tts.TrainState.create(tm.net, topt)
    jstep = jax.jit(jts.make_multitask_train_step(jm, {n: jcrit for n in tasks}, jopt))
    tstep = tts.make_multitask_train_step(tm, {n: tcrit for n in tasks}, topt)
    for _ in range(N_UPDATES):
        jstate, jmet = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        tstate, tmet = tstep(tstate, tbatch, 0)
        np.testing.assert_allclose(float(tmet["gnorm"]), float(jmet["gnorm"]), rtol=LOSS_RTOL)
        for n in tasks:
            for key in ("loss", "nll_loss", "sample_size"):
                np.testing.assert_allclose(float(tmet["tasks"][n][key]),
                                           float(jmet["tasks"][n][key]), rtol=LOSS_RTOL)
    _close_tree(export_params(tm.net), jax.device_get(jstate.params),
                {"atol": 2 * N_UPDATES * LR, "rtol": 0.0, "mean_atol": PARAM_MEAN_ATOL})
