"""One summed refcoco + vqa update of ofasys_torch through image_resnet
against ofasys_tpu's: the train split with the BOX preprocessor's joint
transforms, both tasks through the ResNet trunk (resnet50 on both sides:
ofasys_tpu's registered image_resnet config is set to it for this module),
label-smoothed CE 0.1, adamw with weight decay and clipping at 1.0.

Tiny arch (2+2 layers, E=64, FFN 256, 4 heads), 64 x 64 images (a 4 x 4
grid), a vocab of the byte symbols and the 1,000 ``<bin>_i``.

Tolerances: the update runs in fp64 on both sides (``jax.enable_x64``, the
model's compute dtype float64, fp32 parameters). A 53-convolution trunk in
fp32 puts some ReLU inputs within the two sides' rounding of 0, and one
such input on the other side of the kink moves whole gradient columns
(tests/test_torch_resnet.py). The LayerNorms and the criterion compute in
fp32 on the port's side, so: losses and gnorm rtol 1e-5; gradients atol
1e-8 + rtol 1e-5 of the leaf's largest entry, and atol 1e-4 (as in
tests/test_torch_image.py) for the key-side biases (``k_proj``,
``pos_k_linear``, ``cross_pos_k_linear``), whose gradient is 0 in exact
arithmetic and rounding noise on both sides; parameters after the update,
as in tests/test_torch_image.py: atol 2 lr (adam divides a gradient by its
own size, so an entry whose gradient is rounding noise moves by up to lr
either way) and a mean absolute difference of at most 2e-6 a leaf (the key
side biases excepted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofasys_tpu.preprocessor.box  # noqa: F401  (registers "box" in the ConfigStore)
from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu.configure import ConfigStore
from ofasys_tpu.configure.configs import OptimizationConfig as JOptimizationConfig
from ofasys_tpu.engine import train_step as jts
from ofasys_tpu.engine.criterion.label_smoothed_cross_entropy import (
    LabelSmoothedCrossEntropyCriterion as JCriterion,
    LabelSmoothedCrossEntropyCriterionConfig as JCriterionConfig,
)
from ofasys_tpu.engine.optim import build_optimizer as jbuild_optimizer
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction
from ofasys_torch.adaptor.image import ImageResnetAdaptorConfig
from ofasys_torch.configure.configs import OptimizationConfig
from ofasys_torch.engine import train_step as tts
from ofasys_torch.engine.criterion import (
    LabelSmoothedCrossEntropyCriterion,
    LabelSmoothedCrossEntropyCriterionConfig,
)
from ofasys_torch.engine.optim import build_optimizer
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import sample_to_device

REFCOCO_RESNET = ('[IMAGE:img,adaptor=image_resnet] which region does the text " [TEXT:text] " '
                  'describe? -> [BOX:region_coord]')
VQA_RESNET = "[IMAGE:img,adaptor=image_resnet] [TEXT:question] -> [TEXT:answer]"
SIZE = 64
LR = 1e-3
PARAM_MEAN_ATOL = 2e-6
NOISE_MODULES = ("k_proj", "pos_k_linear", "cross_pos_k_linear")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _image(rng, h=SIZE, w=SIZE):
    return rng.integers(0, 256, (h, w, 3)).astype(np.float32)


def _words(rng, n_chars):
    words = ["a", "man", "left", "red", "car", "the", "dog", "near", "small", "tree", "on", "right"]
    s = ""
    while len(s) < n_chars:
        s += rng.choice(words) + " "
    return s[:n_chars].strip()


def _refcoco_records(rng, n, lo, hi):
    """Images of lo..hi pixels a side, not square, a seeded region each."""
    out = []
    for _ in range(n):
        h, w = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
        x0, y0 = rng.uniform(0, 0.6 * w), rng.uniform(0, 0.6 * h)
        region = {"box": [x0, y0, x0 + rng.uniform(8, 0.4 * w), y0 + rng.uniform(8, 0.4 * h)],
                  "width": float(w), "height": float(h)}
        out.append({"img": _image(rng, h, w), "text": _words(rng, 12), "region_coord": region})
    return out


def _preprocess_pair():
    jd, td = JDictionary(), Dictionary()
    active = ["text", "image", "box"]
    jgp, tgp = JGeneralPreprocess(jd, active=active), GeneralPreprocess(td, active=active)
    for gp in (jgp, tgp):
        gp.name2pre["image"].cfg.patch_image_size = SIZE
    assert jd.symbols == td.symbols
    return jd, jgp, td, tgp


def _same_batch(jb, tb):
    for a, b in zip(jb["net_input"]["slots"], tb["net_input"]["slots"], strict=True):
        np.testing.assert_array_equal(b.value["inputs"], np.asarray(a.value["inputs"]))
    np.testing.assert_array_equal(tb["target"], jb["target"])


def _tiny_cfg(m):
    c = m.cfg
    for stack in (c.encoder, c.decoder):
        stack.embed_dim, stack.ffn_embed_dim, stack.attention_heads, stack.layers = 64, 256, 4, 2
    c.dropout = 0.0


def _perturb(params, seed=11):
    """Random embeddings and biases, statistics off their init values."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "embedding":
            return 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if name in ("bias", "type_embedding", "mean"):
            return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "var":
            return (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, jax.device_get(params))


@pytest.fixture(scope="module")
def resnet50_in_jax():
    """ofasys_tpu's GeneralAdaptor builds image_resnet from the ConfigStore's
    registered config: resnet50 there for this module (resnet101 by
    default on both sides)."""
    node = ConfigStore().get("ofasys.adaptor", "image_resnet").config
    old = node.resnet_type
    node.resnet_type = "resnet50"
    yield
    node.resnet_type = old


def _jax_sample(s):
    return {"net_input": {"slots": s["net_input"]["slots"]}, "target": jnp.asarray(s["target"])}


def _close_tree(t, j, atol, rtol, noise_atol=0.0, mean_atol=None):
    """Leaf by leaf: max |t - j| <= atol + rtol * max |j| (at least
    noise_atol on the key-side biases), and the mean below mean_atol on
    every other leaf."""
    flat_t = jax.tree_util.tree_leaves_with_path(t)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(j))
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        b = np.asarray(flat_j[path])
        name = jax.tree_util.keystr(path)
        assert a.shape == b.shape, name
        noise = path[-1].key == "bias" and path[-2].key in NOISE_MODULES
        tol = atol + rtol * np.abs(b).max()
        if noise:
            tol = max(tol, noise_atol)
        err = np.abs(a - b).max()
        assert err <= tol, (name, err, tol)
        if mean_atol is not None and not noise:
            assert np.abs(a - b).mean() <= mean_atol, (name, np.abs(a - b).mean())


def test_refcoco_vqa_update_through_image_resnet_matches_ofasys_tpu(resnet50_in_jax):
    """One summed refcoco + vqa update (label-smoothed CE 0.1, adamw, clip
    1.0) on the train split with the joint box transforms, both tasks
    through image_resnet at resnet50: losses, gnorm, gradients leaf by leaf
    (trunk convolutions and statistics included) and the parameters after."""
    jd, jgp, td, tgp = _preprocess_pair()
    rng = np.random.default_rng(6)
    ref = _refcoco_records(rng, 4, 80, 120)
    vqa = [{"img": _image(rng), "question": _words(rng, 12), "answer": _words(rng, 5)} for _ in range(4)]
    tasks = {"refcoco": (REFCOCO_RESNET, ref), "vqa": (VQA_RESNET, vqa)}
    jb = {n: jgp.collate([jgp(JInstruction(tpl, split="train").format(**r)) for r in rs])
          for n, (tpl, rs) in tasks.items()}
    tb = {n: tgp.collate([tgp(Instruction(tpl, split="train").format(**r)) for r in rs])
          for n, (tpl, rs) in tasks.items()}
    for n in tasks:
        _same_batch(jb[n], tb[n])
    assert tb["refcoco"]["net_input"]["slots"][0].value["inputs"].shape == (4, SIZE, SIZE, 3)

    jm, tm = JModel(arch="tiny"), GeneralistModel(arch="tiny")
    _tiny_cfg(jm)
    _tiny_cfg(tm)
    pad = td.pad()
    opt = dict(lr=(LR,), clip_norm=1.0, weight_decay=0.01)
    with jax.enable_x64(True):
        jm.initialize(jd, active_adaptors=("text", "image_resnet"), dtype=jnp.float64)
        params = _perturb(jm.init_params(jax.random.PRNGKey(0),
                                         [b["net_input"]["slots"] for b in jb.values()]))
        jcrit = JCriterion(JCriterionConfig(label_smoothing=0.1), pad_id=pad)
        jopt = jbuild_optimizer(JOptimizationConfig(**opt), total_num_update=10)
        jbatch = {n: _jax_sample(b) for n, b in jb.items()}
        jgrads = None
        for i, n in enumerate(tasks):
            g, _, _ = jax.jit(jts.make_grad_step(jm, jcrit, fold=i))(params, 0, jbatch[n],
                                                                      jax.random.PRNGKey(0))
            jgrads = g if jgrads is None else jax.tree.map(jnp.add, jgrads, g)
        jstate, jmet = jax.jit(jts.make_multitask_train_step(jm, {n: jcrit for n in tasks}, jopt))(
            jts.TrainState.create(params, jopt), jbatch, jax.random.PRNGKey(0))
        jgrads, jnew, jmet = jax.device_get((jgrads, jstate.params, jmet))

    tm.initialize(td, active_adaptors=("text", "image_resnet"), dtype=torch.float64, device="cpu",
                  adaptor_cfgs={"image_resnet": ImageResnetAdaptorConfig(resnet_type="resnet50")})
    load_jax_params(tm.net, params)
    assert any(n.startswith("encoder_adaptor.image_resnet.embed_images.layer3_5.bn3.var")
               for n, _ in tm.net.named_parameters())
    tcrit = LabelSmoothedCrossEntropyCriterion(
        LabelSmoothedCrossEntropyCriterionConfig(label_smoothing=0.1), pad_id=pad)
    topt = build_optimizer(OptimizationConfig(**opt), total_num_update=10)
    tbatch = {n: sample_to_device(b, "cpu") for n, b in tb.items()}
    names = [n for n, _ in tm.net.named_parameters()]
    tgrads = None
    for i, n in enumerate(tasks):
        g, _, _ = tts.make_grad_step(tm, tcrit, fold=i)(list(tm.net.parameters()), 0, tbatch[n], 0)
        tgrads = g if tgrads is None else [a + b for a, b in zip(tgrads, g)]
    _close_tree(export_params(tm.net, dict(zip(names, tgrads))), jgrads, atol=1e-8, rtol=1e-5,
                noise_atol=1e-4)
    tstate, tmet = tts.make_multitask_train_step(tm, {n: tcrit for n in tasks}, topt)(
        tts.TrainState.create(tm.net, topt), tbatch, 0)
    np.testing.assert_allclose(float(tmet["gnorm"]), float(jmet["gnorm"]), rtol=1e-5)
    for n in tasks:
        for key in ("loss", "nll_loss", "sample_size"):
            np.testing.assert_allclose(float(tmet["tasks"][n][key]), float(jmet["tasks"][n][key]),
                                       rtol=1e-5)
    _close_tree(export_params(tm.net), jnew, atol=2 * LR, rtol=0.0, mean_atol=PARAM_MEAN_ATOL)
