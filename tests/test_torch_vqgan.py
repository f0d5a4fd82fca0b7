"""VQGAN image codes in ofasys_torch against ofasys_tpu: ``GumbelVQ``
encode and decode at 32 px, the taming mapping on a seeded state_dict,
``VQGANTokenizer``'s weight files, the ``image_vqgan`` adaptor (its grid
positions, relative bias and tied output) inside the whole model, beam
search over the ``<code>`` range, ``Task("image_gen")`` and
``Task("image_infilling")`` trained through ``Trainer.fit``, and image_gen's
best-of-N rerank with an injected scorer.

VQGAN at 32 px with ch 32 (channels 32, 32, 64, 128), 64 codes of 64
dims, z 64: a 4 x 4 grid, attention at the 32 px level and in the mid
stacks. The codes come from a hard argmax, and at random weights two
codebook logits can nearly tie: codes are compared where the top-2 margin
of ofasys_tpu's logits exceeds CODE_MARGIN, and the excluded count is
logged. The models: tiny arch (2+2 layers), fp32, the same perturbed
parameters; the adaptors' code_image_size is 32 (16 codes an image) on
both sides through their ConfigStores, with 64 codes.

Tolerances: code logits atol 1e-4; decoded images atol 1e-4; the adaptor's
outputs atol 1e-5; the model's logits atol 1e-4; beam tokens equal, scores
rtol 1e-4 (tests/test_torch_search.py's margin guard).
"""

import logging
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu.configure import ConfigStore as JConfigStore
from ofasys_tpu.model import vqgan as jvq
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_tpu.utils import torch_import as jti
import ofasys_torch.task  # noqa: F401  (registers the task zoo)
from ofasys_torch import GeneralistModel, Instruction, Trainer, TrainerConfig
from ofasys_torch.configure.config_store import ConfigStore
from ofasys_torch.generator import SequenceGenerator
from ofasys_torch.model import vqgan as tvq
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.utils import torch_import as tti
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import slots_to_device

from test_torch_audio import _perturb, _tiny_cfg  # noqa: F401
from test_torch_search import _one_torch_thread, assert_same_hypotheses, jax_generate  # noqa: F401

logger = logging.getLogger(__name__)

VQ = dict(n_embed=64, embed_dim=64, z_channels=64, ch=32, resolution=32)
CODE_MARGIN = 1e-3
IMG_ATOL = 1e-4
GEN = "[TEXT:cap] -> [IMAGE:code,preprocess=image_vqgan,adaptor=image_vqgan]"
SIZE = 32
N_CODES = 16


def _vq_params(seed=0):
    """ofasys_tpu's GumbelVQ at 32 px and the weights both packages load:
    flax's initializers as the port draws them (``init_vqgan_``), exported
    to flax's tree, whose paths and shapes must be those ofasys_tpu's init
    traces (``jax.eval_shape``: its init is not compiled); biases, norms
    and the codebook perturbed so every parameter matters."""
    m = jvq.GumbelVQ(**VQ)
    shapes = jax.eval_shape(lambda r: m.init(r, jnp.zeros((1, SIZE, SIZE, 3)))["params"],
                            jax.random.PRNGKey(seed))
    tm = tvq.GumbelVQ(**VQ)
    tvq.init_vqgan_(tm, torch.Generator().manual_seed(seed))
    params = export_params(tm)
    assert _shapes(params) == _shapes(shapes)
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if path[-1].key in ("bias", "scale"):
            return a + 0.1 * noise
        if path[-1].key == "embedding":
            return noise
        return a

    return m, jax.tree_util.tree_map_with_path(f, jax.device_get(params))


def _shapes(tree):
    return {jax.tree_util.keystr(p): (tuple(a.shape), np.dtype(a.dtype))
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def vq():
    jm, params = _vq_params()
    tm = tvq.GumbelVQ(**VQ)
    load_jax_params(tm, params)
    images = np.random.default_rng(1).uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    return dict(jm=jm, params=params, tm=tm, images=images)


def _codes_where_clear(jlogits, tcodes):
    """ofasys_tpu's argmax codes, the port's, and the cells whose top-2
    margin exceeds CODE_MARGIN."""
    top2 = np.sort(jlogits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > CODE_MARGIN).reshape(len(jlogits), -1)
    return np.argmax(jlogits, -1).reshape(len(jlogits), -1), tcodes, clear


def test_gumbel_vq_encode_and_decode_match(vq):
    jm, params, tm, x = vq["jm"], vq["params"], vq["tm"], vq["images"]
    jlogits = np.asarray(jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, method=lambda m, x: m.quant_proj(m.quant_conv(m.encoder(x)))))(params, jnp.asarray(x)))
    with torch.no_grad():
        tlogits = tm.code_logits(torch.as_tensor(x)).numpy()
        tcodes = tm.encode_codes(torch.as_tensor(x)).numpy()
    assert tlogits.shape == jlogits.shape == (3, 4, 4, 64)
    np.testing.assert_allclose(tlogits, jlogits, rtol=0, atol=1e-4)
    jcodes, tcodes, clear = _codes_where_clear(jlogits, tcodes)
    logger.info("codes compared at %d of %d cells (top-2 margin > %g)", clear.sum(), clear.size, CODE_MARGIN)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(tcodes[clear], jcodes[clear])
    jencode = jax.jit(lambda p, x: jm.apply({"params": p}, x, method=jm.encode_codes))
    np.testing.assert_array_equal(np.asarray(jencode(params, jnp.asarray(x)))[clear], jcodes[clear])
    jimg = np.asarray(jax.jit(lambda p, c: jm.apply({"params": p}, c, method=jm.decode_codes))(
        params, jnp.asarray(jcodes, jnp.int32)))
    with torch.no_grad():
        timg = tm.decode_codes(torch.as_tensor(jcodes, dtype=torch.long)).numpy()
    assert timg.shape == (3, SIZE, SIZE, 3)
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=IMG_ATOL)


def test_export_is_the_flax_tree(vq):
    back = export_params(vq["tm"])
    flat_j = dict(jax.tree_util.tree_leaves_with_path(vq["params"]))
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        np.testing.assert_array_equal(a, np.asarray(flat_j[path]), err_msg=jax.tree_util.keystr(path))


def _taming_state_dict(tm: tvq.GumbelVQ):
    """A taming GumbelVQ state_dict of ``tm``'s weights (taming's names,
    torch layouts), with the entries the mapping leaves out."""
    import re

    sd = {}
    for name, p in tm.named_parameters():
        k = name.replace("mid_block_1", "mid.block_1").replace("mid_block_2", "mid.block_2")
        k = k.replace("mid_attn", "mid.attn_1")
        k = re.sub(r"(down|up)_(\d+)_(block|attn)_(\d+)", r"\1.\2.\3.\4", k)
        k = re.sub(r"(down|up)_(\d+)_(downsample|upsample)", r"\1.\2.\3.conv", k)
        k = k.replace("quant_proj", "quantize.proj").replace("post_quant_proj", "post_quant_conv")
        k = k.replace("codebook.weight", "quantize.embed.weight")
        sd[k] = p.detach().clone()
    sd["loss.discriminator.main.0.weight"] = torch.zeros(2, 3)
    sd["quantize.temperature"] = torch.tensor(1.0)
    return sd


def test_taming_mapping_matches_ofasys_tpu(vq):
    """A seeded taming state_dict maps to the same tree in both packages and
    loads into the port's GumbelVQ bit for bit."""
    torch.manual_seed(0)
    src = tvq.GumbelVQ(**VQ)
    tvq.init_vqgan_(src, torch.Generator().manual_seed(5))
    sd = _taming_state_dict(src)
    assert "encoder.down.0.attn.1.q.weight" in sd and "decoder.up.3.upsample.conv.weight" in sd
    np_sd = {k: v.numpy() for k, v in sd.items()}
    jtree, ttree = jti.taming_to_flax_params(np_sd), tti.taming_to_flax_params(np_sd)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jtree))
    flat_t = jax.tree_util.tree_leaves_with_path(ttree)
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        np.testing.assert_array_equal(a, flat_j[path], err_msg=jax.tree_util.keystr(path))
    dst = tvq.GumbelVQ(**VQ)
    load_jax_params(dst, ttree)
    for (n, a), (_, b) in zip(src.named_parameters(), dst.named_parameters()):
        assert torch.equal(a, b), n
    # and ofasys_tpu's GumbelVQ on that tree gives the port's images
    codes = np.arange(3 * N_CODES).reshape(3, N_CODES) % 64
    jm = vq["jm"]
    jimg = np.asarray(jax.jit(lambda p, c: jm.apply({"params": p}, c, method=jm.decode_codes))(
        jtree, jnp.asarray(codes, jnp.int32)))
    with torch.no_grad():
        timg = dst.decode_codes(torch.as_tensor(codes)).numpy()
    np.testing.assert_allclose(timg, jimg, rtol=0, atol=IMG_ATOL)


@pytest.mark.parametrize("fmt", ["pt", "npz", "seed"])
def test_tokenizer_weight_files(vq, tmp_path, fmt):
    """VQGANTokenizer reads a taming .pt and a pickled flax tree .npz into
    the same model; without a file it draws its weights from the seed.
    encode takes [0, 1] images, decode returns them in [0, 1]."""
    path = None
    if fmt == "pt":
        path = str(tmp_path / "vqgan.ckpt")
        torch.save({"state_dict": _taming_state_dict(vq["tm"])}, path)
    elif fmt == "npz":
        path = str(tmp_path / "vqgan.npz")
        np.savez(path, params=np.frombuffer(pickle.dumps(vq["params"]), np.uint8))
    vq_kw = {k: v for k, v in VQ.items() if k not in ("n_embed", "resolution")}
    tok = tvq.VQGANTokenizer(SIZE, 64, weights_path=path, device="cpu", **vq_kw)
    assert tok.codes_per_image == N_CODES
    imgs = (vq["images"] + 1.0) / 2.0
    codes = tok.encode(imgs)
    assert codes.shape == (3, N_CODES) and codes.dtype == np.int32
    out = tok.decode(codes)
    assert out.shape == (3, SIZE, SIZE, 3) and out.min() >= 0.0 and out.max() <= 1.0
    if fmt == "seed":
        again = tvq.VQGANTokenizer(SIZE, 64, device="cpu", **vq_kw)
        np.testing.assert_array_equal(again.encode(imgs), codes)
        return
    for a, b in zip(tok.model.parameters(), vq["tm"].parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def store_32px():
    """Both packages' image_vqgan preprocessor and adaptor at 32 px, with
    64 codes (the VQGAN above): a top-k over 8,192 random code embeddings
    would meet near-ties at nearly every step."""
    nodes = [(s.get("ofasys.preprocess", "image_vqgan").config, s.get("ofasys.adaptor", "image_vqgan").config)
             for s in (JConfigStore(), ConfigStore())]
    saved = [(p.code_image_size, p.num_codes, a.code_image_size) for p, a in nodes]
    for p, a in nodes:
        p.code_image_size = a.code_image_size = SIZE
        p.num_codes = 64
    yield
    for (p, a), (ps, pn, as_) in zip(nodes, saved):
        p.code_image_size, p.num_codes, a.code_image_size = ps, pn, as_


def _code_records(rng, n, start):
    caps = ["a red square", "a blue circle on grass", "two dogs", "the sea at night"]
    return [{"cap": caps[i % 4], "code": (rng.integers(0, 64, N_CODES) + start).astype(np.int32)}
            for i in range(n)]


@pytest.fixture(scope="module")
def model_env(store_32px):
    jd = JDictionary()
    jgp = JGeneralPreprocess(jd, active=["text", "image_vqgan"])
    jd.pad_to_multiple_(8)
    td = Dictionary()
    tgp = GeneralPreprocess(td, active=["text", "image_vqgan"]).to("cpu")
    td.pad_to_multiple_(8)
    assert jd.symbols == td.symbols
    jpre, tpre = jgp.name2pre["image_vqgan"], tgp.name2pre["image_vqgan"]
    assert (jpre.code_start, jpre.code_end) == (tpre.code_start, tpre.code_end)
    assert tpre.constraint_range == jpre.constraint_range

    adaptors = ("text", "image_vqgan")
    jm = JModel(arch="tiny")
    _tiny_cfg(jm)
    jm.initialize(jd, active_adaptors=adaptors, dtype=jnp.float32)
    tm = GeneralistModel(arch="tiny")
    _tiny_cfg(tm)
    tm.initialize(td, active_adaptors=adaptors, dtype=torch.float32, device="cpu")
    recs = _code_records(np.random.default_rng(2), 4, tpre.code_start)
    jb = jgp.collate([jgp(JInstruction(GEN, split="train").format(**r)) for r in recs])
    tb = tgp.collate([tgp(Instruction(GEN, split="train").format(**r)) for r in recs])
    jt = jgp.collate([jgp(JInstruction("[TEXT:src] -> [TEXT:tgt]", split="train").format(
        src="a dog", tgt="runs"))])
    params = _perturb(jm.init_params(jax.random.PRNGKey(0),
                                     [jb["net_input"]["slots"], jt["net_input"]["slots"]]), kernel_gain=2.0)
    load_jax_params(tm.net, params)
    return dict(jm=jm, jd=jd, jgp=jgp, tm=tm, td=td, tgp=tgp, params=[params], jb=jb, tb=tb,
                recs=recs, tpre=tpre)


def test_image_vqgan_adaptor_matches(model_env):
    """Code tokens through the shared embedding, grid positions (bos in
    slot 0), the image-bucket relative bias; the adaptor lives on the
    decoder side only."""
    env = model_env
    ts, js = env["tb"], env["jb"]
    np.testing.assert_array_equal(ts["target"], js["target"])
    # 16 codes and EOS a row, padded to a multiple of 8
    assert ts["target"].shape == (4, 24) and ((ts["target"] != env["td"].pad()).sum(1) == N_CODES + 1).all()
    names = [n for n, _ in env["tm"].net.named_parameters()]
    assert "decoder_adaptor.image_vqgan.image_rel_pos_table" in names
    assert not any(n.startswith("encoder_adaptor.image_vqgan") for n in names)
    jslot = js["net_input"]["slots"][1]
    tslot = slots_to_device(ts["net_input"]["slots"], "cpu")[1]
    j_ad = env["jm"].net.apply({"params": env["params"][0]}, [jslot],
                               method=lambda net, s: net.decoder_adaptor(s))
    with torch.no_grad():
        t_ad = env["tm"].net.decoder_adaptor([tslot])
    for key in ("embed", "pos_embed"):
        np.testing.assert_allclose(getattr(t_ad, key).numpy(), np.asarray(getattr(j_ad, key)),
                                   rtol=0, atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(t_ad.bias_spec.bucket, np.asarray(j_ad.bias_spec.bucket))
    np.testing.assert_allclose(t_ad.bias_spec.layer_bias(1).numpy(),
                               np.asarray(j_ad.bias_spec.layer_bias(1)), rtol=0, atol=1e-5)


def test_image_gen_logits_match(model_env):
    env = model_env
    jlogits, _ = jax.jit(lambda p, s: env["jm"].apply(p, s))(env["params"][0], env["jb"]["net_input"]["slots"])
    with torch.no_grad():
        tlogits, _ = env["tm"].apply(slots_to_device(env["tb"]["net_input"]["slots"], "cpu"))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


def test_code_beam_search_matches(model_env, monkeypatch):
    """Beam 2 over the <code> range with 16 codes forced (min_len = max_len_b
    = 16): the same hypotheses, every token a code but the final EOS."""
    env = model_env
    opts = dict(beam_size=2, max_len_b=N_CODES, min_len=N_CODES,
                constraint_range=f"({env['tpre'].constraint_range})", return_n_best=2)
    data = [{"cap": r["cap"]} for r in env["recs"]]
    js = env["jgp"].collate([env["jgp"](JInstruction(GEN, split="test").format(**r)) for r in data])
    ts = env["tgp"].collate([env["tgp"](Instruction(GEN, split="test").format(**r)) for r in data])
    jout = jax_generate(monkeypatch, env, js, **opts)
    tout = SequenceGenerator(env["tm"], env["td"], **opts).generate(ts)
    assert_same_hypotheses(jout, tout)
    pre = env["tpre"]
    for hyps in tout:
        for h in hyps:
            assert len(h.tokens) == N_CODES + 1 and h.tokens[-1] == env["td"].eos()
            assert ((h.tokens[:-1] >= pre.code_start) & (h.tokens[:-1] < pre.code_end)).all()


# ------------------------------------------------------------- the tasks
def _image_records(rng, n):
    caps = ["a red square", "a blue circle"]
    return [{"cap": caps[i % 2], "img": (rng.random((SIZE, SIZE, 3)) * 255).astype(np.uint8),
             "code": (rng.random((SIZE, SIZE, 3)) * 255).astype(np.float32)} for i in range(n)]


def _fit(task, tmp_path, updates=2):
    model = GeneralistModel(arch="tiny")
    _tiny_cfg(model)
    cfg = TrainerConfig()
    cfg.common.dtype = "float32"
    cfg.checkpoint.no_save = True
    cfg.checkpoint.save_dir = str(tmp_path)
    trainer = Trainer(cfg, device="cpu")
    trainer.fit(model, [task], max_update=updates)
    assert int(trainer.state.step) == updates
    assert np.isfinite(trainer.meters[f"{task.name}:loss"].avg)
    return model, trainer


@pytest.fixture(scope="module")
def image_gen(store_32px, tmp_path_factory):
    """Task("image_gen") on 8 records in batches of 4, fitted 2 updates."""
    task = ConfigStore().get("ofasys.task", "image_gen").target_cls()
    task.cfg.dataset.batch_size = 4
    task.add_dataset(_image_records(np.random.default_rng(0), 8), "train")
    model, _ = _fit(task, tmp_path_factory.mktemp("image_gen"))
    return task, model


def _generate(task, model, **generation):
    """The first batch's hypotheses under these generation options (the
    task's generator built anew)."""
    for key, value in generation.items():
        setattr(task.cfg.generation, key, value)
    task._generator = None
    batch = next(task.get_batch_iterator("train", fresh=True).next_epoch_itr(shuffle=False))
    return batch, task.inference(model, None, batch)


def test_image_gen_trains_and_generates_codes(image_gen):
    """Task("image_gen") encodes its images to codes on the trainer's
    device, takes 2 updates, and generates only <code> tokens, decoded to
    32 x 32 images."""
    task, model = image_gen
    pre = task.general_preprocess.name2pre["image_vqgan"]
    assert pre.tokenizer.device == torch.device("cpu")
    assert "image_vqgan" in model.net.active_adaptors
    batch, outs = _generate(task, model, beam=1, max_len_b=N_CODES, min_len=N_CODES, return_n_best=1)
    assert ((batch["target"] != task.global_dict.pad()).sum(1) == N_CODES + 1).all()
    for hyps in outs:
        toks = hyps[0].tokens[:-1]
        assert len(toks) == N_CODES
        assert ((toks >= pre.code_start) & (toks < pre.code_end)).all()
        assert hyps[0].image.shape == (SIZE, SIZE, 3)


def test_image_gen_rerank_best_of_n(image_gen):
    """return_n_best 3: three sampling beams a prompt, every candidate
    decoded in one VQGAN pass, ordered best-first by the injected scorer,
    which saw the stack and the query text; 'none' and 'auto' without CLIP
    weights leave the order as decoded, 'clip' without weights raises."""
    task, model = image_gen
    pre = task.general_preprocess.name2pre["image_vqgan"]
    calls = []

    def scorer(images, text):
        calls.append((images.shape, text))
        return images.reshape(images.shape[0], -1).mean(axis=1)

    pre.rerank_scorer = scorer
    try:
        _, outs = _generate(task, model, max_len_b=N_CODES, min_len=N_CODES, return_n_best=3)
    finally:
        pre.rerank_scorer = None
    assert len(calls) == 4 and calls[0][0] == (3, SIZE, SIZE, 3) and calls[0][1] in ("a red square",
                                                                                       "a blue circle")
    for hyps in outs:
        assert len(hyps) == 3
        scores = [h.extra["rerank_score"] for h in hyps]
        assert scores == sorted(scores, reverse=True)
        for h in hyps:
            assert ((h.tokens[:-1] >= pre.code_start) & (h.tokens[:-1] < pre.code_end)).all()
    images = np.zeros((2, SIZE, SIZE, 3), np.float32)
    saved = pre.cfg.rerank
    try:
        for mode in ("none", "auto"):
            pre.cfg.rerank, pre._clip = mode, None
            assert pre.rerank_scores(images, "x") is None
        pre.cfg.rerank, pre._clip = "clip", None
        with pytest.raises(FileNotFoundError):
            pre.rerank_scores(images, "x")
    finally:
        pre.cfg.rerank, pre._clip = saved, None


class _FakeClipModel(torch.nn.Module):
    """Stands in for transformers' CLIPModel: loads from a directory that
    holds a config.json (else OSError, as for weights that do not load)
    and scores each image by its mean pixel."""

    def __init__(self):
        super().__init__()
        self.gain = torch.nn.Parameter(torch.ones(()))

    @classmethod
    def from_pretrained(cls, path, local_files_only):
        assert local_files_only
        if not os.path.exists(os.path.join(path, "config.json")):
            raise OSError(f"no config.json in {path}")
        return cls()

    def forward(self, pixel_values, input_ids):
        assert pixel_values.device == self.gain.device == input_ids.device
        return type("Out", (), {"logits_per_image": (pixel_values.mean((1, 2, 3)) * self.gain)[:, None]})


class _FakeClipProcessor:
    @classmethod
    def from_pretrained(cls, path, local_files_only):
        return cls()

    def __call__(self, text, images, return_tensors, padding):
        return {"pixel_values": torch.as_tensor(np.stack(images)).float(),
                "input_ids": torch.zeros(len(text), 1, dtype=torch.long)}


def test_clip_rerank_loads_on_the_tokenizers_device(tmp_path, monkeypatch):
    """CLIP (a stand-in module for transformers') loads from a local
    directory onto the preprocessor's device and scores there; under
    'auto' a weights directory that does not load raises, while a missing
    directory or a missing ``transformers`` means no rerank ('clip'
    raises for both)."""
    pre = GeneralPreprocess(Dictionary(), active=["text", "image_vqgan"]).to("cpu").name2pre["image_vqgan"]
    images = np.random.default_rng(4).random((3, SIZE, SIZE, 3)).astype(np.float32)
    fake = types.SimpleNamespace(CLIPModel=_FakeClipModel, CLIPProcessor=_FakeClipProcessor)
    monkeypatch.setitem(sys.modules, "transformers", fake)
    pre.cfg.rerank, pre.cfg.clip_model = "auto", str(tmp_path)
    with pytest.raises(OSError):
        pre.rerank_scores(images, "x")
    (tmp_path / "config.json").write_text("{}")
    scores = pre.rerank_scores(images, "x")
    want = np.clip(images * 255.0, 0, 255).astype(np.uint8).reshape(3, -1).mean(1)
    np.testing.assert_allclose(scores, want, rtol=1e-5)
    assert next(pre._clip[0].parameters()).device == pre.device == torch.device("cpu")
    monkeypatch.setitem(sys.modules, "transformers", None)
    for mode in ("auto", "clip"):
        pre.cfg.rerank, pre._clip = mode, None
        if mode == "auto":
            assert pre.rerank_scores(images, "x") is None
        else:
            with pytest.raises(ImportError):
                pre.rerank_scores(images, "x")


def test_image_infilling_trains(store_32px, tmp_path):
    """Task("image_infilling"): an image_vit source (64 px patches) and a
    code target, 2 updates through Trainer.fit."""
    node = ConfigStore().get("ofasys.preprocess", "image").config
    saved = node.patch_image_size
    node.patch_image_size = 64
    try:
        task = ConfigStore().get("ofasys.task", "image_infilling").target_cls()
        task.cfg.dataset.batch_size = 4
        task.add_dataset(_image_records(np.random.default_rng(3), 8), "train")
        model, _ = _fit(task, tmp_path)
    finally:
        node.patch_image_size = saved
    assert {"image_vit", "image_vqgan"} <= set(model.net.active_adaptors)
