"""``modal_ffn`` of ofasys_torch against ofasys_tpu: the FeedForward with
modality spans (with and without scale_fc), the adaptor's merged spans,
the parameter set against a flax tree built from the same init slot lists,
the whole encode / decode forward, and the decode-step behaviour.

flax creates a FeedForward's ``experts_fc{1,2}_{id}`` only for the modality
ids its init calls saw, and the plain ``fc1``/``fc2`` only if a call passed
no spans (none does when every call comes from a slot list). The port
takes the same set from the slot lists given to ``initialize``. A cached
decode step passes no spans in ofasys_tpu, so it needs ``fc1``: its apply
raises, and so does the port's.

Tiny arch (2+2 layers, E=64, FFN 256, 4 heads), fp32, 64 x 64 images.
Tolerances: FeedForward atol 1e-5; encoder states and logits atol 1e-4
(fp32 products summed in another order, as in tests/test_torch_image.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofasys_tpu.preprocessor.box  # noqa: F401  (registers "box" in the ConfigStore)
from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu import OFASys as JOFASys
from ofasys_tpu.model import transformer as jtransformer
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction, OFASys
from ofasys_torch.model import transformer as ttransformer
from ofasys_torch.model.ofa import modal_ids_of
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.utils.jax_params import export_params, load_jax_params
from ofasys_torch.utils.pytree import slots_to_device

REFCOCO = '[IMAGE:img] which region does the text " [TEXT:text] " describe? -> [BOX:region_coord]'
VQA = "[IMAGE:img] [TEXT:question] -> [TEXT:answer]"
SIZE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(m):
    c = m.cfg
    for stack in (c.encoder, c.decoder):
        stack.embed_dim, stack.ffn_embed_dim, stack.attention_heads, stack.layers = 64, 256, 4, 2
    c.dropout = 0.0
    return m


def _words(rng, n_chars):
    words = ["a", "man", "left", "red", "car", "the", "dog", "near", "small", "tree", "what", "is"]
    s = ""
    while len(s) < n_chars:
        s += rng.choice(words) + " "
    return s[:n_chars].strip()


def _image(rng):
    return rng.integers(0, 256, (SIZE, SIZE, 3)).astype(np.float32)


# -------------------------------------------------------------- FeedForward
@pytest.mark.parametrize("scale_fc", [True, False])
def test_feed_forward_with_spans_matches_flax(scale_fc):
    jm, tm = _tiny(JModel(arch="tiny", modal_ffn=True, scale_fc=scale_fc)), \
        _tiny(GeneralistModel(arch="tiny", modal_ffn=True, scale_fc=scale_fc))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 11, 64)).astype(np.float32)
    spans = ((0, 4, 1), (4, 9, 0), (9, 11, 2))
    jf = jtransformer.FeedForward(jm.cfg, 256, 64, dtype=jnp.float32)
    params = jax.device_get(jf.init(jax.random.PRNGKey(1), x, True, spans)["params"])
    assert sorted(params) == sorted(
        [f"experts_fc{k}_{i}" for k in (1, 2) for i in (0, 1, 2)]
        + ([f"experts_fc2_{i}_ln" for i in (0, 1, 2)] if scale_fc else []))
    params = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    want = np.asarray(jf.apply({"params": params}, x, True, spans))
    tf = ttransformer.FeedForward(tm.cfg, 256, 64, torch.float32, modal_ids=(1, 0, 2))
    load_jax_params(tf, params)
    with torch.no_grad():
        got = tf(torch.from_numpy(x), None, spans).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # a call without spans needs the plain pair: flax's apply raises, so does the port
    with pytest.raises(Exception, match="fc1"):
        jf.apply({"params": params}, x, True, None)
    with pytest.raises(LookupError, match="fc1"):
        tf(torch.from_numpy(x))


def test_feed_forward_without_modal_ffn_ignores_spans():
    tm = _tiny(GeneralistModel(arch="tiny"))
    tf = ttransformer.FeedForward(tm.cfg, 256, 64, torch.float32)
    assert hasattr(tf, "fc1") and not hasattr(tf, "experts_fc1_0")
    x = torch.randn(2, 5, 64)
    with torch.no_grad():
        assert torch.equal(tf(x, None, ((0, 2, 1), (2, 5, 0))), tf(x))


# ------------------------------------------------------------ whole model
@pytest.fixture(scope="module")
def env():
    active = ["text", "image", "box"]
    jd, td = JDictionary(), Dictionary()
    jgp, tgp = JGeneralPreprocess(jd, active=active), GeneralPreprocess(td, active=active)
    for gp in (jgp, tgp):
        gp.name2pre["image"].cfg.patch_image_size = SIZE
    rng = np.random.default_rng(2)
    ref = [{"img": _image(rng), "text": _words(rng, 12),
            "region_coord": [0.1, 0.2, 0.6, 0.7]} for _ in range(3)]
    vqa = [{"img": _image(rng), "question": _words(rng, 10), "answer": _words(rng, 5)} for _ in range(3)]
    jb, tb = {}, {}
    for name, tpl, recs in (("refcoco", REFCOCO, ref), ("vqa", VQA, vqa)):
        jb[name] = jgp.collate([jgp(JInstruction(tpl, split="test").format(**r)) for r in recs])
        tb[name] = tgp.collate([tgp(Instruction(tpl, split="test").format(**r)) for r in recs])
    jm = _tiny(JModel(arch="tiny", modal_ffn=True))
    jm.initialize(jd, active_adaptors=("text", "image_vit"), dtype=jnp.float32)
    slot_lists = [b["net_input"]["slots"] for b in jb.values()]
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                          jax.device_get(jm.init_params(jax.random.PRNGKey(0), slot_lists)))
    tm = _tiny(GeneralistModel(arch="tiny", modal_ffn=True))
    tm.initialize(td, active_adaptors=("text", "image_vit"), dtype=torch.float32, device="cpu",
                  sample_slots=[b["net_input"]["slots"] for b in tb.values()])
    return dict(jm=jm, tm=tm, jd=jd, td=td, jgp=jgp, tgp=tgp, jb=jb, tb=tb, params=params)


def test_parameter_set_matches_the_flax_tree(env):
    """The experts of the init lists' modalities on each side (encoder:
    image and text; decoder: box and text), no plain pair; the flax tree
    loads leaf for leaf and comes back."""
    tm, params = env["tm"], env["params"]
    ffn = params["encoder"]["layers_0"]["ffn"]
    assert sorted(k for k in ffn if not k.endswith("_ln")) == \
        ["experts_fc1_0", "experts_fc1_1", "experts_fc2_0", "experts_fc2_1"]
    dffn = params["decoder"]["layers_1"]["ffn"]
    assert sorted(k for k in dffn if not k.endswith("_ln")) == \
        ["experts_fc1_0", "experts_fc1_2", "experts_fc2_0", "experts_fc2_2"]
    assert modal_ids_of([b["net_input"]["slots"] for b in env["tb"].values()]) == \
        {"encoder": (1, 0), "decoder": (2, 0)}
    load_jax_params(tm.net, params)                       # raises on a missing or unused leaf
    back = export_params(tm.net)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        np.testing.assert_array_equal(a, np.asarray(flat_j[path]), err_msg=jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="modal_ffn needs"):
        _tiny(GeneralistModel(arch="tiny", modal_ffn=True)).initialize(env["td"], device="cpu")


@pytest.mark.parametrize("task", ["refcoco", "vqa"])
def test_forward_with_spans_matches_jax(env, task):
    """The encoder's spans (image, then text) and the decoder's (the target
    group) route through their experts: encoder states and logits."""
    jm, tm = env["jm"], env["tm"]
    load_jax_params(tm.net, env["params"])
    jslots = env["jb"][task]["net_input"]["slots"]
    tslots = slots_to_device(env["tb"][task]["net_input"]["slots"], "cpu")
    with torch.no_grad():
        a = tm.net.encoder_adaptor([s for s in tslots if s.is_src])
        d = tm.net.decoder_adaptor([s for s in tslots if not s.is_src])
    n_img = (SIZE // 16) ** 2
    assert a.modal_spans == ((0, n_img, 1), (n_img, a.embed.shape[1], 0))
    assert d.modal_spans == ((0, d.embed.shape[1], 2 if task == "refcoco" else 0),)
    jenc = jm.net.apply({"params": env["params"]}, [s for s in jslots if s.is_src], method=jm.net.encode)
    jlogits, _ = jm.net.apply({"params": env["params"]}, jslots)
    with torch.no_grad():
        tenc = tm.net.encode([s for s in tslots if s.is_src])
        tlogits, _ = tm.net(tslots)
    np.testing.assert_allclose(tenc.x.numpy(), np.asarray(jenc.x), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)


def test_generate_raises_where_jax_does(env):
    """A cached decode step passes no spans, as in ofasys_tpu: without the
    plain fc1 both sides' generate raises."""
    load_jax_params(env["tm"].net, env["params"])
    recs = [{"img": _image(np.random.default_rng(4)), "text": "the red car"}]
    with pytest.raises(Exception, match="fc1"):
        JOFASys(env["jm"], env["params"], env["jd"], env["jgp"]).inference(REFCOCO, recs)
    with pytest.raises(LookupError, match="fc1"):
        OFASys(env["tm"], None, env["td"], env["tgp"], device="cpu").inference(REFCOCO, recs)
