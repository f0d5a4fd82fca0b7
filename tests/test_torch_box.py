"""The BOX modality of ofasys_torch against ofasys_tpu: the box preprocessor
(encode_box / decode / map, the skip cases, collate with the text group),
its train-split instruction_map (flip, random resize, object-centred crop
of the image and the boxes together), constraint ranges in the generator,
and a tiny refcoco hub's 4 bin tokens (tests/test_torch_grounding.py
runs the summed refcoco + vqa update through image_resnet).

Tiny arch (2+2 layers, E=64, FFN 256, 4 heads), a vocab of the byte
symbols and the 1,000 ``<bin>_i``, images from a numpy seed. Refcoco
records are dicts {"box", "width", "height"}, as ``RefcocoTask.preprocess``
makes them from the TSV columns.

Tolerances:
  * preprocessing, instruction_map, batches: bit-equal;
  * greedy tokens: identical, scores atol 1e-4 (each JAX run first shows
    that no top-k boundary of its decode loop is a near-tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ofasys_tpu.preprocessor.box  # noqa: F401  (registers "box" in the ConfigStore)
from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu import OFASys as JOFASys
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_torch import GeneralistModel, Instruction, OFASys
from ofasys_torch.generator import search as tsearch
from ofasys_torch.preprocessor.box import BoxPreprocess, BoxPreprocessConfig
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess

REFCOCO = '[IMAGE:img] which region does the text " [TEXT:text] " describe? -> [BOX:region_coord]'
SIZE = 64
NEG_INF = -1e9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dictionary(cls):
    """The special symbols only: the text and box preprocessors add their
    namespaces (256 byte symbols, <mask>, 1,000 bins)."""
    return cls()


def _image(rng, h=SIZE, w=SIZE):
    return rng.integers(0, 256, (h, w, 3)).astype(np.float32)


def _words(rng, n_chars):
    words = ["a", "man", "left", "red", "car", "the", "dog", "near", "small", "tree", "on", "right"]
    s = ""
    while len(s) < n_chars:
        s += rng.choice(words) + " "
    return s[:n_chars].strip()


def _region(rng, h, w):
    x0, y0 = rng.uniform(0, 0.6 * w), rng.uniform(0, 0.6 * h)
    return {"box": [x0, y0, x0 + rng.uniform(8, 0.4 * w), y0 + rng.uniform(8, 0.4 * h)],
            "width": float(w), "height": float(h)}


def _refcoco_records(rng, n, sizes=None):
    """Images of SIZE x SIZE, or of sizes[0] .. sizes[1] - 1 pixels a side."""
    out = []
    for _ in range(n):
        h, w = (SIZE, SIZE) if sizes is None else (int(rng.integers(*sizes)), int(rng.integers(*sizes)))
        out.append({"img": _image(rng, h, w), "text": _words(rng, int(rng.integers(8, 14))),
                    "region_coord": _region(rng, h, w)})
    return out


def _preprocess_pair(active=("text", "image", "box")):
    jd, td = _dictionary(JDictionary), _dictionary(Dictionary)
    jgp, tgp = JGeneralPreprocess(jd, active=list(active)), GeneralPreprocess(td, active=list(active))
    for gp in (jgp, tgp):
        gp.name2pre["image"].cfg.patch_image_size = SIZE
    assert jd.symbols == td.symbols
    return jd, jgp, td, tgp


def _same_batch(jb, tb):
    for a, b in zip(jb["net_input"]["slots"], tb["net_input"]["slots"], strict=True):
        assert (a.modality.name, a.is_src, a.column_name) == (b.modality.name, b.is_src, b.column_name)
        np.testing.assert_array_equal(b.value["inputs"], np.asarray(a.value["inputs"]))
        assert b.value["inputs"].dtype == np.asarray(a.value["inputs"]).dtype
    for key in ("target", "prefix_tokens"):
        np.testing.assert_array_equal(tb[key], jb[key])
    assert tb["ntokens"] == jb["ntokens"]


# --------------------------------------------------------------- preprocessor
def test_bins_and_decode_are_bit_equal():
    jd, jgp, td, tgp = _preprocess_pair()
    jbox, tbox = jgp.name2pre["box"], tgp.name2pre["box"]
    assert (tbox.bin_start, tbox.bin_end) == (jbox.bin_start, jbox.bin_end)
    assert tbox.bin_end - tbox.bin_start == 1000 and td.symbols[tbox.bin_start] == "<bin>_0"
    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.uniform(0, 1, (50, 4)), [[0.0, 1.0, 0.5, 0.4995], [0.0005, 0.0015, 1, 1]]])
    for b in boxes:
        t, j = tbox.encode_box(b), jbox.encode_box(b)
        assert t.dtype == j.dtype == np.int32
        np.testing.assert_array_equal(t, j)
        for kw in ({}, {"width": 640.0, "height": 427.0}):
            np.testing.assert_array_equal(tbox.decode(t, **kw), jbox.decode(j, **kw))
    # decode keeps only the first 4 bin tokens and ignores the others
    toks = np.asarray([td.bos(), tbox.bin_start + 3, 7, tbox.bin_start + 999, tbox.bin_start,
                       tbox.bin_start + 500, tbox.bin_start + 1, td.eos()])
    np.testing.assert_array_equal(tbox.decode(toks), jbox.decode(toks))
    np.testing.assert_array_equal(tbox.decode(toks), np.asarray([3, 999, 0, 500], np.float32) / 999)


@pytest.mark.parametrize("split", ["test", "train"])
def test_refcoco_batches_are_bit_equal(split):
    """Dict regions (pixel coords, dims), normalized 4-vectors, a region
    over the image's edge (clipped to [0, 1]) and the skip cases, through
    the whole pipeline and the collate with the text group. On the train
    split, instruction_map moves the image and the box together."""
    jd, jgp, td, tgp = _preprocess_pair()
    rng = np.random.default_rng(1)
    recs = _refcoco_records(rng, 6, sizes=(48, 96))
    recs[1]["region_coord"] = np.asarray([0.1, 0.2, 0.7, 0.9], np.float32)
    recs[2]["region_coord"] = {"box": [-5.0, 3.0, 200.0, 40.0], "width": 60.0, "height": 50.0}
    skipped = [dict(recs[0], region_coord=[0.1, 0.2, 30.0, 0.9]),           # > 1 without dims
               dict(recs[0], region_coord=[0.1, 0.2, 0.3])]                # not 4 coords
    for r in skipped:
        assert jgp(JInstruction(REFCOCO, split="test").format(**r)) is None
        assert tgp(Instruction(REFCOCO, split="test").format(**r)) is None
    if split == "train":
        # the normalized vector has no dims; instruction_map scales it by the image's
        recs = recs[:1] + recs[2:]
    jb = jgp.collate([jgp(JInstruction(REFCOCO, split=split).format(**r)) for r in recs])
    tb = tgp.collate([tgp(Instruction(REFCOCO, split=split).format(**r)) for r in recs])
    _same_batch(jb, tb)
    box = tgp.name2pre["box"]
    tgt = tb["target"]
    assert tgt.shape[0] == len(recs)
    # 4 bin tokens then EOS: the BOX slot is the whole decoder group
    assert ((tgt[:, :4] >= box.bin_start) & (tgt[:, :4] < box.bin_end)).all()
    assert (tgt[:, 4] == td.eos()).all()
    if split == "train":
        assert box._trng.random() == jgp.name2pre["box"]._trng.random()


def test_instruction_map_is_bit_equal_from_one_seed():
    """The joint transforms one by one: image pixels and box coordinates
    after flip / resize / object-centred crop, from generators seeded
    alike, over many samples."""
    _, jgp, _, tgp = _preprocess_pair()
    jbox, tbox = jgp.name2pre["box"], tgp.name2pre["box"]
    rng = np.random.default_rng(2)
    for r in _refcoco_records(rng, 12, sizes=(200, 300)):
        ji = jbox.instruction_map(JInstruction(REFCOCO, split="train").format(**r))
        ti = tbox.instruction_map(Instruction(REFCOCO, split="train").format(**r))
        (jimg, jreg), (timg, treg) = [[s.value for s in i.slots if s.column_name in ("img", "region_coord")]
                                      for i in (ji, ti)]
        assert timg.dtype == jimg.dtype and timg.shape == jimg.shape
        np.testing.assert_array_equal(timg, jimg)
        assert treg == jreg
        # the crop is the image config's registered default size, not the live 64
        assert max(timg.shape[:2]) <= 224 and max(timg.shape[:2]) > SIZE
    # the test split and train_transforms=False leave the slots as they are
    r = _refcoco_records(rng, 1, sizes=(200, 300))[0]
    ti = tbox.instruction_map(Instruction(REFCOCO, split="test").format(**r))
    assert ti.slots[0].value is r["img"]
    off = BoxPreprocess(Dictionary(), BoxPreprocessConfig(train_transforms=False))
    ti = off.instruction_map(Instruction(REFCOCO, split="train").format(**r))
    assert ti.slots[0].value is r["img"]


def test_box_preprocess_is_registered():
    tgp = GeneralPreprocess(Dictionary(), active=["text", "box"])
    assert isinstance(tgp.name2pre["box"], BoxPreprocess)
    with pytest.raises(NotImplementedError, match="phone"):
        GeneralPreprocess(Dictionary(), active=["phone"])


# ------------------------------------------------------------------ search
def test_constraint_range_and_vocab_mask_match_jax():
    from ofasys_tpu.generator import search as jsearch

    rng = np.random.default_rng(3)
    lp = rng.standard_normal((3, 40)).astype(np.float32)
    for start, end, eos in ((5, 17, 2), (0, 40, 2), (30, 31, 39)):
        np.testing.assert_array_equal(
            tsearch.apply_constraint_range(torch.from_numpy(lp), start, end, eos).numpy(),
            np.asarray(jsearch.apply_constraint_range(jnp.asarray(lp), start, end, eos)))
    mask = rng.random((3, 40)) < 0.5
    np.testing.assert_array_equal(tsearch.apply_vocab_mask(torch.from_numpy(lp), torch.from_numpy(mask)).numpy(),
                                  np.asarray(jsearch.apply_vocab_mask(jnp.asarray(lp), jnp.asarray(mask))))


# ---------------------------------------------------------------- tiny hub
def _tiny_cfg(m, layers=2):
    c = m.cfg
    for stack in (c.encoder, c.decoder):
        stack.embed_dim, stack.ffn_embed_dim, stack.attention_heads, stack.layers = 64, 256, 4, layers
    c.dropout = 0.0


def _serve_params(params, seed=11):
    """Larger kernels and random embeddings, so the decode is not a tie."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "kernel":
            return a * 2.0
        if name == "embedding":
            return 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if name in ("bias", "type_embedding"):
            return a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, jax.device_get(params))


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
def hubs():
    jd, jgp, td, tgp = _preprocess_pair()
    jm, tm = JModel(arch="tiny"), GeneralistModel(arch="tiny")
    _tiny_cfg(jm)
    _tiny_cfg(tm)
    jm.initialize(jd, active_adaptors=("text", "image_vit"), dtype=jnp.float32)
    tm.initialize(td, active_adaptors=("text", "image_vit"), dtype=torch.float32, device="cpu")
    recs = _refcoco_records(np.random.default_rng(4), 3)
    sample = jgp.collate([jgp(JInstruction(REFCOCO, split="test").format(**r)) for r in recs])
    params = _serve_params(jm.init_params(jax.random.PRNGKey(0), sample["net_input"]["slots"]))
    return (JOFASys(jm, params, jd, jgp), OFASys(tm, params, td, tgp, device="cpu"),
            tgp.name2pre["box"])


@pytest.mark.parametrize("opts", [{}, {"constraint": True}, {"constraint": True, "beam_size": 2}],
                         ids=["hub_defaults", "constraint_range", "constraint_range_beam2"])
def test_refcoco_hub_tokens_match_jax(hubs, monkeypatch, opts):
    """The hub's BOX defaults (greedy, exactly 4 tokens), then the bin range
    as a constraint: every emitted token is a bin or EOS on both sides."""
    jhub, thub, box = hubs
    rng = np.random.default_rng(5)
    recs = [{k: v for k, v in r.items() if k != "region_coord"} for r in _refcoco_records(rng, 3)]
    kw = dict(opts)
    if kw.pop("constraint", False):
        kw["constraint_range"] = f"({box.bin_start},{box.bin_end})"
    margins = []
    monkeypatch.setattr(jax.lax, "top_k", _recording_top_k(margins))
    jout = jhub.inference(REFCOCO, recs, **kw)
    monkeypatch.undo()
    assert margins and min(margins) > 1e-3, f"near-tie in the JAX run: {min(margins, default=None)}"
    tout = thub.inference(REFCOCO, recs, **kw)
    for a, b in zip(jout, tout, strict=True):
        np.testing.assert_array_equal(b.tokens, np.asarray(a.tokens))
        assert abs(a.score - b.score) <= 1e-4
        np.testing.assert_array_equal(b.box, a.box)
        toks = np.asarray(b.tokens)
        assert len(toks) == 5 and toks[-1] == thub.global_dict.eos()
        if "constraint_range" in kw:
            assert ((toks[:4] >= box.bin_start) & (toks[:4] < box.bin_end)).all()
            assert b.box.shape == (4,) and ((b.box >= 0) & (b.box <= 1)).all()
