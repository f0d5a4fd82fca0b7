"""ofasys_torch's reference-checkpoint import (utils/torch_import.py)
against ofasys_tpu's, on the same weights.

- ``export_reference_state_dict`` of the port equals ofasys_tpu's key for
  key and bit for bit (tiny arch; text + image_resnet at resnet50, audio_fbank
  and motion_6d).
- Importing that state_dict (with the reference's extra keys: the
  decoder's copy of embed_tokens, BatchNorm's num_batches_tracked, and one
  key dropped) gives the port the parameters ofasys_tpu's import gives,
  bit for bit, with the same ``missing`` and ``unused`` lists; a shorter
  vocabulary axis is re-padded alike; ``strict=True`` refuses on both sides.
- ``load_torch_checkpoint`` reads the four dict shapes alike;
  ``check_converted_params`` fails with ofasys_tpu's text.
- The CLI round trip into ``OFASys.from_pretrained`` serves the tokens of
  ofasys_tpu's round trip (fp32, beam 3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ofasys_tpu import GeneralistModel as JModel, OFASys as JOFASys
from ofasys_tpu.configure import ConfigStore as JConfigStore
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_tpu.utils import torch_import as jti
from ofasys_torch import GeneralistModel, OFASys
from ofasys_torch.configure import ConfigStore
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.utils import torch_import as tti
from ofasys_torch.utils.jax_params import export_params, load_jax_params

ADAPTORS = ("text", "image_resnet", "audio_fbank", "motion_6d")
TPL = "[TEXT:src] -> [TEXT:tgt]"
RECS = [{"src": "the storm moved north"}, {"src": "a short article about the weather today"}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def resnet50():
    """Both stores' image_resnet at resnet50 for the module; restored after."""
    cfgs = [s.get("ofasys.adaptor", "image_resnet").config for s in (JConfigStore(), ConfigStore())]
    saved = [c.resnet_type for c in cfgs]
    for c in cfgs:
        c.resnet_type = "resnet50"
    yield
    for c, rt in zip(cfgs, saved):
        c.resnet_type = rt


def _dictionary():
    d = JDictionary()
    JGeneralPreprocess(d, active=["text"])
    for i in range(100):
        d.add_symbol(f"<text>_{i}")
    d.pad_to_multiple_(8)
    return d


def _slots(adaptors):
    """One slot list per adaptor for ofasys_tpu's init (32 x 32 images
    through image_resnet, 80 fbank frames, 8 motion frames of 135)."""
    from ofasys_tpu import ModalityType as M
    from ofasys_tpu.utils.pytree import SlotBatch

    src = SlotBatch(M.TEXT, True, {"inputs": jnp.zeros((1, 4), jnp.int32)}, "src")
    tgt = SlotBatch(M.TEXT, False, {"inputs": jnp.zeros((1, 4), jnp.int32)}, "tgt")
    extra = {
        "image_resnet": SlotBatch(M.IMAGE, True, {"inputs": jnp.zeros((1, 32, 32, 3))}, "img",
                                  ("adaptor=image_resnet",)),
        "audio_fbank": SlotBatch(M.AUDIO, True, {"inputs": jnp.zeros((1, 80, 80))}, "wav"),
        "motion_6d": SlotBatch(M.MOTION, False, {"value": jnp.zeros((1, 8, 135))}, "bvh",
                               ("adaptor=motion_6d",)),
    }
    lists = [[src, tgt]]
    for name in adaptors[1:]:
        s = extra[name]
        lists.append([s, tgt] if s.is_src else [src, s])
    return lists


def _init_all(net, lists):
    for slots in lists:
        out = net(list(slots), deterministic=True)
    return out


def _models(adaptors, layers=2):
    """An ofasys_tpu parameter tree of seeded normal values (its shapes from
    tracing the model's init, which is all the key mapping needs), other
    parameters of the same tree (the port's own initialization), and a port
    model holding the first (tiny arch, ``layers`` + ``layers``)."""
    d = _dictionary()
    jm = JModel(arch="tiny")
    jm.cfg.dropout = 0.0
    jm.cfg.encoder.layers = jm.cfg.decoder.layers = layers
    jm.initialize(d, active_adaptors=adaptors, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r: jm.net.init({"params": r}, _slots(adaptors), method=_init_all)["params"],
                            jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)
    tm = GeneralistModel(arch="tiny")
    tm.cfg.dropout = 0.0
    tm.cfg.encoder.layers = tm.cfg.decoder.layers = layers
    tm.initialize(Dictionary.from_state_dict(d.state_dict()), active_adaptors=adaptors,
                  dtype=torch.float32, device="cpu", seed=1)
    other = export_params(tm.net)
    load_jax_params(tm.net, params)
    return (params, other), tm


@pytest.fixture(scope="module")
def models(resnet50):
    return _models(ADAPTORS)


def _reference_extras(sd):
    """The keys a reference checkpoint has beyond the mapped ones: the
    decoder's copy of the token embedding and BatchNorm's step counters."""
    out = dict(sd)
    out["decoder.adaptor.embed_tokens.weight"] = sd["encoder.adaptor.embed_tokens.weight"]
    for k in sd:
        if k.endswith(".running_mean"):
            out[k[: -len("running_mean")] + "num_batches_tracked"] = np.asarray(0, np.int64)
    return out


def _flat(tree):
    return dict(tti._walk(tree))


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert list(g) == list(w)
    for k in w:
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)


def test_export_matches_ofasys_tpu(models):
    (params, _), tm = models
    want = jti.export_reference_state_dict(params)
    got = tti.export_reference_state_dict(tm)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tti.export_reference_state_dict(export_params(tm.net)).keys() == want.keys()
    assert any(".layer3." in k for k in want) and "encoder.adaptor.text.type_embedding.weight" in want


@pytest.mark.parametrize("drop", [None, "encoder.layers.1.fc1.weight"])
def test_import_matches_ofasys_tpu(models, drop):
    (params, other), tm = models
    sd = _reference_extras(jti.export_reference_state_dict(params))
    if drop:
        sd.pop(drop)
    load_jax_params(tm.net, other)               # the target starts from the other weights
    _, missing, unused = tti.import_reference_state_dict(sd, tm)
    jparams, jmissing, junused = jti.import_reference_state_dict(sd, other)
    assert missing == jmissing and unused == junused
    assert missing == ([] if drop is None else ["encoder/layers_1/ffn/fc1/kernel"])
    assert "decoder.adaptor.embed_tokens.weight" in unused
    assert sum(k.endswith("num_batches_tracked") for k in unused) == len(unused) - 1
    _assert_trees_equal(export_params(tm.net), jparams)
    if drop is None:
        _assert_trees_equal(export_params(tm.net), params)
    with pytest.raises(KeyError, match="missing"):
        tti.import_reference_state_dict({k: v for k, v in sd.items() if k != "decoder.layer_norm.weight"},
                                        tm, strict=True)
    with pytest.raises(KeyError, match="missing"):
        jti.import_reference_state_dict({k: v for k, v in sd.items() if k != "decoder.layer_norm.weight"},
                                        other, strict=True)
    load_jax_params(tm.net, params)


def test_vocab_axis_repad_matches_ofasys_tpu(models):
    (params, other), tm = models
    sd = jti.export_reference_state_dict(params)
    key = "encoder.adaptor.embed_tokens.weight"
    sd[key] = sd[key][:-8]                       # a vocabulary 8 rows shorter
    load_jax_params(tm.net, other)
    _, missing, _ = tti.import_reference_state_dict(sd, tm)
    jparams, jmissing, _ = jti.import_reference_state_dict(sd, other)
    assert missing == jmissing == []
    _assert_trees_equal(export_params(tm.net), jparams)
    emb = export_params(tm.net)["embed_tokens"]["embedding"]
    np.testing.assert_array_equal(emb[-8:], other["embed_tokens"]["embedding"][-8:])
    load_jax_params(tm.net, params)


@pytest.mark.parametrize("wrap", ["model", "state_dict", "generator", None])
def test_load_torch_checkpoint_matches(tmp_path, wrap):
    rng = np.random.default_rng(0)
    sd = {f"m.{i}.weight": torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32)) for i in range(3)}
    path = str(tmp_path / "ck.pt")
    torch.save(sd if wrap is None else {wrap: sd, "args": {"arch": "x"}}, path)
    got, want = tti.load_torch_checkpoint(path), jti.load_torch_checkpoint(path)
    assert list(got) == list(want) == list(sd)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_check_converted_params_matches_ofasys_tpu():
    import flax.linen as fnn

    dense = fnn.Dense(3)
    dummy = jnp.zeros((1, 4))
    good = jax.device_get(dense.init(jax.random.PRNGKey(0), dummy)["params"])
    net = torch.nn.Linear(4, 3, device="meta")
    tti.check_converted_params(good, net, "ok")
    jti.check_converted_params(good, dense, dummy, "ok")
    for bad in ({"kernel": good["kernel"]}, {"kernel": good["kernel"][:2], "bias": good["bias"]}):
        with pytest.raises(ValueError) as t_err:
            tti.check_converted_params(bad, net, "broken")
        with pytest.raises(ValueError) as j_err:
            jti.check_converted_params(bad, dense, dummy, "broken")
        assert str(t_err.value) == str(j_err.value)


def test_cli_round_trip_serves_ofasys_tpu_tokens(tmp_path):
    tm = GeneralistModel(arch="tiny")                # the tiny arch the CLI builds
    tm.initialize(Dictionary.from_state_dict(_dictionary().state_dict()), device="cpu", seed=3)
    sd = tti.export_reference_state_dict(tm)         # ofasys_tpu's export (test above)
    pt = tmp_path / "ref.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, str(pt))
    jti.main([str(pt), str(tmp_path / "j"), "--arch", "tiny", "--adaptors", "text"])
    tti.main([str(pt), str(tmp_path / "t"), "--arch", "tiny", "--adaptors", "text", "--device", "cpu"])
    jhub = JOFASys.from_pretrained(str(tmp_path / "j" / "checkpoint_last"), dtype=jnp.float32)
    thub = OFASys.from_pretrained(str(tmp_path / "t" / "checkpoint_last"), device="cpu", dtype=torch.float32)
    assert thub.global_dict.symbols == jhub.global_dict.symbols
    kw = dict(beam_size=3, max_len_b=6)
    for a, b in zip(jhub.inference(TPL, RECS, **kw), thub.inference(TPL, RECS, **kw), strict=True):
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
    if not torch.cuda.is_available():                 # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tti.main([str(pt), str(tmp_path / "x"), "--arch", "tiny", "--adaptors", "text"])
