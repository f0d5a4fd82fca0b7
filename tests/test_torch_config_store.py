"""ofasys_torch's ConfigStore (configure/config_store.py) and config tree
against ofasys_tpu's: registration, dotted overrides and their coercion,
``update_config``, the serialized task and model groups, ``to_dict`` /
``from_dict`` round trips, and a store override of a preprocess field
moving both packages' collated batches the same way (the box
preprocessor's crop size, read from the store, included).
"""

import copy
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import pytest

import ofasys_tpu.model.ofa  # noqa: F401  (registers ofasys.model/unify)
import ofasys_tpu.task  # noqa: F401  (registers ofasys.task/default)
import ofasys_torch.model.ofa  # noqa: F401
import ofasys_torch.task  # noqa: F401
from ofasys_tpu.configure import ConfigStore as JConfigStore
from ofasys_tpu.configure import TrainerConfig as JTrainerConfig
from ofasys_tpu.configure import config_store as jcs
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_tpu.preprocessor.instruction import Instruction as JInstruction
from ofasys_torch.configure import ConfigStore, TrainerConfig
from ofasys_torch.configure import config_store as tcs
from ofasys_torch.model.config import GeneralistModelConfig
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.preprocessor.instruction import Instruction


@dataclass
class Inner:
    depth: int = 2
    names: Tuple[str, ...] = ("a",)


@dataclass
class Knobs:
    rate: float = 0.5
    steps: int = 10
    flag: bool = False
    tag: Optional[str] = None
    sizes: List[int] = field(default_factory=lambda: [1, 2])
    inner: Inner = field(default_factory=Inner)


OVERRIDES = {"test.port_store.knobs.rate": "0.25", "test.port_store.knobs.steps": "7",
             "test.port_store.knobs.flag": "yes", "test.port_store.knobs.tag": "x",
             "test.port_store.knobs.sizes": "3,4,5", "test.port_store.knobs.inner.depth": "9",
             "test.port_store.knobs.inner.names": "b,c"}


@pytest.fixture
def stores():
    for mod, store in ((jcs, JConfigStore()), (tcs, ConfigStore())):
        mod.register_config("test.port_store", "knobs", Knobs)(type("Target", (), {
            "__init__": lambda self, cfg, *a: setattr(self, "cfg", cfg)}))
    yield JConfigStore(), ConfigStore()
    for store in (JConfigStore(), ConfigStore()):
        store._nodes.pop(("test.port_store", "knobs"), None)


def test_register_get_override_update_match_ofasys_tpu(stores):
    out = []
    for store, mod in zip(stores, (jcs, tcs)):
        node = store.get("test.port_store", "knobs")
        assert node.target_cls.registry_name == "knobs"
        store.import_args(OVERRIDES)
        built = node.build()
        assert built.cfg is node.config
        cfg = copy.deepcopy(node.config)
        mod.update_config(cfg, **{"inner.depth": 4, "rate": 2})
        store.set_active("test.port_store", "knobs")
        out.append((mod.to_dict(node.config), mod.to_dict(cfg), store.names("test.port_store"),
                    [n.name for n in store.active_nodes("test.port_store")],
                    store.state_dict(groups=["test.port_store"])))
        with pytest.raises(KeyError):
            store.get("test.port_store", "missing")
        with pytest.raises(KeyError):
            store.override("nowhere.at.all", 1)
        with pytest.raises(AttributeError):
            store.override("test.port_store.knobs.nope", 1)
    assert out[0] == out[1]
    assert out[1][0]["sizes"] == [3, 4, 5] and out[1][0]["flag"] is True and out[1][1]["inner"]["depth"] == 4


@pytest.fixture
def task_and_model_nodes():
    """The task and model nodes of both stores, restored after the test."""
    nodes = [store.get(g, n) for store in (JConfigStore(), ConfigStore())
             for g, n in (("ofasys.task", "default"), ("ofasys.model", "unify"))]
    saved = [(node._config, node.active) for node in nodes]
    for node in nodes:
        node._config, node.active = None, False
    yield
    for node, (config, active) in zip(nodes, saved):
        node._config, node.active = config, active


def test_task_and_model_groups_serialize_like_ofasys_tpu(task_and_model_nodes):
    states = []
    for store in (JConfigStore(), ConfigStore()):
        store.override("ofasys.task.default.instruction.template", "[TEXT:src] -> [TEXT:tgt]")
        store.override("ofasys.task.default.dataset.batch_size", "16")
        store.override("ofasys.task.default.evaluation.metrics", "bleu,rouge")
        store.override("ofasys.model.unify.dropout", "0.2")
        store.override("ofasys.model.unify.encoder.layers", "3")
        store.set_active("ofasys.task", "default")
        store.set_active("ofasys.model", "unify")
        state = store.state_dict(groups=["ofasys.task", "ofasys.model"])
        states.append(json.loads(json.dumps({g: {n: c for n, c in by.items()
                                                 if (g, n) in (("ofasys.task", "default"),
                                                               ("ofasys.model", "unify"))}
                                             for g, by in state.items()})))
        store.get("ofasys.task", "default")._config = None
        store.get("ofasys.model", "unify")._config = None
    assert states[0] == states[1]
    assert states[1]["ofasys.task"]["default"]["evaluation"]["metrics"] == ["bleu", "rouge"]
    # a reload activates the nodes with the saved configs
    ConfigStore().load_state_dict(states[1])
    assert ConfigStore().get("ofasys.model", "unify").config.encoder.layers == 3
    assert ConfigStore().get("ofasys.task", "default").active


def test_to_dict_from_dict_round_trips(tmp_path):
    for cls, jcls in ((TrainerConfig, JTrainerConfig), (GeneralistModelConfig, None)):
        cfg = cls()
        if cls is TrainerConfig:
            cfg.optimization.lr = (3e-4,)
            cfg.optimization.adam_betas = (0.9, 0.98)
            cfg.checkpoint.finetune_from_model = "x/checkpoint_last"
            cfg.parallel.remat = "full"
        else:
            cfg.apply_arch("base") if hasattr(cfg, "apply_arch") else None
            cfg.dropout, cfg.encoder.layers, cfg.attn_kernel = 0.3, 5, "pallas"
        d = tcs.to_dict(cfg)
        back = tcs.from_dict(cls, json.loads(json.dumps(d)))
        assert back == cfg
        assert isinstance(back.optimization.lr, tuple) if cls is TrainerConfig else True
        if jcls is not None:
            # ofasys_tpu reads the port's serialized tree, and back
            jd = jcs.to_dict(jcs.from_dict(jcls, d))
            jd["common"]["profile_dir"] = d["common"]["profile_dir"]
            assert jd == d
    # from_yaml reads a config file through the launcher, as ofasys_tpu's does
    path = tmp_path / "train.yaml"
    path.write_text("trainer:\n  optimization: {lr: [3.0e-4], max_update: 7}\n  common: {seed: 5}\n")
    got, want = TrainerConfig.from_yaml(str(path)), JTrainerConfig.from_yaml(str(path))
    assert got.optimization.lr == (3e-4,) and got.optimization.max_update == 7
    assert tcs.to_dict(got)["optimization"] == jcs.to_dict(want)["optimization"]


def _collate(gp, cls, tpl, recs, split):
    return gp.collate([gp(cls(tpl, split=split).format(**r)) for r in recs])


def test_store_override_moves_both_packages_batches_alike():
    """max_src_length through the store truncates both sides' sources."""
    recs = [{"src": "a fairly long source sentence " * 4, "tgt": "short"} for _ in range(3)]
    tpl = "[TEXT:src] -> [TEXT:tgt]"
    out = {}
    for store, dcls, gcls, icls in ((JConfigStore(), JDictionary, JGeneralPreprocess, JInstruction),
                                    (ConfigStore(), Dictionary, GeneralPreprocess, Instruction)):
        cfg = store.get("ofasys.preprocess", "text").config
        saved = cfg.max_src_length
        try:
            default = _collate(gcls(dcls(), active=["text"]), icls, tpl, recs, "test")
            store.override("ofasys.preprocess.text.max_src_length", "24")
            short = _collate(gcls(dcls(), active=["text"]), icls, tpl, recs, "test")
        finally:
            cfg.max_src_length = saved
        out[gcls] = [np.asarray(s["net_input"]["slots"][0].value["inputs"]) for s in (default, short)]
    (jd, js), (td, ts) = out.values()
    np.testing.assert_array_equal(jd, td)
    np.testing.assert_array_equal(js, ts)
    assert ts.shape[1] < td.shape[1]


REFCOCO = ('[IMAGE:img] which region does the text " [TEXT:text] " describe? '
           '-> [BOX:region_coord]')


def test_box_crop_size_follows_the_store():
    """The refcoco train sample's joint transforms crop to the image
    preprocess's patch_image_size as the store holds it (ofasys_tpu reads
    its store; the port did the class default before)."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (150, 200, 3)).astype(np.float32)
    rec = {"img": img, "text": "the dog on the left",
           "region_coord": {"box": [20.0, 30.0, 120.0, 110.0], "width": 200.0, "height": 150.0}}
    sides = []
    for store, dcls, gcls, icls in ((JConfigStore(), JDictionary, JGeneralPreprocess, JInstruction),
                                    (ConfigStore(), Dictionary, GeneralPreprocess, Instruction)):
        cfg = store.get("ofasys.preprocess", "image").config
        saved = cfg.patch_image_size
        np.random.seed(3)
        try:
            store.override("ofasys.preprocess.image.patch_image_size", "96")
            gp = gcls(dcls(), active=["text", "image", "box"])
            sample = _collate(gp, icls, REFCOCO, [rec], "train")
        finally:
            cfg.patch_image_size = saved
        sides.append(sample)
    js, ts = sides
    for a, b in zip(js["net_input"]["slots"], ts["net_input"]["slots"], strict=True):
        for k, v in a.value.items():
            if v is not None:
                np.testing.assert_allclose(np.asarray(v), np.asarray(b.value[k]), atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(np.asarray(js["target"]), np.asarray(ts["target"]))
    assert ts["net_input"]["slots"][0].value["inputs"].shape[1:3] == (96, 96)
