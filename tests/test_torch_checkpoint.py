"""ofasys_torch's checkpoints (utils/checkpoint_utils.py) and
OFASys.from_pretrained against ofasys_tpu's.

One run on each side (tests/test_torch_trainer.py's tiny arch, files and
shared initial weights): 4 single-task updates with the EMA (decay 0.9), a
checkpoint every 2 updates. The sidecars must agree; ofasys_tpu's orbax
checkpoints, converted by ``orbax_to_torch``, restore into the port's
trainer and serve through the port's from_pretrained with ofasys_tpu's
tokens (fp32; one checkpoint, a list of two as an ensemble, the EMA
weights).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import OFASys as JOFASys
from ofasys_tpu.engine import trainer as jtrainer_mod
from ofasys_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ofasys_tpu.utils import checkpoint_utils as jcu
from ofasys_torch import GeneralistModel, OFASys, Trainer
from ofasys_torch.engine.optim import build_optimizer
from ofasys_torch.engine.train_step import TrainState
from ofasys_torch.configure import OptimizationConfig
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.utils import checkpoint_utils as tcu
from ofasys_torch.utils.jax_params import export_params

from test_torch_trainer import (  # noqa: F401  (fixture)
    LOSS_RTOL, LR, _one_torch_thread, make_cfg, make_init, make_model, make_tasks, orbax_to_torch,
    recording,
)

TPL = "[TEXT:src] -> [TEXT:tgt]"
N = 4
EMA = dict(store_ema=True, ema_decay=0.9)


def _fit(torch_side, init, save_dir, max_update=N, **ck):
    cfg = make_cfg(torch_side, save_dir, save_interval_updates=2, **ck)
    cfg.ema.store_ema, cfg.ema.ema_decay = EMA["store_ema"], EMA["ema_decay"]
    if "restore_file" not in ck:
        cfg.checkpoint.finetune_from_model = init["torch"] if torch_side else init["orbax"]
    tr = recording(Trainer if torch_side else jtrainer_mod.Trainer)(
        cfg, **({"device": "cpu"} if torch_side else {}))
    tr.fit(make_model(torch_side), make_tasks(torch_side, init["data"], ("summary",)),
           max_update=max_update)
    if not torch_side:
        from ofasys_tpu.configure import ConfigStore

        jcu.wait_for_async_saves()
        ConfigStore().reset()
    return tr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer_mod, "build_mesh", lambda cfg: jbuild_mesh(cfg, devices=jax.devices()[:1]))
        init = make_init(root, ema=True)
        jtr = _fit(False, init, root / "j")
        ttr = _fit(True, init, root / "t")
    conv = {n: orbax_to_torch(str(root / "j" / n), str(root / "conv"), n)
            for n in ("checkpoint_1_2", "checkpoint_1_4")}
    return dict(root=root, init=init, jtr=jtr, ttr=ttr, conv=conv)


def test_sidecar_matches_ofasys_tpu(runs):
    root = runs["root"]
    with open(root / "j" / "checkpoint_last.meta.json") as f:
        jm = json.load(f)
    tm = tcu.read_meta(str(root / "t" / "checkpoint_last"))
    assert set(jm) == set(tm)
    for k in ("num_updates", "configstore", "global_dict", "model_cfg", "active_adaptors"):
        assert jm[k] == tm[k], k
    # the cfg field only one side has (the profiler's directory), and the
    # paths of the two runs (their save_dirs and the same initial weights
    # in each package's format)
    for m in (jm, tm):
        m["cfg"]["common"].pop("profile_dir")
        m["cfg"]["checkpoint"].pop("finetune_from_model")
        m["cfg"]["checkpoint"].pop("save_dir")
    assert jm["cfg"] == tm["cfg"]
    # the port's iterator states also hold the data's random state
    assert {n: {k: s[k] for k in ("epoch", "iterations_in_epoch")}
            for n, s in tm["iterator_states"].items()} == jm["iterator_states"]
    assert set(jm["meters"]) == set(tm["meters"])
    for k, (cls, s) in jm["meters"].items():
        assert tm["meters"][k][0] == cls
        if cls == "AverageMeter" and k not in ("train_wall", "gb_free"):
            assert tm["meters"][k][1]["count"] == s["count"]
            np.testing.assert_allclose(tm["meters"][k][1]["sum"], s["sum"], rtol=LOSS_RTOL)
    assert sorted(os.listdir(root / "j")) == sorted(os.listdir(root / "t"))


def test_orbax_to_torch_converter(runs):
    """The converted checkpoint holds ofasys_tpu's params, EMA, step and
    adam moments exactly; the port's trainer resumes from it (update 2)
    and its updates 3-4 follow ofasys_tpu's."""
    root, init = runs["root"], runs["init"]
    jstate, _ = jcu.load_checkpoint(str(root / "j" / "checkpoint_1_2"))
    conv, meta = tcu.load_checkpoint(runs["conv"]["checkpoint_1_2"])
    assert conv["step"] == 2 and conv["opt_state"]["count"] == 2 and meta["num_updates"] == 2
    for key, tree in (("params", jstate["params"]), ("ema_params", jstate["ema_params"])):
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                                jax.tree_util.tree_leaves(conv[key])):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=jax.tree_util.keystr(path))
    ttr = _fit(True, init, root / "resumed", restore_file=runs["conv"]["checkpoint_1_2"])
    jh, th = runs["jtr"].history(), ttr.history()
    assert len(th) == 2 and [n for n, _ in jh[2:]] == [n for n, _ in th]
    for (_, jm), (_, tm) in zip(jh[2:], th):
        for k in ("loss", "nll_loss", "sample_size", "gnorm"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    jp = jax.device_get(runs["jtr"].state.params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(export_params(ttr.model.net)),
                            jax.tree_util.tree_leaves(jp)):
        assert np.abs(a - np.asarray(b)).max() <= 2 * N * LR, jax.tree_util.keystr(path)


def _state(seed=0):
    d = Dictionary()
    for i in range(40):
        d.add_symbol(f"w{i}")
    m = make_model(True)
    m.initialize(d, device="cpu", dtype=torch.float32, seed=seed)
    opt = build_optimizer(OptimizationConfig(lr=(LR,)))
    state = TrainState.create(m.net, opt, ema=True)
    with torch.no_grad():
        for i, (mu, nu) in enumerate(zip(state.opt_state["mu"], state.opt_state["nu"])):
            mu.normal_(generator=torch.Generator().manual_seed(i))
            nu.uniform_(generator=torch.Generator().manual_seed(100 + i))
    state.opt_state["count"], state.step = 7, 7
    return m, state


@pytest.mark.parametrize("async_save", [False, True])
def test_save_load_round_trip(tmp_path, async_save):
    m, state = _state()
    tree = tcu.train_state_dict(m.net, state)
    before = [p.clone() for p in state.params]
    tcu.save_checkpoint(str(tmp_path), "checkpoint_1_7", tree, {"num_updates": 7},
                        async_save=async_save)
    if async_save:
        # the host copy was taken before save_checkpoint returned
        with torch.no_grad():
            for p in state.params:
                p.add_(1.0)
        tcu.wait_for_async_saves()
    assert os.path.islink(tmp_path / "checkpoint_last")
    assert tcu.latest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint_last")
    assert tcu.read_meta(str(tmp_path / "checkpoint_last")) == {"num_updates": 7}
    loaded, meta = tcu.load_checkpoint(str(tmp_path / "checkpoint_last"))
    m2, fresh = _state(seed=1)
    fresh.opt_state["count"] = fresh.step = 0
    tcu.load_train_state(m2.net, fresh, loaded)
    assert fresh.step == 7 and fresh.opt_state["count"] == 7
    for a, b in zip(before, fresh.params):
        assert torch.equal(a, b)
    for k in ("mu", "nu"):
        for a, b in zip(state.opt_state[k], fresh.opt_state[k]):
            assert torch.equal(a, b)
    for a, b in zip(state.ema_params, fresh.ema_params):
        assert torch.equal(a, b)
    ema, _ = tcu.load_ema_from_checkpoint(str(tmp_path / "checkpoint_last"))
    assert set(ema) == set(loaded["params"])


def test_missing_sidecar_or_ema_raises(tmp_path, runs):
    m, state = _state()
    tree = tcu.train_state_dict(m.net, state)
    del tree["ema_params"]
    tcu.save_checkpoint(str(tmp_path), "bare", tree)
    with pytest.raises(ValueError, match="sidecar"):
        OFASys.from_pretrained(str(tmp_path / "bare"), device="cpu")
    with pytest.raises(ValueError, match="EMA"):
        tcu.load_ema_from_checkpoint(str(tmp_path / "bare"))
    root = runs["root"]
    with pytest.raises(RuntimeError, match="CUDA"):
        OFASys.from_pretrained(str(root / "t" / "checkpoint_last"))


def test_prune_and_upgrade_match_ofasys_tpu():
    tree = {"encoder": {"layers_0": {"fc1": {"kernel": 1}, "fc2": {"kernel": 2}}, "ln": {"scale": 3}},
            "decoder": {"layers_0": {"fc1": {"kernel": 4}}}}
    for kw in (dict(drop=["fc2"]), dict(keep=["fc1"]), dict(drop=["decoder"], keep=["scale"])):
        assert tcu.prune_state_dict(tree, **kw) == jcu.prune_state_dict(tree, **kw)
    meta = {"dictionary": {"symbols": ["a"]}, "iterator_states": [{"epoch": 2}]}
    assert tcu.upgrade_state_meta(json.loads(json.dumps(meta))) == \
        jcu.upgrade_state_meta(json.loads(json.dumps(meta)))


RECS = [{"src": "the storm moved north over the coast"}, {"src": "a short article about weather"},
        {"src": "fill in masked spans of text"}]


@pytest.mark.parametrize("kind", ["single", "ensemble", "ema"])
def test_from_pretrained_matches_ofasys_tpu(runs, kind):
    root, conv = runs["root"], runs["conv"]
    j_paths = {"single": str(root / "j" / "checkpoint_1_4"),
               "ensemble": [str(root / "j" / "checkpoint_1_4"), str(root / "j" / "checkpoint_1_2")],
               "ema": str(root / "j" / "checkpoint_1_4")}[kind]
    t_paths = {"single": conv["checkpoint_1_4"],
               "ensemble": [conv["checkpoint_1_4"], conv["checkpoint_1_2"]],
               "ema": conv["checkpoint_1_4"]}[kind]
    jhub = JOFASys.from_pretrained(j_paths, dtype=jnp.float32, use_ema=kind == "ema")
    thub = OFASys.from_pretrained(t_paths, device="cpu", dtype=torch.float32, use_ema=kind == "ema")
    assert (thub._ensemble is not None) == (kind == "ensemble")
    kw = dict(beam_size=3, max_len_b=6)
    jout = jhub.inference(TPL, RECS, **kw)
    tout = thub.inference(TPL, RECS, **kw)
    for a, b in zip(jout, tout, strict=True):
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
    if kind != "ensemble":
        # the port's own checkpoint of the same run serves the same way
        own = OFASys.from_pretrained(str(root / "t" / "checkpoint_1_4"), device="cpu",
                                     dtype=torch.float32, use_ema=kind == "ema")
        assert isinstance(own.model, GeneralistModel)
