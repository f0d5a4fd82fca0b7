"""ofasys_torch's launcher (launch.py, configure/options.py, cli/) against
ofasys_tpu's.

- ``load_yaml_config`` with ``_include`` and ``${var}``, ``apply_overrides``,
  ``parse_flags`` and ``build_from_config`` give the same dicts and configs;
  ``TrainerConfig.from_yaml`` the same config.
- ``--set`` values and flag values resolve to ofasys_tpu's on a table of
  scalars (``1e-4`` a string, ``1.0e-4`` a float, ``yes`` True, ``~`` None,
  ``0o17`` a string, ``017`` 15, ...).
- Two updates through ``launch.main`` on one JSON config (summary task,
  tiny arch 2+2 layers E=64, fp32, from the port's seeded weights) equal
  two through ofasys_tpu's ``launch.main``: per-update losses rtol 1e-4,
  parameters within lr/10 (a tenth of one Adam step);
  ``cli.evaluate`` on ofasys_tpu's launched checkpoint prints the same
  metrics as ofasys_tpu's ``cli.evaluate``.
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from ofasys_tpu import launch as jlaunch
from ofasys_tpu.cli import evaluate as jevaluate
from ofasys_tpu.configure import ConfigStore as JConfigStore, TrainerConfig as JTrainerConfig
from ofasys_tpu.configure import to_dict as jto_dict
from ofasys_tpu.configure.options import parse_flags as jparse_flags
from ofasys_tpu.engine import trainer as jtrainer_mod
from ofasys_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ofasys_tpu.utils import checkpoint_utils as jcu
from ofasys_torch import TrainerConfig, launch
from ofasys_torch.cli import evaluate as tevaluate, train as ttrain
from ofasys_torch.configure import to_dict
from ofasys_torch.configure.options import parse_flags
from ofasys_torch.utils import checkpoint_utils as tcu
from ofasys_torch.utils.jax_params import export_params
from test_torch_trainer import LR, SUMMARY, _one_torch_thread, orbax_to_torch, write_data  # noqa: F401

N = 2
LOSS_RTOL = 1e-4
PARAM_ATOL = LR / 10    # an Adam step moves a parameter by up to about lr: a tenth of one step
SCALARS = ["1e-4", "1.0e-4", "1.5E10", "1.5e+10", "yes", "No", "on", "OFF", "~", "null", "", "0o17",
           "017", "0x1f", "0b11", "1_000", "3.", "-.5", ".inf", "-.INF", "1:30", "190:20:30.15",
           "2002-12-14", "True", "y", "+12", "-0", "08", "abc", "'yes'", '"1e-4"', "[0.0001]", "[]",
           "[1e-4, 2, yes]", "[a, [b, 'c d']]", " x ", "a b", "/tmp/x.tsv", "0:src,1:tgt",
           "[TEXT:src] -> [TEXT:tgt]"]


def _write_configs(root):
    """base.yaml and child.yaml (which includes it), with ${var}s from its
    env block and the environment."""
    os.makedirs(root, exist_ok=True)
    base = {"model": {"arch": "tiny", "dropout": 0.0},
            "trainer": {"optimization": {"lr": ["1.0e-4"], "max_update": 10},
                        "common": {"seed": 3, "log_interval": 5}},
            "tasks": {"summary": {"task": "gigaword",
                                  "dataset": {"train_data": "${DATA}/${USER_DIR}/train.tsv", "batch_size": 4}}}}
    child = {"_include": "base.yaml", "env": {"DATA": "/data"},
             "trainer": {"optimization": {"max_update": 20, "clip_norm": "1e-1"},
                         "checkpoint": {"save_dir": "${DATA}/ck"}},
             "tasks": {"summary": {"dataset": {"valid_data": "${DATA}/valid.tsv"},
                                   "criterion": {"name": "label_smoothed_cross_entropy",
                                                 "label_smoothing": 0.2}},
                       "glue": {"task": "glue", "subtask": "mnli"}}}
    with open(os.path.join(root, "base.yaml"), "w") as f:
        yaml.safe_dump(base, f)
    with open(os.path.join(root, "child.yaml"), "w") as f:
        f.write(yaml.safe_dump(child).replace("label_smoothing: 0.2", "label_smoothing: 2.0e-1"))
    return os.path.join(root, "child.yaml")


def test_load_yaml_config_and_overrides_match(tmp_path, monkeypatch):
    monkeypatch.setenv("USER_DIR", "u1")
    path = _write_configs(str(tmp_path))
    data, jdata = launch.load_yaml_config(path), jlaunch.load_yaml_config(path)
    assert data == jdata
    assert data["tasks"]["summary"]["dataset"]["train_data"] == "/data/u1/train.tsv"
    sets = ["trainer.optimization.lr=[1e-4]", "trainer.common.seed=7", "model.encoder.layers=2",
            "tasks.summary.dataset.batch_size=8", "trainer.checkpoint.no_save=yes"]
    assert launch.apply_overrides(data, sets) == jlaunch.apply_overrides(jdata, sets)


def test_build_from_config_matches(tmp_path, monkeypatch):
    monkeypatch.setenv("USER_DIR", "u1")
    path = _write_configs(str(tmp_path))
    trainer, model, tasks = launch.build_from_config(launch.load_yaml_config(path), device="cpu")
    jtrainer, jmodel, jtasks = jlaunch.build_from_config(jlaunch.load_yaml_config(path))
    jd, td = jto_dict(jtrainer.cfg), to_dict(trainer.cfg)
    jd["common"]["profile_dir"] = td["common"]["profile_dir"]
    assert td == jd
    assert trainer.device.type == "cpu"
    for k in ("dropout", "arch"):
        assert getattr(model.cfg, k) == getattr(jmodel.cfg, k)
    assert to_dict(model.cfg.encoder) == jto_dict(jmodel.cfg.encoder)
    for t, j in zip(tasks, jtasks, strict=True):
        assert type(t).__name__ == type(j).__name__
        assert to_dict(t.cfg) == jto_dict(j.cfg)
    assert TrainerConfig.from_yaml(path) == launch.build_from_config(
        launch.load_yaml_config(path), device="cpu")[0].cfg
    assert to_dict(TrainerConfig.from_yaml(path)) == {**jto_dict(JTrainerConfig.from_yaml(path)),
                                                     "common": td["common"]}


def test_parse_flags_matches():
    flags = ["--ofasys.task=caption,gigaword", "--ofasys.task.caption.dataset.batch_size=8",
             "--ofasys.model.arch=base", "--ofasys.optimization.lr=[0.0001]",
             "--ofasys.checkpoint.save_dir", "/tmp/ck", "--ofasys.task.gigaword.instruction.template",
             "[TEXT:src] -> [TEXT:tgt]", "--ofasys.common.fp16=yes", "--ofasys.dataset.max_tokens=1e4",
             "cfg.json", "--other"]
    assert parse_flags(flags) == jparse_flags(flags)


@pytest.mark.parametrize("text", SCALARS)
def test_set_values_match_ofasys_tpu(text):
    """A ``--set`` value and a ``--ofasys.`` flag value resolve to
    ofasys_tpu's, type for type (YAML 1.1: ``1e-4`` a string, ``yes`` True);
    a value pyyaml cannot parse raises at ``--set`` and stays the raw
    string as a flag, on both sides."""
    flag = [f"--ofasys.common.x={text}"]
    assert parse_flags(flag) == jparse_flags(flag)
    try:
        want = jlaunch.apply_overrides({}, [f"a.b={text}"])
    except yaml.YAMLError:
        with pytest.raises(yaml.YAMLError):
            launch.apply_overrides({}, [f"a.b={text}"])
        return
    got = launch.apply_overrides({}, [f"a.b={text}"])
    assert got == want and type(got["a"]["b"]) is type(want["a"]["b"])


def _launch_config(root, data, save_dir, init=None):
    """The config of one summary task on the trainer tests' data, N
    updates, from the ``init`` checkpoint when given."""
    valid = os.path.join(root, "valid.tsv")
    with open(os.path.join(data, "summary.tsv")) as src, open(valid, "w") as dst:
        dst.writelines(src.readlines()[:4])
    checkpoint = {"save_dir": str(save_dir), "no_epoch_checkpoints": True}
    if init:
        checkpoint["finetune_from_model"] = init
    return {
        "model": {"arch": "tiny", "dropout": 0.0,
                  "encoder": {"embed_dim": 64, "ffn_embed_dim": 256, "attention_heads": 4, "layers": 2},
                  "decoder": {"embed_dim": 64, "ffn_embed_dim": 256, "attention_heads": 4, "layers": 2}},
        "trainer": {"common": {"dtype": "float32", "log_interval": 1},
                    "optimization": {"lr": [LR], "max_update": N},
                    "checkpoint": checkpoint},
        "tasks": {"summary": {
            "task": "gigaword", "instruction": {"template": SUMMARY},
            "dataset": {"train_data": os.path.join(data, "summary.tsv"),
                        "valid_data": valid,
                        "batch_size": 8, "selected_cols": "0:src,1:tgt", "num_workers": 0},
            "generation": {"beam": 2, "max_len_b": 4}}},
    }


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """The trainer tests' data, and the port's seeded initial weights of the
    launched run (built by ``Trainer.init_model``) as a params-only
    checkpoint in each package's format."""
    root = tmp_path_factory.mktemp("launch")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OFA_CACHE_HOME", str(root / "cache"))
        data = write_data(str(root / "data"))
        trainer, model, tasks = launch.build_from_config(_launch_config(root, data, root / "unused"), "cpu")
        trainer.init_model(model, tasks)
        params = export_params(model.net)
        meta = {"no_optimizer_state": True, "num_updates": 0}
        jcu.save_checkpoint(str(root / "jinit"), "init", {"params": params, "step": np.asarray(0, np.int32)},
                            meta, mirror_last=False)
        tcu.save_checkpoint(str(root / "tinit"), "init",
                            {"params": jax.tree_util.tree_map(torch.from_numpy, params), "step": 0},
                            meta, mirror_last=False)
        yield dict(root=root, data=data, params=params, orbax=str(root / "jinit" / "init"),
                   torch=str(root / "tinit" / "init"))


def _meters(path, load):
    """The training meters of a checkpoint's sidecar (not the clocks)."""
    _, meta = load(path)
    return {k: v for k, (cls, v) in meta["meters"].items()
            if cls == "AverageMeter" and k not in ("train_wall", "gb_free", "wall")}


def test_two_updates_through_launch_main_match(init, tmp_path, monkeypatch):
    monkeypatch.setattr(jtrainer_mod, "build_mesh", lambda cfg: jbuild_mesh(cfg, devices=jax.devices()[:1]))
    paths = {}
    for side in ("j", "t"):
        cfg = _launch_config(tmp_path, init["data"], tmp_path / f"{side}_run",
                             init["torch"] if side == "t" else init["orbax"])
        paths[side] = tmp_path / f"{side}.json"
        paths[side].write_text(json.dumps(cfg))
    assert jlaunch.main([str(paths["j"])]) == 0
    jcu.wait_for_async_saves()
    JConfigStore().reset()
    assert launch.main([str(paths["t"]), "--device", "cpu"]) == 0
    jstate, _ = jcu.load_checkpoint(str(tmp_path / "j_run" / "checkpoint_last"))
    tstate, _ = tcu.load_checkpoint(str(tmp_path / "t_run" / "checkpoint_last"))
    assert int(np.asarray(jstate["step"])) == int(tstate["step"]) == N
    jflat = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(jstate["params"])))
    tflat = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), tstate["params"]))
    assert len(tflat) == len(jflat)
    iflat = dict(jax.tree_util.tree_leaves_with_path(init["params"]))
    moved = 0.0
    for path, a in tflat:
        assert np.abs(a - np.asarray(jflat[path])).max() <= PARAM_ATOL, jax.tree_util.keystr(path)
        moved = max(moved, float(np.abs(a - iflat[path]).max()))
    assert moved > LR / 2                  # the updates moved the weights
    jm = _meters(str(tmp_path / "j_run" / "checkpoint_last"), jcu.load_checkpoint)
    tm = _meters(str(tmp_path / "t_run" / "checkpoint_last"), tcu.load_checkpoint)
    assert set(tm) == set(jm) and "summary:loss" in tm, (sorted(tm), sorted(jm))
    for k in jm:
        assert tm[k]["count"] == jm[k]["count"], k
        np.testing.assert_allclose([tm[k]["val"], tm[k]["sum"]], [jm[k]["val"], jm[k]["sum"]],
                                   rtol=LOSS_RTOL, err_msg=k)

    # cli.evaluate on ofasys_tpu's checkpoint, converted: the same metrics
    ck = orbax_to_torch(str(tmp_path / "j_run" / "checkpoint_last"), str(tmp_path / "conv"), "ck")
    outs = []
    for mod, path, ckpt in ((jevaluate, paths["j"], str(tmp_path / "j_run" / "checkpoint_last")),
                            (tevaluate, paths["t"], ck)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main([str(path), "--ckpt", ckpt, "--split", "valid", "--device", "cpu",
                             "--set", "tasks.summary.evaluation.metrics=[rouge]"]) == 0
        outs.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
        JConfigStore().reset()
    assert outs[1] == outs[0] and set(outs[0]["summary"]) == {"rouge1", "rouge2", "rougeL"}

    # cli.train with flags: a --set style override reaches the TrainerConfig
    seen = {}
    monkeypatch.setattr("ofasys_torch.engine.trainer.Trainer.fit",
                        lambda self, model, tasks: seen.update(cfg=self.cfg, tasks=tasks))
    assert ttrain.main([str(paths["t"]), "--set", "trainer.optimization.max_update=7",
                        "--device", "cpu"]) == 0
    assert seen["cfg"].optimization.max_update == 7
    assert ttrain.main(["--ofasys.task=gigaword", "--ofasys.optimization.lr=[1.0e-4]",
                        "--device", "cpu"]) == 0
    assert seen["cfg"].optimization.lr == (1e-4,) and seen["tasks"][0].name == "gigaword"
