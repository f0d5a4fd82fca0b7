"""ofasys_torch's Trainer against ofasys_tpu's, from the same files and the
same initial weights.

Tiny arch (2+2 layers, E=64, FFN 256, 4 heads), fp32 on both sides, dropout
0, every task's dataset read without the prefetch thread (ofasys_tpu's peek
leaves its prefetch thread running, which then races the real iterator for
the template and span-masking draws). ofasys_tpu's mesh is one CPU device.
Both trainers start from ofasys_tpu's ``setup`` weights: an orbax
checkpoint of them, converted to the port's format by ``orbax_to_torch``,
goes into ``finetune_from_model`` on both sides.

Tolerances (those of tests/test_torch_train_step.py): per-update losses,
nll losses, sample sizes and gnorm rtol 1e-4; parameters after N updates
within 2·N·lr of each other (Adam's m/sqrt(v) turns a rounding difference
in a near-zero gradient into a step of up to lr). The port against itself
(resume) is bit for bit, with one CPU thread.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Task as JTask
from ofasys_tpu.configure import ConfigStore as JConfigStore, TrainerConfig as JTrainerConfig
from ofasys_tpu.engine import trainer as jtrainer_mod
from ofasys_tpu.engine.trainer import Trainer as JTrainer
from ofasys_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ofasys_tpu.utils import checkpoint_utils as jcu
from ofasys_torch import GeneralistModel, Task, Trainer, TrainerConfig
from ofasys_torch.configure import ParallelConfig
from ofasys_torch.utils import checkpoint_utils as tcu
from ofasys_torch.utils.jax_params import export_params

INFILL = 'what is the complete text of " [TEXT:text,mask_ratio=0.3] "? -> [TEXT:text]'
SUMMARY = 'what is the summary of article " [TEXT:src] "? -> [TEXT:tgt]'
LOSS_RTOL = 1e-4
LR = 1e-3
N_UPDATES = 5
WORDS = ["the", "model", "learns", "to", "fill", "in", "masked", "spans", "of", "text", "and",
         "summarize", "a", "short", "article", "about", "weather", "storm", "north", "coast"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Bit-for-bit resume needs one intra-op thread (the CPU's multithreaded
    reductions are not run to run reproducible); tiny shapes gain nothing
    from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _one_jax_device(monkeypatch):
    """ofasys_tpu's trainer on one CPU device (the test session has eight)."""
    monkeypatch.setattr(jtrainer_mod, "build_mesh",
                        lambda cfg: jbuild_mesh(cfg, devices=jax.devices()[:1]))


def _words(rng, n):
    return " ".join(rng.choice(WORDS, n))


def write_data(root, n_rows=16, seed=0):
    """infill.tsv (text) and summary.tsv (src, tgt) of ``n_rows`` rows."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "infill.tsv"), "w") as f:
        for _ in range(n_rows):
            f.write(_words(rng, int(rng.integers(6, 10))) + "\n")
    with open(os.path.join(root, "summary.tsv"), "w") as f:
        for _ in range(n_rows):
            f.write(f"{_words(rng, int(rng.integers(10, 16)))}\t{_words(rng, int(rng.integers(3, 6)))}\n")
    return root


def make_tasks(torch_side, root, which=("infill", "summary"), batch=8):
    cls = Task if torch_side else JTask
    specs = {"infill": (INFILL, "0:text"), "summary": (SUMMARY, "0:src,1:tgt")}
    tasks = []
    for name in which:
        tpl, cols = specs[name]
        t = cls(name=name, instruction=tpl)
        t.cfg.dataset.batch_size = batch
        t.cfg.dataset.selected_cols = cols
        t.cfg.dataset.num_workers = 0
        tasks.append(t.load_dataset_from_path(os.path.join(root, f"{name}.tsv")))
    return tasks


def make_model(torch_side):
    m = (GeneralistModel if torch_side else JModel)(arch="tiny")
    c = m.cfg
    for stack in (c.encoder, c.decoder):
        stack.embed_dim, stack.ffn_embed_dim, stack.attention_heads, stack.layers = 64, 256, 4, 2
    c.dropout = 0.0
    return m


def make_cfg(torch_side, save_dir, **ck):
    cfg = (TrainerConfig if torch_side else JTrainerConfig)()
    cfg.common.dtype = "float32"
    cfg.optimization.lr = (LR,)
    cfg.checkpoint.save_dir = str(save_dir)
    cfg.checkpoint.no_epoch_checkpoints = True
    for k, v in ck.items():
        setattr(cfg.checkpoint, k, v)
    return cfg


def _to_float(tree):
    if isinstance(tree, dict):
        return {k: _to_float(v) for k, v in tree.items()}
    return float(np.asarray(tree))


def recording(base):
    """A Trainer class that keeps every update's metrics (as floats)."""

    class Recording(base):
        def _log_metrics(self, task_name, metrics, ntokens, nsentences=0):
            self.__dict__.setdefault("log", []).append((task_name, metrics))
            super()._log_metrics(task_name, metrics, ntokens, nsentences)

        def history(self):
            return [(n, _to_float(m)) for n, m in self.log]

    return Recording


def orbax_to_torch(src, dst_dir, name):
    """Convert an ofasys_tpu orbax checkpoint (and its sidecar) to the
    port's format: params, EMA, step, and adam's count/mu/nu when the
    optimizer state holds them."""
    state, meta = jcu.load_checkpoint(src)
    out = {"step": int(np.asarray(state["step"])),
           "params": _tensors(state["params"])}
    if state.get("ema_params") is not None:
        out["ema_params"] = _tensors(state["ema_params"])
    adam = _find_adam(state.get("opt_state"))
    if adam is not None:
        out["opt_state"] = {"count": int(np.asarray(adam["count"])),
                            "mu": _tensors(adam["mu"]), "nu": _tensors(adam["nu"])}
    tcu.save_checkpoint(dst_dir, name, out, meta, mirror_last=False)
    return os.path.join(dst_dir, name)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _find_adam(tree):
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for v in tree.values():
            found = _find_adam(v)
            if found is not None:
                return found
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            found = _find_adam(v)
            if found is not None:
                return found
    return None


def make_init(root, ema=False):
    """ofasys_tpu's setup weights (with the EMA shadow when ``ema``) as an
    orbax checkpoint and as the port's, and the data files, under ``root``."""
    os.environ["OFA_CACHE_HOME"] = str(root / "cache")
    data = write_data(str(root / "data"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer_mod, "build_mesh", lambda cfg: jbuild_mesh(cfg, devices=jax.devices()[:1]))
        cfg = make_cfg(False, root / "jinit", async_save=False)
        cfg.ema.store_ema = ema
        jtr = JTrainer(cfg)
        jtr.setup(make_model(False), make_tasks(False, data), max_update=N_UPDATES)
        jtr.save_checkpoint("init", 0)
    jcu.wait_for_async_saves()
    JConfigStore().reset()
    orbax = str(root / "jinit" / "init")
    return dict(root=root, data=data, orbax=orbax,
                torch=orbax_to_torch(orbax, str(root / "tinit"), "init"))


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    return make_init(tmp_path_factory.mktemp("trainer"))


def run(torch_side, init, save_dir, which=("infill", "summary"), max_update=N_UPDATES, **ck):
    """One fit from the shared initial weights; returns the trainer."""
    ck.setdefault("finetune_from_model", init["torch"] if torch_side else init["orbax"])
    cfg = make_cfg(torch_side, save_dir, **ck)
    tr = recording(Trainer if torch_side else JTrainer)(cfg, **({"device": "cpu"} if torch_side else {}))
    tr.fit(make_model(torch_side), make_tasks(torch_side, init["data"], which), max_update=max_update)
    if not torch_side:
        jcu.wait_for_async_saves()
        JConfigStore().reset()
    return tr


@pytest.fixture(scope="module")
def fits(init):
    """The single-task and the two-task summed fits on both sides."""
    root = init["root"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer_mod, "build_mesh", lambda cfg: jbuild_mesh(cfg, devices=jax.devices()[:1]))
        # the single-task fits save every update and keep the last 2
        for mode, which, ck in (("single", ("summary",), dict(save_interval_updates=1,
                                                              keep_interval_updates=2)),
                                ("summed", ("infill", "summary"), {})):
            out[mode] = (run(False, init, root / f"j_{mode}", which, **ck),
                         run(True, init, root / f"t_{mode}", which, **ck))
    return out


@pytest.mark.parametrize("mode", ["single", "summed"])
def test_fit_matches_ofasys_tpu(fits, mode):
    jtr, ttr = fits[mode]
    jh, th = jtr.history(), ttr.history()
    assert [n for n, _ in jh] == [n for n, _ in th]
    updates = 0
    for (name, jm), (_, tm) in zip(jh, th):
        keys = ("loss", "nll_loss", "sample_size") if name is not None else ()
        if name is not None and mode == "single":
            keys += ("gnorm",)
        if name is None:
            keys = ("gnorm",)
            updates += 1
        for k in keys:
            np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, err_msg=f"{name} {k}")
    assert updates == (N_UPDATES if mode == "summed" else 0)
    assert int(ttr.state.step) == int(jtr.state.step) == N_UPDATES
    tparams = export_params(ttr.model.net)
    jparams = jax.device_get(jtr.state.params)
    flat_t = jax.tree_util.tree_leaves_with_path(tparams)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jparams))
    assert len(flat_t) == len(flat_j)
    for path, a in flat_t:
        err = np.abs(a - np.asarray(flat_j[path])).max()
        assert err <= 2 * N_UPDATES * LR, (jax.tree_util.keystr(path), err)
    assert set(ttr.meters.keys()) == set(jtr.meters.keys())


def test_resume_3_plus_2_equals_5_bit_for_bit(init):
    """Two tasks with span masking, 2 batches an epoch: the resumed run
    crosses an epoch boundary and re-draws its masks from the checkpointed
    random state."""
    root = init["root"]
    straight = run(True, init, root / "r_straight", save_interval_updates=3)
    resumed = run(True, init, root / "r_resumed",
                  restore_file=str(root / "r_straight" / "checkpoint_1_3"))
    a, meta_a = tcu.load_checkpoint(str(root / "r_straight" / "checkpoint_last"))
    b, meta_b = tcu.load_checkpoint(str(root / "r_resumed" / "checkpoint_last"))
    assert a.keys() == b.keys() == {"step", "params", "opt_state"}
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert meta_a["iterator_states"] == meta_b["iterator_states"]
    # updates 4 and 5: each task's metrics and the update's gnorm and lr
    assert len(resumed.history()) == 2 * 3
    assert resumed.history() == straight.history()[-6:]


def test_patience_early_stop_and_best_checkpoint(init, tmp_path):
    """lr 0: the valid loss never improves; the first validation (update
    2) saves checkpoint_best, patience 2 stops at update 6, where
    ofasys_tpu's own test (tests/test_trainer_fit.py) stops."""
    tasks = make_tasks(True, init["data"], ("summary",))
    tasks[0].add_dataset([{"src": "the storm moved north", "tgt": "storm"}] * 8, "valid")
    cfg = make_cfg(True, tmp_path, finetune_from_model=init["torch"], patience=2)
    cfg.optimization.lr = (0.0,)
    cfg.dataset.validate_interval_updates = 2
    cfg.dataset.max_valid_batches = 1
    tr = Trainer(cfg, device="cpu")
    state = tr.fit(make_model(True), tasks, max_update=40)
    assert int(state.step) == 6
    assert os.path.exists(tmp_path / "checkpoint_best")
    assert tcu.read_meta(str(tmp_path / "checkpoint_best"))["num_updates"] == 2
    assert tr.meters["valid:summary:loss"].count == 3


def test_keep_interval_updates_prunes_like_ofasys_tpu(fits):
    """save_interval_updates=1, keep_interval_updates=2 over 5 updates: the
    same file names on both sides (orbax's checkpoint is a directory, the
    port's a file)."""
    names = [{n for n in os.listdir(tr.cfg.checkpoint.save_dir) if n.startswith("checkpoint")}
             for tr in fits["single"]]
    assert names[0] == names[1]
    assert names[1] == {"checkpoint_1_4", "checkpoint_1_4.meta.json", "checkpoint_1_5",
                        "checkpoint_1_5.meta.json", "checkpoint_last", "checkpoint_last.meta.json"}


def test_remap_vocab_rows_matches_ofasys_tpu():
    from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
    from ofasys_torch.preprocessor.dictionary import Dictionary

    rng = np.random.default_rng(3)
    old = [f"w{i}" for i in range(12)]
    tree = {"params": {"embed_tokens": {"embedding": rng.standard_normal((12, 6)).astype(np.float32)},
                       "other": {"kernel": rng.standard_normal((6, 6)).astype(np.float32)}},
            "opt_state": {"mu": {"embed_tokens": {"embedding": rng.standard_normal((12, 6)).astype(
                np.float32)}}}}
    outs = []
    for cls, fn in ((JDictionary, jcu.remap_vocab_rows), (Dictionary, tcu.remap_vocab_rows)):
        d = cls()
        for s in ["w3", "new0", "w1", "w11", "new1", "w0"]:
            d.add_symbol(s)
        outs.append(fn(copy.deepcopy(tree), old, d, seed=5))
    for a, b in zip(jax.tree_util.tree_leaves(outs[0]), jax.tree_util.tree_leaves(outs[1])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(tcu.resize_vocab_rows(tree, 20)["params"]["embed_tokens"][
        "embedding"]), np.asarray(jcu.resize_vocab_rows(tree, 20)["params"]["embed_tokens"]["embedding"]))


def test_reset_optimizer_and_params_only_resume(init, tmp_path):
    """A params-only checkpoint (no_save_optimizer_state) resumes at its
    update with the step and the optimizer fresh, as ofasys_tpu's
    _maybe_restore does; reset_optimizer restores the weights and starts
    the update count, the step and the optimizer from zero."""
    run(True, init, tmp_path, ("summary",), max_update=3, no_save_optimizer_state=True)
    saved, meta = tcu.load_checkpoint(str(tmp_path / "checkpoint_last"))
    assert set(saved) == {"step", "params"} and meta["no_optimizer_state"]
    for ck, start_update in ((dict(no_save_optimizer_state=True), 3), (dict(reset_optimizer=True), 0)):
        tr = Trainer(make_cfg(True, tmp_path, **ck), device="cpu")
        start = tr.setup(make_model(True), make_tasks(True, init["data"], ("summary",)), max_update=5)
        tr.close()
        assert start == start_update and tr.state.step == 0 and tr.state.opt_state["count"] == 0
        np.testing.assert_array_equal(export_params(tr.model.net)["embed_tokens"]["embedding"],
                                      saved["params"]["embed_tokens"]["embedding"].numpy())


@pytest.mark.parametrize("parallel", [dict(data=8), dict(fsdp=2), dict(tensor=2), dict(pipeline=2),
                                      dict(sequence=2), dict(expert=2), dict(zero1=True)])
def test_multi_device_parallel_config_raises(parallel):
    """In a world of one, a mesh whose axes do not multiply to one rank
    raises the ValueError of ``resolve_axis_sizes`` (ofasys_tpu's
    parallel/mesh.py:38-50); ``zero1`` alone is accepted (it shards the
    optimizer state only when data > 1, as in ofasys_tpu)."""
    from ofasys_tpu.parallel.mesh import resolve_axis_sizes as jresolve
    from ofasys_tpu.configure.configs import ParallelConfig as JParallelConfig

    cfg = TrainerConfig()
    cfg.parallel = ParallelConfig(**parallel)
    if parallel == {"zero1": True}:
        assert Trainer(cfg, device="cpu").mesh.world == 1
        return
    with pytest.raises(ValueError) as jerr:
        jresolve(JParallelConfig(**parallel), 1)
    with pytest.raises(ValueError) as err:
        Trainer(cfg, device="cpu")
    assert str(err.value) == str(jerr.value)


def test_profile_and_remat_raise(init, tmp_path):
    """``common.profile`` builds a trainer (its trace: tests/test_torch_tools.py);
    a fit under ``parallel.remat='full'`` sets the model's remat mode and
    runs its update."""
    cfg = TrainerConfig()
    cfg.common.profile = True
    assert Trainer(cfg, device="cpu").cfg.common.profile
    cfg = make_cfg(True, tmp_path, finetune_from_model=init["torch"], no_save=True)
    cfg.parallel.remat = "full"
    tr = Trainer(cfg, device="cpu")
    model = make_model(True)
    tr.fit(model, make_tasks(True, init["data"], ("summary",)), max_update=1)
    assert model.cfg.remat == "full" and tr.state.step == 1
    assert all(torch.isfinite(p).all() for p in tr.state.params)
