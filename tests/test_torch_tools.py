"""The trainer's tools in the port against ofasys_tpu's: nan_detector,
utils/profiler, draw, tools/ and ms_wrapper.

``check_tree`` gives the same flax paths as ofasys_tpu's on the same tree
(a tiny model's init with a planted NaN and Inf), whether the port reads
its net, a dict of its gradients or the flax tree itself. The tools write
byte-for-byte the same files. ``Trainer.fit`` under ``common.profile``
writes a Chrome trace with one range per update and gives the same meters,
losses and parameters as the same fit unprofiled (bit for bit: one CPU
thread, same seed).
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Instruction as JInstruction
from ofasys_tpu import draw as jdraw, ms_wrapper as jms
from ofasys_tpu.engine import nan_detector as jnan
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
from ofasys_tpu.tools import create_oss_list_objects as jlist
from ofasys_tpu.tools import create_tsv_cache as jtsv, preprocess_text as jprep
from ofasys_torch import GeneralistModel, Instruction, Trainer
from ofasys_torch import draw as tdraw, ms_wrapper as tms
from ofasys_torch.engine import nan_detector as tnan
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess
from ofasys_torch.tools import create_oss_list_objects as tlist
from ofasys_torch.tools import create_tsv_cache as ttsv, preprocess_text as tprep
from ofasys_torch.utils import profiler
from ofasys_torch.utils.jax_params import export_params, load_jax_params

from test_torch_trainer import make_cfg, make_model, make_tasks, recording, write_data

TPL = "[TEXT:src] -> [TEXT:tgt]"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def planted():
    """ofasys_tpu's tiny init (1+1 layers) with a NaN and an Inf planted,
    and the port's model carrying it."""
    jd, td = JDictionary(), Dictionary()
    jgp, tgp = JGeneralPreprocess(jd, active=["text"]), GeneralPreprocess(td, active=["text"])
    jm, tm = JModel(arch="tiny"), GeneralistModel(arch="tiny")
    for m in (jm, tm):
        m.cfg.encoder.layers = m.cfg.decoder.layers = 1
        m.cfg.dropout = 0.0
    jm.initialize(jd, active_adaptors=("text",), dtype=jnp.float32)
    tm.initialize(td, active_adaptors=("text",), dtype=torch.float32, device="cpu")
    slots = jgp.collate([jgp(JInstruction(TPL, split="test").format(src="a b c"))])["net_input"]["slots"]
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), slots))
    params = jax.tree.map(lambda a: np.array(a), params)
    params["decoder"]["layers_0"]["self_attn"]["k_proj"]["kernel"][3, 5] = np.nan
    params["encoder"]["layer_norm"]["scale"][7] = np.inf
    params["encoder_adaptor"]["text"]["rel_pos_table"][0, 2, 1] = np.nan
    load_jax_params(tm.net, params)
    tslots = tgp.collate([tgp(Instruction(TPL, split="test").format(src="a b c"))])["net_input"]["slots"]
    return dict(params=params, tm=tm, tslots=tslots)


def test_check_tree_paths_equal_ofasys_tpu(planted):
    want = jnan.check_tree(planted["params"], "params")
    assert len(want) == 3
    net = planted["tm"].net
    assert tnan.check_tree(dict(net.named_parameters()), "params", net=net) == want
    assert tnan.check_tree(planted["params"], "params") == want
    grads = {n: p.detach().clone() for n, p in net.named_parameters()}
    assert tnan.check_tree(grads, "grads", net=net) == want
    assert tnan.check_tree(export_params(net), "params") == want
    finite = {n: torch.zeros_like(p) for n, p in net.named_parameters()}
    assert tnan.check_tree(finite, "grads", net=net) == []


def test_debug_forward_names_the_first_non_finite_layer():
    d = Dictionary()
    gp = GeneralPreprocess(d, active=["text"])
    m = GeneralistModel(arch="tiny")
    m.cfg.encoder.layers = m.cfg.decoder.layers = 2
    m.initialize(d, dtype=torch.float32, device="cpu")
    slots = gp.collate([gp(Instruction(TPL, split="test").format(src="a b c"))])["net_input"]["slots"]
    assert tnan.debug_forward(m, slots) == []
    with torch.no_grad():
        m.net.encoder.layers_1.ffn.fc1.weight[0, 0] = float("nan")
    bad = tnan.debug_forward(m, slots)
    assert bad[0] == "encoder/layers_1/ffn/fc1"
    assert not any(p.startswith("encoder/layers_0") for p in bad)
    assert "decoder" in bad[-1] or bad[-1].startswith("decoder")


def test_debug_nans_raises_at_the_backward_op():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    torch.sqrt(x).sum().backward()          # NaN gradient, no error outside the scope
    assert torch.isnan(x.grad).any()
    with pytest.raises(RuntimeError, match="nan"):
        with tnan.debug_nans():
            torch.sqrt(x * 1.0).sum().backward()
    with tnan.debug_nans(False):
        torch.sqrt(x * 1.0).sum().backward()


def test_profiler_tools(tmp_path):
    logdir = tmp_path / "prof"
    with profiler.profile(str(logdir)) as prof:
        with profiler.annotate("the_block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.load(open(logdir / profiler.TRACE_FILE))
    assert any(e.get("name") == "the_block" for e in trace["traceEvents"])
    assert any(e.key == "the_block" for e in prof.key_averages())
    calls = []
    assert profiler.time_fn(lambda: calls.append(1), iters=3, warmup=2, device="cpu") >= 0
    assert len(calls) == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiler.time_fn(lambda: None)
        assert profiler.device_memory_stats() == {}
    dog = profiler.Watchdog(0.2, kill=False).start()
    t0 = time.monotonic()
    while not dog.fired and time.monotonic() - t0 < 5:
        time.sleep(0.05)
    dog.stop()
    assert dog.fired
    with profiler.Watchdog(5.0, kill=False) as dog:
        dog.beat()
    assert not dog.fired


def test_fit_under_profile_writes_a_trace_and_equals_the_plain_fit(tmp_path):
    root = write_data(str(tmp_path / "data"), n_rows=8)
    runs = {}
    for prof in (False, True):
        cfg = make_cfg(True, tmp_path / f"ck_{prof}", no_save=True)
        cfg.common.seed = 1
        cfg.common.log_interval = 1
        cfg.common.profile = prof
        cfg.common.profile_dir = str(tmp_path / "trace")
        tr = recording(Trainer)(cfg, device="cpu")
        model = make_model(True)
        tr.fit(model, make_tasks(True, root, ("summary",), batch=4), max_update=2)
        runs[prof] = (tr.history(), {k: v.smoothed_value for k, v in tr.meters.items()
                                     if type(v).__name__ != "TimeMeter" and k not in ("train_wall", "gb_free")},
                      export_params(model.net))
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == runs[False][1]
    for path, a in jax.tree_util.tree_leaves_with_path(runs[False][2]):
        b = dict(jax.tree_util.tree_leaves_with_path(runs[True][2]))[path]
        np.testing.assert_array_equal(a, b)
    trace = json.load(open(tmp_path / "trace" / profiler.TRACE_FILE))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"update 1", "update 2"} <= names


def test_parse_log_and_draw_equal_ofasys_tpu(tmp_path):
    log = tmp_path / "train.log"
    lines = [json.dumps({"epoch": 1, "update": i, "loss": 3.5 - 0.25 * i, "lr": 1e-4 * i,
                         "gnorm": 1.5 + i, "tag": "x"}) for i in range(1, 4)]
    lines += ["2026-10-17 | INFO | train | epoch 001 | loss 2.75 | nll_loss 1.9 | lr 0.0003 | gnorm 4.2e-1",
              "not a log line", "{broken json | loss 1.5", "| wps -3 | ups 1.2e+01"]
    log.write_text("\n".join(lines) + "\n")
    want = jdraw.parse_log(str(log))
    assert tdraw.parse_log(str(log)) == want and want["loss"] == [3.25, 3.0, 2.75, 2.75, 1.5]
    out = tdraw.draw(str(log), str(tmp_path / "curves.png"))
    assert os.path.getsize(out) > 0


def test_tools_write_the_same_files(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    tsv = tmp_path / "rows.tsv"
    tsv.write_text("".join(f"{i}\t{'x' * int(rng.integers(0, 30))}\n" for i in range(50)) + "tail")
    for side, mod in (("j", jtsv), ("t", ttsv)):
        monkeypatch.setenv("OFA_CACHE_HOME", str(tmp_path / f"cache_{side}"))
        assert mod.main([str(tsv)]) == 0
    idx = [sorted(p for p in os.listdir(tmp_path / f"cache_{s}") if p.endswith(".idx")) for s in "jt"]
    assert idx[0] == idx[1] and len(idx[0]) == 1
    assert (tmp_path / "cache_j" / idx[0][0]).read_bytes() == (tmp_path / "cache_t" / idx[1][0]).read_bytes()

    text = tmp_path / "corpus.txt"
    text.write_text("hello world\nünïcode line\n\nlast")
    for tok in ([], ["characters"]):
        outs = []
        for side, mod in (("j", jprep), ("t", tprep)):
            out = tmp_path / f"ids_{side}{len(tok)}.npy"
            assert mod.main([str(text), str(out)] + tok) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1]

    listing = ["oss://bucket/dir/a.tsv", "oss://bucket/dir/sub/", "oss://bucket/dir/__meta",
               "  oss://bucket/dir/b.tsv  ", "oss://other/c.tsv", "Object Number is: 4"]
    puts = {}
    for side, mod in (("j", jlist), ("t", tlist)):
        assert mod.list_objects("oss://bucket/dir/", list_fn=lambda p: listing) == \
            ["oss://bucket/dir/a.tsv", "oss://bucket/dir/b.tsv"]
        d = tmp_path / f"manifest_{side}"
        d.mkdir()
        local = mod.write_manifest("oss://bucket/dir/", str(d), list_fn=lambda p: listing,
                                   put_fn=lambda a, b, s=side: puts.setdefault(s, (os.path.basename(a), b)))
        puts[side + "_bytes"] = open(local, "rb").read()
        with pytest.raises(ValueError, match="explicit directory"):
            mod.list_objects("oss://bucket/dir", list_fn=lambda p: listing)
    assert puts["j"] == puts["t"] == ("__list_object__.txt", "oss://bucket/dir/__list_object__.txt")
    assert puts["j_bytes"] == puts["t_bytes"]


def test_ms_wrapper_is_a_no_op_without_modelscope():
    assert tms._HAS_MODELSCOPE is jms._HAS_MODELSCOPE is False
    assert tms.TASK_NAME == jms.TASK_NAME
    assert not hasattr(tms, "OFASysMsModel")
