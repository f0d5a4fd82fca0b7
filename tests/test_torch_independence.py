"""ofasys_torch stands alone: importing every one of its modules loads no
jax, flax, optax or ofasys_tpu module, and its entry points refuse to run on an
absent card unless the CPU is asked for explicitly (the hub, the server,
Trainer.fit, OFASys.from_pretrained and utils/profiler.time_fn)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, json, pkgutil, sys
import ofasys_torch
names = []
for m in pkgutil.walk_packages(ofasys_torch.__path__, "ofasys_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "ofasys_tpu"))
out = {"modules": names, "bad": bad}
import torch
if not torch.cuda.is_available():
    from ofasys_torch import GeneralistModel, OFASys
    from ofasys_torch.preprocessor.dictionary import Dictionary
    from ofasys_torch.preprocessor.general import GeneralPreprocess
    d = Dictionary()
    gp = GeneralPreprocess(d)
    m = GeneralistModel(arch="tiny")
    m.cfg.encoder.layers = m.cfg.decoder.layers = 1
    raised = {}
    try:
        m.initialize(d)
        raised["initialize"] = False
    except RuntimeError:
        raised["initialize"] = True
    m.initialize(d, device="cpu")
    try:
        OFASys(m, None, d, gp)
        raised["OFASys"] = False
    except RuntimeError:
        raised["OFASys"] = True
    hub = OFASys(m, None, d, gp, device="cpu")
    from ofasys_torch.serve import InferenceServer
    try:
        InferenceServer(hub)
        raised["InferenceServer"] = False
    except RuntimeError:
        raised["InferenceServer"] = True
    import tempfile
    from ofasys_torch import Task, Trainer, TrainerConfig
    from ofasys_torch.configure import to_dict
    from ofasys_torch.engine.optim import build_optimizer
    from ofasys_torch.engine.train_step import TrainState
    from ofasys_torch.utils import checkpoint_utils
    try:
        task = Task(name="copy", instruction="[TEXT:src] -> [TEXT:tgt]")
        Trainer(TrainerConfig()).fit(GeneralistModel(arch="tiny"), [task], max_update=1)
        raised["Trainer.fit"] = False
    except RuntimeError:
        raised["Trainer.fit"] = True
    root = tempfile.mkdtemp()
    state = TrainState.create(m.net, build_optimizer(TrainerConfig().optimization))
    checkpoint_utils.save_checkpoint(
        root, "checkpoint_last", checkpoint_utils.train_state_dict(m.net, state),
        {"global_dict": d.state_dict(), "model_cfg": to_dict(m.cfg),
         "active_adaptors": list(m.net.active_adaptors)})
    try:
        OFASys.from_pretrained(root + "/checkpoint_last")
        raised["OFASys.from_pretrained"] = False
    except RuntimeError:
        raised["OFASys.from_pretrained"] = True
    OFASys.from_pretrained(root + "/checkpoint_last", device="cpu")
    from ofasys_torch.utils import profiler
    try:
        profiler.time_fn(lambda: None)
        raised["time_fn"] = False
    except RuntimeError:
        raised["time_fn"] = True
    out["raised"] = raised
print(json.dumps(out))
"""


def test_port_imports_nothing_of_jax_and_needs_explicit_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    expected = {"ofasys_torch.serve", "ofasys_torch.hub_interface", "ofasys_torch.ops.dense_attention",
                "ofasys_torch.model.ofa", "ofasys_torch.generator.sequence_generator",
                "ofasys_torch.utils.jax_params", "ofasys_torch.engine.train_step",
                "ofasys_torch.engine.optim", "ofasys_torch.engine.criterion.base",
                "ofasys_torch.engine.criterion.label_smoothed_cross_entropy",
                "ofasys_torch.configure.configs", "ofasys_torch.preprocessor.mask_utils",
                "ofasys_torch.ops.quant", "ofasys_torch.ops.int8_matmul", "ofasys_torch.ops.layer_norm",
                "ofasys_torch.adaptor.image", "ofasys_torch.preprocessor.image",
                "ofasys_torch.generator.search", "ofasys_torch.utils.trie", "ofasys_torch.ops.fused_ce",
                "ofasys_torch.preprocessor.tokenizer.gpt2_bpe", "ofasys_torch.configure.config_store",
                "ofasys_torch.utils.file_utils", "ofasys_torch.io.reader.base_reader",
                "ofasys_torch.io.reader.file_reader", "ofasys_torch.io.reader.readers",
                "ofasys_torch.io.reader.dataset", "ofasys_torch.task.base", "ofasys_torch.logging.meters",
                "ofasys_torch.logging.metrics", "ofasys_torch.logging.progress_bar",
                "ofasys_torch.utils.checkpoint_utils", "ofasys_torch.engine.trainer",
                "ofasys_torch.engine.nan_detector", "ofasys_torch.utils.profiler", "ofasys_torch.draw",
                "ofasys_torch.tools.preprocess_text", "ofasys_torch.tools.create_tsv_cache",
                "ofasys_torch.tools.create_oss_list_objects", "ofasys_torch.ms_wrapper",
                "ofasys_torch.io.reader.object_store", "ofasys_torch.io.reader.streaming",
                "ofasys_torch.generator.speculative"}
    assert expected <= set(out["modules"])
    assert out["bad"] == []
    if "raised" in out:
        assert out["raised"] == {"initialize": True, "OFASys": True, "InferenceServer": True,
                                 "Trainer.fit": True, "OFASys.from_pretrained": True, "time_fn": True}
