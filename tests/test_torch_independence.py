"""ofasys_torch stands alone: importing every one of its modules loads no
jax, flax or ofasys_tpu module, and its entry points refuse to run on an
absent card unless the CPU is asked for explicitly."""

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
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "ofasys_tpu"))
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
                "ofasys_torch.adaptor.image", "ofasys_torch.preprocessor.image"}
    assert expected <= set(out["modules"])
    assert out["bad"] == []
    if "raised" in out:
        assert out["raised"] == {"initialize": True, "OFASys": True, "InferenceServer": True}
