"""No run loads JAX or the JAX package, and the reference loads nothing of
the program: top-level module names compared whole."""

import json
import subprocess
import sys

from conftest import ROOT

RUN = """
import json, sys, time
sys.path.insert(0, {tests!r})
sys.path.insert(0, {root!r})
from conftest import make_tiny_root, run_tiny
import tempfile
root = make_tiny_root(tempfile.mkdtemp())
for cell in ("tiny.caption", "tiny.train"):
    run_tiny(root, cell, seconds=0.5)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REF = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.ofa, portbench.reference.buckets
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT, tests=ROOT + "/portbench/tests")],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level(RUN)
    assert "ofasys_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "ofasys_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(REF)
    assert not names & {"jax", "jaxlib", "flax", "ofasys_tpu", "ofasys_torch"}


def test_the_harness_compares_whole_top_level_names(monkeypatch):
    """A module whose name only begins like a forbidden one passes; a
    submodule of one does not."""
    import types

    from portbench import harness

    monkeypatch.setitem(sys.modules, "flaxen", types.ModuleType("flaxen"))
    monkeypatch.setitem(sys.modules, "ofasys_tpu_extra", types.ModuleType("ofasys_tpu_extra"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]
