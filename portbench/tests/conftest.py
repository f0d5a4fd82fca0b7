"""A tiny copy of the benchmark for the CPU: the repo's BENCHMARK.json and
portbench/ copied into a temporary root, with a tiny configuration and
tiny traffic mixes added as files and cells added as entries, which is how
a later change adds a cell."""

import json
import os
import shutil
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(name="tiny", arch="tiny", encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_layers=2,
            decoder_embed_dim=64, decoder_ffn_embed_dim=128, decoder_layers=2, encoder_attention_heads=4,
            decoder_attention_heads=4, resnet_type="resnet50")

# a grounding mix (RefCOCO-style: an image, a phrase, four box tokens) as
# changes to the caption mix: the text slot, the box adaptor and greedy
# decoding, which no cell of the benchmark drives yet
GROUND = dict(template="[IMAGE:img,adaptor=image_resnet] which region does the text \" [TEXT:text] \" describe? "
                       "-> [BOX:region_coord]",
              image_size=512, text_words=[4, 12], generation={"beam_size": 1, "min_len": 4, "max_len_b": 4})

# each tiny cell: the traffic file it copies and what it changes there
TINY_CELLS = {
    "tiny.caption": ("serve_caption", dict(image_size=64, clients=4, max_batch=2, pool=8, warmup_dispatches=1,
                                           traced_dispatches=2, checked_requests=3,
                                           generation={"beam_size": 3, "min_len": 4, "max_len_b": 4})),
    "tiny.ground": ("serve_caption", dict(GROUND, image_size=64, clients=4, max_batch=2, pool=8,
                                          warmup_dispatches=1, traced_dispatches=2, checked_requests=3)),
    "tiny.train": ("train_summ_long", dict(source_tokens=[40, 100], target_tokens=[8, 20], pad_multiple=16,
                                           samples_per_update=4, ring=4, traced_updates=2, reference_chunk=2)),
}
# the repo's cell whose metric lists each tiny cell joins
LIKE = {"tiny.caption": "ofa_huge.serve_caption", "tiny.ground": "ofa_huge.serve_caption",
        "tiny.train": "ofa_large.train_summ_long"}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_tiny_root(path, dtype="float32"):
    """A copy of the benchmark under ``path`` with the tiny cells added by
    files and entries alone."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), path)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    bench = json.load(open(os.path.join(path, "BENCHMARK.json")))
    base = json.load(open(os.path.join(ROOT, "portbench", "configs", "ofa_large.json")))
    cfg = dict(base, **TINY, compute_dtype=dtype)
    with open(os.path.join(path, "portbench", "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    bench["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2202.03052",
                             "file": "portbench/configs/tiny.json", "reduced": [], "why": "CPU test size"})
    for cell, (traffic, change) in TINY_CELLS.items():
        t = json.load(open(os.path.join(ROOT, "portbench", "traffic", traffic + ".json")))
        t.update(change)
        name = "tiny_" + cell.split(".")[1]
        with open(os.path.join(path, "portbench", "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": name, "chips": 1, "why": "CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if LIKE[cell] in m.get("workloads", []):
                m["workloads"].append(cell)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tinyroot")))


def run_tiny(root, cell, seed=2 ** 31 + 7, seconds=1.5, trace=False, hook=None):
    """One CPU run of a tiny cell: (result, compared)."""
    from portbench import harness
    from portbench.run import run_cell

    bench = harness.load_benchmark(root)
    return run_cell(bench, harness.cell_of(bench, cell), seed, seconds, trace, "cpu", time.perf_counter(),
                    root=root, hook=hook)
