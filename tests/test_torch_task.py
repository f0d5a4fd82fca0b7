"""ofasys_torch's Task (task/base.py) against ofasys_tpu's: the
preprocessors and adaptors a template needs, the template choice over
'|||' (random.Random(1) on the train split), batches from a TSV path and
from a list, max_tokens and micro_batch_size batching, and Task.inference
tokens on the same parameters (tiny arch, fp32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofasys_tpu import GeneralistModel as JModel, Task as JTask
from ofasys_tpu.configure import ConfigStore as JConfigStore
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_torch import GeneralistModel, Task
from ofasys_torch.configure import ConfigStore
from ofasys_torch.preprocessor.dictionary import Dictionary

TEMPLATES = [
    "[TEXT:src] -> [TEXT:tgt]",
    'what is the complete text of " [TEXT:text,mask_ratio=0.3] "? -> [TEXT:text]',
    "[IMAGE:img] what does the image describe? -> [TEXT:cap]",
    "[IMAGE:img,adaptor=image_resnet] which region does the text \" [TEXT:text] \" describe? "
    "-> [BOX:region_coord]",
    "[AUDIO:wav] what is the transcription? -> [TEXT:text]",
    'motion capture: " [TEXT:text] " -> [MOTION:bvh,preprocess=motion_6d,adaptor=motion_6d]',
    "[TEXT:src] -> [TEXT:tgt] ||| [IMAGE:img] [TEXT:src] -> [TEXT:tgt]",
]
TWO = "[TEXT:src] -> [TEXT:tgt] ||| summarize: [TEXT:src] -> [TEXT:tgt]"
WORDS = ["the", "storm", "moved", "north", "over", "coast", "and", "schools", "stay", "closed"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _recs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"src": " ".join(rng.choice(WORDS, int(rng.integers(3, 9)))),
             "tgt": " ".join(rng.choice(WORDS, int(rng.integers(2, 5))))} for _ in range(n)]


@pytest.mark.parametrize("template", TEMPLATES)
def test_required_preprocessors_and_adaptors(template):
    j, t = JTask(name="x", instruction=template), Task(name="x", instruction=template)
    assert t.templates == j.templates
    assert t.required_preprocessors() == j.required_preprocessors()
    assert t.required_adaptors() == j.required_adaptors()


def _task(cls, d, source, template=TWO, **dataset):
    task = cls(name="two", instruction=template)
    task.cfg.dataset.selected_cols = "0:src,1:tgt"
    for k, v in dataset.items():
        setattr(task.cfg.dataset, k, v)
    task.initialize(d)
    if isinstance(source, str):
        task.load_dataset_from_path(source)
    else:
        task.add_dataset(source)
    return task


def _same_batches(jb, tb):
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert a["template"] == b["template"] and a["nsentences"] == b["nsentences"]
        for x, y in zip(a["net_input"]["slots"], b["net_input"]["slots"], strict=True):
            for k, v in x.value.items():
                if v is not None:
                    np.testing.assert_array_equal(np.asarray(v), np.asarray(y.value[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(a["target"]), np.asarray(b["target"]))


@pytest.mark.parametrize("source", ["tsv", "list"])
def test_batches_from_path_and_list_match_ofasys_tpu(tmp_path, monkeypatch, source):
    monkeypatch.setenv("OFA_CACHE_HOME", str(tmp_path))
    recs = _recs(20)
    path = str(tmp_path / "train.tsv")
    with open(path, "w") as f:
        f.writelines(f"{r['src']}\t{r['tgt']}\n" for r in recs)
    out = []
    for cls, dcls in ((JTask, JDictionary), (Task, Dictionary)):
        task = _task(cls, dcls(), path if source == "tsv" else list(recs), batch_size=6)
        it = task.get_batch_iterator("train", seed=3)
        out.append([b for _ in range(2) for b in it.next_epoch_itr()])
    _same_batches(*out)
    # both templates were chosen
    assert {b["template"] for b in out[1]} == {t.strip() for t in TWO.split("|||")}


@pytest.fixture
def short_text():
    """max_src_length 40 and max_tgt_length 24 in both stores."""
    saved = []
    for store in (JConfigStore(), ConfigStore()):
        cfg = store.get("ofasys.preprocess", "text").config
        saved.append((cfg, cfg.max_src_length, cfg.max_tgt_length))
        cfg.max_src_length, cfg.max_tgt_length = 40, 24
    yield
    for cfg, *values in saved:
        cfg.max_src_length, cfg.max_tgt_length = values


def test_max_tokens_and_micro_batch_size_match_ofasys_tpu(short_text):
    # five-letter words, fixed counts: every microbatch has one shape, so
    # the update_freq axis stacks (in both packages)
    rng = np.random.default_rng(1)
    five = ["storm", "north", "coast", "heavy", "rains"]
    recs = [{"src": " ".join(rng.choice(five, 5)), "tgt": " ".join(rng.choice(five, 2))}
            for _ in range(64)]
    out = []
    for cls, dcls in ((JTask, JDictionary), (Task, Dictionary)):
        a = _task(cls, dcls(), list(recs), max_tokens=1000, required_batch_size_multiple=4)
        ia = a.get_batch_iterator("train")
        # one template: microbatches of two templates have different slot
        # structures and do not stack (in either package)
        b = _task(cls, dcls(), list(recs), "[TEXT:src] -> [TEXT:tgt]", batch_size=16, update_freq=2)
        b.cfg.micro_batch_size = 6
        ib = b.get_batch_iterator("train")
        out.append(((ia.batch_size, ia.update_freq), (ib.batch_size, ib.update_freq),
                    list(ib.next_epoch_itr())))
    (ja, jb, jbatches), (ta, tb, tbatches) = out
    assert ta == ja == (12, 1)          # 1000 // (40 + 24) = 15 -> a multiple of 4
    assert tb == jb == (6, 6)           # ceil(16 / 6) = 3 microbatches x update_freq 2
    assert len(tbatches) == len(jbatches) > 0
    for x, y in zip(jbatches, tbatches):
        np.testing.assert_array_equal(np.asarray(x["target"]), y["target"])
        np.testing.assert_array_equal(np.asarray(x["net_input"]["slots"][0].value["inputs"]),
                                      y["net_input"]["slots"][0].value["inputs"])
        assert y["target"].shape[0] in (1, 6)


def test_inference_matches_ofasys_tpu():
    recs = _recs(5, seed=2)
    sides = []
    for cls, dcls, mcls in ((JTask, JDictionary, JModel), (Task, Dictionary, GeneralistModel)):
        task = _task(cls, dcls(), list(recs), batch_size=5, batch_size_valid=5)
        task.add_dataset(list(recs), "valid")
        task.cfg.generation.beam, task.cfg.generation.max_len_b = 3, 6
        m = mcls(arch="tiny")
        m.cfg.encoder.layers = m.cfg.decoder.layers = 2
        batch = next(task.get_batch_iterator("valid").next_epoch_itr(shuffle=False))
        sides.append((task, m, batch))
    (jt, jm, jb), (tt, tm, tb) = sides
    jm.initialize(jt.global_dict, active_adaptors=("text",), dtype=jnp.float32)
    params = jm.init_params(jax.random.PRNGKey(0), jb["net_input"]["slots"])
    tm.initialize(tt.global_dict, device="cpu", dtype=torch.float32)
    jout = jt.inference(jm, params, jb)
    tout = tt.inference(tm, jax.device_get(params), tb)
    assert len(jout) == len(tout) == 5
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a[0].tokens), b[0].tokens)
        assert a[0].text == b[0].text


def test_unported_sources_metrics_and_generators_raise(tmp_path, tmp_path_factory, monkeypatch):
    """Remote and .bin sources read (tests/test_torch_fetchers.py); a remote
    scheme without a registered fetcher raises when its reader opens."""
    from ofasys_torch.utils import file_utils

    src_dir = tmp_path_factory.mktemp("sources")
    monkeypatch.setenv("OFA_CACHE_HOME", str(src_dir / "cache"))
    monkeypatch.delitem(file_utils._SCHEME_FETCHERS, "oss", raising=False)
    d = Dictionary()
    task = Task(name="x", instruction="[TEXT:src] -> [TEXT:tgt]").initialize(d)
    sources = Task(name="s", instruction="[TEXT:src] -> [TEXT:tgt]").initialize(Dictionary())
    with pytest.raises(ValueError, match="no fetcher for scheme 'oss'"):
        sources.load_dataset_from_path("oss://bucket/train.tsv", split="valid").datasets["valid"].open()
    np.arange(1030, dtype=np.int32).tofile(src_dir / "blocks.bin")
    blocks = sources.load_dataset_from_path(str(src_dir / "blocks.bin"), split="valid").datasets["valid"]
    assert len(blocks) == 2 and blocks.read(1).tolist() == list(range(512, 1024))
    with pytest.raises(ValueError, match="no dataset"):
        task.evaluate(None, None)
    # metrics build (test_torch_metrics.py); the Spider SQL evaluators compute
    # (tests/test_torch_sql.py): a ref without a database counts as wrong
    sql = Task(name="y", instruction="[TEXT:src] -> [TEXT:tgt]",
               **{"evaluation.metrics": ("bleu", "sql_exec_acc")}).initialize(Dictionary())
    assert sql.metrics[1].compute(["a"], ["a"]) == {"sql_exec_acc": 0.0}
    # the criteria of item 10 build (tests/test_torch_{tts,speech_pretrain,scst}.py)
    assert type(Task(name="z", instruction="[TEXT:src] -> [TEXT:tgt]",
                     criterion="speech_pretrain_loss").initialize(Dictionary()).criterion
                ).__name__ == "SpeechPretrainCriterion"
    with pytest.raises(ValueError, match="no dataset"):
        task.get_batch_iterator("valid")
    assert os.listdir(tmp_path) == []
