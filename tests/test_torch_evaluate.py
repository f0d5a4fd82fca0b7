"""ofasys_torch's Task.evaluate and TraverseTask.evaluate against
ofasys_tpu's, on the same weights and the same TSV files.

Tiny arch (2+2 layers, E=256), fp32 on both sides. gigaword under rouge
and caption under cider (64 x 64 images, 16 patches) generate with beam 2;
glue sst2 (2 candidates) and mnli (3) rank their answer sets. The
hypotheses, the picks, the metric values and the ``output_dir`` files must
equal ofasys_tpu's exactly; the candidate scores agree to rtol 1e-5 (fp32
sums of log-probabilities in another order), and a pick is required equal
where the top two scores part by more than 1e-4.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ofasys_tpu.task  # noqa: F401  (registers the task zoo)
from ofasys_tpu import GeneralistModel as JModel
from ofasys_tpu.configure import ConfigStore as JConfigStore
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
import ofasys_torch.task  # noqa: F401
from ofasys_torch import GeneralistModel
from ofasys_torch.configure import ConfigStore
from ofasys_torch.preprocessor.dictionary import Dictionary

WORDS = ["the", "storm", "moved", "north", "over", "coast", "and", "schools", "stay", "closed",
         "good", "film", "bad", "plot"]
SCORE_RTOL = 1e-5
TIE = 1e-4
IMAGE = 64
ANSWERS = {"sst2": ["no", "yes"], "mnli": ["yes", "maybe", "no"]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and test workers
    running side by side would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _words(rng, lo, hi):
    return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))


def write_tsvs(root, seed=0):
    """gigaword (src, tgt), caption (img as a .png path, cap), sst2
    (sentence, label) and mnli (premise, hypothesis, label) TSVs."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    rows = {
        "gigaword": [(_words(rng, 6, 12), _words(rng, 2, 5)) for _ in range(5)],
        "sst2": [(_words(rng, 4, 9), str(rng.choice(ANSWERS["sst2"]))) for _ in range(6)],
        "mnli": [(_words(rng, 4, 9), _words(rng, 3, 6), str(rng.choice(ANSWERS["mnli"])))
                 for _ in range(4)],
    }
    caps = []
    for i in range(5):
        path = os.path.join(root, f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (IMAGE, IMAGE, 3)).astype(np.uint8)).save(path)
        caps.append((path, f"{_words(rng, 3, 6)}&&{_words(rng, 3, 6)}"))
    rows["caption"] = caps
    for name, rs in rows.items():
        with open(os.path.join(root, f"{name}.tsv"), "w") as f:
            f.writelines("\t".join(r) + "\n" for r in rs)
    for sub, answers in ANSWERS.items():
        with open(os.path.join(root, f"{sub}_ans2label.json"), "w") as f:
            json.dump({a: i for i, a in enumerate(answers)}, f)
    return root


SPECS = {
    "gigaword": dict(task="gigaword", cols="0:src,1:tgt", metrics=None),
    "caption": dict(task="caption", cols="0:img,1:cap", metrics=("cider",)),
    "sst2": dict(task="glue", subtask="sst2", cols="0:sentence,1:label", metrics=None),
    "mnli": dict(task="glue", subtask="mnli", cols="0:premise,1:hypothesis,2:label", metrics=None),
}


@pytest.fixture
def stores():
    """Both ConfigStores with 64 x 64 images; restored after."""
    saved = []
    for store in (JConfigStore(), ConfigStore()):
        img = store.get("ofasys.preprocess", "image").config
        txt = store.get("ofasys.preprocess", "text").config
        saved.append((img, img.patch_image_size, txt, txt.ans2label_file))
        img.patch_image_size = IMAGE
    yield
    for img, size, txt, a2l in saved:
        img.patch_image_size, txt.ans2label_file = size, a2l


def build(torch_side, name, root, out_dir=None):
    """The task of SPECS[name] reading its TSV as the valid split, and a
    tiny model on its dictionary (ofasys_tpu's with params from PRNGKey(0),
    the port's with no weights of its own yet)."""
    spec = SPECS[name]
    store = ConfigStore() if torch_side else JConfigStore()
    if "subtask" in spec:
        store.get("ofasys.preprocess", "text").config.ans2label_file = \
            os.path.join(root, f"{spec['subtask']}_ans2label.json")
    node = store.get("ofasys.task", spec["task"])
    kw = {"subtask": spec["subtask"]} if "subtask" in spec else {}
    task = node.target_cls(**kw)
    task.cfg.dataset.selected_cols = spec["cols"]
    task.cfg.dataset.batch_size = 4
    task.cfg.dataset.num_workers = 0
    task.cfg.generation.beam, task.cfg.generation.max_len_b = 2, 4
    if spec["metrics"]:
        task.cfg.evaluation.metrics = spec["metrics"]
    task.cfg.evaluation.output_dir = out_dir
    d = Dictionary() if torch_side else JDictionary()
    task.initialize(d, is_train=False)
    task.load_dataset_from_path(os.path.join(root, f"{name}.tsv"), "valid")
    model = (GeneralistModel if torch_side else JModel)(arch="tiny")
    model.cfg.encoder.layers = model.cfg.decoder.layers = 2
    model.cfg.dropout = 0.0
    adaptors = tuple(task.required_adaptors())
    if torch_side:
        model.initialize(d, active_adaptors=adaptors, dtype=torch.float32, device="cpu")
        return task, model, None
    model.initialize(d, active_adaptors=adaptors, dtype=jnp.float32)
    batch = next(task.get_batch_iterator("valid").next_epoch_itr(shuffle=False))
    task.iterators.pop("valid")
    params = model.init_params(jax.random.PRNGKey(0), batch["net_input"]["slots"])
    return task, model, jax.device_get(params)


@pytest.mark.parametrize("name", ["gigaword", "caption"])
def test_generation_evaluate_matches_ofasys_tpu(stores, tmp_path, name):
    root = write_tsvs(str(tmp_path / "data"))
    jt, jm, params = build(False, name, root, str(tmp_path / "j"))
    tt, tm, _ = build(True, name, root, str(tmp_path / "t"))
    jres = jt.evaluate(jm, params, "valid")
    tres = tt.evaluate(tm, params, "valid")
    assert set(jres) == ({"rouge1", "rouge2", "rougeL"} if name == "gigaword" else {"cider"})
    assert tres == jres
    files = [json.load(open(os.path.join(str(tmp_path / side), f"{name}_valid.json")))
             for side in ("j", "t")]
    assert files[0] == files[1]
    assert len(files[1]["hyps"]) == len(files[1]["refs"]) == 5


def _jax_scores(jt, params, batch, answers):
    """ofasys_tpu's candidate scores of one batch, from its own scoring
    function (built by its first rank_answers call)."""
    import dataclasses

    from ofasys_tpu.utils.pytree import SlotBatch

    jt.rank_answers(None, params, batch, answers)
    pre, d = jt.general_preprocess.name2pre["text"], jt.global_dict
    slots = batch["net_input"]["slots"]
    src = [s for s in slots if s.is_src]
    tgt_slot = SlotBatch.target_slot(slots)
    B = next(iter(src[0].value.values())).shape[0]
    out = np.zeros((B, len(answers)))
    for ai, a in enumerate(answers):
        toks = np.concatenate([[d.bos()], pre.encode(a), [d.eos()]]).astype(np.int32)
        tgt = dataclasses.replace(tgt_slot, value={"inputs": jnp.asarray(np.tile(toks[:-1], (B, 1)))})
        out[:, ai] = np.asarray(jt._score_fn(params, src, tgt, jnp.asarray(np.tile(toks[1:], (B, 1))),
                                             d.pad()))
    return out


@pytest.mark.parametrize("name", ["sst2", "mnli"])
def test_traverse_evaluate_matches_ofasys_tpu(stores, tmp_path, name):
    root = write_tsvs(str(tmp_path / "data"))
    jt, jm, params = build(False, name, root)
    tt, tm, _ = build(True, name, root)
    assert tt.candidate_answers() == jt.candidate_answers() == ANSWERS[name]
    batches = list(tt.get_batch_iterator("valid").next_epoch_itr(shuffle=False))
    jbatches = list(jt.get_batch_iterator("valid").next_epoch_itr(shuffle=False))
    tt.iterators.pop("valid")
    jt.iterators.pop("valid")
    jres = jt.evaluate(jm, params, "valid")
    tres = tt.evaluate(tm, params, "valid")
    assert set(tres) == {"accuracy"}
    picks_equal = True
    for jb, tb in zip(jbatches, batches, strict=True):
        js = _jax_scores(jt, params, jb, ANSWERS[name])
        ts = tt.answer_scores(tm, tb, ANSWERS[name])
        np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL)
        top2 = np.sort(js, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > TIE
        np.testing.assert_array_equal(ts.argmax(1)[clear], js.argmax(1)[clear])
        picks_equal &= bool(clear.all())
        assert tt.rank_answers(tm, None, tb) == [ANSWERS[name][i] for i in ts.argmax(1)]
    if picks_equal:
        assert tres == jres
