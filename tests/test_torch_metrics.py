"""ofasys_torch's metric zoo against ofasys_tpu's on the same seeded
hypotheses and references: every metric's dict at rtol 1e-12, ``report``
and ``levenshtein``, the same registry names; bleu raises ImportError at
``compute`` without sacrebleu on both sides (and agrees with it where it
is installed), clip_ti reports NaN without transformers (hidden from the
import system here) on both sides, and the Spider SQL
metrics raise naming ROADMAP Queue A item 11."""

import importlib.util
import math
import sys

import numpy as np
import pytest

import ofasys_tpu.metric  # noqa: F401  (registers the metric zoo)
from ofasys_tpu.configure import ConfigStore as JConfigStore
from ofasys_tpu.metric.base import BaseMetric as JBaseMetric, levenshtein as jlevenshtein
import ofasys_torch.metric  # noqa: F401
from ofasys_torch.configure import ConfigStore
from ofasys_torch.metric.base import BaseMetric, levenshtein

RTOL = 1e-12
WORDS = ["a", "man", "rides", "the", "horse", "on", "beach", "dog", "runs", "A", "Beach.", "red",
         "ball", "an", "of", "yes", "no"]
N = 40


def _sent(rng, lo=1, hi=12):
    return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))


def _pairs(name, seed=0):
    """(hyps, refs) for ``name``: sentences near their references, label
    strings, answer lists, boxes, boards."""
    rng = np.random.default_rng(seed)
    if name in ("accuracy", "matthews_corrcoef"):
        labels = ["yes", "no", "maybe"] if name == "accuracy" else ["yes", "No "]
        return [str(rng.choice(labels)) for _ in range(N)], [str(rng.choice(labels)) for _ in range(N)]
    if name == "iou_acc":
        def box():
            x0, y0 = rng.uniform(0, 50, 2)
            return [x0, y0, x0 + rng.uniform(1, 60), y0 + rng.uniform(1, 60)]
        return [box() for _ in range(N)], [box() for _ in range(N)]
    if name == "vqa_score":
        refs = [[str(rng.choice(WORDS)) for _ in range(10)] if i % 3 else str(rng.choice(WORDS))
                for i in range(N)]
        return [str(rng.choice(WORDS)) for _ in range(N)], refs
    if name == "solved_acc":
        boards = ["".join(map(str, rng.integers(1, 5, 16))) for _ in range(N)]
        hyps = [" ".join(b) if i % 2 else b[:-1] + "1" for i, b in enumerate(boards)]
        return hyps, boards
    refs = [_sent(rng) for _ in range(N)]
    hyps = [r if i % 5 == 0 else _sent(rng) for i, r in enumerate(refs)]
    if name == "cider":
        refs = [[r] + [_sent(rng) for _ in range(int(rng.integers(0, 4)))] for r in refs]
    return hyps, refs


COMPUTED = ["accuracy", "exact_match", "rouge", "f_measure", "wer", "matthews_corrcoef", "iou_acc",
            "vqa_score", "solved_acc", "cider"]


def _metric(store, name):
    node = store.get("ofasys.metric", name)
    return node.target_cls(node.config)


def test_registry_names_match():
    assert ConfigStore().names("ofasys.metric") == JConfigStore().names("ofasys.metric")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", COMPUTED)
def test_metric_matches_ofasys_tpu(name, seed):
    hyps, refs = _pairs(name, seed)
    got = _metric(ConfigStore(), name).compute(hyps, refs)
    want = _metric(JConfigStore(), name).compute(hyps, refs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    assert 0 < len(want)
    # empty input: the same guard values
    assert _metric(ConfigStore(), name).compute([], []) == _metric(JConfigStore(), name).compute([], [])


def test_report_and_levenshtein_match():
    rng = np.random.default_rng(3)
    logs = [{"a": float(rng.random()), "b": float(rng.integers(0, 9))} for _ in range(7)]
    assert BaseMetric.report(logs) == JBaseMetric.report(logs)
    for _ in range(20):
        a, b = (list(rng.choice(WORDS, int(rng.integers(0, 9)))) for _ in range(2))
        assert levenshtein(a, b) == jlevenshtein(a, b)


def test_bleu_behaves_as_ofasys_tpu():
    hyps, refs = _pairs("rouge")
    if importlib.util.find_spec("sacrebleu") is None:
        for store in (ConfigStore(), JConfigStore()):
            with pytest.raises(ImportError):
                _metric(store, "bleu").compute(hyps, refs)
    else:
        got = _metric(ConfigStore(), "bleu").compute(hyps, refs)
        assert got == _metric(JConfigStore(), "bleu").compute(hyps, refs)


def test_clip_ti_behaves_as_ofasys_tpu(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    hyps = [np.zeros((8, 8, 3), np.uint8)] * 2
    got = _metric(ConfigStore(), "clip_ti").compute(hyps, ["a", "b"])
    want = _metric(JConfigStore(), "clip_ti").compute(hyps, ["a", "b"])
    assert set(got) == set(want)
    for k in want:
        assert (math.isnan(got[k]) and math.isnan(want[k])) or got[k] == want[k]


@pytest.mark.parametrize("name", ["sql_exec_acc", "sql_match_acc"])
def test_sql_metrics_raise_naming_item_11(name):
    from ofasys_torch.configure import to_dict
    from ofasys_tpu.configure import to_dict as jto_dict

    assert to_dict(ConfigStore().get("ofasys.metric", name).config) == \
        jto_dict(JConfigStore().get("ofasys.metric", name).config)
    with pytest.raises(NotImplementedError, match="item 11"):
        _metric(ConfigStore(), name).compute(["db | select 1"], ["db | select 1"])
