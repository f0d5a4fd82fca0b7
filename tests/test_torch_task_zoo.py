"""ofasys_torch's task zoo (task/tasks.py) against ofasys_tpu's: the same
registry names and class names; each family's templates, criterion,
metrics, required preprocessors and adaptors; the raw-record
``preprocess`` hooks on the same records; every family (the STRUCT,
PHONE and VIDEO ones among them) builds its criterion and metrics at
``initialize``; GLUE's subtasks from a keyword and from the store's
flags."""

import numpy as np
import pytest

import ofasys_tpu.metric  # noqa: F401  (registers the metric zoo)
import ofasys_tpu.task  # noqa: F401  (registers the task zoo)
from ofasys_tpu.configure import ConfigStore as JConfigStore
import ofasys_torch.task  # noqa: F401
from ofasys_torch.configure import ConfigStore
from ofasys_torch.preprocessor.dictionary import Dictionary

FAMILIES = [n for n in JConfigStore().names("ofasys.task") if n not in ("default", "traverse")]
# family -> the ROADMAP Queue A item its initialize names (none is left)
UNPORTED = {}


def _both(name, **kw):
    return (JConfigStore().get("ofasys.task", name).target_cls(**kw),
            ConfigStore().get("ofasys.task", name).target_cls(**kw))


def test_registry_names_match():
    assert ConfigStore().names("ofasys.task") == JConfigStore().names("ofasys.task")
    assert len(FAMILIES) == 29 and set(UNPORTED) <= set(FAMILIES)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_matches_ofasys_tpu(name):
    j, t = _both(name)
    assert type(t).__name__ == type(j).__name__
    assert type(t).__mro__[1].__name__ == type(j).__mro__[1].__name__
    assert t.name == j.name
    assert t.templates == j.templates
    assert t.cfg.criterion == j.cfg.criterion
    assert tuple(t.cfg.evaluation.metrics) == tuple(j.cfg.evaluation.metrics)
    assert t.required_preprocessors() == j.required_preprocessors()
    assert t.required_adaptors() == j.required_adaptors()
    g, jg = t.cfg.generation, j.cfg.generation
    assert (g.beam, g.max_len_b, g.min_len) == (jg.beam, jg.max_len_b, jg.min_len)


@pytest.mark.parametrize("name", FAMILIES)
def test_initialize_builds_metrics_or_names_the_item(name):
    _, t = _both(name)
    if name in UNPORTED:
        with pytest.raises(NotImplementedError, match=f"item {UNPORTED[name]}"):
            t.initialize(Dictionary())
        return
    t.initialize(Dictionary())
    assert [type(m).__name__ for m in t.metrics] == \
        [JConfigStore().get("ofasys.metric", m).target_cls.__name__ for m in t.cfg.evaluation.metrics]


RECORDS = {
    "caption": [({"cap": "A Man, riding a HORSE!&&two dogs"}, "valid"),
                ({"cap": "A Man, riding a HORSE!&&two dogs"}, "train")],
    "image_gen": [({"cap": "A red Ball, on the beach.&&other"}, "train")],
    "refcoco": [({"region_coord": "1.5,2,30,40.25", "width": "64", "height": 48}, "train")],
    "vqa_gen": [({"answer": "0.6|!+two"}, "valid"), ({"answer": "yes"}, "train")],
    "spider": [({"question": "How MANY <unk> cows?", "db_id": "farm", "database": {"db_id": "farm"},
                 "query": "SELECT count(*) FROM cows"}, "train")],
    "video_generation": [({"video": np.random.default_rng(0).integers(0, 255, (4, 8, 8, 3))}, "train")],
}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_preprocess_hooks_match(name):
    j, t = _both(name)
    for rec, split in RECORDS[name]:
        a, b = j.preprocess(dict(rec), split), t.preprocess(dict(rec), split)
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], dict):
                assert set(a[k]) == set(b[k])
                for kk in a[k]:
                    np.testing.assert_array_equal(np.asarray(a[k][kk]), np.asarray(b[k][kk]))
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_spider_schema_read_raises_naming_item_11():
    """The schema read is ported (tests/test_torch_struct.py): without a
    database root both packages give the database an empty schema."""
    j, t = _both("spider")
    rec = {"question": "q", "db_id": "farm", "query": "select 1"}
    assert t.preprocess(dict(rec), "train") == j.preprocess(dict(rec), "train")
    assert t.preprocess(dict(rec), "train")["database"] == \
        {"db_id": "farm", "tables": {}, "question": "q", "db_path": ""}


@pytest.mark.parametrize("subtask", ["cola", "sst2", "mnli", "qnli", "qqp", "mrpc", "rte", "stsb"])
def test_glue_subtask_from_keyword(subtask):
    j, t = _both("glue", subtask=subtask)
    assert t.subtask == j.subtask == subtask
    assert t.name == j.name == f"glue_{subtask}"
    assert t.templates == j.templates
    assert tuple(t.cfg.evaluation.metrics) == tuple(j.cfg.evaluation.metrics)


def test_glue_subtask_from_store_flags():
    from ofasys_tpu.configure.options import parse_flags as jparse_flags
    from ofasys_tpu.launch import build_from_config as jbuild
    from ofasys_torch.configure.options import parse_flags
    from ofasys_torch.launch import build_from_config

    flags = ["--ofasys.task.mnli.task=glue", "--ofasys.task.mnli.subtask=mnli",
             "--ofasys.task.cola.task=glue", "--ofasys.task.cola.subtask=cola"]
    jdata, _ = jparse_flags(flags)
    data, _ = parse_flags(flags)
    assert data == jdata
    _, _, jtasks = jbuild(jdata)
    _, _, tasks = build_from_config(data, device="cpu")
    for j, t in zip(jtasks, tasks, strict=True):
        assert (t.name, t.subtask, t.templates) == (j.name, j.subtask, j.templates)
        assert tuple(t.cfg.evaluation.metrics) == tuple(j.cfg.evaluation.metrics)
    from ofasys_torch.task.tasks import GlueTask

    with pytest.raises(ValueError, match="unknown GLUE subtask"):
        GlueTask(subtask="nope")
