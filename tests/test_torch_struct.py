"""The STRUCT, CATEGORY and PHONE preprocessors of ofasys_torch against
ofasys_tpu's (preprocessor/struct.py): ``struct`` and ``table``
linearization, ``database`` (both Spider record shapes, DB-content linking
on a sqlite database built from a seed), ``category`` through ans2label,
``phone`` and ``text_phone`` (the ``<phone>`` namespace, hermetic g2p, the
``encoder_target`` column), run through ``GeneralPreprocess`` with the
task zoo's templates; SpiderTask's schema read; and the whole task zoo,
every family of which initializes in both packages with the same metrics.

Tolerance: none — token ids, collated arrays and linearized strings are
equal.
"""

import json
import sqlite3

import numpy as np
import pytest

import ofasys_tpu.adaptor.general  # noqa: F401  (registers the adaptors)
import ofasys_tpu.metric  # noqa: F401  (registers the metric zoo)
import ofasys_tpu.task  # noqa: F401  (registers the task zoo)
from ofasys_tpu import Instruction as JInstruction
from ofasys_tpu.configure import ConfigStore as JConfigStore, to_dict as jto_dict
from ofasys_tpu.preprocessor import struct as jstruct
from ofasys_tpu.preprocessor.dictionary import Dictionary as JDictionary
from ofasys_tpu.preprocessor.general import GeneralPreprocess as JGeneralPreprocess
import ofasys_torch.adaptor.general  # noqa: F401
import ofasys_torch.task  # noqa: F401
from ofasys_torch import Instruction
from ofasys_torch.configure import ConfigStore, to_dict
from ofasys_torch.preprocessor import struct as tstruct
from ofasys_torch.preprocessor.dictionary import Dictionary
from ofasys_torch.preprocessor.general import GeneralPreprocess

SPIDER = ('" [TEXT:question] " ; structured knowledge: '
          '" [STRUCT:database,preprocess=database] " -> [TEXT:query]')
SUDOKU = '" [STRUCT:puzzle,preprocess=struct] " solve the sudoku. -> [STRUCT:solution,preprocess=struct]'
DART = 'what is the description of table " [STRUCT:table,preprocess=table] "? -> [TEXT:text]'
CATEGORY = "[TEXT:src] is it positive? -> [CATEGORY:label]"
PHONE = "[PHONE:phone,preprocess=phone] -> [TEXT:text]"
TEXT_PHONE = "[TEXT:src] say it -> [TEXT:txt,preprocess=text_phone]"

NAMES = ["bessie", "daisy", "mabel", "clover", "buttercup", "rosie", "molly", "penny"]
BREEDS = ["holstein", "jersey", "angus", "hereford"]


def _both(active, template, records, split="train", tune=None):
    """(ofasys_tpu's batch, the port's batch, the two GeneralPreprocess)."""
    out = []
    for gcls, dcls, icls in ((JGeneralPreprocess, JDictionary, JInstruction),
                             (GeneralPreprocess, Dictionary, Instruction)):
        gp = gcls(dcls(), active=active)
        if tune:
            tune(gp)
        out.append((gp.collate([gp(icls(template, split=split).format(**r)) for r in records]), gp))
    (jb, jgp), (tb, tgp) = out
    assert jgp.global_dict.symbols == tgp.global_dict.symbols
    return jb, tb, jgp, tgp


def _assert_batches_equal(jb, tb):
    js, ts = jb["net_input"]["slots"], tb["net_input"]["slots"]
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert (a.modality.name, a.is_src, a.column_name, a.preprocess) == \
            (b.modality.name, b.is_src, b.column_name, b.preprocess)
        assert set(a.value) == set(b.value)
        for k in a.value:
            np.testing.assert_array_equal(np.asarray(b.value[k]), np.asarray(a.value[k]))
    keys = set(jb) - {"net_input", "template"}
    assert keys == set(tb) - {"net_input", "template"}
    for k in keys:
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]), err_msg=k)


def _farm_db(root, seed=0):
    """A Spider-layout database ``{root}/farm/farm.sqlite`` whose rows come
    from ``seed``: cows (id, name, breed, age) and barns (id, cow_id, size)."""
    rng = np.random.default_rng(seed)
    d = root / "farm"
    d.mkdir(exist_ok=True)
    path = str(d / "farm.sqlite")
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE cows (id INTEGER, name TEXT, breed TEXT, age REAL)")
    conn.execute("CREATE TABLE barns (id INTEGER, cow_id INTEGER, size TEXT)")
    conn.executemany("INSERT INTO cows VALUES (?, ?, ?, ?)",
                     [(i, NAMES[i], BREEDS[int(rng.integers(4))], float(rng.uniform(1, 9)))
                      for i in range(len(NAMES))])
    conn.executemany("INSERT INTO barns VALUES (?, ?, ?)",
                     [(i, int(rng.integers(len(NAMES))), ["small", "large"][i % 2]) for i in range(5)])
    conn.commit()
    conn.close()
    return path


def test_registries_hold_the_item_11_names():
    for group in ("ofasys.preprocess", "ofasys.adaptor"):
        assert ConfigStore().names(group) == JConfigStore().names(group), group
    names = set(ConfigStore().names("ofasys.preprocess"))
    assert {"struct", "table", "database", "category", "phone", "text_phone", "video"} <= names
    assert "video_image_sequence" in ConfigStore().names("ofasys.adaptor")
    for name in ("struct", "table", "database", "category", "phone", "text_phone"):
        got = ConfigStore().get("ofasys.preprocess", name)
        want = JConfigStore().get("ofasys.preprocess", name)
        assert got.target_cls.__name__ == want.target_cls.__name__
        # the port's configs have no is_active flag (the store's active set is its own)
        assert to_dict(got.config) == {k: v for k, v in jto_dict(want.config).items()
                                       if k != "is_active"}


@pytest.mark.parametrize("value", [
    "1 0 : 0 2 | 0 2 : 1 0",
    {"header": ["name", "breed"], "rows": [["bessie", "holstein"], ["daisy", 3]]},
    {"columns": ["a"], "data": [[1], [2.5]]},
    [["bessie", "breed", "holstein"], ["daisy", "age", 4]],
])
def test_struct_linearization(value):
    cfg = tstruct.StructPreprocessConfig()
    t = tstruct.StructPreprocess(Dictionary(), cfg)
    j = jstruct.StructPreprocess(JDictionary(), jstruct.StructPreprocessConfig())
    assert t.linearize(value) == j.linearize(value)


def test_struct_rejects_what_it_cannot_linearize():
    t = tstruct.StructPreprocess(Dictionary(), tstruct.StructPreprocessConfig())
    with pytest.raises(tstruct.PreprocessSkipException):
        t.linearize(3.5)


@pytest.mark.parametrize("template,split", [(SUDOKU, "train"), (SUDOKU, "test"), (DART, "train")])
def test_struct_tasks_batches_equal(template, split):
    rng = np.random.default_rng(1)
    recs = []
    for i in range(4):
        board = rng.integers(0, 5, (4, 4))
        recs.append({
            "puzzle": " | ".join(" : ".join(map(str, r)) for r in board),
            "solution": " | ".join(" : ".join(map(str, r)) for r in (board + 1) % 5),
            "table": [[NAMES[i], "breed", BREEDS[i % 4]], [NAMES[i], "age", int(rng.integers(9))]],
            "text": f"{NAMES[i]} is a {BREEDS[i % 4]}",
        })
    jb, tb, _, _ = _both(["text", "struct", "table"], template, recs, split)
    _assert_batches_equal(jb, tb)


@pytest.mark.parametrize("shape", ["tables", "spider_record"])
@pytest.mark.parametrize("with_content", [True, False])
def test_database_serialization_and_linking(tmp_path, shape, with_content):
    path = _farm_db(tmp_path)
    questions = ["what is the breed of bessie?", "how many cows are older than 3?",
                 "list barns that are large", "is daisy a jersey cow?"]
    recs = []
    for q in questions:
        if shape == "tables":
            db = {"db_id": "farm", "tables": {"cows": ["id", "name", "breed", "age"],
                                              "barns": ["id", "cow_id", "size"]}}
        else:
            db = {"db_id": "farm", "db_table_names": ["cows", "barns"],
                  "db_column_names": {"table_id": [-1, 0, 0, 0, 0, 1, 1, 1],
                                      "column_name": ["*", "id", "name", "breed", "age",
                                                      "id", "cow_id", "size"]}}
        db.update(question=q, db_path=str(tmp_path) if shape == "tables" else path)
        recs.append({"question": q, "database": db, "query": "farm | select name from cows"})

    def tune(gp):
        gp.name2pre["database"].cfg.schema_serialization_with_db_content = with_content

    jb, tb, jgp, tgp = _both(["text", "database"], SPIDER, recs, tune=tune)
    _assert_batches_equal(jb, tb)
    lin = [tgp.name2pre["database"].linearize(r["database"]) for r in recs]
    assert lin == [jgp.name2pre["database"].linearize(r["database"]) for r in recs]
    assert lin[0].startswith("| farm | ")
    assert ("name ( bessie )" in lin[0]) == with_content
    assert ("size ( large )" in lin[2]) == with_content


def test_spider_task_reads_the_schema(tmp_path):
    _farm_db(tmp_path)
    j = JConfigStore().get("ofasys.task", "spider").target_cls()
    t = ConfigStore().get("ofasys.task", "spider").target_cls()
    for task in (j, t):
        task.cfg.database_path = str(tmp_path)
    got = []
    for rec in ({"question": "What is the breed of Bessie?", "db_id": "farm",
                 "query": "SELECT breed FROM cows WHERE name = 'bessie'"},
                {"question": "q", "db_id": "nowhere", "query": "select 1"}):
        a, b = j.preprocess(dict(rec), "train"), t.preprocess(dict(rec), "train")
        assert a == b
        got.append(b)
    assert got[1]["database"] == {"db_id": "nowhere", "tables": {}, "question": "q", "db_path": ""}
    assert got[0]["query"] == "farm | select breed from cows where name = 'bessie'"
    assert got[0]["database"]["tables"] == {"barns": ["id", "cow_id", "size"],
                                       "cows": ["id", "name", "breed", "age"]}


@pytest.mark.parametrize("labels", ["ids", "strings"])
def test_category_through_ans2label(tmp_path, labels):
    path = tmp_path / "ans2label.json"
    path.write_text(json.dumps({"negative": 0, "positive": 1, "neutral": 2}))
    rng = np.random.default_rng(2)
    recs = [{"src": f"{NAMES[i]} likes grass",
             "label": int(rng.integers(3)) if labels == "ids" else ["negative", "positive"][i % 2]}
            for i in range(6)] + [{"src": "unknown id", "label": 7 if labels == "ids" else "other"}]

    def tune(gp):
        gp.name2pre["category"].cfg.ans2label_file = str(path)
        gp.name2pre["category"]._load_ans2label(str(path))

    jb, tb, _, _ = _both(["text", "category"], CATEGORY, recs, tune=tune)
    _assert_batches_equal(jb, tb)


def test_phone_namespace_and_tokens():
    jb, tb, jgp, tgp = _both(["text", "phone"], PHONE, [
        {"phone": "HH AH L OW sil W ER L D", "text": "hello world"},
        {"phone": "B AE D XX sp", "text": "bad"},           # XX: the unknown bucket
    ])
    _assert_batches_equal(jb, tb)
    tp, jp = tgp.name2pre["phone"], jgp.name2pre["phone"]
    start, end = tgp.global_dict.get_start_end_idx("<phone>")
    assert (start, end) == jgp.global_dict.get_start_end_idx("<phone>") and end - start == 43
    assert (tp.phone_blank, tp.phone_unk) == (jp.phone_blank, jp.phone_unk) == (start, end - 1)
    ids = tp.encode_phones("AA B XX ZH")
    np.testing.assert_array_equal(ids, jp.encode_phones("AA B XX ZH"))
    assert ids[2] == tp.phone_unk
    assert tp.decode(ids) == jp.decode(ids) == "AA B ZH"


def test_phone_namespace_size_is_checked():
    d = Dictionary()
    d.add_namespace("<phone>", 40)
    with pytest.raises(ValueError, match="already registered with size 40"):
        GeneralPreprocess(d, active=["phone"])


@pytest.mark.parametrize("text", ["ab", "cab xyz", "The Quick brown fox!", "", "42 q"])
def test_hermetic_g2p(text):
    assert tstruct.hermetic_g2p(text) == jstruct.hermetic_g2p(text)


@pytest.mark.parametrize("split", ["train", "test"])
def test_text_phone_encoder_target(split):
    recs = [{"src": s, "txt": t} for s, t in
            (("one", "cab"), ("two", "bad dog"), ("three", "a quick fox jumps"))]
    jb, tb, jgp, tgp = _both(["text", "text_phone"], TEXT_PHONE, recs, split)
    _assert_batches_equal(jb, tb)
    d = tgp.global_dict
    if split == "train":
        et = tb["encoder_target"]
        assert et.shape[0] == 3 and (et[0] != d.pad()).sum() == 4          # K AH B + eos
        start, end = d.get_start_end_idx("<phone>")
        body = et[(et != d.pad()) & (et != d.eos())]
        assert ((body >= start) & (body < end)).all()
    tpre = tgp.name2pre["text_phone"]
    assert tpre.text_to_phones("cab") == jgp.name2pre["text_phone"].text_to_phones("cab") == ["K", "AH", "B"]


def test_text_phone_open_target():
    """An open decoder slot (inference) carries an empty phone run."""
    got = []
    for gcls, dcls, icls in ((JGeneralPreprocess, JDictionary, JInstruction),
                             (GeneralPreprocess, Dictionary, Instruction)):
        gp = gcls(dcls(), active=["text", "text_phone"])
        slot = gp(icls(TEXT_PHONE, split="test").format(src="one")).slots[-1]
        got.append({k: None if v is None else np.asarray(v).tolist() for k, v in slot.value.items()})
    assert got[0] == got[1]
    assert got[1]["phone_tokens"] == []


FAMILIES = [n for n in JConfigStore().names("ofasys.task") if n not in ("default", "traverse")]


@pytest.mark.parametrize("name", FAMILIES)
def test_every_family_initializes(name):
    """The whole task zoo builds and initializes in the port, with the
    preprocessors and metrics ofasys_tpu's initialize builds."""
    j = JConfigStore().get("ofasys.task", name).target_cls()
    t = ConfigStore().get("ofasys.task", name).target_cls()
    j.initialize(JDictionary())
    t.initialize(Dictionary())
    assert sorted(t.general_preprocess.name2pre) == sorted(j.general_preprocess.name2pre)
    assert [type(m).__name__ for m in t.metrics] == [type(m).__name__ for m in j.metrics]
    assert type(t.criterion).__name__ == type(j.criterion).__name__
