"""The Spider SQL utilities of ofasys_torch against ofasys_tpu's:
``utils/spider_linking.py`` (BRIDGE value matching, ``serialize_schema``),
``utils/sql_eval.py`` (read-only execution, ``execution_match``,
``dump_schema``), ``utils/sql_classical.py`` (``parse_sql``,
``exact_match``, ``partial_scores``, ``hardness``, ``evaluate_classical``)
and the ``sql_exec_acc`` and ``sql_match_acc`` metrics, on the query pairs
of tests/test_sql_classical.py and more, over a sqlite database built from
a seed.

Tolerance: none — every result is equal (floats included).
"""

import sqlite3

import numpy as np
import pytest

import ofasys_tpu.metric  # noqa: F401  (registers the metric zoo)
from ofasys_tpu.configure import ConfigStore as JConfigStore
from ofasys_tpu.utils import sql_classical as jsc, sql_eval as jse, spider_linking as jsl
import ofasys_torch.metric  # noqa: F401
from ofasys_torch.configure import ConfigStore
from ofasys_torch.utils import sql_classical as tsc, sql_eval as tse, spider_linking as tsl

# (pred, gold): tests/test_sql_classical.py's cases, then more of Spider's shapes
PAIRS = [
    ("select name from cows", "select name from cows"),
    ("select id from cows where name = 'bessie'", "select id from cows where name = 'daisy'"),
    ("select distinct name from cows", "select name from cows"),
    ("SELECT T1.name FROM cows AS T1", "select cows.name from cows"),
    ("select a, b from t", "select b, a from t"),
    ("select id from cows", "select name from cows"),
    ("select count(*) from cows", "select max(id) from cows"),
    ("select id from cows", "select id from cows where id > 3"),
    ("select name from cows", "select name from pigs"),
    ("select name from cows order by id desc", "select name from cows order by id desc"),
    ("select name from cows order by id asc", "select name from cows order by id desc"),
    ("select name from cows order by id", "select name from cows order by id limit 1"),
    ("select a from t union select b from u", "select a from t union select b from u"),
    ("select a from t union select b from u", "select a from t intersect select b from u"),
    ("select name from cows where id in (select cow_id from milk)",
     "select name from cows where id in (select pig_id from ham)"),
    ("select farm, count(*) from cows group by farm having count(*) > 2",
     "select farm, count(*) from cows group by farm"),
    ("select id from cows where id > 3", "select name from cows where id > 3"),
    ("select farm, max(id) from cows group by farm order by farm limit 3",
     "select farm, max(id) from cows group by farm order by farm limit 3"),
    ("select farm from cows where id > 3 group by farm order by count(*) desc limit 1",
     "select farm from cows where id > 3 group by farm order by count(*) desc limit 1"),
    ("select name from cows where id in (select cow_id from milk where qty > 5) and farm = 'x' "
     "or farm = 'y' order by name limit 2", "select name from cows"),
    ("<<<not sql>>> (((", "select a from t"),
    ("select T1.name, T2.size from cows as T1 join barns as T2 on T1.id = T2.cow_id",
     "select cows.name, barns.size from cows join barns on cows.id = barns.cow_id"),
    ("select avg(age), min(age) from cows where breed != 'angus'",
     "select min(age), avg(age) from cows where breed != 'jersey'"),
    ("select name from cows where age between 2 and 5", "select name from cows where age >= 2"),
    ("select name from cows where name like '%ie'", "select name from cows where name like 'd%'"),
    ("select breed, count(*) from cows group by breed order by count(*) desc limit 1",
     "select breed from cows group by breed order by count(*) desc limit 1"),
    ("select name from cows except select T1.name from cows as T1 join barns as T2 "
     "on T1.id = T2.cow_id", "select name from cows where id not in (select cow_id from barns)"),
    ("select count(distinct breed) from cows", "select count(breed) from cows"),
    ("", "select name from cows"),
]

NAMES = ["bessie", "daisy", "mabel", "clover", "buttercup", "rosie", "molly", "penny"]
BREEDS = ["holstein", "jersey", "angus", "hereford"]


@pytest.fixture(scope="module")
def farm(tmp_path_factory):
    """``{root}/farm/farm.sqlite`` from seed 0: cows (id, name, breed, age)
    and barns (id, cow_id, size)."""
    root = tmp_path_factory.mktemp("spider")
    (root / "farm").mkdir()
    path = str(root / "farm" / "farm.sqlite")
    rng = np.random.default_rng(0)
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE cows (id INTEGER, name TEXT, breed TEXT, age REAL)")
    conn.execute("CREATE TABLE barns (id INTEGER, cow_id INTEGER, size TEXT)")
    conn.executemany("INSERT INTO cows VALUES (?, ?, ?, ?)",
                     [(i, NAMES[i], BREEDS[int(rng.integers(4))], float(rng.uniform(1, 9)) / 3)
                      for i in range(len(NAMES))])
    conn.executemany("INSERT INTO barns VALUES (?, ?, ?)",
                     [(i, int(rng.integers(len(NAMES))), ["small", "large"][i % 2]) for i in range(5)])
    conn.commit()
    conn.close()
    return dict(root=str(root), path=path)


def _as_plain(x):
    """A parsed or scored result as comparable Python values."""
    if hasattr(x, "__dataclass_fields__"):
        return {k: _as_plain(getattr(x, k)) for k in x.__dataclass_fields__}
    if isinstance(x, dict):
        return {k: _as_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_as_plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(map(repr, x))
    return x


@pytest.mark.parametrize("pred,gold", PAIRS)
def test_classical_evaluation_matches(pred, gold):
    assert tsc.tokenize(pred) == jsc.tokenize(pred)
    tp, tg = tsc.parse_sql(pred), tsc.parse_sql(gold)
    jp, jg = jsc.parse_sql(pred), jsc.parse_sql(gold)
    assert _as_plain(tp) == _as_plain(jp)
    assert tsc.exact_match(tp, tg) == jsc.exact_match(jp, jg)
    assert _as_plain(tsc.partial_scores(tp, tg)) == _as_plain(jsc.partial_scores(jp, jg))
    assert tsc.hardness(tg) == jsc.hardness(jg)
    assert tsc.PARTIAL_TYPES == jsc.PARTIAL_TYPES


def test_corpus_evaluation_matches():
    preds, golds = [p for p, _ in PAIRS], [g for _, g in PAIRS]
    assert _as_plain(tsc.evaluate_classical(preds, golds)) == \
        _as_plain(jsc.evaluate_classical(preds, golds))


@pytest.mark.parametrize("gold,pred", [
    ("select count(*) from cows", "SELECT count(id) FROM cows"),
    ("select count(*) from cows", "select 99"),
    ("select name from cows order by age", "select name from cows order by age desc"),
    ("select name from cows", "select name from cows order by age desc"),
    ("select avg(age) from cows", "select sum(age) / count(*) from cows"),
    ("select breed, count(*) from cows group by breed", "select breed, count(*) from cows group by 1"),
    ("select name from cows where breed = 'jersey'", "select name from cows where breed = 'jersey' "
     "union select name from cows where 1 = 0"),
    ("select name from nowhere", "select name from nowhere"),
    ("select size from barns", "drop table barns"),
])
def test_execution_matches(farm, gold, pred):
    path = farm["path"]
    assert tse.execute_sql(path, gold) == jse.execute_sql(path, gold)
    assert tse.execute_sql(path, pred) == jse.execute_sql(path, pred)
    assert tse.execution_match(path, pred, gold) == jse.execution_match(path, pred, gold)
    # read only: the database is unchanged
    assert tse.execute_sql(path, "select count(*) from barns") == [(5,)]


def test_execution_accuracy_and_schema(farm):
    path = farm["path"]
    preds = ["select name from cows", "select id from cows", "select size from barns"]
    golds = ["select name from cows", "select name from cows", "select size from barns order by id"]
    assert tse.execution_accuracy(preds, golds, [path] * 3) == \
        jse.execution_accuracy(preds, golds, [path] * 3)
    assert tse.dump_schema(path) == jse.dump_schema(path)
    assert tse.dump_schema(path, "farm") == {
        "db_id": "farm", "tables": {"barns": ["id", "cow_id", "size"],
                                    "cows": ["id", "name", "breed", "age"]}}


@pytest.mark.parametrize("question", [
    "what is the id of bessie?", "how many entries are there?", "what about cow 1?",
    "show the breed of the cow named daisy", "which barns are large", "is buttercup a jersey?",
    "list holstein and angus cows older than 2", "",
])
def test_value_linking_matches(farm, question):
    path = farm["path"]
    tables = [("cows", ["id", "name", "breed", "age"]), ("barns", ["id", "cow_id", "size"])]
    for table, cols in tables:
        for col in cols:
            assert tsl.get_database_matches(question, table, col, path) == \
                jsl.get_database_matches(question, table, col, path)
    for content in (True, False):
        assert tsl.serialize_schema(question=question, db_path=path, db_id="farm", tables=tables,
                                    with_db_content=content) == \
            jsl.serialize_schema(question=question, db_path=path, db_id="farm", tables=tables,
                                 with_db_content=content)
    for value in ("bessie", "Daisy Duke", "12", "large"):
        assert tsl.score_value_against_question(question, value) == \
            jsl.score_value_against_question(question, value)


def test_linking_finds_cells(farm):
    assert tsl.get_database_matches("what is the id of bessie?", "cows", "name", farm["path"]) == ["bessie"]
    s = tsl.serialize_schema(question="which barns are large", db_path=farm["path"], db_id="farm",
                             tables=[("barns", ["id", "size"])])
    assert "size ( large )" in s


def _metric(store, name, **cfg):
    node = store.get("ofasys.metric", name)
    m = node.target_cls(node.config.__class__(**cfg))
    return m


@pytest.mark.parametrize("name", ["sql_exec_acc", "sql_match_acc"])
def test_sql_metrics_match(farm, name):
    kw = {"database_path": farm["root"]} if name == "sql_exec_acc" else {}
    hyps = ["farm | select count(id) from cows", "farm | select 99", "farm | select name from cows",
            "select name from cows", "farm | select size from barns where id > 2",
            "nowhere | select 1"]
    refs = ["farm | select count(*) from cows", "farm | select count(*) from cows",
            "farm | select name from cows order by id", "farm | select name from cows",
            "farm | select size from barns where id >= 3", "nowhere | select 1"]
    got = _metric(ConfigStore(), name, **kw).compute(hyps, refs)
    want = _metric(JConfigStore(), name, **kw).compute(hyps, refs)
    assert got == want
    if name == "sql_exec_acc":
        assert got["sql_exec_acc"] == 4 / 6
