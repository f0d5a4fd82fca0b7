"""Counterpart of ofasys_tpu/utils/sql_eval.py (pure Python, kept as the
port's own copy).

Execution-accuracy SQL evaluation (reference ofasys/utils/test_suite/,
1,051 LoC: execution-based SQL equivalence for Spider).

Runs predicted and gold SQL against the task's sqlite database and compares
result multisets (order-insensitive unless ORDER BY is present in the gold
query). Databases are the .sqlite files shipped with Spider.
"""

from __future__ import annotations

import re
import sqlite3
from collections import Counter
from typing import Any, List, Optional, Sequence, Tuple


def execute_sql(db_path: str, sql: str, timeout_s: float = 5.0) -> Optional[List[Tuple]]:
    """Execute read-only; returns rows or None on any error."""
    try:
        conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True, timeout=timeout_s)
        conn.text_factory = lambda b: b.decode("utf-8", errors="replace")
        try:
            cur = conn.execute(sql)
            rows = cur.fetchmany(10000)
            return [tuple(r) for r in rows]
        finally:
            conn.close()
    except Exception:
        return None


def _normalize_rows(rows: Sequence[Tuple], ordered: bool):
    def norm_cell(c: Any):
        if isinstance(c, float):
            return round(c, 6)
        return c

    normed = [tuple(norm_cell(c) for c in r) for r in rows]
    return normed if ordered else Counter(normed)


def execution_match(db_path: str, pred_sql: str, gold_sql: str) -> bool:
    gold_rows = execute_sql(db_path, gold_sql)
    if gold_rows is None:
        return False
    pred_rows = execute_sql(db_path, pred_sql)
    if pred_rows is None:
        return False
    ordered = bool(re.search(r"\border\s+by\b", gold_sql, re.IGNORECASE))
    return _normalize_rows(pred_rows, ordered) == _normalize_rows(gold_rows, ordered)


def execution_accuracy(
    preds: Sequence[str], golds: Sequence[str], db_paths: Sequence[str]
) -> float:
    """Fraction of predictions whose execution result matches gold."""
    ok = sum(execution_match(db, p, g) for p, g, db in zip(preds, golds, db_paths))
    return ok / max(len(preds), 1)


def dump_schema(db_path: str, db_id: Optional[str] = None) -> dict:
    """sqlite file -> the {"db_id", "tables": {name: [cols]}} dict the
    database preprocessor linearizes (the reference builds the same structure
    with dump_db_json_schema, ofasys/utils/spider/get_tables.py)."""
    import os

    if db_id is None:
        db_id = os.path.splitext(os.path.basename(db_path))[0]
    conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
    try:
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "AND name NOT LIKE 'sqlite_%' ORDER BY name"
        )]
        out = {}
        for t in tables:
            out[t] = [r[1] for r in conn.execute(f'PRAGMA table_info("{t}")')]
    finally:
        conn.close()
    return {"db_id": db_id, "tables": out}
