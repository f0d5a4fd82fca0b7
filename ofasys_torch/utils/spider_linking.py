"""Counterpart of ofasys_tpu/utils/spider_linking.py (pure Python, kept as the
port's own copy).

Question <-> database-content value linking for text-to-SQL schema
serialization (reference ofasys/utils/spider/bridge_content_encoder.py, the
Salesforce BRIDGE content encoder used by DatabaseStructPreprocess via
serialize_schema, reference preprocessor/default/struct.py:89-115).

Given a natural-language question and one database column, find cell values
of that column that the question plausibly mentions, so they can be injected
into the serialized schema as ``column ( value1 , value2 )``. The matcher is
a longest-common-substring anchor expanded to word boundaries in the
question, scored by full-string fuzzy similarity, with stopword / number /
id-column filters.

Clean-room implementation: same observable filtering behavior, original
structure; fuzzy similarity uses difflib (the reference pulls in rapidfuzz,
which is not assumed here — ``difflib.SequenceMatcher.ratio`` is the same
Ratcliff-Obershelp measure).
"""

from __future__ import annotations

import difflib
import functools
import sqlite3
from typing import List, Optional, Tuple

# NLTK English stopwords (the reference inlines the same list).
_STOPWORDS = frozenset(
    """i me my myself we our ours ourselves you you're you've you'll you'd your
    yours yourself yourselves he him his himself she she's her hers herself it
    it's its itself they them their theirs themselves what which who whom this
    that that'll these those am is are was were be been being have has had
    having do does did doing a an the and but if or because as until while of
    at by for with about against between into through during before after
    above below to from up down in out on off over under again further then
    once here there when where why how all any both each few more most other
    some such no nor not only own same so than too very s t can will just don
    don't should should've now d ll m o re ve y ain aren aren't couldn
    couldn't didn didn't doesn doesn't hadn hadn't hasn hasn't haven haven't
    isn isn't ma mightn mightn't mustn mustn't needn needn't shan shan't
    shouldn shouldn't wasn wasn't weren weren't won won't wouldn wouldn't
    """.split()
)
# Words too common to be evidence of a value mention unless the match is exact.
_WEAK_WORDS = frozenset({"no", "yes", "many"})
_SEPARATORS = set("'\"()`,.?! ")


def _is_number(s: str) -> bool:
    try:
        float(s.replace(",", ""))
        return True
    except ValueError:
        return False


def _similarity(a: str, b: str) -> float:
    return difflib.SequenceMatcher(None, a, b).ratio()


def _expand_to_word(question: str, lo: int, hi: int) -> Optional[str]:
    """Expand [lo, hi) to the enclosing word span in ``question`` (allowing
    the anchor to start/end up to one char inside a word); None if the span
    cannot be closed within 2 chars on either side."""
    start = None
    for i in range(lo, lo - 2, -1):
        if i < 0:
            start = 0
            break
        if question[i] in _SEPARATORS:
            start = i
            break
    if start is None:
        return None
    end = None
    for i in range(hi - 1, hi + 3):
        if i >= len(question):
            end = len(question) - 1
            break
        if question[i] in _SEPARATORS:
            end = i
            break
    if end is None:
        return None
    while start < len(question) and question[start] in _SEPARATORS:
        start += 1
    while end >= 0 and question[end] in _SEPARATORS:
        end -= 1
    if end < start:
        return None
    return question[start : end + 1]


def _first_significant_char_match(a: str, b: str) -> bool:
    a = a.lstrip("".join(_SEPARATORS))
    b = b.lstrip("".join(_SEPARATORS))
    if not a and not b:
        return True
    if not a or not b:
        return False
    return a[0] == b[0]


def score_value_against_question(question: str, value: str) -> Tuple[float, int]:
    """(score in [0,1], anchor length). Score 0 means 'no usable mention'."""
    q_low, v_low = question.lower(), value.lower()
    sm = difflib.SequenceMatcher(None, q_low, v_low)
    m = sm.find_longest_match(0, len(q_low), 0, len(v_low))
    if m.size == 0:
        return 0.0, 0
    span = _expand_to_word(question, m.a, m.a + m.size)
    if span is None or len(span) <= 1:
        return 0.0, 0
    anchor = value[m.b : m.b + m.size].lower().strip()
    span_l = span.lower().strip()
    val_l = value.lower().strip()
    if not anchor or _is_number(anchor) or anchor == "id":
        return 0.0, 0
    if anchor in _STOPWORDS or span_l in _STOPWORDS or val_l in _STOPWORDS:
        return 0.0, 0
    if span_l.endswith(anchor + "'s"):
        score = 1.0
    elif _first_significant_char_match(val_l, span_l):
        score = _similarity(val_l, span_l)
    else:
        score = 0.0
    if (anchor in _WEAK_WORDS or span_l in _WEAK_WORDS or val_l in _WEAK_WORDS) and score < 1:
        return 0.0, 0
    if value.isupper() and score < 1:
        return 0.0, 0
    return score, m.size


@functools.lru_cache(maxsize=1024)
def get_column_picklist(table_name: str, column_name: str, db_path: str) -> tuple:
    """Distinct values of one column, read-only; empty on any sqlite error."""
    try:
        conn = sqlite3.connect(f"file:{db_path}?mode=ro", uri=True)
        conn.text_factory = bytes
        try:
            rows = conn.execute(
                'SELECT DISTINCT "{}" FROM "{}"'.format(
                    column_name.replace('"', '""'), table_name.replace('"', '""')
                )
            ).fetchall()
        finally:
            conn.close()
    except sqlite3.Error:
        return ()
    out = set()
    for (v,) in rows:
        if isinstance(v, bytes):
            try:
                out.add(v.decode("utf-8"))
            except UnicodeDecodeError:
                out.add(v.decode("latin-1"))
        else:
            out.add(v)
    return tuple(out)


def get_database_matches(
    question: str,
    table_name: str,
    column_name: str,
    db_path: str,
    top_k_matches: int = 2,
    match_threshold: float = 0.85,
) -> List[str]:
    """Cell values of ``table.column`` that the question mentions, best first.

    Only text columns participate; "name"-ish columns require a perfect
    match (anything weaker is noise — the reference applies the same rule).
    """
    picklist = get_column_picklist(table_name, column_name, db_path)
    if not picklist or not isinstance(picklist[0], str):
        return []
    if table_name == "sqlite_sequence":  # sqlite bookkeeping table
        return []
    scored = []
    for value in picklist:
        if not isinstance(value, str):
            continue
        score, size = score_value_against_question(question, value)
        if score >= match_threshold:
            scored.append((score, size, value))
    scored.sort(key=lambda t: (t[0], t[1]), reverse=True)
    matches = []
    for score, _size, value in scored:
        if "name" in column_name and score < 1:
            continue
        matches.append(value)
        if len(matches) >= top_k_matches:
            break
    return matches


def serialize_schema(
    question: str,
    db_path: str,
    db_id: str,
    tables: "List[Tuple[str, List[str]]]",
    with_db_id: bool = True,
    with_db_content: bool = True,
    normalize: bool = True,
) -> str:
    """Peteshaw-style serialization (reference default/struct.py:252-304):
    `` | db_id | table : col1 , col2 ( v1 , v2 ) , ...``. ``tables`` is an
    ordered list of (table_name, [column_names])."""

    def col_str(table: str, col: str) -> str:
        s = col.lower() if normalize else col
        if with_db_content and question and db_path:
            vals = get_database_matches(question, table, col, db_path)
            if vals:
                return f"{s} ( " + " , ".join(vals) + " )"
        return s

    parts = []
    if with_db_id:
        parts.append(f" | {db_id}")
    for tname, cols in tables:
        t = tname.lower() if normalize else tname
        parts.append(f" | {t} : " + " , ".join(col_str(tname, c) for c in cols))
    return "".join(parts)
