"""Counterpart of ofasys_tpu/utils/sql_classical.py (pure Python, kept as the
port's own copy).

Classical (parse-based) Spider SQL evaluation: exact set match, per-clause
partial credit, and hardness bucketing (reference
ofasys/utils/spider/evaluation.py, 1,017 LoC, + test_suite/evaluate_classical.py).

Clean-room design: instead of the reference's positional AST tuples
(val_unit/col_unit lists), each query is normalized into a ``ParsedSQL`` of
hashable component collections, and each clause is compared as a multiset.
The observable metric surface matches the reference's defaults:

- literal values in conditions are ignored (reference ``DISABLE_VALUE=True``
  rebuild_sql_val) and DISTINCT is ignored (``DISABLE_DISTINCT=True``);
- partial types: select, select(no AGG), where, where(no OP),
  group(no Having), group, order, and/or, IUEN, keywords;
- exact set match = every partial F1 == 1 and the FROM table sets agree
  (reference Evaluator.eval_exact_match);
- hardness easy/medium/hard/extra via the same component counts
  (reference count_component1/2, count_others, eval_hardness).

Table aliases are resolved from the FROM clause; column references are then
compared by (table, column) when qualified on both sides, else by bare
column name — a schema-free stand-in for the reference's schema-id mapping.
"""

from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

AGG_OPS = ("max", "min", "count", "sum", "avg")
COND_OPS = ("=", "!=", "<>", "<", ">", "<=", ">=", "like", "not like", "in",
            "not in", "between", "is", "exists")
IUEN = ("intersect", "union", "except")
PARTIAL_TYPES = (
    "select", "select(no AGG)", "where", "where(no OP)", "group(no Having)",
    "group", "order", "and/or", "IUEN", "keywords",
)
LEVELS = ("easy", "medium", "hard", "extra", "all")

_TOKEN_RE = re.compile(
    r"'(?:[^']|'')*'|\"(?:[^\"]|\"\")*\"|`[^`]*`|\d+\.\d+|\d+|!=|<>|<=|>=|[(),;*=<>]|[\w.]+"
)


def tokenize(sql: str) -> List[str]:
    """Lowercased tokens; string/number literals collapse to 'value'."""
    out = []
    for tok in _TOKEN_RE.findall(sql):
        if tok[0] in "'\"" or re.fullmatch(r"\d+(\.\d+)?", tok):
            out.append("value")
        elif tok[0] == "`":
            out.append(tok[1:-1].lower())
        else:
            out.append(tok.lower())
    return out


@dataclass(frozen=True)
class ParsedSQL:
    select: Tuple = ()        # (agg, col) units; agg '' when none
    tables: frozenset = frozenset()
    where: Tuple = ()         # (col, op) condition units, values stripped
    and_or: Tuple = ()        # 'and'/'or' connectors in WHERE
    group: Tuple = ()
    having: Tuple = ()
    order: Tuple = ()         # ((agg, col)..., direction, has_limit)
    keywords: frozenset = frozenset()
    iuen: Tuple = ()          # (kw, ParsedSQL)
    nested: Tuple = ()        # subqueries inside conditions


class _Tokens:
    def __init__(self, toks: List[str]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Optional[str]:
        t = self.peek()
        self.i += 1
        return t


def _split_top(toks: List[str], seps: Sequence[str]) -> List[List[str]]:
    """Split a token list on separator tokens at paren depth 0."""
    parts, cur, depth = [], [], 0
    for t in toks:
        if t == "(":
            depth += 1
        elif t == ")":
            depth -= 1
        if depth == 0 and t in seps:
            parts.append(cur)
            cur = []
        else:
            cur.append(t)
    parts.append(cur)
    return parts


_CLAUSE_KW = {"select", "from", "where", "group", "having", "order", "limit",
              "intersect", "union", "except"}


def _clauses(toks: List[str]) -> Dict[str, List[str]]:
    """Top-level clause split. IUEN splits first; 'group by'/'order by' are
    detected as the two-token sequences."""
    out: Dict[str, List[str]] = {}
    cur_kw, cur, depth, i = None, [], 0, 0
    while i < len(toks):
        t = toks[i]
        if t == "(":
            depth += 1
        elif t == ")":
            depth -= 1
        if depth == 0 and t in _CLAUSE_KW:
            if t in ("group", "order"):
                if i + 1 < len(toks) and toks[i + 1] == "by":
                    if cur_kw:
                        out[cur_kw] = cur
                    cur_kw, cur = t, []
                    i += 2
                    continue
            else:
                if cur_kw:
                    out[cur_kw] = cur
                cur_kw, cur = t, []
                i += 1
                continue
        cur.append(t)
        i += 1
    if cur_kw:
        out[cur_kw] = cur
    return out


def _extract_subqueries(toks: List[str]) -> Tuple[List[str], List[List[str]]]:
    """Replace top-level parenthesized SELECTs with '#subN' placeholders."""
    out, subs, i = [], [], 0
    while i < len(toks):
        if toks[i] == "(" and i + 1 < len(toks) and toks[i + 1] == "select":
            depth, j = 1, i + 1
            while j < len(toks) and depth:
                if toks[j] == "(":
                    depth += 1
                elif toks[j] == ")":
                    depth -= 1
                j += 1
            subs.append(toks[i + 1 : j - 1])
            out.append(f"#sub{len(subs) - 1}")
            i = j
        else:
            out.append(toks[i])
            i += 1
    return out, subs


def _alias_map(from_toks: List[str]) -> Tuple[Dict[str, str], frozenset]:
    """alias -> table from the FROM clause; also the set of real tables."""
    amap: Dict[str, str] = {}
    tables = set()
    i = 0
    expect_table = True
    while i < len(from_toks):
        t = from_toks[i]
        if t in ("join", ","):
            expect_table = True
        elif t == "on":
            expect_table = False
            # skip the join condition up to the next join/, at depth 0
            i += 1
            while i < len(from_toks) and from_toks[i] not in ("join", ","):
                i += 1
            continue
        elif expect_table and re.fullmatch(r"[\w.]+", t) and not t.startswith("#sub"):
            table = t
            tables.add(table)
            nxt = from_toks[i + 1] if i + 1 < len(from_toks) else None
            if nxt == "as" and i + 2 < len(from_toks):
                amap[from_toks[i + 2]] = table
                i += 2
            elif nxt and re.fullmatch(r"\w+", nxt) and nxt not in ("join", "on", "where"):
                amap[nxt] = table
                i += 1
            expect_table = False
        i += 1
    return amap, frozenset(tables)


def _norm_col(tok: str, amap: Dict[str, str]) -> str:
    """alias.col -> table.col; compare unqualified when either side is bare
    (handled at comparison time by also keeping the bare name)."""
    if "." in tok:
        head, _, col = tok.partition(".")
        return f"{amap.get(head, head)}.{col}"
    return tok


def _col_key(col: str) -> str:
    """Comparison key: bare column name (schema-free stand-in for the
    reference's schema-id canonicalization)."""
    return col.rsplit(".", 1)[-1]


def _parse_select_units(toks: List[str], amap) -> Tuple:
    units = []
    for item in _split_top(toks, (",",)):
        item = [t for t in item if t != "distinct"]
        if not item:
            continue
        if item[0] in AGG_OPS:
            inner = [t for t in item[1:] if t not in ("(", ")")]
            col = _col_key(_norm_col(inner[0], amap)) if inner else "*"
            units.append((item[0], col))
        else:
            units.append(("", _col_key(_norm_col(item[0], amap))))
    return tuple(units)


def _mask_between_and(toks: List[str]) -> List[str]:
    """Rename the 'and' that belongs to a BETWEEN .. AND .. expression so the
    connector split doesn't break the condition in two."""
    out, pending = [], 0
    for t in toks:
        if t == "between":
            pending += 1
        if t == "and" and pending > 0:
            pending -= 1
            out.append("&and")
            continue
        out.append(t)
    return out


def _parse_conditions(toks: List[str], amap) -> Tuple[Tuple, Tuple, List[str]]:
    """-> (cond units (col, op, subquery placeholder or ''), connectors,
    subquery placeholders seen). The placeholder is resolved to a ParsedSQL
    by the caller so nested queries participate in clause comparison
    (reference rebuild_cond_unit_val keeps dict vals under DISABLE_VALUE)."""
    toks = _mask_between_and(toks)
    conds, connectors, subs = [], [], []
    pieces = _split_top(toks, ("and", "or"))
    # reconstruct connector sequence
    depth = 0
    for t in toks:
        if t == "(":
            depth += 1
        elif t == ")":
            depth -= 1
        elif depth == 0 and t in ("and", "or"):
            connectors.append(t)
    for piece in pieces:
        if not piece:
            continue
        col, op = None, None
        j = 0
        if piece[j : j + 1] == ["not"]:
            j += 1
        if j < len(piece):
            if piece[j] in AGG_OPS and j + 1 < len(piece) and piece[j + 1] == "(":
                k = j + 2
                inner = []
                while k < len(piece) and piece[k] != ")":
                    inner.append(piece[k])
                    k += 1
                cname = inner[0] if inner else "*"
                col = f"{piece[j]}({_col_key(_norm_col(cname, amap))})"
                j = k + 1
            else:
                col = _col_key(_norm_col(piece[j], amap))
                j += 1
        neg = False
        if j < len(piece) and piece[j] == "not":
            neg = True
            j += 1
        if j < len(piece) and piece[j] in ("=", "!=", "<>", "<", ">", "<=", ">=",
                                           "like", "in", "between", "is", "exists"):
            op = piece[j]
            if op == "<>":
                op = "!="
            if neg:
                op = f"not {op}"
        sub = ""
        for t in piece:
            if t.startswith("#sub"):
                subs.append(t)
                sub = t
        if col is not None and op is not None:
            conds.append((col, op, sub))
    return tuple(conds), tuple(connectors), subs


def parse_sql(sql: str) -> ParsedSQL:
    toks = tokenize(str(sql))
    toks, raw_subs = _extract_subqueries(toks)
    sub_parsed = [parse_sql(" ".join(s)) for s in raw_subs]

    # top-level IUEN
    for kw in IUEN:
        parts = _split_top(toks, (kw,))
        if len(parts) > 1:
            left = _parse_clauses(parts[0], sub_parsed)
            right = _parse_clauses(parts[1], sub_parsed)
            kws = left.keywords | {kw}
            return ParsedSQL(
                select=left.select, tables=left.tables, where=left.where,
                and_or=left.and_or, group=left.group, having=left.having,
                order=left.order, keywords=kws,
                iuen=((kw, right),), nested=left.nested + right.nested,
            )
    return _parse_clauses(toks, sub_parsed)


def _parse_clauses(toks: List[str], sub_parsed: List[ParsedSQL]) -> ParsedSQL:
    cl = _clauses(toks)
    amap, tables = _alias_map(cl.get("from", []))
    select = _parse_select_units(cl.get("select", []), amap)
    where, and_or, wsubs = _parse_conditions(cl.get("where", []), amap)
    having, _, hsubs = _parse_conditions(cl.get("having", []), amap)

    def _resolve(conds: Tuple) -> Tuple:
        out = []
        for col, op, sub in conds:
            q = None
            if sub:
                idx = int(sub[4:])
                if idx < len(sub_parsed):
                    q = sub_parsed[idx]
            out.append((col, op, q))
        return tuple(out)

    where, having = _resolve(where), _resolve(having)
    group = tuple(
        _col_key(_norm_col(p[0], amap)) for p in _split_top(cl.get("group", []), (",",)) if p
    )
    order_toks = cl.get("order", [])
    order: Tuple = ()
    if order_toks:
        direction = "desc" if "desc" in order_toks else "asc"
        cols = []
        for p in _split_top([t for t in order_toks if t not in ("asc", "desc")], (",",)):
            p = [t for t in p if t not in ("(", ")", "distinct")]
            if not p:
                continue
            if p[0] in AGG_OPS:
                cols.append((p[0], _col_key(_norm_col(p[1], amap)) if len(p) > 1 else "*"))
            else:
                cols.append(("", _col_key(_norm_col(p[0], amap))))
        order = (tuple(sorted(cols)), direction, "limit" in cl)

    keywords = set()
    if where:
        keywords.add("where")
    if group:
        keywords.add("group")
    if having:
        keywords.add("having")
    if order:
        keywords.add("order")
        keywords.add(order[1])
    if "limit" in cl:
        keywords.add("limit")
    if len(tables) > 1:
        keywords.add("join")
    for col, op, _sub in where + having:
        for w in ("not", "in", "like", "between", "exists"):
            if w in op.split():
                keywords.add(w)

    nested = []
    for ph in wsubs + hsubs:
        idx = int(ph[4:])
        if idx < len(sub_parsed):
            nested.append(sub_parsed[idx])
    # subqueries in FROM
    for t in cl.get("from", []):
        if t.startswith("#sub"):
            idx = int(t[4:])
            if idx < len(sub_parsed):
                nested.append(sub_parsed[idx])

    return ParsedSQL(
        select=select, tables=tables, where=where, and_or=and_or, group=group,
        having=having, order=order, keywords=frozenset(keywords),
        nested=tuple(nested),
    )


# ------------------------------------------------------------------ scoring

def _set_scores(pred: Sequence, gold: Sequence) -> Dict[str, float]:
    """Multiset precision/recall/F1 plus raw totals (reference get_scores)."""
    pc, gc = Counter(pred), Counter(gold)
    hit = sum((pc & gc).values())
    pt, gt = sum(pc.values()), sum(gc.values())
    if pt == gt == 0:
        return {"acc": 1.0, "rec": 1.0, "f1": 1.0, "pred_total": 0, "label_total": 0}
    # reference get_scores (evaluation.py:144-150) is all-or-nothing: a
    # clause scores 1 only when totals agree AND every unit matches
    ok = pt == gt and hit == pt
    v = 1.0 if ok else 0.0
    return {"acc": v, "rec": v, "f1": v, "pred_total": pt, "label_total": gt}


def partial_scores(pred: ParsedSQL, gold: ParsedSQL) -> Dict[str, Dict[str, float]]:
    scores = {}
    scores["select"] = _set_scores(sorted(pred.select), sorted(gold.select))
    scores["select(no AGG)"] = _set_scores(
        sorted(c for _, c in pred.select), sorted(c for _, c in gold.select))
    scores["where"] = _set_scores(list(pred.where), list(gold.where))
    scores["where(no OP)"] = _set_scores(
        sorted(c for c, _, _ in pred.where), sorted(c for c, _, _ in gold.where))
    scores["group(no Having)"] = _set_scores(sorted(pred.group), sorted(gold.group))
    scores["group"] = _set_scores(
        sorted(pred.group) + sorted(pred.having), sorted(gold.group) + sorted(gold.having))
    scores["order"] = _set_scores(
        [pred.order] if pred.order else [], [gold.order] if gold.order else [])
    scores["and/or"] = _set_scores(sorted(pred.and_or), sorted(gold.and_or))
    # IUEN: the nested right-hand queries must exact-match recursively
    if len(pred.iuen) == len(gold.iuen):
        ok = all(kw1 == kw2 and exact_match(q1, q2)
                 for (kw1, q1), (kw2, q2) in zip(pred.iuen, gold.iuen))
    else:
        ok = False
    v = 1.0 if ok else 0.0
    scores["IUEN"] = {"acc": v, "rec": v, "f1": v,
                      "pred_total": len(pred.iuen), "label_total": len(gold.iuen)}
    scores["keywords"] = _set_scores(sorted(pred.keywords), sorted(gold.keywords))
    return scores


def exact_match(pred: ParsedSQL, gold: ParsedSQL) -> bool:
    """All partial F1s == 1 and FROM tables agree (reference
    Evaluator.eval_exact_match)."""
    ps = partial_scores(pred, gold)
    if any(s["f1"] != 1 for s in ps.values()):
        return False
    return sorted(pred.tables) == sorted(gold.tables)


# ----------------------------------------------------------------- hardness

def _count_component1(q: ParsedSQL) -> int:
    n = 0
    n += bool(q.where) + bool(q.group) + bool(q.order)
    if q.order and q.order[2]:
        n += 1
    n += max(len(q.tables) - 1, 0)
    n += sum(1 for c in q.and_or if c == "or")
    n += sum(1 for _, op, _sub in q.where + q.having if "like" in op)
    return n


def _count_component2(q: ParsedSQL) -> int:
    return len(q.nested) + len(q.iuen)


def _count_others(q: ParsedSQL) -> int:
    n = 0
    aggs = sum(1 for a, _ in q.select if a)
    if q.order:
        aggs += sum(1 for a, _ in q.order[0] if a)
    if aggs > 1:
        n += 1
    if len(q.select) > 1:
        n += 1
    if len(q.where) > 1:
        n += 1
    if len(q.group) > 1:
        n += 1
    return n


def hardness(q: ParsedSQL) -> str:
    c1, c2, others = _count_component1(q), _count_component2(q), _count_others(q)
    if c1 <= 1 and others == 0 and c2 == 0:
        return "easy"
    if (others <= 2 and c1 <= 1 and c2 == 0) or (c1 <= 2 and others < 2 and c2 == 0):
        return "medium"
    if ((others > 2 and c1 <= 2 and c2 == 0)
            or (2 < c1 <= 3 and others <= 2 and c2 == 0)
            or (c1 <= 1 and others == 0 and c2 <= 1)):
        return "hard"
    return "extra"


# --------------------------------------------------------------- aggregate

def evaluate_classical(
    preds: Sequence[str], golds: Sequence[str]
) -> Dict[str, object]:
    """Corpus-level classical evaluation: overall + per-hardness exact set
    match, and mean partial F1 per clause type (reference Evaluator +
    finalize, evaluation.py:571-700)."""
    counts = {lv: 0 for lv in LEVELS}
    exact = {lv: 0.0 for lv in LEVELS}
    partial = {lv: {t: {"f1": 0.0} for t in PARTIAL_TYPES} for lv in LEVELS}
    for p, g in zip(preds, golds):
        gq = parse_sql(g)
        try:
            pq = parse_sql(p)
        except Exception:
            pq = ParsedSQL()
        lv = hardness(gq)
        em = float(exact_match(pq, gq))
        ps = partial_scores(pq, gq)
        for level in (lv, "all"):
            counts[level] += 1
            exact[level] += em
            for t in PARTIAL_TYPES:
                partial[level][t]["f1"] += ps[t]["f1"]
    out: Dict[str, object] = {"counts": counts}
    out["exact"] = {lv: (exact[lv] / counts[lv] if counts[lv] else 0.0) for lv in LEVELS}
    out["partial_f1"] = {
        lv: {t: (partial[lv][t]["f1"] / counts[lv] if counts[lv] else 0.0)
             for t in PARTIAL_TYPES}
        for lv in LEVELS
    }
    return out
