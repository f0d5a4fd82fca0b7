"""The metric zoo (counterpart of ofasys_tpu/metric/metrics.py): accuracy,
exact_match, bleu, rouge, f_measure, wer, matthews_corrcoef, iou_acc,
vqa_score, solved_acc, cider and clip_ti, registered under
``ofasys.metric`` with ofasys_tpu's names and computed in the same order
(the same floats). ``bleu`` needs ``sacrebleu`` and ``clip_ti`` needs
``transformers`` and local CLIP weights, as in ofasys_tpu. The Spider
metrics ``sql_exec_acc`` and ``sql_match_acc`` are registered and raise at
``compute``: their SQL evaluators wait for ROADMAP Queue A item 11."""

from __future__ import annotations

import re
import string
from collections import Counter, defaultdict
from dataclasses import dataclass

import numpy as np

from ofasys_torch.configure import register_config
from ofasys_torch.metric.base import BaseMetric, MetricConfig, levenshtein


def _norm(s: str) -> str:
    return " ".join(str(s).lower().strip().split())


@register_config("ofasys.metric", "accuracy", MetricConfig)
class AccuracyMetric(BaseMetric):
    def compute(self, hyps, refs):
        correct = sum(_norm(h) == _norm(r) for h, r in zip(hyps, refs))
        return {"accuracy": correct / max(len(hyps), 1)}


@register_config("ofasys.metric", "exact_match", MetricConfig)
class ExactMatchMetric(BaseMetric):
    """SQuAD-style EM: lowercase, strip punctuation/articles."""

    @staticmethod
    def _normalize(s: str) -> str:
        s = str(s).lower()
        s = "".join(c for c in s if c not in set(string.punctuation))
        s = re.sub(r"\b(a|an|the)\b", " ", s)
        return " ".join(s.split())

    def compute(self, hyps, refs):
        em = sum(self._normalize(h) == self._normalize(r) for h, r in zip(hyps, refs))
        return {"exact_match": em / max(len(hyps), 1)}


@register_config("ofasys.metric", "bleu", MetricConfig)
class BleuMetric(BaseMetric):
    def compute(self, hyps, refs):
        import sacrebleu

        refs_t = [[str(r) for r in refs]] if refs and isinstance(refs[0], str) else \
            [list(r) for r in zip(*refs)]
        score = sacrebleu.corpus_bleu([str(h) for h in hyps], refs_t)
        return {"bleu": score.score}


@register_config("ofasys.metric", "rouge", MetricConfig)
class RougeMetric(BaseMetric):
    """ROUGE-1/2/L F1."""

    @staticmethod
    def _ngrams(tokens, n):
        return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))

    @staticmethod
    def _f1(match, hyp_n, ref_n):
        p = match / hyp_n if hyp_n else 0.0
        r = match / ref_n if ref_n else 0.0
        return 2 * p * r / (p + r) if p + r else 0.0

    def _lcs(self, a, b):
        if not a or not b:
            return 0
        dp = [0] * (len(b) + 1)
        for x in a:
            prev = 0
            for j, y in enumerate(b, 1):
                cur = dp[j]
                dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
                prev = cur
        return dp[-1]

    def compute(self, hyps, refs):
        r1 = r2 = rl = 0.0
        n = max(len(hyps), 1)
        for h, r in zip(hyps, refs):
            ht, rt = _norm(h).split(), _norm(r).split()
            for key, k in (("r1", 1), ("r2", 2)):
                hn, rn = self._ngrams(ht, k), self._ngrams(rt, k)
                match = sum((hn & rn).values())
                val = self._f1(match, sum(hn.values()), sum(rn.values()))
                if key == "r1":
                    r1 += val
                else:
                    r2 += val
            lcs = self._lcs(ht, rt)
            rl += self._f1(lcs, len(ht), len(rt))
        return {"rouge1": r1 / n, "rouge2": r2 / n, "rougeL": rl / n}


@register_config("ofasys.metric", "f_measure", MetricConfig)
class FMeasureMetric(BaseMetric):
    def compute(self, hyps, refs):
        f1 = 0.0
        n = max(len(hyps), 1)
        for h, r in zip(hyps, refs):
            hn, rn = Counter(_norm(h).split()), Counter(_norm(r).split())
            match = sum((hn & rn).values())
            p = match / max(sum(hn.values()), 1)
            rr = match / max(sum(rn.values()), 1)
            f1 += 2 * p * rr / (p + rr) if p + rr else 0.0
        return {"f1": f1 / n}


@register_config("ofasys.metric", "wer", MetricConfig)
class WerMetric(BaseMetric):
    def compute(self, hyps, refs):
        errs = words = 0
        for h, r in zip(hyps, refs):
            rt = _norm(r).split()
            errs += levenshtein(_norm(h).split(), rt)
            words += len(rt)
        return {"wer": errs / max(words, 1)}


@register_config("ofasys.metric", "matthews_corrcoef", MetricConfig)
class MatthewsMetric(BaseMetric):
    def compute(self, hyps, refs):
        labels = sorted({_norm(x) for x in list(hyps) + list(refs)})
        idx = {l: i for i, l in enumerate(labels)}
        y1 = np.asarray([idx[_norm(h)] for h in hyps])
        y2 = np.asarray([idx[_norm(r)] for r in refs])
        # binary MCC; multi-class via generalized formula
        c = np.zeros((len(labels), len(labels)))
        for a, b in zip(y1, y2):
            c[b, a] += 1
        t = c.sum()
        s = np.trace(c)
        pk = c.sum(0)
        tk = c.sum(1)
        num = s * t - tk @ pk
        den = np.sqrt(t * t - pk @ pk) * np.sqrt(t * t - tk @ tk)
        return {"matthews_corrcoef": float(num / den) if den else 0.0}


@register_config("ofasys.metric", "iou_acc", MetricConfig)
class IouAccMetric(BaseMetric):
    """Acc@0.5 for boxes [x0,y0,x1,y1]."""

    @staticmethod
    def iou(a, b) -> float:
        ax0, ay0, ax1, ay1 = a
        bx0, by0, bx1, by1 = b
        ix = max(0.0, min(ax1, bx1) - max(ax0, bx0))
        iy = max(0.0, min(ay1, by1) - max(ay0, by0))
        inter = ix * iy
        union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
        return inter / union if union > 0 else 0.0

    def compute(self, hyps, refs):
        acc = sum(self.iou(h, r) >= 0.5 for h, r in zip(hyps, refs))
        return {"iou_acc": acc / max(len(hyps), 1)}


@register_config("ofasys.metric", "vqa_score", MetricConfig)
class VqaScoreMetric(BaseMetric):
    """VQA consensus score: min(#matching annotators / 3, 1); refs are
    answer lists (or single answers)."""

    def compute(self, hyps, refs):
        total = 0.0
        for h, r in zip(hyps, refs):
            answers = r if isinstance(r, (list, tuple)) else [r]
            matches = sum(_norm(h) == _norm(a) for a in answers)
            total += min(matches / 3.0, 1.0) if len(answers) > 1 else float(matches > 0)
        return {"vqa_score": total / max(len(hyps), 1)}


@register_config("ofasys.metric", "solved_acc", MetricConfig)
class SolvedAccMetric(BaseMetric):
    """Sudoku solved accuracy: full-board exact match."""

    def compute(self, hyps, refs):
        solved = sum("".join(_norm(h).split()) == "".join(_norm(r).split())
                     for h, r in zip(hyps, refs))
        return {"solved_acc": solved / max(len(hyps), 1)}


@register_config("ofasys.metric", "cider", MetricConfig)
class CiderMetric(BaseMetric):
    """CIDEr-D."""

    def __init__(self, cfg: MetricConfig = None, n: int = 4, sigma: float = 6.0):
        super().__init__(cfg)
        self.n = n
        self.sigma = sigma

    def _counts(self, tokens):
        out = []
        for k in range(1, self.n + 1):
            out.append(Counter(tuple(tokens[i:i + k]) for i in range(len(tokens) - k + 1)))
        return out

    def compute(self, hyps, refs):
        refs_lists = [r if isinstance(r, (list, tuple)) else [r] for r in refs]
        hyp_counts = [self._counts(_norm(h).split()) for h in hyps]
        ref_counts = [[self._counts(_norm(r).split()) for r in rl] for rl in refs_lists]
        # document frequencies over reference sets
        df = [defaultdict(float) for _ in range(self.n)]
        for rl in ref_counts:
            for k in range(self.n):
                seen = set()
                for rc in rl:
                    seen.update(rc[k].keys())
                for g in seen:
                    df[k][g] += 1.0
        n_docs = max(len(refs_lists), 1)
        import math

        def tfidf(counts, length):
            vecs, norms = [], []
            for k in range(self.n):
                vec = {}
                for g, c in counts[k].items():
                    idf = math.log(max(n_docs, 1.0)) - math.log(max(df[k][g], 1.0))
                    vec[g] = c * idf
                vecs.append(vec)
                norms.append(math.sqrt(sum(v * v for v in vec.values())))
            return vecs, norms

        scores = []
        for hi, (hc, rl) in enumerate(zip(hyp_counts, ref_counts)):
            hlen = sum(hc[0].values())
            hv, hn = tfidf(hc, hlen)
            score_k = np.zeros(self.n)
            for rc in rl:
                rlen = sum(rc[0].values())
                rv, rn = tfidf(rc, rlen)
                delta = hlen - rlen
                for k in range(self.n):
                    num = sum(min(hv[k].get(g, 0.0), rv[k].get(g, 0.0)) * rv[k][g] for g in rv[k])
                    if hn[k] and rn[k]:
                        sim = num / (hn[k] * rn[k])
                    else:
                        sim = 0.0
                    sim *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
                    score_k[k] += sim
            score_k /= max(len(rl), 1)
            scores.append(10.0 * float(np.mean(score_k)))
        return {"cider": float(np.mean(scores)) if scores else 0.0}


@register_config("ofasys.metric", "clip_ti", MetricConfig)
class ClipTiMetric(BaseMetric):
    """CLIP text-image similarity for image generation. Requires
    ``transformers`` and CLIP weights on disk (OFA_CLIP_PATH); reports NaN
    (never a constant 0 that could win or lose a comparison) when either is
    unavailable."""

    def compute(self, hyps, refs):
        try:
            from transformers import CLIPModel, CLIPProcessor  # noqa: F401

            import os
            path = os.environ.get("OFA_CLIP_PATH")
            if not path:
                raise FileNotFoundError("set OFA_CLIP_PATH to local CLIP weights")
            model = CLIPModel.from_pretrained(path)
            proc = CLIPProcessor.from_pretrained(path)
        except Exception:
            import logging

            logging.getLogger("ofasys_torch.metric").warning(
                "clip_ti: CLIP weights unavailable (set OFA_CLIP_PATH); "
                "reporting NaN"
            )
            return {"clip_ti": float("nan"), "clip_ti_available": 0.0}
        import torch

        sims = []
        for img, txt in zip(hyps, refs):
            inputs = proc(text=[str(txt)], images=img, return_tensors="pt", padding=True)
            with torch.no_grad():
                out = model(**inputs)
            sims.append(float(out.logits_per_image[0, 0]))
        return {"clip_ti": sum(sims) / max(len(sims), 1), "clip_ti_available": 1.0}


@dataclass
class SqlExecMetricConfig(MetricConfig):
    # root of the Spider database layout: {database_path}/{db_id}/{db_id}.sqlite
    database_path: str = ""


SQL = ("the Spider SQL evaluators (utils/sql_eval.py, utils/sql_classical.py) are not ported to "
       "ofasys_torch yet (ROADMAP Queue A item 11)")


@register_config("ofasys.metric", "sql_exec_acc", SqlExecMetricConfig)
class SqlExecAccMetric(BaseMetric):
    """Spider execution accuracy (ofasys_tpu's ``sql_exec_acc``)."""

    def compute(self, hyps, refs):
        raise NotImplementedError(f"sql_exec_acc: {SQL}")


@register_config("ofasys.metric", "sql_match_acc", MetricConfig)
class SqlMatchAccMetric(BaseMetric):
    """Classical Spider evaluation (ofasys_tpu's ``sql_match_acc``)."""

    def compute(self, hyps, refs):
        raise NotImplementedError(f"sql_match_acc: {SQL}")
